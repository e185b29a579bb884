"""StreamingFleet — incremental matrix profiles for N concurrent series,
held on the device: port of `repro.core.fleet`.

The fleet keeps ALL per-tenant state stacked on its device — sample
buffers, the cached windows and their norms (the z-stats), and the
merged, left and right profiles as `(N, lcap)` tensors — and applies one
arrival per tenant per round across the whole fleet. `ingest(tenant_ids,
values)` groups an arbitrary batch of (tenant, value) arrivals into rounds
of at most one arrival per tenant and runs exactly that many rounds, each a
fixed sequence of tensor ops with no host sync inside the loop.

Exactness contract: a fleet tenant is BITWISE equal to a per-series
`StreamingProfile` replay of the same arrivals. Both surfaces run the same
f64 block arithmetic — the shared kernels in `zstats` (`centered_block`,
`sqdist_*_from_parts`: elementwise products and fixed-order sums, so an
element's bits depend only on its own pair of windows) — and the same
bookkeeping: first-min row argmin, strict-< right-side updates, and the
finite-window mask of the `invn = -1` missing-data sentinel (a NaN arrival
masks exactly the windows that touch it, per tenant).

Capacity/eviction semantics (epoch restart): each tenant owns a fixed
`capacity`-sample buffer. When the buffer is full, the next arrival
RESTARTS the tenant's epoch carrying the trailing `m-1` samples (so
subsequence coverage has no gap across the boundary), resets its profile
state and restarts subsequence indexing at 0; `epochs[tenant]` counts
restarts. The replay oracle is a fresh `StreamingProfile` fed the `m-1`
carryover, then the later arrivals.

Per round, only what changes is written: a tenant's new window, norm and
mask go into its slot in place, profiles improve in place, and restarts
(known on the host from the arrivals alone, through a host mirror of the
per-tenant counts) reset just the restarting rows. The (N, lcap, m)
product of the new windows against the cached ones runs in tenant chunks
of at most `BLOCK_ELEMENTS` elements; a chunk's bits do not depend on its
size.

Checkpointing rides `checkpoint.ckpt` format 2 with the reference's keys,
metadata and on-disk dtypes (`wk` in f64, whatever the device holds), so
each package restores the other's fleets; `rescale()` grows (fresh
tenants) or shrinks (drops the tail) N without touching surviving
tenants' state.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.utils.device import resolve_device

__all__ = ["StreamingFleet"]

# stacked per-tenant state. Leading axis is always N.
#   buf   (N, cap)      epoch sample buffer (f64)
#   cnt   (N,)          valid samples in the current epoch (i32)
#   wk    (N, lcap, m)  cached windows: centered if normalize else raw (f64,
#                       or the reduced stream dtype)
#   aux   (N, lcap)     centered norms / sums of squares (f64)
#   ok    (N, lcap)     finite-window mask (the invn=-1 sentinel) (bool)
#   prof  (N, lcap)     merged profile, SQUARED distance (f64; inf = unset)
#   pidx  (N, lcap)     merged neighbor index, epoch-local (i32; -1 = unset)
#   lprof/lidx          left split (set once per subsequence, final)
#   rprof/ridx          right split (strict-< column updates)
#   total (N,)          lifetime arrivals per tenant (i64)
#   epoch (N,)          completed epoch restarts per tenant (i32)
_FIELDS = ("buf", "cnt", "wk", "aux", "ok", "prof", "pidx",
           "lprof", "lidx", "rprof", "ridx", "total", "epoch")
# the reference's dtypes: the on-disk dtypes of every checkpoint
_DTYPES = dict(buf=np.float64, cnt=np.int32, wk=np.float64, aux=np.float64,
               ok=np.bool_, prof=np.float64, pidx=np.int32,
               lprof=np.float64, lidx=np.int32, rprof=np.float64,
               ridx=np.int32, total=np.int64, epoch=np.int32)
_TORCH_DTYPES = {np.float64: torch.float64, np.int32: torch.int32,
                 np.int64: torch.int64, np.bool_: torch.bool}
# profile fields and their unset value
_UNSET = dict(prof=torch.inf, pidx=-1, lprof=torch.inf, lidx=-1,
              rprof=torch.inf, ridx=-1)


def _host(values, dtype) -> np.ndarray:
    if isinstance(values, torch.Tensor):
        values = values.detach().cpu().numpy()
    return np.atleast_1d(np.asarray(values, dtype))


class StreamingFleet:
    """Multi-tenant incremental exact matrix profiles on one device (see
    the module docstring for the state layout, exactness contract and
    eviction semantics). `device=None` is the CUDA card; `device="cpu"`
    runs on the host."""

    # elements of the (tenants, lcap, m) f64 product one chunk may hold
    # (512 MiB)
    BLOCK_ELEMENTS = 1 << 26

    def __init__(self, n: int, window: int, capacity: int,
                 exclusion: int | None = None, normalize: bool = True,
                 precision=None, *, device=None):
        from repro_torch.core.precision import as_precision

        if int(window) < 2:
            raise ValueError(f"window must be >= 2, got {window}")
        if int(capacity) < int(window):
            raise ValueError(f"capacity must be >= window, got "
                             f"{capacity} < {window}")
        if int(n) < 1:
            raise ValueError(f"n must be >= 1, got {n}")
        self.n = int(n)
        self.m = int(window)
        self.capacity = int(capacity)
        self.excl = max(1, self.m // 4) if exclusion is None else int(exclusion)
        self.normalize = bool(normalize)
        # only the `stream` role applies here: it is the dtype of the
        # O(N*lcap*m) cached-window stack `wk`, the fleet's largest
        # resident. Accumulation stays f64 (the exactness contract); the
        # default spec keeps wk f64.
        self.precision = as_precision(precision)
        if self.precision.reduced_stream and not self.normalize:
            raise ValueError(
                "reduced stream precision requires normalize=True: raw "
                "window distances have no [-1, 1] bound to absorb the "
                "stream rounding (see PrecisionSpec)")
        self.device = resolve_device(device)
        self.lcap = self.capacity - self.m + 1
        self._ingests = 0
        self._state = self._init_state(self.n)
        # host mirror of `cnt`: restarts follow from the arrivals alone, so
        # the host knows which rows restart in which round without a sync
        self._cnt_host = np.zeros(self.n, np.int64)

    @property
    def _wk_stream(self) -> str:
        """wk storage dtype name: the plan-time stream precision when
        reduced, else f64."""
        return (self.precision.stream if self.precision.reduced_stream
                else "float64")

    # -- state plumbing ------------------------------------------------------

    def _init_state(self, n: int) -> dict:
        cap, lcap, m = self.capacity, self.lcap, self.m
        shapes = dict(buf=(n, cap), cnt=(n,), wk=(n, lcap, m), aux=(n, lcap),
                      ok=(n, lcap), total=(n,), epoch=(n,))
        shapes.update({f: (n, lcap) for f in _UNSET})
        state = {}
        for f in _FIELDS:
            state[f] = torch.full(shapes[f], _UNSET.get(f, 0),
                                  dtype=self._dtype(f), device=self.device)
        return state

    def _set_host_state(self, host: dict) -> None:
        """Install host arrays as the device state (wk in its stream
        dtype) and the host count mirror."""
        self._state = {
            f: torch.from_numpy(np.ascontiguousarray(host[f], _DTYPES[f]))
            .to(self.device, self._dtype(f)) for f in _FIELDS}
        self._cnt_host = np.asarray(host["cnt"], np.int64).copy()

    def _dtype(self, f: str) -> torch.dtype:
        """Device dtype of field `f`: the reference's, but `wk` in the
        reduced stream dtype when there is one."""
        if f == "wk" and self.precision.reduced_stream:
            return self.precision.stream_dtype
        return _TORCH_DTYPES[_DTYPES[f]]

    def _to_host(self) -> dict:
        """The state as host arrays of the on-disk dtypes (wk in f64)."""
        return {f: t.cpu().to(torch.float64).numpy() if f == "wk"
                else t.cpu().numpy() for f, t in self._state.items()}

    def _upload(self, a: np.ndarray) -> torch.Tensor:
        """Host array -> device tensor without waiting for the device
        (pinned staging on the card)."""
        t = torch.from_numpy(a)
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    # -- ingestion -----------------------------------------------------------

    def ingest(self, tenant_ids, values) -> int:
        """Apply a batch of (tenant, value) arrivals.

        Arrivals are grouped into rounds of at most one arrival per tenant
        (stable order: the k-th arrival for a tenant lands in round k, so
        per-tenant arrival order is preserved) and the rounds run back to
        back on the device, with no host sync between them. NaN values are
        legal — they mask every window touching them for that tenant,
        exactly like a NaN appended to `StreamingProfile`. Returns the
        number of arrivals applied."""
        tid = _host(tenant_ids, np.int64)
        val = _host(values, np.float64)
        if tid.ndim != 1 or val.ndim != 1:
            raise ValueError("tenant_ids and values must be scalars or 1-D")
        if tid.size == 1 and val.size > 1:
            tid = np.full(val.shape, tid[0])
        if tid.shape != val.shape:
            raise ValueError(f"tenant_ids/values length mismatch: "
                             f"{tid.shape} vs {val.shape}")
        if tid.size == 0:
            return 0
        if tid.min() < 0 or tid.max() >= self.n:
            raise ValueError(f"tenant ids must be in [0, {self.n})")
        order = np.argsort(tid, kind="stable")
        st, sv = tid[order], val[order]
        # round of each arrival = its occurrence number within its tenant
        idx = np.arange(st.size)
        first = np.r_[True, st[1:] != st[:-1]]
        rounds = idx - np.maximum.accumulate(np.where(first, idx, 0))
        nr = int(rounds.max()) + 1
        vmat = np.zeros((nr, self.n), np.float64)
        amat = np.zeros((nr, self.n), np.bool_)
        vmat[rounds, st] = sv
        amat[rounds, st] = True
        # epoch restarts, round by round, from the host count mirror
        cnt = self._cnt_host
        restarts = {}                     # round -> restarting rows
        for r in range(nr):
            full = amat[r] & (cnt == self.capacity)
            if full.any():
                restarts[r] = np.flatnonzero(full)
                cnt[restarts[r]] = self.m - 1
            cnt += amat[r]
        vdev, adev = self._upload(vmat), self._upload(amat)
        for r in range(nr):
            if r in restarts:
                self._restart(self._upload(restarts[r]))
            self._round(vdev[r], adev[r])
        self._ingests += 1
        return int(val.size)

    def _restart(self, rows: torch.Tensor) -> None:
        """Epoch restart of `rows`: carry the trailing m-1 samples to the
        buffer's front and reset their profile state. Stale wk/aux/ok slots
        are not cleared: slots refill from 0 and the admissibility mask
        (col <= j - excl) excludes every slot not yet rewritten."""
        s = self._state
        s["buf"][rows] = torch.roll(s["buf"][rows], -self.lcap, dims=1)
        s["cnt"][rows] = self.m - 1
        s["epoch"][rows] += 1
        for f, unset in _UNSET.items():
            s[f].index_fill_(0, rows, unset)

    def _sqdist(self, wkj: torch.Tensor, auxj: torch.Tensor) -> torch.Tensor:
        """(N, 1, m) new windows against each tenant's cached ones -> (N,
        lcap) squared distances, through the shared block kernels, in
        tenant chunks of at most `BLOCK_ELEMENTS` product elements."""
        from repro_torch.core import zstats

        s = self._state
        out = torch.empty((self.n, self.lcap), dtype=torch.float64,
                          device=self.device)
        step = max(1, self.BLOCK_ELEMENTS // (self.lcap * self.m))
        for a in range(0, self.n, step):
            b = a + step
            wk = s["wk"][a:b].to(torch.float64)  # no copy when already f64
            if self.normalize:
                d2 = zstats.sqdist_znorm_from_parts(
                    wkj[a:b], auxj[a:b], wk, s["aux"][a:b], window=self.m)
            else:
                d2 = zstats.sqdist_nonnorm_from_parts(
                    wkj[a:b], auxj[a:b], wk, s["aux"][a:b])
            out[a:b] = d2[:, 0]
        return out

    def _round(self, v: torch.Tensor, act: torch.Tensor) -> None:
        """One round across ALL tenants: `v`/`act` are (N,). Mirrors
        `StreamingProfile.append` of one point, on the shared block
        kernels; rows without a new complete window change nothing but
        their buffer and counts."""
        from repro_torch.core import zstats

        s = self._state
        m, cap, lcap = self.m, self.capacity, self.lcap
        dev = self.device
        rows = torch.arange(self.n, device=dev)
        # -- write the arrival ---------------------------------------------
        wpos = s["cnt"].clamp(0, cap - 1).long()
        s["buf"][rows, wpos] = torch.where(act, v, s["buf"][rows, wpos])
        s["cnt"] += act
        s["total"] += act
        # -- new complete window? ------------------------------------------
        j = s["cnt"] - m              # (N,) epoch-local subsequence index
        gate = act & (j >= 0)
        sj = j.clamp(0, lcap - 1).long()
        start = j.clamp(0, cap - m).long()
        w = s["buf"].gather(
            1, start[:, None] + torch.arange(m, device=dev))[:, None]
        okj = zstats.window_finite_mask(w)[:, 0]               # (N,)
        if self.normalize:
            wkj, auxj = zstats.centered_block(w)          # (N,1,m), (N,1)
        else:
            wkj, auxj = w, zstats.window_sumsq(w)
        d2 = self._sqdist(wkj, auxj)                           # (N, lcap)
        # admissible: col <= j - excl (also excludes stale post-restart
        # slots, whose indices exceed j); masked windows never pair; rows
        # without a new window take no update at all
        adm = torch.arange(lcap, device=dev)[None, :] <= (j - self.excl)[:, None]
        d2.masked_fill_(~(adm & okj[:, None] & s["ok"] & gate[:, None]),
                        torch.inf)
        # row min -> the new subsequence's merged AND left entry (final)
        rb = torch.argmin(d2, dim=1)                           # first min
        rv = d2.gather(1, rb[:, None])[:, 0]
        has = torch.isfinite(rv)
        set_p = torch.where(has, rv, torch.inf)
        set_i = torch.where(has, rb.int(), -1)

        def put(f, val):              # slot sj of the gated rows, in place
            g = gate if val.ndim == 1 else gate[:, None]
            s[f][rows, sj] = torch.where(g, val, s[f][rows, sj])

        put("wk", wkj[:, 0].to(s["wk"].dtype))
        put("aux", auxj[:, 0])
        put("ok", okj)
        for f in ("prof", "lprof"):
            put(f, set_p)
        for f in ("pidx", "lidx"):
            put(f, set_i)
        # column mins -> existing entries improve (right-side, strict <)
        jc = j[:, None]
        for pf, xf in (("prof", "pidx"), ("rprof", "ridx")):
            upd = d2 < s[pf]
            torch.where(upd, d2, s[pf], out=s[pf])
            torch.where(upd, jc, s[xf], out=s[xf])

    # -- results -------------------------------------------------------------

    def _check_tenant(self, t: int) -> int:
        if not 0 <= t < self.n:
            raise ValueError(f"tenant must be in [0, {self.n}), got {t}")
        return t

    def _result(self, d: dict, l: int):
        from repro_torch.core.result import ProfileResult

        return ProfileResult(
            p=d["prof"][:l], i=d["pidx"][:l],
            left_p=d["lprof"][:l], left_i=d["lidx"][:l],
            right_p=d["rprof"][:l], right_i=d["ridx"][:l],
            kind="self", window=self.m, exclusion=self.excl,
            normalize=self.normalize, backend="fleet")

    def _fields_out(self, rows) -> dict:
        """The six profile fields of `rows`, distances sqrt'd (f64) and
        indices int64: new tensors, so later ingests never change them."""
        from repro_torch.core.zstats import sqdist_to_dist

        s = self._state
        out = {}
        for f in _UNSET:
            a = s[f][rows]
            out[f] = (sqdist_to_dist(a) if a.dtype == torch.float64
                      else a.to(torch.int64))
        return out

    def snapshot(self, tenant: int | None = None):
        """Per-tenant profile-so-far as `ProfileResult`s (merged + the
        left/right split, epoch-local indices) of f64/int64 tensors on the
        fleet's device. `tenant=None` returns a list over the whole fleet,
        reading the profile fields once; otherwise one result, reading only
        that tenant's rows and count. Masked/unset entries stay inf/-1."""
        cnt = self._state["cnt"]
        if tenant is not None:
            t = self._check_tenant(int(tenant))
            l = max(0, int(cnt[t]) - self.m + 1)
            return self._result(self._fields_out(t), l)
        counts = cnt.cpu().numpy()
        d = self._fields_out(slice(None))
        return [self._result({f: a[t] for f, a in d.items()},
                             max(0, int(counts[t]) - self.m + 1))
                for t in range(self.n)]

    @property
    def counts(self) -> np.ndarray:
        """Samples in each tenant's current epoch (i32, shape (N,))."""
        return self._state["cnt"].cpu().numpy().copy()

    @property
    def totals(self) -> np.ndarray:
        """Lifetime arrivals per tenant (i64, shape (N,))."""
        return self._state["total"].cpu().numpy().copy()

    @property
    def epochs(self) -> np.ndarray:
        """Completed capacity restarts per tenant (i32, shape (N,))."""
        return self._state["epoch"].cpu().numpy().copy()

    # -- checkpoint / elastic rescale ---------------------------------------

    def save(self, directory: str, *, keep: int = 3, injector=None) -> str:
        """Checkpoint the whole fleet via `checkpoint.ckpt` format 2 (crc32
        manifest, atomic commit), in the reference's keys, metadata and
        dtypes. `injector` threads a chaos-test `FaultInjector` through the
        writer. Returns the step directory."""
        from repro_torch.checkpoint import ckpt

        meta = dict(n=self.n, window=self.m, capacity=self.capacity,
                    exclusion=self.excl, normalize=self.normalize,
                    ingests=self._ingests, stream=self._wk_stream)
        return ckpt.save(directory, step=self._ingests, tree=self._to_host(),
                         keep=keep, metadata=meta, injector=injector)

    @classmethod
    def restore(cls, directory: str, *, step: int | None = None,
                device=None):
        """Rebuild a fleet on `device` from the newest intact checkpoint
        (or a pinned `step`), falling back past corrupted steps like every
        other `ckpt.restore` caller. Returns (fleet, step)."""
        from repro_torch.checkpoint import ckpt
        from repro_torch.core.precision import PrecisionSpec

        tree_like = {f: np.zeros((), _DTYPES[f]) for f in _FIELDS}
        tree, got, meta = ckpt.restore(directory, tree_like, step=step)
        stream = str(meta.get("stream", "float64"))
        prec = (PrecisionSpec(stream=stream)
                if stream not in ("float32", "float64") else None)
        fleet = cls(n=int(meta["n"]), window=int(meta["window"]),
                    capacity=int(meta["capacity"]),
                    exclusion=int(meta["exclusion"]),
                    normalize=bool(meta["normalize"]), precision=prec,
                    device=device)
        fleet._ingests = int(meta["ingests"])
        fleet._set_host_state(tree)
        return fleet, got

    def rescale(self, n_new: int) -> "StreamingFleet":
        """Elastically resize the fleet in place: grow appends fresh
        tenants (empty state), shrink drops the highest-numbered tenants.
        Surviving tenants' state is untouched (bitwise). Returns self."""
        n_new = int(n_new)
        if n_new < 1:
            raise ValueError(f"n must be >= 1, got {n_new}")
        if n_new == self.n:
            return self
        if n_new < self.n:
            self._state = {f: t[:n_new].clone()
                           for f, t in self._state.items()}
            self._cnt_host = self._cnt_host[:n_new].copy()
        else:
            fresh = self._init_state(n_new - self.n)
            self._state = {f: torch.cat([t, fresh[f]])
                           for f, t in self._state.items()}
            self._cnt_host = np.concatenate(
                [self._cnt_host, np.zeros(n_new - self.n, np.int64)])
        self.n = n_new
        return self
