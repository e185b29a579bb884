"""Atomic npz pytree checkpoints with keep-k retention and restart — port
of `repro.checkpoint.ckpt`, format 2, byte for byte.

The layout is the reference's, so each package restores the other's
checkpoints: step-numbered directories, atomic rename commit, a LATEST
pointer written last, corrupt/partial checkpoints ignored on restore.
Trees are nested dicts, lists and tuples with array leaves (numpy arrays,
numpy scalars or torch tensors on any device).

Checkpoint layout (one directory per step, `step_%010d/`):

  arrays.npz   — flattened tree leaves, keyed by "/".join(path): dict keys
                 in sorted order, list/tuple positions as their index —
                 the names `jax.tree_util.tree_flatten_with_path` gives
  meta.json    — {"format":    int, format tag of the writer (FORMAT here);
                                format-1 files (no tag) still restore, just
                                without checksum verification,
                  "step":      int,
                  "metadata":  caller dict,
                  "keys":      sorted array names — restore verifies these
                               against the npz contents, so a truncated
                               archive is DETECTED, not KeyError'd,
                  "checksums": name -> crc32 of the raw array bytes —
                               silent bit-rot is detected on restore}

Tensor leaves are written as host numpy arrays of their dtype. A bf16
tensor has no numpy dtype: it is written as its raw 2-byte words with the
void dtype `|V2`, which is what `np.savez` stores for the reference's
bf16 (ml_dtypes) leaves, so the bytes and checksums agree. On restore a
tensor leaf of `tree_like` comes back as a tensor of its dtype on its
device (a `|V2` array into a bf16 leaf by reinterpreting the words); a
numpy leaf comes back as numpy.

`restore()` verifies the requested step and, when verification fails and no
explicit `step` was pinned, falls back to the NEWEST OLDER intact step with
a warning (losing at most the interval between the two) instead of raising.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import tempfile
import warnings
import zlib

import numpy as np
import torch

from repro_torch.core.faults import CheckpointCorruptionError

__all__ = ["FORMAT", "CheckpointCorruptionError", "save", "restore",
           "all_steps", "latest_step"]

#: Format written by `save`. Format 2 adds per-array crc32 checksums.
FORMAT = 2


def _leaves_with_paths(tree, path=()):
    """(path, leaf) pairs in the reference's flattening order: dict keys
    sorted, list/tuple entries in order, None holding no leaf."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves_with_paths(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves_with_paths(v, path + (i,))
    elif tree is not None:
        yield path, tree


def _key(path) -> str:
    return "/".join(str(p) for p in path)


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.dtype("V2"))
        return t.numpy()
    return np.asarray(leaf)


def _flatten_with_paths(tree) -> dict:
    return {_key(p): _to_numpy(leaf) for p, leaf in _leaves_with_paths(tree)}


def _crc32(a: np.ndarray) -> int:
    return zlib.crc32(np.ascontiguousarray(a).tobytes())


def save(directory: str, step: int, tree, *, keep: int = 3,
         metadata: dict | None = None, injector=None) -> str:
    """Atomically write checkpoint `step`; prune to the newest `keep`.

    `injector` threads a chaos-test `faults.FaultInjector` through the
    writer: `on_checkpoint_write(step)` fires BEFORE anything touches disk
    (a kill there loses only this save — prior steps stay intact), and
    `after_checkpoint_write(step, <arrays.npz>)` fires after the atomic
    commit so scheduled bit-flips corrupt a COMMITTED file, exercising the
    crc32-verify + fall-back path in `restore`.
    """
    if injector is not None:
        injector.on_checkpoint_write(step)
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:010d}")
    tmp = tempfile.mkdtemp(dir=directory, prefix=".tmp_ckpt_")
    try:
        arrays = _flatten_with_paths(tree)
        np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump({"format": FORMAT, "step": step,
                       "metadata": metadata or {},
                       "keys": sorted(arrays),
                       "checksums": {k: _crc32(a)
                                     for k, a in arrays.items()}}, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    if injector is not None:
        injector.after_checkpoint_write(step, os.path.join(final,
                                                           "arrays.npz"))
    with open(os.path.join(directory, "LATEST.tmp"), "w") as f:
        f.write(str(step))
    os.replace(os.path.join(directory, "LATEST.tmp"),
               os.path.join(directory, "LATEST"))
    _prune(directory, keep)
    return final


def _prune(directory: str, keep: int) -> None:
    steps = all_steps(directory)
    for s in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(os.path.join(directory, f"step_{s:010d}"),
                      ignore_errors=True)


def all_steps(directory: str) -> list[int]:
    if not os.path.isdir(directory):
        return []
    out = []
    for name in os.listdir(directory):
        m = re.fullmatch(r"step_(\d{10})", name)
        if m and os.path.exists(os.path.join(directory, name, "meta.json")):
            out.append(int(m.group(1)))
    return sorted(out)


def latest_step(directory: str) -> int | None:
    """Prefer the LATEST pointer; fall back to scanning (pointer may be
    stale if a node died mid-commit — scanning skips partial dirs)."""
    steps = all_steps(directory)
    ptr = os.path.join(directory, "LATEST")
    if os.path.exists(ptr):
        try:
            with open(ptr) as f:
                s = int(f.read().strip())
            if s in steps:
                return s
        except (ValueError, OSError):
            pass
    return steps[-1] if steps else None


def _load_step(directory: str, step: int) -> tuple[dict, dict]:
    """Load + verify one step directory -> (arrays, meta). Raises
    `CheckpointCorruptionError` on any verification failure."""
    path = os.path.join(directory, f"step_{step:010d}")
    try:
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
    except (OSError, ValueError) as e:
        raise CheckpointCorruptionError(
            f"step {step}: unreadable meta.json: {e}") from e
    try:
        with np.load(os.path.join(path, "arrays.npz")) as z:
            arrays = {k: z[k] for k in z.files}
    except Exception as e:  # BadZipFile, zlib errors, truncation, OSError
        raise CheckpointCorruptionError(
            f"step {step}: unreadable arrays.npz: {e}") from e
    keys = meta.get("keys")
    if keys is not None and sorted(keys) != sorted(arrays):
        missing = sorted(set(keys) - set(arrays))
        extra = sorted(set(arrays) - set(keys))
        raise CheckpointCorruptionError(
            f"step {step}: arrays.npz does not match meta keys "
            f"(missing {missing}, unexpected {extra}) — truncated or "
            f"mixed-up checkpoint")
    if int(meta.get("format", 1)) >= 2:
        for name, want in meta.get("checksums", {}).items():
            got = _crc32(arrays[name])
            if got != int(want):
                raise CheckpointCorruptionError(
                    f"step {step}: checksum mismatch for array {name!r} "
                    f"(stored {want}, recomputed {got}) — silent disk "
                    f"corruption")
    return arrays, meta


def _like(a: np.ndarray, leaf):
    """Array `a` in the type of the `tree_like` leaf: a tensor of its dtype
    on its device, or a numpy array of its dtype."""
    if isinstance(leaf, torch.Tensor):
        # `ascontiguousarray` turns a 0-d array into a 1-d one
        a = np.ascontiguousarray(a).reshape(a.shape)
        if leaf.dtype == torch.bfloat16 and a.dtype == np.dtype("V2"):
            t = torch.from_numpy(a.view(np.int16))
            return t.view(torch.bfloat16).to(leaf.device)
        return torch.from_numpy(a).to(device=leaf.device, dtype=leaf.dtype)
    if hasattr(leaf, "dtype"):
        return a.astype(leaf.dtype)
    return a


def _unflatten_like(tree_like, arrays: dict, step: int, path=()):
    if isinstance(tree_like, dict):
        return {k: _unflatten_like(v, arrays, step, path + (k,))
                for k, v in tree_like.items()}
    if isinstance(tree_like, (list, tuple)):
        out = [_unflatten_like(v, arrays, step, path + (i,))
               for i, v in enumerate(tree_like)]
        return out if isinstance(tree_like, list) else type(tree_like)(out)
    if tree_like is None:
        return None
    key = _key(path)
    if key not in arrays:
        raise CheckpointCorruptionError(
            f"step {step}: array {key!r} required by the restore "
            f"target is missing from the checkpoint")
    return _like(arrays[key], tree_like)


def restore(directory: str, tree_like, *, step: int | None = None):
    """Restore into the structure of `tree_like`. Returns (tree, step,
    metadata); raises FileNotFoundError if no usable checkpoint exists.

    The loaded step is VERIFIED (meta keys vs npz contents, crc32
    checksums). When the newest step fails verification and `step` was not
    pinned, restore warns and falls back to the next older intact step;
    a pinned `step` that fails raises `CheckpointCorruptionError`.
    """
    pinned = step is not None
    step = latest_step(directory) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoint in {directory}")
    candidates = ([step] if pinned else
                  [s for s in reversed(all_steps(directory)) if s <= step]
                  or [step])
    arrays = meta = None
    for i, s in enumerate(candidates):
        try:
            arrays, meta = _load_step(directory, s)
            step = s
            break
        except CheckpointCorruptionError as e:
            if pinned or i == len(candidates) - 1:
                raise
            warnings.warn(
                f"checkpoint {e}; falling back to an older step",
                stacklevel=2)
    return (_unflatten_like(tree_like, arrays, step), step,
            meta.get("metadata", {}))
