"""Guards of the port: it imports no jax and nothing of `repro`, it never
falls back to the CPU quietly, and a CUDA tensor reaches the kernel or an
error — never the plain version. The `gpu`-marked tests hold each CUDA
kernel against its plain version, and the band engine against the kernel
path, on the card and skip elsewhere; this file imports no jax, so they run
where jax is not installed.
"""

import ast
import pathlib

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.core import matrix_profile
from repro_torch.kernels import _build, flash_attn, natsa_mp, ops
from repro_torch.utils.device import resolve_device

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _imported_roots(path: pathlib.Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax_and_no_reference(path):
    bad = _imported_roots(path) & {"jax", "jaxlib", "repro"}
    assert not bad, f"{path} imports {sorted(bad)}"


def test_scan_covers_the_package():
    names = {p.name for p in PORT_FILES}
    assert {"natsa_mp.py", "flash_attn.py", "ref.py", "ops.py", "plan.py",
            "zstats.py", "matrix_profile.py", "chip_smoke.py"} <= names
    assert repro_torch.resolve_device is resolve_device


def test_entry_point_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ts = np.cumsum(np.random.default_rng(0).normal(size=200))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        matrix_profile(ts, 16)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda:0")
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("meta")


def test_non_cpu_tensor_never_reaches_the_plain_version(monkeypatch):
    def failing_build(name):
        raise RuntimeError(f"build of {name} failed")

    def plain_called(*a, **k):
        raise AssertionError("plain version reached for a device tensor")

    monkeypatch.setattr(_build, "load", failing_build)
    monkeypatch.setattr(natsa_mp, "rowmax_profile_ab_plain", plain_called)
    z = torch.zeros(64, device="meta")
    with pytest.raises(RuntimeError, match="build of natsa_mp failed"):
        natsa_mp.rowmax_profile_ab(z, z, z, z, z, z, z[:8], k_start=0,
                                   k_end=8, l_i=32, l_j=32)


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(_build, "_LOADED", {})
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.load("natsa_mp")


def test_build_is_keyed_by_source_and_flags(monkeypatch):
    a = _build._target("natsa_mp")
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-G",))
    assert _build._target("natsa_mp") != a
    assert a.parent == _build.BUILD_DIR and a.name.startswith("libnatsa_mp_")


def _cases(device):
    """(args, kwargs) of kernel calls — the cases `chip_smoke.py` checks:
    a self-join with l not a multiple of any tile, NaN gaps, bf16 streams,
    and the spans of an AB join (short side on rows) with exclusion 0 and
    32."""
    from repro_torch.core.zstats import (
        compute_cross_stats_host, compute_stats_host,
    )

    rng = np.random.default_rng(1)
    m = 128
    gaps = np.cumsum(rng.normal(size=16384))
    gaps[[1000, 5000, 12000]] = np.nan
    for ts, dtype in ((np.cumsum(rng.normal(size=16384)), torch.float32),
                      (gaps, torch.float32),
                      (np.cumsum(rng.normal(size=16384)), torch.bfloat16)):
        stats = compute_stats_host(ts, m, out_dtype=dtype, device=device)
        df, dg, invn, cov0p, n_rows, _, l = ops._pad_streams(stats, 256, 8,
                                                             32)
        rows = n_rows * 256
        yield ((df[:rows], dg[:rows], invn[:rows], df, dg, invn, cov0p),
               dict(k_start=32, k_end=l, l_i=l, l_j=l, jpad=0))
    a, b = np.cumsum(rng.normal(size=16384)), np.cumsum(rng.normal(size=4096))
    cross = compute_cross_stats_host(b, a, m, device=device)
    for excl in (0, 32):
        for s0, s1 in ops.ab_spans(cross.l_a, cross.l_b, excl):
            *args, _, _, jpad = ops._pad_streams_ab(cross, 256, 8, s0, s1)
            yield tuple(args), dict(k_start=s0, k_end=s1, l_i=cross.l_a,
                                    l_j=cross.l_b, jpad=jpad)


@pytest.mark.gpu
def test_cuda_kernel_matches_plain_version_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (and nvcc) to run the NATSA kernel")
    before = natsa_mp.LAUNCHES
    n = 0
    for args, kw in _cases("cuda"):
        kern = natsa_mp.rowmax_profile_ab(*args, **kw)
        plain = natsa_mp.rowmax_profile_ab_plain(*args, **kw)
        torch.cuda.synchronize()
        for (ck, ik), (cp, ip) in (((kern[0], kern[1]), (plain[0], plain[1])),
                                   ((kern[2], kern[3]), (plain[2], plain[3]))):
            err = (ck - cp).abs()
            assert float(err.max()) <= 1e-4
            assert not bool(((ik != ip) & (err >= 1e-4)).any())
        n += 1
    assert natsa_mp.LAUNCHES - before == n


FLASH_SHAPES = [                    # the reference's table
    (2, 2, 128, 32, 64, 64, True),
    (1, 4, 256, 16, 128, 64, True),
    (2, 1, 128, 64, 32, 128, True),
    (1, 2, 128, 32, 64, 64, False),
    (1, 1, 64, 8, 64, 64, True),
]
FLASH_ODD_TILES = [                 # S % 128 != 0: the kernel's masked tile
    (1, 2, 96, 40, 32, 48, True),
    (1, 1, 96, 24, 16, 96, False),
    (2, 1, 80, 128, 16, 40, True),
]


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (and nvcc) to run the CUDA kernels")


def _qkv_on_card(shape, seed, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
            .to("cuda", dtype) for _ in range(3)]


@pytest.mark.gpu
@pytest.mark.parametrize("b,h,s,d,bq,bk,causal",
                         FLASH_SHAPES + FLASH_ODD_TILES)
def test_flash_kernel_matches_plain_version_on_card(b, h, s, d, bq, bk,
                                                    causal):
    _need_card()
    q, k, v = _qkv_on_card((b, h, s, d), seed=b * 100 + s)
    before = flash_attn.LAUNCHES
    out = flash_attn.flash_attention(q, k, v, bq=bq, bk=bk, causal=causal)
    torch.cuda.synchronize()
    assert flash_attn.LAUNCHES == before + 1
    plain = flash_attn.flash_attention_plain(q, k, v, causal=causal)
    torch.testing.assert_close(out, plain, rtol=2e-4, atol=2e-4)


@pytest.mark.gpu
def test_flash_kernel_bf16_and_block_invariance_on_card():
    _need_card()
    q, k, v = _qkv_on_card((1, 2, 128, 32), seed=0, dtype=torch.bfloat16)
    out = flash_attn.flash_attention(q, k, v, bq=64, bk=64)
    assert out.dtype == torch.bfloat16
    plain = flash_attn.flash_attention_plain(q, k, v)
    torch.testing.assert_close(out.float(), plain.float(), rtol=3e-2,
                               atol=3e-2)
    q, k, v = _qkv_on_card((1, 2, 128, 16), seed=7)
    a = flash_attn.flash_attention(q, k, v, bq=32, bk=32)
    b = flash_attn.flash_attention(q, k, v, bq=128, bk=64)
    torch.testing.assert_close(a, b, rtol=0, atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["self", "ab"])
def test_engine_matches_kernel_path_on_card(kind):
    """The band engine (reseeded) against the kernel path on the same
    series: correlations within 1e-4, indices equal except at near-ties."""
    from repro_torch.core import ab_join

    _need_card()
    rng = np.random.default_rng(3)
    m = 64
    a = np.cumsum(rng.normal(size=6000))
    if kind == "self":
        eng = matrix_profile(a, m, band=128, harvest="both")
        ker = matrix_profile(a, m, harvest="both")
        sides = [("p", "i"), ("left_p", "left_i"), ("right_p", "right_i")]
    else:
        b = np.cumsum(rng.normal(size=2500))
        eng = ab_join(a, b, m, band=128, return_b=True)
        ker = ab_join(a, b, m, return_b=True)
        sides = [("p", "i"), ("b_p", "b_i")]
    assert (eng.backend, ker.backend) == ("engine", "kernel")
    for fp, fi in sides:
        ce, ck = (1.0 - getattr(r, fp).double() ** 2 / (2 * m)
                  for r in (eng, ker))
        fin = torch.isfinite(ce)
        assert torch.equal(fin, torch.isfinite(ck))
        err = (ce[fin] - ck[fin]).abs()
        assert float(err.max()) <= 1e-4
        mism = (getattr(eng, fi) != getattr(ker, fi))[fin]
        assert not bool((mism & (err >= 1e-4)).any())
