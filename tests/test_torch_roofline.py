"""The port's roofline model (`repro_torch.launch.roofline`,
`repro_torch.kernels.ops.hbm_bytes_per_cell` / `kernel_roofline`) against
the reference's (`tests/test_roofline_tools.py`), on the CPU.

The formulas are the reference's; the rates are the H100 SXM's. So the
byte counts equal the reference's exactly wherever both regime rules (the
reference's TPU VMEM budget, the port's L2) pick the same regime, and the
times are the same bytes and FLOPs over the card's rates (1e-12 relative).
"""

import pytest

from repro.kernels import ops as rops
from repro.launch import roofline as rroofline
from repro_torch.kernels import DEFAULT_DT, DEFAULT_IT, ops
from repro_torch.launch import roofline

# ecg-256k (src/repro/configs/natsa.py:17): n = 262144, m = 512, exclusion
# 128; PERF.md's NATSA bound, 9 FLOP a cell at 67 TFLOP/s
ECG_L, ECG_EXCL, ECG_BOUND_MS = 262144 - 512 + 1, 128, 4.593


def test_shape_bytes():
    assert roofline.shape_bytes("bf16[2048,4096]") == 2048 * 4096 * 2
    assert roofline.shape_bytes("f32[8]") == 32
    assert roofline.shape_bytes("(f32[4,4], bf16[2,2])") == 64 + 8
    assert roofline.shape_bytes("pred[16]") == 16
    for s in ("bf16[2048,4096]", "(f32[4,4], bf16[2,2])", "s4[7], token[]"):
        assert roofline.shape_bytes(s) == rroofline.shape_bytes(s)


def test_the_rates_are_the_cards():
    assert (roofline.PEAK_FLOPS, roofline.FP32_PEAK, roofline.HBM_BW,
            roofline.NVLINK_BW, roofline.L2_BYTES) == (
        989e12, 67e12, 3.35e12, 450e9, 50 * 2**20)


def test_roofline_terms_bottleneck():
    t = roofline.RooflineTerms(flops_per_chip=989e12, bytes_per_chip=0,
                               wire_bytes_per_chip=0,
                               model_flops_total=989e12, n_chips=1)
    assert t.bottleneck == "compute" and t.t_compute == pytest.approx(1.0)
    assert t.mfu_bound == pytest.approx(1.0)
    t2 = roofline.RooflineTerms(flops_per_chip=0, bytes_per_chip=3.35e12,
                                wire_bytes_per_chip=90e9,
                                model_flops_total=1.0, n_chips=1)
    assert t2.bottleneck == "memory"      # 1.0 s vs 0.2 s collective
    assert t2.t_collective == pytest.approx(0.2)
    t3 = roofline.RooflineTerms(flops_per_chip=0, bytes_per_chip=0,
                                wire_bytes_per_chip=450e9,
                                model_flops_total=1.0, n_chips=1)
    assert t3.bottleneck == "collective"
    # the peak a term's FLOPs run at is the terms' own
    f32 = roofline.RooflineTerms(flops_per_chip=67e12, bytes_per_chip=0,
                                 wire_bytes_per_chip=0,
                                 model_flops_total=67e12, n_chips=1,
                                 peak_flops=roofline.FP32_PEAK)
    assert f32.t_compute == pytest.approx(1.0)
    assert f32.mfu_bound == pytest.approx(1.0)
    assert f32.to_dict()["peak_flops"] == roofline.FP32_PEAK
    ref = rroofline.RooflineTerms(1.0, 2.0, 3.0, 4.0, 2).to_dict()
    assert list(t.to_dict()) == list(ref) + ["peak_flops"]


def test_kernel_roofline_regimes():
    small = ops.kernel_roofline(131072, 64, 512, 32)
    big = ops.kernel_roofline(2097152, 64, 512, 32)
    assert small["resident"] and not big["resident"]
    assert small["bytes_per_cell"] < 0.01 < big["bytes_per_cell"]
    assert small["t_compute_s"] > small["t_memory_s"]      # compute-bound
    # tile hillclimb direction
    worse = ops.kernel_roofline(2097152, 64, 256, 8)
    assert big["bytes_per_cell"] < worse["bytes_per_cell"]
    assert set(small) == (set(rops.kernel_roofline(131072, 64, 512, 32))
                          - {"vmem_bytes"}) | {"l2_bytes"}


@pytest.mark.parametrize("l,it,dt,stream_bytes,regime", [
    (131072, 512, 32, 4, "resident"),
    (131072, DEFAULT_IT, DEFAULT_DT, 2, "resident"),
    (2097152, 512, 32, 4, "streamed"),
    # 16-bit streams shrink the L2 set (22 bytes a row: 46 MB at 2097152,
    # resident there), not the reference's VMEM model: streamed at 4194304
    (4194304, 512, 32, 2, "streamed"),
])
def test_bytes_equal_the_reference_where_the_regimes_agree(l, it, dt,
                                                           stream_bytes,
                                                           regime):
    excl = 64
    got = ops.kernel_roofline(l, excl, it, dt, stream_bytes=stream_bytes)
    ref = rops.kernel_roofline(l, excl, it, dt, stream_bytes=stream_bytes)
    assert got["resident"] == ref["resident"] == (regime == "resident")
    assert got["cells"] == ref["cells"]
    assert ops.hbm_bytes_per_cell(l, excl, it, dt,
                                  stream_bytes=stream_bytes) == \
        rops.hbm_bytes_per_cell(l, excl, it, dt, stream_bytes=stream_bytes)
    # the same FLOPs and bytes over the card's rates
    assert got["t_compute_s"] == pytest.approx(
        ref["cells"] * rops.FLOPS_PER_CELL / roofline.FP32_PEAK, rel=1e-12)
    assert got["t_memory_s"] == pytest.approx(
        ref["cells"] * ref["bytes_per_cell"] / roofline.HBM_BW, rel=1e-12)


def test_the_regime_rules_differ_between_the_budgets():
    """At l = 1.5e6 (it 512, dt 32) the reference's kernel no longer fits
    a TPU core's 16 MiB VMEM budget (streamed), while the sweep's streams
    and accumulators, 42 MB, fit the H100's 50 MiB L2 (resident)."""
    l, excl, it, dt = 1_500_000, 64, 512, 32
    got = ops.kernel_roofline(l, excl, it, dt)
    ref = rops.kernel_roofline(l, excl, it, dt)
    assert got["resident"] and not ref["resident"]
    assert got["l2_bytes"] == (l + it + dt) * 28 <= roofline.L2_BYTES
    assert ref["vmem_bytes"] > rops.VMEM_BYTES
    assert got["bytes_per_cell"] < ref["bytes_per_cell"] / 100
    assert got["cells"] == ref["cells"]


def test_the_ecg_256k_bound_is_the_tables():
    """At ecg-256k the sweep is compute-bound: 3.42e10 cells of 9 f32 FLOPs
    at 67 TFLOP/s, 4.593 ms (PERF.md's bound); its ~12.6 MB of resident
    bytes take ~4 µs at 3.35 TB/s."""
    k = ops.kernel_roofline(ECG_L, ECG_EXCL, DEFAULT_IT, DEFAULT_DT)
    assert k["resident"]
    assert k["cells"] == (ECG_L - ECG_EXCL) * (ECG_L - ECG_EXCL + 1) / 2
    assert round(1e3 * k["t_compute_s"], 3) == ECG_BOUND_MS
    assert 12.5e6 < k["cells"] * k["bytes_per_cell"] < 12.7e6
    assert 3e-6 < k["t_memory_s"] < 5e-6
    assert ops.sweep_cells(ECG_L, ECG_EXCL) == sum(
        ECG_L - j for j in range(ECG_EXCL, ECG_L))


def test_matrix_profile_roofline_bridges_kernel_model():
    """matrix_profile_roofline == kernel_roofline's terms, expressed as
    RooflineTerms at the f32 peak."""
    l, excl = 131072, 64
    t = roofline.matrix_profile_roofline(l, excl, it=512, dt=32)
    ref = ops.kernel_roofline(l, excl, 512, 32)
    assert t.peak_flops == roofline.FP32_PEAK
    assert t.t_compute == pytest.approx(ref["t_compute_s"])
    assert t.t_memory == pytest.approx(ref["t_memory_s"])
    assert t.wire_bytes_per_chip == 0 and t.t_collective == 0
    # defaults come from the shared kernel constants, not local copies
    t_def = roofline.matrix_profile_roofline(l, excl)
    ref_def = ops.kernel_roofline(l, excl, DEFAULT_IT, DEFAULT_DT)
    assert t_def.t_memory == pytest.approx(ref_def["t_memory_s"])
    # regime verdicts: the resident sweep is compute-bound; past the L2
    # the streamed regime flips memory-bound
    small = roofline.matrix_profile_roofline(16384, 64)
    assert small.bottleneck == "compute"
    big = roofline.matrix_profile_roofline(2097152, 64, it=512, dt=32)
    assert big.bottleneck == "memory"
    assert big.step_time == pytest.approx(big.t_memory)
    # the reference's bytes and FLOPs, where its regime is the same
    rt = rroofline.matrix_profile_roofline(2097152, 64, it=512, dt=32)
    assert (big.flops_per_chip, big.bytes_per_chip) == (rt.flops_per_chip,
                                                        rt.bytes_per_chip)
    assert big.n_chips == rt.n_chips == 1


def test_roofline_fraction():
    l, excl = 131072, 64
    t = roofline.matrix_profile_roofline(l, excl)
    assert roofline.roofline_fraction(l, excl, 2 * t.t_memory) == \
        pytest.approx(0.5)
    with pytest.raises(ValueError, match="positive"):
        roofline.roofline_fraction(l, excl, 0.0)
