"""The collectives the port's layouts issue, and the dry-run, on a fake 2 x
2 group in one process (`launch.mesh.start_fake_group`).

The train-mode forward of each smoke config at (2, 16) tokens under TP
rules is traced by the dry-run's tally and held against the reference's
compiled HLO for the same forward (4 forced host devices). XLA lists the
scanned layer body once, so the reference's per-step count multiplies
its body's collectives by the layer count. The dense families
(llama3-8b, qwen2-7b, qwen2-vl-2b) and olmoe-1b-7b issue all-reduces
only: one for the vocab-parallel embedding and one after each
attention's and each FFN's output projection (the MoE's two more are its
aux mean, 4 bytes each), and their wire bytes are at most the
reference's. The other families' counts and wire bytes are recorded; the
port's all-gathers and all-to-alls are bounded by the reference's
(DTensor's CPU groups run the MLA up-projections' shard move, an
all-to-all on the card, as an all-gather). The weights each forward
gathers per use are named (from the local shard shapes of the
all-gathers' inputs) and held to the forced moves of ROADMAP.md §C (25).
Three heads on the 2-way model axis (`h3`, `mh3`) cut a head: there a
rank fetches the columns its heads need from its neighbour by one
all-to-all of activations, where the reference's HLO gathers q, k and v
whole. The dry-run's records carry the reference's keys, their FLOPs per
rank are the local shards' (a dense layer's: a quarter of the global
count), and `launch.report` renders both tables."""

import pytest

from _torch_mesh_run import run_reference, run_suite
from _torch_mesh_worker import TRACE_ARCHS, smoke

DENSE_AR_ONLY = ["llama3-8b", "qwen2-7b", "qwen2-vl-2b", "olmoe-1b-7b"]
REF_KEYS = {"arch", "shape", "mesh", "layout", "memory", "cost_raw",
            "collectives_raw", "timings", "per_layer", "head",
            "reconstructed", "model_flops", "roofline", "ok"}


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_trace")
    return run_suite("trace", tmp), run_reference(tmp, "trace")["trace"]


def _ref_step(ref):
    """The reference's per-step collectives: the scan body's times the
    layer count."""
    n = ref["layer_groups"][2]
    out = []
    for kind, nbytes, wire, body in ref["collectives"]:
        out += [(kind, nbytes, wire)] * (n if body else 1)
    return out


@pytest.mark.parametrize("arch", DENSE_AR_ONLY)
def test_dense_tp_forward_lowers_to_megatron_all_reduces(both, arch):
    port, ref = both
    colls = port[arch]
    kinds = [c[0] for c in colls]
    assert set(kinds) == {"all-reduce"}
    big = [c for c in colls if c[1] > 4]
    # the embedding's, then one per attention block and one per FFN block
    assert len(big) == 1 + 2 * 2
    assert all(c[1] == 4096 for c in big[1:])
    wire = sum(c[3] for c in colls)
    ref_wire = sum(c[2] for c in _ref_step(ref[arch]))
    assert wire <= ref_wire
    assert [c[0] for c in _ref_step(ref[arch])] == ["all-reduce"] * 5


@pytest.mark.parametrize("arch", TRACE_ARCHS)
def test_all_gathers_bounded_by_reference(both, arch):
    port, ref = both
    step = _ref_step(ref[arch])
    moves = ("all-gather", "all-to-all")
    n_ag = sum(1 for c in port[arch] if c[0] in moves)
    ref_ag = sum(1 for c in step if c[0] in moves)
    assert n_ag <= ref_ag
    assert sum(c[3] for c in port[arch]) <= sum(c[2] for c in step)


# the weights a forward gathers per use (ROADMAP.md §C (25)): MLA's
# latent down-projections and up-projections, stored split on r and dr
# and computed whole (and, where the heads do not split, its q
# up-projection, stored split on the head dim); RWKV6's u (H x K) where
# its heads do not split. No other weight moves.
MLA_MOVES = {"wdkv", "wkr", "wuk", "wuv"}
FORCED = {"deepseek-v2-lite-16b": MLA_MOVES, "minicpm3-4b": MLA_MOVES,
          "minicpm3-4b/h3": MLA_MOVES | {"wuq"}, "rwkv6-3b/h3": {"u"}}


@pytest.mark.parametrize("arch", TRACE_ARCHS)
def test_weights_gathered_per_use_are_the_forced_moves(both, arch):
    port, _ = both
    assert set(port[f"{arch}|gathered_weights"]) == FORCED.get(arch, set())


# three heads of 16 on the 2-way model axis: a rank's column shard of wq
# holds 1.5 heads
UNEVEN = ["llama3-8b/h3", "llama3-8b/mh3", "whisper-large-v3/h3"]


@pytest.mark.parametrize("arch", UNEVEN)
def test_heads_cut_by_the_model_axis_exchange_activations(both, arch):
    """Each attention block fetches the columns of the q, k and v heads its
    rank reads that its neighbour's shard holds: three all-to-alls of
    activations (no weight moves, as above), and no all-gather. Where the
    reference gathers q, k and v (three KV heads), the port's wire is
    less than its gathers'."""
    port, ref = both
    cfg = smoke(arch)
    colls = port[arch]
    n_attn = cfg.n_layers * (2 if cfg.is_encdec else 1) + (
        cfg.encoder_layers if cfg.is_encdec else 0)
    assert sum(c[0] == "all-to-all" for c in colls) == 3 * n_attn
    assert not any(c[0] == "all-gather" for c in colls)
    if cfg.n_kv_heads == cfg.n_heads:
        ref_ag = [c for c in _ref_step(ref[arch]) if c[0] == "all-gather"]
        assert len(ref_ag) == 3 * n_attn
        assert (sum(c[3] for c in colls if c[0] == "all-to-all")
                < sum(c[2] for c in ref_ag))


def test_dryrun_records_carry_the_reference_keys(both):
    port, _ = both
    for key, rec in port["records"].items():
        assert rec["ok"], (key, rec.get("error"))
        assert set(rec) == REF_KEYS, key
        assert set(rec["memory"]) == {"argument_gb", "output_gb", "temp_gb",
                                      "code_gb", "alias_gb"}
        assert set(rec["per_layer"][0]) == {"name", "flops", "bytes",
                                            "wire_bytes", "repeat"}
        assert rec["roofline"]["n_chips"] == 4
        assert rec["reconstructed"]["flops_per_chip"] == pytest.approx(
            sum(p["flops"] * p["repeat"] for p in rec["per_layer"])
            + rec["head"]["flops"])


def test_dryrun_flops_are_the_local_shards(both):
    """A dense smoke layer's prefill FLOPs on one rank of the 2 x 2 mesh
    are a quarter of the layer's global count (batch over data, heads and
    the FFN over model; the norms count no FLOPs)."""
    port, _ = both
    layer = port["records"]["llama3-8b|prefill"]["per_layer"][0]
    assert layer["repeat"] == 2
    assert layer["flops"] == pytest.approx(
        port["dense_layer_global_flops"] / 4, rel=1e-9)


def test_report_renders_both_tables(both):
    port, _ = both
    text = port["report"]
    assert "### Dry-run table" in text and "### Roofline table" in text
    assert "| llama3-8b | smoke_prefill | single | ok |" in text
