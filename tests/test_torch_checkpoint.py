"""The port's format-2 checkpoints (`repro_torch.checkpoint.ckpt`) — twins
of `tests/test_checkpoint.py:38-110` — and their byte contract with the
reference's `repro.checkpoint.ckpt`: the same tree gives the same keys,
dtypes, bytes and crc32 checksums, and each package restores the other's
steps. Every comparison is exact (no tolerance): nothing here computes.
"""

import json
import os
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as rckpt
from repro_torch.checkpoint import ckpt
from repro_torch.core.faults import (CheckpointWriteError, FaultInjector,
                                     flip_bits)

TREE = {"params": {"w": np.arange(24.0).reshape(4, 6),
                   "b": np.ones(6, np.float32)},
        "step_count": np.int64(7)}


def _tensor_tree():
    """TREE with tensor leaves, nested through a list and a tuple."""
    return {"params": {"w": torch.arange(24.0, dtype=torch.float64)
                       .reshape(4, 6),
                       "b": torch.ones(6)},
            "step_count": np.int64(7),
            "opt": [torch.arange(5, dtype=torch.int32),
                    (torch.tensor([True, False]), np.zeros(3, np.int16))]}


def _numpy_tree():
    """`_tensor_tree` as the reference would hold it (numpy leaves)."""
    return {"params": {"w": np.arange(24.0).reshape(4, 6),
                       "b": np.ones(6, np.float32)},
            "step_count": np.int64(7),
            "opt": [np.arange(5, dtype=np.int32),
                    (np.array([True, False]), np.zeros(3, np.int16))]}


def _step_dir(d, step):
    return os.path.join(d, "step_%010d" % step)


def _meta(d, step):
    with open(os.path.join(_step_dir(d, step), "meta.json")) as f:
        return json.load(f)


def _arrays(d, step):
    with np.load(os.path.join(_step_dir(d, step), "arrays.npz")) as z:
        return {k: z[k] for k in z.files}


def _corrupt_payload(path):
    size = os.path.getsize(path)
    with open(path, "r+b") as f:
        f.seek(size // 3)
        f.write(b"\xa5" * (size // 3))


def test_ckpt_roundtrip_and_format_tag(tmp_path):
    d = str(tmp_path)
    ckpt.save(d, 3, TREE, metadata={"note": "x"})
    out, step, md = ckpt.restore(d, TREE)
    assert step == 3 and md == {"note": "x"}
    np.testing.assert_array_equal(out["params"]["w"], TREE["params"]["w"])
    meta = _meta(d, 3)
    assert meta["format"] == ckpt.FORMAT == rckpt.FORMAT
    assert set(meta["checksums"]) == set(meta["keys"])


def test_ckpt_corrupted_latest_falls_back_to_previous(tmp_path):
    d = str(tmp_path)
    ckpt.save(d, 1, TREE)
    ckpt.save(d, 2, TREE)
    _corrupt_payload(os.path.join(_step_dir(d, 2), "arrays.npz"))
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        out, step, _ = ckpt.restore(d, TREE)
    assert step == 1
    assert any("falling back" in str(x.message) for x in w)
    np.testing.assert_array_equal(out["params"]["b"], TREE["params"]["b"])


def test_ckpt_bitflip_detected_by_checksums(tmp_path):
    d = str(tmp_path)
    ckpt.save(d, 1, TREE)
    flip_bits(os.path.join(_step_dir(d, 1), "arrays.npz"), seed=3,
              n_flips=64)
    with pytest.raises(ckpt.CheckpointCorruptionError):
        ckpt.restore(d, TREE, step=1)


def test_ckpt_truncated_archive_reports_missing_keys(tmp_path):
    d = str(tmp_path)
    ckpt.save(d, 1, TREE)
    arrays = _arrays(d, 1)
    arrays.pop(sorted(arrays)[0])
    np.savez(os.path.join(_step_dir(d, 1), "arrays.npz"), **arrays)
    with pytest.raises(ckpt.CheckpointCorruptionError, match="missing"):
        ckpt.restore(d, TREE, step=1)


def test_ckpt_pinned_step_does_not_fall_back(tmp_path):
    d = str(tmp_path)
    ckpt.save(d, 1, TREE)
    ckpt.save(d, 2, TREE)
    _corrupt_payload(os.path.join(_step_dir(d, 2), "arrays.npz"))
    with pytest.raises(ckpt.CheckpointCorruptionError):
        ckpt.restore(d, TREE, step=2)


def test_ckpt_format1_files_still_restore(tmp_path):
    d = str(tmp_path)
    ckpt.save(d, 1, TREE)
    meta = _meta(d, 1)
    del meta["format"], meta["checksums"]          # what old writers produced
    with open(os.path.join(_step_dir(d, 1), "meta.json"), "w") as f:
        json.dump(meta, f)
    out, step, _ = ckpt.restore(d, TREE)
    assert step == 1
    np.testing.assert_array_equal(out["params"]["w"], TREE["params"]["w"])


def test_keep_prune_latest_pointer_and_injector(tmp_path):
    d = str(tmp_path)
    for s in range(1, 6):
        ckpt.save(d, s, TREE, keep=2)
    assert ckpt.all_steps(d) == [4, 5] and ckpt.latest_step(d) == 5
    inj = FaultInjector(checkpoint_kills={6}, checkpoint_flips={7})
    with pytest.raises(CheckpointWriteError, match="injected kill"):
        ckpt.save(d, 6, TREE, keep=10, injector=inj)
    assert ckpt.all_steps(d) == [4, 5]       # a killed save leaves no dir
    assert not [n for n in os.listdir(d) if n.startswith(".tmp_ckpt_")]
    ckpt.save(d, 7, TREE, keep=10, injector=inj)  # committed, then flipped
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        _, step, _ = ckpt.restore(d, TREE)
    assert step == 5
    with pytest.raises(FileNotFoundError):
        ckpt.restore(str(tmp_path / "empty"), TREE)


def test_same_tree_same_keys_dtypes_bytes_and_checksums(tmp_path):
    """The port's tensor tree and the reference's numpy tree write the same
    step: equal meta.json (keys, checksums) and equal arrays."""
    dp, dr = str(tmp_path / "port"), str(tmp_path / "ref")
    ckpt.save(dp, 4, _tensor_tree(), metadata={"n": 3})
    rckpt.save(dr, 4, _numpy_tree(), metadata={"n": 3})
    assert _meta(dp, 4) == _meta(dr, 4)
    got, want = _arrays(dp, 4), _arrays(dr, 4)
    assert sorted(got) == sorted(want) == sorted(_meta(dr, 4)["keys"])
    assert "opt/1/0" in got
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert got[k].tobytes() == want[k].tobytes(), k


def test_each_package_restores_the_others_steps(tmp_path):
    dp, dr = str(tmp_path / "port"), str(tmp_path / "ref")
    ckpt.save(dp, 2, _tensor_tree())
    rckpt.save(dr, 2, _numpy_tree())
    ref_out, step, _ = rckpt.restore(dp, _numpy_tree())
    assert step == 2
    port_out, step, _ = ckpt.restore(dr, _tensor_tree())
    assert step == 2
    want = _numpy_tree()
    for k in ("w", "b"):
        np.testing.assert_array_equal(np.asarray(ref_out["params"][k]),
                                      want["params"][k])
        got = port_out["params"][k]
        assert isinstance(got, torch.Tensor)
        assert got.dtype == _tensor_tree()["params"][k].dtype
        np.testing.assert_array_equal(got.numpy(), want["params"][k])
    # tensor leaves come back as tensors, numpy leaves as numpy, tuples as
    # tuples
    leaf, (mask, zeros) = port_out["opt"]
    assert isinstance(leaf, torch.Tensor) and leaf.dtype == torch.int32
    assert isinstance(mask, torch.Tensor) and mask.dtype == torch.bool
    assert isinstance(zeros, np.ndarray) and zeros.dtype == np.int16
    assert isinstance(port_out["opt"][1], tuple)


def test_bf16_leaf_is_written_as_the_reference_writes_it(tmp_path):
    """A bf16 tensor has no numpy dtype: it is written as raw 2-byte words
    (`|V2`), what `np.savez` stores for the reference's bf16 leaf; the port
    reads either package's step back into a bf16 tensor."""
    vals = np.linspace(-3, 3, 10)
    dp, dr = str(tmp_path / "port"), str(tmp_path / "ref")
    ckpt.save(dp, 1, {"x": torch.tensor(vals, dtype=torch.bfloat16)})
    rckpt.save(dr, 1, {"x": np.asarray(jnp.asarray(vals, jnp.bfloat16))})
    assert _meta(dp, 1) == _meta(dr, 1)
    got, want = _arrays(dp, 1)["x"], _arrays(dr, 1)["x"]
    assert got.dtype == want.dtype == np.dtype("V2")
    assert got.tobytes() == want.tobytes()
    like = {"x": torch.zeros(10, dtype=torch.bfloat16)}
    for d in (dp, dr):
        out, _, _ = ckpt.restore(d, like)
        assert out["x"].dtype == torch.bfloat16
        assert torch.equal(out["x"], torch.tensor(vals, dtype=torch.bfloat16))
