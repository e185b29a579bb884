"""The port's synthetic data (`repro_torch.data.pipeline`) against the
reference's (`repro.data.pipeline`): token batches and every time-series
generator equal bit for bit, over several seeds, steps and shards."""

import numpy as np
import pytest

from repro.data import pipeline as rpipe
from repro_torch.data import pipeline


@pytest.mark.parametrize("seed", [0, 3, 11])
@pytest.mark.parametrize("shard,n_shards", [(0, 1), (1, 2), (3, 4)])
def test_token_stream_batches_are_the_reference_bits(seed, shard, n_shards):
    kw = dict(vocab_size=300, seq_len=24, global_batch=8, seed=seed)
    ref = rpipe.TokenStream(rpipe.TokenStreamConfig(**kw))
    got = pipeline.TokenStream(pipeline.TokenStreamConfig(**kw))
    assert np.array_equal(got.trans, ref.trans)
    assert np.array_equal(got.emit, ref.emit)
    for step in (0, 1, 7, 1000):
        a = ref.batch(step, shard=shard, n_shards=n_shards)
        b = got.batch(step, shard=shard, n_shards=n_shards)
        assert list(b) == list(a) == ["tokens", "labels"]
        for key in a:
            assert b[key].dtype == a[key].dtype == np.int32
            assert np.array_equal(b[key], a[key]), (step, key)
        assert np.array_equal(b["tokens"][:, 1:], b["labels"][:, :-1])


@pytest.mark.parametrize("seed", [0, 5])
def test_series_generators_are_the_reference_bits(seed):
    cases = [
        ("random_walk", (1000,), dict(seed=seed)),
        ("sines_with_noise", (1000,), dict(period=37.0, noise=0.2,
                                           seed=seed)),
        ("ecg_like", (2000,), dict(bpm_period=150, seed=seed)),
    ]
    for name, args, kw in cases:
        a = getattr(rpipe, name)(*args, **kw)
        b = getattr(pipeline, name)(*args, **kw)
        assert b.dtype == a.dtype == np.float32, name
        assert np.array_equal(a, b), name
    ts = pipeline.random_walk(1000, seed=seed)
    a = rpipe.plant_motif(ts, [100, 600], 64, amplitude=3.0, seed=seed)
    b = pipeline.plant_motif(ts, [100, 600], 64, amplitude=3.0, seed=seed)
    assert b.dtype == a.dtype and np.array_equal(a, b)
    a = rpipe.plant_discord(ts, 400, 50, magnitude=6.0)
    b = pipeline.plant_discord(ts, 400, 50, magnitude=6.0)
    assert b.dtype == a.dtype and np.array_equal(a, b)
