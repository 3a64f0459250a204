"""The port's synthetic LM and CIFAR batches equal the JAX package's
byte for byte: both draw with numpy from ``(seed, step)`` alone."""

import numpy as np
import pytest
import torch

from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import synthetic_cifar_batches as j_cifar
from repro.data.pipeline import synthetic_lm_batches as j_batches
from repro_torch.data.pipeline import (DataConfig, Prefetcher, cifar_batch_at,
                                       host_shard_slice,
                                       synthetic_cifar_batches,
                                       synthetic_lm_batches)


@pytest.mark.parametrize("hosts,host_id", [(1, 0), (2, 1)])
def test_synthetic_lm_batches_equal_the_jax_packages(hosts, host_id):
    kw = dict(seed=7, global_batch=4, seq_len=64, vocab_size=49152,
              num_hosts=hosts, host_id=host_id)
    ours, theirs = synthetic_lm_batches(DataConfig(**kw)), j_batches(JDataConfig(**kw))
    for step in range(3):
        got, want = next(ours), next(theirs)
        assert got["step"] == want["step"] == step
        for key in ("tokens", "labels"):
            g, w = got[key].numpy(), np.asarray(want[key])
            assert g.dtype == w.dtype == np.int32 and g.shape == (4 // hosts, 64)
            assert g.tobytes() == w.tobytes()
        np.testing.assert_array_equal(got["tokens"][:, 1:].numpy(),
                                      got["labels"][:, :-1].numpy())


def test_host_shard_slice_refuses_an_uneven_split():
    assert host_shard_slice(DataConfig(global_batch=6, num_hosts=3, host_id=2)) == (4, 2)
    with pytest.raises(ValueError, match="not divisible"):
        host_shard_slice(DataConfig(global_batch=5, num_hosts=2))


@pytest.mark.parametrize("hosts,host_id", [(1, 0), (2, 0), (2, 1)])
def test_synthetic_cifar_batches_equal_the_jax_packages(hosts, host_id):
    kw = dict(seed=11, global_batch=4, num_hosts=hosts, host_id=host_id)
    ours, theirs = synthetic_cifar_batches(DataConfig(**kw)), j_cifar(JDataConfig(**kw))
    for step in range(4):
        got, want = next(ours), next(theirs)
        assert got["step"] == want["step"] == step
        for key, dtype, shape in (("images", np.float32, (4 // hosts, 32, 32, 3)),
                                  ("labels", np.int32, (4 // hosts,))):
            g, w = got[key].numpy(), np.asarray(want[key])
            assert g.dtype == w.dtype == dtype and g.shape == shape
            assert g.tobytes() == w.tobytes()
        again = cifar_batch_at(DataConfig(**kw), step)
        assert torch.equal(again["images"], got["images"])
        assert torch.equal(again["labels"], got["labels"])


def test_prefetcher_yields_the_stream_in_order_and_stops():
    cfg = DataConfig(seed=3, global_batch=2)
    got = list(Prefetcher(cifar_batch_at(cfg, i) for i in range(5)))
    assert [b["step"] for b in got] == list(range(5))
    for b in got:
        assert torch.equal(b["images"], cifar_batch_at(cfg, b["step"])["images"])
