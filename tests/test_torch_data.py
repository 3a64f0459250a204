"""The port's synthetic LM batches equal the JAX package's byte for
byte: both draw with numpy from ``(seed, step)`` alone."""

import numpy as np
import pytest

from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import synthetic_lm_batches as j_batches
from repro_torch.data.pipeline import (DataConfig, host_shard_slice,
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
