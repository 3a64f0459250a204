"""Data-parallel LM training (``train.step.make_dp_train_step``) on CPU
meshes of 2 and 4 entries against the single-device step on the whole
batch: smollm (attention), jamba's smoke config (the SSM scan, and MoE
layers, whose balance loss is formed over the whole batch) and xlstm (the
mLSTM and sLSTM), in float32 under ``float_policy()`` and
``train_policy()``, batch 4 x 64 drawn with numpy. The loss within rtol
1e-5 and Adam's first moment (0.1 x the clipped reduced gradient) within
rtol 1e-3 / atol 1e-8: the shards' sums round in another order, and
xlstm's recurrences carry that rounding (2.8e-4 of an element seen on 4
shards); the embedding's gradient is a scatter-add whose order varies
from run to run on the CPU, so not even two single-device steps agree bit
for bit there. The params after the
step within 2 x lr x lr_scale: the first Adam step moves a param by up to
lr x lr_scale whatever its gradient's size, so a gradient at roundoff
can move it either way. The MoE path's loss is also held to the JAX
package's loss of the whole batch.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as j_configs
from repro.models.model_factory import build_model as j_build_model
from repro_torch import tree
from repro_torch.configs.base import float_policy, smoke_config, train_policy
from repro_torch.convert import params_from_numpy
from repro_torch.launch.mesh import ServingMesh
from repro_torch.models.model_factory import build_model
from repro_torch.train.step import (TrainConfig, init_opt_state,
                                    make_dp_train_step, make_train_step)

POLICIES = {"float": float_policy, "train": train_policy}
BATCH, SEQ = 4, 64


def batch_of(cfg, seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (BATCH, SEQ + 1)).astype(np.int32)
    return {"tokens": torch.from_numpy(tokens[:, :-1].copy()),
            "labels": torch.from_numpy(tokens[:, 1:].copy())}


def steps(arch, policy, n, tcfg=TrainConfig()):
    cfg = smoke_config(arch)
    model = build_model(cfg, POLICIES[policy]())
    params = model.init(torch.Generator().manual_seed(1))
    opt = init_opt_state(params)
    batch = batch_of(cfg)
    one = make_train_step(model, tcfg)(params, opt, batch)
    dp = make_dp_train_step(model, tcfg, ServingMesh(("cpu",) * n))(params, opt, batch)
    return one, dp, tcfg


def assert_same_step(one, dp, tcfg):
    (p1, o1, m1), (p2, o2, m2) = one, dp
    np.testing.assert_allclose(float(m2["loss"]), float(m1["loss"]), rtol=1e-5)
    for key in ("aux", "grad_norm"):
        if key in m1:
            np.testing.assert_allclose(float(m2[key]), float(m1[key]), rtol=1e-5)
    for a, b in zip(tree.leaves(o2["adam"]["mu"]), tree.leaves(o1["adam"]["mu"])):
        torch.testing.assert_close(a, b, rtol=1e-3, atol=1e-8)
    move = 2 * tcfg.adamw.lr * float(m1["lr_scale"])
    for a, b in zip(tree.leaves(p2), tree.leaves(p1)):
        torch.testing.assert_close(a, b, rtol=0, atol=move)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("policy", sorted(POLICIES))
@pytest.mark.parametrize("arch", ["smollm-360m", "jamba-1.5-large-398b", "xlstm-1.3b"])
def test_dp_step_equals_the_single_device_step(arch, policy, n):
    assert_same_step(*steps(arch, policy, n))


def test_dp_step_with_microbatches():
    assert_same_step(*steps("xlstm-1.3b", "float", 2, TrainConfig(microbatches=2)))


def test_moe_dp_loss_is_the_whole_batch_s_and_jax_s():
    """moonshot's smoke config on 2 replicas: the step's loss and balance
    loss equal the single-device step's and the JAX package's loss of the
    whole batch (rtol 1e-5); with microbatches it equals the single-device
    microbatched step, each microbatch's balance loss over its own rows."""
    arch = "moonshot-v1-16b-a3b"
    one, dp, tcfg = steps(arch, "float", 2)
    assert_same_step(one, dp, tcfg)
    jcfg = j_configs.smoke_config(arch)
    jm = j_build_model(jcfg, j_configs.float_policy())
    jparams = jm.init(jax.random.PRNGKey(0))
    cfg = smoke_config(arch)
    model = build_model(cfg, float_policy())
    params = params_from_numpy(jparams, device="cpu")
    batch = batch_of(cfg, seed=3)
    _, _, metrics = make_dp_train_step(model, tcfg, ServingMesh(("cpu", "cpu")))(
        params, init_opt_state(params), batch)
    total, jmetrics = jax.jit(jm.loss)(
        jparams, {k: jnp.asarray(v.numpy()) for k, v in batch.items()})
    np.testing.assert_allclose(float(metrics["loss"]), float(total), rtol=1e-5)
    np.testing.assert_allclose(float(metrics["aux"]), float(jmetrics["aux"]), rtol=1e-5)
    assert_same_step(*steps(arch, "float", 2, TrainConfig(microbatches=2)))


def test_one_replica_is_the_single_device_step():
    """A 1-entry mesh takes the replicas' path with one shard (an MoE
    config too): the same loss bit for bit, the same step."""
    for arch in ("smollm-360m", "moonshot-v1-16b-a3b"):
        one, dp, tcfg = steps(arch, "train", 1)
        assert float(one[2]["loss"]) == float(dp[2]["loss"])
        assert_same_step(one, dp, tcfg)
