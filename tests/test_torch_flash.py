"""Flash attention and the dense LM's training forward against the JAX
package.

The plain twin ``kernels.ref.flash_attention_ref`` against the Pallas
``flash_attention`` run in interpret mode; the port's flash branch of
``_attend`` (long causal self-attention without cache) against the JAX
package's ``_attend`` (its chunked path off the TPU); ``Model.loss`` of
``smoke_config("smollm-360m")`` at S 4096, whose attention takes that
branch, against the JAX ``Model.loss`` on the JAX package's params
(``params_from_numpy``). Inputs come from numpy. Float32 sums in other
orders: the twin within rtol/atol 1e-5 of the kernel, the loss within
rtol/atol 1e-4. The flash branch's gradient (autograd through the twin)
against ``jax.grad`` of the JAX ``_attend`` pins what the kernel's backward
will be held to (rtol/atol 1e-4).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import float_policy as j_float_policy
from repro.configs import smoke_config as j_smoke_config
from repro.configs import train_policy as j_train_policy
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import synthetic_lm_batches as j_batches
from repro.kernels.flash_attention import flash_attention
from repro.models import attention as jattn
from repro.models.model_factory import build_model as j_build_model
from repro_torch.configs.base import float_policy, smoke_config, train_policy
from repro_torch.convert import params_from_numpy
from repro_torch.data.pipeline import DataConfig, synthetic_lm_batches
from repro_torch.kernels import ops
from repro_torch.kernels.ref import flash_attention_ref
from repro_torch.models import attention as tattn
from repro_torch.models.model_factory import build_model

from torch_parity import t

TOL = dict(rtol=1e-5, atol=1e-5)
ARCH = "smollm-360m"
POLICIES = {"train": (j_train_policy, train_policy),
            "float": (j_float_policy, float_policy)}


def normal(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("bh,s,dh,block_q,block_kv", [
    (2, 64, 32, 16, 32), (3, 128, 16, 32, 16), (2, 96, 32, 32, 32),
    # the kernel's key tile (the twin's block_kv on the card), several
    # tiles and a 128-row query block as the bf16 kernel takes them
    (2, 256, 64, 128, ops.FLASH_TILE), (1, 384, 32, 128, ops.FLASH_TILE)])
def test_flash_twin_matches_the_pallas_kernel(bh, s, dh, block_q, block_kv, causal):
    rng = np.random.default_rng(150)
    q, k, v = normal(rng, bh, s, dh), normal(rng, bh, s, dh), normal(rng, bh, s, dh)
    want = flash_attention(*map(jnp.asarray, (q, k, v)), causal=causal,
                           block_q=block_q, block_kv=block_kv, interpret=True)
    got = flash_attention_ref(t(q), t(k), t(v), causal=causal,
                              block_q=block_q, block_kv=block_kv)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("sq,skv,causal", [(100, 100, True), (40, 100, False),
                                          (100, 60, True)])
def test_flash_twin_takes_ragged_blocks(sq, skv, causal):
    """A last KV block shorter than ``block_kv`` and Sq != Skv: the same
    attention as one block over all keys (a plain masked softmax)."""
    rng = np.random.default_rng(151)
    q, k, v = t(normal(rng, 2, sq, 16)), t(normal(rng, 2, skv, 16)), t(normal(rng, 2, skv, 16))
    got = flash_attention_ref(q, k, v, causal=causal, block_kv=24)
    s = (q @ k.transpose(1, 2)) * 16 ** -0.5
    if causal:
        s = torch.where(torch.arange(skv)[None, :] <= torch.arange(sq)[:, None], s, -1e30)
    want = torch.softmax(s, -1) @ v
    torch.testing.assert_close(got, want, **TOL)


def test_attend_flash_branch_matches_jax(monkeypatch):
    """S 4096 at the smoke widths (4 heads of 32, 2 KV heads): the port
    takes the flash branch (one ``ops.flash_attention`` call on [B*H, S,
    Dh] with the KV heads repeated), the JAX package its chunked path."""
    rng = np.random.default_rng(152)
    b, s, h, hkv, dh = 1, 4096, 4, 2, 32
    q, k, v = normal(rng, b, s, h, dh), normal(rng, b, s, hkv, dh), normal(rng, b, s, hkv, dh)
    pos = np.arange(s, dtype=np.int32)
    want = jax.jit(lambda q, k, v, p: jattn._attend(
        q, k, v, groups=h // hkv, causal=True, q_positions=p, kv_positions=p))(
        *map(jnp.asarray, (q, k, v, pos)))
    calls = []
    wrapper = ops.flash_attention

    def counted(*args, **kwargs):
        calls.append(args[0].shape)
        return wrapper(*args, **kwargs)

    monkeypatch.setattr(ops, "flash_attention", counted)
    got = tattn._attend(t(q), t(k), t(v), groups=h // hkv, causal=True,
                        q_positions=t(pos).long(), kv_positions=t(pos).long())
    assert calls == [(b * h, s, dh)]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# The gradient the flash kernel's backward (not written yet) will be held
# to: d/dq, dk, dv of <out, cotangent> through the port's flash branch
# (the twin on the CPU, differentiated by autograd) against jax.grad of the
# JAX ``_attend`` (its chunked path off the TPU), at the forward test's
# shape. Float32 sums in other orders: rtol/atol 1e-4.
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)


def test_attend_flash_branch_gradient_matches_jax():
    rng = np.random.default_rng(153)
    b, s, h, hkv, dh = 1, 4096, 4, 2, 32
    q, k, v = normal(rng, b, s, h, dh), normal(rng, b, s, hkv, dh), normal(rng, b, s, hkv, dh)
    ct = normal(rng, b, s, h, dh)
    pos = np.arange(s, dtype=np.int32)

    def j_objective(q, k, v):
        out = jattn._attend(q, k, v, groups=h // hkv, causal=True,
                            q_positions=jnp.asarray(pos), kv_positions=jnp.asarray(pos))
        return jnp.sum(out * jnp.asarray(ct))

    want = jax.jit(jax.grad(j_objective, argnums=(0, 1, 2)))(
        *map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (t(a).requires_grad_() for a in (q, k, v))
    out = tattn._attend(tq, tk, tv, groups=h // hkv, causal=True,
                        q_positions=t(pos).long(), kv_positions=t(pos).long())
    got = torch.autograd.grad((out * t(ct)).sum(), (tq, tk, tv))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **GRAD_TOL)


@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_smollm_loss_matches_jax(policy):
    """``Model.loss`` (tokens and labels of ``synthetic_lm_batches``) on the
    JAX package's params: 2 layers, each through the flash branch."""
    j_policy, t_policy = POLICIES[policy]
    cfg = j_smoke_config(ARCH)
    data = dict(seed=15, global_batch=2, seq_len=4096, vocab_size=cfg.vocab_size)
    jb = next(j_batches(JDataConfig(**data)))
    jm = j_build_model(cfg, j_policy())
    params = jm.init(jax.random.PRNGKey(0))
    want_total, want = jax.jit(jm.loss)(params, {"tokens": jb["tokens"],
                                                 "labels": jb["labels"]})
    model = build_model(smoke_config(ARCH), t_policy())
    before = ops.LAUNCHES["flash_attention"]
    with torch.no_grad():
        total, parts = model.loss(params_from_numpy(params, device="cpu"),
                                  next(synthetic_lm_batches(DataConfig(**data))))
    assert ops.LAUNCHES["flash_attention"] == before   # the twin on the CPU
    np.testing.assert_allclose(float(total), float(want_total), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(float(parts["loss"]), float(want["loss"]),
                               rtol=1e-4, atol=1e-4)
    assert float(parts["aux"]) == float(want["aux"]) == 0.0
