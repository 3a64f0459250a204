"""The LM stack's modules against the JAX package, module by module, at
``smoke_config("jamba-1.5-large-398b")`` (float32, d_model 128, 4 heads
of 32 with 2 KV heads, d_inner 256, d_state 8, 8 experts top-2).

Inputs come from numpy; params are the JAX package's (``jax.random``
init, carried across with ``params_from_numpy``); the JAX side is
jitted. Packed words are held exactly. Float outputs sum float32
products in other orders (matmuls of unpacked ±1 weights, attention,
the scan) and round ``rsqrt``/``exp``/``cos`` differently by an ulp or
two: rtol/atol 1e-5, unless a test states otherwise with its reason.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import serve_policy as j_serve_policy
from repro.configs import smoke_config as j_smoke_config
from repro.core import layers as jl
from repro.core.binarize import QuantMode as JQuantMode
from repro.models import attention as jattn
from repro.models import common as jcommon
from repro.models import ffn as jffn
from repro.models import mamba as jmamba
from repro_torch.configs.base import float_policy, serve_policy, smoke_config
from repro_torch.convert import params_from_numpy
from repro_torch.core import layers as tl
from repro_torch.core.binarize import QuantMode
from repro_torch.models import attention as tattn
from repro_torch.models import common as tcommon
from repro_torch.models import ffn as tffn
from repro_torch.models import mamba as tmamba

from torch_parity import t, ulp_distance

ARCH = "jamba-1.5-large-398b"
TOL = dict(rtol=1e-5, atol=1e-5)
J_CFG = j_smoke_config(ARCH)
T_CFG = smoke_config(ARCH)
POLICIES = {"serve": (j_serve_policy(), serve_policy()),
            "float": (jcommon.QuantPolicy(enabled=False), float_policy())}


def normal(rng, *shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


def jax_params(init, seed, packed):
    """JAX params of ``init(key)``, packed if asked, and their torch twin."""
    p = init(jax.random.PRNGKey(seed))
    if packed:
        p = jcommon.pack_projection_tree(p)
    return p, params_from_numpy(p, device="cpu")


def close(got: torch.Tensor, want, **tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, dtype=np.float32),
                               **(tol or TOL))


# ------------------------------------------------------------ bit layers

@pytest.mark.parametrize("shape", [(40, 100), (3, 24, 70)], ids=["2d", "stacked"])
def test_pack_linear_params_use_scale_matches_jax(shape):
    """Words exact; alpha = mean(|w|) over the unpadded K, rtol 1e-6 (a
    float32 mean summed in another order)."""
    w = normal(np.random.default_rng(70), *shape)
    want = jl.pack_linear_params({"w": jnp.asarray(w)}, use_scale=True)
    got = tl.pack_linear_params({"w": t(w)}, use_scale=True)
    assert got.keys() == want.keys() == {"w_packed", "alpha"}
    np.testing.assert_array_equal(got["w_packed"].numpy(), np.asarray(want["w_packed"]))
    np.testing.assert_allclose(got["alpha"].numpy(), np.asarray(want["alpha"]),
                               rtol=1e-6)
    assert "alpha" not in tl.pack_linear_params({"w": t(w)})


@pytest.mark.parametrize("mode", ["packed", "fake_quant"])
def test_bit_linear_weight_only_with_alpha_matches_jax(mode):
    """The LM projection: weight-only ±1 weights (K=100, padded to 128 in
    PACKED), scaled by alpha before the bias, on real input."""
    rng = np.random.default_rng(71)
    p = {"w": normal(rng, 24, 100), "b": normal(rng, 24)}
    x = normal(rng, 3, 5, 100)
    jm = JQuantMode.PACKED if mode == "packed" else JQuantMode.FAKE_QUANT
    j_cfg = jl.BitLinearConfig(mode=jm, binarize_acts=False, use_scale=True)
    t_cfg = tl.BitLinearConfig(mode=QuantMode(mode), binarize_acts=False,
                               use_scale=True)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: t(v) for k, v in p.items()}
    if mode == "packed":
        jp = jl.pack_linear_params(jp, use_scale=True)
        tp = tl.pack_linear_params(tp, use_scale=True)
    want = jl.bit_linear(jp, jnp.asarray(x), j_cfg)
    close(tl.bit_linear(tp, t(x), t_cfg), want)


# ------------------------------------------------------- norms and RoPE

def test_rmsnorm_and_rope_match_jax():
    """rsqrt, cos and sin round differently by an ulp or two: rtol 1e-5,
    atol 1e-6 (the values are O(1)). LayerNorm too (jamba's norm is RMS;
    other families use it)."""
    rng = np.random.default_rng(72)
    x = normal(rng, 2, 7, 4, 32)
    scale, bias = normal(rng, 32), normal(rng, 32)
    close(tcommon.rmsnorm({"scale": t(scale)}, t(x)),
          jcommon.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x)),
          rtol=1e-5, atol=1e-6)
    close(tcommon.layernorm({"scale": t(scale), "bias": t(bias)}, t(x)),
          jcommon.layernorm({"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)},
                            jnp.asarray(x)),
          rtol=1e-5, atol=1e-6)
    pos = np.arange(5, 12, dtype=np.int32)
    close(tcommon.apply_rope(t(x), t(pos)[None, :], 1e4),
          jcommon.apply_rope(jnp.asarray(x), jnp.asarray(pos)[None, :], 1e4),
          rtol=1e-5, atol=1e-6)


# ------------------------------------------------------------ attention

@pytest.mark.parametrize("cache_dtype", ["f32", "bf16", "int8"])
def test_attention_with_cache_matches_jax(cache_dtype):
    """A 16-token prefill into a 20-slot cache, then one decode step.
    Caches: float32 exact to the tolerance; bfloat16 and int8 store the
    rounded k/v, so a float32 difference of an ulp can move a stored
    value by one step of the cache's grid (2^-8 relative, 1/24): caches
    within that step, outputs rtol/atol 1e-4."""
    jdt = {"f32": jnp.float32, "bf16": jnp.bfloat16, "int8": jnp.int8}[cache_dtype]
    tdt = {"f32": torch.float32, "bf16": torch.bfloat16, "int8": torch.int8}[cache_dtype]
    tol = TOL if cache_dtype == "f32" else dict(rtol=1e-4, atol=1e-4)
    grid = {"f32": dict(rtol=1e-5, atol=1e-5), "bf16": dict(rtol=2 ** -8, atol=1e-5),
            "int8": dict(rtol=0, atol=1 / 24 + 1e-6)}[cache_dtype]
    j_pol, t_pol = POLICIES["serve"]
    jp, tp = jax_params(lambda k: jattn.init_attention(k, J_CFG), 73, True)
    rng = np.random.default_rng(73)
    jfn = jax.jit(lambda p, x, pos, cache: jattn.attention(
        p, x, J_CFG, j_pol, positions=pos, cache=cache))
    jc = jattn.init_cache(J_CFG, 2, 20, layers=1, dtype=jdt)
    jcache = {"k": jc["k"][0], "v": jc["v"][0], "index": jc["index"]}
    tc = tattn.init_cache(T_CFG, 2, 20, layers=1, dtype=tdt, device="cpu")
    tcache = {"k": tc["k"][0], "v": tc["v"][0], "index": 0}
    for s in (16, 1):
        x = normal(rng, 2, s, T_CFG.d_model)
        pos = np.arange(tcache["index"], tcache["index"] + s, dtype=np.int32)
        want, jcache = jfn(jp, jnp.asarray(x), jnp.asarray(pos), jcache)
        got, tcache = tattn.attention(tp, t(x), T_CFG, t_pol,
                                      positions=t(pos).long(), cache=tcache)
        close(got, want, **tol)
        assert tcache["index"] == int(jcache["index"])
        for kv in ("k", "v"):
            assert tcache[kv].dtype == tdt
            close(tcache[kv], np.asarray(jcache[kv]).astype(np.float32), **grid)


def test_chunked_attention_matches_jax_and_dense():
    """The online-softmax path with 4-query / 6-key chunks, a cache fill
    mask and a sliding window, against the JAX package's and the port's
    dense path."""
    rng = np.random.default_rng(74)
    q, k, v = normal(rng, 2, 8, 4, 16), normal(rng, 2, 12, 2, 16), normal(rng, 2, 12, 2, 16)
    qpos = np.arange(3, 11, dtype=np.int32)
    kpos = np.arange(12, dtype=np.int32)
    valid = kpos < 10
    kw = dict(groups=2, causal=True, sliding_window=5)
    want = jattn._attend_chunked(
        *map(jnp.asarray, (q, k, v)), q_positions=jnp.asarray(qpos),
        kv_positions=jnp.asarray(kpos), kv_valid=jnp.asarray(valid),
        q_chunk=4, kv_chunk=6, **kw)
    targs = dict(q_positions=t(qpos).long(), kv_positions=t(kpos).long(),
                 kv_valid=t(valid), **kw)
    got = tattn._attend_chunked(t(q), t(k), t(v), q_chunk=4, kv_chunk=6, **targs)
    close(got, want)
    close(tattn._attend(t(q), t(k), t(v), **targs), np.asarray(want))
    # grouped heads equal the same attention on KV heads repeated G times
    mha = dict(targs, groups=1)
    close(tattn._attend(t(q), tattn._repeat_kv(t(k), 2), tattn._repeat_kv(t(v), 2),
                        **mha), np.asarray(want))
    with pytest.raises(ValueError, match="chunked attention"):
        tattn._attend_chunked(t(q), t(k), t(v), q_chunk=3, kv_chunk=6, **targs)


# ------------------------------------------------------------------ FFN

@pytest.mark.parametrize("policy,act", [("serve", "swiglu"), ("float", "swiglu"),
                                        ("serve", "gelu")])
def test_dense_ffn_matches_jax(policy, act):
    """SwiGLU (jamba's) and GeLU (the tanh approximation, JAX's default)."""
    j_pol, t_pol = POLICIES[policy]
    jp, tp = jax_params(lambda k: jffn.init_dense_ffn(k, 128, 256, act),
                        75, policy == "serve")
    x = normal(np.random.default_rng(75), 2, 5, 128)
    close(tffn.dense_ffn(tp, t(x), t_pol, act),
          jax.jit(lambda p, x: jffn.dense_ffn(p, x, j_pol, act))(jp, jnp.asarray(x)))


@pytest.mark.parametrize("policy,capacity_factor", [
    ("serve", 1.25), ("serve", 0.25), ("float", 1.25)])
def test_moe_ffn_matches_jax(policy, capacity_factor):
    """Top-2 of 8 experts over 2 rows of 64 tokens. At capacity factor
    0.25 each expert keeps 8 of its ~16 pairs per row: the dropped pairs
    come back as zeros, and the output differs from the 1.25 one."""
    j_pol, t_pol = POLICIES[policy]
    jcfg = dataclasses.replace(J_CFG, capacity_factor=capacity_factor)
    tcfg = dataclasses.replace(T_CFG, capacity_factor=capacity_factor)
    jp, tp = jax_params(lambda k: jffn.init_moe(k, jcfg), 76, policy == "serve")
    x = normal(np.random.default_rng(76), 2, 64, 128)
    want, want_aux = jax.jit(lambda p, x: jffn.moe_ffn(p, x, jcfg, j_pol))(
        jp, jnp.asarray(x))
    got, aux = tffn.moe_ffn(tp, t(x), tcfg, t_pol)
    close(got, want)
    close(aux, want_aux)
    assert tffn._capacity(tcfg, 64) == jffn._capacity(jcfg, 64)
    if capacity_factor < 1:
        full, _ = tffn.moe_ffn(tp, t(x), T_CFG, t_pol)
        assert not torch.allclose(got, full)


# ---------------------------------------------------------------- mamba

def test_mamba_prefill_then_decode_matches_jax():
    """A 512-token prefill (two 256-step chunks: the kernel path's twin
    here, an associative scan in JAX) and one decode step, with the
    streaming state: h and the conv window."""
    j_pol, t_pol = POLICIES["serve"]
    jp, tp = jax_params(lambda k: jmamba.init_mamba(k, J_CFG), 77, True)
    rng = np.random.default_rng(77)
    jfn = jax.jit(lambda p, x, st: jmamba.mamba(p, x, J_CFG, j_pol, state=st))
    js = jax.tree.map(lambda a: a[0], jmamba.init_mamba_state(J_CFG, 2, layers=1))
    ts = {k: v[0] for k, v in tmamba.init_mamba_state(T_CFG, 2, layers=1,
                                                      device="cpu").items()}
    for s in (512, 1):
        x = normal(rng, 2, s, T_CFG.d_model)
        want, js = jfn(jp, jnp.asarray(x), js)
        got, ts = tmamba.mamba(tp, t(x), T_CFG, t_pol, state=ts)
        close(got, want)
        close(ts["h"], js["h"])
        close(ts["conv"], js["conv"])
    with pytest.raises(ValueError, match="multiple"):
        tmamba.mamba(tp, t(normal(rng, 1, 300, 128)), T_CFG, t_pol)


def test_causal_conv_keeps_the_jax_summation_order():
    """The taps sum as the JAX package's ``sum(hist[:, i:i+S] * w[i]) + b``:
    bit-identical on the same inputs."""
    rng = np.random.default_rng(78)
    x, w, b, st = (normal(rng, 2, 9, 16), normal(rng, 4, 16), normal(rng, 16),
                   normal(rng, 2, 3, 16))
    for state in (None, st):
        want = jmamba._causal_conv(*map(jnp.asarray, (x, w, b)),
                                   None if state is None else jnp.asarray(state))
        got = tmamba._causal_conv(t(x), t(w), t(b),
                                  None if state is None else t(state))
        for g, j in zip(got, want):
            assert ulp_distance(g.numpy(), np.asarray(j)).max() == 0
