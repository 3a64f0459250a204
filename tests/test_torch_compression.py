"""The port's compressed gradient reduce (``distributed.compression``)
against the JAX package's, on per-shard inputs drawn with numpy.

The JAX package's collectives run jitted inside ``shard_map`` on n of the
host devices ``tests/conftest.py`` forces, as its data-parallel step runs
them; the port's take the same shards as a list in mesh order.

Tolerances. ``psum_compressed``: mean and residuals bit-exact (the scale
is a max and the total an integer sum; XLA fuses the residual's
``corrected - q * scale`` into one multiply-add, which the port's
single-rounded float64 residual reproduces). ``psum_signsgd``: the int32
sign totals exact; the scale, a float mean whose sum order may differ
between XLA and torch, within rtol ``SIGN_RTOL``, and the mean and the new
residuals within what that scale's difference moves them by. The local
round trips: int8 bit-exact, the sign scale within ``SIGN_RTOL``. Then
the JAX package's own compression tests, ported, with their thresholds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

from repro.distributed import compression as jcomp
from repro_torch.distributed import compression as tcomp

from torch_parity import t

# A float32 mean of ~37,000 terms in another order: a few ulps.
SIGN_RTOL = 1e-6
SHAPES = [(1000, 37), (77,)]
MESHES = [1, 2, 4, 8]


def shard_inputs(n: int, shape, seed: int):
    """n gradients of mixed magnitudes and n residuals, with exact zeros
    (and -0.0 where both are -0.0) among them."""
    rng = np.random.default_rng(seed)
    gs, errs = [], []
    for _ in range(n):
        g = (rng.normal(size=shape) * np.exp(rng.normal(size=shape))
             ).astype(np.float32)
        e = (0.05 * rng.normal(size=shape)).astype(np.float32)
        zero = rng.random(shape) < 0.02
        g[zero], e[zero] = -0.0, -0.0
        gs.append(g)
        errs.append(e)
    return gs, errs


def jax_collective(name: str, gs, errs):
    """The JAX package's ``name`` on ``len(gs)`` host devices: (mean,
    stacked new residuals)."""
    from jax.experimental.shard_map import shard_map

    n = len(gs)
    if jax.device_count() < n:
        pytest.skip("needs the host devices tests/conftest.py forces")
    mesh = Mesh(np.asarray(jax.devices()[:n]), ("data",))
    fn = getattr(jcomp, name)

    def body(g, e):
        mean, new_err = fn(g[0], e[0], "data")
        return mean, new_err[None]

    run = jax.jit(shard_map(body, mesh=mesh, in_specs=(P("data"), P("data")),
                            out_specs=(P(), P("data")), check_rep=False))
    mean, new = run(np.stack(gs), np.stack(errs))
    return np.asarray(mean), np.asarray(new)


def port_collective(name: str, gs, errs):
    mean, new = getattr(tcomp, name)([t(g) for g in gs], [t(e) for e in errs])
    return mean.numpy(), np.stack([x.numpy() for x in new])


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("n", MESHES)
def test_psum_compressed_is_bit_exact_with_jax(n, shape):
    gs, errs = shard_inputs(n, shape, seed=n)
    want_mean, want_err = jax_collective("psum_compressed", gs, errs)
    got_mean, got_err = port_collective("psum_compressed", gs, errs)
    np.testing.assert_array_equal(got_mean, want_mean)
    np.testing.assert_array_equal(got_err, want_err)


def test_psum_compressed_residual_rounds_once():
    """The residual a float32 product then difference would give is not
    the JAX package's: the single rounding is what the test above holds."""
    rng = np.random.default_rng(4)
    gs = [rng.normal(size=(1000, 37)).astype(np.float32) for _ in range(4)]
    errs = [np.zeros_like(g) for g in gs]
    _, want_err = jax_collective("psum_compressed", gs, errs)
    corrected = [t(g) + t(e) for g, e in zip(gs, errs)]
    scale = torch.clamp(torch.max(torch.stack(
        [c.abs().max() for c in corrected])), min=1e-30) * (1.0 / 127.0)
    twice = np.stack([
        (c - torch.clamp(torch.round(c / scale), -127, 127).to(torch.int8)
         .to(torch.float32) * scale).numpy() for c in corrected])
    share = (twice != want_err).mean()
    print(f"a product then a difference: {share:.1%} of the residuals differ")
    assert share > 0.5


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("n", MESHES)
def test_psum_signsgd_matches_jax(n, shape, record_property):
    gs, errs = shard_inputs(n, shape, seed=10 + n)
    want_mean, want_err = jax_collective("psum_signsgd", gs, errs)
    got_mean, got_err = port_collective("psum_signsgd", gs, errs)
    corrected = [g + e for g, e in zip(gs, errs)]
    signs = [np.where(c >= 0, 1, -1) for c in corrected]   # -0.0 -> +1
    total = np.sum(signs, axis=0)
    # The scale each package used, read back from its residual of shard 0
    # (corrected - sign * scale), and the totals from its mean.
    got_scale = float(np.median((corrected[0] - got_err[0]) / signs[0]))
    want_scale = float(np.median((corrected[0] - want_err[0]) / signs[0]))
    np.testing.assert_allclose(got_scale, want_scale, rtol=SIGN_RTOL)
    for mean, scale in ((got_mean, got_scale), (want_mean, want_scale)):
        np.testing.assert_array_equal(np.rint(mean * n / scale), total)
    np.testing.assert_allclose(got_mean, want_mean, rtol=SIGN_RTOL)
    # A residual moves by the scale's difference, and rounds within an ulp.
    moved = abs(got_scale - want_scale) + np.spacing(np.abs(want_err))
    assert (np.abs(got_err - want_err) <= moved).all()
    record_property("bit_exact", bool(np.array_equal(got_err, want_err)
                                      and np.array_equal(got_mean, want_mean)))


def test_local_round_trips_match_jax():
    gs, errs = shard_inputs(1, (1000, 37), seed=21)
    g, e = gs[0], errs[0]
    want = jcomp.compress_decompress(jnp.asarray(g), jnp.asarray(e))
    got = tcomp.compress_decompress(t(g), t(e))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    want = jcomp.signsgd_compress_decompress(jnp.asarray(g), jnp.asarray(e))
    got = tcomp.signsgd_compress_decompress(t(g), t(e))
    scale = float(np.mean(np.abs(g + e)))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=SIGN_RTOL,
                                   atol=SIGN_RTOL * scale)
    tree_g = {"a": [g, g[:3]], "b": e}
    tree_e = {"a": [e, e[:3]], "b": g}
    want = jcomp.tree_compress_decompress(
        jax.tree.map(jnp.asarray, tree_g), jax.tree.map(jnp.asarray, tree_e))
    got = tcomp.tree_compress_decompress(
        {"a": [t(g), t(g[:3])], "b": t(e)}, {"a": [t(e), t(e[:3])], "b": t(g)})
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    zeros = tcomp.init_error_feedback({"w": t(g)})
    assert torch.equal(zeros["w"], torch.zeros_like(t(g)))
    assert (tcomp.INT8_BITS_RATIO, tcomp.SIGNSGD_BITS_RATIO) == (
        jcomp.INT8_BITS_RATIO, jcomp.SIGNSGD_BITS_RATIO)


# --- the JAX package's compression tests (tests/test_distributed.py) ---


def test_compression_error_feedback_reduces_bias():
    rng = np.random.default_rng(0)
    g_true = t(rng.normal(0, 1, (256,)).astype(np.float32))
    err = torch.zeros_like(g_true)
    acc = torch.zeros_like(g_true)
    for _ in range(50):
        deq, err = tcomp.compress_decompress(g_true, err)
        acc = acc + deq
    # with error feedback the running sum converges to 50 * g
    np.testing.assert_allclose((acc / 50).numpy(), g_true.numpy(), atol=1e-2)


def test_compression_single_round_is_int8_coarse():
    g = torch.linspace(-1, 1, 255)
    deq, err = tcomp.compress_decompress(g, torch.zeros_like(g))
    assert float(err.abs().max()) <= float(g.abs().max()) / 127


def test_psum_compressed_on_one_shard():
    g = torch.arange(8, dtype=torch.float32)
    mean, _ = tcomp.psum_compressed([g], [torch.zeros_like(g)])
    np.testing.assert_allclose(mean.numpy(), g.numpy(), atol=0.05)


def test_signsgd_error_feedback_reduces_bias():
    """One round keeps 1 bit a coordinate, but with error feedback the
    running mean of the decompressed grads converges to the true
    gradient, and keeps improving with more rounds."""
    rng = np.random.default_rng(0)
    g_true = t(rng.normal(0, 1, (256,)).astype(np.float32))

    def avg_error(rounds):
        err = torch.zeros_like(g_true)
        acc = torch.zeros_like(g_true)
        for _ in range(rounds):
            deq, err = tcomp.signsgd_compress_decompress(g_true, err)
            acc = acc + deq
        return float(torch.mean(torch.abs(acc / rounds - g_true)))

    e50, e800 = avg_error(50), avg_error(800)
    assert e50 < 5e-2
    assert e800 < 1e-2
    assert e800 < e50 / 4  # converging, not plateaued


def test_signsgd_single_round_is_scaled_sign():
    g = torch.linspace(-1.0, 1.0, 255)
    deq, err = tcomp.signsgd_compress_decompress(g, torch.zeros_like(g))
    scale = float(torch.mean(torch.abs(g)))
    gn = g.numpy()
    np.testing.assert_allclose(deq.numpy(),
                               scale * np.sign(np.where(gn == 0, 1.0, gn)),
                               rtol=1e-6)
    # lossless in the EF sense: deq + err reconstructs g
    np.testing.assert_allclose((deq + err).numpy(), gn, atol=1e-6)


def test_psum_signsgd_on_one_shard():
    g = torch.arange(8, dtype=torch.float32) - 3.5
    mean, (err,) = tcomp.psum_signsgd([g], [torch.zeros_like(g)])
    scale = float(torch.mean(torch.abs(g)))
    np.testing.assert_allclose(
        mean.numpy(), scale * np.where(g.numpy() >= 0, 1.0, -1.0), rtol=1e-6)
    np.testing.assert_allclose((mean + err).numpy(), g.numpy(), atol=1e-6)


def test_signsgd_convergence_tracks_fp32():
    """Plain SGD on a 2-shard least-squares problem, gradients reduced
    three ways: the float32 mean, EF-int8 and 1-bit EF sign-SGD. Both
    compressed runs must reach (near) the float32 run's final loss."""
    n_dev, n, d, lr, steps = 2, 64, 8, 0.05, 300
    rng = np.random.default_rng(3)
    w_true = rng.normal(size=(d,)).astype(np.float32)
    x = rng.normal(size=(n_dev, n, d)).astype(np.float32)
    y = x @ w_true + 0.01 * rng.normal(size=(n_dev, n)).astype(np.float32)
    xs, ys = t(x), t(y)

    def run(reduce_fn):
        w = torch.zeros(d)
        errs = [torch.zeros(d) for _ in range(n_dev)]
        for _ in range(steps):
            gs = [2.0 * xs[i].T @ (xs[i] @ w - ys[i]) / n
                  for i in range(n_dev)]
            g, errs = reduce_fn(gs, errs)
            w = w - lr * g
        resid = xs.reshape(-1, d) @ w - ys.reshape(-1)
        return float(torch.mean(resid**2))

    loss_fp32 = run(lambda gs, es: (sum(gs) / n_dev, es))
    loss_int8 = run(tcomp.psum_compressed)
    loss_sign = run(tcomp.psum_signsgd)
    # the problem's noise floor is ~1e-4; every run must solve it
    assert loss_fp32 < 5e-4
    assert loss_int8 < 5 * loss_fp32
    assert loss_sign < 5 * loss_fp32
