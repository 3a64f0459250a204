"""The selective-scan chunk (``ssm_scan_chunk``): the port's plain twin
and its ``ops`` wrapper on CPU tensors against the JAX package's Pallas
kernel in interpret mode and its model's associative-scan chunk, on the
same numpy inputs.

The twin is the sequential recurrence; the Pallas kernel is sequential
too but reduces ``y`` over ``n`` in its own order, and the associative
scan reassociates the products of ``exp(dt*A)``: float32 sums in other
orders, held to rtol/atol 1e-5 (the JAX package's own tolerance between
its kernel and its oracles, ``tests/test_ssm_scan.py``). The CUDA
kernel's own order of work (y as one fma chain over the states, carried
across the lanes that hold them), ``ref.ssm_scan_chunk_chain``, is held
to both within the same tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssm_scan import ssm_scan_chunk as pallas_scan
from repro.models.mamba import _selective_scan_chunk as jax_model_chunk
from repro_torch.kernels import ops
from repro_torch.kernels.ref import ssm_scan_chunk_chain, ssm_scan_chunk_ref
from repro_torch.models import mamba as tmamba

from torch_parity import t

TOL = dict(rtol=1e-5, atol=1e-5)


def scan_inputs(seed, b, c, di, ds):
    """dt = softplus(N(0,1)), x, B, C ~ N(0,1), A = -exp(0.5 N(0,1)),
    h0 ~ 0.1 N(0,1), as ``tests/test_ssm_scan.py`` draws them."""
    rng = np.random.default_rng(seed)

    def normal(*shape):
        return rng.normal(size=shape).astype(np.float32)

    dt = np.logaddexp(normal(b, c, di), 0).astype(np.float32)
    return (dt, normal(b, c, di), normal(b, c, ds), normal(b, c, ds),
            -np.exp(normal(di, ds) * 0.5).astype(np.float32),
            normal(b, di, ds) * np.float32(0.1))


@pytest.mark.parametrize("b,c,di,ds,bd", [
    (2, 16, 64, 8, 32),
    (1, 32, 128, 16, 128),
    (3, 8, 32, 4, 16),
])
def test_twin_matches_pallas_kernel(b, c, di, ds, bd):
    args = scan_inputs(60 + b, b, c, di, ds)
    y_j, h_j = pallas_scan(*map(jnp.asarray, args), block_d=bd, interpret=True)
    y, h = ssm_scan_chunk_ref(*map(t, args))
    np.testing.assert_allclose(y.numpy(), np.asarray(y_j), **TOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(h_j), **TOL)
    # the wrapper on CPU tensors is the twin, exactly
    y_w, h_w = ops.ssm_scan_chunk(*map(t, args))
    assert torch.equal(y_w, y) and torch.equal(h_w, h)


@pytest.mark.parametrize("b,c,di,ds", [
    (2, 16, 64, 5), (1, 37, 32, 8), (3, 8, 32, 16), (1, 16, 32, 32)])
def test_chain_order_matches_twin_and_pallas(b, c, di, ds):
    """``ssm_scan_chunk_chain`` (y as one fma chain over the states, the
    kernel's order) against the twin and the Pallas kernel in interpret
    mode: float32 sums in other orders, rtol/atol 1e-5; its state equals
    the twin's exactly (the same ops in the same order)."""
    args = scan_inputs(70 + ds, b, c, di, ds)
    y, h = ssm_scan_chunk_chain(*map(t, args))
    y_t, h_t = ssm_scan_chunk_ref(*map(t, args))
    np.testing.assert_allclose(y.numpy(), y_t.numpy(), **TOL)
    assert torch.equal(h, h_t)
    y_j, h_j = pallas_scan(*map(jnp.asarray, args), block_d=16, interpret=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_j), **TOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(h_j), **TOL)


def test_chain_order_sums_the_states_in_order():
    """One step, h0 = 0, dt = x = 1, A = 0 (so da = 1 and h = B), C = 1:
    y is the states added in order in float32, so 1e8 + 1 loses the 1 and
    the chain gives 1.75 where the exact sum is 2.75."""
    ds = 16
    bvec = np.array([1e8, 1, -1e8, 1, 3, 0.5, -3, 0.25] + [0.0] * 8, np.float32)
    args = (np.ones((1, 1, 1), np.float32), np.ones((1, 1, 1), np.float32),
            bvec[None, None], np.ones((1, 1, ds), np.float32),
            np.zeros((1, ds), np.float32), np.zeros((1, 1, ds), np.float32))
    y, h = ssm_scan_chunk_chain(*map(t, args))
    acc = np.float32(0)
    for v in bvec:
        acc = np.float32(acc + v)
    assert float(y) == float(acc) == 1.75
    np.testing.assert_array_equal(h.numpy()[0, 0], bvec)


def test_twin_matches_the_models_associative_scan():
    args = scan_inputs(64, 2, 16, 64, 8)
    dt, xh, bm, cm, a, h0 = map(jnp.asarray, args)
    h_j, y_j = jax.jit(jax_model_chunk)(h0, (dt, xh, bm, cm, a))
    h, y = tmamba._selective_scan_chunk(t(args[5]), tuple(map(t, args[:5])))
    np.testing.assert_allclose(y.numpy(), np.asarray(y_j), **TOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(h_j), **TOL)


def test_wrapper_reads_chunk_views_in_place():
    """Chunks of a longer sequence (batch stride S*di) and column slices
    of the x_proj output for B and C give the same result as copies."""
    dt, xh, _, _, a, h0 = scan_inputs(65, 2, 64, 48, 8)
    bc = t(np.random.default_rng(66).normal(size=(2, 64, 40)).astype(np.float32))
    bm, cm = bc[..., 24:32], bc[..., 32:40]
    for sl in (slice(0, 32), slice(32, 64)):
        views = (t(dt)[:, sl], t(xh)[:, sl], bm[:, sl], cm[:, sl])
        got = ops.ssm_scan_chunk(*views, t(a), t(h0))
        want = ssm_scan_chunk_ref(*(v.contiguous() for v in views), t(a), t(h0))
        for g, w in zip(got, want):
            assert torch.equal(g, w)


def test_empty_chunk_returns_the_state():
    dt, xh, bm, cm, a, h0 = map(t, scan_inputs(67, 2, 0, 16, 4))
    y, h = ops.ssm_scan_chunk(dt, xh, bm, cm, a, h0)
    assert y.shape == (2, 0, 16) and torch.equal(h, h0)


def test_wrapper_refuses_what_the_kernel_does_not_take():
    dt, xh, bm, cm, a, h0 = map(t, scan_inputs(68, 2, 8, 16, 4))
    with pytest.raises(TypeError, match="float32"):
        ops.ssm_scan_chunk(dt.double(), xh, bm, cm, a, h0)
    with pytest.raises(ValueError, match="3-D"):
        ops.ssm_scan_chunk(dt[0], xh, bm, cm, a, h0)
    with pytest.raises(ValueError, match="expected"):
        ops.ssm_scan_chunk(dt, xh, bm, cm, a[:8], h0)
    with pytest.raises(ValueError, match="unit stride"):
        ops.ssm_scan_chunk(dt.transpose(1, 2).contiguous().transpose(1, 2),
                           xh, bm, cm, a, h0)
    with pytest.raises(ValueError, match="contiguous"):
        ops.ssm_scan_chunk(dt, xh, bm, cm, a.T.contiguous().T, h0)
    with pytest.raises(ValueError, match="different devices"):
        ops.ssm_scan_chunk(dt, xh, bm, cm, a, h0.to("meta"))
    # meta operands (the dry run's trace) get meta results of the kernel's
    # shapes; neither kernel nor twin runs
    y, h_last = ops.ssm_scan_chunk(*(x.to("meta") for x in (dt, xh, bm, cm, a, h0)))
    assert (y.device.type, y.shape, h_last.shape) == ("meta", dt.shape, h0.shape)


def test_cuda_path_raises_without_cuda_and_never_falls_back(monkeypatch):
    """CUDA operands go to the kernel or raise: the twin is reached only
    through the CPU check."""
    monkeypatch.setattr(ops, "_on_cuda", lambda *ts: True)
    monkeypatch.setattr(ops.ref, "ssm_scan_chunk_ref",
                        lambda *a, **k: pytest.fail("fell back to the twin"))
    ops.reset_launches()
    args = map(t, scan_inputs(69, 1, 4, 8, 4))
    with pytest.raises((RuntimeError, ValueError, AssertionError)):
        ops.ssm_scan_chunk(*args)
    assert ops.LAUNCHES["ssm_scan_chunk"] == 0
