"""The segment scheme of the scan's backward kernel on the CPU.

``ref.ssm_scan_chunk_bwd_segmented`` is ``csrc/ssm_scan_bwd.cu``'s order
of work in plain torch: a forward pass that keeps only every k-th step's
state, each segment's states recomputed from its checkpoint as the
reverse pass reaches it, states padded to the compiled width and channels
to whole blocks, and the sums over states and channels in the kernel's
fixed order. Held here to three things: its recomputed states equal the
full forward's bit for bit; its gradients match
``ssm_scan_chunk_bwd_ref`` for k of 1, 5, 16 and the whole chunk within
rtol 1e-5 of each element plus atol 1e-6 of the gradient's largest
magnitude (the form of ``chip_smoke.py``'s ``BWD_F32_TOL``: the sums run
in other orders, and one float32 ulp of a gradient of magnitude 40 is
3.8e-6; both sit within 1e-5 of the float64 gradients); and they match
``jax.grad`` of the JAX package's ``_selective_scan_chunk`` at a chunk
that is no multiple of k, within ``tests/test_torch_lm_train.py``'s TOL.
The kernel itself is held to ``ssm_scan_chunk_bwd_ref`` on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py`` phase 11).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import mamba as j_mamba
from repro_torch.kernels import ref
from tests.torch_parity import t

TOL = dict(rtol=1e-4, atol=1e-5)
SEG_TOL = dict(rtol=1e-5, atol=1e-6)  # atol of the gradient's largest magnitude
KS = [1, 5, 16, None]  # None: one segment, the whole chunk


def scan_case(seed, b, c, di, ds):
    """Operands as the mamba layer hands them over: dt a softplus, A of
    the model's init (-1..-ds) perturbed, h0 != 0; output gradients."""
    rng = np.random.default_rng(seed)

    def normal(*shape, scale=1.0):
        return (scale * rng.normal(size=shape)).astype(np.float32)

    dt = np.log1p(np.exp(normal(b, c, di)))
    a = -np.arange(1, ds + 1, dtype=np.float32)[None].repeat(di, 0) * \
        (1 + 0.1 * rng.random((di, ds))).astype(np.float32)
    return (dt, normal(b, c, di), normal(b, c, ds), normal(b, c, ds), a,
            normal(b, di, ds, scale=0.5), normal(b, c, di), normal(b, di, ds))


# (B, C, di, ds): the compiled width 16 with padded states (ds 4, 13) and
# 32 (ds 24), channels past one block and short of one, B 1 (d a written
# directly) and B 3 (its batch rows added).
SHAPES = [(1, 37, 70, 13), (3, 20, 130, 4), (2, 23, 40, 24)]


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("shape", SHAPES[:2])
def test_recomputed_states_equal_the_full_forward(shape, k):
    args = [t(x) for x in scan_case(60, *shape)]
    dt, xh, bm, cm, a, h0 = args[:6]
    _, states = ref.ssm_scan_chunk_bwd_segmented(*args, k or shape[1], return_states=True)
    h = h0
    for step in range(shape[1]):
        da = torch.exp(dt[:, step, :, None] * a)
        h = h * da + (dt[:, step] * xh[:, step])[..., None] * bm[:, step, None, :]
        assert torch.equal(states[:, step], h), step
    assert torch.equal(states[:, -1], ref.ssm_scan_chunk_ref(dt, xh, bm, cm, a, h0)[1])


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("shape", SHAPES)
def test_segmented_matches_the_twin(shape, k):
    args = [t(x) for x in scan_case(61, *shape)]
    got = ref.ssm_scan_chunk_bwd_segmented(*args, k or shape[1])
    want = ref.ssm_scan_chunk_bwd_ref(*args)
    for name, g, w in zip(("dt", "xh", "B", "C", "A", "h0"), got, want):
        assert g.shape == w.shape, name
        limit = SEG_TOL["rtol"] * w.abs() + SEG_TOL["atol"] * float(w.abs().max())
        assert bool(((g - w).abs() <= limit).all()), (name, float((g - w).abs().max()))


@pytest.mark.parametrize("shape,k", [((2, 12, 6, 4), 5), ((1, 37, 70, 13), 16),
                                     ((2, 23, 40, 24), 8)])
def test_segmented_matches_jax_selective_scan_chunk(shape, k):
    fwd = scan_case(62, *shape)
    dy, dh = fwd[6:]
    dt, xh, bm, cm, a, h0 = map(jnp.asarray, fwd[:6])

    def objective(dt, xh, bm, cm, a, h0):
        h_last, y = j_mamba._selective_scan_chunk(h0, (dt, xh, bm, cm, a))
        return jnp.sum(y * dy) + jnp.sum(h_last * dh)

    want = jax.jit(jax.grad(objective, argnums=tuple(range(6))))(dt, xh, bm, cm, a, h0)
    got = ref.ssm_scan_chunk_bwd_segmented(*map(t, fwd), k)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
