"""Gradients of the LM loss: ``torch.autograd.grad`` of the port's
``Model.loss`` against ``jax.grad`` of the JAX package's, with respect to
every parameter, for the smoke configs of smollm-360m (dense), xlstm-1.3b
(ssm: sLSTM and the chunkwise mLSTM) and jamba-1.5-large-398b (hybrid:
the selective scan, attention and MoE experts with their aux loss).

On the CPU the port's kernel wrappers return their plain twins, which
autograd differentiates; on CUDA the wrappers raise on operands that
require grad, because no kernel has a backward yet. These are the
gradients the backward kernels will be held to. The loss is taken under
``float_policy()``: the port has no straight-through estimator for
``train_policy()``'s sign yet, so its weight gradients would be zero.

Params and batch come from numpy: every leaf of the JAX package's init
tree is drawn from ``np.random.default_rng`` at the init's scale
(``numpy_params``), and the tokens and labels are numpy integers; both
packages get the same arrays. A batch of 2 x 32 keeps every layer on its
one-chunk path (the mLSTM and the scan through their kernels' twins,
attention unchunked). Tolerance: float32 sums in other orders through
every layer and back, rtol 1e-4 and atol 1e-5 on every gradient (a
leaf's largest gradient is 4e-3 to 0.5; the largest disagreement seen
takes a fifth of the tolerance, in xlstm); the loss itself within 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import float_policy as j_float_policy
from repro.configs import smoke_config as j_smoke_config
from repro.models.model_factory import build_model as j_build_model
from repro_torch.configs.base import float_policy, smoke_config
from repro_torch.convert import params_from_numpy
from repro_torch.kernels import ops
from repro_torch.models.model_factory import build_model

GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
BATCH, SEQ = 2, 32
ARCHS = ["jamba-1.5-large-398b", "smollm-360m", "xlstm-1.3b"]


def numpy_params(jm, rng):
    """Params of the JAX model's init tree (shapes from ``jax.eval_shape``)
    drawn from ``rng``: weights, embeddings and recurrent matrices normal
    over the root of their fan-in (last axis) as the init draws them,
    norm scales and skip gains 1 + 0.1 normal, the rest (biases,
    ``A_log``) 0.5 normal."""
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0))

    def draw(path, leaf):
        name = path[-1].key
        z = rng.normal(size=leaf.shape)
        if name in ("w", "conv_w", "R", "table"):
            z = z / np.sqrt(leaf.shape[-1])
        elif name in ("scale", "gn_scale", "D"):
            z = 1.0 + 0.1 * z
        else:
            z = 0.5 * z
        return z.astype(leaf.dtype)
    return jax.tree_util.tree_map_with_path(draw, shapes)


def leaves(tree):
    """The tensors of a nested dict/list tree in ``jax.tree_util``'s order
    (dict keys sorted, sequences in order)."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in leaves(v)]
    return [tree]


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_gradient_matches_jax(arch):
    rng = np.random.default_rng(190)
    j_cfg = j_smoke_config(arch)
    jm = j_build_model(j_cfg, j_float_policy())
    params = numpy_params(jm, rng)
    tokens = rng.integers(0, j_cfg.vocab_size, size=(BATCH, SEQ), dtype=np.int32)
    labels = rng.integers(0, j_cfg.vocab_size, size=(BATCH, SEQ), dtype=np.int32)

    def j_total(p):
        return jm.loss(p, {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)})[0]

    want_total, want = jax.jit(jax.value_and_grad(j_total))(params)
    names = [jax.tree_util.keystr(path)
             for path, _ in jax.tree_util.tree_flatten_with_path(want)[0]]

    model = build_model(smoke_config(arch), float_policy())
    tparams = params_from_numpy(params, device="cpu")
    tleaves = [t.requires_grad_() for t in leaves(tparams)]
    before = dict(ops.LAUNCHES)
    total, _ = model.loss(tparams, {"tokens": torch.from_numpy(tokens).long(),
                                    "labels": torch.from_numpy(labels).long()})
    got = torch.autograd.grad(total, tleaves)
    assert ops.LAUNCHES == before   # the twins, on the CPU
    np.testing.assert_allclose(float(total.detach()), float(want_total), rtol=1e-5,
                               atol=1e-5)
    want_leaves = jax.tree_util.tree_leaves(want)
    assert len(got) == len(want_leaves) == len(names)
    for name, g, w in zip(names, got, want_leaves):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **GRAD_TOL,
                                   err_msg=f"{arch} d loss / d {name}")
