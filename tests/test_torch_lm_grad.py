"""The LM trainer's step against the JAX package's, where each family
takes its kernel: ``make_train_step`` of the smoke smollm-360m at S 4096
(every attention layer on the flash branch, ``Sq * Skv > 2048^2``), the
smoke xlstm-1.3b at S 512 (the stateless mLSTM over two chunks of 256)
and the smoke jamba-1.5-large-398b at S 512 (the scan over two chunks,
chained through the carried state), on the same numpy params and batch.

On the CPU the wrappers run their twins forward and backward
(``ops._FlashAttention`` and its siblings): the gradients the CUDA
backward kernels are held to on the card, with ``remat`` on, as
``Model.loss`` runs. Params are drawn with numpy at the init's scale
(``tests/test_torch_loss_grad.py``'s ``numpy_params``); float32 under
``float_policy()``. The step's loss and grad norm within rtol 1e-4; the
``Model.loss`` gradient of every leaf (read back from Adam's first
moment ``(1 - b1) g``, unclipped by the step's own norm) within rtol
1e-4 / atol 1e-5; the new params as ``test_train_step_matches_jax``
argues below.

The xlstm params take the forget gates' bias near +3, as the xLSTM
authors initialize it. Near 0 the forget gates sum to about -0.7 a step,
so over a 256-step chunk ``exp(g_j - m_loc_t)`` above the diagonal
overflows in the JAX package's ``_mlstm_chunk`` (``g`` grows by ~0.7 a
step) and the mask ``jnp.where(lmask, w_intra, 0.0)`` sends ``0 * inf``
back: its ``jax.grad`` is NaN. The port's backward never forms the
weights above the diagonal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import float_policy as j_float_policy
from repro.configs import smoke_config as j_smoke_config
from repro.models.model_factory import build_model as j_build_model
from repro.train import step as j_step
from repro_torch.configs.base import float_policy, smoke_config
from repro_torch.convert import params_from_numpy
from repro_torch.kernels import ops
from repro_torch.models.model_factory import build_model
from repro_torch.train import step as t_step
from tests.test_torch_loss_grad import GRAD_TOL, leaves, numpy_params

# (arch, batch, seq, the kernel its loss reaches)
CASES = [("smollm-360m", 1, 4096, "flash_attention"),
         ("xlstm-1.3b", 1, 512, "mlstm_chunked"),
         ("jamba-1.5-large-398b", 1, 512, "ssm_scan_chunk")]


def _unclipped(opt, gnorm):
    """The gradient from Adam's first moment after one step from zero,
    ``(1 - b1) min(1, clip / |g|) g``, unclipped by the step's norm."""
    return [np.asarray(mu, dtype=np.float64) / 0.1 * max(1.0, float(gnorm))
            for mu in opt]


@pytest.mark.parametrize("arch,batch,seq,kernel", CASES)
def test_train_step_matches_jax(arch, batch, seq, kernel, monkeypatch):
    """Adam's first step moves each param by ``lr_t g / (|g| + eps)`` (m
    and v start at zero), so the new params agree to a few ulps of the
    param plus ``lr_t`` times the relative error of g, within ``2e-3
    lr_t`` where ``|g| > 1e-6`` (float32 sums in other orders move g by
    ~1e-6 of a leaf's largest gradient), and within ``2 lr_t``, the most
    an update can move, for the elements near zero, whose sign the
    rounding may flip."""
    rng = np.random.default_rng(270)
    j_cfg = j_smoke_config(arch)
    jm = j_build_model(j_cfg, j_float_policy())
    params = numpy_params(jm, rng)
    if arch == "xlstm-1.3b":
        for layer in params["layers"]:
            if "mlstm" in layer:
                b = np.asarray(layer["mlstm"]["if_proj"]["b"]).copy()
                h = b.shape[-1] // 2
                b[..., h:] = 3.0 + 0.5 * rng.normal(size=b[..., h:].shape)
                layer["mlstm"]["if_proj"]["b"] = jnp.asarray(b)
    tokens = rng.integers(0, j_cfg.vocab_size, size=(batch, seq), dtype=np.int32)
    labels = rng.integers(0, j_cfg.vocab_size, size=(batch, seq), dtype=np.int32)
    j_fn = jax.jit(j_step.make_train_step(jm, j_step.TrainConfig()))
    j_new, j_opt, j_metrics = j_fn(params, j_step.init_opt_state(params),
                                   {"tokens": jnp.asarray(tokens),
                                    "labels": jnp.asarray(labels)})

    calls = {"fwd": 0, "bwd": 0}
    fwd = {"flash_attention": "_flash_forward", "mlstm_chunked": "_mlstm_forward",
           "ssm_scan_chunk": "_ssm_forward"}[kernel]
    for name, key in ((fwd, "fwd"), (kernel + "_bwd", "bwd")):
        inner = getattr(ops, name)

        def counted(*a, _inner=inner, _key=key, **k):
            calls[_key] += 1
            return _inner(*a, **k)

        monkeypatch.setattr(ops, name, counted)
    model = build_model(smoke_config(arch), float_policy())
    tparams = params_from_numpy(params, device="cpu")
    fn = t_step.make_train_step(model, t_step.TrainConfig())
    new, opt, metrics = fn(tparams, t_step.init_opt_state(tparams),
                           {"tokens": torch.from_numpy(tokens).long(),
                            "labels": torch.from_numpy(labels).long()})
    # remat: each period's forward runs twice, its backward once
    assert calls["fwd"] == 2 * calls["bwd"] > 0, calls
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(metrics[key]), float(j_metrics[key]), rtol=1e-4)
    names = [jax.tree_util.keystr(path)
             for path, _ in jax.tree_util.tree_flatten_with_path(j_new)[0]]
    got_g = _unclipped(leaves(opt["adam"]["mu"]), metrics["grad_norm"])
    want_g = _unclipped(jax.tree_util.tree_leaves(j_opt["adam"]["mu"]),
                        j_metrics["grad_norm"])
    assert len(got_g) == len(want_g) == len(names)
    for name, g, w in zip(names, got_g, want_g):
        np.testing.assert_allclose(g, w, **GRAD_TOL, err_msg=f"{arch} d loss / d {name}")
    lr_t = t_step.TrainConfig().adamw.lr * float(metrics["lr_scale"])
    for name, got, want, g in zip(names, leaves(new), jax.tree_util.tree_leaves(j_new),
                                  want_g):
        diff = np.abs(got.numpy() - np.asarray(want))
        big = np.abs(g) > 1e-6
        assert (diff[big] <= 2e-3 * lr_t + 1e-6 * np.abs(np.asarray(want))[big]).all(), name
        assert (diff <= 2 * lr_t + 1e-6).all(), name
