"""Checkpoints across packages, and the port's checkpoint manager.

Both formats carry across exactly: the sign-form ``.npz``
(``save_binary_checkpoint`` / ``load_binary_checkpoint``) and the
manager's ``step_*`` directories (``checkpoint/manager.py``: the same
layout and leaf keys, ``params/conv/0/w`` ... ``opt/adam/count``), each
written by one package and read by the other. Then the manager's
behaviour: torn writes skipped, stray names ignored, ``retain``, and
``AsyncCheckpointer``'s snapshot and close.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import manager as j_manager
from repro.core import bnn as jbnn
from repro.optim.adamw import adamw_init as j_adamw_init
from repro_torch import tree
from repro_torch.checkpoint import manager
from repro_torch.convert import params_from_numpy
from repro_torch.core import bnn as tbnn
from repro_torch.optim.adamw import adamw_init

from test_torch_bnn_train import numpy_params
from test_torch_train import bnn_shaped_tree


def _latents(seed=0):
    """Full-width BNN latents (the sign-form layout needs the real layer
    list) with 1% of the weights exactly 0 (sign +1)."""
    rng = np.random.default_rng(seed)
    p = numpy_params(seed)
    for group in ("conv", "fc"):
        for layer in p[group]:
            layer["w"][rng.random(layer["w"].shape) < 0.01] = 0.0
    return p


def _assert_same(got, want):
    flat_g = list(tree.leaves_with_path(got))
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    assert [p for p, _ in flat_g] == [
        tuple(getattr(k, "key", getattr(k, "idx", None)) for k in p) for p, _ in flat_w]
    for (path, g), (_, w) in zip(flat_g, flat_w):
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        w = np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape, path
        np.testing.assert_array_equal(g, w, err_msg=str(path))


def test_sign_checkpoints_cross_both_ways(tmp_path):
    latents = _latents()
    j_path, t_path = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    jbnn.save_binary_checkpoint(j_path, latents)
    tbnn.save_binary_checkpoint(t_path, params_from_numpy(latents, device="cpu"))
    with np.load(j_path) as a, np.load(t_path) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    want = jbnn.load_binary_checkpoint(j_path)
    _assert_same(tbnn.load_binary_checkpoint(j_path, device="cpu"), want)
    _assert_same(tbnn.load_binary_checkpoint(t_path, device="cpu"), want)
    _assert_same(tbnn.load_binary_checkpoint(t_path, device="cpu"),
                 jbnn.load_binary_checkpoint(t_path))


def _train_state(seed):
    """A trainer's checkpoint tree, ``{"params", "opt": {"adam": {"mu",
    "nu", "count"}}}``, with moments and a count that are not the init's."""
    rng = np.random.default_rng(seed)
    params = bnn_shaped_tree(rng)
    return {"params": params,
            "opt": {"adam": {"mu": bnn_shaped_tree(rng, 0.1),
                             "nu": bnn_shaped_tree(rng, 0.01),
                             "count": np.asarray(37, np.int32)}}}


def test_manager_checkpoints_cross_both_ways(tmp_path):
    state = _train_state(1)
    t_state = params_from_numpy(state, device="cpu")
    assert t_state["opt"]["adam"]["count"].dtype == torch.int32
    # like trees as each trainer builds them: its params and a fresh
    # optimizer state.
    j_like = {"params": jax.tree.map(jnp.zeros_like, state["params"]),
              "opt": {"adam": j_adamw_init(state["params"])}}
    t_params = params_from_numpy(state["params"], device="cpu")
    t_like = {"params": tree.tree_map(torch.zeros_like, t_params),
              "opt": {"adam": adamw_init(t_params)}}

    manager.save(str(tmp_path / "t"), 50, t_state)
    assert j_manager.latest_valid_step(str(tmp_path / "t")) == 50
    _assert_same(j_manager.restore(str(tmp_path / "t"), 50, j_like), state)

    j_manager.save(str(tmp_path / "j"), 50, state)
    assert manager.latest_valid_step(str(tmp_path / "j")) == 50
    got = manager.restore(str(tmp_path / "j"), 50, t_like)
    _assert_same(got, state)
    assert got["opt"]["adam"]["count"].shape == ()
    # The same keys and leaf metadata either way; each side's own treedef.
    import json
    metas = [json.load(open(tmp_path / d / "step_00000050" / "tree.json"))
             for d in ("t", "j")]
    assert metas[0]["leaves"] == metas[1]["leaves"]
    assert any(m["key"] == "opt/adam/count" and m["dtype"] == "int32"
               for m in metas[0]["leaves"])


def test_restore_names_missing_keys(tmp_path):
    state = params_from_numpy(_train_state(2), device="cpu")
    manager.save(str(tmp_path), 1, state["params"])
    with pytest.raises(ValueError, match="missing leaf keys.*params/conv/0/w"):
        manager.restore(str(tmp_path), 1, state)


def test_torn_and_stray_entries_are_skipped(tmp_path):
    d = str(tmp_path)
    state = params_from_numpy(_train_state(3), device="cpu")
    manager.save(d, 10, state)
    manager.save(d, 20, state)
    os.remove(os.path.join(d, "step_00000020", "MANIFEST.json"))  # torn write
    os.makedirs(os.path.join(d, "step_abc"))
    os.makedirs(os.path.join(d, "step_00000030.tmp"))
    open(os.path.join(d, "step_notes.txt"), "w").close()
    assert manager.latest_valid_step(d) == 10
    with open(os.path.join(d, "step_00000010", "tree.json"), "a") as f:
        f.write(" ")  # a checksum that no longer matches
    assert manager.latest_valid_step(d) is None
    assert manager.latest_valid_step(os.path.join(d, "absent")) is None


def test_retain_keeps_the_last_three(tmp_path):
    d = str(tmp_path)
    state = {"w": torch.ones(3)}
    for step in (5, 1, 3, 4, 2):
        manager.save(d, step, state)
    os.makedirs(os.path.join(d, "step_junk"))
    manager.retain(d, keep=3)
    assert sorted(os.listdir(d)) == ["step_00000003", "step_00000004",
                                     "step_00000005", "step_junk"]


def test_async_checkpointer_snapshots_before_save_returns(tmp_path):
    d = str(tmp_path)
    w = torch.zeros(4)
    ckpt = manager.AsyncCheckpointer(d, keep=2)
    for step in range(1, 4):
        w.fill_(float(step))
        ckpt.save(step, {"w": w})
        w.add_(100.0)  # an in-place update after save returns
    ckpt.wait()
    assert sorted(os.listdir(d)) == ["step_00000002", "step_00000003"]
    for step in (2, 3):
        got = manager.restore(d, step, {"w": torch.empty(4)})
        assert torch.equal(got["w"], torch.full((4,), float(step)))
    ckpt.close()
    ckpt.close()  # idempotent
    with pytest.raises(RuntimeError, match="after close"):
        ckpt.save(4, {"w": w})
