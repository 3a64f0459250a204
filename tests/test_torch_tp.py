"""Tensor-parallel LM training over a ``("data", "model")`` mesh of CPU
entries (``train.step.make_tp_train_step``) against the single-device step
and the JAX package's sharded step: the rule table's shards against the
JAX arrays' ``addressable_shards`` on the forced host devices, the step on
(1, 2), (1, 4) (the smoke configs' kv heads split mid-head) and (2, 2)
meshes for smollm-360m, qwen2.5-3b (QKV bias, tied embeddings) and
pixtral-12b (``input_embeds``, an untied head) under both policies, the
row-parallel alpha, the vocab-parallel loss over a padded vocab, the clip's
norm of a laid-out tree, the collectives, ``constrain`` and its friends,
the launcher's layouts and a resume across them (jamba, xlstm and seamless
on the model axis: ``test_torch_tp_ssm.py``, ``test_torch_tp_encdec.py``). Params and batches are
drawn with numpy or a seeded generator; the tolerances are
``test_torch_lm_dp.py``'s (``assert_same_step``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as j_configs
from repro.distributed import sharding as j_sharding
from repro.models.model_factory import build_model as j_build_model
from repro.train import step as j_step
from repro_torch import tree
from repro_torch.configs.base import float_policy, smoke_config, train_policy
from repro_torch.convert import params_from_numpy
from repro_torch.distributed import sharding
from repro_torch.distributed import tensor_parallel as tp
from repro_torch.launch import train as launch_train
from repro_torch.launch.mesh import DeviceMesh, ServingMesh, make_device_mesh
from repro_torch.models.common import (proj, softmax_cross_entropy,
                                       vocab_parallel_cross_entropy)
from repro_torch.models.model_factory import build_model
from repro_torch.optim.clip import global_norm
from repro_torch.train.step import (TrainConfig, init_opt_state,
                                    make_tp_train_step, make_train_step)
import torch_parity  # noqa: F401  (one torch thread a pytest-xdist worker)
from test_torch_lm_dp import POLICIES, assert_same_step

ARCHS = ["smollm-360m", "qwen2.5-3b", "pixtral-12b"]
MESHES = [(1, 2), (1, 4), (2, 2)]
BATCH, SEQ = 4, 32


def cpu_mesh(shape) -> DeviceMesh:
    return DeviceMesh(np.full(shape, "cpu", dtype=object), ("data", "model"))


def batch_of(cfg, seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (BATCH, SEQ + 1)).astype(np.int32)
    batch = {"tokens": tokens[:, :-1].copy(), "labels": tokens[:, 1:].copy()}
    if cfg.input_kind == "embeddings":
        batch["input_embeds"] = rng.normal(
            0, 1, (BATCH, SEQ, cfg.d_model)).astype(np.float32)
        del batch["tokens"]
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def j_params_of(arch: str, policy: str):
    jcfg = j_configs.smoke_config(arch)
    jpol = j_configs.train_policy() if policy == "train" else j_configs.float_policy()
    jm = j_build_model(jcfg, jpol)
    return jm, jm.init(jax.random.PRNGKey(0))


def j_mesh(shape):
    devices = np.asarray(jax.devices()[:int(np.prod(shape))]).reshape(shape)
    return jax.sharding.Mesh(devices, ("data", "model"))


# ------------------------------ layout ----------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_shards_are_the_jax_arrays_addressable_shards(arch):
    """Leaf by leaf, each device's shard has the shape and the numbers of
    the JAX array's shard on that device, placed by ``params_shardings`` on
    a (1, 2) and a (2, 2) host mesh (there split over ``data`` too);
    ``gather_params(shard_params(p))`` is ``p`` bit for bit."""
    _, jparams = j_params_of(arch, "float")
    params = params_from_numpy(jparams, device="cpu")
    for shape in ((1, 2), (2, 2)):
        jm = j_mesh(shape)
        placed = jax.device_put(jparams, j_sharding.params_shardings(jm, jparams))
        shards = sharding.shard_params(params, cpu_mesh(shape))
        order = {d: i for i, d in enumerate(jm.devices.flat)}
        jleaves = jax.tree_util.tree_leaves(placed)
        assert len(jleaves) == len(tree.leaves(params))
        for i, jleaf in enumerate(jleaves):
            for s in jleaf.addressable_shards:
                got = tree.leaves(shards[order[s.device]])[i]
                np.testing.assert_array_equal(got.numpy(), np.asarray(s.data))
    for shape in MESHES:
        again = sharding.gather_params(sharding.shard_params(params, cpu_mesh(shape)),
                                       cpu_mesh(shape))
        for a, b in zip(tree.leaves(again), tree.leaves(params)):
            assert torch.equal(a, b)


def test_shards_follow_the_rule_table():
    """On a (2, 2) mesh each device's block of each leaf is ``shard_shape``
    of its whole spec, data axes included: device (k, r) holds rank r's
    contiguous part over ``model`` and data row k's over ``data``
    (``device_block``); every device holds tensors of its own, so no tree
    repeats down the rows."""
    model = build_model(smoke_config("qwen2.5-3b"), float_policy())
    params = model.init(torch.Generator().manual_seed(0))
    mesh = cpu_mesh((2, 2))
    shards = sharding.shard_params(params, mesh)
    assert len(shards) == 4 and len(shards.rows()) == 2
    split_over_data = 0
    for path, leaf in tree.leaves_with_path(params):
        spec = sharding.param_spec(mesh, path, leaf)
        want = sharding.shard_shape(mesh, leaf.shape, spec)
        split_over_data += "data" in spec
        blocks = [sharding.spec_at(shards[i], path) for i in range(4)]
        assert len({b.data_ptr() for b in blocks}) == 4
        for i, got in enumerate(blocks):
            k, r = divmod(i, 2)
            assert tuple(got.shape) == want
            assert torch.equal(got, sharding.device_block(leaf, spec, 2, r, 2, k))
    assert split_over_data > 0


# ------------------------------ the step --------------------------------------


def _steps(arch, policy, shape, tcfg=TrainConfig()):
    cfg = smoke_config(arch)
    model = build_model(cfg, POLICIES[policy]())
    params = model.init(torch.Generator().manual_seed(1))
    opt = init_opt_state(params)
    batch = batch_of(cfg)
    one = make_train_step(model, tcfg)(params, opt, batch)
    mesh = cpu_mesh(shape)
    p, o, m = make_tp_train_step(model, tcfg, mesh)(
        sharding.shard_params(params, mesh), sharding.shard_params(opt, mesh), batch)
    return one, (sharding.gather_params(p, mesh), sharding.gather_params(o, mesh), m)


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("policy", sorted(POLICIES))
@pytest.mark.parametrize("arch", ARCHS)
def test_tp_step_equals_the_single_device_step(arch, policy, shape):
    """Loss rtol 1e-5, Adam's first moment rtol 1e-3 / atol 1e-8, params
    within 2 lr lr_scale; the pre-clip norm within rtol 1e-5."""
    one, tp_ = _steps(arch, policy, shape)
    assert_same_step(one, tp_, TrainConfig())


def test_tp_step_with_microbatches():
    tcfg = TrainConfig(microbatches=2)
    one, tp_ = _steps("qwen2.5-3b", "train", (1, 2), tcfg)
    assert_same_step(one, tp_, tcfg)


@pytest.mark.parametrize("policy", sorted(POLICIES))
@pytest.mark.parametrize("arch", ARCHS)
def test_tp_step_is_the_jax_sharded_step(arch, policy):
    """The JAX package's ``make_train_step`` jitted with ``in_shardings``
    from ``params_shardings`` under ``activation_mesh`` on a (1, 2) host
    mesh, against one TP step on the same params: loss rtol 1e-5, the
    updated params gathered within 2 lr lr_scale."""
    jm, jparams = j_params_of(arch, policy)
    jopt = j_step.init_opt_state(jparams)
    mesh, jmesh = cpu_mesh((1, 2)), j_mesh((1, 2))
    batch = batch_of(smoke_config(arch), seed=5)
    jbatch = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
    with jmesh, j_sharding.activation_mesh(jmesh):
        jstep = jax.jit(j_step.make_train_step(jm, j_step.TrainConfig()),
                        in_shardings=(j_sharding.params_shardings(jmesh, jparams),
                                      j_sharding.params_shardings(jmesh, jopt), None))
        jnew, _, jmetrics = jstep(jparams, jopt, jbatch)
    model = build_model(smoke_config(arch), POLICIES[policy]())
    params = params_from_numpy(jparams, device="cpu")
    p, _, m = make_tp_train_step(model, TrainConfig(), mesh)(
        sharding.shard_params(params, mesh),
        sharding.shard_params(init_opt_state(params), mesh), batch)
    np.testing.assert_allclose(float(m["loss"]), float(jmetrics["loss"]), rtol=1e-5)
    move = 2 * TrainConfig().adamw.lr * float(m["lr_scale"])
    for a, b in zip(tree.leaves(sharding.gather_params(p, mesh)),
                    jax.tree_util.tree_leaves(jnew)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=move)


# ------------------------------ the pieces ------------------------------------


def _ranked_proj(w, x, ranks: int, row: bool, bias=None):
    spec = sharding.P(None, "model") if row else sharding.P("model", None)
    params = {"w": w} if bias is None else {"w": w, "b": bias}
    specs = {"w": spec, "b": sharding.P()} if row else {"w": spec, "b": sharding.P("model")}
    parts = [{k: sharding.model_slice(v, specs[k], ranks, r) for k, v in params.items()}
             for r in range(ranks)]
    return tp.RankedTree(parts, {k: specs[k] for k in params}), tp.Ranked(
        [x] * ranks, (None, None))


@pytest.mark.parametrize("ranks", [2, 4])
def test_row_parallel_alpha_is_the_whole_row_s(ranks):
    """A row-parallel projection under ``train_policy()`` (XNOR-Net alpha)
    with a replicated bias equals the single-device one; with each rank's
    own alpha it would not."""
    rng = np.random.default_rng(2)
    w = torch.from_numpy(rng.normal(0, 1, (24, 64)).astype(np.float32))
    w[:, :64 // ranks] *= 4.0          # the first rank's slice is larger
    x = torch.from_numpy(rng.normal(0, 1, (5, 64)).astype(np.float32))
    b = torch.from_numpy(rng.normal(0, 1, (24,)).astype(np.float32))
    policy = train_policy()
    want = proj({"w": w, "b": b}, x, policy)
    params, xr = _ranked_proj(w, x, ranks, row=True, bias=b)
    got = proj(params, xr, policy)
    assert got.spec == (None, None)
    for part in got.parts:
        torch.testing.assert_close(part, want, rtol=1e-5, atol=1e-5)
    local = sum(proj({"w": p["w"]}, x[:, r * 64 // ranks:(r + 1) * 64 // ranks], policy)
                for r, p in enumerate(params.parts)) + b
    assert not torch.allclose(local, want, rtol=1e-2, atol=1e-2)
    col, xc = _ranked_proj(w, x, ranks, row=False, bias=b)
    torch.testing.assert_close(torch.cat(proj(col, xc, policy).parts, -1), want,
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("ranks", [2, 4])
def test_vocab_parallel_loss_masks_the_padded_vocab(ranks):
    """Vocab 300 padded to 512 over the ranks: the padding (large logits,
    in the last ranks' slices, a whole slice at 4 ranks) is masked; the
    loss and its gradient equal the plain loss of the first 300 columns."""
    rng = np.random.default_rng(3)
    logits = torch.from_numpy(rng.normal(0, 3, (2, 7, 512)).astype(np.float32))
    logits[..., 300:] = 50.0
    labels = torch.from_numpy(rng.integers(0, 300, (2, 7)))
    whole = logits.clone().requires_grad_(True)
    want = softmax_cross_entropy(whole[..., :300], labels)
    (g_want,) = torch.autograd.grad(want, whole)
    split = logits.clone().requires_grad_(True)
    ranked = tp.Ranked(torch.chunk(split, ranks, -1), (None, None, "model"))
    got = vocab_parallel_cross_entropy(ranked, tp.Ranked.replicated(labels, ["cpu"] * ranks),
                                       300)
    (g_got,) = torch.autograd.grad(got, split)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(g_got, g_want, rtol=1e-5, atol=1e-7)
    assert float(g_got[..., 300:].abs().max()) == 0.0


def test_global_norm_counts_a_replicated_leaf_once():
    rng = np.random.default_rng(4)
    full = {"norm": {"scale": torch.from_numpy(rng.normal(size=(8,)).astype(np.float32))},
            "q_proj": {"w": torch.from_numpy(rng.normal(size=(8, 6)).astype(np.float32))}}
    mesh = cpu_mesh((1, 2))
    shards = sharding.shard_params(full, mesh)
    assert shards.specs["q_proj"]["w"] == ("model", None)
    torch.testing.assert_close(global_norm(shards), global_norm(full), rtol=1e-6, atol=0)
    twice = torch.sqrt(sum(torch.sum(t ** 2) for s in shards for t in tree.leaves(s)))
    assert float(twice) > float(global_norm(full)) * 1.05


def test_collectives_are_deterministic_with_their_gradients():
    """all_reduce's gradient is the sum of its copies' gradients on every
    input, all_gather's each input's slice of them summed; two runs give
    the same bits, and each counts its bytes a device."""
    rng = np.random.default_rng(5)
    xs = [torch.from_numpy(rng.normal(size=(3, 4)).astype(np.float32)).requires_grad_(True)
          for _ in range(3)]
    tp.reset_bytes()
    outs = tp.all_reduce(xs, site="t")
    assert all(torch.equal(o, xs[0] + xs[1] + xs[2]) for o in outs)
    ws = [torch.full((3, 4), float(r + 1)) for r in range(3)]
    grads = torch.autograd.grad(sum((o * w).sum() for o, w in zip(outs, ws)), xs)
    assert all(torch.equal(g, torch.full((3, 4), 6.0)) for g in grads)
    gathered = tp.all_gather(xs, -1, site="t")
    assert all(torch.equal(g, torch.cat(xs, -1)) for g in gathered)
    grads = torch.autograd.grad(sum((g * r).sum() for r, g in enumerate(gathered)), xs)
    assert all(torch.equal(g, torch.full((3, 4), 3.0)) for g in grads)
    assert tp.BYTES[("all-reduce", "t", "fwd")] == 3 * 4 * 4 * 2
    assert tp.BYTES[("all-gather", "t", "fwd")] == 3 * 12 * 4
    assert tp.BYTES[("reduce-scatter", "t", "bwd")] == 3 * 4 * 4
    again = tp.all_reduce([x.detach() for x in xs])
    assert torch.equal(again[0], outs[0])
    mx = tp.all_max([x.detach() for x in xs])
    assert torch.equal(mx[1], torch.maximum(torch.maximum(xs[0], xs[1]), xs[2]))


def test_constrain_and_friends():
    """Identity with no mesh; under a mesh a ``Ranked`` is laid out by the
    guarded spec (sliced or gathered) and its parts checked, as is a
    whole tensor; ``activation_mesh`` restores the mesh it replaced."""
    x = torch.arange(4 * 3 * 8, dtype=torch.float32).reshape(4, 3, 8)
    ranked = tp.Ranked([x[:2]] * 2, (None, None, None))
    assert sharding.get_active_mesh() is None
    assert sharding.constrain(x, "data", None, "model") is x
    assert sharding.constrain_seq(ranked) is ranked
    mesh = cpu_mesh((2, 2))
    with sharding.activation_mesh(mesh):
        assert sharding.get_active_mesh() is mesh
        split = sharding.constrain(ranked, sharding.DATA_AXES, None, sharding.MODEL_AXIS)
        assert split.spec == (None, None, "model")
        assert torch.equal(split.parts[1], x[:2, :, 4:])
        back = sharding.constrain_seq(split)
        assert back.spec == (None, None, None) and torch.equal(back.parts[1], x[:2])
        with pytest.raises(ValueError, match="shard"):   # a data shard's rows as the batch
            sharding.constrain(ranked, None, None, None)
        assert sharding.constrain(x, None, sharding.DATA_AXES, None) is x  # 3 rows
        with pytest.raises(ValueError, match="shard"):
            sharding.constrain(x, sharding.DATA_AXES, None, sharding.MODEL_AXIS)
        with sharding.activation_mesh(None):
            assert sharding.constrain(x, "data") is x
        assert sharding.get_active_mesh() is mesh
    assert sharding.get_active_mesh() is None


# ------------------------------ the launcher ----------------------------------


def test_device_mesh_is_the_jax_launcher_s_layout(monkeypatch):
    """``make_device_mesh(devices, model_parallel=min(n, 16))``: (1, n) up
    to 16 devices, (n // 16, 16) past; the launcher takes it for every
    family on several cards (a dense one, jamba's hybrid stack)."""
    for n, shape in ((2, (1, 2)), (5, (1, 5)), (16, (1, 16)), (40, (2, 16))):
        mesh = make_device_mesh(["cpu"] * n, model_parallel=min(n, 16))
        assert tuple(mesh.shape.values()) == shape
        assert mesh.axis_names == ("data", "model") and len(mesh.flat) == np.prod(shape)
    dev = make_device_mesh([torch.device("cuda", 0)] * 4, model_parallel=4)
    assert dev.flat == (torch.device("cuda", 0),) * 4
    with pytest.raises(ValueError):
        DeviceMesh(np.array([["cpu", "cuda:0"]], dtype=object), ("data", "model"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    got = launch_train.train_mesh()
    assert isinstance(got, DeviceMesh) and dict(got.shape) == {"data": 1, "model": 2}
    assert got.flat == (torch.device("cuda", 0), torch.device("cuda", 1))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert isinstance(launch_train.train_mesh(), ServingMesh)


def test_checkpoint_of_a_tp_run_resumes_on_one_device(tmp_path, capsys):
    """``launch.train.train`` on a (1, 2) CPU mesh prints its layout and
    writes a gathered checkpoint at step 4; a run on one device resumes
    from it as from its own run's (losses within rtol 1e-4)."""
    kw = dict(smoke=True, batch=4, seq=16, lr=1e-3, ckpt_every=4, log_every=100,
              quantized=False)
    tp_run = launch_train.train("smollm-360m", steps=4, mesh=cpu_mesh((1, 2)),
                                ckpt_dir=str(tmp_path / "tp"), **kw)
    assert "layout: tensor parallel over {'data': 1, 'model': 2}" in capsys.readouterr().out
    one_run = launch_train.train("smollm-360m", steps=4, device="cpu",
                                 ckpt_dir=str(tmp_path / "one"), **kw)
    np.testing.assert_allclose(tp_run["losses"], one_run["losses"], rtol=1e-5)
    resumed = [launch_train.train("smollm-360m", steps=6, device="cpu",
                                  ckpt_dir=str(tmp_path / name), **kw)["losses"]
               for name in ("tp", "one")]
    assert "resumed from step 4" in capsys.readouterr().out
    assert len(resumed[0]) == 2
    np.testing.assert_allclose(resumed[0], resumed[1], rtol=1e-4)
