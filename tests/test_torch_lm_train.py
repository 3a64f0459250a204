"""The LM trainer slice of the port on the CPU: the three backward twins
(``kernels/ref.py``: flash attention, the selective scan, the chunkwise
mLSTM), ``remat``, ``make_elastic_mesh``, the launcher
(``launch/train.py``).

Each backward twin is held to ``torch.autograd`` of its forward twin
(the scan's also by ``gradcheck`` in float64) and to ``jax.grad`` of the
JAX package's path off the TPU on the same numpy inputs, within rtol
1e-4 / atol 1e-5: ``_attend_chunked``, ``_selective_scan_chunk`` (an
associative scan) and ``_mlstm_chunk`` under ``lax.scan``. The CUDA
kernels are held to these twins on the card (``chip_smoke.py`` phase
11, ``tests/test_torch_cuda.py``). Inputs come from
``np.random.default_rng``; shapes are small.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from repro.distributed import fault_tolerance as j_ft
from repro.models import attention as j_attn
from repro.models import mamba as j_mamba
from repro.models import xlstm as j_xlstm
from repro_torch import tree
from repro_torch.configs.base import float_policy, smoke_config
from repro_torch.distributed.fault_tolerance import make_elastic_mesh
from repro_torch.kernels import ops, ref
from repro_torch.launch import train as launch_train
from repro_torch.launch.mesh import DeviceMesh, ServingMesh
from repro_torch.models.model_factory import build_model
from repro_torch.models.encdec import encdec_loss
from repro_torch.models.transformer import lm_loss
from tests.torch_parity import t

TOL = dict(rtol=1e-4, atol=1e-5)
ARCHS = ["jamba-1.5-large-398b", "smollm-360m", "xlstm-1.3b", "qwen2.5-3b",
         "qwen2.5-32b", "mistral-large-123b", "moonshot-v1-16b-a3b",
         "arctic-480b", "pixtral-12b", "seamless-m4t-large-v2"]


def normal(rng, *shape, scale=1.0):
    return (scale * rng.normal(size=shape)).astype(np.float32)


# ------------------------------- the inputs ---------------------------------

def flash_inputs(rng, bh=2, sq=70, skv=70, dh=16):
    return (normal(rng, bh, sq, dh), normal(rng, bh, skv, dh),
            normal(rng, bh, skv, dh), normal(rng, bh, sq, dh))


def scan_inputs(rng, b=2, c=9, di=5, ds=4):
    dt = np.log1p(np.exp(normal(rng, b, c, di)))
    a = -np.arange(1, ds + 1, dtype=np.float32)[None].repeat(di, 0) * \
        (1 + 0.1 * rng.random((di, ds))).astype(np.float32)
    return (dt, normal(rng, b, c, di), normal(rng, b, c, ds), normal(rng, b, c, ds),
            a, normal(rng, b, di, ds, scale=0.5), normal(rng, b, c, di),
            normal(rng, b, di, ds))


def mlstm_inputs(rng, b=1, h=2, s=32, dh=8, q_scale=0.3):
    """[B, S, H, d] arrays as the JAX cell takes them (q pre-scaled);
    ``q_scale`` small keeps |den| under 1 on some steps (the clamp)."""
    q = normal(rng, b, s, h, dh, scale=q_scale)
    k, v = normal(rng, b, s, h, dh), normal(rng, b, s, h, dh)
    logi = normal(rng, b, s, h)
    logf = np.log(1 / (1 + np.exp(-(normal(rng, b, s, h) + 2)))).astype(np.float32)
    return q, k, v, logi, logf


def heads(x):
    """[B, S, H, ...] -> [B*H, S, ...]."""
    x = np.moveaxis(x, 2, 1)
    return np.ascontiguousarray(x.reshape(x.shape[0] * x.shape[1], *x.shape[2:]))


# ------------------- backward twins against autograd -------------------------

@pytest.mark.parametrize("causal", [True, False])
def test_flash_backward_twin_matches_autograd(causal):
    q, k, v, do = flash_inputs(np.random.default_rng(250), skv=70 if causal else 45)
    tq, tk, tv = (t(a).requires_grad_() for a in (q, k, v))
    o, lse = ref.flash_attention_ref(tq, tk, tv, causal=causal, block_kv=16,
                                     return_lse=True)
    want = torch.autograd.grad((o * t(do)).sum(), (tq, tk, tv))
    got = ref.flash_attention_bwd_ref(t(q), t(k), t(v), o.detach(), lse.detach(),
                                      t(do), causal=causal, block_q=32)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), **TOL)


def test_scan_backward_twin_matches_autograd_and_gradcheck():
    rng = np.random.default_rng(251)
    *fwd, dy, dh = scan_inputs(rng)
    args = [t(a).double().requires_grad_() for a in fwd]
    y, h = ref.ssm_scan_chunk_ref(*args)
    want = torch.autograd.grad((y * t(dy).double()).sum() + (h * t(dh).double()).sum(), args)
    got = ref.ssm_scan_chunk_bwd_ref(*(a.detach() for a in args), t(dy).double(),
                                     t(dh).double())
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-10, atol=1e-12)

    class Scan(torch.autograd.Function):
        @staticmethod
        def forward(ctx, *xs):
            ctx.save_for_backward(*xs)
            return ref.ssm_scan_chunk_ref(*xs)

        @staticmethod
        def backward(ctx, gy, gh):
            return ref.ssm_scan_chunk_bwd_ref(*ctx.saved_tensors, gy, gh)

    cut = [(1, 4, 3), (1, 4, 3), (1, 4, 2), (1, 4, 2), (3, 2), (1, 3, 2)]
    small = [a.detach()[tuple(slice(n) for n in c)].contiguous().requires_grad_()
             for a, c in zip(args, cut)]
    assert torch.autograd.gradcheck(Scan.apply, small)


def test_mlstm_backward_twin_matches_autograd():
    q, k, v, logi, logf = mlstm_inputs(np.random.default_rng(252))
    args = [t(heads(a)).requires_grad_() for a in (q, k, v, logi, logf)]
    y, C, n, m, st, nst = ref.mlstm_chunked_ref(*args, chunk=8, return_states=True)
    rng = np.random.default_rng(253)
    dy, dC, dn = (t(normal(rng, *x.shape)) for x in (y, C, n))
    want = torch.autograd.grad((y * dy).sum() + (C * dC).sum() + (n * dn).sum(), args)
    got = ref.mlstm_chunked_bwd_ref(*(a.detach() for a in args), y.detach(),
                                    st.detach(), nst.detach(), dy, dC, dn, chunk=8)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-4, atol=1e-5)


# ---------------- backward twins against jax.grad of the JAX paths -----------

@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dh", [16, 32, 64, 128])
def test_flash_backward_twin_matches_jax_attend_chunked(dh, causal):
    """d/dq, dk, dv of <out, dO> against jax.grad of ``_attend_chunked``
    (its chunks cut to 32 keys, so the online softmax runs over several),
    at every head width the kernel is compiled for, causal and full."""
    rng = np.random.default_rng(254)
    b, s, h = 1, 64, 3
    q, k, v, do = (normal(rng, b, s, h, dh) for _ in range(4))
    pos = jnp.arange(s)

    def objective(q, k, v):
        out = j_attn._attend_chunked(q, k, v, groups=1, causal=causal, q_positions=pos,
                                     kv_positions=pos, kv_valid=None, sliding_window=0,
                                     q_chunk=32, kv_chunk=32)
        return jnp.sum(out * do)

    want = jax.jit(jax.grad(objective, argnums=(0, 1, 2)))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (t(heads(a)) for a in (q, k, v))
    o, lse = ref.flash_attention_ref(tq, tk, tv, causal=causal, return_lse=True)
    got = ops.flash_attention_bwd(tq, tk, tv, o, lse, t(heads(do)), causal=causal)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), heads(np.asarray(w)), **TOL)


def test_scan_backward_twin_matches_jax_selective_scan_chunk():
    *fwd, dy, dh = scan_inputs(np.random.default_rng(255), c=12, di=6, ds=4)
    dt, xh, bm, cm, a, h0 = map(jnp.asarray, fwd)

    def objective(dt, xh, bm, cm, a, h0):
        h_last, y = j_mamba._selective_scan_chunk(h0, (dt, xh, bm, cm, a))
        return jnp.sum(y * dy) + jnp.sum(h_last * dh)

    want = jax.jit(jax.grad(objective, argnums=tuple(range(6))))(dt, xh, bm, cm, a, h0)
    got = ops.ssm_scan_chunk_bwd(*map(t, fwd), t(dy), t(dh))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def _jax_mlstm_grads(q, k, v, logi, logf, dy, dC, dn, chunk):
    """jax.grad of the JAX package's chunk body scanned over the chunks
    from the zero state, as ``mlstm_cell`` runs it off the TPU (q
    pre-scaled here, as the kernel takes it)."""
    b, s, h, dh = q.shape

    def objective(q, k, v, logi, logf):
        def chunked(x):
            return x.reshape(b, s // chunk, chunk, *x.shape[2:]).swapaxes(0, 1)

        carry = (jnp.zeros((b, h, dh, dh)), jnp.zeros((b, h, dh)),
                 jnp.full((b, h), -1e30))
        (C, n, _), ys = lax.scan(j_xlstm._mlstm_chunk, carry,
                                 tuple(map(chunked, (q, k, v, logi, logf))))
        y = ys.swapaxes(0, 1).reshape(b, s, h, dh)
        return jnp.sum(y * dy) + jnp.sum(C * dC) + jnp.sum(n * dn)

    return jax.jit(jax.grad(objective, argnums=tuple(range(5))))(
        *map(jnp.asarray, (q, k, v, logi, logf)))


def _port_mlstm_grads(q, k, v, logi, logf, dy, dC, dn, chunk):
    b, s, h, dh = q.shape
    args = [t(heads(x)) for x in (q, k, v, logi, logf)]
    y, _, _, _, st, nst = ref.mlstm_chunked_ref(*args, chunk=chunk, return_states=True)
    got = ops.mlstm_chunked_bwd(*args, y, st, nst, t(heads(dy)),
                                t(dC.reshape(b * h, dh, dh)),
                                t(dn.reshape(b * h, 1, dh)), chunk=chunk)
    return [g.reshape(b, h, s, *g.shape[2:]).transpose(1, 2).numpy() for g in got]


@pytest.mark.parametrize("chunk", [8, 16])
@pytest.mark.parametrize("chunks", [1, 2, 4])
def test_mlstm_backward_twin_matches_jax_mlstm_chunk(chunks, chunk):
    """One, two and four chunks of 8 and 16 steps; q small enough that
    |den| clamps at 1 on some steps, where the stabilizer does not cancel
    and its gradient flows through m_loc, the running max and the chain
    to earlier chunks."""
    rng = np.random.default_rng(256)
    s = chunks * chunk
    x = mlstm_inputs(rng, s=s)
    cts = (normal(rng, 1, s, 2, 8), normal(rng, 1, 2, 8, 8), normal(rng, 1, 2, 8))
    want = _jax_mlstm_grads(*x, *cts, chunk=chunk)
    got = _port_mlstm_grads(*x, *cts, chunk=chunk)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), **TOL)


def test_mlstm_backward_ties_split_as_jax_grad():
    """The tie conventions against jax.grad: with logf = 0 the stabilizer
    entering chunk 1 is chunk 0's largest logi, and chunk 1's first logi
    equals it, so max(M, m) ties on every step of chunk 1 (jax.grad
    gives each side half; so does the twin)."""
    rng = np.random.default_rng(257)
    q, k, v, logi, _ = mlstm_inputs(rng, s=16, q_scale=0.05)
    logf = np.zeros_like(logi)
    logi[:, 8:] = logi[:, :8].max(axis=1, keepdims=True) - np.abs(logi[:, 8:]) - 0.1
    logi[:, 8] = logi[:, :8].max(axis=1)
    cts = (normal(rng, 1, 16, 2, 8), normal(rng, 1, 2, 8, 8), normal(rng, 1, 2, 8))
    want = _jax_mlstm_grads(q, k, v, logi, logf, *cts, chunk=8)
    got = _port_mlstm_grads(q, k, v, logi, logf, *cts, chunk=8)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), **TOL)


def test_mlstm_final_stabilizer_has_no_gradient():
    q, k, v, logi, logf = (t(heads(a)).requires_grad_() for a in
                           mlstm_inputs(np.random.default_rng(258), s=16))
    y, C, n, m = ops.mlstm_chunked(q, k, v, logi, logf, chunk=8)
    with pytest.raises(RuntimeError, match="final stabilizer m"):
        torch.autograd.grad(y.sum() + m.sum(), (q,))
    torch.autograd.grad(y.sum() + C.sum() + n.sum(), (q, k, v, logi, logf))


# ---------------------------------- remat -----------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_remat_changes_no_number(arch):
    cfg = smoke_config(arch)
    model = build_model(cfg, float_policy())
    params = model.init(torch.Generator().manual_seed(3))
    rng = np.random.default_rng(259)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(1, 32)))
             for k in ("tokens", "labels")}
    if cfg.input_kind == "embeddings":
        batch["input_embeds"] = torch.from_numpy(
            rng.normal(size=(1, 32, cfg.d_model)).astype(np.float32))
    loss = encdec_loss if cfg.family == "encdec" else lm_loss
    results = []
    for remat in (False, True):
        live = [p.detach().requires_grad_() for p in tree.leaves(params)]
        it = iter(live)
        lp = tree.tree_map(lambda _: next(it), params)
        total, _ = loss(lp, batch, cfg, model.policy, remat=remat)
        # allow_unused: pixtral's loss, fed embeddings, leaves the embed table out
        results.append((total.detach(),
                        torch.autograd.grad(total, live, allow_unused=True)))
    (l0, g0), (l1, g1) = results
    assert torch.equal(l0, l1)
    assert sum(g is None for g in g0) == (cfg.input_kind == "embeddings"
                                           and cfg.family != "encdec")
    assert all((a is None and b is None) or torch.equal(a, b) for a, b in zip(g0, g1))


# --------------------------- the mesh and the launcher -----------------------

@pytest.mark.parametrize("n", [1, 2, 4, 16, 32])
def test_make_elastic_mesh_takes_the_jax_plan(n):
    grid, axes = make_elastic_mesh(list(range(n)))
    plan = j_ft.plan_mesh_for(n)
    assert grid.shape == plan.shape and axes == plan.axes
    assert grid.dtype == object and list(grid.flat) == list(range(plan.num_devices))
    if n <= len(jax.devices()):
        mesh = j_ft.make_elastic_mesh(jax.devices()[:n])
        assert mesh.devices.shape == grid.shape and mesh.axis_names == axes


def test_train_learns_and_resumes(tmp_path):
    """``tests/test_launch.py`` on the port: 12 steps with checkpoints every
    5, then a run to 14 resumes from step 10 (the data restarts at batch
    0, as the JAX launcher's zip does)."""
    kw = dict(smoke=True, batch=4, seq=32, lr=1e-3, ckpt_dir=str(tmp_path),
              ckpt_every=5, log_every=100, device="cpu")
    out = launch_train.train("smollm-360m", steps=12, **kw)
    assert len(out["losses"]) == 12 and np.isfinite(out["losses"]).all()
    assert np.mean(out["losses"][-5:]) < np.mean(out["losses"][:5])
    out2 = launch_train.train("smollm-360m", steps=14, **kw)
    assert len(out2["losses"]) == 4
    assert out2["losses"][0] != out["losses"][0]   # step 10's params, batch 0


def test_train_refuses_what_is_not_ported(monkeypatch):
    """The launcher's mesh: with no mesh it takes every visible card; on a
    2-entry CPU mesh smollm trains as on one device (losses within rtol
    1e-5: the float order of the reduce); an MoE config with microbatches
    on more than one replica trains; jamba's hybrid stack (mamba, attention
    and experts) takes one step on a ``DeviceMesh`` whose model axis holds
    2 devices, with a finite loss; a config fed by embeddings trains
    (pixtral's smoke config, 2 steps)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert launch_train.train_mesh().flat == (torch.device("cuda", 0),
                                              torch.device("cuda", 1))
    monkeypatch.undo()
    kw = dict(steps=3, batch=4, seq=32, log_every=100, quantized=False)
    one = launch_train.train("smollm-360m", device="cpu", **kw)
    two = launch_train.train("smollm-360m", mesh=ServingMesh(("cpu", "cpu")), **kw)
    np.testing.assert_allclose(two["losses"], one["losses"], rtol=1e-5)
    moe = launch_train.train("moonshot-v1-16b-a3b", steps=1, batch=4, seq=32,
                             microbatches=2, mesh=ServingMesh(("cpu", "cpu")),
                             log_every=100)
    assert np.isfinite(moe["losses"]).all()
    jamba = launch_train.train("jamba-1.5-large-398b", steps=1, batch=4, seq=32,
                               log_every=100,
                               mesh=DeviceMesh(np.array([["cpu", "cpu"]], dtype=object),
                                               ("data", "model")))
    assert len(jamba["losses"]) == 1 and np.isfinite(jamba["losses"]).all()
    out = launch_train.train("pixtral-12b", steps=2, batch=2, seq=16,
                             log_every=100, device="cpu")
    assert len(out["losses"]) == 2 and np.isfinite(out["losses"]).all()


def test_cli_takes_the_jax_launchers_flags():
    args = launch_train.parse_args([])
    assert vars(args) == dict(arch="smollm-360m", smoke=True, steps=50, batch=8,
                              seq=128, lr=3e-4, microbatches=1, ckpt_dir=None,
                              quantized=True)
    args = launch_train.parse_args(["--full", "--float", "--ckpt-dir", "d"])
    assert not args.smoke and not args.quantized and args.ckpt_dir == "d"
