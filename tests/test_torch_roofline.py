"""The port's roofline: the op counter (``roofline.op_cost``) against
known-FLOP programs and ``tests/test_roofline.py``'s cases, the LM
kernels' counts on the CPU (twin) and on meta, the trip-counted loops
(bit-identical outside the counter, the same FLOPs under it), the
collectives reckoned from the rule table (exact on hand-worked trees, no
more than the JAX package's ``hlo_cost`` count of the compiled cell on a
(1, 2, 4) mesh of the 8 forced host devices for one forward, and with the
backward and recompute equal to what a tensor-parallel step moves), and
the ``Roofline``
math with the H100's constants. Counts are exact: FLOPs and bytes of
integer shapes, compared with ``==``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as j_configs
from repro.configs.base import ShapeConfig as JShape
from repro.distributed import sharding as j_sharding
from repro.launch.dryrun import shardings_for as j_shardings_for
from repro.models.model_factory import build_model as j_build_model
from repro.roofline import analysis as j_analysis
from repro.roofline import hlo_cost
from repro.train.step import TrainConfig as JTrainConfig
from repro.train.step import init_opt_state as j_init_opt_state
from repro.train.step import make_train_step as j_make_train_step
from repro_torch import tree
from repro_torch.configs.base import (ShapeConfig, float_policy, serve_policy,
                                      smoke_config, train_policy)
from repro_torch.core.layers import pack_linear_params
from repro_torch.kernels import ops
from repro_torch.launch.mesh import AbstractMesh
from repro_torch.models import attention, ffn, mamba, xlstm
from repro_torch.models.model_factory import build_model
from repro_torch.roofline import analysis, op_cost
from repro_torch.train.step import init_opt_state

# ------------------------------- the counter ---------------------------------


def test_loop_flops_multiplied_by_trip_count():
    """``tests/test_roofline.py``'s scan of 11 matmuls, as a Python loop:
    counted trip by trip, and trip-counted (two trips run)."""
    w = torch.zeros(256, 256, device="meta")
    x = torch.ones(32, 256, device="meta")
    for loop in (list, op_cost.trips):
        with op_cost.count() as c:
            y = x
            for _ in loop(range(11)):
                y = torch.tanh(y @ w)
        assert c.flops == 11 * 2 * 32 * 256 * 256


def test_nested_loop_flops_multiply():
    w = torch.zeros(128, 128, device="meta")
    with op_cost.count() as c:
        y = torch.ones(16, 128, device="meta")
        for _ in op_cost.trips(range(5)):
            for _ in op_cost.trips(range(3)):
                y = torch.tanh(y @ w)
    assert c.flops == 15 * 2 * 16 * 128 * 128
    assert c.kernels == {} and c.fusible_bytes == 0


def test_bytes_views_and_peak():
    """Operands plus results of every op, views free; the peak counts the
    live tensors made under the counter, not its arguments."""
    x = torch.ones(64, 64, device="meta")           # 16 KiB argument
    with op_cost.count() as c:
        y = x.T                                      # view: free
        z = x + y                                    # 3 x 16 KiB
        del z
        u = torch.empty(32, 64, device="meta").fill_(1.0)   # 2 x 8 KiB
        del u
    assert c.bytes == 3 * 16384 + 2 * 8192
    assert c.peak_bytes == 16384


def test_backward_of_a_trip_counted_loop_is_multiplied():
    """The sLSTM block's loop over time, forward and backward on meta: the
    same FLOPs trip-counted as counted step by step."""
    cfg = smoke_config("xlstm-1.3b")
    params = tree.tree_map(lambda p: p.requires_grad_(), xlstm.init_slstm(None, cfg))
    x = torch.empty(2, 64, cfg.d_model, device="meta", dtype=torch.bfloat16)

    def run():
        y, _ = xlstm.slstm_block(params, x, cfg, train_policy())
        return torch.autograd.grad(y.float().sum(), tree.leaves(params))

    with op_cost.count() as counted:
        run()
    with op_cost.count() as full:
        full_loop = op_cost.trips.__init__

        def every_trip(self, items):
            full_loop(self, items)
            self.counted = False
        try:
            op_cost.trips.__init__ = every_trip
            run()
        finally:
            op_cost.trips.__init__ = full_loop
    assert counted.flops == full.flops > 0


def test_trip_loops_are_bit_identical_outside_the_counter(monkeypatch):
    """With no counter, ``trips`` runs every item and its ``cat`` /
    ``stack`` are torch's: the sLSTM, the chunked mLSTM and mamba with a
    state, chunked attention and the packed experts give the same bits as
    the plain loops."""
    rng = np.random.default_rng(0)

    def rand(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

    cfg = smoke_config("xlstm-1.3b")
    jcfg = smoke_config("jamba-1.5-large-398b")
    gen = torch.Generator().manual_seed(0)
    sl = xlstm.init_slstm(gen, cfg)
    mb = mamba.init_mamba(gen, jcfg)
    moe_cfg = smoke_config("moonshot-v1-16b-a3b")
    experts = ffn.init_moe(gen, moe_cfg)["up_proj"]
    packed = serve_policy()
    experts = pack_linear_params(experts, use_scale=True)
    q, k, v = rand(1, 1024, 4, 16), rand(1, 2048, 2, 16), rand(1, 2048, 2, 16)
    pos_q, pos_k = torch.arange(1024), torch.arange(2048)
    state = {"C": rand(1, 4, 16, 16) * 0.1, "n": rand(1, 4, 16) * 0.1,
             "m": torch.zeros(1, 4)}
    x_m = rand(1, 512, 4, 16)

    def runs():
        return [
            xlstm.slstm_block(sl, rand(2, 33, cfg.d_model), cfg, float_policy())[0],
            xlstm.mlstm_cell(x_m, x_m, x_m, rand(1, 512, 4), -rand(1, 512, 4).abs(),
                             state, chunk=128)[0],
            mamba.mamba(mb, rand(1, 768, jcfg.d_model), jcfg, float_policy())[0],
            attention._attend_chunked(q, k, v, groups=2, causal=True,
                                      q_positions=pos_q, kv_positions=pos_k,
                                      kv_valid=None, sliding_window=0,
                                      q_chunk=256, kv_chunk=512),
            ffn._expert_matmul(experts, rand(2, moe_cfg.num_experts, 8,
                                             moe_cfg.d_model), packed),
        ]

    state_rng = rng.bit_generator.state
    got = runs()

    class plain:   # the loops as they were: every trip, torch.cat / stack
        def __init__(self, items):
            self.items = list(items)

        def __iter__(self):
            return iter(self.items)

        def cat(self, ys, dim=0):
            return torch.cat(ys, dim)

        def stack(self, ys, dim=0):
            return torch.stack(ys, dim)

    monkeypatch.setattr(op_cost, "trips", plain)
    rng.bit_generator.state = state_rng
    for a, b in zip(got, runs()):
        assert torch.equal(a, b)


# ------------------------------ kernel counts --------------------------------

def _kernel_cases():
    g = torch.Generator().manual_seed(3)

    def r(*shape):
        return torch.randn(shape, generator=g)

    q, k, v = r(2, 64, 16), r(2, 64, 16), r(2, 64, 16)
    o, lse = ops._flash_forward(q, k, v, True)
    dt, xh = r(1, 8, 16).abs() * 0.1, r(1, 8, 16)
    bm, cm, a, h0 = r(1, 8, 4), r(1, 8, 4), -r(16, 4).abs(), r(1, 16, 4)
    mq, mk, mv = r(2, 32, 8) * 8 ** -0.5, r(2, 32, 8), r(2, 32, 8)
    li, lf = r(2, 32), torch.nn.functional.logsigmoid(r(2, 32) + 2)
    y, _, _, _, states, nst = ops._mlstm_forward(mq, mk, mv, li, lf, 16)
    wp = torch.randint(-2**31, 2**31 - 1, (8, 2), dtype=torch.int32, generator=g)
    return {
        "flash_attention": (ops._flash_forward, (q, k, v, True), {},
                            op_cost.flash_flops(2, 64, 64, 16)),
        "flash_attention_bwd": (ops.flash_attention_bwd, (q, k, v, o, lse, r(2, 64, 16)),
                                {"causal": True},
                                op_cost.flash_flops(2, 64, 64, 16, backward=True)),
        "ssm_scan_chunk": (ops._ssm_forward, (dt, xh, bm, cm, a, h0), {},
                           op_cost.scan_flops(1, 8, 16, 4)),
        "ssm_scan_chunk_bwd": (ops.ssm_scan_chunk_bwd,
                               (dt, xh, bm, cm, a, h0, r(1, 8, 16), r(1, 16, 4)), {},
                               op_cost.scan_flops(1, 8, 16, 4)),
        "mlstm_chunked": (ops._mlstm_forward, (mq, mk, mv, li, lf, 16), {},
                          op_cost.mlstm_flops(2, 32, 8, 8, 16)),
        "mlstm_chunked_bwd": (ops.mlstm_chunked_bwd,
                              (mq, mk, mv, li, lf, y, states, nst, r(2, 32, 8)),
                              {"chunk": 16},
                              op_cost.mlstm_flops(2, 32, 8, 8, 16, backward=True)),
        "unpack_gemm": (ops.unpack_gemm, (wp, r(64, 3)), {},
                        op_cost.gemm_flops(8, 64, 3)),
    }


@pytest.mark.parametrize("name", sorted(_kernel_cases()))
def test_kernel_counts_the_same_on_cpu_and_on_meta(name):
    """One call counts its formula's FLOPs and its operands' and results'
    bytes, whether its twin ran (CPU) or its meta stand-in; the twin's
    internals go to ``fusible_bytes`` only. Meta results have the twin's
    shapes and dtypes."""
    fn, args, kwargs, flops = _kernel_cases()[name]
    meta_args = tuple(a.to("meta") if isinstance(a, torch.Tensor) else a
                      for a in args)
    with op_cost.count() as cpu:
        want = fn(*args, **kwargs)
    with op_cost.count() as meta:
        got = fn(*meta_args, **kwargs)
    assert cpu.flops == meta.flops == flops
    assert cpu.bytes == meta.bytes > 0
    assert cpu.kernels == meta.kernels == {name: 1}
    assert cpu.fusible_bytes > 0 and meta.fusible_bytes == 0
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    assert [(g.device.type, g.shape, g.dtype) for g in got] == [
        ("meta", w.shape, w.dtype) for w in want]


def test_other_kernels_still_refuse_meta():
    w = torch.zeros(32, 4, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        ops.xnor_gemm(w, w.T.contiguous(), 128)


# ------------------------------- collectives ---------------------------------

def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def test_collectives_of_a_hand_worked_tree():
    """One stacked column-parallel and one row-parallel weight, a
    replicated norm, batch 8 x 16 tokens, on a (1, 2, 4) mesh."""
    mesh = AbstractMesh((1, 2, 4))
    params = {"layers": [{"attn": {"q_proj": {"w": _meta(3, 64, 32)},
                                   "o_proj": {"w": _meta(3, 32, 64)}},
                          "norm1": {"scale": _meta(3, 32)}}]}
    batch = {"tokens": _meta(8, 16, dtype=torch.int32),
             "labels": _meta(8, 16, dtype=torch.int32)}
    w_bytes = 3 * 64 * 32 * 4
    prefill = op_cost.collective_bytes(mesh, (params, None, batch), "prefill",
                                       act_bytes=2)
    # each weight gathered over data (2 devices), split over model (4),
    # at the activations' 2 bytes; o_proj's [3 x 8/2*16 tokens x 32] out
    # all-reduced over model at 2 bytes, times 2
    assert prefill["all-gather"] == 2 * (w_bytes // 2) / 4
    assert prefill["all-reduce"] == 3 * (8 / 2 * 16) * 32 * 2 * 2
    assert prefill["reduce-scatter"] == 0
    train = op_cost.collective_bytes(mesh, (params, None, batch), "train",
                                     act_bytes=2)
    grads = 2 * (w_bytes / 4) * 2 + 3 * 32 * 4 * 2    # the norm: replicated
    assert train["all-reduce"] == prefill["all-reduce"] + grads
    decode = op_cost.collective_bytes(
        mesh, (params, None, {"tokens": _meta(8, 1, dtype=torch.int32)}),
        "decode", act_bytes=2)
    assert decode["all-reduce"] == 3 * (8 / 2) * 32 * 2 * 2
    one = op_cost.collective_bytes(AbstractMesh((1, 1, 1)), (params, None, batch),
                                   "train")
    assert one == {k: 0.0 for k in op_cost.COLL_MULT}


def _j_cell(arch, kind, seq, batch):
    cfg = j_configs.smoke_config(arch)
    shape = JShape("x", seq, batch, kind)
    model = j_build_model(cfg, j_configs.train_policy() if kind == "train"
                          else j_configs.serve_policy())
    fp = jax.eval_shape(model.init, jax.random.PRNGKey(0))
    if kind == "train":
        step = j_make_train_step(model, JTrainConfig())
        return step, (fp, jax.eval_shape(j_init_opt_state, fp),
                      model.input_specs(shape)), (0, 1)
    state = jax.eval_shape(functools.partial(model.init_state, batch, seq,
                                             dtype=jnp.bfloat16))
    return (lambda p, s, b: model.prefill(p, s, b),
            (jax.eval_shape(model.pack, fp), state, model.input_specs(shape)), (1,))


@pytest.mark.parametrize("kind", ["prefill", "train"])
def test_collectives_are_a_lower_bound_of_the_jax_cell(kind):
    """smollm's smoke cell at 4 x 64 on a (1, 2, 4) mesh: each kind of
    collective the port reckons is no more than what ``hlo_cost`` counts
    in the JAX cell compiled with ``shardings_for``."""
    arch, seq, batch = "smollm-360m", 64, 4
    devices = np.asarray(jax.devices()[:8]).reshape(1, 2, 4)
    mesh = jax.sharding.Mesh(devices, ("pod", "data", "model"))
    step, args, donate = _j_cell(arch, kind, seq, batch)
    with mesh, j_sharding.activation_mesh(mesh):
        compiled = jax.jit(step, in_shardings=j_shardings_for(mesh, args, kind),
                           donate_argnums=donate).lower(*args).compile()
    want = hlo_cost.analyze(compiled.as_text()).collective_breakdown
    model = build_model(smoke_config(arch), train_policy() if kind == "train"
                        else serve_policy())
    shape = ShapeConfig("x", seq, batch, kind)
    if kind == "train":
        params = model.init()
        targs = (params, init_opt_state(params), model.input_specs(shape))
    else:
        targs = (model.init_packed(), model.init_state(batch, seq, device="meta"),
                 model.input_specs(shape))
    got = op_cost.collective_bytes(AbstractMesh((1, 2, 4)), targs, kind)
    assert sum(got.values()) > 0
    for k, v in got.items():
        assert v <= want[k], (k, v, want[k])


def test_moe_combine_of_a_hand_worked_tree():
    """A stacked MoE layer's combine is all-reduced over ``model`` where
    its experts split (8 experts on 4 devices; not 6), once a layer: its
    ``[3 x 8/2*16 tokens x 32]`` output at 2 bytes, times 2."""
    mesh = AbstractMesh((1, 2, 4))
    batch = {"tokens": _meta(8, 16, dtype=torch.int32),
             "labels": _meta(8, 16, dtype=torch.int32)}
    for experts, want in ((8, 3 * (8 / 2 * 16) * 32 * 2 * 2), (6, 0.0)):
        params = {"layers": [{"moe": {"router": {"w": _meta(3, experts, 32)},
                                      "up_proj": {"w": _meta(3, experts, 16, 32)}}}]}
        got = op_cost.collective_bytes(mesh, (params, None, batch), "prefill",
                                       act_bytes=2)
        assert got["all-reduce"] == want


def _counted_and_reckoned(arch, shape):
    """One TP step of ``arch``'s smoke config under ``train_policy()`` on a
    ``shape`` mesh of CPU entries: ``tensor_parallel.BYTES`` summed by
    (kind, direction), and ``collective_bytes`` + ``collective_bytes_bwd``
    of the same cell keyed so."""
    from test_torch_tp import batch_of, cpu_mesh
    from test_torch_tp_encdec import batch_of as encdec_batch_of
    from repro_torch.distributed import sharding
    from repro_torch.distributed import tensor_parallel as tp
    from repro_torch.train.step import TrainConfig, make_tp_train_step

    cfg = smoke_config(arch)
    model = build_model(cfg, train_policy())
    params = model.init(torch.Generator().manual_seed(1))
    batch = encdec_batch_of(cfg) if cfg.family == "encdec" else batch_of(cfg)
    mesh = cpu_mesh(shape)
    tp.reset_bytes()
    make_tp_train_step(model, TrainConfig(), mesh)(
        sharding.shard_params(params, mesh),
        sharding.shard_params(init_opt_state(params), mesh), batch)
    counted = {}
    for (kind, _, direction), n in tp.BYTES.items():
        counted[(kind, direction)] = counted.get((kind, direction), 0.0) + n
    meta = model.init()
    args = (meta, None, {k: _meta(*v.shape, dtype=v.dtype) for k, v in batch.items()})
    reckoned = op_cost.collective_bytes_bwd(mesh, args, "train", cfg)
    for key, n in op_cost.collective_bytes(mesh, args, "train", act_bytes=4,
                                           by_direction=True).items():
        reckoned[key] = reckoned.get(key, 0.0) + n
    return counted, reckoned


@pytest.mark.parametrize("shape", [(1, 2), (1, 4), (2, 2), (2, 4)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("arch", ["qwen2.5-3b", "moonshot-v1-16b-a3b", "arctic-480b",
                                  "jamba-1.5-large-398b", "xlstm-1.3b",
                                  "seamless-m4t-large-v2"])
def test_reckoning_is_what_a_tp_step_moves(arch, shape):
    """ROADMAP C5: the dry run's reckoning of a train cell, one forward
    (``collective_bytes``, its gradient reduction over data keyed
    ``"bwd"``) plus the recompute, the backward and the smaller sites
    (``collective_bytes_bwd``), equals the bytes one TP step counts in
    ``tensor_parallel.BYTES`` (a device's mean over the mesh), kind by kind
    and direction by direction, to 1e-9 relative: the row-parallel
    outputs, the MoE combine, the embedding, a head cut mid-way at m = 4
    (self- and cross-attention), the loss and the alpha; mamba's and the
    xLSTM's fused outputs gathered and the mLSTM's group norm at both
    sizes; on two data rows the params' gathers over data (forward and
    recompute) and the gradients' all-reduce."""
    counted, reckoned = _counted_and_reckoned(arch, shape)
    _hold_reckoning(counted, reckoned)
    if arch in ("jamba-1.5-large-398b", "xlstm-1.3b") or shape[0] > 1:
        # fused outputs gathered, or the params over data
        assert counted[("all-gather", "fwd")] > 0
    else:   # only a head cut mid-way gathers
        assert (("all-gather", "fwd") in counted) == (shape == (1, 4))


def test_reckoning_of_heads_the_ranks_do_not_divide():
    """xlstm's smoke config on 8 ranks, which do not divide its 4 heads:
    every rank runs every head (the mLSTM's q, k and v gathered, no group
    norm all-reduce, the sLSTM's whole loop on every rank), and the
    reckoning still equals the count to 1e-9 relative."""
    _hold_reckoning(*_counted_and_reckoned("xlstm-1.3b", (1, 8)))


def _hold_reckoning(counted: dict, reckoned: dict) -> None:
    for key in set(counted) | set(reckoned):
        got, want = counted.get(key, 0.0), reckoned.get(key, 0.0)
        assert abs(got - want) <= 1e-9 * max(got, want), (key, got, want)
    assert counted[("all-reduce", "bwd")] > 0


def test_repaired_train_cell_beside_the_jax_cell():
    """smollm's smoke train cell at 4 x 64 on a (1, 2, 4) mesh: the
    repaired total (``collective_bytes`` + ``collective_bytes_bwd``)
    beside ``hlo_cost``'s count of the JAX cell compiled with
    ``shardings_for``, both printed; the repaired total is the larger
    reckoning of the two the port makes."""
    arch, seq, batch = "smollm-360m", 64, 4
    devices = np.asarray(jax.devices()[:8]).reshape(1, 2, 4)
    mesh = jax.sharding.Mesh(devices, ("pod", "data", "model"))
    step, args, donate = _j_cell(arch, "train", seq, batch)
    with mesh, j_sharding.activation_mesh(mesh):
        compiled = jax.jit(step, in_shardings=j_shardings_for(mesh, args, "train"),
                           donate_argnums=donate).lower(*args).compile()
    jax_total = sum(hlo_cost.analyze(compiled.as_text()).collective_breakdown.values())
    cfg = smoke_config(arch)
    model = build_model(cfg, train_policy())
    params = model.init()
    targs = (params, init_opt_state(params),
             model.input_specs(ShapeConfig("x", seq, batch, "train")))
    one = sum(op_cost.collective_bytes(AbstractMesh((1, 2, 4)), targs, "train").values())
    rest = sum(op_cost.collective_bytes_bwd(AbstractMesh((1, 2, 4)), targs, "train",
                                            cfg).values())
    print(f"smollm smoke train 4 x 64 on (1, 2, 4): reckoned {one + rest:.6g} bytes "
          f"a device ({one:.6g} forward, {rest:.6g} recompute, backward and small "
          f"sites), hlo_cost of the JAX cell {jax_total:.6g}")
    assert rest > 0 and one + rest > one


# -------------------------------- roofline -----------------------------------

def test_roofline_terms_and_bottleneck():
    """``tests/test_roofline.py``'s case with the H100's constants."""
    r = analysis.Roofline(
        arch="x", shape="train_4k", mesh="single", chips=256,
        hlo_flops_per_chip=analysis.PEAK_FLOPS,           # exactly 1s of compute
        hlo_bytes_per_chip=analysis.HBM_BW * 2,           # 2s of memory
        collective_bytes_per_chip=analysis.LINK_BW * 0.5,
        collective_breakdown={},
        model_flops=analysis.PEAK_FLOPS * 256 * 0.5,
    )
    assert np.isclose(r.compute_s, 1.0)
    assert np.isclose(r.memory_s, 2.0)
    assert np.isclose(r.collective_s, 0.5)
    assert r.bottleneck == "memory"
    assert np.isclose(r.step_time_s, 2.0)
    assert np.isclose(r.mfu, 0.25)
    assert np.isclose(r.useful_flops_fraction, 0.5)
    assert (analysis.PEAK_FLOPS, analysis.HBM_BW) == (989e12, 3.35e12)
    d = r.to_dict()
    assert set(d) >= {"hlo_flops_per_chip", "hlo_bytes_per_chip",
                      "fusible_bytes_per_chip", "collective_bytes_per_chip",
                      "collective_breakdown", "model_flops",
                      "bytes_per_chip_peak", "mfu", "compute_s", "memory_s",
                      "collective_s", "bottleneck"}


def test_from_counted_splits_over_the_model_axis():
    counted = {"flops": 8e12, "bytes": 4e9, "fusible_bytes": 2e9,
               "peak_bytes": 1.0, "kernels": {}}
    r = analysis.from_counted(counted, arch="a", shape="s", mesh_name="m",
                              chips=32, model_shards=4, model_flops=1e12,
                              collectives={"all-reduce": 3.0, "all-gather": 1.0},
                              memory_stats={"temp_bytes": 7})
    assert (r.hlo_flops_per_chip, r.hlo_bytes_per_chip,
            r.fusible_bytes_per_chip) == (2e12, 1e9, 5e8)
    assert r.collective_bytes_per_chip == 4.0 and r.bytes_per_chip_peak == 7


def test_count_params_moe_active_fraction():
    """``tests/test_roofline.py``'s tree, held to the JAX function too."""
    shapes = {"layers": {"moe": {"up_proj": {"w": (64, 16, 8)},
                                 "router": {"w": (64, 8)}},
                         "attn": {"q_proj": {"w": (8, 8)}}},
              "packed": {"w_packed": (4, 2)}}
    def build(make, node):
        if isinstance(node, dict):
            return {k: build(make, v) for k, v in node.items()}
        return make(node)

    ttree = build(lambda s: _meta(*s), shapes)
    jtree = build(jnp.zeros, shapes)
    for frac in (None, 2 / 64):
        got = analysis.count_params(ttree, active_moe_fraction=frac)
        assert got == j_analysis.count_params(jtree, active_moe_fraction=frac)
    assert analysis.count_params(ttree) == 64 * 16 * 8 + 64 * 8 + 64 + 8 * 32


def test_model_flops_for_kinds():
    train = ShapeConfig("t", 1024, 8, "train")
    pre = ShapeConfig("p", 1024, 8, "prefill")
    dec = ShapeConfig("d", 1024, 8, "decode")
    assert analysis.model_flops_for(None, train, 1e9, 1e9) == 6e9 * 8 * 1024
    assert analysis.model_flops_for(None, pre, 1e9, 1e9) == 2e9 * 8 * 1024
    assert analysis.model_flops_for(None, dec, 1e9, 1e9) == 2e9 * 8
