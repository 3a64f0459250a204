"""On the card: every tiling the kernels compile against the plain twins,
the tuner, and the serving executors' CUDA graphs.

* Every ``tile_n`` x ``k_splits`` of ``xnor_gemm`` and
  ``fused_xnor_gemm``, every ``tile_n`` of the two direct convs and every
  cluster of the two megakernels, at Table 2's batch-64 shapes and the
  batch-32 served ones: bit-identical to the twin. A tiling a kernel
  cannot run raises ``ValueError``.
* The Python heuristics equal the C launchers' (``repro_xnor_gemm_tile_n``,
  ``repro_xnor_gemm_splits``) on this card.
* ``autotune.tune`` stores a winner stamped with this card's name.
* The executors: graph-replayed logits equal eager logits for every
  engine x conv_impl x bucket and extent class; after warmup and 50
  requests ``executors.compiles`` equals the shapes warmed; the float
  first conv's words do not depend on the batch; a capture that fails
  raises with its key and never runs eager.

Every test here needs a GPU and ``nvcc`` and skips without them; run on
the card with

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_graphs.py

This file imports no JAX."""

import json

import numpy as np
import pytest
import torch

from repro_torch.core import bitops
from repro_torch.kernels import autotune, build, ops
from repro_torch.kernels.autotune import AUTO

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture
def cache(tmp_path, monkeypatch):
    path = tmp_path / "autotune.json"
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(path))
    monkeypatch.delenv("REPRO_AUTOTUNE", raising=False)
    return path


# (M, KW, N): Table 2's eight batch-64 products and the served batch-32
# fc0, fc1 and head.
GEMMS = [(128, 36, 65536), (256, 36, 16384), (256, 72, 16384), (512, 72, 4096),
         (512, 144, 4096), (1024, 256, 64), (1024, 32, 64), (10, 32, 64),
         (1024, 256, 32), (1024, 32, 32), (10, 32, 32)]


# Each tunable kernel's plain twin, on the wrapper's own arguments.
TWINS = {"xnor_gemm": bitops.xnor_popcount_matmul,
         "fused_xnor_gemm": bitops.fused_xnor_layer,
         "fused_direct_conv": bitops.direct_conv_oracle,
         "direct_conv": bitops.direct_conv_dot,
         "megakernel_conv_stage": bitops.conv_stage_xla,
         "megakernel_chain": bitops.megakernel_chain_xla}


def _check_every_tiling(call, cands):
    """Every candidate tiling of ``call`` equals the twin; returns the
    candidates the kernel ran (the others raised ValueError)."""
    want = TWINS[call.kernel](*call.args, **call.kwargs)
    ran = []
    for cfg in cands:
        try:
            got = call(**autotune.block_kwargs(cfg, call.kernel))
        except ValueError:
            continue
        torch.cuda.synchronize()
        assert torch.equal(got, want), (call.kernel, cfg.key())
        ran.append(cfg)
    return ran


@pytest.mark.parametrize("m,kw,n", GEMMS)
def test_every_gemm_tiling_matches_the_twin(dev, m, kw, n):
    shape = autotune.gemm_shape(m, kw, n)
    for kernel in ("xnor_gemm", "fused_xnor_gemm"):
        cands = autotune.default_candidates(kernel, shape)
        call = autotune.operands(kernel, shape, dev)
        assert _check_every_tiling(call, cands) == cands
        with pytest.raises(ValueError):
            call(k_splits=kw + 1)


# The five convs of Table 2 at batch 64 and as served at batch 32.
CONVS = [(n, h, c, d) for n in (64, 32) for h, c, d in
         ((32, 128, 128), (16, 128, 256), (16, 256, 256), (8, 256, 512),
          (8, 512, 512))]


@pytest.mark.parametrize("n,h,c,d", CONVS)
def test_every_conv_tiling_matches_the_twin(dev, n, h, c, d):
    shape = autotune.conv_shape(n, h, h, c // 32, d, 3, 3, 1, 1)
    for kernel in ("fused_direct_conv", "direct_conv"):
        cands = autotune.default_candidates(kernel, shape)
        call = autotune.operands(kernel, shape, dev)
        assert _check_every_tiling(call, cands) == cands
        with pytest.raises(ValueError):
            call(tile_n=256)


# The three conv stages at batch 32 and 3: clusters of 1 to 8 CTAs an
# image, each bit-identical to the twin or refused with ValueError (a
# cluster whose filters exceed a block's shared memory).
STAGES = [(32, 32, (128, 128)), (32, 16, (128, 256, 256)),
          (32, 8, (256, 512, 512)), (3, 8, (256, 512, 512))]


@pytest.mark.parametrize("n,h,chans", STAGES)
def test_every_stage_cluster_matches_the_twin(dev, n, h, chans):
    shape = autotune.stage_shape(n, h, h, chans[0] // 32,
                                 [c // 32 for c in chans[1:]], 3, 3, 1, True)
    call = autotune.operands("megakernel_conv_stage", shape, dev)
    ran = _check_every_tiling(
        call, autotune.default_candidates("megakernel_conv_stage", shape))
    assert {cfg.stage_cluster for cfg in ran} >= {4, 8}
    with pytest.raises(ValueError):
        call(cluster=16)


@pytest.mark.parametrize("n", [8, 32])
def test_every_chain_cluster_matches_the_twin(dev, n):
    """The CIFAR trunk: fc0 [1024, 8192] and fc1 [1024, 1024] stacked,
    the head [10, 1024]."""
    shape = autotune.chain_shape((256, 32), 1024, 256, 256, 10, 32, n)
    call = autotune.operands("megakernel_chain", shape, dev)
    cands = autotune.default_candidates("megakernel_chain", shape)
    assert _check_every_tiling(call, cands) == cands
    with pytest.raises(ValueError):
        call(cluster=32)


def test_python_heuristics_equal_the_c_launchers(dev):
    sms = ops._sm_count(dev)
    tile, splits = build.load("repro_xnor_gemm_tile_n"), build.load(
        "repro_xnor_gemm_splits")
    rng = np.random.default_rng(80)
    shapes = GEMMS + [tuple(int(v) for v in rng.integers(1, 3000, size=3))
                      for _ in range(200)]
    for m, kw, n in shapes:
        assert autotune.heuristic_tile_n(m, n, sms) == tile(m, n), (m, n)
        assert autotune.heuristic_k_splits(m, kw, n, sms) == splits(m, kw, n), (
            m, kw, n)


def test_tune_stores_a_stamped_identical_winner(dev, cache):
    timings = {}
    shape = autotune.gemm_shape(1024, 256, 32)
    best = autotune.tune("fused_xnor_gemm", shape, device=dev, timings=timings)
    # The winner is the fastest candidate; AUTO's own timing is recorded
    # beside them but is no candidate (it may equal one of their tilings).
    assert timings[AUTO] > 0 and timings[best] == min(
        t for cfg, t in timings.items() if cfg != AUTO and t is not None)
    assert autotune.load_entry("fused_xnor_gemm", shape) == best
    (entry,) = json.loads(cache.read_text())["entries"].values()
    assert entry["device"] == torch.cuda.get_device_name()
    assert entry["cuda"] == torch.version.cuda


# --------------------------------------------------------------- executors

@pytest.fixture(scope="module")
def params():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.core.bnn import (init_bnn_params, pack_bnn_params_fused,
                                      pack_bnn_params_megakernel)

    latent = init_bnn_params(11, device="cuda")
    return {"fused": pack_bnn_params_fused(latent),
            "mega": pack_bnn_params_megakernel(latent)}


ENGINES = [("xnor", "direct"), ("xnor", "im2col"), ("xla", "direct"),
           ("megakernel", "im2col"), ("megakernel_xla", "im2col")]


@pytest.mark.parametrize("engine,conv_impl", ENGINES)
def test_graph_replay_equals_eager(dev, params, engine, conv_impl):
    from repro_torch.core.bnn import bnn_serve_fn
    from repro_torch.serve import ExecutorCache, RaggedExecutorCache

    packed = params["mega" if engine.startswith("megakernel") else "fused"]
    rng = np.random.default_rng(81)
    caches = [(ExecutorCache, (1, 8, 32), False)]
    if engine.startswith("megakernel"):
        caches.append((RaggedExecutorCache, (1, 2, 4, 8, 16, 24, 32), True))
    for cls, shapes, ragged in caches:
        cache = cls(packed, engine=engine, conv_impl=conv_impl)
        eager = bnn_serve_fn(engine=engine, conv_impl=conv_impl, ragged=ragged)
        for rows in shapes:
            x = rng.normal(size=(rows, 32, 32, 3)).astype(np.float32)
            got = cache.run(x)
            want = eager(packed, torch.from_numpy(x).to(dev)).cpu().numpy()
            np.testing.assert_array_equal(got, want, err_msg=f"{cls.__name__} {rows}")
            np.testing.assert_array_equal(cache.run(x), got)
        assert cache.size == len(shapes)


def test_compiles_equal_the_shapes_warmed(dev, params):
    from repro_torch.launch.serve_bnn import random_requests
    from repro_torch.serve import ContinuousServingEngine, ServingEngine

    rng = np.random.default_rng(82)
    for eng in (ServingEngine(params["fused"], engine="xnor", conv_impl="direct",
                              max_wait_s=0.0),
                ContinuousServingEngine(params["mega"], engine="megakernel",
                                        max_wait_s=0.0)):
        warmed = eng.warmup()
        before = dict(ops.LAUNCHES)
        for imgs in random_requests(rng, 50, 8):
            eng.submit(imgs)
            eng.step()
        eng.drain()
        snap = eng.snapshot()
        assert snap["requests"]["completed"] == 50
        assert snap["executors"]["compiles"] == warmed == len(eng._warm_shapes())
        # replays count their launches
        assert sum(ops.LAUNCHES.values()) > sum(before.values())


def test_first_conv_words_do_not_depend_on_the_batch(dev, params):
    from repro_torch.core.bnn import first_conv_packed

    imgs = torch.from_numpy(np.random.default_rng(83).normal(
        size=(64, 32, 32, 3)).astype(np.float32)).to(dev)
    with torch.inference_mode():
        alone = torch.cat([first_conv_packed(params["fused"], imgs[i:i + 1])
                           for i in range(64)])
        for n in (2, 5, 8, 24, 64):
            got = torch.cat([first_conv_packed(params["fused"], imgs[i:i + n])
                             for i in range(0, 64, n)])
            assert torch.equal(got, alone), n


def test_a_failing_capture_raises_and_never_runs_eager(dev, params, monkeypatch):
    from repro_torch.serve import ExecutorCache

    cache = ExecutorCache(params["fused"], engine="xnor", conv_impl="direct")
    real = cache._build()

    def syncs(packed, images):      # a host sync inside the forward
        out = real(packed, images)
        return out * float(out.abs().max().item() > -1)

    monkeypatch.setattr(cache, "_build", lambda: syncs)
    x = np.zeros((8, 32, 32, 3), np.float32)
    with pytest.raises(RuntimeError, match=r"capture of executor \(8, 'xnor'"):
        cache.run(x)
    assert cache.size == 0
    with pytest.raises(RuntimeError, match="capture"):
        cache.run(x)
