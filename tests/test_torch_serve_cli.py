"""The port's serving CLI against the JAX package's, its load mode on the
CPU with an injected clock, ``--blocks tuned`` and the serving tuner,
and the executors' CPU form (eager: no CUDA graph exists there)."""

import argparse

import numpy as np
import pytest

from repro.launch import serve_bnn as jserve_bnn
from repro_torch.kernels import autotune
from repro_torch.kernels.autotune import AUTO, BlockConfig
from repro_torch.launch import serve_bnn
from repro_torch.serve import (SERVE_KERNEL, ServingEngine,
                               load_serving_blocks, serving_shape,
                               tune_serving_blocks)
from repro_torch.serve.executor import EagerExecutor


class _Captured(Exception):
    pass


def _flags(parser: argparse.ArgumentParser) -> set:
    return {s for a in parser._actions for s in a.option_strings} - {"-h", "--help"}


def test_flags_match_the_jax_cli(monkeypatch):
    """Every flag of ``repro.launch.serve_bnn``, plus ``--device``."""
    def capture(self, *args, **kwargs):
        raise _Captured(self)

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", capture)
    with pytest.raises(_Captured) as got:
        jserve_bnn.main()
    monkeypatch.undo()
    jax_flags = _flags(got.value.args[0])
    assert "--devices" in jax_flags and "--sustained" in jax_flags
    assert _flags(serve_bnn.make_parser()) == jax_flags | {"--device"}
    with pytest.raises(SystemExit):
        serve_bnn.parse_args(["--smoke", "--sustained"])
    smoke, sustained = serve_bnn.parse_args([]), serve_bnn.parse_args(["--sustained"])
    assert (smoke.buckets, smoke.max_rows) == ((1, 4, 8), 8)
    assert (sustained.buckets, sustained.max_rows) == ((1, 8, 32, 128), 32)


@pytest.mark.parametrize("scheduler", ["bucket", "continuous"])
def test_smoke_on_a_mesh_of_four_cpu_devices(scheduler, capsys):
    snap = serve_bnn.main(["--smoke", "--devices", "4", "--device", "cpu",
                           "--scheduler", scheduler, "--requests", "3",
                           "--max-images", "3", "--max-rows", "4"])
    out = capsys.readouterr().out
    assert "serving mesh: 4 devices, 1-D data axis" in out
    assert "0 logits mismatches" in out
    assert snap["requests"]["completed"] == 3
    assert all(k.endswith("|mesh4") for k in snap["executors"]["keys"])
    assert all(b % 4 == 0 for b in snap["batches"]["per_bucket"])


class StepClock:
    """A clock that moves ``step`` seconds at every read: the load loop
    runs its course without sleeping."""

    def __init__(self, step: float):
        self.t, self.step = 0.0, step

    def __call__(self) -> float:
        self.t += self.step
        return self.t


@pytest.mark.parametrize("argv", [
    ["--scheduler", "continuous", "--engine", "megakernel", "--max-rows", "4",
     "--max-queue-rows", "8", "--slo-ms", "50"],
    ["--engine", "xnor", "--conv-impl", "direct", "--buckets", "1,4"]])
def test_sustained_on_the_cpu_with_an_injected_clock(argv, capsys):
    snap = serve_bnn.main(["--sustained", "--rate", "40", "--duration", "0.1",
                           "--max-images", "2", "--device", "cpu"] + argv,
                          clock=StepClock(1e-3))
    check = snap["check"]
    assert snap["requests"]["completed"] == snap["requests"]["submitted"] >= 3
    assert check["mismatches"] == check["failed"] == check["unanswered"] == 0
    # warmup built every shape and traffic added none
    assert snap["executors"]["compiles"] == check["warmup_built"]
    out = capsys.readouterr().out
    assert "latency p50" in out and "pad-row fraction" in out
    if "--slo-ms" in argv:
        assert snap["slo"]["slo_s"] == pytest.approx(0.05)


def test_sustained_exits_nonzero_when_requests_fail(monkeypatch):
    from repro_torch.serve import FaultPlan, FaultSpec, RetryPolicy

    real = serve_bnn.build_engine

    def failing(args, *, clock):
        eng = real(args, clock=clock)
        eng.retry = RetryPolicy(max_attempts=1)
        eng.faults = FaultPlan([FaultSpec("raise", at=0, count=10**6)])
        return eng

    monkeypatch.setattr(serve_bnn, "build_engine", failing)
    with pytest.raises(SystemExit, match="requests failed"):
        serve_bnn.main(["--sustained", "--rate", "40", "--duration", "0.05",
                        "--max-images", "1", "--engine", "xnor", "--buckets",
                        "1,2", "--conv-impl", "direct", "--device", "cpu"],
                       clock=StepClock(1e-3))


def test_blocks_tuned_reads_the_largest_buckets_entry(tmp_path, monkeypatch,
                                                      capsys):
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(tmp_path / "autotune.json"))
    monkeypatch.delenv("REPRO_AUTOTUNE", raising=False)
    cfg = BlockConfig(block_n=64, k_splits=1)
    autotune.save_entry(SERVE_KERNEL, serving_shape("xnor", "direct", 2), cfg)
    autotune.save_entry(SERVE_KERNEL, serving_shape("xnor", "direct", 1),
                        BlockConfig(block_n=32))
    assert load_serving_blocks("xnor", "direct", 2) == cfg
    assert load_serving_blocks("xnor", "im2col", 2) == AUTO
    args = serve_bnn.parse_args(["--smoke", "--blocks", "tuned", "--engine",
                                 "xnor", "--conv-impl", "direct", "--buckets",
                                 "1,2,4", "--device", "cpu"])
    eng = serve_bnn.build_engine(args)
    assert eng.executors.blocks == cfg
    assert "tuned serving config of bucket 2" in capsys.readouterr().out
    snap = serve_bnn.main(["--smoke", "--blocks", "tuned", "--engine", "xnor",
                           "--conv-impl", "direct", "--buckets", "1,2",
                           "--requests", "2", "--max-images", "2",
                           "--device", "cpu"])
    assert snap["executors"]["keys"][0].endswith("|bn64-ks1")
    monkeypatch.setenv("REPRO_AUTOTUNE", "0")
    assert serve_bnn.serving_blocks(args) == AUTO


@pytest.fixture(scope="module")
def fused():
    from repro_torch.core.bnn import init_bnn_params, pack_bnn_params_fused

    return pack_bnn_params_fused(init_bnn_params(3, device="cpu"))


def test_tune_serving_blocks_caches_only_an_identical_winner(
        fused, tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(tmp_path / "autotune.json"))
    monkeypatch.delenv("REPRO_AUTOTUNE", raising=False)
    cands = [AUTO, BlockConfig(block_n=32), BlockConfig(block_n=64)]
    fake = iter([3.0, 2.0, 1.0])
    timings = {}
    best = tune_serving_blocks(fused, 2, engine="xnor", conv_impl="direct",
                               candidates=cands, timings=timings,
                               timer=lambda fn: next(fake))
    assert best == BlockConfig(block_n=64) and timings[AUTO] == 3.0
    assert load_serving_blocks("xnor", "direct", 2) == best

    from repro_torch.core import bnn as tbnn

    real = tbnn.bnn_serve_fn

    def off_by_one(*, blocks=AUTO, **kw):
        fn = real(blocks=blocks, **kw)
        return fn if blocks == AUTO else (lambda p, x: fn(p, x) + 1)

    monkeypatch.setattr(tbnn, "bnn_serve_fn", off_by_one)
    with pytest.raises(RuntimeError, match="changed the xnor/direct logits"):
        tune_serving_blocks(fused, 2, engine="xnor", conv_impl="direct",
                            candidates=[BlockConfig(block_n=32)],
                            timer=lambda fn: 1.0)
    assert autotune.load_entry(SERVE_KERNEL, serving_shape("xnor", "direct", 2)) == best


def test_serving_candidates_are_hopper_tilings():
    per_layer = autotune.KERNEL_KNOBS["fused_xnor_gemm"]
    from repro_torch.serve import default_serving_candidates

    for engine in ("xnor", "megakernel"):
        cands = default_serving_candidates(32, engine)
        assert cands[0] == AUTO and len(set(cands)) == len(cands) > 3
        for cfg in cands[1:]:
            fields = {f for f, v in cfg.fields().items() if v != AUTO}
            assert fields <= ({"block_n", "k_splits"} if engine == "xnor"
                              else {"stage_cluster", "chain_cluster"})
    assert set(per_layer) == {"block_n", "k_splits"}


def test_cpu_executors_stay_eager(fused):
    eng = ServingEngine(fused, engine="xnor", conv_impl="direct", buckets=(1, 2),
                        blocks=BlockConfig(block_n=128))
    assert eng.warmup() == 2
    ex = eng.executors.get(2)
    assert isinstance(ex, EagerExecutor)
    x = np.random.default_rng(5).normal(size=(2, 32, 32, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        ex(x), serve_bnn.exact_forward(eng, x, "direct"))
    assert eng.executors.key(2) == (2, "xnor", "direct", "bn128")
    assert eng.snapshot()["executors"]["compiles"] == 2
    eng.executors.release()
    assert eng.executors.size == 0
