"""The port's serving stack on the CPU: ``ServingEngine`` answers ragged
requests exactly as the exact-shape forward does, builds one executor
per bucket warmed and none under traffic, demotes ``xnor -> xla`` only
when a ``FallbackPolicy`` is armed, and the CLI runs on CUDA unless told
``--device cpu`` and exits non-zero when a request fails."""

import numpy as np
import pytest
import torch

from repro_torch.core.bnn import (bnn_apply_fused, init_bnn_params,
                                  pack_bnn_params_fused)
from repro_torch.launch import serve_bnn
from repro_torch.serve import (FallbackPolicy, FaultPlan, FaultSpec,
                               MicroBatcher, RequestFailed, RetryPolicy,
                               ServingEngine, bucket_for, is_error,
                               pad_to_bucket)

import torch_parity  # noqa: F401  (one torch thread per xdist worker)

BUCKETS = (1, 4)


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


@pytest.fixture(scope="module")
def packed():
    return pack_bnn_params_fused(init_bnn_params(0, device="cpu"))


def requests(seed, sizes):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(n, 32, 32, 3)).astype(np.float32) for n in sizes]


def exact(packed, imgs, engine="xnor", conv_impl="direct"):
    with torch.inference_mode():
        return bnn_apply_fused(packed, torch.from_numpy(imgs), engine=engine,
                               conv_impl=conv_impl).numpy()


# direct: 5 rows over bucket 4 split the second request across batches;
# im2col (slower on the CPU) stays at 2 rows.
@pytest.mark.parametrize("conv_impl,buckets,sizes", [
    ("direct", BUCKETS, [3, 2]), ("im2col", (1, 2), [1, 1])])
def test_ragged_requests_match_exact_shape_forward(packed, conv_impl, buckets,
                                                   sizes):
    eng = ServingEngine(packed, engine="xnor", conv_impl=conv_impl,
                        buckets=buckets, clock=FakeClock())
    assert eng.warmup() == len(buckets)
    reqs = requests(1, sizes)
    rids = [eng.submit(r) for r in reqs]
    eng.drain()
    for rid, imgs in zip(rids, reqs):
        got = eng.take(rid)
        assert got.shape == (imgs.shape[0], 10)
        np.testing.assert_array_equal(got, exact(packed, imgs,
                                                 conv_impl=conv_impl))
    snap = eng.snapshot()
    assert snap["executors"]["compiles"] == len(buckets)
    assert snap["executors"]["hits"] >= 1
    assert snap["requests"]["completed"] == len(reqs)
    assert not snap["degraded"] and eng.fallback is None


def test_fallback_demotes_xnor_to_xla_bit_identically(packed):
    plan = FaultPlan([FaultSpec("raise", at=0, count=2, engine="xnor")])
    eng = ServingEngine(
        packed, engine="xnor", conv_impl="direct", buckets=BUCKETS,
        retry=RetryPolicy(max_attempts=4, backoff_base_s=0.0, jitter=0.0),
        fallback=FallbackPolicy(fused_params=packed, warm=False),
        faults=plan, clock=FakeClock())
    (imgs,) = requests(2, [2])
    rid = eng.submit(imgs)
    eng.drain()
    np.testing.assert_array_equal(eng.take(rid), exact(packed, imgs))
    snap = eng.snapshot()
    assert snap["dispatch"]["engine_path"] == ["xnor->xla"]
    assert snap["degraded"] and eng.executors.engine == "xla"
    assert [f["kind"] for f in plan.fired] == ["raise", "raise"]


def test_without_fallback_a_failing_engine_fails_requests(packed):
    eng = ServingEngine(
        packed, engine="xnor", buckets=BUCKETS,
        retry=RetryPolicy(max_attempts=2, backoff_base_s=0.0, jitter=0.0),
        faults=FaultPlan([FaultSpec("raise", at=0, count=5)]),
        clock=FakeClock())
    rid = eng.submit(requests(3, [1])[0])
    eng.drain()
    got = eng.take(rid)
    assert is_error(got) and isinstance(got, RequestFailed)
    assert got.attempts == 2
    assert eng.snapshot()["dispatch"]["fallbacks"] == 0


def test_micro_batcher_splits_fifo_across_buckets():
    clock = FakeClock()
    mb = MicroBatcher((1, 4), max_wait_s=1.0, clock=clock)
    a = mb.submit(np.zeros((3, 2)))
    b = mb.submit(np.ones((3, 2)))
    full = mb.poll()
    assert [(x.bucket, x.reason, x.rows) for x in full] == [(4, "full", 4)]
    assert [(s.rid, s.length, s.offset) for s in full[0].segments] == [
        (a, 3, 0), (b, 1, 0)]
    clock.t = 2.0
    (rest,) = mb.poll()
    assert (rest.bucket, rest.reason, rest.segments[0].offset) == (4, "max_wait", 1)
    assert pad_to_bucket(np.ones((2, 3)), 4).shape == (4, 3)
    assert bucket_for(2, (1, 4)) == 4
    with pytest.raises(ValueError):
        bucket_for(5, (1, 4))


def test_cli_runs_on_cuda_unless_told_cpu():
    args = ["--smoke", "--requests", "2", "--max-images", "2",
            "--buckets", "1,2", "--engine", "xnor", "--conv-impl", "direct"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="--device cpu"):
            serve_bnn.main(args)
    snap = serve_bnn.main(args + ["--device", "cpu"])
    assert snap["requests"]["completed"] == 2
    assert snap["executors"]["compiles"] == 2


def test_cli_exits_nonzero_when_every_dispatch_fails(packed, monkeypatch):
    """A kernel that fails at every launch must not pass the smoke run:
    the failed requests make the CLI exit non-zero."""
    def failing_engine(args):
        return ServingEngine(
            packed, engine=args.engine, conv_impl=args.conv_impl,
            buckets=args.buckets,
            retry=RetryPolicy(max_attempts=2, backoff_base_s=0.0, jitter=0.0),
            faults=FaultPlan([FaultSpec("raise", at=0, count=10**6)]))

    monkeypatch.setattr(serve_bnn, "build_engine", failing_engine)
    with pytest.raises(SystemExit, match="2 requests failed") as exc:
        serve_bnn.main(["--smoke", "--requests", "2", "--max-images", "1",
                        "--buckets", "1", "--engine", "xnor",
                        "--conv-impl", "direct", "--device", "cpu"])
    assert exc.value.code  # a message: exit status 1
