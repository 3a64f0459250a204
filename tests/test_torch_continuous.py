"""The port's continuous scheduler on the CPU: its extent ladder is the
JAX package's, ``ContinuousServingEngine(engine="megakernel")`` answers
ragged requests exactly as the exact-shape forward does, admission
control rejects with a retry hint and counts it, a failing engine
demotes ``megakernel -> xnor -> xla`` bit-identically, and the CLI's
continuous megakernel smoke run passes."""

import numpy as np
import pytest
import torch

from repro.serve import executor as jexec
from repro_torch.core.bnn import (bnn_apply_megakernel, init_bnn_params,
                                  pack_bnn_params_fused,
                                  pack_bnn_params_megakernel)
from repro_torch.launch import serve_bnn
from repro_torch.serve import (ContinuousBatcher, ContinuousServingEngine,
                               FallbackPolicy, FaultPlan, FaultSpec, QueueFull,
                               RetryPolicy, default_extents, extent_for)

import torch_parity  # noqa: F401  (one torch thread per xdist worker)

MAX_ROWS = 4  # extent classes 1, 2, 4: small forwards on the CPU


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


@pytest.fixture(scope="module")
def params():
    latent = init_bnn_params(0, device="cpu")
    return {"mega": pack_bnn_params_megakernel(latent),
            "fused": pack_bnn_params_fused(latent)}


def requests(seed, sizes):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(n, 32, 32, 3)).astype(np.float32) for n in sizes]


def exact(mega, imgs):
    with torch.inference_mode():
        return bnn_apply_megakernel(mega, torch.from_numpy(imgs),
                                    engine="xla").numpy()


def test_extent_ladder_matches_jax():
    for n in range(1, 41):
        assert extent_for(n) == jexec.extent_for(n), n
        assert default_extents(n) == jexec.default_extents(n), n
    assert default_extents(32) == (1, 2, 4, 8, 16, 24, 32)
    assert all(extent_for(e) == e for e in default_extents(40))


def test_ragged_requests_match_exact_shape_forward(params):
    eng = ContinuousServingEngine(params["mega"], engine="megakernel",
                                  max_rows=MAX_ROWS, clock=FakeClock())
    assert eng.warmup() == 3
    reqs = requests(5, [3, 2, 1, 2])
    rids = []
    for r in reqs:
        rids.append(eng.submit(r))
        eng.step()          # max_wait not reached on the fake clock
    eng.drain()
    for rid, imgs in zip(rids, reqs):
        got = eng.take(rid)
        assert got.shape == (imgs.shape[0], 10)
        np.testing.assert_array_equal(got, exact(params["mega"], imgs))
    snap = eng.snapshot()
    assert snap["scheduler"] == "continuous"
    assert snap["executors"]["compiles"] == 3     # none under traffic
    assert all(k.endswith("|ragged") for k in snap["executors"]["keys"])
    # 8 rows at a budget of 4: two full extent-4 batches, no pad rows.
    assert snap["batches"]["dispatched"] == 2
    assert snap["batches"]["pad_row_fraction"] == 0.0
    assert not snap["degraded"]


def test_queue_full_carries_a_retry_hint_and_is_counted(params):
    clock = FakeClock()
    eng = ContinuousServingEngine(params["mega"], engine="megakernel_xla",
                                  max_rows=2, max_queue_rows=3,
                                  max_wait_s=0.01, clock=clock)
    eng.submit(requests(6, [2])[0])
    with pytest.raises(QueueFull) as exc:
        eng.submit(requests(7, [2])[0])
    assert exc.value.retry_after_s == pytest.approx(0.01)  # no service seen yet
    snap = eng.snapshot()
    assert snap["requests"]["rejected"] == 1
    assert snap["requests"]["images_rejected"] == 2
    assert snap["requests"]["submitted"] == 1
    # After a dispatch the hint is the per-row service estimate.
    eng.batcher.note_service(2, 0.5)
    with pytest.raises(QueueFull) as exc:
        eng.submit(requests(8, [3])[0])
    assert exc.value.retry_after_s == pytest.approx(0.25 * 2)


def test_slo_aware_wait_shrinks_with_the_service_estimate():
    clock = FakeClock()
    mb = ContinuousBatcher(max_rows=4, max_wait_s=0.1, slo_s=0.2,
                           slo_headroom=0.5, clock=clock)
    assert mb.current_wait() == pytest.approx(0.1)
    mb.submit(np.zeros((2, 3)))
    mb.note_service(4, 0.08)            # 0.02 s per row
    assert mb.current_wait() == pytest.approx(0.1 - 0.04)
    assert mb.poll() == []
    clock.t = 0.07
    (batch,) = mb.poll()
    assert (batch.rows, batch.bucket, batch.reason) == (2, 2, "max_wait")


def test_failover_demotes_megakernel_to_xnor_to_xla(params):
    plan = FaultPlan([FaultSpec("raise", at=0, count=4)])
    policy = FallbackPolicy(fused_params=params["fused"],
                            mega_params=params["mega"], warm=False)
    eng = ContinuousServingEngine(
        params["mega"], engine="megakernel", max_rows=MAX_ROWS,
        retry=RetryPolicy(max_attempts=6, backoff_base_s=0.0, jitter=0.0),
        fallback=policy, faults=plan, clock=FakeClock())
    (imgs,) = requests(9, [3])
    rid = eng.submit(imgs)
    eng.drain()
    np.testing.assert_array_equal(eng.take(rid), exact(params["mega"], imgs))
    snap = eng.snapshot()
    assert snap["dispatch"]["engine_path"] == ["megakernel->xnor", "xnor->xla"]
    assert eng.executors.engine == "xla"
    assert eng.executors.key(4) == (4, "xla", "im2col", "auto", "ragged")
    assert [f["engine"] for f in plan.fired] == ["megakernel"] * 2 + ["xnor"] * 2
    # Rungs without params are skipped; without any, nothing demotes.
    assert FallbackPolicy(fused_params=params["fused"]).next_engine(
        "megakernel") == "xnor"
    assert FallbackPolicy(mega_params=params["mega"]).next_engine(
        "megakernel") is None
    assert FallbackPolicy(mega_params=params["mega"]).next_engine(
        "megakernel_xla") is None


def test_cli_continuous_megakernel_smoke_on_cpu():
    snap = serve_bnn.main(["--smoke", "--scheduler", "continuous",
                           "--engine", "megakernel", "--max-rows", "4",
                           "--requests", "3", "--max-images", "3",
                           "--fallback", "on", "--device", "cpu"])
    assert snap["scheduler"] == "continuous"
    assert snap["requests"]["completed"] == 3
    assert snap["executors"]["compiles"] == 3
