"""BNN serving CLI: a serving engine against synthetic ragged requests.

``--scheduler bucket`` (the default) pads each batch to a rung of
``--buckets``; ``--scheduler continuous`` coalesces up to ``--max-rows``
real rows per dispatch and pads only to the batch's extent class, with
admission control (``--max-queue-rows``) and an SLO-aware wait
(``--slo-ms``). ``--engine`` picks the kernel path: ``xnor``/``xla`` the
per-layer fused chain, ``megakernel``/``megakernel_xla`` one launch per
network stage (``--conv-impl`` then does not apply: those convs are
direct). ``--fallback on`` arms the bit-identical demotion ladder,
holding both param packings for a megakernel engine. ``--devices N``
serves on a mesh of the first ``N`` devices (``launch.mesh``): the packed
weights replicated on each, every batch split across them, one process
driving them all; with ``--device cpu`` they are ``N`` CPU entries.
``--blocks tuned`` serves the tiling that
``repro_torch.serve.tuning.tune_serving_blocks`` stored in the autotune
cache (``$REPRO_AUTOTUNE_CACHE``), probing the buckets largest first;
``auto`` resolves each kernel's tiling per launch.

Two modes:

* ``--smoke`` (the default) warms every bucket or extent class, serves
  ``--requests`` requests of U{1..``--max-images``} images each, checks
  every request's logits bit for bit against an exact-shape forward of
  its images alone, and prints the stats snapshot.
* ``--sustained`` is an open-loop load run: requests arrive at
  ``--rate`` a second for ``--duration`` seconds and the dispatch loop
  runs in the gaps (:func:`run_sustained`); it prints p50/p95/p99
  latency, throughput, goodput under ``--slo-ms``, the pad-row fraction
  and the executors built, and checks every answered request's logits
  as the smoke run does.

Both exit non-zero if any request diverged, failed or went unanswered;
with ``--deadline-ms`` a request may expire instead. On CUDA each bucket
or extent class is served from a captured CUDA graph. The CLI runs on
CUDA unless ``--device cpu`` is given, and raises when CUDA is asked for
and absent. Weights are random, from ``--seed``.

  PYTHONPATH=src python -m repro_torch.launch.serve_bnn --smoke --engine xnor
  PYTHONPATH=src python -m repro_torch.launch.serve_bnn --smoke --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve_bnn --smoke \
      --scheduler continuous --engine megakernel --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve_bnn --sustained \
      --scheduler continuous --engine megakernel --rate 200 --duration 3
  PYTHONPATH=src python -m repro_torch.launch.serve_bnn --smoke \
      --devices 8 --device cpu
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch.core.bnn import (SERVE_ENGINES, bnn_apply_fused,
                                  bnn_apply_megakernel, init_bnn_params,
                                  pack_bnn_params_fused,
                                  pack_bnn_params_megakernel, resolve_device)
from repro_torch.kernels.autotune import AUTO
from repro_torch.launch.mesh import make_serving_mesh
from repro_torch.serve import (DEFAULT_BUCKETS, ContinuousServingEngine,
                               FallbackPolicy, QueueFull, RetryPolicy,
                               ServingEngine, is_error, load_serving_blocks)
from repro_torch.serve.faults import DeadlineExceeded


def serving_blocks(args):
    """``--blocks``: ``AUTO``, or the tuned serving config of the largest
    bucket that has one (printing which entry was found)."""
    if args.blocks == AUTO:
        return AUTO
    for b in sorted(args.buckets, reverse=True):
        blocks = load_serving_blocks(args.engine, args.conv_impl, b)
        if blocks != AUTO:
            print(f"using the tuned serving config of bucket {b}: {blocks}")
            return blocks
    print("no tuned serving config in the autotune cache for "
          f"engine={args.engine} conv_impl={args.conv_impl} "
          f"buckets={args.buckets}; using 'auto'")
    return AUTO


def build_engine(args, *, clock=time.monotonic) -> ServingEngine:
    device = resolve_device(args.device)
    mesh = None
    if args.devices > 1:
        mesh = make_serving_mesh(args.devices, device=device)
        print(f"serving mesh: {args.devices} devices, 1-D data axis "
              "(weights replicated, batch sharded)")
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    params = init_bnn_params(args.seed, device=device)
    fused = pack_bnn_params_fused(params)
    mega = (pack_bnn_params_megakernel(params)
            if args.engine.startswith("megakernel") else None)
    fallback = None
    if args.fallback == "on":
        fallback = FallbackPolicy(fused_params=fused, mega_params=mega)
    packed = mega if mega is not None else fused
    slo_s = args.slo_ms / 1e3 if args.slo_ms is not None else None
    common = dict(
        engine=args.engine, conv_impl=args.conv_impl,
        blocks=serving_blocks(args), max_wait_s=args.max_wait_ms / 1e3,
        slo_s=slo_s,
        deadline_s=(args.deadline_ms / 1e3
                    if args.deadline_ms is not None else None),
        # --max-retries counts re-dispatches; the policy counts attempts
        retry=RetryPolicy(max_attempts=args.max_retries + 1),
        mesh=mesh, fallback=fallback, clock=clock)
    if args.scheduler == "continuous":
        return ContinuousServingEngine(
            packed, max_rows=args.max_rows,
            max_queue_rows=args.max_queue_rows, **common)
    return ServingEngine(packed, buckets=args.buckets, **common)


def exact_forward(eng: ServingEngine, images: np.ndarray,
                  conv_impl: str) -> np.ndarray:
    """The engine's forward on ``images`` alone, at their exact shape."""
    x = torch.from_numpy(images).to(eng.executors.device)
    engine = eng.executors.engine
    with torch.inference_mode():
        if engine.startswith("megakernel"):
            inner = "xnor" if engine == "megakernel" else "xla"
            y = bnn_apply_megakernel(eng.executors.packed, x, engine=inner)
        else:
            y = bnn_apply_fused(eng.executors.packed, x, engine=engine,
                                conv_impl=conv_impl)
    return y.cpu().numpy()


def random_requests(rng: np.random.Generator, count: int,
                    max_images: int) -> list[np.ndarray]:
    """``count`` requests of U{1..max_images} normal images each."""
    out = []
    for _ in range(count):
        n = int(rng.integers(1, max_images + 1))
        out.append(rng.normal(size=(n, 32, 32, 3)).astype(np.float32))
    return out


def check_results(eng: ServingEngine, requests: dict, results: dict,
                  args) -> dict:
    """Hold every answered request's logits to its exact-shape forward;
    count the mismatches, the expired, the failed and the unanswered,
    and raise ``SystemExit`` on any mismatch, failure or unanswered
    request (an expired one only when no ``--deadline-ms`` was set)."""
    mismatches = expired = failed = 0
    for rid, imgs in requests.items():
        got = results.get(rid)
        if got is None:
            continue
        if is_error(got):
            if isinstance(got, DeadlineExceeded):
                expired += 1
            else:
                failed += 1
            continue
        if not np.array_equal(got, exact_forward(eng, imgs, args.conv_impl)):
            mismatches += 1
    unanswered = len(requests) - len(results)
    print(f"served {len(results) - expired - failed} of {len(requests)} "
          f"requests, {mismatches} logits mismatches, {expired} expired, "
          f"{failed} failed, {unanswered} unanswered")
    if mismatches:
        raise SystemExit(f"{mismatches} requests diverged from the "
                         "exact-shape forward")
    lost = failed + unanswered + (expired if args.deadline_ms is None else 0)
    if lost:
        raise SystemExit(f"{failed + expired} requests failed and "
                         f"{len(results) - expired - failed} of "
                         f"{len(requests)} completed")
    return {"mismatches": mismatches, "expired": expired, "failed": failed,
            "unanswered": unanswered}


def run_smoke(args) -> dict:
    eng = build_engine(args)
    t0 = time.monotonic()
    n_built = eng.warmup()
    continuous = args.scheduler == "continuous"
    shapes = eng.extents if continuous else eng.batcher.buckets
    print(f"warmup: {n_built} {'extent' if continuous else 'bucket'} "
          f"executors built ({', '.join(map(str, shapes))}) in "
          f"{time.monotonic() - t0:.1f}s")
    requests = random_requests(np.random.default_rng(args.seed),
                               args.requests, args.max_images)
    submitted = {}
    for imgs in requests:
        submitted[eng.submit(imgs)] = imgs
        eng.step()
    eng.drain()
    results = {rid: eng.results.pop(rid) for rid in list(eng.results)}
    snap = eng.snapshot()
    print(json.dumps(snap, indent=2))
    check_results(eng, submitted, results, args)
    return snap


def run_sustained(args, *, clock=time.monotonic) -> dict:
    """Open-loop load: one request every ``1 / --rate`` seconds of
    ``clock`` for ``--duration`` seconds, the engine's ``step`` in the
    gaps, then a drain. ``clock`` drives arrivals, the batcher's waits
    and the latencies alike; a test passes one that advances by itself,
    so nothing sleeps. Every answered request's logits are checked as
    in :func:`run_smoke`, after the run; returns the snapshot with the
    check's counts under ``"check"``."""
    eng = build_engine(args, clock=clock)
    n_built = eng.warmup()
    rng = np.random.default_rng(args.seed)
    interval = 1.0 / args.rate
    t_start = clock()
    t_end = t_next = t_start
    t_end += args.duration
    submitted, results, rejected = {}, {}, 0
    while clock() < t_end:
        if clock() >= t_next:
            imgs = random_requests(rng, 1, args.max_images)[0]
            try:
                submitted[eng.submit(imgs)] = imgs
            except QueueFull:
                rejected += 1   # admission control shed it (counted in
                                # the snapshot too)
            t_next += interval
        for rid in eng.step():
            results[rid] = eng.take(rid)
    for rid in eng.drain():
        results[rid] = eng.take(rid)
    snap = eng.snapshot()
    lat, bat = snap["latency_s"], snap["batches"]
    print(f"sustained[{snap['scheduler']}]: {len(submitted)} requests "
          f"({rejected} rejected) over {args.duration:.1f}s at "
          f"{args.rate}/s target; {n_built} executors built at warmup")
    print(f"throughput {snap['throughput']['images_per_s']:.1f} img/s | "
          f"latency p50 {lat['p50'] * 1e3:.3f} ms p95 {lat['p95'] * 1e3:.3f} "
          f"ms p99 {lat['p99'] * 1e3:.3f} ms")
    print(f"dispatch shapes {bat['per_bucket']} | pad-row fraction "
          f"{bat['pad_row_fraction']:.3f} | executors built "
          f"{snap['executors']['compiles']} ({n_built} at warmup)")
    if snap["slo"]["slo_s"] is not None:
        print(f"SLO {snap['slo']['slo_s'] * 1e3:.1f} ms: goodput "
              f"{snap['slo']['goodput_images_per_s']:.1f} img/s "
              f"({snap['slo']['images_within_slo']} images within it)")
    req, disp = snap["requests"], snap["dispatch"]
    if (req["expired"] or req["failed"] or disp["retries"]
            or snap["degraded"]):
        print(f"resilience: {req['expired']} expired, {req['failed']} "
              f"failed, {disp['retries']} batch retries, "
              f"{disp['fallbacks']} fallbacks "
              f"({' '.join(disp['engine_path']) or 'none'}), "
              f"{snap['mesh']['shrinks']} mesh shrinks | "
              f"degraded={snap['degraded']}")
    print(json.dumps(snap, indent=2))
    snap["check"] = check_results(eng, submitted, results, args)
    snap["check"].update(rejected=rejected, warmup_built=n_built)
    return snap


def make_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--engine", default="xla", choices=list(SERVE_ENGINES),
                    help="xnor/megakernel: the CUDA kernels, one launch per "
                         "layer/per stage; xla/megakernel_xla: their "
                         "plain-torch twins")
    ap.add_argument("--conv-impl", default="im2col",
                    choices=["im2col", "direct"],
                    help="xnor/xla only; the megakernel convs are direct")
    ap.add_argument("--scheduler", default="bucket",
                    choices=["bucket", "continuous"],
                    help="bucket: pad to a rung of --buckets; continuous: "
                         "ragged batches of up to --max-rows rows")
    ap.add_argument("--buckets", type=lambda s: tuple(
        int(b) for b in s.split(",")), default=None,
        help="bucket scheduler: comma-separated batch-size ladder (default "
             "1,4,8 for --smoke, 1,8,32,128 for --sustained)")
    ap.add_argument("--max-rows", type=int, default=None,
                    help="continuous scheduler: per-dispatch row budget "
                         "(default 8 for --smoke, 32 for --sustained)")
    ap.add_argument("--max-queue-rows", type=int, default=None,
                    help="continuous scheduler: admission-control bound on "
                         "queued rows (default: unbounded)")
    ap.add_argument("--slo-ms", type=float, default=None,
                    help="latency SLO: arms goodput accounting on both "
                         "schedulers and the continuous scheduler's "
                         "SLO-aware wait")
    ap.add_argument("--max-wait-ms", type=float, default=2.0,
                    help="micro-batcher head-of-line latency bound")
    ap.add_argument("--deadline-ms", type=float, default=None,
                    help="per-request deadline: past it a request "
                         "completes as DeadlineExceeded instead of being "
                         "served late (default: none)")
    ap.add_argument("--max-retries", type=int, default=2,
                    help="re-dispatches of a failed batch before its "
                         "requests complete as RequestFailed")
    ap.add_argument("--fallback", default="off", choices=["on", "off"],
                    help="on: arm the bit-identical engine demotion ladder")
    ap.add_argument("--blocks", default=AUTO, choices=[AUTO, "tuned"],
                    help="tuned: the serving tiling stored in the autotune "
                         "cache by tune_serving_blocks; auto: each kernel's "
                         "per launch")
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--sustained", action="store_true",
                      help="open-loop load run")
    mode.add_argument("--smoke", action="store_true",
                      help="short burst + logits verification (the default)")
    ap.add_argument("--requests", type=int, default=12,
                    help="smoke: number of requests in the burst")
    ap.add_argument("--rate", type=float, default=10.0,
                    help="sustained: request arrivals per second")
    ap.add_argument("--duration", type=float, default=10.0,
                    help="sustained: seconds of traffic")
    ap.add_argument("--max-images", type=int, default=8,
                    help="images per request ~ U{1..max}")
    ap.add_argument("--devices", type=int, default=1,
                    help="serve on a mesh of the first N devices of the "
                         "--device kind: weights replicated, every batch "
                         "split across them")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    ap.add_argument("--seed", type=int, default=0)
    return ap


def parse_args(argv=None):
    args = make_parser().parse_args(argv)
    if args.buckets is None:
        # the smoke run verifies every request, so its ladder stays small
        args.buckets = DEFAULT_BUCKETS if args.sustained else (1, 4, 8)
    if args.max_rows is None:
        args.max_rows = 32 if args.sustained else 8
    return args


def main(argv=None, *, clock=time.monotonic) -> dict:
    args = parse_args(argv)
    if args.sustained:
        return run_sustained(args, clock=clock)
    return run_smoke(args)


if __name__ == "__main__":
    main()
