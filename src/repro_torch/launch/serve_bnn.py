"""BNN serving CLI: a serving engine against a short burst of synthetic
ragged requests.

``--scheduler bucket`` (the default) pads each batch to a rung of
``--buckets``; ``--scheduler continuous`` coalesces up to ``--max-rows``
real rows per dispatch and pads only to the batch's extent class.
``--engine`` picks the kernel path: ``xnor``/``xla`` the per-layer fused
chain, ``megakernel``/``megakernel_xla`` one launch per network stage
(``--conv-impl`` then does not apply: those convs are direct).
``--fallback on`` arms the bit-identical demotion ladder, holding both
param packings for a megakernel engine.

``--smoke`` (the only mode so far) warms every bucket or extent class,
serves ``--requests`` requests of U{1..``--max-images``} images each,
checks every request's logits bit for bit against an exact-shape
forward of its images alone, and prints the stats snapshot. It exits non-zero if
any request diverged, failed or went unanswered: the CLI sets no
deadline, so a failed request means a failed kernel. It runs on CUDA unless
``--device cpu`` is given, and raises when CUDA is asked for and absent.
Weights are random, from ``--seed``.

  PYTHONPATH=src python -m repro_torch.launch.serve_bnn --smoke --engine xnor
  PYTHONPATH=src python -m repro_torch.launch.serve_bnn --smoke --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve_bnn --smoke \
      --scheduler continuous --engine megakernel --device cpu
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
from repro_torch.serve import (ContinuousServingEngine, FallbackPolicy,
                               ServingEngine, is_error)


def build_engine(args) -> ServingEngine:
    device = resolve_device(args.device)
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
    if args.scheduler == "continuous":
        return ContinuousServingEngine(
            packed, engine=args.engine, conv_impl=args.conv_impl,
            max_rows=args.max_rows, fallback=fallback)
    return ServingEngine(packed, engine=args.engine, conv_impl=args.conv_impl,
                         buckets=args.buckets, fallback=fallback)


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
    rids = []
    for imgs in requests:
        rids.append(eng.submit(imgs))
        eng.step()
    eng.drain()

    mismatches = errored = 0
    for rid, imgs in zip(rids, requests):
        got = eng.take(rid)
        if got is not None and is_error(got):
            errored += 1
            continue
        want = exact_forward(eng, imgs, args.conv_impl)
        if got is None or not np.array_equal(got, want):
            mismatches += 1
    snap = eng.snapshot()
    print(f"served {snap['requests']['completed']} requests "
          f"({snap['requests']['images_completed']} images), "
          f"{mismatches} logits mismatches, {errored} expired/failed")
    print(json.dumps(snap, indent=2))
    if mismatches:
        raise SystemExit(f"{mismatches} requests diverged from the "
                         "exact-shape forward")
    if errored or snap["requests"]["completed"] != len(requests):
        raise SystemExit(f"{errored} requests failed and "
                         f"{snap['requests']['completed']} of {len(requests)} "
                         "completed")
    return snap


def parse_args(argv=None):
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
    ap.add_argument("--max-rows", type=int, default=8,
                    help="continuous scheduler: per-dispatch row budget")
    ap.add_argument("--fallback", default="off", choices=["on", "off"],
                    help="on: arm the bit-identical engine demotion ladder")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    ap.add_argument("--buckets", type=lambda s: tuple(
        int(b) for b in s.split(",")), default=(1, 4, 8),
        help="bucket scheduler: comma-separated batch-size ladder")
    ap.add_argument("--smoke", action="store_true",
                    help="short burst + logits verification (the default)")
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--max-images", type=int, default=8,
                    help="images per request ~ U{1..max}")
    ap.add_argument("--seed", type=int, default=0)
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    return run_smoke(parse_args(argv))


if __name__ == "__main__":
    main()
