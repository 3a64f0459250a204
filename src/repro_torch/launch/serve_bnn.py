"""BNN serving CLI: the bucket-scheduled serving engine against a
short burst of synthetic ragged requests.

``--smoke`` (the only mode so far) warms every bucket, serves
``--requests`` requests of U{1..``--max-images``} images each, checks
every request's logits bit for bit against an exact-shape forward of
its images alone, and prints the stats snapshot. It exits non-zero if
any request diverged, failed or went unanswered: the CLI sets no
deadline, so a failed request means a failed kernel. It runs on CUDA unless
``--device cpu`` is given, and raises when CUDA is asked for and absent.
Weights are random, from ``--seed``.

  PYTHONPATH=src python -m repro_torch.launch.serve_bnn --smoke --engine xnor
  PYTHONPATH=src python -m repro_torch.launch.serve_bnn --smoke --device cpu
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch.core.bnn import (SERVE_ENGINES, bnn_apply_fused,
                                  init_bnn_params, pack_bnn_params_fused,
                                  resolve_device)
from repro_torch.serve import ServingEngine, is_error


def build_engine(args) -> ServingEngine:
    device = resolve_device(args.device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    fused = pack_bnn_params_fused(init_bnn_params(args.seed, device=device))
    return ServingEngine(fused, engine=args.engine, conv_impl=args.conv_impl,
                         buckets=args.buckets)


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
    print(f"warmup: {n_built} bucket executors built "
          f"({', '.join(map(str, eng.batcher.buckets))}) in "
          f"{time.monotonic() - t0:.1f}s")
    requests = random_requests(np.random.default_rng(args.seed),
                               args.requests, args.max_images)
    rids = []
    for imgs in requests:
        rids.append(eng.submit(imgs))
        eng.step()
    eng.drain()

    mismatches = errored = 0
    dev = eng.executors.device
    for rid, imgs in zip(rids, requests):
        got = eng.take(rid)
        if got is not None and is_error(got):
            errored += 1
            continue
        with torch.inference_mode():
            want = bnn_apply_fused(
                eng.executors.packed, torch.from_numpy(imgs).to(dev),
                engine=eng.executors.engine, conv_impl=args.conv_impl,
            ).cpu().numpy()
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
                    help="xnor: the CUDA kernels; xla: the plain-torch twins")
    ap.add_argument("--conv-impl", default="im2col",
                    choices=["im2col", "direct"])
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    ap.add_argument("--buckets", type=lambda s: tuple(
        int(b) for b in s.split(",")), default=(1, 4, 8),
        help="comma-separated batch-size ladder")
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
