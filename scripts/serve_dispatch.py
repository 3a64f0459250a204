"""Host-clock time of the single-device BNN serving dispatch of one tree,
on one GPU.

    python3 scripts/serve_dispatch.py [TREE] [--reps N]

``TREE`` (default: this repository) is a checkout whose ``src`` holds a
``repro_torch``; its kernels are built from its own sources. On the
trained checkpoint it times, as medians of ``--reps`` host-clock calls
after 10 warm-up calls: the xnor/direct executor's dispatch of 32 images
(one CUDA graph: copy in, replay, copy out), and a 32-image request
through the xnor/direct bucket engine and through the continuous
megakernel engine, submit to logits. Prints one JSON line. To compare two
commits, unpack the other one (``git archive``) into a git-ignored
directory and run the script on both trees in turns on one card, in one
command (A B B A): runs on other cards or at other times differ by more
than the effects it measures. Needs CUDA and ``nvcc``; imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]


def median_ms(fn, reps: int) -> float:
    for _ in range(10):
        fn()
    times = []
    for _ in range(reps):
        t = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t)
    return statistics.median(times) * 1e3


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("tree", nargs="?", default=str(ROOT))
    parser.add_argument("--reps", type=int, default=200)
    args = parser.parse_args()
    tree = pathlib.Path(args.tree).resolve()
    sys.path.insert(0, str(tree / "src"))
    import numpy as np
    import torch

    from repro_torch.core.bnn import (load_binary_checkpoint,
                                      pack_bnn_params_fused,
                                      pack_bnn_params_megakernel)
    from repro_torch.kernels import build
    from repro_torch.serve import (ContinuousServingEngine, ExecutorCache,
                                   ServingEngine)

    if not torch.cuda.is_available():
        sys.exit("serve_dispatch: needs a CUDA device")
    build.build()
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    latent = load_binary_checkpoint(
        tree / "tests" / "golden" / "bnn_trained_ckpt.npz", device=dev)
    packed = pack_bnn_params_fused(latent)
    mega = pack_bnn_params_megakernel(latent)
    x = np.random.default_rng(41).normal(size=(32, 32, 32, 3)).astype(
        np.float32)
    out = {"tree": str(tree), "device": torch.cuda.get_device_name(0)}
    ex = ExecutorCache(packed, engine="xnor", conv_impl="direct").get(32)
    out["executor_b32_ms"] = median_ms(lambda: ex(x), args.reps)
    for name, eng in (
            ("engine_xnor_direct", ServingEngine(
                packed, engine="xnor", conv_impl="direct", buckets=(32,),
                max_wait_s=0.0)),
            ("engine_megakernel", ContinuousServingEngine(
                mega, engine="megakernel", max_rows=32, max_wait_s=0.0))):
        eng.warmup()

        def request(eng=eng):
            rid = eng.submit(x)
            eng.step()
            eng.drain()
            if eng.take(rid).shape != (32, 10):
                sys.exit(f"serve_dispatch: {name} returned no logits")

        out[f"{name}_b32_ms"] = median_ms(request, args.reps)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
