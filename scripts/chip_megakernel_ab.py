"""A/B timing of the port's two megakernels on one GPU.

    python3 scripts/chip_megakernel_ab.py TREE [TREE ...] [--probe]

For each TREE (a checkout of this repository, e.g. the parent commit
unpacked with ``git archive`` into a directory ``.gitignore`` lists),
builds its kernels and runs phase 3's megakernel part of its
``chip_smoke.py`` (each kernel bit-exact against its twin, timed beside
the per-layer kernels), then times its batch-32 megakernel forward on
the trained checkpoint. Give the trees in turns (A B B A) to compare two
versions on one card. ``--probe`` then times the chain kernel of the
first tree alone at stack shapes that split its time into launch, fc0's
K words and the head. Needs CUDA; imports no JAX.
"""

from __future__ import annotations

import argparse
import importlib.util
import pathlib
import subprocess
import sys

PROBE_CASES = [  # (label, layers, M, K words, k_bits, batch, head)
    ("near-empty L1 [1,256,1] n8", 1, 256, 1, (32,), 8, False),
    ("near-empty L1 [1,256,1] n8 + head", 1, 256, 1, (32,), 8, True),
    ("fc1-like L1 [1,1024,32] n8", 1, 1024, 32, (1024,), 8, False),
    ("fc0 L1 [1,1024,64] n8", 1, 1024, 64, (2048,), 8, False),
    ("fc0 L1 [1,1024,128] n8", 1, 1024, 128, (4096,), 8, False),
    ("fc0 L1 [1,1024,256] n8", 1, 1024, 256, (8192,), 8, False),
    ("trunk L2 [2,1024,256] n8 + head", 2, 1024, 256, (8192, 1024), 8, True),
    ("trunk L2 [2,1024,256] n32 + head", 2, 1024, 256, (8192, 1024), 32, True),
]


def run_tree(tree: pathlib.Path) -> None:
    """Phase 3 megakernels and the batch-32 forward of one tree, in a
    process of its own (each tree imports its own ``repro_torch``)."""
    code = f"""
import sys, importlib.util
sys.path.insert(0, {str(tree / 'src')!r})
spec = importlib.util.spec_from_file_location("smoke", {str(tree / 'chip_smoke.py')!r})
cs = importlib.util.module_from_spec(spec); spec.loader.exec_module(cs)
import numpy as np, torch
from repro_torch.core.bnn import (bnn_apply_megakernel, load_binary_checkpoint,
                                  pack_bnn_params_megakernel)
from repro_torch.kernels import build, ops
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
build.build()
dev = torch.device("cuda", 0)
totals = {{k: {{"max_abs_err": 0, "bytes": 0, "ops": 0}} for k in ops.LAUNCHES}}
cs.megakernel_phase(dev, totals, [])
mega = pack_bnn_params_megakernel(load_binary_checkpoint(cs.CKPT, device=dev))
x = torch.from_numpy(np.random.default_rng(0).normal(
    size=(cs.BATCH, 32, 32, 3)).astype(np.float32)).to(dev)
with torch.inference_mode():
    f = lambda: bnn_apply_megakernel(mega, x, engine="xnor", ragged=True)
    print(f"  forward batch {{cs.BATCH}} megakernel: eager {{cs.time_ms(f, 10, 3):.4f}} ms, "
          f"graph {{cs.graph_ms(f, 5):.4f}} ms", flush=True)
"""
    print(f"== {tree}", flush=True)
    subprocess.run([sys.executable, "-c", code], check=True)


def probe(tree: pathlib.Path) -> None:
    sys.path.insert(0, str(tree / "src"))
    spec = importlib.util.spec_from_file_location("smoke", tree / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import torch

    from repro_torch.kernels import build, ops

    build.build()
    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(0)
    print(f"== chain probe, {tree}", flush=True)
    for label, n_layers, m, kw, k_bits, n, head in PROBE_CASES:
        w = cs.rand_words(gen, (n_layers, m, kw), dev)
        aff = [cs.rand_affine(gen, m, k, dev) for k in k_bits]
        a = torch.stack([p[0] for p in aff])
        b = torch.stack([p[1] for p in aff])
        x = cs.rand_words(gen, (kw, n), dev)
        fin = cs.rand_words(gen, (10, m // 32), dev) if head else None

        def run(w=w, a=a, b=b, x=x, fin=fin, k_bits=k_bits, m=m):
            return ops.megakernel_chain(w, a, b, k_bits, x, m, final_wp=fin,
                                        final_k_bits=m,
                                        ragged_tile=ops.RAGGED_TILE_N)

        print(f"  {label:36s} {cs.graph_ms(run, iters=50) * 1e3:8.2f} us",
              flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("trees", nargs="+", type=pathlib.Path)
    ap.add_argument("--probe", action="store_true")
    args = ap.parse_args()
    for tree in args.trees:
        run_tree(tree.resolve())
    if args.probe:
        probe(args.trees[0].resolve())


if __name__ == "__main__":
    main()
