"""The BNN's train-to-serve loop end to end, as ``examples/bnn_cifar.py``:
train the CIFAR BNN with STE (latent clip, running BN statistics,
resumable checkpoints with ``--checkpoint-dir``), export it to every
packed serving format with the bit-identity probe
(``pack_trained_params``), and with ``--export`` write the sign-form
checkpoint and check its round trip.

Runs on CUDA unless ``--device cpu`` is given (it raises when CUDA is
asked for and absent); on CUDA with TF32 off, as the serving entry
points run. The ``xnor`` and ``megakernel`` engines of the probe launch
the kernels on CUDA and run their plain twins on the CPU.

Under ``torchrun`` (``WORLD_SIZE`` set) it trains data parallel, one
process a device (``distributed.process_group.init_from_env``: NCCL where
every rank has a card of its own, gloo where ranks share one), each rank
the gradient of its batch shard averaged over the world in rank order
(``train.bnn_trainer.make_dp_train_step``); rank 0 exports and reports.

  PYTHONPATH=src python -m repro_torch.launch.train_bnn [--steps 120] \
      [--checkpoint-dir DIR] [--export trained.npz] [--device cpu]
  PYTHONPATH=src python -m torch.distributed.run --nproc-per-node 2 \
      -m repro_torch.launch.train_bnn --steps 120
"""

from __future__ import annotations

import argparse
import os
import time

import torch

from repro_torch import tree
from repro_torch.core.bnn import (bnn_eval_logits, load_binary_checkpoint,
                                  pack_trained_params, resolve_device,
                                  save_binary_checkpoint)
from repro_torch.data.pipeline import DataConfig, cifar_batch_at
from repro_torch.distributed import process_group as pg
from repro_torch.launch.mesh import ServingMesh
from repro_torch.train.bnn_trainer import BNNTrainerConfig, train_bnn


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--checkpoint-dir", default=None,
                    help="resumable float checkpoints (checkpoint/manager)")
    ap.add_argument("--export", default=None,
                    help="write the compact sign-form checkpoint here")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the "
                         "plain-torch twins)")
    return ap.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(argv)
    if "WORLD_SIZE" not in os.environ:
        _run(args, None)
        return
    pg.init_from_env(device=args.device)
    try:
        _run(args, pg.bind(ServingMesh(tuple(pg.world_devices()))))
    finally:
        pg.destroy()


def _run(args, mesh) -> None:
    dev = pg.device() if mesh is not None else resolve_device(args.device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    cfg = BNNTrainerConfig(steps=args.steps, batch=args.batch, lr=args.lr,
                           warmup_steps=max(1, args.steps // 12),
                           checkpoint_dir=args.checkpoint_dir)
    t0 = time.time()
    res = train_bnn(cfg, verbose=True, device=dev, mesh=mesh)
    if mesh is not None and mesh.position != 0:
        return
    resumed = f" (resumed from {res.start_step})" if res.start_step else ""
    print(f"trained {args.steps - res.start_step} steps in "
          f"{time.time() - t0:.1f}s{resumed}")
    print(f"held-out eval: loss {res.eval_loss:.4f} acc {res.eval_acc:.3f} "
          f"(chance 0.10)")

    # Export every serving format, verified bit-identical to the trained
    # float-boundary forward on a probe batch (raises otherwise).
    probe = cifar_batch_at(DataConfig(global_batch=4, seed=2024), 0)[
        "images"].to(dev)
    packs = pack_trained_params(res.params, probe_images=probe)
    print("export verified bit-identical across engines:",
          ", ".join(sorted(packs)))

    def nbytes(t):
        return sum(x.numel() * x.element_size() for x in tree.leaves(t))

    fbytes, pbytes = nbytes(res.params), nbytes(packs["packed"])
    print(f"weights {fbytes/1e6:.1f} MB -> {pbytes/1e6:.1f} MB packed "
          f"({fbytes/pbytes:.1f}x)")

    if args.export:
        save_binary_checkpoint(args.export, res.params)
        re = load_binary_checkpoint(args.export, device=dev)
        with torch.no_grad():
            a = bnn_eval_logits(res.params, probe)
            b = bnn_eval_logits(re, probe)
        if not torch.equal(a, b):
            raise SystemExit("sign-form round trip diverged")
        pack_trained_params(re, probe_images=probe)
        print(f"sign-form checkpoint: {args.export} "
              f"({os.path.getsize(args.export)/1e6:.2f} MB, "
              f"round trip bit-identical)")


if __name__ == "__main__":
    main()
