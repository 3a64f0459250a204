"""End-to-end LM training driver, as ``repro.launch.train``: the synthetic
data pipeline (prefetched), the quantization-aware model, AdamW with the
latent clip, global-norm clip and schedule, checksummed async
checkpoints with auto-resume, and the fault-tolerance monitor.

Runs on CUDA (``train(device=...)`` takes another device, as the tests
do; the CLI has the JAX launcher's flags and no device flag), on every
visible card, laid out as the JAX launcher lays its devices out
(:func:`train_mesh`): ``make_elastic_mesh(devices, model_parallel=min(n,
16))``, a ``("data", "model")`` ``DeviceMesh``. Every family trains there
by ``train.step.make_tp_train_step``: tensor and expert parallelism over
the model axis (attention, dense and MoE FFNs, mamba, the xLSTM, the
encoder-decoder), the params and optimizer state laid out by the whole
rule table (``distributed.sharding.shard_params``), the step under
``activation_mesh``, as the JAX launcher runs its steps. From 32 cards
the data axis holds more than one (``(n // 16, 16)``), and every matrix is
then split over it too: each card holds its block of the params and of
AdamW's state, and a period's weights are gathered over data where they
are used (fully sharded data parallelism; the layout line says so).
``train(mesh=)`` takes a ``DeviceMesh`` or a 1-D ``ServingMesh`` (data
parallelism: ``train.step.make_dp_train_step``, params on the first device, each
replica the gradient of its batch shard, averaged there in mesh order; an
MoE config's balance loss formed from every shard's router terms), CPU
entries or replicas sharing one card. The launcher prints the layout it
took. Checkpoints hold the gathered tree, so a run saved on one mesh
resumes on another. Every family trains: a config fed by
embeddings (pixtral-12b, seamless-m4t-large-v2) gets them derived from
each batch's tokens as the JAX launcher derives them
(``stub_embeddings``). Each step is eager PyTorch: no
``torch.compile``; attention, the SSM scan and the mLSTM run their
kernels forward and backward.

Under ``torchrun`` (``WORLD_SIZE`` set) it runs one process a device, as
the JAX package runs its sharded step: ``distributed.process_group.
init_from_env`` starts the world (NCCL where every rank has a card of its
own, gloo where ranks share one), the mesh of the world's devices is the
one above with each rank at its flat position (``process_group.bind``),
each process holds its own device's blocks and computes its own part,
and the collectives go through ``torch.distributed``; the step is the
one-process step bit for bit. Rank 0 prints and writes the checkpoints
(the gathered trees); every rank reads the same checkpoint on resume and
takes its own blocks. MoE configs do not run so yet (ROADMAP A5b step 6).

  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \\
      --smoke --steps 50 --batch 8 --seq 128 --ckpt-dir /tmp/ckpt
  PYTHONPATH=src python -m torch.distributed.run --nproc-per-node 2 \\
      -m repro_torch.launch.train --arch qwen2.5-3b --steps 20
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from repro_torch.checkpoint import manager as ckpt
from repro_torch.configs.base import (float_policy, get_config, smoke_config,
                                      train_policy)
from repro_torch.core.bnn import resolve_device
from repro_torch.data.pipeline import DataConfig, Prefetcher, synthetic_lm_batches
from repro_torch.distributed import process_group as pg
from repro_torch.distributed.fault_tolerance import (HeartbeatMonitor,
                                                     StragglerDetector)
from repro_torch.distributed.sharding import (data_axis_size, flat_devices,
                                              gather_params, model_axis_size,
                                              shard_params)
from repro_torch.launch.mesh import (DeviceMesh, ServingMesh, make_device_mesh,
                                     make_serving_mesh)
from repro_torch.models.model_factory import build_model
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.step import (TrainConfig, init_opt_state,
                                    make_dp_train_step, make_tp_train_step,
                                    make_train_step)


def stub_embeddings(tokens: torch.Tensor, d_model: int) -> torch.Tensor:
    """The modality stub's embeddings of a batch, as the JAX launcher
    derives them: ``normal(0, 1, (*tokens.shape, d_model))`` in float32
    from ``np.random.default_rng(tokens[0, 0])`` (0 for an empty batch),
    on the CPU."""
    tok = tokens.cpu().numpy()
    rng = np.random.default_rng(tok[0, 0] if tok.size else 0)
    emb = rng.normal(0, 1, (*tok.shape, d_model)).astype(np.float32)
    return torch.from_numpy(emb)


def train_mesh(device=None, mesh=None):
    """The mesh ``train`` runs on: ``mesh`` when given, else every visible
    card on CUDA, or the one device named. Several cards give the JAX
    launcher's layout, ``make_device_mesh(cards, model_parallel=min(n,
    16))``, for every family; one card its 1-D ``ServingMesh``
    (``make_serving_mesh``). Under a process group the world's devices,
    laid out the same way, bound to this process's position."""
    if pg.active():
        if mesh is None:
            devs = pg.world_devices()
            mesh = (make_device_mesh(devs, model_parallel=min(len(devs), 16))
                    if len(devs) > 1 else ServingMesh(tuple(devs)))
        return pg.bind(mesh)
    if mesh is not None:
        return mesh
    dev = resolve_device(device)
    if dev.type != "cuda":
        return ServingMesh((dev,))
    cards = make_serving_mesh(device=dev)
    if len(cards) > 1:
        return make_device_mesh(cards.devices,
                                model_parallel=min(len(cards), 16))
    return cards


def _layout(model, tcfg: TrainConfig, mesh):
    """(step, laid out, gathered, description): the train step for
    ``mesh``, the functions from a full tree to the step's layout of it
    and back, and what the launcher prints."""
    if isinstance(mesh, DeviceMesh):
        if model_axis_size(mesh) > 1:
            rows = data_axis_size(mesh)
            fsdp = (f"; params and optimizer state sharded over data too, {rows} "
                    "blocks a leaf, gathered where used" if rows > 1 else "")
            return (make_tp_train_step(model, tcfg, mesh),
                    lambda t: shard_params(t, mesh),
                    lambda t: gather_params(t, mesh),
                    f"tensor parallel over {dict(mesh.shape)} "
                    f"{list(map(str, mesh.flat))}{fsdp}")
        mesh = ServingMesh(mesh.flat, position=mesh.position)
    if len(mesh) == 1:
        return (make_train_step(model, tcfg), lambda t: t, lambda t: t,
                f"one device, {mesh.devices[0]}")
    return (make_dp_train_step(model, tcfg, mesh), lambda t: t, lambda t: t,
            f"data parallel over {len(mesh)} devices {list(map(str, mesh.devices))}")


def train(
    arch: str,
    *,
    smoke: bool = True,
    steps: int = 50,
    batch: int = 8,
    seq: int = 128,
    lr: float = 3e-4,
    microbatches: int = 1,
    ckpt_dir: str | None = None,
    ckpt_every: int = 20,
    quantized: bool = True,
    log_every: int = 10,
    seed: int = 0,
    device=None,
    mesh: ServingMesh | DeviceMesh | None = None,
) -> dict:
    """Train ``arch`` for ``steps`` steps on ``train_mesh(device, mesh)``: one device, tensor parallelism over a ``DeviceMesh``'s model
    axis, or data parallelism over several devices with the params on the
    first (module docstring); one process a device where a process group
    runs, or ``WORLD_SIZE`` says one should (started here then, and ended
    when the run ends). Returns the (gathered) params, the losses and the
    last step's metrics."""
    started = "WORLD_SIZE" in os.environ and not pg.active()
    if started:
        pg.init_from_env(device=device)
    try:
        return _train(arch, smoke=smoke, steps=steps, batch=batch, seq=seq, lr=lr,
                      microbatches=microbatches, ckpt_dir=ckpt_dir,
                      ckpt_every=ckpt_every, quantized=quantized,
                      log_every=log_every, seed=seed, device=device, mesh=mesh)
    finally:
        if started:
            pg.destroy()


def _train(arch, *, smoke, steps, batch, seq, lr, microbatches, ckpt_dir, ckpt_every,
           quantized, log_every, seed, device, mesh) -> dict:
    cfg = smoke_config(arch) if smoke else get_config(arch)
    policy = train_policy() if quantized else float_policy()
    model = build_model(cfg, policy)
    mesh = train_mesh(device, mesh)
    dev = flat_devices(mesh)[getattr(mesh, "position", None) or 0]
    lead = not pg.active() or pg.rank() == 0

    dcfg = DataConfig(seed=seed, global_batch=batch, seq_len=seq,
                      vocab_size=cfg.vocab_size)
    data = Prefetcher(synthetic_lm_batches(dcfg))

    params = model.init(torch.Generator(dev).manual_seed(seed))
    opt_state = init_opt_state(params)
    tcfg = TrainConfig(
        adamw=AdamWConfig(lr=lr, weight_decay=0.01, latent_clip=quantized),
        microbatches=microbatches,
    )
    step_fn, lay_out, gather, layout = _layout(model, tcfg, mesh)
    if pg.active():
        layout += f"; one process a device, backend {pg.backend()}, {pg.world_size()} ranks"
    if lead:
        print(f"layout: {layout}", flush=True)

    start_step = 0
    writer = None
    if ckpt_dir:
        if lead:
            writer = ckpt.AsyncCheckpointer(ckpt_dir)
        latest = ckpt.latest_valid_step(ckpt_dir)
        if latest is not None:
            state = ckpt.restore(ckpt_dir, latest,
                                 {"params": params, "opt": opt_state})
            params, opt_state = state["params"], state["opt"]
            start_step = latest
            if lead:
                print(f"resumed from step {latest}")
    params, opt_state = lay_out(params), lay_out(opt_state)

    monitor = HeartbeatMonitor(num_hosts=1, timeout=3600.0)
    straggler = StragglerDetector()
    metrics = {}
    losses = []
    # A resumed run restarts the data stream at batch 0, as the JAX
    # launcher's zip does.
    for step, b in zip(range(start_step, steps), data):
        t0 = time.time()
        monitor.beat(0)
        monitor.check()
        batch_arrays = {"tokens": b["tokens"].to(dev), "labels": b["labels"].to(dev)}
        if cfg.input_kind == "embeddings":
            batch_arrays["input_embeds"] = stub_embeddings(
                b["tokens"], cfg.d_model).to(dev)
        params, opt_state, metrics = step_fn(params, opt_state, batch_arrays)
        dt = time.time() - t0
        straggler.observe({0: dt})
        losses.append(float(metrics["loss"]))
        if lead and (step % log_every == 0 or step == steps - 1):
            print(f"step {step:5d}  loss {float(metrics['loss']):.4f}  "
                  f"gnorm {float(metrics['grad_norm']):.3f}  {dt:.2f}s",
                  flush=True)
        if ckpt_dir and (step + 1) % ckpt_every == 0:
            full = {"params": gather(params), "opt": gather(opt_state)}
            if writer:
                writer.save(step + 1, full)
    if writer:
        writer.close()
    return {"params": gather(params), "losses": losses, "final_metrics": metrics}


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--float", dest="quantized", action="store_false")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    out = train(args.arch, smoke=args.smoke, steps=args.steps,
                batch=args.batch, seq=args.seq, lr=args.lr,
                microbatches=args.microbatches, ckpt_dir=args.ckpt_dir,
                quantized=args.quantized)
    first = np.mean(out["losses"][:5])
    last = np.mean(out["losses"][-5:])
    if int(os.environ.get("RANK", 0)) == 0:
        print(f"loss {first:.4f} -> {last:.4f}")


if __name__ == "__main__":
    main()
