"""The dry run, as ``repro.launch.dryrun``: every (architecture x input
shape) cell planned against the production mesh with NO hardware and NO
allocation (meta tensors end to end), on the CPU.

For each cell this prints and records:

  * ``memory_analysis`` — per-device bytes of the arguments (by the rule
    table's specs, ``distributed.sharding.shard_shape``), of the results,
    of the donated arguments, and the temporaries: the peak of live
    non-argument bytes while the step runs on meta at one data shard's
    batch (the batch divided by the data axes' size where it divides,
    else the whole batch). Activations, gradients and updated params stay
    whole over ``model`` (and params over ``data``) in that run, so
    ``temp_size_in_bytes`` is an upper bound.
  * ``roofline`` — ``roofline.analysis.Roofline.to_dict()``: the same
    meta run counted op by op (``roofline.op_cost``) and split over the
    model axis, and the collectives the rule table's layout implies (a
    train cell's backward and recompute included).

The JAX package lowers and compiles each cell for 512 placeholder
devices; the port has no partitioner, so it traces one data shard's step
and reckons the rest. A cell that raises is recorded as ``error``.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch smollm-360m \\
      --shape train_4k --mesh single
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both
"""

from __future__ import annotations

import argparse
import json
import math
import os
import time
import traceback
from typing import Optional

import torch

from repro_torch import tree
from repro_torch.configs import ASSIGNED
from repro_torch.configs.base import (SHAPES, cell_applicable, float_policy,
                                      get_config, serve_policy, train_policy)
from repro_torch.core.binarize import QuantMode
from repro_torch.distributed import sharding as shard_rules
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.model_factory import build_model
from repro_torch.roofline import analysis as roofline
from repro_torch.roofline import op_cost
from repro_torch.train.step import TrainConfig, init_opt_state, make_train_step

CACHE_DTYPES = {"bf16": torch.bfloat16, "int8": torch.int8,
                "f32": torch.float32}


def _policy_for(kind: str, name: str):
    if name == "float":
        return float_policy()
    if name == "auto":
        return train_policy() if kind == "train" else serve_policy()
    if name == "train":
        return train_policy()
    return serve_policy()


def build_cell(arch: str, shape_name: str, *, policy_name: str = "auto",
               train_cfg: Optional[TrainConfig] = None, cache_dtype=None,
               batch: Optional[int] = None):
    """Returns (step_fn, example_args, donate, model_flops, meta). Every
    tensor of ``example_args`` is on the ``meta`` device: building a cell
    allocates nothing. ``batch`` builds the state and inputs at another
    global batch than the shape's (one data shard's, in ``run_cell``)."""
    cache_dtype = cache_dtype or torch.bfloat16
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    policy = _policy_for(shape.kind, policy_name)
    model = build_model(cfg, policy)

    float_params = model.init()
    n_total = roofline.count_params(float_params)
    frac = (cfg.experts_per_token / cfg.num_experts
            if cfg.num_experts else None)
    n_active = roofline.count_params(float_params, active_moe_fraction=frac)
    model_flops = roofline.model_flops_for(cfg, shape, n_total, n_active)
    b = shape.global_batch if batch is None else batch
    inputs = model.input_specs(shape if batch is None else
                               type(shape)(shape.name, shape.seq_len, b, shape.kind))
    meta = {"n_params": n_total, "n_active": n_active, "cfg": cfg,
            "shape": shape}

    if shape.kind == "train":
        step = make_train_step(model, train_cfg or TrainConfig())
        opt = init_opt_state(float_params)
        return step, (float_params, opt, inputs), (0, 1), model_flops, meta

    packed = model.init_packed() if model.policy.packed else float_params
    state = model.init_state(b, shape.seq_len, dtype=cache_dtype, device="meta")
    if shape.kind == "prefill":
        def step(params, st, bt):
            return model.prefill(params, st, bt)
        return step, (packed, state, inputs), (1,), model_flops, meta

    def step(params, st, bt):
        return model.decode_step(params, st, bt)
    return step, (packed, state, inputs), (1,), model_flops, meta


def shardings_for(mesh, args, kind: str):
    """Spec trees of ``args`` by the rule table (the optimizer state
    mirrors the params). A spec is a tuple, so walk them beside ``args``
    (``tree.map_with_path``), not with ``tree.leaves``."""
    p, s_or_o, batch = args
    p_sh = shard_rules.params_shardings(mesh, p)
    b_sh = shard_rules.batch_shardings(mesh, batch)
    if kind == "train":
        o_sh = shard_rules.params_shardings(mesh, s_or_o)
        return (p_sh, o_sh, b_sh)
    st_sh = shard_rules.state_shardings(mesh, s_or_o)
    return (p_sh, st_sh, b_sh)


def _device_bytes(mesh, leaves_specs) -> int:
    """Bytes one device holds of ``(leaf, spec)`` pairs."""
    total = 0
    for leaf, spec in leaves_specs:
        if not isinstance(leaf, torch.Tensor):
            continue
        shard = shard_rules.shard_shape(mesh, leaf.shape, spec)
        total += math.prod(shard) * leaf.element_size()
    return total


def _pairs(arg, specs) -> list:
    """``(leaf, spec)`` of every leaf of ``arg``, ``specs`` its spec tree."""
    out: list = []
    tree.map_with_path(lambda _, leaf, spec: out.append((leaf, spec)), arg, specs)
    return out


def _data_shards(mesh, inputs) -> int:
    """Devices the batch is split over by ``batch_spec`` (1 if it does not
    divide)."""
    lead = tree.leaves(inputs)[0]
    spec = shard_rules.batch_spec(mesh, (), lead)
    return lead.shape[0] // shard_rules.shard_shape(mesh, lead.shape, spec)[0]


def _output_bytes(mesh, kind, args, in_sh, out, scale: int) -> int:
    """Per-device bytes of the step's results: a train step's new params
    and optimizer state laid out as its arguments, plus the metrics; a
    serving step's logits and state by the rule table at the cell's batch
    (``scale`` x the counted shard's)."""
    if kind == "train":
        metrics = sum(t.numel() * t.element_size()
                      for t in tree.leaves(out[2]) if isinstance(t, torch.Tensor))
        return (_device_bytes(mesh, _pairs(args[0], in_sh[0]))
                + _device_bytes(mesh, _pairs(args[1], in_sh[1])) + metrics)
    logits, state = out
    full_logits = torch.empty((logits.shape[0] * scale, *logits.shape[1:]),
                              dtype=logits.dtype, device="meta")
    total = _device_bytes(mesh, [(full_logits, shard_rules.batch_spec(
        mesh, (), full_logits))])
    in_state = dict(tree.leaves_with_path(args[1]))
    for path, leaf in tree.leaves_with_path(state):
        if not isinstance(leaf, torch.Tensor):
            continue
        if path in in_state:   # the state the step was given, updated
            full = in_state[path]
        else:                  # new in the state (the encoder's memory)
            full = torch.empty((leaf.shape[0] * scale, *leaf.shape[1:]),
                               dtype=leaf.dtype, device="meta")
        total += _device_bytes(mesh, [(full, shard_rules.state_spec(mesh, path, full))])
    return total


def run_cell(arch: str, shape_name: str, mesh_name: str, *,
             policy_name: str = "auto", out_dir: Optional[str] = None,
             train_cfg: Optional[TrainConfig] = None, verbose: bool = True,
             tag: str = "", cache_dtype=None):
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    ok, reason = cell_applicable(cfg, shape)
    result = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
              "policy": policy_name, "tag": tag}
    if not ok:
        result.update(status="skipped", reason=reason)
        _emit(result, out_dir, verbose)
        return result

    mesh = make_production_mesh(multi_pod=mesh_name == "multi")
    t0 = time.time()
    try:
        step, args, donate, model_flops, _ = build_cell(
            arch, shape_name, policy_name=policy_name, train_cfg=train_cfg,
            cache_dtype=cache_dtype)
        shards = _data_shards(mesh, args[2])
        shard_args = args
        if shards > 1:
            _, shard_args, _, _, _ = build_cell(
                arch, shape_name, policy_name=policy_name, train_cfg=train_cfg,
                cache_dtype=cache_dtype, batch=shape.global_batch // shards)
            shard_args = (args[0], args[1] if shape.kind == "train"
                          else shard_args[1], shard_args[2])
        t_build = time.time() - t0
        with op_cost.count() as counted:
            out = step(*shard_args)
        t_trace = time.time() - t0 - t_build

        in_sh = shardings_for(mesh, args, shape.kind)

        def arg_bytes(indices) -> int:
            return _device_bytes(mesh, [p for i in indices
                                        for p in _pairs(args[i], in_sh[i])])

        mem_stats = {
            "argument_size_in_bytes": arg_bytes(range(len(args))),
            "output_size_in_bytes": _output_bytes(mesh, shape.kind, args, in_sh,
                                                  out, shards),
            "temp_size_in_bytes": int(counted.peak_bytes),
            "alias_size_in_bytes": arg_bytes(donate),
        }
        collectives = op_cost.collective_bytes(
            mesh, args, shape.kind, act_bytes=torch.tensor(
                [], dtype=cfg.dtype).element_size())
        policy = _policy_for(shape.kind, policy_name)
        collectives_bwd = op_cost.collective_bytes_bwd(
            mesh, args, shape.kind, cfg, alpha=(
                policy.enabled and policy.mode == QuantMode.FAKE_QUANT
                and policy.use_scale))
        rf = roofline.from_counted(
            counted, arch=arch, shape=shape_name, mesh_name=mesh_name,
            chips=mesh.size, model_shards=mesh.shape["model"],
            model_flops=model_flops, collectives=collectives,
            collectives_bwd=collectives_bwd,
            memory_stats={"temp_bytes": mem_stats["temp_size_in_bytes"]})
        result.update(
            status="ok",
            build_s=round(t_build, 1),
            trace_s=round(t_trace, 1),
            data_shards=shards,
            memory_analysis=mem_stats,
            roofline=rf.to_dict(),
        )
    except Exception as e:  # a failing cell is a bug — record it loudly
        result.update(status="error", error=f"{type(e).__name__}: {e}",
                      traceback=traceback.format_exc()[-2000:])
    _emit(result, out_dir, verbose)
    return result


def _emit(result: dict, out_dir: Optional[str], verbose: bool):
    if verbose:
        status = result["status"]
        line = f"[{status:7s}] {result['arch']:24s} {result['shape']:12s} " \
               f"{result['mesh']}"
        if status == "ok":
            rf = result["roofline"]
            line += (f"  compute={rf['compute_s']:.4f}s"
                     f" memory={rf['memory_s']:.4f}s"
                     f" coll={rf['collective_s']:.4f}s"
                     f" bottleneck={rf['bottleneck']}"
                     f" (trace {result['trace_s']}s)")
        elif status == "skipped":
            line += f"  ({result['reason']})"
        else:
            line += f"  {result['error']}"
        print(line, flush=True)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        tag = result.get("tag") or ""
        suffix = f"_{tag}" if tag else ""
        fname = (f"{result['arch']}_{result['shape']}_{result['mesh']}"
                 f"{suffix}.json")
        with open(os.path.join(out_dir, fname), "w") as f:
            json.dump(result, f, indent=1)


def render_table(results: list) -> str:
    """The ``ok`` cells in ``benchmarks/roofline_table.py``'s columns."""
    rows = ["| arch | shape | mesh | status | compute_s | memory_s | "
            "collective_s | bottleneck | roofline MFU | notes |",
            "|---|---|---|---|---|---|---|---|---|---|"]
    for c in results:
        if c["status"] != "ok":
            continue
        r = c["roofline"]
        rows.append(
            f"| {c['arch']} | {c['shape']} | {c['mesh']} | ok "
            f"| {r['compute_s']:.4f} | {r['memory_s']:.4f} "
            f"| {r['collective_s']:.4f} | {r['bottleneck']} "
            f"| {r['mfu']:.3f} | useful={r['useful_flops_fraction']:.2f} |")
    return "\n".join(rows)


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ASSIGNED)
    ap.add_argument("--shape", choices=sorted(SHAPES))
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="single")
    ap.add_argument("--policy", choices=["auto", "float", "train", "packed"],
                    default="auto")
    ap.add_argument("--all", action="store_true",
                    help="run every (arch x shape) cell")
    ap.add_argument("--out", default="build/dryrun")
    ap.add_argument("--tag", default="", help="suffix for output JSONs")
    ap.add_argument("--cache-dtype", default="bf16",
                    choices=["bf16", "int8", "f32"],
                    help="KV-cache storage dtype (int8 = quantized cache)")
    ap.add_argument("--microbatches", type=int, default=1,
                    help="gradient-accumulation microbatches (train cells)")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    cache_dtype = CACHE_DTYPES[args.cache_dtype]
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    if args.all:
        cells = [(a, s) for a in ASSIGNED for s in SHAPES]
    else:
        if not (args.arch and args.shape):
            raise SystemExit("--arch/--shape or --all")
        cells = [(args.arch, args.shape)]

    t0 = time.time()
    results = []
    for mesh_name in meshes:
        for arch, shape_name in cells:
            tc = (TrainConfig(microbatches=args.microbatches)
                  if args.microbatches > 1 else None)
            results.append(run_cell(arch, shape_name, mesh_name,
                                    policy_name=args.policy, out_dir=args.out,
                                    tag=args.tag, cache_dtype=cache_dtype,
                                    train_cfg=tc))
    failures = sum(r["status"] == "error" for r in results)
    if args.all:
        print(render_table(results))
    counts = {s: sum(r["status"] == s for r in results)
              for s in ("ok", "skipped", "error")}
    print(f"done; {counts['ok']} ok / {counts['skipped']} skipped / "
          f"{failures} failures in {time.time() - t0:.1f} s")
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()
