"""Train and serve step factories, as ``repro.train.step``.

``make_train_step(model, tcfg)`` returns ``(params, opt_state, batch) ->
(params, opt_state, metrics)``: the loss gradient by
``torch.autograd.grad``, global-norm clip, AdamW with the latent clip
of the leaves ``clip_predicate`` selects, and optional gradient
accumulation over microbatches, taken in order and summed from zeros
as the JAX package's scan does. The model's own metrics (accuracy, BN
batch statistics, ...) ride along in ``metrics``, averaged over
microbatches, so the BNN trainer keeps running BatchNorm statistics
without a second forward.

The schedule takes the POST-increment optimizer step (``count + 1``):
``cosine_schedule(0)`` is 0.0 during warm-up, so the pre-increment count
would make the first update a no-op (with microbatches, a whole
accumulated batch).

A leaf the loss does not reach (a BatchNorm ``mean``/``var`` buffer in
training mode) gets a zero gradient, as ``jax.grad`` gives it, so
Adam's moments and the global norm see the JAX package's tree.

``make_dp_train_step(model, tcfg, mesh)`` is the same step over a 1-D
``"data"`` mesh (``launch.mesh.ServingMesh``): data parallelism from one
process, each replica's gradient on its batch shard summed in mesh order
(``dp_shards``, ``dp_mesh_mean``, which the BNN trainer's
compressed DP step shares).

``make_tp_train_step(model, tcfg, mesh)`` is the step over a ``("data",
"model")`` mesh (``launch.mesh.DeviceMesh``): tensor parallelism over the
model axis inside each data shard for every family, and fully sharded
data parallelism over the data axis: the params and optimizer state laid
out by the whole rule table (``distributed.sharding.shard_params``), a
leaf split over data gathered where it is used.

Each multi-device step runs one of two ways. In lockstep one process
drives every device of the mesh and runs each shard's part in turn. Where
the mesh runs one process a device (its ``position`` set by
``distributed.process_group.bind``: SPMD, as the JAX package's sharded
steps run) each process computes its own position's part alone and its
reductions gather the other processes' parts over ``torch.distributed``
(``process_group.everyone``), then sum them in the lockstep order: every
param, optimizer leaf and metric is the lockstep step's bit for bit. The
MoE configs' whole-batch balance loss needs a gradient back through a
cross-process gather, which the port does not have yet (ROADMAP A5b step
6): their steps raise ``NotImplementedError`` under a process group.

``make_prefill`` / ``make_decode_step`` wrap ``Model.prefill`` /
``Model.decode_step``.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch import tree
from repro_torch.distributed import compression, sharding
from repro_torch.distributed import process_group as pg
from repro_torch.distributed import tensor_parallel as tp
from repro_torch.distributed.sharding import shard_rows
from repro_torch.models import ffn
from repro_torch.models.transformer import AUX_WEIGHT
from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update
from repro_torch.optim.clip import clip_by_global_norm
from repro_torch.optim.schedules import cosine_schedule


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    adamw: AdamWConfig = AdamWConfig(lr=3e-4, weight_decay=0.01, latent_clip=True)
    clip_norm: float = 1.0
    microbatches: int = 1          # >1 => gradient accumulation
    warmup_steps: int = 100
    total_steps: int = 10_000


def _keystr(path: tuple) -> str:
    return "".join(f"[{k!r}]" for k in path)


def _split_microbatches(batch, microbatches: int):
    """Reshape every leaf ``[B, ...] -> [microbatches, B / microbatches,
    ...]``.

    Raises an actionable ValueError where a plain split would fail
    cryptically, or silently mis-split a leaf whose leading dim differs
    from the batch size."""
    leaves = list(tree.leaves_with_path(batch))
    if not leaves:
        raise ValueError("empty batch")
    sizes = {_keystr(path): np.shape(leaf)[0] if np.ndim(leaf) else None
             for path, leaf in leaves}
    dims = set(sizes.values())
    if None in dims or len(dims) != 1:
        raise ValueError(
            f"gradient accumulation needs every batch leaf to share one "
            f"leading batch dim; got leading dims {sizes} (drop scalar "
            f"bookkeeping keys like 'step' before the train step)")
    (bsz,) = dims
    if bsz % microbatches != 0:
        raise ValueError(
            f"batch size {bsz} is not divisible by "
            f"tcfg.microbatches={microbatches}; pick a batch size that "
            f"is a multiple of the microbatch count")
    return tree.tree_map(
        lambda t: t.reshape(microbatches, bsz // microbatches, *t.shape[1:]),
        batch)


def _grads_of(model, params, batch):
    """(loss, metrics, grads): ``model.loss`` and its gradient with
    respect to every leaf of ``params``, zeros where it does not reach.
    Loss and metrics come back detached."""
    live = tree.tree_map(lambda p: p.detach().requires_grad_(True), params)
    flat = tree.leaves(live)
    with torch.enable_grad():
        loss, metrics = model.loss(live, batch)
        grads = torch.autograd.grad(loss, flat, allow_unused=True)
    grads = iter([torch.zeros_like(p) if g is None else g
                  for p, g in zip(flat, grads)])
    return (loss.detach(), tree.tree_map(torch.Tensor.detach, metrics),
            tree.tree_map(lambda _: next(grads), live))


def _accumulated_grads(grads_of: Callable, params, batch, microbatches: int):
    """(loss, metrics, grads) of ``batch`` by ``grads_of(params, batch)``,
    over ``microbatches`` of it taken in order and summed from zeros where
    there is more than one (a None gradient, a block a data row does not
    read, stays None)."""
    if microbatches <= 1:
        return grads_of(params, batch)
    gsum = None
    losses, mmetrics = [], []
    mbs = _split_microbatches(batch, microbatches)
    for i in range(microbatches):
        mb = tree.tree_map(lambda t, i=i: t[i], mbs)
        loss, metrics, grads = grads_of(params, mb)
        if gsum is None:
            gsum = tree.tree_map(lambda g: None if g is None else torch.zeros_like(g),
                                 grads)
        gsum = tree.tree_map(_add, gsum, grads)
        losses.append(loss)
        mmetrics.append(metrics)
    grads = tree.tree_map(lambda g: None if g is None else g / microbatches, gsum)
    loss = torch.mean(torch.stack(losses))
    model_metrics = tree.tree_map(
        lambda *ms: torch.mean(torch.stack(ms), dim=0), *mmetrics)
    return loss, model_metrics, grads


def _apply_update(tcfg: TrainConfig, params, opt_state, grads, clip_predicate):
    """One global-norm clip, the schedule on the post-increment count
    (``cosine_schedule(0)`` is 0.0) and one AdamW update: (new params, new
    optimizer state, grad norm, lr scale)."""
    grads, gnorm = clip_by_global_norm(grads, tcfg.clip_norm)
    step = opt_state["adam"]["count"] + 1
    lr_scale = cosine_schedule(step, warmup_steps=tcfg.warmup_steps,
                               total_steps=tcfg.total_steps)
    new_params, new_adam = adamw_update(
        grads, opt_state["adam"], params, tcfg.adamw, lr_scale=lr_scale,
        clip_predicate=clip_predicate)
    return new_params, {"adam": new_adam}, gnorm, lr_scale


def make_train_step(model, tcfg: TrainConfig,
                    clip_predicate: Optional[Callable] = None):
    def train_step(params, opt_state, batch):
        loss, model_metrics, grads = _accumulated_grads(
            functools.partial(_grads_of, model), params, batch, tcfg.microbatches)
        new_params, new_opt, gnorm, lr_scale = _apply_update(
            tcfg, params, opt_state, grads, clip_predicate)
        metrics = {**model_metrics, "loss": loss, "grad_norm": gnorm,
                   "lr_scale": lr_scale}
        return new_params, new_opt, metrics

    return train_step


# ---------------------------------------------------------------------------
# Data parallelism over a 1-D mesh, from one process.
# ---------------------------------------------------------------------------


def spmd(mesh) -> bool:
    """Whether ``mesh`` runs one process a device (its ``position`` set):
    ``ValueError`` where it does and no process group runs."""
    if getattr(mesh, "position", None) is None:
        return False
    if not pg.active():
        raise ValueError("a mesh bound to a process position, and no process group")
    return True


def _no_moe_spmd(model) -> None:
    if model.cfg.num_experts:
        raise NotImplementedError(
            "an MoE config's balance loss is formed from the router terms of the "
            "whole batch, which needs a gradient back through a cross-process "
            "gather: one process a device trains the MoE stacks from ROADMAP A5b "
            "step 6 on; run it in lockstep from one process until then")


def dp_shards(fn: Callable, params, batch, devices, only: Optional[int] = None) -> list:
    """``fn(params, shard)`` of each replica, in mesh order: replica ``i``
    on ``devices[i]`` with its contiguous batch shard
    (``distributed.sharding.shard_rows``). The params are copied once to
    each device they are not on; replicas on one device share them. With
    ``only`` (one process a device) replica ``only`` alone, a list of one."""
    home = tree.leaves(params)[0].device
    rows = shard_rows(int(tree.leaves(batch)[0].shape[0]), len(devices))
    replicas: dict = {home: params}
    outs = []
    for i, dev in enumerate(devices):
        if only is not None and i != only:
            continue
        if dev not in replicas:
            replicas[dev] = tree.tree_map(lambda t: t.to(dev), params)
        shard = tree.tree_map(lambda t: t[i * rows:(i + 1) * rows].to(dev), batch)
        outs.append(fn(replicas[dev], shard))
    return outs


def dp_mesh_mean(xs, home: torch.device) -> torch.Tensor:
    """The replicas' tensors summed in mesh order on the first one's device
    (``compression._mesh_sum``), divided by their count, moved to
    ``home``: the JAX package's ``pmean``. Under a process group a
    process's one tensor is gathered over the data group first."""
    xs = pg.everyone(xs, pg.DATA)
    return (compression._mesh_sum(xs) / len(xs)).to(home)


def _whole_batch_loss(ces, terms, home) -> tuple:
    """(loss, cross-entropy, balance loss) of the whole batch from its
    shards' cross-entropies ``ces`` and router terms ``terms`` (one list a
    shard, ``models.ffn.balance_terms``): the mean of the shards'
    cross-entropies, and each MoE layer's balance loss formed from its
    router terms averaged over the shards, all in mesh order on ``home``."""
    aux = sum(ffn.balance_loss(dp_mesh_mean(mes, home), dp_mesh_mean(cs, home))
              for mes, cs in (zip(*layer) for layer in zip(*terms)))
    ce = dp_mesh_mean(ces, home)
    return ce + AUX_WEIGHT * aux, ce, aux


def _whole_batch_moe_grads(model, params, batch, devices) -> tuple:
    """(loss, metrics, grads) of an MoE model's loss on the whole batch,
    each contiguous shard's forward on its replica's device: the
    cross-entropy is the mean of the shards', and each MoE layer's balance
    loss is formed from its router terms averaged over the shards
    (``models.ffn.balance_terms``), which are the whole batch's, so the
    loss is the single-device loss of the whole batch. One backward
    through every shard's graph, autograd adding the replicas' gradients
    onto the params."""
    home = tree.leaves(params)[0].device
    live = tree.tree_map(lambda t: t.detach().requires_grad_(True), params)

    def shard_loss(replica, shard):
        with ffn.balance_terms() as terms:
            _, metrics = model.loss(replica, shard)
        return metrics["loss"], terms

    with torch.enable_grad():
        ces, terms = zip(*dp_shards(shard_loss, live, batch, devices))
        loss, ce, aux = _whole_batch_loss(ces, terms, home)
        flat = tree.leaves(live)
        got = torch.autograd.grad(loss, flat, allow_unused=True)
    grads = iter([torch.zeros_like(p) if g is None else g
                  for p, g in zip(flat, got)])
    return (loss.detach(), {"loss": ce.detach(), "aux": aux.detach()},
            tree.tree_map(lambda _: next(grads), params))


def make_dp_train_step(model, tcfg: TrainConfig, mesh,
                       clip_predicate: Optional[Callable] = None):
    """:func:`make_train_step` over ``mesh``'s devices (a 1-D
    ``launch.mesh.ServingMesh``): ``(params, opt_state, batch) -> (params,
    opt_state, metrics)``, params and optimizer state on one device and the
    results back there.

    The batch splits into ``len(mesh)`` contiguous shards; replica ``i``
    takes the gradient of ``model.loss`` on shard ``i`` on
    ``mesh.devices[i]`` (``tcfg.microbatches`` splitting each shard).
    The gradients are summed in mesh order on the first replica's device
    and divided by n, then one global-norm clip, one schedule step and one
    AdamW update, as the single-device step. ``loss`` and the model's
    metrics are the replicas' means in mesh order. With equal shards the
    token-mean loss of the whole batch is the mean of the shards', so the
    loss and the reduced gradients equal the single-device step's on the
    whole batch up to the order of float sums.

    An MoE config's balance loss is nonlinear in the batch (a product of
    two means over every token), so the mean of the shards' losses is not
    the whole batch's: on more than one replica its step forms the loss
    from the router terms averaged over the shards
    (:func:`_whole_batch_moe_grads`), the whole batch's loss, and takes its
    gradient in one backward. With ``tcfg.microbatches > 1`` the whole
    batch splits into microbatches first, as the single-device step
    splits it, and each microbatch's whole loss is taken over the
    replicas, its balance loss over that microbatch's rows.

    Where ``mesh`` runs one process a device (SPMD) a process takes the
    gradient of its own shard, gathers every shard's gradient tree over
    the world and averages it as above, on its own device; params and
    optimizer state are whole on every process. MoE configs raise there
    (ROADMAP A5b step 6)."""
    devices = tuple(mesh.devices)
    n = len(devices)
    moe = n > 1 and bool(model.cfg.num_experts)
    own = mesh.position if spmd(mesh) else None
    if own is not None:
        _no_moe_spmd(model)

    def grads_of(params, shard):
        return _accumulated_grads(functools.partial(_grads_of, model), params,
                                  shard, tcfg.microbatches)

    def whole_batch_grads(params, batch):
        return _whole_batch_moe_grads(model, params, batch, devices)

    def train_step(params, opt_state, batch):
        home = tree.leaves(params)[0].device
        if moe:
            loss, model_metrics, grads = _accumulated_grads(
                whole_batch_grads, params, batch, tcfg.microbatches)
        else:
            losses, shard_metrics, shard_grads = zip(*dp_shards(
                grads_of, params, batch, devices, own))
            if own is not None:
                shard_grads = pg.gather_tree(shard_grads[0], pg.DATA)
            means = iter([dp_mesh_mean(gs, home)
                          for gs in zip(*map(tree.leaves, shard_grads))])
            grads = tree.tree_map(lambda _: next(means), params)
            loss = dp_mesh_mean(losses, home)
            model_metrics = tree.tree_map(lambda *ms: dp_mesh_mean(ms, home),
                                          *shard_metrics)
        new_params, new_opt, gnorm, lr_scale = _apply_update(
            tcfg, params, opt_state, grads, clip_predicate)
        metrics = {**model_metrics, "loss": loss, "grad_norm": gnorm,
                   "lr_scale": lr_scale}
        return new_params, new_opt, metrics

    return train_step


# ---------------------------------------------------------------------------
# Tensor parallelism over the model axis, fully sharded data parallelism
# over the data axis, from one process.
# ---------------------------------------------------------------------------


def _add(a, b):
    """``a + b`` of two gradients, None standing for zeros."""
    return b if a is None else a if b is None else a + b


def _sum_replicated(grads: list, specs) -> list:
    """The ranks' gradient trees with every leaf the ranks hold whole (the
    norms and the biases each rank applies to its copy of the residual
    stream) replaced by the sum of the ranks' shares in rank order
    (``compression._mesh_sum``), on every rank; leaves split over the
    model axis are left as they are. Under a process group ``grads`` is
    this process's one tree: the other ranks' shares are gathered over the
    model group (one collective for every such leaf)."""
    leaves = [tree.leaves(g) for g in grads]
    whole = [i for i, (path, _) in enumerate(tree.leaves_with_path(grads[0]))
             if sharding.MODEL_AXIS not in sharding.spec_at(specs, path)]
    if pg.active():
        ranks = pg.gather_tree([leaves[0][i] for i in whole], pg.MODEL)
        shares = {i: [rk[k] for rk in ranks] for k, i in enumerate(whole)}
    else:
        shares = {i: [lv[i] for lv in leaves] for i in whole}
    for i, parts in shares.items():
        total = compression._mesh_sum(parts)
        for lv in leaves:
            lv[i] = total.to(lv[i].device)
    return [tree.tree_map(lambda _, it=iter(lv): next(it), g)
            for g, lv in zip(grads, leaves)]


def _live_grid(grid: list) -> list:
    """Every device's tree (``grid[k][r]``: data row ``k``, model rank
    ``r``) as fresh leaves that require grad, sharing the storage."""
    return [[tree.tree_map(lambda t: t.detach().requires_grad_(True), t) for t in row]
            for row in grid]


def _grid_grads(grid: list, got, specs, row: int) -> list:
    """``torch.autograd.grad``'s results for the leaves of ``grid`` (every
    device's tree, flattened device by device) as one tree a device, in
    mesh order: zeros where data row ``row`` reads a block and no gradient
    reached it (every block of a leaf split over the data axes, the row's
    own copy of any other), None where the row does not read it."""
    got = iter(got)

    def grad(path, p, k):
        g = next(got)
        reads = k == row or sharding.data_dim(sharding.spec_at(specs, path)) is not None
        return torch.zeros_like(p) if g is None and reads else g

    return [tree.map_with_path(lambda path, p, k=k: grad(path, p, k), t)
            for k, trees in enumerate(grid) for t in trees]


def _reduce_over_rows(row_grads: list, shards, mean: bool) -> list:
    """The data rows' gradients (``row_grads[d]``: one tree a device,
    :func:`_grid_grads`) reduced over the rows, one tree a device: for a
    leaf split over the data axes each device's block is the sum of the
    rows' gradients of that block; for any other leaf the sum of the
    rows' gradients of their own copies, on every row. Sums in mesh order
    (``compression._mesh_sum``), divided by the rows with ``mean``
    (``dp_mesh_mean``: each row's gradient is of its own shard's loss).
    Over more than one row, counted as the reckoning counts it
    (``roofline.op_cost.collective_bytes``): an all-reduce of each rank's
    gathered gradient over the rows, site ``"data grads"``.

    Under a process group ``row_grads`` is this process's row with its one
    tree: a block of a leaf split over the data axes already holds the sum
    over the rows (``tensor_parallel._DataGather``'s backward), and any
    other leaf's row copies are gathered over the data group (one
    collective) and summed in row order; a list of one tree."""
    m = sharding.model_axis_size(shards.mesh)
    rows = sharding.data_axis_size(shards.mesh)
    flat = [[tree.leaves(t) for t in g] for g in row_grads]
    if pg.active():
        return [_reduce_own_over_rows(flat[0][0], shards, rows, mean)]
    out: list = [[] for _ in shards]
    for j, (path, leaf) in enumerate(tree.leaves_with_path(shards[0])):
        split = sharding.data_dim(sharding.spec_at(shards.specs, path)) is not None
        for r in range(m):
            if split:
                totals = [compression._mesh_sum([flat[d][k * m + r][j] for d in range(rows)])
                          for k in range(rows)]
            else:
                totals = [compression._mesh_sum(
                    [flat[d][d * m + r][j] for d in range(rows)])] * rows
            for k in range(rows):
                g = totals[k] / rows if mean else totals[k]
                out[k * m + r].append(g.to(tree.leaves(shards[k * m + r])[j].device))
            if rows > 1:
                tp.add_bytes("all-reduce", "data grads", "bwd",
                             (rows if split else 1) * leaf.numel() * leaf.element_size(),
                             rows)
    return [tree.tree_map(lambda _, it=iter(g): next(it), t) for t, g in zip(shards, out)]


def _reduce_own_over_rows(own: list, shards, rows: int, mean: bool):
    """:func:`_reduce_over_rows` of one process's leaves ``own`` (its
    row's gradient of its blocks), as its one tree."""
    split = [sharding.data_dim(sharding.spec_at(shards.specs, path)) is not None
             for path, _ in tree.leaves_with_path(shards[0])]
    keep = [j for j, s in enumerate(split) if not s]
    copies = pg.gather_tree([own[j] for j in keep], pg.DATA)
    totals = {j: compression._mesh_sum([c[k] for c in copies]) for k, j in enumerate(keep)}
    out = []
    for j, (leaf, s) in enumerate(zip(tree.leaves(shards[0]), split)):
        g = totals.get(j, own[j])
        out.append(g / rows if mean else g)
        if rows > 1:
            tp.add_bytes("all-reduce", "data grads", "bwd",
                         (rows if s else 1) * leaf.numel() * leaf.element_size(), rows)
    it = iter(out)
    return tree.tree_map(lambda _: next(it), shards[0])


def _whole_batch_moe_tp_grads(loss_of, grid: list, batch, specs) -> tuple:
    """(loss, metrics, grads) of an MoE model's loss on the whole batch
    over a mesh's data rows (``grid``: one tree a device, a list a row):
    row ``d``'s ranks take its contiguous shard in lockstep
    (``loss_of(live, d, shard)``), the cross-entropy is the mean of the
    rows', and each MoE layer's balance loss is formed from its router
    terms (each row's, rank 0's: the loss counts them once) averaged over
    the rows (:func:`_whole_batch_loss`), as :func:`_whole_batch_moe_grads`
    forms it over replicas. Each row reads its own live leaves of every
    block, so one backward gives each row's gradients apart
    (:func:`_grid_grads`, one list a row), which the step sums over the
    rows in mesh order."""
    home = tree.leaves(grid[0][0])[0].device
    rows = len(grid)
    per_row = shard_rows(int(tree.leaves(batch)[0].shape[0]), rows)
    lives, ces, terms = [], [], []
    with torch.enable_grad():
        for d in range(rows):
            live = _live_grid(grid)
            shard = {k: v[d * per_row:(d + 1) * per_row] for k, v in batch.items()}
            with ffn.balance_terms() as row_terms:
                _, metrics = loss_of(live, d, shard)
            lives.append(live)
            ces.append(metrics["loss"])
            terms.append(row_terms)
        loss, ce, aux = _whole_batch_loss(ces, terms, home)
        flats = [[leaf for row in live for t in row for leaf in tree.leaves(t)]
                 for live in lives]
        got = torch.autograd.grad(loss, [leaf for f in flats for leaf in f],
                                  allow_unused=True)
    grads, at = [], 0
    for d, f in enumerate(flats):
        grads.append(_grid_grads(grid, got[at:at + len(f)], specs, d))
        at += len(f)
    return loss.detach(), {"loss": ce.detach(), "aux": aux.detach()}, grads


def make_tp_train_step(model, tcfg: TrainConfig, mesh,
                       clip_predicate: Optional[Callable] = None):
    """:func:`make_train_step` over a ``("data", "model")`` mesh
    (``launch.mesh.DeviceMesh``; ``("pod", "data", "model")`` too):
    ``(params, opt_state, batch) -> (params, opt_state, metrics)`` with
    ``params`` and ``opt_state`` laid out by
    ``distributed.sharding.shard_params`` (one tree a device, each leaf
    its device's block by the rule table, over the data axes and the model
    axis), and returned so: no device holds a whole model slice between
    steps.

    The batch splits into contiguous shards over the mesh's data rows.
    Each row's model ranks take the gradient of ``model.loss`` on its
    shard in lockstep (``models.transformer``, ``models.encdec``: column-
    and row-parallel projections, local attention and xLSTM heads, mamba's
    local channels, a vocab-parallel embedding and loss), under
    ``activation_mesh(mesh)``, ``tcfg.microbatches`` splitting the shard.
    Over several data rows the params reach the model as a
    ``tensor_parallel.ShardedTree``: a leaf split over the data axes is
    gathered onto the row's ranks where it is used, a period at a time
    (``tensor_parallel.gathered``), and its gradient flows back to every
    block. The rows' gradients are then summed in mesh order and divided
    by the rows, each device keeping its block (:func:`_reduce_over_rows`),
    and a leaf every rank holds whole sums its ranks' shares. Then one clip
    by the global norm of the whole tree (``optim.clip``: every block
    once), and on each device's own blocks one schedule step and one AdamW
    update. Up to the order of float sums this is the single-device step
    on the whole batch.

    An MoE config's balance loss is a product of two means over every
    token, so with more than one data row its step forms the loss from the
    router terms averaged over the rows (:func:`_whole_batch_moe_tp_grads`)
    and takes one backward, as :func:`make_dp_train_step` does over its
    replicas; with ``tcfg.microbatches > 1`` the whole batch splits into
    microbatches first, each one's balance loss over its own rows.

    Every family takes this step: attention with dense or MoE FFNs, mamba
    on each rank's channels, the mLSTM and the sLSTM on each rank's heads,
    and the encoder-decoder with its cross-attention (``models.encdec``).
    Collective bytes count in ``tensor_parallel.BYTES`` as the mean over
    the mesh's devices (``tensor_parallel.counted_over``).

    Where ``mesh`` runs one process a device (SPMD) a process holds its own
    device's blocks (``shard_params`` of the bound mesh), takes its data
    row's shard of the batch, computes its model rank's part, and its
    collectives go over its row's model group and its column's data group;
    every param, Adam leaf and metric is the lockstep step's bit for bit
    (module docstring; with microbatches a leaf split over data sums the
    rows within each microbatch first). MoE configs raise there (ROADMAP
    A5b step 6)."""
    ranks = sharding.model_axis_size(mesh)
    rows = sharding.data_axis_size(mesh)
    moe = rows > 1 and bool(model.cfg.num_experts)
    per_process = spmd(mesh)
    if per_process:
        _no_moe_spmd(model)

    def loss_of(live, d: int, shard: dict, specs):
        devs = [tree.leaves(t)[0].device for t in live[d]]
        ranked = {k: tp.Ranked.replicated(v.to(devs[0]), devs) for k, v in shard.items()}
        params = (tp.RankedTree(live[0], specs) if rows == 1
                  else tp.ShardedTree(live, specs, d))
        return model.loss(params, ranked)

    def row_grads(grid, d: int, shard: dict, specs):
        live = _live_grid(grid)
        flat = [leaf for row in live for t in row for leaf in tree.leaves(t)]
        with torch.enable_grad():
            loss, metrics = loss_of(live, d, shard, specs)
            got = torch.autograd.grad(loss, flat, allow_unused=True)
        return (loss.detach(), tree.tree_map(torch.Tensor.detach, metrics),
                _grid_grads(grid, got, specs, d))

    def train_step(params, opt_state, batch):
        grid, specs = params.rows(), params.specs
        home = tree.leaves(params[0])[0].device
        with sharding.activation_mesh(mesh), tp.counted_over(len(params)):
            if moe:
                loss, model_metrics, per_row = _accumulated_grads(
                    lambda _, mb: _whole_batch_moe_tp_grads(
                        lambda live, d, shard: loss_of(live, d, shard, specs),
                        grid, mb, specs),
                    None, batch, tcfg.microbatches)
                grads = _reduce_over_rows(per_row, params, mean=False)
            else:
                per_row = shard_rows(int(tree.leaves(batch)[0].shape[0]), rows)
                held = [pg.index(pg.DATA)] if per_process else range(rows)
                outs = [_accumulated_grads(
                    lambda _, mb, i=i: row_grads(grid, i, mb, specs), None,
                    tree.tree_map(lambda t, d=d: t[d * per_row:(d + 1) * per_row], batch),
                    tcfg.microbatches) for i, d in enumerate(held)]
                losses, row_metrics, per_row_grads = zip(*outs)
                grads = _reduce_over_rows(list(per_row_grads), params, mean=True)
                loss = dp_mesh_mean(losses, home)
                model_metrics = tree.tree_map(lambda *ms: dp_mesh_mean(ms, home),
                                              *row_metrics)
        grads = (_sum_replicated(grads, specs) if per_process else
                 [g for k in range(rows)
                  for g in _sum_replicated(grads[k * ranks:(k + 1) * ranks], specs)])
        grads, gnorm = clip_by_global_norm(sharding.Shards(grads, specs, mesh),
                                           tcfg.clip_norm)
        new_params, new_opt, lr_scales = [], [], []
        for p, o, g in zip(params, opt_state, grads):
            lr_scales.append(cosine_schedule(o["adam"]["count"] + 1,
                                             warmup_steps=tcfg.warmup_steps,
                                             total_steps=tcfg.total_steps))
            new_p, new_adam = adamw_update(g, o["adam"], p, tcfg.adamw,
                                           lr_scale=lr_scales[-1],
                                           clip_predicate=clip_predicate)
            new_params.append(new_p)
            new_opt.append({"adam": new_adam})
        metrics = {**model_metrics, "loss": loss, "grad_norm": gnorm,
                   "lr_scale": lr_scales[0]}
        return (sharding.Shards(new_params, specs, mesh),
                sharding.Shards(new_opt, opt_state.specs, mesh), metrics)

    return train_step


def init_opt_state(params) -> dict:
    return {"adam": adamw_init(params)}


def make_prefill(model):
    def prefill_step(params, state, batch):
        return model.prefill(params, state, batch)

    return prefill_step


def make_decode_step(model):
    def decode_step(params, state, batch):
        return model.decode_step(params, state, batch)

    return decode_step
