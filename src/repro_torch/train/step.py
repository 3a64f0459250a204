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
model axis inside each data shard for every family, the params and
optimizer state laid out by the rule table
(``distributed.sharding.shard_params``).

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
    there is more than one."""
    if microbatches <= 1:
        return grads_of(params, batch)
    gsum = tree.tree_map(torch.zeros_like, params)
    losses, mmetrics = [], []
    mbs = _split_microbatches(batch, microbatches)
    for i in range(microbatches):
        mb = tree.tree_map(lambda t, i=i: t[i], mbs)
        loss, metrics, grads = grads_of(params, mb)
        gsum = tree.tree_map(torch.add, gsum, grads)
        losses.append(loss)
        mmetrics.append(metrics)
    grads = tree.tree_map(lambda g: g / microbatches, gsum)
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


def dp_shards(fn: Callable, params, batch, devices) -> list:
    """``fn(params, shard)`` of each replica, in mesh order: replica ``i``
    on ``devices[i]`` with its contiguous batch shard
    (``distributed.sharding.shard_rows``). The params are copied once to
    each device they are not on; replicas on one device share them."""
    home = tree.leaves(params)[0].device
    rows = shard_rows(int(tree.leaves(batch)[0].shape[0]), len(devices))
    replicas: dict = {home: params}
    outs = []
    for i, dev in enumerate(devices):
        if dev not in replicas:
            replicas[dev] = tree.tree_map(lambda t: t.to(dev), params)
        shard = tree.tree_map(lambda t: t[i * rows:(i + 1) * rows].to(dev), batch)
        outs.append(fn(replicas[dev], shard))
    return outs


def dp_mesh_mean(xs, home: torch.device) -> torch.Tensor:
    """The replicas' tensors summed in mesh order on the first one's device
    (``compression._mesh_sum``), divided by their count, moved to
    ``home``: the JAX package's ``pmean``."""
    xs = list(xs)
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
    replicas, its balance loss over that microbatch's rows."""
    devices = tuple(mesh.devices)
    n = len(devices)
    moe = n > 1 and bool(model.cfg.num_experts)

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
                grads_of, params, batch, devices))
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
# Tensor parallelism over the model axis, data parallelism over the data
# axis, from one process.
# ---------------------------------------------------------------------------


def _mean_over_rows(trees: list, home: torch.device):
    """The data shards' trees of one model rank averaged leaf by leaf in
    mesh order on ``home`` (``dp_mesh_mean``)."""
    means = iter([dp_mesh_mean(gs, home) for gs in zip(*map(tree.leaves, trees))])
    return tree.tree_map(lambda _: next(means), trees[0])


def _sum_replicated(grads: list, specs) -> list:
    """The ranks' gradient trees with every leaf the ranks hold whole (the
    norms and the biases each rank applies to its copy of the residual
    stream) replaced by the sum of the ranks' shares in rank order
    (``compression._mesh_sum``), on every rank; leaves split over the
    model axis are left as they are."""
    leaves = [tree.leaves(g) for g in grads]
    per_rank: list = [[] for _ in grads]
    for i, (path, _) in enumerate(tree.leaves_with_path(grads[0])):
        parts = [lv[i] for lv in leaves]
        if sharding.MODEL_AXIS not in sharding.spec_at(specs, path):
            total = compression._mesh_sum(parts)
            parts = [total.to(p.device) for p in parts]
        for r, p in enumerate(parts):
            per_rank[r].append(p)
    return [tree.tree_map(lambda _, it=iter(per_rank[r]): next(it), g)
            for r, g in enumerate(grads)]


def _whole_batch_moe_tp_grads(model, rows: list, batch, specs) -> tuple:
    """(loss, metrics, grads) of an MoE model's loss on the whole batch
    over a mesh's data rows (``rows``: one tree a model rank, a list a
    row): row ``d``'s ranks take its contiguous shard in lockstep, the
    cross-entropy is the mean of the rows', and each MoE layer's balance
    loss is formed from its router terms (each row's, rank 0's: the loss
    counts them once) averaged over the rows (:func:`_whole_batch_loss`),
    as :func:`_whole_batch_moe_grads` forms it over replicas. Every row runs
    on copies of one live tree a rank, on row 0's devices, so one backward
    adds the rows' gradients onto it; ``grads`` is one tree a rank."""
    home = tree.leaves(rows[0][0])[0].device
    per_row = shard_rows(int(tree.leaves(batch)[0].shape[0]), len(rows))
    live = [tree.tree_map(lambda t: t.detach().requires_grad_(True), t)
            for t in rows[0]]
    ces, terms = [], []
    with torch.enable_grad():
        for d, trees in enumerate(rows):
            devs = [tree.leaves(t)[0].device for t in trees]
            replica = [tree.tree_map(lambda t, dev=dev: t.to(dev), lt)
                       for lt, dev in zip(live, devs)]
            shard = {k: tp.Ranked.replicated(
                v[d * per_row:(d + 1) * per_row].to(devs[0]), devs)
                for k, v in batch.items()}
            with ffn.balance_terms() as row_terms:
                _, metrics = model.loss(tp.RankedTree(replica, specs), shard)
            ces.append(metrics["loss"])
            terms.append(row_terms)
        loss, ce, aux = _whole_batch_loss(ces, terms, home)
        flat = [leaf for t in live for leaf in tree.leaves(t)]
        got = torch.autograd.grad(loss, flat, allow_unused=True)
    got = iter([torch.zeros_like(p) if g is None else g for p, g in zip(flat, got)])
    return (loss.detach(), {"loss": ce.detach(), "aux": aux.detach()},
            [tree.tree_map(lambda _: next(got), t) for t in live])


def make_tp_train_step(model, tcfg: TrainConfig, mesh,
                       clip_predicate: Optional[Callable] = None):
    """:func:`make_train_step` over a ``("data", "model")`` mesh
    (``launch.mesh.DeviceMesh``): ``(params, opt_state, batch) -> (params,
    opt_state, metrics)`` with ``params`` and ``opt_state`` laid out by
    ``distributed.sharding.shard_params`` (one tree a device, each leaf its
    rank's slice by the rule table), and returned so.

    The batch splits into contiguous shards over the mesh's data rows.
    Each row's model ranks take the gradient of ``model.loss`` on its
    shard in lockstep (``models.transformer``, ``models.encdec``: column-
    and row-parallel projections, local attention and xLSTM heads, mamba's
    local channels, a vocab-parallel embedding and loss), under ``activation_mesh(mesh)``, ``tcfg.microbatches``
    splitting the shard. Each rank's gradients are averaged over the rows
    in mesh order (``dp_mesh_mean``), and a leaf every rank holds whole
    sums its ranks' shares. Then one clip by the global norm of the whole
    tree (``optim.clip``: a replicated leaf counted once), and on each
    rank's slice one schedule step and one AdamW update, copied to the
    rank's devices on the other rows. Up to the order of float sums this
    is the single-device step on the whole batch.

    An MoE config's balance loss is a product of two means over every
    token, so with more than one data row its step forms the loss from the
    router terms averaged over the rows (:func:`_whole_batch_moe_tp_grads`)
    and takes one backward, as :func:`make_dp_train_step` does over its
    replicas; with ``tcfg.microbatches > 1`` the whole batch splits into
    microbatches first, each one's balance loss over its own rows.

    Every family takes this step: attention with dense or MoE FFNs, mamba
    on each rank's channels, the mLSTM and the sLSTM on each rank's heads,
    and the encoder-decoder with its cross-attention (``models.encdec``)."""
    ranks = sharding.model_axis_size(mesh)

    def row_grads(trees: list, shard: dict, specs):
        devs = [tree.leaves(t)[0].device for t in trees]
        live = [tree.tree_map(lambda t: t.detach().requires_grad_(True), t)
                for t in trees]
        ranked = {k: tp.Ranked.replicated(v, devs) for k, v in shard.items()}
        flat = [leaf for t in live for leaf in tree.leaves(t)]
        with torch.enable_grad():
            loss, metrics = model.loss(tp.RankedTree(live, specs), ranked)
            got = torch.autograd.grad(loss, flat, allow_unused=True)
        got = iter([torch.zeros_like(p) if g is None else g
                    for p, g in zip(flat, got)])
        return (loss.detach(), tree.tree_map(torch.Tensor.detach, metrics),
                [tree.tree_map(lambda _: next(got), t) for t in live])

    def row_mean_grads(rows, batch, specs, home):
        """Each row's gradients on its contiguous shard, averaged over the
        rows rank by rank; the loss and metrics likewise."""
        per_row = shard_rows(int(tree.leaves(batch)[0].shape[0]), len(rows))
        outs = []
        for d, trees in enumerate(rows):
            first = tree.leaves(trees[0])[0].device
            shard = tree.tree_map(
                lambda t: t[d * per_row:(d + 1) * per_row].to(first), batch)
            outs.append(_accumulated_grads(
                functools.partial(row_grads, specs=specs), trees, shard,
                tcfg.microbatches))
        losses, row_metrics, row_grads_ = zip(*outs)
        grads = [_mean_over_rows([g[r] for g in row_grads_], home[r])
                 for r in range(ranks)]
        return (dp_mesh_mean(losses, home[0]),
                tree.tree_map(lambda *ms: dp_mesh_mean(ms, home[0]), *row_metrics),
                grads)

    def train_step(params, opt_state, batch):
        rows = params.rows()
        home = [tree.leaves(t)[0].device for t in rows[0]]
        with sharding.activation_mesh(mesh):
            if len(rows) > 1 and model.cfg.num_experts:
                loss, model_metrics, grads = _accumulated_grads(
                    lambda _, mb: _whole_batch_moe_tp_grads(model, rows, mb,
                                                            params.specs),
                    rows[0], batch, tcfg.microbatches)
            else:
                loss, model_metrics, grads = row_mean_grads(
                    rows, batch, params.specs, home)
        grads = _sum_replicated(grads, params.specs)
        grads, gnorm = clip_by_global_norm(
            sharding.Shards(grads, params.specs, mesh), tcfg.clip_norm)
        new_row, new_opt_row, lr_scales = [], [], []
        for p, o, g in zip(rows[0], opt_state.rows()[0], grads):
            lr_scales.append(cosine_schedule(o["adam"]["count"] + 1,
                                             warmup_steps=tcfg.warmup_steps,
                                             total_steps=tcfg.total_steps))
            new_p, new_adam = adamw_update(g, o["adam"], p, tcfg.adamw,
                                           lr_scale=lr_scales[-1],
                                           clip_predicate=clip_predicate)
            new_row.append(new_p)
            new_opt_row.append({"adam": new_adam})
        metrics = {**model_metrics, "loss": loss, "grad_norm": gnorm,
                   "lr_scale": lr_scales[0]}
        return (sharding.Shards.of_row(new_row, params.specs, mesh),
                sharding.Shards.of_row(new_opt_row, opt_state.specs, mesh),
                metrics)

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
