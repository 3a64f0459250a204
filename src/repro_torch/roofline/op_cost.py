"""Cost of one step, counted as it runs: the port's counterpart of the JAX
package's ``roofline/hlo_cost.py``, which walks compiled HLO.

The port compiles nothing, so :func:`count` runs the step under a
``TorchDispatchMode`` and reckons every aten op that reaches the
dispatcher (usually on the ``meta`` device, where nothing is computed or
allocated; on the card or the CPU the same ops run for real):

* **flops** — 2·M·N·K for every ``mm``, ``bmm``, ``addmm``, ``baddbmm``
  and convolution (einsum and matmul reach aten as these), as
  ``hlo_cost._dot_flops`` counts dots; elementwise work is not counted.
* **bytes** — the operands plus the results of every aten op. Views,
  ``empty`` and metadata ops are free (``hlo_cost._NO_TRAFFIC``).
* **the LM kernels** (flash attention, the SSM scan and the mLSTM, forward
  and backward, and ``unpack_gemm``) count at their ``kernels.ops``
  boundary (:func:`kernel`): their FLOPs by formula (the functions below,
  which ``chip_smoke.py`` takes for its bounds), their operands and
  results as bytes. The count is the same whether the kernel, its twin or
  the meta path ran. What a twin materialises inside (scores, states)
  goes to ``fusible_bytes``, the counterpart of the JAX ``vmem_fusible``
  scope; a twin's FLOPs are not counted again.
* **trip counts** — a loop written ``for i in trips(items)`` runs two
  trips under the counter, the first once and the second for the other
  ``len(items) - 1``: every op of the second (and, in a train step, of its
  backward) is multiplied, as ``hlo_cost`` multiplies a ``while`` body by
  its ``known_trip_count``; nested loops multiply. ``trips(...).cat`` /
  ``.stack`` then stand the last trip's output in for every trip's. Outside the counter the loop runs
  every trip, as before. Its body must take the same shapes on every trip.
  Under the counter the loop's values are not the model's: the counter
  counts, it does not compute.
* **peak_bytes** — the most bytes held at once by tensors made during the
  step (not its arguments), a tensor freed when the last tensor on its
  storage dies. A trip-counted body's tensors count ``len(items)`` times
  when grad is on, since autograd keeps each trip's.

The count follows the ops eager PyTorch runs, so it differs from the HLO
walker's where eager autograd does other work than XLA's: a loop's
backward here adds up the gradients of a stacked input trip by trip.

:func:`collective_bytes` reckons the collectives a mesh's layout implies
for one forward, from the rule table (``distributed.sharding``), since
there is no partitioner and no HLO to read; :func:`collective_bytes_bwd`
the rest of a train step's (remat's recompute, the backward, the
embedding, gathers and loss).
"""

from __future__ import annotations

import collections
import contextlib
import math
import weakref
from typing import Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode, _disable_current_modes
from torch.utils._pytree import tree_flatten

from repro_torch import tree
from repro_torch.distributed import sharding

aten = torch.ops.aten

# Ops that move no bytes: allocation without a write, metadata, aliasing.
_FREE = {aten.empty, aten.empty_like, aten.empty_strided, aten.detach,
         aten.alias, aten.lift_fresh, aten._unsafe_view, aten.t,
         aten.sym_size, aten.sym_stride, aten.sym_numel, aten.sym_storage_offset,
         aten.is_same_size, aten.set_}

# wire-traffic multiplier per collective kind (ring algorithms), as
# ``hlo_cost._COLL_MULT``
COLL_MULT = {"all-reduce": 2.0, "all-gather": 1.0, "reduce-scatter": 1.0,
             "all-to-all": 1.0, "collective-permute": 1.0}


# ------------------------------ kernel FLOPs ---------------------------------
#
# One formula a kernel, the operations its bound in chip_smoke.py counts.

def flash_flops(bh: int, sq: int, skv: int, dh: int, causal: bool = True, *,
                backward: bool = False) -> float:
    """Flash attention: the QK^T and PV products, 2 x 2 BH Sq Skv Dh, half
    of them under a causal mask (2 BH S^2 Dh at Sq = Skv); the backward's
    five products are 2.5x the forward's."""
    f = 4.0 * bh * sq * skv * dh * (0.5 if causal else 1.0)
    return 2.5 * f if backward else f


def scan_flops(b: int, c: int, di: int, ds: int) -> float:
    """The selective scan, forward or backward: one exp a state and step,
    B C di ds (the bound counts them at the special-function units' rate)."""
    return float(b * c * di * ds)


def mlstm_flops(bh: int, s: int, dk: int, dv: int, chunk: int, *,
                backward: bool = False) -> float:
    """The chunkwise mLSTM per (bh, chunk) of L steps: forward L (L + 1)
    (dk + dv) + 4 L dk dv (the causal half of q k^T and of the weights
    times v, the diagonal included, then q C and the update of C);
    backward L (L + 1) (3 dk + 2 dv) + 8 L dk dv."""
    ln = min(chunk, s)
    if not ln:
        return 0.0
    if backward:
        per = ln * (ln + 1) * (3 * dk + 2 * dv) + 8 * ln * dk * dv
    else:
        per = ln * (ln + 1) * (dk + dv) + 4 * ln * dk * dv
    return float((s // ln) * bh * per)


def gemm_flops(m: int, k: int, n: int) -> float:
    """A dense product ``[M, K] x [K, N]``: 2 M N K (``unpack_gemm``)."""
    return 2.0 * m * k * n


# ------------------------------- the counter ---------------------------------

_ACTIVE: list["Counter"] = []


def active() -> Optional["Counter"]:
    """The innermost running counter, or None."""
    return _ACTIVE[-1] if _ACTIVE else None


def _tensors(obj) -> list:
    return [t for t in tree_flatten(obj)[0] if isinstance(t, torch.Tensor)]


def _nbytes(obj) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(obj))


def _storage_key(t: torch.Tensor):
    try:
        return t.untyped_storage()._cdata
    except (NotImplementedError, RuntimeError):
        return None


def _mm_flops(func, args, out) -> float:
    packet = func.overloadpacket
    if packet in (aten.mm, aten.addmm):
        a, b = (args[0], args[1]) if packet is aten.mm else (args[1], args[2])
        return 2.0 * a.shape[0] * a.shape[1] * b.shape[1]
    if packet in (aten.bmm, aten.baddbmm):
        a, b = (args[0], args[1]) if packet is aten.bmm else (args[1], args[2])
        return 2.0 * a.shape[0] * a.shape[1] * a.shape[2] * b.shape[2]
    if packet in (aten.mv, aten.addmv):
        a = args[0] if packet is aten.mv else args[1]
        return 2.0 * a.shape[0] * a.shape[1]
    if packet is aten.dot:
        return 2.0 * args[0].shape[0]
    if packet is aten.convolution:
        w = args[1]
        return 2.0 * out.numel() * math.prod(w.shape[1:])
    if packet is aten.convolution_backward:
        w = args[2]
        per = 2.0 * args[0].numel() * math.prod(w.shape[1:])
        return per * sum(bool(m) for m in args[-1][:2])
    return 0.0


class Counter(TorchDispatchMode):
    """What :func:`count` yields: ``flops``, ``bytes``, ``fusible_bytes``
    and ``peak_bytes`` of what ran under it, and ``kernels`` (name ->
    calls, trips multiplied)."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.fusible_bytes = 0.0
        self.peak_bytes = 0.0
        self.kernels: collections.Counter = collections.Counter()
        self._live = 0.0
        self._storages: dict = {}       # storage key -> [tensors, bytes]
        self._stack: list[int] = []     # trip counts of the loops we are in
        self._ranges: list = []         # (first, end, trips) of autograd nodes
        self._node_mult: dict = {}
        self._fusible = 0
        self._probe = torch.empty(0, requires_grad=True)

    # -- multipliers --

    def _seq(self) -> int:
        """The sequence number the next autograd node will get."""
        with _disable_current_modes(), torch.enable_grad():
            return self._probe.view(0).grad_fn._sequence_nr() + 1

    def _backward_mult(self, seq: int) -> float:
        if seq not in self._node_mult:
            self._node_mult[seq] = math.prod(
                n for first, end, n in self._ranges if first <= seq < end)
        return self._node_mult[seq]

    def mult(self) -> float:
        """How many times the op now running stands for: the product of the
        loops it runs in, or, in a backward, of the loops that made its
        autograd node."""
        node = torch._C._current_autograd_node()
        if node is not None and not torch.is_grad_enabled():
            return self._backward_mult(node._sequence_nr())
        return math.prod(self._stack)

    # -- live bytes --

    def _release(self, key) -> None:
        entry = self._storages.get(key)
        if entry is None:
            return
        entry[0] -= 1
        if entry[0] == 0:
            self._live -= entry[1]
            del self._storages[key]

    def _track(self, out, inputs: set) -> None:
        mem_mult = (math.prod(self._stack)
                    if torch.is_grad_enabled()
                    and torch._C._current_autograd_node() is None else 1)
        for t in _tensors(out):
            key = _storage_key(t)
            if key is None or key in inputs:
                continue
            entry = self._storages.get(key)
            if entry is None:
                nbytes = t.untyped_storage().nbytes() * mem_mult
                entry = self._storages[key] = [0, nbytes]
                self._live += nbytes
                self.peak_bytes = max(self.peak_bytes, self._live)
            entry[0] += 1
            weakref.finalize(t, self._release, key)

    # -- dispatch --

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ins = _tensors((args, kwargs))
        if not (func.is_view or func.overloadpacket in _FREE):
            mult = self.mult()
            nbytes = (_nbytes(ins) + _nbytes(out)) * mult
            if self._fusible:
                self.fusible_bytes += nbytes
            else:
                self.bytes += nbytes
                self.flops += _mm_flops(func, args, out) * mult
        self._track(out, {_storage_key(t) for t in ins})
        return out

    def as_dict(self) -> dict:
        return {"flops": self.flops, "bytes": self.bytes,
                "fusible_bytes": self.fusible_bytes,
                "peak_bytes": self.peak_bytes, "kernels": dict(self.kernels)}


@contextlib.contextmanager
def count():
    """Count the aten ops, kernels and live bytes of the block."""
    counter = Counter()
    _ACTIVE.append(counter)
    try:
        with counter:
            yield counter
    finally:
        _ACTIVE.remove(counter)


def kernel(name: str, flops: float, fn, *args, **kwargs):
    """``fn(*args, **kwargs)``, one call of kernel ``name`` (its launch,
    its twin or its meta stand-in). Under a counter: ``flops`` and the
    bytes of the tensors among the arguments and among the results, each
    times the trip multiplier; the aten ops inside count as
    ``fusible_bytes`` only."""
    counter = active()
    if counter is None:
        return fn(*args, **kwargs)
    counter._fusible += 1
    try:
        out = fn(*args, **kwargs)
    finally:
        counter._fusible -= 1
    mult = counter.mult()
    counter.flops += flops * mult
    counter.bytes += (_nbytes((args, kwargs)) + _nbytes(out)) * mult
    counter.kernels[name] += mult
    return out


class trips:
    """``for i in trips(items)``: every item outside a counter; under one,
    two trips: the first, counted once, and the second, standing for the
    other ``len(items) - 1`` (the first trip's carry may differ from the
    rest's, as a zero state that needs no gradient does). Collect the
    trips' outputs with :meth:`cat` or :meth:`stack`."""

    def __init__(self, items):
        self.items = list(items)
        self.counter = active()
        self.counted = self.counter is not None and len(self.items) > 2

    def __iter__(self):
        if not self.counted:
            yield from self.items
            return
        c, n = self.counter, len(self.items)
        for item, mult in ((self.items[0], 1), (self.items[1], n - 1)):
            first = c._seq() if torch.is_grad_enabled() else None
            c._stack.append(mult)
            try:
                yield item
            finally:
                c._stack.pop()
                if first is not None:
                    c._ranges.append((first, c._seq(), mult))
                    c._node_mult.clear()

    def _repeat(self, ys: list, dim: int, new_axis: bool) -> torch.Tensor:
        y = ys[-1]
        dim = dim % (y.ndim + int(new_axis))
        shape = list(y.shape)
        rep = y.unsqueeze(dim).expand(*shape[:dim], len(self.items), *shape[dim:])
        if new_axis:
            return rep.contiguous()
        return rep.reshape(*shape[:dim], len(self.items) * shape[dim],
                           *shape[dim + 1:])

    def cat(self, ys: list, dim: int = 0) -> torch.Tensor:
        """``torch.cat(ys, dim)`` of the trips' outputs."""
        if not self.counted:
            return torch.cat(ys, dim)
        return self._repeat(ys, dim, new_axis=False)

    def stack(self, ys: list, dim: int = 0) -> torch.Tensor:
        """``torch.stack(ys, dim)`` of the trips' outputs."""
        if not self.counted:
            return torch.stack(ys, dim)
        return self._repeat(ys, dim, new_axis=True)


# ------------------------------- collectives ---------------------------------


def _leaf_bytes(leaf, itemsize: Optional[int] = None) -> float:
    shape = tuple(getattr(leaf, "shape", ()))
    size = itemsize or getattr(leaf, "element_size", lambda: 4)()
    return float(math.prod(shape)) * size


def _spec_axes(spec) -> set:
    axes = set()
    for entry in spec:
        if entry is None:
            continue
        axes.update(entry if isinstance(entry, tuple) else (entry,))
    return axes


def _over(mesh, axes) -> int:
    return math.prod(mesh.shape[a] for a in axes if a in mesh.shape)


def collective_bytes(mesh, args, kind: str, *, act_bytes: int = 2,
                     by_direction: bool = False) -> dict:
    """Per-device wire bytes of the collectives the rule table's layout
    needs for one step of a ``kind`` cell (``"train"``, ``"prefill"``,
    ``"decode"``) with ``args = (params, opt_state | state, batch)``, by
    kind of collective: the result bytes on each device times
    :data:`COLL_MULT`, as ``hlo_cost`` counts them.

    With ``M_leaf`` the devices of ``model`` a param is sharded over and
    ``D_batch`` those the batch is split over:

    * **all-gather** of every param sharded over the data axes (FSDP),
      before its use: each device receives the leaf gathered over data,
      ``bytes(leaf) / M_leaf``. A train cell gathers it at the leaf's own
      width, as the port's step does (``tensor_parallel.gathered``: the
      float32 latent weights, whose whole rows FAKE_QUANT's alpha needs);
      a serving cell at the smaller of the leaf's and the activations'
      (the gather may move the cast weights).
    * in ``train`` cells on a mesh whose data axes hold more than one
      device, the **reduction of every param's gradient** over them, as
      the SPMD partitioner emits it and the port's step counts it
      (``train.step._reduce_over_rows``): an all-reduce of the gradient
      gathered over data, ``bytes(leaf) / M_leaf``, times 2, after which
      each device keeps its shard.
    * **all-reduce** of each layer output summed over ``model``
      (:func:`_layer_all_reduces`: each row-parallel projection's and
      each expert-parallel MoE layer's combine), once a layer that runs:
      ``tokens / D_batch x width x act_bytes``, times 2. A decode cell
      does not run an encoder.

    An axis of one device moves nothing. One forward's worth: a train
    step's recompute (which gathers each period's weights again),
    backward and smaller sites are :func:`collective_bytes_bwd`. No
    resharding of activations is counted (there is no partitioner to
    insert it). With ``by_direction`` the keys are ``(kind, "fwd" |
    "bwd")``, as :func:`collective_bytes_bwd`'s: the gradient reduction is
    the backward's, the rest the forward's."""
    params, _, batch = args
    out = {(k, d): 0.0 for k in COLL_MULT for d in ("fwd", "bwd")}
    data_axes = [a for a in sharding.DATA_AXES if a in mesh.shape]
    reduce_grads = kind == "train" and _over(mesh, data_axes) > 1
    for path, leaf in tree.leaves_with_path(params):
        if not hasattr(leaf, "shape"):
            continue
        spec = sharding.param_spec(mesh, path, leaf)
        axes = _spec_axes(spec)
        m_leaf = _over(mesh, axes & {sharding.MODEL_AXIS})
        if _over(mesh, axes & set(data_axes)) > 1:
            width = (leaf.element_size() if kind == "train"
                     else min(leaf.element_size(), act_bytes))
            out[("all-gather", "fwd")] += _leaf_bytes(leaf, width) / m_leaf
        if reduce_grads:
            out[("all-reduce", "bwd")] += (_leaf_bytes(leaf) / m_leaf
                                           * COLL_MULT["all-reduce"])
    for elems, _ in _layer_all_reduces(mesh, params, batch, kind):
        out[("all-reduce", "fwd")] += elems * act_bytes * COLL_MULT["all-reduce"]
    if by_direction:
        return out
    return {k: out[(k, "fwd")] + out[(k, "bwd")] for k in COLL_MULT}


def _recompute_gathers(mesh, params) -> float:
    """Bytes a device all-gathers again in a train step's recompute: every
    leaf of a layer stack (``layers``) split over the data axes, at its
    own width, ``bytes(leaf) / M_leaf`` (each period, or each
    encoder-decoder layer, is gathered inside its rematerialized body)."""
    data_axes = set(a for a in sharding.DATA_AXES if a in mesh.shape)
    total = 0.0
    for path, leaf in tree.leaves_with_path(params):
        if "layers" not in path or not hasattr(leaf, "shape"):
            continue
        axes = _spec_axes(sharding.param_spec(mesh, path, leaf))
        if _over(mesh, axes & data_axes) > 1:
            total += _leaf_bytes(leaf) / _over(mesh, axes & {sharding.MODEL_AXIS})
    return total


def _d_batch(mesh, batch) -> int:
    """Devices the batch is split over."""
    lead = tree.leaves(batch)[0]
    return _over(mesh, _spec_axes(sharding.batch_spec(mesh, (), lead)))


def _layer_all_reduces(mesh, params, batch, kind: str):
    """``(elements a device, alpha_elements)`` of every layer output
    the model axis sums, all layers of a stack together: each row-parallel
    projection's (``o_proj``, ``down_proj``, ``out_proj`` with ``in`` over
    ``model``; ``alpha_elements`` its out width a layer, the XNOR-Net
    alpha's all-reduce) and each MoE layer's combine where the experts
    split over ``model`` (``alpha_elements`` 0: an expert's alpha is
    local). None on a model axis of one device."""
    if _over(mesh, {sharding.MODEL_AXIS}) <= 1:
        return
    b = tree.leaves(batch)[0].shape[0]
    d_batch = _d_batch(mesh, batch)
    for path, leaf in tree.leaves_with_path(params):
        keys = [k for k in path if isinstance(k, str)]
        if (len(keys) < 2 or keys[-1] != "w" or not hasattr(leaf, "shape")
                or (kind == "decode" and "encoder" in keys)):
            continue
        layers = leaf.shape[0] if "layers" in path and leaf.ndim == 3 else 1
        if keys[-2] in sharding._ROW_PARALLEL:
            spec = sharding.param_spec(mesh, path, leaf)
            if len(spec) < 2 or spec[-1] != sharding.MODEL_AXIS:
                continue
            width, alpha = leaf.shape[-2], leaf.shape[-2]
        elif keys[-2] == "router" and "moe" in keys:
            if sharding._guard(mesh, leaf.shape[-2], sharding.MODEL_AXIS) is None:
                continue
            width, alpha = leaf.shape[-1], 0
        else:
            continue
        seq = 1 if kind == "decode" else _tokens_per_row(batch, keys)
        yield layers * b * seq / d_batch * width, layers * alpha


def collective_bytes_bwd(mesh, args, kind: str, cfg, *, alpha: bool = True) -> dict:
    """Per-device wire bytes of a ``train`` cell's collectives that
    :func:`collective_bytes` leaves out, as the port's tensor-parallel
    step (``train.step.make_tp_train_step``) moves them, by
    ``(kind of collective, "fwd" | "bwd")``, the keys of
    ``distributed.tensor_parallel.BYTES`` less the site. ``cfg`` gives the
    heads and the activations' dtype; ``alpha``: the row-parallel
    projections take XNOR-Net's alpha (a FAKE_QUANT policy with
    ``use_scale``, every train cell's). Zero for another ``kind``, and
    only the recompute's gathers over the data axes on a model axis of one
    device. With ``n`` a site's tokens over ``D_batch``:

    * **remat's recompute**, ``"fwd"``: every period is recomputed whole
      in the backward, so each all-reduce of :func:`_layer_all_reduces`
      runs again, and every forward site below that lies in a period.
    * **the backward** of each of them, ``"bwd"``: the all-reduce's
      gradient is the sum of its copies' gradients, the same bytes.
    * **the vocab-parallel embedding** (a batch of tokens, the table's
      vocab over ``model``): ``n x d_model`` activations all-reduced,
      forward and backward, not recomputed.
    * **a head cut mid-way** in self-attention (``m`` does not divide the
      q or kv heads, or a projection's out width): the q, k and v outputs
      split over ``model`` are all-gathered, ``n x out`` each, in the
      forward and the recompute; their gradients reduce-scattered, ``n x
      out / m``, in the backward. Cross-attention likewise, its q over
      the decoder's tokens and its k and v over the encoder's frames.
    * **a fused output re-laid out** (:func:`_mixer_gathers`): mamba's
      ``in_proj`` (``2 d_inner``) and ``x_proj`` (``dt_rank + 2 d_state``),
      the mLSTM's ``up_proj`` (``2 d_inner``) and ``if_proj`` (``2 H``), the
      sLSTM's ``gates_proj`` (``4 d``), its output (``d``, where its heads
      are split) and its ``up_proj`` (``d_ff``), each all-gathered where the
      rule table splits it, ``n x out``, in the forward and the recompute,
      reduce-scattered, ``n x out / m``, in the backward; with the heads
      split, the mLSTM's group norm all-reduces its float32 partial sums,
      ``n`` each, in the forward, the recompute and the backward.
    * **the vocab-parallel loss** (the head's vocab over ``model``): the
      row max, the sum of exps and the label's logit, float32 ``n``
      each, all-reduced in the forward, the last two in the backward.
    * **the row-parallel alpha**: the ranks' ``|w|`` sums, float32, one
      out width a layer, in the forward and the recompute (detached: no
      backward). With ``TrainConfig.microbatches`` it runs once a
      microbatch; it is reckoned once. The gathered weights see whole
      rows over the data axes, so no second reduction.
    * **the recompute's gathers** over the data axes (FSDP), ``"fwd"``:
      every layer stack's leaf split over them, again
      (:func:`_recompute_gathers`), on a mesh whose data axes hold more
      than one device, whatever the model axis. With
      ``TrainConfig.microbatches`` a period is gathered once a microbatch
      (forward and recompute) and the gradient reduced once a step; the
      gathers are reckoned once, as the alpha is.

    Each all-reduce counts times 2 (:data:`COLL_MULT`)."""
    out = {(k, d): 0.0 for k in ("all-reduce", "all-gather", "reduce-scatter")
           for d in ("fwd", "bwd")}
    if kind != "train":
        return out
    params, _, batch = args
    out[("all-gather", "fwd")] += _recompute_gathers(mesh, params)
    m = _over(mesh, {sharding.MODEL_AXIS})
    if m <= 1:
        return out
    act = torch.empty((), dtype=cfg.dtype).element_size()
    ar = COLL_MULT["all-reduce"]
    for elems, alpha_elems in _layer_all_reduces(mesh, params, batch, kind):
        out[("all-reduce", "fwd")] += elems * act * ar
        out[("all-reduce", "bwd")] += elems * act * ar
        if alpha:
            out[("all-reduce", "fwd")] += 2 * alpha_elems * 4 * ar

    b = tree.leaves(batch)[0].shape[0]
    rows = b / _d_batch(mesh, batch)
    leaves = dict(tree.leaves_with_path(params))
    table = leaves[("embed", "table")]
    split_vocab = sharding._guard(mesh, table.shape[0], sharding.MODEL_AXIS) is not None
    if "tokens" in batch and split_vocab:
        n = rows * batch["tokens"].shape[1] * table.shape[1] * act * ar
        out[("all-reduce", "fwd")] += n
        out[("all-reduce", "bwd")] += n
    if split_vocab:   # the head: the table or lm_head, of the same vocab
        n = rows * batch["labels"].shape[1] * 4 * ar
        out[("all-reduce", "fwd")] += 3 * n
        out[("all-reduce", "bwd")] += 2 * n

    def out_split(path) -> bool:
        return sharding.param_spec(mesh, path, leaves[path])[-2] == sharding.MODEL_AXIS

    qkv = ("q_proj", "k_proj", "v_proj")
    heads_whole = cfg.num_heads % m == 0 and cfg.num_kv_heads % m == 0
    for path, leaf in leaves.items():
        if (path[-1] != "w" or path[-2] not in qkv
                or path[-3] not in ("attn", "self_attn")):
            continue
        group = path[:-2]
        local = heads_whole and all(out_split(group + (name, "w")) for name in qkv)
        if local or not out_split(path):
            continue
        layers = leaf.shape[0] if "layers" in path and leaf.ndim == 3 else 1
        n = layers * rows * _tokens_per_row(batch, path) * leaf.shape[-2] * act
        out[("all-gather", "fwd")] += 2 * n
        out[("reduce-scatter", "bwd")] += n / m
    for key, n in _mixer_gathers(mesh, leaves, batch, cfg, rows, act):
        out[key] += n
    return out


def _mixer_gathers(mesh, leaves: dict, batch, cfg, rows: float, act: int):
    """``((kind, "fwd" | "bwd"), bytes)`` of the gathers and group-norm
    all-reduces of cross-attention, mamba, the mLSTM and the sLSTM over
    the model axis (``models.attention._cross_attention_tp``,
    ``models.mamba._mamba_tp``, ``models.xlstm._mlstm_tp`` and
    ``_slstm_tp``), every layer of a stack together: see
    :func:`collective_bytes_bwd`."""
    m = _over(mesh, {sharding.MODEL_AXIS})
    ar = COLL_MULT["all-reduce"]
    heads_split = cfg.num_heads % m == 0

    def out_split(path) -> bool:
        return sharding.param_spec(mesh, path, leaves[path])[-2] == sharding.MODEL_AXIS

    for path, leaf in leaves.items():
        if path[-1] != "w" or len(path) < 3:
            continue
        group, name, mixer = path[:-2], path[-2], path[-3]
        first = {"mamba": "in_proj", "mlstm": "up_proj", "slstm": "gates_proj",
                 "cross_attn": "q_proj"}.get(mixer)
        if name != first:
            continue
        layers = leaf.shape[0] if "layers" in path and leaf.ndim == 3 else 1
        tokens = layers * rows * _tokens_per_row(batch, path)

        def gather(proj, width=None, n=tokens):
            wpath = group + (proj, "w")
            if not out_split(wpath):
                return []
            elems = n * (leaves[wpath].shape[-2] if width is None else width)
            return [(("all-gather", "fwd"), 2 * elems * act),
                    (("reduce-scatter", "bwd"), elems * act / m)]

        sites = []
        if mixer == "mamba":
            sites += gather("in_proj") + gather("x_proj")
        elif mixer == "mlstm":
            qkv = ("q_proj", "k_proj", "v_proj")
            local = heads_split and all(out_split(group + (q, "w")) for q in qkv)
            sites += gather("up_proj") + gather("if_proj")
            if local:
                sites += [(("all-reduce", "fwd"), 2 * tokens * 4 * ar),
                          (("all-reduce", "bwd"), tokens * 4 * ar)]
            else:
                sites += [site for q in qkv for site in gather(q)]
        elif mixer == "slstm":
            d = leaf.shape[-1]
            sites += gather("gates_proj") + gather("up_proj")
            if heads_split:
                elems = tokens * d
                sites += [(("all-gather", "fwd"), 2 * elems * act),
                          (("reduce-scatter", "bwd"), elems * act / m)]
        else:   # cross-attention: q over the decoder, k and v over the frames
            qkv = ("q_proj", "k_proj", "v_proj")
            local = (heads_split and cfg.num_kv_heads % m == 0
                     and all(out_split(group + (q, "w")) for q in qkv))
            if not local:
                frames = layers * rows * _tokens_per_row(batch, ("encoder",))
                sites += (gather("q_proj") + gather("k_proj", n=frames)
                          + gather("v_proj", n=frames))
        yield from sites


def _tokens_per_row(batch, keys) -> int:
    """Sequence length a projection of ``keys`` sees in this batch: the
    encoder's frames (``input_embeds``) for an encoder layer, else the
    tokens' (or the embeddings') length."""
    if "encoder" in keys and "input_embeds" in batch:
        return batch["input_embeds"].shape[1]
    src = batch.get("tokens", batch.get("input_embeds", batch.get("labels")))
    return src.shape[1]


__all__ = ["COLL_MULT", "Counter", "active", "collective_bytes",
           "collective_bytes_bwd", "count",
           "flash_flops", "gemm_flops", "kernel", "mlstm_flops", "scan_flops",
           "trips"]
