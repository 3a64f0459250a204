"""Compressed gradient all-reduce for the data-parallel axis, as
``repro.distributed.compression``: error-feedback int8 and 1-bit
error-feedback sign-SGD.

The JAX package runs ``psum_compressed`` / ``psum_signsgd`` inside
``shard_map`` on a named axis. The port drives its mesh
(``launch.mesh.ServingMesh``) from one process, so each collective is a
function over the shards' tensors given in mesh order, ``(gs, errs) ->
(mean, new_errs)``: the shards are gathered to the device of the first
(a shard on another card is moved there with ``.to()``), and the mean and
the new residuals, stacked ``[n, ...]``, are computed there; every float
sum runs in mesh order. Under a process group (one process a device,
``distributed.process_group``) a process passes its own shard, ``[g]``
and its residual row ``[1, ...]``: it gathers every shard's ``g + err``
over the data group, computes what one process computes from them, and
keeps its own residual row, so the mean and the residuals are the single
process's bit for bit.
Error feedback keeps the quantization noise unbiased across steps (Seide
et al.; Karimireddy et al. 2019): each shard carries what its own
rounding threw away into its next round.

Byte accounting, as in the JAX package: the int8 path keeps 8 of 32 bits
of entropy a coordinate (``INT8_BITS_RATIO``), but the reference widens
the payload to int32 for the sum, so the 4x saving is realized only on a
fabric that reduces in int8. The sign path keeps 1 bit a coordinate plus
one float32 scale a tensor (``SIGNSGD_BITS_RATIO``, 32x); it too widens
the ±1 payload for the sum. No packed wire format is built: replicas that
share one card have no fabric to save.

Each operation keeps the JAX package's order, and the collectives round
as XLA compiles them under ``jit`` (a product with the reciprocal for a
division by a constant, one fused multiply-add for the int8 residual).
The int8 scale is a max and its total an integer sum, both order-free,
so ``psum_compressed``'s mean and residual equal the JAX package's bit
for bit; the sign totals are integers too, and only the sign path's
scale, a float mean, may round apart. The local round trips
(``compress_decompress``, ``signsgd_compress_decompress``) keep the
division, as the JAX package's run op by op.
"""

from __future__ import annotations

import torch

from repro_torch import tree
from repro_torch.distributed import process_group as pg

# Entropy ratio against a float32 all-reduce: bits kept a coordinate.
INT8_BITS_RATIO = 32 / 8     # 4x: realized on int8-reducing fabrics only
SIGNSGD_BITS_RATIO = 32 / 1  # 32x: 1 sign bit (+ one float32 scale a tensor)


def init_error_feedback(grads):
    return tree.tree_map(torch.zeros_like, grads)


def _quantize(g: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    scale = torch.clamp(torch.max(torch.abs(g)), min=1e-30) / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def _dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def compress_decompress(g: torch.Tensor, err: torch.Tensor,
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Local (single-device) EF int8 quantization round trip: (the
    dequantized grad to feed the optimizer, the new error residual)."""
    corrected = g + err
    q, scale = _quantize(corrected)
    deq = _dequantize(q, scale)
    return deq, corrected - deq


def _mesh_sum(xs) -> torch.Tensor:
    """``xs[0] + xs[1] + ...`` in mesh order on the device of ``xs[0]``."""
    home = xs[0].device
    total = xs[0]
    for x in xs[1:]:
        total = total + x.to(home)
    return total


def _corrected(gs, errs) -> torch.Tensor:
    """``g + err`` of every shard, stacked ``[n, ...]`` in mesh order on
    the device of the first shard. ``gs`` and ``errs`` are lists of the
    shards' tensors or tensors already stacked so."""
    def stack(xs):
        if isinstance(xs, torch.Tensor):
            return xs
        return torch.stack([x.to(xs[0].device) for x in xs])

    g = stack(gs)
    return g + stack(errs).to(g.device)


def _over_data(c: torch.Tensor) -> tuple:
    """(every shard's ``c`` stacked ``[n, ...]``, the rows of those this
    process holds): ``c`` and ``None`` (all of them) from one process; under a
    process group this process's ``[1, ...]`` gathered over the data group
    and its own row."""
    if not pg.active():
        return c, None
    k = pg.index(pg.DATA)
    return torch.cat(pg.everyone([c], pg.DATA)), slice(k, k + 1)


def _rows(new_errs: torch.Tensor, mine) -> torch.Tensor:
    return new_errs if mine is None else new_errs[mine].clone()


def psum_compressed(gs, errs) -> tuple[torch.Tensor, torch.Tensor]:
    """EF-int8 all-reduce over the shards ``gs`` (with residuals
    ``errs``), in mesh order: one common scale from the max of every
    shard's ``|g + err|``, each shard rounded to int8 against it, the
    int8 payloads summed widened to int32, then ``total * scale / n``.
    Returns the mean and each shard's rounding error, its new residual,
    stacked ``[n, ...]`` (this process's row under a process group)."""
    c, mine = _over_data(_corrected(gs, errs))
    n = c.shape[0]
    # The JAX package writes ``/ 127.0``; under jit XLA's algebraic
    # simplifier turns a division by a constant into a product with its
    # float32 reciprocal, which rounds otherwise for some maxima. The
    # collective runs jitted there, so it is that product here.
    scale = torch.clamp(torch.amax(torch.abs(c)), min=1e-30) * (1.0 / 127.0)
    q = torch.clamp(torch.round(c / scale), -127, 127).to(torch.int8)
    total = torch.sum(q, dim=0, dtype=torch.int32)
    mean = total.to(torch.float32) * scale / n
    # The residual rounds once: XLA contracts the JAX package's
    # ``corrected - q * scale`` into one fused multiply-add, and a float32
    # product then difference would round twice. An int8 times a float32
    # is exact in float64, and so is the difference (|c - q s| <= s / 2),
    # so this equals the fused result bit for bit.
    new_errs = (c.to(torch.float64) - q.to(torch.float64)
                * scale.to(torch.float64)).to(torch.float32)
    return mean, _rows(new_errs, mine)


def signsgd_compress_decompress(g: torch.Tensor, err: torch.Tensor,
                                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Local (single-device) EF sign-SGD round trip (EF-signSGD,
    Karimireddy et al. 2019): ``scale * sign(corrected)`` with ``scale =
    mean(|corrected|)``, the l1-optimal magnitude of a sign vector.
    Returns (decompressed grad, new error residual)."""
    corrected = g + err
    scale = torch.mean(torch.abs(corrected))
    sgn = torch.where(corrected >= 0, 1.0, -1.0).to(torch.float32)
    deq = scale * sgn
    return deq, corrected - deq


def psum_signsgd(gs, errs) -> tuple[torch.Tensor, torch.Tensor]:
    """1-bit EF sign-SGD all-reduce over the shards ``gs`` (with
    residuals ``errs``), in mesh order: one common scale, the mean of the
    shards' ``mean(|g + err|)``; each shard's signs (``x >= 0`` is +1, as
    the packed weight bits: NaN goes to -1 and -0.0 to +1) summed as
    int32, then ``total * scale / n``. Returns the mean and each shard's
    ``corrected - scale * sign``, its new residual, stacked ``[n, ...]``
    (this process's row under a process group)."""
    c, mine = _over_data(_corrected(gs, errs))
    n = c.shape[0]
    scale = _mesh_sum(torch.mean(torch.abs(c).reshape(n, -1), dim=1)) / n
    positive = c >= 0
    total = 2 * torch.sum(positive, dim=0, dtype=torch.int32) - n
    mean = total.to(torch.float32) * scale / n
    new_errs = c - torch.where(positive, scale, -scale)
    return mean, _rows(new_errs, mine)


def tree_compress_decompress(grads, err_state):
    """:func:`compress_decompress` on every leaf: (the dequantized grad
    tree, the new residual tree)."""
    pairs = [compress_decompress(g, e) for g, e in
             zip(tree.leaves(grads), tree.leaves(err_state))]
    deq, new_err = iter([p[0] for p in pairs]), iter([p[1] for p in pairs])
    return (tree.tree_map(lambda _: next(deq), grads),
            tree.tree_map(lambda _: next(new_err), grads))


__all__ = ["INT8_BITS_RATIO", "SIGNSGD_BITS_RATIO", "compress_decompress",
           "init_error_feedback", "psum_compressed", "psum_signsgd",
           "signsgd_compress_decompress", "tree_compress_decompress"]
