"""Carry params from the JAX package into the port.

``params_from_numpy`` takes the JAX package's params — the BNN's, latent
(``init_bnn_params`` / ``load_binary_checkpoint``) or fused-packed
(``pack_bnn_params_fused``: ``w_packed``, ``a``, ``b``), or an LM's
(``Model.init``, ``Model.pack``: ``layers`` a list over period positions
of dicts whose leaves carry the periods axis, int32 ``w_packed``,
``alpha``) — as nested dicts and lists of arrays, and returns the same
tree of torch tensors.
The keys and layouts of both packages agree, so nothing is renamed or
transposed. Every array is copied: ``np.asarray`` of a JAX array is
read-only, which ``torch.from_numpy`` would warn about and share.

This module imports neither JAX nor the JAX package: it reads anything
``np.array`` accepts.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.bnn import resolve_device


def params_from_numpy(params, *, device=None):
    """Nested dicts/lists/tuples of arrays -> the same tree of tensors on
    ``device`` (CUDA unless given), dtypes kept (float32, int32)."""
    dev = resolve_device(device)

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(conv(v) for v in x)
        return torch.from_numpy(np.array(x, copy=True)).to(dev)

    return conv(params)
