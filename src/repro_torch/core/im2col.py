"""im2col / col2im — the paper's §2.1 convolution lowering, in PyTorch.

Same layout as ``repro.core.im2col``: :func:`im2col` returns batch-major
patches ``[N, OH*OW, kH*kW*C]``, element index ``(h*kW + w)*C + c``
within a patch. Callers transpose at the GEMM (``x2d.T``), never here.
On channel-packed int32 maps (``pad_value=-1``) the word index within a
patch is ``(h*kW + w)*CW + cw``, the tap-aligned filter layout of
``repro_torch.core.layers.pack_conv_aligned``.
"""

from __future__ import annotations

import torch


def conv_out_size(size: int, k: int, stride: int, pad: int) -> int:
    return (size + 2 * pad - k) // stride + 1


def im2col(x: torch.Tensor, kh: int, kw: int, stride: int = 1, pad: int = 0,
           pad_value=0):
    """[N, H, W, C] -> (patches [N, OH*OW, kH*kW*C], (OH, OW)).

    ``pad_value`` is the border fill: 0 for real-valued maps, -1 (all
    bits set = +1) for channel-packed words.
    """
    n, h, w, c = x.shape
    oh = conv_out_size(h, kh, stride, pad)
    ow = conv_out_size(w, kw, stride, pad)
    if pad:
        x = torch.nn.functional.pad(x, (0, 0, pad, pad, pad, pad),
                                    value=pad_value)
    cols = [
        x[:, i:i + stride * oh:stride, j:j + stride * ow:stride, :]
        for i in range(kh) for j in range(kw)
    ]
    patches = torch.stack(cols, dim=3)  # [N, OH, OW, kH*kW, C]
    return patches.reshape(n, oh * ow, kh * kw * c), (oh, ow)


def filters_to_matrix(w: torch.Tensor) -> torch.Tensor:
    """[D, kH, kW, C] -> [D, kH*kW*C] matching :func:`im2col` ordering."""
    return w.reshape(w.shape[0], -1)


def col2im(y: torch.Tensor, oh: int, ow: int) -> torch.Tensor:
    """GEMM output [N, OH*OW, D] -> feature map [N, OH, OW, D]."""
    n, _, d = y.shape
    return y.reshape(n, oh, ow, d)
