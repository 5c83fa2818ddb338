"""W8A8 (int8 weights and activations) dense and conv ops.

Counterpart of `xmask3d_tpu/ops/int8_quant.py`, a standalone op: as in the
JAX package, `XMASK3D_INT8` is wired into no model, so it changes nothing
the entry points run. The scheme is dynamic, with no calibration pass:

  - weights: symmetric per-output-channel scales (abs-max over the other
    axes / 127), rounded to int8 at apply time;
  - dense activations: symmetric per-token scales (abs-max over the
    contraction axis), so y * (s_x[:, None] * s_w[None, :]) rescales
    exactly;
  - conv activations: one per-tensor scale;
  - int32 accumulation, rescale in fp32, then the output dtype.

The int32 products are a library GEMM, as the JAX op is a plain XLA
`dot_general` (no TPU kernel is behind it): on CUDA `torch._int_mm` (its
operands padded with zeros to its shape rules, M > 16 and K, N multiples
of 8, which leaves the products exact), on the CPU a float64 matmul. The
conv goes through im2col. `QDense` / `QConv` keep `nn.Linear`'s and the
port's `Conv`'s parameters (the weight bridge's names and layouts) and
take the W8A8 path when `int8_enabled()` (`XMASK3D_INT8`, read in
`models/layers.py`) and both the contraction and the output are at least 64
wide.
"""

from __future__ import annotations

from typing import Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from xmask3d_tpu_torch.models.layers import Conv, int8_enabled, set_int8  # noqa: F401

_EPS = 1e-8
_MIN_QUANT_DIM = 64

Padding = Union[str, int, Sequence[Tuple[int, int]]]


def _quantize(xf: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)


def _scale(amax: torch.Tensor) -> torch.Tensor:
    """amax / 127 floored at 1e-8, by a true division on every device (a
    Python scalar divisor becomes a multiply by its reciprocal on CUDA,
    which may round one ulp otherwise)."""
    return torch.clamp(amax / torch.full_like(amax, 127.0), min=_EPS)


def quant_weight(w: torch.Tensor, out_dim: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(int8 weight, fp32 per-output-channel scale broadcastable to w): the
    abs-max over every axis but `out_dim`, / 127, floored at 1e-8."""
    wf = w.float()
    red = tuple(d for d in range(w.ndim) if d != out_dim % w.ndim)
    s = _scale(wf.abs().amax(dim=red, keepdim=True))
    return _quantize(wf, s), s


def int_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """int8 (M, K) @ int8 (K, N) -> int32 (M, N), exact. CUDA tensors go
    through `torch._int_mm`, zero-padded to M >= 17 and K, N multiples of 8
    and with b column-major; CPU tensors through a float64 matmul, exact
    since every product and partial sum is an integer below 2^53 (an int32
    matmul has no BLAS on the CPU)."""
    if a.device.type != "cuda":
        return (a.double() @ b.double()).to(torch.int32)
    m, k = a.shape
    n = b.shape[1]
    mp, kp, np_ = max(m, 17), -(-k // 8) * 8, -(-n // 8) * 8
    if (mp, kp) != (m, k):
        a = F.pad(a, (0, kp - k, 0, mp - m))
    if (kp, np_) != (k, n):
        b = F.pad(b, (0, np_ - n, 0, kp - k))
    out = torch._int_mm(a.contiguous(), b.t().contiguous().t())
    return out[:m, :n]


def quant_dot_int(x: torch.Tensor, w: torch.Tensor):
    """The int8 operands, their int32 product and the scales of
    `quant_dot`: (xq (..., K), wq (K, N), y int32 (..., N), s_x (..., 1),
    s_w (1, N))."""
    xf = x.float()
    sx = _scale(xf.abs().amax(dim=-1, keepdim=True))
    xq = _quantize(xf, sx)
    wq, sw = quant_weight(w, out_dim=1)
    y = int_matmul(xq.reshape(-1, xq.shape[-1]), wq).reshape(*xq.shape[:-1], wq.shape[1])
    return xq, wq, y, sx, sw


def quant_dot(x: torch.Tensor, w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """int8 x @ w with per-token activation scales; x (..., K), w (K, N)."""
    _, _, y, sx, sw = quant_dot_int(x, w)
    return (y.float() * sx * sw.reshape(-1)).to(dtype)


def _pads(padding: Padding, size: Sequence[int], kernel: Sequence[int],
          stride: Sequence[int]) -> Tuple[Tuple[int, int], Tuple[int, int]]:
    """((top, bottom), (left, right)) as XLA reads `padding`: "SAME"
    (the extra row or column low on the far side), "VALID", an int or
    per-axis pairs."""
    if padding == "VALID":
        return (0, 0), (0, 0)
    if padding == "SAME":
        out = []
        for n, k, s in zip(size, kernel, stride):
            total = max((-(-n // s) - 1) * s + k - n, 0)
            out.append((total // 2, total - total // 2))
        return tuple(out)
    if isinstance(padding, int):
        return (padding, padding), (padding, padding)
    return tuple((int(lo), int(hi)) for lo, hi in padding)


def quant_conv_int(x: torch.Tensor, w: torch.Tensor, stride: Sequence[int], padding: Padding):
    """The int8 operands, int32 product and scales of `quant_conv`: (xq
    NHWC, wq OIHW, y int32 NHWC, s_x (), s_w (O,))."""
    xf = x.float()
    sx = _scale(xf.abs().amax())
    xq = _quantize(xf, sx)
    wq, sw = quant_weight(w, out_dim=0)
    o, i, kh, kw = w.shape
    (pt, pb), (pl, pr) = _pads(padding, x.shape[1:3], (kh, kw), stride)
    # im2col on the int8 values held exactly in fp32, then back to int8
    xp = F.pad(xq.permute(0, 3, 1, 2).float(), (pl, pr, pt, pb))
    cols = F.unfold(xp, (kh, kw), stride=tuple(stride))  # (N, I*kh*kw, L)
    n = x.shape[0]
    ho = (xp.shape[2] - kh) // stride[0] + 1
    wo = (xp.shape[3] - kw) // stride[1] + 1
    a = cols.transpose(1, 2).reshape(-1, i * kh * kw).to(torch.int8)
    y = int_matmul(a, wq.reshape(o, -1).t())
    return xq, wq, y.reshape(n, ho, wo, o), sx, sw.reshape(-1)


def quant_conv(x: torch.Tensor, w: torch.Tensor, stride: Sequence[int], padding: Padding,
               dtype: torch.dtype) -> torch.Tensor:
    """int8 conv of NHWC x with an OIHW weight (the port's `Conv` layouts)
    and a per-tensor activation scale -> NHWC."""
    _, _, y, sx, sw = quant_conv_int(x, w, stride, padding)
    return (y.float() * sx * sw).to(dtype)


class QDense(nn.Linear):
    """`nn.Linear` that runs its matmul W8A8 when `int8_enabled()` and the
    layer is at least 64 wide both ways; otherwise the plain matmul in the
    input's dtype."""

    def forward(self, x):
        if int8_enabled() and self.in_features >= _MIN_QUANT_DIM \
                and self.out_features >= _MIN_QUANT_DIM:
            y = quant_dot(x, self.weight.t(), x.dtype)
        else:
            y = x @ self.weight.to(x.dtype).t()
        return y if self.bias is None else y + self.bias.to(y.dtype)


class QConv(Conv):
    """The port's `Conv` (NHWC tensors, OIHW weight) with the W8A8 path when
    `int8_enabled()` and both channel counts are at least 64; `padding` as
    XLA takes it ("SAME", "VALID", an int or per-axis pairs)."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int = 3, stride: int = 1,
                 padding: Padding = "SAME", bias: bool = True):
        super().__init__(in_ch, out_ch, kernel, stride=stride, padding=0, bias=bias)
        self.xla_padding = padding

    def forward(self, x):
        stride = (self.stride,) * 2 if isinstance(self.stride, int) else tuple(self.stride)
        o, i, kh, kw = self.weight.shape
        if int8_enabled() and min(i, o) >= _MIN_QUANT_DIM:
            y = quant_conv(x, self.weight, stride, self.xla_padding, x.dtype)
        else:
            (pt, pb), (pl, pr) = _pads(self.xla_padding, x.shape[1:3], (kh, kw), stride)
            y = F.conv2d(F.pad(x.permute(0, 3, 1, 2), (pl, pr, pt, pb)),
                         self.weight.to(x.dtype), stride=stride).permute(0, 2, 3, 1)
        return y if self.bias is None else y + self.bias.to(y.dtype)
