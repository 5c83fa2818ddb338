"""Attention for the SD UNet and VAE: kernel K2 and its plain version.

Counterpart of `xmask3d_tpu/ops/flash_attention.py`. Non-causal, unmasked
`softmax(Q K^T / sqrt(d)) V`, layout (B, H, T, D). On a CUDA tensor every
shape goes to the kernel (the ragged key edge is masked there); on a CPU
tensor the plain version runs. `variant` names the kernel a call takes, from
its shapes and dtype alone: bf16 runs on the tensor cores, fp32 on CUDA cores.
The wrapper is differentiable: its backward is the plain version's VJP.
"""

from __future__ import annotations

import ctypes
import math
from typing import Tuple

import torch

from xmask3d_tpu_torch.ops import _build


def reference_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Plain attention: fp32 scores, softmax, cast back to q's dtype. P stays
    fp32 here; the bf16 kernel rounds P to bf16 as the operand of P V only
    (its max and sum are fp32) and is held to this version all the same."""
    d = q.shape[-1]
    s = torch.einsum("bhqd,bhkd->bhqk", q.float() / math.sqrt(d), k.float())
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)


# padded head dims of the tensor-core variants, and the most keys that fit the
# one-tile variant (no K/V ring); both mirror csrc/flash_attention.cu
MMA_WIDTHS = (48, 80, 128, 160, 512)
SINGLE_TILE_KEYS = 80


def kernel_plan(dtype: torch.dtype, tk: int, d: int) -> Tuple[str, int, bool]:
    """(variant name, padded head dim, one K/V tile) of the kernel that a call
    with `tk` keys of head dim `d` takes."""
    if d > MMA_WIDTHS[-1]:
        raise ValueError(f"attention: head dim {d} not supported")
    if dtype == torch.float32:
        return "fma_fp32", 0, False
    dp = next(w for w in MMA_WIDTHS if d <= w)
    if dp == 512:
        return "mma_d512", dp, False
    single = tk <= SINGLE_TILE_KEYS
    return f"mma_d{dp}" + ("_one_tile" if single else "_ring"), dp, single


def variant(q: torch.Tensor, k: torch.Tensor) -> str:
    """The kernel variant `attention(q, k, v)` launches on the card: a pure
    function of shapes and dtype."""
    return kernel_plan(q.dtype, k.shape[2], q.shape[3])[0]


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """q (B, H, Tq, D), k/v (B, H, Tk, D) -> (B, H, Tq, D): kernel K2 on
    CUDA tensors, the plain version on CPU ones (same checks on both)."""
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"attention: unsupported device {q.device}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"attention: unsupported dtype {q.dtype}")
    if q.ndim != 4 or k.shape != v.shape or k.shape[:2] != q.shape[:2] \
            or k.shape[3] != q.shape[3]:
        raise ValueError(
            f"attention: q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)}"
        )
    if k.dtype != q.dtype or v.dtype != q.dtype or k.device != q.device or v.device != q.device:
        raise ValueError("attention: q, k, v must share dtype and device")
    if k.shape[2] == 0:
        raise ValueError("attention: no keys")
    kernel_plan(q.dtype, k.shape[2], q.shape[3])  # raises on an unsupported head dim
    _build.require_contiguous("attention", q, k, v)
    _build.record("flash_attention", q, k, v)
    return _Attention.apply(q, k, v)


class _Attention(torch.autograd.Function):
    """K2 with the plain version's VJP as its backward (the JAX package's
    `_flash_diff`): the forward saves only q, k, v; the backward recomputes
    the fp32 scores of one call and frees them when it returns."""

    @staticmethod
    def forward(ctx, q, k, v):
        ctx.save_for_backward(q, k, v)
        if q.device.type == "cpu":
            return reference_attention(q, k, v)
        return _launch(q, k, v)

    @staticmethod
    def backward(ctx, g):
        return _build.plain_vjp(reference_attention, ctx.saved_tensors,
                                ctx.needs_input_grad, g)


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    b, h, tq, d = q.shape
    tk = k.shape[2]
    _, dp, single = kernel_plan(q.dtype, tk, d)
    out = torch.empty_like(q)
    lib = _build.load("flash_attention")
    args = (_build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(out), b * h, tq, tk, d)
    if q.dtype == torch.bfloat16:
        # 16-byte copies need rows and bases on 16 bytes; else scalar staging
        vec = d % 8 == 0 and all(t.data_ptr() % 16 == 0 for t in (q, k, v))
        err = lib.xm_flash_attention_bf16(*args, dp, int(single), int(vec),
                                          _build.stream(q.device))
    else:
        err = lib.xm_flash_attention_f32(*args, _build.stream(q.device))
    _build.check(err, "attention")
    attention.launches += 1
    return out


attention.launches = 0


def _bind(lib):
    for name, ints in (("xm_flash_attention_f32", 4), ("xm_flash_attention_bf16", 7)):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * ints + [ctypes.c_void_p]
        fn.restype = ctypes.c_int


_build.BINDERS["flash_attention"] = _bind
