"""Attention for the SD UNet and VAE: kernel K2 and its plain version.

Counterpart of `xmask3d_tpu/ops/flash_attention.py`. Non-causal, unmasked
`softmax(Q K^T / sqrt(d)) V`, layout (B, H, T, D). On a CUDA tensor every
shape goes to the kernel (the ragged key edge is masked there); on a CPU
tensor the plain version runs.
"""

from __future__ import annotations

import ctypes
import math

import torch

from xmask3d_tpu_torch.ops import _build


def reference_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Plain attention: fp32 scores, softmax, cast back to q's dtype."""
    d = q.shape[-1]
    s = torch.einsum("bhqd,bhkd->bhqk", q.float() / math.sqrt(d), k.float())
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)


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
    b, h, tq, d = q.shape
    tk = k.shape[2]
    if d > 512 or tk == 0:
        raise ValueError(f"attention: head dim {d} / key length {tk} not supported")
    _build.require_contiguous("attention", q, k, v)
    _build.record("flash_attention", q, k, v)
    if q.device.type == "cpu":
        return reference_attention(q, k, v)
    out = torch.empty_like(q)
    lib = _build.load("flash_attention")
    fn = lib.xm_flash_attention_bf16 if q.dtype == torch.bfloat16 else lib.xm_flash_attention_f32
    err = fn(_build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(out),
             b * h, tq, tk, d, _build.stream(q.device))
    _build.check(err, "attention")
    attention.launches += 1
    return out


attention.launches = 0


def _bind(lib):
    for name in ("xm_flash_attention_f32", "xm_flash_attention_bf16"):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int


_build.BINDERS["flash_attention"] = _bind
