"""Attention for the SD UNet and VAE: kernel K2 and its plain version.

Counterpart of `xmask3d_tpu/ops/flash_attention.py`. Non-causal, unmasked
`softmax(Q K^T / sqrt(d)) V`, layout (B, H, T, D). On a CUDA tensor every
shape goes to the kernel (the ragged key edge is masked there); on a CPU
tensor the plain version runs. `variant` names the kernel a call takes, from
its shapes and dtype alone: bf16 runs on the tensor cores, fp32 on CUDA cores.
The wrapper is differentiable. A bf16 CUDA call of head dim up to 160 that
autograd records also writes the rows' log-sum-exp and takes the kernels'
FlashAttention-2 backward (`backward_plan`; its plain statement is
`attention_backward_reference`); every other call the plain version's VJP.
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


def reference_attention_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """The forward that a recorded kernel call runs, in plain PyTorch: the
    output (as `reference_attention`) and each query row's log-sum-exp of the
    scaled fp32 scores, (B, H, Tq) fp32, kept as the kernel keeps it: the
    row's running max plus the log of its sum of exponentials."""
    d = q.shape[-1]
    s = torch.einsum("bhqd,bhkd->bhqk", q.float() / math.sqrt(d), k.float())
    m = s.amax(dim=-1, keepdim=True)
    e = torch.exp(s - m)
    total = e.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhqk,bhkd->bhqd", e / total, v.float()).to(q.dtype)
    return o, (m + torch.log(total)).squeeze(-1)


def attention_backward_reference(q, k, v, lse, do):
    """The kernels' backward in plain PyTorch, fp32 (what `attn_bwd_*`
    compute, without their bf16 operand rounding): from the inputs, the
    forward's row log-sum-exp `lse` and the output gradient `do`, (dq, dk,
    dv) through P = exp(S / sqrt(d) - lse), dP = do V^T, D = rowsum(P * dP)
    (rowsum(do * O) for the unrounded output) and dS = P * (dP - D)."""
    d = q.shape[-1]
    q, k, v, do = (t.float() for t in (q, k, v, do))
    p = torch.exp(torch.einsum("bhqd,bhkd->bhqk", q, k) / math.sqrt(d) - lse[..., None])
    dv = torch.einsum("bhqk,bhqd->bhkd", p, do)
    dp = torch.einsum("bhqd,bhkd->bhqk", do, v)
    ds = p * (dp - (p * dp).sum(-1, keepdim=True))
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, k) / math.sqrt(d)
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q) / math.sqrt(d)
    return dq, dk, dv


# padded head dims of the tensor-core variants, and the most keys that fit the
# one-tile variant (no K/V ring); both mirror csrc/flash_attention.cu
MMA_WIDTHS = (48, 80, 128, 160, 512)
SINGLE_TILE_KEYS = 80
# padded head dims of the kernels' backward (and of the forward that writes
# lse for it)
BACKWARD_WIDTHS = (48, 80, 160)


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


def backward_plan(dtype: torch.dtype, d: int) -> int:
    """The padded head dim of the kernels' backward that a CUDA call of head
    dim `d` takes when autograd records it, or 0: the plain version's VJP
    (fp32, and head dims past 160). CPU calls always take the plain VJP."""
    if dtype != torch.bfloat16 or d > BACKWARD_WIDTHS[-1]:
        return 0
    return next(w for w in BACKWARD_WIDTHS if d <= w)


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
    recorded = torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                            or v.requires_grad)
    return _Attention.apply(q, k, v, recorded)


class _Attention(torch.autograd.Function):
    """K2 and its backward. A CUDA call that autograd records and that
    `backward_plan` gives a width runs the forward that also writes lse,
    saves q, k, v and lse, and takes the kernels' backward
    (`_launch_backward`); any other call saves q, k, v and takes the plain
    version's VJP (the JAX package's `_flash_diff`), which recomputes the
    fp32 scores of one call and frees them when it returns. The backward
    launches through the library, not `attention`: the recorder and
    `attention.launches` see forward calls only; `backward_calls` counts the
    backwards by route."""

    @staticmethod
    def forward(ctx, q, k, v, recorded):
        ctx.kernels = recorded and q.device.type == "cuda" and bool(
            backward_plan(q.dtype, q.shape[3]))
        if ctx.kernels:
            out, lse = _launch(q, k, v, with_lse=True)
            ctx.save_for_backward(q, k, v, lse)
            return out
        ctx.save_for_backward(q, k, v)
        if q.device.type == "cpu":
            return reference_attention(q, k, v)
        return _launch(q, k, v)[0]

    @staticmethod
    def backward(ctx, g):
        needs = ctx.needs_input_grad[:3]
        if not ctx.kernels:
            attention.backward_calls["plain"] += 1
            return (*_build.plain_vjp(reference_attention, ctx.saved_tensors, needs, g), None)
        attention.backward_calls["kernel"] += 1
        return (*_launch_backward(*ctx.saved_tensors, g, needs), None)


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, with_lse: bool = False):
    """(output, lse): with `with_lse` (bf16, d <= 160) the forward runs at the
    backward's padded width and also writes the (B, H, Tq) fp32 log-sum-exp,
    else lse is None."""
    b, h, tq, d = q.shape
    tk = k.shape[2]
    _, dp, single = kernel_plan(q.dtype, tk, d)
    out = torch.empty_like(q)
    lse = torch.empty((b, h, tq), dtype=torch.float32, device=q.device) if with_lse else None
    lib = _build.load("flash_attention")
    args = (_build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(out))
    dims = (b * h, tq, tk, d)
    if q.dtype == torch.bfloat16:
        # 16-byte copies need rows and bases on 16 bytes; else scalar staging
        vec = d % 8 == 0 and all(t.data_ptr() % 16 == 0 for t in (q, k, v))
        err = lib.xm_flash_attention_bf16(*args, _build.ptr(lse), *dims,
                                          backward_plan(q.dtype, d) if with_lse else dp,
                                          int(single), int(vec), _build.stream(q.device))
    else:
        err = lib.xm_flash_attention_f32(*args, *dims, _build.stream(q.device))
    _build.check(err, "attention")
    attention.launches += 1
    return out, lse


def _launch_backward(q, k, v, lse, g, needs):
    """dq, dk, dv (None where `needs` is False) on the card: D (`attn_bwd_rowdot`),
    then `attn_bwd_dkdv` and `attn_bwd_dq`, each skipped when its gradients
    are not needed. `g` may be any view whose
    rows are contiguous (autograd hands over the transpose of the heads)."""
    b, h, tq, d = q.shape
    tk = k.shape[2]
    if g.stride(3) != 1:
        g = g.contiguous()
    dq = torch.empty_like(q) if needs[0] else None
    dk, dv = (torch.empty_like(k), torch.empty_like(v)) if needs[1] or needs[2] else (None, None)
    dd = torch.empty((b, h, tq), dtype=torch.float32, device=q.device)
    # 16-byte copies: rows and bases on 16 bytes, dO's strides included
    vec = d % 8 == 0 and all(t.data_ptr() % 16 == 0 for t in (q, k, v, g)) \
        and all(st % 8 == 0 for st in g.stride()[:3])
    lib = _build.load("flash_attention")
    err = lib.xm_attn_backward_bf16(
        _build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(g),
        _build.ptr(lse), _build.ptr(dd), _build.ptr(dq), _build.ptr(dk), _build.ptr(dv),
        b, h, tq, tk, d, g.stride(0), g.stride(1), g.stride(2), backward_plan(q.dtype, d),
        int(vec), _build.stream(q.device))
    _build.check(err, "attention backward")
    return dq, dk if needs[1] else None, dv if needs[2] else None


attention.launches = 0
# backwards by route: "kernel" the kernels' FlashAttention-2 backward, "plain"
# the plain version's VJP
attention.backward_calls = {"kernel": 0, "plain": 0}


def _bind(lib):
    for name, ptrs, ints in (("xm_flash_attention_f32", 4, 4), ("xm_flash_attention_bf16", 5, 7),
                             ("xm_attn_backward_bf16", 9, 10)):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * ptrs + [ctypes.c_int] * ints + [ctypes.c_void_p]
        fn.restype = ctypes.c_int


_build.BINDERS["flash_attention"] = _bind
