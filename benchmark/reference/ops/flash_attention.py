"""Attention for the SD UNet and VAE, plain: non-causal, unmasked
`softmax(Q K^T / sqrt(d)) V`, layout (B, H, T, D).
"""

from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

from benchmark.reference.ops.record import record


def reference_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Plain attention: fp32 scores, softmax, cast back to q's dtype. P stays
    fp32 here; the bf16 kernel rounds P to bf16 as the operand of P V only
    (its max and sum are fp32) and is held to this version all the same."""
    d = q.shape[-1]
    s = torch.einsum("bhqd,bhkd->bhqk", q.float() / math.sqrt(d), k.float())
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)



SLICE_SCORES = 1 << 28  # score elements of one slice (1 GiB in fp32)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The SD UNet's and VAE's attention: its plain formulation, a slice of
    (batch, head) pairs at a time so that no more than SLICE_SCORES scores
    live at once; under autograd each slice is checkpointed, so the backward
    forms its scores again."""
    record("attention", q=q, k=k, v=v)
    b, h, tq, d = q.shape
    pairs = max(1, SLICE_SCORES // (tq * k.shape[2]))
    if b * h <= pairs:
        return reference_attention(q, k, v)
    qf, kf, vf = (t.reshape(b * h, 1, t.shape[2], d) for t in (q, k, v))
    grad = torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v))
    outs = []
    for i in range(0, b * h, pairs):
        args = (qf[i:i + pairs], kf[i:i + pairs], vf[i:i + pairs])
        outs.append(checkpoint(reference_attention, *args, use_reentrant=False) if grad
                    else reference_attention(*args))
    return torch.cat(outs).reshape(b, h, tq, d)
