"""K1, the sparse 3D convolution (`csrc/sparse_conv.cu`): out[b, v] =
sum_k feats[b, kmap[b, k, v]] @ W[k] over the kernel map's live pairs."""

import torch

from benchmark.kernels.peaks import BF16_OPS_PER_S, nbytes

OP = "sparse_conv"
PATTERNS = ("sparse_conv_",)  # the tensor-core and FMA kernels and the split-K sum
PEAK_OPS_PER_S = BF16_OPS_PER_S


def work(call, itemsize):
    """(bytes, operations) of one call with activations and weights of
    `itemsize` bytes: the map columns of live outputs, each feature row a
    live output references once, the weights, bias, mask and output once;
    a multiply-add per live (tap, output) pair and channel pair."""
    feats, w, kmap, bias, valid = (call[k] for k in ("feats", "weights", "kmap", "bias",
                                                      "out_valid"))
    live = torch.ones((kmap.shape[0], kmap.shape[2]), dtype=torch.bool, device=kmap.device) \
        if valid is None else valid
    n_live = int(live.sum())
    rows = 0
    for i in range(kmap.shape[0]):
        m = kmap[i][:, live[i]]
        rows += int(torch.unique(m[m >= 0]).numel())
    hits = int(((kmap >= 0) & live[:, None, :]).sum())
    ops = 2 * hits * w.shape[1] * w.shape[2]
    out_numel = kmap.shape[0] * kmap.shape[2] * w.shape[2]
    moved = (kmap.shape[1] * n_live * kmap.element_size() + rows * feats.shape[2] * itemsize
             + nbytes(w, itemsize) + nbytes(bias, 4) + nbytes(valid, 1) + out_numel * itemsize)
    return moved, ops
