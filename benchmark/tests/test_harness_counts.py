"""Each kernel's bytes and operations, and the forward's operation count,
against sums worked out by hand at small shapes."""

from __future__ import annotations

import torch

from benchmark.harness import work
from benchmark.kernels import k1, k2, k3
from benchmark.kernels.peaks import BF16_OPS_PER_S, HBM_BYTES_PER_S
from benchmark.reference.ops.deform_attn import ms_deform_attn
from benchmark.reference.ops.flash_attention import attention
from benchmark.reference.ops.sparse_conv import sparse_conv


def small_conv():
    # one sample, 4 input rows (C_in 2), 3 output slots of which 2 live,
    # 2 taps (C_out 5); live pairs: slot 0 taps (0, 1), slot 1 tap 1
    feats = torch.arange(8, dtype=torch.float32).reshape(1, 4, 2)
    w = torch.ones(2, 2, 5)
    kmap = torch.tensor([[[0, -1, 3], [2, 2, 1]]], dtype=torch.int32)
    valid = torch.tensor([[True, True, False]])
    return {"feats": feats, "weights": w, "kmap": kmap, "bias": None, "out_valid": valid}


def test_k1_work_by_hand():
    call = small_conv()
    moved, ops = k1.work(call, 2)
    # 3 live pairs x 2 x 5 multiply-adds
    assert ops == 2 * 3 * 2 * 5
    # map columns of the 2 live slots (2 taps x 2 x 4 B), the 2 distinct rows
    # they read (rows 0 and 2: 2 x 2 ch x 2 B), weights 20 x 2 B, the mask
    # 3 x 1 B, the output 3 slots x 5 ch x 2 B
    assert moved == 2 * 2 * 4 + 2 * 2 * 2 + 20 * 2 + 3 + 3 * 5 * 2


def test_k2_work_by_hand():
    q = torch.zeros(2, 3, 5, 8)
    k = torch.zeros(2, 3, 7, 8)
    moved, ops = k2.work({"q": q, "k": k, "v": k}, 2)
    assert ops == 4 * 2 * 3 * 5 * 7 * 8
    assert moved == 2 * (2 * 3 * 5 * 8) * 2 + 2 * (2 * 3 * 7 * 8) * 2


def test_k3_work_by_hand():
    value = torch.zeros(1, 4 * 4 + 2 * 2, 2, 8)
    loc = torch.zeros(1, 6, 2, 2, 3, 2)
    aw = torch.zeros(1, 6, 2, 2, 3)
    moved, ops = k3.work({"value": value, "loc": loc, "aw": aw}, 2)
    assert ops == 8 * 6 * 2 * 2 * 3 * 8
    assert moved == value.numel() * 2 + loc.numel() * 4 + aw.numel() * 4 + 6 * 2 * 8 * 2


def test_bounds_and_flops_of_recorded_calls():
    """The recorder sees the reference's ops; the flop count takes the
    sparse conv over its live pairs and the dense ops as the counter does."""
    call = small_conv()
    q = torch.randn(1, 2, 16, 8)
    value = torch.randn(1, 20, 2, 8)
    loc = torch.rand(1, 6, 2, 2, 3, 2)
    aw = torch.rand(1, 6, 2, 2, 3)
    x = torch.randn(3, 4)
    y = torch.randn(4, 6)

    def fn():
        sparse_conv(call["feats"], call["weights"], call["kmap"], out_valid=call["out_valid"])
        attention(q, q, q)
        ms_deform_attn(value, [(4, 4), (2, 2)], loc, aw)
        return x @ y

    _, w, flops = work.count(fn)
    assert w.calls == {"k1": 1, "k2": 1, "k3": 1}
    m1, o1 = k1.work(call, 2)
    assert abs(w.bound_s["k1"] - max(m1 / HBM_BYTES_PER_S, o1 / BF16_OPS_PER_S)) < 1e-18
    # sparse conv: 3 live pairs; attention: 2 products of 2 x 16 x 16 x 8
    # a head; the plain matmul 2 x 3 x 4 x 6; the sampling's einsum a level:
    # 2 x (6 queries x 2 heads x 3 points x 8 channels)
    expected = 2 * 3 * 2 * 5 + 4 * 2 * 16 * 16 * 8 + 2 * 3 * 4 * 6 + 2 * (2 * 6 * 2 * 3 * 8)
    assert flops == expected


def test_transposed_and_pointwise_live_rows():
    from benchmark.reference.models.minkunet import SparseConv
    from benchmark.reference.ops.sparse_conv import sparse_conv_transpose

    feats = torch.randn(1, 3, 4)
    w = torch.randn(8, 4, 6)
    parent = torch.tensor([[0, 1, -1, 2, -1]], dtype=torch.int32)
    octant = torch.zeros(1, 5, dtype=torch.int32)
    conv = SparseConv(4, 6, 1)
    valid = torch.tensor([[True, False, True]])

    def fn():
        sparse_conv_transpose(feats, w, parent, octant)
        return conv(feats, None, out_valid=valid)

    _, _, flops = work.count(fn)
    # 3 fine rows with a parent, 2 live rows of the 1x1 conv
    assert flops == 2 * 3 * 4 * 6 + 2 * 2 * 4 * 6


def test_traced_cells_count_their_work():
    """A traced tiny run counts each kernel's calls and the operations a
    view or a step needs (the profiler's readings are the card's)."""
    from benchmark.tests import tiny

    record, _, _ = tiny.run("b15n4.serve_scan", trace=True)
    vw = record["view_work"]
    assert vw["flops"] > 0 and all(vw["calls"][k] > 0 for k in ("k1", "k2", "k3"))
    assert all(vw["bound_s"][k] > 0 for k in ("k1", "k2", "k3"))
    record, _, _ = tiny.run("b170n30.train_b8", trace=True)
    assert record["step_flops"] > 0
    assert record["step_work"]["calls"]["k1"] > 0 and record["step_work"]["calls"]["k2"] > 0
