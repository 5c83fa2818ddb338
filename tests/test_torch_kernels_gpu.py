"""The port's CUDA kernels against their plain versions, on the card.

A CUDA kernel has no CPU mode, so every test here needs a GPU and skips
without one. The file imports nothing of JAX, so it runs on a machine that
has only PyTorch:

    python -m pytest --noconftest tests/test_torch_kernels_gpu.py

Tolerances on max |kernel - plain| relative to max(1, max |plain|): 1e-5 in
fp32 (summation order only), 2^-7 in bf16 (two ulps of the output).
"""

import numpy as np
import pytest
import torch

from xmask3d_tpu_torch.ops import deform_attn as tda
from xmask3d_tpu_torch.ops import flash_attention as tfa
from xmask3d_tpu_torch.ops import sparse_conv as tsc

pytestmark = pytest.mark.gpu
DTYPES = ((torch.float32, 1e-5), (torch.bfloat16, 2.0 ** -7))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _close(fn, plain, args, kwargs, tol):
    n = fn.launches
    got = fn(*args, **kwargs).float()
    torch.cuda.synchronize()
    assert fn.launches == n + 1
    ref = plain(*args, **kwargs).float()
    err = float((got - ref).abs().max())
    assert err <= tol * max(1.0, float(ref.abs().max())), err


@pytest.mark.parametrize("kernel,cin,cout", [(5, 3, 64), (3, 96, 128), (3, 13, 7), (2, 32, 32)])
def test_sparse_conv(cuda, kernel, cin, cout):
    """Stem (125 taps, C_in 3), k3, odd widths and a stride-2 down map, with
    missing neighbours and all-padding tiles."""
    rng = np.random.RandomState(kernel + cin)
    coords = np.unique(rng.randint(0, 24, size=(3000, 3)).astype(np.int32), axis=0)
    caps = (4096, 2048, 1024, 512, 256)
    h = tsc.build_hierarchy(coords, caps)
    kmap = {5: h.kmap5, 3: h.kmap3[0], 2: h.down[0]}[kernel][None]
    v_out = kmap.shape[2]
    feats = torch.from_numpy(rng.randn(1, caps[0], cin).astype(np.float32)).to(cuda)
    w = torch.from_numpy(rng.randn(kmap.shape[1], cin, cout).astype(np.float32)).to(cuda)
    valid = torch.from_numpy(np.arange(v_out) < int(h.num[1 if kernel == 2 else 0]))[None].to(cuda)
    bias = torch.from_numpy(rng.randn(cout).astype(np.float32)).to(cuda)
    kmap = torch.from_numpy(kmap).to(cuda)
    for dt, tol in DTYPES:
        _close(tsc.sparse_conv, tsc.sparse_conv_reference,
               (feats.to(dt), w.to(dt), kmap), dict(bias=bias, out_valid=valid), tol)


@pytest.mark.parametrize("tq,tk,d,h", [(4096, 4096, 40, 8), (1024, 77, 80, 8), (64, 64, 160, 8),
                                       (1000, 300, 40, 2), (4096, 4096, 512, 1)])
def test_flash_attention(cuda, tq, tk, d, h):
    rng = np.random.RandomState(tq + d)
    q, k, v = (torch.from_numpy(rng.randn(1, h, t, d).astype(np.float32)).to(cuda)
               for t in (tq, tk, tk))
    for dt, tol in DTYPES:
        _close(tfa.attention, tfa.reference_attention, (q.to(dt), k.to(dt), v.to(dt)), {}, tol)


def test_deform_attn(cuda):
    """The pixel decoder's shapes, with samples partly and wholly outside."""
    rng = np.random.RandomState(0)
    shapes = [(16, 16), (32, 32), (64, 64)]
    n = sum(a * b for a, b in shapes)
    value = torch.from_numpy(rng.randn(1, n, 8, 32).astype(np.float32)).to(cuda)
    loc = torch.from_numpy(rng.uniform(-0.2, 1.2, (1, n, 8, 3, 4, 2)).astype(np.float32)).to(cuda)
    aw = torch.softmax(torch.from_numpy(rng.randn(1, n, 8, 12).astype(np.float32)), -1)
    aw = aw.reshape(1, n, 8, 3, 4).to(cuda)
    for dt, tol in DTYPES:
        _close(tda.ms_deform_attn, tda.ms_deform_attn_reference, (value.to(dt), shapes, loc, aw), {}, tol)


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    x = torch.zeros(1, 8, 4, 16, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        tfa.attention(x.transpose(2, 3), x.transpose(2, 3), x.transpose(2, 3))
    with pytest.raises(TypeError):
        tfa.attention(x.half(), x.half(), x.half())
    feats = torch.zeros(1, 8, 4, device=cuda)
    kmap = torch.zeros(1, 27, 8, dtype=torch.int64, device=cuda)
    with pytest.raises(TypeError, match="int32"):
        tsc.sparse_conv(feats, torch.zeros(27, 4, 4, device=cuda), kmap)
    value = torch.zeros(1, 4, 2, 32, device=cuda)
    loc = torch.zeros(1, 3, 2, 1, 1, 2, device=cuda, dtype=torch.float64)
    with pytest.raises(TypeError, match="float32"):
        tda.ms_deform_attn(value, [(2, 2)], loc, torch.zeros(1, 3, 2, 1, 1, device=cuda))
