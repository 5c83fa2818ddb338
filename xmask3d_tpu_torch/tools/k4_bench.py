"""Kernel K4 (bf16) at the VAE's 34 call shapes of a 512 x 512 view, timed on
the card by CUDA graphs (device time, no host gaps between launches):

    python -m xmask3d_tpu_torch.tools.k4_bench

Per shape it prints, as JSON lines: the statistics kernels' device us a
call, the conv's us a call at the block width `kernel_plan` chooses and its
max error over the bf16 tolerance against the plain version, the conv at the
other block width (64 or 128 output channels a block), and the tensor-core
bound; then the conv ms and the statistics ms summed over a view's calls.
"""

from __future__ import annotations

import json
import sys

import torch

from xmask3d_tpu_torch.ops import _build
from xmask3d_tpu_torch.ops import gn_conv as g

# rows, columns, C, C_out, calls a view (the VAE encoder's blocks and mid
# blocks, the decoder's mid blocks and up blocks before its last tap)
SHAPES = [(512, 512, 128, 128, 4), (256, 256, 128, 256, 1), (256, 256, 256, 256, 3),
          (128, 128, 256, 512, 1), (128, 128, 512, 512, 7), (64, 64, 512, 512, 18)]


def graph_us(fn, reps: int = 20) -> float:
    """Device us a call: `reps` calls captured in a CUDA graph, replayed."""
    fn()
    torch.cuda.synchronize()
    stream = torch.cuda.Stream()
    with torch.cuda.stream(stream):
        fn()
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=stream):
            for _ in range(reps):
                fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps * 1e3


def main() -> int:
    if not torch.cuda.is_available():
        print("k4_bench: no CUDA device", file=sys.stderr)
        return 1
    lib = _build.load("gn_conv")
    torch.manual_seed(0)
    conv_total = stats_total = 0.0
    for h, w, c, cout, calls in SHAPES:
        x = torch.randn(1, h, w, c, device="cuda").bfloat16()
        scale = torch.rand(c, device="cuda") + 0.5
        bias = torch.randn(c, device="cuda") * 0.1
        wt = torch.randn(3, 3, c, cout, device="cuda") * (0.5 / (9 * c) ** 0.5)
        b = torch.randn(cout, device="cuda") * 0.1
        wk, bf = g.kernel_params(wt, b, torch.bfloat16)
        a, s = g.group_affine(x, scale, bias, 32, 1e-6)
        ref = g.gn_silu_conv_reference(x, scale, bias, wt, b).float()
        tol = 2.0 ** -7 * max(1.0, float(ref.abs().max()))
        _, bn = g.kernel_plan(torch.bfloat16, 1, h, w, cout)
        n_blocks, ppb, vec = g.stats_plan(h * w, c, torch.bfloat16)
        part = torch.empty(1, n_blocks, 32, 2, device="cuda", dtype=torch.float64)
        a2, s2 = torch.empty_like(a), torch.empty_like(s)
        stats_us = graph_us(lambda: lib.xm_gn_affine(
            _build.ptr(x), _build.ptr(part), _build.ptr(scale), _build.ptr(bias), _build.ptr(a2),
            _build.ptr(s2), 1, h * w, c, 32, n_blocks, ppb, vec, 1, 0, 1e-6,
            _build.stream(x.device)))
        stats_total += stats_us * calls
        out = torch.empty(1, h, w, cout, device="cuda", dtype=torch.bfloat16)

        def conv(width):
            return lib.xm_gn_silu_conv_bf16(
                _build.ptr(x), _build.ptr(a), _build.ptr(s), _build.ptr(wk), _build.ptr(bf),
                _build.ptr(out), 1, h, w, c, cout, width, 1, _build.stream(x.device))

        _build.check(conv(bn), "k4_bench")
        torch.cuda.synchronize()
        err = float((out.float() - ref).abs().max()) / tol
        us = graph_us(lambda: conv(bn))
        conv_total += us * calls
        other = 192 - bn
        print(json.dumps({"shape": [h, w, c, cout], "calls": calls, "bn": bn,
                          "stats_us": stats_us, "conv_us": us, "err_over_tol": err,
                          f"bn{other}_us": graph_us(lambda: conv(other)),
                          "bound_us": 18 * h * w * c * cout / 989e12 * 1e6}), flush=True)
    print(json.dumps({"view_ms_conv": conv_total / 1e3, "view_ms_stats": stats_total / 1e3}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
