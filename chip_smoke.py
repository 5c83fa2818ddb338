#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`xmask3d_tpu_torch`) on one GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure:
  1. build the CUDA kernels from `xmask3d_tpu_torch/csrc/` (one nvcc each,
     in parallel) and log what ptxas reports per kernel (registers, spills);
  2. build the full-width B15N4 model in bf16 with seeded weights drawn on
     the card, its statics through the CLIP text tower, and four synthetic
     views at the bench's default capacities (32768 points, 24576 voxels,
     512x512 image, 77-token context);
  3. run one warm-up view while recording every kernel call (through the
     wrappers' recorder hook), then hold each kernel against its plain
     PyTorch version on those recorded inputs, call by call (in bf16 as
     recorded, and again in fp32), and time both per view by CUDA events
     around a view's launches (`ms`, which includes the gaps in which the
     card waits for the host); also per shape (`by_shape`: variant,
     launches, ms, bound and, for K2, `scaled_dot_product_attention`, for
     K4 the port's unfused stages), K1's share of skipped (16-row strip,
     tap) steps per level and the bytes K3's taps gather;
  4. one uncounted view to refill the allocator's cache, then the main
     path: three views through the serving view body (forward,
     routing, vote) with every launch counter set to 0 first; checks the
     launch counts, that every bf16 call of K1 and K2 took a tensor-core
     variant and of K3 the 16-byte-gather one (counted per variant), the
     vote table and the outputs;
     `graph_main_path`: the same path as CUDA graphs (`make_infer_step` and
     the scene scan's view body, each captured once at these capacities;
     the counts, set to 0 before, see the warm-ups and the captures):
     replayed views equal eager ones (labels, coverage, routing and the
     vote table exactly; the float outputs' largest gap is logged and held
     to the bf16 tolerance), and the host clock a view over 12 interleaved
     pairs of the eager and the replayed view body;
     `scene_scan`: the bench's shape, one synthetic scene of 30 views
     cycling 6 distinct ones through `make_scene_scan_step`, its votes equal
     to per-view eager dispatch, scenes/s and ms a view of both (runs scan,
     eager, eager, scan);
     `bench`: `xmask3d_tpu_torch/tools/bench.py` at its defaults (3 scenes
     of 30 views) in scan, per-view and include-host mode, in this process,
     each printing its JSON line, with finite scenes/s;
     then it profiles one eager and one replayed view (device time by
     kernel, the device's idle share; the replayed view's launches read from
     the kernel names, since the wrappers' counters do not see replays), and
     only then takes each kernel's device-busy time on its recorded calls
     from the profiler (`device_ms`, per shape): once used, the profiler
     slows every later launch on the host; before that, `device_hierarchy`:
     the counted views with the hierarchy built on the device inside
     `make_infer_step`'s graph: the hierarchy equal to the host builder's in
     sorted-key order, replayed views equal to eager and to the host-built
     views in that row order (labels, coverage, routing), the label
     agreement with the host-built views in their own row order; the
     build's and K1's device ms under either hierarchy, and the bytes a view
     copies in under either route;
  5. whole scenes at full width with the VAE's GroupNorm -> SiLU -> conv3x3
     stages on kernel K4 (`fused_gn`): the same seeded weights, two
     synthetic scenes of 40000 points and 8 views each through the
     whole-scene CLI's `run_eval_scenes` (per-view forward and routing,
     multi-view votes, KD-tree fill, IoU meters). A warm-up run of the
     scenes' fullest view through the eager body records every kernel's
     calls, which are held against their plain versions (bf16 and fp32; K4
     also timed beside the port's unfused stages, and its statistics
     kernels on their own); the `kernels` line takes K4's row from here;
     then `make_infer_step`'s graph is captured and the scenes run eager,
     then on the graph with the numpy and the C++ kernel-map builder in
     turns (numpy, native, native, numpy), then eager; the graph runs'
     per-view host time by stage is logged per builder (`host_pipeline`),
     and `native_kmaps` holds the two builders equal on every view (and
     whole scene) of these scenes with their host ms; the eager runs check
     every kernel's launches (K4's statistics once per conv), that every
     bf16 K4 call took a tensor-core
     variant, the votes, the fill and the summaries; the graph runs launch
     nothing outside their graph and equal the eager run exactly
     (predictions, votes, summaries); a replayed view is profiled for its
     launches;
     `scene_reuse`: the same scenes through `run_eval_scenes(scene_reuse=
     True)`, one 3D pass a scene at 4x the view's capacities (131072
     points, 98304 voxels) and a 2D pass a view, both captured: K1's calls
     at scene capacities recorded from an eager pass and held against the
     plain version (bf16 and fp32, per shape with variant, time and bound),
     the votes, the fill, finite summaries, s/scene beside phase 5's, and
     each replayed step's launches from the profiler;
  6. training at full width (`train_phase`): the serving models freed, the
     B15N4 model built for training (bf16 parameters, fp32 AdamW masters of
     the trainable groups, SD and CLIP frozen) and driven through the
     trainer's train step on synthetic batches of two views. A warm-up step
     records every kernel call of its forward pass, which are held against
     their plain versions (bf16 and fp32); one call of each kernel is taken
     back through its autograd Function and held against the plain
     version's autograd on the same inputs; three counted steps check the
     launches a step, the variants, every loss, each trainable group's
     gradient (both 3D UNets apart), that no frozen parameter has a
     gradient, and that the masters and the BatchNorm statistics moved;
     a profiled step gives the device's busy time and each kernel's forward
     and plain-backward device ms;
  7. the tiny model on the card (fp32, kernels) against the same model on
     the CPU (plain versions), unfused and with `fused_gn`, and one training
     step of it, losses and gradients leaf by leaf.

The last line of standard output is `{"ok": true, "device": {...}}`; the
line before it is the `kernels` JSON object, and the one before that the
card's name and power limit from nvidia-smi. Exits non-zero, printing no
result, without CUDA or outside a checkout of the repository.
"""

from __future__ import annotations

import contextlib
import copy
import gc
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(ROOT, "configs", "scannet", "xmask3d_scannet_B15N4.yaml")

HBM_BYTES_PER_S = 3.35e12  # H100 SXM
PEAK_OPS = {"bf16": 989e12, "fp32": 67e12}  # dense tensor-core bf16; fp32 off the tensor cores

# per-kernel tolerance on max |kernel - plain|, relative to max(1, max |plain|):
# bf16 outputs round at 2^-8 relative, so two output ulps; fp32 differs only
# by summation order
TOL = {"bf16": 2.0 ** -7, "fp32": 1e-4}

# the scene phase: synthetic scenes at the bench's image size and capacities
SCENES, SCENE_POINTS, SCENE_VIEWS = 2, 40000, 8


def log(obj) -> None:
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout
    return out.strip().splitlines()[0]


# --------------------------------------------------------------------------
# expected launches per view, derived from the configuration
# --------------------------------------------------------------------------


def expected_launches(mc) -> dict:
    from xmask3d_tpu_torch.models.minkunet import _VARIANTS

    # K1: the fused k5 stem, then per net 4 stride-2 down convs and two
    # k3 convs per residual block
    k1 = 1 + sum(4 + 2 * sum(_VARIANTS[a][1]) for a in (mc.arch_3d, mc.arch_binary_head))
    # K2: self + cross attention per SD UNet spatial transformer that runs
    # before the last tap is taken, plus the VAE encoder and decoder mid blocks
    u = mc.ldm.unet
    n_lv = len(u.ch_mult)
    blocks = sum(u.num_res_blocks for lv in range(n_lv) if lv in u.attention_levels) + 1
    last, idx = max(mc.ldm.unet_block_indices), 0
    for lv in reversed(range(n_lv)):
        for _ in range(u.num_res_blocks + 1):
            if idx < last and lv in u.attention_levels:
                blocks += 1
            idx += 1
    k2 = 2 * blocks * len(mc.ldm.steps) + 2
    # K4 (with fused_gn): two GN -> SiLU -> conv stages per VAE resblock;
    # the encoder runs all of its blocks and two mid blocks, the decoder its
    # two mid blocks and the up blocks before its last tap
    v = mc.ldm.vae
    enc = len(v.ch_mult) * v.num_res_blocks + 2
    dec = 2 + min(max(mc.ldm.decoder_block_indices), len(v.ch_mult) * (v.num_res_blocks + 1))
    k4 = 2 * (enc + dec) if mc.fused_gn else 0
    # K3: one sampling call per deformable encoder layer
    return {"sparse_conv": k1, "flash_attention": k2, "deform_attn": mc.pixel_enc_layers,
            "gn_silu_conv": k4}


# --------------------------------------------------------------------------
# recording the main path's kernel calls
# --------------------------------------------------------------------------


def kernel_table():
    from xmask3d_tpu_torch.ops import deform_attn, flash_attention, gn_conv, sparse_conv

    return {
        "sparse_conv": {
            "fn": sparse_conv.sparse_conv, "plain": sparse_conv.sparse_conv_reference,
            "variant": lambda call: sparse_conv.variant(call[0], call[1], call[2]),
            # taps, C_in, C_out, output rows
            "shape": lambda call: (call[1].shape[0], call[1].shape[1], call[1].shape[2],
                                   call[2].shape[2]),
            "source": "xmask3d_tpu_torch/csrc/sparse_conv.cu",
            "replaces": "xmask3d_tpu/ops/sparse_conv_pallas.py:279",
        },
        "flash_attention": {
            "fn": flash_attention.attention, "plain": flash_attention.reference_attention,
            "variant": lambda call: flash_attention.variant(call[0], call[1]),
            # heads, queries, keys, head dim
            "shape": lambda call: (call[0].shape[1], call[0].shape[2], call[1].shape[2],
                                   call[0].shape[3]),
            "source": "xmask3d_tpu_torch/csrc/flash_attention.cu",
            "replaces": "xmask3d_tpu/ops/flash_attention.py:65",
        },
        "deform_attn": {
            "fn": deform_attn.ms_deform_attn, "plain": deform_attn.ms_deform_attn_reference,
            "variant": lambda call: deform_attn.variant(call[0], call[2]),
            # batch, queries, heads, head dim, levels, points
            "shape": lambda call: (*call[2].shape[:3], call[0].shape[3], *call[2].shape[3:5]),
            "source": "xmask3d_tpu_torch/csrc/deform_attn.cu",
            "replaces": "xmask3d_tpu/ops/deform_attn.py:190",
        },
        "gn_silu_conv": {
            "fn": gn_conv.gn_silu_conv, "plain": gn_conv.gn_silu_conv_reference,
            "variant": lambda call: gn_conv.variant(call[0], call[3]),
            # batch, rows, columns, C, C_out
            "shape": lambda call: (*call[0].shape, call[3].shape[3]),
            "source": "xmask3d_tpu_torch/csrc/gn_conv.cu",
            "replaces": "xmask3d_tpu/ops/gn_conv.py:141",
        },
    }


def _clone(x):
    import torch

    if torch.is_tensor(x):
        return x.detach().clone()
    return copy.deepcopy(x)


@contextlib.contextmanager
def recording(calls):
    """Keep a copy of the (positional) arguments of every call of the kernel
    wrappers named in `calls`, through the wrappers' recorder hook, then
    unset the hook."""
    from xmask3d_tpu_torch.ops import _build

    def rec(name, args):
        if name in calls:
            calls[name].append(tuple(_clone(a) for a in args))

    _build.RECORDER = rec
    try:
        yield
    finally:
        _build.RECORDER = None


@contextlib.contextmanager
def counting_variants(table, counts):
    """Count, per kernel that names its variants, the variant each call takes
    (through the recorder hook, which every wrapper calls once per call)."""
    from xmask3d_tpu_torch.ops import _build

    def rec(name, args):
        if "variant" in table.get(name, ()):
            v = table[name]["variant"](args)
            counts.setdefault(name, {})
            counts[name][v] = counts[name].get(v, 0) + 1

    _build.RECORDER = rec
    try:
        yield
    finally:
        _build.RECORDER = None


# the variants a bf16 call of the path must take: tensor cores for K1, K2 and
# K4, the 16-byte gathers for K3
FAST_VARIANTS = {"sparse_conv": ("mma_",), "flash_attention": ("mma_",),
                 "gn_silu_conv": ("wgmma_",), "deform_attn": ("vec_",)}


def check_variants(counts, expected, n_views) -> None:
    """Every bf16 call of the path's kernels must take a fast variant. A
    kernel the path does not run has an expected count of 0; one with no
    expected count at all is an error."""
    for name, prefixes in FAST_VARIANTS.items():
        if name not in expected:
            raise KeyError(f"{name}: no expected launch count")
        if expected[name] == 0:
            continue
        got = counts.get(name, {})
        if sum(got.values()) != expected[name] * n_views:
            raise AssertionError(f"{name}: variants {got} do not add up to "
                                 f"{expected[name] * n_views} calls")
        off = {v: n for v, n in got.items() if not v.startswith(prefixes)}
        if off:
            raise AssertionError(f"{name}: bf16 calls on a CUDA-core or scalar variant, "
                                 f"not {prefixes}: {off}")


def launches():
    """Each kernel's launch count; K4's statistics (two kernels, one count a
    call) beside K4."""
    from xmask3d_tpu_torch.ops.gn_conv import group_affine

    counts = {name: k["fn"].launches for name, k in kernel_table().items()}
    counts["gn_statistics"] = group_affine.launches
    return counts


def reset_launches():
    from xmask3d_tpu_torch.ops.gn_conv import group_affine

    for k in kernel_table().values():
        k["fn"].launches = 0
    group_affine.launches = 0


# --------------------------------------------------------------------------
# kernel checks and timings on the recorded calls
# --------------------------------------------------------------------------


def as_fp32(call):
    import torch

    return tuple(a.float() if torch.is_tensor(a) and a.is_floating_point() else a
                 for a in call)


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def work(name, call, out):
    """(bytes the function must move, operations it needs) for one call,
    counted from this call's data."""
    import torch

    if name == "sparse_conv":
        feats, w, kmap, bias, valid = call
        live = torch.ones(kmap.shape[::2], dtype=torch.bool, device=kmap.device) \
            if valid is None else valid
        # map columns of live outputs only (tiles with no live row are
        # skipped), and each feature row that a live output references, once
        n_live = int(live.sum())
        rows = sum(int(torch.unique(kmap[i][:, live[i]][kmap[i][:, live[i]] >= 0]).numel())
                   for i in range(kmap.shape[0]))
        hits = (kmap >= 0) & live[:, None, :]
        ops = 2 * int(hits.sum()) * w.shape[1] * w.shape[2]
        moved = (kmap.shape[1] * n_live * kmap.element_size()
                 + rows * feats.shape[2] * feats.element_size()
                 + nbytes(w, bias, valid, out))
        return moved, ops
    if name == "flash_attention":
        q, k, v = call
        b, h, tq, d = q.shape
        return nbytes(q, k, v, out), 4 * b * h * tq * k.shape[2] * d
    if name == "gn_silu_conv":
        # x and the output once, the norm and conv parameters; a multiply-add
        # per tap, input and output channel of every output pixel
        x, scale, bias, w, b = call[:5]
        bsz, h, wd, c = x.shape
        return nbytes(x, scale, bias, w, b, out), 2 * bsz * h * wd * w.shape[3] * 9 * c
    value, _, loc, aw = call
    b, lq, heads, n_lv, npts, _ = loc.shape
    # four taps, one multiply-add per channel each
    return nbytes(value, loc, aw, out), 8 * b * lq * heads * n_lv * npts * value.shape[3]


def bound(name, calls, outs):
    """(least ms for the calls, "bytes" or "operations"): per call the larger
    of its bytes over the memory rate and its operations over the peak rate
    of their type (bf16 tensor cores, or fp32 for the deformable sampling,
    whose bilinear weights are fp32)."""
    peak = PEAK_OPS["fp32"] if name == "deform_attn" else PEAK_OPS["bf16"]
    times = [(b / HBM_BYTES_PER_S, ops / peak) for b, ops in
             (work(name, c, o) for c, o in zip(calls, outs))]
    total = sum(max(t) for t in times) * 1e3
    by_bytes = sum(t[0] for t in times) >= sum(t[1] for t in times)
    return total, "bytes" if by_bytes else "operations"


def time_calls(fn, calls, reps: int) -> float:
    """Device ms for one pass over `calls` (a view's worth of launches)."""
    import torch

    for args in calls:
        fn(*args)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        for args in calls:
            fn(*args)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(jobs, reps: int) -> list:
    """Device-busy ms for one pass over each job's calls; a job is
    (fn, calls). The summed durations of the kernels and copies the calls put
    on the card, from torch.profiler. Unlike `time_calls` it leaves out the
    gaps in which the card waits for the host's next launch, which dominate
    once a kernel takes a few microseconds.

    The profiler can lose records: a stretch of them in a long session, all
    of them in a session of a few short kernels. So all jobs run in one
    session behind some throwaway launches, and each job starts with three
    marker kernels that split the card's timeline (on one stream it is in
    launch order); a run of markers is one boundary, so a lost marker costs
    nothing and a lost kernel its few microseconds. A session that does not
    show every boundary and work behind each is taken again, with another
    number of throwaway launches so that the records fall differently; after
    four such sessions the times are None and the log says so."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    mark = torch.zeros(1, device="cuda")
    for fn, calls in jobs:
        for args in calls:
            fn(*args)
    torch.cuda.synchronize()
    for attempt in range(4):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(50 + 37 * attempt):
                mark.add_(0)
            torch.cuda.synchronize()
            for fn, calls in jobs:
                for _ in range(3):
                    torch.erfinv(mark)
                for _ in range(reps):
                    for args in calls:
                        fn(*args)
            torch.cuda.synchronize()
        spans = sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                       if e.device_type == DeviceType.CUDA)
        busy_us, after_marker = [], False
        for start, stop, name in spans:
            if "erfinv" in name:
                if not after_marker:
                    busy_us.append(0.0)
                after_marker = True
                continue
            after_marker = False
            if busy_us:
                busy_us[-1] += stop - start
        if len(busy_us) == len(jobs) and all(us > 0 for us in busy_us):
            return [us / 1e3 / reps for us in busy_us]
        log({"phase": "device_ms_retry", "attempt": attempt, "events": len(spans),
             "boundaries": len(busy_us), "jobs": len(jobs)})
    log({"phase": "device_ms_unmeasured", "jobs": len(jobs),
         "why": "four profiler sessions lost a job's boundary or all of its kernels"})
    return [None] * len(jobs)


def max_err(fn, plain, calls, tol):
    """Each call held to its own scale: per call, |kernel - plain| against
    tol * max(1, max |plain|). Returns (max abs error, the worst call's
    error / its tolerance, that call's index and max |plain|, outputs)."""
    import torch

    err, worst, at, at_scale = 0.0, -1.0, -1, 0.0
    outs = []
    for i, args in enumerate(calls):
        got = fn(*args)
        ref = plain(*args)
        torch.cuda.synchronize()
        if got.shape != ref.shape or got.dtype != ref.dtype:
            raise AssertionError(f"{fn.__name__}: {got.shape}/{got.dtype} vs {ref.shape}/{ref.dtype}")
        if not torch.isfinite(got.float()).all():
            raise AssertionError(f"{fn.__name__}: non-finite kernel output")
        e = float((got.float() - ref.float()).abs().max())
        scale = float(ref.float().abs().max())
        ratio = e / (tol * max(1.0, scale))
        err = max(err, e)
        if ratio > worst:
            worst, at, at_scale = ratio, i, scale
        outs.append(got)
    return err, worst, at, at_scale, outs


def tap_skipping(calls) -> dict:
    """K1's (16-row strip, tap) steps on the recorded kernel-3 calls, one
    call per level (levels differ in their output rows): how many the gather
    variant walks and the share it skips for want of a hit."""
    from xmask3d_tpu_torch.ops.sparse_conv import strip_tap_steps

    levels = {}
    for feats, w, kmap, _, valid in calls:
        if w.shape[0] == 27 and kmap.shape[2] not in levels:
            steps, hit = strip_tap_steps(kmap, valid)
            levels[kmap.shape[2]] = {"rows": kmap.shape[2], "steps": steps, "with_hit": hit,
                                     "skipped_share": 1 - hit / max(steps, 1)}
    return {"phase": "k1_tap_skipping",
            "levels": [levels[v] for v in sorted(levels, reverse=True)]}


def unfused_stages(calls):
    """The port's unfused GroupNorm -> SiLU -> conv3x3 (the modules a VAE
    resblock runs without fused_gn) on K4's recorded calls: [(stage, x)]."""
    import torch.nn.functional as F

    from xmask3d_tpu_torch.models.layers import Conv, GroupNorm

    out = []
    for x, scale, bias, w, b, groups, _ in calls:
        c, cout = w.shape[2], w.shape[3]
        norm = GroupNorm(c).to(x.device)
        conv = Conv(c, cout, 3, padding=1).to(x.device)
        if norm.groups != groups:
            raise AssertionError(f"GroupNorm({c}) has {norm.groups} groups, the call {groups}")
        norm.weight.data, norm.bias.data = scale, bias
        conv.weight.data = w.permute(3, 2, 0, 1).contiguous()
        conv.bias.data = b

        def stage(x, norm=norm, conv=conv):
            return conv(F.silu(norm(x)))

        out.append((stage, x))
    return out


def run_stage(stage, x):
    import torch

    with torch.no_grad():
        return stage(x)


def with_params(name, calls):
    """K4's calls as the resblocks make them, with the weight layout made once
    per conv; other kernels' calls as they are."""
    if name != "gn_silu_conv":
        return calls
    from xmask3d_tpu_torch.ops.gn_conv import kernel_params

    return [c + (kernel_params(c[3], c[4], c[0].dtype),) for c in calls]


def gather_bytes(calls) -> int:
    """K3: bytes of the value rows its taps gather on these calls, in whole
    32-byte sectors, counting only taps inside the maps of live samples; the
    gathers' floor is this at the L2's rate (the rows stay in L2)."""
    import torch

    total = 0
    for value, shapes, loc, _ in calls:
        row = -(-value.shape[3] * value.element_size() // 32) * 32
        for li, (h, w) in enumerate(shapes):
            fx = torch.floor(loc[..., li, :, 0] * w - 0.5)
            fy = torch.floor(loc[..., li, :, 1] * h - 0.5)
            live = (fx >= -1) & (fx < w) & (fy >= -1) & (fy < h)
            for ox, oy in ((0, 0), (1, 0), (0, 1), (1, 1)):
                inside = (fx + ox >= 0) & (fx + ox < w) & (fy + oy >= 0) & (fy + oy < h)
                total += int((live & inside).sum()) * row
    return total


def check_kernels(table, calls) -> list:
    """Each kernel with recorded calls against its plain version (bf16 as
    recorded, then fp32), then timed: kernel, plain, and for K4 the port's
    unfused stages; one row of the `kernels` line each."""
    import torch
    import torch.nn.functional as F

    rows = []
    for name, cs in calls.items():
        k = table[name]
        if not cs:
            raise AssertionError(f"{name}: the main path made no call")
        errs = {}
        for dtype in ("bf16", "fp32"):
            cd = cs if dtype == "bf16" else [as_fp32(c) for c in cs]
            err, worst, at, at_scale, outs = max_err(k["fn"], k["plain"], cd, TOL[dtype])
            log({"phase": "kernel_check", "kernel": name, "dtype": dtype, "calls": len(cd),
                 "max_abs_err": err, "tol_per_call": f"{TOL[dtype]} * max(1, max |plain|)",
                 "worst_err_over_tol": worst, "worst_call": at,
                 "worst_call_max_abs_plain": at_scale, "ok": worst <= 1.0})
            if not worst <= 1.0:
                raise AssertionError(f"{name} ({dtype}): call {at} is {worst}x its tolerance")
            errs[dtype] = err
            if dtype == "bf16":
                bound_ms, bound_by = bound(name, cs, outs)
                outs_bf16 = outs
            del outs
        reps = 5
        timed = with_params(name, cs)
        t = [time_calls(k["plain"], cs, 2), time_calls(k["fn"], timed, reps),
             time_calls(k["fn"], timed, reps), time_calls(k["plain"], cs, 2)]
        del timed
        library = unfused = None
        if name == "flash_attention":
            library = time_calls(F.scaled_dot_product_attention, cs, reps)
        if name == "gn_silu_conv":
            unfused = time_calls(run_stage, unfused_stages(cs), reps)
        by_shape = None
        if "shape" in k:
            groups = {}
            for c, o in zip(cs, outs_bf16):
                groups.setdefault((k["shape"](c), k["variant"](c)), []).append((c, o))
            by_shape = []
            for (shape, var), members in groups.items():
                g_calls = [c for c, _ in members]
                g_bound, g_by = bound(name, g_calls, [o for _, o in members])
                by_shape.append({
                    "shape": list(shape), "variant": var, "launches": len(g_calls),
                    "ms": time_calls(k["fn"], with_params(name, g_calls), reps),
                    "bound_ms": g_bound, "bound_by": g_by,
                    "library_ms": time_calls(F.scaled_dot_product_attention, g_calls, reps)
                    if name == "flash_attention" else None,
                    "unfused_ms": time_calls(run_stage, unfused_stages(g_calls), reps)
                    if name == "gn_silu_conv" else None})
        del outs_bf16
        row = {
            "name": name, "route": "cuda", "source": k["source"], "replaces": k["replaces"],
            "launches": None, "max_abs_err": errs["bf16"],
            "ms": (t[1] + t[2]) / 2, "plain_ms": (t[0] + t[3]) / 2,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library,
        }
        log({"phase": "kernel_time", "kernel": name, "ms": row["ms"], "plain_ms": row["plain_ms"],
             "bound_ms": bound_ms, "library_ms": library, "unfused_ms": unfused, "runs_ms": t,
             "gather_bytes": gather_bytes(cs) if name == "deform_attn" else None,
             "by_shape": by_shape})
        rows.append(row)
        torch.cuda.empty_cache()
    return rows


def device_times(table, calls, rows) -> None:
    """The kernels' device-busy time on their recorded calls (`device_ms`),
    per shape; K2 beside `scaled_dot_product_attention`, K4 beside the
    port's unfused stages and with its statistics kernels alone; adds
    `device_ms` and `library_device_ms` to each kernel's row. It runs after
    the counted views: the profiler it uses stays attached to the process
    and slows every later launch on the host."""
    import torch.nn.functional as F

    from xmask3d_tpu_torch.ops.gn_conv import group_affine

    reps = 5
    for row in rows:
        name = row["name"]
        k, cs = table[name], calls[name]
        groups = {}
        for c in cs:
            groups.setdefault((k["shape"](c), k["variant"](c)), []).append(c)
        # each job over the view's calls, then over each shape's
        sets = [cs] + list(groups.values())
        jobs = [(k["fn"], with_params(name, g)) for g in sets]
        if name == "flash_attention":
            jobs += [(F.scaled_dot_product_attention, g) for g in sets]
        if name == "gn_silu_conv":
            jobs += [(run_stage, unfused_stages(g)) for g in sets]
            jobs += [(group_affine, [c[:3] + c[5:7] for c in g]) for g in sets]
        ms = device_ms(jobs, reps)
        n = len(sets)
        extra = {"flash_attention": ["library_device_ms"],
                 "gn_silu_conv": ["unfused_device_ms", "stats_device_ms"]}.get(name, [])
        row["device_ms"] = ms[0]
        row["library_device_ms"] = ms[n] if name == "flash_attention" else None
        whole = {key: ms[n * (1 + j)] for j, key in enumerate(extra)}
        by_shape = [dict({"shape": list(shape), "variant": var, "launches": len(g),
                          "device_ms": ms[1 + i]},
                         **{key: ms[n * (1 + j) + 1 + i] for j, key in enumerate(extra)})
                    for i, ((shape, var), g) in enumerate(groups.items())]
        log(dict({"phase": "kernel_device_time", "kernel": name, "device_ms": row["device_ms"]},
                 **whole, by_shape=by_shape))


# --------------------------------------------------------------------------
# phases
# --------------------------------------------------------------------------


def check_outputs(outputs, caps, mc) -> None:
    import torch

    q = mc.num_queries
    expect = {
        "fused_pred_feature": (1, caps.max_points, mc.projection_dim),
        "pred_logits": (1, q, mc.num_test_classes + 1),
        "mask_embed_clip": (1, q, mc.projection_dim),
        "final_mask_3d": (1, q, caps.max_points),
        "pred_labels": (1, q),
    }
    for key, shape in expect.items():
        t = outputs[key]
        if tuple(t.shape) != shape:
            raise AssertionError(f"{key}: shape {tuple(t.shape)} != {shape}")
        if t.is_floating_point() and not torch.isfinite(t.float()).all():
            raise AssertionError(f"{key}: non-finite values")


def profile_view(fn, *args) -> dict:
    """One more view, fn(*args), under torch.profiler: device time per
    kernel name (the largest twelve), the port kernels' share, and how much
    of the view's host wall time the device was busy (the union of kernel
    intervals)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        fn(*args)
        torch.cuda.synchronize()
        wall_ms = (time.time() - t0) * 1e3
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    by_name, busy_us, end = {}, 0.0, float("-inf")
    for start, stop, name in spans:
        by_name[name] = by_name.get(name, 0.0) + (stop - start) / 1e3
        busy_us += max(0.0, stop - max(start, end))
        end = max(end, stop)
    ours = {k: sum(ms for n, ms in by_name.items() if k in n)
            for k in ("sparse_conv_", "flash_", "deform_attn_", "gn_conv_wgmma_", "gn_stats_",
                      "gn_affine_")}
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])
    return {
        "phase": "profile", "wall_ms": wall_ms, "kernels_seen": len(spans),
        "device_busy_ms": busy_us / 1e3, "device_idle_share": 1 - busy_us / 1e3 / wall_ms,
        "port_kernels_ms": ours, "launches": named_launches(n for _, _, n in spans),
        "top": [[n[:80], ms] for n, ms in ranked[:12]],
    }


# each wrapper's launches as the profiler names its kernels: K1's split-K sum
# (`sparse_conv_reduce_kernel`) is part of a call, and K4's statistics are
# counted by their second kernel, one a call
KERNEL_NAMES = {
    "sparse_conv": ("sparse_conv_mma_kernel", "sparse_conv_fma_kernel"),
    "flash_attention": ("flash_mma_kernel", "flash_wide_kernel", "flash_fma_kernel"),
    "deform_attn": ("deform_attn_vec_kernel", "deform_attn_kernel"),
    "gn_silu_conv": ("gn_conv_wgmma_kernel", "gn_conv_f32_kernel"),
    "gn_statistics": ("gn_affine_kernel",),
}


def named_launches(names) -> dict:
    names = list(names)
    return {k: sum(any(p in n for p in pats) for n in names) for k, pats in KERNEL_NAMES.items()}


def with_statistics(expected) -> dict:
    """Expected launches a view with K4's statistics (one a K4 call)."""
    return dict(expected, gn_statistics=expected["gn_silu_conv"])


def replayed_profile(phase, fn, args, expected, attempts: int = 3) -> dict:
    """One call of `fn` (a replayed CUDA graph: the wrappers' counters do not
    see it) under the profiler, with each kernel's launches read from the
    kernel names; they must equal `expected`. The profiler can lose records
    on the card's machine, so a session that counts fewer is taken again, up
    to `attempts` times; more launches than expected fail at once."""
    for attempt in range(attempts):
        prof = profile_view(fn, *args)
        prof["phase"] = phase
        got = prof["launches"]
        if got == expected:
            return prof
        log(dict(prof, retry=attempt, expected=expected))
        if any(got[k] > expected[k] for k in expected):
            break
    raise AssertionError(f"{phase}: replayed launches {got}, expected {expected}")


def _to(tree, dev):
    import torch

    if torch.is_tensor(tree):
        return tree.to(dev)
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    return [_to(v, dev) for v in tree]


def trunk_stages(model, batch, statics, given=None):
    """The eval trunk stage by stage; with `given` (another run's stage
    outputs) each stage takes its inputs from there, so stages are compared
    one at a time."""
    g = given or {}
    out = {"run_3d": model.run_3d(batch)}
    img01 = batch["img"] / 255.0
    imp = g.get("run_3d", out["run_3d"])["imp_condition"]
    out["backbone"] = model.backbone(img01, imp, statics["uncond_tokens"])
    mf, ms = model.pixel_decoder(g.get("backbone", out["backbone"]))
    out["pixel_decoder"] = {"mask_features": mf, "ms": ms}
    src = g.get("pixel_decoder", out["pixel_decoder"])
    dec = model.mask_decoder(src["ms"], src["mask_features"])
    out["mask_decoder"] = {"pred_masks": dec["pred_masks"], "mask_embed": dec["mask_embed"]}
    masks = g.get("mask_decoder", out["mask_decoder"])["pred_masks"]
    out["maskclip"] = {"mask_embed_clip": model._clip_mask_embed(img01, masks)}
    return out


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}" if prefix else k)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def reference_check(cfg_path, fused_gn: bool = False) -> dict:
    """Tiny model, fp32: the card (kernels) against the CPU (plain versions)
    on the same weights and batch, stage by stage with the CPU's stage
    inputs, within 2e-3 of each output's largest value (the eval golden's
    tolerance);
    then the whole eval forward, whose discrete outputs must agree on 99%.
    With `fused_gn` the VAE resblocks run K4 on the card, which must launch
    for every stage of both runs."""
    import torch

    from xmask3d_tpu_torch.config import load_config
    from xmask3d_tpu_torch.data.batching import Capacities
    from xmask3d_tpu_torch.data.synthetic import synthetic_batch
    from xmask3d_tpu_torch.engine.builder import build_model, build_statics

    cfg = load_config(cfg_path)
    cfg.update(mask_shape=[24, 32], compute_dtype="float32")
    caps = Capacities(max_points=512, max_voxels=256, max_targets=8)
    cpu = build_model(cfg, tiny=True, seed=1, device="cpu", fused_gn=fused_gn)
    gpu = copy.deepcopy(cpu).to("cuda")
    reset_launches()
    kw = dict(seed=3, num_points=400, image_size=(64, 64), mask_shape=(24, 32),
              context_length=16, vocab_size=512)
    b_cpu = synthetic_batch(1, caps, device="cpu", **kw)
    b_gpu = synthetic_batch(1, caps, device="cuda", **kw)
    s_cpu = build_statics(cpu, cfg, device="cpu")
    s_gpu = build_statics(gpu, cfg, device="cuda")
    with torch.no_grad():
        ref = trunk_stages(cpu, b_cpu, s_cpu)
        got = trunk_stages(gpu, b_gpu, s_gpu, given=_to(ref, "cuda"))
    report, bad = {"phase": "reference_tiny_fp32" + ("_fused_gn" if fused_gn else "")}, []
    for (key, a), (_, b) in zip(_leaves(ref), _leaves(got)):
        err = float((a.float() - b.float().cpu()).abs().max())
        tol = 2e-3 * float(a.float().abs().max()) + 1e-6
        report[key] = err
        if not err <= tol:
            bad.append(f"{key}: {err} > {tol}")
    out_cpu = cpu.eval_forward(b_cpu, s_cpu)
    out_gpu = gpu.eval_forward(b_gpu, s_gpu)
    for key in ("final_mask_3d", "pred_labels", "binary_pred"):
        frac = float((out_cpu[key] != out_gpu[key].cpu()).float().mean())
        report[f"{key}_mismatch"] = frac
        if frac > 0.01:
            bad.append(f"{key} disagrees on {frac:.2%}")
    report["launches"] = launches()
    k4 = 2 * expected_launches(gpu.cfg)["gn_silu_conv"]
    if report["launches"]["gn_silu_conv"] != k4:
        bad.append(f"K4 launched {report['launches']['gn_silu_conv']} times, expected {k4}")
    if bad:
        log(report)
        raise AssertionError("tiny reference: " + "; ".join(bad))
    return report


# the graph phases: interleaved pairs of an eager and a replayed view for the
# host clock; the scene scan at the bench's shape (30 views a scene cycling
# 6 distinct ones, BENCH_DISTINCT_VIEWS' default), in runs scan, eager,
# eager, scan
GRAPH_PAIRS = 12
SCAN_VIEWS, SCAN_DISTINCT = 30, 6
EXACT_KEYS = ("pred", "pred_3d", "covered_2d", "binary_pred")
FLOAT_KEYS = ("feat_2d", "text", "logit_scale")


def float_gap(got, want) -> dict:
    """Largest |graph - eager| of each float output, and it over the bf16
    tolerance of the kernel checks (a library call may pick another
    algorithm under capture; none is allowed past that tolerance)."""
    out = {}
    for k in FLOAT_KEYS:
        e = float((got[k].float() - want[k].float()).abs().max())
        tol = TOL["bf16"] * max(1.0, float(want[k].float().abs().max()))
        if not e <= tol:
            raise AssertionError(f"{k}: replayed and eager differ by {e} > {tol}")
        out[k] = e
    return out


def graph_main_path(model, cfg, caps, views, statics) -> tuple:
    """The main path as captured device programs: `make_infer_step` (one
    view's forward and routing) and the scene scan's view body (forward,
    routing, vote), each captured once at the main path's capacities, with
    the counts set to 0 before and read after (they count the eager warm-up
    and the capture; replays count nothing). Replayed views must equal eager
    ones: exact on the labels, the coverage, the binary routing and the vote
    table, the float outputs within the bf16 tolerance (their largest gap is
    logged). Then the host clock a view over GRAPH_PAIRS interleaved pairs
    of the eager view body and the replayed one. Returns (infer_step, scan)."""
    import torch

    from xmask3d_tpu_torch.engine.infer_cli import make_infer_step
    from xmask3d_tpu_torch.engine.serve import (
        fresh_vote_state, make_scene_scan_step, stack_views)

    n_cls = model.cfg.num_test_classes
    reset_launches()
    t0 = time.time()
    infer_step, _ = make_infer_step(model, cfg)
    infer_step(views[0], statics)
    scan = make_scene_scan_step(model, cfg)
    body = scan.step
    body(views[0], statics, *fresh_vote_state(caps.max_points, n_cls))
    torch.cuda.synchronize()
    captured, capture_s = launches(), time.time() - t0
    if infer_step.graphs != 1 or body.graphs != 1:
        raise AssertionError(f"graphs held: {infer_step.graphs}, {body.graphs}")
    gaps = []
    for b in views[1:]:
        got = {k: v.clone() for k, v in infer_step(b, statics).items()}
        want = infer_step.fn(b, statics)
        torch.cuda.synchronize()
        for k in EXACT_KEYS:
            if not torch.equal(got[k], want[k]):
                raise AssertionError(f"{k}: the replayed view differs from the eager one")
        gaps.append(float_gap(got, want))
    got = scan(stack_views(views[1:]), range(len(views) - 1), statics,
               *fresh_vote_state(caps.max_points, n_cls))
    if body.graphs != 1:
        raise AssertionError(f"the scan captured its view body again: {body.graphs} graphs")
    want = fresh_vote_state(caps.max_points, n_cls)
    for b in views[1:]:
        want = body.fn(b, statics, *want)
    if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
        raise AssertionError("the scan's vote table differs from the eager view body's")
    valid = sum(int(b["point_valid"].sum()) for b in views[1:])
    if int(got[1].sum()) != valid:
        raise AssertionError(f"{int(got[1].sum())} votes for {valid} valid view points")

    votes = fresh_vote_state(caps.max_points, n_cls)
    ms = {"eager": [], "graph": []}
    for r in range(GRAPH_PAIRS):
        b = views[1 + r % (len(views) - 1)]
        order = (("eager", body.fn), ("graph", body))
        for name, fn in order if r % 2 == 0 else order[::-1]:
            torch.cuda.synchronize()
            t0 = time.time()
            fn(b, statics, *votes)
            torch.cuda.synchronize()
            ms[name].append((time.time() - t0) * 1e3)
    log({"phase": "graph_main_path", "views": len(views) - 1, "capture_seconds": capture_s,
         "launches_warmup_and_capture": captured, "graphs": infer_step.graphs + body.graphs,
         "exact": list(EXACT_KEYS) + ["votes", "counter"], "float_max_abs_diff": gaps,
         "pairs": GRAPH_PAIRS, "host_ms": ms,
         "mean_eager_ms": sum(ms["eager"]) / GRAPH_PAIRS,
         "mean_graph_ms": sum(ms["graph"]) / GRAPH_PAIRS,
         "peak_mem_bytes": torch.cuda.max_memory_allocated()})
    for name, n in captured.items():
        if name in EXPECTED_NONZERO and n == 0:
            raise AssertionError(f"{name}: no launch while the graphs were captured")
    return infer_step, scan


# kernels every main-path capture must launch (K4 runs only with fused_gn)
EXPECTED_NONZERO = ("sparse_conv", "flash_attention", "deform_attn")


def scene_scan(scan, model, cfg, caps, statics) -> dict:
    """The bench's shape without the bench: one synthetic scene of
    SCAN_VIEWS views (SCAN_DISTINCT distinct ones cycled by `idxseq`) at
    the bench's capacities through `make_scene_scan_step` (the view body
    captured in `graph_main_path`), against the same views dispatched one
    by one through the eager view body; runs scan, eager, eager, scan. Every
    run's votes must be equal."""
    import torch

    from xmask3d_tpu_torch.data.synthetic import synthetic_batch
    from xmask3d_tpu_torch.engine.serve import fresh_vote_state, stack_views

    n_cls = model.cfg.num_test_classes
    views = [synthetic_batch(1, caps, seed=400 + i, num_points=20000, image_size=(512, 512),
                             mask_shape=tuple(cfg.mask_shape), context_length=77,
                             vocab_size=49408)
             for i in range(SCAN_DISTINCT)]
    stacked = stack_views(views)
    idxseq = torch.arange(SCAN_VIEWS, dtype=torch.int32) % SCAN_DISTINCT

    def eager():
        vc = fresh_vote_state(caps.max_points, n_cls)
        for i in idxseq.tolist():
            vc = scan.step.fn(views[i], statics, *vc)
        return vc

    def graph():
        return scan(stacked, idxseq, statics, *fresh_vote_state(caps.max_points, n_cls))

    seconds, results = {"scan": [], "eager": []}, []
    for name, fn in (("scan", graph), ("eager", eager), ("eager", eager), ("scan", graph)):
        torch.cuda.synchronize()
        t0 = time.time()
        vc = fn()
        torch.cuda.synchronize()
        seconds[name].append(time.time() - t0)
        results.append(vc)
    for vc in results[1:]:
        if not (torch.equal(vc[0], results[0][0]) and torch.equal(vc[1], results[0][1])):
            raise AssertionError("the scan's votes differ from per-view dispatch")
    valid = sum(int(views[i]["point_valid"].sum()) for i in idxseq.tolist())
    if int(results[0][1].sum()) != valid:
        raise AssertionError(f"{int(results[0][1].sum())} votes for {valid} valid view points")
    if scan.step.graphs != 1:
        raise AssertionError(f"the scan holds {scan.step.graphs} graphs of its view body")
    report = {"phase": "scene_scan", "views": SCAN_VIEWS, "distinct_views": SCAN_DISTINCT,
              "seconds": seconds, "votes_equal": True}
    for name, ts in seconds.items():
        mean = sum(ts) / len(ts)
        report[f"{name}_scenes_per_sec"] = 1.0 / mean
        report[f"{name}_ms_per_view"] = mean * 1e3 / SCAN_VIEWS
    log(report)
    return report


# the scene phase's runs (route, kernel-map builder): the graph route with
# the native builder (the default) and the numpy one in turns
SCENE_RUNS = (("eager", "native"), ("graph", "numpy"), ("graph", "native"), ("graph", "native"),
              ("graph", "numpy"), ("eager", "native"))


def _stats_ms(xs) -> dict:
    xs = sorted(x * 1e3 for x in xs)
    return {"median_ms": xs[len(xs) // 2], "min_ms": xs[0], "max_ms": xs[-1], "n": len(xs)}


def host_pipeline(runs) -> dict:
    """Each host stage of `run_scene` (`infer_cli.STAGES`) a view, per
    kernel-map builder, over the given runs' views (median and range), and
    the runs' order: the split of a scene view's host time."""
    from xmask3d_tpu_torch.engine.infer_cli import STAGES

    out = {"phase": "host_pipeline", "order": [r["builder"] for r in runs], "by_builder": {}}
    for builder in dict.fromkeys(r["builder"] for r in runs):
        recs = [rec for r in runs if r["builder"] == builder for rec in r["record"]]
        stages = {k: _stats_ms([x for rec in recs for x in rec["host_seconds"][k]])
                  for k in STAGES}
        total = [sum(xs) for rec in recs for xs in zip(*(rec["host_seconds"][k] for k in STAGES))]
        out["by_builder"][builder] = {"stages": stages, "view_total": _stats_ms(total)}
    return out


def device_hierarchy(model, cfg, caps, statics, views, table) -> None:
    """The main path's views with `device_hierarchy=True`: the hierarchy
    built on the device inside `make_infer_step`'s graph. The counts, set
    to 0 before the capture, must see K1-K3 in it. Each view's device-built
    hierarchy equals its host-built one with levels 1-4 in sorted-key order
    (`to_key_order`), every leaf (level 0's maps as they are). Each replayed
    view equals its eager body, and the host-built view in that row order
    exactly on the labels, coverage and routing (the float outputs' largest
    gaps logged); against the host-built view in its own row order, which
    K1's split over a tile's live taps rounds differently at levels 1-4,
    the float outputs' largest gaps and the share of valid points with
    equal labels are logged. Then, from the profiler: the build's
    device ms, K1's device ms over a view's calls under either hierarchy,
    and a replayed view's launches; and the bytes a view copies in under
    either route."""
    import torch

    from xmask3d_tpu_torch.data.synthetic import synthetic_batch
    from xmask3d_tpu_torch.engine.graphs import flatten
    from xmask3d_tpu_torch.engine.infer_cli import make_infer_step
    from xmask3d_tpu_torch.ops.hierarchy_device import build_hierarchy_on_device, to_key_order

    kw = dict(num_points=20000, image_size=(512, 512), mask_shape=tuple(cfg.mask_shape),
              context_length=77, vocab_size=49408)
    seeds = range(101, 100 + len(views))  # the main path's counted views
    dviews = [synthetic_batch(1, caps, seed=s, device_hierarchy=True, **kw) for s in seeds]
    copied = {route: nbytes(*flatten(synthetic_batch(1, caps, seed=101, device="cpu",
                                                     device_hierarchy=d, **kw))[1])
              for route, d in (("host", False), ("device", True))}
    level_caps = caps.level_caps()
    keyed = []
    for dv, hv in zip(dviews, views[1:]):
        host_h = hv["hierarchy"]
        nums = [int(lv.num[0]) for lv in host_h.levels]
        if any(n >= c for n, c in zip(nums[1:], level_caps[1:])):
            raise AssertionError(f"a level overflows its capacity: {nums} of {level_caps}")
        (sig_d, got), (sig_k, want) = (
            flatten(build_hierarchy_on_device(dv["voxel_coords"], dv["voxel_num"], level_caps)),
            flatten(to_key_order(host_h)))
        if sig_d != sig_k or not all(torch.equal(a, b) for a, b in zip(got, want)):
            raise AssertionError("the device-built hierarchy differs from the host-built one "
                                 "in sorted-key order")
        keyed.append(dict(hv, hierarchy=to_key_order(host_h)))
    step, _ = make_infer_step(model, cfg)
    reset_launches()
    t0 = time.time()
    step(dviews[0], statics)
    torch.cuda.synchronize()
    captured, capture_s = launches(), time.time() - t0
    for name in EXPECTED_NONZERO:
        if captured[name] == 0:
            raise AssertionError(f"{name}: no launch in the device-hierarchy capture")
    gaps = {"eager": [], "host_key_order": [], "host": []}
    agree = {"pred": [], "pred_3d": []}
    for dv, kv, hv in zip(dviews, keyed, views[1:]):
        got = {k: v.clone() for k, v in step(dv, statics).items()}
        ref = {"eager": step.fn(dv, statics), "host_key_order": step.fn(kv, statics),
               "host": step.fn(hv, statics)}
        torch.cuda.synchronize()
        for name in ("eager", "host_key_order"):
            for k in EXACT_KEYS:
                if not torch.equal(got[k], ref[name][k]):
                    raise AssertionError(f"{k}: the replayed device-hierarchy view differs from "
                                         f"the {name} view")
        for name in ("eager", "host_key_order"):
            gaps[name].append(float_gap(got, ref[name]))
        # not held: the 3D branch's global feature conditions the SD
        # backbone, so K1's rounding at levels 1-4 reaches every 2D output
        gaps["host"].append({k: float((got[k].float() - ref["host"][k].float()).abs().max())
                             for k in FLOAT_KEYS})
        pv = hv["point_valid"]
        for k in agree:
            agree[k].append(float((got[k] == ref["host"][k])[pv].float().mean()))
    calls = {"host": {"sparse_conv": []}, "device": {"sparse_conv": []}}
    for route, b in (("host", views[1]), ("device", dviews[0])):
        with recording(calls[route]):
            step.fn(b, statics)
    k1 = table["sparse_conv"]["fn"]
    coords, num = dviews[0]["voxel_coords"], dviews[0]["voxel_num"]
    build_ms, k1_host_ms, k1_dev_ms = device_ms(
        [(lambda c, n: build_hierarchy_on_device(c, n, level_caps), [(coords, num)]),
         (k1, calls["host"]["sparse_conv"]), (k1, calls["device"]["sparse_conv"])], reps=3)
    del calls
    log({"phase": "device_hierarchy", "views": len(dviews), "capture_seconds": capture_s,
         "launches_warmup_and_capture": captured, "graphs": step.graphs,
         "hierarchy_equals_host_in_key_order": "every leaf of every view",
         "exact_vs_eager_and_host_key_order": list(EXACT_KEYS),
         "float_max_abs_diff": gaps, "label_agreement_vs_host_row_order": agree,
         "build_device_ms": build_ms,
         "k1_device_ms": {"host_hierarchy": k1_host_ms, "device_hierarchy": k1_dev_ms},
         "bytes_copied_in_a_view": copied})
    log(replayed_profile("device_hierarchy_profile", step, (dviews[0], statics),
                         with_statistics(expected_launches(model.cfg))))
    step.reset()


@contextlib.contextmanager
def environ(**values):
    """os.environ with `values` set, restored after."""
    old = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


# the port's bench at its defaults, one run a mode: scan, per-view dispatch
# of the captured view body, and views built on the host in the timed window
BENCH_MODES = (("scan", {}), ("per_view", {"BENCH_SCAN_VIEWS": "0"}),
               ("include_host", {"BENCH_INCLUDE_HOST": "1"}))


def bench_phase() -> None:
    """`tools/bench.py` in each of BENCH_MODES at its defaults (3 scenes of
    30 views at the bench's capacities), in this process; each mode prints
    its own JSON line, which must hold a finite scenes/s. The counts, set
    to 0 before each mode, see its eager warm-up and capture (replays count
    nothing) and must show K1-K3."""
    import gc
    import math

    import torch

    from xmask3d_tpu_torch.tools import bench

    results = {}
    for name, env in BENCH_MODES:
        reset_launches()
        t0 = time.time()
        with environ(BENCH_SIZE="full", **env):
            line, votes = bench.main()
        counts = launches()
        if not (math.isfinite(line["value"]) and line["value"] > 0) or votes.sum() <= 0:
            raise AssertionError(f"bench {name}: {line}, {int(votes.sum())} votes")
        for kernel in EXPECTED_NONZERO:
            if counts[kernel] == 0:
                raise AssertionError(f"bench {name}: {kernel} never launched")
        results[name] = dict(line, seconds=time.time() - t0, launches_warmup_and_capture=counts)
        del votes
        gc.collect()
        torch.cuda.empty_cache()
    log({"phase": "bench", "modes": results})


def scene_phase(cfg, caps, table):
    """Whole scenes at full width with fused_gn: the model built again from
    the same seed, two synthetic scenes through `run_eval_scenes`. A warm-up
    run of the fullest view through the eager body records every kernel's
    calls, which are held against their plain versions (K1-K3 again, on
    this path's inputs). `make_infer_step`'s graph is then captured (its
    counts read) and the scenes run six times (SCENE_RUNS: eager, the graph
    with each kernel-map builder in turns, eager), the host stages of each
    graph run's views logged by builder (`host_pipeline`):
    each eager run must launch every kernel its per-view count times over
    all views, vote once per kept view point, leave no scene point without
    a prediction and give finite summaries; each graph run must launch
    nothing outside its graph and give the eager run's predictions, votes
    and summaries exactly. A replayed view is profiled, its launches read
    from the kernel names. Returns (K4's row of the `kernels` line, the
    model, statics, scenes and s/scene of both routes) for `scene_reuse`."""
    import math

    import torch

    from xmask3d_tpu_torch.data.batching import collate_views
    from xmask3d_tpu_torch.data.synthetic import synthetic_scene
    from xmask3d_tpu_torch.engine.builder import build_model, build_statics
    from xmask3d_tpu_torch.engine.infer_cli import make_infer_step, run_eval_scenes

    t0 = time.time()
    model = build_model(cfg, seed=0, fused_gn=True)
    mc = model.cfg
    statics = build_statics(model, cfg)
    infer_step, route_2d = make_infer_step(model, cfg)
    body = infer_step.fn
    scenes = [synthetic_scene(caps, seed=200 + i, num_points=SCENE_POINTS, num_views=SCENE_VIEWS,
                              num_classes=cfg.test_classes, image_size=(512, 512),
                              mask_shape=tuple(cfg.mask_shape), context_length=77,
                              vocab_size=49408)
              for i in range(SCENES)]
    n_views = sum(len(sc["views"]) for sc in scenes)
    torch.cuda.synchronize()
    log({"phase": "scene_setup", "seconds": time.time() - t0, "scenes": SCENES,
         "views": n_views, "points": [len(sc["coords"]) for sc in scenes],
         "visible": [int(v["visible"].sum()) for sc in scenes for v in sc["views"]]})
    expected = expected_launches(mc)

    # warm-up view: record every kernel's calls on this path's fullest view
    # (more live rows than the main path's views), check and time them
    calls = {name: [] for name, n in expected.items() if n}
    fullest = max((v for sc in scenes for v in sc["views"]), key=lambda v: int(v["visible"].sum()))
    batch = collate_views([fullest["sample"]], caps)
    reset_launches()
    with recording(calls):
        t0 = time.time()
        body(batch, statics)
        torch.cuda.synchronize()
    log({"phase": "scene_warmup_view", "ms": (time.time() - t0) * 1e3, "launches": launches(),
         "live_voxels": int(batch["hierarchy"].levels[0].num[0]),
         "live_points": int(batch["point_valid"].sum())})
    for name, n in expected.items():
        if len(calls.get(name, ())) != n or launches()[name] != n:
            raise AssertionError(f"{name}: {len(calls.get(name, ()))} calls, {launches()[name]} "
                                 f"launches in the scene warm-up view, expected {n}")
    rows = check_kernels(table, calls)
    device_times(table, calls, rows)
    rows = {row["name"]: row for row in rows}
    log({"phase": "scene_kernel_rows", "rows": list(rows.values())})
    row = rows["gn_silu_conv"]
    del calls
    torch.cuda.empty_cache()
    body(batch, statics)  # refill the allocator's cache, uncounted
    reset_launches()
    t0 = time.time()
    infer_step(batch, statics)  # the eager warm-up and the capture
    torch.cuda.synchronize()
    log({"phase": "scene_capture", "seconds": time.time() - t0, "graphs": infer_step.graphs,
         "launches_warmup_and_capture": launches()})

    runs = []
    for route, builder in SCENE_RUNS:
        record, variants = [], {}
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.time()
        with counting_variants(table, variants):
            summary = run_eval_scenes(scenes, len(scenes), cfg=cfg, caps=caps, statics=statics,
                                      infer_step=body if route == "eager" else infer_step,
                                      route_2d=route_2d, record=record, builder=builder)
        seconds = time.time() - t0
        runs.append({"route": route, "builder": builder, "seconds": seconds, "summary": summary,
                     "record": record, "launches": launches(), "variants": variants,
                     "peak": torch.cuda.max_memory_allocated()})
        log({"phase": "scenes", "route": route, "builder": builder, "scenes": len(scenes),
             "views": n_views, "seconds": seconds, "seconds_per_scene": seconds / len(scenes),
             "host_ms_per_view": seconds * 1e3 / n_views, "peak_mem_bytes": runs[-1]["peak"],
             "launches": runs[-1]["launches"], "expected_per_view": expected,
             "variants": variants, "summary": summary, "kept": [r["kept"] for r in record],
             "counter": [r["counter"] for r in record]})
    eager = runs[0]
    counts = eager["launches"]
    for name, n in expected.items():
        if counts[name] != n * n_views:
            raise AssertionError(f"{name}: {counts[name]} launches over the scenes, "
                                 f"expected {n * n_views}")
    check_variants(eager["variants"], expected, n_views)
    if counts["gn_statistics"] != counts["gn_silu_conv"]:
        raise AssertionError(f"K4's statistics ran {counts['gn_statistics']} times for "
                             f"{counts['gn_silu_conv']} conv launches")
    for rec, sc in zip(eager["record"], scenes):
        if rec["views"] != len(sc["views"]) or rec["kept"] <= 0:
            raise AssertionError(f"{rec['name']}: {rec['views']} views, {rec['kept']} kept rows")
        if any(c != rec["kept"] for c in rec["counter"].values()):
            raise AssertionError(f"{rec['name']}: votes {rec['counter']} != {rec['kept']} kept")
        for stream, pred in rec["pred"].items():
            if pred.shape != (len(sc["coords"]),) or pred.min() < 0 \
                    or pred.max() >= cfg.test_classes:
                raise AssertionError(f"{rec['name']} {stream}: predictions do not cover the scene")
    for key in ("hIoU", "mIoU", "hIoU_2d", "mIoU_2d", "hIoU_3d", "mIoU_3d"):
        if not math.isfinite(eager["summary"][key]):
            raise AssertionError(f"{key} = {eager['summary'][key]}")
    for run in runs[1:]:
        if run["route"] == "graph" and any(run["launches"].values()):
            raise AssertionError(f"a graph run launched outside its graph: {run['launches']}")
        same = [k for k in eager["summary"] if k != "scenes_per_sec"
                and run["summary"][k] != eager["summary"][k]]
        for a, b in zip(run["record"], eager["record"]):
            same += [f"{a['name']} kept/counter"] if (a["kept"], a["counter"]) != \
                (b["kept"], b["counter"]) else []
            same += [f"{a['name']} {k}" for k in a["pred"] if not (a["pred"][k] == b["pred"][k]).all()]
        if same:
            raise AssertionError(f"the {run['route']} run differs from the first eager run: {same}")
    per_scene = {f"{r}_{b}": [run["seconds"] / len(scenes) for run in runs
                              if (run["route"], run["builder"]) == (r, b)]
                 for r, b in dict.fromkeys(SCENE_RUNS)}
    log({"phase": "scenes_graph_vs_eager", "seconds_per_scene": per_scene,
         "host_ms_per_view": {k: [t * len(scenes) * 1e3 / n_views for t in v]
                              for k, v in per_scene.items()},
         "equal": "predictions, kept, counter and summaries of every run"})
    log(host_pipeline([r for r in runs if r["route"] == "graph"]))
    log(profile_view(body, batch, statics))
    log(replayed_profile("scene_graph_profile", infer_step, (batch, statics),
                         with_statistics(expected)))
    row["launches"] = counts["gn_silu_conv"]
    infer_step.reset()
    return row, model, statics, scenes, per_scene


def same_host_hierarchy(a, b) -> bool:
    """Two `HostHierarchy`s equal leaf by leaf, bit for bit."""
    import dataclasses

    import numpy as np

    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, list):
            if len(x) != len(y) or not all(np.array_equal(u, v) and np.asarray(u).dtype ==
                                           np.asarray(v).dtype for u, v in zip(x, y)):
                return False
        elif not (np.array_equal(x, y) and x.dtype == y.dtype):
            return False
    return True


def native_kmaps(cfg, caps, scenes) -> None:
    """The C++ kernel-map builder against the numpy one on every view of the
    scene phase's scenes (at the view's capacities, coords as `collate_views`
    clips them) and on each whole scene (at scene reuse's capacities, as
    `scene_3d_batch` voxelizes it): bit for bit, in turns, with each
    builder's host ms a hierarchy."""
    import numpy as np

    from xmask3d_tpu_torch.data.voxelizer import Voxelizer
    from xmask3d_tpu_torch.engine.scene_reuse import scene_caps_from_view_caps
    from xmask3d_tpu_torch.ops.sparse_conv import build_hierarchy

    scene_caps = scene_caps_from_view_caps(caps)
    jobs = [("view", np.clip(v["sample"].voxel_coords[: caps.max_voxels].astype(np.int32),
                             0, 1023), caps.level_caps())
            for sc in scenes for v in sc["views"]]
    for sc in scenes:
        coords = Voxelizer(cfg.voxel_size).voxelize(
            sc["coords"], sc["colors"], np.zeros((len(sc["coords"]),), np.int64))[0]
        jobs.append(("scene", coords[: scene_caps.max_voxels].astype(np.int32),
                     scene_caps.level_caps()))
    seconds = {kind: {"numpy": [], "native": []} for kind in ("view", "scene")}
    voxels = {"view": [], "scene": []}
    for i, (kind, coords, level_caps) in enumerate(jobs):
        built = {}
        for builder in ("numpy", "native") if i % 2 == 0 else ("native", "numpy"):
            t0 = time.perf_counter()
            built[builder] = build_hierarchy(coords, level_caps, builder=builder)
            seconds[kind][builder].append(time.perf_counter() - t0)
        if not same_host_hierarchy(built["native"], built["numpy"]):
            raise AssertionError(f"native and numpy hierarchies differ on {kind} {i}")
        voxels[kind].append(built["native"].num)
    log({"phase": "native_kmaps", "equal": "every leaf of every view and scene",
         "views": len(voxels["view"]), "scenes": len(voxels["scene"]),
         "view_capacities": list(caps.level_caps()),
         "scene_capacities": list(scene_caps.level_caps()),
         "live_voxels_by_level": voxels,
         "host_ms": {kind: {b: _stats_ms(ts) for b, ts in by.items()}
                     for kind, by in seconds.items()}})


def scene_reuse_phase(model, cfg, caps, statics, scenes, table, per_scene) -> None:
    """The scenes of `scene_phase` through `run_eval_scenes(scene_reuse=True)`
    on the same model (fused_gn): one 3D pass a scene at
    `scene_caps_from_view_caps` (4x the view's capacities) and a 2D pass a
    view, both captured. First one eager 3D pass of the first scene records
    K1's calls at scene capacities, held against the plain version in bf16
    and fp32 and timed per shape (variant, ms, bound). The counted run (the
    counts set to 0 before it: they see the two captures) must vote once per
    kept view point, fill every scene point and give finite summaries; a
    second run times the host; replayed steps are profiled for their
    launches: K1 alone in the 3D pass, everything else in a view's."""
    import math

    import torch

    from xmask3d_tpu_torch.engine.graphs import copy_into
    from xmask3d_tpu_torch.engine.infer_cli import run_eval_scenes
    from xmask3d_tpu_torch.engine.scene_reuse import (
        make_reuse_infer_step, make_scene_3d_step, reuse_view_batch, scene_3d_batch,
        scene_caps_from_view_caps)

    scene_caps = scene_caps_from_view_caps(caps)
    step3d = make_scene_3d_step(model)
    reuse_step, route_2d = make_reuse_infer_step(model, cfg)
    expected = expected_launches(model.cfg)
    sb = scene_3d_batch(scenes[0]["coords"], scenes[0]["colors"], scene_caps,
                        voxel_size=cfg.voxel_size, input_color=cfg.input_color)
    calls = {"sparse_conv": []}
    with recording(calls):
        step3d.fn(sb)
        torch.cuda.synchronize()
    if len(calls["sparse_conv"]) != expected["sparse_conv"]:
        raise AssertionError(f"{len(calls['sparse_conv'])} K1 calls in a scene's 3D pass")
    log({"phase": "scene_reuse_batch", "capacities": [scene_caps.max_points,
                                                      scene_caps.max_voxels],
         "live_voxels": int(sb["hierarchy"].levels[0].num[0]),
         "live_points": int(sb["point_valid"].sum())})
    k1_row = check_kernels(table, calls)[0]
    log({"phase": "scene_reuse_k1", "row": k1_row})
    del calls
    torch.cuda.empty_cache()

    runs = []
    for _ in range(2):
        record = []
        reset_launches()
        t0 = time.time()
        summary = run_eval_scenes(scenes, len(scenes), cfg=cfg, caps=caps, statics=statics,
                                  infer_step=reuse_step, route_2d=route_2d, record=record,
                                  scene_reuse=True, scene_3d_step=step3d, scene_caps=scene_caps)
        runs.append({"seconds": time.time() - t0, "launches": launches(), "summary": summary,
                     "record": record})
    first, second = runs
    n_views = sum(len(sc["views"]) for sc in scenes)
    log({"phase": "scene_reuse", "scenes": len(scenes), "views": n_views,
         "seconds": [r["seconds"] for r in runs],
         "seconds_per_scene": [r["seconds"] / len(scenes) for r in runs],
         "phase5_seconds_per_scene": per_scene, "graphs": step3d.graphs + reuse_step.graphs,
         "launches_first_run_with_captures": first["launches"],
         "launches_second_run": second["launches"], "summary": first["summary"],
         "kept": [r["kept"] for r in first["record"]],
         "counter": [r["counter"] for r in first["record"]]})
    if step3d.graphs != 1 or reuse_step.graphs != 1 or any(second["launches"].values()):
        raise AssertionError("scene reuse did not run on its two graphs")
    for name in ("sparse_conv", "flash_attention", "deform_attn", "gn_silu_conv"):
        if first["launches"][name] == 0:
            raise AssertionError(f"{name}: no launch in the scene-reuse captures")
    for rec, sc in zip(first["record"], scenes):
        if rec["kept"] <= 0 or any(c != rec["kept"] for c in rec["counter"].values()):
            raise AssertionError(f"{rec['name']}: votes {rec['counter']}, {rec['kept']} kept")
        for stream, pred in rec["pred"].items():
            if pred.shape != (len(sc["coords"]),) or pred.min() < 0 \
                    or pred.max() >= cfg.test_classes:
                raise AssertionError(f"{rec['name']} {stream}: predictions do not cover the scene")
    for key in ("hIoU", "mIoU", "hIoU_2d", "mIoU_2d", "hIoU_3d", "mIoU_3d"):
        if not math.isfinite(first["summary"][key]):
            raise AssertionError(f"{key} = {first['summary'][key]}")
    if any(second["summary"][k] != first["summary"][k] for k in first["summary"]
           if k != "scenes_per_sec"):
        raise AssertionError("two scene-reuse runs of the same scenes differ")
    only_k1 = {k: (expected["sparse_conv"] if k == "sparse_conv" else 0) for k in KERNEL_NAMES}
    log(replayed_profile("scene_reuse_3d_profile", step3d, (sb,), only_k1))
    # a later view of a scene: the scene's tables are in the step's buffers,
    # the view's leaves and ids are copied in, one replay
    batch, ids, *_ = reuse_view_batch(scenes[0]["views"][0], caps,
                                      sb["point_valid"][0].cpu().numpy())
    reuse_step.load(batch, statics, step3d(sb), ids)

    def later_view(batch, ids):
        copy_into(reuse_step.inputs[0], batch)
        copy_into(reuse_step.inputs[3], ids)
        return reuse_step.run()

    log(replayed_profile("scene_reuse_view_profile", later_view, (batch, ids),
                         dict(with_statistics(expected), sparse_conv=0)))
    step3d.reset()
    reuse_step.reset()


# --------------------------------------------------------------------------
# training
# --------------------------------------------------------------------------

# a training step: two views of the bench's capacities, 20000 points each
TRAIN_BATCH, TRAIN_STEPS = 2, 3
# the wrappers' autograd Functions, by the name of their backward nodes
BACKWARD_NODES = {"sparse_conv": "_SparseConvBackward", "flash_attention": "_AttentionBackward",
                  "deform_attn": "_DeformAttnBackward", "gn_silu_conv": "_GnSiluConvBackward"}
# the tiny training step, card against CPU: loss terms as the train golden;
# gradients leaf by leaf as tests/test_torch_train.py holds the port to the
# JAX package (the model's gradient jumps where a bilinear sample crosses a
# pixel centre or a ReLU input crosses zero, so ~1e-6 apart in the forward
# moves a leaf by up to a few percent), and the attention key biases, whose
# gradient is zero in exact arithmetic, absolutely
TRAIN_TOL = {"loss": 2e-4, "grad_l2": 1e-2, "grad_max": 3e-2, "grad_zero": 1e-6, "stats": 1e-5}


def train_batch(cfg, caps, seed, device=None):
    """A synthetic training batch of TRAIN_BATCH views at full size. Its
    base/novel labels are drawn per point, so no mask would be novel- or
    base-dominant and loss_3d_contra would be 0: view 0 is made all novel
    and the others all base, so the term carries gradient."""
    from xmask3d_tpu_torch.data.synthetic import synthetic_batch

    b = synthetic_batch(TRAIN_BATCH, caps, seed=seed, num_points=20000, image_size=(512, 512),
                        mask_shape=tuple(cfg.mask_shape), context_length=77, vocab_size=49408,
                        device=device)
    b["binary_label_3d"][0] = 0.0
    b["binary_label_3d"][1:] = 1.0
    return b


def pick_backward_call(name, calls):
    """The recorded call of each kernel whose backward is checked: K1's
    first 27-tap conv with a live-row mask, K2's longest self-attention of
    the narrowest heads (the SD UNet's 4096 tokens at d 40), K3's first
    call."""
    if name == "sparse_conv":
        return next(c for c in calls if c[4] is not None and c[1].shape[0] == 27)
    if name == "flash_attention":
        return max(calls, key=lambda c: (c[0].shape[2] == c[1].shape[2], c[1].shape[2],
                                         -c[0].shape[3]))
    return calls[0]


def backward_check(table, name, call, dtype):
    """The call's kernel output taken back through the wrapper's Function
    under a seeded cotangent, against torch.autograd.grad of the plain
    version on the same inputs: (max abs error, worst error / tolerance)."""
    import torch

    k = table[name]
    tol = TOL[dtype]
    if dtype == "fp32":
        call = as_fp32(call)
    diff = [i for i, a in enumerate(call) if torch.is_tensor(a) and a.is_floating_point()]

    def run(fn):
        args = [a.detach().clone().requires_grad_() if i in diff else a
                for i, a in enumerate(call)]
        return fn(*args), [args[i] for i in diff]

    n = k["fn"].launches
    out, xs = run(k["fn"])
    gen = torch.Generator(device=out.device).manual_seed(0)
    ct = torch.randn(out.shape, generator=gen, device=out.device).to(out.dtype)
    got = torch.autograd.grad(out, xs, ct)
    ref_out, ys = run(k["plain"])
    ref = torch.autograd.grad(ref_out, ys, ct)
    torch.cuda.synchronize()
    if k["fn"].launches != n + 1:
        raise AssertionError(f"{name}: the backward launched the kernel")
    err, worst = 0.0, 0.0
    for g, r in zip(got, ref):
        if not torch.isfinite(g.float()).all():
            raise AssertionError(f"{name} ({dtype}): non-finite gradient")
        e = float((g.float() - r.float()).abs().max())
        err = max(err, e)
        worst = max(worst, e / (tol * max(1.0, float(r.float().abs().max()))))
    return err, worst


def group_norms(model, labels, store):
    """An optimizer step that first stores each trainable group's gradient
    norm, both 3D UNets apart, and the names of frozen parameters holding a
    gradient."""
    import torch

    def norms():
        groups = {"pc_decoder": [], "pc_binary_head": [], "others": []}
        frozen = []
        for n, p in model.named_parameters():
            if labels[n] == "frozen":
                if p.grad is not None:
                    frozen.append(n)
                continue
            if p.grad is not None:
                groups[n.split(".")[0] if labels[n] == "3d" else "others"].append(p.grad.float())
        out = {g: float(torch.nn.utils.get_total_norm(v)) if v else 0.0
               for g, v in groups.items()}
        store.append({"grad_norm": out, "frozen_with_grad": frozen})
    return norms


def profile_step(step_fn) -> dict:
    """One more training step under torch.profiler: device busy ms and idle
    share, kernels, and per kernel the device ms of its forward launches
    and of its plain backward (the device work under the Function's
    backward node)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        step_fn()
        torch.cuda.synchronize()
        wall_ms = (time.time() - t0) * 1e3
    events = prof.events()
    # the card's kernels and copies; not the optimizer's annotation ranges
    spans = sorted((e.time_range.start, e.time_range.end, e.name) for e in events
                   if e.device_type == DeviceType.CUDA
                   and not getattr(e, "is_user_annotation", False))
    busy_us, end = 0.0, float("-inf")
    for start, stop, _ in spans:
        busy_us += max(0.0, stop - max(start, end))
        end = max(end, stop)
    prefixes = {"sparse_conv": "sparse_conv_", "flash_attention": "flash_",
                "deform_attn": "deform_attn_"}
    forward = {k: sum((stop - start) / 1e3 for start, stop, n in spans if p in n)
               for k, p in prefixes.items()}
    by_name = {}
    for start, stop, n in spans:
        by_name[n] = by_name.get(n, 0.0) + (stop - start) / 1e3
    def kernels_under(e):
        return len(e.kernels) + sum(kernels_under(c) for c in e.cpu_children)

    backward = {k: {"device_ms": 0.0, "calls": 0, "kernels": 0} for k in prefixes}
    for e in events:
        if e.device_type == DeviceType.CPU and e.name.startswith("autograd::engine::evaluate"):
            for k in prefixes:
                if BACKWARD_NODES[k] in e.name:
                    backward[k]["device_ms"] += e.device_time_total / 1e3
                    backward[k]["calls"] += 1
                    backward[k]["kernels"] += kernels_under(e)
    return {"phase": "train_profile", "wall_ms": wall_ms, "kernels_seen": len(spans),
            "device_busy_ms": busy_us / 1e3, "device_idle_share": 1 - busy_us / 1e3 / wall_ms,
            "forward_device_ms": forward, "plain_backward": backward,
            "top": [[n[:80], ms] for n, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:12]]}


def train_phase(cfg, caps, table) -> None:
    """Full-width B15N4 training on the card through the trainer's pieces
    (the training build, `make_optimizer`, `make_train_step`); raises on any
    failed check."""
    import math

    import torch

    from xmask3d_tpu_torch.engine.builder import build_statics, build_train_model, label_tree
    from xmask3d_tpu_torch.engine.train_step import (
        create_train_state, make_optimizer, make_train_step)
    from xmask3d_tpu_torch.models.minkunet import MaskedBatchNorm

    t0 = time.time()
    model = build_train_model(cfg, seed=0)
    mc = model.cfg
    statics = build_statics(model, cfg)
    labels = label_tree(model)
    state = create_train_state(model, make_optimizer(model, cfg.lr_3d, cfg.lr_others, 1000,
                                                     schedule=cfg.learning_rate_type,
                                                     power=cfg.power), seed=0)
    step = make_train_step(dict(cfg.loss_weight))
    batches = [train_batch(cfg, caps, seed=300 + i) for i in range(TRAIN_STEPS + 2)]
    torch.cuda.synchronize()
    trainable = {g: sum(p.numel() for n, p in model.named_parameters() if labels[n] == g)
                 for g in ("3d", "others", "frozen")}
    log({"phase": "train_setup", "seconds": time.time() - t0, "batch": TRAIN_BATCH,
         "params": trainable, "param_dtype": str(mc.dtype),
         "live_voxels": [[int(n) for n in b["hierarchy"].levels[0].num] for b in batches],
         "live_points": [int(b["point_valid"].sum()) for b in batches],
         "targets": [int(b["target_valid"].sum()) for b in batches]})
    expected = expected_launches(mc)
    if expected["gn_silu_conv"]:
        raise AssertionError("the training step runs the VAE unfused (fused_gn off)")

    # warm-up step, recording every kernel call of its forward pass
    calls = {name: [] for name, n in expected.items() if n}
    reset_launches()
    with recording(calls):
        t0 = time.time()
        metrics = step(state, batches[0], statics, 1.0)
        torch.cuda.synchronize()
    log({"phase": "train_warmup_step", "ms": (time.time() - t0) * 1e3, "launches": launches(),
         "loss_total": float(metrics["loss_total"])})
    del metrics
    for name, n in expected.items():
        if len(calls.get(name, ())) != n or launches()[name] != n:
            raise AssertionError(f"{name}: {len(calls.get(name, ()))} calls, {launches()[name]} "
                                 f"launches in the warm-up step, expected {n}")
    for name, cs in calls.items():
        k = table[name]
        for dtype in ("bf16", "fp32"):
            cd = cs if dtype == "bf16" else [as_fp32(c) for c in cs]
            err, worst, at, _, outs = max_err(k["fn"], k["plain"], cd, TOL[dtype])
            del outs
            b_err, b_worst = backward_check(table, name, pick_backward_call(name, cs), dtype)
            log({"phase": "train_kernel_check", "kernel": name, "dtype": dtype, "calls": len(cd),
                 "max_abs_err": err, "worst_err_over_tol": worst, "worst_call": at,
                 "backward_max_abs_err": b_err, "backward_worst_err_over_tol": b_worst,
                 "tol": f"{TOL[dtype]} * max(1, max |plain|)"})
            if not (worst <= 1.0 and b_worst <= 1.0):
                raise AssertionError(f"{name} ({dtype}): forward {worst}x, backward {b_worst}x "
                                     "its tolerance")
            torch.cuda.empty_cache()
    del calls
    torch.cuda.empty_cache()

    # the counted steps
    masters = {g: [m.detach().clone() for m in ms]
               for g, ms in state.optimizer.masters().items()}
    bns = [m for m in model.modules() if isinstance(m, MaskedBatchNorm)]
    stats = [(m.mean.clone(), m.var.clone()) for m in bns]
    norms = []
    real_step = state.optimizer.step
    collect = group_norms(model, labels, norms)

    def step_with_norms(s):
        collect()
        real_step(s)

    state.optimizer.step = step_with_norms
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    step_ms, variants, step_metrics = [], {}, []
    with counting_variants(table, variants):
        for b in batches[1:1 + TRAIN_STEPS]:
            torch.cuda.synchronize()
            t0 = time.time()
            step_metrics.append(step(state, b, statics, 1.0))
            torch.cuda.synchronize()
            step_ms.append((time.time() - t0) * 1e3)
    state.optimizer.step = real_step
    losses = [{k: float(v) for k, v in m.items() if not k.startswith("metric_")}
              for m in step_metrics]
    counts = launches()
    peak = torch.cuda.max_memory_allocated()
    log({"phase": "train_steps", "steps": TRAIN_STEPS, "batch": TRAIN_BATCH, "step_ms": step_ms,
         "mean_step_ms": sum(step_ms) / TRAIN_STEPS, "peak_bytes": peak, "launches": counts,
         "expected_per_step": expected, "variants": variants, "losses": losses,
         "grad_norms": norms})
    for name, n in expected.items():
        if counts[name] != n * TRAIN_STEPS:
            raise AssertionError(f"{name}: {counts[name]} launches over {TRAIN_STEPS} steps, "
                                 f"expected {n * TRAIN_STEPS}")
    check_variants(variants, expected, TRAIN_STEPS)
    for i, (ls, nm) in enumerate(zip(losses, norms)):
        bad = [k for k, v in ls.items() if not math.isfinite(v)]
        if bad or "loss_3d_contra" not in ls:
            raise AssertionError(f"step {i}: non-finite or missing losses {bad}")
        bad = [g for g, v in nm["grad_norm"].items() if not (math.isfinite(v) and v > 0)]
        if bad or nm["frozen_with_grad"]:
            raise AssertionError(f"step {i}: gradient norms {nm['grad_norm']}, frozen parameters "
                                 f"with a gradient {nm['frozen_with_grad'][:5]}")
    if not any(ls["loss_3d_contra"] > 0 for ls in losses):
        raise AssertionError("loss_3d_contra was 0 in every step: it carried no gradient")
    moved = {g: sum(not torch.equal(a, b) for a, b in zip(ms, masters[g]))
             for g, ms in state.optimizer.masters().items()}
    bn_moved = sum(not torch.equal(m.mean, a) and not torch.equal(m.var, v)
                   for m, (a, v) in zip(bns, stats))
    log({"phase": "train_updates", "masters_moved": moved,
         "masters": {g: len(ms) for g, ms in masters.items()},
         "batchnorms_moved": bn_moved, "batchnorms": len(bns)})
    if not all(moved.values()) or bn_moved != len(bns):
        raise AssertionError(f"masters moved {moved}, BatchNorms moved {bn_moved} of {len(bns)}")
    del masters, stats, step_metrics

    log(profile_step(lambda: step(state, batches[-1], statics, 1.0)))
    del model, state, statics, batches
    torch.cuda.empty_cache()


def tiny_train_check(cfg_path) -> dict:
    """The tiny fp32 model (the CPU tests' reduced one) one training step on
    the card (kernels) against the CPU (plain versions), the same weights,
    batch and point draws: every loss term, the IoU histograms, each
    trainable leaf's gradient and the BatchNorm running statistics, within
    TRAIN_TOL."""
    import numpy as np
    import torch

    from xmask3d_tpu_torch.config import load_config
    from xmask3d_tpu_torch.data.batching import Capacities
    from xmask3d_tpu_torch.data.synthetic import synthetic_batch
    from xmask3d_tpu_torch.engine.builder import build_statics, build_train_model, label_tree
    from xmask3d_tpu_torch.engine.train_step import weight_losses
    from xmask3d_tpu_torch.ops.point_sample import point_draws

    cfg = load_config(cfg_path)
    cfg.update(arch_3d="MinkUNet14A", arch_binary_head="MinkUNet14A", mask_shape=[24, 32],
               compute_dtype="float32", dec_layers=2, pixel_enc_layers=2)
    caps = Capacities(max_points=512, max_voxels=256, max_targets=8)
    cpu = build_train_model(cfg, tiny=True, seed=1, device="cpu")
    gpu = copy.deepcopy(cpu).to("cuda")
    draws = point_draws(torch.Generator().manual_seed(0), cpu.cfg.dec_layers + 1, 2, 8,
                        cpu.cfg.num_points)
    reset_launches()
    results = {}
    for name, model, dev in (("cpu", cpu, "cpu"), ("cuda", gpu, "cuda")):
        b = synthetic_batch(2, caps, seed=3, num_points=400, image_size=(128, 128),
                            mask_shape=(24, 32), context_length=16, vocab_size=512, device=dev)
        b["binary_label_3d"][0] = 0.0
        b["binary_label_3d"][1] = 1.0
        statics = build_statics(model, cfg, device=dev)
        losses, _ = model(b, statics, train=True, draws=_to(draws, dev))
        weight_losses(losses, dict(cfg.loss_weight), contra_on=1.0).backward()
        results[name] = (
            {k: v.detach().cpu() for k, v in losses.items()},
            {n: p.grad.detach().cpu() for n, p in model.named_parameters() if p.grad is not None},
            {n: x.detach().cpu() for n, x in model.named_buffers()})
    (l_cpu, g_cpu, s_cpu), (l_gpu, g_gpu, s_gpu) = results["cpu"], results["cuda"]
    report, bad = {"phase": "reference_tiny_fp32_train", "launches": launches()}, []
    for k, want in l_cpu.items():
        got = l_gpu[k]
        if k.startswith("metric_"):  # an argmax near a tie may flip: reported only
            report[k + "_points_apart"] = float((got - want).abs().sum())
            continue
        err = float((got - want).abs().max())
        report[k] = err
        if not err <= TRAIN_TOL["loss"] * max(1.0, float(want.abs().max())):
            bad.append(f"{k}: {err}")
    labels = label_tree(cpu)
    top = max(float(g.abs().max()) for g in g_cpu.values())
    worst_l2, worst_max = 0.0, 0.0
    if set(g_cpu) != set(g_gpu) or any(labels[n] == "frozen" for n in g_cpu):
        bad.append("the two runs have gradients on different or frozen parameters")
    for n, want in g_cpu.items():
        got = g_gpu[n]
        if n.endswith("k_proj.bias"):
            if max(float(got.abs().max()), float(want.abs().max())) > TRAIN_TOL["grad_zero"] * top:
                bad.append(f"{n}: not zero")
            continue
        l2 = float((got - want).norm() / want.norm().clamp(min=1e-30))
        mx = float((got - want).abs().max() / want.abs().max().clamp(min=1e-30))
        worst_l2, worst_max = max(worst_l2, l2), max(worst_max, mx)
        if not (l2 <= TRAIN_TOL["grad_l2"] and mx <= TRAIN_TOL["grad_max"]):
            bad.append(f"{n}: L2 {l2}, max {mx}")
    report.update({"grad_leaves": len(g_cpu), "worst_grad_l2": worst_l2,
                   "worst_grad_max": worst_max, "tolerances": TRAIN_TOL})
    for n, want in s_cpu.items():
        if not np.isclose(float((s_gpu[n] - want).abs().max()), 0.0, atol=TRAIN_TOL["stats"]):
            bad.append(f"running statistic {n}")
    if any(report["launches"][k] == 0 for k in ("sparse_conv", "flash_attention", "deform_attn")):
        bad.append(f"a kernel did not launch: {report['launches']}")
    if bad:
        log(report)
        raise AssertionError("tiny training step: " + "; ".join(bad[:10]))
    return report


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(ROOT, "xmask3d_tpu_torch")):
        print("chip_smoke: run from a checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    # fp32 stays fp32 on the card: no TF32 in matmuls or convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from xmask3d_tpu_torch.config import load_config
    from xmask3d_tpu_torch.data.batching import Capacities
    from xmask3d_tpu_torch.data.synthetic import synthetic_batch
    from xmask3d_tpu_torch.engine.builder import build_model, build_statics
    from xmask3d_tpu_torch.engine.serve import fresh_vote_state, make_view_body
    from xmask3d_tpu_torch.ops import _build

    card = card_line()
    log({"phase": "card", "nvidia_smi": card, "torch": torch.__version__,
         "cuda": torch.version.cuda})

    t0 = time.time()
    build_log = _build.build_all()
    log({"phase": "build", "seconds": time.time() - t0, "kernels": list(_build.KERNELS),
         "ptxas": _build.resource_usage(build_log)})

    t0 = time.time()
    cfg = load_config(CONFIG)
    caps = Capacities(max_points=32768, max_voxels=24576, max_targets=24)
    model = build_model(cfg, seed=0)
    mc = model.cfg
    statics = build_statics(model, cfg)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    t_model = time.time() - t0
    t0 = time.time()
    views = [
        synthetic_batch(1, caps, seed=100 + i, num_points=20000, image_size=(512, 512),
                        mask_shape=tuple(cfg.mask_shape), context_length=77, vocab_size=49408)
        for i in range(4)
    ]
    log({"phase": "setup", "params": n_params, "dtype": str(mc.dtype),
         "model_seconds": t_model, "views_seconds": time.time() - t0,
         "live_voxels": [int(v["hierarchy"].levels[0].num[0]) for v in views],
         "live_points": [int(v["point_valid"].sum()) for v in views]})

    view_body = make_view_body(model, cfg)
    table = kernel_table()
    expected = expected_launches(mc)

    # warm-up view, recording every kernel call of the path
    calls = {name: [] for name, n in expected.items() if n}
    reset_launches()
    with recording(calls):
        votes, counter = fresh_vote_state(caps.max_points, mc.num_test_classes)
        t0 = time.time()
        view_body(views[0], statics, votes, counter)
        torch.cuda.synchronize()
    log({"phase": "warmup_view", "ms": (time.time() - t0) * 1e3,
         "recorded": {n: len(c) for n, c in calls.items()}, "launches": launches()})
    for name, n in expected.items():
        if len(calls.get(name, ())) != n or launches()[name] != n:
            raise AssertionError(f"{name}: {len(calls.get(name, ()))} calls, {launches()[name]} "
                                 f"launches in the warm-up view, expected {n}")

    rows = check_kernels(table, calls)
    log(tap_skipping(calls["sparse_conv"]))
    del calls
    torch.cuda.empty_cache()
    # the kernel checks emptied the allocator's cache: one uncounted view
    # fills it again, so the counted views time the path and not cudaMalloc
    votes, counter = fresh_vote_state(caps.max_points, mc.num_test_classes)
    t0 = time.time()
    view_body(views[0], statics, votes, counter)
    torch.cuda.synchronize()
    log({"phase": "rewarm_view", "ms": (time.time() - t0) * 1e3})

    # the main path, counted: three views through the view body
    votes, counter = fresh_vote_state(caps.max_points, mc.num_test_classes)
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    view_ms, variants = [], {}
    with counting_variants(table, variants):
        for batch in views[1:]:
            torch.cuda.synchronize()
            t0 = time.time()
            votes, counter = view_body(batch, statics, votes, counter)
            torch.cuda.synchronize()
            view_ms.append((time.time() - t0) * 1e3)
    counts = launches()
    peak = torch.cuda.max_memory_allocated()
    n_views = len(views) - 1
    log({"phase": "main_path", "views": n_views, "view_ms": view_ms,
         "mean_view_ms": sum(view_ms) / n_views, "peak_mem_bytes": peak,
         "launches": counts, "expected_per_view": expected, "variants": variants})
    for name, n in expected.items():
        if counts[name] != n * n_views:
            raise AssertionError(f"{name}: {counts[name]} launches, expected {n * n_views}")
    check_variants(variants, expected, n_views)
    for row in rows:
        row["launches"] = counts[row["name"]]

    valid = sum(int(b["point_valid"].sum()) for b in views[1:])
    if int(counter.sum()) != valid or int(votes.sum()) != valid:
        raise AssertionError(f"votes {int(votes.sum())} / counter {int(counter.sum())} "
                             f"!= {valid} valid view points")

    # the main path as captured graphs, and the scene scan; both time the
    # host before any profiler is attached to the process
    infer_graph, scan = graph_main_path(model, cfg, caps, views, statics)
    scene_scan(scan, model, cfg, caps, statics)
    bench_phase()
    log(profile_view(view_body, views[1], statics, votes, counter))
    log(replayed_profile("graph_profile", scan.step, (views[1], statics, votes, counter),
                         with_statistics(expected)))
    infer_graph.reset()
    scan.step.reset()
    del infer_graph, scan
    device_hierarchy(model, cfg, caps, statics, views, table)
    # the same view recorded again (its calls were freed before the counted
    # views, which slow down beside ~2 GB of held tensors)
    calls = {name: [] for name, n in expected.items() if n}
    with recording(calls):
        view_body(views[0], statics, *fresh_vote_state(caps.max_points, mc.num_test_classes))
    device_times(table, calls, rows)
    del calls
    outputs = model.eval_forward(views[1], statics)
    check_outputs(outputs, caps, mc)
    log({"phase": "outputs", "ok": True,
         "pred_labels": outputs["pred_labels"][0, :10].tolist(),
         "final_masks": int(outputs["final_mask_valid"].sum())})
    del model, outputs, views, statics, view_body, votes, counter
    gc.collect()
    torch.cuda.empty_cache()

    k4_row, model, statics, scenes, per_scene = scene_phase(cfg, caps, table)
    rows.append(k4_row)
    native_kmaps(cfg, caps, scenes)
    scene_reuse_phase(model, cfg, caps, statics, scenes, table, per_scene)
    del model, statics, scenes
    gc.collect()
    torch.cuda.empty_cache()

    train_phase(cfg, caps, table)

    log(reference_check(CONFIG))
    log(reference_check(CONFIG, fused_gn=True))
    log(tiny_train_check(CONFIG))

    print(card, flush=True)
    log({"kernels": rows})
    log({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
