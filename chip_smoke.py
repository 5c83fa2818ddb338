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
     `view_batch`: the bench's scan at 1, 2 and 4 views a forward
     (`BENCH_VIEW_BATCH`, 2 scenes each), scenes/s; a step of 2 and of 4
     views through the eager view body with every K1-K3 call held against
     its plain version and timed (K2 beside `scaled_dot_product_attention`),
     its peak bytes; 2 views a forward against 1 at a time on the same
     views, coverage equal, labels logged in bf16 and held in fp32 (the
     model built again in fp32 from the same seed); a replayed step at each
     B profiled (device busy a view, idle share, launches);
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
     copies in under either route; after the main path's outputs,
     `brick`: one view's two 3D UNets through the brick-dense path
     (`XMASK3D_BRICK=1`, `brick_divisor` 8, no voxel dropped) against K1,
     held in fp32, the bf16 gap logged, each path's device ms and the brick
     path's bound; and `int8`:
     the W8A8 op at a pixel-decoder and a VAE shape, int8 operands, scales
     and int32 products equal to the CPU's, fp32 outputs within 1 ulp,
     device ms beside the bf16 library call;
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
     `converted`: the same model (seed A) written as the three released
     files (an SD v1 CompVis checkpoint, an open_clip state dict and a
     b15n4.pth.tar-layout dict, fp32, `checkpoint/ref_format.py`), converted
     by `python -m xmask3d_tpu_torch.tools.convert_checkpoints` in a
     subprocess and loaded into a seed-B model by the CLI's `--converted`
     route: every covered tensor bit-equal to seed A's, the uncovered ones
     named (`CONVERTED_UNCOVERED`), then one view and one scene on the graph
     route equal to seed A's exactly; the files' bytes, the conversion's
     and the load's seconds, peak RSS and s/scene; the files removed;
     `txt2img`: the diffusion sampling path with the same model's SD UNet,
     VAE and text encoder (`txt2img_phase`): every K2 and K4 call of one
     denoising step and one full decode (K4 at the decoder's 256^2 and
     512^2 levels) held against its plain version and timed, then one
     512x512 image (`ddim50`, CFG 7.5) with the decoder unfused and on K4,
     its launches counted from 0 against `expected_txt2img_launches`, its
     values finite and in [0, 1]; s an image and a step, peak bytes, the
     device time of a profiled step;
  6. training at full width (`train_phase`): the serving models freed, the
     B15N4 model built for training (bf16 parameters, fp32 AdamW masters of
     the trainable groups, SD and CLIP frozen) and driven through the
     trainer's train step on synthetic batches of two views. A warm-up step
     records every kernel call of its forward pass, which are held against
     their plain versions (bf16 and fp32); one call of each kernel is taken
     back through its autograd Function and held against the plain
     version's autograd on the same inputs (K1's through the gather form of
     its backward and K2's, one call of each shape, through its kernels,
     `attn_bwd_*`, each holding under 100 MB above its entry, against the
     plain version's autograd in fp32, within the forward's tolerance); three
     counted steps check the launches a step, that every K1 call's backward
     took the gather form and every recorded K2 call's the kernels, the
     variants,
     every loss, each trainable group's
     gradient (both 3D UNets apart), that no frozen parameter has a
     gradient, and that the masters and the BatchNorm statistics moved;
     with the config's `remat_backbone` on, the UNet's K2 calls launch again
     in the backward (its checkpointed blocks recompute);
     `train_remat_*`: one forward and backward with remat off and on (the
     same weights, batch and draws, deterministic algorithms): losses and
     every trainable leaf's gradient bit-equal, launches; the default
     mode's run-to-run spread of the gradient; two steps each way
     for ms a step; one step at batch 8 each way for peak bytes (remat off
     may not fit, which is logged); a profiled step each way gives the
     device's busy time and each kernel's forward and backward
     device ms (each K2 backward node launching the three `attn_bwd_*`);
     `ddp` (`ddp_phase`): data parallelism through `parallel/mesh.py`: a
     step with a one-process NCCL group bit for bit the step without one;
     two ranks spawned on the card over gloo against one process at batch
     2 (bf16 timed, fp32 held to it), and the CLI's eval sharded over the
     two ranks equal to one process's;
     `tp` (`tp_phase`): tensor parallelism of the dense towers through
     `parallel/tensor.py`: two ranks on the card over gloo on a (1, 2) mesh
     at batch 2, each holding its slices of the sharded layers: an fp32
     step held to the one process's as `ddp`'s is (the sharded gradients
     made whole), bf16 steps for ms a rank, the model group's collectives
     and parameter and peak bytes a rank, one validation batch equal to
     one process's, and every K2 call of the step at the rank's heads held
     against its plain version and timed per shape;
     `act_shard` (`act_shard_phase`): activation sharding through
     `parallel/spatial.py`, the SD UNet and VAE in row bands: two ranks on
     the card over gloo on a (1, 2) mesh at batch 2, whole parameters and
     then with `shard_params` (sequence parallelism): each fp32 step held
     to the one process's as `ddp`'s is, bf16 steps for ms and peak bytes a
     rank beside one process's and `tp`'s, the model group's collectives
     and their bytes, every K2 call at its band shape held and timed per
     shape; K4 on row bands: a full-width 512^2 `fused_gn` encode in fp32
     equal to one process's, every band call of the moments and the conv
     held against the plain band version, the bf16 calls timed per shape;
  7. the tiny model on the card (fp32, kernels) against the same model on
     the CPU (plain versions), unfused and with `fused_gn`, and one training
     step of it, losses and gradients leaf by leaf.

The last line of standard output is `{"ok": true, "device": {...}}`; the
line before it is the `kernels` JSON object, and the one before that the
card's name and power limit from nvidia-smi. Exits non-zero, printing no
result, without CUDA or outside a checkout of the repository.
"""

from __future__ import annotations

import collections
import contextlib
import copy
import gc
import json
import os
import subprocess
import sys
import time
import warnings

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
    # the models' GroupNorm (`group_norm`): per SD UNet pass two a resblock
    # (down, middle, and the up blocks before the last tap) and one a spatial
    # transformer; the VAE's resblocks two each (K4's with fused_gn), its two
    # middle attention blocks and the encoder's norm_out; the backbone's
    # bottleneck projections, three a tap and a fourth on the shortcut of a
    # tap not 512 wide (`FeatureExtractorBackbone`'s projection width); the
    # pixel decoder's three input levels, lateral and output convs
    unet_gn = 2 * (n_lv * u.num_res_blocks + 2 + last) + blocks
    # K4 (with fused_gn): two GN -> SiLU -> conv stages per VAE resblock;
    # the encoder runs all of its blocks and two mid blocks, the decoder its
    # two mid blocks and the up blocks before its last tap
    v = mc.ldm.vae
    enc = len(v.ch_mult) * v.num_res_blocks + 2
    dec = 2 + min(max(mc.ldm.decoder_block_indices), len(v.ch_mult) * (v.num_res_blocks + 1))
    k4 = 2 * (enc + dec) if mc.fused_gn else 0
    gn = (unet_gn * len(mc.ldm.steps) + 2 * (enc + dec) + 3 - k4
          + sum(3 + (ch != 512) for ch in mc.ldm.feature_channels()) + 5)
    # K3: one sampling call per deformable encoder layer
    return {"sparse_conv": k1, "flash_attention": k2, "deform_attn": mc.pixel_enc_layers,
            "gn_silu_conv": k4, "group_norm": gn}


def expected_train_launches(mc) -> dict:
    """A training step's launches: the forward's, and with `remat_backbone`
    the UNet's attention again in the backward (each checkpointed
    SpatialTransformer recomputes its two K2 calls; the VAE's blocks are not
    checkpointed there, since none of their inputs needs a gradient). K1's
    backward launches its own kernels through the library, not through the
    wrapper, so it adds no K1 launch: each K1 call takes one gather-form
    backward (`sparse_conv.backward_calls`). The models' GroupNorm is not
    counted: its calls that autograd records take the plain formula, the
    frozen towers' take the kernel."""
    n = expected_launches(mc)
    del n["group_norm"]
    if mc.remat_backbone:
        n["flash_attention"] += expected_train_backwards(mc)["flash_attention"]
    return n


def expected_train_backwards(mc) -> dict:
    """A training step's backwards of K1 and K2 by their wrappers' counters
    (`backward_calls`), all on the kernels: every K1 call (gather form) and
    every K2 call but the VAE's two, whose inputs need no gradient (the SD
    UNet's, bf16 at head dims 40 / 80 / 160: `attn_bwd_*`)."""
    n = expected_launches(mc)
    return {"sparse_conv": n["sparse_conv"], "flash_attention": n["flash_attention"] - 2}


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
        "group_norm": {
            "fn": gn_conv.group_norm, "plain": gn_conv.group_norm_reference,
            # 16-byte loads of x, as the statistics' plan takes them
            "variant": lambda call: "vec" if gn_conv.stats_plan(
                1, call[0].shape[-1], call[0].dtype, aligned=call[0].data_ptr() % 16 == 0)[2] > 1
            else "scalar",
            # batch, values of a channel, C, SiLU
            "shape": lambda call: (call[0].shape[0],
                                   call[0][0].numel() // call[0].shape[-1],
                                   call[0].shape[-1], int(call[5])),
            "source": "xmask3d_tpu_torch/csrc/gn_conv.cu",
            "replaces": "xmask3d_tpu/models/layers.py:17",
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
    if name in ("gn_silu_conv", "affine_silu_conv"):
        # x and the output once, the norm (or affine) and conv parameters; a
        # multiply-add per tap, input and output channel of every output pixel
        x, scale, bias, w, b = call[:5]
        bsz, h, wd, c = x.shape
        return nbytes(x, scale, bias, w, b, out), 2 * bsz * h * wd * w.shape[3] * 9 * c
    if name == "group_moments":
        # one read of x; a subtraction and two multiply-adds a value
        return nbytes(call[0], out), 5 * call[0].numel()
    if name == "group_norm":
        # x read once and the output written once (the function's floor; the
        # kernels read x twice), the parameters; the statistics' five
        # operations a value, then a subtraction and a multiply-add, and
        # SiLU's exponential, add and division
        x, weight, bias, _, _, silu = call
        return nbytes(x, weight, bias, out), (8 + 3 * bool(silu)) * x.numel()
    value, _, loc, aw = call
    b, lq, heads, n_lv, npts, _ = loc.shape
    # four taps, one multiply-add per channel each
    return nbytes(value, loc, aw, out), 8 * b * lq * heads * n_lv * npts * value.shape[3]


def bound(name, calls, outs):
    """(least ms for the calls, "bytes" or "operations"): per call the larger
    of its bytes over the memory rate and its operations over the peak rate
    of their type (bf16 tensor cores, or fp32 for the deformable sampling,
    whose bilinear weights are fp32, and GroupNorm, which computes in fp32)."""
    peak = PEAK_OPS["fp32"] if name in ("deform_attn", "group_norm") else PEAK_OPS["bf16"]
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
                      "gn_affine_", "gn_moments_", "gn_apply_")}
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
    "group_norm": ("gn_apply_kernel",),
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


@contextlib.contextmanager
def exact_group_norm():
    """The models' GroupNorm with exact statistics while it lasts: float64
    `var_mean` per (batch, group) and the centred form in float64, cast back
    to x's type. On the card every GroupNorm call that autograd does not
    record takes `group_norm`'s kernel, whose statistics are Welford's with
    fp64 merges; the plain formula's one-pass fp32 variance E[x^2] - E[x]^2
    cancels in the tiny model's groups of two values (the SD UNet's 1x1 maps
    of 64 channels), by up to 7% of rsqrt(var + eps), and its stride-32
    features amplify the rounding: on the CPU alone the one-pass formula's
    s5 moves by 0.0193 between 4 and 8 threads, past the stage tolerance of
    0.0135, and these statistics' by 2.1e-5."""
    import torch
    import torch.nn.functional as F

    from xmask3d_tpu_torch.models import layers

    def exact(x, weight, bias, groups, eps=1e-6, silu=False):
        cg = x.shape[-1] // groups
        xd = x.double().reshape(x.shape[0], -1, groups, cg)
        var, mean = torch.var_mean(xd, dim=(1, 3), correction=0, keepdim=True)
        y = ((xd - mean) * (torch.rsqrt(var + eps) * weight.double().reshape(groups, cg))
             + bias.double().reshape(groups, cg)).reshape(x.shape).to(x.dtype)
        return F.silu(y) if silu else y

    plain, layers.group_norm = layers.group_norm, exact
    try:
        yield
    finally:
        layers.group_norm = plain


def reference_check(cfg_path, fused_gn: bool = False) -> dict:
    """Tiny model, fp32: the card (kernels) against the CPU (plain versions;
    GroupNorm with exact statistics, `exact_group_norm`, as the card's
    kernel computes them) on the same weights and batch, stage by stage with
    the CPU's stage inputs, within 2e-3 of each output's largest value (the
    eval golden's tolerance); then the whole eval forward, whose discrete
    outputs must agree on 99%. The card against the CPU's one-pass GroupNorm
    formula is logged beside (`<stage>_vs_one_pass`). With `fused_gn` the
    VAE resblocks run K4 on the card, which must launch for every stage of
    both runs; every other GroupNorm call of both runs must take
    `group_norm`'s kernel."""
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
        with exact_group_norm():
            ref = trunk_stages(cpu, b_cpu, s_cpu)
        got = trunk_stages(gpu, b_gpu, s_gpu, given=_to(ref, "cuda"))
    report, bad = {"phase": "reference_tiny_fp32" + ("_fused_gn" if fused_gn else "")}, []
    for (key, a), (_, b) in zip(_leaves(ref), _leaves(got)):
        err = float((a.float() - b.float().cpu()).abs().max())
        tol = 2e-3 * float(a.float().abs().max()) + 1e-6
        report[key] = err
        if not err <= tol:
            bad.append(f"{key}: {err} > {tol}")
    with exact_group_norm():
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
    gn = 2 * expected_launches(gpu.cfg)["group_norm"]
    if report["launches"]["group_norm"] != gn:
        bad.append(f"group_norm launched {report['launches']['group_norm']} times, expected {gn}")
    with torch.no_grad():
        one_pass = trunk_stages(cpu, b_cpu, s_cpu)
        got = trunk_stages(gpu, b_gpu, s_gpu, given=_to(one_pass, "cuda"))
    for (key, a), (_, b) in zip(_leaves(one_pass), _leaves(got)):
        report[f"{key}_vs_one_pass"] = float((a.float() - b.float().cpu()).abs().max())
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
        if x is None or y is None:  # no brick metadata
            if x is not y:
                return False
        elif isinstance(x, list):
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
# released weights: files in the released layouts, converted, served
# --------------------------------------------------------------------------

# where the converted phase writes its files (git-ignored; removed after)
CONVERTED_DIR = os.path.join(ROOT, "_converted")
# tensors of the model no released file holds, and why
CONVERTED_UNCOVERED = {
    "params/backbone/feature_extractor/ldm_extractor/shared_noise":
        "the SD extractor's fixed noise: the reference draws it at construction from a fixed "
        "seed and saves it in no file; the port draws it from the model's seed, so the "
        "served model takes the writer's noise before its outputs are compared",
}
# tensors the converters write as a constant rather than from a file
CONVERTED_CONSTANT = {
    "params/backbone/feature_extractor/ldm_extractor/text_encoder/text_projection":
        "SD's text encoder has no projection: the converter writes the identity, and the SD "
        "path reads the encodings before it",
}


def _flat_tensors(model) -> dict:
    """{"<collection>/<jax path>": tensor} of a port model (the weight
    bridge's names)."""
    from xmask3d_tpu_torch.checkpoint.from_jax import bridge_tensors

    return {f"{b.collection}/{b.path}": b.tensor for b in bridge_tensors(model)}


def converted_phase(model, cfg, caps, scenes, view) -> None:
    """Serving released weights without JAX or yaml: the scene phase's model
    (seed A, fused_gn) written as the three released files
    (`checkpoint/ref_format.py`: an SD v1 CompVis checkpoint, an open_clip
    state dict and a b15n4.pth.tar-layout dict, fp32), converted by
    `python -m xmask3d_tpu_torch.tools.convert_checkpoints` in a subprocess,
    loaded into a seed-B model by the CLI's `--converted` route
    (`build_serving_model`). Every tensor the files cover must equal seed
    A's bit for bit after the bf16 cast; the ones they do not cover are
    named and must be in CONVERTED_UNCOVERED (the served model then takes
    seed A's), the converters' constants in CONVERTED_CONSTANT. Then, with
    the counts set to 0, one main-path view through `make_infer_step`'s
    graph and one synthetic scene through `run_eval_scenes` on the graph
    route: the served model's outputs must equal seed A's exactly (no kernel
    of the path adds in a run-dependent order). Logs the files' bytes, the
    conversion's and the load's seconds, peak RSS, s/scene; removes the
    files."""
    import resource
    import shutil

    import numpy as np
    import torch

    from xmask3d_tpu_torch.checkpoint.ref_format import write_released
    from xmask3d_tpu_torch.engine.builder import build_statics
    from xmask3d_tpu_torch.engine.infer_cli import (
        build_serving_model, make_infer_step, run_eval_scenes)

    shutil.rmtree(CONVERTED_DIR, ignore_errors=True)
    os.makedirs(CONVERTED_DIR)
    try:
        free = shutil.disk_usage(CONVERTED_DIR).free
        t0 = time.time()
        paths = write_released(model, CONVERTED_DIR)
        write_s = time.time() - t0
        sizes = {k: os.path.getsize(v) for k, v in paths.items()}
        npz = os.path.join(CONVERTED_DIR, "converted.npz")
        # `python -m xmask3d_tpu_torch.tools.convert_checkpoints ...`, its
        # resident bytes sampled every 50 ms from /proc/self/statm (getrusage
        # would count the parent's pages at the fork)
        code = ("import os, runpy, threading, time\n"
                "peak = [0]\n"
                "def watch():\n"
                "    while True:\n"
                "        pages = int(open('/proc/self/statm').read().split()[1])\n"
                "        peak[0] = max(peak[0], pages * os.sysconf('SC_PAGE_SIZE'))\n"
                "        time.sleep(0.05)\n"
                "threading.Thread(target=watch, daemon=True).start()\n"
                "runpy.run_module('xmask3d_tpu_torch.tools.convert_checkpoints', "
                "run_name='__main__', alter_sys=True)\n"
                "print('rss_peak_bytes', peak[0])\n")
        cmd = [sys.executable, "-c", code, "--xmask3d", paths["xmask3d"], "--sd", paths["sd"],
               "--clip", paths["clip"], "--out", npz]
        t0 = time.time()
        r = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=600)
        convert_s = time.time() - t0
        if r.returncode != 0:
            raise AssertionError(
                f"the conversion tool failed: {r.stdout[-2000:]}{r.stderr[-2000:]}")
        child_rss = int(r.stdout.split("rss_peak_bytes")[-1].split()[0]) or "not measured"
        npz_bytes = os.path.getsize(npz)
        for p in paths.values():
            os.remove(p)
        t0 = time.time()
        served = build_serving_model(cfg, fused_gn=True, converted=npz, seed=1)
        torch.cuda.synchronize()
        load_s = time.time() - t0
        with np.load(npz) as f:
            keys = set(f.files)
        os.remove(npz)
    finally:
        shutil.rmtree(CONVERTED_DIR, ignore_errors=True)
    self_rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024  # the whole run's

    want, got = _flat_tensors(model), _flat_tensors(served)
    uncovered = sorted(set(got) - keys)
    differ = [k for k in sorted(keys & set(got)) if k not in CONVERTED_CONSTANT
              and not (got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]))]
    log({"phase": "converted_load", "file_bytes": sizes, "npz_bytes": npz_bytes,
         "disk_free_bytes": free, "write_seconds": write_s, "convert_seconds": convert_s,
         "load_seconds": load_s, "convert_stdout": r.stdout.strip().splitlines()[-5:-1],
         "peak_rss_bytes": {"conversion": child_rss, "this_process_so_far": self_rss},
         "tensors": len(got), "covered": len(keys & set(got)), "npz_keys": len(keys),
         "uncovered": uncovered, "uncovered_why": CONVERTED_UNCOVERED,
         "constant": sorted(keys & set(CONVERTED_CONSTANT)), "constant_why": CONVERTED_CONSTANT,
         "differ": differ[:10]})
    if keys - set(got):
        raise AssertionError(
            f"converted tensors with no destination: {sorted(keys - set(got))[:5]}")
    unexplained = sorted(set(uncovered) - set(CONVERTED_UNCOVERED))
    if differ or unexplained:
        raise AssertionError(f"converted tensors differ from seed A's: {differ[:5]}; uncovered "
                             f"and unexplained: {unexplained}")
    with torch.no_grad():
        for k in uncovered:
            got[k].copy_(want[k])

    outs, records, seconds = [], [], []
    expected = expected_launches(model.cfg)
    for m in (model, served):
        statics = build_statics(m, cfg)
        step, route_2d = make_infer_step(m, cfg)
        if m is served:
            reset_launches()  # the served model's path: one view, one scene
        outs.append({k: v.clone() for k, v in step(view, statics).items()})
        record = []
        t0 = time.time()
        run_eval_scenes(scenes[:1], 1, cfg=cfg, caps=caps, statics=statics, infer_step=step,
                        route_2d=route_2d, record=record)
        seconds.append(time.time() - t0)
        records.append(record[0])
        step.reset()
        del step, statics
    counts = launches()
    gaps = {k: float((outs[1][k].float() - outs[0][k].float()).abs().max())
            for k in outs[0] if outs[0][k].is_floating_point()}
    apart = [k for k in outs[0] if not torch.equal(outs[1][k], outs[0][k])]
    apart += [f"scene {s}" for s in records[0]["pred"]
              if not (records[1]["pred"][s] == records[0]["pred"][s]).all()]
    apart += ["scene votes"] if (records[1]["kept"], records[1]["counter"]) != \
        (records[0]["kept"], records[0]["counter"]) else []
    log({"phase": "converted_serve", "launches": counts, "expected_per_view": expected,
         "view_keys": sorted(outs[0]), "float_max_abs_diff": gaps, "apart": apart,
         "scene_views": records[1]["views"], "kept": records[1]["kept"],
         "seconds_per_scene": {"seed_a": seconds[0], "converted": seconds[1]}})
    if apart:
        raise AssertionError(f"the converted model's outputs differ from seed A's: {apart}")
    missing = [k for k in ("sparse_conv", "flash_attention", "deform_attn", "gn_silu_conv")
               if counts[k] == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the converted path: {missing}")
    del served
    torch.cuda.empty_cache()


# --------------------------------------------------------------------------
# training
# --------------------------------------------------------------------------

# a training step: two views of the bench's capacities, 20000 points each
TRAIN_BATCH, TRAIN_STEPS = 2, 3
# the larger batch at which remat's peak memory is read
REMAT_BATCH = 8
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


def train_batch(cfg, caps, seed, device=None, batch=None):
    """A synthetic training batch of `batch` (TRAIN_BATCH) views at full size. Its
    base/novel labels are drawn per point, so no mask would be novel- or
    base-dominant and loss_3d_contra would be 0: view 0 is made all novel
    and the others all base, so the term carries gradient."""
    from xmask3d_tpu_torch.data.synthetic import synthetic_batch

    b = synthetic_batch(batch or TRAIN_BATCH, caps, seed=seed, num_points=20000,
                        image_size=(512, 512),
                        mask_shape=tuple(cfg.mask_shape), context_length=77, vocab_size=49408,
                        device=device)
    b["binary_label_3d"][0] = 0.0
    b["binary_label_3d"][1:] = 1.0
    return b


def pick_backward_calls(name, calls):
    """The recorded calls of each kernel whose backward is checked: K1's
    first 27-tap conv with a live-row mask (a level's own `kmap3`, whose
    transpose is SAME_LEVEL), K2's first call of each shape (its kernels'
    rounding grows with the keys' common component, which only the model's
    own activations carry), K3's first call."""
    if name == "sparse_conv":
        return [next(c for c in calls if c[4] is not None and c[1].shape[0] == 27)]
    if name == "flash_attention":
        return list({(c[0].shape, c[1].shape): c for c in reversed(calls)}.values())
    return calls[:1]


# the most the allocator may hold above its level at entry while K2's kernel
# backward of one call runs: its gradients and a row of D, never a (Tq, Tk)
# matrix (the plain VJP held three of 1.07 GB for the 4096-token call at 2 views)
K2_BACKWARD_BYTES = 100 * 2 ** 20


def backward_check(table, name, call, dtype):
    """The call's kernel output taken back through the wrapper's Function
    under a seeded cotangent, against torch.autograd.grad of the plain
    version on the same inputs: (max abs error, worst error / tolerance,
    bytes the backward held above its entry).
    K1's call passes its map's transpose (SAME_LEVEL), so its backward is
    the gather form (`k1_dgrad_*`, `k1_wgrad_*` in bf16); K2's bf16 call
    takes the kernels' backward (`attn_bwd_*`) and holds under
    K2_BACKWARD_BYTES. Both are held to the plain version's autograd on the
    same values in fp32 within the forward's tolerance: the plain VJP in
    bf16 rounds each tap's feature gradient, the kernels once."""
    import torch

    from xmask3d_tpu_torch.ops import flash_attention, sparse_conv

    k = table[name]
    tol = TOL[dtype]
    if dtype == "fp32":
        call = as_fp32(call)
    diff = [i for i, a in enumerate(call) if torch.is_tensor(a) and a.is_floating_point()]
    kwargs = {"transpose": sparse_conv.SAME_LEVEL} if name == "sparse_conv" else {}

    def run(fn, args, **kw):
        args = [a.detach().clone().requires_grad_() if i in diff else a
                for i, a in enumerate(args)]
        return fn(*args, **kw), [args[i] for i in diff]

    n, forms = k["fn"].launches, dict(sparse_conv.sparse_conv.backward_calls)
    routes = dict(flash_attention.attention.backward_calls)
    out, xs = run(k["fn"], call, **kwargs)
    gen = torch.Generator(device=out.device).manual_seed(0)
    ct = torch.randn(out.shape, generator=gen, device=out.device).to(out.dtype)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    got = torch.autograd.grad(out, xs, ct)
    torch.cuda.synchronize()
    held = torch.cuda.max_memory_allocated() - base
    if name in ("sparse_conv", "flash_attention"):
        ref_out, ys = run(k["plain"], as_fp32(call))
        ref = torch.autograd.grad(ref_out, ys, ct.float())
    else:
        ref_out, ys = run(k["plain"], call)
        ref = torch.autograd.grad(ref_out, ys, ct)
    torch.cuda.synchronize()
    if k["fn"].launches != n + 1:
        raise AssertionError(f"{name}: the backward launched the kernel")
    if name == "sparse_conv" and sparse_conv.sparse_conv.backward_calls["kernel"] != \
            forms["kernel"] + 1:
        raise AssertionError("sparse_conv: the backward did not take the gather form")
    if name == "flash_attention":
        kernels = dtype == "bf16" and flash_attention.backward_plan(call[0].dtype, call[0].shape[3])
        route = "kernel" if kernels else "plain"
        if flash_attention.attention.backward_calls[route] != routes[route] + 1:
            raise AssertionError(f"flash_attention ({dtype}): the backward did not take the "
                                 f"{route} route")
        if kernels and held >= K2_BACKWARD_BYTES:
            raise AssertionError(f"flash_attention: the kernel backward held {held} bytes above "
                                 "its entry")
    err, worst = 0.0, 0.0
    for g, r in zip(got, ref):
        if not torch.isfinite(g.float()).all():
            raise AssertionError(f"{name} ({dtype}): non-finite gradient")
        e = float((g.float() - r.float()).abs().max())
        err = max(err, e)
        worst = max(worst, e / (tol * max(1.0, float(r.float().abs().max()))))
    return err, worst, held


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
    and of its backward (the device work under the Function's backward
    node)."""
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
        return [x.name for x in e.kernels] + [n for c in e.cpu_children for n in kernels_under(c)]

    def short(n):  # "void (anonymous namespace)::attn_bwd_dq_kernel<48>(...)" -> attn_bwd_dq_kernel
        return n.split("<")[0].split("::")[-1].split("(")[0].split(" ")[-1]

    backward = {k: {"device_ms": 0.0, "calls": 0, "kernels": 0, "names": collections.Counter()}
                for k in prefixes}
    for e in events:
        if e.device_type == DeviceType.CPU and e.name.startswith("autograd::engine::evaluate"):
            for k in prefixes:
                if BACKWARD_NODES[k] in e.name:
                    names = kernels_under(e)
                    backward[k]["device_ms"] += e.device_time_total / 1e3
                    backward[k]["calls"] += 1
                    backward[k]["kernels"] += len(names)
                    backward[k]["names"].update(short(n) for n in names)
    return {"phase": "train_profile", "wall_ms": wall_ms, "kernels_seen": len(spans),
            "device_busy_ms": busy_us / 1e3, "device_idle_share": 1 - busy_us / 1e3 / wall_ms,
            "forward_device_ms": forward, "backward": backward,
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
    from xmask3d_tpu_torch.models.layers import set_remat
    from xmask3d_tpu_torch.models.minkunet import MaskedBatchNorm
    from xmask3d_tpu_torch.ops.flash_attention import attention
    from xmask3d_tpu_torch.ops.sparse_conv import sparse_conv

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
    expected = expected_train_launches(mc)
    if expected["gn_silu_conv"]:
        raise AssertionError("the training step runs the VAE unfused (fused_gn off)")
    if not mc.remat_backbone:
        raise AssertionError("the config's remat_backbone did not reach the model")

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
            picks = pick_backward_calls(name, cs)
            checked = [backward_check(table, name, c, dtype) for c in picks]
            b_err, b_worst = (max(x[i] for x in checked) for i in range(2))
            log({"phase": "train_kernel_check", "kernel": name, "dtype": dtype, "calls": len(cd),
                 "max_abs_err": err, "worst_err_over_tol": worst, "worst_call": at,
                 "backward_max_abs_err": b_err, "backward_worst_err_over_tol": b_worst,
                 # each checked call: its shape, worst error / tolerance, bytes held
                 "backward_by_call": [[list(k["shape"](c)), w, h]
                                      for c, (_, w, h) in zip(picks, checked)],
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
    forms = dict(sparse_conv.backward_calls)
    routes = dict(attention.backward_calls)
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
    forms = {k: n - forms[k] for k, n in sparse_conv.backward_calls.items()}
    routes = {k: n - routes[k] for k, n in attention.backward_calls.items()}
    backwards = expected_train_backwards(mc)
    peak = torch.cuda.max_memory_allocated()
    log({"phase": "train_steps", "steps": TRAIN_STEPS, "batch": TRAIN_BATCH, "step_ms": step_ms,
         "mean_step_ms": sum(step_ms) / TRAIN_STEPS, "peak_bytes": peak, "launches": counts,
         "expected_per_step": expected, "k1_backward_forms": forms,
         "k2_backward_routes": routes, "expected_backwards_per_step": backwards,
         "variants": variants,
         "losses": losses, "grad_norms": norms})
    for name, n in expected.items():
        if counts[name] != n * TRAIN_STEPS:
            raise AssertionError(f"{name}: {counts[name]} launches over {TRAIN_STEPS} steps, "
                                 f"expected {n * TRAIN_STEPS}")
    if forms != {"kernel": backwards["sparse_conv"] * TRAIN_STEPS, "plain": 0}:
        raise AssertionError(f"K1's backwards by form {forms}: every K1 call of a step should "
                             "take the gather form")
    if routes != {"kernel": backwards["flash_attention"] * TRAIN_STEPS, "plain": 0}:
        raise AssertionError(f"K2's backwards by route {routes}: every recorded K2 call of a "
                             "step should take the kernels")
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

    remat_phase(model, state, step, batches, statics, cfg, caps, labels)
    for on in (True, False):
        set_remat(model, on)
        prof = profile_step(lambda: step(state, batches[-1], statics, 1.0))
        log({**prof, "remat": on})
        k2 = prof["backward"]["flash_attention"]
        if k2["calls"] != backwards["flash_attention"] or dict(k2["names"]) != {
                n: k2["calls"] for n in ("attn_bwd_rowdot_kernel", "attn_bwd_dkdv_kernel",
                                         "attn_bwd_dq_kernel")}:
            raise AssertionError(f"K2's backward nodes: {k2['calls']} calls, kernels "
                                 f"{dict(k2['names'])}: each should launch the three attn_bwd_*")
    set_remat(model, True)
    del model, state, statics, batches
    torch.cuda.empty_cache()


# autograd nodes whose CUDA backward adds with atomics in the default mode:
# gather's (a scatter-add), advanced indexing's (index_put_ with accumulate),
# and K3's Function, whose plain VJP runs gathers inside (K1's model calls
# take the gather form, which adds in a fixed order)
ATOMIC_BACKWARD = ("GatherBackward", "IndexBackward", "IndexSelectBackward",
                   "EmbeddingBackward", "_DeformAttnBackward")


def backward_nodes(loss) -> dict:
    """{node type: count} of the nodes of `loss`'s autograd graph named in
    ATOMIC_BACKWARD."""
    seen, todo, out = set(), [loss.grad_fn], collections.Counter()
    while todo:
        fn = todo.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        name = type(fn).__name__
        if name.startswith(ATOMIC_BACKWARD):
            out[name] += 1
        todo.extend(f for f, _ in fn.next_functions)
    return out


def remat_phase(model, state, step, batches, statics, cfg, caps, labels) -> None:
    """`remat_backbone` on the card. One forward and backward of batch 2
    with remat off and on, the same weights, batch and point draws, under
    `torch.use_deterministic_algorithms` (the plain backwards' scatter-adds
    and the point sampler's backward otherwise add in a run-dependent
    order): the losses and every leaf's gradient bit-equal, the launches
    the forward's plus, with remat, the UNet's K2 calls recomputed. Then
    remat off twice in the default mode, each run against the other, for
    the run-to-run spread of the gradient (logged, not held), beside what
    reads its cause: whether the two runs' losses are equal, the gradient
    norms of the leaves that move most against the median leaf's, and the
    backward's nodes that add with atomics on the card (a gather's backward
    is a scatter-add; K3's plain VJP runs gathers inside its Function).
    Then two optimizer steps each way (off,
    on, on, off) for ms a step and peak bytes, and one step at batch 8 each
    way for peak bytes (remat off may not fit: that is logged, not
    raised)."""
    import torch

    from xmask3d_tpu_torch.engine.train_step import weight_losses
    from xmask3d_tpu_torch.models.layers import set_remat
    from xmask3d_tpu_torch.ops.point_sample import point_draws

    mc = model.cfg
    b = batches[1]
    dev = b["img"].device
    n_blocks = set_remat(model, False)

    def fwd_bwd(on, nodes=None):
        set_remat(model, on)
        gen = torch.Generator(device=dev).manual_seed(7)
        draws = point_draws(gen, mc.dec_layers + 1, b["target_labels"].shape[0],
                            b["target_labels"].shape[1], mc.num_points, mc.oversample_ratio,
                            mc.importance_sample_ratio, device=dev)
        model.zero_grad(set_to_none=True)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        losses, _ = model(b, statics, train=True, draws=draws)
        total = weight_losses(losses, dict(cfg.loss_weight), mc.class_weight, mc.mask_weight,
                              mc.dice_weight, contra_on=1.0)
        if nodes is not None:
            nodes.update(backward_nodes(total))
        total.backward()
        torch.cuda.synchronize()
        out = {"peak": torch.cuda.max_memory_allocated(), "launches": launches(),
               "losses": {k: v.detach().clone() for k, v in losses.items()},
               "grads": {n: p.grad.detach().clone() for n, p in model.named_parameters()
                         if p.grad is not None}}
        model.zero_grad(set_to_none=True)
        return out

    def rel_l2(got, want):
        return {n: float((got[n].float() - w.float()).norm() / w.float().norm().clamp(min=1e-30))
                for n, w in want.items() if not n.endswith("k_proj.bias")}

    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            off, on = fwd_bwd(False), fwd_bwd(True)
    finally:
        torch.use_deterministic_algorithms(False)
    # ops with no deterministic implementation (warn_only names them)
    nondeterministic = sorted({str(w.message).split(" does not have")[0] for w in caught
                               if "deterministic" in str(w.message)})
    bad = [f"loss {k}" for k in off["losses"] if not torch.equal(on["losses"][k], off["losses"][k])]
    if off["grads"].keys() != on["grads"].keys() \
            or any(labels[n] == "frozen" for n in off["grads"]):
        bad.append("the two runs have gradients on different or frozen parameters")
    bad += [n for n, g in off["grads"].items() if not torch.equal(on["grads"].get(n, g * 0), g)]
    expect_on, expect_off = expected_train_launches(mc), expected_launches(mc)
    for name in ("sparse_conv", "flash_attention", "deform_attn"):
        if on["launches"][name] != expect_on[name] or off["launches"][name] != expect_off[name]:
            bad.append(f"{name}: launches {off['launches'][name]} / {on['launches'][name]}, "
                       f"expected {expect_off[name]} / {expect_on[name]}")
    n_leaves = len(off["grads"])
    log({"phase": "train_remat_check", "batch": TRAIN_BATCH, "remat_blocks": n_blocks,
         "deterministic_algorithms": True, "grad_leaves": n_leaves,
         "losses_and_grads_bit_equal": not bad,
         "no_deterministic_implementation": nondeterministic,
         "peak_bytes_deterministic": {"off": off["peak"], "on": on["peak"]},
         "launches": {"off": off["launches"], "on": on["launches"]},
         "loss_total": float(weight_losses(off["losses"], dict(cfg.loss_weight)))})
    del off, on
    if bad:
        raise AssertionError("remat on against off: " + "; ".join(bad[:10]))

    # the default mode: two runs without remat, each against the other
    nodes = collections.Counter()
    first, second = fwd_bwd(False, nodes), fwd_bwd(False)
    spread = rel_l2(second["grads"], first["grads"])
    norms = {n: float(g.float().norm()) for n, g in first["grads"].items() if n in spread}
    median_norm = sorted(norms.values())[len(norms) // 2]
    worst = sorted(spread, key=lambda n: -spread[n])[:5]
    whole = float(torch.sqrt(sum(((second["grads"][n].float() - first["grads"][n].float())
                                  .norm() ** 2) for n in spread))
                  / torch.sqrt(sum(first["grads"][n].float().norm() ** 2 for n in spread)))
    log({"phase": "train_remat_default_mode", "batch": TRAIN_BATCH, "remat": False,
         "compares": "two default-mode runs, the second against the first",
         "losses_bit_equal": all(torch.equal(second["losses"][k], v)
                                 for k, v in first["losses"].items()),
         "rel_l2": {"max": spread[worst[0]],
                    "median": sorted(spread.values())[len(spread) // 2],
                    "whole_gradient": whole,
                    "bit_equal_leaves": sum(v == 0 for v in spread.values())},
         "median_leaf_grad_norm": median_norm,
         "worst": [{"leaf": n, "rel_l2": spread[n], "grad_norm": norms[n],
                    "diff_norm": spread[n] * norms[n]} for n in worst],
         "atomic_add_backward_nodes": dict(nodes)})
    del first, second

    timing = {"off": [], "on": []}
    peaks = {"off": [], "on": []}
    for i, flag in enumerate((False, True, True, False)):
        set_remat(model, flag)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        step(state, batches[1 + i % TRAIN_STEPS], statics, 1.0)
        torch.cuda.synchronize()
        timing["on" if flag else "off"].append((time.time() - t0) * 1e3)
        peaks["on" if flag else "off"].append(torch.cuda.max_memory_allocated())
    log({"phase": "train_remat_steps", "batch": TRAIN_BATCH, "order": "off, on, on, off",
         "step_ms": timing, "peak_bytes": peaks})

    big = train_batch(cfg, caps, seed=400, batch=REMAT_BATCH)
    out = {}
    for flag in (True, False):
        set_remat(model, flag)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        try:
            step(state, big, statics, 1.0)
            torch.cuda.synchronize()
            out["on" if flag else "off"] = {"step_ms": (time.time() - t0) * 1e3,
                                            "peak_bytes": torch.cuda.max_memory_allocated()}
        except torch.cuda.OutOfMemoryError as e:
            if flag:
                raise
            model.zero_grad(set_to_none=True)
            out["off"] = {"fits": False, "error": str(e).splitlines()[0][:200],
                          "peak_bytes_before_failing": torch.cuda.max_memory_allocated()}
    set_remat(model, True)
    del big
    gc.collect()
    torch.cuda.empty_cache()
    log({"phase": "train_remat_batch", "batch": REMAT_BATCH, **out,
         "card_bytes": torch.cuda.get_device_properties(0).total_memory})


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


# --------------------------------------------------------------------------
# txt2img: the diffusion sampling path through SD v1 at full width
# --------------------------------------------------------------------------

# one 512 x 512 image (64^2 latents), classifier-free guidance at UNet batch 2
TXT2IMG_RESPACING, TXT2IMG_GUIDANCE = "ddim50", 7.5
TXT2IMG_PROMPT = "a photograph of a living room with a sofa, a table and a lamp"


def expected_txt2img_launches(mc, steps: int, fused_gn: bool) -> dict:
    """One image's launches: the two K2 calls of every SD UNet spatial
    transformer a step (the full forward: each attention level's down and up
    blocks and the middle one) and the VAE decoder's middle attention once;
    with `fused_gn`, two K4 calls per decoder resblock (its two middle
    blocks and every up block)."""
    u, v = mc.ldm.unet, mc.ldm.vae
    levels = sum(lv in u.attention_levels for lv in range(len(u.ch_mult)))
    transformers = levels * (2 * u.num_res_blocks + 1) + 1
    k4 = 2 * (2 + len(v.ch_mult) * (v.num_res_blocks + 1)) if fused_gn else 0
    return {"sparse_conv": 0, "flash_attention": 2 * transformers * steps + 1,
            "deform_attn": 0, "gn_silu_conv": k4}


def txt2img_phase(model, cfg, statics, table) -> list:
    """`models/txt2img.py` `sample_images` with the model's SD UNet, VAE and
    text encoder (seeded random weights): the prompt's and the empty
    prompt's contexts, `ddim50`, CFG 7.5, one 512 x 512 image, with the VAE
    decoder's resblocks unfused and on K4. First every K2 and K4 call of one
    denoising step (the UNet's full forward at batch 2) and of one decode is
    recorded and held against its plain version (bf16 and fp32), timed and
    profiled (`check_kernels`, `device_times`). Then one image each way with
    the counts set to 0 before and read after: the launches against
    `expected_txt2img_launches`, the variants, the image's shape, values
    finite and in [0, 1]; seconds an image and a step, the decode's
    seconds, peak bytes, and the device ms of one profiled step. Returns
    the kernel rows of the recorded calls (K2 in the sampler, K4 at the
    decoder's shapes)."""
    import torch

    from xmask3d_tpu_torch.engine.builder import data_tokenizer
    from xmask3d_tpu_torch.models.diffusion import GaussianDiffusion
    from xmask3d_tpu_torch.models.txt2img import sample_images
    from xmask3d_tpu_torch.models.vae import ResnetBlock

    mc = model.cfg
    ldm = model.backbone.feature_extractor.ldm_extractor
    unet, vae = ldm.unet, ldm.vae
    dev = next(unet.parameters()).device
    dt = unet.time_embed_0.weight.dtype
    with torch.no_grad():
        cond = ldm.embed_text(torch.from_numpy(data_tokenizer(cfg)([TXT2IMG_PROMPT])).to(dev))
        uncond = ldm.embed_text(statics["uncond_tokens"])
    diffusion = GaussianDiffusion.create(mc.ldm.diffusion_steps, mc.ldm.noise_schedule,
                                         TXT2IMG_RESPACING)
    n = diffusion.num_timesteps
    stride = 2 ** (len(mc.ldm.vae.ch_mult) - 1)
    latent = (1, 512 // stride, 512 // stride, mc.ldm.unet.in_channels)
    blocks = [m for m in vae.modules() if isinstance(m, ResnetBlock)]
    ctx = torch.cat([cond, uncond]).to(dt)
    t2 = torch.full((2,), int(diffusion.timestep_map[-1]), dtype=torch.int64, device=dev)
    x = torch.randn(latent, generator=torch.Generator(device=dev).manual_seed(1), device=dev)

    def denoise_step():
        with torch.no_grad():
            eps = unet(torch.cat([x, x]), t2, ctx, full=True)[0].float()
            e_c, e_u = eps.chunk(2)
            return e_u + TXT2IMG_GUIDANCE * (e_c - e_u)

    for m in blocks:
        m.fused_gn = True
    calls = {"flash_attention": [], "gn_silu_conv": []}
    reset_launches()
    with recording(calls):
        denoise_step()
        with torch.no_grad():
            vae.decode(x.to(dt))
        torch.cuda.synchronize()
    want = expected_txt2img_launches(mc, 1, True)
    log({"phase": "txt2img_recorded", "calls": {k: len(v) for k, v in calls.items()},
         "expected": want, "launches": launches()})
    for name, cs in calls.items():
        if len(cs) != want[name]:
            raise AssertionError(f"txt2img: {len(cs)} {name} calls in a step and a decode, "
                                 f"expected {want[name]}")
    rows = check_kernels(table, calls)
    device_times(table, calls, rows)
    for row in rows:
        row["launches"] = len(calls[row["name"]])
    log({"phase": "txt2img_kernel_rows", "rows": rows})
    del calls
    torch.cuda.empty_cache()
    prof = profile_view(denoise_step)
    prof["phase"] = "txt2img_step_profile"
    log(prof)

    images = {}
    for fused in (False, True):
        for m in blocks:
            m.fused_gn = fused
        expected = expected_txt2img_launches(mc, n, fused)
        with torch.no_grad():  # one uncounted decode: each way's first use of its layouts
            vae.decode(x.to(dt))
        torch.cuda.synchronize()
        t0 = time.time()
        with torch.no_grad():
            vae.decode(x.to(dt))
        torch.cuda.synchronize()
        decode_s = time.time() - t0
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        variants = {}
        with counting_variants(table, variants):
            t0 = time.time()
            img = sample_images(unet, vae, diffusion, cond, uncond,
                                torch.Generator(device=dev).manual_seed(0),
                                latent_hw=latent[1:3], latent_dim=latent[3],
                                guidance_scale=TXT2IMG_GUIDANCE)
            torch.cuda.synchronize()
            seconds = time.time() - t0
        counts = launches()
        log({"phase": "txt2img", "fused_gn": fused, "respacing": TXT2IMG_RESPACING,
             "steps": n, "guidance": TXT2IMG_GUIDANCE, "shape": list(img.shape),
             "seconds_per_image": seconds, "seconds_per_step": (seconds - decode_s) / n,
             "decode_seconds": decode_s, "peak_bytes": torch.cuda.max_memory_allocated(),
             "launches": counts, "expected": expected, "variants": variants,
             "min": float(img.min()), "max": float(img.max()), "mean": float(img.mean())})
        for name, k in expected.items():
            if counts[name] != k:
                raise AssertionError(f"txt2img (fused_gn {fused}): {counts[name]} {name} "
                                     f"launches, expected {k}")
        check_variants(variants, expected, 1)
        if tuple(img.shape) != (1, 512, 512, 3):
            raise AssertionError(f"txt2img: image shape {tuple(img.shape)}")
        if not (torch.isfinite(img).all() and float(img.min()) >= 0 and float(img.max()) <= 1):
            raise AssertionError("txt2img: values not finite or outside [0, 1]")
        images[fused] = img
    log({"phase": "txt2img_fused_vs_unfused",
         "max_abs_diff": float((images[True] - images[False]).abs().max())})
    for m in blocks:
        m.fused_gn = True
    return rows


# --------------------------------------------------------------------------
# ddp: data-parallel training and sharded eval across processes
# --------------------------------------------------------------------------

DDP_DIR = os.path.join(ROOT, "_ddp")
# the CLI's synthetic scenes at the bench's capacities
DDP_EVAL_ARGV = ["--config", CONFIG, "--synthetic", "--num_scenes", "2",
                 "max_points", "32768", "max_voxels", "24576"]
# Two ranks against one process, held in fp32 (in bf16 the split changes
# which roundings the batch-size-dependent kernels make, ~1e-3 of a loss):
# each loss term, trainable leaf's gradient, BatchNorm buffer and the whole
# gradient within TRAIN_TOL, or within DDP_SPREAD_MULTIPLE times how far
# the one process's own value moves when its input voxel features are
# nudged by DDP_NUDGE relative (two seeds). The model's gradient at seeded
# random weights can be chaotic (on the CPU's tiny model a 1e-7 nudge of
# the input moves the conditioning leaves' gradients by 5x their norm), and
# the split changes the BatchNorm sums' rounding just so.
DDP_SPREAD_MULTIPLE, DDP_NUDGE, DDP_NUDGE_SEEDS = 8.0, 1e-6, (7, 8)


def ddp_step(model, statics, batch, draws, cfg) -> dict:
    """One train step from the model's current weights with a new optimizer,
    on `batch` with the point `draws` given: the losses and histograms, each
    trainable parameter's fp32 master gradient as the update sees it (summed
    over the ranks under a process group), the buffers after it, the
    step's host ms and each all-reduce's ms (the gradients', the
    metrics')."""
    import torch

    from xmask3d_tpu_torch.engine import train_step as ts

    state = ts.create_train_state(model, ts.make_optimizer(
        model, cfg.lr_3d, cfg.lr_others, 1000, schedule=cfg.learning_rate_type,
        power=cfg.power), seed=0)
    name = {id(p): n for n, p in model.named_parameters()}
    grads, reduce_ms = {}, []
    real_step, real_reduce = state.optimizer.step, ts.all_reduce_sum_

    def keep_grads(s):
        for pairs in state.optimizer.pairs.values():
            for p, m in pairs:
                grads[name[id(p)]] = m.grad.detach().clone()
        real_step(s)

    def timed_reduce(tensors):
        torch.cuda.synchronize()
        t0 = time.time()
        real_reduce(tensors)
        torch.cuda.synchronize()
        reduce_ms.append((time.time() - t0) * 1e3)

    state.optimizer.step = keep_grads
    ts.all_reduce_sum_ = timed_reduce
    try:
        torch.cuda.synchronize()
        t0 = time.time()
        metrics = ts.make_train_step(dict(cfg.loss_weight))(state, batch, statics, 1.0,
                                                            draws=draws)
        torch.cuda.synchronize()
        ms = (time.time() - t0) * 1e3
    finally:
        ts.all_reduce_sum_ = real_reduce
        state.optimizer.step = real_step  # no cycle: the optimizer's memory goes with it
    return {"metrics": {k: v.detach().cpu() for k, v in metrics.items()}, "grads": grads,
            "buffers": {n: b.detach().clone() for n, b in model.named_buffers()},
            "step_ms": ms, "reduce_ms": reduce_ms}


def _ddp_cfg(dtype: str):
    from xmask3d_tpu_torch.config import load_config

    cfg = load_config(CONFIG)
    cfg.update(compute_dtype=dtype)
    return cfg


def _deterministic(fn, *args):
    import torch

    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        return fn(*args)
    finally:
        torch.use_deterministic_algorithms(False)


def _weights_sum(model) -> float:
    import torch

    with torch.no_grad():
        return float(sum(t.double().sum() for t in list(model.parameters())
                         + list(model.buffers())))


def _ddp_rank(rank: int, world: int) -> None:
    """A rank of the two-rank phase (a spawned process): gloo on the one
    card; the B15N4 training build from the parent's seed with rank 0's
    weights broadcast, one step on its row of the saved batch and draws,
    in bf16 (the configs' type, the default mode: the second of two steps
    timed) and in fp32 (under deterministic algorithms: compared); then the
    CLI's sharded eval.
    Writes its results to DDP_DIR/rank<r>.pt, a traceback to rank<r>.err on
    failure."""
    import traceback

    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK="0")
    sys.path.insert(0, ROOT)
    import torch
    import torch.distributed as dist

    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        from xmask3d_tpu_torch.engine import infer_cli
        from xmask3d_tpu_torch.engine.builder import build_statics, build_train_model
        from xmask3d_tpu_torch.parallel.mesh import broadcast_module, init_distributed, rows_of_rank

        dev = init_distributed(init_method=f"file://{os.path.join(DDP_DIR, 'rendezvous')}",
                               backend="gloo")
        data = torch.load(os.path.join(DDP_DIR, "inputs.pt"), map_location=dev,
                          weights_only=False)
        batch, draws = rows_of_rank(data["batch"]), rows_of_rank(data["draws"], dim=1)
        out = {"device": str(dev)}
        for dtype in ("bfloat16", "float32"):
            cfg = _ddp_cfg(dtype)
            model = build_train_model(cfg, seed=0, device=dev)
            t0 = time.time()
            broadcast_module(model)
            torch.cuda.synchronize()
            broadcast_s = time.time() - t0
            weights_sum = _weights_sum(model)
            statics = build_statics(model, cfg, device=dev)
            torch.cuda.reset_peak_memory_stats()
            if dtype == "bfloat16":  # the second step is timed: the first loads the kernels
                ddp_step(model, statics, batch, draws, cfg)
                step = ddp_step(model, statics, batch, draws, cfg)
                step = {k: step[k] for k in ("metrics", "step_ms", "reduce_ms")}
            else:
                step = _deterministic(ddp_step, model, statics, batch, draws, cfg)
                step["grads"] = {k: v.cpu() for k, v in step["grads"].items()}
                step["buffers"] = {k: v.cpu() for k, v in step["buffers"].items()}
            step.update(peak_bytes=torch.cuda.max_memory_allocated(), broadcast_s=broadcast_s,
                        weights_sum=weights_sum)
            out[dtype] = step
            del model, statics
            torch.cuda.empty_cache()
        t0 = time.time()
        out["eval"] = infer_cli.main(DDP_EVAL_ARGV)
        out["eval_seconds"] = time.time() - t0
        torch.save(out, os.path.join(DDP_DIR, f"rank{rank}.pt"))
    except BaseException:
        with open(os.path.join(DDP_DIR, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _rel(a, b) -> float:
    return float((a.float() - b.float()).norm() / b.float().norm().clamp(min=1e-30))


def _spawn_ranks(world: int, timeout: float, target=None, directory: str = DDP_DIR) -> list:
    """Each rank's results of `target` (`_ddp_rank` unless given), read
    from `directory`; raises if one failed or hung."""
    import multiprocessing

    import torch

    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=target or _ddp_rank, args=(r, world)) for r in range(world)]
    t0 = time.time()
    for p in procs:
        p.start()
    for p in procs:
        p.join(max(1.0, timeout - (time.time() - t0)))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(10)
    errs = []
    for r in range(world):
        path = os.path.join(directory, f"rank{r}.err")
        if os.path.exists(path):
            with open(path) as f:
                errs.append(f.read())
    if hung or errs or any(p.exitcode != 0 for p in procs):
        raise AssertionError(f"{os.path.basename(directory)} ranks: hung {hung}, exit codes "
                             f"{[p.exitcode for p in procs]}\n" + "\n".join(errs))
    return [torch.load(os.path.join(directory, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


def ddp_compare(one, nudged, ranks) -> dict:
    """The two ranks' fp32 step against the one process's (module comment
    above DDP_SPREAD_MULTIPLE): a report with the failures under "bad"."""
    import torch

    got = ranks[0]
    bad = []
    if got["weights_sum"] != ranks[1]["weights_sum"] or got["weights_sum"] != one["weights_sum"]:
        bad.append("the ranks' weights differ from each other's or this process's")
    for what in ("grads", "buffers"):
        if not all(torch.equal(v, ranks[1][what][k]) for k, v in got[what].items()):
            bad.append(f"the two ranks' {what} differ")
    loss_gap, hist_apart = {}, {}
    for k, want in one["metrics"].items():
        g = got["metrics"][k]
        if k.startswith("grad_norm"):
            continue
        if k.startswith("metric_"):  # an argmax near a tie may flip: reported only
            hist_apart[k] = [float((g - want).abs().sum())] + [
                float((n["metrics"][k] - want).abs().sum()) for n in nudged]
            continue
        gap = float((g - want).abs().max())
        moved = max(float((n["metrics"][k] - want).abs().max()) for n in nudged)
        loss_gap[k] = [gap, moved]
        if not (gap <= TRAIN_TOL["loss"] * (1 + float(want.abs().max()))
                or gap <= DDP_SPREAD_MULTIPLE * moved):
            bad.append(f"{k}: {float(g)} against {float(want)} (nudged: {moved} apart)")
    rows = []
    for what in ("grads", "buffers"):
        for k, want in one[what].items():
            if not want.is_floating_point() or float(want.float().norm()) == 0:
                continue
            want = want.cpu()
            gap = _rel(got[what][k], want)
            sp = max(_rel(n[what][k], want) for n in nudged)
            rows.append((gap / max(sp, 1e-30), gap, sp, k))
            if not (gap <= TRAIN_TOL["grad_l2"] or gap <= DDP_SPREAD_MULTIPLE * sp):
                bad.append(f"{k}: relative L2 {gap}, nudged {sp}")
    names = list(one["grads"])

    def flat(grads):
        return torch.cat([grads[k].cpu().float().reshape(-1) for k in names])

    ref = flat(one["grads"])
    whole = _rel(flat(got["grads"]), ref)
    whole_spread = max(_rel(flat(n["grads"]), ref) for n in nudged)
    if not (whole <= TRAIN_TOL["grad_l2"] or whole <= DDP_SPREAD_MULTIPLE * whole_spread):
        bad.append(f"the whole gradient: relative L2 {whole}, nudged {whole_spread}")
    rows.sort(reverse=True)
    return {"loss_gap_and_nudged": loss_gap, "histogram_points_apart_and_nudged": hist_apart,
            "whole_grad_rel_l2": whole, "whole_grad_nudged": whole_spread, "leaves": len(rows),
            "worst_gap_over_nudged": [[k, gap, sp] for _, gap, sp, k in rows[:6]],
            "worst_gap": sorted(([gap, k] for _, gap, _, k in rows), reverse=True)[:6],
            "bad": bad}


def validation_hists(model, cfg, batch, statics) -> dict:
    """The validate step's IoU histograms of one batch (deterministic
    algorithms), on the host ("hists"), and what `tie_flips` reads of the
    same forward: each stream's routed class scores (B, P, L) before its
    argmax ("scores"), the binary routing, each point's last covering mask
    and the valid points. The scores' argmax must give the histograms."""
    import torch

    from xmask3d_tpu_torch.engine.infer import routed_2d_scores, routed_scores
    from xmask3d_tpu_torch.engine.validate import make_validate_step
    from xmask3d_tpu_torch.utils.metrics import intersection_and_union

    mc = model.cfg
    hists = _deterministic(make_validate_step(model, cfg), batch, statics)

    @torch.no_grad()
    def forward():
        was_training = model.training
        model.eval()
        try:
            return model.eval_forward(batch, statics)
        finally:
            model.train(was_training)

    outputs = _deterministic(forward)
    r = routed_scores(outputs, mc.base_category, mc.novel_category, cfg.base_ratio,
                      cfg.novel_ratio)
    b, p = r["pred"].shape[:2]
    ident = torch.arange(p, dtype=torch.int32, device=r["pred"].device).expand(b, p)
    scores = {"pred": r["pred"], "pred_3d": r["pred_3d"],
              "pred_2d": routed_2d_scores(r["feat_2d"], ident, r["binary_pred"], r["text"],
                                          r["logit_scale"], mc.base_category, mc.novel_category)}
    for name, s in scores.items():
        again = intersection_and_union(
            s.argmax(dim=-1).int(), batch["labels_3d"], mc.num_test_classes,
            ignore_index=tuple(mc.ignore_category), valid=batch["point_valid"])
        if not all(torch.equal(a, h) for a, h in zip(again, hists[name])):
            raise AssertionError(f"validation {name}: the scores' argmax does not give the "
                                 "validate step's histograms")
    mask = outputs["final_mask_3d"] & outputs["final_mask_valid"][:, :, None]
    q_ids = torch.arange(mask.shape[1], device=mask.device)[None, :, None]
    return {"hists": {k: [t.cpu() for t in v] for k, v in hists.items()},
            "scores": {k: v.cpu() for k, v in scores.items()},
            "binary": r["binary_pred"].cpu(),
            "last_q": torch.where(mask, q_ids, torch.full_like(q_ids, -1)).amax(dim=1).cpu(),
            "valid": batch["point_valid"].bool().cpu()}


def tie_flips(one, got) -> tuple:
    """The labels of `got` that differ from `one`'s on valid points (both
    `validation_hists` of one batch), split into ties and the rest. A label
    is a tie where both runs route the point alike (the same binary
    prediction and last covering mask) and the top two of its routed scores
    in `one` lie closer than `got`'s scores move from `one`'s: the stream's
    largest change over the points routed alike, on the classes not routed
    away. Returns (ties, others, that change by stream)."""
    import torch

    valid = one["valid"]
    alike = (one["binary"] == got["binary"]) & (one["last_q"] == got["last_q"]) & valid
    ties, others, moved = [], [], {}
    for stream, s1 in one["scores"].items():
        s2 = got["scores"][stream]
        live = alike[..., None] & (s1 > -1e9) & (s2 > -1e9)
        moved[stream] = float((s2 - s1).abs()[live].max()) if live.any() else 0.0
        l1, l2 = s1.argmax(dim=-1), s2.argmax(dim=-1)
        top2 = s1.topk(2, dim=-1).values
        for b, p in ((l1 != l2) & valid).nonzero().tolist():
            margin = float(top2[b, p, 0] - top2[b, p, 1])
            entry = {"stream": stream, "view": b, "point": p,
                     "labels": [int(l1[b, p]), int(l2[b, p])], "top_two_margin": margin,
                     "routed_alike": bool(alike[b, p]), "scores_moved": moved[stream]}
            (ties if entry["routed_alike"] and margin < moved[stream] else others).append(entry)
    return ties, others, moved


def ddp_phase(caps) -> dict:
    """`parallel/mesh.py` on the card, the B15N4 training build, one batch of
    two views (view 0 all novel, view 1 all base: unequal masks, points and
    flagged masks) with fixed point draws. (a) bf16, the configs' type: one
    step with a one-process NCCL group equals the same step with no group,
    bit for bit (losses, every master gradient, the BatchNorm statistics),
    under deterministic algorithms. (b) Two ranks spawned on the one card
    over gloo (NCCL refuses two ranks on one card), one view each, against
    one process at batch 2: two bf16 steps in the default mode each, the
    second timed (step ms, the reductions' ms, peak bytes a rank); an fp32 step under
    deterministic algorithms each, held to the one process's by
    `ddp_compare` (the ranks' gradients and statistics bit-equal to each
    other's). (c) The same ranks run the CLI's sharded eval of two
    synthetic scenes (one a rank) and their summed meters give the
    one-process run's summary exactly. Returns what the `tp` phase holds
    its ranks to: the fp32 one-process step and its nudged spread, the
    batch and draws, one validation batch's histograms in fp32, and the
    bf16 one-process step's ms and peak bytes."""
    import math
    import shutil
    import socket

    import torch
    import torch.distributed as dist

    from xmask3d_tpu_torch.engine import infer_cli
    from xmask3d_tpu_torch.engine.builder import build_statics, build_train_model, label_tree
    from xmask3d_tpu_torch.ops.point_sample import point_draws

    t0 = time.time()
    cfg = _ddp_cfg("bfloat16")
    batch = train_batch(cfg, caps, seed=400, batch=2)
    dev = batch["img"].device
    t = batch["target_labels"].shape[1]
    report = {"phase": "ddp_setup", "targets": batch["target_valid"].sum(1).tolist(),
              "live_points": batch["point_valid"].sum(1).tolist(), "novel_view": 0,
              "base_view": 1}
    one, nudged = {}, []
    for dtype in ("bfloat16", "float32"):
        cfg = _ddp_cfg(dtype)
        model = build_train_model(cfg, seed=0)
        mc = model.cfg
        statics = build_statics(model, cfg)
        labels = label_tree(model)
        if dtype == "bfloat16":
            draws = point_draws(torch.Generator(device=dev).manual_seed(0), mc.dec_layers + 1, 2,
                                t, mc.num_points, mc.oversample_ratio, mc.importance_sample_ratio,
                                device=dev)
        start = {n: v.detach().clone() for n, v in model.state_dict().items()
                 if labels.get(n, "buffer") != "frozen"}
        weights_sum = _weights_sum(model)

        def run(b, deterministic=True):
            model.load_state_dict(start, strict=False)
            torch.cuda.reset_peak_memory_stats()
            out = _deterministic(ddp_step, model, statics, b, draws, cfg) if deterministic \
                else ddp_step(model, statics, b, draws, cfg)
            out["peak_bytes"] = torch.cuda.max_memory_allocated()
            return out

        if dtype == "bfloat16":
            run(batch, deterministic=False)  # the second step is timed: the first loads
            timed = run(batch, deterministic=False)
            report.update(bf16_one_process_step_ms=timed["step_ms"],
                          bf16_one_process_peak_bytes=timed["peak_bytes"])
            del timed
            # (a) world size 1 over NCCL against no process group
            base = run(batch)
            with socket.socket() as sock:
                sock.bind(("localhost", 0))
                port = sock.getsockname()[1]
            dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}", rank=0,
                                    world_size=1)
            try:
                nccl = run(batch)
            finally:
                dist.destroy_process_group()
            same = {what: all(torch.equal(nccl[what][k], v) for k, v in base[what].items())
                    for what in ("metrics", "grads", "buffers")}
            log({"phase": "ddp_world1_nccl", "bit_equal": same, "deterministic": True,
                 "step_ms": [base["step_ms"], nccl["step_ms"]], "reduce_ms": nccl["reduce_ms"],
                 "grad_leaves": len(base["grads"])})
            if not all(same.values()):
                raise AssertionError(f"one-process NCCL group against no group: {same}")
            del base, nccl
        else:
            # (b)'s reference in fp32, and its own spread under nudged inputs
            one = run(batch)
            one["weights_sum"] = weights_sum
            for seed in DDP_NUDGE_SEEDS:
                g = torch.Generator(device=dev).manual_seed(seed)
                feats = batch["voxel_feats"]
                noise = torch.randn(feats.shape, generator=g, device=dev)
                out = run(dict(batch, voxel_feats=feats * (1 + DDP_NUDGE * noise)))
                nudged.append({k: {n: v.cpu() for n, v in out[k].items()}
                               for k in ("metrics", "grads", "buffers")})
                del out
            # the `tp` phase's one-process validation batch
            model.load_state_dict(start, strict=False)
            val_batch = train_batch(cfg, caps, seed=500, batch=2)
            one_val = validation_hists(model, cfg, val_batch, statics)
        del model, statics, start
        gc.collect()
        torch.cuda.empty_cache()
    report["seconds"] = time.time() - t0
    log(report)

    shutil.rmtree(DDP_DIR, ignore_errors=True)
    os.makedirs(DDP_DIR)
    try:
        torch.save({"batch": batch, "draws": draws}, os.path.join(DDP_DIR, "inputs.pt"))
        t0 = time.time()
        ranks = _spawn_ranks(2, 900.0)
    finally:
        shutil.rmtree(DDP_DIR, ignore_errors=True)
    ranks_seconds = time.time() - t0

    cmp = ddp_compare(one, nudged, [r["float32"] for r in ranks])
    bad = cmp.pop("bad")
    one_eval = infer_cli.main(DDP_EVAL_ARGV)
    eval_equal = {k: all(r["eval"][k] == v or (math.isnan(r["eval"][k]) and math.isnan(v))
                         for r in ranks)
                  for k, v in one_eval.items() if k != "scenes_per_sec"}
    if not all(eval_equal.values()):
        bad.append(f"sharded eval differs: {[k for k, v in eval_equal.items() if not v]}")
    log({"phase": "ddp_two_ranks", "backend": "gloo", "ranks": 2, "batch": 2,
         "seconds": ranks_seconds, "device": [r["device"] for r in ranks],
         "bf16_step_ms": [r["bfloat16"]["step_ms"] for r in ranks],
         "bf16_reduce_ms": [r["bfloat16"]["reduce_ms"] for r in ranks],
         "bf16_peak_bytes": [r["bfloat16"]["peak_bytes"] for r in ranks],
         "bf16_broadcast_s": [r["bfloat16"]["broadcast_s"] for r in ranks],
         "fp32_step_ms": [r["float32"]["step_ms"] for r in ranks],
         "fp32_one_process_step_ms": one["step_ms"],
         "fp32_reduce_ms": [r["float32"]["reduce_ms"] for r in ranks],
         "fp32_peak_bytes": [r["float32"]["peak_bytes"] for r in ranks],
         "fp32_one_process_peak_bytes": one["peak_bytes"], **cmp,
         "eval_summary": one_eval, "eval_seconds": [r["eval_seconds"] for r in ranks],
         "eval_equal": all(eval_equal.values()), "bad": bad[:10]})
    if bad:
        raise AssertionError("ddp: " + "; ".join(bad[:10]))
    return {"one": one, "nudged": nudged, "batch": batch, "draws": draws,
            "val_batch": val_batch, "val": one_val,
            "bf16_step_ms": report["bf16_one_process_step_ms"],
            "bf16_peak_bytes": report["bf16_one_process_peak_bytes"]}


# --------------------------------------------------------------------------
# tp: tensor parallelism of the dense towers (the mesh's model axis)
# --------------------------------------------------------------------------

TP_DIR = os.path.join(ROOT, "_tp")


@contextlib.contextmanager
def model_collectives(group, record, sync: bool):
    """Every all-reduce and all-gather over `group` appended to `record` as
    (name, ms, bytes of the rank's input); ms only with `sync` (the card
    synchronised around each, which slows the step), else 0."""
    import torch
    import torch.distributed as dist

    real = {n: getattr(dist, n) for n in ("all_reduce", "all_gather")}

    def wrap(name, fn):
        def call(*args, **kw):
            if kw.get("group") is not group:
                return fn(*args, **kw)
            t = args[0] if name == "all_reduce" else args[1]
            if sync:
                torch.cuda.synchronize()
            t0 = time.time()
            out = fn(*args, **kw)
            if sync:
                torch.cuda.synchronize()
            record.append((name, (time.time() - t0) * 1e3 if sync else 0.0,
                           t.numel() * t.element_size()))
            return out
        return call

    for n, fn in real.items():
        setattr(dist, n, wrap(n, fn))
    try:
        yield
    finally:
        for n, fn in real.items():
            setattr(dist, n, fn)


def _param_bytes(params) -> int:
    return sum(p.numel() * p.element_size() for p in params)


def tp_k2_check(table, calls) -> dict:
    """Kernel K2's calls of a tensor-parallel step (the rank's heads) held
    against its plain version (bf16 as recorded, then fp32), then per shape
    (heads, queries, keys, head dim) its launches, ms, the plain version's,
    `scaled_dot_product_attention`'s, the bound and the device ms of K2 and
    of the library call."""
    import torch.nn.functional as F

    k = table["flash_attention"]
    errs = {}
    for dtype in ("bf16", "fp32"):
        cd = calls if dtype == "bf16" else [as_fp32(c) for c in calls]
        err, worst, at, _, outs = max_err(k["fn"], k["plain"], cd, TOL[dtype])
        if not worst <= 1.0:
            raise AssertionError(f"K2 at the rank's heads ({dtype}): call {at} is {worst}x its "
                                 "tolerance")
        errs[dtype] = err
        if dtype == "bf16":
            outs_bf16 = outs
        del outs
    groups = {}
    for c, o in zip(calls, outs_bf16):
        groups.setdefault((k["shape"](c), k["variant"](c)), []).append((c, o))
    reps = 5
    by_shape = []
    for (shape, var), members in groups.items():
        cs = [c for c, _ in members]
        g_bound, g_by = bound("flash_attention", cs, [o for _, o in members])
        by_shape.append({"shape": list(shape), "variant": var, "launches": len(cs),
                         "ms": time_calls(k["fn"], cs, reps),
                         "plain_ms": time_calls(k["plain"], cs, 2),
                         "library_ms": time_calls(F.scaled_dot_product_attention, cs, reps),
                         "bound_ms": g_bound, "bound_by": g_by})
    del outs_bf16
    sets = [[c for c, _ in members] for members in groups.values()]
    ms = device_ms([(k["fn"], g) for g in sets]
                   + [(F.scaled_dot_product_attention, g) for g in sets], reps)
    for i, row in enumerate(by_shape):
        row["device_ms"], row["library_device_ms"] = ms[i], ms[len(sets) + i]
    return {"calls": len(calls), "max_abs_err": errs["bf16"], "max_abs_err_fp32": errs["fp32"],
            "by_shape": by_shape}


def _tp_rank(rank: int, world: int) -> None:
    """A rank of the `tp` phase (a spawned process): gloo on the one card, a
    (1, world) mesh, the B15N4 training build from the parent's seed (the
    same weights on every rank, checked by their sum), sharded by
    `shard_params`. (b) bf16, the default mode: a first step records K2's
    calls, a second is timed with the model group's collectives counted, a
    third times each collective (the card synchronised around it); the
    kernels' launches in the timed step; parameter, master and peak bytes
    against the whole model's. (c) fp32: the validate step's histograms of
    the parent's validation batch. (a) fp32: one step under deterministic
    algorithms, the gradients of sharded masters made whole. (d) K2's
    recorded calls against its plain version at the rank's head count,
    timed per shape (`tp_k2_check`, last: the profiler slows later
    launches). Writes TP_DIR/rank<r>.pt, a traceback to rank<r>.err on
    failure."""
    import traceback

    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK="0")
    sys.path.insert(0, ROOT)
    import torch
    import torch.distributed as dist

    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        from xmask3d_tpu_torch.engine.builder import build_statics, build_train_model, label_tree
        from xmask3d_tpu_torch.parallel.mesh import create_mesh, init_distributed
        from xmask3d_tpu_torch.parallel.tensor import (
            gather_tensor, shard_params, sharded_tensors)

        dev = init_distributed(init_method=f"file://{os.path.join(TP_DIR, 'rendezvous')}",
                               backend="gloo")
        mesh = create_mesh(1, world)
        data = torch.load(os.path.join(TP_DIR, "inputs.pt"), map_location=dev,
                          weights_only=False)
        batch, draws = data["batch"], data["draws"]
        table = kernel_table()
        out = {"device": str(dev), "mesh": mesh.shape}

        # (b) bf16
        cfg = _ddp_cfg("bfloat16")
        t0 = time.time()
        model = build_train_model(cfg, seed=0, device=dev)
        mc = model.cfg
        labels = label_tree(model)
        whole = {"param_bytes": _param_bytes(model.parameters()),
                 "master_bytes": 4 * sum(p.numel() for n, p in model.named_parameters()
                                         if labels[n] != "frozen")}
        shard_params(model, mesh)
        statics = build_statics(model, cfg, device=dev)
        torch.cuda.synchronize()
        setup_s = time.time() - t0
        calls = {"flash_attention": []}
        torch.cuda.reset_peak_memory_stats()
        with recording(calls):
            ddp_step(model, statics, batch, draws, cfg)
        expected = expected_train_launches(mc)
        counted, variants = [], {}
        reset_launches()
        with counting_variants(table, variants), \
                model_collectives(mesh.model_group, counted, sync=False):
            step = ddp_step(model, statics, batch, draws, cfg)
        counts = launches()
        peak = torch.cuda.max_memory_allocated()
        timed = []
        with model_collectives(mesh.model_group, timed, sync=True):
            synced = ddp_step(model, statics, batch, draws, cfg)
        trainable = [p for n, p in model.named_parameters() if labels[n] != "frozen"]
        out["bf16"] = {
            "setup_s": setup_s, "step_ms": step["step_ms"], "synced_step_ms": synced["step_ms"],
            "metrics": step["metrics"], "launches": counts, "expected": expected,
            "variants": variants, "collectives": len(counted),
            "collective_bytes": sum(b for _, _, b in counted),
            "by_collective": {n: sum(1 for c in counted if c[0] == n)
                              for n in ("all_reduce", "all_gather")},
            "collective_ms": sum(ms for _, ms, _ in timed), "collectives_synced": len(timed),
            "param_bytes": _param_bytes(model.parameters()),
            "master_bytes": 4 * sum(p.numel() for p in trainable),
            "whole": whole, "peak_bytes": peak, "sharded_tensors": len(sharded_tensors(model))}
        del model, statics, step, synced
        gc.collect()
        torch.cuda.empty_cache()

        # (c) and (a) fp32
        cfg = _ddp_cfg("float32")
        model = build_train_model(cfg, seed=0, device=dev)
        weights_sum = _weights_sum(model)
        shard_params(model, mesh)
        statics = build_statics(model, cfg, device=dev)
        out["val"] = validation_hists(model, cfg, data["val_batch"], statics)
        step = _deterministic(ddp_step, model, statics, batch, draws, cfg)
        shards = sharded_tensors(model)
        step["grads"] = {k: (gather_tensor(v, *shards[k]) if k in shards else v).cpu()
                         for k, v in step["grads"].items()}
        step["buffers"] = {k: v.cpu() for k, v in step["buffers"].items()}
        step["weights_sum"] = weights_sum
        out["fp32"] = step
        del model, statics
        gc.collect()
        torch.cuda.empty_cache()

        # (d) K2 at the rank's heads
        out["k2"] = tp_k2_check(table, calls["flash_attention"])
        torch.save(out, os.path.join(TP_DIR, f"rank{rank}.pt"))
    except BaseException:
        with open(os.path.join(TP_DIR, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def tp_phase(ref, table, rows) -> dict:
    """Tensor parallelism on the card: two ranks spawned over gloo (NCCL
    refuses two ranks on one card), a (1, 2) mesh, the B15N4 training build
    at full width on the `ddp` phase's batch of two views (`_tp_rank`).
    (a) The fp32 step held to the one-process step by `ddp_compare` (the
    whole masters' gradients, the statistics and the losses; the two ranks
    bit-equal). (b) The bf16 step's ms a rank, the model group's
    collectives (count, bytes, ms), parameter, master and peak bytes a rank
    against the whole model's; the kernels' launches in the timed step as
    one process's (`expected_train_launches`), on their fast variants. (c)
    One validation batch's labels as one process's, but for ties
    (`tie_flips`, each logged), and the two ranks' histograms equal. (d)
    Every K2 call of the step
    at the rank's head count against its plain version; its per-shape times
    join K2's row of the `kernels` line (`tp_by_shape`). Gloo moves every
    collective through the host, so the step ms measure that, not NVLink.
    Returns the ranks' bf16 step ms and peak bytes (what `act_shard` sets
    its bands against)."""
    import shutil

    import torch

    shutil.rmtree(TP_DIR, ignore_errors=True)
    os.makedirs(TP_DIR)
    try:
        torch.save({"batch": ref["batch"], "draws": ref["draws"], "val_batch": ref["val_batch"]},
                   os.path.join(TP_DIR, "inputs.pt"))
        t0 = time.time()
        ranks = _spawn_ranks(2, 900.0, target=_tp_rank, directory=TP_DIR)
    finally:
        shutil.rmtree(TP_DIR, ignore_errors=True)
    seconds = time.time() - t0

    cmp = ddp_compare(ref["one"], ref["nudged"], [r["fp32"] for r in ranks])
    bad = cmp.pop("bad")
    b0 = ranks[0]["bf16"]
    for r in ranks:
        b = r["bf16"]
        for name, n in b["expected"].items():
            if b["launches"][name] != n:
                bad.append(f"{name}: {b['launches'][name]} launches in the timed step, "
                           f"expected {n}")
        try:
            check_variants(b["variants"], b["expected"], 1)
        except AssertionError as e:
            bad.append(str(e))
    flips, points = 0, int(ref["val_batch"]["point_valid"].sum())
    ties, moved = [], []
    for i, r in enumerate(ranks):
        for k, want in ref["val"]["hists"].items():
            flips = max(flips, sum(int((g - w).abs().sum())
                                   for g, w in zip(r["val"]["hists"][k], want)))
        tied, others, m = tie_flips(ref["val"], r["val"])
        ties += [dict(e, rank=i) for e in tied]
        moved.append(m)
        if others:
            bad.append(f"rank {i}: {len(others)} validation labels differ from one process's "
                       f"and are no tie: {others[:3]}")
    for e in ties:
        log(dict(e, phase="tp_validation_tie"))
    if not all(torch.equal(ranks[0]["val"]["hists"][k][i], ranks[1]["val"]["hists"][k][i])
               for k in ranks[0]["val"]["hists"] for i in range(3)):
        bad.append("the model group's validation histograms differ")
    k2 = [r["k2"] for r in ranks]
    heads = sorted({s["shape"][0] for s in k2[0]["by_shape"]})
    log({"phase": "tp", "backend": "gloo", "mesh": ranks[0]["mesh"], "batch": 2,
         "seconds": seconds, "device": [r["device"] for r in ranks],
         "bf16_setup_s": [r["bf16"]["setup_s"] for r in ranks],
         "bf16_step_ms": [r["bf16"]["step_ms"] for r in ranks],
         "bf16_synced_step_ms": [r["bf16"]["synced_step_ms"] for r in ranks],
         "bf16_one_process_step_ms": ref["bf16_step_ms"],
         "collectives_a_step": b0["collectives"], "by_collective": b0["by_collective"],
         "collective_bytes_a_step": b0["collective_bytes"],
         "collective_ms_a_step": [r["bf16"]["collective_ms"] for r in ranks],
         "param_bytes_a_rank": [r["bf16"]["param_bytes"] for r in ranks],
         "param_bytes_whole": b0["whole"]["param_bytes"],
         "master_bytes_a_rank": [r["bf16"]["master_bytes"] for r in ranks],
         "master_bytes_whole": b0["whole"]["master_bytes"],
         "bf16_peak_bytes_a_rank": [r["bf16"]["peak_bytes"] for r in ranks],
         "bf16_one_process_peak_bytes": ref["bf16_peak_bytes"],
         "sharded_tensors": b0["sharded_tensors"], "launches": b0["launches"],
         "fp32_step_ms": [r["fp32"]["step_ms"] for r in ranks], **cmp,
         "val_points": points, "val_counts_apart": flips, "val_tied_labels": len(ties),
         "val_scores_moved": moved,
         "k2_heads": heads, "k2_calls": k2[0]["calls"],
         "k2_max_abs_err": [k["max_abs_err"] for k in k2],
         "k2_max_abs_err_fp32": [k["max_abs_err_fp32"] for k in k2],
         "k2_by_shape": k2[0]["by_shape"], "bad": bad[:10]})
    if bad:
        raise AssertionError("tp: " + "; ".join(bad[:10]))
    for row in rows:
        if row["name"] == "flash_attention":
            row["tp_by_shape"] = k2[0]["by_shape"]
    return {"bf16_step_ms": [r["bf16"]["step_ms"] for r in ranks],
            "bf16_peak_bytes": [r["bf16"]["peak_bytes"] for r in ranks]}


# --------------------------------------------------------------------------
# act_shard: the SD towers' activations in row bands (the mesh's model axis)
# --------------------------------------------------------------------------

ACT_DIR = os.path.join(ROOT, "_act")
# K4's band pieces and their plain versions (the kernels line's K4 row)
K4_BAND = ("group_moments", "affine_silu_conv")


def _band_step(model, statics, batch, draws, cfg, mesh, deterministic=False):
    """`ddp_step` with the SD towers in row bands over `mesh`'s model
    group."""
    from xmask3d_tpu_torch.parallel.spatial import activation_sharding

    with activation_sharding(mesh):
        if deterministic:
            return _deterministic(ddp_step, model, statics, batch, draws, cfg)
        return ddp_step(model, statics, batch, draws, cfg)


def _timed_band_steps(model, statics, batch, draws, cfg, mesh, table, calls=None) -> dict:
    """A warm-up step in bands (recording K2's calls into `calls` if given),
    then one counted and timed: its ms, launches, variants, the model
    group's collectives and the peak bytes."""
    import torch

    with recording(calls) if calls is not None else contextlib.nullcontext():
        _band_step(model, statics, batch, draws, cfg, mesh)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counted, variants = [], {}
    reset_launches()
    with counting_variants(table, variants), \
            model_collectives(mesh.model_group, counted, sync=False):
        step = _band_step(model, statics, batch, draws, cfg, mesh)
    return {"step_ms": step["step_ms"], "metrics": step["metrics"], "launches": launches(),
            "variants": variants, "peak_bytes": torch.cuda.max_memory_allocated(),
            "collectives": len(counted), "collective_bytes": sum(b for _, _, b in counted),
            "by_collective": {n: sum(1 for c in counted if c[0] == n)
                              for n in ("all_reduce", "all_gather")}}


def _whole_grads(step, model, mesh):
    """The fp32 step's gradients on the host, sharded masters made whole."""
    from xmask3d_tpu_torch.parallel.tensor import gather_tensor, sharded_tensors

    shards = sharded_tensors(model)
    step["grads"] = {k: (gather_tensor(v, *shards[k], mesh) if k in shards else v).cpu()
                     for k, v in step["grads"].items()}
    step["buffers"] = {k: v.cpu() for k, v in step["buffers"].items()}
    return step


def act_k4_check(mesh, dev, table) -> dict:
    """(e) K4 on row bands: the full-width `AutoencoderKL.encode` at 512^2
    with `fused_gn` (seeded weights, every norm's scale and bias moved off
    its constant), in fp32 in bands against the same encode in one process
    (latent and taps within the fp32 tolerance); every band call of K4's
    pieces, fp32 and bf16, against its plain band version on the same
    inputs (the moments' mean within 1e-6 of max(1, |mean|), M2 within 1e-5
    relative; the conv within K4's per-call tolerance); the bf16 band
    encode's launches counted from 0; the bf16 conv calls timed per shape
    (with their moments) beside the plain band version, the bound and the
    one-process encode's whole-map K4 calls of the same widths."""
    import torch

    from xmask3d_tpu_torch.models.vae import AutoencoderKL, VAEConfig
    from xmask3d_tpu_torch.ops import gn_conv
    from xmask3d_tpu_torch.parallel.spatial import activation_sharding

    torch.manual_seed(0)
    with torch.device(dev):
        vae = AutoencoderKL(VAEConfig(), fused_gn=True)
        with torch.no_grad():
            for p in vae.parameters():
                if p.ndim == 1:
                    p.add_(0.1 * torch.randn_like(p))
        image = torch.rand(1, 512, 512, 3) * 2 - 1
    vae.eval().requires_grad_(False)
    report = {"weights_sum": _weights_sum(vae)}
    fns = {"group_moments": (gn_conv.group_moments, gn_conv.moments_reference),
           "affine_silu_conv": (gn_conv.affine_silu_conv, gn_conv.affine_silu_conv_reference)}
    by_dtype = {}
    for dtype, key in ((torch.float32, "fp32"), (torch.bfloat16, "bf16")):
        vae.to(dtype)
        x = image.to(dtype)
        calls = {n: [] for n in (*K4_BAND, "flash_attention")}
        whole = {"gn_silu_conv": []}
        with torch.no_grad():
            with recording(whole) if key == "bf16" else contextlib.nullcontext():
                one = vae.encode(x)
            reset_launches()
            for name in K4_BAND:
                fns[name][0].launches = 0
            with recording(calls), activation_sharding(mesh):
                got = vae.encode(x)
            torch.cuda.synchronize()
        counts = dict(launches(), **{n: fns[n][0].launches for n in K4_BAND})
        gaps = []
        for g, w in zip([got[0], *got[1]], [one[0], *one[1]]):
            gaps.append([float((g.float() - w.float()).abs().max()),
                         TOL[key] * max(1.0, float(w.float().abs().max()))])
        mom_err = [0.0, 0.0]
        for c in calls["group_moments"]:
            k, r = gn_conv.group_moments(*c), gn_conv.moments_reference(*c)
            mom_err[0] = max(mom_err[0], float(((k[..., 1] - r[..., 1]).abs()
                                                / r[..., 1].abs().clamp(min=1.0)).max()))
            mom_err[1] = max(mom_err[1], float(((k[..., 2] - r[..., 2]) / r[..., 2]).abs().max()))
        err, worst, at, _, outs = max_err(*fns["affine_silu_conv"], calls["affine_silu_conv"],
                                          TOL[key])
        entry = {"output_gap_and_tol": gaps, "launches": counts,
                 "band_calls": {n: len(calls[n]) for n in calls},
                 "moments_rel_err": mom_err, "conv_max_abs_err": err,
                 "conv_worst_over_tol": worst, "conv_worst_call": at,
                 "variants": sorted({gn_conv.variant(c[0], c[3])
                                     for c in calls["affine_silu_conv"]}),
                 "shapes": sorted({tuple(c[0].shape) for c in calls["affine_silu_conv"]})}
        if key == "bf16":
            groups = {}
            for c, o in zip(calls["affine_silu_conv"], outs):
                groups.setdefault((tuple(c[0].shape) + (c[3].shape[3],),
                                   gn_conv.variant(c[0], c[3])), []).append((c, o))
            # the one-process encode's whole-map calls of the same widths
            whole_of = {}
            for c in with_params("gn_silu_conv", whole["gn_silu_conv"]):
                whole_of.setdefault((c[0].shape[2], c[0].shape[3], c[3].shape[3]), []).append(c)
            rows = []
            for (shape, var), members in groups.items():
                cs = [c for c, _ in members]
                timed = [c + (gn_conv.kernel_params(c[3], c[4], c[0].dtype),) for c in cs]
                b_ms, b_by = bound("affine_silu_conv", cs, [o for _, o in members])
                ms = time_calls(lambda *a: gn_conv.affine_silu_conv(*a[:5], params=a[5]),
                                timed, 5)
                wc = whole_of[shape[2:]]
                rows.append({"shape": list(shape), "variant": var, "launches": len(cs),
                             "ms": ms,
                             "plain_ms": time_calls(gn_conv.affine_silu_conv_reference, cs, 2),
                             "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
                             "whole_map_ms_a_call": time_calls(gn_conv.gn_silu_conv, wc, 5)
                             / len(wc), "band_ms_a_call": ms / len(cs)})
            mcs = calls["group_moments"]
            mouts = [gn_conv.group_moments(*c) for c in mcs]
            m_bound, m_by = bound("group_moments", mcs, mouts)
            entry.update(by_shape=rows, moments={
                "calls": len(mcs), "ms": time_calls(gn_conv.group_moments, mcs, 5),
                "plain_ms": time_calls(gn_conv.moments_reference, mcs, 2),
                "bound_ms": m_bound, "bound_by": m_by})
        del outs, calls, got, one, whole
        by_dtype[key] = entry
        torch.cuda.empty_cache()
    report.update(by_dtype)
    del vae
    return report


def _act_rank(rank: int, world: int) -> None:
    """A rank of the `act_shard` phase (a spawned process): gloo on the one
    card, a (1, world) mesh, the B15N4 training build from the parent's
    seed (the same weights on every rank, checked by their sum), the SD
    towers in row bands (`activation_sharding`). (b) bf16: a first step
    in bands records K2's calls, a second is timed, counted from 0 (launches,
    variants, the model group's collectives) and its peak bytes read; then
    (c) the same after `shard_params` (sequence parallelism). (a) and (c)
    fp32: one step in bands with whole parameters and one after
    `shard_params`, each under deterministic algorithms, the gradients of
    sharded masters made whole. (e) K4 on bands (`act_k4_check`). (d) K2's
    recorded calls at their band shapes against the plain version, timed
    per shape (`tp_k2_check`, last: the profiler slows later launches).
    Writes ACT_DIR/rank<r>.pt, a traceback to rank<r>.err on failure."""
    import traceback

    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK="0")
    sys.path.insert(0, ROOT)
    import torch
    import torch.distributed as dist

    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        from xmask3d_tpu_torch.engine.builder import build_statics, build_train_model, label_tree
        from xmask3d_tpu_torch.parallel.mesh import create_mesh, init_distributed
        from xmask3d_tpu_torch.parallel.tensor import shard_params

        dev = init_distributed(init_method=f"file://{os.path.join(ACT_DIR, 'rendezvous')}",
                               backend="gloo")
        mesh = create_mesh(1, world)
        data = torch.load(os.path.join(ACT_DIR, "inputs.pt"), map_location=dev,
                          weights_only=False)
        batch, draws = data["batch"], data["draws"]
        table = kernel_table()
        out = {"device": str(dev), "mesh": mesh.shape}

        t0 = time.time()
        cfg = _ddp_cfg("bfloat16")
        model = build_train_model(cfg, seed=0, device=dev)
        out["expected"] = expected_train_launches(model.cfg)
        statics = build_statics(model, cfg, device=dev)
        calls = {"flash_attention": []}
        out["bands_bf16"] = _timed_band_steps(model, statics, batch, draws, cfg, mesh, table,
                                              calls)
        shard_params(model, mesh)
        out["sp_bf16"] = _timed_band_steps(model, statics, batch, draws, cfg, mesh, table)
        del model, statics
        gc.collect()
        torch.cuda.empty_cache()

        cfg = _ddp_cfg("float32")
        model = build_train_model(cfg, seed=0, device=dev)
        weights_sum = _weights_sum(model)
        statics = build_statics(model, cfg, device=dev)
        labels = label_tree(model)
        start = {n: v.detach().clone() for n, v in model.state_dict().items()
                 if labels.get(n, "buffer") != "frozen"}
        for key in ("bands_fp32", "sp_fp32"):
            if key == "sp_fp32":  # from the same weights and statistics: a step updates them
                model.load_state_dict(start, strict=False)
                shard_params(model, mesh)
            step = _band_step(model, statics, batch, draws, cfg, mesh, deterministic=True)
            out[key] = dict(_whole_grads(step, model, mesh), weights_sum=weights_sum)
        del model, statics, start
        gc.collect()
        torch.cuda.empty_cache()
        out["steps_s"] = time.time() - t0

        t0 = time.time()
        out["k4"] = act_k4_check(mesh, dev, table)
        out["k4_s"] = time.time() - t0
        out["k2"] = tp_k2_check(table, calls["flash_attention"])
        torch.save(out, os.path.join(ACT_DIR, f"rank{rank}.pt"))
    except BaseException:
        with open(os.path.join(ACT_DIR, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def act_shard_phase(ref, tp, table, rows) -> None:
    """Activation sharding on the card: two ranks spawned over gloo (NCCL
    refuses two ranks on one card), a (1, 2) mesh, the B15N4 training build
    at full width on the `ddp` phase's batch of two views (`_act_rank`),
    the SD UNet and VAE in row bands. (a) The fp32 step in bands held to
    the one-process step by `ddp_compare`, (c) and with `shard_params` as
    well; the two ranks bit-equal. (b) The bf16 step's ms and peak bytes a
    rank, in bands and with `shard_params` too, beside one process's and
    the `tp` phase's (model 2 without bands); the kernels' launches in each
    timed step as one process's (`expected_train_launches`), on their fast
    variants; the model group's collectives and their bytes. (d) Every K2
    call of the step at its band shape against its plain version, timed
    per shape; these join K2's row of the `kernels` line (`band_by_shape`).
    (e) K4 on row bands (`act_k4_check`): the encode equal to one
    process's in fp32, every band call within its tolerance; the bf16
    calls' times join K4's row (`band_by_shape`, `band_moments`)."""
    import shutil

    shutil.rmtree(ACT_DIR, ignore_errors=True)
    os.makedirs(ACT_DIR)
    t0 = time.time()
    try:
        import torch

        torch.save({"batch": ref["batch"], "draws": ref["draws"]},
                   os.path.join(ACT_DIR, "inputs.pt"))
        ranks = _spawn_ranks(2, 900.0, target=_act_rank, directory=ACT_DIR)
    finally:
        shutil.rmtree(ACT_DIR, ignore_errors=True)
    seconds = time.time() - t0

    bad = []
    cmp = {}
    for key in ("bands_fp32", "sp_fp32"):
        c = ddp_compare(ref["one"], ref["nudged"], [r[key] for r in ranks])
        bad += [f"{key}: {b}" for b in c.pop("bad")]
        cmp[key] = c
    for r in ranks:
        for key in ("bands_bf16", "sp_bf16"):
            b = r[key]
            for name, n in r["expected"].items():
                if b["launches"][name] != n:
                    bad.append(f"{key} {name}: {b['launches'][name]} launches in the timed "
                               f"step, expected {n}")
            try:
                check_variants(b["variants"], r["expected"], 1)
            except AssertionError as e:
                bad.append(f"{key}: {e}")
        k4 = r["k4"]
        for key in ("fp32", "bf16"):
            e = k4[key]
            if key == "fp32" and any(gap > tol for gap, tol in e["output_gap_and_tol"]):
                bad.append(f"K4 encode in bands against one process: {e['output_gap_and_tol']}")
            if not e["conv_worst_over_tol"] <= 1.0:
                bad.append(f"K4 band conv ({key}): call {e['conv_worst_call']} is "
                           f"{e['conv_worst_over_tol']}x its tolerance")
            if e["moments_rel_err"][0] > 1e-6 or e["moments_rel_err"][1] > 1e-5:
                bad.append(f"K4 band moments ({key}): {e['moments_rel_err']}")
            for name in (*K4_BAND, "flash_attention"):
                if not e["launches"][name] or e["launches"][name] != e["band_calls"][name]:
                    bad.append(f"K4 encode ({key}): {name} launched {e['launches'][name]} "
                               f"times for {e['band_calls'][name]} calls")
            if e["launches"]["gn_silu_conv"]:
                bad.append(f"K4 encode ({key}): whole-map K4 launched in bands")
            if key == "bf16" and not all(v.startswith("wgmma_") for v in e["variants"]):
                bad.append(f"K4 band conv (bf16) off the tensor cores: {e['variants']}")
    if ranks[0]["k4"]["weights_sum"] != ranks[1]["k4"]["weights_sum"]:
        bad.append("the ranks' VAE weights differ")
    k2 = [r["k2"] for r in ranks]
    b0, s0 = ranks[0]["bands_bf16"], ranks[0]["sp_bf16"]
    k4 = ranks[0]["k4"]
    log({"phase": "act_shard", "backend": "gloo", "mesh": ranks[0]["mesh"], "batch": 2,
         "seconds": seconds, "steps_s": [r["steps_s"] for r in ranks],
         "k4_s": [r["k4_s"] for r in ranks],
         "bands_bf16_step_ms": [r["bands_bf16"]["step_ms"] for r in ranks],
         "sp_bf16_step_ms": [r["sp_bf16"]["step_ms"] for r in ranks],
         "tp_bf16_step_ms": tp["bf16_step_ms"], "one_process_bf16_step_ms": ref["bf16_step_ms"],
         "bands_bf16_peak_bytes": [r["bands_bf16"]["peak_bytes"] for r in ranks],
         "sp_bf16_peak_bytes": [r["sp_bf16"]["peak_bytes"] for r in ranks],
         "tp_bf16_peak_bytes": tp["bf16_peak_bytes"],
         "one_process_bf16_peak_bytes": ref["bf16_peak_bytes"],
         "bands_collectives": [b0["collectives"], b0["by_collective"], b0["collective_bytes"]],
         "sp_collectives": [s0["collectives"], s0["by_collective"], s0["collective_bytes"]],
         "launches": b0["launches"],
         "fp32_step_ms": [r[k]["step_ms"] for r in ranks for k in ("bands_fp32", "sp_fp32")],
         **{f"{k}_compare": v for k, v in cmp.items()},
         "k2_calls": k2[0]["calls"], "k2_max_abs_err": [k["max_abs_err"] for k in k2],
         "k2_max_abs_err_fp32": [k["max_abs_err_fp32"] for k in k2],
         "k2_by_shape": k2[0]["by_shape"],
         "k4_fp32": {k: v for k, v in k4["fp32"].items()},
         "k4_bf16": {k: v for k, v in k4["bf16"].items() if k not in ("by_shape", "moments")},
         "k4_by_shape": k4["bf16"]["by_shape"], "k4_moments": k4["bf16"]["moments"],
         "bad": bad[:10]})
    if bad:
        raise AssertionError("act_shard: " + "; ".join(bad[:10]))
    for row in rows:
        if row["name"] == "flash_attention":
            row["band_by_shape"] = k2[0]["by_shape"]
        if row["name"] == "gn_silu_conv":
            row["band_by_shape"] = k4["bf16"]["by_shape"]
            row["band_moments"] = k4["bf16"]["moments"]
            row["band_launches"] = {n: k4["bf16"]["launches"][n] for n in K4_BAND}


# --------------------------------------------------------------------------
# view batching, the brick-dense 3D conv, the W8A8 op
# --------------------------------------------------------------------------

VIEW_BATCHES = (1, 2, 4)
VIEW_BATCH_SCENES = 2


def _view_of(batch, i):
    from xmask3d_tpu_torch.engine.graphs import tree_map

    return tree_map(lambda t: t[i:i + 1], batch)


def view_batch_phase(model, cfg, caps, statics, table, expected) -> None:
    """BENCH_VIEW_BATCH, B views a forward. (a) `tools/bench.py` in scan
    mode at each B of VIEW_BATCHES (VIEW_BATCH_SCENES scenes of 30 views),
    its scenes/s; the counts, set to 0 before each run, see its warm-up and
    capture. (b) one batch of B views (B = 2, 4) through the eager view body
    with every kernel call recorded: each K1-K3 call held against its plain
    version (bf16, the per-call tolerance), each kernel timed over the
    step's calls (events; K2 beside `scaled_dot_product_attention`) with
    its bound, and the step's peak bytes; at B = 2 the votes against its two
    views through the view body one at a time, on the same host-built
    hierarchies (no C 15 row order): the coverage equal; in bf16 the labels'
    agreement and the routed outputs' largest float gaps logged (the
    library GEMMs round otherwise at twice the rows); the same views
    through the model built in fp32 from the same seed, where the labels
    must agree on VIEW_BATCH_AGREEMENT of the voted points. (c) each B's
    view body captured (the scene scan's step) and one replayed step
    profiled: device busy ms a view, the idle share, and its launches from
    the kernel names, one view's worth."""
    import gc
    import math

    import torch
    import torch.nn.functional as F

    from xmask3d_tpu_torch.data.synthetic import synthetic_batch
    from xmask3d_tpu_torch.engine.builder import build_model, build_statics
    from xmask3d_tpu_torch.engine.serve import (
        fresh_vote_state, make_scene_scan_step, make_view_body, stack_views)
    from xmask3d_tpu_torch.tools import bench

    n_cls = model.cfg.num_test_classes
    report = {"phase": "view_batch", "bench": {}, "steps": {}, "profiles": {}}
    for b in VIEW_BATCHES:
        reset_launches()
        t0 = time.time()
        with environ(BENCH_SIZE="full", BENCH_VIEW_BATCH=str(b)):
            line, votes = bench.main(num_scenes=VIEW_BATCH_SCENES)
        counts = launches()
        if not (math.isfinite(line["value"]) and line["value"] > 0) or votes.sum() <= 0:
            raise AssertionError(f"bench at {b} views a forward: {line}, {int(votes.sum())} votes")
        for kernel in EXPECTED_NONZERO:
            if counts[kernel] == 0:
                raise AssertionError(f"bench at {b} views a forward: {kernel} never launched")
        report["bench"][b] = dict(line, seconds=time.time() - t0,
                                  launches_warmup_and_capture=counts)
        del votes
        gc.collect()
        torch.cuda.empty_cache()

    kw = dict(num_points=20000, image_size=(512, 512), mask_shape=tuple(cfg.mask_shape),
              context_length=77, vocab_size=49408)
    body = make_view_body(model, cfg)
    batches = {b: synthetic_batch(b, caps, seed=300, **kw) for b in VIEW_BATCHES}
    for b in VIEW_BATCHES[1:]:
        calls = {name: [] for name in EXPECTED_NONZERO}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        with recording(calls):
            votes = body(batches[b], statics, *fresh_vote_state(caps.max_points, n_cls))
        torch.cuda.synchronize()
        step = {"peak_bytes": torch.cuda.max_memory_allocated(), "launches": launches(),
                "kernels": {}}
        for name in EXPECTED_NONZERO:
            if step["launches"][name] != expected[name]:
                raise AssertionError(f"{name}: {step['launches'][name]} launches in a step of "
                                     f"{b} views, expected {expected[name]}")
            k, cs = table[name], calls[name]
            err, worst, at, _, outs = max_err(k["fn"], k["plain"], cs, TOL["bf16"])
            if not worst <= 1.0:
                raise AssertionError(f"{name} at {b} views: call {at} is {worst}x its tolerance")
            bound_ms, bound_by = bound(name, cs, outs)
            del outs
            step["kernels"][name] = {
                "launches": len(cs), "max_abs_err": err, "worst_err_over_tol": worst,
                "ms": time_calls(k["fn"], cs, 3), "bound_ms": bound_ms, "bound_by": bound_by,
                "library_ms": time_calls(F.scaled_dot_product_attention, cs, 3)
                if name == "flash_attention" else None}
        jobs = [(table[n]["fn"], calls[n]) for n in EXPECTED_NONZERO]
        jobs.append((F.scaled_dot_product_attention, calls["flash_attention"]))
        ms = device_ms(jobs, 3)
        for name, dms in zip(EXPECTED_NONZERO, ms):
            step["kernels"][name]["device_ms"] = dms
        step["kernels"]["flash_attention"]["library_device_ms"] = ms[-1]
        del calls, jobs
        if b == 2:
            step["against_one_view_a_forward"] = {
                "bf16": _batched_against_single(model, cfg, body, batches[b], statics, votes,
                                                caps)}
        report["steps"][b] = step
        del votes
        gc.collect()
        torch.cuda.empty_cache()

    cfg32 = copy.deepcopy(cfg)
    cfg32["compute_dtype"] = "float32"
    model32 = build_model(cfg32, seed=0)
    statics32 = build_statics(model32, cfg32)
    body32 = make_view_body(model32, cfg32)
    votes32 = body32(batches[2], statics32, *fresh_vote_state(caps.max_points, n_cls))
    got = _batched_against_single(model32, cfg32, body32, batches[2], statics32, votes32, caps)
    report["steps"][2]["against_one_view_a_forward"]["fp32"] = got
    del model32, statics32, body32, votes32
    gc.collect()
    torch.cuda.empty_cache()
    if got["label_agreement"] < VIEW_BATCH_AGREEMENT:
        log(report)
        raise AssertionError(f"fp32: 2 views a forward agree with 1 at a time on "
                             f"{got['label_agreement']} of the voted points, below "
                             f"{VIEW_BATCH_AGREEMENT}")

    scan = make_scene_scan_step(model, cfg)
    for b in VIEW_BATCHES:
        votes = fresh_vote_state(caps.max_points, n_cls)
        scan(stack_views([batches[b]]), [0], statics, *votes)  # captures at b views
        prof = replayed_profile(f"view_batch_profile_{b}", scan.step,
                                (batches[b], statics, *votes), with_statistics(expected))
        report["profiles"][b] = {k: prof[k] for k in ("wall_ms", "device_busy_ms",
                                                      "device_idle_share", "port_kernels_ms")}
        report["profiles"][b]["device_busy_ms_a_view"] = prof["device_busy_ms"] / b
        scan.step.reset()
        torch.cuda.empty_cache()
    log(report)


# 2 views a forward against 1 at a time on the same host-built views, in
# fp32: the share of voted points whose label must agree (the library GEMMs
# sum in another order at twice the rows; random weights leave near-ties)
VIEW_BATCH_AGREEMENT = 0.999


def _batched_against_single(model, cfg, body, batch, statics, votes, caps) -> dict:
    """`batch`'s views one at a time through `body` against `votes`, the
    body's votes for them in one forward: coverage must be equal; returns
    the labels' agreement over the covered points, whether the tables are
    equal, and the routed outputs' largest float gap over their scale."""
    import torch

    from xmask3d_tpu_torch.engine.infer import ensemble_and_route
    from xmask3d_tpu_torch.engine.serve import fresh_vote_state

    mc = model.cfg
    one = fresh_vote_state(caps.max_points, mc.num_test_classes)
    n = batch["point_valid"].shape[0]
    for i in range(n):
        one = body(_view_of(batch, i), statics, *one)
    if not torch.equal(votes[1], one[1]):
        raise AssertionError(f"{n} views a forward cover other points than 1 at a time")
    covered = one[1] > 0
    agree = float((votes[0].argmax(1) == one[0].argmax(1))[covered].float().mean())
    with torch.no_grad():
        def routed(b):
            return ensemble_and_route(model.eval_forward(b, statics), mc.base_category,
                                      mc.novel_category, mc.num_test_classes,
                                      cfg.base_ratio, cfg.novel_ratio)
        both = routed(batch)
        gaps = {}
        for i in range(n):
            single = routed(_view_of(batch, i))
            for k in FLOAT_KEYS:
                if both[k].ndim == 0 or both[k].shape[0] != n:
                    continue
                w = single[k][0].float()
                e = float((both[k][i].float() - w).abs().max()) / max(1.0, float(w.abs().max()))
                gaps[k] = max(gaps.get(k, 0.0), e)
    return {"label_agreement": agree, "votes_equal": bool(torch.equal(votes[0], one[0])),
            "covered_points": int(covered.sum()), "float_gap_over_scale": gaps}

# the brick phase: nb_cap = level capacity // BRICK_DIVISOR bricks a level;
# a main-path view (13,400-13,900 live voxels) fills 1,474-1,552 of level 0's
# 3,072 (occupancy ~14%), so none is dropped
BRICK_DIVISOR = 8


def brick_phase(model, caps, view) -> None:
    """XMASK3D_BRICK: one main-path view's two 3D UNets through the
    brick-dense path (`ops/brick_conv.py`: every k3 / k5 conv a cuDNN conv3d
    over halo'd 4^3 bricks, the k2 s2 convs still K1) and through K1 (its
    fused stem), on the view's host hierarchy built again with
    BRICK_DIVISOR's brick metadata (no voxel may be dropped). Held: the two
    UNets in fp32 (copies of the bf16 model's), both outputs of each through
    bricks against K1, within the fp32 per-call tolerance. Logged: `run_3d`'s
    bf16 outputs (`pred_3d`, the per-point features, `binary_scores` and the
    global `imp_condition`) of the brick path against K1's over the bf16
    per-call tolerance (the paths round ~50 layers' outputs to bf16 from
    other summation orders, so the gap compounds past one call's); each
    path's device ms over the whole 3D branch, and K1's calls in the K1
    path alone; the brick path's bound (`brick_bound_ms`: its conv3d calls'
    padded bricks and products, and its K1 calls)."""
    import torch

    from xmask3d_tpu_torch.ops.sparse_conv import (
        build_hierarchy, sparse_conv, stack_hierarchies)

    lv0 = view["hierarchy"].levels[0]
    coords = lv0.coords[0, :int(lv0.num[0])].cpu().numpy()
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # brick_metadata warns when it drops voxels
        h = build_hierarchy(coords, caps.level_caps(), brick_divisor=BRICK_DIVISOR)
    dropped = [int(n - (sor[:n] >= 0).sum()) for n, (_, sor, _) in zip(h.num, h.bricks)]
    bricks_used = [int(len(set((sor[sor >= 0] // 64).tolist()))) for _, sor, _ in h.bricks]
    batch = dict(view, hierarchy=stack_hierarchies([h], view["img"].device))
    calls = {"sparse_conv": []}
    with torch.no_grad():
        with environ(XMASK3D_BRICK="0"), recording(calls):
            want = model.run_3d(batch)
        with environ(XMASK3D_BRICK="1"):
            got = model.run_3d(batch)
        torch.cuda.synchronize()
        report = {"phase": "brick", "brick_divisor": BRICK_DIVISOR, "dropped_voxels": dropped,
                  "bricks_used": bricks_used,
                  "brick_capacity": [len(sv) // 64 for _, _, sv in h.bricks], "outputs": {}}
        for key in ("pred_3d", "binary_scores", "imp_condition"):
            ref, out = want[key].float(), got[key].float()
            err = float((out - ref).abs().max())
            tol = TOL["bf16"] * max(1.0, float(ref.abs().max()))
            report["outputs"][key] = {"max_abs_err": err, "err_over_bf16_tol": err / tol}
        del want, got
        feats = batch["voxel_feats"].float()
        report["fp32"] = {}
        for tower in ("pc_decoder", "pc_binary_head"):
            net = copy.deepcopy(getattr(model, tower).MinkUNet_0).float()
            with environ(XMASK3D_BRICK="0"):
                ref = net(feats, batch["hierarchy"])
            with environ(XMASK3D_BRICK="1"):
                out = net(feats, batch["hierarchy"])
            for name, r, o in zip(("bottleneck", "out"), ref, out):
                err = float((o - r).abs().max())
                tol = TOL["fp32"] * max(1.0, float(r.abs().max()))
                report["fp32"][f"{tower}.{name}"] = {"max_abs_err": err, "tol": tol,
                                                    "ok": err <= tol}
            del net, ref, out
        k1_calls = calls["sparse_conv"]

        def run(flag):
            def fn():
                with environ(XMASK3D_BRICK=flag):
                    model.run_3d(batch)
            return fn

        ms = device_ms([(run("0"), [()]), (run("1"), [()]), (sparse_conv, k1_calls)], 3)
        # the brick path's bound: per cuDNN conv3d call its halo'd bricks,
        # weights and output once against a multiply-add per tap, input and
        # output channel of every brick slot; with its K1 calls' own bounds
        conv_work, brick_k1 = [], {"sparse_conv": []}
        real_conv3d = torch.nn.functional.conv3d

        def counted_conv3d(x, w, *args, **kw):
            y = real_conv3d(x, w, *args, **kw)
            conv_work.append((nbytes(x, w, y), 2 * y.numel() * w[0].numel()))
            return y

        torch.nn.functional.conv3d = counted_conv3d
        try:
            with environ(XMASK3D_BRICK="1"), recording(brick_k1):
                model.run_3d(batch)
        finally:
            torch.nn.functional.conv3d = real_conv3d
        k1_in_brick = brick_k1["sparse_conv"]
        k1_bound, _ = bound("sparse_conv", k1_in_brick, [sparse_conv(*c) for c in k1_in_brick])
        conv_times = [(b / HBM_BYTES_PER_S, ops / PEAK_OPS["bf16"]) for b, ops in conv_work]
        report.update(brick_bound_ms=sum(max(t) for t in conv_times) * 1e3 + k1_bound,
                      brick_bound_by="bytes" if sum(t[0] for t in conv_times)
                      >= sum(t[1] for t in conv_times) else "operations",
                      brick_conv3d_calls=len(conv_work),
                      brick_conv3d_bytes=sum(b for b, _ in conv_work),
                      brick_conv3d_ops=sum(o for _, o in conv_work), brick_k1_bound_ms=k1_bound)
        del brick_k1, k1_in_brick
        reset_launches()
        with environ(XMASK3D_BRICK="1"):
            model.run_3d(batch)
        n_brick_k1 = launches()["sparse_conv"]
    report.update({"k1_path_device_ms": ms[0], "brick_path_device_ms": ms[1],
                   "k1_calls_device_ms": ms[2], "k1_calls": len(k1_calls),
                   "k1_launches_in_brick_path": n_brick_k1})
    log(report)
    bad = {k: v for k, v in report["fp32"].items() if not v["ok"]}
    if any(dropped) or bad:
        raise AssertionError(f"brick path: dropped {dropped}, outside the tolerance {bad}")


# the W8A8 phase's shapes: a pixel-decoder FFN (the 64^2 + 32^2 + 16^2
# tokens of a 512x512 view, 256 -> 1024) and a VAE encoder conv at 128^2
INT8_DOT = ((1, 5376, 256), (256, 1024))
INT8_CONV = ((1, 128, 128, 256), (256, 256, 3, 3))


def _ordered(a):
    """fp32 values as integers in the order of the floats (one apart for
    adjacent floats, -0.0 and 0.0 equal)."""
    import numpy as np

    i = a.view(np.int32).astype(np.int64)
    return np.where(i < 0, -(i & 0x7FFFFFFF), i)


def int8_phase() -> None:
    """`ops/int8_quant.py` on the card (torch._int_mm, the conv through
    im2col) against its CPU plain version (a float64 matmul, exact) on the same
    seeded inputs: int8 operands and int32 products equal, fp32 outputs
    within 1 ulp; device ms of `quant_dot` / `quant_conv` beside the bf16
    `torch.matmul` / `F.conv2d` of the same shape."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from xmask3d_tpu_torch.ops import int8_quant as q

    gen = torch.Generator().manual_seed(0)
    x, w = (torch.randn(s, generator=gen) for s in INT8_DOT)
    img, k = (torch.randn(s, generator=gen) for s in INT8_CONV)
    w, k = w * 0.05, k * 0.05
    report = {"phase": "int8"}
    cases = (("quant_dot", q.quant_dot_int, q.quant_dot, (x, w), ()),
             ("quant_conv", q.quant_conv_int, q.quant_conv, (img, k), ((1, 1), "SAME")))
    for name, ints, fn, args, extra in cases:
        cpu = ints(*args, *extra)
        dev = ints(*(a.cuda() for a in args), *extra)
        for part, a, b in zip(("x_int8", "w_int8", "int32_product", "x_scale", "w_scale"),
                              cpu, dev):
            if not torch.equal(a, b.cpu()):
                raise AssertionError(f"{name}: the card's {part} differs from the CPU's")
        got = fn(*(a.cuda() for a in args), *extra, torch.float32).cpu().numpy()
        want = fn(*args, *extra, torch.float32).numpy()
        ulp = int(np.max(np.abs(_ordered(got) - _ordered(want))))
        if ulp > 1:
            raise AssertionError(f"{name}: fp32 outputs {ulp} ulp apart")
        report[name] = {"shape": [list(a.shape) for a in args], "int32_equal": True,
                        "max_ulp": ulp}
    xd, wd = x.cuda(), w.cuda()
    imgd, kd = img.cuda(), k.cuda()
    xb, wb = xd.bfloat16(), wd.bfloat16()
    imgb, kb = imgd.permute(0, 3, 1, 2).contiguous().bfloat16(), kd.bfloat16()
    jobs = [(q.quant_dot, [(xd, wd, torch.bfloat16)]), (torch.matmul, [(xb, wb)]),
            (q.quant_conv, [(imgd, kd, (1, 1), "SAME", torch.bfloat16)]),
            (F.conv2d, [(imgb, kb, None, 1, 1)])]
    ms = device_ms(jobs, 5)
    events = [time_calls(fn, calls, 5) for fn, calls in jobs]
    for (name, key), d, e in zip((("quant_dot", "ms"), ("quant_dot", "bf16_matmul_ms"),
                                  ("quant_conv", "ms"), ("quant_conv", "bf16_conv2d_ms")),
                                 ms, events):
        report[name][key.replace("ms", "device_ms")] = d
        report[name][key] = e
    log(report)


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
    view_batch_phase(model, cfg, caps, statics, table, expected)
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
    brick_phase(model, caps, views[1])
    int8_phase()
    del model, outputs, views, statics, view_body, votes, counter
    gc.collect()
    torch.cuda.empty_cache()

    k4_row, model, statics, scenes, per_scene = scene_phase(cfg, caps, table)
    rows.append(k4_row)
    native_kmaps(cfg, caps, scenes)
    scene_reuse_phase(model, cfg, caps, statics, scenes, table, per_scene)
    converted_phase(model, cfg, caps, scenes,
                    synthetic_batch(1, caps, seed=101, num_points=20000, image_size=(512, 512),
                                    mask_shape=tuple(cfg.mask_shape), context_length=77,
                                    vocab_size=49408))
    txt2img_phase(model, cfg, statics, table)
    del model, statics, scenes
    gc.collect()
    torch.cuda.empty_cache()

    train_phase(cfg, caps, table)
    ref = ddp_phase(caps)
    act_shard_phase(ref, tp_phase(ref, table, rows), table, rows)
    del ref

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
