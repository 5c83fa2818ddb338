"""Training, one step after another: `batch` views a step, through the
port's training step (`engine/train_step.py` `make_train_step` on
`engine/builder.py` `build_train_model` and `make_optimizer`: bf16 compute,
fp32 masters, two-group AdamW, remat as the configuration states).

Set-up draws `distinct_batches` batches from the seed, collates them with
the port's host pipeline and stages them on the card. It builds the one
training state and drives it through `follow_steps` steps, one on each
batch in turn, through the window's own call: the steps the reference
follows. Their losses, the first gradient of every trainable leaf (from
AdamW's first moment after one step) and each leaf's change after the last
of them are kept. The window then steps on, cycling the batches, until
`--seconds` have passed; the peak is taken over the window.
"""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np

from benchmark.harness.core import log
from benchmark.harness.port import (
    caps_of, draw_tokens, draw_views, port_config, port_samples, statics_of)
from benchmark.traffic.views import VOXEL_SIZE

BACKWARD_NODES = ("_SparseConvBackward",)


def leaf_norms(tensors: Dict[str, "torch.Tensor"]) -> Dict[str, float]:
    import torch

    names = list(tensors)
    norms = torch.stack([torch.linalg.vector_norm(tensors[n].float()) for n in names])
    return dict(zip(names, norms.cpu().tolist()))


def bn_change(model) -> Dict[str, float]:
    """Each BatchNorm statistic's change from its start (mean 0, variance
    1), as a norm: what the steps' batches did to the running statistics."""
    return leaf_norms({n: b.detach().float() - (1.0 if n.endswith(".var") else 0.0)
                       for n, b in model.named_buffers() if n.endswith((".mean", ".var"))})


def stage_batches(raws: List[Dict], caps: Dict, batch: int, device):
    """The port's voxelizer and collation (native kernel maps) on each
    batch of `batch` views."""
    from xmask3d_tpu_torch.data.batching import collate_views

    samples, pc = port_samples(raws, caps)
    return [collate_views(samples[i:i + batch], pc, device=device)
            for i in range(0, len(samples), batch)]


def run(ctx: Dict) -> Dict:
    import torch
    from torch.profiler import record_function
    from xmask3d_tpu_torch.engine.builder import build_train_model
    from xmask3d_tpu_torch.engine.train_step import (
        create_train_state, make_optimizer, make_train_step)

    from benchmark.harness import trace as tr
    from benchmark.harness.refmodel import leaf_specs
    from benchmark.harness.weights import make_weights

    conf, traffic, dev, seed, tiny = (ctx[k] for k in ("conf", "traffic", "device", "seed", "tiny"))
    cuda = dev.type == "cuda"
    caps = caps_of(conf, traffic)
    cfg = port_config(conf, tiny)
    leaves = leaf_specs(conf, tiny, dev)
    model = build_train_model(cfg, tiny=tiny, device=dev)
    model.load_state_dict(make_weights(leaves, seed, dev), strict=True)
    if cuda:
        torch.cuda.empty_cache()
    opt = make_optimizer(model, conf["lr_3d"], conf["lr_others"], traffic["total_steps"],
                         schedule=conf["learning_rate_type"])
    state = create_train_state(model, opt, seed=seed)
    step_fn = make_train_step(conf["loss_weight"])
    log(f"model, weights and optimizer at {ctx['t_setup']():.2f} s")
    tokens = draw_tokens(seed, conf, tiny)
    statics = statics_of(model, tokens, dev)
    bsz, n_batches = traffic["batch"], traffic["distinct_batches"]
    raws = draw_views(seed, conf, traffic, tiny, bsz * n_batches)
    batches = stage_batches(raws, caps, bsz, dev)
    log(f"batches staged at {ctx['t_setup']():.2f} s")
    contra_on = float(traffic["contra_on"])

    masters = {}
    for name, p in model.named_parameters():
        for pairs in opt.pairs.values():
            for q, m in pairs:
                if q is p:
                    masters[name] = m
    init = {n: m.detach().clone() for n, m in masters.items()}

    def step(i: int) -> float:
        with record_function("train_step"):
            out = step_fn(state, batches[i % n_batches], statics, contra_on)
            return float(out["loss_total"])

    losses, grad1 = [], {}
    for i in range(traffic["follow_steps"]):
        losses.append(step(i))
        if i == 0:
            # a master the optimizer holds no moment of got no gradient
            grad1 = leaf_norms({n: opt.adamw.state.get(m, {}).get("exp_avg", torch.zeros_like(m))
                                / 0.1 for n, m in masters.items()})
            bn1 = bn_change(model)
    change = leaf_norms({n: masters[n].detach() - init[n] for n in masters})
    del init
    done = traffic["follow_steps"]
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
    setup_s = ctx["t_setup"]()
    t0 = time.perf_counter()
    deadline = t0 + ctx["seconds"]
    steps = 0
    while True:
        step(done + steps)
        steps += 1
        if time.perf_counter() >= deadline:
            break
    if cuda:
        torch.cuda.synchronize()
    window_s = time.perf_counter() - t0
    log(f"set-up {setup_s:.2f} s; window {window_s:.2f} s, {steps} steps")
    record = {"kind": "train_step", "setup_s": setup_s, "window_s": window_s, "steps": steps,
              "batch": bsz, "attempted": steps * bsz, "failed": 0,
              "peak_bytes": torch.cuda.max_memory_allocated(dev) if cuda else 0}
    if ctx["trace"] and cuda:
        n0 = done + steps
        record["trace"] = tr.traced([lambda i=i: step(n0 + i) for i in range(traffic["trace_steps"])],
                                    dev, node_names=BACKWARD_NODES)
        record["trace_steps"] = traffic["trace_steps"]
    del state, opt, model, batches, statics, masters
    if cuda:
        torch.cuda.empty_cache()
    record.update({"losses": losses, "grad1": grad1, "change": change, "bn1": bn1, "raws": raws,
                   "tokens": tokens, "caps": caps})
    return record


def leaf_gaps(got: Dict[str, float], want: Dict[str, float], keep) -> np.ndarray:
    """Each kept leaf's gap between the program's norm and the reference's,
    over the larger of the reference's norm and the median leaf's."""
    names = [n for n in want if keep(n)]
    if not names:
        return np.array([np.inf])
    median = float(np.median([want[n] for n in names]))
    return np.array([abs(got[n] - want[n]) / max(want[n], median, 1e-30) for n in names])


def reference_follow(ctx: Dict, record: Dict, dtype=None, transform=None,
                     batch_fault=None) -> Dict:
    """The reference follows the set-up's steps on the same batches and
    draws: each step's loss, each leaf's first gradient and its change
    after the steps. `dtype` (fp32 by default) and `transform` (applied to
    the model) make the control; `batch_fault` (applied to each batch) a
    fault planted in the reference put in the program's place. In a traced
    run the first step's calls are counted."""
    import torch

    from benchmark.harness import work
    from benchmark.harness.refmodel import build_reference
    from benchmark.reference.data.collate import collate_views
    from benchmark.reference.train import Trainer

    conf, traffic, dev, seed, tiny = (ctx[k] for k in ("conf", "traffic", "device", "seed", "tiny"))
    caps, raws, bsz = record["caps"], record["raws"], traffic["batch"]
    t_ref = time.perf_counter()
    ref = build_reference(conf, seed, dev, dtype=dtype or torch.float32, tiny=tiny)
    if transform is not None:
        transform(ref)
    tr = Trainer(ref, conf["lr_3d"], conf["lr_others"], traffic["total_steps"],
                 conf["learning_rate_type"], seed, conf["loss_weight"])
    statics = statics_of(ref, record["tokens"], dev)
    n_batches = traffic["distinct_batches"]

    def batch(i):
        views = raws[(i % n_batches) * bsz:(i % n_batches + 1) * bsz]
        b = collate_views(views, caps["max_points"], caps["max_voxels"], caps["max_targets"],
                          VOXEL_SIZE, dev)
        return b if batch_fault is None else batch_fault(b)

    init = {n: p.detach().float().clone() for n, p in tr.trainables()}
    out = {"losses": []}
    contra_on = float(traffic["contra_on"])
    for i in range(traffic["follow_steps"]):
        if i == 0 and ctx["trace"]:
            (total, _), w, _ = work.count(lambda: tr.forward_backward(batch(i), statics, contra_on))
            record["step_work"] = {"bound_s": dict(w.bound_s), "calls": dict(w.calls)}
        else:
            total, _ = tr.forward_backward(batch(i), statics, contra_on)
        out["losses"].append(float(total))
        if i == 0:
            out["bn1"] = bn_change(ref)
            out["grad1"] = leaf_norms({n: (p.grad if p.grad is not None else torch.zeros_like(p))
                                       for n, p in tr.trainables()})
        tr.update()
    out["change"] = leaf_norms({n: p.detach().float() - init[n] for n, p in tr.trainables()})
    del init, tr, ref
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    if ctx["trace"] and dtype is None and transform is None and batch_fault is None:
        out["statics"] = statics
    log(f"reference steps in {time.perf_counter() - t_ref:.2f} s: losses {out['losses']}")
    return out


def readings(got: Dict, want: Dict) -> Dict[str, float]:
    """The numbers a check may compare (`leaf_gaps`), of which the cell's
    `limits` name those it does (PERF.md gives why): the worst and the
    median leaf's first-gradient gap; the worst and the median leaf's change
    gap after the steps, leaves whose reference gradient is under a
    thousandth of the median leaf's left out; the worst and the median BatchNorm statistic's
    gap after the first step. The steps' losses are logged, not compared:
    bf16 storage drops sub-ulp updates, so every bf16 run, sound or not,
    reads ~2% at the second step."""
    grad1 = want["grad1"]
    median_g = float(np.median(list(grad1.values())))
    g = leaf_gaps(got["grad1"], grad1, lambda n: True)
    c = leaf_gaps(got["change"], want["change"], lambda n: grad1[n] >= 1e-3 * median_g)
    b = leaf_gaps(got["bn1"], want["bn1"], lambda n: True)
    return {"grad1_leaf": float(g.max()), "grad1_median": float(np.median(g)),
            "change_leaf": float(c.max()), "change_median": float(np.median(c)),
            "bn1_leaf": float(b.max()), "bn1_median": float(np.median(b))}


def worst_leaves(got: Dict, want: Dict, k: int = 3) -> Dict[str, list]:
    """The k leaves with the widest first-gradient and change gaps, with
    the reference's norms: where a worst-leaf number comes from."""
    grad1 = want["grad1"]
    median_g = float(np.median(list(grad1.values())))
    out = {}
    for key, keep in (("grad1", lambda n: True), ("change", lambda n: grad1[n] >= 1e-3 * median_g)):
        names = [n for n in want[key] if keep(n)]
        gaps = leaf_gaps(got[key], want[key], keep)
        order = np.argsort(-gaps)[:k]
        out[key] = [[names[i], float(gaps[i]), want[key][names[i]], got[key][names[i]]]
                    for i in order]
    return out


def candidate_readings(got: Dict, want: Dict) -> Dict[str, float]:
    """Each step's loss gap, for calibration."""
    return {"loss_rel_steps": [abs(a - b) / abs(b) for a, b in zip(got["losses"], want["losses"])]}


def check(record: Dict, ctx: Dict) -> Dict:
    """The fp32 reference (TF32 off) following the set-up's steps, against
    the program's readings of them. Returns {name: {"value", "limit",
    "ok"}}."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    want = reference_follow(ctx, record)
    record["reference"] = want
    got = readings(record, want)
    record["losses_rel"] = [abs(a - b) / abs(b) for a, b in zip(record["losses"], want["losses"])]
    record["worst_leaves"] = worst_leaves(record, want)
    log(f"program against the reference: {got}; losses {record['losses']} against "
        f"{want['losses']}; worst leaves {record['worst_leaves']}")
    if ctx["trace"]:
        record["step_flops"] = step_flops(ctx, record["raws"][:1], record["caps"],
                                          want.pop("statics"), ctx["traffic"]) \
            * ctx["traffic"]["batch"]
    record["readings"] = got
    limits = ctx["limits"]
    return {k: {"value": got[k], "limit": v, "ok": got[k] <= v} for k, v in limits.items()}


def step_flops(ctx: Dict, views, caps, statics, traffic) -> float:
    """Operations of one view's training step in the reference (forward and
    backward, no recompute: remat off, every tap's rows kept), dense ops
    from the flop counter and the sparse convs over their live pairs (their
    backward twice the forward)."""
    import torch

    from benchmark.harness import work
    from benchmark.harness.refmodel import build_reference
    from benchmark.reference.data.collate import collate_views
    from benchmark.reference.ops.sparse_conv import saving_taps
    from benchmark.reference.train import Trainer

    conf = dict(ctx["conf"], remat_backbone=False)
    dev = ctx["device"]
    ref = build_reference(conf, ctx["seed"], dev, dtype=torch.float32, tiny=ctx["tiny"])
    tr = Trainer(ref, conf["lr_3d"], conf["lr_others"], traffic["total_steps"],
                 conf["learning_rate_type"], ctx["seed"], conf["loss_weight"])
    b = collate_views(views, caps["max_points"], caps["max_voxels"], caps["max_targets"],
                      VOXEL_SIZE, dev)
    with saving_taps():
        _, w, flops = work.count(lambda: tr.forward_backward(b, statics,
                                                             float(traffic["contra_on"])))
    # the counter saw each sparse op's backward over all rows too
    return flops + 2 * w.flops_fix
