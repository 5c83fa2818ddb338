"""Whole-scene serving, closed loop, one client: scenes of `views_per_scene`
views, one view a forward, through the port's scene scan
(`engine/serve.py` `make_scene_scan_step`: the view body captured once as
a CUDA graph and replayed a view at a time, the votes on the card).

Set-up draws `distinct_views` views from the seed, voxelizes and collates
them with the port's host pipeline, stages them on the card and cycles them
through every scene's slots (slot v serves view v mod distinct_views). Each
slot votes into rows of its own in the scene's vote table (the scene holds
views_per_scene x max_points points), so each served label can be read back.
One scene runs in set-up: it captures the view body. The window then runs
whole scenes until `--seconds` have passed; each scene's voted labels reach
the host before the next scene starts. A CUDA event recorded on the stream
after each replay gives every view's time from the previous view's end (or
the scene's start) to its own.
"""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np

from benchmark.harness.core import log
from benchmark.harness.port import (
    caps_of, draw_tokens, draw_views, port_config, port_samples, statics_of)
from benchmark.traffic.views import VOXEL_SIZE


def stage_views(raws: List[Dict], caps: Dict, traffic: Dict, device):
    """The port's host pipeline on each distinct view (its voxelizer and
    collation with its native kernel maps), stacked on the card into
    the scene's slots, with each slot's vote rows."""
    import torch
    from xmask3d_tpu_torch.data.batching import collate_views
    from xmask3d_tpu_torch.engine.graphs import tree_map
    from xmask3d_tpu_torch.engine.serve import stack_views

    samples, pc = port_samples(raws, caps)
    batches = [collate_views([s], pc, device=device) for s in samples]
    n_slots, p = traffic["views_per_scene"], caps["max_points"]
    order = torch.arange(n_slots, device=device) % len(raws)
    stacked = tree_map(lambda t: t[order], stack_views(batches))
    rows = torch.arange(n_slots * p, dtype=torch.int32, device=device).reshape(n_slots, 1, p)
    valid = stacked["point_valid"]
    stacked["vote_point_ids"] = torch.where(valid, rows, torch.full_like(rows, -1))
    return stacked, valid.reshape(-1).to(torch.int32)


def run(ctx: Dict) -> Dict:
    """The cell's run; returns the record the metric readers and the check
    read. `ctx`: seed, seconds, trace, device, tiny, conf, traffic, t_setup
    (a callable giving seconds since the process started)."""
    import torch
    from torch.profiler import record_function
    from xmask3d_tpu_torch.engine.builder import build_model
    from xmask3d_tpu_torch.engine.serve import fresh_vote_state, make_scene_scan_step

    from benchmark.harness import trace as tr
    from benchmark.harness.refmodel import leaf_specs
    from benchmark.harness.weights import make_weights

    conf, traffic, dev, seed, tiny = (ctx[k] for k in ("conf", "traffic", "device", "seed", "tiny"))
    cuda = dev.type == "cuda"
    caps = caps_of(conf, traffic)
    cfg = port_config(conf, tiny)
    leaves = leaf_specs(conf, tiny, dev)
    log(f"imports, configuration and weight rules at {ctx['t_setup']():.2f} s")
    model = build_model(cfg, tiny=tiny, device=dev)
    log(f"port model built at {ctx['t_setup']():.2f} s")
    model.load_state_dict(make_weights(leaves, seed, dev), strict=True)
    if cuda:
        # the program's peak: the benchmark's tree and weight draw are gone
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    log(f"weights drawn and loaded at {ctx['t_setup']():.2f} s")
    tokens = draw_tokens(seed, conf, tiny)
    statics = statics_of(model, tokens, dev)
    raws = draw_views(seed, conf, traffic, tiny, traffic["distinct_views"])
    stacked, expected = stage_views(raws, caps, traffic, dev)
    log(f"views staged at {ctx['t_setup']():.2f} s")
    n_slots, p, ncls = traffic["views_per_scene"], caps["max_points"], conf["test_classes"]
    idxseq = torch.arange(n_slots, dtype=torch.int32)
    scan = make_scene_scan_step(model, cfg, device=dev)

    # one CUDA event after each replay: the benchmark's span around its
    # call into the captured body
    events = [torch.cuda.Event(enable_timing=True) for _ in range(n_slots + 1)] if cuda else []
    host_marks: List[float] = []
    replay = scan.step.run

    def timed_run():
        with record_function("replay"):
            out = replay()
        if cuda:
            events[len(host_marks) + 1].record()
        host_marks.append(time.perf_counter())
        return out

    scan.step.run = timed_run
    label_dtype = torch.uint8 if ncls <= 255 else torch.int16

    def scene():
        """One scene: fresh votes, the scan, the labels and the vote-count
        check read back. Returns (labels (V*P,) numpy, bad rows, view
        seconds)."""
        host_marks.clear()
        with record_function("scene_start"):
            votes = fresh_vote_state(n_slots * p, ncls, device=dev)
            if cuda:
                events[0].record()
            t0 = time.perf_counter()
        votes, counter = scan(stacked, idxseq, statics, *votes)
        with record_function("readback"):
            lab = votes.argmax(dim=1).to(label_dtype)
            bad = (counter != expected).sum()
            lab, bad = lab.cpu().numpy(), int(bad)
        if cuda:
            views = [events[i].elapsed_time(events[i + 1]) / 1e3 for i in range(n_slots)]
        else:
            marks = [t0] + host_marks
            views = [marks[i + 1] - marks[i] for i in range(n_slots)]
        return lab, bad, views

    scene()  # captures the view body
    if cuda:
        torch.cuda.synchronize()
    setup_s = ctx["t_setup"]()
    labels, view_s, unvoted, bad_scenes = [], [], 0, 0
    t0 = time.perf_counter()
    deadline = t0 + ctx["seconds"]
    while True:
        lab, bad, views = scene()
        labels.append(lab)
        view_s += views
        unvoted += bad
        bad_scenes += bad > 0
        if time.perf_counter() >= deadline:
            break
    window_s = time.perf_counter() - t0
    log(f"set-up {setup_s:.2f} s; window {window_s:.2f} s, {len(labels)} scenes")
    ms = np.asarray(view_s).reshape(len(labels), n_slots) * 1e3
    log("view ms quantiles (50, 90, 95, 99): "
        f"{np.percentile(ms, [50, 90, 95, 99]).round(3).tolist()}; median a slot: "
        f"{np.median(ms, axis=0).round(2).tolist()}")
    record = {"kind": "scene_scan", "setup_s": setup_s, "window_s": window_s,
              "views_per_scene": n_slots, "views_done": len(view_s), "view_s": view_s,
              "scenes": len(labels), "attempted": len(view_s),
              "failed": bad_scenes * n_slots}
    if ctx["trace"] and cuda:
        def seg():
            lab, bad, _ = scene()
            labels.append(lab)
            nonlocal unvoted
            unvoted += bad

        record["trace"] = tr.traced([seg] * traffic["trace_scenes"], dev)
        record["trace_views"] = n_slots * traffic["trace_scenes"]
    record["peak_bytes"] = torch.cuda.max_memory_allocated(dev) if cuda else 0
    record["unvoted_rows"] = unvoted
    # the program's state is freed before the reference runs
    scan.step.reset()
    del scan, model, stacked, statics
    if cuda:
        torch.cuda.empty_cache()
    record["served"] = labels
    record["raws"], record["tokens"], record["caps"] = raws, tokens, caps
    record["slot_view"] = [v % len(raws) for v in range(n_slots)]
    return record


def labels_of(model, ctx: Dict, record: Dict, count_work: bool = False):
    """A reference model's scores of every distinct view; with
    `count_work`, also what its calls need (kernels' bounds, operations),
    a view at a time."""
    from benchmark.harness import serve_check, work

    statics = statics_of(model, record["tokens"], ctx["device"])

    def score(v):
        return serve_check.reference_scores(model, ctx["conf"], [v], record["caps"], statics,
                                            ctx["device"], VOXEL_SIZE)[0]

    scores, counted = [], []
    for v in record["raws"]:
        if count_work:
            s, w, flops = work.count(lambda: score(v))
            counted.append({"bound_s": dict(w.bound_s), "calls": dict(w.calls), "flops": flops})
        else:
            s = score(v)
        scores.append(s)
    return scores, counted


def check(record: Dict, ctx: Dict) -> Dict:
    """The fp32 reference over every distinct view (its work counted in a
    traced run) against every label the window and the traced stretch
    served, beside the bf16 witness's labels of the same views (see
    `harness/serve_check.py`). Returns {name: {"value", "limit", "ok"}}."""
    import torch

    from benchmark.harness import serve_check
    from benchmark.harness.refmodel import build_reference

    conf, dev, seed, tiny = ctx["conf"], ctx["device"], ctx["seed"], ctx["tiny"]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_ref = time.perf_counter()
    ref = build_reference(conf, seed, dev, dtype=torch.float32, tiny=tiny)
    scores, counted = labels_of(ref, ctx, record, count_work=ctx["trace"])
    del ref
    wit = build_reference(conf, seed, dev, dtype=torch.bfloat16, tiny=tiny)
    witness, _ = labels_of(wit, ctx, record)
    del wit
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    p = record["caps"]["max_points"]
    served: Dict[int, List[np.ndarray]] = {}
    for lab in record["served"]:
        for slot, i in enumerate(record["slot_view"]):
            served.setdefault(i, []).append(lab[slot * p:(slot + 1) * p])
    prog = serve_check.compare(scores, served)
    wit_got = serve_check.compare(scores, {i: [w["pred"].numpy()] for i, w in enumerate(witness)})
    got = serve_check.excess(prog, wit_got)
    record["ref_scores"], record["compare"] = scores, {"program": prog, "witness": wit_got}
    log(f"reference and witness over {len(scores)} views in {time.perf_counter() - t_ref:.2f} s: "
        f"program {prog}, witness {wit_got}")
    if counted:
        slots = record["slot_view"]
        record["view_work"] = {
            "flops": sum(counted[i]["flops"] for i in slots) / len(slots),
            "bound_s": {k: sum(counted[i]["bound_s"][k] for i in slots) / len(slots)
                        for k in counted[0]["bound_s"]},
            "calls": {k: sum(counted[i]["calls"][k] for i in slots) / len(slots)
                      for k in counted[0]["calls"]}}
    limits = ctx["limits"]
    record["excess"] = got
    compared = {k: got[k] for k in serve_check.COMPARED}
    compared["unvoted_rows"] = record["unvoted_rows"]
    checks = {k: {"value": v, "limit": limits[k], "ok": v <= limits[k]}
              for k, v in compared.items()}
    checks["compared_labels"] = {"value": prog["compared"], "limit": 1,
                                 "ok": prog["compared"] >= 1}
    return checks
