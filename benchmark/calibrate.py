"""Readings that the limits of a cell's correctness check are set from.

    python3 benchmark/calibrate.py --workload <name> --seeds 11 12 13 [--witness 1]

For each seed, in one process: one run of the cell (a window of one scene
or step), its check's numbers against the reference, and the control's:
the reference itself put in the program's place and computed one step of
precision below the configuration's bf16, every weight of two or more axes
rounded to fp8 (e4m3, one scale an output channel), bf16 activations. A
training cell also reads the fault of half the batch, planted in the
reference put in the program's place, and with --witness 1 the reference
stepping in bf16 alone. Prints one JSON line a seed. A control or fault
that reads three times the program's worst or more (a training fault: ten
times) sets the upper end of a limit; the program's worst over a dozen
seeds or more the lower.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark.harness import core  # noqa: E402

FP8_MAX = 448.0  # float8_e4m3fn


def quantize_fp8_(model) -> int:
    """Round every weight of two or more axes (the shared noise aside) to
    fp8 e4m3 with one scale an output channel, in place; returns the count."""
    import torch

    n = 0
    with torch.no_grad():
        for name, p in model.named_parameters():
            if p.ndim < 2 or name.endswith("shared_noise"):
                continue
            out_dim = 2 if name.endswith("kernel") and p.ndim == 3 else 0
            red = tuple(d for d in range(p.ndim) if d != out_dim)
            scale = p.float().abs().amax(dim=red, keepdim=True).clamp(min=1e-12) / FP8_MAX
            q = (p.float() / scale).to(torch.float8_e4m3fn).float() * scale
            p.copy_(q.to(p.dtype))
            n += 1
    return n


def control_serve(ctx, record):
    """The control's labels of every distinct view against the fp32
    reference's scores the run's check kept, and its excess over the
    check's bf16 witness."""
    import torch

    from benchmark.harness import serve_check
    from benchmark.harness.port import statics_of
    from benchmark.harness.refmodel import build_reference
    from benchmark.traffic.views import VOXEL_SIZE

    ctl = build_reference(ctx["conf"], ctx["seed"], ctx["device"], dtype=torch.bfloat16,
                          tiny=ctx["tiny"])
    quantize_fp8_(ctl)
    statics = statics_of(ctl, record["tokens"], ctx["device"])
    got = serve_check.reference_scores(ctl, ctx["conf"], record["raws"], record["caps"], statics,
                                       ctx["device"], VOXEL_SIZE)
    del ctl
    served = {i: [g["pred"].numpy()] for i, g in enumerate(got)}
    ctl_got = serve_check.compare(record["ref_scores"], served)
    return dict(ctl_got, **serve_check.excess(ctl_got, record["compare"]["witness"]))


def first_half(tree):
    """Every batch-leading tensor of a batch tree (dicts, tuples, the
    hierarchy's dataclasses) cut to its first half."""
    import dataclasses

    import torch

    if torch.is_tensor(tree):
        return tree[: max(1, tree.shape[0] // 2)] if tree.ndim else tree
    if isinstance(tree, dict):
        return {k: first_half(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(first_half(v) for v in tree)
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{f.name: first_half(getattr(tree, f.name))
                                           for f in dataclasses.fields(tree)})
    return tree


def half_batch(batch):
    """The fault "half of the batch left out, the mean taken over the
    rest": the step sees the batch's first half alone."""
    return first_half(batch)


def control_train(ctx, record, witness: bool = False):
    """Readings of the control (the reference stepping in bf16 with fp8
    weights) and of the fault of half the batch (planted in the fp32
    reference put in the program's place), against the check's reference;
    with `witness`, also of the reference stepping in bf16 alone."""
    import torch

    from benchmark.traffic import train_step as ts

    want = record["reference"]
    runs = {"control": dict(dtype=torch.bfloat16, transform=quantize_fp8_),
            "half_batch": dict(batch_fault=half_batch)}
    if witness:
        runs["witness"] = dict(dtype=torch.bfloat16)
    out = {}
    for name, kw in runs.items():
        got = ts.reference_follow(ctx, record, **kw)
        out[name] = dict(ts.readings(got, want), **ts.candidate_readings(got, want))
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--witness", type=int, default=0,
                    help="training: also the reference stepping in bf16 alone")
    args = ap.parse_args(argv)
    core.set_environment()
    w = core.cell(args.workload)
    dev = core.require_cards(w["chips"])
    kind = w["traffic_file"]["kind"]
    code = core.traffic_code(kind)
    for seed in args.seeds:
        t0 = time.perf_counter()
        ctx = {"seed": seed, "seconds": 0.0, "trace": False, "device": dev, "tiny": False,
               "conf": w["config_file"], "traffic": w["traffic_file"], "limits": w["limits"],
               "t_setup": lambda: time.perf_counter() - t0}
        record = code.run(ctx)
        checks = code.check(record, ctx)
        line = {"seed": seed, "program": {k: c["value"] for k, c in checks.items()}}
        if "compare" in record:
            line["program_detail"] = record["compare"]
        if "reference" in record:
            from benchmark.traffic import train_step as ts

            line["program_detail"] = ts.candidate_readings(record, record["reference"])
        if kind == "scene_scan":
            line["control"] = control_serve(ctx, record)
        else:
            line.update(control_train(ctx, record, witness=bool(args.witness)))
        line["seconds"] = time.perf_counter() - t0
        print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()
