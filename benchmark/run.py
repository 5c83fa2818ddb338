"""Runs one cell of the benchmark once and prints its result line.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell is benchmark/workloads/<name>.json; its configuration, traffic
mix and code are found by the names in it (configs/, traffic/). The
program under test is the port, `xmask3d_tpu_torch`, on the card. With
--trace 0 the result carries the cell's end-to-end metrics, with --trace 1
its per-layer metrics, read from a profiled stretch after the window. The
last line of standard output is the JSON result; the numbers the
correctness check compared, each with its limit, are the last lines of
standard error and the result's last key.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark.harness import core  # noqa: E402


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if args.seed < 0:
        core.fail("--seed must be a non-negative whole number")
    core.set_environment()
    w = core.cell(args.workload)
    dev = core.require_cards(w["chips"])
    code = core.traffic_code(w["traffic_file"]["kind"])
    ctx = {"seed": args.seed, "seconds": args.seconds, "trace": bool(args.trace), "device": dev,
           "tiny": False, "conf": w["config_file"], "traffic": w["traffic_file"],
           "limits": w["limits"], "t_setup": core.process_start_s}
    record = code.run(ctx)
    checks = code.check(record, ctx)
    metrics = core.read_metrics(record, w["traffic_file"]["kind"], bool(args.trace))
    tr = record.get("trace")
    device = core.device_block(w["chips"], record["peak_bytes"],
                               *((tr["busy_s"], tr["wall_s"]) if tr else ()))
    from benchmark.harness.trace import breakdown

    core.emit(all(c["ok"] for c in checks.values()), record["attempted"], record["failed"],
              metrics, device, checks, breakdown(tr) if tr else None)


if __name__ == "__main__":
    main()
