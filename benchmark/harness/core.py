"""What every cell shares: finding a cell's files by name, the card checks,
the set-up clock, the guard against JAX, the result line."""

from __future__ import annotations

import importlib.util
import json
import os
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

BENCH = Path(__file__).resolve().parent.parent  # the benchmark's folder
ROOT = BENCH.parent  # the checkout
FORBIDDEN = ("jax", "jaxlib", "flax", "xmask3d_tpu")


def process_start_s() -> float:
    """Seconds since this process started, from /proc (the interpreter's
    own start-up included); the time since this module's import where
    /proc is not there."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _IMPORTED


_IMPORTED = time.perf_counter()


def log(msg: str) -> None:
    """A progress line of the run: standard output, before the result."""
    print(f"# {msg}", flush=True)


def load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def cell(name: str, bench: Path = BENCH) -> Dict:
    """The cell's workload file with its configuration and traffic mix
    read in: workloads/<name>.json, configs/<config>.json,
    traffic/<traffic>.json."""
    path = bench / "workloads" / f"{name}.json"
    if not path.is_file():
        known = sorted(p.stem for p in (bench / "workloads").glob("*.json"))
        raise SystemExit(f"unknown workload {name!r}; known: {known}")
    w = load_json(path)
    w["name"] = name
    w["config_file"] = load_json(bench / "configs" / f"{w['config']}.json")
    w["traffic_file"] = load_json(bench / "traffic" / f"{w['traffic']}.json")
    return w


def load_module(path: Path, name: str):
    """A benchmark file imported by its path (names may hold dots)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def traffic_code(kind: str, bench: Path = BENCH):
    return load_module(bench / "traffic" / f"{kind}.py", f"benchmark_traffic_{kind}")


def metric_readers(bench: Path = BENCH) -> List:
    """Every metrics/<name>.py, sorted by name; each has NAME, UNIT, KIND
    ("end_to_end" or "per_layer"), KINDS (the traffic kinds it reads) and
    read(record) -> a number, or None where the run gave nothing to read."""
    mods = []
    for p in sorted((bench / "metrics").glob("*.py")):
        if p.name.startswith("_"):
            continue
        m = load_module(p, "benchmark_metric_" + p.stem.replace(".", "_"))
        if m.NAME != p.stem:
            raise ValueError(f"{p}: NAME {m.NAME!r} is not the file's name")
        mods.append(m)
    return mods


def read_metrics(record: Dict, kind: str, trace: bool, bench: Path = BENCH) -> Dict:
    want = "per_layer" if trace else "end_to_end"
    out = {}
    for m in metric_readers(bench):
        if m.KIND != want or kind not in m.KINDS:
            continue
        v = m.read(record)
        if v is not None:
            out[m.NAME] = {"value": float(v), "unit": m.UNIT}
    return out


THREADS = "4"  # host threads of the run's math libraries (of 8 cores a card)


def set_environment() -> None:
    """Build and kernel caches at fixed paths inside the checkout, so only
    a checkout's first run builds; libraries that would load JAX are told
    not to; a few host threads, so that the one process's host work is not
    slowed by its own thread pools. Before torch is imported."""
    for k in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ[k] = THREADS
    cache = ROOT / ".bench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def forbidden_loaded() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def fail(msg: str, code: int = 2) -> None:
    print(msg, file=sys.stderr, flush=True)
    raise SystemExit(code)


def require_cards(n: int):
    """The card checks; exits without a result when fewer than n cards."""
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device: this benchmark measures the port on the card")
    if torch.cuda.device_count() < n:
        fail(f"the cell needs {n} cards, {torch.cuda.device_count()} are visible")
    return torch.device("cuda", 0)


def device_block(count: int, peak_bytes: int, busy_s: Optional[float] = None,
                 window_s: Optional[float] = None) -> Dict:
    import torch

    out = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": count,
           "memory_peak_bytes": int(peak_bytes)}
    if busy_s is not None:
        out["busy_s"], out["window_s"] = busy_s, window_s
    return out


def emit(correct: bool, attempted: int, failed: int, metrics: Dict, device: Dict,
         checks: Dict, breakdown: Optional[Dict] = None) -> None:
    """The run's last lines: each number compared beside its limit on
    standard error, then the result line on standard output, its `checks`
    last. Exits without a result if JAX or the JAX package was loaded."""
    bad = forbidden_loaded()
    if bad:
        fail(f"modules of {bad} were loaded in this process")
    line = {"correct": bool(correct), "attempted": int(attempted), "failed": int(failed),
            "metrics": metrics, "device": device}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["checks"] = checks
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r}, "
              f"{'ok' if c['ok'] else 'FAILED'})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
