"""The benchmark's layout: what it may import, that cells and metrics are
found by name, and one tiny cell end to end on the CPU."""

from __future__ import annotations

import ast
import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark.harness import core
from benchmark.tests import tiny

BENCH = core.BENCH
PORT = "xmask3d_tpu_torch"


def imported_modules(path: Path):
    """Every module a file imports, by its full dotted name."""
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module
            for a in node.names:
                yield f"{node.module}.{a.name}"


def sources(folder: Path):
    return sorted(p for p in folder.rglob("*.py") if "__pycache__" not in p.parts)


def test_no_jax_anywhere():
    """Top-level names compared whole: `xmask3d_tpu_torch` is not
    `xmask3d_tpu`."""
    for path in sources(BENCH):
        for mod in imported_modules(path):
            assert mod.split(".")[0] not in core.FORBIDDEN, (path, mod)


def test_reference_imports_nothing_of_the_port():
    for path in sources(BENCH / "reference"):
        for mod in imported_modules(path):
            assert mod.split(".")[0] != PORT, (path, mod)
            assert mod.split(".")[0] in ("benchmark", "torch", "numpy", "scipy", "math",
                                         "typing", "dataclasses", "collections", "contextlib",
                                         "contextvars", "__future__"), (path, mod)


def test_not_the_port_tools():
    for path in sources(BENCH):
        for mod in imported_modules(path):
            assert not mod.startswith(f"{PORT}.tools"), (path, mod)
            assert mod.split(".")[0] != "chip_smoke", (path, mod)


def test_no_fixed_scratch_paths():
    """Caches go inside the checkout; nothing is written to /dev/shm or a
    fixed /tmp path."""
    for path in sources(BENCH):
        if path.name.startswith("test_"):
            continue
        text = path.read_text()
        assert "/dev/shm" not in text and "/tmp/" not in text, path


def test_cache_dirs_inside_the_checkout(monkeypatch):
    for k in ("TORCH_EXTENSIONS_DIR", "TRITON_CACHE_DIR", "USE_FLAX", "OMP_NUM_THREADS",
              "MKL_NUM_THREADS"):
        monkeypatch.delenv(k, raising=False)
    core.set_environment()
    import os

    for k in ("TORCH_EXTENSIONS_DIR", "TRITON_CACHE_DIR"):
        assert Path(os.environ[k]).resolve().is_relative_to(core.ROOT)
    assert os.environ["USE_FLAX"] == "0"


def test_cells_match_benchmark_json():
    spec = json.loads((core.ROOT / "BENCHMARK.json").read_text())
    for cell in spec["workloads"]:
        w = core.cell(cell["name"])
        assert (w["config"], w["traffic"], w["chips"]) == (cell["config"], cell["traffic"],
                                                         cell["chips"])
    kinds = {"end_to_end": {m["name"] for m in spec["end_to_end"]},
             "per_layer": {m["name"] for m in spec["per_layer"]}}
    found = {m.NAME: m for m in core.metric_readers()}
    for kind, names in kinds.items():
        for n in names:
            assert found[n].KIND == kind
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert found[m["name"]].UNIT == m["unit"]


def test_new_cell_and_metric_found_by_name(tmp_path):
    """A workload file and a metric reader added to a copy of the folder
    are picked up with no edit to any file there."""
    copy = tmp_path / "benchmark"
    shutil.copytree(BENCH, copy, ignore=shutil.ignore_patterns("__pycache__"))
    (copy / "traffic" / "scan_5k.json").write_text(json.dumps(
        dict(json.loads((BENCH / "traffic" / "scan_20k.json").read_text()),
             points_per_view=5000)))
    (copy / "workloads" / "b15n4.serve_scan_5k.json").write_text(json.dumps(
        {"config": "b15n4", "traffic": "scan_5k", "chips": 1,
         "limits": {"disagree_excess": 0.015, "unvoted_rows": 0}}))
    (copy / "metrics" / "views_done.serve.py").write_text(
        'NAME, UNIT, KIND, KINDS = "views_done.serve", "views", "per_layer", ("scene_scan",)\n\n\n'
        'def read(record):\n    return record["views_done"]\n')
    w = core.cell("b15n4.serve_scan_5k", bench=copy)
    assert w["traffic_file"]["points_per_view"] == 5000
    got = core.read_metrics({"views_done": 60, "kind": "scene_scan"}, "scene_scan", True,
                            bench=copy)
    assert got["views_done.serve"] == {"value": 60.0, "unit": "views"}
    code, ctx = tiny.context("b15n4.serve_scan_5k", bench=copy)
    assert ctx["traffic"]["kind"] == "scene_scan" and hasattr(code, "run")


def test_tiny_cell_end_to_end(capsys):
    """The serving cell's whole run at tiny size on the CPU, up to the
    result line (the metrics a card gives are decided in the test below)."""
    record, checks, ctx = tiny.run("b15n4.serve_scan", seconds=0.5)
    metrics = core.read_metrics(record, "scene_scan", False)
    assert set(metrics) == {"scenes_per_s", "view_ms_p99", "setup_s"}
    assert all(c["ok"] for c in checks.values()), checks
    core.emit(True, record["attempted"], record["failed"], metrics,
              {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}, checks)
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    assert list(line)[-1] == "checks" and line["correct"] is True
    assert err.strip().splitlines()[-1].startswith("check compared_labels")


def test_run_refuses_without_a_card():
    """`run.py` on a machine without a card exits non-zero and prints no
    result."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = subprocess.run([sys.executable, str(BENCH / "run.py"), "--workload", "b15n4.serve_scan",
                        "--seed", "1", "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, cwd=core.ROOT, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""


@pytest.mark.gpu
def test_cell_on_the_card():
    """One short run of each cell on the card, each correct (run there with
    `python -m pytest benchmark/tests -m gpu`)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    spec = json.loads((core.ROOT / "BENCHMARK.json").read_text())
    for cell in spec["workloads"]:
        p = subprocess.run([sys.executable, str(BENCH / "run.py"), "--workload", cell["name"],
                            "--seed", "2147483659", "--seconds", "2", "--trace", "0"],
                           capture_output=True, text=True, cwd=core.ROOT, timeout=1200)
        assert p.returncode == 0, p.stderr[-4000:]
        assert json.loads(p.stdout.strip().splitlines()[-1])["correct"] is True
