"""The port's bench (`xmask3d_tpu_torch/tools/bench.py`) at BENCH_SIZE=tiny on
the CPU, one scene of three views.

- Each mode prints, as its last line, one JSON object with the JAX bench's
  four keys and its mode's metric name; the line before it names the
  device.
- The scan and the per-view dispatch of the captured view body leave the
  same vote table.
- Include-host mode runs with views built by worker threads, here with the
  hierarchy built on the device (`BENCH_DEVICE_HIER`); scene reuse runs.
- BENCH_VIEW_BATCH=2 runs two views a forward (scan mode, and scene reuse
  at BENCH_SCENE_FACTOR=2); `scene_caps_from_view_caps` takes the JAX
  package's factor.
- Without a GPU and without `device="cpu"` it raises.
"""

import json

import numpy as np
import pytest
import torch

from xmask3d_tpu_torch.tools import bench

KEYS = {"metric", "value", "unit", "vs_baseline"}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run(monkeypatch, capsys, views_per_scene=3, **env):
    for k in ("BENCH_SCAN_VIEWS", "BENCH_INCLUDE_HOST", "BENCH_DEVICE_HIER", "BENCH_SCENE_REUSE",
              "BENCH_PIPELINE_SCENES", "BENCH_DISTINCT_VIEWS", "BENCH_HOST_WORKERS",
              "BENCH_VIEW_BATCH", "BENCH_SCENE_FACTOR", "BENCH_BF16_PARAMS"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("BENCH_SIZE", "tiny")
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    line, votes = bench.main(device="cpu", num_scenes=1, views_per_scene=views_per_scene)
    out = capsys.readouterr().out.strip().splitlines()
    assert json.loads(out[-1]) == line and set(line) == KEYS
    assert out[-2].startswith("# device: cpu")
    assert all(ln.startswith("#") for ln in out[:-1])
    assert line["unit"] == "scenes/sec/chip" and np.isfinite(line["value"]) and line["value"] > 0
    assert line["vs_baseline"] == round(line["value"] / 0.15, 3)
    return line, votes


def test_scan_and_per_view_modes_vote_alike(monkeypatch, capsys):
    scan, votes_scan = _run(monkeypatch, capsys)
    per_view, votes_each = _run(monkeypatch, capsys, BENCH_SCAN_VIEWS="0",
                                BENCH_PIPELINE_SCENES="0")
    assert scan["metric"] == per_view["metric"] == "scene_inference_throughput"
    assert votes_scan.shape == (512, 19) and votes_scan.sum() > 0
    np.testing.assert_array_equal(votes_scan, votes_each)


def test_include_host_mode_on_device_hierarchies(monkeypatch, capsys):
    line, votes = _run(monkeypatch, capsys, BENCH_INCLUDE_HOST="1", BENCH_HOST_WORKERS="2",
                       BENCH_DEVICE_HIER="1")
    assert line["metric"] == "scene_inference_throughput_e2e" and votes.sum() > 0


def test_scene_reuse_mode(monkeypatch, capsys):
    line, votes = _run(monkeypatch, capsys, BENCH_SCENE_REUSE="1")
    assert line["metric"] == "scene_inference_throughput_reuse" and votes.sum() > 0


def test_view_batch_scan_mode(monkeypatch, capsys):
    """Two views a forward, four views a scene: two steps of the view body
    captured at two views, every view's 400 points voted once."""
    line, votes = _run(monkeypatch, capsys, BENCH_VIEW_BATCH="2", views_per_scene=4)
    assert line["metric"] == "scene_inference_throughput"
    assert votes.shape == (512, 19) and votes.sum() == 4 * 400


def test_scene_factor_and_view_batch_under_scene_reuse(monkeypatch, capsys):
    from xmask3d_tpu.data.batching import Capacities as JaxCapacities
    from xmask3d_tpu.engine.scene_reuse import scene_caps_from_view_caps as jax_scene_caps
    from xmask3d_tpu_torch.data.batching import Capacities
    from xmask3d_tpu_torch.engine.scene_reuse import scene_caps_from_view_caps

    for factor in (2, 4, 8):
        want = jax_scene_caps(JaxCapacities(512, 256, 8), factor=factor)
        got = scene_caps_from_view_caps(Capacities(512, 256, 8), factor=factor)
        assert (got.max_points, got.max_voxels, got.max_targets, got.level_caps()) == (
            want.max_points, want.max_voxels, want.max_targets, want.level_caps())
    line, votes = _run(monkeypatch, capsys, BENCH_SCENE_REUSE="1", BENCH_SCENE_FACTOR="2",
                       BENCH_VIEW_BATCH="2", views_per_scene=4)
    assert line["metric"] == "scene_inference_throughput_reuse" and votes.sum() > 0


def test_the_bench_needs_a_gpu_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        bench.main()
    monkeypatch.setenv("BENCH_SIZE", "huge")
    with pytest.raises(ValueError, match="BENCH_SIZE"):
        bench.main(device="cpu")
