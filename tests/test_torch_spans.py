"""The port's spans (`utils/spans.py`): free where nothing listens, on the
profiler's timeline in a training step, and timed by `collect()`.

- With no profiler, `span()` is one shared no-op that enters no
  `record_function`.
- Under `torch.profiler.profile` (CPU activity), one step of the reduced
  tiny model (the one `tests/test_torch_remat.py` runs, remat on, at 64x64)
  shows each span of the training step once, nested as the step opens
  them, all on the calling thread: remat's recompute in the backward opens
  none.
- `collect()` gathers each span's own host seconds by name.
"""

import threading
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from xmask3d_tpu_torch.config import load_config
from xmask3d_tpu_torch.data.batching import Capacities
from xmask3d_tpu_torch.data.synthetic import synthetic_batch
from xmask3d_tpu_torch.engine.builder import build_statics, build_train_model
from xmask3d_tpu_torch.engine.train_step import (
    create_train_state, make_optimizer, make_train_step)
from xmask3d_tpu_torch.utils import spans

CONFIG = "configs/scannet/xmask3d_scannet_B15N4.yaml"
REDUCED = {"arch_3d": "MinkUNet14A", "arch_binary_head": "MinkUNet14A", "mask_shape": [24, 32],
           "compute_dtype": "float32", "dec_layers": 2, "pixel_enc_layers": 2}
# each span of the training step and the span it opens in
PARENT = {"xm3d.train.step": None, "xm3d.train.draws": "xm3d.train.step",
          "xm3d.train.forward": "xm3d.train.step", "xm3d.forward.trunk": "xm3d.train.forward",
          "xm3d.matcher": "xm3d.train.forward", "xm3d.train.backward": "xm3d.train.step",
          "xm3d.train.optimizer": "xm3d.train.step", "xm3d.train.metrics": "xm3d.train.step"}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def refuse(*args, **kwargs):
    raise AssertionError("record_function entered with no profiler running")


def test_span_is_the_shared_no_op_without_a_profiler(monkeypatch):
    monkeypatch.setattr(spans, "record_function", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    a, b = spans.span("xm3d.a"), spans.span("xm3d.b")
    assert a is b
    with a, spans.span("xm3d.c"):
        pass


def test_a_training_step_shows_each_span_once_nested_on_the_calling_thread():
    cfg = load_config(CONFIG)
    cfg.update(REDUCED)
    assert cfg.remat_backbone
    model = build_train_model(cfg, tiny=True, seed=1, device="cpu")
    statics = build_statics(model, cfg, device="cpu")
    batch = synthetic_batch(2, Capacities(max_points=512, max_voxels=256, max_targets=8), seed=3,
                            num_points=400, image_size=(64, 64), mask_shape=(24, 32),
                            context_length=16, vocab_size=512, device="cpu")
    state = create_train_state(model, make_optimizer(model, cfg.lr_3d, cfg.lr_others, 10))
    step = make_train_step(dict(cfg.loss_weight))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        metrics = step(state, batch, statics, 1.0)
    assert torch.isfinite(metrics["loss_total"])
    # the session's raw records: `prof.events()` builds ~240k Python events here
    got = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns(), e.start_thread_id())
           for e in prof.profiler.kineto_results.events() if e.name().startswith(spans.PREFIX)]
    assert sorted(name for name, *_ in got) == sorted(PARENT)
    assert len({thread for *_, thread in got}) == 1
    by_name = {name: (start, end) for name, start, end, _ in got}
    for name, parent in PARENT.items():
        start, end = by_name[name]
        # the innermost span around this one is the table's parent
        around = [n for n, (a, b) in by_name.items() if n != name and a <= start and end <= b]
        innermost = min(around, key=lambda n: by_name[n][1] - by_name[n][0], default=None)
        assert innermost == parent, (name, around)


def test_collect_gathers_each_spans_own_host_seconds():
    with spans.collect() as seconds:
        with spans.span("xm3d.outer"):
            time.sleep(0.01)
            with spans.span("xm3d.inner"):
                time.sleep(0.3)
        with spans.span("xm3d.inner"):
            time.sleep(0.01)
    assert set(seconds) == {"xm3d.outer", "xm3d.inner"}
    assert seconds["xm3d.inner"] >= 0.31
    assert 0.01 <= seconds["xm3d.outer"] < 0.3  # the inner span's 0.3 s left out
    assert spans.span("xm3d.after") is spans.span("xm3d.other")  # no-op again


def test_collect_is_per_thread():
    """A span of another thread is not gathered by this thread's collect."""
    with spans.collect() as seconds:
        t = threading.Thread(target=lambda: spans.span("xm3d.elsewhere").__enter__())
        t.start()
        t.join(timeout=10)
        assert not t.is_alive()
        with spans.span("xm3d.here"):
            pass
    assert set(seconds) == {"xm3d.here"}
