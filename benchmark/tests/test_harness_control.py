"""The check's control and its faults, at tiny size on the CPU.

The control is the reference computed a step of precision below the
configuration's bf16 (fp8 weights, `benchmark/calibrate.py`); on the card
at the cells' sizes its readings set the upper end of each limit (PERF.md).
Here it must read well above the program at the same tiny size. Each fault
breaks the timed path underneath a whole tiny run (the harness's look for a
card skipped) and must make `correct` false."""

from __future__ import annotations

import pytest
import torch

from benchmark import calibrate
from benchmark.tests import tiny


def correct(checks) -> bool:
    return all(c["ok"] for c in checks.values())


def test_control_reads_above_the_program():
    code, ctx = tiny.context("b15n4.serve_scan", dtype="bfloat16")
    record = code.run(ctx)
    checks = code.check(record, ctx)
    control = calibrate.control_serve(ctx, record)
    program = checks["disagree_excess"]["value"]
    assert control["disagree_excess"] > max(program, 0.0) + 0.02


def test_fp8_rounding_moves_every_weight():
    from benchmark.harness.refmodel import build_reference
    from benchmark.tests.tiny import TINY_MODEL
    from benchmark.harness import core

    conf = dict(core.cell("b15n4.serve_scan")["config_file"], **TINY_MODEL)
    m = build_reference(conf, 5, torch.device("cpu"), dtype=torch.bfloat16, tiny=True)
    before = {n: p.clone() for n, p in m.named_parameters()}
    n = calibrate.quantize_fp8_(m)
    moved = [k for k, p in m.named_parameters() if not torch.equal(p, before[k])]
    assert n > 100 and len(moved) >= n - 5


def test_fault_answer_altered(monkeypatch):
    """Every served label shifted by one where the view body makes it."""
    import xmask3d_tpu_torch.engine.serve as serve

    real = serve.ensemble_and_route

    def altered(outputs, *a, **kw):
        r = real(outputs, *a, **kw)
        return dict(r, pred=(r["pred"] + 1) % outputs["text_embed_test"].shape[0])

    monkeypatch.setattr(serve, "ensemble_and_route", altered)
    _, checks, _ = tiny.run("b15n4.serve_scan")
    assert not correct(checks) and not checks["disagree_excess"]["ok"]


def test_fault_half_the_rows_left_out(monkeypatch):
    """Half of each view's rows never voted."""
    import xmask3d_tpu_torch.engine.serve as serve

    real = serve.device_vote_add

    def half(votes, counter, ids, pred, valid):
        keep = valid.clone()
        keep[keep.shape[0] // 2:] = False
        return real(votes, counter, ids, pred, keep)

    monkeypatch.setattr(serve, "device_vote_add", half)
    _, checks, _ = tiny.run("b15n4.serve_scan")
    assert not correct(checks) and not checks["unvoted_rows"]["ok"]


def test_fault_step_leaves_the_state_unchanged(monkeypatch):
    from xmask3d_tpu_torch.engine import train_step

    def no_update(self, step):
        for pairs in self.pairs.values():
            for p, m in pairs:
                p.grad = None
                m.grad = None
        self._reduced = False

    monkeypatch.setattr(train_step.MasterAdamW, "step", no_update)
    _, checks, _ = tiny.run("b170n30.train_b8")
    assert not correct(checks) and not checks["change_leaf"]["ok"]


def test_fault_half_the_batch_left_out(monkeypatch):
    """The step's forward sees the first half of the batch alone."""
    from xmask3d_tpu_torch.models.xmask3d import XMask3D

    real = XMask3D.train_forward

    def halved(self, batch, statics, draws):
        draws = {k: v[:, : max(1, v.shape[1] // 2)] for k, v in draws.items()}
        return real(self, calibrate.first_half(batch), statics, draws)

    monkeypatch.setattr(XMask3D, "train_forward", halved)
    _, checks, _ = tiny.run("b170n30.train_b8")
    assert not correct(checks)


def test_fault_update_altered(monkeypatch):
    """Every step's update a quarter larger where it is made (AdamW's
    learning rate); a scaled loss would not do, AdamW is blind to scale."""
    from xmask3d_tpu_torch.engine import train_step

    real = train_step.cosine_lr
    monkeypatch.setattr(train_step, "cosine_lr", lambda *a, **kw: real(*a, **kw) * 1.25)
    _, checks, _ = tiny.run("b170n30.train_b8")
    assert not correct(checks) and not checks["change_median"]["ok"]


@pytest.mark.parametrize("workload", ["b15n4.serve_scan", "b170n30.train_b8"])
def test_sound_tiny_runs_are_correct(workload):
    _, checks, _ = tiny.run(workload)
    assert correct(checks), checks
