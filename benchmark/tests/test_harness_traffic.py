"""The traffic generators: the same seed gives the same inputs, two seeds
differ, and seeds past 32 bits are taken."""

from __future__ import annotations

import numpy as np
import pytest

from benchmark.harness import core
from benchmark.harness.port import draw_tokens, draw_views

SEEDS = (0, 2**31 + 11, 2**40 + 3)


def _cell(name):
    w = core.cell(name)
    traffic = dict(w["traffic_file"], points_per_view=500)
    return w["config_file"], traffic


def _same(a, b):
    return all(np.array_equal(a[k], b[k]) for k in a)


@pytest.mark.parametrize("cell", ["b15n4.serve_scan", "b15n4.serve_scan_60k",
                                  "b170n30.train_b8"])
@pytest.mark.parametrize("seed", SEEDS)
def test_same_seed_same_inputs(cell, seed):
    conf, traffic = _cell(cell)
    a = draw_views(seed, conf, traffic, tiny=True, n=2)
    b = draw_views(seed, conf, traffic, tiny=True, n=2)
    assert all(_same(x, y) for x, y in zip(a, b))
    ta, tb = draw_tokens(seed, conf, True), draw_tokens(seed, conf, True)
    assert _same(ta, tb)


@pytest.mark.parametrize("cell", ["b15n4.serve_scan", "b170n30.train_b8"])
def test_two_seeds_differ(cell):
    conf, traffic = _cell(cell)
    a = draw_views(SEEDS[1], conf, traffic, tiny=True, n=1)[0]
    b = draw_views(SEEDS[1] + 1, conf, traffic, tiny=True, n=1)[0]
    assert not np.array_equal(a["points"], b["points"])
    assert not np.array_equal(a["img"], b["img"])
    assert not np.array_equal(draw_tokens(SEEDS[1], conf, True)["test"],
                              draw_tokens(SEEDS[1] + 1, conf, True)["test"])


def test_views_of_one_run_differ():
    conf, traffic = _cell("b15n4.serve_scan")
    a, b = draw_views(7, conf, traffic, tiny=True, n=2)
    assert not np.array_equal(a["points"], b["points"])


def test_training_views_carry_many_targets():
    """The training mix's 2D labels give up to the configuration's 48
    targets a view (ScanNet200's load on the matcher)."""
    from benchmark.reference.data.collate import pack_targets

    conf, traffic = _cell("b170n30.train_b8")
    counts = [int(pack_targets(v["label_2d"], conf["max_targets"])[1].sum())
              for v in draw_views(3, conf, traffic, tiny=False, n=4)]
    assert max(counts) > 24 and max(counts) <= conf["max_targets"]


def test_weights_same_seed_same_values():
    import torch

    from benchmark.harness.refmodel import leaf_specs
    from benchmark.harness.weights import make_weights
    from benchmark.tests.tiny import TINY_MODEL

    conf = dict(core.cell("b15n4.serve_scan")["config_file"], **TINY_MODEL)
    leaves = leaf_specs(conf, True, "cpu")
    a = make_weights(leaves, 2**31 + 9, "cpu")
    b = make_weights(leaves, 2**31 + 9, "cpu")
    c = make_weights(leaves, 2**31 + 10, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert any(not torch.equal(a[k], c[k]) for k in a)
    assert a[next(k for k in a if k.endswith(".var"))].dtype == torch.float32
