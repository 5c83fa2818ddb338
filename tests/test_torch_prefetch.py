"""Batch prefetch (`data/prefetch.py`) and the trainer's `workers`.

- `parallel_map_iterator`: results in order whatever the workers' timing,
  at most `depth` calls ahead of the consumer, arguments drawn in order in
  the consumer's thread; a worker's exception reaches the consumer at its
  item, after the items before it, without a hang; closing the iterator
  ends its threads. A stress run with more workers than cores and a short
  switch interval keeps the order.
- `prefetch_iterator`: order, a bounded lead, an exception raised by the
  iterator reaching the consumer.
- On the miniature ScanNet of `tests/mini_scannet.py`: the trainer's
  `make_data_iter` gives the same batches bit for bit with `workers` 1 and
  4, run after run; with `workers` 0 its batches equal the JAX trainer's
  serial loader.
"""

import random
import sys
import threading
import time

import numpy as np
import pytest
import torch

from mini_scannet import build_mini_scannet
from xmask3d_tpu.config import load_config as jax_load_config
from xmask3d_tpu.data.batching import Capacities as JaxCapacities
from xmask3d_tpu.engine import train as jax_train
from xmask3d_tpu_torch.config import load_config
from xmask3d_tpu_torch.data.batching import Capacities
from xmask3d_tpu_torch.data.prefetch import parallel_map_iterator, prefetch_iterator, to_device
from xmask3d_tpu_torch.engine import train as trainer
from xmask3d_tpu_torch.engine.graphs import flatten

CONFIG = "configs/scannet/xmask3d_scannet_B15N4.yaml"


class Boom(Exception):
    pass


def _prefetch_threads():
    return [t for t in threading.enumerate() if t.name.startswith("prefetch")]


def _wait_for_no_prefetch_threads(timeout=10.0):
    end = time.time() + timeout
    while _prefetch_threads() and time.time() < end:
        time.sleep(0.01)
    return not _prefetch_threads()


@pytest.mark.parametrize("workers", [1, 3, 8])
def test_results_come_in_order(workers):
    rng = random.Random(workers)
    delays = [rng.uniform(0, 0.01) for _ in range(40)]

    def slow_square(i):
        time.sleep(delays[i])
        return i * i

    assert list(parallel_map_iterator(slow_square, range(40), workers)) == \
        [i * i for i in range(40)]
    assert _wait_for_no_prefetch_threads()


def test_at_most_depth_calls_ahead_and_arguments_drawn_in_order():
    """The iterator refills its window and only then hands an item out, so
    no call starts more than `depth` items past the item last handed out.
    Seen from the consumer, while an item is on its way, `depth + 1` calls
    have started beyond the ones it has taken. Deterministic: at each item
    the consumer waits until every call that may start has started."""
    depth, n = 5, 30
    lock = threading.Lock()
    drawn, started, consumed = [], [], []
    ahead = []  # per call: its item less the number of items consumed
    started_evt = [threading.Event() for _ in range(n)]

    def args():
        for i in range(n):
            drawn.append((i, threading.current_thread() is threading.main_thread()))
            yield i

    def fn(i):
        with lock:
            started.append(i)
            ahead.append(i - len(consumed))
        started_evt[i].set()
        return i

    for out in parallel_map_iterator(fn, args(), workers=4, depth=depth):
        # `out` is in transit: the refill behind it has run, the next one not
        last = min(out + depth, n - 1)
        assert all(started_evt[k].wait(10) for k in range(last + 1))
        with lock:
            assert max(started) == last and len(started) == last + 1
            assert len(started) - len(consumed) == min(depth + 1, n - len(consumed))
            consumed.append(out)
        # the window: what was drawn is at most `depth` past what was consumed
        assert len(drawn) <= len(consumed) + depth
    assert consumed == list(range(n))
    assert [i for i, _ in drawn] == list(range(n)) and all(main for _, main in drawn)
    assert max(ahead) == depth


def test_an_exception_reaches_the_consumer_at_its_item():
    def fn(i):
        if i == 7:
            raise Boom(f"item {i}")
        time.sleep(0.001)
        return i

    got = []
    with pytest.raises(Boom, match="item 7"):
        for out in parallel_map_iterator(fn, iter(range(100)), workers=4):
            got.append(out)
    assert got == list(range(7))
    assert _wait_for_no_prefetch_threads()


def test_an_exception_of_the_argument_iterator_reaches_the_consumer():
    def args():
        yield from range(3)
        raise Boom("no more arguments")

    got = []
    with pytest.raises(Boom, match="no more arguments"):
        for out in parallel_map_iterator(lambda i: i, args(), workers=2):
            got.append(out)
    assert got == []  # raised while the window was being filled


def test_closing_the_iterator_ends_its_threads():
    it = parallel_map_iterator(lambda i: i, iter(range(10 ** 6)), workers=4)
    assert [next(it) for _ in range(5)] == list(range(5))
    it.close()
    assert _wait_for_no_prefetch_threads()


def test_order_holds_under_stress():
    """More workers than cores and a short switch interval; every result
    lands at its own index."""
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        n = 400
        out = list(parallel_map_iterator(lambda i: (i, np.full(64, i).sum()), range(n),
                                         workers=32))
    finally:
        sys.setswitchinterval(old)
    assert [i for i, _ in out] == list(range(n))
    assert all(s == 64 * i for i, s in out)
    assert _wait_for_no_prefetch_threads()


def test_prefetch_iterator_order_lead_and_exception():
    produced = []

    def gen():
        for i in range(20):
            produced.append(i)
            yield i
        raise Boom("iterator failed")

    got = []
    with pytest.raises(Boom, match="iterator failed"):
        for x in prefetch_iterator(gen(), depth=3):
            # the producer runs at most the queue's depth (plus the item in
            # its hands) ahead
            assert len(produced) <= len(got) + 1 + 3 + 1
            got.append(x)
            time.sleep(0.002)
    assert got == list(range(20))
    assert _wait_for_no_prefetch_threads()
    it = prefetch_iterator(iter(range(10 ** 6)), depth=2)
    assert [next(it) for _ in range(3)] == [0, 1, 2]
    it.close()
    assert _wait_for_no_prefetch_threads()


def test_to_device_leaves_cpu_batches_as_they_are():
    batch = {"a": torch.ones(2), "b": (torch.zeros(3, dtype=torch.int32),)}
    assert to_device(batch, torch.device("cpu")) is batch


# --------------------------------------------------------------------------
# the trainer's data stream on the miniature ScanNet
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def mini_root(tmp_path_factory):
    return build_mini_scannet(tmp_path_factory.mktemp("scannet_prefetch"), n_views=4)


def _cfg(loader, root, workers):
    cfg = loader(CONFIG)
    cfg.update(data_root=str(root / "scannet_3d"), data_root_2d=str(root / "scannet_2d"),
               caption_path=str(root / "caption.json"), loop=4, batch_size=2, workers=workers,
               max_points=2048, max_voxels=2048, max_targets=8)
    return cfg


CAPS = (2048, 2048, 8)


def _port_batches(root, workers, n=4):
    data, samples, _ = trainer.make_data_iter(_cfg(load_config, root, workers), Capacities(*CAPS),
                                              synthetic=False, tiny=True,
                                              allow_hash_tokenizer=True, device="cpu")
    out = [next(data) for _ in range(n)]
    data.close()
    assert samples == 4
    return out


def _same(a, b) -> bool:
    (sa, la), (sb, lb) = flatten(a), flatten(b)
    return sa == sb and all(torch.equal(x, y) for x, y in zip(la, lb))


def test_workers_one_and_four_give_the_same_batches_run_after_run(mini_root):
    four = _port_batches(mini_root, 4)
    assert all(_same(a, b) for a, b in zip(four, _port_batches(mini_root, 4)))
    assert all(_same(a, b) for a, b in zip(four, _port_batches(mini_root, 1)))
    # the batches differ from one another: each draws its own views and jitter
    assert not _same(four[0], four[1]) and not _same(four[1], four[2])
    assert _wait_for_no_prefetch_threads()


def test_serial_batches_equal_the_jax_serial_loader(mini_root):
    got = _port_batches(mini_root, 0, n=3)
    jdata, jsamples, _ = jax_train.make_data_iter(
        _cfg(jax_load_config, mini_root, 0), JaxCapacities(*CAPS), synthetic=False, tiny=True,
        allow_hash_tokenizer=True)
    want = [next(jdata) for _ in range(3)]
    assert jsamples == 4
    for g, w in zip(got, want):
        for key, value in w.items():
            if key == "hierarchy":
                continue
            np.testing.assert_array_equal(g[key].numpy(), np.asarray(value), err_msg=key)
        hj, ht = w["hierarchy"], g["hierarchy"]
        for lj, lt in zip(hj.levels, ht.levels):
            for name in ("coords", "valid", "kmap3", "num"):
                np.testing.assert_array_equal(getattr(lt, name).numpy(),
                                              np.asarray(getattr(lj, name)))
        for name in ("down", "up_parent", "up_octant"):
            for a, b in zip(getattr(hj, name), getattr(ht, name)):
                np.testing.assert_array_equal(b.numpy(), np.asarray(a))
        np.testing.assert_array_equal(ht.kmap5.numpy(), np.asarray(hj.kmap5))
