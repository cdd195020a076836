"""The port's ``DevicePrefetcher`` (parallel/prefetch.py) on the CPU: the
four cases of the JAX package's tests/test_prefetch.py (order, an
exception from staging, an early break releasing the staging thread, the
consumer running while staging blocks), staging never more than ``depth``
items ahead of the consumer, and the loader's batches bit-equal whatever
``TPU.PREFETCH`` and whichever staging (``staged_inline``) — and equal to
the JAX loader's; ``Loader.stage_with`` runs the trainer's staging where
the loader stages."""

import threading
import time

import numpy as np
import pytest

from slowfast_tpu.config import get_cfg as jax_get_cfg
from slowfast_tpu.data import construct_loader as jax_construct_loader
from slowfast_tpu_torch.config import get_cfg
from slowfast_tpu_torch.data import construct_loader
from slowfast_tpu_torch.parallel.prefetch import DevicePrefetcher, staged_inline


def test_yields_all_items_in_order():
    staged = []

    def stage(x):
        staged.append(x)
        return x * 10

    out = list(DevicePrefetcher(iter(range(8)), stage, depth=2))
    assert out == [x * 10 for x in range(8)]
    assert staged == list(range(8))


def test_stage_exception_propagates():
    def stage(x):
        if x == 3:
            raise ValueError("boom")
        return x

    got = []
    with pytest.raises(ValueError, match="boom"):
        for x in DevicePrefetcher(iter(range(8)), stage, depth=2):
            got.append(x)
    assert got == [0, 1, 2]


def test_iterator_exception_propagates():
    def items():
        yield 0
        raise KeyError("source")

    with pytest.raises(KeyError, match="source"):
        list(DevicePrefetcher(items(), lambda x: x, depth=2))


def test_early_break_releases_staging_thread():
    alive = threading.Event()
    alive.set()
    produced = []

    def infinite():
        i = 0
        while alive.is_set():
            yield i
            i += 1

    def stage(x):
        produced.append(x)
        return x

    before = threading.active_count()
    for x in DevicePrefetcher(infinite(), stage, depth=2):
        if x >= 3:
            break
    deadline = time.time() + 5.0
    while threading.active_count() > before and time.time() < deadline:
        time.sleep(0.05)
    assert threading.active_count() <= before
    assert len(produced) < 16
    alive.clear()


def test_consumer_runs_while_staging_blocks():
    gate = threading.Event()

    def stage(x):
        if x == 2:
            gate.wait(timeout=5.0)
        return x

    it = iter(DevicePrefetcher(iter(range(4)), stage, depth=2))
    assert next(it) == 0
    assert next(it) == 1  # staged while item 2 is blocked
    gate.set()
    assert list(it) == [2, 3]


@pytest.mark.parametrize("depth", [1, 2, 4])
def test_staging_at_most_depth_ahead(depth):
    """The iterator is pulled at most ``depth`` items past the ones the
    consumer has taken, however slowly it consumes."""
    pulled, ahead = [0], []

    def counting():
        for i in range(12):
            pulled[0] += 1
            yield i

    taken = 0
    for x in DevicePrefetcher(counting(), lambda x: x, depth=depth):
        taken += 1
        time.sleep(0.02)  # a slow step: staging runs as far ahead as it may
        ahead.append(pulled[0] - taken)
    assert taken == 12 and max(ahead) <= depth and max(ahead[:12 - depth]) == depth
    assert list(staged_inline(iter(range(3)), lambda x: x + 1)) == [1, 2, 3]


def _cfgs(prefetch):
    opts = ["TRAIN.DATASET", "syntheticvideo", "DATA.SYNTHETIC_SIZE", "10", "TRAIN.BATCH_SIZE",
            "3", "DATA.NUM_FRAMES", "4", "DATA.TRAIN_CROP_SIZE", "32", "DATA_LOADER.NUM_WORKERS",
            "2", "TPU.PREFETCH", str(prefetch), "NUM_GPUS", "1"]
    cfg, jcfg = get_cfg(), jax_get_cfg()
    cfg.merge_from_list(opts)
    jcfg.merge_from_list(opts)
    return cfg, jcfg


def _batches(loader):
    return [(x[0].numpy().copy(), y, idx) for x, y, idx, _, _ in loader]


def test_loader_batches_equal_for_every_prefetch():
    """Two epochs of the train loader (shuffled, last batch dropped) at
    ``TPU.PREFETCH`` 0, 1, 2 and 4 and with inline staging: the same
    batches, bit for bit, as the JAX loader's at the same setting."""
    want = None
    for prefetch in (0, 1, 2, 4):
        cfg, jcfg = _cfgs(prefetch)
        runs = {"prefetcher": construct_loader(cfg, "train", device="cpu"),
                "inline": construct_loader(cfg, "train", device="cpu",
                                           prefetcher=staged_inline)}
        jloader = jax_construct_loader(jcfg, "train")
        for epoch in range(2):
            jloader.set_epoch(epoch)
            jax_batches = [(x[0], y, idx) for x, y, idx, _, _ in jloader]
            for loader in runs.values():
                assert loader.prefetch == prefetch
                loader.set_epoch(epoch)
                got = _batches(loader)
                assert len(got) == len(jax_batches) == 3
                for (x, y, i), (jx, jy, ji) in zip(got, jax_batches):
                    np.testing.assert_array_equal(x, jx)
                    np.testing.assert_array_equal(y, jy)
                    np.testing.assert_array_equal(i, ji)
                if epoch == 0:
                    want = want or got
                    for (x, y, i), (wx, wy, wi) in zip(got, want):
                        assert np.array_equal(x, wx) and np.array_equal(y, wy)


@pytest.mark.parametrize("staging", ["prefetcher", "inline"])
def test_stage_with_runs_where_the_loader_stages(staging):
    """``Loader.stage_with(then)``: ``then`` of each staged batch, in order,
    on the loader's staging thread (the caller's with ``staged_inline``),
    and the batches those of plain iteration."""
    cfg, _ = _cfgs(2)
    kwargs = {} if staging == "prefetcher" else {"prefetcher": staged_inline}
    loader = construct_loader(cfg, "train", device="cpu", **kwargs)
    loader.set_epoch(0)
    threads = []

    def then(batch):
        threads.append(threading.current_thread())
        return batch

    got = _batches(loader.stage_with(then))
    assert len(threads) == len(got) == 3
    assert all((t is threading.main_thread()) == (staging == "inline") for t in threads)
    for (x, y, i), (wx, wy, wi) in zip(got, _batches(loader)):
        assert np.array_equal(x, wx) and np.array_equal(y, wy) and np.array_equal(i, wi)
