"""Test-split loader (counterpart of slowfast_tpu/data/loader.py for the
eval path).

Samples are made by a thread pool a few batches ahead (numpy's generators
release the GIL while they fill an array), stacked into uint8 NTHWC
batches, and sent to the device from pinned memory with a non-blocking
copy. Labels and clip ids stay on the host for the meter.
"""

import os
from collections import deque
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from .kinetics import Syntheticvideo

DATASET_REGISTRY = {"Syntheticvideo": Syntheticvideo}
PREFETCH = 2  # batches in the making beyond the one being consumed


def build_dataset(dataset_name, cfg, split):
    name = dataset_name.capitalize()
    if name not in DATASET_REGISTRY:
        raise NotImplementedError(f"dataset {name!r} is not ported yet; "
                                  f"available: {sorted(DATASET_REGISTRY)}")
    return DATASET_REGISTRY[name](cfg, split)


def collate(samples):
    """Stack samples into ``(inputs, labels, clip_ids, times, meta)``."""
    num_pathways = len(samples[0][0])
    inputs = [np.stack([s[0][p] for s in samples]) for p in range(num_pathways)]
    labels = np.asarray([s[1] for s in samples], np.int64)
    index = np.asarray([s[2] for s in samples], np.int64)
    times = np.stack([np.asarray(s[3]) for s in samples])
    return inputs, labels, index, times, {}


class TestLoader:
    """In-order batches of a dataset, inputs placed on ``device``."""

    def __init__(self, dataset, batch_size, device, num_workers=1):
        self.dataset = dataset
        self.batch_size = batch_size
        self.device = torch.device(device)
        self.num_workers = max(1, min(num_workers, os.cpu_count() or 1))

    def __len__(self):
        return -(-len(self.dataset) // self.batch_size)

    def _to_device(self, x):
        t = torch.from_numpy(x)
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device)

    def __iter__(self):
        n, bs = len(self.dataset), self.batch_size
        batches = iter([range(b * bs, min(n, (b + 1) * bs)) for b in range(len(self))])
        pool = ThreadPoolExecutor(self.num_workers)
        window = deque()
        try:
            while True:
                while len(window) <= PREFETCH:
                    idx = next(batches, None)
                    if idx is None:
                        break
                    window.append([pool.submit(self.dataset.__getitem__, i) for i in idx])
                if not window:
                    return
                inputs, labels, index, times, meta = collate(
                    [f.result() for f in window.popleft()])
                yield [self._to_device(x) for x in inputs], labels, index, times, meta
        finally:
            pool.shutdown(wait=True, cancel_futures=True)


def construct_loader(cfg, split, device="cuda"):
    """The test-split loader (the only split the port runs yet)."""
    if split != "test":
        raise NotImplementedError(f"the {split!r} loader is not ported yet")
    dataset = build_dataset(cfg.TEST.DATASET, cfg, split)
    return TestLoader(dataset, cfg.TEST.BATCH_SIZE, device,
                      num_workers=cfg.DATA_LOADER.NUM_WORKERS)
