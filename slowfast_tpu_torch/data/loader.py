"""Train, val and test loaders (counterpart of slowfast_tpu/data/loader.py:29-305).

Samples are made by a thread pool ``TPU.PREFETCH + 1`` batches ahead
(numpy's generators release the GIL while they fill an array), stacked
into NTHWC batches (uint8 clips, or the float pathways of the AVA dataset)
and sent to the device from pinned memory with a non-blocking copy on a
background thread and, on the card, a side stream (``parallel/prefetch.py``
``DevicePrefetcher``, up to ``max(TPU.PREFETCH, 1)`` batches ahead of the
consumer, as the JAX loader's producer thread), with the padded boxes
and box mask of a detection batch (``detection_collate``) and the masks of
a masked-pretraining batch (``AUG.GEN_MASK_LOADER``); an SSL train batch
(``ssl_collate``) is a tuple of views, each a list of pathways. Labels, clip ids
and the ragged ``ori_boxes`` and ``metadata`` stay on the host. The train
split is shuffled per epoch with ``np.random.RandomState(RNG_SEED +
epoch).permutation`` and drops its last partial batch, as the JAX
``ShardedLoader`` does; val and test keep their order and their last batch.
``set_epoch`` also tells the dataset the epoch, from which each sample
seeds its generators. Under ``MULTIGRID.SHORT_CYCLE`` the train loader's
batches cycle through three shapes (``short_cycle_batches``): the shuffled
order is cut into batches of ``[B·f₀, B·f₁, B]`` items, each item an
``(index, cycle position)`` pair that the dataset crops at
``SHORT_CYCLE_FACTORS[i]·DEFAULT_S`` (the full crop at position 2); the
epoch ends at the first batch that the order cannot fill. ``len`` counts
batches of ``B``, as the JAX ``ShardedLoader`` does (:182-186), so an
epoch's ``epoch_exact`` reaches about 0.43 before the next epoch starts.

Under a process group of W ranks every batch size is the global batch's,
and each rank loads its part of every global batch in the JAX package's
layout (slowfast_tpu/data/loader.py:192-213 and ``shard_batch``): shard
``s`` of ``NUM_SHARDS`` takes ``batch[s::NUM_SHARDS]``, and within the
shard, GPU ``g`` the ``g``-th contiguous chunk (``rank_rows``). Val and
test keep their order; their last partial batch is padded to a multiple
of W by repeating its last item (slowfast_tpu/parallel/mesh.py:252
``pad_batch_for_mesh``), and ``meta["num_real"]`` counts the rank's real
rows, which come first.
"""

import os
from collections import deque
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from slowfast_tpu_torch.parallel.prefetch import DevicePrefetcher, to_device
from slowfast_tpu_torch.utils import distributed as du

from .ava_dataset import Ava
from .charades import Charades
from .imagenet import Imagenet
from .kinetics import Kinetics, Syntheticvideo
from .ssv2 import Ssv2

# The reference's pytorchvideo-backed names map to the same datasets
# (slowfast_tpu/data/kinetics.py:612, charades.py:147, ssv2.py:151).
DATASET_REGISTRY = {"Syntheticvideo": Syntheticvideo, "Kinetics": Kinetics,
                    "Ptvkinetics": Kinetics, "Charades": Charades, "Ptvcharades": Charades,
                    "Ssv2": Ssv2, "Ptvssv2": Ssv2, "Ava": Ava, "Imagenet": Imagenet}
# Per-clip box counts are padded up to one of these (multiples of the last
# beyond it), so a detection step sees a few shapes only.
_BOX_BUCKETS = (4, 8, 16, 32)
# Entries of a batch's meta that go to the device with the inputs.
DEVICE_META = ("boxes", "box_mask", "mask")


def build_dataset(dataset_name, cfg, split):
    name = dataset_name.capitalize()
    if name not in DATASET_REGISTRY:
        raise NotImplementedError(f"dataset {name!r} is not ported yet; "
                                  f"available: {sorted(DATASET_REGISTRY)}")
    return DATASET_REGISTRY[name](cfg, split)


def collate(samples):
    """Stack samples into ``(inputs, labels, clip_ids, times, meta)``: integer
    labels as int64, multi-hot ones as float32; the loader's masks, when the
    samples carry them, as ``meta["mask"]`` (slowfast_tpu/data/loader.py:132)."""
    num_pathways = len(samples[0][0])
    inputs = [np.stack([s[0][p] for s in samples]) for p in range(num_pathways)]
    labels = np.asarray([s[1] for s in samples])
    labels = labels.astype(np.float32 if labels.dtype.kind == "f" else np.int64)
    index = np.asarray([s[2] for s in samples], np.int64)
    times = np.stack([np.asarray(s[3]) for s in samples])
    meta = {}
    if "mask" in samples[0][4]:
        meta["mask"] = np.stack([s[4]["mask"] for s in samples])
    return inputs, labels, index, times, meta


def _box_bucket(n):
    """The smallest bucket of ``_BOX_BUCKETS`` that holds ``n`` boxes."""
    for b in _BOX_BUCKETS:
        if n <= b:
            return b
    return int(-(-n // _BOX_BUCKETS[-1]) * _BOX_BUCKETS[-1])


def detection_collate(samples):
    """Detection batches (slowfast_tpu/data/loader.py:46-83): each clip's
    boxes and multi-hot labels padded to the bucket of the batch's largest
    box count, with a validity mask. Returns ``(inputs, (B, M, K) labels,
    clip ids, times, meta)``, meta holding ``boxes`` ``(B, M, 4)``,
    ``box_mask`` ``(B, M)`` and, one row per real box in the clips' order,
    ``ori_boxes`` ``(N, 5)`` (the clip's index first) and ``metadata``
    ``(N, 2)``."""
    num_pathways = len(samples[0][0])
    inputs = []
    for p in range(num_pathways):
        x = np.stack([s[0][p] for s in samples])
        inputs.append(x if x.dtype == np.uint8 else x.astype(np.float32))
    labels = [np.atleast_2d(np.asarray(s[1], np.float32)) for s in samples]
    index = np.asarray([s[2] for s in samples], np.int64)
    times = np.stack([np.asarray(s[3]) for s in samples])
    metas = [s[4] for s in samples]
    B = len(samples)
    M = _box_bucket(max(m["boxes"].shape[0] for m in metas))
    boxes = np.zeros((B, M, 4), np.float32)
    box_mask = np.zeros((B, M), np.float32)
    padded = np.zeros((B, M, labels[0].shape[1]), np.float32)
    ori_boxes, metadata = [], []
    for i, meta in enumerate(metas):
        n = meta["boxes"].shape[0]
        boxes[i, :n] = meta["boxes"]
        box_mask[i, :n] = 1.0
        padded[i, :n] = labels[i][:n]
        for j in range(n):
            ori_boxes.append([i] + list(meta["ori_boxes"][j]))
            metadata.append(meta["metadata"][j] if "metadata" in meta else [0, 0])
    meta = {"boxes": boxes, "box_mask": box_mask,
            "ori_boxes": np.asarray(ori_boxes, np.float32),
            "metadata": np.asarray(metadata, np.float32)}
    return inputs, padded, index, times, meta


def ssl_collate(samples):
    """The SSL multi-view batch (slowfast_tpu/data/loader.py:98): each item's
    first entry is its list of views, each a pathway list. Returns ``(views,
    labels, clip ids, times, {})``, ``views`` a tuple of stacked float32
    pathway lists, one per view (at least two; the train step takes the
    first two). Under a process group the loader hands it this rank's
    items of the global batch (``rank_rows``), so the views, ``index`` and
    ``time`` are this rank's rows, in the order of the global batch."""
    views = tuple([np.stack([s[0][v][p] for s in samples]).astype(np.float32)
                   for p in range(len(samples[0][0][v]))]
                  for v in range(len(samples[0][0])))
    labels = np.asarray([s[1] for s in samples])
    index = np.asarray([s[2] for s in samples], np.int64)
    times = np.stack([np.asarray(s[3]) for s in samples])
    return views, labels, index, times, {}


def multiple_samples_collate(samples):
    """Flatten repeated-augmentation items (each a list of ``NUM_SAMPLE``
    clips with replicated labels and ids) into the batch axis (reference
    loader.py:20-45)."""
    return collate([flat for s in samples for flat in zip(*s)])


def rank_rows(batch, rank, world, num_shards):
    """Rank ``rank``'s rows of a global ``batch`` (a list) on ``world``
    ranks over ``num_shards`` hosts: the host's strided part, then the
    rank's contiguous chunk of it."""
    gpus = world // num_shards
    shard, gpu = divmod(rank, gpus)
    host = batch[shard::num_shards]
    per = len(host) // gpus
    return host[gpu * per:(gpu + 1) * per]


def short_cycle_batches(cfg, batch_size):
    """The short cycle's batch sizes, ``[B·f₀, B·f₁, B]`` with ``fᵢ =
    round((TRAIN_CROP_SIZE / (SHORT_CYCLE_FACTORS[i]·DEFAULT_S))²)``
    (slowfast_tpu/data/loader.py:155-175)."""
    factors = [int(round((float(cfg.DATA.TRAIN_CROP_SIZE) / (f * cfg.MULTIGRID.DEFAULT_S)) ** 2))
               for f in cfg.MULTIGRID.SHORT_CYCLE_FACTORS]
    return [batch_size * factors[0], batch_size * factors[1], batch_size]


class Loader:
    """Batches of a dataset, inputs placed on ``device``.

    ``shuffle`` reorders the dataset every epoch (``set_epoch``) from
    ``seed + epoch``; ``drop_last`` drops the last partial batch.
    ``cycle_batches`` (the short cycle's three batch sizes) makes each
    batch a list of ``(index, cycle position)`` items. ``batch_size`` and
    ``cycle_batches`` are global: with ``world`` > 1 this loader yields
    rank ``rank``'s rows of each (``rank_rows``), the last partial batch
    padded for every rank. ``prefetch`` (``TPU.PREFETCH``): the samples of
    ``prefetch + 1`` batches are made at once, and ``prefetcher``
    (``parallel.prefetch.DevicePrefetcher``, or ``staged_inline`` to stage
    on the consumer's thread) collates and moves up to ``max(prefetch, 1)``
    batches ahead of the consumer; ``stage_with`` runs a consumer's own
    staging there too.
    """

    def __init__(self, dataset, batch_size, device, num_workers=1, shuffle=False,
                 drop_last=False, seed=0, collate_fn=collate, cycle_batches=None,
                 rank=0, world=1, num_shards=1, prefetch=2, prefetcher=DevicePrefetcher):
        if world > 1 and (batch_size % world or world % num_shards):
            raise ValueError(f"the global batch of {batch_size} does not split over "
                             f"{world} ranks on {num_shards} hosts")
        self.dataset = dataset
        self.batch_size = batch_size
        self.device = torch.device(device)
        self.num_workers = max(1, min(num_workers, os.cpu_count() or 1))
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.collate_fn = collate_fn
        self.cycle_batches = cycle_batches
        self.rank, self.world, self.num_shards = rank, world, num_shards
        self.prefetch = max(int(prefetch), 0)
        self.prefetcher = prefetcher
        self.epoch = 0

    def set_epoch(self, epoch):
        self.epoch = epoch
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(epoch)

    def __len__(self):
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _global_batches(self):
        """The global batches of the epoch, lists of items."""
        n, bs = len(self.dataset), self.batch_size
        order = (np.random.RandomState(self.seed + self.epoch).permutation(n)
                 if self.shuffle else np.arange(n)).tolist()
        if self.cycle_batches is None:
            return [order[b * bs:(b + 1) * bs] for b in range(len(self))]
        batches, pos = [], 0
        while pos + self.cycle_batches[len(batches) % 3] <= n:
            cycle = len(batches) % 3
            batches.append([(i, cycle) for i in order[pos:pos + self.cycle_batches[cycle]]])
            pos += self.cycle_batches[cycle]
        return batches

    def _indices(self):
        """This rank's items of each global batch."""
        return [items for items, _ in self._rank_batches()]

    def _rank_batches(self):
        """This rank's ``(items, real item count)`` of each global batch."""
        out = []
        for batch in self._global_batches():
            n = len(batch)
            batch = batch + batch[-1:] * (-n % self.world)
            rows = rank_rows(list(range(len(batch))), self.rank, self.world, self.num_shards)
            out.append(([batch[i] for i in rows], sum(i < n for i in rows)))
        return out

    def _host_batches(self):
        """This rank's collated host batches, the samples of ``prefetch + 1``
        batches in the making on the thread pool."""
        batches = iter(self._rank_batches())
        pool = ThreadPoolExecutor(self.num_workers)
        window = deque()
        try:
            while True:
                while len(window) <= self.prefetch:
                    idx, num_real = next(batches, (None, 0))
                    if idx is None:
                        break
                    window.append(([pool.submit(self.dataset.__getitem__, i) for i in idx],
                                   num_real))
                if not window:
                    return
                futures, num_real = window.popleft()
                inputs, labels, index, times, meta = self.collate_fn(
                    [f.result() for f in futures])
                if self.world > 1:
                    meta["num_real"] = num_real
                yield inputs, labels, index, times, meta
        finally:
            pool.shutdown(wait=True, cancel_futures=True)

    def _stage(self, batch):
        """The batch with its inputs and ``DEVICE_META`` on the device."""
        inputs, labels, index, times, meta = batch
        meta = {k: to_device(v, self.device) if k in DEVICE_META else v
                for k, v in meta.items()}
        if isinstance(inputs, tuple):  # SSL views
            inputs = tuple([to_device(x, self.device) for x in view] for view in inputs)
        else:
            inputs = [to_device(x, self.device) for x in inputs]
        return inputs, labels, index, times, meta

    def __iter__(self):
        return self.stage_with(None)

    def stage_with(self, then):
        """The staged batches, or ``then(batch)`` of each: ``then`` runs
        after the batch's copies, on the same thread and stream, so what it
        moves (the trainer's labels, the SSL step's clip ids and times)
        travels with the batch."""
        stage = self._stage if then is None else lambda batch: then(self._stage(batch))
        return iter(self.prefetcher(self._host_batches(), stage, max(self.prefetch, 1),
                                    self.device))


def construct_loader(cfg, split, device="cuda", prefetcher=DevicePrefetcher):
    """The loader of ``split`` (``train``, ``val`` or ``test``); see
    ``Loader`` for ``prefetcher``."""
    if split not in ("train", "val", "test"):
        raise ValueError(f"unknown split {split!r}")
    if split == "test":
        dataset_name, batch_size = cfg.TEST.DATASET, cfg.TEST.BATCH_SIZE
    else:
        dataset_name, batch_size = cfg.TRAIN.DATASET, cfg.TRAIN.BATCH_SIZE
    train = split == "train"
    dataset = build_dataset(dataset_name, cfg, split)
    cycle_batches = None
    if train and cfg.MULTIGRID.SHORT_CYCLE:
        if not isinstance(dataset, (Kinetics, Syntheticvideo)):
            # slowfast_tpu/data/charades.py:101, ssv2.py:102 (ROADMAP Queue 3).
            raise NotImplementedError(
                f"{type(dataset).__name__} has no short-cycle items: the JAX package's "
                f"{type(dataset).__name__}.__getitem__ takes an int index and fails on the "
                "loader's (index, cycle) pairs; train with MULTIGRID.SHORT_CYCLE False (the "
                "long cycle runs)")
        cycle_batches = short_cycle_batches(cfg, batch_size)
    if cfg.DETECTION.ENABLE:
        collate_fn = detection_collate
    elif train and cfg.MODEL.MODEL_NAME == "ContrastiveModel":
        collate_fn = ssl_collate
    elif train and cfg.AUG.ENABLE and cfg.AUG.NUM_SAMPLE > 1:
        collate_fn = multiple_samples_collate
    else:
        collate_fn = collate
    return Loader(dataset, batch_size, device, num_workers=cfg.DATA_LOADER.NUM_WORKERS,
                  shuffle=train, drop_last=train, seed=cfg.RNG_SEED, collate_fn=collate_fn,
                  cycle_batches=cycle_batches, rank=du.get_rank(), world=du.get_world_size(),
                  num_shards=cfg.NUM_SHARDS, prefetch=cfg.TPU.PREFETCH, prefetcher=prefetcher)


def shuffle_dataset(loader, cur_epoch):
    """Set the epoch that seeds the train order (reference loader.py:174-207)."""
    loader.set_epoch(cur_epoch)
