"""Dataset helpers (counterpart of slowfast_tpu/data/utils.py:12-144; reference
slowfast/datasets/utils.py).

The port's loader ships uint8 clips, which the preprocess kernel normalizes
and splits into pathways on the card; the AVA dataset and the SSL
pretraining items ship float clips, normalized on the host
(``tensor_normalize``) and split by ``pack_pathway_output``.
``sample_rngs`` makes the generators each sample draws from.
"""

import random
import time

import numpy as np

from . import transform


def sample_rngs(seed, epoch, index):
    """A ``random.Random`` and a ``np.random.RandomState`` for one sample,
    both seeded with one 32-bit number made from ``(seed, epoch, index)``:
    a sample draws the same numbers whatever thread makes it and whenever.
    Seeding the modules ``random`` and ``np.random`` with ``sample_seed``
    gives the same two streams."""
    s = sample_seed(seed, epoch, index)
    return random.Random(s), np.random.RandomState(s)


def sample_seed(seed, epoch, index):
    return int(np.random.SeedSequence([seed, epoch, index]).generate_state(1)[0])


class SeededDataset:
    """A dataset whose item ``index`` draws from ``sample_rngs(cfg.RNG_SEED,
    epoch, index)``; the loader sets the epoch (``set_epoch``). A short-cycle
    item ``(index, cycle position)`` is sampled with ``short_cycle_idx``."""

    epoch = 0

    def set_epoch(self, epoch):
        self.epoch = epoch

    def __getitem__(self, index):
        if isinstance(index, tuple):
            index, cycle = index
            return self.sample(index, *sample_rngs(self.cfg.RNG_SEED, self.epoch, index),
                               short_cycle_idx=cycle)
        return self.sample(index, *sample_rngs(self.cfg.RNG_SEED, self.epoch, index))


def retry_load_images(image_paths, retry=10):
    """Read every frame with cv2 (BGR), trying the whole list up to ``retry``
    times half a second apart (reference utils.py:24-52)."""
    import cv2

    for _ in range(retry):
        imgs = [cv2.imread(p) for p in image_paths]
        if all(img is not None for img in imgs):
            return imgs
        time.sleep(0.5)
    raise RuntimeError(f"Failed to load images {image_paths}")


def get_sequence(center_idx, half_len, sample_rate, num_frames):
    """Frame indices around ``center_idx``, clamped to the video (reference
    utils.py:55-75)."""
    seq = list(range(center_idx - half_len, center_idx + half_len, sample_rate))
    return [min(max(s, 0), num_frames - 1) for s in seq]


def tensor_normalize(frames, mean, std):
    """``(x - mean) / std``, a uint8 clip first divided by 255 (reference
    utils.py:278-297)."""
    if frames.dtype == np.uint8:
        frames = frames.astype(np.float32) / 255.0
    return (frames - np.asarray(mean, np.float32)) / np.asarray(std, np.float32)


def pack_pathway_output(cfg, frames):
    """A (T, H, W, C) float clip as the model's pathway list (reference
    utils.py:78-111): channels reversed under ``DATA.REVERSE_INPUT_CHANNEL``;
    SlowFast's slow pathway takes the frames ``linspace(0, T - 1, T //
    alpha)`` truncated to integers."""
    if cfg.DATA.REVERSE_INPUT_CHANNEL:
        frames = frames[..., ::-1]
    if cfg.MODEL.ARCH in cfg.MODEL.SINGLE_PATHWAY_ARCH:
        return [frames]
    if cfg.MODEL.ARCH in cfg.MODEL.MULTI_PATHWAY_ARCH:
        idx = np.linspace(0, frames.shape[0] - 1,
                          frames.shape[0] // cfg.SLOWFAST.ALPHA).astype(np.int64)
        return [frames[idx], frames]
    raise NotImplementedError(f"Model arch {cfg.MODEL.ARCH} is not in "
                              f"{cfg.MODEL.SINGLE_PATHWAY_ARCH + cfg.MODEL.MULTI_PATHWAY_ARCH}")


def spatial_sampling(frames, rng, np_rng, spatial_idx=-1, min_scale=256, max_scale=320,
                     crop_size=224, random_horizontal_flip=True,
                     inverse_uniform_sampling=False, aspect_ratio=None, scale=None,
                     motion_shift=False):
    """Train (``spatial_idx`` -1: scale jitter and random crop, or a random
    resized crop when ``scale``/``aspect_ratio`` are given, then the flip) or
    test (0, 1, 2: short side to ``min_scale``, then that uniform crop)
    sampling of a (T, H, W, C) clip (reference utils.py:114-185)."""
    if spatial_idx not in (-1, 0, 1, 2):
        raise ValueError(f"spatial_idx {spatial_idx} is not -1, 0, 1 or 2")
    if spatial_idx == -1:
        if aspect_ratio is None and scale is None:
            frames = transform.random_short_side_scale_jitter(
                frames, min_scale, max_scale, np_rng,
                inverse_uniform_sampling=inverse_uniform_sampling)
            frames = transform.random_crop(frames, crop_size, np_rng)
        else:
            rrc = (transform.random_resized_crop_with_shift if motion_shift
                   else transform.random_resized_crop)
            frames = rrc(frames, crop_size, crop_size, rng, scale=tuple(scale),
                         ratio=tuple(aspect_ratio))
        if random_horizontal_flip:
            frames = transform.horizontal_flip(0.5, frames, np_rng)
    else:
        frames = transform.random_short_side_scale_jitter(frames, min_scale, min_scale,
                                                          np_rng)
        frames = transform.uniform_crop(frames, crop_size, spatial_idx)
    return np.ascontiguousarray(frames)


def as_binary_vector(labels, num_classes):
    """Multi-hot float32 vector of ``labels``."""
    vec = np.zeros((num_classes,), np.float32)
    for label in set(labels):
        vec[int(label)] = 1.0
    return vec


def aggregate_labels(label_list):
    """The sorted union of per-frame label lists."""
    return sorted({label for labels in label_list for label in labels})
