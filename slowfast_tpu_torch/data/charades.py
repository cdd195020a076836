"""Charades (counterpart of slowfast_tpu/data/charades.py; reference
slowfast/datasets/charades.py).

Frame lists with per-frame labels: ``{train,val}.csv`` rows of
``original_vido_id video_id frame_id path labels`` under a header, frames
read with cv2 (BGR, turned to RGB). A clip is ``NUM_FRAMES`` frames
``SAMPLING_RATE`` apart (a random start in training, evenly spaced views in
test, clamped to the video), spatially sampled as Kinetics clips are; its
label is the multi-hot vector of every label of its frames. Test reads
``val.csv``. Items are uint8 clips; the card normalizes them.
"""

import os
from collections import defaultdict

import numpy as np

from slowfast_tpu_torch.utils import logging as logging_utils
from slowfast_tpu_torch.utils.io import pathmgr
from . import utils

logger = logging_utils.get_logger(__name__)


def read_frame_lists(path_to_file, path_prefix):
    """``{video: [frame paths]}`` and ``{video: [row's last field]}`` of a
    frame-list csv, in file order."""
    paths, fields = defaultdict(list), defaultdict(list)
    with pathmgr.open(path_to_file) as f:
        f.readline()
        for line in f:
            row = line.split()
            paths[row[0]].append(os.path.join(path_prefix, row[3]))
            fields[row[0]].append(row[-1])
    return paths, fields


def clip_sampling(cfg, mode, spatial_temporal_idx):
    """``(spatial_idx, min_scale, max_scale, crop_size)`` of a frame dataset's
    item."""
    if mode in ("train", "val"):
        return (-1, *cfg.DATA.TRAIN_JITTER_SCALES, cfg.DATA.TRAIN_CROP_SIZE)
    size = cfg.DATA.TEST_CROP_SIZE
    return spatial_temporal_idx % cfg.TEST.NUM_SPATIAL_CROPS, size, size, size


def load_clip(cfg, paths, spatial, rng, np_rng):
    """Read ``paths`` and spatially sample them into one uint8 RGB clip."""
    spatial_idx, min_scale, max_scale, crop_size = spatial
    frames = np.stack([f[:, :, ::-1] for f in utils.retry_load_images(paths)])
    return utils.spatial_sampling(frames, rng, np_rng, spatial_idx=spatial_idx,
                                  min_scale=min_scale, max_scale=max_scale,
                                  crop_size=crop_size,
                                  random_horizontal_flip=cfg.DATA.RANDOM_FLIP,
                                  inverse_uniform_sampling=cfg.DATA.INV_UNIFORM_SAMPLE)


def _parse_labels(field):
    field = field.replace('"', "")
    return [int(x) for x in field.split(",")] if field else []


class Charades(utils.SeededDataset):
    def __init__(self, cfg, mode):
        if mode not in ("train", "val", "test"):
            raise ValueError(f"unknown split {mode!r}")
        self.cfg = cfg
        self.mode = mode
        self._num_clips = (1 if mode in ("train", "val")
                           else cfg.TEST.NUM_ENSEMBLE_VIEWS * cfg.TEST.NUM_SPATIAL_CROPS)
        split = "train" if mode == "train" else "val"
        paths, fields = read_frame_lists(
            os.path.join(cfg.DATA.PATH_TO_DATA_DIR, f"{split}.csv"), cfg.DATA.PATH_PREFIX)
        self._path_to_videos, self._labels, self._spatial_temporal_idx = [], [], []
        for name in paths:
            labels = [_parse_labels(f) for f in fields[name]]
            for idx in range(self._num_clips):
                self._path_to_videos.append(paths[name])
                self._labels.append(labels)
                self._spatial_temporal_idx.append(idx)
        logger.info("Charades dataloader constructed (size: %d)", len(self._path_to_videos))

    def __len__(self):
        return len(self._path_to_videos)

    @property
    def num_videos(self):
        return len(self._path_to_videos)

    def get_seq_frames(self, index, rng):
        """The clip's frame indices (reference charades.py:150-185)."""
        cfg = self.cfg
        num_frames, rate = cfg.DATA.NUM_FRAMES, cfg.DATA.SAMPLING_RATE
        video_length = len(self._path_to_videos[index])
        clip_length = (num_frames - 1) * rate + 1
        if clip_length > video_length:
            start = rng.randint(video_length - clip_length, 0)
        elif self.mode == "train":
            start = rng.randint(0, video_length - clip_length)
        else:
            temporal_idx = self._spatial_temporal_idx[index] // cfg.TEST.NUM_SPATIAL_CROPS
            gap = max(video_length - clip_length, 0)
            start = int(gap * temporal_idx / max(cfg.TEST.NUM_ENSEMBLE_VIEWS - 1, 1))
        return [max(min(start + i * rate, video_length - 1), 0) for i in range(num_frames)]

    def sample(self, index, rng, np_rng):
        """Item ``index``: ``([clip], multi-hot label, index, time, {})``."""
        seq = self.get_seq_frames(index, rng)
        spatial = clip_sampling(self.cfg, self.mode, self._spatial_temporal_idx[index])
        frames = load_clip(self.cfg, [self._path_to_videos[index][f] for f in seq], spatial,
                           rng, np_rng)
        labels = utils.aggregate_labels([self._labels[index][f] for f in seq])
        label = utils.as_binary_vector(labels, self.cfg.MODEL.NUM_CLASSES)
        return [frames], label, index, np.zeros((1,)), {}
