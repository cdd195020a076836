"""Synthetic video dataset (counterpart of slowfast_tpu/data/kinetics.py:509-607).

Clips are the same bytes as the JAX package's ``Syntheticvideo``:
``np.random.RandomState(index)`` frames, labels seeded by
``index // num_clips`` so every view of a video has one label, and
``NUM_ENSEMBLE_VIEWS x NUM_SPATIAL_CROPS`` clips per video in test mode.
Real Kinetics decoding is not ported yet.
"""

import numpy as np


class Syntheticvideo:
    def __init__(self, cfg, mode):
        if not cfg.TPU.UINT8_PIPELINE:
            raise NotImplementedError("the port's loader ships uint8 clips only")
        self.cfg = cfg
        self.mode = mode
        self._size = cfg.DATA.SYNTHETIC_SIZE or (256 if mode == "train" else 64)
        if mode == "test":
            self._num_clips = cfg.TEST.NUM_ENSEMBLE_VIEWS * cfg.TEST.NUM_SPATIAL_CROPS
            self._size *= self._num_clips
        else:
            self._num_clips = 1

    def __len__(self):
        return self._size

    @property
    def num_videos(self):
        """Number of clips, as the JAX dataset counts them."""
        return self._size

    def __getitem__(self, index):
        cfg = self.cfg
        crop = cfg.DATA.TRAIN_CROP_SIZE if self.mode in ("train", "val") else (
            cfg.DATA.TEST_CROP_SIZE)
        rng = np.random.RandomState(index)
        frames = rng.randint(0, 255, (cfg.DATA.NUM_FRAMES, crop, crop, 3), np.uint8)
        label_rng = np.random.RandomState(index // self._num_clips)
        label = int(label_rng.randint(0, cfg.MODEL.NUM_CLASSES))
        return [frames], label, index, np.zeros((1,)), {}
