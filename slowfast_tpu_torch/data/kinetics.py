"""Synthetic video dataset (counterpart of slowfast_tpu/data/kinetics.py:509-607).

Clips are the same bytes as the JAX package's ``Syntheticvideo``:
``np.random.RandomState(index)`` frames, labels seeded by
``index // num_clips`` so every view of a video has one label, and
``NUM_ENSEMBLE_VIEWS x NUM_SPATIAL_CROPS`` clips per video in test mode.
Train and val clips are ``TRAIN_CROP_SIZE`` square; in train mode with
``AUG.ENABLE`` and ``AUG.NUM_SAMPLE > 1`` an item is that many copies of
the clip (the repeated-augmentation contract, flattened into the batch by
``loader.multiple_samples_collate``). Real Kinetics decoding is not ported
yet.
"""

import numpy as np


class Syntheticvideo:
    def __init__(self, cfg, mode):
        if not cfg.TPU.UINT8_PIPELINE:
            raise NotImplementedError("the port's loader ships uint8 clips only")
        if cfg.AUG.GEN_MASK_LOADER or cfg.DETECTION.ENABLE:
            raise NotImplementedError("loader masks and detection boxes are not ported yet")
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
        num_aug = cfg.AUG.NUM_SAMPLE if self.mode == "train" and cfg.AUG.ENABLE else 1
        if num_aug > 1:
            return ([[frames]] * num_aug, [label] * num_aug, [index] * num_aug,
                    [np.zeros((1,))] * num_aug, [{}] * num_aug)
        return [frames], label, index, np.zeros((1,)), {}
