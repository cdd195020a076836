"""Random erasing of (T, H, W, C) clips (counterpart of
slowfast_tpu/data/random_erasing.py; reference slowfast/datasets/
random_erasing.py, from timm).

With probability ``probability``, ``count`` rectangles are erased, each with
per-pixel normal noise (``pixel``), one normal colour (``rand``) or zeros
(``const``); with ``cube`` the same rectangle and fill cover every frame.
The fill is cast to the clip's dtype, as the JAX package casts it. The
caller passes the generators: ``rng`` (``random.Random``) for the
rectangles, ``np_rng`` (``np.random.RandomState``) for the noise.
"""

import math

import numpy as np


class RandomErasing:
    def __init__(self, probability=0.5, min_area=0.02, max_area=1 / 3, min_aspect=0.3,
                 max_aspect=None, mode="const", min_count=1, max_count=None, num_splits=0,
                 cube=True):
        mode = mode.lower()
        if mode not in ("rand", "pixel", "const"):
            raise ValueError(f"random erasing mode {mode!r}")
        self.probability = probability
        self.min_area = min_area
        self.max_area = max_area
        max_aspect = max_aspect or 1 / min_aspect
        self.log_aspect_ratio = (math.log(min_aspect), math.log(max_aspect))
        self.min_count = min_count
        self.max_count = max_count or min_count
        self.num_splits = num_splits
        self.cube = cube
        self.rand_color = mode == "rand"
        self.per_pixel = mode == "pixel"

    def _fill(self, shape, dtype, np_rng):
        if self.per_pixel:
            return np_rng.normal(size=shape).astype(dtype)
        if self.rand_color:
            return np_rng.normal(size=(1, 1, shape[-1])).astype(dtype) * np.ones(shape, dtype)
        return np.zeros(shape, dtype)

    def __call__(self, frames, rng, np_rng):
        if rng.random() > self.probability:
            return frames
        t, h, w, c = frames.shape
        area = h * w
        count = (self.min_count if self.min_count == self.max_count
                 else rng.randint(self.min_count, self.max_count))
        frames = frames.copy()
        for _ in range(count):
            for _ in range(10):
                target_area = rng.uniform(self.min_area, self.max_area) * area / count
                aspect_ratio = math.exp(rng.uniform(*self.log_aspect_ratio))
                eh = int(round(math.sqrt(target_area * aspect_ratio)))
                ew = int(round(math.sqrt(target_area / aspect_ratio)))
                if ew < w and eh < h:
                    top = rng.randint(0, h - eh)
                    left = rng.randint(0, w - ew)
                    if self.cube:
                        frames[:, top:top + eh, left:left + ew] = self._fill(
                            (eh, ew, c), frames.dtype, np_rng)
                    else:
                        for ti in range(t):
                            frames[ti, top:top + eh, left:left + ew] = self._fill(
                                (eh, ew, c), frames.dtype, np_rng)
                    break
        return frames
