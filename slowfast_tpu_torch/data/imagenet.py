"""ImageNet (counterpart of slowfast_tpu/data/imagenet.py:24-145; reference
slowfast/datasets/imagenet.py).

The split's images come from the directory tree ``PATH_TO_DATA_DIR/{train,
val}/<class>/<image>`` (classes numbered in sorted order, images sorted), or
from ``PATH_TO_PRELOAD_IMDB/{split}.json``, a list of ``{"im_path",
"class"}``; the test split reads val. An image is read with cv2 and turned
to RGB. Train: RandAugment on the uint8 image (``AUG.AA_TYPE``), normalize,
an Inception-style ``random_resized_crop`` (scale 0.08-1, aspect 3/4-4/3)
to ``TRAIN_CROP_SIZE``, a flip, random erasing (``AUG.RE_PROB``). Val and
test: normalize, the short side scaled to ``TEST_CROP_SIZE /
IN_VAL_CROP_RATIO``, the centre ``TEST_CROP_SIZE`` square. An item is the
model's pathway list of one float32 frame (T = 1), and under
``AUG.GEN_MASK_LOADER`` MaskFeat's 2D mask (``maskfeat_mask``) in
``meta["mask"]``. Each item draws from its own generators
(``utils.sample_rngs``) in the JAX package's order, so seeding that
package's ``random`` and ``np.random`` with the same number gives the same
item.
"""

import json
import os

import numpy as np

from slowfast_tpu_torch.models.mvit import maskfeat_feature_size
from slowfast_tpu_torch.utils import logging as logging_utils
from slowfast_tpu_torch.utils.io import pathmgr
from . import transform, utils
from .rand_augment import rand_augment_transform
from .random_erasing import RandomErasing

logger = logging_utils.get_logger(__name__)


def maskfeat_mask(cfg, rng):
    """MaskFeat's 2D mask at the deepest ``MASK.PRETRAIN_DEPTH`` feature grid
    (slowfast_tpu/data/imagenet.py:131, reference imagenet.py:170-206):
    ``round(h·w·MASK_RATIO)`` cells in blocks of at least a fifth of that,
    float32; blocks draw from ``rng``."""
    h = maskfeat_feature_size(cfg)
    num = round(h * h * cfg.AUG.MASK_RATIO)
    return transform.MaskingGenerator(
        (h, h), num, min_num_patches=max(num // 5, 1),
        max_num_patches=cfg.AUG.MAX_MASK_PATCHES_PER_BLOCK)(rng).astype(np.float32)


class Imagenet(utils.SeededDataset):
    def __init__(self, cfg, mode):
        if mode not in ("train", "val", "test"):
            raise ValueError(f"unknown split {mode!r}")
        self.cfg = cfg
        self.mode = "val" if mode == "test" else mode
        self._construct_imdb()
        train_aug = cfg.AUG.ENABLE and mode == "train"
        self.randaug = None
        if train_aug and cfg.AUG.AA_TYPE:
            self.randaug = rand_augment_transform(cfg.AUG.AA_TYPE, dict(
                translate_const=int(cfg.DATA.TRAIN_CROP_SIZE * 0.45),
                img_mean=tuple(min(255, round(255 * m)) for m in cfg.DATA.MEAN),
                interpolation=cfg.AUG.INTERPOLATION))
        self.erasing = None
        if train_aug and cfg.AUG.RE_PROB > 0:
            self.erasing = RandomErasing(cfg.AUG.RE_PROB, mode=cfg.AUG.RE_MODE)

    def _construct_imdb(self):
        cfg = self.cfg
        if cfg.DATA.PATH_TO_PRELOAD_IMDB:
            path = os.path.join(cfg.DATA.PATH_TO_PRELOAD_IMDB, f"{self.mode}.json")
            with pathmgr.open(path) as f:
                self._imdb = json.load(f)
            logger.info("Loaded imagenet imdb (size: %d) from %s", len(self._imdb), path)
            return
        split_path = os.path.join(cfg.DATA.PATH_TO_DATA_DIR, self.mode)
        if not os.path.isdir(split_path):
            raise FileNotFoundError(f"{split_path} not found")
        classes = sorted(d for d in os.listdir(split_path)
                         if os.path.isdir(os.path.join(split_path, d)))
        self._imdb = [{"im_path": os.path.join(split_path, c, name), "class": i}
                      for i, c in enumerate(classes)
                      for name in sorted(os.listdir(os.path.join(split_path, c)))]
        logger.info("Constructed imagenet imdb (size: %d)", len(self._imdb))

    def __len__(self):
        return len(self._imdb)

    @property
    def num_videos(self):
        return len(self._imdb)

    def sample(self, index, rng, np_rng):
        import cv2

        cfg = self.cfg
        entry = self._imdb[index]
        img = cv2.imread(entry["im_path"])
        if img is None:
            raise RuntimeError(f"Failed to read image {entry['im_path']}")
        frames = img[:, :, ::-1][None]  # (1, H, W, C), RGB
        crop = cfg.DATA.TRAIN_CROP_SIZE
        meta = {}
        if self.mode == "train":
            if self.randaug is not None:
                frames = self.randaug(np.ascontiguousarray(frames, np.uint8), rng)
            frames = utils.tensor_normalize(frames, cfg.DATA.MEAN, cfg.DATA.STD)
            frames = transform.random_resized_crop(frames, crop, crop, rng, scale=(0.08, 1.0),
                                                   ratio=(3 / 4, 4 / 3))
            frames = transform.horizontal_flip(0.5, frames, np_rng)
            if self.erasing is not None:
                frames = self.erasing(frames, rng, np_rng)
            if cfg.AUG.GEN_MASK_LOADER:
                meta["mask"] = maskfeat_mask(cfg, rng)
        else:
            test_crop = cfg.DATA.TEST_CROP_SIZE
            scale = int(round(test_crop / cfg.DATA.IN_VAL_CROP_RATIO))
            frames = utils.tensor_normalize(frames, cfg.DATA.MEAN, cfg.DATA.STD)
            frames = transform.random_short_side_scale_jitter(frames, scale, scale, np_rng)
            frames = transform.uniform_crop(frames, test_crop, 1)
        frames = np.ascontiguousarray(frames, np.float32)
        # MaskMViT takes one pathway; the JAX package's pack_pathway_output
        # does not list its arch and raises (ROADMAP Queue 3).
        inputs = [frames] if cfg.MODEL.ARCH == "maskmvit" else utils.pack_pathway_output(
            cfg, frames)
        return inputs, entry["class"], index, np.zeros((1,)), meta
