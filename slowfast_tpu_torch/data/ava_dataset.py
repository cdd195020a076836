"""The AVA dataset on JPEG frames (counterpart of
slowfast_tpu/data/ava_dataset.py, both ``AVA.IMG_PROC_BACKEND`` paths;
reference slowfast/datasets/ava_dataset.py).

Each item is one keyframe: the clip of ``NUM_FRAMES`` frames at
``SAMPLING_RATE`` around it, read with cv2, with every box of the keyframe.
Train scales the short side by a jitter in ``TRAIN_JITTER_SCALES``, crops a
random ``TRAIN_CROP_SIZE`` square and flips; val and test scale the short
side to ``TEST_CROP_SIZE`` and take the centre square (test may force the
flip). Train may add color and PCA jitter. The clip is normalized on the
host and returned as float pathways, with the boxes in pixels of the crop,
the multi-hot labels of the 80 classes and, per box, the normalized
original box and ``[video_idx, sec]``. Each item draws from the generators
of ``(RNG_SEED, epoch, index)`` in the JAX package's order (jitter size,
crop y, crop x, flip, then the color draws), so seeding its ``np.random``
with the same number gives the same item.

``AVA.IMG_PROC_BACKEND pytorch`` is the reference's tensor path, which the
JAX package runs in numpy (``_images_and_boxes_preprocessing``,
slowfast_tpu/data/ava_dataset.py:134): the clip stays in the decoded BGR
order throughout, is scaled to [0, 1] first, train always flips at p 0.5
(``DATA.RANDOM_FLIP`` is not read), val scales and centre-crops, test only
scales the short side, the color jitters run on the channel-reversed view,
the normalization indexes the BGR channels, and the clip goes to RGB last
unless ``AVA.BGR``.
"""

import numpy as np

from slowfast_tpu_torch.utils import logging as logging_utils
from . import ava_helper, cv2_transform
from . import transform as T
from . import utils as data_utils

logger = logging_utils.get_logger(__name__)


class Ava(data_utils.SeededDataset):
    def __init__(self, cfg, split):
        self.cfg = cfg
        self._split = split
        self._sample_rate = cfg.DATA.SAMPLING_RATE
        self._seq_len = cfg.DATA.NUM_FRAMES * self._sample_rate
        self._num_classes = cfg.MODEL.NUM_CLASSES
        if split == "train":
            self._crop_size = cfg.DATA.TRAIN_CROP_SIZE
            self._jitter_min_scale, self._jitter_max_scale = cfg.DATA.TRAIN_JITTER_SCALES
        else:
            self._crop_size = cfg.DATA.TEST_CROP_SIZE
        self._load_data(cfg)

    def _load_data(self, cfg):
        self._image_paths, self._video_idx_to_name = ava_helper.load_image_lists(
            cfg, is_train=self._split == "train")
        boxes_and_labels = ava_helper.load_boxes_and_labels(cfg, mode=self._split)
        boxes_and_labels = [boxes_and_labels.get(name, {}) for name in self._video_idx_to_name]
        self._keyframe_indices, self._keyframe_boxes_and_labels = (
            ava_helper.get_keyframe_data(boxes_and_labels))
        num_boxes = ava_helper.get_num_boxes_used(self._keyframe_indices,
                                                  self._keyframe_boxes_and_labels)
        logger.info("=== AVA dataset summary (%s) ===", self._split)
        logger.info("Number of videos: %d", len(self._image_paths))
        logger.info("Number of keyframes: %d", len(self))
        logger.info("Number of boxes: %d", num_boxes)

    def __len__(self):
        return len(self._keyframe_indices)

    @property
    def num_videos(self):
        return len(self)

    def _images_and_boxes_preprocessing_cv2(self, imgs, boxes, np_rng):
        """Scale, crop and flip the RGB float images with their boxes, then
        scale to [0, 1], jitter the colors (train), normalize and reorder to
        BGR under ``AVA.BGR`` (slowfast_tpu/data/ava_dataset.py:70-137);
        returns the (T, H, W, C) clip and the boxes clipped to it."""
        cfg = self.cfg
        height, width = imgs[0].shape[0], imgs[0].shape[1]
        boxes[:, [0, 2]] *= width
        boxes[:, [1, 3]] *= height
        boxes = [cv2_transform.clip_boxes_to_image(boxes, height, width)]
        if self._split == "train":
            imgs, boxes = cv2_transform.random_short_side_scale_jitter_list(
                imgs, self._jitter_min_scale, self._jitter_max_scale, np_rng, boxes=boxes)
            imgs, boxes = cv2_transform.random_crop_list(imgs, self._crop_size, np_rng,
                                                         boxes=boxes)
            if cfg.DATA.RANDOM_FLIP:
                imgs, boxes = cv2_transform.horizontal_flip_list(0.5, imgs, np_rng, boxes=boxes)
        else:
            imgs = [cv2_transform.scale(self._crop_size, img) for img in imgs]
            boxes = [cv2_transform.scale_boxes(self._crop_size, boxes[0], height, width)]
            imgs, boxes = cv2_transform.spatial_shift_crop_list(self._crop_size, imgs, 1,
                                                                boxes=boxes)
            if cfg.AVA.TEST_FORCE_FLIP:
                imgs, boxes = cv2_transform.horizontal_flip_list(1.0, imgs, np_rng, boxes=boxes)

        imgs = [img.astype(np.float32) / 255.0 for img in imgs]
        if self._split == "train" and cfg.AVA.TRAIN_USE_COLOR_AUGMENTATION:
            if not cfg.AVA.TRAIN_PCA_JITTER_ONLY:
                imgs = list(T.color_jitter(np.stack(imgs), np_rng, 0.4, 0.4, 0.4))
            imgs = [cv2_transform.PCA_jitter(img, 0.1, cfg.DATA.TRAIN_PCA_EIGVAL,
                                             cfg.DATA.TRAIN_PCA_EIGVEC, np_rng)
                    for img in imgs]
        imgs = [cv2_transform.color_normalization(img, cfg.DATA.MEAN, cfg.DATA.STD)
                for img in imgs]
        if cfg.AVA.BGR:
            imgs = [img[:, :, ::-1] for img in imgs]
        clip = np.stack(imgs)
        return clip, cv2_transform.clip_boxes_to_image(boxes[0], clip.shape[1], clip.shape[2])

    def _images_and_boxes_preprocessing(self, imgs, boxes, np_rng):
        """The ``pytorch`` backend on the raw ``(T, H, W, C)`` uint8 BGR stack
        (slowfast_tpu/data/ava_dataset.py:134-206); returns the clip and the
        boxes clipped to the crop."""
        cfg = self.cfg
        imgs = imgs.astype(np.float32) / 255.0
        height, width = imgs.shape[1], imgs.shape[2]
        boxes = boxes.copy()
        boxes[:, [0, 2]] *= width
        boxes[:, [1, 3]] *= height
        boxes = T.clip_boxes_to_image(boxes, height, width)
        if self._split == "train":
            imgs, boxes = T.random_short_side_scale_jitter(
                imgs, self._jitter_min_scale, self._jitter_max_scale, np_rng, boxes=boxes)
            imgs, boxes = T.random_crop(imgs, self._crop_size, np_rng, boxes=boxes)
            imgs, boxes = T.horizontal_flip(0.5, imgs, np_rng, boxes=boxes)
        else:
            imgs, boxes = T.random_short_side_scale_jitter(
                imgs, self._crop_size, self._crop_size, np_rng, boxes=boxes)
            if self._split == "val":
                imgs, boxes = T.uniform_crop_with_boxes(imgs, self._crop_size, 1, boxes)
            if cfg.AVA.TEST_FORCE_FLIP:
                imgs, boxes = T.horizontal_flip(1.0, imgs, np_rng, boxes=boxes)
        if self._split == "train" and cfg.AVA.TRAIN_USE_COLOR_AUGMENTATION:
            if not cfg.AVA.TRAIN_PCA_JITTER_ONLY:
                imgs = T.color_jitter(imgs[..., ::-1], np_rng, 0.4, 0.4, 0.4)[..., ::-1]
            imgs = T.lighting_jitter(imgs[..., ::-1], 0.1,
                                     np.array(cfg.DATA.TRAIN_PCA_EIGVAL, np.float32),
                                     np.array(cfg.DATA.TRAIN_PCA_EIGVEC, np.float32),
                                     np_rng)[..., ::-1]
        imgs = T.color_normalization(imgs, cfg.DATA.MEAN, cfg.DATA.STD)
        if not cfg.AVA.BGR:
            imgs = imgs[..., ::-1]
        boxes = T.clip_boxes_to_image(boxes, self._crop_size, self._crop_size)
        return np.ascontiguousarray(imgs), boxes

    def sample(self, index, rng, np_rng):
        """Keyframe ``index``: ``(pathways, labels (N, num_classes) int32,
        index, time, {"boxes", "ori_boxes", "metadata"})``."""
        video_idx, sec_idx, sec, center_idx = self._keyframe_indices[index]
        seq = data_utils.get_sequence(center_idx, self._seq_len // 2, self._sample_rate,
                                      num_frames=len(self._image_paths[video_idx]))
        clip_label_list = self._keyframe_boxes_and_labels[video_idx][sec_idx]
        boxes = np.array([box for box, _ in clip_label_list], np.float32)
        ori_boxes = boxes.copy()
        imgs = data_utils.retry_load_images([self._image_paths[video_idx][f] for f in seq])
        if self.cfg.AVA.IMG_PROC_BACKEND == "pytorch":
            clip, boxes = self._images_and_boxes_preprocessing(np.stack(imgs), boxes, np_rng)
        else:
            imgs = [img[:, :, ::-1].astype(np.float32) for img in imgs]  # BGR -> RGB
            clip, boxes = self._images_and_boxes_preprocessing_cv2(imgs, boxes, np_rng)
        label_arrs = np.zeros((len(clip_label_list), self._num_classes), np.int32)
        for i, (_, box_labels) in enumerate(clip_label_list):
            for label in box_labels:
                if label == -1:
                    continue
                if not 1 <= label <= self._num_classes:
                    raise ValueError(f"AVA label {label} outside 1..{self._num_classes}")
                label_arrs[i][label - 1] = 1
        meta = {"boxes": boxes, "ori_boxes": ori_boxes,
                "metadata": [[video_idx, sec]] * len(boxes)}
        return (data_utils.pack_pathway_output(self.cfg, clip), label_arrs, index,
                np.zeros((1,)), meta)
