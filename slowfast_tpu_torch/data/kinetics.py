"""Kinetics and synthetic video datasets (counterpart of
slowfast_tpu/data/kinetics.py:24-475, the classification paths, and
:509-607).

``Kinetics`` reads ``{train,val,test}.csv`` of ``path label`` lines (split
by ``DATA.PATH_LABEL_SEPARATOR``, paths under ``DATA.PATH_PREFIX``) and
decodes with cv2 (``decoder``). Train and val draw one random window and
crop; test expands each video into ``NUM_ENSEMBLE_VIEWS x
NUM_SPATIAL_CROPS`` clips, each its own temporal window and uniform crop.
Training samples the short-side jitter before decoding
(``DATA.DECODE_AT_SCALE``), jitters the frame rate
(``DATA.TRAIN_JITTER_FPS``) or takes relative scale and aspect crops, and
under ``AUG.ENABLE`` applies RandAugment, random erasing and ``NUM_SAMPLE``
repeated augmentations of one decoded clip. Under ``AUG.GEN_MASK_LOADER``
each clip (each repeat) also carries MaskFeat's mask, ``meta["mask"]``,
drawn after the clip (``gen_mask``). A short-cycle item crops at its
position's size. A file that fails to decode is
tried again, past half the retries with another random video (not in test).
Each item draws from its own generators (``utils.sample_rngs``) in the JAX
package's order, so seeding that package's ``random`` and ``np.random``
with the same number gives the same clip. Items are uint8 clips; the card
normalizes them. Under ``TPU.UINT8_PIPELINE False`` they are float
pathways normalized on the host, as the JAX package's
(slowfast_tpu/data/kinetics.py:182, :422-434, :557-565): the clip is
normalized before the spatial sampling, and no crop is fused into the
decode. ``ContrastiveModel``'s items are always normalized float
pathways, and in training its multi-view items (``_ssl_views``);
``DATA.SSL_COLOR_JITTER`` applies the SSL colour recipe to every train clip
before the spatial sampling. The decode backend is logged when a split is
built.
``DATA.FUSED_DECODE_CROP`` belongs to the FFmpeg decoder:
under cv2 the JAX package pre-crops nothing, and treats a frame that comes
out at the crop's size as cropped; so does the port.

``Syntheticvideo`` clips are the same bytes as the JAX package's:
``np.random.RandomState(index)`` frames (at a short-cycle position's crop
under multigrid), labels seeded by ``index //
num_clips`` so every view of a video has one label; an item with repeated
augmentation is ``NUM_SAMPLE`` copies of the clip. Its masks draw from
``utils.sample_rngs(RNG_SEED, epoch, index)``. Under
``DETECTION.ENABLE`` an item is the AVA item's contract: 1-5 boxes with
multi-hot labels, drawn from the same generator after the frames
(slowfast_tpu/data/kinetics.py:566-579).
"""

import math
import os

import numpy as np

from slowfast_tpu_torch.utils import logging as logging_utils
from slowfast_tpu_torch.utils.io import pathmgr

from . import decoder, transform, utils
from .imagenet import maskfeat_mask
from .rand_augment import rand_augment_transform
from .random_erasing import RandomErasing

logger = logging_utils.get_logger(__name__)


def _ssl(cfg):
    return cfg.MODEL.MODEL_NAME == "ContrastiveModel"


def _uint8_path(cfg):
    """Whether items are uint8 clips that the card normalizes (else float
    pathways normalized on the host)."""
    return cfg.TPU.UINT8_PIPELINE and not _ssl(cfg)


def gen_mask(cfg, rng, np_rng):
    """MaskFeat's loader mask at ``AUG.MASK_WINDOW_SIZE`` (t, h, w), float32
    (slowfast_tpu/data/kinetics.py:477, reference kinetics.py:470-504): a 2D
    block mask repeated over t (``AUG.MASK_TUBE``), whole frames
    (``AUG.MASK_FRAMES``, from ``np_rng``) or 3D blocks, about
    ``AUG.MASK_RATIO`` of the window; blocks draw from ``rng``. The 2D patch
    stem's is ``imagenet.maskfeat_mask``."""
    if cfg.MVIT.PATCH_2D:
        return maskfeat_mask(cfg, rng)
    win = cfg.AUG.MASK_WINDOW_SIZE
    ratio = cfg.AUG.MASK_RATIO
    max_block = cfg.AUG.MAX_MASK_PATCHES_PER_BLOCK
    if cfg.AUG.MASK_TUBE:
        m = transform.MaskingGenerator((win[1], win[2]), round(win[1] * win[2] * ratio),
                                       max_num_patches=max_block)(rng)
        return np.tile(m[None], (win[0], 1, 1)).astype(np.float32)
    if cfg.AUG.MASK_FRAMES:
        m = np.zeros(win, np.float32)
        m[np_rng.permutation(win[0])[:round(win[0] * ratio)]] = 1.0
        return m
    return transform.MaskingGenerator3D(win, round(np.prod(win) * ratio),
                                        max_num_patches=max_block)(rng).astype(np.float32)


def _mask_meta(cfg, rng, np_rng):
    return {"mask": gen_mask(cfg, rng, np_rng)} if cfg.AUG.GEN_MASK_LOADER else {}


class Kinetics(utils.SeededDataset):
    def __init__(self, cfg, mode, num_retries=100):
        if mode not in ("train", "val", "test"):
            raise ValueError(f"unknown split {mode!r}")
        self.cfg = cfg
        self.mode = mode
        self._num_retries = num_retries
        self._num_clips = (1 if mode in ("train", "val")
                           else cfg.TEST.NUM_ENSEMBLE_VIEWS * cfg.TEST.NUM_SPATIAL_CROPS)
        self._construct_loader()
        train_aug = cfg.AUG.ENABLE and mode == "train"
        self.randaug = None
        if train_aug and cfg.AUG.AA_TYPE:
            self.randaug = rand_augment_transform(cfg.AUG.AA_TYPE, dict(
                translate_const=int(cfg.DATA.TRAIN_CROP_SIZE * 0.45),
                img_mean=tuple(min(255, round(255 * m)) for m in cfg.DATA.MEAN),
                interpolation=cfg.AUG.INTERPOLATION))
        self.erasing = None
        if train_aug and cfg.AUG.RE_PROB > 0:
            self.erasing = RandomErasing(cfg.AUG.RE_PROB, mode=cfg.AUG.RE_MODE,
                                         max_count=cfg.AUG.RE_COUNT,
                                         num_splits=cfg.AUG.RE_COUNT)
        self.dummy_output = None
        logger.info("Kinetics %s: decoding video with %s (DATA.DECODING_BACKEND %s)", mode,
                    decoder.BACKEND, cfg.DATA.DECODING_BACKEND)

    def _construct_loader(self):
        """The csv's clips; a chunked train csv (``DATA.LOADER_CHUNK_SIZE``)
        keeps only its rows ``[SKIP_ROWS, SKIP_ROWS + LOADER_CHUNK_SIZE)``
        (slowfast_tpu/data/kinetics.py:59-72), the trainer moving
        ``SKIP_ROWS`` each epoch."""
        cfg = self.cfg
        path_to_file = os.path.join(cfg.DATA.PATH_TO_DATA_DIR, f"{self.mode}.csv")
        if not pathmgr.exists(path_to_file):
            raise FileNotFoundError(f"{path_to_file} not found")
        chunk = cfg.DATA.LOADER_CHUNK_SIZE if self.mode == "train" else 0
        skip = cfg.DATA.SKIP_ROWS if chunk > 0 else 0
        self._path_to_videos, self._labels, self._spatial_temporal_idx = [], [], []
        with pathmgr.open(path_to_file) as f:
            for row, line in enumerate(f):
                if chunk > 0 and not skip <= row < skip + chunk:
                    continue
                line = line.strip()
                if not line:
                    continue
                fields = line.split(cfg.DATA.PATH_LABEL_SEPARATOR)
                if len(fields) != 2:
                    raise ValueError(f"bad line {line!r} in {path_to_file}")
                path, label = fields
                for idx in range(self._num_clips):
                    self._path_to_videos.append(os.path.join(cfg.DATA.PATH_PREFIX, path))
                    self._labels.append(int(label))
                    self._spatial_temporal_idx.append(idx)
        if not self._path_to_videos:
            raise ValueError(f"Failed to load Kinetics split {self.mode} from {path_to_file}")
        logger.info("Constructed kinetics dataloader (size: %d) from %s",
                    len(self._path_to_videos), path_to_file)

    def __len__(self):
        return len(self._path_to_videos)

    @property
    def num_videos(self):
        """Number of clips, as the JAX dataset counts them."""
        return len(self._path_to_videos)

    def __getitem__(self, index):
        if self.dummy_output is not None:
            return self.dummy_output
        return super().__getitem__(index)

    def sample(self, index, rng, np_rng, short_cycle_idx=None):
        """Item ``index`` drawing from ``rng`` (``random.Random``) and
        ``np_rng`` (``np.random.RandomState``): ``([clip], label, index,
        time, {})``, or lists of ``NUM_SAMPLE`` of each under repeated
        augmentation. At short-cycle position 0 or 1 the crop is
        ``SHORT_CYCLE_FACTORS[i]·DEFAULT_S`` (slowfast_tpu/data/kinetics.py:107-130)."""
        cfg = self.cfg
        train = self.mode == "train"
        if self.mode in ("train", "val"):
            temporal_sample_index = spatial_sample_index = -1
            min_scale, max_scale = cfg.DATA.TRAIN_JITTER_SCALES
            crop_size = cfg.DATA.TRAIN_CROP_SIZE
            if short_cycle_idx in (0, 1):
                crop_size = int(round(cfg.MULTIGRID.SHORT_CYCLE_FACTORS[short_cycle_idx]
                                      * cfg.MULTIGRID.DEFAULT_S))
            if cfg.MULTIGRID.DEFAULT_S > 0:
                min_scale = int(round(float(min_scale) * crop_size / cfg.MULTIGRID.DEFAULT_S))
        else:
            crops = cfg.TEST.NUM_SPATIAL_CROPS
            temporal_sample_index = self._spatial_temporal_idx[index] // crops
            spatial_sample_index = self._spatial_temporal_idx[index] % crops if crops > 1 else 1
            min_scale = max_scale = crop_size = cfg.DATA.TEST_CROP_SIZE
        target_fps = cfg.DATA.TARGET_FPS
        if train and cfg.DATA.TRAIN_JITTER_FPS > 0.0:
            target_fps += rng.uniform(0.0, cfg.DATA.TRAIN_JITTER_FPS)
        decode_at_scale = 0
        if (train and cfg.DATA.DECODE_AT_SCALE and not cfg.DATA.TRAIN_JITTER_SCALES_RELATIVE
                and not (cfg.AUG.ENABLE and cfg.AUG.NUM_SAMPLE > 1) and not _ssl(cfg)):
            decode_at_scale = transform.sample_jitter_size(min_scale, max_scale, rng,
                                                           cfg.DATA.INV_UNIFORM_SAMPLE)
            min_scale = max_scale = decode_at_scale
        fused_crop = (decode_at_scale and cfg.DATA.FUSED_DECODE_CROP and cfg.TPU.UINT8_PIPELINE
                      and not cfg.AUG.ENABLE
                      and not cfg.DATA.SSL_COLOR_JITTER and not cfg.DATA.TRAIN_JITTER_MOTION_SHIFT)
        for i_try in range(self._num_retries):
            rng.random(), rng.random()  # the FFmpeg decoder's crop placement, unused here
            result = decoder.decode(
                self._path_to_videos[index], cfg.DATA.SAMPLING_RATE, cfg.DATA.NUM_FRAMES, rng,
                clip_idx=temporal_sample_index, num_clips=cfg.TEST.NUM_ENSEMBLE_VIEWS,
                target_fps=target_fps,
                max_spatial_scale=(cfg.DATA.DECODING_SHORT_SIZE if self.mode == "test"
                                   else decode_at_scale),
                use_offset=cfg.DATA.USE_OFFSET_SAMPLING)
            if result is not None:
                frames, _, _, time_frac = result
                break
            logger.warning("Failed to decode video idx %d, trial %d", index, i_try)
            if self.mode != "test" and i_try > self._num_retries // 2:
                index = rng.randint(0, len(self._path_to_videos) - 1)
        else:
            raise RuntimeError(f"Failed to fetch video after {self._num_retries} retries.")

        args = (spatial_sample_index, min_scale, max_scale, crop_size, rng, np_rng)
        if train and _ssl(cfg):
            return self._ssl_views(index, frames, time_frac, target_fps, args)
        label = self._labels[index]
        time_out = np.asarray([time_frac], np.float32)
        num_aug = cfg.AUG.NUM_SAMPLE if train and cfg.AUG.ENABLE else 1
        if num_aug > 1:
            clips, metas = [], []
            for _ in range(num_aug):  # each repeat's mask after its clip
                clips.append(self._process_clip(frames, *args))
                metas.append(_mask_meta(cfg, rng, np_rng))
            out = (clips, [label] * num_aug, [index] * num_aug, [time_out] * num_aug, metas)
        else:
            pre_cropped = bool(fused_crop) and frames.shape[1:3] == (crop_size, crop_size)
            clip = self._process_clip(frames, *args, pre_cropped=pre_cropped)
            out = (clip, label, index, time_out, _mask_meta(cfg, rng, np_rng))
        if cfg.DATA.DUMMY_LOAD and self.dummy_output is None:
            self.dummy_output = out
        return out

    def _ssl_views(self, index, frames, time_frac, target_fps, args):
        """The SSL item (slowfast_tpu/data/kinetics.py:219-321): ``n_t``
        temporal windows (``TRAIN_CROP_NUM_TEMPORAL``), the first the clip
        already decoded, each extra one decoded afresh at a random place,
        or all drawn jointly under ``CONTRASTIVE.DELTA_CLIPS_{MIN,MAX}``
        (``decoder.decode_views``, the first replacing the decoded clip);
        each window through ``augment_raw_frames`` under
        ``DATA.TIME_DIFF_PROB``, then ``n_s`` (``TRAIN_CROP_NUM_SPATIAL``)
        independent augmentations of it; at least two views. Returns
        ``(views, label, index, view times, {})``."""
        cfg = self.cfg
        rng = args[-2]
        path, rate, t = self._path_to_videos[index], cfg.DATA.SAMPLING_RATE, cfg.DATA.NUM_FRAMES
        n_t = max(cfg.DATA.TRAIN_CROP_NUM_TEMPORAL, 1)
        n_s = max(cfg.DATA.TRAIN_CROP_NUM_SPATIAL, 1)
        if n_t * n_s < 2:
            n_s = 2
        d_min, d_max = cfg.CONTRASTIVE.DELTA_CLIPS_MIN, cfg.CONTRASTIVE.DELTA_CLIPS_MAX
        windows = [(frames, time_frac)]
        if n_t > 1 and (d_min > -math.inf or d_max < math.inf):
            got = decoder.decode_views(path, rate, t, rng, n_t,
                                       num_clips=cfg.TEST.NUM_ENSEMBLE_VIEWS,
                                       target_fps=target_fps, min_delta=d_min, max_delta=d_max)
            if got is not None:
                windows = list(zip(got[0], got[3]))
        views, times = [], []
        for i in range(n_t):
            if i < len(windows):
                t_frames, t_time = windows[i]
            else:
                got = decoder.decode(path, rate, t, rng, clip_idx=-1,
                                     num_clips=cfg.TEST.NUM_ENSEMBLE_VIEWS,
                                     target_fps=target_fps,
                                     use_offset=cfg.DATA.USE_OFFSET_SAMPLING)
                t_frames, t_time = (got[0], got[3]) if got is not None else (frames, time_frac)
            if cfg.DATA.TIME_DIFF_PROB > 0:
                t_frames, _ = transform.augment_raw_frames(
                    t_frames, rng, time_diff_prob=cfg.DATA.TIME_DIFF_PROB)
            for _ in range(n_s):
                views.append(self._process_clip(t_frames, *args))
                times.append(t_time)
        return views, self._labels[index], index, np.asarray(times, np.float32), {}

    def _process_clip(self, frames, spatial_sample_index, min_scale, max_scale, crop_size,
                      rng, np_rng, pre_cropped=False):
        """The SSL colour recipe (train, ``DATA.SSL_COLOR_JITTER``, on [0, 1]
        floats, before everything else), RandAugment, the spatial sampling
        (or only the flip of a clip the decoder already cropped), random
        erasing; returns ``[clip]``, a uint8 clip, or off the uint8 path
        (``_uint8_path``) the normalized float pathways
        (slowfast_tpu/data/kinetics.py:387-475).
        A float clip goes back to uint8 by truncation, as the JAX package's
        ``astype(np.uint8)`` does (:433-434)."""
        cfg = self.cfg
        is_float255 = frames.dtype != np.uint8
        if self.mode == "train" and cfg.DATA.SSL_COLOR_JITTER:
            f = transform.color_jitter_video_ssl(
                frames.astype(np.float32) / 255.0, rng, bri_con_sat=cfg.DATA.SSL_COLOR_BRI_CON_SAT,
                hue=cfg.DATA.SSL_COLOR_HUE, p_convert_gray=cfg.DATA.COLOR_RND_GRAYSCALE,
                moco_v2_aug=cfg.DATA.SSL_MOCOV2_AUG)
            frames, is_float255 = np.clip(f, 0.0, 1.0) * 255.0, True
        if self.randaug is not None:
            if is_float255:
                frames, is_float255 = np.clip(frames, 0, 255).astype(np.uint8), False
            frames = self.randaug(frames, rng)
        uint8_path = _uint8_path(cfg)
        if not uint8_path:
            frames = utils.tensor_normalize(
                frames.astype(np.float32) / 255.0 if is_float255 else frames,
                cfg.DATA.MEAN, cfg.DATA.STD)
        elif frames.dtype != np.uint8:
            frames = np.clip(frames, 0, 255).astype(np.uint8)
        if pre_cropped:
            if cfg.DATA.RANDOM_FLIP:
                frames = transform.horizontal_flip(0.5, frames, np_rng)
        else:
            scl = cfg.DATA.TRAIN_JITTER_SCALES_RELATIVE
            asp = cfg.DATA.TRAIN_JITTER_ASPECT_RELATIVE
            frames = utils.spatial_sampling(
                frames, rng, np_rng, spatial_idx=spatial_sample_index, min_scale=min_scale,
                max_scale=max_scale, crop_size=crop_size,
                random_horizontal_flip=cfg.DATA.RANDOM_FLIP,
                inverse_uniform_sampling=cfg.DATA.INV_UNIFORM_SAMPLE,
                aspect_ratio=asp or None, scale=scl or None,
                motion_shift=cfg.DATA.TRAIN_JITTER_MOTION_SHIFT and self.mode == "train")
        if self.erasing is not None:
            frames = self.erasing(frames, rng, np_rng)
        if not uint8_path:
            return utils.pack_pathway_output(cfg, frames.astype(np.float32))
        return [np.ascontiguousarray(frames)]


class Syntheticvideo(utils.SeededDataset):
    def __init__(self, cfg, mode):
        if _ssl(cfg):
            # slowfast_tpu/data/kinetics.py:557-565 returns one pathway list
            # where ssl_collate expects views (ROADMAP Queue 3).
            raise NotImplementedError(
                "Syntheticvideo has no SSL views for ContrastiveModel: the JAX package's "
                "synthetic item is one pathway list, which its ssl_collate reads as one view "
                "of several pathways, so its SSL step cannot take it; pretrain on video files "
                "(TRAIN.DATASET kinetics)")
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

    def sample(self, index, rng, np_rng, short_cycle_idx=None):
        cfg = self.cfg
        crop = cfg.DATA.TRAIN_CROP_SIZE if self.mode in ("train", "val") else (
            cfg.DATA.TEST_CROP_SIZE)
        if short_cycle_idx in (0, 1) and cfg.MULTIGRID.DEFAULT_S > 0:
            crop = int(round(cfg.MULTIGRID.SHORT_CYCLE_FACTORS[short_cycle_idx]
                             * cfg.MULTIGRID.DEFAULT_S))
        # The frames and boxes from their own generator; the masks from the
        # sample's (``rng`` is the JAX package's ``random``).
        frame_rng = np.random.RandomState(index)
        frames = frame_rng.randint(0, 255, (cfg.DATA.NUM_FRAMES, crop, crop, 3), np.uint8)
        inputs = [frames]
        if not _uint8_path(cfg):
            inputs = utils.pack_pathway_output(
                cfg, utils.tensor_normalize(frames, cfg.DATA.MEAN, cfg.DATA.STD).astype(np.float32))
        if cfg.DETECTION.ENABLE:
            n = int(frame_rng.randint(1, 6))
            xy1 = frame_rng.rand(n, 2) * (crop / 2)
            wh = frame_rng.rand(n, 2) * (crop / 2) + 2.0
            boxes = np.concatenate([xy1, xy1 + wh], axis=1).astype(np.float32)
            labels = (frame_rng.rand(n, cfg.MODEL.NUM_CLASSES) < 0.2).astype(np.float32)
            meta = {"boxes": boxes, "ori_boxes": boxes / crop,
                    "metadata": [[index, 900 + index]] * n}
            return inputs, labels, index, np.zeros((1,)), meta
        label_rng = np.random.RandomState(index // self._num_clips)
        label = int(label_rng.randint(0, cfg.MODEL.NUM_CLASSES))
        num_aug = cfg.AUG.NUM_SAMPLE if self.mode == "train" and cfg.AUG.ENABLE else 1
        if num_aug > 1:
            return ([inputs] * num_aug, [label] * num_aug, [index] * num_aug,
                    [np.zeros((1,))] * num_aug,
                    [_mask_meta(cfg, rng, np_rng) for _ in range(num_aug)])
        return inputs, label, index, np.zeros((1,)), _mask_meta(cfg, rng, np_rng)
