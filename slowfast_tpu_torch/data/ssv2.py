"""Something-Something V2 (counterpart of slowfast_tpu/data/ssv2.py; reference
slowfast/datasets/ssv2.py).

``something-something-v2-labels.json`` maps each template to its class;
``something-something-v2-{train,validation}.json`` give each video's
template (brackets dropped); ``{train,val}.csv`` list its frames, as
Charades' do. A clip takes one frame from each of ``NUM_FRAMES`` equal
segments of the video (a random one in training, the middle one otherwise)
and is spatially sampled as Kinetics clips are. Videos without frames are
left out. Items are uint8 clips; the card normalizes them.
"""

import json
import os

import numpy as np

from slowfast_tpu_torch.utils import logging as logging_utils
from slowfast_tpu_torch.utils.io import pathmgr
from . import utils
from .charades import clip_sampling, load_clip, read_frame_lists

logger = logging_utils.get_logger(__name__)


class Ssv2(utils.SeededDataset):
    def __init__(self, cfg, mode):
        if mode not in ("train", "val", "test"):
            raise ValueError(f"unknown split {mode!r}")
        self.cfg = cfg
        self.mode = mode
        num_clips = (1 if mode in ("train", "val")
                     else cfg.TEST.NUM_ENSEMBLE_VIEWS * cfg.TEST.NUM_SPATIAL_CROPS)
        root = cfg.DATA.PATH_TO_DATA_DIR
        with pathmgr.open(os.path.join(root, "something-something-v2-labels.json")) as f:
            label_dict = json.load(f)
        split = "train" if mode == "train" else "validation"
        with pathmgr.open(os.path.join(root, f"something-something-v2-{split}.json")) as f:
            videos = json.load(f)
        frame_lists, _ = read_frame_lists(
            os.path.join(root, f"{'train' if mode == 'train' else 'val'}.csv"),
            cfg.DATA.PATH_PREFIX)
        self._video_names, self._labels, self._frame_lists = [], [], []
        self._spatial_temporal_idx = []
        for video in videos:
            name = video["id"]
            label = int(label_dict[video["template"].replace("[", "").replace("]", "")])
            if name not in frame_lists:
                continue
            for idx in range(num_clips):
                self._video_names.append(name)
                self._labels.append(label)
                self._frame_lists.append(frame_lists[name])
                self._spatial_temporal_idx.append(idx)
        logger.info("Something-Something V2 dataloader constructed (size: %d)",
                    len(self._video_names))

    def __len__(self):
        return len(self._video_names)

    @property
    def num_videos(self):
        return len(self._video_names)

    def sample(self, index, rng, np_rng):
        """Item ``index``: ``([clip], label, index, time, {})``."""
        num_frames = self.cfg.DATA.NUM_FRAMES
        seg_size = float(len(self._frame_lists[index]) - 1) / num_frames
        seq = []
        for i in range(num_frames):
            start = int(np.round(seg_size * i))
            end = int(np.round(seg_size * (i + 1)))
            seq.append(rng.randint(start, end) if self.mode == "train" else (start + end) // 2)
        spatial = clip_sampling(self.cfg, self.mode, self._spatial_temporal_idx[index])
        frames = load_clip(self.cfg, [self._frame_lists[index][f] for f in seq], spatial,
                           rng, np_rng)
        return [frames], self._labels[index], index, np.zeros((1,)), {}
