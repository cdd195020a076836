"""Test-time meters (counterpart of slowfast_tpu/utils/meters.py:59-80 and
:292-395, reference slowfast/utils/meters.py).

Host-side bookkeeping: multi-view prediction ensembling into per-video
scores and the final top-k accuracies.
"""

import time

import numpy as np

from .logging import get_logger, log_json_stats

logger = get_logger(__name__)


class Timer:
    def __init__(self):
        self.reset()

    def reset(self):
        self._start = time.perf_counter()
        self._paused_at = None

    def pause(self):
        if self._paused_at is None:
            self._paused_at = time.perf_counter()

    def seconds(self):
        end = self._paused_at if self._paused_at is not None else time.perf_counter()
        return end - self._start


class TestMeter:
    """Multi-view test-time ensembling (reference meters.py:239-407).

    Accumulates per-clip predictions into per-video scores keyed by
    clip_id // num_clips, with sum or max ensembling, then finalizes
    top-1/top-5 accuracy.
    """

    def __init__(self, num_videos, num_clips, num_cls, ensemble_method="sum",
                 output_dir=None):
        if ensemble_method not in ("sum", "max"):
            raise ValueError(f"unknown ensemble method {ensemble_method!r}")
        self.iter_timer = Timer()
        self.num_clips = num_clips
        self.ensemble_method = ensemble_method
        self.video_preds = np.zeros((num_videos, num_cls), np.float64)
        self.video_labels = np.zeros((num_videos,), np.int64)
        self.clip_count = np.zeros((num_videos,), np.int64)
        self.stats = {}
        self.output_dir = output_dir

    def update_stats(self, preds, labels, clip_ids):
        preds = np.asarray(preds)
        labels = np.asarray(labels)
        clip_ids = np.asarray(clip_ids)
        for ind in range(preds.shape[0]):
            vid_id = int(clip_ids[ind]) // self.num_clips
            if self.clip_count[vid_id] > 0 and self.video_labels[vid_id] != labels[ind]:
                raise ValueError(f"label consistency check failed for video {vid_id}")
            self.video_labels[vid_id] = labels[ind]
            if self.ensemble_method == "sum":
                self.video_preds[vid_id] += preds[ind]
            else:
                self.video_preds[vid_id] = np.maximum(self.video_preds[vid_id], preds[ind])
            self.clip_count[vid_id] += 1

    def iter_tic(self):
        self.iter_timer.reset()

    def iter_toc(self):
        self.iter_timer.pause()

    def log_iter_stats(self, cur_iter):
        stats = {
            "_type": "test_iter",
            "cur_iter": f"{cur_iter + 1}",
            "time_diff": self.iter_timer.seconds(),
        }
        log_json_stats(stats, self.output_dir)

    def finalize_metrics(self, ks=(1, 5)):
        if not np.all(self.clip_count == self.num_clips):
            mismatch = np.argwhere(self.clip_count != self.num_clips).flatten()
            logger.warning(
                "clip count %s ~= num clips %s",
                ", ".join(f"{i}: {self.clip_count[i]}" for i in mismatch[:10]),
                self.num_clips,
            )
        self.stats = {"_type": "test_final"}
        correct = topks_correct_np(self.video_preds, self.video_labels, ks)
        for k, c in zip(ks, correct):
            self.stats[f"top{k}_acc"] = f"{c / self.video_preds.shape[0] * 100.0:.2f}"
        log_json_stats(self.stats, self.output_dir)
        return self.stats


def topks_correct_np(preds, labels, ks):
    """Top-k correct counts on host arrays, ties broken as the JAX meter's
    ``np.argsort(-preds)`` breaks them."""
    idx = np.argsort(-preds, axis=1)[:, : max(ks)]
    correct = idx == labels[:, None]
    return [int(correct[:, :k].sum()) for k in ks]
