"""Meters (counterpart of slowfast_tpu/utils/meters.py:59-415; reference
slowfast/utils/meters.py).

Host-side bookkeeping on numbers the step already reduced: windowed train
and val statistics, epoch summaries and the loss-explosion guard, logged
as ``json_stats`` with the JAX meters' keys (``train_iter``,
``train_epoch``, ``val_iter``, ``val_epoch``); multi-view prediction
ensembling into per-video scores and the final top-k accuracies, or for
multi-label data the mean average precision (``get_map``, numpy only); and
``AVAMeter``, which gathers the detections of an AVA epoch and scores them
with ``ava_eval`` (mAP at IoU 0.5). Over several ranks the numbers come
in already reduced (``engine/trainer.py``, ``engine/tester.py``);
``AVAMeter`` gathers every rank's detections before it scores them, and
only the master logs.
"""

import datetime
import os
import time
from collections import deque

import numpy as np
import torch

from . import ava_eval
from .distributed import all_gather_unaligned
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


def gpu_mem_usage():
    """Device memory in use, in GiB (0 without a card)."""
    if not torch.cuda.is_available():
        return 0.0
    return torch.cuda.memory_allocated() / 1024 ** 3


class ScalarMeter:
    """Windowed scalar tracker (reference meters.py:409-462)."""

    def __init__(self, window_size):
        self.deque = deque(maxlen=window_size)
        self.total = 0.0
        self.count = 0

    def reset(self):
        self.deque.clear()
        self.total = 0.0
        self.count = 0

    def add_value(self, value):
        self.deque.append(value)
        self.count += 1
        self.total += value

    def get_win_median(self):
        return float(np.median(self.deque)) if self.deque else 0.0


class TrainMeter:
    """Per-iteration and per-epoch training stats (reference meters.py:499-678)."""

    def __init__(self, epoch_iters, cfg):
        self._cfg = cfg
        self.epoch_iters = epoch_iters
        self.MAX_EPOCH = cfg.SOLVER.MAX_EPOCH * epoch_iters
        self.iter_timer = Timer()
        self.data_timer = Timer()
        self.net_timer = Timer()
        self.loss = ScalarMeter(cfg.LOG_PERIOD)
        self.mb_top1_err = ScalarMeter(cfg.LOG_PERIOD)
        self.mb_top5_err = ScalarMeter(cfg.LOG_PERIOD)
        self.output_dir = cfg.OUTPUT_DIR
        self.reset()

    def reset(self):
        self.loss.reset()
        self.loss_total = 0.0
        self.lr = None
        self.mb_top1_err.reset()
        self.mb_top5_err.reset()
        self.num_top1_mis = 0
        self.num_top5_mis = 0
        self.num_samples = 0

    def iter_tic(self):
        self.iter_timer.reset()
        self.data_timer.reset()

    def iter_toc(self):
        self.iter_timer.pause()
        self.net_timer.pause()

    def data_toc(self):
        self.data_timer.pause()
        self.net_timer.reset()

    def update_stats(self, top1_err, top5_err, loss, lr, mb_size):
        self.loss.add_value(loss)
        self.lr = lr
        self.loss_total += loss * mb_size
        self.num_samples += mb_size
        if top1_err is not None:  # None for multi-label steps
            self.mb_top1_err.add_value(top1_err)
            self.mb_top5_err.add_value(top5_err)
            self.num_top1_mis += top1_err * mb_size
            self.num_top5_mis += top5_err * mb_size
        # Loss-explosion guard (reference meters.py:594-606).
        kill = self._cfg.TRAIN.KILL_LOSS_EXPLOSION_FACTOR
        if kill > 0.0 and len(self.loss.deque) > 5:
            prev = list(self.loss.deque)[-6:-1]
            if loss > kill * float(np.mean(prev)):
                raise RuntimeError(
                    f"ERROR: Got Loss explosion of {loss} {datetime.datetime.now()}")

    def log_iter_stats(self, cur_epoch, cur_iter):
        if (cur_iter + 1) % self._cfg.LOG_PERIOD != 0:
            return
        eta_sec = self.iter_timer.seconds() * (
            self.MAX_EPOCH - (cur_epoch * self.epoch_iters + cur_iter + 1))
        stats = {
            "_type": "train_iter",
            "epoch": f"{cur_epoch + 1}/{self._cfg.SOLVER.MAX_EPOCH}",
            "iter": f"{cur_iter + 1}/{self.epoch_iters}",
            "dt": self.iter_timer.seconds(),
            "dt_data": self.data_timer.seconds(),
            "dt_net": self.net_timer.seconds(),
            "eta": str(datetime.timedelta(seconds=int(eta_sec))),
            "loss": self.loss.get_win_median(),
            "lr": self.lr,
            "gpu_mem": f"{gpu_mem_usage():.2f}G",
        }
        if self.mb_top1_err.count > 0:
            stats["top1_err"] = self.mb_top1_err.get_win_median()
            stats["top5_err"] = self.mb_top5_err.get_win_median()
        log_json_stats(stats, self.output_dir)

    def log_epoch_stats(self, cur_epoch):
        stats = {
            "_type": "train_epoch",
            "epoch": f"{cur_epoch + 1}/{self._cfg.SOLVER.MAX_EPOCH}",
            "dt": self.iter_timer.seconds(),
            "loss": self.loss_total / max(self.num_samples, 1),
            "lr": self.lr,
            "gpu_mem": f"{gpu_mem_usage():.2f}G",
        }
        if self.num_samples > 0 and self.num_top1_mis > 0:
            stats["top1_err"] = self.num_top1_mis / self.num_samples
            stats["top5_err"] = self.num_top5_mis / self.num_samples
        log_json_stats(stats, self.output_dir)


class ValMeter:
    """Validation stats and the best errors so far, or for multi-label data
    (``DATA.MULTI_LABEL``) the mAP of the epoch's predictions (reference
    meters.py:679-822)."""

    def __init__(self, max_iter, cfg):
        self._cfg = cfg
        self.max_iter = max_iter
        self.iter_timer = Timer()
        self.mb_top1_err = ScalarMeter(cfg.LOG_PERIOD)
        self.mb_top5_err = ScalarMeter(cfg.LOG_PERIOD)
        self.min_top1_err = 100.0
        self.min_top5_err = 100.0
        self.output_dir = cfg.OUTPUT_DIR
        self.reset()

    def reset(self):
        self.iter_timer.reset()
        self.mb_top1_err.reset()
        self.mb_top5_err.reset()
        self.num_top1_mis = 0
        self.num_top5_mis = 0
        self.num_samples = 0
        self.all_preds = []
        self.all_labels = []

    def iter_tic(self):
        self.iter_timer.reset()

    def iter_toc(self):
        self.iter_timer.pause()

    def update_predictions(self, preds, labels):
        self.all_preds.append(preds)
        self.all_labels.append(labels)

    def update_stats(self, top1_err, top5_err, mb_size):
        self.mb_top1_err.add_value(top1_err)
        self.mb_top5_err.add_value(top5_err)
        self.num_top1_mis += top1_err * mb_size
        self.num_top5_mis += top5_err * mb_size
        self.num_samples += mb_size

    def log_iter_stats(self, cur_epoch, cur_iter):
        if (cur_iter + 1) % self._cfg.LOG_PERIOD != 0:
            return
        stats = {
            "_type": "val_iter",
            "epoch": f"{cur_epoch + 1}/{self._cfg.SOLVER.MAX_EPOCH}",
            "iter": f"{cur_iter + 1}/{self.max_iter}",
            "time_diff": self.iter_timer.seconds(),
            "top1_err": self.mb_top1_err.get_win_median(),
            "top5_err": self.mb_top5_err.get_win_median(),
        }
        log_json_stats(stats, self.output_dir)

    def log_epoch_stats(self, cur_epoch):
        stats = {
            "_type": "val_epoch",
            "epoch": f"{cur_epoch + 1}/{self._cfg.SOLVER.MAX_EPOCH}",
            "time_diff": self.iter_timer.seconds(),
            "gpu_mem": f"{gpu_mem_usage():.2f}G",
        }
        if self._cfg.DATA.MULTI_LABEL:
            stats["map"] = get_map(np.concatenate(self.all_preds),
                                   np.concatenate(self.all_labels))
        else:
            top1_err = self.num_top1_mis / max(self.num_samples, 1)
            top5_err = self.num_top5_mis / max(self.num_samples, 1)
            self.min_top1_err = min(self.min_top1_err, top1_err)
            self.min_top5_err = min(self.min_top5_err, top5_err)
            stats.update(top1_err=top1_err, top5_err=top5_err,
                         min_top1_err=self.min_top1_err, min_top5_err=self.min_top5_err)
        log_json_stats(stats, self.output_dir)
        return stats


class EpochTimer:
    """Epoch durations (reference meters.py:850+)."""

    def __init__(self):
        self.timer = Timer()
        self.epoch_times = []

    def epoch_tic(self):
        self.timer.reset()

    def epoch_toc(self):
        self.timer.pause()
        self.epoch_times.append(self.timer.seconds())

    def last_epoch_time(self):
        return self.epoch_times[-1]

    def avg_epoch_time(self):
        return float(np.mean(self.epoch_times))


def gather_ragged_across_hosts(x):
    """Every rank's rows of a ragged array (AVA's detections), in rank
    order (slowfast_tpu/utils/meters.py:21): with one process, ``x``."""
    return all_gather_unaligned(x)


class AVAMeter:
    """Detection meter (slowfast_tpu/utils/meters.py:443; reference
    meters.py:46-238): in train the loss and LR per iteration; in val and
    test every real box's predictions, original box and ``[video_idx,
    sec]``, scored at the epoch's end against the GT of ``AVA.ANNOTATION_DIR``
    (val: the seconds divisible by 4, unless ``AVA.FULL_TEST_ON_VAL``; test:
    all of it). Without a label map there is nothing to score: the mAP is 0."""

    def __init__(self, overall_iters, cfg, mode):
        self.cfg = cfg
        self.mode = mode
        self.overall_iters = overall_iters
        self.lr = None
        self.loss = ScalarMeter(cfg.LOG_PERIOD)
        self.iter_timer = Timer()
        self.all_preds, self.all_ori_boxes, self.all_metadata = [], [], []
        self.excluded_keys = self.categories = self.class_whitelist = None
        self.video_idx_to_name = None
        self.groundtruth = None
        self.full_map = 0.0
        self.output_dir = cfg.OUTPUT_DIR
        if mode != "train":
            self._load_eval_assets()

    def _load_eval_assets(self):
        ava = self.cfg.AVA
        label_map = os.path.join(ava.ANNOTATION_DIR, ava.LABEL_MAP_FILE)
        exclusions = os.path.join(ava.ANNOTATION_DIR, ava.EXCLUSION_FILE)
        gt_file = os.path.join(ava.ANNOTATION_DIR, ava.GROUNDTRUTH_FILE)
        if not os.path.exists(label_map):
            return
        self.categories, self.class_whitelist = ava_eval.read_label_map(label_map)
        self.excluded_keys = (ava_eval.read_exclusions(exclusions)
                              if os.path.exists(exclusions) else set())
        if os.path.exists(gt_file):
            full = ava_eval.read_csv(gt_file, self.class_whitelist)
            full_gt = self.mode == "test" or (self.mode == "val" and ava.FULL_TEST_ON_VAL)
            self.groundtruth = full if full_gt else ava_eval.get_ava_mini_groundtruth(full)

    def set_video_idx_to_name(self, names):
        self.video_idx_to_name = names

    def iter_tic(self):
        self.iter_timer.reset()

    def iter_toc(self):
        self.iter_timer.pause()

    def data_toc(self):
        pass  # the train loop's timer call; this meter times iterations only

    def reset(self):
        self.loss.reset()
        self.all_preds, self.all_ori_boxes, self.all_metadata = [], [], []

    def update_stats(self, preds, ori_boxes, metadata, loss=None, lr=None):
        if self.mode in ("val", "test"):
            self.all_preds.append(np.asarray(preds))
            self.all_ori_boxes.append(np.asarray(ori_boxes))
            self.all_metadata.append(np.asarray(metadata))
        if loss is not None:
            self.loss.add_value(loss)
        if lr is not None:
            self.lr = lr

    def log_iter_stats(self, cur_epoch, cur_iter):
        if (cur_iter + 1) % self.cfg.LOG_PERIOD != 0:
            return
        stats = {"_type": f"{self.mode}_iter",
                 "cur_epoch": cur_epoch + 1 if cur_epoch is not None else None,
                 "cur_iter": cur_iter + 1, "time_diff": self.iter_timer.seconds(),
                 "mode": self.mode}
        if self.mode == "train":
            stats.update(loss=self.loss.get_win_median(), lr=self.lr)
        log_json_stats(stats, self.output_dir)

    def finalize_metrics(self, log=True):
        preds, boxes, meta = (gather_ragged_across_hosts(np.concatenate(x, axis=0)) for x in
                              (self.all_preds, self.all_ori_boxes, self.all_metadata))
        if self.groundtruth is None:
            logger.info("AVA groundtruth unavailable; skipping mAP (collected %d boxes)",
                        preds.shape[0])
            self.full_map = 0.0
            return self.full_map
        self.full_map = ava_eval.evaluate_ava(
            preds, boxes, meta, self.excluded_keys or set(),
            self.class_whitelist or set(range(1, preds.shape[1] + 1)), self.categories or [],
            groundtruth=self.groundtruth, video_idx_to_name=self.video_idx_to_name)
        if log:
            log_json_stats({"mode": self.mode, "map": self.full_map}, self.output_dir)
        return self.full_map

    def log_epoch_stats(self, cur_epoch):
        if self.mode in ("val", "test"):
            self.finalize_metrics(log=False)
            stats = {"_type": f"{self.mode}_epoch", "cur_epoch": cur_epoch + 1,
                     "mode": self.mode, "map": self.full_map}
        else:
            stats = {"_type": "train_epoch", "cur_epoch": cur_epoch + 1, "mode": self.mode,
                     "loss": self.loss.get_win_median() if self.loss.deque else None,
                     "lr": self.lr}
        log_json_stats(stats, self.output_dir)
        return stats


class TestMeter:
    """Multi-view test-time ensembling (reference meters.py:239-407).

    Accumulates per-clip predictions into per-video scores keyed by
    clip_id // num_clips, with sum or max ensembling, then finalizes
    top-1/top-5 accuracy, or the mAP with ``multi_label`` (multi-hot labels;
    the scores start at -1e10, so ``max`` takes the views' maximum).
    """

    def __init__(self, num_videos, num_clips, num_cls, multi_label=False,
                 ensemble_method="sum", output_dir=None):
        if ensemble_method not in ("sum", "max"):
            raise ValueError(f"unknown ensemble method {ensemble_method!r}")
        self.iter_timer = Timer()
        self.num_clips = num_clips
        self.multi_label = multi_label
        self.ensemble_method = ensemble_method
        self.video_preds = np.zeros((num_videos, num_cls), np.float64)
        if multi_label:
            self.video_preds -= 1e10
        self.video_labels = np.zeros((num_videos, num_cls) if multi_label else (num_videos,),
                                     np.int64)
        self.clip_count = np.zeros((num_videos,), np.int64)
        self.stats = {}
        self.output_dir = output_dir

    def update_stats(self, preds, labels, clip_ids):
        preds = np.asarray(preds)
        labels = np.asarray(labels)
        clip_ids = np.asarray(clip_ids)
        for ind in range(preds.shape[0]):
            vid_id = int(clip_ids[ind]) // self.num_clips
            if self.clip_count[vid_id] > 0 and not np.array_equal(self.video_labels[vid_id],
                                                                  labels[ind]):
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
        if self.multi_label:
            self.stats["map"] = get_map(self.video_preds, self.video_labels)
        else:
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


def get_map(preds, labels):
    """Mean over classes of the average precision, classes with no nonzero
    label dropped (reference meters.py:823-849), with the steps of the JAX
    package's sklearn ``average_precision_score(average=None)``: per class,
    the positives are the labels equal to 1; the scores sorted descending;
    cumulative true and false positives (float64) at the last index of each
    run of tied scores; precision and recall at those thresholds reversed
    and closed with (1, 0); the step integral ``max(0, -sum(diff(recall) *
    precision[:-1]))``. Returns -1.0 where sklearn raises: no sample or class
    left, more than two label values or a fractional one, one class whose
    two values do not include 1, a score that is not finite."""
    logger.info("Getting mAP for %d examples", preds.shape[0])
    keep = ~np.all(labels == 0, axis=0)
    preds, labels = np.asarray(preds)[:, keep], np.asarray(labels)[:, keep]
    values = np.unique(labels)
    if (labels.size == 0 or len(values) > 2 or np.any(values != np.round(values))
            or (labels.shape[1] == 1 and len(values) == 2 and 1 not in values)
            or not np.isfinite(preds).all()):
        logger.error("Average precision requires a sufficient number of samples; "
                     "returning -1")
        return -1.0
    return float(np.mean([_average_precision(labels[:, c] == 1, preds[:, c])
                          for c in range(labels.shape[1])]))


def _average_precision(y_true, y_score):
    order = np.argsort(y_score, kind="stable")[::-1]
    y_score, y_true = y_score[order], y_true[order]
    thresholds = np.r_[np.nonzero(np.diff(y_score))[0], y_true.size - 1]
    tps = np.cumsum(y_true, dtype=np.float64)[thresholds]
    fps = 1 + thresholds.astype(np.float64) - tps
    ps = tps + fps
    precision = np.divide(tps, ps, out=np.zeros_like(tps), where=ps != 0)
    recall = tps / tps[-1] if tps[-1] != 0 else np.ones_like(tps)
    precision = np.r_[precision[::-1], 1.0]
    recall = np.r_[recall[::-1], 0.0]
    return max(0.0, float(-np.sum(np.diff(recall) * precision[:-1])))
