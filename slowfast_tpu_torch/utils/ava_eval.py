"""AVA evaluation: PASCAL VOC mAP@0.5IoU in numpy (the port's copy of
slowfast_tpu/utils/ava_eval.py).

The JAX package replaces the vendored ActivityNet/TF evaluator (reference
ava_evaluation/, 3.2k LoC) with a compact implementation of the same metric:
per-class AP with greedy IoU>=0.5 matching, sorted by detection score,
precision integrated over recall (VOC "area under PR curve" without
11-point interpolation — matching object_detection_evaluation defaults),
plus the reference's csv plumbing (box column reorder, exclusions, label
map parsing; reference slowfast/utils/ava_eval_helper.py:87-288).
"""

import csv
import time
from collections import defaultdict

import numpy as np

from . import logging as logging_utils

logger = logging_utils.get_logger(__name__)


# ---------------------------------------------------------------------------
# Parsing (reference ava_eval_helper.py:87-120)
# ---------------------------------------------------------------------------

def read_label_map(labelmap_file):
    """Parse a pbtxt label map -> (categories list, class id set)."""
    labelmap = []
    class_ids = set()
    name = ""
    class_id = ""
    with open(labelmap_file, "r") as f:
        for line in f:
            if line.startswith("  name:"):
                name = line.split('"')[1]
            elif line.startswith("  id:") or line.startswith("  label_id:"):
                class_id = int(line.strip().split(" ")[-1])
                labelmap.append({"id": class_id, "name": name})
                class_ids.add(class_id)
    return labelmap, class_ids


def read_exclusions(exclusions_file):
    """Set of 'video,sec' keys to skip (reference :95-106)."""
    excluded = set()
    if exclusions_file:
        with open(exclusions_file, "r") as f:
            reader = csv.reader(f)
            for row in reader:
                assert len(row) == 2, f"Expected only 2 columns, got: {row}"
                excluded.add(make_image_key(row[0], row[1]))
    return excluded


def make_image_key(video_id, timestamp):
    return f"{video_id},{int(timestamp):04d}"


def read_csv(csv_file, class_whitelist=None, load_score=False):
    """Read an AVA-format csv -> (boxes, labels, scores) keyed by image_key.

    Boxes are stored [y1, x1, y2, x2] (the evaluator's convention; the
    reference reorders the same way, ava_eval_helper.py:235-271).
    """
    boxes = defaultdict(list)
    labels = defaultdict(list)
    scores = defaultdict(list)
    with open(csv_file, "r") as f:
        reader = csv.reader(f)
        for row in reader:
            assert len(row) in [7, 8], f"Wrong number of columns: {row}"
            image_key = make_image_key(row[0], row[1])
            x1, y1, x2, y2 = (float(n) for n in row[2:6])
            action_id = int(row[6])
            if class_whitelist and action_id not in class_whitelist:
                continue
            score = 1.0
            if load_score:
                score = float(row[7])
            boxes[image_key].append([y1, x1, y2, x2])
            labels[image_key].append(action_id)
            scores[image_key].append(score)
    return boxes, labels, scores


def get_ava_mini_groundtruth(full_groundtruth):
    """Subsample the GT to keyframes with second % 4 == 0 — the reference's
    faster val-during-training protocol (reference meters.py:28-43).
    Final test evaluates against the full GT."""
    ret = [defaultdict(list), defaultdict(list), defaultdict(list)]
    for i in range(3):
        for key in full_groundtruth[i].keys():
            if int(key.split(",")[1]) % 4 == 0:
                ret[i][key] = full_groundtruth[i][key]
    return tuple(ret)


# ---------------------------------------------------------------------------
# Core PASCAL AP
# ---------------------------------------------------------------------------

def _iou_matrix(boxes1, boxes2):
    """IoU between (N,4) and (M,4) [y1,x1,y2,x2] boxes."""
    area1 = (boxes1[:, 2] - boxes1[:, 0]) * (boxes1[:, 3] - boxes1[:, 1])
    area2 = (boxes2[:, 2] - boxes2[:, 0]) * (boxes2[:, 3] - boxes2[:, 1])
    yx1 = np.maximum(boxes1[:, None, :2], boxes2[None, :, :2])
    yx2 = np.minimum(boxes1[:, None, 2:], boxes2[None, :, 2:])
    wh = np.clip(yx2 - yx1, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    union = area1[:, None] + area2[None, :] - inter
    return np.where(union > 0, inter / union, 0.0)


def compute_average_precision(precision, recall):
    """VOC-style AP: area under the monotone precision envelope
    (matches the vendored metrics.compute_average_precision)."""
    if precision is None or len(precision) == 0:
        return np.nan
    recall = np.concatenate([[0], recall, [1]])
    precision = np.concatenate([[0], precision, [0]])
    for i in range(len(precision) - 2, -1, -1):
        precision[i] = np.maximum(precision[i], precision[i + 1])
    indices = np.where(recall[1:] != recall[:-1])[0] + 1
    return float(
        np.sum((recall[indices] - recall[indices - 1]) * precision[indices])
    )


def evaluate_detections(
    gt_boxes, gt_labels, det_boxes, det_labels, det_scores, class_ids,
    iou_thresh=0.5,
):
    """Per-class PASCAL AP over all images.

    All inputs are dicts keyed by image_key; boxes [y1,x1,y2,x2] in [0,1].
    Returns {class_id: AP} over classes with >=1 GT box.
    """
    # Collect per-class GT counts and per-class detections.
    npos = defaultdict(int)
    gt_by_img_cls = defaultdict(lambda: defaultdict(list))
    for key, labels in gt_labels.items():
        for box, label in zip(gt_boxes[key], labels):
            npos[label] += 1
            gt_by_img_cls[key][label].append(box)

    dets_by_cls = defaultdict(list)  # class -> (score, key, box)
    for key, labels in det_labels.items():
        for box, label, score in zip(det_boxes[key], labels, det_scores[key]):
            dets_by_cls[label].append((float(score), key, box))

    aps = {}
    for cls in class_ids:
        if npos[cls] == 0:
            continue
        dets = sorted(dets_by_cls.get(cls, []), key=lambda d: -d[0])
        nd = len(dets)
        tp = np.zeros(nd)
        fp = np.zeros(nd)
        matched = defaultdict(set)  # image -> matched gt indices
        gt_cache = {}
        for i, (score, key, box) in enumerate(dets):
            gts = gt_by_img_cls.get(key, {}).get(cls)
            if not gts:
                fp[i] = 1
                continue
            if (key, cls) not in gt_cache:
                gt_cache[(key, cls)] = np.asarray(gts, np.float64)
            ious = _iou_matrix(np.asarray([box], np.float64), gt_cache[(key, cls)])[0]
            order = np.argsort(-ious)
            hit = False
            for j in order:
                if ious[j] < iou_thresh:
                    break
                if j not in matched[key]:
                    matched[key].add(j)
                    tp[i] = 1
                    hit = True
                    break
            if not hit:
                fp[i] = 1
        cum_tp = np.cumsum(tp)
        cum_fp = np.cumsum(fp)
        recall = cum_tp / npos[cls]
        precision = cum_tp / np.maximum(cum_tp + cum_fp, 1e-12)
        aps[cls] = compute_average_precision(precision, recall)
    return aps


# ---------------------------------------------------------------------------
# Driver API (reference ava_eval_helper.py:133-288)
# ---------------------------------------------------------------------------

def evaluate_ava(
    preds,
    original_boxes,
    metadata,
    excluded_keys,
    class_whitelist,
    categories,
    groundtruth=None,
    video_idx_to_name=None,
    name="latest",
):
    """Full AVA eval from in-memory predictions.

    preds: (N, num_classes) scores per box; original_boxes: (N, 5)
    [batch_idx, x1, y1, x2, y2] normalized; metadata: (N, 2)
    [video_idx, sec].
    """
    eval_start = time.time()
    det_boxes, det_labels, det_scores = get_ava_eval_data(
        preds, original_boxes, metadata, class_whitelist, video_idx_to_name
    )
    gt_boxes, gt_labels, _ = groundtruth

    # Drop excluded keys.
    for excluded in excluded_keys:
        det_boxes.pop(excluded, None)
        det_labels.pop(excluded, None)
        det_scores.pop(excluded, None)

    aps = evaluate_detections(
        gt_boxes, gt_labels, det_boxes, det_labels, det_scores,
        sorted(class_whitelist),
    )
    mean_ap = float(np.nanmean(list(aps.values()))) if aps else 0.0
    logger.info("AVA eval done in %f seconds.", time.time() - eval_start)
    logger.info("PascalBoxes_Precision/mAP@0.5IOU: %f", mean_ap)
    return mean_ap


def get_ava_eval_data(
    scores, boxes, metadata, class_whitelist, video_idx_to_name=None
):
    """Convert network outputs to evaluator format with the reference's
    column reorder [0,2,1,4,3]: x1,y1,x2,y2 -> y1,x1,y2,x2
    (reference ava_eval_helper.py:235-271)."""
    out_boxes = defaultdict(list)
    out_labels = defaultdict(list)
    out_scores = defaultdict(list)
    for i in range(scores.shape[0]):
        video_idx = int(metadata[i][0])
        sec = int(metadata[i][1])
        video = video_idx_to_name[video_idx] if video_idx_to_name else str(video_idx)
        key = make_image_key(video, sec)
        batch_box = boxes[i]
        box = [batch_box[2], batch_box[1], batch_box[4], batch_box[3]]  # y1x1y2x2
        for cls_idx, score in enumerate(scores[i]):
            cls = cls_idx + 1  # AVA classes are 1-indexed
            if cls in class_whitelist:
                out_boxes[key].append(box)
                out_labels[key].append(cls)
                out_scores[key].append(float(score))
    return out_boxes, out_labels, out_scores


def write_results(detections, filename):
    """Dump detections csv (reference ava_eval_helper.py:274-288)."""
    boxes, labels, scores = detections
    with open(filename, "w") as f:
        for key in boxes.keys():
            video, sec = key.split(",")
            for box, label, score in zip(boxes[key], labels[key], scores[key]):
                f.write(
                    f"{video},{int(sec)},{box[1]:.6f},{box[0]:.6f},"
                    f"{box[3]:.6f},{box[2]:.6f},{label},{score:.6f}\n"
                )
