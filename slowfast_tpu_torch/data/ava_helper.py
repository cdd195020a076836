"""AVA annotations: frame lists, box csvs and keyframes (counterpart of
slowfast_tpu/data/ava_helper.py; reference slowfast/datasets/ava_helper.py).

Frame lists are ``original_video_id video_id frame_id path labels`` lines
after a header. Box csvs are ``video,sec,x1,y1,x2,y2,label[,score]`` rows in
normalized coordinates: ground truth, and predicted boxes kept from a score
of ``AVA.DETECTION_SCORE_THRESH``. Keyframes are the seconds 902-1798 of
each video that have a box, at frame ``(sec - 900) * 30``.
"""

import os

from slowfast_tpu_torch.utils import logging as logging_utils
from slowfast_tpu_torch.utils.io import pathmgr

logger = logging_utils.get_logger(__name__)

FPS = 30
AVA_VALID_FRAMES = range(902, 1799)


def load_image_lists(cfg, is_train):
    """Returns ``(image_paths, video_idx_to_name)``: per video, in the order
    videos first appear, its frames' paths under ``AVA.FRAME_DIR``."""
    names = cfg.AVA.TRAIN_LISTS if is_train else cfg.AVA.TEST_LISTS
    list_filenames = [os.path.join(cfg.AVA.FRAME_LIST_DIR, f) for f in names]
    image_paths = {}
    video_idx_to_name = []
    for list_filename in list_filenames:
        with pathmgr.open(list_filename) as f:
            f.readline()  # header
            for line in f:
                row = line.split()
                if len(row) != 5:
                    raise ValueError(f"bad frame list line {line!r} in {list_filename}")
                if row[0] not in image_paths:
                    image_paths[row[0]] = []
                    video_idx_to_name.append(row[0])
                image_paths[row[0]].append(os.path.join(cfg.AVA.FRAME_DIR, row[3]))
    logger.info("Finished loading image paths from: %s", ", ".join(list_filenames))
    return [image_paths[name] for name in video_idx_to_name], video_idx_to_name


def load_boxes_and_labels(cfg, mode):
    """``{video: {sec: [[box, [labels]], ...]}}`` from the GT (train only) and
    predicted box csvs of ``mode``; train keeps the valid seconds only, and
    every video read gets an entry for each valid second."""
    gt_lists = cfg.AVA.TRAIN_GT_BOX_LISTS if mode == "train" else []
    pred_lists = (cfg.AVA.TRAIN_PREDICT_BOX_LISTS if mode == "train"
                  else cfg.AVA.TEST_PREDICT_BOX_LISTS)
    filenames = [os.path.join(cfg.AVA.ANNOTATION_DIR, f) for f in gt_lists + pred_lists]
    is_gt = [True] * len(gt_lists) + [False] * len(pred_lists)
    all_boxes = {}
    count = unique = 0
    for filename, gt in zip(filenames, is_gt):
        with pathmgr.open(filename) as f:
            for line in f:
                row = line.strip().split(",")
                if not gt and float(row[7]) < cfg.AVA.DETECTION_SCORE_THRESH:
                    continue
                video, sec = row[0], int(row[1])
                if mode == "train" and sec not in AVA_VALID_FRAMES:
                    continue
                box_key = ",".join(row[2:6])
                label = -1 if row[6] == "" else int(row[6])
                if video not in all_boxes:
                    all_boxes[video] = {s: {} for s in AVA_VALID_FRAMES}
                secs = all_boxes[video].setdefault(sec, {})
                if box_key not in secs:
                    secs[box_key] = [list(map(float, row[2:6])), []]
                    unique += 1
                if label != -1:
                    secs[box_key][1].append(label)
                count += 1
    for video in all_boxes.values():
        for sec in list(video):
            video[sec] = list(video[sec].values())
    logger.info("Finished loading annotations: %d boxes (%d unique)", count, unique)
    return all_boxes


def get_keyframe_data(boxes_and_labels):
    """``(keyframe_indices, keyframe_boxes_and_labels)``: per keyframe
    ``(video_idx, sec_idx, sec, frame)``, and per video the boxes of each of
    its keyframes."""
    keyframe_indices, keyframe_boxes = [], []
    for video_idx, video in enumerate(boxes_and_labels):
        keyframe_boxes.append([])
        sec_idx = 0
        for sec, boxes in video.items():
            if sec not in AVA_VALID_FRAMES or not boxes:
                continue
            keyframe_indices.append((video_idx, sec_idx, sec, (sec - 900) * FPS))
            keyframe_boxes[video_idx].append(boxes)
            sec_idx += 1
    logger.info("%d keyframes used.", len(keyframe_indices))
    return keyframe_indices, keyframe_boxes


def get_num_boxes_used(keyframe_indices, keyframe_boxes_and_labels):
    return sum(len(keyframe_boxes_and_labels[v][s]) for v, s, _, _ in keyframe_indices)
