"""Corpora of real media files for tests and ``chip_smoke.py`` (the port's
counterpart of slowfast_tpu/data/synth_media.py).

``make_video_corpus``: each video is a seeded random frame rolled 3 pixels a
frame along W (cheap motion), written with cv2's mp4v encoder; the split
csvs list ``path label`` for the first ``n`` videos of each split, label
``i % 10``. The default is the storage shape of Kinetics at short side 256:
340 x 256 at 30 fps.

``make_ava_corpus``: AVA's layout on JPEG frames at 30 fps (455 x 256 by
default, AVA's frames at short side 256), with every file the AVA dataset
and ``AVAMeter`` read, in the formats of the AVA v2.2 release.

``make_imagenet_corpus``: ImageNet's directory tree, ``<split>/<class>/
<image>.JPEG``, seeded random JPEGs of ImageNet's typical 500 x 375.
"""

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np


def write_video(path, frames, size, fps, seed):
    import cv2

    w, h = size
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
    try:
        frame = (np.random.RandomState(seed).rand(h, w, 3) * 255).astype(np.uint8)
        for _ in range(frames):
            frame = np.roll(frame, 3, axis=1)
            writer.write(frame)
    finally:
        writer.release()


def make_video_corpus(root, splits, frames=300, size=(340, 256), fps=30, seed=0,
                      workers=1):
    """Write ``max(splits.values())`` videos under ``root`` (``workers``
    threads) and ``<split>.csv`` for each ``split: n`` of ``splits``; returns
    ``root``."""
    os.makedirs(root, exist_ok=True)
    n_videos = max(splits.values())
    paths = [os.path.join(root, f"v{i:03d}.mp4") for i in range(n_videos)]
    with ThreadPoolExecutor(max(workers, 1)) as pool:
        list(pool.map(lambda i: write_video(paths[i], frames, size, fps, seed + i),
                      range(n_videos)))
    for split, n in splits.items():
        with open(os.path.join(root, f"{split}.csv"), "w") as f:
            f.writelines(f"{paths[i]} {i % 10}\n" for i in range(n))
    return root


def _write_frames(root, video, n, size, seed):
    """``n`` JPEG frames of a smooth seeded image rolled 2 pixels a frame;
    returns their paths relative to ``root``."""
    import cv2

    w, h = size
    os.makedirs(os.path.join(root, video), exist_ok=True)
    small = (np.random.RandomState(seed).rand(max(h // 8, 2), max(w // 8, 2), 3) * 255)
    frame = cv2.resize(small.astype(np.uint8), (w, h), interpolation=cv2.INTER_LINEAR)
    rels = []
    for i in range(n):
        rel = f"{video}/{video}_{i + 1:06d}.jpg"
        cv2.imwrite(os.path.join(root, rel), np.roll(frame, 2 * i, axis=1))
        rels.append(rel)
    return rels


def make_ava_corpus(root, num_videos=4, secs=range(902, 918), size=(455, 256),
                    num_classes=80, seed=0, workers=1):
    """An AVA corpus under ``root``: ``frames/<video>/`` with every frame of
    seconds 900 to ``secs[-1]`` at 30 fps; ``frame_lists/{train,val}.csv``;
    in ``annotations/`` the GT of every keyframe of ``secs`` (1-5 boxes, each
    with 1-3 of ``num_classes`` labels and a person id) as the train csv and
    as the val GT, the predicted person boxes of both splits (the GT boxes
    moved by up to 0.02, with scores on both sides of 0.8, and one false
    box per keyframe), the label map, and one excluded val keyframe. The
    file names are those of ``configs/AVA/SLOWFAST_32x2_R50_SHORT.yaml``.
    Returns the ``AVA.*`` config opts that point at it."""
    rs = np.random.RandomState(seed)
    videos = [f"vid{i:03d}" for i in range(num_videos)]
    n_frames = (secs[-1] - 900 + 1) * 30
    frame_dir, list_dir, ann_dir = (os.path.join(root, d)
                                    for d in ("frames", "frame_lists", "annotations"))
    for d in (frame_dir, list_dir, os.path.join(ann_dir, "person_box_67091280_iou90")):
        os.makedirs(d, exist_ok=True)
    with ThreadPoolExecutor(max(workers, 1)) as pool:
        rels = list(pool.map(lambda i: _write_frames(frame_dir, videos[i], n_frames, size,
                                                     seed + i), range(num_videos)))
    rows = ["original_video_id video_id frame_id path labels"]
    for i, (video, paths) in enumerate(zip(videos, rels)):
        rows += [f'{video} {i} {j} {rel} ""' for j, rel in enumerate(paths)]
    for split in ("train", "val"):
        with open(os.path.join(list_dir, f"{split}.csv"), "w") as f:
            f.write("\n".join(rows) + "\n")
    gt, pred = [], []
    for video in videos:
        for sec in secs:
            for person in range(rs.randint(1, 6)):
                xy1 = rs.rand(2) * 0.6
                x1, y1, x2, y2 = np.concatenate([xy1, xy1 + 0.1 + rs.rand(2) * 0.3])
                for label in rs.choice(np.arange(1, num_classes + 1), rs.randint(1, 4),
                                       replace=False):
                    gt.append(f"{video},{sec},{x1:.3f},{y1:.3f},{x2:.3f},{y2:.3f},{label},"
                              f"{person}")
                dx = rs.uniform(-0.02, 0.02, 4)
                box = np.clip([x1, y1, x2, y2] + dx, 0.0, 1.0)
                pred.append(f"{video},{sec},{box[0]:.3f},{box[1]:.3f},{box[2]:.3f},"
                            f"{box[3]:.3f},,{rs.uniform(0.5, 1.0):.6f}")
            x1, y1 = rs.rand(2) * 0.5
            pred.append(f"{video},{sec},{x1:.3f},{y1:.3f},{x1 + 0.3:.3f},{y1 + 0.4:.3f},,"
                        f"{rs.uniform(0.5, 1.0):.6f}")
    files = {"ava_train_v2.2.csv": gt, "ava_val_v2.2.csv": gt,
             "person_box_67091280_iou90/ava_detection_train_boxes_and_labels_include_"
             "negative_v2.2.csv": pred,
             "person_box_67091280_iou90/ava_detection_val_boxes_and_labels.csv": pred,
             "ava_val_excluded_timestamps_v2.2.csv": [f"{videos[-1]},{secs[0]}"],
             "ava_action_list_v2.2_for_activitynet_2019.pbtxt": [
                 f'item {{\n  name: "action {k}"\n  id: {k}\n}}'
                 for k in range(1, num_classes + 1)]}
    for name, lines in files.items():
        with open(os.path.join(ann_dir, name), "w") as f:
            f.write("\n".join(lines) + "\n")
    return ["AVA.FRAME_DIR", frame_dir, "AVA.FRAME_LIST_DIR", list_dir,
            "AVA.ANNOTATION_DIR", ann_dir]


def make_imagenet_corpus(root, splits, num_classes=10, size=(500, 375), seed=0, workers=1):
    """Write ``n`` JPEGs for each ``split: n`` of ``splits`` under
    ``root/<split>/n{class:08d}/``, image ``i`` in class ``i % num_classes``
    (``workers`` threads); returns ``root``."""
    import cv2

    w, h = size
    jobs = []
    for s_i, (split, n) in enumerate(sorted(splits.items())):
        for c in range(min(num_classes, n)):
            os.makedirs(os.path.join(root, split, f"n{c:08d}"), exist_ok=True)
        jobs += [(os.path.join(root, split, f"n{i % num_classes:08d}", f"{split}_{i:06d}.JPEG"),
                  seed + 100_000 * s_i + i) for i in range(n)]

    def write(job):
        path, s = job
        cv2.imwrite(path, (np.random.RandomState(s).rand(h, w, 3) * 255).astype(np.uint8))

    with ThreadPoolExecutor(workers) as pool:
        list(pool.map(write, jobs))
    return root
