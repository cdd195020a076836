"""A corpus of real .mp4 files for tests and ``chip_smoke.py`` (the port's
counterpart of slowfast_tpu/data/synth_media.py).

Each video is a seeded random frame rolled 3 pixels a frame along W (cheap
motion), written with cv2's mp4v encoder; the split csvs list ``path label``
for the first ``n`` videos of each split, label ``i % 10``. The default is
the storage shape of Kinetics at short side 256: 340 x 256 at 30 fps.
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
