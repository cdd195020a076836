"""Video decoding and temporal sampling (counterpart of
slowfast_tpu/data/decoder.py:31-85 and its cv2 path, :225-320; reference
slowfast/datasets/decoder.py).

The port decodes with cv2 whatever ``DATA.DECODING_BACKEND`` says: the JAX
package does the same when its FFmpeg decode service is not built. The clip
window is placed in the stream's frame indices, cv2 seeks to its first
frame and reads to its last, shrinking each frame whose short side exceeds
``max_spatial_scale`` as it goes, and the clip's frames are picked by
linspace within the window. Random placement draws from the
``random.Random`` the caller passes.
"""

import math

import numpy as np

BACKEND = "cv2"


def temporal_sampling(frames, start_idx, end_idx, num_samples):
    """``num_samples`` frames at linspace indices in [start, end], clamped
    (reference decoder.py:17-34)."""
    index = np.linspace(start_idx, end_idx, num_samples)
    index = np.clip(index, 0, frames.shape[0] - 1).astype(np.int64)
    return frames[index]


def get_start_end_idx(video_size, clip_size, clip_idx, num_clips, rng=None,
                      use_offset=False):
    """The clip's window ``(start, end, start / (video_size - clip_size))``:
    uniform at random for ``clip_idx`` -1, else the ``clip_idx``-th of
    ``num_clips`` evenly spaced windows (reference decoder.py:37-76)."""
    delta = max(video_size - clip_size, 0)
    if clip_idx == -1:
        start_idx = rng.uniform(0, delta)
    elif use_offset:
        if num_clips == 1:
            start_idx = math.floor(delta / 2)
        else:
            start_idx = clip_idx * math.floor(delta / max(num_clips - 1, 1))
    else:
        start_idx = delta * clip_idx / num_clips
    end_idx = start_idx + clip_size - 1
    return start_idx, end_idx, start_idx / delta if delta != 0 else 0.0


def get_multiple_start_end_idx(video_size, clip_sizes, clip_idx, num_clips, rng,
                               min_delta=0, max_delta=math.inf):
    """Windows for several clips, redrawn (up to 100 times) until the gaps
    between consecutive ones lie in [min_delta, max_delta] (reference
    decoder.py:79-183)."""
    se_inds = np.empty((0, 2))
    for _ in range(100):
        se_inds = np.array([get_start_end_idx(video_size, size, clip_idx, num_clips, rng)[:2]
                            for size in clip_sizes])
        if len(clip_sizes) == 1:
            return se_inds
        order = np.argsort(se_inds[:, 0])
        dt = se_inds[order][1:, 0] - se_inds[order][:-1, 1]
        if ((dt >= min_delta) & (dt <= max_delta)).all():
            break
    return se_inds


def get_video_fps_and_frames(path):
    """``(capture, fps, frame count)`` of a video file, ``(None, 0, 0)`` when
    cv2 cannot open it; a stream without a rate reads as 30 fps."""
    import cv2

    cap = cv2.VideoCapture(path)
    if not cap.isOpened():
        return None, 0, 0
    fps = cap.get(cv2.CAP_PROP_FPS) or 30.0
    return cap, fps, int(cap.get(cv2.CAP_PROP_FRAME_COUNT))


def _read_window(cap, total, start_idx, end_idx, num_frames, max_spatial_scale=0):
    """The ``num_frames`` linspace frames of the window ``[start_idx,
    end_idx]`` of an open capture, RGB uint8 (T, H, W, C), each frame's short
    side shrunk to ``max_spatial_scale`` when it is longer; None when no
    frame reads."""
    import cv2

    start_f = max(int(math.floor(start_idx)), 0)
    end_f = min(int(math.ceil(end_idx)), total - 1)
    if int(cap.get(cv2.CAP_PROP_POS_FRAMES)) != start_f:
        cap.set(cv2.CAP_PROP_POS_FRAMES, start_f)
    frames = []
    for _ in range(end_f - start_f + 1):
        ok, frame = cap.read()
        if not ok:
            break
        if max_spatial_scale > 0:
            h, w = frame.shape[:2]
            if min(h, w) > max_spatial_scale:
                scale = max_spatial_scale / min(h, w)
                frame = cv2.resize(frame, (int(round(w * scale)), int(round(h * scale))),
                                   interpolation=cv2.INTER_LINEAR)
        frames.append(frame[:, :, ::-1])  # BGR -> RGB
    if not frames:
        return None
    frames = np.stack(frames)
    index = np.linspace(start_idx - start_f, end_idx - start_f, num_frames)
    index = np.clip(index, 0, frames.shape[0] - 1).astype(np.int64)
    return frames[index]


def decode(path, sampling_rate, num_frames, rng=None, clip_idx=-1, num_clips=10,
           target_fps=30, max_spatial_scale=0, use_offset=False):
    """One clip of ``num_frames`` uint8 RGB frames (T, H, W, C), frames
    ``sampling_rate`` apart at ``target_fps``: returns ``(frames, fps,
    False, time_frac)``, with the window's relative start ``time_frac``, or
    None when the file cannot be read."""
    cap, fps, total = get_video_fps_and_frames(path)
    if cap is None:
        return None
    try:
        if total <= 0:
            return None
        clip_size = sampling_rate * num_frames / target_fps * fps
        start_idx, end_idx, time_frac = get_start_end_idx(total, clip_size, clip_idx,
                                                          num_clips, rng, use_offset=use_offset)
        frames = _read_window(cap, total, start_idx, end_idx, num_frames, max_spatial_scale)
    finally:
        cap.release()
    return None if frames is None else (frames, fps, False, time_frac)


def decode_views(path, sampling_rate, num_frames, rng, n_views, num_clips=10, target_fps=30,
                 min_delta=-math.inf, max_delta=math.inf):
    """``n_views`` random windows drawn jointly until the gaps between them
    lie in ``[min_delta, max_delta]`` (``get_multiple_start_end_idx``), each
    decoded as ``decode`` decodes one: the SSL views under
    ``CONTRASTIVE.DELTA_CLIPS_{MIN,MAX}``, which the JAX package draws in
    its FFmpeg multi-window decode (slowfast_tpu/data/decoder.py:150-164).
    Returns ``(clips, fps, False, time_fracs)`` or None."""
    cap, fps, total = get_video_fps_and_frames(path)
    if cap is None:
        return None
    try:
        if total <= 0:
            return None
        clip_size = sampling_rate * num_frames / target_fps * fps
        se = get_multiple_start_end_idx(total, [clip_size] * n_views, -1, num_clips, rng,
                                        min_delta=min_delta, max_delta=max_delta)
        span = max(total - clip_size, 0)
        clips = [_read_window(cap, total, s, e, num_frames) for s, e in se]
    finally:
        cap.release()
    if any(c is None for c in clips):
        return None
    return clips, fps, False, [s / span if span != 0 else 0.0 for s, _ in se]
