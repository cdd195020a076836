"""MAE's reconstruction renders (counterpart of
slowfast_tpu/visualization/mae_vis.py; reference slowfast/models/masked.py
``_mae_visualize`` driven from tools/test_net.py:124).

Under ``VIS_MASK.ENABLE`` with ``MASK.ENABLE`` and ``MASK.MAE_ON`` the test
renders every test clip in place of the metrics: the input, the masked
input and the reconstruction side by side, ``(T, H, 3W)``, written with
cv2 to ``OUTPUT_DIR/vis_mask/vid/vis_mask_mr{AUG.MASK_RATIO}_{iter}_{i}.mp4``
(``i`` the clip's row in the global batch). The model's forward runs on
the device (row 6 of the kernel table in MAE's blocks); the composition is
numpy on the host. Under ``MASK.NORM_PRED_PIXEL`` the prediction lives in
per-patch normalized space and is de-normalized with the input patches'
statistics, as the JAX package does.
"""

import os

import numpy as np
import torch

from slowfast_tpu_torch.utils import logging as logging_utils

logger = logging_utils.get_logger(__name__)


def _patchify(cfg, frames, T0, H0, W0):
    """``(B, T, H, W, C)`` → ``(B, T0·H0·W0, D)``, the order of MAE's pixel
    targets, not normalized."""
    B, T, H, W, C = frames.shape
    pt, ph, pw = cfg.MVIT.PATCH_STRIDE
    if cfg.MASK.TIME_STRIDE_LOSS:
        patches = frames.reshape(B, T0, H0, ph, W0, pw, C).transpose(0, 1, 2, 4, 3, 5, 6)
        return patches.reshape(B, T0 * H0 * W0, ph * pw * C)
    patches = frames.reshape(B, T0, pt, H0, ph, W0, pw, C).transpose(0, 1, 3, 5, 2, 4, 6, 7)
    return patches.reshape(B, T0 * H0 * W0, pt * ph * pw * C)


def _unpatchify(cfg, patches, T0, H0, W0):
    """The inverse of ``_patchify``: ``(B, T, H, W, 3)``."""
    B = patches.shape[0]
    pt, ph, pw = cfg.MVIT.PATCH_STRIDE
    if cfg.MASK.TIME_STRIDE_LOSS:
        x = patches.reshape(B, T0, H0, W0, ph, pw, 3).transpose(0, 1, 2, 4, 3, 5, 6)
        return x.reshape(B, T0, H0 * ph, W0 * pw, 3)
    x = patches.reshape(B, T0, H0, W0, pt, ph, pw, 3).transpose(0, 1, 4, 2, 5, 3, 6, 7)
    return x.reshape(B, T0 * pt, H0 * ph, W0 * pw, 3)


def _to_uint8(cfg, frames):
    """``DATA.MEAN``/``STD`` undone for display; a [0, 1] clip scaled to
    [0, 255]."""
    x = frames * np.asarray(cfg.DATA.STD, np.float32) + np.asarray(cfg.DATA.MEAN, np.float32)
    if x.max() <= 2.0:
        x = x * 255.0
    return np.clip(x, 0, 255).astype(np.uint8)


def _write_video(path, frames, fps=4):
    """``(T, H, W, C)`` RGB uint8 frames to an mp4."""
    import cv2

    os.makedirs(os.path.dirname(path), exist_ok=True)
    h, w = frames.shape[1:3]
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
    for f in frames:
        writer.write(np.ascontiguousarray(f[:, :, ::-1]))  # RGB -> BGR
    writer.release()


def mae_strips(cfg, model, inputs):
    """The ``(B, T, H, 3W, 3)`` uint8 strips (input | masked | reconstruction)
    of one batch of pathways on the model's device."""
    from slowfast_tpu_torch.engine.steps import maybe_device_preprocess

    model.eval()
    with torch.no_grad():
        inputs = maybe_device_preprocess(cfg, inputs)
        preds, labels = model(inputs)
    pred = preds[0].float().cpu().numpy()  # (B, N, D)
    mask = labels[0][1].float().cpu().numpy()  # (B, N)
    clip = inputs[0].float().cpu().numpy()

    pt, ph, pw = cfg.MVIT.PATCH_STRIDE
    T0, H0, W0 = cfg.DATA.NUM_FRAMES // pt, clip.shape[2] // ph, clip.shape[3] // pw
    im_viz = clip[:, ::pt][:, :T0] if cfg.MASK.TIME_STRIDE_LOSS else clip
    vis_patches = _patchify(cfg, im_viz, T0, H0, W0)
    if cfg.MASK.NORM_PRED_PIXEL:
        mu = vis_patches.mean(-1, keepdims=True)
        var = vis_patches.var(-1, keepdims=True)
        pred = pred * np.sqrt(var + 1e-6) + mu
    m = mask[:, :, None]
    recon = _unpatchify(cfg, pred * m + vis_patches * (1 - m), T0, H0, W0)
    masked = _unpatchify(cfg, vis_patches * (1 - m), T0, H0, W0)
    return np.stack([np.concatenate([_to_uint8(cfg, x[i]) for x in (im_viz, masked, recon)],
                                    axis=2) for i in range(clip.shape[0])])


def visualize_mae_batch(cfg, model, inputs, out_dir, counter, rows=None):
    """Render one batch; ``rows`` names each clip's file (its row in the
    global batch; the batch's own rows by default). Returns the paths."""
    strips = mae_strips(cfg, model, inputs)
    rows = range(len(strips)) if rows is None else rows
    paths = []
    for strip, i in zip(strips, rows):
        path = os.path.join(out_dir, f"vis_mask_mr{cfg.AUG.MASK_RATIO}_{counter}_{i}.mp4")
        _write_video(path, strip)
        paths.append(path)
    return paths


def run_mae_visualization(cfg, model, test_loader):
    """Render every test clip (the test's ``VIS_MASK`` mode); each rank
    writes its real rows."""
    from slowfast_tpu_torch.data.loader import rank_rows
    from slowfast_tpu_torch.utils import distributed as du

    out_dir = os.path.join(cfg.OUTPUT_DIR, "vis_mask", "vid")
    world = du.get_world_size()
    n = 0
    for cur_iter, (inputs, labels, _, _, meta) in enumerate(test_loader):
        rows = rank_rows(list(range(len(labels) * world)), du.get_rank(), world, cfg.NUM_SHARDS)
        rows = rows[:meta.get("num_real", len(labels))]
        n += len(visualize_mae_batch(cfg, model, [x[:len(rows)] for x in inputs], out_dir,
                                     cur_iter, rows))
    logger.info("VIS_MASK: wrote %d reconstruction videos to %s", n, out_dir)
    return {"vis_mask_videos": n, "dir": out_dir}
