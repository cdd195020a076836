"""MAE's reconstruction renders of the port against the JAX package, on the
CPU.

The narrow MAE of tests/test_torch_masked.py (a 2-block ViT, 4 frames of
64², one decoder block) on the same seeded weights and the same mask
noise on both sides (``same_noise``): ``visualize_mae_batch``'s strips
(input | masked input | reconstruction, ``(T, H, 3W)`` uint8) within one
level of the JAX package's (the forward's fp32 sums run in another order),
with and without ``MASK.NORM_PRED_PIXEL``'s de-normalization and
``MASK.TIME_STRIDE_LOSS``; the patch order bit-equal to JAX's. Then the
port's ``test`` under ``VIS_MASK.ENABLE`` on synthetic uint8 clips: one mp4
a clip named as JAX's, which cv2 reads back as T frames of H × 3W (T
the patches in time under ``MASK.TIME_STRIDE_LOSS``).
"""

import os
import types

import cv2
import numpy as np
import pytest
import torch

from slowfast_tpu.config import get_cfg as jax_get_cfg
from slowfast_tpu.engine.steps import TrainState
from slowfast_tpu.models import build_model as jax_build_model
from slowfast_tpu.visualization import mae_vis as jax_mae_vis
from slowfast_tpu_torch.config import get_cfg
from slowfast_tpu_torch.visualization import mae_vis

from test_torch_masked import MAE, VIT, clips, jax_variables, make_cfg, noise_for, port_model
from test_torch_masked import same_noise  # noqa: F401  (fixture)
from test_torch_train import one_torch_thread  # noqa: F401  (autouse fixture)
from vis_models import jit_run

CASES = {"norm_pixel": [], "raw_pixel_no_time_stride": ["MASK.NORM_PRED_PIXEL", "False",
                                                        "MASK.TIME_STRIDE_LOSS", "False"]}


def shown_frames(cfg):
    """A strip's frames: one a patch in time under ``MASK.TIME_STRIDE_LOSS``."""
    if cfg.MASK.TIME_STRIDE_LOSS:
        return cfg.DATA.NUM_FRAMES // cfg.MVIT.PATCH_STRIDE[0]
    return cfg.DATA.NUM_FRAMES


def captured(monkeypatch, module):
    """The frames and file names ``module`` would write."""
    written = {}
    monkeypatch.setattr(module, "_write_video",
                        lambda path, frames, fps=4: written.setdefault(os.path.basename(path),
                                                                       frames))
    return written


@pytest.mark.parametrize("case", sorted(CASES))
def test_mae_strips_match_jax(case, same_noise, monkeypatch, tmp_path):  # noqa: F811
    extra = MAE + CASES[case]
    variables = jax_variables(VIT, extra)
    jcfg, cfg = make_cfg(jax_get_cfg, VIT, extra=extra), make_cfg(get_cfg, VIT, extra=extra)
    x = clips(cfg)
    same_noise(noise_for(cfg))

    model = jax_build_model(jcfg)
    jitted = types.SimpleNamespace(apply=lambda v, xs, train: jit_run(
        lambda v, xs: model.apply(v, xs, train=False), v, xs))
    state = TrainState(step=0, params=variables["params"],
                       batch_stats=variables.get("batch_stats", {}), opt_state=None)
    want = captured(monkeypatch, jax_mae_vis)
    jax_mae_vis.visualize_mae_batch(jcfg, jitted, state, [x], str(tmp_path), 3)

    got = captured(monkeypatch, mae_vis)
    paths = mae_vis.visualize_mae_batch(cfg, port_model(variables, VIT, extra=extra),
                                        [torch.from_numpy(x)], str(tmp_path), 3)
    assert [os.path.basename(p) for p in paths] == list(got) == list(want) == [
        "vis_mask_mr0.75_3_0.mp4", "vis_mask_mr0.75_3_1.mp4"]
    t = shown_frames(cfg)
    for name in want:
        assert got[name].dtype == np.uint8
        assert got[name].shape == want[name].shape == (t, 64, 192, 3)
        assert np.abs(got[name].astype(int) - want[name].astype(int)).max() <= 1
        # The middle third is the input with the masked patches at the mean.
        assert (got[name][:, :, 64:128] != got[name][:, :, :64]).any()


@pytest.mark.parametrize("time_stride", [True, False])
def test_patchify_matches_jax(time_stride):
    cfg = make_cfg(get_cfg, VIT, extra=MAE + ["MASK.TIME_STRIDE_LOSS", str(time_stride)])
    frames = np.random.RandomState(0).rand(2, 2 if time_stride else 4, 64, 64, 3)
    T0 = 2
    got = mae_vis._patchify(cfg, frames, T0, 4, 4)
    np.testing.assert_array_equal(got, jax_mae_vis._patchify(cfg, frames, T0, 4, 4))
    np.testing.assert_array_equal(mae_vis._unpatchify(cfg, got, T0, 4, 4), frames)
    np.testing.assert_array_equal(mae_vis._to_uint8(cfg, frames),
                                  jax_mae_vis._to_uint8(cfg, frames))


def test_vis_mask_test_writes_one_video_a_clip(tmp_path):
    from slowfast_tpu_torch.engine.tester import test

    cfg = make_cfg(get_cfg, VIT, extra=MAE + [
        "TEST.DATASET", "syntheticvideo", "DATA.SYNTHETIC_SIZE", "3", "TEST.BATCH_SIZE", "2",
        "TEST.NUM_ENSEMBLE_VIEWS", "1", "TEST.NUM_SPATIAL_CROPS", "1", "VIS_MASK.ENABLE",
        "True", "DATA_LOADER.NUM_WORKERS", "1", "OUTPUT_DIR", str(tmp_path)])
    (result,) = test(cfg, "cpu")
    out = tmp_path / "vis_mask" / "vid"
    names = sorted(os.listdir(out))
    assert result == {"vis_mask_videos": 3, "dir": str(out)}
    assert names == ["vis_mask_mr0.75_0_0.mp4", "vis_mask_mr0.75_0_1.mp4",
                     "vis_mask_mr0.75_1_0.mp4"]
    for name in names:
        cap = cv2.VideoCapture(str(out / name))
        frames = []
        ok, frame = cap.read()
        while ok:
            frames.append(frame)
            ok, frame = cap.read()
        cap.release()
        assert len(frames) == shown_frames(cfg) and frames[0].shape == (64, 192, 3)
