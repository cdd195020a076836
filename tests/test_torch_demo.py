"""The video demo of the port against the JAX package, on the CPU.

``VideoVisualizer``'s frames bit-equal to JAX's on the same frames and
predictions (top-k, thresholds, boxes, ground truth, a keyframe range and
repeated frames), and its seeded colours where matplotlib does not import.
``Predictor`` on a narrow C2D R18 (width 8, 4 frames of 64², 8 classes)
with one PySlowFast ``.pyth`` loaded by both packages: the host clip
bit-equal to the one JAX's eval step takes, the predictions within 1e-5
(fp32; sums in another order). ``AsyncPredictor``: the cases of
tests/test_demo_async.py. ``run_net`` with ``DEMO.ENABLE`` on the mp4 of
tests/test_demo_e2e.py writes as many frames as JAX's demo; the threaded
reader with two clips in flight predicts what the plain loop predicts. The
motion proposals equal JAX's frame by frame; a detector weights file
raises (JAX's raises ``NameError``, ROADMAP Queue 3 #46). The
precomputed-box visualizer on a narrow Slow detection model writes the
frames JAX's writes.
"""

import csv
import sys
import time

import cv2
import numpy as np
import pytest
import torch

from slowfast_tpu.config import get_cfg as jax_get_cfg
from slowfast_tpu.visualization import demo as jax_demo
from slowfast_tpu.visualization import video_visualizer as jax_vv
from slowfast_tpu_torch.config import assert_and_infer_cfg, get_cfg
from slowfast_tpu_torch.models.build import build_model
from slowfast_tpu_torch.visualization import demo, video_visualizer

from test_torch_detection import det_cfg
from test_torch_train import one_torch_thread  # noqa: F401  (autouse fixture)
from vis_models import jitted_jax_init

C2D = ["MODEL.MODEL_NAME", "ResNet", "MODEL.ARCH", "c2d", "MODEL.NUM_CLASSES", "8",
       "RESNET.DEPTH", "18", "RESNET.WIDTH_PER_GROUP", "8",
       "RESNET.NUM_BLOCK_TEMP_KERNEL", "[[1],[1],[1],[1]]", "DATA.NUM_FRAMES", "4",
       "DATA.SAMPLING_RATE", "2", "DATA.TEST_CROP_SIZE", "64", "DATA.TRAIN_CROP_SIZE", "64",
       "DATA.INPUT_CHANNEL_NUM", "[3]", "TPU.COMPUTE_DTYPE", "float32", "NUM_GPUS", "1"]


def cfg_of(get, opts, checkpoint=None, extra=()):
    cfg = get()
    cfg.merge_from_list(list(opts) + list(extra))
    if checkpoint:
        cfg.TEST.CHECKPOINT_FILE_PATH = str(checkpoint)
    return cfg


def save_checkpoint(path, cfg):
    """A PySlowFast ``.pyth`` of the port's seeded model, which both
    packages load."""
    torch.save({"model_state": build_model(cfg, device="cpu").state_dict()}, str(path))
    return path


def write_video(path, n=40, size=(96, 96), fps=30.0, seed=0):
    """tests/test_demo_e2e.py's clip: a seeded image rolled 3 pixels a frame."""
    writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), fps, size)
    frame = (np.random.RandomState(seed).rand(size[1], size[0], 3) * 255).astype(np.uint8)
    for _ in range(n):
        frame = np.roll(frame, 3, axis=1)
        writer.write(frame)
    writer.release()
    return str(path)


def read_frames(path):
    cap = cv2.VideoCapture(str(path))
    frames = []
    ok, frame = cap.read()
    while ok:
        frames.append(frame)
        ok, frame = cap.read()
    cap.release()
    return frames


# --- VideoVisualizer ---------------------------------------------------------

VIS_CASES = {
    "top_k": (dict(top_k=3), dict()),
    "thres": (dict(mode="thres", thres=0.5, lower_thres=0.2, common_class_names=["1", "4"]),
              dict()),
    "boxes": (dict(mode="thres", thres=0.3), dict(boxes=True)),
    "ground_truth": (dict(), dict(boxes=True, ground_truth=True)),
    "keyframe_repeat": (dict(top_k=2, colormap="viridis"), dict(keyframe_idx=2, repeat_frame=2)),
}


@pytest.mark.parametrize("case", sorted(VIS_CASES))
def test_video_visualizer_frames_equal_jax(case):
    kwargs, draw = VIS_CASES[case]
    rs = np.random.RandomState(3)
    frames = rs.randint(0, 256, (6, 48, 64, 3)).astype(np.uint8)
    boxes = np.array([[4, 6, 30, 40], [20, 2, 60, 44]], np.float32)
    preds = rs.rand(2, 6) if draw.get("boxes") else rs.rand(6)
    outs = []
    for module in (jax_vv, video_visualizer):
        vis = module.VideoVisualizer(6, **kwargs)
        if draw.get("ground_truth"):
            outs.append([vis.draw_one_frame(f.copy(), (preds > 0.5).astype(float),
                                            bboxes=boxes, ground_truth=True) for f in frames])
        else:
            outs.append(vis.draw_clip_range(
                [f.copy() for f in frames], preds, bboxes=boxes if draw.get("boxes") else None,
                keyframe_idx=draw.get("keyframe_idx"), repeat_frame=draw.get("repeat_frame", 1)))
    want, got = outs
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert any((g != f).any() for g, f in zip(got, frames))


def test_class_colors_without_matplotlib_match_jax(monkeypatch):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    want = jax_vv.VideoVisualizer(5)._colors
    got = video_visualizer.VideoVisualizer(5)._colors
    assert got == want and len(set(got)) == 5
    assert all(64 <= c < 255 for color in got for c in color)


# --- Predictor and AsyncPredictor ---------------------------------------------

@pytest.fixture(scope="module")
def c2d(tmp_path_factory):
    """The narrow C2D's checkpoint and the JAX package's ``Predictor`` on
    it, whose eval step records the pathways it is given."""
    ckpt = save_checkpoint(tmp_path_factory.mktemp("c2d") / "c2d.pyth", cfg_of(get_cfg, C2D))
    with jitted_jax_init():
        jax_pred = jax_demo.Predictor(cfg_of(jax_get_cfg, C2D, ckpt))
    real_eval = jax_pred.eval_fn

    def eval_fn(state, batch):
        jax_pred.seen = [np.asarray(x) for x in batch["inputs"]]
        return real_eval(state, batch)

    jax_pred.eval_fn = eval_fn
    return ckpt, jax_pred


def test_predictor_matches_jax(c2d):
    ckpt, jax_pred = c2d
    pred = demo.Predictor(cfg_of(get_cfg, C2D, ckpt), "cpu")
    rs = np.random.RandomState(5)
    for _ in range(2):
        frames = list(rs.randint(0, 256, (8, 72, 96, 3)).astype(np.uint8))
        task, want_task = demo.TaskInfo(), jax_demo.TaskInfo()
        task.frames = want_task.frames = frames
        want = jax_pred(want_task).action_preds
        clip = demo.host_clip(pred.cfg, frames)
        assert [c.dtype for c in clip] == [np.float32]
        np.testing.assert_array_equal(clip[0][None], jax_pred.seen[0])
        got = pred(task).action_preds
        assert got.shape == want.shape == (1, 8)
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


class _SlowDoubler:
    def __init__(self, fail_on=None):
        self.fail_on = fail_on

    def __call__(self, task):
        time.sleep(0.01)
        if task == self.fail_on:
            raise ValueError("boom")
        return task * 2


def test_async_predictor_preserves_order():
    p = demo.AsyncPredictor(cfg=None, num_inflight=2, predictor=_SlowDoubler())
    got = list(p.run(range(7)))
    p.shutdown()
    assert got == [0, 2, 4, 6, 8, 10, 12]


def test_async_predictor_propagates_errors():
    p = demo.AsyncPredictor(cfg=None, num_inflight=2, predictor=_SlowDoubler(fail_on=3))
    with pytest.raises(ValueError, match="boom"):
        list(p.run(range(6)))


def test_async_predictor_single_item():
    p = demo.AsyncPredictor(cfg=None, num_inflight=2, predictor=_SlowDoubler())
    assert list(p.run([5])) == [10]
    p.shutdown()


# --- the demo end to end -----------------------------------------------------

DEMO = ["DEMO.ENABLE", "True", "DEMO.THREAD_ENABLE", "False", "DEMO.NUM_VIS_INSTANCES", "1",
        "DEMO.BUFFER_SIZE", "0"]


def test_demo_writes_the_frames_jax_writes(tmp_path, c2d, monkeypatch):
    from slowfast_tpu.config.defaults import assert_and_infer_cfg as jax_infer
    from slowfast_tpu_torch.run_net import main

    src = write_video(tmp_path / "in.mp4")
    ckpt, jax_pred = c2d
    monkeypatch.setattr(jax_demo, "Predictor", lambda cfg: jax_pred)  # built on the same cfg
    io = lambda name: ["DEMO.INPUT_VIDEO", src, "DEMO.OUTPUT_FILE",  # noqa: E731
                       str(tmp_path / name), "OUTPUT_DIR", str(tmp_path)]
    jax_demo.demo(jax_infer(cfg_of(jax_get_cfg, C2D, ckpt, DEMO + io("jax.mp4"))))
    main(["--device", "cpu", "--opts", *C2D, *DEMO, *io("port.mp4"), "TRAIN.ENABLE", "False",
          "TEST.ENABLE", "False", "TEST.CHECKPOINT_FILE_PATH", str(ckpt)])
    want, got = read_frames(tmp_path / "jax.mp4"), read_frames(tmp_path / "port.mp4")
    assert len(got) == len(want) == 40 // 8 * 8
    assert any((g != w).any() for g, w in zip(got, read_frames(src)))  # annotated

    # The threaded reader with two clips in flight: the same predictions.
    def preds(extra):
        cfg = assert_and_infer_cfg(cfg_of(get_cfg, C2D, ckpt, DEMO + io("x.mp4") + extra))
        manager = (demo.ThreadVideoManager if cfg.DEMO.THREAD_ENABLE else demo.VideoManager)(cfg)
        try:
            return [(t.id, t.action_preds) for t in demo.run_demo(cfg, manager, "cpu")]
        finally:
            manager.clean()

    plain = preds([])
    threaded = preds(["DEMO.THREAD_ENABLE", "True", "DEMO.NUM_VIS_INSTANCES", "2"])
    assert [i for i, _ in threaded] == [i for i, _ in plain] == list(range(5))
    for (_, a), (_, b) in zip(threaded, plain):
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=0)


# --- detection: motion proposals and precomputed boxes -------------------------

def test_motion_boxes_equal_jax():
    want = jax_demo.PersonDetector(jax_get_cfg())
    got = demo.PersonDetector(get_cfg())
    bg = (np.random.RandomState(1).rand(120, 160, 3) * 60).astype(np.uint8)
    found = 0
    for t in range(12):
        frame = bg.copy()
        frame[30:90, 20 + 8 * t:38 + 8 * t] = 220  # a tall bright blob marching right
        w, g = want(frame), got(frame)
        np.testing.assert_array_equal(g, w)
        found += len(g)
    assert found > 0


def test_detector_weights_file_raises(tmp_path):
    weights = tmp_path / "rcnn.pth"
    weights.write_bytes(b"not read")
    for get, error in ((get_cfg, NotImplementedError), (jax_get_cfg, NameError)):
        cfg = get()
        cfg.DEMO.DETECTRON2_WEIGHTS = str(weights)
        with pytest.raises(error):
            (demo if get is get_cfg else jax_demo).PersonDetector(cfg)


def test_precomputed_box_visualizer_writes_jax_frames(tmp_path):
    src = write_video(tmp_path / "ava.mp4", n=24, size=(96, 72), fps=8.0, seed=2)
    with open(tmp_path / "preds.csv", "w") as f:
        csv.writer(f).writerows([["v", 900, 0.1, 0.1, 0.6, 0.9, 0.95],
                                 ["v", 900, 0.5, 0.2, 0.9, 0.8, 0.5],
                                 ["v", 901, 0.2, 0.1, 0.7, 0.9, 0.99],
                                 ["v", 902, 0.3, 0.3, 0.5, 0.5, 0.1]])
    with open(tmp_path / "gt.csv", "w") as f:
        csv.writer(f).writerows([["v", 900, 0.1, 0.1, 0.6, 0.9, 2],
                                 ["v", 900, 0.1, 0.1, 0.6, 0.9, 5]])
    extra = ["DATA.SAMPLING_RATE", "2", "DEMO.ENABLE", "True", "DEMO.INPUT_VIDEO", src,
             "DEMO.PREDS_BOXES", str(tmp_path / "preds.csv"),
             "DEMO.GT_BOXES", str(tmp_path / "gt.csv"), "DEMO.SLOWMO", "2",
             "OUTPUT_DIR", str(tmp_path)]
    ckpt = save_checkpoint(tmp_path / "det.pyth", det_cfg(get_cfg, "slow", extra=extra))
    extra += ["TEST.CHECKPOINT_FILE_PATH", str(ckpt)]
    with jitted_jax_init():
        n = jax_demo.demo(det_cfg(jax_get_cfg, "slow", extra=extra + [
            "DEMO.OUTPUT_FILE", str(tmp_path / "jax.mp4")]))
    got = demo.demo(det_cfg(get_cfg, "slow", extra=extra + [
        "DEMO.OUTPUT_FILE", str(tmp_path / "port.mp4")]), "cpu")
    assert got == n == 3
    want, got = read_frames(tmp_path / "jax.mp4"), read_frames(tmp_path / "port.mp4")
    assert len(got) == len(want) == 2 * 24
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
