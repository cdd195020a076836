"""Losses that divide by a count of the data, under data parallelism, on 2
gloo ranks on the CPU: each rank divides its sum by the global count and
scales by the world size, so that the mean of the ranks' gradients is the
global loss's, as the JAX package's step on the global batch computes it
(slowfast_tpu/engine/steps.py:106-127).

* Detection: narrow Slow R18 on AVA's ``SLOW_4x16_R50_DETECTION`` (width
  8, 64², every parameter and BN statistic seeded random), global batches
  of 4 clips with 3, 1, 0 and 2 real boxes, so rank 0 holds 4 and rank 1
  2; the loss is BCE over the real boxes.
* MaskFeat: the narrow ViT MaskMViT of tests/test_torch_masked.py with HOG
  targets and the loader's masks (about half the window), which cover
  other counts on each rank.

Each runs 3 fp32 SGD steps. Against JAX's ``make_train_step`` on a
2-device mesh, each port step from JAX's state: the loss within rtol 1e-5,
the parameters and BN statistics after each step within 1e-4 relative L2.
Against the port in one process on the global batch, each 2-rank step from
its state: within 1e-6 (detection's fp32 misses decided in float64, as in
tests/test_torch_ddp.py; MaskMViT takes its norms in fp32 and has no
float64 step).
"""

import os

import numpy as np
import pytest

from ddp_harness import check_one_process, port_cfg
from ddp_harness import one_torch_thread  # noqa: F401  (autouse fixture)
from test_torch_ddp import SGD, STEPS, spawn_cases

CLIPS = 4
BOXES = (3, 1, 0, 2)  # real boxes a clip: 4 on rank 0, 2 on rank 1
M = 4  # padded boxes a clip


def detection():
    from test_torch_detection import CONFIGS, MODELS, NARROW

    yaml, opts = MODELS["slow"]
    return os.path.join(CONFIGS, yaml), NARROW + opts + SGD + ["TRAIN.BATCH_SIZE", str(CLIPS)]


def maskfeat():
    from test_torch_masked import HOG_HEAD, VIT

    return VIT[0], VIT[1] + HOG_HEAD + SGD + ["AUG.GEN_MASK_LOADER", "True",
                                              "TRAIN.BATCH_SIZE", str(CLIPS)]


def detection_batches(cfg, seed):
    rs = np.random.RandomState(seed)
    crop, t, k = cfg.DATA.TRAIN_CROP_SIZE, cfg.DATA.NUM_FRAMES, cfg.MODEL.NUM_CLASSES
    out = []
    for i in range(STEPS):
        boxes = np.zeros((CLIPS, M, 4), np.float32)
        mask = np.zeros((CLIPS, M), np.float32)
        labels = np.zeros((CLIPS, M, k), np.float32)
        for b, n in enumerate(BOXES):
            xy1 = rs.rand(n, 2) * (crop / 2)
            boxes[b, :n] = np.concatenate([xy1, xy1 + rs.rand(n, 2) * (crop / 2) + 2.0], axis=1)
            mask[b, :n] = 1.0
            labels[b, :n] = rs.rand(n, k) < 0.3
        out.append({"inputs": [rs.randint(0, 256, (CLIPS, t, crop, crop, 3)).astype(np.uint8)],
                    "labels": labels, "boxes": boxes, "box_mask": mask,
                    "epoch_exact": 0.1 * (i + 1)})
    return out


def maskfeat_batches(cfg, seed):
    rs = np.random.RandomState(seed)
    crop, t = cfg.DATA.TRAIN_CROP_SIZE, cfg.DATA.NUM_FRAMES
    return [{"inputs": [rs.normal(0.0, 1.0, (CLIPS, t, crop, crop, 3)).astype(np.float32)],
             "labels": np.zeros((CLIPS,), np.int64),
             "mask": (rs.rand(CLIPS, *cfg.AUG.MASK_WINDOW_SIZE) > 0.5).astype(np.float32),
             "epoch_exact": 0.1 * (i + 1)} for i in range(STEPS)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from ddp_jax import jax_cfg, jax_variables, mesh_run

    cases = {}
    for name, (yaml, opts), make, seed in (("detection", detection(), detection_batches, 3),
                                           ("maskfeat", maskfeat(), maskfeat_batches, 4)):
        jcfg = jax_cfg(opts, yaml)
        batches = make(port_cfg(opts, yaml), seed)
        cases[name] = (opts, batches, mesh_run(jcfg, jax_variables(jcfg, seed), batches),
                       {"yaml": yaml})
    return spawn_cases(tmp_path_factory.mktemp("losses"), cases, float64={"detection"})


def test_counts_differ_between_the_ranks():
    for batch in detection_batches(port_cfg(detection()[1], detection()[0]), 3):
        assert batch["box_mask"][:2].sum() != batch["box_mask"][2:].sum()
    for batch in maskfeat_batches(port_cfg(maskfeat()[1], maskfeat()[0]), 4):
        assert batch["mask"][:2].sum() != batch["mask"][2:].sum()


@pytest.mark.parametrize("name", ["detection", "maskfeat"])
def test_two_ranks_match_jax_on_a_two_device_mesh(runs, name):
    from ddp_jax import check_jax_steps

    assert check_jax_steps(runs[name]["jax"], runs[name]["jax_run"]) > 1e-4


@pytest.mark.parametrize("name", ["detection", "maskfeat"])
def test_two_ranks_match_one_process(runs, name):
    r = runs[name]
    check_one_process(r["one"], r["one_process"], r["one64"], r["one_process64"])
