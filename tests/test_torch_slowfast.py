"""The slice end to end: a narrow SLOWFAST_4x16_R50 through the port's eval
step and multi-view tester against the JAX package's.

The config keeps the recipe's graph (ALPHA/BETA_INV, fusion, temporal
kernels, test crop larger than train crop, so the head averages softmax
over positions) at small widths: depth 18, width 8, 8 frames, alpha 4,
train crop 32, test crop 40, 16 classes. JAX variables are shaped by a
traced ``init_model`` and filled with seeded random values (every
parameter and BN statistic; gamma and variance in [0.5, 1.5]).
"""

import json
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from slowfast_tpu.config import get_cfg as jax_get_cfg
from slowfast_tpu.data.kinetics import Syntheticvideo as JaxSyntheticvideo
from slowfast_tpu.engine.steps import TrainState, make_eval_step as jax_make_eval_step
from slowfast_tpu.models import build_model as jax_build_model
from slowfast_tpu.models.build import init_model
from slowfast_tpu.utils import metrics as jax_metrics
from slowfast_tpu.utils.meters import TestMeter as JaxTestMeter
from slowfast_tpu_torch.config import assert_and_infer_cfg, get_cfg
from slowfast_tpu_torch.engine.steps import make_eval_step
from slowfast_tpu_torch.engine.tester import test as port_test
from slowfast_tpu_torch.models.build import build_model
from slowfast_tpu_torch.run_net import main as run_net_main
from slowfast_tpu_torch.utils import metrics as port_metrics
from slowfast_tpu_torch.utils.checkpoint import state_dict_from_jax

YAML = os.path.join(os.path.dirname(__file__), "..", "configs", "Kinetics",
                    "SLOWFAST_4x16_R50.yaml")
NARROW = [
    "RESNET.DEPTH", "18", "RESNET.WIDTH_PER_GROUP", "8",
    "RESNET.NUM_BLOCK_TEMP_KERNEL", "[[2,2],[2,2],[2,2],[2,2]]",
    "DATA.NUM_FRAMES", "8", "SLOWFAST.ALPHA", "4",
    "DATA.TRAIN_CROP_SIZE", "32", "DATA.TEST_CROP_SIZE", "40",
    "MODEL.NUM_CLASSES", "16", "NUM_GPUS", "1", "TRAIN.ENABLE", "False",
    "DATA_LOADER.NUM_WORKERS", "2", "TEST.BATCH_SIZE", "2",
]
# fp32: only summation order differs. bf16: the two frameworks round
# activations to bf16 at different places through 18 layers.
FP32_ATOL, BF16_ATOL = 1e-5, 2e-2


def narrow_cfg(get, dtype="float32", extra=()):
    cfg = get()
    cfg.merge_from_file(YAML)
    cfg.merge_from_list(NARROW + ["TPU.COMPUTE_DTYPE", dtype] + list(extra))
    return cfg


def randomize(shapes, seed):
    rng = np.random.RandomState(seed)
    out = {}
    for path, s in traverse_util.flatten_dict(shapes).items():
        leaf = path[-1]
        if leaf == "kernel":
            v = rng.normal(0.0, np.sqrt(1.0 / np.prod(s.shape[:-1])), s.shape)
        elif leaf in ("scale", "var"):
            v = rng.uniform(0.5, 1.5, s.shape)
        else:
            v = rng.normal(0.0, 0.1, s.shape)
        out[path] = v.astype(np.float32)
    return traverse_util.unflatten_dict(out)


class JaxSide:
    """The JAX model, its random variables and jitted eval steps."""

    def __init__(self):
        self.cfg = narrow_cfg(jax_get_cfg)
        model = jax_build_model(self.cfg)
        shapes = jax.eval_shape(
            lambda: init_model(model, self.cfg, rng=jax.random.PRNGKey(0), train=False))
        self.variables = randomize(dict(shapes), 0)
        self.state = TrainState(step=0, params=self.variables["params"],
                                batch_stats=self.variables["batch_stats"], opt_state=None)
        self._steps = {}

    def eval(self, clips, dtype="float32"):
        if dtype not in self._steps:
            cfg = narrow_cfg(jax_get_cfg, dtype)
            self._steps[dtype] = jax_make_eval_step(cfg, jax_build_model(cfg))
        out = self._steps[dtype](self.state, {"inputs": [jnp.asarray(clips)]})
        return np.asarray(out).astype(np.float32)


@pytest.fixture(scope="module")
def jax_side():
    return JaxSide()


def port_model(jax_side, dtype):
    model = build_model(narrow_cfg(get_cfg, dtype), device="cpu")
    model.load_state_dict(state_dict_from_jax(jax_side.variables), strict=True)
    return model


def _clips(seed):
    return np.random.RandomState(seed).randint(0, 255, (2, 8, 40, 40, 3)).astype(np.uint8)


@pytest.mark.parametrize("dtype,atol", [("float32", FP32_ATOL), ("bfloat16", BF16_ATOL)])
def test_eval_step_matches_jax(jax_side, dtype, atol):
    clips = _clips(1)
    want = jax_side.eval(clips, dtype)
    step = make_eval_step(narrow_cfg(get_cfg, dtype), port_model(jax_side, dtype))
    got = step({"inputs": [torch.from_numpy(clips)]})
    assert got.dtype == (torch.bfloat16 if dtype == "bfloat16" else torch.float32)
    got = got.float().numpy()
    assert got.shape == (2, 16)
    # Not a saturated softmax: the comparison sees the whole distribution.
    assert want.max() < 0.9
    np.testing.assert_allclose(got, want, atol=atol, rtol=0)


@pytest.mark.parametrize("views,crops,method", [(2, 1, "sum"), (1, 2, "max")])
def test_tester_matches_jax_test_meter(jax_side, tmp_path, views, crops, method):
    """test(cfg, device="cpu") on Syntheticvideo, weights loaded through
    TEST.CHECKPOINT_FILE_PATH, against a JAX TestMeter fed by the JAX eval
    step on the same batches."""
    ckpt = tmp_path / "bridged.pyth"
    torch.save({"model_state": state_dict_from_jax(jax_side.variables)}, ckpt)
    extra = ["TEST.DATASET", "syntheticvideo", "DATA.SYNTHETIC_SIZE", "2",
             "TEST.NUM_ENSEMBLE_VIEWS", str(views), "TEST.NUM_SPATIAL_CROPS", str(crops),
             "TEST.CHECKPOINT_FILE_PATH", str(ckpt), "OUTPUT_DIR", str(tmp_path),
             "TEST.SAVE_RESULTS_PATH", str(tmp_path / "results.pkl"),
             "DATA.ENSEMBLE_METHOD", method]
    cfg = assert_and_infer_cfg(narrow_cfg(get_cfg, extra=extra))
    (stats,) = port_test(cfg, device="cpu")
    with open(tmp_path / "results.pkl", "rb") as f:
        video_preds, video_labels = pickle.load(f)

    jcfg = narrow_cfg(jax_get_cfg, extra=extra)
    dataset = JaxSyntheticvideo(jcfg, "test")
    num_clips = views * crops
    meter = JaxTestMeter(dataset.num_videos // num_clips, num_clips, 16, 2,
                         ensemble_method=method)
    for start in range(0, len(dataset), 2):
        samples = [dataset[i] for i in range(start, start + 2)]
        clips = np.stack([s[0][0] for s in samples])
        meter.update_stats(jax_side.eval(clips), [s[1] for s in samples],
                           [s[2] for s in samples])
    want = meter.finalize_metrics()

    np.testing.assert_array_equal(video_labels, meter.video_labels)
    np.testing.assert_allclose(video_preds, meter.video_preds, atol=num_clips * FP32_ATOL)
    assert stats["_type"] == "test_final"
    assert (stats["top1_acc"], stats["top5_acc"]) == (want["top1_acc"], want["top5_acc"])
    logged = (tmp_path / "json_stats.log").read_text().splitlines()
    assert json.loads(logged[-1].split("json_stats: ")[1]) == stats


@pytest.mark.parametrize("seed", [0, 1])
def test_topk_metrics_match_jax(seed):
    rng = np.random.RandomState(seed)
    preds, labels = rng.rand(12, 16).astype(np.float32), rng.randint(0, 16, 12)
    for name in ("topks_correct", "topk_errors", "topk_accuracies"):
        want = getattr(jax_metrics, name)(jnp.asarray(preds), jnp.asarray(labels), (1, 5))
        got = getattr(port_metrics, name)(torch.from_numpy(preds), torch.from_numpy(labels),
                                          (1, 5))
        np.testing.assert_allclose([float(g) for g in got], [float(w) for w in want],
                                   rtol=1e-6, err_msg=name)


def test_run_net_cli_runs_the_test(tmp_path):
    run_net_main([
        "--device", "cpu", "--cfg", YAML, "--opts", *NARROW,
        "TPU.COMPUTE_DTYPE", "float32", "TEST.DATASET", "syntheticvideo",
        "DATA.SYNTHETIC_SIZE", "1", "TEST.NUM_ENSEMBLE_VIEWS", "1",
        "TEST.NUM_SPATIAL_CROPS", "2", "OUTPUT_DIR", str(tmp_path),
    ])
    last = (tmp_path / "json_stats.log").read_text().splitlines()[-1]
    stats = json.loads(last.split("json_stats: ")[1])
    assert stats["_type"] == "test_final" and "top1_acc" in stats


def test_run_net_refuses_training(tmp_path):
    """``run_net`` refuses to train on what the port lacks, before any
    step: a dataset it has not ported (every dataset of the JAX package is
    ported since ImageNet, tests/test_torch_imagenet.py; UCF-101 is in
    neither). The elementwise gradient clip is ported
    (tests/test_torch_ddp_misc.py), and LARS (tests/test_torch_contrastive.py).
    One process: the recipe's ``NUM_GPUS 8`` would spawn 8 ranks."""
    with pytest.raises(NotImplementedError, match="dataset 'Ucf101' is not ported"):
        run_net_main(["--device", "cpu", "--cfg", YAML, "--opts", "TRAIN.DATASET", "ucf101",
                      "NUM_GPUS", "1", "TRAIN.ENABLE", "True", "OUTPUT_DIR", str(tmp_path)])


def test_cuda_is_the_default_and_never_falls_back():
    """Entry points run on the card unless asked for the CPU; without CUDA
    they raise instead of moving to the CPU."""
    if torch.cuda.is_available():
        assert next(build_model(narrow_cfg(get_cfg)).parameters()).is_cuda
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            build_model(narrow_cfg(get_cfg))
