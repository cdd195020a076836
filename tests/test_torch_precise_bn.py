"""Precise BN of the port against the JAX package's, on the CPU, and the
CNN recipes trained through ``run_net`` with it.

* ``engine.precise_bn.compute_precise_bn_stats`` against the JAX package's
  ``compute_precise_bn_stats`` on a narrow SLOWFAST_4x16_R50 (the one of
  tests/test_torch_slowfast.py) and a narrow X3D-M, every parameter and BN
  statistic set to a seeded random value, over 3 batches of seeded uint8
  clips through the preprocess: every BN's running mean and variance
  within rtol 1e-4 and atol 1e-4. That is the fp32 forward's own noise at
  this depth: the deepest variances differ by up to 1.6e-4 relative
  between the two packages, and by up to 1.1e-4 (port) and 1.5e-4 (JAX)
  from the port run with float64 activations. The parameters, the model
  generator's state and the train/eval mode stay as they were.
* ``run_net --device cpu`` trains and then tests each CNN recipe
  (SLOWFAST_4x16_R50, X3D_M, C2D_8x8_R50, I3D_NLN_8x8_R50, SLOW_8x8_R50, all
  with SGD, head dropout 0.5 and precise BN) at a tiny size on synthetic
  video. The epoch's checkpoint holds precise statistics: recomputing them
  from its own weights over the epoch's train batches gives them back
  exactly, and they differ from the running averages of the train steps.
"""

import os

import jax
import numpy as np
import pytest
import torch

from slowfast_tpu.config import get_cfg as jax_get_cfg
from slowfast_tpu.engine.precise_bn import compute_precise_bn_stats as jax_precise_bn
from slowfast_tpu.engine.steps import TrainState
from slowfast_tpu.models import build_model as jax_build_model
from slowfast_tpu.models.build import init_model
from slowfast_tpu_torch.config import assert_and_infer_cfg, get_cfg
from slowfast_tpu_torch.data import construct_loader, shuffle_dataset
from slowfast_tpu_torch.engine.precise_bn import compute_precise_bn_stats
from slowfast_tpu_torch.models.build import build_model
from slowfast_tpu_torch.run_net import main as run_net_main
from slowfast_tpu_torch.utils import checkpoint as cu
from slowfast_tpu_torch.utils.checkpoint import state_dict_from_jax
from test_torch_slowfast import NARROW as SLOWFAST_NARROW
from test_torch_slowfast import randomize
from test_torch_train import one_torch_thread  # noqa: F401  (autouse fixture)

KINETICS = os.path.join(os.path.dirname(__file__), "..", "configs", "Kinetics")
X3D_NARROW = ["X3D.WIDTH_FACTOR", "0.5", "X3D.DEPTH_FACTOR", "0.5", "X3D.DIM_C5", "32",
              "DATA.NUM_FRAMES", "4", "DATA.TRAIN_CROP_SIZE", "32", "MODEL.NUM_CLASSES", "16",
              "NUM_GPUS", "1"]
MODELS = {"slowfast": ("SLOWFAST_4x16_R50.yaml", SLOWFAST_NARROW),
          "x3d": ("X3D_M.yaml", X3D_NARROW)}


def model_cfg(get, name):
    yaml, narrow = MODELS[name]
    cfg = get()
    cfg.merge_from_file(os.path.join(KINETICS, yaml))
    cfg.merge_from_list(list(narrow) + ["TPU.COMPUTE_DTYPE", "float32"])
    return cfg


def clip_batches(cfg, n=3):
    crop = cfg.DATA.TRAIN_CROP_SIZE
    rng = np.random.RandomState(5)
    return [rng.randint(0, 256, (2, cfg.DATA.NUM_FRAMES, crop, crop, 3)).astype(np.uint8)
            for _ in range(n)]


@pytest.mark.parametrize("name", sorted(MODELS))
def test_precise_bn_matches_jax(name):
    jcfg = model_cfg(jax_get_cfg, name)
    jmodel = jax_build_model(jcfg)
    shapes = jax.eval_shape(
        lambda: init_model(jmodel, jcfg, rng=jax.random.PRNGKey(0), train=False))
    variables = randomize(dict(shapes), 6)
    batches = clip_batches(jcfg)
    state = TrainState(step=0, params=variables["params"],
                       batch_stats=variables["batch_stats"], opt_state=None)
    want = jax_precise_bn(jcfg, jmodel, state, [([b], None, None, None, None) for b in batches],
                          len(batches))
    want = state_dict_from_jax({"params": {}, "batch_stats": want.batch_stats})

    cfg = model_cfg(get_cfg, name)
    model = build_model(cfg, device="cpu")
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    model.eval()
    params = {n: p.detach().clone() for n, p in model.named_parameters()}
    tracked = {n: b.clone() for n, b in model.named_buffers() if n.endswith("tracked")}
    gen = model.head.generator
    gen_state = gen.get_state()
    n = compute_precise_bn_stats(cfg, model, [([torch.from_numpy(b)],) for b in batches], 5)
    assert n == len(batches)
    sd = model.state_dict()
    stats = [k for k in want if not k.endswith("tracked")]
    assert stats and sorted(stats) == sorted(
        k for k in sd if k.endswith(("running_mean", "running_var")))
    for k in stats:
        np.testing.assert_allclose(sd[k].numpy(), want[k].numpy(), rtol=1e-4, atol=1e-4,
                                   err_msg=k)
    for k, p in model.named_parameters():
        assert torch.equal(p, params[k]), k
    for k, b in tracked.items():
        assert torch.equal(sd[k], b), k
    assert torch.equal(gen.get_state(), gen_state)
    assert not model.training


RECIPES = {
    "SLOWFAST_4x16_R50.yaml": ["RESNET.DEPTH", "18", "RESNET.WIDTH_PER_GROUP", "8",
                               "DATA.NUM_FRAMES", "8", "SLOWFAST.ALPHA", "4"],
    "X3D_M.yaml": ["X3D.WIDTH_FACTOR", "0.5", "X3D.DEPTH_FACTOR", "0.5", "X3D.DIM_C5", "16",
                   "DATA.NUM_FRAMES", "4"],
    "C2D_8x8_R50.yaml": ["RESNET.DEPTH", "18", "RESNET.WIDTH_PER_GROUP", "4",
                         "DATA.NUM_FRAMES", "4"],
    "I3D_NLN_8x8_R50.yaml": ["RESNET.DEPTH", "18", "RESNET.WIDTH_PER_GROUP", "4",
                             "DATA.NUM_FRAMES", "4",
                             "NONLOCAL.LOCATION", "[[[]], [[1]], [[1]], [[]]]"],
    "SLOW_8x8_R50.yaml": ["RESNET.DEPTH", "18", "RESNET.WIDTH_PER_GROUP", "4",
                          "DATA.NUM_FRAMES", "4"],
}
TINY = ["DATA.TRAIN_CROP_SIZE", "32", "DATA.TEST_CROP_SIZE", "32", "MODEL.NUM_CLASSES", "8",
        "NUM_GPUS", "1", "TRAIN.DATASET", "syntheticvideo", "TEST.DATASET", "syntheticvideo",
        "DATA.SYNTHETIC_SIZE", "6", "TRAIN.BATCH_SIZE", "2", "TEST.BATCH_SIZE", "2",
        "TEST.NUM_ENSEMBLE_VIEWS", "1", "TEST.NUM_SPATIAL_CROPS", "1", "SOLVER.MAX_EPOCH", "1",
        "BN.NUM_BATCHES_PRECISE", "2", "DATA_LOADER.NUM_WORKERS", "2",
        "TPU.COMPUTE_DTYPE", "float32"]


@pytest.mark.parametrize("yaml", sorted(RECIPES))
def test_run_net_trains_and_tests_the_recipe(yaml, tmp_path):
    argv = ["--device", "cpu", "--cfg", os.path.join(KINETICS, yaml), "--opts",
            *RECIPES[yaml], *TINY, "OUTPUT_DIR", str(tmp_path)]
    run_net_main(argv)
    cfg = get_cfg()
    cfg.merge_from_file(os.path.join(KINETICS, yaml))
    cfg.merge_from_list(argv[argv.index("--opts") + 1:])
    cfg = assert_and_infer_cfg(cfg)
    assert cfg.SOLVER.OPTIMIZING_METHOD == "sgd" and cfg.MODEL.DROPOUT_RATE == 0.5
    assert cfg.BN.USE_PRECISE_STATS
    logged = (tmp_path / "json_stats.log").read_text()
    assert '"train_epoch"' in logged and '"test_final"' in logged

    ckpt = torch.load(cu.get_path_to_checkpoint(str(tmp_path), 1), weights_only=True)
    model = build_model(cfg, device="cpu")
    model.load_state_dict(ckpt["model_state"], strict=True)
    saved = {k: v.clone() for k, v in model.state_dict().items() if "running_" in k}
    loader = construct_loader(cfg, "train", device="cpu")
    shuffle_dataset(loader, 0)
    assert compute_precise_bn_stats(cfg, model, loader, cfg.BN.NUM_BATCHES_PRECISE) == 2
    sd = model.state_dict()
    for k, v in saved.items():
        assert torch.equal(sd[k], v), k
    # The train steps' running averages are not what was saved.
    steps_only = build_model(cfg, device="cpu")
    assert not all(torch.equal(steps_only.state_dict()[k], v) for k, v in saved.items())
