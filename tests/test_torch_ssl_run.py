"""``run_net`` pretraining and transfer in the port, on the CPU, on an mp4
corpus: every pretraining recipe of configs/contrastive_ssl narrowed (Slow
R18 at width 8, 4 frames of 32², MLPs of 64, a queue of 16) trains through
``run_net`` with its checkpoint and the kNN probe; an SSL checkpoint
auto-resumes with the model, the optimizer and the SSL state bit-equal;
``linear_k400_*`` loads the pretrain's backbone through
``CHECKPOINT_CLEAR_NAME_PATTERN`` and trains the linear head with the
backbone's weights untouched (``DETACH_FINAL_FC``); the test after a
pretrain is refused, as the JAX package's fails. Every recipe of the
directory builds at full width on the meta device with the JAX package's
parameters and names.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from slowfast_tpu.config import get_cfg as jax_get_cfg
from slowfast_tpu.models import build_model as jax_build_model
from slowfast_tpu.models.build import init_model
from slowfast_tpu_torch.config import assert_and_infer_cfg, get_cfg
from slowfast_tpu_torch.data import synth_media
from slowfast_tpu_torch.engine import trainer
from slowfast_tpu_torch.engine.tester import test as run_test
from slowfast_tpu_torch.models.build import MODEL_REGISTRY, build_model
from slowfast_tpu_torch.models.contrastive import init_ssl_state
from slowfast_tpu_torch.run_net import main as run_net_main
from slowfast_tpu_torch.solver.optimizer import construct_optimizer
from slowfast_tpu_torch.utils import checkpoint as cu
from slowfast_tpu_torch.utils.checkpoint import state_dict_from_jax
from test_torch_train import one_torch_thread  # noqa: F401  (autouse fixture)

pytest.importorskip("cv2")

CONFIGS = os.path.join(os.path.dirname(__file__), "..", "configs", "contrastive_ssl")
PRETRAIN = ["MoCo_SlowR50_8x8.yaml", "MoCo_Slow_8x8_R50.yaml", "BYOL_SlowR50_8x8.yaml",
            "SimCLR_SlowR50_8x8.yaml", "SwAV_Slow_R50_8x8.yaml"]
NARROW = ["RESNET.DEPTH", "18", "RESNET.WIDTH_PER_GROUP", "8",
          "RESNET.NUM_BLOCK_TEMP_KERNEL", "[[2], [2], [2], [2]]", "DATA.NUM_FRAMES", "4",
          "DATA.SAMPLING_RATE", "4", "DATA.TRAIN_CROP_SIZE", "32", "DATA.TEST_CROP_SIZE", "32",
          "DATA.TRAIN_JITTER_SCALES", "[40, 48]", "CONTRASTIVE.MLP_DIM", "64",
          "CONTRASTIVE.QUEUE_LEN", "16", "DATA.TRAIN_CROP_NUM_TEMPORAL", "2",
          "TRAIN.BATCH_SIZE", "2", "TEST.ENABLE", "False", "NUM_GPUS", "1",
          "TPU.COMPUTE_DTYPE", "float32", "DATA_LOADER.NUM_WORKERS", "2", "LOG_PERIOD", "1"]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Four mp4s of 160 x 120 at 30 fps, 80 frames: 2 steps of 2 clips an
    epoch, a val split of two."""
    root = str(tmp_path_factory.mktemp("ssl_run"))
    return synth_media.make_video_corpus(root, {"train": 4, "val": 2, "test": 2},
                                         frames=80, size=(160, 120))


def opts(corpus, out_dir, extra=()):
    return NARROW + ["DATA.PATH_TO_DATA_DIR", corpus, "OUTPUT_DIR", str(out_dir)] + list(extra)


def make_cfg(yaml, option_list):
    cfg = get_cfg()
    cfg.merge_from_file(os.path.join(CONFIGS, yaml))
    cfg.merge_from_list(option_list)
    return assert_and_infer_cfg(cfg)


def logged(out_dir):
    lines = open(os.path.join(out_dir, "json_stats.log")).read().splitlines()
    return [json.loads(line.split("json_stats: ", 1)[1]) for line in lines]


@pytest.mark.parametrize("yaml", PRETRAIN)
def test_run_net_pretrains_the_recipe(corpus, tmp_path, yaml):
    run_net_main(["--device", "cpu", "--cfg", os.path.join(CONFIGS, yaml), "--opts",
                  *opts(corpus, tmp_path, ["SOLVER.MAX_EPOCH", "1"])])
    stats = logged(tmp_path)
    types = [s["_type"] for s in stats]
    assert types.count("train_iter") == 2 and types.count("train_epoch") == 1
    assert all(np.isfinite(s["loss"]) for s in stats if s["_type"] == "train_epoch")
    (knn,) = [s for s in stats if s["_type"] == "knn_epoch"]
    assert 0.0 <= knn["top1_acc"] <= 100.0
    cfg = make_cfg(yaml, opts(corpus, tmp_path))
    ckpt = torch.load(cu.get_last_checkpoint(str(tmp_path), cfg.TASK), weights_only=True)
    assert ckpt["epoch"] == 0 and ckpt["ssl_state"]["iter"] == 2
    assert {k.split(".")[0] for k in ckpt["model_state"]} <= {"backbone", "predictors",
                                                             "swav_prototypes"}
    if cfg.CONTRASTIVE.TYPE in ("moco", "byol"):
        assert set(ckpt["ssl_state"]["hist"]) == {
            k[len("backbone."):] for k in ckpt["model_state"] if k.startswith("backbone.")}
    # CONTRASTIVE.LENGTH follows the train set: the kNN bank has a row a clip.
    assert ckpt["ssl_state"]["memory"].shape[0] == 4


def ssl_snapshot(model, opt, ssl):
    out = {"model." + k: v.clone() for k, v in model.state_dict().items()}
    out.update({"opt." + k: v for k, v in opt.state_dict().items() if k != "count"})
    for k, v in ssl.state_dict().items():
        out["ssl." + k] = v
    return out


def assert_equal_trees(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        if isinstance(a[k], dict):
            assert_equal_trees(a[k], b[k])
        elif isinstance(a[k], torch.Tensor):
            assert torch.equal(a[k], b[k]), k
        else:
            assert a[k] == b[k], k


def test_auto_resume_restores_the_ssl_state(corpus, tmp_path):
    """MoCo with the multi-view queue: one epoch, then a fresh model,
    optimizer and SSL state resume from the checkpoint bit for bit (the
    momentum encoder with its BN statistics, the queue, the pointer, the
    kNN bank, the step count); ``run_net`` then continues at epoch 2."""
    cfg = make_cfg(PRETRAIN[0], opts(corpus, tmp_path, ["SOLVER.MAX_EPOCH", "1"]))
    model, ssl = trainer.train(cfg, "cpu")
    opt = construct_optimizer(model, cfg)
    ckpt = torch.load(cu.get_last_checkpoint(str(tmp_path), cfg.TASK), weights_only=True)
    opt.load_state_dict(ckpt["optimizer_state"])
    want = ssl_snapshot(model, opt, ssl)
    assert ssl.ptr == 2 * 2 * 2 % 16 and ssl.iter == 2
    cfg = make_cfg(PRETRAIN[0], opts(corpus, tmp_path, ["SOLVER.MAX_EPOCH", "2"]))
    cfg.CONTRASTIVE.LENGTH = 4
    fresh = build_model(cfg, "cpu")
    fresh_opt = construct_optimizer(fresh, cfg)
    fresh_ssl = init_ssl_state(cfg, fresh, torch.Generator().manual_seed(1))
    assert cu.load_train_checkpoint(cfg, fresh, fresh_opt, fresh_ssl) == 1
    assert_equal_trees(ssl_snapshot(fresh, fresh_opt, fresh_ssl), want)
    run_net_main(["--device", "cpu", "--cfg", os.path.join(CONFIGS, PRETRAIN[0]), "--opts",
                  *opts(corpus, tmp_path, ["SOLVER.MAX_EPOCH", "2"])])
    epochs = [s["epoch"] for s in logged(tmp_path) if s["_type"] == "train_epoch"]
    assert epochs == ["1/1", "2/2"]


@pytest.mark.parametrize("yaml", ["linear_k400_Slow_8x8_R50_syn0.yaml",
                                  "linear_k400_Slow_8x8_R50_syn8.yaml"])
def test_linear_probe_from_the_pretrain(corpus, tmp_path, yaml, monkeypatch):
    """The SSL checkpoint's backbone into ``linear_k400_*``: every backbone
    tensor of the ResNet loaded (the head's projection missing, the MLP
    projection and the predictors unexpected), then one epoch in which
    only the head's projection moves."""
    pt_dir = tmp_path / "pretrain"
    run_net_main(["--device", "cpu", "--cfg", os.path.join(CONFIGS, "BYOL_SlowR50_8x8.yaml"),
                  "--opts", *opts(corpus, pt_dir, ["SOLVER.MAX_EPOCH", "1"])])
    pt = cu.get_last_checkpoint(str(pt_dir), "ssl")
    pt_state = torch.load(pt, weights_only=True)["model_state"]
    reports, load = [], cu.load_weights

    def recording(*args, **kwargs):
        reports.append(load(*args, **kwargs))
        return reports[-1]

    monkeypatch.setattr(cu, "load_weights", recording)
    cfg = make_cfg(yaml, opts(corpus, tmp_path / "linear", [
        "SOLVER.MAX_EPOCH", "1", "MODEL.NUM_CLASSES", "10", "TRAIN.CHECKPOINT_FILE_PATH", pt]))
    assert cfg.MODEL.DETACH_FINAL_FC and cfg.TRAIN.CHECKPOINT_CLEAR_NAME_PATTERN == ("backbone.",)
    os.makedirs(cfg.OUTPUT_DIR)
    model = trainer.train(cfg, "cpu")
    (report,) = reports
    assert sorted(report.missing) == ["head.projection.bias", "head.projection.weight"]
    assert all(u.startswith(("head.projection.projection.", "predictors."))
               for u in report.unexpected) and report.skipped == 0
    assert len(report.loaded) == len([k for k in pt_state if k.startswith("backbone.")
                                      and ".head." not in k
                                      and not k.endswith("num_batches_tracked")])
    init = dict(build_model(cfg, "cpu").named_parameters())  # RNG_SEED's init
    for name, p in model.named_parameters():
        if name.startswith("head."):
            assert not torch.equal(p, init[name]), name
        else:
            assert torch.equal(p.detach(), pt_state["backbone." + name]), name
    assert [s["_type"] for s in logged(cfg.OUTPUT_DIR)].count("val_epoch") == 1


def test_test_after_a_pretrain_is_refused(corpus, tmp_path):
    cfg = make_cfg(PRETRAIN[0], opts(corpus, tmp_path))
    with pytest.raises(NotImplementedError, match="TEST.ENABLE after an SSL pretrain"):
        run_test(cfg, "cpu")


RECIPES = ["MoCo_SlowR50_8x8.yaml", "MoCo_Slow_8x8_R50.yaml", "BYOL_SlowR50_8x8.yaml",
           "SimCLR_SlowR50_8x8.yaml", "SwAV_Slow_R50_8x8.yaml",
           "linear_k400_Slow_8x8_R50_syn0.yaml", "linear_k400_Slow_8x8_R50_syn8.yaml",
           "finetune_ucf_Slow_R50_syn0.yaml", "finetune_ucf_Slow_R50_syn8.yaml",
           "finetune_SSv2_Slow_R50_syn0.yaml", "finetune_SSv2_Slow_R50_syn8.yaml",
           "finetune_ava_Slow_R50_syn0.yaml", "finetune_ava_Slow_R50_syn8.yaml"]


@pytest.mark.parametrize("yaml", RECIPES)
def test_recipe_builds(yaml):
    """Every recipe of configs/contrastive_ssl builds at full width on the
    meta device with the JAX package's parameter count, and its optimizer
    (LARS where the recipe sets it) constructs."""
    path = os.path.join(CONFIGS, yaml)
    cfg = get_cfg()
    cfg.merge_from_file(path)
    cfg = assert_and_infer_cfg(cfg)
    jcfg = jax_get_cfg()
    jcfg.merge_from_file(path)
    jmodel = jax_build_model(jcfg)
    shapes = jax.eval_shape(lambda: init_model(jmodel, jcfg, rng=jax.random.PRNGKey(0)))
    with torch.device("meta"):
        model = MODEL_REGISTRY[cfg.MODEL.MODEL_NAME](cfg)
    want = sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes["params"]))
    assert sum(p.numel() for p in model.parameters()) == want
    names = set(state_dict_from_jax(jax.tree.map(lambda s: np.zeros(s.shape, np.float32),
                                                 shapes)))
    assert names == set(model.state_dict()), names ^ set(model.state_dict())
    opt = construct_optimizer(model, cfg)
    assert bool(opt.lars) == cfg.SOLVER.LARS_ON
