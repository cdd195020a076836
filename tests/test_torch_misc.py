"""The port's misc utilities, profiler and profile_step against the JAX
package's (slowfast_tpu/utils/misc.py, utils/profiler.py,
tools/profile_step.py), on the CPU.

``params_count`` of narrow C2D, SlowFast, X3D and MViTv2 models equals the
JAX ``params_count`` of the same config's variables (shaped by a traced
``init_model``). ``get_flop_stats`` of a narrow C2D equals twice its
multiply-adds counted from the shapes of its convolutions and its
projection (the counter counts products, convolutions and attention only;
XLA's cost analysis, which the JAX package reads, adds elementwise work:
ROADMAP Queue 3 #49). ``log_model_info`` runs at the start of ``run_net``'s
train and test under ``LOG_MODEL_INFO`` and not without it. ``StepTimer``
and ``trace``; ``profile_step`` on two steps of a narrow C2D and of a
narrow MoCo prints its table and writes its trace. The NaN guard and the
eval cadence against JAX's.
"""

import json
import math
import os

import jax
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from slowfast_tpu.config import get_cfg as jax_get_cfg
from slowfast_tpu.models import build_model as jax_build_model
from slowfast_tpu.models.build import init_model
from slowfast_tpu.utils import misc as jax_misc
from slowfast_tpu_torch import profile_step
from slowfast_tpu_torch.config import assert_and_infer_cfg, get_cfg
from slowfast_tpu_torch.models.build import build_model
from slowfast_tpu_torch.run_net import main as run_net_main
from slowfast_tpu_torch.utils import misc, profiler

CONFIGS = os.path.join(os.path.dirname(__file__), "..", "configs")
R18 = ["RESNET.DEPTH", "18", "RESNET.WIDTH_PER_GROUP", "8", "DATA.NUM_FRAMES", "4",
       "DATA.TRAIN_CROP_SIZE", "32", "DATA.TEST_CROP_SIZE", "32", "MODEL.NUM_CLASSES", "8",
       "NUM_GPUS", "1", "TPU.COMPUTE_DTYPE", "float32"]
MODELS = {
    "c2d": ("Kinetics/C2D_8x8_R50.yaml", R18 + ["RESNET.NUM_BLOCK_TEMP_KERNEL",
                                               "[[2],[2],[2],[2]]"]),
    "slowfast": ("Kinetics/SLOWFAST_4x16_R50.yaml",
                 R18 + ["RESNET.NUM_BLOCK_TEMP_KERNEL", "[[2,2],[2,2],[2,2],[2,2]]",
                        "DATA.NUM_FRAMES", "8", "SLOWFAST.ALPHA", "4"]),
    "x3d": ("Kinetics/X3D_M.yaml", ["X3D.WIDTH_FACTOR", "0.5", "X3D.DEPTH_FACTOR", "0.5",
                                    "X3D.DIM_C5", "32", "DATA.NUM_FRAMES", "4",
                                    "DATA.TRAIN_CROP_SIZE", "32", "MODEL.NUM_CLASSES", "8",
                                    "NUM_GPUS", "1"]),
    "mvit": ("Kinetics/MVITv2_S_16x4.yaml",
             ["MVIT.DEPTH", "4", "MVIT.EMBED_DIM", "16", "MVIT.NUM_HEADS", "1",
              "MVIT.DIM_MUL", "[[1,2.0],[3,2.0]]", "MVIT.HEAD_MUL", "[[1,2.0],[3,2.0]]",
              "MVIT.POOL_Q_STRIDE", "[[0,1,1,1],[1,1,2,2],[2,1,1,1],[3,1,2,2]]",
              "DATA.NUM_FRAMES", "4", "DATA.TRAIN_CROP_SIZE", "56", "MODEL.NUM_CLASSES", "16",
              "NUM_GPUS", "1"]),
}


def cfgs(name):
    yaml, opts = MODELS[name]
    cfg, jcfg = get_cfg(), jax_get_cfg()
    for c in (cfg, jcfg):
        c.merge_from_file(os.path.join(CONFIGS, yaml))
        c.merge_from_list(list(opts))
    return assert_and_infer_cfg(cfg), jcfg


@pytest.mark.parametrize("name", sorted(MODELS))
def test_params_count_matches_jax(name):
    cfg, jcfg = cfgs(name)
    shapes = jax.eval_shape(lambda r: init_model(jax_build_model(jcfg), jcfg, rng=r),
                            jax.random.PRNGKey(0))
    model = build_model(cfg, device="cpu")
    assert misc.params_count(model) == jax_misc.params_count(shapes["params"])


def test_flops_are_twice_the_multiply_adds():
    """A narrow C2D: 2 x (each convolution's output elements x its kernel
    volume x input channels per group, plus the projection's in x out)."""
    cfg, _ = cfgs("c2d")
    model = build_model(cfg, device="cpu").eval()
    macs = []

    def conv_hook(module, args, out):
        w = module.weight
        macs.append(out.numel() * w[0].numel())  # (C_in / groups) * kT * kH * kW

    hooks = [m.register_forward_hook(conv_hook) for m in model.modules()
             if type(m).__name__ == "Conv3D"]
    with torch.no_grad():
        model(misc.dummy_inputs(cfg))
    for h in hooks:
        h.remove()
    proj = [m for n, m in model.named_modules() if n.endswith("projection")][0]
    macs.append(proj.weight.numel())
    assert misc.get_flop_stats(cfg) * 1e9 == pytest.approx(2 * sum(macs), rel=1e-12)


def test_check_nan_losses_and_eval_cadence():
    misc.check_nan_losses(1.0)
    with pytest.raises(RuntimeError, match="Got NaN losses at epoch 2"):
        misc.check_nan_losses(math.nan, " at epoch 2")
    cfg, jcfg = get_cfg(), jax_get_cfg()
    for c in (cfg, jcfg):
        c.merge_from_list(["SOLVER.MAX_EPOCH", "10", "TRAIN.EVAL_PERIOD", "3"])
    assert ([misc.is_eval_epoch(cfg, e) for e in range(10)]
            == [jax_misc.is_eval_epoch(jcfg, e) for e in range(10)])
    assert misc.gpu_mem_usage() == 0.0


@pytest.mark.parametrize("log", [True, False])
def test_log_model_info_under_its_key(tmp_path, monkeypatch, log):
    calls = []
    real = misc.log_model_info

    def recording(model, cfg):
        calls.append(cfg.TRAIN.ENABLE)
        return real(model, cfg)

    monkeypatch.setattr(misc, "log_model_info", recording)
    _, opts = MODELS["c2d"]
    run_net_main(["--device", "cpu", "--cfg", os.path.join(CONFIGS, MODELS["c2d"][0]),
                  "--opts", *opts, "RESNET.NUM_BLOCK_TEMP_KERNEL", "[[2],[2],[2],[2]]",
                  "TRAIN.DATASET", "syntheticvideo", "TEST.DATASET", "syntheticvideo",
                  "DATA.SYNTHETIC_SIZE", "2", "TRAIN.BATCH_SIZE", "2", "TEST.BATCH_SIZE", "2",
                  "TEST.NUM_ENSEMBLE_VIEWS", "1", "TEST.NUM_SPATIAL_CROPS", "1",
                  "SOLVER.MAX_EPOCH", "1", "BN.USE_PRECISE_STATS", "False",
                  "DATA_LOADER.NUM_WORKERS", "1", "LOG_MODEL_INFO", str(log),
                  "OUTPUT_DIR", str(tmp_path)])
    assert calls == ([True, True] if log else [])
    if log:
        assert "Flops:" in (tmp_path / "stdout.log").read_text()


def test_step_timer_and_trace(tmp_path):
    timer = profiler.StepTimer(warmup=1)
    for _ in range(3):
        timer.start()
        timer.stop(torch.ones(()) * 2)
    s = timer.summary()
    assert s["steps"] == 2 and s["p50_s"] >= 0 and s["p90_s"] >= s["p50_s"] - 1e-12
    assert profiler.StepTimer().summary() == {}
    with profiler.trace(str(tmp_path), enabled=False) as prof:
        assert prof is None
    with profiler.trace(str(tmp_path)) as prof:
        F.relu(torch.randn(8, 8))
    assert any(e.name == "aten::relu" for e in prof.events())
    assert json.load(open(tmp_path / "trace.json"))["traceEvents"]


MOCO = ["RESNET.DEPTH", "18", "RESNET.WIDTH_PER_GROUP", "8",
        "RESNET.NUM_BLOCK_TEMP_KERNEL", "[[2], [2], [2], [2]]", "DATA.NUM_FRAMES", "4",
        "DATA.TRAIN_CROP_SIZE", "32", "CONTRASTIVE.MLP_DIM", "64", "CONTRASTIVE.QUEUE_LEN",
        "16", "NUM_GPUS", "1", "TPU.COMPUTE_DTYPE", "float32"]


@pytest.mark.parametrize("yaml,opts", [
    (MODELS["c2d"][0], MODELS["c2d"][1] + ["MIXUP.ENABLE", "False"]),
    ("contrastive_ssl/MoCo_SlowR50_8x8.yaml", MOCO)], ids=["c2d", "moco"])
def test_profile_step(tmp_path, capsys, yaml, opts):
    out = tmp_path / "trace"
    result = profile_step.main(["--device", "cpu", "--cfg", os.path.join(CONFIGS, yaml),
                                "--batch", "2", "--steps", "2", "--top", "5", "--out", str(out),
                                "--opts", *opts])
    printed = capsys.readouterr().out
    assert "top 5 ops by self CPU time per step over 2 steps of 2 clips on cpu" in printed
    assert "-- by category --" in printed and "conv" in result["by_category"]
    assert len(result["rows"]) == 5 and result["rows"][0]["ms_per_step"] > 0
    assert any(r["gbps"] is not None for r in result["rows"])
    assert json.loads(printed.strip().splitlines()[-1])["steps"] == 2
    assert (out / "trace.json").stat().st_size > 0
    assert np.isfinite(result["step_timer"]["mean_s"])
    assert result["kernel_ms_per_step"] is None and result["idle_share"] is None  # no card
