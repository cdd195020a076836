"""Training masked pretraining in the port against the JAX package, on the
CPU, on the models of tests/test_torch_masked.py (whose helpers this file
shares): one train step's loss and gradients against ``jax.grad`` (fp32:
the loss within 1e-5, each gradient within 2e-5 + 1e-4 relative, the MViT
family's tolerance with Queue 3 #3's 2e-5; bf16: as close to JAX's fp32
gradients as JAX's own bf16 ones, within 1.5 times, relative L2), a few
fp32 AdamW steps against JAX ``make_train_step`` (the loss within 1e-4
relative at every step, the parameters within 1e-4 at the end), the
optimizer's partition of the decoder tables, and ``run_net`` training the
two 3D recipes narrowed: it trains, checkpoints, never runs a val epoch, and
resumes.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slowfast_tpu.config import get_cfg as jax_get_cfg
from slowfast_tpu.engine.steps import TrainState, make_train_step as jax_make_train_step
from slowfast_tpu.models import build_model as jax_build_model
from slowfast_tpu.models import masked as jmasked
from slowfast_tpu.solver import optimizer as joptim
from slowfast_tpu_torch.config import get_cfg
from slowfast_tpu_torch.engine.steps import make_train_step
from slowfast_tpu_torch.models import masked as tmasked
from slowfast_tpu_torch.run_net import main as run_net_main
from slowfast_tpu_torch.solver import optimizer as toptim
from slowfast_tpu_torch.utils.checkpoint import state_dict_from_jax
from test_torch_masked import (ATOL, MAE, MAE_CASES, MAE_YAML, MASKFEAT, MASKFEAT_YAML, RTOL,
                               VIT, clips, jax_variables, make_cfg, mask_input, noise_for,
                               port_model, same_noise)  # noqa: F401  (fixture)
from test_torch_mvit import NARROW as V2_NARROW
from test_torch_mvit_family import jit_run
from test_torch_train import one_torch_thread  # noqa: F401  (fixture)

CASES = {"maskfeat_hog": MASKFEAT["vit_hog"], "maskfeat_pooled_hog": MASKFEAT["pooled_hog"],
         "maskfeat_random_mask": MASKFEAT["vit_random_mask"], "mae_random": MAE_CASES["random"],
         "mae_loader_mask_dec_kv": MAE_CASES["loader_mask_dec_kv_sep_pos"],
         "mae_per_frame": MAE_CASES["per_frame_sincos"]}
STEPS_PER_EPOCH = 2
SOLVER = ["SOLVER.OPTIMIZING_METHOD", "adamw", "SOLVER.BETAS", "(0.9, 0.95)",
          "SOLVER.BASE_LR", "1e-3", "SOLVER.LR_POLICY", "cosine", "SOLVER.WARMUP_EPOCHS", "1.0",
          "SOLVER.WARMUP_START_LR", "1e-6", "SOLVER.COSINE_AFTER_WARMUP", "True",
          "SOLVER.COSINE_END_LR", "1e-6", "SOLVER.MAX_EPOCH", "3", "SOLVER.WEIGHT_DECAY", "0.05",
          "SOLVER.ZERO_WD_1D_PARAM", "True", "SOLVER.CLIP_GRAD_L2NORM", "0.02",
          "MIXUP.ENABLE", "False"]


def setup(case, same_noise, dtype="float32"):
    """The case's config options, JAX variables, clips and loader mask, with
    the random-mask draws of both packages made equal."""
    base, extra, source = case
    cfg = make_cfg(get_cfg, base, extra=extra)
    if source == "noise":
        same_noise(noise_for(cfg))
    return base, list(extra), jax_variables(base, extra), clips(cfg), mask_input(cfg, source)


def jax_grads(base, extra, dtype, variables, x, mask):
    model = jax_build_model(make_cfg(jax_get_cfg, base, dtype, extra))
    kw = lambda m: {} if m is None else {"mask": m}  # noqa: E731

    def loss_fn(params, x, m):
        preds, labels = model.apply({"params": params}, [x], train=True,
                                    rngs={"dropout": jax.random.PRNGKey(0)}, **kw(m))
        return jmasked.masked_loss(preds, labels)

    args = (variables["params"], jnp.asarray(x), None if mask is None else jnp.asarray(mask))
    loss, grads = jit_run(jax.value_and_grad(loss_fn), *args)
    return float(loss), state_dict_from_jax({"params": jax.tree.map(np.asarray, grads)})


def port_grads(base, extra, dtype, variables, x, mask):
    model = port_model(variables, base, dtype, extra)
    model.train()
    preds, labels = model([torch.from_numpy(x)],
                          mask=None if mask is None else torch.from_numpy(mask))
    loss = tmasked.masked_loss(preds, labels)
    loss.backward()
    return loss.item(), {n: p.grad for n, p in model.named_parameters()}


@pytest.mark.parametrize("name", sorted(CASES))
def test_train_gradients_match_jax_grad(name, same_noise):
    """fp32: the loss within 1e-5, each gradient within 2e-5 + 1e-4
    relative; every parameter has a gradient."""
    base, extra, variables, x, mask = setup(CASES[name], same_noise)
    want_loss, want = jax_grads(base, extra, "float32", variables, x, mask)
    loss, got = port_grads(base, extra, "float32", variables, x, mask)
    np.testing.assert_allclose(loss, want_loss, rtol=1e-5)
    assert got.keys() == want.keys()
    for n, g in got.items():
        assert g is not None, n
        np.testing.assert_allclose(g.numpy(), want[n].numpy(), atol=ATOL, rtol=RTOL, err_msg=n)
    if "dec_kv" in name:  # the decoder's kv pooling trains
        assert got["pred_head.transforms.0.0.attn.pool_k.weight"].abs().max() > 0


def _flat(grads):
    return torch.cat([grads[n].float().flatten() for n in sorted(grads)])


@pytest.mark.parametrize("name", ["maskfeat_hog", "mae_random"])
def test_train_gradients_bf16_as_close_as_jax(name, same_noise):
    """bf16: the port's gradients sit no farther from JAX's fp32 ones than
    JAX's own bf16 gradients do (within 1.5 times, relative L2)."""
    base, extra, variables, x, mask = setup(CASES[name], same_noise)
    want_loss, want = jax_grads(base, extra, "float32", variables, x, mask)
    _, jax_bf16 = jax_grads(base, extra, "bfloat16", variables, x, mask)
    loss, got = port_grads(base, extra, "bfloat16", variables, x, mask)
    np.testing.assert_allclose(loss, want_loss, rtol=2e-2)
    scale = _flat(want).norm()
    port_err = (_flat(got) - _flat(want)).norm() / scale
    jax_err = (_flat(jax_bf16) - _flat(want)).norm() / scale
    assert port_err <= 1.5 * jax_err, (port_err, jax_err)


@pytest.mark.parametrize("name", ["maskfeat_hog", "mae_random", "mae_loader_mask_dec_kv"])
def test_adamw_trajectory_matches_jax(name, same_noise):
    """6 fp32 steps of the recipes' AdamW (betas 0.9/0.95, clip 0.02,
    warmup then cosine) on new clips and masks each step, against JAX
    ``make_train_step``."""
    base, extra, variables, _, _ = setup(CASES[name], same_noise)
    extra = extra + SOLVER
    jcfg = make_cfg(jax_get_cfg, base, extra=extra)
    tx, _ = joptim.construct_optimizer(variables["params"], jcfg, STEPS_PER_EPOCH)
    state = TrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                       batch_stats={}, opt_state=tx.init(variables["params"]))
    jstep = jax_make_train_step(jcfg, jax_build_model(jcfg), tx, donate=False,
                                steps_per_epoch=STEPS_PER_EPOCH)
    cfg = make_cfg(get_cfg, base, extra=extra)
    model = port_model(variables, base, extra=extra)
    step = make_train_step(cfg, model, toptim.construct_optimizer(model, cfg))
    source = CASES[name][2]
    for i in range(3 * STEPS_PER_EPOCH):
        x, mask = clips(cfg, seed=10 + i), mask_input(cfg, source, seed=20 + i)
        jbatch = {"inputs": [jnp.asarray(x)], "labels": jnp.zeros((2,), jnp.int32)}
        batch = {"inputs": [torch.from_numpy(x)], "labels": torch.zeros(2, dtype=torch.long),
                 "epoch_exact": i / STEPS_PER_EPOCH}
        if mask is not None:
            jbatch["mask"], batch["mask"] = jnp.asarray(mask), torch.from_numpy(mask)
        state, jm = jstep(state, jbatch, jax.random.PRNGKey(i))
        m = step(batch)
        assert "top1_err" not in m and "top1_err" not in jm
        np.testing.assert_allclose(m["loss"].item(), float(jm["loss"]), rtol=1e-4, err_msg=i)
        np.testing.assert_allclose(m["grad_norm"].item(), float(jm["grad_norm"]), rtol=1e-3)
        np.testing.assert_allclose(m["lr"], float(jm["lr"]), rtol=2e-6)
        assert float(jm["grad_norm"]) > 0.02  # the clip engaged
    want = state_dict_from_jax({"params": jax.tree.map(np.asarray, state.params)})
    for n, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[n].numpy(), atol=1e-4, err_msg=n)


def test_decoder_tables_skip_weight_decay_as_in_jax():
    """``MVIT.ZERO_DECAY_POS_CLS`` with ``MASK.DECODER_SEP_POS_EMBED``: the
    separable decoder tables are not decayed; the partition equals JAX's."""
    extra = MAE + ["MASK.DECODER_SEP_POS_EMBED", "True", "MVIT.ZERO_DECAY_POS_CLS", "True",
                   "SOLVER.WEIGHT_DECAY", "0.05"]
    variables = jax_variables(VIT, extra)
    wd_tree, _ = joptim.build_param_scales(variables["params"],
                                           make_cfg(jax_get_cfg, VIT, extra=extra))
    # Each parameter's decay as a full array of its shape, to carry the names.
    full = jax.tree.map(lambda p, w: np.full(p.shape, w, np.float32), variables["params"],
                        wd_tree)
    want = {n: v.flatten()[0].item() for n, v in state_dict_from_jax({"params": full}).items()}
    got = toptim.build_param_scales(port_model(variables, VIT, extra=extra),
                                    make_cfg(get_cfg, VIT, extra=extra))
    assert {n: np.float32(wd) for n, (wd, _) in got.items()} == want
    for name in ("dec_pos_embed_spatial", "dec_pos_embed_temporal", "dec_pos_embed_class",
                 "pos_embed_spatial", "cls_token"):
        assert got[name][0] == 0.0, name
    assert got["mask_token"][0] == got["blocks.0.attn.qkv.weight"][0] == 0.05


# --- run_net --------------------------------------------------------------------

RUN = ["NUM_GPUS", "1", "TPU.COMPUTE_DTYPE", "float32", "TRAIN.DATASET", "syntheticvideo",
       "DATA.SYNTHETIC_SIZE", "4", "TRAIN.BATCH_SIZE", "2", "LOG_PERIOD", "1",
       "DATA_LOADER.NUM_WORKERS", "2", "SOLVER.WARMUP_EPOCHS", "0.5", "TEST.ENABLE", "False"]
RECIPES = {
    "maskfeat": (MASKFEAT_YAML, [o for o in V2_NARROW if o not in ("TRAIN.ENABLE", "False")]
                 + ["MASK.PRETRAIN_DEPTH", "[1]", "AUG.MASK_WINDOW_SIZE", "[2,7,7]"]),
    "mae": (MAE_YAML, ["MVIT.DEPTH", "2", "MVIT.EMBED_DIM", "64", "MVIT.NUM_HEADS", "2",
                       "MASK.PRETRAIN_DEPTH", "[1]", "MASK.DECODER_DEPTH", "1",
                       "MASK.DECODER_EMBED_DIM", "64", "DATA.NUM_FRAMES", "4",
                       "DATA.TRAIN_CROP_SIZE", "64", "DATA.TEST_CROP_SIZE", "64"]),
}


def run(recipe, out_dir, max_epoch):
    yaml, narrow = RECIPES[recipe]
    run_net_main(["--device", "cpu", "--cfg", yaml, "--opts", *narrow, *RUN,
                  "SOLVER.MAX_EPOCH", str(max_epoch), "OUTPUT_DIR", str(out_dir)])
    lines = (out_dir / "json_stats.log").read_text().splitlines()
    return [json.loads(line.split("json_stats: ")[1]) for line in lines]


@pytest.mark.parametrize("recipe", sorted(RECIPES))
def test_run_net_pretrains_checkpoints_and_resumes(recipe, tmp_path):
    """The recipe narrowed, fp32 on the CPU, on synthetic clips (MaskFeat's
    with the loader's masks): one epoch of 2 steps, a checkpoint, no val
    epoch; a second run resumes from it for epoch 2."""
    stats = run(recipe, tmp_path, 1)
    types = [s["_type"] for s in stats]
    assert "train_epoch" in types and "val_epoch" not in types
    assert all(np.isfinite(s["loss"]) for s in stats if s["_type"] == "train_iter")
    ckpt = tmp_path / "checkpoints" / "ssl_checkpoint_epoch_00001.pyth"
    assert ckpt.exists()
    state = torch.load(ckpt, map_location="cpu", weights_only=True)["model_state"]
    yaml, narrow = RECIPES[recipe]
    cfg = get_cfg()
    cfg.merge_from_file(yaml)
    cfg.merge_from_list(narrow + RUN)
    from slowfast_tpu_torch.models.build import build_model

    build_model(cfg, device="cpu").load_state_dict(state, strict=True)
    stats = run(recipe, tmp_path, 2)
    epochs = [s["epoch"] for s in stats if s["_type"] == "train_epoch"]
    assert epochs == ["1/1", "2/2"]
    assert (tmp_path / "checkpoints" / "ssl_checkpoint_epoch_00002.pyth").exists()
    assert os.path.getsize(ckpt) > 0
