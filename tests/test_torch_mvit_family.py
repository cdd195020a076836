"""The rest of the MViT family in the port against the JAX package, on the
CPU: every MViT option's eval forward, the recipes' build at full size, and
the sin-cos table. Training (gradients, activation checkpointing, dropout),
the weight bridge and the optimizer's partition are in
tests/test_torch_mvit_family_train.py, which shares this file's models.

Narrow models, their parameters overwritten with seeded random values (as
tests/test_torch_mvit.py does), inputs seeded numpy arrays:

* MViTv1: ``MVIT_B_16x4_CONV.yaml`` at depth 4, embed 16, 4 frames, 56²
  crops (token grids 14 -> 7 -> 4), q strides at blocks 1 and 3, the
  adaptive KV strides, separable pos-embeds and the cls token;
* ViT: ``k400_VIT_B_16x4_FT.yaml`` at depth 2, embed 32, 4 heads, 32²
  crops: separable pos-embeds, mean pooling, unpooled attention;
* MViTv2: ``MVITv2_S_16x4.yaml`` narrowed as in tests/test_torch_mvit.py,
  for the rel-pos tables resized at other test sizes and for detection.

Each option is one case of ``test_option_eval_matches_jax``: the eval
forward at fp32 (atol 1e-5, rtol 1e-4) and at bf16 (2e-2).
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from slowfast_tpu.config import get_cfg as jax_get_cfg
from slowfast_tpu.models import build_model as jax_build_model
from slowfast_tpu.models.build import init_model
from slowfast_tpu_torch.config import get_cfg
from slowfast_tpu_torch.models import mvit as tmvit
from slowfast_tpu_torch.models.build import build_model, init_mvit_weights
from slowfast_tpu_torch.utils.checkpoint import state_dict_from_jax
from test_torch_mvit import NARROW as V2_NARROW
from test_torch_mvit import randomize
from test_torch_train import one_torch_thread  # noqa: F401  (fixture)

ATOL, RTOL = 1e-5, 1e-4
BF16_ATOL = 2e-2
CONFIGS = os.path.join(os.path.dirname(__file__), "..", "configs")
V1 = (os.path.join(CONFIGS, "Kinetics", "MVIT_B_16x4_CONV.yaml"), [
    "MVIT.DEPTH", "4", "MVIT.EMBED_DIM", "16", "MVIT.NUM_HEADS", "1",
    "MVIT.DIM_MUL", "[[1,2.0],[3,2.0]]", "MVIT.HEAD_MUL", "[[1,2.0],[3,2.0]]",
    "MVIT.POOL_Q_STRIDE", "[[1,1,2,2],[3,1,2,2]]", "DATA.NUM_FRAMES", "4",
    "DATA.TRAIN_CROP_SIZE", "56", "DATA.TEST_CROP_SIZE", "56"])
VIT = (os.path.join(CONFIGS, "masked_ssl", "k400_VIT_B_16x4_FT.yaml"), [
    "MVIT.DEPTH", "2", "MVIT.EMBED_DIM", "32", "MVIT.NUM_HEADS", "4", "DATA.NUM_FRAMES", "4",
    "DATA.TRAIN_CROP_SIZE", "32", "DATA.TEST_CROP_SIZE", "32"])
V2 = (os.path.join(CONFIGS, "Kinetics", "MVITv2_S_16x4.yaml"), list(V2_NARROW))
COMMON = ["MODEL.NUM_CLASSES", "16", "NUM_GPUS", "1"]
DETECTION = ["DETECTION.ENABLE", "True", "MODEL.HEAD_ACT", "sigmoid",
             "DETECTION.SPATIAL_SCALE_FACTOR", "14", "DETECTION.ROI_XFORM_RESOLUTION", "4"]

# option -> (base model, config options, eval crop or None for the train crop)
CASES = {
    "separable_pos": (V1, [], None),
    "joint_pos": (V1, ["MVIT.SEP_POS_EMBED", "False"], None),
    # The fixed table with a joint pos_embed: the parameter is kept and the
    # table is used (added twice, as in JAX).
    "sincos_pos": (V1, ["MVIT.SEP_POS_EMBED", "False", "MVIT.USE_FIXED_SINCOS_POS", "True"],
                   None),
    "cls_off": (V1, ["MVIT.CLS_EMBED_ON", "False"], None),
    "mean_pooling": (V1, ["MVIT.USE_MEAN_POOLING", "True"], None),
    "norm_stem": (V1, ["MVIT.NORM_STEM", "True"], None),
    "pool_first": (V1, ["MVIT.POOL_FIRST", "True"], None),
    "separate_qkv": (V1, ["MVIT.SEPARATE_QKV", "True"], None),
    "mode_avg": (V1, ["MVIT.MODE", "avg"], None),
    "mode_max": (V1, ["MVIT.MODE", "max"], None),
    "mode_conv_unshared": (V1, ["MVIT.MODE", "conv_unshared"], None),
    # _maybe_interp_pos: the separable table resized (antialiased) from the
    # 14 x 14 training grid to 10 x 10.
    "interp_pos": (V1, [], 40),
    "rel_pos_shrinks": (V2, [], 40),
    "rel_pos_grows": (V2, [], 72),
    "vit": (VIT, [], None),
    "detection": (V2, DETECTION, None),
}


def make_cfg(get, base, dtype="float32", extra=()):
    yaml, narrow = base
    cfg = get()
    cfg.merge_from_file(yaml)
    cfg.merge_from_list(narrow + COMMON + ["TPU.COMPUTE_DTYPE", dtype] + list(extra))
    return cfg


def jax_variables(base, extra=(), seed=0):
    return _jax_variables(base[0], tuple(base[1]), tuple(extra), seed)


@functools.lru_cache(maxsize=None)
def _jax_variables(yaml, narrow, extra, seed):
    cfg = make_cfg(jax_get_cfg, (yaml, list(narrow)), extra=extra)
    shapes = jax.eval_shape(lambda: init_model(jax_build_model(cfg), cfg,
                                               rng=jax.random.PRNGKey(0), train=True))
    return randomize(dict(shapes), seed)


def jit_run(fn, *args):
    """``jax.jit(fn)(*args)``, compiled with XLA's CPU backend at
    optimization level 0: the same HLO (its fusions included) with less
    LLVM work, which halves the compile of a narrow MViT (results within
    5e-7 of the default level's)."""
    compiled = jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_backend_optimization_level": "0"})
    return compiled(*args)


def port_model(variables, base, dtype="float32", extra=()):
    model = build_model(make_cfg(get_cfg, base, dtype, extra), device="cpu")
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    return model


def clips(cfg, crop=None, n=2, seed=1):
    crop = crop or cfg.DATA.TRAIN_CROP_SIZE
    shape = (n, cfg.DATA.NUM_FRAMES, crop, crop, 3)
    return np.random.RandomState(seed).normal(0.0, 1.0, shape).astype(np.float32)


def boxes(cfg, n=2, m=3, seed=2):
    """Padded boxes ``(n, m, 4)`` inside the crop; the last of each clip a
    zero box."""
    crop = cfg.DATA.TRAIN_CROP_SIZE
    rng = np.random.RandomState(seed)
    xy = rng.uniform(0, crop / 2, (n, m, 2))
    out = np.concatenate([xy, xy + rng.uniform(4, crop / 2, (n, m, 2))], -1)
    out[:, -1] = 0.0
    return out.astype(np.float32)


def jax_eval(variables, base, dtype, extra, x, bboxes=None):
    cfg = make_cfg(jax_get_cfg, base, dtype, extra)
    model = jax_build_model(cfg)
    args = () if bboxes is None else (jnp.asarray(bboxes),)
    out = jit_run(lambda v, x: model.apply(v, [x], *args, train=False), variables,
                  jnp.asarray(x))
    return np.asarray(out.astype(jnp.float32))


def port_eval(variables, base, dtype, extra, x, bboxes=None):
    model = port_model(variables, base, dtype, extra)
    model.eval()
    args = () if bboxes is None else (torch.from_numpy(bboxes),)
    with torch.no_grad():
        return model([torch.from_numpy(x)], *args).float().numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES)
def test_option_eval_matches_jax(case, dtype):
    base, extra, crop = CASES[case]
    variables = jax_variables(base, extra)
    cfg = make_cfg(get_cfg, base, extra=extra)
    x = clips(cfg, crop)
    bboxes = boxes(cfg) if cfg.DETECTION.ENABLE else None
    want = jax_eval(variables, base, dtype, extra, x, bboxes)
    got = port_eval(variables, base, dtype, extra, x, bboxes)
    assert got.shape == want.shape == ((6 if bboxes is not None else 2), 16)
    assert 0.0 < want.max() < 0.9  # not a saturated softmax
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    else:
        np.testing.assert_allclose(got, want, atol=BF16_ATOL, rtol=0)


def test_sep_pos_embed_ignored_without_abs_pos():
    """``SEP_POS_EMBED True`` under ``USE_ABS_POS False`` (the masked_ssl FT
    recipes) changes nothing: the same variables in both packages and the
    same output (ROADMAP Queue 3 #8)."""
    flag = ["MVIT.SEP_POS_EMBED", "True"]
    jax_plain = jax_variables(V2)
    jax_flag = jax_variables(V2, flag)
    assert (traverse_util.flatten_dict(jax_plain).keys()
            == traverse_util.flatten_dict(jax_flag).keys())
    a = build_model(make_cfg(get_cfg, V2), device="cpu")
    b = build_model(make_cfg(get_cfg, V2, extra=flag), device="cpu")
    sa, sb = a.state_dict(), b.state_dict()
    assert sa.keys() == sb.keys() == state_dict_from_jax(jax_plain).keys()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    x = torch.from_numpy(clips(make_cfg(get_cfg, V2)))
    a.eval(), b.eval()
    with torch.no_grad():
        assert torch.equal(a([x]), b([x]))


RECIPES = ["Kinetics/MVIT_B_16x4_CONV.yaml", "Kinetics/MVIT_B_32x3_CONV.yaml",
           "Kinetics/MVITv2_B_32x3.yaml", "Kinetics/MVITv2_L_40x3_test.yaml",
           "SSv2/MVITv2_B_32x3.yaml", "SSv2/MVITv2_L_40x3.yaml",
           "masked_ssl/k400_MVITv2_S_16x4_FT.yaml", "masked_ssl/k400_MVITv2_L_16x4_FT.yaml",
           "masked_ssl/k400_VIT_B_16x4_FT.yaml", "masked_ssl/k400_VIT_L_16x4_FT.yaml",
           "masked_ssl/k400_VIT_H_16x4_FT.yaml"]


def test_recipes_build_at_full_size():
    """Every shipped recipe of the family builds and initializes at full
    width and depth, its parameters on the meta device (no memory, nothing
    run)."""
    for recipe in RECIPES:
        cfg = get_cfg()
        cfg.merge_from_file(os.path.join(CONFIGS, recipe))
        with torch.device("meta"):
            model = tmvit.MViT(cfg)
            init_mvit_weights(model, cfg, torch.Generator().manual_seed(0))
        assert len(model.blocks) == cfg.MVIT.DEPTH, recipe
        assert model.act_checkpoint == cfg.MODEL.ACT_CHECKPOINT, recipe
        assert sum(p.numel() for p in model.parameters()) > 1e7, recipe


def test_init_of_the_new_parameters_follows_jax():
    """The JAX package's init distributions for the new parameters:
    pos-embeds, ``q``/``k``/``v`` and the unshared pool kernels
    trunc_normal(0.02) (cut at ±2 std), their biases and ``norm_stem``'s
    0.02, ``norm_stem``'s scale 1; zero rel-pos tables under
    REL_POS_ZERO_INIT; the detection head N(0, FC_INIT_STD), bias 0."""
    sd = build_model(make_cfg(get_cfg, V1, extra=[
        "MVIT.NORM_STEM", "True", "MVIT.SEPARATE_QKV", "True", "MVIT.MODE", "conv_unshared"]),
        device="cpu").state_dict()
    for name in ("pos_embed_spatial", "pos_embed_temporal", "pos_embed_class",
                 "blocks.0.attn.q.weight", "blocks.0.attn.v.weight",
                 "blocks.1.attn.pool_k.weight"):
        assert 0.0 < sd[name].abs().max() <= 0.04, name
    assert torch.all(sd["norm_stem.weight"] == 1.0)
    for name in ("norm_stem.bias", "blocks.0.attn.k.bias", "blocks.1.attn.norm_q.bias"):
        assert torch.all(sd[name] == 0.02), name
    sd = build_model(make_cfg(get_cfg, V2, extra=["MVIT.REL_POS_ZERO_INIT", "True"]),
                     device="cpu").state_dict()
    assert all(not sd[n].any() for n in sd if ".rel_pos_" in n)
    cfg = make_cfg(get_cfg, V2, extra=DETECTION + ["MODEL.NUM_CLASSES", "2000"])
    sd = build_model(cfg, device="cpu").state_dict()
    w = sd["head.projection.weight"]
    assert abs(w.std().item() - cfg.MODEL.FC_INIT_STD) < 0.1 * cfg.MODEL.FC_INIT_STD
    assert w.abs().max() > 2 * cfg.MODEL.FC_INIT_STD  # a normal, not cut at 2 std
    assert not sd["head.projection.bias"].any()


def test_sincos_table_matches_jax():
    from slowfast_tpu.models.mvit import get_3d_sincos_pos_embed as jax_sincos

    for dim, grid, t, cls in ((16, 14, 2, True), (32, 2, 2, False)):
        np.testing.assert_array_equal(tmvit.get_3d_sincos_pos_embed(dim, grid, t, cls),
                                      jax_sincos(dim, grid, t, cls))
