"""Masked pretraining in the port against the JAX package, on the CPU: HOG,
the MaskFeat and MAE forwards (predictions, targets and masks), the loss,
the init, the weight bridge both ways, the recipes' build and the loader's
masks. Training is in tests/test_torch_masked_train.py, which shares this
file's models.

Models, their parameters seeded random values (as tests/test_torch_mvit.py
sets them) carried to the port through ``state_dict_from_jax``:

* ``VIT``: the tiny ViT of tests/test_masked_modes.py:38-51, 4 frames of
  64², patch (2, 16, 16), 2 blocks of 64 channels, a (2, 4, 4) token grid;
* ``V2``: ``k400_MVITv2_S_16x4_MaskFeat_PT.yaml`` narrowed as
  tests/test_torch_mvit.py narrows MViTv2-S (4 blocks, 16 -> 64 channels, q
  strides at blocks 1 and 3), 4 frames of 56²: token grids 14 -> 7 -> 4,
  odd on the way; at 112², 28 -> 14 -> 7.

The random masks are made equal on both sides by handing both the same
noise (``jax.random.uniform`` and the port's ``uniform_noise`` patched, as
tests/test_masked_modes.py ``_patch_rngs`` does for the JAX package), or
by a loader mask. Tolerances: fp32 outputs within 2e-5 + 1e-4 relative
(the MViT family's 1e-5, loosened to 2e-5 for the attention core's
default-core departure, ROADMAP Queue 3 #3), targets and HOG within 1e-5,
masks bit-equal; bf16 within 2e-2 of each output's scale.
"""

import math
import os
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from slowfast_tpu.config import get_cfg as jax_get_cfg
from slowfast_tpu.data import kinetics as jkinetics
from slowfast_tpu.data import transform as jtr
from slowfast_tpu.models import build_model as jax_build_model
from slowfast_tpu.models import masked as jmasked
from slowfast_tpu.models import mvit as jmvit
from slowfast_tpu.models.build import _scale_init_by_depth, init_model
from slowfast_tpu.ops.hog import hog_features as jax_hog
from slowfast_tpu.solver import losses as jlosses
from slowfast_tpu.utils.checkpoint import load_torch_checkpoint_dict
from slowfast_tpu_torch.config import get_cfg
from slowfast_tpu_torch.data import kinetics as tkinetics
from slowfast_tpu_torch.data import transform as ttr
from slowfast_tpu_torch.data.loader import Loader, collate, multiple_samples_collate
from slowfast_tpu_torch.models import build as tbuild
from slowfast_tpu_torch.models import masked as tmasked
from slowfast_tpu_torch.models import mvit as tmvit
from slowfast_tpu_torch.ops.hog import hog_features, orientation_bins
from slowfast_tpu_torch.solver import losses as tlosses
from slowfast_tpu_torch.utils.checkpoint import state_dict_from_jax
from test_torch_mvit import NARROW as V2_NARROW
from test_torch_mvit_family import jit_run
from test_torch_mvit import randomize
from test_torch_train import one_torch_thread  # noqa: F401  (fixture)

ATOL, RTOL = 2e-5, 1e-4
TARGET_TOL = 1e-5
BF16_TOL = 2e-2
CONFIGS = os.path.join(os.path.dirname(__file__), "..", "configs")
MASKFEAT_YAML = os.path.join(CONFIGS, "masked_ssl", "k400_MVITv2_S_16x4_MaskFeat_PT.yaml")
MAE_YAML = os.path.join(CONFIGS, "masked_ssl", "k400_VIT_B_16x4_MAE_PT.yaml")

VIT = (None, [
    "MODEL.MODEL_NAME", "MaskMViT", "MODEL.ARCH", "maskmvit", "MODEL.NUM_CLASSES", "16",
    "MODEL.DROPOUT_RATE", "0.0", "MODEL.LOSS_FUNC", "multi_mse", "TASK", "ssl",
    "MASK.ENABLE", "True", "MASK.PRETRAIN_DEPTH", "[1]",
    "MVIT.EMBED_DIM", "64", "MVIT.NUM_HEADS", "2", "MVIT.DEPTH", "2",
    "MVIT.PATCH_KERNEL", "[2,16,16]", "MVIT.PATCH_STRIDE", "[2,16,16]",
    "MVIT.PATCH_PADDING", "[0,0,0]", "MVIT.MODE", "conv", "MVIT.CLS_EMBED_ON", "True",
    "MVIT.SEP_POS_EMBED", "True", "MVIT.USE_ABS_POS", "True", "MVIT.QKV_BIAS", "True",
    "MVIT.DROPPATH_RATE", "0.0", "MVIT.ZERO_DECAY_POS_CLS", "False",
    "DATA.NUM_FRAMES", "4", "DATA.TRAIN_CROP_SIZE", "64", "DATA.TEST_CROP_SIZE", "64",
    "DATA.INPUT_CHANNEL_NUM", "[3]", "AUG.MASK_WINDOW_SIZE", "[2,4,4]"])
V2 = (MASKFEAT_YAML, [o for o in V2_NARROW if o not in ("TRAIN.ENABLE", "False")]
      + ["MASK.PRETRAIN_DEPTH", "[1]", "AUG.MASK_WINDOW_SIZE", "[2,7,7]"])
V2_112 = (V2[0], V2[1] + ["DATA.TRAIN_CROP_SIZE", "112", "DATA.TEST_CROP_SIZE", "112"])
MAE = ["MASK.MAE_ON", "True", "MASK.MAE_RND_MASK", "True", "MASK.HEAD_TYPE",
       "separate_xformer", "MASK.DECODER_DEPTH", "1", "MASK.DECODER_EMBED_DIM", "64",
       "MASK.PRED_HOG", "False", "AUG.MASK_RATIO", "0.75"]
HOG_HEAD = ["MASK.PRED_HOG", "True", "MASK.HEAD_TYPE", "separate"]
PIXEL_HEAD = ["MASK.PRED_HOG", "False", "MASK.HEAD_TYPE", "separate"]

# case -> (base model, options, mask source): "loader" hands both sides a
# seeded binary window mask, "unique" a token-grid mask of distinct values
# (MAE's mask-as-noise), "noise" patches the random draws.
MASKFEAT = {
    "vit_hog": (VIT, HOG_HEAD, "loader"),
    "vit_pixel": (VIT, PIXEL_HEAD + ["MASK.NORM_PRED_PIXEL", "True"], "loader"),
    "vit_pixel_unnormalized": (VIT, PIXEL_HEAD + ["MASK.NORM_PRED_PIXEL", "False"], "loader"),
    "vit_random_mask": (VIT, PIXEL_HEAD + ["MASK.MAE_RND_MASK", "True", "AUG.MASK_RATIO", "0.5"],
                        "noise"),
    "pooled_hog": (V2, HOG_HEAD, "loader"),
    "pooled_hog_2d_mask": (V2, HOG_HEAD, "loader_2d"),
    "pooled_hog_two_depths": (V2_112, HOG_HEAD + ["MASK.PRETRAIN_DEPTH", "[1,3]"], "loader"),
    "pooled_pixel_odd_grids": (V2, PIXEL_HEAD + ["MASK.PRETRAIN_DEPTH", "[1,3]"], "loader"),
    "pooled_random_mask": (V2, HOG_HEAD + ["MASK.MAE_RND_MASK", "True", "AUG.MASK_RATIO", "0.4"],
                           "noise"),
    "pooled_xformer_head": (V2, HOG_HEAD + ["MASK.HEAD_TYPE", "separate_xformer",
                                            "MASK.DECODER_DEPTH", "1",
                                            "MASK.DECODER_EMBED_DIM", "64"], "loader"),
}
MAE_CASES = {
    "random": (VIT, MAE, "noise"),
    "tube": (VIT, MAE + ["AUG.MASK_TUBE", "True"], "noise"),
    "per_frame_sincos": (VIT, MAE + ["MASK.PER_FRAME_MASKING", "True", "MVIT.SEP_POS_EMBED",
                                     "False", "MVIT.USE_FIXED_SINCOS_POS", "True"], "noise"),
    "loader_mask_dec_kv_sep_pos": (VIT, MAE + [
        "MASK.MAE_RND_MASK", "False", "MASK.DECODER_SEP_POS_EMBED", "True",
        "MASK.DEC_KV_KERNEL", "[1,3,3]", "MASK.DEC_KV_STRIDE", "[1,2,2]",
        "AUG.MASK_RATIO", "0.5"], "unique"),
    "joint_pos_no_time_stride": (VIT, MAE + ["MVIT.SEP_POS_EMBED", "False",
                                             "MASK.TIME_STRIDE_LOSS", "False",
                                             "MASK.NORM_PRED_PIXEL", "False"], "noise"),
    "cls_off_two_decoder_blocks": (VIT, MAE + ["MVIT.CLS_EMBED_ON", "False",
                                               "MASK.DECODER_DEPTH", "2"], "noise"),
}


def make_cfg(get, base, dtype="float32", extra=()):
    yaml, opts = base
    cfg = get()
    if yaml:
        cfg.merge_from_file(yaml)
    cfg.merge_from_list(list(opts) + ["NUM_GPUS", "1", "TPU.COMPUTE_DTYPE", dtype] + list(extra))
    return cfg


def jax_variables(base, extra=(), seed=0):
    cfg = make_cfg(jax_get_cfg, base, extra=extra)
    shapes = jax.eval_shape(lambda: init_model(jax_build_model(cfg), cfg,
                                               rng=jax.random.PRNGKey(0), train=True))
    return randomize(dict(shapes), seed)


def port_model(variables, base, dtype="float32", extra=()):
    model = tbuild.build_model(make_cfg(get_cfg, base, dtype, extra), device="cpu")
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    return model


def clips(cfg, n=2, seed=1):
    crop = cfg.DATA.TRAIN_CROP_SIZE
    shape = (n, cfg.DATA.NUM_FRAMES, crop, crop, 3)
    return np.random.RandomState(seed).normal(0.0, 1.0, shape).astype(np.float32)


def token_grid(cfg):
    ps = cfg.MVIT.PATCH_STRIDE
    crop = cfg.DATA.TRAIN_CROP_SIZE
    return cfg.DATA.NUM_FRAMES // ps[0], crop // ps[1], crop // ps[2]


def mask_input(cfg, source, n=2, seed=3):
    """The loader mask of a case, or None for the random-mask cases."""
    rs = np.random.RandomState(seed)
    if source == "loader":
        return (rs.rand(n, *cfg.AUG.MASK_WINDOW_SIZE) > 0.5).astype(np.float32)
    if source == "loader_2d":
        return (rs.rand(n, *cfg.AUG.MASK_WINDOW_SIZE[1:]) > 0.5).astype(np.float32)
    if source == "unique":
        # Distinct values, so the argsorts of both packages agree.
        size = int(np.prod(token_grid(cfg)))
        vals = (np.arange(size) + 0.5) / size
        return np.stack([rs.permutation(vals) for _ in range(n)]).reshape(
            n, *token_grid(cfg)).astype(np.float32)
    return None


def noise_for(cfg, n=2, seed=4):
    """The uniform noise a random-mask case draws: ``(B, N)``, or ``(B, 1,
    H·W)`` under ``AUG.MASK_TUBE``."""
    T0, H0, W0 = token_grid(cfg)
    shape = (n, 1, H0 * W0) if cfg.AUG.MASK_TUBE else (n, T0 * H0 * W0)
    return np.random.RandomState(seed).rand(*shape).astype(np.float32)


@pytest.fixture
def same_noise(monkeypatch):
    """``set(noise)``: both packages' random-mask draws return ``noise``."""

    def set_noise(noise):
        real_uniform = jax.random.uniform

        def fake_uniform(key, shape=(), *args, **kw):
            if tuple(shape) == noise.shape:
                return jnp.asarray(noise)
            return real_uniform(key, shape, *args, **kw)

        def fake_noise(shape, generator, device):
            assert tuple(shape) == noise.shape, shape
            return torch.from_numpy(noise.copy()).to(device)

        monkeypatch.setattr(jax.random, "uniform", fake_uniform)
        monkeypatch.setattr(tmasked, "uniform_noise", fake_noise)

    return set_noise


def jax_forward(variables, base, dtype, extra, x, mask):
    model = jax_build_model(make_cfg(jax_get_cfg, base, dtype, extra))
    if mask is None:
        preds, labels = jit_run(lambda v, x: model.apply(v, [x], train=False), variables,
                                jnp.asarray(x))
    else:
        preds, labels = jit_run(lambda v, x, m: model.apply(v, [x], mask=m, train=False),
                                variables, jnp.asarray(x), jnp.asarray(mask))
    return ([np.asarray(p, np.float32) for p in preds],
            [(np.asarray(t), np.asarray(m)) for t, m in labels])


def port_forward(variables, base, dtype, extra, x, mask):
    model = port_model(variables, base, dtype, extra)
    model.eval()
    with torch.no_grad():
        preds, labels = model([torch.from_numpy(x)],
                              mask=None if mask is None else torch.from_numpy(mask))
    return [p.float().numpy() for p in preds], [(t.numpy(), m.numpy()) for t, m in labels]


def run_case(case, dtype, same_noise):
    base, extra, source = case
    cfg = make_cfg(get_cfg, base, extra=extra)
    if source == "noise":
        same_noise(noise_for(cfg))
    variables = jax_variables(base, extra)
    x, mask = clips(cfg), mask_input(cfg, source)
    return (jax_forward(variables, base, dtype, extra, x, mask),
            port_forward(variables, base, dtype, extra, x, mask))


def assert_same_outputs(want, got, dtype):
    (want_preds, want_labels), (got_preds, got_labels) = want, got
    assert len(got_preds) == len(want_preds) == len(got_labels) == len(want_labels)
    for (t, m), (wt, wm) in zip(got_labels, want_labels):
        np.testing.assert_array_equal(m, wm)
        assert 0 < m.sum() < m.size
        np.testing.assert_allclose(t, wt, atol=TARGET_TOL, rtol=0)
    for p, wp, (t, m) in zip(got_preds, want_preds, got_labels):
        assert p.shape == wp.shape == t.shape and p.shape[1] == m.shape[1]
        if dtype == "float32":
            np.testing.assert_allclose(p, wp, atol=ATOL, rtol=RTOL)
        else:
            np.testing.assert_allclose(p, wp, atol=BF16_TOL * np.abs(wp).max(), rtol=0)


# --- HOG -----------------------------------------------------------------------


def _gradients(xp, x):
    """The separable Sobel of hog.py on ``x`` padded by the array module
    ``xp`` (numpy in float64, or jax.numpy in fp32)."""
    pad = xp.pad(x, ((0, 0), (1, 1), (1, 1), (0, 0)), mode="reflect")
    sm_v = pad[:, :-2] + 2.0 * pad[:, 1:-1] + pad[:, 2:]
    sm_h = pad[:, :, :-2] + 2.0 * pad[:, :, 1:-1] + pad[:, :, 2:]
    return sm_v[:, :, :-2] - sm_v[:, :, 2:], sm_h[:, :-2] - sm_h[:, 2:]


def jax_bins(x, nbins=9):
    """The orientation bins as slowfast_tpu/ops/hog.py:26-38 computes them."""
    gx, gy = _gradients(jnp, jnp.asarray(x))
    return np.asarray(jnp.floor(jnp.arctan2(gx, gy) / math.pi * nbins).astype(jnp.int32) % nbins)


def edge_distance64(x, nbins=9):
    """Each pixel's float64 phase distance from the nearest bin edge."""
    gx, gy = _gradients(np, x.astype(np.float64))
    phase = np.arctan2(gx, gy) / np.pi * nbins
    return np.abs(phase - np.round(phase))


HOG_FRAMES = {
    "normal": lambda rs: rs.normal(0.0, 1.0, (4, 64, 48, 3)),
    "uint8_pixels": lambda rs: rs.randint(0, 256, (3, 32, 40, 3)),
    # Flat patches: zero gradients inside and on the reflect borders.
    "flat_blocks": lambda rs: np.kron(rs.randint(0, 4, (2, 4, 4, 3)), np.ones((1, 8, 8, 1))),
    "ramps": lambda rs: (np.arange(32)[None, :, None, None] * rs.uniform(-1, 1, (2, 1, 32, 3))
                         + np.arange(32)[None, None, :, None] * rs.uniform(-1, 1, (2, 32, 1, 3))),
    "normalized_bf16": lambda rs: torch.from_numpy(rs.normal(0.0, 1.0, (2, 56, 56, 3))).to(
        torch.bfloat16).float().numpy(),
}


@pytest.mark.parametrize("name", sorted(HOG_FRAMES))
def test_hog_matches_jax(name):
    """``hog_features`` against the JAX package's within 1e-5. A pixel whose
    orientation bin differs from JAX's (a flip) must sit within 1e-5 of a
    bin edge in float64, which decides it; the flips are counted, and none
    appear on these frames."""
    x = np.asarray(HOG_FRAMES[name](np.random.RandomState(7)), np.float32)
    got = hog_features(torch.from_numpy(x)).numpy()
    want = np.asarray(jax_hog(jnp.asarray(x)))
    assert got.shape == want.shape == (x.shape[0], 3, 9, x.shape[1] // 8, x.shape[2] // 8)
    flips = orientation_bins(torch.from_numpy(x))[1].numpy() != jax_bins(x)
    assert (edge_distance64(x)[flips] < 1e-5).all(), "a bin flip off a float64 bin edge"
    assert flips.sum() == 0, f"{flips.sum()} bin flips, each on a float64 bin edge"
    np.testing.assert_allclose(got, want, atol=TARGET_TOL, rtol=0)


def test_hog_border_gradient_is_an_exact_zero():
    """On the reflect border the Sobel across the border is an exact +0.0,
    so ``atan2`` puts the pixel where JAX's does (bin 0 for a vertical
    ramp), not at ±1e-7 on either side of the 0/8 edge."""
    x = np.broadcast_to(np.arange(16, dtype=np.float32)[None, :, None, None] * 0.37,
                        (1, 16, 16, 3)).copy()
    got = hog_features(torch.from_numpy(x)).numpy()
    want = np.asarray(jax_hog(jnp.asarray(x)))
    np.testing.assert_array_equal(got, want)
    # All gradient points along H: one bin holds the whole histogram.
    assert np.count_nonzero(got[0, 0, :, 0, 0]) == 1


# --- MaskFeat and MAE forwards -----------------------------------------------------


@pytest.mark.parametrize("name", sorted(MASKFEAT))
def test_maskfeat_forward_matches_jax(name, same_noise):
    """fp32: predictions, HOG or pixel targets and masks at every depth."""
    want, got = run_case(MASKFEAT[name], "float32", same_noise)
    assert_same_outputs(want, got, "float32")


@pytest.mark.parametrize("name", sorted(MAE_CASES))
def test_mae_forward_matches_jax(name, same_noise):
    """fp32: the decoder's predictions, the pixel targets and the mask."""
    base, extra, _ = MAE_CASES[name]
    want, got = run_case(MAE_CASES[name], "float32", same_noise)
    assert_same_outputs(want, got, "float32")
    # Every row (a sample, or a frame under PER_FRAME_MASKING) hides L -
    # int(L (1 - MASK_RATIO)) tokens.
    cfg = make_cfg(get_cfg, base, extra=extra)
    _, H0, W0 = token_grid(cfg)
    m = got[1][0][1]
    rows = m.reshape(-1, H0 * W0) if cfg.MASK.PER_FRAME_MASKING else m
    L = rows.shape[1]
    assert (rows.sum(-1) == L - int(L * (1 - cfg.AUG.MASK_RATIO))).all()


@pytest.mark.parametrize("name", ["pooled_hog", "vit_hog"])
def test_maskfeat_forward_bf16_matches_jax(name, same_noise):
    want, got = run_case(MASKFEAT[name], "bfloat16", same_noise)
    assert_same_outputs(want, got, "bfloat16")


def test_mae_forward_bf16_matches_jax(same_noise):
    want, got = run_case(MAE_CASES["random"], "bfloat16", same_noise)
    assert_same_outputs(want, got, "bfloat16")


def test_mask_tube_and_eval_draws():
    """``AUG.MASK_TUBE``: one spatial mask for every frame. In eval the mask
    comes from a generator seeded with 0: two calls agree; in training the
    model's generator moves on."""
    extra = MAE + ["AUG.MASK_TUBE", "True"]
    model = tbuild.build_model(make_cfg(get_cfg, VIT, extra=extra), device="cpu")
    x = [torch.from_numpy(clips(make_cfg(get_cfg, VIT)))]
    model.eval()
    with torch.no_grad():
        m1 = model(x)[1][0][1]
        m2 = model(x)[1][0][1]
        model.train()
        m3 = model(x)[1][0][1]
        m4 = model(x)[1][0][1]
    assert torch.equal(m1, m2) and not torch.equal(m3, m4)
    grid = m3.reshape(2, 2, 16)
    assert torch.equal(grid[:, 0], grid[:, 1])


def test_maskfeat_needs_the_loader_mask():
    model = tbuild.build_model(make_cfg(get_cfg, VIT, extra=HOG_HEAD), device="cpu")
    with pytest.raises(ValueError, match="GEN_MASK_LOADER"):
        model([torch.from_numpy(clips(make_cfg(get_cfg, VIT)))])


# --- loss, geometry, init, bridge --------------------------------------------------


def test_masked_loss_and_multi_mse_match_jax():
    rs = np.random.RandomState(5)
    preds = [rs.normal(size=(2, 6, 5)).astype(np.float32) for _ in range(2)]
    targets = [rs.normal(size=(2, 6, 5)).astype(np.float32) for _ in range(2)]
    masks = [(rs.rand(2, 6) > 0.5).astype(np.float32), np.zeros((2, 6), np.float32)]
    want = float(jmasked.masked_loss([jnp.asarray(p) for p in preds],
                                     [(jnp.asarray(t), jnp.asarray(m))
                                      for t, m in zip(targets, masks)]))
    got = tmasked.masked_loss([torch.from_numpy(p) for p in preds],
                              [(torch.from_numpy(t), torch.from_numpy(m))
                               for t, m in zip(targets, masks)]).item()
    np.testing.assert_allclose(got, want, rtol=1e-6)
    # multi_mse: plain targets and (target, weight) pairs.
    labels = [(targets[0], 0.3), targets[1]]
    want_sum, want_multi = jlosses.multi_mse(
        [jnp.asarray(p) for p in preds],
        [(jnp.asarray(labels[0][0]), 0.3), jnp.asarray(labels[1])])
    got_sum, got_multi = tlosses.get_loss_func("multi_mse")(
        [torch.from_numpy(p) for p in preds],
        [(torch.from_numpy(labels[0][0]), 0.3), torch.from_numpy(labels[1])])
    np.testing.assert_allclose(got_sum.item(), float(want_sum), rtol=1e-6)
    np.testing.assert_allclose([g.item() for g in got_multi],
                               [float(w) for w in want_multi], rtol=1e-6)


@pytest.mark.parametrize("base,extra", [
    (V2, []), (V2_112, ["MASK.PRETRAIN_DEPTH", "[1,3]"]), ((MASKFEAT_YAML, []), []),
    ((os.path.join(CONFIGS, "masked_ssl", "k400_MVITv2_L_16x4_MaskFeat_PT.yaml"), []), [])],
    ids=["narrow_56", "narrow_112", "mvitv2_s", "mvitv2_l"])
def test_maskfeat_feature_size_matches_jax(base, extra):
    want = jmvit.maskfeat_feature_size(make_cfg(jax_get_cfg, base, extra=extra))
    assert tmvit.maskfeat_feature_size(make_cfg(get_cfg, base, extra=extra)) == want


def test_scale_init_by_depth_matches_jax():
    """``MASK.SCALE_INIT_BY_DEPTH`` on the same weights: the port's rescale
    equals JAX's, the decoder's attention ids past the trunk's."""
    extra = MAE + ["MASK.DECODER_DEPTH", "2"]
    variables = jax_variables(VIT, extra)
    want = state_dict_from_jax(_scale_init_by_depth(variables))
    model = port_model(variables, VIT, extra=extra)
    tbuild.scale_init_by_depth(model)
    got = model.state_dict()
    for name in want:
        np.testing.assert_allclose(got[name].numpy(), want[name].numpy(), rtol=1e-7,
                                   err_msg=name)
    before = state_dict_from_jax(variables)
    ratio = lambda n: (got[n] / before[n]).mean().item()  # noqa: E731
    assert ratio("pred_head.transforms.0.1.attn.proj.weight") == pytest.approx(8 ** -0.5)
    assert ratio("pred_head.transforms.0.1.mlp.fc2.weight") == pytest.approx(4 ** -0.5)
    # build_model applies it under the flag.
    on = tbuild.build_model(make_cfg(get_cfg, VIT, extra=extra + [
        "MASK.SCALE_INIT_BY_DEPTH", "True"]), device="cpu").state_dict()
    off = tbuild.build_model(make_cfg(get_cfg, VIT, extra=extra), device="cpu").state_dict()
    assert torch.allclose(on["blocks.1.mlp.fc2.weight"], off["blocks.1.mlp.fc2.weight"] / 2.0)


def test_init_follows_jax():
    """The JAX package's init laws: the mask token and decoder pos-embeds
    trunc_normal(0.02); the heads' LayerNorms scale 1 and bias 0, their
    projections a zero bias; ``norm`` and ``decoder_embed`` the 0.02 bias."""
    extra = MAE + ["MVIT.SEP_POS_EMBED", "False"]
    sd = tbuild.build_model(make_cfg(get_cfg, VIT, extra=extra), device="cpu").state_dict()
    for name in ("mask_token", "decoder_pos_embed", "pred_head.projections.0.weight",
                 "decoder_embed.weight"):
        assert 0.0 < sd[name].abs().max() <= 0.04, name
    assert torch.all(sd["pred_head.transforms.0.1.weight"] == 1.0)
    assert not sd["pred_head.transforms.0.1.bias"].any()
    assert not sd["pred_head.projections.0.bias"].any()
    for name in ("norm.bias", "decoder_embed.bias", "pred_head.transforms.0.0.norm1.bias"):
        assert torch.all(sd[name] == 0.02), name
    jcfg = make_cfg(jax_get_cfg, VIT, extra=extra)
    jsd = state_dict_from_jax(jax.tree.map(np.asarray, jit_run(lambda: init_model(
        jax_build_model(jcfg), jcfg, rng=jax.random.PRNGKey(0)))))
    assert sd.keys() == jsd.keys()
    for name in ("pred_head.transforms.0.1.bias", "pred_head.projections.0.bias", "norm.bias"):
        assert torch.equal(sd[name], jsd[name]), name


@pytest.mark.parametrize("base,extra", [
    (VIT, HOG_HEAD), (V2, HOG_HEAD + ["MASK.HEAD_TYPE", "separate_xformer",
                                      "MASK.DECODER_DEPTH", "1"]),
    (VIT, MAE + ["MASK.DECODER_SEP_POS_EMBED", "True"])],
    ids=["maskfeat", "maskfeat_xformer", "mae_sep_dec_pos"])
def test_bridge_round_trip(base, extra):
    """A port ``state_dict`` loads into the JAX package through
    ``load_torch_checkpoint_dict`` (every leaf, nothing left over) and
    gives back the variables it came from."""
    variables = jax_variables(base, extra)
    sd = {k: v.numpy() for k, v in port_model(variables, base, extra=extra)
          .state_dict().items()}
    loaded, missing, unexpected = load_torch_checkpoint_dict(sd, variables)
    assert not missing and not unexpected
    want = traverse_util.flatten_dict(variables["params"])
    got = traverse_util.flatten_dict(loaded["params"])
    assert want.keys() == got.keys()
    for path in want:
        np.testing.assert_array_equal(np.asarray(got[path]), want[path], err_msg=str(path))


MASKED_RECIPES = ["k400_MVITv2_S_16x4_MaskFeat_PT.yaml", "k400_MVITv2_L_16x4_MaskFeat_PT.yaml",
                  "MVITv2_S_16x4_MaskFeat_PT.yaml", "k400_VIT_B_16x4_MAE_PT.yaml",
                  "k400_VIT_L_16x4_MAE_PT.yaml", "k400_VIT_H_16x4_MAE_PT.yaml"]


@pytest.mark.parametrize("recipe", MASKED_RECIPES)
def test_recipe_builds_at_full_size(recipe):
    """Each 3D masked recipe builds and initializes at full width and depth,
    on the meta device; its heads' widths are JAX's."""
    cfg = get_cfg()
    cfg.merge_from_file(os.path.join(CONFIGS, "masked_ssl", recipe))
    with torch.device("meta"):
        model = tmasked.MaskMViT(cfg)
        tbuild.init_mvit_weights(model, cfg, torch.Generator().manual_seed(0))
    assert len(model.blocks) == max(cfg.MASK.PRETRAIN_DEPTH) + 1
    assert sum(p.numel() for p in model.parameters()) > 1e7
    jcfg = jax_get_cfg()
    jcfg.merge_from_file(os.path.join(CONFIGS, "masked_ssl", recipe))
    for proj in model.pred_head.projections:
        if cfg.MASK.MAE_ON:
            assert proj.out_features == 2 * 16 * 16 * 3 // (2 if cfg.MASK.TIME_STRIDE_LOSS else 1)
        else:  # HOG: 9 bins x 3 channels x the cells of a feature cell
            cells = (cfg.DATA.TRAIN_CROP_SIZE // 8) // jmvit.maskfeat_feature_size(jcfg)
            assert proj.out_features == 27 * cells * cells


@pytest.mark.parametrize("recipe", ["in1k_VIT_B_MaskFeat_PT.yaml", "in1k_VIT_L_MaskFeat_PT.yaml"])
def test_patch_2d_recipes_refuse(recipe):
    """The 2D patch recipes no longer refuse (the 2D stem is ported,
    tests/test_torch_imagenet.py): ``MaskMViT`` builds at full size on the
    meta device with a 2D stem and the 14² grid, and a ``Syntheticvideo``
    item carries the JAX package's 2D mask at that grid."""
    cfg = get_cfg()
    cfg.merge_from_file(os.path.join(CONFIGS, "masked_ssl", recipe))
    with torch.device("meta"):
        model = tmasked.MaskMViT(cfg)
    assert model.patch_embed.proj.weight.shape[1:] == (3, 16, 16)
    assert model.patch_dims == [1, 14, 14]
    jcfg = jax_get_cfg()
    jcfg.merge_from_file(os.path.join(CONFIGS, "masked_ssl", recipe))
    cfg.merge_from_list(["DATA.TRAIN_CROP_SIZE", "224"])
    seed = tkinetics.utils.sample_seed(cfg.RNG_SEED, 0, 3)
    random.seed(seed)
    np.random.seed(seed)
    want = jkinetics.gen_mask(jcfg)
    got = tkinetics.Syntheticvideo(cfg, "train")[3][4]["mask"]
    assert got.shape == (14, 14)
    np.testing.assert_array_equal(got, want)


# --- loader masks ---------------------------------------------------------------------


@pytest.mark.parametrize("window,num,max_block", [
    ((7, 7), 20, None), ((14, 14), 118, 40), ((5, 9), 30, None)])
def test_masking_generator_matches_jax(window, num, max_block):
    for seed in range(5):
        random.seed(seed)
        want = jtr.MaskingGenerator(window, num, max_num_patches=max_block)()
        got = ttr.MaskingGenerator(window, num, max_num_patches=max_block)(random.Random(seed))
        np.testing.assert_array_equal(got, want)
        assert got.dtype == want.dtype and 0 < got.sum() <= num


@pytest.mark.parametrize("window,num", [((8, 7, 7), 157), ((2, 4, 4), 13), ((4, 14, 14), 400)])
def test_masking_generator_3d_matches_jax(window, num):
    """Bit-equal 3D masks. A block that cannot be placed in 10 draws ends
    the mask early, on both sides (at the MaskFeat recipe's [8, 7, 7] and
    157 cells, some masks end empty)."""
    sums = []
    for seed in range(8):
        random.seed(seed)
        want = jtr.MaskingGenerator3D(window, num)()
        got = ttr.MaskingGenerator3D(window, num)(random.Random(seed))
        np.testing.assert_array_equal(got, want)
        sums.append(got.sum())
    assert max(sums) > 0


MASK_OPTIONS = {
    "blocks_3d": ["AUG.MASK_RATIO", "0.4"],
    "tube": ["AUG.MASK_RATIO", "0.5", "AUG.MASK_TUBE", "True"],
    "frames": ["AUG.MASK_RATIO", "0.5", "AUG.MASK_FRAMES", "True"],
    "repeated_aug": ["AUG.MASK_RATIO", "0.4", "AUG.ENABLE", "True", "AUG.NUM_SAMPLE", "2",
                     "AUG.RE_PROB", "0.0", "AUG.AA_TYPE", ""],
}


@pytest.mark.parametrize("name", sorted(MASK_OPTIONS))
def test_gen_mask_matches_jax(name):
    """``gen_mask`` from the same two streams as JAX's from the seeded
    modules: bit-equal masks, float32 at the window's shape."""
    opts = ["AUG.GEN_MASK_LOADER", "True", "AUG.MASK_WINDOW_SIZE", "[4,7,7]"] + MASK_OPTIONS[name]
    jcfg, cfg = jax_get_cfg(), get_cfg()
    jcfg.merge_from_list(opts)
    cfg.merge_from_list(opts)
    for seed in range(4):
        random.seed(seed)
        np.random.seed(seed)
        want = jkinetics.gen_mask(jcfg)
        got = tkinetics.gen_mask(cfg, random.Random(seed), np.random.RandomState(seed))
        assert got.dtype == want.dtype == np.float32 and got.shape == (4, 7, 7)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", sorted(MASK_OPTIONS))
def test_kinetics_items_carry_jax_masks(name, corpus):
    """Kinetics train items with ``AUG.GEN_MASK_LOADER``: clips and masks
    bit-equal to the JAX package's (one mask a repeat under ``NUM_SAMPLE``
    2); the loader stacks the masks into ``meta["mask"]`` on the device."""
    from test_torch_data import assert_same_item, both_cfgs, seeded

    from slowfast_tpu.data.kinetics import Kinetics as JaxKinetics
    from slowfast_tpu_torch.data import utils as tutils

    opts = ["AUG.GEN_MASK_LOADER", "True", "AUG.MASK_WINDOW_SIZE", "[4,7,7]"] + MASK_OPTIONS[name]
    jcfg, cfg = both_cfgs(corpus, opts)
    jds, ds = JaxKinetics(jcfg, "train"), tkinetics.Kinetics(cfg, "train")
    for index in range(len(ds)):
        seeded(tutils.sample_seed(cfg.RNG_SEED, 0, index))
        got, want = ds[index], jds[index]
        gm, wm = ((got[4], want[4]) if isinstance(got[4], list) else ([got[4]], [want[4]]))
        assert len(gm) == len(wm) == (2 if name == "repeated_aug" else 1)
        for g, w in zip(gm, wm):
            np.testing.assert_array_equal(g.pop("mask"), w.pop("mask"))
        assert_same_item(got, want)
    loader = Loader(ds, 2, "cpu", num_workers=2,
                    collate_fn=multiple_samples_collate if name == "repeated_aug" else collate)
    inputs, _, _, _, meta = next(iter(loader))
    assert isinstance(meta["mask"], torch.Tensor)
    assert meta["mask"].shape == (inputs[0].shape[0], 4, 7, 7)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    pytest.importorskip("cv2")
    from slowfast_tpu_torch.data import synth_media

    root = str(tmp_path_factory.mktemp("k400_masked"))
    return synth_media.make_video_corpus(root, {"train": 2, "val": 2}, frames=80,
                                         size=(160, 120))
