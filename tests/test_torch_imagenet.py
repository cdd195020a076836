"""ImageNet and the 2D patch stem in the port against the JAX package, on
the CPU.

* ``Imagenet`` items (train with and without RandAugment and random
  erasing, 2D MaskFeat's loader masks, val, test, the preload json) equal
  the JAX package's on JPEGs written with cv2, each item's generators
  seeded as the JAX package's global ones.
* The 2D stem: ``configs/ImageNet/MVITv2_S.yaml`` narrowed as
  tests/test_torch_mvit.py narrows MViTv2-S (4 blocks, 16 -> 64 channels)
  on 56² images, eval forward fp32 within 1e-5 + 1e-4 relative and bf16
  within 2e-2 of the output's scale, and one train step's gradients
  against ``jax.grad`` (fp32 within 1e-5 + 1e-4 relative; bf16 as close
  to JAX's fp32 gradients as JAX's own bf16 ones, within 1.5 times, the
  MViT family's rule); ``in1k_VIT_B_MaskFeat_PT.yaml`` narrowed
  (2 blocks of 64, 64² images, a 4 x 4 grid) with a loader 2D mask, its
  forward as tests/test_torch_masked.py holds MaskFeat's and its
  gradients; ``REV_VIT_S.yaml`` narrowed, its forward.
* The bridge: the 2D kernel (kh, kw, C, D) <-> (D, C, kh, kw) both ways,
  and the partial load of a 2D checkpoint.
* Every ``configs/ImageNet/*`` and ``configs/masked_ssl/in1k_*`` YAML
  builds at full size (on the meta device).
"""

import glob
import json
import os
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slowfast_tpu.config import get_cfg as jax_get_cfg
from slowfast_tpu.data import kinetics as jkinetics
from slowfast_tpu.data.imagenet import Imagenet as JaxImagenet
from slowfast_tpu.models import build_model as jax_build_model
from slowfast_tpu.models import masked as jmasked
from slowfast_tpu.solver import losses as jlosses
from slowfast_tpu.utils.checkpoint import load_torch_checkpoint_dict
from slowfast_tpu_torch.config import get_cfg
from slowfast_tpu_torch.data import kinetics as tkinetics
from slowfast_tpu_torch.data.imagenet import Imagenet
from slowfast_tpu_torch.data.loader import construct_loader
from slowfast_tpu_torch.data.utils import sample_seed
from slowfast_tpu_torch.models import masked as tmasked
from slowfast_tpu_torch.models.build import MODEL_REGISTRY, init_mvit_weights, init_weights
from slowfast_tpu_torch.models.stem import PatchEmbed
from slowfast_tpu_torch.solver import losses as tlosses
from slowfast_tpu_torch.utils.checkpoint import load_state_dict_partial, state_dict_from_jax
from test_torch_masked import (assert_same_outputs, jax_forward, jax_variables, make_cfg,
                               port_forward, port_model)
from test_torch_mvit_family import jit_run
from test_torch_train import one_torch_thread  # noqa: F401  (autouse fixture)

cv2 = pytest.importorskip("cv2")

CONFIGS = os.path.join(os.path.dirname(__file__), "..", "configs")
ATOL, RTOL = 1e-5, 1e-4
BF16_TOL = 2e-2
PLAIN = ["MIXUP.ENABLE", "False", "MVIT.DROPPATH_RATE", "0.0", "MODEL.DROPOUT_RATE", "0.0"]
MVIT2D = (os.path.join(CONFIGS, "ImageNet", "MVITv2_S.yaml"), [
    "MVIT.DEPTH", "4", "MVIT.EMBED_DIM", "16", "MVIT.NUM_HEADS", "1",
    "MVIT.DIM_MUL", "[[1,2.0],[3,2.0]]", "MVIT.HEAD_MUL", "[[1,2.0],[3,2.0]]",
    "MVIT.POOL_Q_STRIDE", "[[0,1,1,1],[1,1,2,2],[2,1,1,1],[3,1,2,2]]",
    "MVIT.POOL_KV_STRIDE", "[[0,1,4,4],[1,1,2,2],[2,1,2,2],[3,1,1,1]]",
    "DATA.TRAIN_CROP_SIZE", "56", "DATA.TEST_CROP_SIZE", "56", "MODEL.NUM_CLASSES", "16"])
MASKFEAT2D = (os.path.join(CONFIGS, "masked_ssl", "in1k_VIT_B_MaskFeat_PT.yaml"), [
    "MVIT.DEPTH", "2", "MVIT.EMBED_DIM", "64", "MVIT.NUM_HEADS", "2",
    "MASK.PRETRAIN_DEPTH", "[1]", "DATA.TRAIN_CROP_SIZE", "64", "DATA.TEST_CROP_SIZE", "64",
    "MVIT.DROPPATH_RATE", "0.0"])
REVVIT2D = (os.path.join(CONFIGS, "ImageNet", "REV_VIT_S.yaml"), [
    "MVIT.DEPTH", "2", "MVIT.EMBED_DIM", "64", "MVIT.NUM_HEADS", "2",
    "DATA.TRAIN_CROP_SIZE", "64", "DATA.TEST_CROP_SIZE", "64", "MODEL.NUM_CLASSES", "16",
    "MVIT.DROPPATH_RATE", "0.0"])


def images(cfg, n=2, seed=1):
    crop = cfg.DATA.TRAIN_CROP_SIZE
    return np.random.RandomState(seed).normal(0.0, 1.0, (n, 1, crop, crop, 3)).astype(np.float32)


def mask2d(cfg, n=2, seed=3):
    from slowfast_tpu_torch.models.mvit import maskfeat_feature_size

    h = maskfeat_feature_size(cfg)
    return (np.random.RandomState(seed).rand(n, h, h) > 0.5).astype(np.float32)


# --- the 2D stem -----------------------------------------------------------------


def test_patch_embed_2d_is_a_per_frame_conv():
    embed = PatchEmbed(3, 8, [7, 7], [4, 4], [3, 3], conv_2d=True)
    torch.nn.init.normal_(embed.proj.weight)
    x = torch.randn(2, 3, 20, 24, 3)
    tokens, thw = embed(x)
    assert embed.proj.weight.shape == (8, 3, 7, 7) and thw == [3, 5, 6]
    want = torch.nn.functional.conv2d(x.reshape(6, 20, 24, 3).permute(0, 3, 1, 2),
                                      embed.proj.weight, embed.proj.bias, 4, 3)
    torch.testing.assert_close(tokens, want.permute(0, 2, 3, 1).reshape(2, 90, 8))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mvitv2_2d_forward_matches_jax(dtype):
    variables = jax_variables(MVIT2D)
    x = images(make_cfg(get_cfg, MVIT2D))
    jmodel = jax_build_model(make_cfg(jax_get_cfg, MVIT2D, dtype))
    want = np.asarray(jit_run(lambda v, x: jmodel.apply(v, [x], train=False), variables,
                              jnp.asarray(x)), np.float32)
    model = port_model(variables, MVIT2D, dtype)
    model.eval()
    with torch.no_grad():
        got = model([torch.from_numpy(x)]).float().numpy()
    assert got.shape == want.shape == (2, 16)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    else:
        np.testing.assert_allclose(got, want, atol=BF16_TOL * np.abs(want).max(), rtol=0)


def jax_grads(base, dtype, labels, loss, inputs):
    """JAX's loss and gradients (``jax.grad``) of one train step of ``base``
    on ``inputs`` (``{"x", "mask"}``), in the port's names."""
    jmodel = jax_build_model(make_cfg(jax_get_cfg, base, dtype, PLAIN))
    x, mask = inputs["x"], inputs.get("mask")

    def jloss(params):
        kw = {} if mask is None else {"mask": jnp.asarray(mask)}
        out = jmodel.apply({"params": params}, [jnp.asarray(x)], train=True,
                           rngs={"dropout": jax.random.PRNGKey(0)}, **kw)
        return loss[0](out, labels)

    want_loss, want = jit_run(jax.value_and_grad(jloss), jax_variables(base)["params"])
    return float(want_loss), state_dict_from_jax({"params": jax.tree.map(np.asarray, want)})


def port_grads(base, dtype, labels, loss, inputs):
    model = port_model(jax_variables(base), base, dtype, PLAIN)
    model.train()
    mask = inputs.get("mask")
    kw = {} if mask is None else {"mask": torch.from_numpy(mask)}
    got_loss = loss[1](model([torch.from_numpy(inputs["x"])], **kw), labels)
    got_loss.backward()
    return got_loss.item(), {n: p.grad for n, p in model.named_parameters()}


def rel_l2(got, want, names):
    g = torch.cat([got[n].float().flatten() for n in names])
    w = torch.cat([want[n].float().flatten() for n in names])
    return ((g - w).norm() / w.norm()).item()


def check_grads(base, dtype, labels, loss, inputs):
    """fp32: the loss within 1e-5, every gradient within 1e-5 + 1e-4
    relative. bf16: the loss within 2e-2, and the gradients as close to
    JAX's fp32 ones as JAX's own bf16 ones are, within 1.5 times (relative
    L2; tests/test_torch_mvit_family_train.py's rule)."""
    want_loss, want = jax_grads(base, "float32", labels, loss, inputs)
    got_loss, got = port_grads(base, dtype, labels, loss, inputs)
    assert sorted(got) == sorted(want)
    names = [n for n in want if want[n].abs().max() > 0]
    if dtype == "float32":
        np.testing.assert_allclose(got_loss, want_loss, rtol=1e-5)
        for n in names:
            np.testing.assert_allclose(got[n].numpy(), want[n].numpy(), atol=ATOL, rtol=RTOL,
                                       err_msg=n)
        return
    np.testing.assert_allclose(got_loss, want_loss, rtol=BF16_TOL)
    jax_bf16 = rel_l2(jax_grads(base, dtype, labels, loss, inputs)[1], want, names)
    assert rel_l2(got, want, names) <= 1.5 * jax_bf16, (rel_l2(got, want, names), jax_bf16)


CE = (lambda out, y: jlosses.soft_cross_entropy(out, jnp.asarray(y)),
      lambda out, y: tlosses.soft_cross_entropy(out, torch.from_numpy(y)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mvitv2_2d_gradients_match_jax_grad(dtype):
    cfg = make_cfg(get_cfg, MVIT2D)
    y = np.random.RandomState(3).randint(0, 16, (2,)).astype(np.int64)
    check_grads(MVIT2D, dtype, y, CE, {"x": images(cfg)})


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_maskfeat_2d_forward_matches_jax(dtype):
    cfg = make_cfg(get_cfg, MASKFEAT2D)
    variables = jax_variables(MASKFEAT2D)
    x, mask = images(cfg), mask2d(cfg)
    assert mask.shape == (2, 4, 4) and 0 < mask.sum() < mask.size
    want = jax_forward(variables, MASKFEAT2D, dtype, (), x, mask)
    got = port_forward(variables, MASKFEAT2D, dtype, (), x, mask)
    assert got[0][0].shape == (2, 16, 27 * 2 * 2)  # HOG cells of each 16² patch
    assert_same_outputs(want, got, dtype)


def test_maskfeat_2d_gradients_match_jax_grad():
    cfg = make_cfg(get_cfg, MASKFEAT2D)
    loss = (lambda out, _: jmasked.masked_loss(*out), lambda out, _: tmasked.masked_loss(*out))
    check_grads(MASKFEAT2D, "float32", None, loss, {"x": images(cfg), "mask": mask2d(cfg)})


def test_rev_vit_2d_forward_matches_jax():
    variables = jax_variables(REVVIT2D)
    x = images(make_cfg(get_cfg, REVVIT2D))
    jmodel = jax_build_model(make_cfg(jax_get_cfg, REVVIT2D))
    want = np.asarray(jit_run(lambda v, x: jmodel.apply(v, [x], train=False), variables,
                              jnp.asarray(x)))
    model = port_model(variables, REVVIT2D)
    model.eval()
    with torch.no_grad():
        got = model([torch.from_numpy(x)]).numpy()
    assert got.shape == want.shape == (2, 16)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def test_2d_stem_round_trips_through_the_bridge():
    variables = jax_variables(MVIT2D)
    sd = state_dict_from_jax(variables)
    kernel = np.asarray(variables["params"]["patch_embed"]["proj"]["kernel"])
    assert kernel.shape == (7, 7, 3, 16) and sd["patch_embed.proj.weight"].shape == (16, 3, 7, 7)
    np.testing.assert_array_equal(sd["patch_embed.proj.weight"].numpy(),
                                  kernel.transpose(3, 2, 0, 1))
    model = port_model(variables, MVIT2D)
    back = load_torch_checkpoint_dict({k: v.numpy() for k, v in model.state_dict().items()},
                                      jax.tree.map(np.zeros_like, variables))
    flat = jax.tree_util.tree_leaves_with_path
    for (path, got), (_, want) in zip(flat(back), flat(variables)):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want), err_msg=str(path))
    # The partial load (a fine-tune's) takes the 2D kernel by name and shape.
    fresh = port_model(jax_variables(MVIT2D, seed=1), MVIT2D)
    report = load_state_dict_partial(fresh, model.state_dict())
    assert "patch_embed.proj.weight" in report.loaded and not report.missing
    assert torch.equal(fresh.patch_embed.proj.weight, model.patch_embed.proj.weight)


RECIPES = sorted(glob.glob(os.path.join(CONFIGS, "ImageNet", "*.yaml"))
                 + glob.glob(os.path.join(CONFIGS, "masked_ssl", "in1k_*.yaml")))


def test_every_imagenet_and_in1k_recipe_builds():
    """At full width and depth, the parameters on the meta device; the
    MViT family's 2D stems are 4-D kernels."""
    assert len(RECIPES) == 12
    for recipe in RECIPES:
        cfg = get_cfg()
        cfg.merge_from_file(recipe)
        with torch.device("meta"):
            model = MODEL_REGISTRY[cfg.MODEL.MODEL_NAME](cfg)
            init = init_weights if cfg.MODEL.MODEL_NAME == "ResNet" else init_mvit_weights
            init(model, cfg, torch.Generator().manual_seed(0))
        assert sum(p.numel() for p in model.parameters()) > 2e7, recipe
        if cfg.MODEL.ARCH != "2d":
            assert model.patch_embed.proj.weight.dim() == 4, recipe


# --- the dataset -------------------------------------------------------------------


@pytest.fixture(scope="module")
def image_root(tmp_path_factory):
    """Two classes of JPEGs of assorted sizes in each split, and a preload
    json of the train split listing them in another order."""
    root = tmp_path_factory.mktemp("imagenet")
    rs = np.random.RandomState(0)
    sizes = [(48, 64), (70, 52), (40, 40), (90, 60), (56, 80)]
    for split, counts in (("train", (3, 2)), ("val", (1, 2))):
        k = 0
        for c, n in zip(("n01", "n02"), counts):
            os.makedirs(root / split / c)
            for i in range(n):
                h, w = sizes[k % len(sizes)]
                k += 1
                cv2.imwrite(str(root / split / c / f"img_{i}.JPEG"),
                            (rs.rand(h, w, 3) * 255).astype(np.uint8))
    imdb = [{"im_path": str(root / "val" / "n02" / "img_1.JPEG"), "class": 1},
            {"im_path": str(root / "train" / "n01" / "img_2.JPEG"), "class": 0}]
    (root / "preload").mkdir()
    for split in ("train", "val"):
        (root / "preload" / f"{split}.json").write_text(json.dumps(imdb))
    return str(root)


BASE = ["DATA.TRAIN_CROP_SIZE", "32", "DATA.TEST_CROP_SIZE", "32", "NUM_GPUS", "1",
        "DATA.MEAN", "[0.485, 0.456, 0.406]", "DATA.STD", "[0.229, 0.224, 0.225]"]
AUG = ["AUG.ENABLE", "True", "AUG.AA_TYPE", "rand-m9-n6-mstd0.5-inc1", "AUG.RE_PROB", "0.9",
       "AUG.RE_MODE", "pixel", "AUG.INTERPOLATION", "bicubic"]
ITEMS = {
    "plain": (os.path.join(CONFIGS, "ImageNet", "MVITv2_S.yaml"), ["AUG.ENABLE", "False"]),
    "randaug_erasing": (os.path.join(CONFIGS, "ImageNet", "MVITv2_S.yaml"), AUG),
    "maskfeat": MASKFEAT2D,
    "resnet": (os.path.join(CONFIGS, "ImageNet", "RES_R50.yaml"), []),
}
CASES = [(name, "train") for name in sorted(ITEMS)] + [("plain", "val"), ("resnet", "test"),
                                                       ("plain", "preload")]


def item_cfgs(root, name, extra=()):
    yaml, opts = ITEMS[name]
    out = []
    for get in (jax_get_cfg, get_cfg):
        cfg = get()
        cfg.merge_from_file(yaml)
        cfg.merge_from_list(BASE + list(opts) + ["DATA.PATH_TO_DATA_DIR", root] + list(extra))
        out.append(cfg)
    return out


@pytest.mark.parametrize("name,mode", CASES)
def test_imagenet_items_match_jax(image_root, name, mode):
    extra = (["DATA.PATH_TO_PRELOAD_IMDB", os.path.join(image_root, "preload")]
             if mode == "preload" else [])
    jcfg, cfg = item_cfgs(image_root, name, extra)
    mode = "train" if mode == "preload" else mode
    if name == "maskfeat":
        # The JAX package's pack_pathway_output does not list MaskMViT's
        # arch and raises; listed, its items are the port's.
        with pytest.raises(NotImplementedError, match="maskmvit"):
            seed = sample_seed(cfg.RNG_SEED, 0, 0)
            random.seed(seed)
            np.random.seed(seed)
            JaxImagenet(jcfg, mode)[0]
        jcfg.MODEL.SINGLE_PATHWAY_ARCH = jcfg.MODEL.SINGLE_PATHWAY_ARCH + ["maskmvit"]
    ds, jds = Imagenet(cfg, mode), JaxImagenet(jcfg, mode)
    assert len(ds) == len(jds) == (2 if extra else 5 if mode == "train" else 3)
    for index in range(len(ds)):
        seed = sample_seed(cfg.RNG_SEED, 0, index)
        random.seed(seed)
        np.random.seed(seed)
        want = jds[index]
        got = ds[index]
        crop = cfg.DATA.TRAIN_CROP_SIZE if mode == "train" else cfg.DATA.TEST_CROP_SIZE
        assert len(got[0]) == len(want[0]) == 1
        assert got[0][0].dtype == np.float32 and got[0][0].shape == (1, crop, crop, 3)
        np.testing.assert_allclose(got[0][0], want[0][0], atol=1e-6, rtol=0)
        assert got[1:3] == want[1:3]
        assert sorted(got[4]) == sorted(want[4])
        if "mask" in want[4]:
            assert got[4]["mask"].shape == (4, 4)
            np.testing.assert_array_equal(got[4]["mask"], want[4]["mask"])


def test_imagenet_loader_batches_and_synthetic_2d_masks(image_root):
    """The loader stacks the float images (T = 1); a 2D MaskFeat recipe's
    ``Syntheticvideo`` item carries the JAX package's 2D mask."""
    _, cfg = item_cfgs(image_root, "plain", ["TRAIN.BATCH_SIZE", "2"])
    inputs, labels, index, _, _ = next(iter(construct_loader(cfg, "train", device="cpu")))
    assert inputs[0].shape == (2, 1, 32, 32, 3) and inputs[0].dtype == torch.float32
    assert labels.dtype == np.int64 and len(index) == 2
    jcfg, cfg = item_cfgs(image_root, "maskfeat")
    rng = random.Random(5)
    random.seed(5)
    want = jkinetics.gen_mask(jcfg)
    got = tkinetics.gen_mask(cfg, rng, np.random.RandomState(5))
    assert got.shape == (4, 4) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
