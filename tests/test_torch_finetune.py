"""Fine-tuning from checkpoints in the port against the JAX package, on the
CPU.

Each case writes a synthetic checkpoint, loads it into a port model with
``utils/checkpoint.py load_state_dict_partial`` (or
``utils/c2_import.py load_caffe2_checkpoint``) and into the JAX model with
the JAX package's ``load_torch_checkpoint_dict`` (or its
``load_caffe2_checkpoint``), both models starting from the same seeded
values: the port's ``state_dict`` must equal ``state_dict_from_jax`` of
JAX's variables bit for bit, with as many missing and unexpected entries.
The cases: a narrow MaskFeat pretraining checkpoint into the MViTv2
fine-tune, MAE's into the ViT fine-tune, rel-pos and pos-embed tables into
a longer clip and a larger crop, a 2D ResNet inflated into I3D,
``backbone.``-prefixed names cleared, the image-init surgery both ways, and
a caffe2 pickle. Also: the ``*_IN1K.yaml`` recipes load a 2D checkpoint, a
``run_net`` fine-tune from a port-written pretraining checkpoint, the
counts that ``chip_smoke.py``'s ``finetune_slice`` holds the full-width load
to, and the refusal of a pickle that names anything but numpy's arrays.
"""

import functools
import importlib.util
import json
import os
import pickle
import re

import jax
import numpy as np
import pytest
import torch

from slowfast_tpu.config import get_cfg as jax_get_cfg
from slowfast_tpu.models import build_model as jax_build_model
from slowfast_tpu.models.build import init_model
from slowfast_tpu.utils import c2_import as jc2
from slowfast_tpu.utils.checkpoint import load_torch_checkpoint_dict
from slowfast_tpu_torch.config import get_cfg
from slowfast_tpu_torch.models.build import build_model
from slowfast_tpu_torch.run_net import main as run_net_main
from slowfast_tpu_torch.utils import c2_import as tc2
from slowfast_tpu_torch.utils import checkpoint as cu
from test_torch_mvit import NARROW as V2_NARROW
from test_torch_mvit import randomize
from test_torch_train import one_torch_thread  # noqa: F401  (fixture)

ROOT = os.path.join(os.path.dirname(__file__), "..")
CONFIGS = os.path.join(ROOT, "configs")
MASKFEAT_PT = os.path.join(CONFIGS, "masked_ssl", "k400_MVITv2_S_16x4_MaskFeat_PT.yaml")
MVITV2_FT = os.path.join(CONFIGS, "masked_ssl", "k400_MVITv2_S_16x4_FT.yaml")
MAE_PT = os.path.join(CONFIGS, "masked_ssl", "k400_VIT_B_16x4_MAE_PT.yaml")
VIT_FT = os.path.join(CONFIGS, "masked_ssl", "k400_VIT_B_16x4_FT.yaml")
MVITV1 = os.path.join(CONFIGS, "Kinetics", "MVIT_B_16x4_CONV.yaml")
MVITV2 = os.path.join(CONFIGS, "Kinetics", "MVITv2_S_16x4.yaml")
I3D = os.path.join(CONFIGS, "Kinetics", "I3D_8x8_R50_IN1K.yaml")
C2D = os.path.join(CONFIGS, "Kinetics", "C2D_8x8_R50.yaml")
IN1K = ["C2D_8x8_R50_IN1K.yaml", "C2D_NLN_8x8_R50_IN1K.yaml", "I3D_8x8_R50_IN1K.yaml",
        "I3D_NLN_8x8_R50_IN1K.yaml"]

COMMON = ["NUM_GPUS", "1", "TPU.COMPUTE_DTYPE", "float32"]
V2_OPTS = [o for o in V2_NARROW if o not in ("TRAIN.ENABLE", "False")]
# MaskFeat's trunk ends at its last PRETRAIN_DEPTH block; at the deepest
# block the fine-tune loads it whole (112²: HOG's 14² cells tile the 7²
# grid there).
V2_112 = V2_OPTS + ["DATA.TRAIN_CROP_SIZE", "112", "DATA.TEST_CROP_SIZE", "112"]
MASKFEAT_OPTS = V2_112 + ["MASK.PRETRAIN_DEPTH", "[3]", "AUG.MASK_WINDOW_SIZE", "[2,7,7]"]
VIT_OPTS = ["MVIT.DEPTH", "2", "MVIT.EMBED_DIM", "64", "MVIT.NUM_HEADS", "2",
            "DATA.NUM_FRAMES", "4", "DATA.TRAIN_CROP_SIZE", "64", "DATA.TEST_CROP_SIZE", "64",
            "MODEL.NUM_CLASSES", "16"]
MAE_OPTS = VIT_OPTS + ["MASK.PRETRAIN_DEPTH", "[1]", "MASK.DECODER_DEPTH", "1",
                       "MASK.DECODER_EMBED_DIM", "64"]
RESNET_OPTS = ["RESNET.DEPTH", "18", "RESNET.WIDTH_PER_GROUP", "4", "DATA.NUM_FRAMES", "4",
               "DATA.TRAIN_CROP_SIZE", "32", "MODEL.NUM_CLASSES", "8"]
V1_OPTS = ["MVIT.DEPTH", "4", "MVIT.EMBED_DIM", "16", "MVIT.NUM_HEADS", "1",
           "MVIT.DIM_MUL", "[[1,2.0],[3,2.0]]", "MVIT.HEAD_MUL", "[[1,2.0],[3,2.0]]",
           "MVIT.POOL_Q_STRIDE", "[[1,1,2,2],[3,1,2,2]]", "DATA.NUM_FRAMES", "4",
           "DATA.TRAIN_CROP_SIZE", "56", "DATA.TEST_CROP_SIZE", "56", "MODEL.NUM_CLASSES", "16"]


def cfg_of(get, yaml, opts):
    cfg = get()
    if yaml:
        cfg.merge_from_file(yaml)
    cfg.merge_from_list(list(opts) + COMMON)
    return cfg


@functools.lru_cache(maxsize=None)
def jax_variables(yaml, opts, seed):
    """Seeded random values in the JAX model's variable shapes, as numpy."""
    cfg = cfg_of(jax_get_cfg, yaml, opts)
    shapes = jax.eval_shape(lambda: init_model(jax_build_model(cfg), cfg,
                                               rng=jax.random.PRNGKey(0), train=True))
    return randomize(dict(shapes), seed)


def port_model(yaml, opts, seed):
    """The port's model for ``yaml`` with the values of ``jax_variables``."""
    model = build_model(cfg_of(get_cfg, yaml, opts), device="cpu")
    model.load_state_dict(cu.state_dict_from_jax(jax_variables(yaml, tuple(opts), seed)),
                          strict=True)
    return model


def source_state_dict(yaml, opts, seed=7):
    """A checkpoint's ``model_state``: the port model of ``yaml`` with other
    seeded values."""
    return {k: v.clone() for k, v in port_model(yaml, opts, seed).state_dict().items()}


def assert_loads_like_jax(sd, yaml, opts, **kw):
    """``sd`` into the model of ``yaml`` in the port and in JAX, from the
    same values: equal state dicts (``num_batches_tracked`` aside, which JAX
    does not have), equal counts. Returns the port's report and model."""
    opts = tuple(opts)
    variables = jax_variables(yaml, opts, 0)
    want, missing, unexpected = load_torch_checkpoint_dict(
        {k: v.numpy() for k, v in sd.items()}, variables, **kw)
    model = port_model(yaml, opts, 0)
    report = cu.load_state_dict_partial(model, sd, **kw)
    assert (len(report.missing), len(report.unexpected)) == (len(missing), len(unexpected))
    assert sorted(report.unexpected) == sorted(unexpected)
    assert_equal_to_jax(model, want)
    return report, model


def assert_equal_to_jax(model, variables):
    want = cu.state_dict_from_jax(variables)
    got = {k: v for k, v in model.state_dict().items() if not k.endswith("num_batches_tracked")}
    assert got.keys() == {k for k in want if not k.endswith("num_batches_tracked")}
    for k, v in got.items():
        assert torch.equal(v, want[k]), k


def test_maskfeat_pretraining_into_the_mvitv2_fine_tune():
    """The trunk loads; the fine-tune's final norm and head stay fresh
    (missing: MaskFeat's trunk ends in its prediction head's norms), the
    mask token and the prediction head are dropped (unexpected)."""
    sd = source_state_dict(MASKFEAT_PT, MASKFEAT_OPTS)
    report, _ = assert_loads_like_jax(sd, MVITV2_FT, V2_112)
    assert sorted(report.missing) == ["head.projection.bias", "head.projection.weight",
                                      "norm.bias", "norm.weight"]
    assert report.skipped == 0 and "mask_token" in report.unexpected
    assert any(u.startswith("pred_head.") for u in report.unexpected)


def test_mae_pretraining_into_the_vit_fine_tune():
    sd = source_state_dict(MAE_PT, MAE_OPTS)
    report, _ = assert_loads_like_jax(sd, VIT_FT, VIT_OPTS)
    assert sorted(report.missing) == ["head.projection.bias", "head.projection.weight"]
    assert any(u.startswith("decoder") for u in report.unexpected)


TABLES = ["MVIT.USE_ABS_POS", "True", "MVIT.SEP_POS_EMBED", "True"]


def test_tables_resized_into_a_longer_clip_and_a_larger_crop():
    """4 frames at 56² -> 8 frames at 112²: every ``rel_pos_{h,w,t}`` table
    linearly, ``pos_embed_temporal`` linearly, ``pos_embed_spatial``
    bicubically; nothing skipped."""
    sd = source_state_dict(MVITV2, V2_OPTS + TABLES)
    bigger = V2_OPTS + TABLES + ["DATA.NUM_FRAMES", "8", "DATA.TRAIN_CROP_SIZE", "112"]
    report, model = assert_loads_like_jax(sd, MVITV2, bigger)
    assert report.skipped == 0 and not report.missing and not report.unexpected
    for name in ("pos_embed_spatial", "pos_embed_temporal", "blocks.0.attn.rel_pos_h",
                 "blocks.0.attn.rel_pos_t"):
        assert model.state_dict()[name].shape[-2] > sd[name].shape[-2], name


def test_a_2d_resnet_inflates_into_i3d():
    """Every 5-D conv of a narrow I3D given as its first time slice,
    ``(O, I, h, w)``; ``CHECKPOINT_INFLATE`` repeats it over the kernel's T
    and divides by T; without it each is a shape mismatch."""
    sd = {k: (v[:, :, 0].clone() if v.dim() == 5 else v)
          for k, v in source_state_dict(I3D, RESNET_OPTS).items()}
    report, model = assert_loads_like_jax(sd, I3D, RESNET_OPTS, inflate=True)
    assert not report.missing and not report.unexpected
    stem = model.state_dict()["s1.pathway0_stem.conv.weight"]
    t = stem.shape[2]
    assert t == 5 and torch.equal(stem[:, :, 2], sd["s1.pathway0_stem.conv.weight"] / float(t))
    report, _ = assert_loads_like_jax(sd, I3D, RESNET_OPTS, inflate=False)
    assert report.skipped == sum(v.dim() == 4 for v in sd.values()) > 0


def test_clear_name_pattern_strips_the_backbone_prefix():
    """An SSL-style checkpoint (``backbone.`` names, a projection MLP) loads
    with ``("backbone.",)``; the MLP is unexpected."""
    sd = {"backbone." + k: v for k, v in source_state_dict(C2D, RESNET_OPTS).items()}
    sd["projection.0.weight"] = torch.zeros(4, 4)
    report, _ = assert_loads_like_jax(sd, C2D, RESNET_OPTS, clear_name_pattern=("backbone.",))
    assert not report.missing and report.unexpected == ["projection.0.weight"]


def image_checkpoint(sd):
    """``sd`` as an image model's: the patch conv 2D (its middle time
    slice), the pool convs one frame deep."""
    out = dict(sd)
    w = sd["patch_embed.proj.weight"]
    out["patch_embed.proj.weight"] = w[:, :, w.shape[2] // 2].clone()
    for k, v in sd.items():
        if re.search(r"\.pool_[qkv]\.weight$", k):
            out[k] = v[:, :, :1].clone()
    return out


def test_image_init_splits_a_joint_pos_embed():
    """A joint ``pos_embed`` (cls row + spatial rows of a one-frame grid)
    into a separable MViTv1: ``pos_embed_class`` and ``pos_embed_spatial``
    loaded, ``pos_embed_temporal`` missing; the patch and pool convs
    repeated over T without dividing by T."""
    sd = image_checkpoint(source_state_dict(MVITV1, V1_OPTS))
    sd["pos_embed"] = torch.cat([sd.pop("pos_embed_class"), sd.pop("pos_embed_spatial")], 1)
    sd.pop("pos_embed_temporal")
    report, model = assert_loads_like_jax(sd, MVITV1, V1_OPTS, image_init=True)
    assert report.missing == ["pos_embed_temporal"] and not report.unexpected
    got = model.state_dict()
    assert torch.equal(got["pos_embed_class"], sd["pos_embed"][:, :1])
    assert torch.equal(got["patch_embed.proj.weight"][:, :, 1], sd["patch_embed.proj.weight"])
    assert torch.equal(got["blocks.1.attn.pool_q.weight"][:, :, 2],
                       sd["blocks.1.attn.pool_q.weight"][:, :, 0])


def test_image_init_merges_separated_pos_embeds():
    """Separated ``pos_embed_class`` + ``pos_embed_spatial`` into a joint
    table (a one-frame grid: 2 frames, patch stride 2)."""
    one_frame = V1_OPTS + ["DATA.NUM_FRAMES", "2"]
    sd = image_checkpoint(source_state_dict(MVITV1, one_frame))
    joint = one_frame + ["MVIT.SEP_POS_EMBED", "False"]
    report, model = assert_loads_like_jax(sd, MVITV1, joint, image_init=True)
    assert report.unexpected == ["pos_embed_temporal"] and not report.missing
    want = torch.cat([sd["pos_embed_class"], sd["pos_embed_spatial"]], 1)
    assert torch.equal(model.state_dict()["pos_embed"], want)


# --- caffe2 ------------------------------------------------------------------

_C2_LEAF = {"weight": "s", "bias": "b", "running_mean": "rm", "running_var": "riv"}


def c2_name(name):
    """A ResNet parameter's caffe2 blob name (the inverse of the rules)."""
    leaf = name.rsplit(".", 1)[1]
    rules = [
        (r"s1\.pathway0_stem\.conv\.weight", "conv1_w"),
        (r"s1\.pathway0_stem\.bn\.(\w+)", lambda m: "res_conv1_bn_" + _C2_LEAF[m[1]]),
        (r"s(\d)\.pathway0_res(\d+)\.branch2\.([abc])\.weight", r"res\1_\2_branch2\3_w"),
        (r"s(\d)\.pathway0_res(\d+)\.branch2\.([abc])_bn\.(\w+)",
         lambda m: f"res{m[1]}_{m[2]}_branch2{m[3]}_bn_{_C2_LEAF[m[4]]}"),
        (r"s(\d)\.pathway0_res(\d+)\.branch1\.weight", r"res\1_\2_branch1_w"),
        (r"s(\d)\.pathway0_res(\d+)\.branch1_bn\.(\w+)",
         lambda m: f"res{m[1]}_{m[2]}_branch1_bn_{_C2_LEAF[m[3]]}"),
        (r"head\.projection\.(weight|bias)", lambda m: "pred_" + m[1][0]),
    ]
    for pattern, repl in rules:
        if re.fullmatch(pattern, name):
            return re.sub(pattern, repl, name)
    raise KeyError(name + " " + leaf)


def write_c2(path, sd):
    """A caffe2-style pickle (protocol 2, as Python 2 wrote them) of ``sd``'s
    tensors under their blob names, with a momentum blob per conv, the BN
    blobs as (C, 1) arrays to squeeze, and a non-array entry."""
    blobs = {}
    for k, v in sd.items():
        if k.endswith("num_batches_tracked"):
            continue
        arr = v.numpy().astype(np.float32)
        name = c2_name(k)
        assert tc2.convert_c2_name(name) == k, (name, k)
        if "_bn_" in name:
            arr = arr.reshape(-1, 1)
        blobs[name] = arr
        if name.endswith("_w"):
            blobs[name + "_momentum"] = np.zeros_like(arr)
    blobs["model_iter"] = 3
    with open(path, "wb") as f:
        pickle.dump({"blobs": blobs}, f, protocol=2)
    return blobs


def test_caffe2_checkpoint_loads_like_jax(tmp_path):
    """Momentum blobs dropped, (C, 1) BN blobs squeezed, every tensor of a
    narrow C2D loaded; equal to JAX's ``load_caffe2_checkpoint``."""
    opts = tuple(RESNET_OPTS)
    path = tmp_path / "c2d.pkl"
    blobs = write_c2(path, source_state_dict(C2D, opts))
    assert any("momentum" in b for b in blobs)
    want, missing, unexpected = jc2.load_caffe2_checkpoint(str(path),
                                                           jax_variables(C2D, opts, 0))
    model = port_model(C2D, opts, 0)
    report = tc2.load_caffe2_checkpoint(str(path), model)
    assert not report.missing and not report.unexpected and not missing and not unexpected
    assert_equal_to_jax(model, want)


def test_caffe2_name_rules_match_jax():
    names = [c2_name(k) for k in source_state_dict(C2D, RESNET_OPTS)
             if not k.endswith("num_batches_tracked")]
    names += ["t_res4_1_branch2b_w", "t_pool1_subsample_bn_riv", "nonlocal_conv4_0_theta_w",
              "res4_0_branch2b_bn_b_momentum"]
    assert [tc2.convert_c2_name(n) for n in names] == [jc2.convert_c2_name(n) for n in names]


class _RunsCode:
    def __reduce__(self):
        return (os.getcwd, ())


@pytest.mark.parametrize("payload", [_RunsCode(), {"blobs": {"x": _RunsCode()}},
                                     {"blobs": {"x": np.zeros(2), "f": __import__("fractions")
                                                .Fraction(1, 3)}}],
                         ids=["reduce", "nested", "other_class"])
def test_caffe2_pickle_with_another_class_is_refused(payload, tmp_path):
    path = tmp_path / "bad.pkl"
    with open(path, "wb") as f:
        pickle.dump(payload, f, protocol=2)
    with pytest.raises(pickle.UnpicklingError):
        tc2.load_caffe2_blobs(str(path))


# --- recipes and run_net ------------------------------------------------------

@pytest.mark.parametrize("recipe", IN1K)
def test_in1k_recipes_load_a_2d_checkpoint(recipe, tmp_path):
    """Each ``*_IN1K.yaml`` recipe (``CHECKPOINT_INFLATE``), depth and width
    cut, initializes from a 2D ImageNet-style ``.pyth`` through
    ``load_train_checkpoint``: every conv inflated, the 1000-class head
    skipped; training starts at epoch 0."""
    yaml = os.path.join(CONFIGS, "Kinetics", recipe)
    opts = RESNET_OPTS + ["NONLOCAL.LOCATION", "[[[]], [[1]], [[1]], [[]]]"] * ("NLN" in recipe)
    cfg = cfg_of(get_cfg, yaml, opts)
    assert cfg.TRAIN.CHECKPOINT_INFLATE
    src = build_model(cfg, device="cpu").state_dict()
    sd = {k: (v[:, :, 0] if v.dim() == 5 else v) for k, v in src.items()}
    sd["head.projection.weight"] = torch.zeros(1000, sd["head.projection.weight"].shape[1])
    sd["head.projection.bias"] = torch.zeros(1000)
    path = tmp_path / "in1k.pyth"
    torch.save({"model_state": sd}, path)
    cfg.TRAIN.CHECKPOINT_FILE_PATH = str(path)
    cfg.OUTPUT_DIR = str(tmp_path)
    model = build_model(cfg, device="cpu")
    from slowfast_tpu_torch.solver.optimizer import construct_optimizer

    assert cu.load_train_checkpoint(cfg, model, construct_optimizer(model, cfg)) == 0
    report = cu.load_weights(cfg, model, str(path))
    assert report.skipped == 2 and report.missing == ["head.projection.weight",
                                                      "head.projection.bias"]
    conv = [k for k, v in src.items() if v.dim() == 5]
    got = model.state_dict()
    for k in conv:
        t = got[k].shape[2]
        assert torch.equal(got[k], (sd[k][:, :, None].repeat(1, 1, t, 1, 1) / float(t))), k


def test_rev_mvit_recipe_builds_and_loads_its_own_checkpoint(tmp_path):
    """``REV_MVIT_B_16x4_CONV.yaml`` narrowed: its ``.pyth`` reloads through
    the partial load with everything loaded."""
    yaml = os.path.join(CONFIGS, "Kinetics", "REV_MVIT_B_16x4_CONV.yaml")
    opts = ["MVIT.DEPTH", "4", "MVIT.EMBED_DIM", "16", "MVIT.DIM_MUL", "[[1,2.0],[3,2.0]]",
            "MVIT.HEAD_MUL", "[[1,2.0],[3,2.0]]", "MVIT.POOL_Q_STRIDE", "[[1,1,2,2],[3,1,2,2]]",
            "MVIT.REV.BUFFER_LAYERS", "[1,3]", "DATA.NUM_FRAMES", "4",
            "DATA.TRAIN_CROP_SIZE", "32", "MODEL.NUM_CLASSES", "8"]
    sd = source_state_dict(yaml, opts)
    report, _ = assert_loads_like_jax(sd, yaml, opts)
    assert len(report.loaded) == len(sd) and not report.missing


FT_RUN = ["TRAIN.DATASET", "syntheticvideo", "DATA.SYNTHETIC_SIZE", "4", "TRAIN.BATCH_SIZE", "2",
          "LOG_PERIOD", "1", "DATA_LOADER.NUM_WORKERS", "2", "SOLVER.WARMUP_EPOCHS", "0.5",
          "TEST.ENABLE", "False", "SOLVER.MAX_EPOCH", "1"]


def test_run_net_fine_tunes_from_a_port_pretraining_checkpoint(tmp_path, monkeypatch):
    """A narrow MaskFeat pretraining run writes its checkpoint; the MViTv2
    fine-tune recipe (``CHECKPOINT_EPOCH_RESET``) starts from it through
    ``run_net``: at epoch 0, every trunk tensor equal to the checkpoint's
    before the first step, the final norm and the head (which the
    checkpoint does not have) as a fresh build's."""
    from slowfast_tpu_torch.engine import trainer

    pt_dir, ft_dir = tmp_path / "pt", tmp_path / "ft"
    run_net_main(["--device", "cpu", "--cfg", MASKFEAT_PT, "--opts", *MASKFEAT_OPTS, *COMMON,
                  *FT_RUN, "OUTPUT_DIR", str(pt_dir)])
    ckpt = pt_dir / "checkpoints" / "ssl_checkpoint_epoch_00001.pyth"
    pt_state = torch.load(ckpt, map_location="cpu", weights_only=True)["model_state"]
    seen, make_step = [], trainer.make_train_step

    def recording(cfg, model, optimizer, generator):
        seen.append((cfg, {k: v.clone() for k, v in model.state_dict().items()}))
        return make_step(cfg, model, optimizer, generator)

    monkeypatch.setattr(trainer, "make_train_step", recording)
    run_net_main(["--device", "cpu", "--cfg", MVITV2_FT, "--opts", *V2_112, *COMMON, *FT_RUN,
                  "MIXUP.ENABLE", "False", "TRAIN.CHECKPOINT_FILE_PATH", str(ckpt),
                  "OUTPUT_DIR", str(ft_dir)])
    cfg, before = seen[0]
    assert cfg.TRAIN.CHECKPOINT_EPOCH_RESET
    fresh = build_model(cfg, device="cpu").state_dict()
    fresh_names = {"head.projection.weight", "head.projection.bias", "norm.weight", "norm.bias"}
    assert set(before) - set(pt_state) == fresh_names
    for k, v in before.items():
        assert torch.equal(v, fresh[k] if k in fresh_names else pt_state[k]), k
    stats = [json.loads(line.split("json_stats: ")[1])
             for line in (ft_dir / "json_stats.log").read_text().splitlines()]
    assert [s["epoch"] for s in stats if s["_type"] == "train_epoch"] == ["1/1"]
    assert (ft_dir / "checkpoints" / "ssl_eval_checkpoint_epoch_00001.pyth").exists()


def chip_smoke_counts():
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.FINETUNE_COUNTS


def test_full_depth_fine_tune_counts_pinned_for_the_card():
    """The MaskFeat pretraining recipe into the MViTv2-S fine-tune recipe at
    their full depth and shapes of grid (16 blocks, 16 frames, 224²; the
    widths cut, which no count depends on): JAX's counts are the ones
    ``chip_smoke.py``'s ``finetune_slice`` holds the full-width load to
    (loaded = the fine-tune's tensors less the missing)."""
    narrow = ["MVIT.EMBED_DIM", "8", "MODEL.NUM_CLASSES", "16"]
    sd = source_state_dict(MASKFEAT_PT, narrow)
    report, model = assert_loads_like_jax(sd, MVITV2_FT, narrow)
    counts = {"loaded": len(report.loaded), "skipped": report.skipped,
              "missing": len(report.missing), "unexpected": len(report.unexpected)}
    pinned = chip_smoke_counts()
    assert counts["loaded"] == len(model.state_dict()) - pinned["missing"]
    assert {k: counts[k] for k in ("skipped", "missing", "unexpected")} == pinned
