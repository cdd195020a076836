"""MViTv2 in the port against the JAX package: each block in eval mode,
then the narrow model end to end.

Every parameter is overwritten with seeded random values before the
comparison: dense and conv kernels N(0, 1/fan_in), LayerNorm scales and
layer-scale gammas U(0.5, 1.5), biases N(0, 0.1), rel-pos tables N(0, 0.3),
the cls token N(0, 1). Inputs are seeded numpy arrays.

Blocks: fp32, atol 1e-5 / rtol 1e-4 (sums taken in another order). The
narrow model is ``MVITv2_S_16x4.yaml`` at depth 4, embed dim 16, 4 frames,
56² crops and 16 classes, with the recipe's q strides at blocks 1 and 3:
token grids 14 -> 7 -> 4, the cls token, rel-pos on every axis and residual
pooling. It runs from uint8 clips through both packages' eval steps: fp32
within atol 1e-5; bf16 within 2e-2, because the frameworks round to bf16 at
other places and the port's constant-shift core sums the bf16-rounded
``e`` (as the Pallas kernel it replaces does) where the JAX XLA core sums
it in fp32.
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
from slowfast_tpu.models import attention as jattn
from slowfast_tpu.models import build_model as jax_build_model
from slowfast_tpu.models import common as jcommon
from slowfast_tpu.models import heads as jheads
from slowfast_tpu.models import stem as jstem
from slowfast_tpu.models.build import init_model
from slowfast_tpu.utils.meters import TestMeter as JaxTestMeter
from slowfast_tpu_torch.config import assert_and_infer_cfg, get_cfg
from slowfast_tpu_torch.engine.steps import make_eval_step
from slowfast_tpu_torch.engine.tester import test as port_test
from slowfast_tpu_torch.models import attention as tattn
from slowfast_tpu_torch.models import common as tcommon
from slowfast_tpu_torch.models import heads as theads
from slowfast_tpu_torch.models import stem as tstem
from slowfast_tpu_torch.models.build import build_model
from slowfast_tpu_torch.models.mvit import mvit_block_schedule
from slowfast_tpu_torch.ops import attention as attention_ops
from slowfast_tpu_torch.run_net import main as run_net_main
from slowfast_tpu_torch.utils.checkpoint import state_dict_from_jax

ATOL, RTOL = 1e-5, 1e-4
FP32_ATOL, BF16_ATOL = 1e-5, 2e-2
YAML = os.path.join(os.path.dirname(__file__), "..", "configs", "Kinetics",
                    "MVITv2_S_16x4.yaml")
NARROW = [
    "MVIT.DEPTH", "4", "MVIT.EMBED_DIM", "16", "MVIT.NUM_HEADS", "1",
    "MVIT.DIM_MUL", "[[1,2.0],[3,2.0]]", "MVIT.HEAD_MUL", "[[1,2.0],[3,2.0]]",
    "MVIT.POOL_Q_STRIDE", "[[0,1,1,1],[1,1,2,2],[2,1,1,1],[3,1,2,2]]",
    "DATA.NUM_FRAMES", "4", "DATA.TRAIN_CROP_SIZE", "56", "DATA.TEST_CROP_SIZE", "56",
    "MODEL.NUM_CLASSES", "16", "NUM_GPUS", "1", "TRAIN.ENABLE", "False",
    "DATA_LOADER.NUM_WORKERS", "2", "TEST.BATCH_SIZE", "2",
]


def randomize(shapes, seed):
    rng = np.random.RandomState(seed)
    out = {}
    for path, s in traverse_util.flatten_dict(shapes).items():
        leaf = path[-1]
        if leaf == "kernel":
            v = rng.normal(0.0, np.sqrt(1.0 / np.prod(s.shape[:-1])), s.shape)
        elif leaf in ("scale", "gamma_1", "gamma_2"):
            v = rng.uniform(0.5, 1.5, s.shape)
        elif leaf.startswith("rel_pos"):
            v = rng.normal(0.0, 0.3, s.shape)
        elif leaf == "cls_token":
            v = rng.normal(0.0, 1.0, s.shape)
        else:
            v = rng.normal(0.0, 0.1, s.shape)
        out[path] = v.astype(np.float32)
    return traverse_util.unflatten_dict(out)


def jax_variables(module, args, seed, **kwargs):
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), *args, **kwargs))
    return randomize(dict(shapes), seed)


def port_apply(module, variables, *args):
    module.load_state_dict(state_dict_from_jax(variables), strict=True)
    module.eval()
    with torch.no_grad():
        return module(*args)


def assert_close(got, want, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=atol, rtol=rtol)


def _x(shape, seed):
    return np.random.RandomState(seed).normal(0.0, 1.0, shape).astype(np.float32)


def test_patch_embed():
    x = _x((2, 4, 24, 20, 3), 0)
    kw = dict(kernel=(3, 7, 7), stride=(2, 4, 4), padding=(1, 3, 3))
    jm = jstem.PatchEmbed(dim_out=16, **kw)
    v = jax_variables(jm, (jnp.asarray(x),), 1)
    want, want_thw = jm.apply(v, jnp.asarray(x))
    got, got_thw = port_apply(tstem.PatchEmbed(3, 16, **kw), v, torch.from_numpy(x))
    assert got_thw == list(want_thw) == [2, 6, 5]
    assert_close(got, want)


def test_mlp():
    x = _x((2, 7, 12), 2)
    jm = jcommon.Mlp(hidden_features=40, out_features=20, bias_init=jattn.bias02)
    v = jax_variables(jm, (jnp.asarray(x),), 3)
    want = jm.apply(v, jnp.asarray(x))
    assert_close(port_apply(tcommon.Mlp(12, 40, 20), v, torch.from_numpy(x)), want)


@pytest.mark.parametrize("act", ["softmax", "sigmoid", "none"])
def test_transformer_head(act):
    x = _x((3, 24), 4)
    jm = jheads.TransformerBasicHead(dim_in=24, num_classes=10, dropout_rate=0.5,
                                     act_func=act)
    v = jax_variables(jm, (jnp.asarray(x),), 5)
    want = jm.apply(v, jnp.asarray(x), train=False)
    tm = theads.TransformerBasicHead(24, 10, dropout_rate=0.5, act_func=act)
    assert_close(port_apply(tm, v, torch.from_numpy(x)), want)


@pytest.mark.parametrize("mode,heads,kernel,stride,has_cls", [
    ("conv", 3, (3, 3, 3), (1, 2, 2), True),
    ("conv", 2, (3, 3, 3), (1, 4, 4), False),
    ("max", 1, (1, 3, 3), (1, 2, 2), True),
    # flax's avg_pool counts the padding: the border windows of T = 3.
    ("avg", 1, (3, 3, 3), (1, 2, 2), True),
    ("conv_unshared", 1, (3, 3, 3), (1, 2, 2), False),
])
def test_pool_tokens_flat(mode, heads, kernel, stride, has_cls):
    d, thw = 4, (3, 7, 5)
    x = _x((2, int(np.prod(thw)) + int(has_cls), heads * d), 6)
    w = _x(kernel + (1, d), 7) if mode.startswith("conv") else None
    want, want_thw = jattn.pool_tokens_flat(
        jnp.asarray(x), thw, kernel, stride, mode, has_cls,
        pool_w=None if w is None else jnp.asarray(w), heads=heads)
    got, got_thw = tattn.pool_tokens_flat(
        torch.from_numpy(x), thw, kernel, stride, mode, has_cls,
        pool_w=None if w is None else torch.from_numpy(w.transpose(4, 3, 0, 1, 2)),
        heads=heads)
    assert got_thw == list(want_thw)
    assert_close(got, want)


@pytest.mark.parametrize("q_shape,k_shape,has_cls", [
    ((2, 7, 7), (2, 4, 4), True),
    ((4, 3, 5), (2, 3, 2), False),
])
def test_augment_qk_relpos(q_shape, k_shape, has_cls):
    """The decomposed rel-pos bias folded into q/k, with the tables at the
    sizes the recipe gives them (2·max(q, k) - 1 rows)."""
    B, nh, C, sp = 2, 2, 6, int(has_cls)
    q = _x((B, int(np.prod(q_shape)) + sp, nh, C), 8)
    k = _x((B, int(np.prod(k_shape)) + sp, nh, C), 9)
    tables = [_x((2 * max(q_shape[a], k_shape[a]) - 1, C), 10 + a) for a in (1, 2, 0)]
    want = jattn._augment_qk_relpos(jnp.asarray(q), jnp.asarray(k), 0.4, has_cls, q_shape,
                                    k_shape, *(jnp.asarray(t) for t in tables))
    got = tattn._augment_qk_relpos(torch.from_numpy(q), torch.from_numpy(k), 0.4, has_cls,
                                   q_shape, k_shape, *(torch.from_numpy(t) for t in tables))
    for g, w in zip(got, want):
        assert_close(g, w)


@pytest.mark.parametrize("rows", [5, 13, 27])
def test_rel_pos_table_grows_as_jax_resizes(rows):
    """Odd grids grow a table (5 -> 7 rows in the narrow model's last
    stage); a smaller test input shrinks one, where jax.image.resize
    antialiases, and the port does as JAX does."""
    table = _x((rows, 6), 15)
    for d in (2 * rows - 1, rows - 2):
        want = jattn._resize_rel_pos(jnp.asarray(table), d)
        assert_close(tattn._resize_rel_pos(torch.from_numpy(table), d), want)


ATTN_KW = dict(dim=16, dim_out=32, input_size=(2, 8, 8), num_heads=2, qkv_bias=True,
               kernel_q=(3, 3, 3), kernel_kv=(3, 3, 3), stride_q=(1, 2, 2),
               stride_kv=(1, 4, 4), has_cls_embed=True, mode="conv",
               rel_pos_spatial=True, rel_pos_temporal=True, residual_pooling=True)


@pytest.mark.parametrize("core", ["flash", "exact"])
def test_multiscale_attention(core):
    """Both cores inside the attention: the exact one against the Pallas
    kernel (interpret mode), the constant-shift one against the XLA core."""
    x = _x((2, 1 + 2 * 8 * 8, 16), 11)
    jm = jattn.MultiScaleAttention(**ATTN_KW, use_pallas_attention=core == "exact")
    v = jax_variables(jm, (jnp.asarray(x), (2, 8, 8)), 12)
    want, want_thw = jm.apply(v, jnp.asarray(x), (2, 8, 8))
    launches = attention_ops.flash_launches, attention_ops.exact_launches
    tm = tattn.MultiScaleAttention(**ATTN_KW, exact_softmax=core == "exact")
    got, got_thw = port_apply(tm, v, torch.from_numpy(x), [2, 8, 8])
    assert got_thw == list(want_thw) == [2, 4, 4]
    assert_close(got, want)
    assert (attention_ops.flash_launches, attention_ops.exact_launches) == launches


BLOCK_CASES = {
    # MViTv2-S's stage transition: dim and heads double inside the attention
    # (DIM_MUL_IN_ATT), q stride 2, the residual max-pooled.
    "transition": dict(dim=16, dim_out=32, num_heads=2, kernel_q=(3, 3, 3),
                       stride_q=(1, 2, 2), kernel_kv=(3, 3, 3), stride_kv=(1, 2, 2),
                       dim_mul_in_att=True, layer_scale_init_value=0.0),
    # The MLP changes the dim (proj on norm2's output), with layer scale.
    "mlp_dim_change": dict(dim=16, dim_out=24, num_heads=2, kernel_q=(3, 3, 3),
                           stride_q=(1, 1, 1), kernel_kv=(3, 3, 3), stride_kv=(1, 4, 4),
                           dim_mul_in_att=False, layer_scale_init_value=0.1),
}


@pytest.mark.parametrize("case", BLOCK_CASES)
def test_multiscale_block(case):
    kw = dict(BLOCK_CASES[case], input_size=(2, 7, 7), mlp_ratio=2.0, qkv_bias=True,
              mode="conv", has_cls_embed=True, rel_pos_spatial=True,
              rel_pos_temporal=True, residual_pooling=True)
    x = _x((2, 1 + 2 * 7 * 7, 16), 13)
    jm = jattn.MultiScaleBlock(**kw)
    v = jax_variables(jm, (jnp.asarray(x), (2, 7, 7)), 14)
    want, want_thw = jm.apply(v, jnp.asarray(x), (2, 7, 7))
    got, got_thw = port_apply(tattn.MultiScaleBlock(**kw), v, torch.from_numpy(x), [2, 7, 7])
    assert got_thw == list(want_thw)
    assert_close(got, want)


def narrow_cfg(get, dtype="float32", extra=()):
    cfg = get()
    cfg.merge_from_file(YAML)
    cfg.merge_from_list(NARROW + ["TPU.COMPUTE_DTYPE", dtype] + list(extra))
    return cfg


def test_block_schedule_matches_jax():
    from slowfast_tpu.models.mvit import mvit_block_schedule as jax_schedule

    for extra in ([], ["MVIT.DEPTH", "16", "MVIT.EMBED_DIM", "96",
                       "MVIT.DIM_MUL", "[[1,2.0],[3,2.0],[14,2.0]]",
                       "MVIT.HEAD_MUL", "[[1,2.0],[3,2.0],[14,2.0]]",
                       "MVIT.POOL_Q_STRIDE", "[[1,1,2,2],[3,1,2,2],[14,1,2,2]]"]):
        assert (mvit_block_schedule(narrow_cfg(get_cfg, extra=extra))
                == jax_schedule(narrow_cfg(jax_get_cfg, extra=extra)))


class JaxSide:
    """The narrow JAX MViT, its random variables and jitted eval steps."""

    def __init__(self):
        cfg = narrow_cfg(jax_get_cfg)
        model = jax_build_model(cfg)
        shapes = jax.eval_shape(
            lambda: init_model(model, cfg, rng=jax.random.PRNGKey(0), train=False))
        self.variables = randomize(dict(shapes), 0)
        self.state = TrainState(step=0, params=self.variables["params"],
                                batch_stats=self.variables.get("batch_stats", {}),
                                opt_state=None)
        self._steps = {}

    def eval(self, clips, dtype="float32"):
        if dtype not in self._steps:
            cfg = narrow_cfg(jax_get_cfg, dtype)
            self._steps[dtype] = jax_make_eval_step(cfg, jax_build_model(cfg))
        out = self._steps[dtype](self.state, {"inputs": [jnp.asarray(clips)]})
        return np.asarray(out.astype(jnp.float32))


@pytest.fixture(scope="module")
def jax_side():
    return JaxSide()


def port_model(jax_side, dtype, extra=()):
    model = build_model(narrow_cfg(get_cfg, dtype, extra), device="cpu")
    model.load_state_dict(state_dict_from_jax(jax_side.variables), strict=True)
    return model


def _clips(seed, n=2):
    return np.random.RandomState(seed).randint(0, 255, (n, 4, 56, 56, 3)).astype(np.uint8)


@pytest.mark.parametrize("dtype,atol,core", [
    ("float32", FP32_ATOL, "flash"),
    ("float32", FP32_ATOL, "exact"),
    ("bfloat16", BF16_ATOL, "flash"),
])
def test_eval_step_matches_jax(jax_side, dtype, atol, core):
    """uint8 clips through the port's eval step (the preprocess, then the
    model with either attention core) against the JAX eval step (the XLA
    core)."""
    clips = _clips(1)
    want = jax_side.eval(clips, dtype)
    extra = ["TPU.PALLAS_ATTENTION", "True"] if core == "exact" else []
    cfg = narrow_cfg(get_cfg, dtype, extra)
    model = port_model(jax_side, dtype, extra)
    assert all(b.attn.exact_softmax == (core == "exact") for b in model.blocks)
    got = make_eval_step(cfg, model)({"inputs": [torch.from_numpy(clips)]})
    assert got.dtype == getattr(torch, dtype)
    got = got.float().numpy()
    assert got.shape == (2, 16)
    assert want.max() < 0.9  # not a saturated softmax
    np.testing.assert_allclose(got, want, atol=atol, rtol=0)


def test_tester_matches_jax_test_meter(jax_side, tmp_path):
    """test(cfg, device="cpu") on Syntheticvideo, 2 videos x 5 views x 1 crop,
    weights loaded through TEST.CHECKPOINT_FILE_PATH, against a JAX TestMeter
    fed by the JAX eval step on the same batches."""
    ckpt = tmp_path / "bridged.pyth"
    torch.save({"model_state": state_dict_from_jax(jax_side.variables)}, ckpt)
    extra = ["TEST.DATASET", "syntheticvideo", "DATA.SYNTHETIC_SIZE", "2",
             "TEST.CHECKPOINT_FILE_PATH", str(ckpt), "OUTPUT_DIR", str(tmp_path),
             "TEST.SAVE_RESULTS_PATH", str(tmp_path / "results.pkl")]
    cfg = assert_and_infer_cfg(narrow_cfg(get_cfg, extra=extra))
    assert (cfg.TEST.NUM_ENSEMBLE_VIEWS, cfg.TEST.NUM_SPATIAL_CROPS) == (5, 1)
    (stats,) = port_test(cfg, device="cpu")
    with open(tmp_path / "results.pkl", "rb") as f:
        video_preds, video_labels = pickle.load(f)

    dataset = JaxSyntheticvideo(narrow_cfg(jax_get_cfg, extra=extra), "test")
    meter = JaxTestMeter(dataset.num_videos // 5, 5, 16, len(dataset) // 2)
    for start in range(0, len(dataset), 2):
        samples = [dataset[i] for i in range(start, start + 2)]
        clips = np.stack([s[0][0] for s in samples])
        meter.update_stats(jax_side.eval(clips), [s[1] for s in samples],
                           [s[2] for s in samples])
    want = meter.finalize_metrics()

    np.testing.assert_array_equal(video_labels, meter.video_labels)
    np.testing.assert_allclose(video_preds, meter.video_preds, atol=5 * FP32_ATOL)
    assert stats["_type"] == "test_final"
    assert (stats["top1_acc"], stats["top5_acc"]) == (want["top1_acc"], want["top5_acc"])
    logged = (tmp_path / "json_stats.log").read_text().splitlines()
    assert json.loads(logged[-1].split("json_stats: ")[1]) == stats


@pytest.mark.parametrize("opt", [
    # Rev-MViT, contrastive SSL and the 2D patch stem are ported
    # (tests/test_torch_reversible.py, tests/test_torch_contrastive.py,
    # tests/test_torch_imagenet.py), and so is the pytorchvideo name
    # PTVMViT, which builds MViT's model; the head activation and the norm
    # that the reference refuses are not.
    ["MODEL.MODEL_NAME", "PTVMViT"], ["MODEL.HEAD_ACT", "tanh"],
    ["MVIT.NORM", "batchnorm"],
])
def test_unported_options_raise(opt):
    if opt[1] == "PTVMViT":
        got = build_model(narrow_cfg(get_cfg, extra=opt), device="cpu").state_dict()
        want = build_model(narrow_cfg(get_cfg), device="cpu").state_dict()
        assert list(got) == list(want)
        assert all(torch.equal(got[k], want[k]) for k in want)
        return
    with pytest.raises(NotImplementedError):
        build_model(narrow_cfg(get_cfg, extra=opt), device="cpu")


def test_run_net_cli_runs_the_mvit_test(tmp_path):
    run_net_main(["--device", "cpu", "--cfg", YAML, "--opts", *NARROW,
                  "TPU.COMPUTE_DTYPE", "float32", "TEST.DATASET", "syntheticvideo",
                  "DATA.SYNTHETIC_SIZE", "1", "OUTPUT_DIR", str(tmp_path)])
    last = (tmp_path / "json_stats.log").read_text().splitlines()[-1]
    stats = json.loads(last.split("json_stats: ")[1])
    assert stats["_type"] == "test_final" and "top1_acc" in stats


def test_init_follows_jax_distributions():
    """trunc_normal(0.02) weights, rel-pos tables and cls token (cut at ±2
    std); Linear and LayerNorm biases 0.02, LayerNorm scales 1; zero patch
    stem and head biases; the head at 0.02 * HEAD_INIT_SCALE."""
    model = build_model(narrow_cfg(get_cfg, extra=["MVIT.HEAD_INIT_SCALE", "0.5"]),
                        device="cpu")
    sd = model.state_dict()
    assert torch.all(sd["blocks.0.norm1.weight"] == 1.0)
    for name in ("blocks.0.norm1.bias", "blocks.1.attn.norm_q.bias", "blocks.1.attn.qkv.bias",
                 "blocks.1.attn.proj.bias", "blocks.1.mlp.fc2.bias", "blocks.1.proj.bias",
                 "norm.bias"):
        assert torch.all(sd[name] == 0.02), name
    assert torch.all(sd["patch_embed.proj.bias"] == 0.0)
    assert torch.all(sd["head.projection.bias"] == 0.0)
    big = torch.cat([sd[n].flatten() for n in ("blocks.3.mlp.fc1.weight",
                                               "blocks.3.attn.qkv.weight")])
    # A normal cut at ±2 std keeps 0.88 of its std.
    assert abs(big.std().item() - 0.02 * 0.8796) < 1e-3 and big.abs().max() <= 0.04
    for name in ("cls_token", "blocks.0.attn.rel_pos_h", "blocks.1.attn.pool_k.weight",
                 "patch_embed.proj.weight"):
        assert 0.0 < sd[name].abs().max() <= 0.04, name
    assert 0.0 < sd["head.projection.weight"].abs().max() <= 0.02
