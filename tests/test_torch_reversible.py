"""Rev-MViT in the port against the JAX package, on the CPU.

The narrow Rev-MViT of tests/test_reversible_backprop.py (embed 16, one
head, 4 frames at 32², a q stride and a transition at block 1, the adaptive
KV strides, residual pooling, mean pooling), its parameters overwritten
with seeded random values, inputs seeded numpy arrays:

* ``TwoStreamFusion`` in every mode against JAX's module;
* the eval forward at fp32 (atol 1e-5, rtol 1e-4) and bf16 (2e-2) over the
  fusion modes of ``RESPATH_FUSE``, both ``RES_PATH`` values,
  ``PRE_Q_FUSION`` ``avg`` and ``concat`` and both ``USE_MEAN_POOLING``
  orders;
* one train step's loss (rtol 1e-5) and gradients (atol 1e-5, rtol 1e-4)
  against ``jax.grad`` through JAX's custom VJP, fp32, with the reversible
  backward and with its checkpointed fallback;
* the reversible backward against the fallback with drop path and dropout
  on (the JAX package's own limits, rtol 2e-4, atol 2e-5), the generator
  left where a forward alone leaves it, and the flash core's calls per step;
* the bytes saved for the backward flat in span depth (JAX's
  ``test_activation_memory_flat_in_depth``, its bounds);
* the weight bridge both ways, the recipe on the meta device, the
  optimizer's partition.
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
from slowfast_tpu.models import common as jcommon
from slowfast_tpu.models.build import init_model
from slowfast_tpu.solver import losses as jlosses
from slowfast_tpu.solver import optimizer as joptim
from slowfast_tpu.utils.checkpoint import load_torch_checkpoint_dict
from slowfast_tpu_torch.config import get_cfg
from slowfast_tpu_torch.models import common as tcommon
from slowfast_tpu_torch.models import mvit as tmvit
from slowfast_tpu_torch.models.build import build_model, init_mvit_weights
from slowfast_tpu_torch.models.reversible import ReversibleBlock, StageTransitionBlock
from slowfast_tpu_torch.ops import attention as tattention
from slowfast_tpu_torch.solver import losses as tlosses
from slowfast_tpu_torch.solver import optimizer as toptim
from slowfast_tpu_torch.utils.checkpoint import state_dict_from_jax
from test_torch_mvit import randomize
from test_torch_mvit_family import jit_run
from test_torch_train import one_torch_thread  # noqa: F401  (fixture)

ATOL, RTOL = 1e-5, 1e-4
BF16_ATOL = 2e-2
CONFIGS = os.path.join(os.path.dirname(__file__), "..", "configs")


def rev_opts(depth=4, droppath=0.0, rev_backprop=True):
    """tests/test_reversible_backprop.py:31-60's narrow Rev-MViT."""
    return [
        "MODEL.MODEL_NAME", "MViT", "MODEL.ARCH", "mvit", "MODEL.NUM_CLASSES", "8",
        "MVIT.EMBED_DIM", "16", "MVIT.NUM_HEADS", "1", "MVIT.DEPTH", str(depth),
        "MVIT.PATCH_KERNEL", "[3,7,7]", "MVIT.PATCH_STRIDE", "[2,4,4]",
        "MVIT.PATCH_PADDING", "[1,3,3]", "MVIT.DIM_MUL", "[[1,2.0]]",
        "MVIT.HEAD_MUL", "[[1,2.0]]", "MVIT.POOL_Q_STRIDE", "[[1,1,2,2]]",
        "MVIT.POOL_KVQ_KERNEL", "[3,3,3]", "MVIT.POOL_KV_STRIDE_ADAPTIVE", "[1,4,4]",
        "MVIT.MODE", "conv", "MVIT.CLS_EMBED_ON", "False", "MVIT.SEP_POS_EMBED", "False",
        "MVIT.USE_ABS_POS", "False", "MVIT.RESIDUAL_POOLING", "True",
        "MVIT.DIM_MUL_IN_ATT", "True", "MVIT.USE_MEAN_POOLING", "True",
        "MVIT.DROPPATH_RATE", str(droppath), "MVIT.ZERO_DECAY_POS_CLS", "False",
        "MVIT.REV.ENABLE", "True", "MVIT.REV.BUFFER_LAYERS", "[1]",
        "MVIT.REV.RESPATH_FUSE", "concat", "MVIT.REV.PRE_Q_FUSION", "avg",
        "MVIT.REV.RES_PATH", "conv", "DATA.NUM_FRAMES", "4", "DATA.TRAIN_CROP_SIZE", "32",
        "DATA.TEST_CROP_SIZE", "32", "DATA.INPUT_CHANNEL_NUM", "[3]",
        "MODEL.DROPOUT_RATE", "0.0", "TPU.REV_BACKPROP", str(rev_backprop), "NUM_GPUS", "1",
        "MIXUP.ENABLE", "False"]


def make_cfg(get, extra=(), dtype="float32", **kw):
    cfg = get()
    cfg.merge_from_list(rev_opts(**kw) + ["TPU.COMPUTE_DTYPE", dtype] + list(extra))
    return cfg


@functools.lru_cache(maxsize=None)
def jax_variables(extra=(), depth=4, seed=0):
    """Seeded random values in the shapes JAX's ``init_model`` gives (its
    init runs the per-block remat path, reversible.py:427)."""
    cfg = make_cfg(jax_get_cfg, extra, depth=depth)
    shapes = jax.eval_shape(lambda: init_model(jax_build_model(cfg), cfg,
                                               rng=jax.random.PRNGKey(0), train=True))
    return randomize(dict(shapes), seed)


def port_model(variables, extra=(), dtype="float32", **kw):
    model = build_model(make_cfg(get_cfg, extra, dtype, **kw), device="cpu")
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    return model


def clips(n=2, seed=1):
    return np.random.RandomState(seed).normal(0.0, 1.0, (n, 4, 32, 32, 3)).astype(np.float32)


def port_name(path):
    """Flax param path -> the port's parameter name."""
    mods = [p.replace("blocks_", "blocks.").replace("layers_", "layers.") for p in path[:-1]]
    leaf = {"kernel": "weight", "scale": "weight"}.get(path[-1], path[-1])
    return ".".join(mods + [leaf])


# --- TwoStreamFusion -----------------------------------------------------------

@pytest.mark.parametrize("mode", tcommon.FUSION_MODES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_two_stream_fusion_matches_jax(mode, dtype):
    """Each mode on a (2, 5, 2·6) input, the parameters (``fuse_fn``,
    ``fuse_fn1``/``fuse_fn2``, ``fuse_norm``, ``fuse_mlp``) JAX's: the
    value and the dtype (the projections and their sums promote to fp32)."""
    dim = 12
    jdtype = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    x = np.random.RandomState(4).normal(0.0, 1.0, (2, 5, dim)).astype(np.float32)
    module = jcommon.TwoStreamFusion(mode=mode, dim=dim)
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), jnp.zeros((2, 5, dim))))
    variables = randomize(dict(shapes), 5) if shapes else {}
    want = module.apply(variables, jnp.asarray(x).astype(jdtype))
    fuse = tcommon.TwoStreamFusion(mode, dim)
    sd = state_dict_from_jax(variables) if variables else {}
    fuse.load_state_dict(sd, strict=True)
    with torch.no_grad():
        got = fuse(torch.from_numpy(x).to(getattr(torch, dtype)))
    assert got.shape[-1] == fuse.out_width(dim) == want.shape[-1]
    assert str(got.dtype).split(".")[-1] == str(want.dtype)
    tol = (ATOL, RTOL) if dtype == "float32" or want.dtype == jnp.float32 else (BF16_ATOL, 0)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=tol[0], rtol=tol[1])


def test_two_stream_fusion_refuses_an_unknown_mode():
    with pytest.raises(NotImplementedError):
        tcommon.TwoStreamFusion("concat_linear_3", 8)


# --- forward -------------------------------------------------------------------

FORWARD_CASES = {
    **{f"respath_fuse_{m}": ["MVIT.REV.RESPATH_FUSE", m] for m in tcommon.FUSION_MODES},
    "res_path_max": ["MVIT.REV.RES_PATH", "max"],
    "pre_q_concat": ["MVIT.REV.PRE_Q_FUSION", "concat"],
    "pre_q_concat_res_max": ["MVIT.REV.PRE_Q_FUSION", "concat", "MVIT.REV.RES_PATH", "max"],
    "no_mean_pooling": ["MVIT.USE_MEAN_POOLING", "False"],
    "no_mean_pooling_add": ["MVIT.USE_MEAN_POOLING", "False", "MVIT.REV.RESPATH_FUSE", "add"],
    "pool_first": ["MVIT.POOL_FIRST", "True", "MVIT.DIM_MUL_IN_ATT", "False"],
}


def jax_eval(extra, dtype, x):
    cfg = make_cfg(jax_get_cfg, extra, dtype)
    model = jax_build_model(cfg)
    return np.asarray(jit_run(lambda v, x: model.apply(v, [x], train=False),
                              jax_variables(tuple(extra)), jnp.asarray(x)), np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(FORWARD_CASES))
def test_forward_matches_jax(case, dtype):
    extra = FORWARD_CASES[case]
    x = clips()
    want = jax_eval(extra, dtype, x)
    model = port_model(jax_variables(tuple(extra)), extra, dtype)
    model.eval()
    with torch.no_grad():
        got = model([torch.from_numpy(x)]).float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    else:
        np.testing.assert_allclose(got, want, atol=BF16_ATOL)


# --- gradients -----------------------------------------------------------------

def train_batch(n=2):
    return clips(n), np.random.RandomState(3).randint(0, 8, (n,)).astype(np.int64)


@functools.lru_cache(maxsize=None)
def jax_grads(depth=6):
    """JAX's loss and gradients of one train step (drop path 0) through its
    custom VJP, in the port's names."""
    cfg = make_cfg(jax_get_cfg, depth=depth)
    assert cfg.TPU.REV_BACKPROP
    model = jax_build_model(cfg)
    x, y = train_batch()

    def loss_fn(params):
        preds = model.apply({"params": params}, [jnp.asarray(x)], train=True,
                            rngs={"dropout": jax.random.PRNGKey(0)})
        return jlosses.soft_cross_entropy(preds, jnp.asarray(y))

    loss, grads = jit_run(jax.value_and_grad(loss_fn), jax_variables(depth=depth)["params"])
    return float(loss), state_dict_from_jax({"params": jax.tree.map(np.asarray, grads)})


def port_step(model, x, y):
    for p in model.parameters():
        p.grad = None
    loss = tlosses.soft_cross_entropy(model([torch.from_numpy(x)]), torch.from_numpy(y))
    loss.backward()
    return loss.item(), {n: p.grad for n, p in model.named_parameters()}


@pytest.mark.parametrize("rev_backprop", [True, False])
def test_train_gradients_match_jax_grad(rev_backprop):
    """fp32: the loss within 1e-5, every gradient within 1e-5 + 1e-4
    relative of JAX's custom-VJP gradients; no parameter without one."""
    want_loss, want = jax_grads()
    model = port_model(jax_variables(depth=6), depth=6, rev_backprop=rev_backprop)
    model.train()
    loss, got = port_step(model, *train_batch())
    np.testing.assert_allclose(loss, want_loss, rtol=1e-5)
    assert got.keys() == want.keys()
    for name, g in got.items():
        assert g is not None, name
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), atol=ATOL, rtol=RTOL,
                                   err_msg=name)


def stochastic_step(rev_backprop, depth=6, forward_only=False):
    """An fp32 train step with drop path 0.2 and ``MVIT.DROPOUT_RATE`` 0.1
    from one generator; returns the loss, the gradients and the
    generator's state after it."""
    extra = ["MVIT.DROPOUT_RATE", "0.1"]
    model = port_model(jax_variables(tuple(extra), depth=depth), extra, depth=depth,
                       droppath=0.2, rev_backprop=rev_backprop)
    gen = torch.Generator().manual_seed(5)
    for m in model.modules():
        if hasattr(m, "generator"):
            m.generator = gen
    model.train()
    x, y = train_batch()
    if forward_only:
        with torch.no_grad():
            model([torch.from_numpy(x)])
        return None, None, gen.get_state()
    loss, grads = port_step(model, x, y)
    return loss, grads, gen.get_state()


def test_reversible_backward_matches_checkpointed_fallback():
    """Drop path 0.2 and attention dropout 0.1: the reversible backward's
    gradients within 2e-4 / 2e-5 of ``TPU.REV_BACKPROP False``'s (each
    block under ``torch.utils.checkpoint``), equal losses, and after either
    step the generator stands where a forward alone leaves it."""
    loss_r, grads_r, gen_r = stochastic_step(True)
    loss_c, grads_c, gen_c = stochastic_step(False)
    _, _, gen_f = stochastic_step(True, forward_only=True)
    assert torch.equal(gen_r, gen_f) and torch.equal(gen_c, gen_f)
    assert loss_r == loss_c
    for name, g in grads_r.items():
        np.testing.assert_allclose(g.numpy(), grads_c[name].numpy(), rtol=2e-4, atol=2e-5,
                                   err_msg=name)
    # The masks were drawn: the step differs from the deterministic one.
    model = port_model(jax_variables(depth=6), depth=6)
    model.train()
    assert port_step(model, *train_batch())[0] != loss_r


@pytest.mark.parametrize("rev_backprop", [True, False])
def test_flash_core_calls_per_step(rev_backprop, monkeypatch):
    """The constant-shift core's forward runs once a block and once more for
    each reversible block's rebuild (or checkpoint recompute), its backward
    once a block: 2 · 5 + 1 forwards and 6 backwards at depth 6 (at the
    recipe's 16 blocks, 29 and 16)."""
    calls = {"fwd": 0, "bwd": 0}
    core, backward = tattention.flash_pooled_attention, tattention._FlashCore.backward

    def counted_core(q, k, v):
        calls["fwd"] += 1
        return core(q, k, v)

    def counted_backward(ctx, do):
        calls["bwd"] += 1
        return backward(ctx, do)

    monkeypatch.setattr(tattention, "flash_pooled_attention", counted_core)
    monkeypatch.setattr(tattention._FlashCore, "backward", staticmethod(counted_backward))
    model = port_model(jax_variables(depth=6), depth=6, rev_backprop=rev_backprop)
    model.train()
    port_step(model, *train_batch())
    n_rev = sum(isinstance(layer, ReversibleBlock) for layer in model.rev_backbone.layers)
    assert n_rev == 5
    assert calls == {"fwd": 6 + n_rev, "bwd": 6}


# --- memory --------------------------------------------------------------------

def saved_activation_bytes(depth, rev_backprop):
    """Bytes of the non-parameter tensors that one train forward saves for
    its backward (``saved_tensors_hooks``)."""
    model = port_model(jax_variables(depth=depth), depth=depth, rev_backprop=rev_backprop)
    model.train()
    params = {p.data_ptr() for p in model.parameters()}
    saved = {}

    def pack(t):
        if t.data_ptr() not in params:
            saved[(t.data_ptr(), t.dtype, tuple(t.shape))] = t.numel() * t.element_size()
        return t

    x, y = train_batch()
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        loss = tlosses.soft_cross_entropy(model([torch.from_numpy(x)]), torch.from_numpy(y))
    loss.backward()
    return sum(saved.values())


def test_activation_memory_flat_in_depth():
    """Span depth 6 -> 18 (depth 8 -> 20): the reversible backward's saved
    bytes stay flat (growth under max(4096, 5% of the fallback's)), the
    checkpointed fallback's grow by two (B, N, C) streams a block (16 KB
    here): the bounds of the JAX package's test."""
    remat_growth = saved_activation_bytes(20, False) - saved_activation_bytes(8, False)
    rev_growth = saved_activation_bytes(20, True) - saved_activation_bytes(8, True)
    assert remat_growth > 12 * 8192, remat_growth
    assert rev_growth < max(4096, 0.05 * remat_growth), (rev_growth, remat_growth)


# --- bridge, recipe, optimizer ---------------------------------------------------

BRIDGE = ("MVIT.REV.PRE_Q_FUSION", "concat_linear_2", "MVIT.REV.RESPATH_FUSE", "ln+mlp")


@pytest.mark.parametrize("extra,names", [
    ((), ["rev_backbone.layers.1.res_proj.weight", "rev_backbone.layers.0.F.attn.qkv.weight",
          "rev_backbone.layers.1.F.attn.pool_q.weight", "rev_backbone.layers.2.G.mlp.fc2.bias"]),
    (BRIDGE, ["rev_backbone.layers.1.pre_q_fuse.fuse_fn1.weight",
              "rev_backbone.layers.1.pre_q_fuse.fuse_fn2.bias", "fuse.fuse_norm.weight",
              "fuse.fuse_mlp.fc1.weight"]),
    (("MVIT.REV.PRE_Q_FUSION", "concat_linear", "MVIT.REV.RES_PATH", "max",
      "MVIT.REV.RESPATH_FUSE", "concat_linear_1"),
     ["rev_backbone.layers.1.pre_q_fuse.fuse_fn.weight", "fuse.fuse_fn.bias"]),
], ids=["default", "fuse_linear_2_ln_mlp", "fuse_linear_res_max"])
def test_bridge_round_trip(extra, names):
    """JAX variables -> ``state_dict_from_jax`` -> the port (strict) -> its
    ``state_dict`` -> JAX's ``load_torch_checkpoint_dict`` (strict) gives
    the variables back: ``rev_backbone.layers.{i}``, ``F``/``G``,
    ``pre_q_fuse``, ``res_proj`` and the ``fuse`` projections."""
    variables = jax_variables(extra)
    model = port_model(variables, extra)
    sd = model.state_dict()
    for name in names:
        assert name in sd, name
    zeros = jax.tree.map(np.zeros_like, variables)
    back, missing, unexpected = load_torch_checkpoint_dict(sd, zeros, strict=True)
    assert not missing and not unexpected
    flat_want = traverse_util.flatten_dict(variables["params"])
    flat_got = traverse_util.flatten_dict(back["params"])
    assert flat_got.keys() == flat_want.keys()
    for path, v in flat_want.items():
        np.testing.assert_array_equal(flat_got[path], v, err_msg=str(path))


def test_recipe_builds_at_full_size():
    """REV_MVIT_B_16x4_CONV.yaml at full width and depth on the meta device:
    16 layers, transitions at [1, 3, 14], a 1,536-wide head (the concat of
    two 768-wide streams)."""
    cfg = get_cfg()
    cfg.merge_from_file(os.path.join(CONFIGS, "Kinetics", "REV_MVIT_B_16x4_CONV.yaml"))
    with torch.device("meta"):
        model = tmvit.MViT(cfg)
        init_mvit_weights(model, cfg, torch.Generator().manual_seed(0))
    layers = model.rev_backbone.layers
    assert len(layers) == 16
    assert [i for i, b in enumerate(layers) if isinstance(b, StageTransitionBlock)] == [1, 3, 14]
    assert model.head.projection.in_features == 2 * 768
    assert sum(p.numel() for p in model.parameters()) > 3e7


def test_cls_token_and_2d_patch_refused():
    """A cls token is refused, as in the reference; the 2D patch stem is
    ported (tests/test_torch_imagenet.py) and builds the reversible trunk on
    one image's token grid."""
    with pytest.raises(AssertionError):
        tmvit.MViT(make_cfg(get_cfg, ["MVIT.CLS_EMBED_ON", "True"]))
    model = tmvit.MViT(make_cfg(get_cfg, ["MVIT.PATCH_2D", "True", "DATA.NUM_FRAMES", "1",
                                          "MVIT.PATCH_KERNEL", "[7, 7]",
                                          "MVIT.PATCH_STRIDE", "[4, 4]",
                                          "MVIT.PATCH_PADDING", "[3, 3]"]))
    assert model.patch_embed.proj.weight.dim() == 4 and model.patch_dims[0] == 1


def test_init_of_the_fusions_follows_jax():
    """``fuse_fn*`` lecun_normal with a zero bias, ``fuse_norm`` scale 1
    and bias 0, ``fuse_mlp`` trunc_normal(0.02) with a zero bias; the
    transition's ``res_proj`` trunc_normal(0.02) with the 0.02 bias."""
    sd = build_model(make_cfg(get_cfg, BRIDGE), device="cpu").state_dict()
    w = sd["rev_backbone.layers.1.pre_q_fuse.fuse_fn1.weight"]
    assert 0.5 < w.std().item() * np.sqrt(w.shape[1]) < 1.5
    assert torch.all(sd["rev_backbone.layers.1.pre_q_fuse.fuse_fn2.bias"] == 0)
    assert torch.all(sd["fuse.fuse_norm.weight"] == 1) and torch.all(sd["fuse.fuse_norm.bias"] == 0)
    assert 0 < sd["fuse.fuse_mlp.fc1.weight"].abs().max() <= 0.04
    assert torch.all(sd["fuse.fuse_mlp.fc2.bias"] == 0)
    sd = build_model(make_cfg(get_cfg), device="cpu").state_dict()
    assert 0 < sd["rev_backbone.layers.1.res_proj.weight"].abs().max() <= 0.04
    assert torch.all(sd["rev_backbone.layers.1.res_proj.bias"] == 0.02)


@pytest.mark.parametrize("extra", [(), ("SOLVER.ZERO_WD_1D_PARAM", "True") + BRIDGE,
                                   ("SOLVER.LAYER_DECAY", "0.75", "MVIT.USE_ABS_POS", "True",
                                    "MVIT.ZERO_DECAY_POS_CLS", "True")],
                         ids=["default", "zero_wd_1d", "layer_decay_pos"])
def test_param_scales_match_jax(extra):
    """The weight decay and LR scale of every Rev-MViT parameter equal the
    JAX package's (solver/optimizer.py:49-84)."""
    variables = jax_variables(tuple(extra))
    wd_tree, scale_tree = joptim.build_param_scales(variables["params"],
                                                    make_cfg(jax_get_cfg, extra))
    wd = traverse_util.flatten_dict(wd_tree)
    scale = traverse_util.flatten_dict(scale_tree)
    want = {port_name(p): (wd[p], scale[p]) for p in wd}
    got = toptim.build_param_scales(port_model(variables, extra), make_cfg(get_cfg, extra))
    assert got == pytest.approx(want)
