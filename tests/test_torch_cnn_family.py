"""The CNN classification family of the port (C2D, I3D with non-local
blocks, Slow, ResNet_nopool, X3D, CSN and R(2+1)D) against the JAX
package, on the CPU.

Every parameter and BN statistic is overwritten with seeded random values
(gamma and variance in [0.5, 1.5]), so no zero-init branch (final BNs, the
non-local ``bn``) hides a fault. Inputs are seeded numpy arrays.

* Each new module alone in eval mode: ``Nonlocal`` (softmax and
  dot-product, with and without the key/value pool), ``X3DTransform`` with
  and without SE, ``SE``, the X3D stem, ``X3DHead`` with and without
  ``BN_LIN5``, ``BasicTransform``, ``CSNTransform`` and
  ``R2Plus1DTransform``; fp32 within atol 1e-5 + rtol 1e-4
  (sums taken in another order), bf16 within 2e-2 of the output's max (the
  two frameworks round activations to bf16 at different places).
* Whole narrow models (depth 18, 4 frames, 64² crops): the eval softmax in
  fp32 and bf16 (atol 1e-5 / 2e-2), the train-mode logits and every BN
  running statistic after one train-mode forward (fp32), and the fp32
  gradients of one train step against ``jax.grad`` for I3D-NLN and X3D
  (each within 1e-3 of its max, all within 1e-4 relative L2). For CSN and
  R(2+1)D the same limits, with a flip decided by float64 as in
  ``test_torch_slowfast_train.py``: on these inputs JAX's own fp32
  gradients sit 5.1e-3 (CSN) and 3.4e-2 (R(2+1)D) of their max from the
  port's float64 step, the port's fp32 ones 2.7e-5; with other inputs (4,
  5) JAX's CSN gradients sit 8e-5 from it. A ReLU or max pool of JAX's fp32
  forward took the other side of a near-tie there.
  CSN and R(2+1)D are ``PTVCSN`` / ``PTVR2plus1D`` from their recipes with
  ``RESNET.TRANS_FUNC`` set to their transform (the recipes leave it at
  the bottleneck).
* The weight bridge: the port's ``state_dict`` of each model goes through
  the JAX package's ``load_torch_checkpoint_dict`` back to the same
  variables, with nothing missing or unexpected.
"""

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
from slowfast_tpu.models import heads as jheads
from slowfast_tpu.models import nonlocal_block as jnl
from slowfast_tpu.models import resnet as jresnet
from slowfast_tpu.models import stem as jstem
from slowfast_tpu.models.build import init_model
from slowfast_tpu.solver import losses as jlosses
from slowfast_tpu.utils.checkpoint import load_torch_checkpoint_dict
from slowfast_tpu_torch.config import get_cfg
from slowfast_tpu_torch.models import common as tcommon
from slowfast_tpu_torch.models import heads as theads
from slowfast_tpu_torch.models import nonlocal_block as tnl
from slowfast_tpu_torch.models import resnet as tresnet
from slowfast_tpu_torch.models import stem as tstem
from slowfast_tpu_torch.models.batchnorm import BatchNorm3D
from slowfast_tpu_torch.models.build import build_model
from slowfast_tpu_torch.solver import losses as tlosses
from slowfast_tpu_torch.utils.checkpoint import state_dict_from_jax
from test_torch_blocks import J_NORM, T_NORM, _x, jax_variables, port_apply, randomize
from test_torch_train import one_torch_thread  # noqa: F401  (autouse fixture)

ATOL, RTOL, BF16_SHARE = 1e-5, 1e-4, 2e-2
KINETICS = os.path.join(os.path.dirname(__file__), "..", "configs", "Kinetics")
NARROW = ["RESNET.DEPTH", "18", "RESNET.WIDTH_PER_GROUP", "4", "DATA.NUM_FRAMES", "4",
          "DATA.TRAIN_CROP_SIZE", "64", "DATA.TEST_CROP_SIZE", "64", "MODEL.NUM_CLASSES", "10",
          "MODEL.DROPOUT_RATE", "0.0", "NUM_GPUS", "1"]
# Depth 18 has two blocks a stage: non-local blocks after res3's and res4's
# second block, each with the recipe's (1, 2, 2) key/value pool.
NLN = ["NONLOCAL.LOCATION", "[[[]], [[1]], [[1]], [[]]]"]
MODELS = {
    "c2d": ("C2D_8x8_R50.yaml", []),
    "i3d_nln": ("I3D_NLN_8x8_R50.yaml", NLN),
    "i3d_nln_dot_product": ("I3D_NLN_8x8_R50.yaml", NLN + ["NONLOCAL.INSTANTIATION",
                                                             "dot_product"]),
    "slow": ("SLOW_8x8_R50.yaml", []),
    "c2d_nopool": ("C2D_8x8_R50.yaml", ["MODEL.MODEL_NAME", "ResNet_nopool"]),
    "x3d": ("X3D_M.yaml", ["X3D.WIDTH_FACTOR", "0.5", "X3D.DEPTH_FACTOR", "0.5",
                           "X3D.DIM_C5", "32"]),
    "csn": ("pytorchvideo/CSN_32x2_R101.yaml", ["RESNET.TRANS_FUNC", "csn_transform"]),
    "r2plus1d": ("pytorchvideo/R2PLUS1D_16x4_R50.yaml",
                 ["RESNET.TRANS_FUNC", "r2plus1d_transform"]),
}


def assert_close(got, want, dtype="float32"):
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    else:
        share = np.abs(got - want).max() / np.abs(want).max()
        assert share <= BF16_SHARE, share


def run_both(jm, tm, x, seed, dtype, **apply_kw):
    """``jm`` and ``tm`` in eval mode on ``x`` (NTHWC numpy) in ``dtype``,
    with the same random variables."""
    v = jax_variables(jm, (jnp.asarray(x),), seed)
    jx = jnp.asarray(x, getattr(jnp, dtype))
    want = jm.apply(v, jx, **(apply_kw or {"train": False}))
    got = port_apply(tm, v, torch.from_numpy(x).to(getattr(torch, dtype)))
    assert got.dtype == getattr(torch, dtype)
    return got, want


DTYPES = ["float32", "bfloat16"]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("instantiation", ["softmax", "dot_product"])
@pytest.mark.parametrize("pool", [None, [1, 2, 2]])
def test_nonlocal(instantiation, pool, dtype):
    x = _x((2, 4, 6, 6, 16), 20)
    jm = jnl.Nonlocal(dim=16, dim_inner=8, pool_size=pool, instantiation=instantiation,
                      norm=J_NORM, dtype=getattr(jnp, dtype))
    tm = tnl.Nonlocal(16, 8, pool_size=pool, instantiation=instantiation, norm=T_NORM)
    assert_close(*run_both(jm, tm, x, 21, dtype), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("block_idx,stride", [(0, 2), (1, 1), (2, 1)])
def test_x3d_transform(block_idx, stride, dtype):
    """Block indices 0 and 2 have SE, 1 has none; channelwise 3x3x3."""
    x = _x((2, 4, 8, 8, 12), 22)
    args = dict(dim_out=12, temp_kernel_size=3, stride=stride, dim_inner=24, num_groups=24,
                zero_init_final_bn=True, block_idx=block_idx)
    jm = jresnet.X3DTransform(norm=J_NORM, dtype=getattr(jnp, dtype), **args)
    tm = tresnet.X3DTransform(dim_in=12, norm=T_NORM, **args)
    assert (tm.se is not None) == (block_idx % 2 == 0)
    assert_close(*run_both(jm, tm, x, 23, dtype), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("dim_in", [24, 200])
def test_se(dim_in, dtype):
    """fc1 widths: 8 (the floor) and round_width(200, 1/16) = 16."""
    x = _x((2, 3, 5, 5, dim_in), 24)
    tm = tcommon.SE(dim_in, 0.0625)
    assert tm.fc1.weight.shape[0] == max(8, jcommon.SE._round_width(dim_in, 0.0625))
    jm = jcommon.SE(dim_in=dim_in, ratio=0.0625)
    assert_close(*run_both(jm, tm, x, 25, dtype, rngs={}), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_x3d_stem(dtype):
    xs = [_x((2, 5, 16, 16, 3), 26)]
    kw = dict(kernel=[[5, 3, 3]], stride=[[1, 2, 2]], padding=[[2, 1, 1]])
    jm = jstem.VideoModelStem(dim_out=[12], norm=J_NORM, stem_func_name="x3d_stem",
                              dtype=getattr(jnp, dtype), **kw)
    v = jax_variables(jm, ([jnp.asarray(x) for x in xs],), 27)
    want = jm.apply(v, [jnp.asarray(x, getattr(jnp, dtype)) for x in xs], train=False)
    tm = tstem.VideoModelStem(dim_in=[3], dim_out=[12], norm=T_NORM,
                              stem_func_name="x3d_stem", **kw)
    got = port_apply(tm, v, [torch.from_numpy(x).to(getattr(torch, dtype)) for x in xs])
    assert_close(got[0], want[0], dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("bn_lin5", [False, True])
@pytest.mark.parametrize("pool", [[2, 3, 3], None])
def test_x3d_head(bn_lin5, pool, dtype):
    """A 2x3x3 pool on a 2x4x4 map leaves 2x2 positions: per-position
    projection and softmax, then the mean; None pools globally."""
    x = _x((2, 2, 4, 4, 16), 28)
    args = dict(dim_in=16, dim_inner=24, dim_out=32, num_classes=10, pool_size=pool,
                bn_lin5_on=bn_lin5)
    jm = jheads.X3DHead(norm=J_NORM, dtype=getattr(jnp, dtype), **args)
    tm = theads.X3DHead(norm=T_NORM, **args)
    v = jax_variables(jm, ([jnp.asarray(x)],), 29)
    want = jm.apply(v, [jnp.asarray(x, getattr(jnp, dtype))], train=False)
    got = port_apply(tm, v, [torch.from_numpy(x).to(getattr(torch, dtype))])
    assert got.shape == (2, 10)
    assert_close(got, want, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("dim_in,stride,tk", [(16, 1, 3), (8, 2, 1)])
def test_basic_transform(dim_in, stride, tk, dtype):
    x = _x((2, 4, 8, 8, dim_in), 30)
    args = dict(dim_out=16, temp_kernel_size=tk, stride=stride, zero_init_final_bn=True)
    jm = jresnet.BasicTransform(norm=J_NORM, dtype=getattr(jnp, dtype), **args)
    tm = tresnet.BasicTransform(dim_in=dim_in, dim_inner=0, num_groups=1, norm=T_NORM, **args)
    assert_close(*run_both(jm, tm, x, 31, dtype), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("transform", ["CSNTransform", "R2Plus1DTransform"])
@pytest.mark.parametrize("dim_in,stride,dilation", [(16, 1, 1), (8, 2, 1), (16, 1, 2)])
def test_csn_and_r2plus1d_transforms(transform, dim_in, stride, dilation, dtype):
    x = _x((2, 4, 8, 8, dim_in), 32)
    args = dict(dim_out=16, temp_kernel_size=1, stride=stride, dim_inner=12, num_groups=1,
                dilation=dilation, zero_init_final_bn=True)
    jm = getattr(jresnet, transform)(norm=J_NORM, dtype=getattr(jnp, dtype), **args)
    tm = getattr(tresnet, transform)(dim_in=dim_in, norm=T_NORM, **args)
    assert_close(*run_both(jm, tm, x, 33, dtype), dtype)


def model_cfg(get, name, dtype="float32"):
    yaml, extra = MODELS[name]
    cfg = get()
    cfg.merge_from_file(os.path.join(KINETICS, yaml))
    cfg.merge_from_list(NARROW + extra + ["TPU.COMPUTE_DTYPE", dtype])
    return cfg


class JaxModel:
    """A narrow JAX model with random variables (traced shapes, seeded
    values). Two of them are then rescaled, so that no softmax saturates and
    the comparisons see the whole distribution: the non-local ``conv_theta``
    and ``conv_phi`` kernels by 1/2 (at full scale the affinity logits span
    about ±30, and each fp32 rounding upstream moves the softmax by 30 times
    as much), and the projection so that the logits of ``inputs(1)`` have
    std 2."""

    def __init__(self, name):
        self.name = name
        cfg = model_cfg(jax_get_cfg, name)
        self.model = jax_build_model(cfg)
        shapes = jax.eval_shape(
            lambda: init_model(self.model, cfg, rng=jax.random.PRNGKey(0), train=False))
        self.variables = randomize(dict(shapes), 40)
        self.frames = cfg.DATA.NUM_FRAMES
        flat = traverse_util.flatten_dict(self.variables["params"])
        for path in flat:
            if path[-2] in ("conv_theta", "conv_phi") and path[-1] == "kernel":
                flat[path] = flat[path] * 0.5
        model = self.port(extra=["MODEL.HEAD_ACT", "none"], params=flat)
        model.eval()
        with torch.no_grad():
            k = 2.0 / model([torch.from_numpy(x) for x in self.inputs(1)]).std().item()
        for leaf in ("kernel", "bias"):
            flat[("head", "projection", leaf)] = flat[("head", "projection", leaf)] * k
        self.variables["params"] = traverse_util.unflatten_dict(flat)

    def inputs(self, seed):
        return [_x((2, self.frames, 64, 64, 3), seed)]

    def port(self, dtype="float32", extra=(), params=None):
        cfg = model_cfg(get_cfg, self.name, dtype)
        cfg.merge_from_list(list(extra))
        model = build_model(cfg, device="cpu")
        variables = dict(self.variables)
        if params is not None:
            variables["params"] = traverse_util.unflatten_dict(params)
        model.load_state_dict(state_dict_from_jax(variables), strict=True)
        return model


_JAX_MODELS = {}


def jax_model(name):
    if name not in _JAX_MODELS:
        _JAX_MODELS[name] = JaxModel(name)
    return _JAX_MODELS[name]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", sorted(MODELS))
def test_model_eval_matches_jax(name, dtype):
    jm = jax_model(name)
    xs = jm.inputs(1)
    jmodel = jax_build_model(model_cfg(jax_get_cfg, name, dtype))
    want = np.asarray(jax.jit(lambda v, x: jmodel.apply(v, x, train=False))(
        jm.variables, [jnp.asarray(x) for x in xs]), np.float32)
    model = jm.port(dtype)
    model.eval()
    with torch.no_grad():
        got = model([torch.from_numpy(x) for x in xs])
    assert got.shape == (2, 10) and got.dtype == getattr(torch, dtype)
    assert want.max() < 0.9  # not a saturated softmax
    np.testing.assert_allclose(got.float().numpy(), want,
                               atol=ATOL if dtype == "float32" else BF16_SHARE, rtol=0)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_model_train_forward_and_bn_statistics_match_jax(name):
    """One train-mode forward: the logits, and every BN's running mean and
    variance after the momentum update."""
    jm = jax_model(name)
    xs = jm.inputs(2)
    want, mutated = jax.jit(lambda v, x: jm.model.apply(
        v, x, train=True, mutable=["batch_stats"], rngs={"dropout": jax.random.PRNGKey(0)}))(
        jm.variables, [jnp.asarray(x) for x in xs])
    model = jm.port()
    model.train()
    with torch.no_grad():
        got = model([torch.from_numpy(x) for x in xs])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=RTOL)
    stats = state_dict_from_jax({"params": {}, "batch_stats": mutated["batch_stats"]})
    sd = model.state_dict()
    bn_buffers = [k for k in sd if k.endswith(("running_mean", "running_var"))]
    assert sorted(bn_buffers) == sorted(k for k in stats if not k.endswith("tracked"))
    for k in bn_buffers:
        np.testing.assert_allclose(sd[k].numpy(), stats[k].numpy(), atol=ATOL, rtol=RTOL,
                                   err_msg=k)


@pytest.mark.parametrize("name", ["i3d_nln", "x3d"])
def test_train_gradients_match_jax_grad(name):
    """Each gradient within 1e-3 of its own max, all of them within 1e-4
    relative L2: the models' gradients move with the summation order (one
    torch thread or several) by more than atol 1e-5 on a few elements. Two
    clips: at four, the JAX package's own fp32 I3D-NLN gradients sit 1.3e-2
    (relative L2) from a float64 run of the port, whose fp32 gradients sit
    1.2e-5 from it (ROADMAP.md, Queue 3)."""
    jm = jax_model(name)
    xs = jm.inputs(3)
    labels = np.array([3, 7])

    def loss_fn(params):
        preds, _ = jm.model.apply({"params": params, "batch_stats": jm.variables["batch_stats"]},
                                  [jnp.asarray(x) for x in xs], train=True,
                                  mutable=["batch_stats"],
                                  rngs={"dropout": jax.random.PRNGKey(0)})
        return jlosses.get_loss_func("cross_entropy")(preds, jnp.asarray(labels))

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(jm.variables["params"])
    want = state_dict_from_jax({"params": jax.tree.map(np.asarray, grads)})
    model = jm.port()
    model.train()
    preds = model([torch.from_numpy(x) for x in xs])
    got_loss = tlosses.get_loss_func("cross_entropy")(preds, torch.from_numpy(labels))
    got_loss.backward()
    np.testing.assert_allclose(got_loss.item(), float(loss), rtol=1e-5)
    names = [n for n, _ in model.named_parameters()]
    assert sorted(names) == sorted(want)
    diff = sq = 0.0
    gmax = max(want[n].abs().max().item() for n in names)
    for n, p in model.named_parameters():
        assert p.grad is not None and p.grad.abs().max() > 0, n
        if want[n].abs().max() <= 1e-5 * gmax:
            # Zero in exact arithmetic (a bias before a softmax or a
            # train-mode BN): rounding noise on both sides.
            assert p.grad.abs().max() <= 1e-5 * gmax, n
            continue
        share = ((p.grad - want[n]).abs().max() / want[n].abs().max()).item()
        assert share <= 1e-3, (n, share)
        diff += (p.grad - want[n]).double().pow(2).sum().item()
        sq += want[n].double().pow(2).sum().item()
    assert (diff / sq) ** 0.5 <= 1e-4


def port_grads(jm, xs, labels, dtype=torch.float32):
    """The port's gradients of one fp32 (or float64) train-mode step."""
    model = jm.port()
    if dtype == torch.float64:
        model = model.double()
        model.dtype = dtype
    model.train()
    preds = model([torch.from_numpy(x).to(dtype) for x in xs])
    loss = tlosses.get_loss_func("cross_entropy")(preds, torch.from_numpy(labels))
    loss.backward()
    return loss.item(), {n: p.grad.double() for n, p in model.named_parameters()}


def grads_within(got, want, share_tol=1e-3, l2_tol=1e-4):
    """Each gradient within ``share_tol`` of its max (zero ones within
    rounding noise) and all within ``l2_tol`` relative L2; returns the
    relative L2."""
    gmax = max(w.abs().max().item() for w in want.values())
    diff = sq = 0.0
    for n, w in want.items():
        assert got[n].abs().max() > 0, n
        if w.abs().max() <= 1e-5 * gmax:
            assert got[n].abs().max() <= 1e-5 * gmax, n
            continue
        share = ((got[n] - w).abs().max() / w.abs().max()).item()
        assert share <= share_tol, (n, share)
        diff += (got[n] - w).pow(2).sum().item()
        sq += w.pow(2).sum().item()
    rel = (diff / sq) ** 0.5
    assert rel <= l2_tol, rel
    return rel


def rel_l2(a, b):
    num = sum((a[n] - b[n]).pow(2).sum().item() for n in b)
    return (num / sum(b[n].pow(2).sum().item() for n in b)) ** 0.5


@pytest.mark.parametrize("name", ["csn", "r2plus1d"])
def test_csn_and_r2plus1d_gradients_match_jax_grad(name):
    """The port's fp32 gradients within the I3D limits of JAX's, unless
    JAX's fp32 step flipped: then the port's fp32 step must be within those
    limits of its float64 step, JAX's at least as far from that float64
    step as from the port's (JAX's run is the one that moved), and within
    5e-2 relative L2 of the port's, as a flip is held in
    ``test_torch_slowfast_train.py``."""
    jm = jax_model(name)
    xs = jm.inputs(3)
    labels = np.array([3, 7])

    def loss_fn(params):
        preds, _ = jm.model.apply({"params": params, "batch_stats": jm.variables["batch_stats"]},
                                  [jnp.asarray(x) for x in xs], train=True,
                                  mutable=["batch_stats"],
                                  rngs={"dropout": jax.random.PRNGKey(0)})
        return jlosses.get_loss_func("cross_entropy")(preds, jnp.asarray(labels))

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(jm.variables["params"])
    want = {n: g.double() for n, g in
            state_dict_from_jax({"params": jax.tree.map(np.asarray, grads)}).items()}
    got_loss, got = port_grads(jm, xs, labels)
    np.testing.assert_allclose(got_loss, float(loss), rtol=1e-5)
    assert sorted(got) == sorted(want)
    try:
        grads_within(got, want)
    except AssertionError:
        _, got64 = port_grads(jm, xs, labels, torch.float64)
        grads_within(got, got64)
        assert rel_l2(want, got64) >= rel_l2(want, got) * 0.9
        assert rel_l2(got, want) <= 5e-2


@pytest.mark.parametrize("name", ["i3d_nln", "x3d", "c2d_nopool", "csn", "r2plus1d"])
def test_state_dict_round_trips_through_the_jax_importer(name):
    jm = jax_model(name)
    model = jm.port()
    zeros = jax.tree.map(np.zeros_like, jm.variables)
    new_vars, missing, unexpected = load_torch_checkpoint_dict(model.state_dict(), zeros)
    assert missing == [] and unexpected == []
    for col in ("params", "batch_stats"):
        want = traverse_util.flatten_dict(jm.variables[col])
        got = traverse_util.flatten_dict(new_vars[col])
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(np.asarray(got[k]), want[k], err_msg=str(k))


def test_every_bn_is_randomized():
    """The comparisons above see no zero-init branch: every BN scale of the
    random variables is in [0.5, 1.5], the zero-init ones included."""
    model = jax_model("i3d_nln").port()
    gammas = [m.weight for m in model.modules() if isinstance(m, BatchNorm3D)]
    assert len(gammas) > 0 and all(g.min() >= 0.5 for g in gammas)
    assert any(n.endswith("nonlocal1.bn.weight") for n, _ in model.named_parameters())
