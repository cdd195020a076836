"""Eval-mode forward parity of the port's blocks against the JAX package's.

Every parameter and BN statistic is overwritten with seeded random values
(gamma and variance in [0.5, 1.5]) before the comparison, so no residual
branch is zeroed by the zero-init final BN. Inputs are seeded numpy arrays.

At these narrow widths the JAX package runs its T-folded, block-Toeplitz
and per-tap formulations (``SMALL_C = 32``); the port runs one direct
``conv3d``. fp32 on both sides; tolerance atol 1e-5, rtol 1e-4 (sums taken
in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from slowfast_tpu.config import get_cfg as jax_get_cfg
from slowfast_tpu.models import batchnorm as jbn
from slowfast_tpu.models import heads as jheads
from slowfast_tpu.models import resnet as jresnet
from slowfast_tpu.models import stem as jstem
from slowfast_tpu.models import video_models as jvm
from slowfast_tpu.ops.video_conv import fold_time
from slowfast_tpu_torch.config import get_cfg
from slowfast_tpu_torch.models import batchnorm as tbn
from slowfast_tpu_torch.models import heads as theads
from slowfast_tpu_torch.models import resnet as tresnet
from slowfast_tpu_torch.models import stem as tstem
from slowfast_tpu_torch.models import video_models as tvm
from slowfast_tpu_torch.utils.checkpoint import state_dict_from_jax

ATOL, RTOL = 1e-5, 1e-4
J_NORM = jbn.norm_builder(jax_get_cfg())
T_NORM = tbn.norm_builder(get_cfg())


def randomize(shapes, seed):
    """Seeded values for a tree of ShapeDtypeStructs: conv/dense kernels
    N(0, 2/fan_in), BN gamma and variance U(0.5, 1.5), biases and means
    N(0, 0.1)."""
    rng = np.random.RandomState(seed)
    out = {}
    for path, s in traverse_util.flatten_dict(shapes).items():
        leaf = path[-1]
        if leaf == "kernel":
            v = rng.normal(0.0, np.sqrt(2.0 / np.prod(s.shape[:-1])), s.shape)
        elif leaf in ("scale", "var"):
            v = rng.uniform(0.5, 1.5, s.shape)
        else:
            v = rng.normal(0.0, 0.1, s.shape)
        out[path] = v.astype(np.float32)
    return traverse_util.unflatten_dict(out)


def jax_variables(module, args, seed, **kwargs):
    """Random variables shaped as ``module.init`` would make them (traced
    only, never run)."""
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), *args, **kwargs))
    return randomize(dict(shapes), seed)


def port_apply(block, variables, *args):
    block.load_state_dict(state_dict_from_jax(variables), strict=True)
    block.eval()
    with torch.no_grad():
        return block(*args)


def assert_close(got, want):
    if isinstance(got, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert_close(g, w)
        return
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)


def _x(shape, seed):
    return np.random.RandomState(seed).normal(0.0, 1.0, shape).astype(np.float32)


def test_stem_matches_folded_jax_stem():
    xs = [_x((2, 2, 16, 16, 3), 0), _x((2, 8, 16, 16, 3), 1)]
    kw = dict(kernel=[[1, 7, 7], [5, 7, 7]], stride=[[1, 2, 2]] * 2,
              padding=[[0, 3, 3], [2, 3, 3]])
    jm = jstem.VideoModelStem(dim_out=[8, 2], norm=J_NORM, **kw)
    v = jax_variables(jm, ([jnp.asarray(x) for x in xs],), 10)
    want = jm.apply(v, [jnp.asarray(x) for x in xs], train=False)
    tm = tstem.VideoModelStem(dim_in=[3, 3], dim_out=[8, 2], norm=T_NORM, **kw)
    got = port_apply(tm, v, [torch.from_numpy(x) for x in xs])
    assert_close(got, want)


@pytest.mark.parametrize(
    "dim_in,dim_out,stride,tk,stride_1x1",
    [(16, 16, 1, 3, False), (8, 32, 2, 3, False), (8, 32, 2, 1, True)],
)
def test_resblock(dim_in, dim_out, stride, tk, stride_1x1):
    x = _x((2, 4, 8, 8, dim_in), 2)
    args = dict(dim_out=dim_out, temp_kernel_size=tk, stride=stride,
                trans_func_name="bottleneck_transform", dim_inner=8, num_groups=1,
                stride_1x1=stride_1x1, zero_init_final_bn=True)
    jm = jresnet.ResBlock(dim_in=dim_in, norm=J_NORM, **args)
    v = jax_variables(jm, (jnp.asarray(x),), 11)
    want = jm.apply(v, jnp.asarray(x), train=False)
    tm = tresnet.ResBlock(dim_in=dim_in, norm=T_NORM, **args)
    assert_close(port_apply(tm, v, torch.from_numpy(x)), want)


def test_resstage_matches_folded_jax_stage():
    """Two pathways; the narrow one runs T-folded in JAX. Temporal kernel
    schedule cut at 1 block of 2."""
    xs = [_x((2, 2, 8, 8, 40), 3), _x((2, 8, 8, 8, 8), 4)]
    args = dict(dim_in=[40, 8], dim_out=[64, 16], dim_inner=[16, 4],
                temp_kernel_sizes=[[1], [3]], stride=[2, 2], num_blocks=[2, 2],
                num_groups=[1, 1], num_block_temp_kernel=[1, 1],
                nonlocal_inds=[[], []], trans_func_name="bottleneck_transform")
    jm = jresnet.ResStage(nonlocal_group=[1, 1], nonlocal_pool=[[1, 2, 2]] * 2,
                          instantiation="dot_product", norm=J_NORM, **args)
    jx = [jnp.asarray(x) for x in xs]
    v = jax_variables(jm, (jx,), 12)
    want = jm.apply(v, jx, train=False)
    tm = tresnet.ResStage(norm=T_NORM, **args)
    assert_close(port_apply(tm, v, [torch.from_numpy(x) for x in xs]), want)


@pytest.mark.parametrize("folded", [False, True])
def test_fuse_fast_to_slow(folded):
    T, alpha = 8, 4
    x_s, x_f = _x((2, T // alpha, 6, 6, 16), 5), _x((2, T, 6, 6, 4), 6)
    jf = fold_time(jnp.asarray(x_f)) if folded else jnp.asarray(x_f)
    jm = jvm.FuseFastToSlow(4, 2, 5, alpha, norm=J_NORM, folded_t=T if folded else 0)
    v = jax_variables(jm, ([jnp.asarray(x_s), jf],), 13)
    want_s, _ = jm.apply(v, [jnp.asarray(x_s), jf], train=False)
    tm = tvm.FuseFastToSlow(4, 2, 5, alpha, norm=T_NORM)
    got_s, got_f = port_apply(tm, v, [torch.from_numpy(x_s), torch.from_numpy(x_f)])
    assert_close(got_s, want_s)
    assert torch.equal(got_f, torch.from_numpy(x_f))


@pytest.mark.parametrize("pool", [[[1, 2, 2], [4, 2, 2]], None])
def test_head_fully_convolutional(pool):
    """Pool 2x2 on a 3x3 map leaves 2x2 positions: per-position linear,
    softmax, then the mean over positions."""
    xs = [_x((2, 1, 3, 3, 16), 7), _x((2, 4, 3, 3, 4), 8)]
    jm = jheads.ResNetBasicHead(dim_in=[16, 4], num_classes=10, pool_size=pool)
    jx = [jnp.asarray(x) for x in xs]
    v = jax_variables(jm, (jx,), 14)
    want = jm.apply(v, jx, train=False)
    tm = theads.ResNetBasicHead(dim_in=[16, 4], num_classes=10, pool_size=pool)
    got = port_apply(tm, v, [torch.from_numpy(x) for x in xs])
    assert got.shape == (2, 10)
    assert_close(got, want)


def test_batchnorm_eval():
    x = _x((2, 3, 4, 5, 6), 9)
    jm = jbn.BatchNorm3D(features=6)
    v = jax_variables(jm, (jnp.asarray(x),), 15)
    want = jm.apply(v, jnp.asarray(x), train=False)
    assert_close(port_apply(tbn.BatchNorm3D(6), v, torch.from_numpy(x)), want)


def test_batchnorm_train_statistics():
    """Train mode: biased variance to normalize, unbiased variance and torch
    momentum for the running statistics."""
    x = _x((2, 3, 4, 5, 6), 16) * 2.0 + 0.5
    jm = jbn.BatchNorm3D(features=6)
    v = jax_variables(jm, (jnp.asarray(x),), 17)
    want, mutated = jm.apply(v, jnp.asarray(x), train=True, mutable=["batch_stats"])
    tm = tbn.BatchNorm3D(6)
    tm.load_state_dict(state_dict_from_jax(v), strict=True)
    tm.train()
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    assert_close(got, want)
    stats = mutated["batch_stats"]
    assert_close(tm.running_mean, stats["mean"])
    assert_close(tm.running_var, stats["var"])
