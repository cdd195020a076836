"""The port's uint8 preprocessing against the JAX package's.

Inputs are made with numpy from a seed and go through both packages on the
CPU: the JAX side through ``normalize_clips(impl="pallas")`` (the Pallas
kernel in interpret mode), ``impl="xla"``, ``device_preprocess`` and
``engine.steps._maybe_device_preprocess``; the port side through its
wrappers, which take the plain PyTorch version for CPU tensors.

Tolerance: 1 ulp, in the output dtype, of the largest magnitude in the
affine at that element (the product ``u8 * scale``, the bias or the
result). XLA may fuse the multiply-add into one rounding where the port
rounds twice; where the two terms cancel, that one rounding of a term is
many ulps of the small result.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slowfast_tpu.config import get_cfg as jax_get_cfg
from slowfast_tpu.engine.steps import _maybe_device_preprocess
from slowfast_tpu.ops import preprocess as jpp
from slowfast_tpu_torch.ops import preprocess as tpp

MEAN = [0.45, 0.4, 0.35]
STD = [0.225, 0.25, 0.2]
SHAPES = [(2, 8, 6, 10, 3), (3, 10, 5, 7, 3)]  # the second: T//alpha truncates
DTYPES = [("float32", jnp.float32, torch.float32), ("bfloat16", jnp.bfloat16, torch.bfloat16)]


def _clip(shape, seed):
    return np.random.RandomState(seed).randint(0, 256, shape).astype(np.uint8)


def _ulp(mag, dtype):
    """One ulp of ``mag`` (float64 array) in fp32 or bf16."""
    mag = np.maximum(mag, np.finfo(np.float32).tiny)
    return np.exp2(np.floor(np.log2(mag)) - (23 if dtype == torch.float32 else 7))


def _terms(x, flips=None, reverse=False, idx=None):
    """Per output element, max(|u8 * scale|, |bias|), laid out as the
    outputs ([x] or [slow, fast]) are."""
    scale, bias = tpp.scale_bias(MEAN, STD)
    mag = np.maximum(np.abs(x * scale.astype(np.float64)), np.abs(bias.astype(np.float64)))
    if flips is not None:
        mag = np.where(np.asarray(flips).reshape(-1, 1, 1, 1, 1) != 0, mag[:, :, :, ::-1], mag)
    if reverse:
        mag = mag[..., ::-1]
    return [mag] if idx is None else [mag[:, idx], mag]


def assert_within_one_ulp(got, want, terms):
    """``got`` (torch) and ``want`` (JAX) agree within 1 ulp, in got's dtype,
    of the largest magnitude in the affine."""
    g = got.to(torch.float32).numpy().astype(np.float64)
    w = np.asarray(want).astype(np.float64)
    assert g.shape == w.shape, (g.shape, w.shape)
    tol = _ulp(np.maximum(terms, np.maximum(np.abs(g), np.abs(w))), got.dtype)
    bad = np.abs(g - w) > tol
    assert not bad.any(), f"{bad.sum()} elements beyond 1 ulp, max diff {np.abs(g - w).max()}"


@pytest.mark.parametrize("impl", ["pallas", "xla"])
@pytest.mark.parametrize("name,jdt,tdt", DTYPES)
@pytest.mark.parametrize("shape", SHAPES)
def test_normalize_clips_matches_jax(impl, name, jdt, tdt, shape):
    x = _clip(shape, 0)
    want = jpp.normalize_clips(x, MEAN, STD, out_dtype=jdt, impl=impl)
    got = tpp.normalize_clips(torch.from_numpy(x), MEAN, STD, out_dtype=tdt)
    assert got.dtype == tdt
    assert_within_one_ulp(got, want, _terms(x)[0])


@pytest.mark.parametrize("single", [False, True])
@pytest.mark.parametrize("flip", [False, True])
@pytest.mark.parametrize("name,jdt,tdt", DTYPES)
@pytest.mark.parametrize("shape,alpha", [(SHAPES[0], 4), (SHAPES[1], 4), ((1, 16, 4, 6, 3), 8)])
def test_device_preprocess_matches_jax(single, flip, name, jdt, tdt, shape, alpha):
    x = _clip(shape, 1)
    flips = (np.arange(shape[0]) % 2 == 0).astype(np.int32) if flip else None
    want = jpp.device_preprocess(x, MEAN, STD, flips=flips, alpha=alpha,
                                 single_pathway=single, out_dtype=jdt, impl="pallas")
    got = tpp.device_preprocess(torch.from_numpy(x), MEAN, STD, flips=flips,
                                alpha=alpha, single_pathway=single, out_dtype=tdt)
    assert len(got) == len(want) == (1 if single else 2)
    idx = None if single else tpp.slow_index(shape[1], alpha)
    for g, w, m in zip(got, want, _terms(x, flips, idx=idx)):
        assert g.dtype == tdt
        assert_within_one_ulp(g, w, m)


@pytest.mark.parametrize("arch", ["slowfast", "slow"])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_step_preprocess_matches_jax(arch, reverse, compute):
    """Channel reverse and the pathway split as the eval step does them."""
    from slowfast_tpu_torch.config import get_cfg
    from slowfast_tpu_torch.engine.steps import maybe_device_preprocess

    x = _clip(SHAPES[1], 2)
    cfgs = []
    for cfg in (jax_get_cfg(), get_cfg()):
        cfg.MODEL.ARCH = arch
        cfg.SLOWFAST.ALPHA = 4
        cfg.DATA.MEAN, cfg.DATA.STD = MEAN, STD
        cfg.DATA.REVERSE_INPUT_CHANNEL = reverse
        cfg.TPU.COMPUTE_DTYPE = compute
        cfgs.append(cfg)
    want = _maybe_device_preprocess(cfgs[0], [jnp.asarray(x)])
    got = maybe_device_preprocess(cfgs[1], [torch.from_numpy(x)])
    assert len(got) == len(want) == (2 if arch == "slowfast" else 1)
    idx = tpp.slow_index(x.shape[1], 4) if arch == "slowfast" else None
    for g, w, m in zip(got, want, _terms(x, reverse=reverse, idx=idx)):
        assert_within_one_ulp(g, w, m)


def test_flip_and_reverse_together():
    """Both options at once: JAX flip + pathway split, then the channel
    reverse that its eval step applies."""
    x = _clip(SHAPES[0], 3)
    flips = np.array([1, 0])
    want = jpp.device_preprocess(x, MEAN, STD, flips=flips, alpha=4,
                                 out_dtype=jnp.float32, impl="xla")
    got = tpp.device_preprocess(torch.from_numpy(x), MEAN, STD, flips=flips, alpha=4,
                                out_dtype=torch.float32, reverse_channels=True)
    terms = _terms(x, flips, reverse=True, idx=tpp.slow_index(x.shape[1], 4))
    for g, w, m in zip(got, want, terms):
        assert_within_one_ulp(g, np.asarray(w)[..., ::-1], m)


def test_cpu_tensors_take_the_plain_version():
    """CPU tensors never reach the kernel: the launch count does not move."""
    before = tpp.launches
    x = torch.from_numpy(_clip(SHAPES[0], 4))
    tpp.device_preprocess(x, MEAN, STD, alpha=4)
    tpp.normalize_clips(x, MEAN, STD)
    assert tpp.launches == before


def test_rejects_bad_inputs():
    with pytest.raises(ValueError):
        tpp.device_preprocess(torch.zeros((1, 2, 3, 4, 3)), MEAN, STD)
    with pytest.raises(ValueError):
        tpp.device_preprocess(torch.zeros((1, 2, 3, 4, 3), dtype=torch.uint8), MEAN, STD,
                              out_dtype=torch.float16)
    with pytest.raises(ValueError):
        tpp.device_preprocess(torch.zeros((1, 2, 3, 4, 3), dtype=torch.uint8, device="meta"),
                              MEAN, STD)
