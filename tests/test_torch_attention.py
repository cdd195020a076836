"""The port's pooled-attention cores against the JAX package's.

On the CPU the wrappers run their plain PyTorch versions, which is what the
CUDA kernels are held against on the card. Here they meet the JAX package's
Pallas kernels in interpret mode (``flash_pooled_attention``,
``fused_pooled_attention`` and ``pooled_attention``) and the XLA core
``models/attention._attention_core``, on the same seeded numpy inputs.

Tolerances: fp32 atol/rtol 2e-5 (the sums are taken in another order). bf16
atol/rtol 1e-2, about one bf16 ulp of the output, against the Pallas
function with the same rounding. In bf16 the XLA core sums the unrounded
``e`` while the flash kernel sums it rounded, so it is compared in fp32 only.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slowfast_tpu.models.attention import _attention_core
from slowfast_tpu.ops import pallas_attention as jpa
from slowfast_tpu_torch.ops import attention as ta

FP32_TOL, BF16_TOL = 2e-5, 1e-2
SHAPES = {
    # (B, Nq, Nk, nh, dq, dv): ragged q tile and odd widths, as
    # tests/test_pallas_attention.py:59 uses; and Nk beyond one 64-key chunk.
    "ragged": (2, 131, 13, 2, 24, 16),
    "long_k": (1, 70, 200, 2, 20, 12),
}
CORES = {
    "flash": (ta.flash_pooled_attention, jpa.flash_pooled_attention),
    "exact": (ta.pooled_attention, jpa.pooled_attention),
    "fused": (ta.fused_pooled_attention, jpa.fused_pooled_attention),
}
CONSTANT_SHIFT = ("flash", "fused")


def _inputs(shape, seed, extreme=False):
    B, Nq, Nk, nh, dq, dv = shape
    rng = np.random.RandomState(seed)
    q = rng.normal(0.0, 0.6, (B, Nq, nh, dq)).astype(np.float32)
    k = rng.normal(0.0, 0.6, (B, Nk, nh, dq)).astype(np.float32)
    v = rng.normal(0.0, 1.0, (B, Nk, nh, dv)).astype(np.float32)
    if extreme:
        # Channel 0 of k is in [1, 2]; q rows 0-2 get +100 there (every
        # logit above the clamp at 50) and rows 3-5 get -200 (every
        # exp(l - 20) underflows to 0 in fp32).
        k[..., 0] = 1.0 + rng.uniform(0.0, 1.0, k[..., 0].shape)
        q[:, 0:3, :, 0] = 100.0
        q[:, 3:6, :, 0] = -200.0
    return q, k, v


def _port(fn, arrays, dtype):
    out = fn(*(torch.from_numpy(a).to(dtype) for a in arrays))
    assert out.dtype == dtype
    return out.float().numpy()


def _jax(fn, arrays, dtype, **kw):
    out = fn(*(jnp.asarray(a, dtype) for a in arrays), **kw)
    assert out.dtype == dtype
    return np.asarray(out.astype(jnp.float32))


@pytest.mark.parametrize("shape", SHAPES.values(), ids=SHAPES.keys())
@pytest.mark.parametrize("core", CORES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_core_matches_pallas(core, shape, dtype):
    port_fn, jax_fn = CORES[core]
    arrays = _inputs(shape, 0)
    tol = FP32_TOL if dtype == "float32" else BF16_TOL
    got = _port(port_fn, arrays, getattr(torch, dtype))
    want = _jax(jax_fn, arrays, getattr(jnp, dtype), block_q=128, interpret=True)
    assert got.shape == shape[:2] + (shape[3], shape[5])
    np.testing.assert_allclose(got, want, atol=tol, rtol=tol)


@pytest.mark.parametrize("shape", SHAPES.values(), ids=SHAPES.keys())
@pytest.mark.parametrize("core", CORES)
def test_core_matches_xla_core_fp32(core, shape):
    """Both cores compute softmax(q kᵀ) v; in fp32 they agree with the XLA
    core of the default JAX path."""
    arrays = _inputs(shape, 1)
    got = _port(CORES[core][0], arrays, torch.float32)
    want = _jax(_attention_core, arrays, jnp.float32)
    np.testing.assert_allclose(got, want, atol=FP32_TOL, rtol=FP32_TOL)


@pytest.mark.parametrize("core", CORES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_clamped_and_underflowing_rows(core, dtype):
    """Rows whose logits all exceed 50 and rows whose exp(l - 20) all
    underflow: the same finite output as JAX, and zero rows for the
    constant-shift core, which has no row max to rescue them."""
    shape = SHAPES["long_k"]
    arrays = _inputs(shape, 2, extreme=True)
    port_fn, jax_fn = CORES[core]
    tol = FP32_TOL if dtype == "float32" else BF16_TOL
    got = _port(port_fn, arrays, getattr(torch, dtype))
    want = _jax(jax_fn, arrays, getattr(jnp, dtype), block_q=128, interpret=True)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=tol, rtol=tol)
    if core in CONSTANT_SHIFT:
        np.testing.assert_array_equal(got[:, 3:6], 0.0)
        assert np.abs(got[:, 0:3]).max() > 0.0
        if dtype == "float32":
            xla = _jax(_attention_core, arrays, jnp.float32)
            np.testing.assert_allclose(got, xla, atol=FP32_TOL, rtol=FP32_TOL)


def test_cpu_runs_the_plain_version_and_counts_no_launch():
    arrays = [torch.from_numpy(a) for a in _inputs(SHAPES["ragged"], 3)]
    before = (ta.flash_launches, ta.exact_launches, ta.fused_launches)
    assert torch.equal(ta.flash_pooled_attention(*arrays), ta.flash_plain(*arrays))
    assert torch.equal(ta.pooled_attention(*arrays), ta.exact_plain(*arrays))
    assert torch.equal(ta.fused_pooled_attention(*arrays), ta.fused_plain(*arrays)[0])
    assert (ta.flash_launches, ta.exact_launches, ta.fused_launches) == before


@pytest.mark.parametrize("fn", [ta.flash_pooled_attention, ta.pooled_attention,
                                ta.fused_pooled_attention])
def test_wrappers_raise_instead_of_falling_back(fn):
    """Off the CPU the wrappers launch their kernel or raise; wrong shapes
    and dtypes raise everywhere."""
    q, k, v = (torch.empty(s, device="meta") for s in
               [(1, 5, 2, 8), (1, 3, 2, 8), (1, 3, 2, 4)])
    with pytest.raises(ValueError, match="no pooled-attention kernel"):
        fn(q, k, v)
    with pytest.raises(ValueError, match="mismatched"):
        fn(torch.zeros(1, 5, 2, 8), torch.zeros(1, 3, 2, 7), torch.zeros(1, 3, 2, 4))
    with pytest.raises(ValueError, match="dtype"):
        fn(torch.zeros(1, 5, 2, 8), torch.zeros(1, 3, 2, 8),
           torch.zeros(1, 3, 2, 4, dtype=torch.bfloat16))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_saved_e_matches_the_pallas_residual(dtype):
    """The port's saved ``e`` equals the ``e16`` residual of
    ``_fused_attention_fwd`` (the same ``(B, nh, Nq, Nk)`` layout) within one
    bf16 ulp, and its output is the JAX kernel's."""
    B, Nq, Nk, nh, dq, dv = SHAPES["long_k"]
    q, k, v = _inputs(SHAPES["long_k"], 4)
    out, e = ta.fused_plain(*(torch.from_numpy(a).to(getattr(torch, dtype)) for a in (q, k, v)))
    assert e.shape == (B, nh, Nq, Nk) and e.dtype == getattr(torch, dtype)
    lanes = jpa.LANES
    dqp, dvp = dq + (-dq) % lanes, dv + (-dv) % lanes
    flat = [jpa._pad_to(jnp.asarray(a, getattr(jnp, dtype)), 3, lanes).reshape(B, n, nh * d)
            for a, n, d in ((q, Nq, dqp), (k, Nk, dqp), (v, Nk, dvp))]
    bq = jpa._fused_block_q(Nk, 128, jnp.dtype(getattr(jnp, dtype)).itemsize)
    jax_out, (_, _, _, e16) = jpa._fused_attention_fwd(*flat, nh, bq, True)
    want = np.asarray(e16.astype(jnp.float32))
    got = e.float().numpy()
    bf16_ulp = np.ldexp(1.0, np.frexp(np.abs(want))[1] - 8)
    assert (np.abs(got - want) <= bf16_ulp).all()
    jax_out = np.asarray(jax_out.astype(jnp.float32)).reshape(B, Nq, nh, dvp)[..., :dv]
    tol = FP32_TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(out.float().numpy(), jax_out, atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_plain_is_the_flash_plain_bitwise(dtype):
    """The saved-e forward and backward compute the constant-shift core's
    function with its roundings: bit-equal to the flash plain versions."""
    dt = getattr(torch, dtype)
    B, Nq, Nk, nh, dq, dv = SHAPES["ragged"]
    q, k, v = (torch.from_numpy(a).to(dt) for a in _inputs(SHAPES["ragged"], 5))
    do = torch.from_numpy(np.random.RandomState(6).normal(0.0, 1.0, (B, Nq, nh, dv))).to(dt)
    out, e = ta.fused_plain(q, k, v)
    assert torch.equal(out, ta.flash_plain(q, k, v))
    for got, want in zip(ta.fused_bwd_plain(q, k, v, do, e), ta.flash_bwd_plain(q, k, v, do)):
        assert got.dtype == want.dtype and torch.equal(got, want)
