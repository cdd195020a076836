"""Gradients of the port's pooled-attention cores against the JAX package's.

On the CPU the ``autograd.Function``s run the plain backwards
(``flash_bwd_plain``, ``fused_bwd_plain``, ``exact_bwd_plain``), which is
what the CUDA backward kernels are held against on the card. Here they meet
``jax.vjp`` of the Pallas functions in interpret mode
(``flash_pooled_attention``, whose backward is ``_flash_bwd_kernel``,
``fused_pooled_attention``, whose backward ``_fused_bwd_kernel`` reads the
saved ``e``, and ``pooled_attention``, whose backward is ``_bwd_kernel``) on
the same seeded numpy inputs and output gradient.

Tolerances: fp32 atol 5e-5 / rtol 5e-4, as
``tests/test_pallas_attention.py``'s gradient parity uses (the sums are
taken in another order). bf16: max abs error within 3e-2 of the max |grad|,
as ``test_attention_core_bf16_gradients_track_fp32`` uses: the rounded
``e``, ``do_n`` and ``dl`` may round the other way where the fp32 values
before them differ in the last bits.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slowfast_tpu.ops import pallas_attention as jpa
from slowfast_tpu_torch.ops import attention as ta

FP32_ATOL, FP32_RTOL, BF16_REL = 5e-5, 5e-4, 3e-2
SHAPES = {
    # (B, Nq, Nk, nh, dq, dv): the ragged q tile and odd widths of
    # tests/test_pallas_attention.py:164; and Nk over one 64-key chunk.
    "ragged": (2, 131, 13, 2, 24, 16),
    "long_k": (1, 70, 200, 2, 20, 12),
}
CORES = {
    "flash": (ta.flash_pooled_attention, ta.flash_bwd_plain, jpa.flash_pooled_attention),
    "exact": (ta.pooled_attention, ta.exact_bwd_plain, jpa.pooled_attention),
    "fused": (ta.fused_pooled_attention,
              lambda q, k, v, do: ta.fused_bwd_plain(q, k, v, do, ta.fused_plain(q, k, v)[1]),
              jpa.fused_pooled_attention),
}
CONSTANT_SHIFT = ("flash", "fused")


def _inputs(shape, seed, extreme=False):
    """q, k, v and the output gradient; with ``extreme``, q rows 0-2 put
    every logit above the clamp at 50 and rows 3-5 make every exp(l - 20)
    underflow (as tests/test_torch_attention.py does)."""
    B, Nq, Nk, nh, dq, dv = shape
    rng = np.random.RandomState(seed)
    q = rng.normal(0.0, 0.6, (B, Nq, nh, dq)).astype(np.float32)
    k = rng.normal(0.0, 0.6, (B, Nk, nh, dq)).astype(np.float32)
    v = rng.normal(0.0, 1.0, (B, Nk, nh, dv)).astype(np.float32)
    do = rng.normal(0.0, 1.0, (B, Nq, nh, dv)).astype(np.float32)
    if extreme:
        k[..., 0] = 1.0 + rng.uniform(0.0, 1.0, k[..., 0].shape)
        q[:, 0:3, :, 0] = 100.0
        q[:, 3:6, :, 0] = -200.0
    return q, k, v, do


def _jax_grads(core, arrays, dtype):
    fn = CORES[core][2]
    q, k, v, do = (jnp.asarray(a, dtype) for a in arrays)
    _, pull = jax.vjp(lambda *a: fn(*a, block_q=128, interpret=True), q, k, v)
    return [np.asarray(g.astype(jnp.float32)) for g in pull(do)]


def _port_grads(core, arrays, dtype):
    """Gradients through the wrapper's ``autograd.Function``."""
    q, k, v, do = (torch.from_numpy(a).to(dtype) for a in arrays)
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    out = CORES[core][0](q, k, v)
    assert out.grad_fn is not None
    grads = torch.autograd.grad(out, (q, k, v), do)
    assert all(g.dtype == dtype for g in grads)
    return [g.float().numpy() for g in grads]


def _assert_close(got, want, dtype):
    for g, w in zip(got, want):
        assert g.shape == w.shape
        if dtype == "float32":
            np.testing.assert_allclose(g, w, atol=FP32_ATOL, rtol=FP32_RTOL)
        else:
            assert np.abs(g - w).max() <= BF16_REL * np.abs(w).max()


@pytest.mark.parametrize("shape", SHAPES.values(), ids=SHAPES.keys())
@pytest.mark.parametrize("core", CORES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_backward_matches_pallas_vjp(core, shape, dtype):
    arrays = _inputs(shape, 0)
    got = _port_grads(core, arrays, getattr(torch, dtype))
    _assert_close(got, _jax_grads(core, arrays, getattr(jnp, dtype)), dtype)


@pytest.mark.parametrize("core", CORES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_autograd_function_is_the_plain_backward(core, dtype):
    """On the CPU the Function's gradients are exactly the plain backward's,
    and no kernel launch is counted."""
    dt = getattr(torch, dtype)
    q, k, v, do = (torch.from_numpy(a).to(dt) for a in _inputs(SHAPES["long_k"], 1))
    before = (ta.flash_bwd_launches, ta.exact_bwd_launches, ta.fused_bwd_launches)
    got = _port_grads(core, [t.float().numpy() for t in (q, k, v, do)], dt)
    want = CORES[core][1](q, k, v, do)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w.float().numpy())
    assert (ta.flash_bwd_launches, ta.exact_bwd_launches, ta.fused_bwd_launches) == before


@pytest.mark.parametrize("core", CORES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_clamped_and_underflowing_rows(core, dtype):
    """Rows whose logits all exceed 50 get the JAX kernel's gradient (no
    derivative of the clamp), rows whose every exp underflows get zeros;
    nothing is NaN."""
    arrays = _inputs(SHAPES["long_k"], 2, extreme=True)
    got = _port_grads(core, arrays, getattr(torch, dtype))
    assert all(np.isfinite(g).all() for g in got)
    _assert_close(got, _jax_grads(core, arrays, getattr(jnp, dtype)), dtype)
    if core in CONSTANT_SHIFT:
        assert np.abs(got[0][:, 3:6]).max() == 0.0  # dq of underflowing rows
        assert np.abs(got[0][:, 0:3]).max() > 0.0  # clamped rows still learn


def test_clamped_rows_differ_from_autograd_of_the_forward():
    """Autograd of ``flash_plain`` gives clamped logits no gradient; the
    JAX kernel's formula, which the Function follows, does."""
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(SHAPES["long_k"], 3, extreme=True))
    q.requires_grad_()
    dq_autograd, = torch.autograd.grad(ta.flash_plain(q, k, v), (q,), do)
    dq_jax_formula, = torch.autograd.grad(ta.flash_pooled_attention(q, k, v), (q,), do)
    assert dq_autograd[:, 0:3].abs().max() == 0.0
    assert dq_jax_formula[:, 0:3].abs().max() > 0.0
    torch.testing.assert_close(dq_autograd[:, 6:], dq_jax_formula[:, 6:], atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("fn", [ta.flash_pooled_attention, ta.pooled_attention,
                                ta.fused_pooled_attention])
def test_backward_raises_instead_of_falling_back(fn):
    """Off the CPU the backward launches its kernel or raises."""
    tensors = [torch.empty(s, device="meta") for s in
               [(1, 5, 2, 8), (1, 3, 2, 8), (1, 3, 2, 4), (1, 5, 2, 4)]]
    with pytest.raises(ValueError, match="no pooled-attention kernel"):
        if fn is ta.fused_pooled_attention:
            ta._launch_fused_bwd(*tensors, torch.empty((1, 2, 5, 3), device="meta"))
        else:
            ta._launch_bwd(*tensors, exact=fn is ta.pooled_attention)
