"""The port's max pool and its deterministic backward against the JAX
package's, on the CPU.

``max_pool3d_bwd_plain`` (the gather that ``csrc/max_pool3d_bwd.cu`` does
on the card, in the kernel's order of the windows; ``chip_smoke.py`` holds
the kernel to it) against ``jax.vjp`` of
``slowfast_tpu.models.common.max_pool3d`` and against ATen's CPU backward,
at every pool shape the port's models use: the ResNet stem's
(1,3,3)/(1,2,2)/(0,1,1), the pathway pools (2,1,1), non-local's (1,2,2),
MViT's ``k // 2``-padded query and key/value pools and its residual pools,
on odd sizes and on integer-valued inputs full of ties (the first maximum
of a window wins, in both frameworks).

Tolerances. fp32: both sum the same few fp32 terms, in their own order:
within 1e-6 of max |grad| (ATen's CPU backward adds in the kernel's order:
bit-equal). bf16: the port sums in fp32 and rounds once, the JAX VJP adds
in bf16 (``video_conv.py:464-514``), so the port is JAX's fp32 VJP of the
same values rounded once to bf16 (bit-equal), and JAX's bf16 VJP lies
within one bf16 ulp of the sum of the magnitudes of its terms from the
port's (``bf16_ulp``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from slowfast_tpu.models.common import max_pool3d as jax_max_pool3d
from slowfast_tpu_torch.models.common import max_pool3d
from slowfast_tpu_torch.ops import max_pool

# (name, input (N, T, H, W, C), kernel, stride, padding)
CASES = [
    ("stem", (2, 3, 17, 15, 5), (1, 3, 3), (1, 2, 2), (0, 1, 1)),
    ("stem_even", (1, 2, 16, 16, 8), (1, 3, 3), (1, 2, 2), (0, 1, 1)),
    ("pathway_pool", (2, 6, 5, 7, 3), (2, 1, 1), (2, 1, 1), (0, 0, 0)),
    ("pathway_pool_odd_t", (1, 5, 4, 4, 3), (2, 1, 1), (2, 1, 1), (0, 0, 0)),
    ("nonlocal", (2, 3, 9, 7, 4), (1, 2, 2), (1, 2, 2), (0, 0, 0)),
    ("mvit_q", (1, 4, 9, 9, 4), (3, 3, 3), (1, 2, 2), (1, 1, 1)),
    ("mvit_q_unit", (1, 3, 7, 5, 4), (3, 3, 3), (1, 1, 1), (1, 1, 1)),
    ("mvit_kv", (1, 4, 17, 17, 4), (3, 3, 3), (1, 8, 8), (1, 1, 1)),
    ("mvit_kv_4", (1, 5, 11, 13, 3), (3, 3, 3), (1, 4, 4), (1, 1, 1)),
    ("mvit_skip", (2, 2, 9, 11, 6), (1, 3, 3), (1, 2, 2), (0, 1, 1)),
    ("strided_t", (1, 7, 7, 7, 2), (3, 3, 3), (2, 2, 2), (1, 1, 1)),
]
IDS = [c[0] for c in CASES]


def inputs(case, seed, ties):
    """``x`` (integer-valued with ``ties``, so windows hold equal maxima)
    and an output gradient, float64 numpy."""
    _, shape, kernel, stride, padding = case
    rs = np.random.RandomState(seed)
    x = rs.randint(-3, 4, shape).astype(np.float64) if ties else rs.randn(*shape)
    out = [(shape[1 + a] + 2 * padding[a] - kernel[a]) // stride[a] + 1 for a in range(3)]
    dy = rs.randn(shape[0], *out, shape[4])
    return x, dy


def port_vjp(x, dy, case, dtype):
    _, _, kernel, stride, padding = case
    xt = torch.tensor(x, dtype=dtype, requires_grad=True)
    y = max_pool3d(xt, kernel, stride, padding)
    (gx,) = torch.autograd.grad(y, xt, torch.tensor(dy, dtype=dtype))
    return y.detach(), gx


def jax_vjp(x, dy, case, dtype):
    _, _, kernel, stride, padding = case
    y, vjp = jax.vjp(lambda v: jax_max_pool3d(v, kernel, stride, padding),
                     jnp.asarray(x, dtype))
    (gx,) = vjp(jnp.asarray(dy, dtype))
    return np.asarray(y.astype(jnp.float32)), np.asarray(gx.astype(jnp.float32))


def bf16_ulp(v):
    """One bf16 ulp at each |v| (0 where v is 0): 8 significant bits."""
    v = np.abs(v)
    return np.where(v > 0, 2.0 ** (np.floor(np.log2(np.where(v > 0, v, 1.0))) - 7), 0.0)


def abs_terms(x, dy, case):
    """Per input element, the sum of |grad_out| over the windows it won."""
    _, _, kernel, stride, padding = case
    xt = torch.tensor(x, dtype=torch.float64)
    _, idx = F.max_pool3d(xt.permute(0, 4, 1, 2, 3), kernel, stride, padding,
                          return_indices=True)
    return max_pool.max_pool3d_bwd_plain(torch.tensor(np.abs(dy)), idx.permute(0, 2, 3, 4, 1),
                                         x.shape, kernel, stride, padding).numpy()


@pytest.mark.parametrize("ties", [True, False], ids=["ties", "random"])
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_fp32_against_jax(case, ties):
    x, dy = inputs(case, 0, ties)
    y, gx = port_vjp(x, dy, case, torch.float32)
    jy, jgx = jax_vjp(x, dy, case, jnp.float32)
    np.testing.assert_array_equal(y.numpy(), jy)
    assert np.abs(gx.numpy() - jgx).max() <= 1e-6 * np.abs(jgx).max()


@pytest.mark.parametrize("ties", [True, False], ids=["ties", "random"])
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_bf16_against_jax(case, ties):
    x, dy = inputs(case, 1, ties)
    x = np.asarray(torch.tensor(x, dtype=torch.bfloat16).double())  # bf16 values
    dy = np.asarray(torch.tensor(dy, dtype=torch.bfloat16).double())
    y, gx = port_vjp(x, dy, case, torch.bfloat16)
    jy, jgx = jax_vjp(x, dy, case, jnp.bfloat16)
    np.testing.assert_array_equal(y.float().numpy(), jy)
    # The fp32 sum of the same bf16 terms, rounded once: the port's bits.
    _, jgx32 = jax_vjp(x, dy, case, jnp.float32)
    np.testing.assert_array_equal(gx.float().numpy(),
                                  torch.tensor(jgx32).to(torch.bfloat16).float().numpy())
    tol = bf16_ulp(abs_terms(x, dy, case))
    assert (np.abs(gx.float().numpy() - jgx) <= tol).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_against_aten_and_autograd(case, dtype):
    """ATen's CPU backward; autograd through the Function equals the plain
    version on the saved indices; no kernel launch on the CPU."""
    _, shape, kernel, stride, padding = case
    x, dy = inputs(case, 2, True)
    x, dy = torch.tensor(x, dtype=dtype), torch.tensor(dy, dtype=dtype)
    before = max_pool.bwd_launches
    y, gx = port_vjp(x.double().numpy(), dy.double().numpy(), case, dtype)
    assert max_pool.bwd_launches == before
    xa = x.clone().requires_grad_()
    ya = F.max_pool3d(xa.permute(0, 4, 1, 2, 3), kernel, stride, padding)
    (ga,) = torch.autograd.grad(ya, xa, dy.permute(0, 4, 1, 2, 3))
    assert torch.equal(y, ya.detach().permute(0, 2, 3, 4, 1))
    if dtype == torch.float32:
        assert torch.equal(gx, ga)
    else:  # ATen's CPU backward adds in bf16
        tol = bf16_ulp(abs_terms(x.double().numpy(), dy.double().numpy(), case))
        assert ((gx.float() - ga.float()).abs().numpy() <= tol).all()
    _, idx = F.max_pool3d(x.permute(0, 4, 1, 2, 3), kernel, stride, padding,
                          return_indices=True)
    plain = max_pool.max_pool3d_bwd_plain(dy, idx.permute(0, 2, 3, 4, 1), shape, kernel, stride,
                                          padding)
    assert plain.dtype == dtype and torch.equal(gx, plain)


def test_strided_gradient_and_windows():
    """The backward reads a channels-last, non-contiguous output gradient as
    it is; every input position is covered by the windows ``windows`` lists
    and by no other."""
    case = CASES[0]
    _, shape, kernel, stride, padding = case
    x, dy = inputs(case, 3, True)
    xt = torch.tensor(x, dtype=torch.float32, requires_grad=True)
    y = max_pool3d(xt, kernel, stride, padding)
    g = torch.tensor(dy, dtype=torch.float32).permute(0, 4, 1, 2, 3).contiguous()
    (gx,) = torch.autograd.grad(y, xt, g.permute(0, 2, 3, 4, 1), retain_graph=True)  # strided
    (want,) = torch.autograd.grad(y, xt, torch.tensor(dy, dtype=torch.float32))
    assert torch.equal(gx, want)
    for size, k, s, p in [(17, 3, 2, 1), (7, 3, 1, 1), (17, 3, 8, 1), (6, 2, 2, 0), (7, 3, 2, 1)]:
        out = (size + 2 * p - k) // s + 1
        got = {(i, int(o)) for o_t, v_t in max_pool.windows(size, out, k, s, p)
               for i, (o, v) in enumerate(zip(o_t, v_t)) if v}
        want = {(i, o) for i in range(size) for o in range(out) if o * s - p <= i < o * s - p + k}
        assert got == want
