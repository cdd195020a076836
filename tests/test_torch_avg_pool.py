"""The port's average pool and its deterministic backward against the JAX
package's, on the CPU.

``avg_pool3d_bwd_plain`` (the sums that ``csrc/avg_pool3d_bwd.cu`` takes
on the card, added in the kernel's order of the windows; ``chip_smoke.py``
holds the kernel to it) and ``models.common.avg_pool3d``'s autograd against
``jax.vjp`` of ``slowfast_tpu.models.common.avg_pool3d`` (flax's
``nn.avg_pool``, padding counted) and against ATen's CPU backward, at the
pools the port's models take: a CNN head's whole-map pool in training (one
window), the test crop's 7 x 7 pool at stride 1 on an 8 x 8 map (windows
overlap), X3D-M's head pool, and MViT's ``MODE avg`` pools with ``k // 2``
padding, one with a time axis shorter than the kernel; then
``ResNetBasicHead`` and ``X3DHead`` end to end against the JAX heads on the
same weights.

Tolerances. fp32 and float64: the port divides each term and adds in the
kernel's order, which is ATen's CPU order (bit-equal), and XLA sums the
same few terms in its own order: within 1e-6 of max |grad|. bf16: the
helper pools in fp32 and rounds the gradient once to bf16, so the port is
the fp32 VJP of the same bf16 values rounded once (bit-equal where XLA
adds in the same order, as at every case here); JAX's bf16 VJP divides and
adds in bf16, one rounding of at most half an ulp of a value no larger
than the sum of the terms' magnitudes for each of its divisions and adds:
within ``(n + 1)`` bf16 ulps of that sum for ``n`` terms. The heads in fp32:
the same pools, a linear and a softmax summed in other orders, within 1e-5
of each output's and each gradient's max.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from slowfast_tpu.models import heads as jheads
from slowfast_tpu.models.common import avg_pool3d as jax_avg_pool3d
from slowfast_tpu_torch.models import heads as theads
from slowfast_tpu_torch.models.common import avg_pool3d
from slowfast_tpu_torch.ops import avg_pool
from slowfast_tpu_torch.utils.checkpoint import state_dict_from_jax
from test_torch_blocks import J_NORM, T_NORM, jax_variables

# (name, input (N, T, H, W, C), kernel, stride, padding)
CASES = [
    ("head_train", (2, 4, 7, 7, 16), (4, 7, 7), (1, 1, 1), (0, 0, 0)),
    ("head_fast_train", (2, 8, 7, 7, 4), (8, 7, 7), (1, 1, 1), (0, 0, 0)),
    ("head_test_crop", (2, 1, 8, 8, 8), (1, 7, 7), (1, 1, 1), (0, 0, 0)),
    ("x3d_head", (2, 4, 5, 5, 12), (4, 5, 5), (1, 1, 1), (0, 0, 0)),
    ("mvit_q_short_t", (1, 2, 9, 9, 4), (3, 3, 3), (1, 2, 2), (1, 1, 1)),
    ("mvit_kv", (1, 3, 10, 10, 6), (3, 3, 3), (1, 4, 4), (1, 1, 1)),
    ("mvit_unit_odd_c", (2, 3, 7, 5, 5), (3, 3, 3), (1, 1, 1), (1, 1, 1)),
]
IDS = [c[0] for c in CASES]


def out_shape(case):
    _, shape, kernel, stride, padding = case
    return (shape[0], *[(shape[1 + a] + 2 * padding[a] - kernel[a]) // stride[a] + 1
                        for a in range(3)], shape[4])


def inputs(case, seed):
    rs = np.random.RandomState(seed)
    return rs.randn(*case[1]), rs.randn(*out_shape(case))


def port_vjp(x, dy, case, dtype):
    _, _, kernel, stride, padding = case
    xt = torch.tensor(x, dtype=dtype, requires_grad=True)
    y = avg_pool3d(xt, kernel, stride, padding)
    (gx,) = torch.autograd.grad(y, xt, torch.tensor(dy, dtype=dtype))
    return y.detach(), gx


def jax_vjp(x, dy, case, dtype):
    _, _, kernel, stride, padding = case
    y, vjp = jax.vjp(lambda v: jax_avg_pool3d(v, kernel, stride, padding), jnp.asarray(x, dtype))
    (gx,) = vjp(jnp.asarray(dy, dtype))
    return np.asarray(y.astype(jnp.float32)), np.asarray(gx.astype(jnp.float32))


def padded_plain(dy, case, dtype=torch.float64):
    """``avg_pool3d_bwd_plain`` on the zero-padded input, unpadded."""
    _, shape, kernel, stride, padding = case
    n, t, h, w, c = shape
    pt, ph, pw = padding
    g = avg_pool.avg_pool3d_bwd_plain(torch.as_tensor(dy, dtype=dtype),
                                      (n, t + 2 * pt, h + 2 * ph, w + 2 * pw, c), kernel, stride)
    return g[:, pt:pt + t, ph:ph + h, pw:pw + w]


def bf16_ulp(v):
    """One bf16 ulp at each |v| (0 where v is 0): 8 significant bits."""
    v = np.abs(v)
    return np.where(v > 0, 2.0 ** (np.floor(np.log2(np.where(v > 0, v, 1.0))) - 7), 0.0)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_fp32_against_jax(case):
    x, dy = inputs(case, 0)
    y, gx = port_vjp(x, dy, case, torch.float32)
    jy, jgx = jax_vjp(x, dy, case, jnp.float32)
    assert np.abs(y.numpy() - jy).max() <= 1e-6 * np.abs(jy).max()
    assert np.abs(gx.numpy() - jgx).max() <= 1e-6 * np.abs(jgx).max()


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_bf16_against_jax(case):
    x, dy = inputs(case, 1)
    x = torch.tensor(x, dtype=torch.bfloat16).double().numpy()  # bf16 values
    dy = torch.tensor(dy, dtype=torch.bfloat16).double().numpy()
    y, gx = port_vjp(x, dy, case, torch.bfloat16)
    assert gx.dtype == torch.bfloat16
    _, jgx32 = jax_vjp(x, dy, case, jnp.float32)
    np.testing.assert_array_equal(gx.float().numpy(),
                                  torch.tensor(jgx32).to(torch.bfloat16).float().numpy())
    _, jgx = jax_vjp(x, dy, case, jnp.bfloat16)
    terms = padded_plain(np.ones_like(dy), case).numpy() * np.prod(case[2])
    sum_abs = padded_plain(np.abs(dy), case).numpy()
    assert (np.abs(gx.float().numpy() - jgx) <= (terms + 1) * bf16_ulp(sum_abs)).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["fp32", "float64"])
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_against_aten_and_autograd(case, dtype):
    """ATen's CPU backward of the same zero-padded pool, bit for bit; the
    Function's backward is the plain version; no kernel launch on the
    CPU."""
    _, shape, kernel, stride, padding = case
    x, dy = inputs(case, 2)
    before = avg_pool.bwd_launches
    y, gx = port_vjp(x, dy, case, dtype)
    assert avg_pool.bwd_launches == before and gx.dtype == dtype
    pt, ph, pw = padding
    xa = F.pad(torch.tensor(x, dtype=dtype).permute(0, 4, 1, 2, 3), (pw, pw, ph, ph, pt, pt))
    xa.requires_grad_()
    ya = F.avg_pool3d(xa, kernel, stride)
    (ga,) = torch.autograd.grad(ya, xa, torch.tensor(dy, dtype=dtype).permute(0, 4, 1, 2, 3))
    ga = ga[:, :, pt:pt + shape[1], ph:ph + shape[2], pw:pw + shape[3]].permute(0, 2, 3, 4, 1)
    assert torch.equal(y, ya.detach().permute(0, 2, 3, 4, 1))
    assert torch.equal(gx, ga)
    assert torch.equal(gx, padded_plain(dy, case, dtype))


def test_strided_gradient_and_refusals():
    """The backward reads a non-contiguous output gradient as it is; the
    wrapper refuses a bf16 gradient (the helper pools in fp32)."""
    case = CASES[4]
    _, dy = inputs(case, 3)
    g = torch.tensor(dy, dtype=torch.float32)
    strided = torch.stack([g, torch.zeros_like(g)], dim=-1).flatten(-2)[..., ::2]
    assert not strided.is_contiguous() and torch.equal(strided, g)
    assert torch.equal(padded_plain(strided, case, torch.float32),
                       padded_plain(g, case, torch.float32))
    with pytest.raises(ValueError, match="takes"):
        avg_pool._launch_bwd(g.bfloat16(), (1, 4, 11, 11, 4), (3, 3, 3), (1, 2, 2))


def heads_vjp(jm, tm, xs, seed):
    """Both heads in eval mode on the same variables: outputs and the
    gradients of ``sum(out * cot)`` for the inputs and every parameter (the
    JAX ones mapped to the port's names and layouts)."""
    jx = [jnp.asarray(x, jnp.float32) for x in xs]
    v = jax_variables(jm, (jx,), seed)
    out, vjp = jax.vjp(lambda p, ins: jm.apply({**v, "params": p}, ins, train=False),
                       v["params"], jx)
    cot = np.random.RandomState(seed + 1).randn(*out.shape).astype(np.float32)
    jgp, jgx = vjp(jnp.asarray(cot))
    tm.load_state_dict(state_dict_from_jax(v), strict=True)
    tm.eval()
    tx = [torch.tensor(x, dtype=torch.float32, requires_grad=True) for x in xs]
    got = tm(tx)
    got.backward(torch.from_numpy(cot))
    want_p = state_dict_from_jax({**v, "params": jgp})
    pairs = [(got.detach(), out)] + [(t.grad, g) for t, g in zip(tx, jgx)]
    pairs += [(p.grad, want_p[name]) for name, p in tm.named_parameters()]
    for a, b in pairs:
        a, b = a.numpy(), np.asarray(b)
        assert a.shape == b.shape
        assert np.abs(a - b).max() <= 1e-5 * np.abs(b).max()


@pytest.mark.parametrize("size", [7, 8], ids=["train_crop", "test_crop"])
def test_resnet_head_against_jax(size):
    """Two pathways pooled (4, 7, 7) and (8, 7, 7): one window at the train
    crop's 7 x 7 map, 2 x 2 overlapping windows at the test crop's 8 x 8."""
    rs = np.random.RandomState(40 + size)
    xs = [rs.randn(2, 4, size, size, 16), rs.randn(2, 8, size, size, 4)]
    pool = [[4, 7, 7], [8, 7, 7]]
    heads_vjp(jheads.ResNetBasicHead(dim_in=[16, 4], num_classes=10, pool_size=pool),
              theads.ResNetBasicHead(dim_in=[16, 4], num_classes=10, pool_size=pool), xs, 41)


@pytest.mark.parametrize("size", [7, 8], ids=["train_crop", "test_crop"])
def test_x3d_head_against_jax(size):
    """X3D-M's head pool, (T, 7, 7) of the 224 crop's map, on the train and
    the test crop."""
    x = np.random.RandomState(50 + size).randn(2, 4, size, size, 12)
    args = dict(dim_in=12, dim_inner=24, dim_out=32, num_classes=10, pool_size=[4, 7, 7])
    heads_vjp(jheads.X3DHead(norm=J_NORM, **args), theads.X3DHead(norm=T_NORM, **args), [x], 51)
