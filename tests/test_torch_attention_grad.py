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


def _inputs(shape, seed, extreme=False, subnormal=False):
    """q, k, v and the output gradient; with ``extreme``, q rows 0-2 put
    every logit above the clamp at 50 and rows 3-5 make every exp(l - 20)
    underflow (as tests/test_torch_attention.py does); with ``subnormal``,
    every logit lies near -69.5, so that every e = exp(l - 20) is a
    subnormal number in bf16 and in fp32."""
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
    if subnormal:
        q, k = q * 0.05, k * 0.05
        k[..., 0] = 1.0
        q[..., 0] = -69.5
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
    counters = ("flash_bwd_launches", "exact_bwd_launches", "fused_bwd_launches",
                "flash_tc_bwd_launches", "exact_tc_bwd_launches", "fused_tc_bwd_launches")
    before = [getattr(ta, name) for name in counters]
    got = _port_grads(core, [t.float().numpy() for t in (q, k, v, do)], dt)
    want = CORES[core][1](q, k, v, do)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w.float().numpy())
    assert [getattr(ta, name) for name in counters] == before


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


# The bf16 exact backward on the tensor cores
# (csrc/pooled_attention_exact_bwd.cu): the keys kernel's q split and
# scratch, what the wrapper hands the kernels, and the kernels' scheme in
# plain PyTorch.

from test_torch_attention import EDGE_CASES, _padded, stub  # noqa: E402,F401  (stub: a fixture)


@pytest.mark.parametrize("shape, split", [
    # MViTv2-S 16x4 at 16 clips, 8 blocks per SM (1056) wanted: block 0
    # has 7 key chunks x 1 head x 16 clips = 112 blocks, so its 393 q tiles
    # go in 10 slices of 40; block 1 (800 blocks) in 2, block 2 (224) in
    # 5, blocks 4-13 (448) in 3, block 15 (896) in 2; blocks 3 and 14
    # (1600 and 3200 blocks) are not split.
    ((16, 25089, 393, 1, 118, 96), (10, 40)),
    ((16, 6273, 1569, 2, 132, 96), (2, 50)),
    ((16, 6273, 393, 2, 118, 96), (5, 20)),
    ((16, 1569, 1569, 4, 132, 96), (1, 25)),
    ((16, 1569, 393, 4, 118, 96), (3, 9)),
    ((16, 393, 1569, 8, 132, 96), (1, 7)),
    ((16, 393, 393, 8, 118, 96), (2, 4)),
    # small shapes: no more slices than q tiles, none of them empty
    ((2, 131, 13, 2, 24, 16), (3, 1)),
    ((1, 1, 65, 3, 20, 12), (1, 1)),
    ((1, 700, 64, 1, 20, 12), (11, 1)),
    ((1, 4000, 64, 1, 20, 12), (63, 1)),
])
def test_keys_split_plan(shape, split):
    B, Nq, Nk, nh, dq, dv = shape
    n_split, per = ta.keys_split(B, Nq, Nk, nh, sms=132)
    assert (n_split, per) == split
    tiles = -(-Nq // 64)
    assert (n_split - 1) * per < tiles <= n_split * per
    grid = -(-Nk // 64) * nh * B * n_split
    assert grid >= min(8 * 132, -(-Nk // 64) * nh * B * tiles)


def test_exact_bwd_scratch_sizes():
    """Block 0 at 16 clips: 10 slices of fp32 dk and dv, 53.8 MB, and the
    row statistics."""
    n_split, _ = ta.keys_split(16, 25089, 393, 1)
    sizes = ta.exact_bwd_scratch(16, 25089, 393, 1, 118, 96, n_split)
    assert sizes == {"stats": (3, 16, 1, 25089), "dk_part": (10, 16, 393, 1, 118),
                     "dv_part": (10, 16, 393, 1, 96)}
    assert 4 * sum(np.prod(sizes[k]) for k in ("dk_part", "dv_part")) == 53_825_280


@pytest.mark.parametrize("shape", [(2, 131, 13, 2, 24, 16), (16, 25089, 393, 1, 118, 96)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_exact_backward_routes_by_dtype(stub, shape, dtype):
    """bf16 goes to the tensor-core entry point with the padded depths, the
    copy pieces, the q split and its scratch; fp32 to the FMA kernels'
    exact mode; each counts on its own counter."""
    B, Nq, Nk, nh, dq, dv = shape
    dt = getattr(torch, dtype)
    q, k, v, do = (torch.empty(s, dtype=dt) for s in
                   [(B, Nq, nh, dq), (B, Nk, nh, dq), (B, Nk, nh, dv), (B, Nq, nh, dv)])
    grads = ta._launch_bwd(q, k, v, do, exact=True)
    assert [g.shape for g in grads] == [q.shape, k.shape, v.shape]
    (source, symbol, args), = stub.calls
    if dtype == "bfloat16":
        assert (source, symbol) == ("pooled_attention_exact_bwd", "sf_exact_attention_bwd")
        n_split, per = ta.keys_split(B, Nq, Nk, nh, 132)
        assert args[10:22] == (B, Nq, Nk, nh, dq, dv, ta.pad16(dq), ta.pad16(dv),
                               ta.copy_vec((q, k), dq), ta.copy_vec((v, do), dv), n_split, per)
        assert (ta.exact_tc_bwd_launches, ta.exact_bwd_launches) == (1, 0)
    else:
        assert (source, symbol) == ("pooled_attention_bwd", "sf_pooled_attention_bwd")
        assert args[8:15] == (B, Nq, Nk, nh, dq, dv, 1)  # exact
        assert (ta.exact_tc_bwd_launches, ta.exact_bwd_launches) == (0, 1)


def emulate_exact_backward(q, k, v, do, sms=132):
    """The tensor-core backward's scheme in plain PyTorch, on the padded
    operands of the forward's emulation. Rows kernel: per 64-key chunk an
    online row max with the sums behind ``s`` and ``r = Σ dp·p``, rescaled
    when the max grows; then ``dl = round(p (dp - r))`` and ``dq = dl k``.
    Keys kernel: per q
    slice of ``keys_split``, fp32 partial ``dk = dlᵀ q`` and
    ``dv = round(p)ᵀ do`` with rows >= Nq masked; the slices are summed in
    order and rounded once."""
    dt = q.dtype
    B, Nq, nh, dq = q.shape
    Nk, dv = k.shape[1], v.shape[3]
    qf, kf, vf, valid = _padded(q, k, v)
    dof = torch.nn.functional.pad(do.float(), (0, ta.pad16(dv) - dv))
    chunks = range(0, kf.shape[1], 64)

    def chunk(c0):
        l = torch.einsum("bqnc,bknc->bnqk", qf, kf[:, c0:c0 + 64])
        dp = torch.einsum("bqnc,bknc->bnqk", dof, vf[:, c0:c0 + 64])
        return l.masked_fill(~valid[c0:c0 + 64], -float("inf")), dp

    m = torch.full((B, nh, Nq), -float("inf"))
    s = torch.zeros_like(m)
    r = torch.zeros_like(m)
    for c0 in chunks:
        l, dp = chunk(c0)
        m_new = torch.maximum(m, l.amax(-1))
        scale, e = torch.exp(m - m_new), torch.exp(l - m_new[..., None])
        s = s * scale + e.sum(-1)
        r = r * scale + (dp * e).sum(-1)
        m = m_new
    r = r / s
    dq_acc = 0.0
    for c0 in chunks:
        l, dp = chunk(c0)
        p = torch.exp(l - m[..., None]) / s[..., None]
        dl = (p * (dp - r[..., None])).to(dt).float()
        dq_acc = dq_acc + torch.einsum("bnqk,bknc->bqnc", dl, kf[:, c0:c0 + 64])

    n_split, per = ta.keys_split(B, Nq, Nk, nh, sms)
    dk_part, dv_part = [], []
    for sl in range(n_split):
        rows = slice(64 * sl * per, min(Nq, 64 * (sl + 1) * per))
        lt = torch.einsum("bknc,bqnc->bnkq", kf, qf[:, rows])
        dpt = torch.einsum("bknc,bqnc->bnkq", vf, dof[:, rows])
        p = torch.exp(lt - m[:, :, None, rows]) / s[:, :, None, rows]
        p = p.masked_fill(~valid[:, None], 0.0)
        dl = (p * (dpt - r[:, :, None, rows])).to(dt).float()
        dk_part.append(torch.einsum("bnkq,bqnc->bknc", dl, qf[:, rows]))
        dv_part.append(torch.einsum("bnkq,bqnc->bknc", p.to(dt).float(), dof[:, rows]))
    dk_acc, dv_acc = dk_part[0], dv_part[0]
    for a, b in zip(dk_part[1:], dv_part[1:]):
        dk_acc, dv_acc = dk_acc + a, dv_acc + b
    return (dq_acc[..., :dq].to(dt), dk_acc[:, :Nk, :, :dq].to(dt),
            dv_acc[:, :Nk, :, :dv].to(dt))


@pytest.mark.parametrize("shape, extreme", EDGE_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_backward_scheme_matches_exact_bwd_plain(shape, dtype, extreme):
    """The emulated tensor-core backward (padding, masking, the online row
    sum, the q split and its ordered sum) is ``exact_bwd_plain`` within
    summation order (fp32) or the card's bf16 tolerance, 2e-2 of each
    gradient's max."""
    dt = getattr(torch, dtype)
    q, k, v, do = (torch.from_numpy(a).to(dt) for a in _inputs(shape, 9, extreme))
    got = emulate_exact_backward(q, k, v, do)
    want = ta.exact_bwd_plain(q, k, v, do)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype and torch.isfinite(g).all()
        g, w = g.float().numpy(), w.float().numpy()
        if dtype == "float32":
            np.testing.assert_allclose(g, w, atol=FP32_ATOL, rtol=FP32_RTOL)
        else:
            assert np.abs(g - w).max() <= 2e-2 * np.abs(w).max()


# The bf16 constant-shift backwards on the tensor cores
# (csrc/pooled_attention_flash_bwd.cu: the flash core's, which recomputes e,
# and the fused core's, which reads it): what the wrapper hands the kernels,
# and the kernels' scheme in plain PyTorch.

@pytest.mark.parametrize("shape", [(2, 131, 13, 2, 24, 16), (16, 1569, 393, 4, 118, 96)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("core", CONSTANT_SHIFT)
def test_constant_shift_backward_routes_by_dtype(stub, core, shape, dtype):
    """bf16 goes to the tensor-core entry points (recompute or read e) with
    the padded depths, the copy pieces and the q split; fp32 to the FMA
    kernels; each counts on its own counter."""
    B, Nq, Nk, nh, dq, dv = shape
    dt = getattr(torch, dtype)
    q, k, v, do = (torch.empty(s, dtype=dt) for s in
                   [(B, Nq, nh, dq), (B, Nk, nh, dq), (B, Nk, nh, dv), (B, Nq, nh, dv)])
    e = torch.empty((B, nh, Nq, Nk), dtype=dt)
    if core == "flash":
        grads = ta._launch_bwd(q, k, v, do, exact=False)
    else:
        grads = ta._launch_fused_bwd(q, k, v, do, e)
    assert [(g.shape, g.dtype) for g in grads] == [(t.shape, dt) for t in (q, k, v)]
    (source, symbol, args), = stub.calls
    counts = {name: getattr(ta, f"{name}_launches") for name in
              ("flash_bwd", "flash_tc_bwd", "fused_bwd", "fused_tc_bwd")}
    if dtype == "bfloat16":
        assert source == "pooled_attention_flash_bwd"
        assert symbol == f"sf_{core}_attention_bwd_tc"
        read = int(core == "fused")
        assert args[4:4 + read] == ((e.data_ptr(),) if read else ())
        n_split, per = ta.keys_split(B, Nq, Nk, nh, 132)
        assert args[11 + read:23 + read] == (
            B, Nq, Nk, nh, dq, dv, ta.pad16(dq), ta.pad16(dv), ta.copy_vec((q, k), dq),
            ta.copy_vec((v, do), dv), n_split, per)
        assert counts == {"flash_bwd": 0, "fused_bwd": 0, "flash_tc_bwd": 1 - read,
                          "fused_tc_bwd": read}
    elif core == "flash":
        assert (source, symbol) == ("pooled_attention_bwd", "sf_pooled_attention_bwd")
        assert args[8:15] == (B, Nq, Nk, nh, dq, dv, 0)  # not exact
        assert counts == {"flash_bwd": 1, "fused_bwd": 0, "flash_tc_bwd": 0, "fused_tc_bwd": 0}
    else:
        assert (source, symbol) == ("pooled_attention_fused_bwd",
                                    "sf_pooled_attention_fused_bwd")
        assert args[9:15] == (B, Nq, Nk, nh, dq, dv)
        assert counts == {"flash_bwd": 0, "fused_bwd": 1, "flash_tc_bwd": 0, "fused_tc_bwd": 0}


def test_flash_bwd_scratch_sizes():
    """Block 0 at 16 clips: r / s per row, do_n in do's layout, and 10
    slices of fp32 dk and dv (53.8 MB), as the exact backward's."""
    n_split, _ = ta.keys_split(16, 25089, 393, 1)
    sizes = ta.flash_bwd_scratch(16, 25089, 393, 1, 118, 96, n_split)
    assert sizes == {"rs": ((16, 1, 25089), torch.float32),
                     "do_n": ((16, 25089, 1, 96), torch.bfloat16),
                     "dk_part": ((10, 16, 393, 1, 118), torch.float32),
                     "dv_part": ((10, 16, 393, 1, 96), torch.float32)}
    parts = [np.prod(sizes[k][0]) for k in ("dk_part", "dv_part")]
    assert 4 * sum(parts) == 53_825_280


def test_fused_tc_backward_refuses_an_unaligned_e(stub):
    """The read mode stages e from 16-byte aligned windows, so e's base must
    be 16-byte aligned."""
    shape = (1, 7, 5, 1, 8, 8)
    B, Nq, Nk, nh, dq, dv = shape
    q, k, v, do = (torch.zeros(s, dtype=torch.bfloat16) for s in
                   [(B, Nq, nh, dq), (B, Nk, nh, dq), (B, Nk, nh, dv), (B, Nq, nh, dv)])
    e = torch.zeros(B * nh * Nq * Nk + 1, dtype=torch.bfloat16)[1:].view(B, nh, Nq, Nk)
    with pytest.raises(ValueError, match="16-byte aligned"):
        ta._launch_fused_bwd(q, k, v, do, e)
    assert not stub.calls


def emulate_flash_backward(q, k, v, do, e=None, sms=132):
    """The tensor-core constant-shift backward's scheme in plain PyTorch, on
    padded operands; with ``e`` (the saved-e forward's) the read mode, else
    ``e = round(exp(min(l, 50) - 20))`` recomputed. Rows kernel, three
    passes over the 64-key chunks (keys >= Nk masked): ``s = max(Σe,
    1e-30)``, then ``do_n = round(do / s)`` with the final ``s``; ``r =
    Σ dpn·e``; ``dl = round(e (dpn - r / s))`` and ``dq = dl k``. Keys
    kernel: per q slice of ``keys_split``, fp32 partial ``dk = dlᵀ q`` and
    ``dv = eᵀ do_n`` from the transposed products and the stored ``r / s``;
    the slices are summed in order and rounded once."""
    dt = q.dtype
    B, Nq, nh, dq = q.shape
    Nk, dv = k.shape[1], v.shape[3]
    qf, kf, vf, valid = _padded(q, k, v)
    nkp = kf.shape[1]
    ef = None if e is None else torch.nn.functional.pad(e.float(), (0, nkp - Nk))

    def e_rows(c0):  # (B, nh, Nq, 64)
        if ef is not None:
            x = ef[..., c0:c0 + 64]
        else:
            l = torch.einsum("bqnc,bknc->bnqk", qf, kf[:, c0:c0 + 64])
            x = torch.exp(torch.clamp(l, max=50.0) - 20.0).to(dt).float()
        return x.masked_fill(~valid[c0:c0 + 64], 0.0)

    chunks = range(0, nkp, 64)
    s = sum(e_rows(c0).sum(-1) for c0 in chunks)
    s = torch.clamp(s, min=1e-30)  # (B, nh, Nq)
    do_n = (do.float() / s.permute(0, 2, 1)[..., None]).to(dt).float()
    dnf = torch.nn.functional.pad(do_n, (0, ta.pad16(dv) - dv))

    def dpn(c0):
        return torch.einsum("bqnc,bknc->bnqk", dnf, vf[:, c0:c0 + 64])

    rs = sum((dpn(c0) * e_rows(c0)).sum(-1) for c0 in chunks) / s
    dq_acc = 0.0
    for c0 in chunks:
        dl = (e_rows(c0) * (dpn(c0) - rs[..., None])).to(dt).float()
        dq_acc = dq_acc + torch.einsum("bnqk,bknc->bqnc", dl, kf[:, c0:c0 + 64])

    n_split, per = ta.keys_split(B, Nq, Nk, nh, sms)
    dk_acc = dv_acc = 0.0
    for sl in range(n_split):
        rows = slice(64 * sl * per, min(Nq, 64 * (sl + 1) * per))
        if ef is not None:
            et = ef[:, :, rows].transpose(-1, -2)
        else:
            lt = torch.einsum("bknc,bqnc->bnkq", kf, qf[:, rows])
            et = torch.exp(torch.clamp(lt, max=50.0) - 20.0).to(dt).float()
        et = et.masked_fill(~valid[:, None], 0.0)
        dpt = torch.einsum("bknc,bqnc->bnkq", vf, dnf[:, rows])
        dl = (et * (dpt - rs[:, :, None, rows])).to(dt).float()
        dk_acc = dk_acc + torch.einsum("bnkq,bqnc->bknc", dl, qf[:, rows])
        dv_acc = dv_acc + torch.einsum("bnkq,bqnc->bknc", et, dnf[:, rows])
    return (dq_acc[..., :dq].to(dt), dk_acc[:, :Nk, :, :dq].to(dt),
            dv_acc[:, :Nk, :, :dv].to(dt))


# The edge cases of the tiling, and one whose every e is subnormal (bf16
# and fp32).
FLASH_CASES = EDGE_CASES + [pytest.param(SHAPES["long_k"], "subnormal", id="long_k-subnormal")]


@pytest.mark.parametrize("shape, extreme", FLASH_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("core", CONSTANT_SHIFT)
def test_constant_shift_backward_scheme(core, shape, dtype, extreme):
    """The emulated tensor-core backward (padding, masking, the three row
    passes with do_n rounded with the final s, the q split and its ordered
    sum) is the plain backward (``flash_bwd_plain``, or ``fused_bwd_plain``
    on the saved-e forward's e) and, on the cases without extreme logits,
    the JAX package's Pallas VJP within summation order (fp32) or 2e-2 of
    each gradient's max (bf16); rows whose every exp underflows get a zero
    dq."""
    dt = getattr(torch, dtype)
    arrays = _inputs(shape, 11, extreme is True, subnormal=extreme == "subnormal")
    q, k, v, do = (torch.from_numpy(a).to(dt) for a in arrays)
    e = None if core == "flash" else ta.fused_plain(q, k, v)[1]
    got = emulate_flash_backward(q, k, v, do, e)
    want = ta.flash_bwd_plain(q, k, v, do) if e is None else ta.fused_bwd_plain(q, k, v, do, e)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype and torch.isfinite(g).all()
    got = [g.float().numpy() for g in got]
    refs = [[w.float().numpy() for w in want]]
    if not extreme:  # the extreme rows' plain backward meets the VJP above
        refs.append(_jax_grads(core, arrays, getattr(jnp, dtype)))
    for ref in refs:
        for g, w in zip(got, ref):
            assert np.abs(w).max() > 0.0
            if dtype == "float32":
                np.testing.assert_allclose(g, w, atol=FP32_ATOL, rtol=FP32_RTOL)
            else:
                assert np.abs(g - w).max() <= 2e-2 * np.abs(w).max()
    if extreme is True:
        assert np.abs(got[0][:, 3:6]).max() == 0.0
