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


# The bf16 exact core on the tensor cores (csrc/pooled_attention_exact.cu):
# what the wrapper hands the kernel, and the kernel's padding and masking
# scheme in plain PyTorch.

MVIT_WIDTHS = [(118, 128), (132, 144), (20, 32), (24, 32), (12, 16), (96, 96), (16, 16)]


@pytest.mark.parametrize("d, padded", MVIT_WIDTHS)
def test_pad16_is_the_shared_memory_depth(d, padded):
    assert ta.pad16(d) == padded


@pytest.mark.parametrize("nh, d, offset, vec", [
    (1, 118, 0, 2),   # MViTv2-S block 0: 236-byte rows, 4-byte pieces
    (2, 118, 0, 2),   # blocks 2-13: a head starts 236 bytes after the last
    (2, 132, 0, 4),   # blocks 1, 3, 14: 264 bytes, 8-byte pieces
    (8, 96, 0, 8),    # v: 192 bytes, 16-byte pieces
    (2, 20, 0, 4),
    (2, 12, 0, 4),
    (2, 21, 0, 1),    # odd depth: 2-byte alignment, plain loads
    (1, 96, 2, 2),    # a base pointer 4 bytes into its storage
])
def test_copy_vec_takes_the_widest_aligned_piece(nh, d, offset, vec):
    storage = torch.zeros(3 * 5 * nh * d + offset, dtype=torch.bfloat16)
    t = storage[offset:].view(3, 5, nh, d)
    assert t.data_ptr() % 16 == (2 * offset) % 16
    assert ta.copy_vec((t,), d) == vec


class _StubLibrary:
    """Records what the wrapper would launch; launches nothing."""

    def __init__(self):
        self.calls = []

    def kernel(self, source, symbol, argtypes):
        def fn(*args):
            assert len(args) == len(argtypes)
            self.calls.append((source, symbol, args))
            return 0
        return fn


@pytest.fixture
def stub(monkeypatch):
    lib = _StubLibrary()
    monkeypatch.setattr(ta, "_kernel", lib.kernel)
    monkeypatch.setattr(ta, "_check_device", lambda t: None)
    monkeypatch.setattr(ta, "_stream", lambda t: 0)
    monkeypatch.setattr(ta, "_sm_count", lambda t: 132)
    for name in ("flash_launches", "exact_launches", "exact_tc_launches", "fused_launches",
                 "flash_bwd_launches", "exact_bwd_launches", "exact_tc_bwd_launches",
                 "flash_tc_bwd_launches", "fused_bwd_launches", "fused_tc_bwd_launches"):
        monkeypatch.setattr(ta, name, 0)
    return lib


@pytest.mark.parametrize("shape", [(2, 131, 13, 2, 24, 16), (1, 70, 200, 2, 20, 12),
                                   (2, 300, 393, 1, 118, 96), (1, 100, 1569, 2, 132, 96)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_exact_forward_routes_by_dtype(stub, shape, dtype):
    """bf16 goes to the tensor-core entry point with the padded depths and
    the copy pieces; fp32 to the FMA kernel's exact mode; each counts on
    its own counter. The flash forward is the FMA kernel in both."""
    B, Nq, Nk, nh, dq, dv = shape
    dt = getattr(torch, dtype)
    q, k, v = (torch.zeros(s, dtype=dt) for s in
               [(B, Nq, nh, dq), (B, Nk, nh, dq), (B, Nk, nh, dv)])
    out = ta._launch(q, k, v, exact=True)
    assert out.shape == (B, Nq, nh, dv) and out.dtype == dt
    ta._launch(q, k, v, exact=False)
    (source, symbol, args), flash = stub.calls
    assert flash[:2] == ("pooled_attention", "sf_pooled_attention") and flash[2][10] == 0
    if dtype == "bfloat16":
        assert (source, symbol) == ("pooled_attention_exact", "sf_exact_attention_fwd")
        assert args[4:14] == (B, Nq, Nk, nh, dq, dv, ta.pad16(dq), ta.pad16(dv),
                              ta.copy_vec((q, k), dq), ta.copy_vec((v,), dv))
        assert (ta.exact_tc_launches, ta.exact_launches) == (1, 0)
    else:
        assert (source, symbol) == ("pooled_attention", "sf_pooled_attention")
        assert args[4:12] == (B, Nq, Nk, nh, dq, dv, 1, 0)  # exact, not bf16
        assert (ta.exact_tc_launches, ta.exact_launches) == (0, 1)
    assert ta.flash_launches == 1


def _chunked_logits(q, k, c0):
    """fp32 logits of every q row against keys [c0, c0 + 64) of the padded
    k, ``(B, nh, Nq, 64)``."""
    return torch.einsum("bqnc,bknc->bnqk", q, k[:, c0:c0 + 64])


def _padded(q, k, v):
    """q, k and v as the tensor-core kernels see them in shared memory:
    fp32 values, depths zero-padded to pad16, keys zero-padded to whole
    64-key chunks; and a key mask, ``(Nk_padded,)``."""
    dq, dv, Nk = q.shape[3], v.shape[3], k.shape[1]
    nkp = -(-Nk // 64) * 64
    qf = torch.nn.functional.pad(q.float(), (0, ta.pad16(dq) - dq))
    kf = torch.nn.functional.pad(k.float(), (0, ta.pad16(dq) - dq, 0, 0, 0, nkp - Nk))
    vf = torch.nn.functional.pad(v.float(), (0, ta.pad16(dv) - dv, 0, 0, 0, nkp - Nk))
    return qf, kf, vf, torch.arange(nkp) < Nk


def emulate_exact_forward(q, k, v):
    """The tensor-core forward's scheme in plain PyTorch: padded depths,
    64-key chunks whose keys >= Nk get -inf logits and zero V rows; pass 1
    the row max, pass 2 ``p = exp(l - m)``, ``s`` from the unrounded ``p``
    and ``o += round(p) v`` per chunk."""
    dt, dv = v.dtype, v.shape[3]
    qf, kf, vf, valid = _padded(q, k, v)
    m = torch.full(q.shape[:1] + (q.shape[2], q.shape[1]), -float("inf"))
    for c0 in range(0, kf.shape[1], 64):
        l = _chunked_logits(qf, kf, c0).masked_fill(~valid[c0:c0 + 64], -float("inf"))
        m = torch.maximum(m, l.amax(-1))
    s = torch.zeros_like(m)
    o = 0.0
    for c0 in range(0, kf.shape[1], 64):
        l = _chunked_logits(qf, kf, c0).masked_fill(~valid[c0:c0 + 64], -float("inf"))
        p = torch.exp(l - m[..., None])
        s = s + p.sum(-1)
        o = o + torch.einsum("bnqk,bknc->bqnc", p.to(dt).float(), vf[:, c0:c0 + 64])
    return (o / s.permute(0, 2, 1)[..., None])[..., :dv].to(dt)


EDGE_SHAPES = {
    # (B, Nq, Nk, nh, dq, dv): every edge of the 64 x 64 tiling
    "nk_below_64": (2, 131, 13, 2, 24, 16),
    "nk_64j_plus_1": (1, 70, 129, 2, 20, 12),
    "nq_1": (2, 1, 65, 3, 20, 12),
    "mvit_block0_like": (1, 97, 200, 1, 118, 96),
}


# Extreme logits need q rows 0-5, so Nq = 1 runs without them.
EDGE_CASES = [pytest.param(shape, extreme, id=f"{name}{'-extreme' if extreme else ''}")
              for name, shape in EDGE_SHAPES.items() for extreme in (False, True)
              if shape[1] >= 6 or not extreme]


@pytest.mark.parametrize("shape, extreme", EDGE_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_padding_and_masking_scheme_matches_exact_plain(shape, dtype, extreme):
    """Zero-padded depths, -inf on the masked keys and zero V rows change
    nothing: the emulated kernel is ``exact_plain`` within summation order
    (fp32) or one bf16 ulp of the output (bf16)."""
    dt = getattr(torch, dtype)
    q, k, v = (torch.from_numpy(a).to(dt) for a in _inputs(shape, 7, extreme))
    got, want = emulate_exact_forward(q, k, v), ta.exact_plain(q, k, v)
    assert got.dtype == want.dtype and torch.isfinite(got).all()
    tol = FP32_TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(got.float().numpy(), want.float().numpy(), atol=tol, rtol=tol)
