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
    for name in ("flash_launches", "flash_tc_launches", "exact_launches", "exact_tc_launches",
                 "fused_launches", "fused_tc_launches", "flash_bwd_launches",
                 "exact_bwd_launches", "exact_tc_bwd_launches", "flash_tc_bwd_launches",
                 "fused_bwd_launches", "fused_tc_bwd_launches"):
        monkeypatch.setattr(ta, name, 0)
    return lib


@pytest.mark.parametrize("shape", [(2, 131, 13, 2, 24, 16), (1, 70, 200, 2, 20, 12),
                                   (2, 300, 393, 1, 118, 96), (1, 100, 1569, 2, 132, 96)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_exact_forward_routes_by_dtype(stub, shape, dtype):
    """bf16 goes to the tensor-core entry point with the padded depths and
    the copy pieces; fp32 to the FMA kernel's exact mode; each counts on
    its own counter. The flash forward goes to its tensor-core kernel in
    bf16 and to the FMA kernel in fp32."""
    B, Nq, Nk, nh, dq, dv = shape
    dt = getattr(torch, dtype)
    q, k, v = (torch.zeros(s, dtype=dt) for s in
               [(B, Nq, nh, dq), (B, Nk, nh, dq), (B, Nk, nh, dv)])
    out = ta._launch(q, k, v, exact=True)
    assert out.shape == (B, Nq, nh, dv) and out.dtype == dt
    ta._launch(q, k, v, exact=False)
    (source, symbol, args), flash = stub.calls
    if dtype == "bfloat16":
        assert flash[:2] == ("pooled_attention_flash", "sf_flash_attention_fwd")
    else:
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
    assert ta.flash_launches + ta.flash_tc_launches == 1


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


# The bf16 constant-shift forwards on the tensor cores
# (csrc/pooled_attention_flash.cu): what the wrappers hand the kernel, and
# the kernel's scheme in plain PyTorch.

@pytest.mark.parametrize("shape", [(2, 131, 13, 2, 24, 16), (1, 70, 200, 2, 20, 12),
                                   (2, 300, 393, 1, 118, 96), (1, 100, 1569, 2, 132, 96)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("core", ["flash", "fused"])
def test_constant_shift_forward_routes_by_dtype(stub, shape, dtype, core):
    """bf16 goes to the tensor-core entry point (flash, or saved-e for the
    fused core) with k and v's packed scratch, the real and padded depths
    and the copy pieces; fp32 to the FMA kernel's flash or saved-e mode.
    Each counts on its own counter; the fused core's e is (B, nh, Nq, Nk) in
    v's dtype."""
    B, Nq, Nk, nh, dq, dv = shape
    dt = getattr(torch, dtype)
    q, k, v = (torch.zeros(s, dtype=dt) for s in
               [(B, Nq, nh, dq), (B, Nk, nh, dq), (B, Nk, nh, dv)])
    if core == "flash":
        out = ta._launch(q, k, v, exact=False)
    else:
        out, e = ta._launch_fused(q, k, v)
        assert e.shape == (B, nh, Nq, Nk) and e.dtype == dt
    assert out.shape == (B, Nq, nh, dv) and out.dtype == dt
    (source, symbol, args), = stub.calls
    saved = int(core == "fused")
    counts = (ta.flash_launches, ta.flash_tc_launches, ta.fused_launches, ta.fused_tc_launches)
    if dtype == "bfloat16":
        assert source == "pooled_attention_flash"
        assert symbol == ("sf_flash_attention_fwd_saved_e" if saved else "sf_flash_attention_fwd")
        assert args[3] == out.data_ptr() and (not saved or args[4] == e.data_ptr())
        assert args[6 + saved:16 + saved] == (
            B, Nq, Nk, nh, dq, dv, ta.pad16(dq), ta.pad16(dv), ta.copy_vec((q, k), dq),
            ta.copy_vec((v,), dv))
        assert counts == ((0, 1, 0, 0) if core == "flash" else (0, 0, 0, 1))
    else:
        assert source == "pooled_attention"
        if core == "flash":
            assert symbol == "sf_pooled_attention"
            assert args[4:12] == (B, Nq, Nk, nh, dq, dv, 0, 0)  # not exact, not bf16
        else:
            assert symbol == "sf_pooled_attention_saved_e" and args[4] == e.data_ptr()
            assert args[5:12] == (B, Nq, Nk, nh, dq, dv, 0)  # not bf16
        assert counts == ((1, 0, 0, 0) if core == "flash" else (0, 0, 1, 0))


@pytest.mark.parametrize("dq, dv, dqk, dvv", [
    (118, 96, 128, 96),   # MViTv2-S blocks 0, 2, 4-13, 15
    (132, 96, 144, 96),   # blocks 1, 3, 14
    (20, 12, 32, 16),
    (64, 64, 128, 64),
    (150, 100, 192, 128),
    (256, 128, 256, 128),
])
def test_flash_fwd_scratch_takes_the_template_depths(dq, dv, dqk, dvv):
    """k and v are packed into 64-key tiles as deep as the kernel's
    template instance; Nk = 393 and 1569 end in a partial tile."""
    for Nk, tiles in ((393, 7), (1569, 25), (64, 1)):
        assert ta.flash_fwd_scratch(16, Nk, 2, dq, dv) == {
            "k": (16, 2, tiles, 64, dqk), "v": (16, 2, tiles, 64, dvv)}


def test_bit_rounding_is_round_to_nearest_even():
    """The kernel rounds e to bf16 on its fp32 bits (csrc's flash_e_bits):
    the same value as PyTorch's rounding, for normal and subnormal numbers,
    ties and the clamp's largest e."""
    rng = np.random.RandomState(11)
    x = np.concatenate([np.exp(rng.uniform(-110.0, 30.0, 20000)),
                        np.float32([0.0, np.exp(30.0), 2.0 ** -130, 1.0 + 2.0 ** -8,
                                    1.0 + 3 * 2.0 ** -8, 2.0 ** -126])]).astype(np.float32)
    u = x.view(np.uint32).astype(np.uint64)
    got = (((u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000).astype(np.uint32)).view(np.float32)
    want = torch.from_numpy(x).to(torch.bfloat16).float().numpy()
    np.testing.assert_array_equal(got, want)


def emulate_constant_shift_forward(q, k, v, mask_by_index=True):
    """The tensor-core constant-shift forward's scheme in plain PyTorch:
    padded depths, 64-key chunks whose keys >= Nk have zero K and V rows
    and, with ``mask_by_index``, e = 0 by their index; per chunk
    ``e = round(exp(min(l, 50) - 20))``, ``s`` from the rounded e and
    ``o += e v``; then ``o / max(s, 1e-30)``. Returns ``(out, e)``."""
    dt, dv, Nk = v.dtype, v.shape[3], k.shape[1]
    qf, kf, vf, valid = _padded(q, k, v)
    s, o, es = 0.0, 0.0, []
    for c0 in range(0, kf.shape[1], 64):
        l = _chunked_logits(qf, kf, c0)
        e = torch.exp(torch.clamp(l, max=50.0) - 20.0).to(dt).float()
        if mask_by_index:
            e = e.masked_fill(~valid[c0:c0 + 64], 0.0)
        s = s + e.sum(-1)
        o = o + torch.einsum("bnqk,bknc->bqnc", e, vf[:, c0:c0 + 64])
        es.append(e)
    out = o / torch.clamp(s, min=1e-30).permute(0, 2, 1)[..., None]
    return out[..., :dv].to(dt), torch.cat(es, -1)[..., :Nk].to(dt)


def _within_one_ulp_of_max(got, want):
    """|got - want| within one bf16 ulp of max |want|."""
    g, w = got.float().numpy(), want.float().numpy()
    ulp = np.ldexp(1.0, int(np.frexp(np.abs(w).max())[1]) - 8)
    assert np.abs(g - w).max() <= ulp, (np.abs(g - w).max(), ulp)


@pytest.mark.parametrize("shape, extreme", EDGE_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_constant_shift_scheme_matches_flash_and_fused_plain(shape, dtype, extreme):
    """Zero-padded depths, zero K and V rows and e = 0 by index on the
    masked keys, s from the rounded e chunk by chunk: the emulated kernel is
    ``flash_plain`` and its e is ``fused_plain``'s, within summation order
    (fp32) or one bf16 ulp of the output's max (bf16); underflowing rows
    stay zero."""
    dt = getattr(torch, dtype)
    q, k, v = (torch.from_numpy(a).to(dt) for a in _inputs(shape, 12, extreme))
    out, e = emulate_constant_shift_forward(q, k, v)
    want_out, want_e = ta.fused_plain(q, k, v)
    assert torch.equal(want_out, ta.flash_plain(q, k, v))
    assert out.dtype == want_out.dtype and e.shape == want_e.shape and e.dtype == want_e.dtype
    assert torch.isfinite(out).all()
    if dtype == "float32":
        np.testing.assert_allclose(out.numpy(), want_out.numpy(), atol=FP32_TOL, rtol=FP32_TOL)
        np.testing.assert_allclose(e.numpy(), want_e.numpy(), atol=0.0, rtol=FP32_TOL)
    else:
        _within_one_ulp_of_max(out, want_out)
        bf16_ulp = np.ldexp(1.0, np.frexp(np.abs(want_e.float().numpy()))[1] - 8)
        assert (np.abs(e.float().numpy() - want_e.float().numpy()) <= bf16_ulp).all()
    if extreme:
        assert torch.count_nonzero(out[:, 3:6]) == 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [EDGE_SHAPES["nk_below_64"], EDGE_SHAPES["nk_64j_plus_1"]])
def test_zero_filled_keys_without_the_index_mask_do_not_match(shape, dtype):
    """A zero-filled K row gives l = 0, so e = exp(-20), not 0: without the
    mask by index the padded keys add to s, the output shrinks and leaves
    the tolerance that the masked scheme meets."""
    dt = getattr(torch, dtype)
    q, k, v = (torch.from_numpy(a).to(dt) for a in _inputs(shape, 13))
    unmasked, _ = emulate_constant_shift_forward(q, k, v, mask_by_index=False)
    got, want = unmasked.float().numpy(), ta.flash_plain(q, k, v).float().numpy()
    assert shape[2] % 64 != 0
    if dtype == "float32":
        assert not np.allclose(got, want, atol=FP32_TOL, rtol=FP32_TOL)
    else:
        assert np.abs(got - want).max() > np.ldexp(1.0, int(np.frexp(np.abs(want).max())[1]) - 8)
    assert np.abs(got).sum() < np.abs(want).sum()
