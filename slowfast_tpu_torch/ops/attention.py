"""MViT pooled-attention cores: softmax(q kᵀ) v per (batch, head), with
their gradients.

Three cores, each a forward and a backward kernel written by hand in CUDA,
the counterparts of the JAX package's Pallas kernels
(``slowfast_tpu/ops/pallas_attention.py``):

* ``flash_pooled_attention``, the port's default MViT core. Forward
  (kernel :375 ``_flash_fwd_kernel``): the constant-shift softmax
  ``e = round(exp(min(l, 50) - 20))``, ``s = max(Σe, 1e-30)``,
  ``o = (e v) / s``, with ``e`` rounded to the compute dtype before the sum
  and the product. Rows whose every ``exp`` underflows give zeros, not NaN.
  In bf16 it runs on the tensor cores (``csrc/pooled_attention_flash.cu``,
  wgmma), in fp32 on ``csrc/pooled_attention.cu`` (FMA loops). Backward
  (kernel :392 ``_flash_bwd_kernel``), which recomputes ``e``:
  ``do_n = round(do / s)``, ``dv = eᵀ do_n``, ``dpn = do_n vᵀ``,
  ``r = Σ dpn·e``, ``dl = round(e (dpn - r / s))``, ``dq = dl k``,
  ``dk = dlᵀ q``. It has no derivative of the clamp: a clamped logit gets
  ``e (dpn - r / s)`` as in the JAX kernel, where autograd of the forward
  would give zero. In bf16 it runs on the tensor cores
  (``csrc/pooled_attention_flash_bwd.cu``, wgmma), in fp32 on
  ``csrc/pooled_attention_bwd.cu`` (FMA loops).
* ``fused_pooled_attention``, the same function with the saved-e backward of
  kernels :237 ``_fused_fwd_kernel`` and :255 ``_fused_bwd_kernel``. Forward:
  the saved-e mode of the same kernels (``csrc/pooled_attention_flash.cu`` in
  bf16, ``csrc/pooled_attention.cu`` in fp32), whose output is bit-equal to
  the flash forward's and which also writes ``e`` as ``(B, nh, Nq, Nk)`` in
  v's dtype. Backward: the flash backward's formulas with ``e`` read
  back instead of recomputed; in bf16 the read mode of
  ``csrc/pooled_attention_flash_bwd.cu``, in fp32
  ``csrc/pooled_attention_fused_bwd.cu``. No config key routes MViT to it,
  as none does in the JAX package.
* ``pooled_attention``, selected by ``TPU.PALLAS_ATTENTION``. Forward
  (kernel :39 ``_fwd_kernel``): ``p = exp(l - max l)``, ``s = Σp`` in fp32,
  ``o = (round(p) v) / s``. Backward (kernel :58 ``_bwd_kernel``):
  ``p = e / s``, ``dp = do vᵀ`` in fp32, ``dl = p (dp - Σ dp·p)``,
  ``dq = round(dl) k``, ``dk = round(dl)ᵀ q``, ``dv = round(p)ᵀ do``. In
  bf16 both run on the tensor cores (``csrc/pooled_attention_exact.cu`` and
  ``csrc/pooled_attention_exact_bwd.cu``, wgmma), with depths padded to a
  multiple of 16 in shared memory only; in fp32 they are the exact modes of
  ``csrc/pooled_attention.cu`` and ``csrc/pooled_attention_bwd.cu`` (FMA
  loops: the tensor cores have no full-fp32 product).

All take q ``(B, Nq, nh, dq)``, k ``(B, Nk, nh, dq)`` (pre-scaled and
rel-pos augmented) and v ``(B, Nk, nh, dv)``, all bf16 or all fp32, and
return ``(B, Nq, nh, dv)`` in v's dtype; each is a ``torch.autograd.Function``
whose gradients are rounded to the input dtype as the JAX kernels' are
(dk and dv summed over every q row in fp32 first). ``flash_plain``,
``fused_plain``, ``exact_plain``, ``flash_bwd_plain``, ``fused_bwd_plain``
and ``exact_bwd_plain`` are the same functions in plain PyTorch; the
wrappers use them only for tensors on the CPU, and for a CUDA tensor launch
the kernel or raise.
"""

import ctypes

import torch

from . import _build

_DTYPES = (torch.bfloat16, torch.float32)
# PA_MAX_DQ, PA_MAX_DV in csrc/pooled_attention.cu; EX_MAX_DQ, EX_MAX_DV and
# FF_MAX_DQ, FF_MAX_DV in csrc/pooled_attention_{exact,flash}.cu
_MAX_DQ, _MAX_DV = 256, 128
# PB_MAX_DQ, PF_MAX_DQ, EB_MAX_DQ, FB_MAX_DQ in
# csrc/pooled_attention{_bwd,_fused_bwd,_exact_bwd,_flash_bwd}.cu
_MAX_DQ_BWD = 192
_TILE = 64  # q rows and keys per tile of every pooled-attention kernel
# Depths of the template instances of csrc/pooled_attention_flash.cu: q kᵀ
# over dq padded to one of _FWD_QK_DEPTHS, e v over dv padded to one of
# _FWD_V_DEPTHS (the depths of its packed tiles).
_FWD_QK_DEPTHS = (32, 128, 144, 192, 256)
_FWD_V_DEPTHS = (16, 64, 96, 128)
_SM_COUNT_H100 = 132
_KEYS_BLOCKS_PER_SM = 8  # four waves of the keys kernel's two resident blocks

# Kernel launches since the last reset; only the _launch* functions add to
# them. A kernel with an fp32 (FMA) and a bf16 (tensor-core) instance counts
# them apart: ``flash_*``, ``exact_*`` and ``fused_*`` are the FMA kernels,
# ``*_tc_*`` the tensor-core ones.
flash_launches = 0
flash_tc_launches = 0
exact_launches = 0
exact_tc_launches = 0
fused_launches = 0
fused_tc_launches = 0
flash_bwd_launches = 0
exact_bwd_launches = 0
exact_tc_bwd_launches = 0
flash_tc_bwd_launches = 0
fused_bwd_launches = 0
fused_tc_bwd_launches = 0


def flash_pooled_attention(qh, kh, vh):
    """Constant-shift pooled attention (the port's default MViT core)."""
    _check(qh, kh, vh)
    return _FlashCore.apply(qh, kh, vh)


def pooled_attention(qh, kh, vh):
    """Exact max-subtracted pooled attention (``TPU.PALLAS_ATTENTION``)."""
    _check(qh, kh, vh)
    return _ExactCore.apply(qh, kh, vh)


def fused_pooled_attention(qh, kh, vh):
    """Constant-shift pooled attention whose backward reads the saved ``e``."""
    _check(qh, kh, vh)
    return _FusedCore.apply(qh, kh, vh)


def _core_forward(ctx, qh, kh, vh, exact):
    ctx.save_for_backward(qh, kh, vh)
    if qh.device.type == "cpu":
        return (exact_plain if exact else flash_plain)(qh, kh, vh)
    return _launch(qh, kh, vh, exact=exact)


def _core_backward(ctx, do, exact):
    qh, kh, vh = ctx.saved_tensors
    do = do.contiguous()
    if qh.device.type == "cpu":
        return (exact_bwd_plain if exact else flash_bwd_plain)(qh, kh, vh, do)
    return _launch_bwd(qh, kh, vh, do, exact=exact)


class _FlashCore(torch.autograd.Function):
    """The constant-shift forward kernel with its backward kernel (plain
    versions on the CPU)."""

    @staticmethod
    def forward(ctx, qh, kh, vh):
        return _core_forward(ctx, qh, kh, vh, exact=False)

    @staticmethod
    def backward(ctx, do):
        return _core_backward(ctx, do, exact=False)


class _FusedCore(torch.autograd.Function):
    """The saved-e forward kernel with the backward kernel that reads ``e``
    (plain versions on the CPU)."""

    @staticmethod
    def forward(ctx, qh, kh, vh):
        if qh.device.type == "cpu":
            out, e = fused_plain(qh, kh, vh)
        else:
            out, e = _launch_fused(qh, kh, vh)
        ctx.save_for_backward(qh, kh, vh, e)
        return out

    @staticmethod
    def backward(ctx, do):
        qh, kh, vh, e = ctx.saved_tensors
        do = do.contiguous()
        if qh.device.type == "cpu":
            return fused_bwd_plain(qh, kh, vh, do, e)
        return _launch_fused_bwd(qh, kh, vh, do, e)


class _ExactCore(torch.autograd.Function):
    """The exact forward kernel with its backward kernel (plain versions on
    the CPU)."""

    @staticmethod
    def forward(ctx, qh, kh, vh):
        return _core_forward(ctx, qh, kh, vh, exact=True)

    @staticmethod
    def backward(ctx, do):
        return _core_backward(ctx, do, exact=True)


def _logits(qh, kh):
    return torch.einsum("bqnc,bknc->bnqk", qh.float(), kh.float())


def _weighted(p, vh, s):
    """``(p v) / s`` in fp32, ``(B, nh, Nq, Nk)`` -> ``(B, Nq, nh, dv)``."""
    o = torch.einsum("bnqk,bknc->bqnc", p.float(), vh.float())
    return (o / s.permute(0, 2, 1, 3)).to(vh.dtype)


def _flash_e(qh, kh, dtype):
    """``round(exp(min(l, 50) - 20))`` as fp32 values, ``(B, nh, Nq, Nk)``."""
    return torch.exp(torch.clamp(_logits(qh, kh), max=50.0) - 20.0).to(dtype).float()


def _flash_out(e, vh):
    """``(e v) / max(Σe, 1e-30)`` from the rounded ``e`` as fp32 values."""
    return _weighted(e, vh, torch.clamp(e.sum(dim=-1, keepdim=True), min=1e-30))


def flash_plain(qh, kh, vh):
    """The plain PyTorch version of the constant-shift kernel."""
    return _flash_out(_flash_e(qh, kh, vh.dtype), vh)


def fused_plain(qh, kh, vh):
    """The plain PyTorch version of the saved-e forward kernel, step by step
    as ``_fused_fwd_kernel``; returns ``(out, e)``, ``e`` ``(B, nh, Nq, Nk)``
    in v's dtype."""
    e = _flash_e(qh, kh, vh.dtype)
    return _flash_out(e, vh), e.to(vh.dtype)


def exact_plain(qh, kh, vh):
    """The plain PyTorch version of the exact kernel."""
    logits = _logits(qh, kh)
    p = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    return _weighted(p.to(vh.dtype), vh, p.sum(dim=-1, keepdim=True))


def _grads(dl, qh, kh):
    """``dq = dl k`` and ``dk = dlᵀ q`` from the rounded ``dl``, in fp32."""
    dq = torch.einsum("bnqk,bknc->bqnc", dl, kh.float())
    dk = torch.einsum("bnqk,bqnc->bknc", dl, qh.float())
    return dq.to(qh.dtype), dk.to(kh.dtype)


def flash_bwd_plain(qh, kh, vh, do):
    """The plain PyTorch version of the constant-shift backward kernel,
    step by step as ``_flash_bwd_kernel``; returns ``(dq, dk, dv)``."""
    return _bwd_from_e(_flash_e(qh, kh, vh.dtype), qh, kh, vh, do)


def fused_bwd_plain(qh, kh, vh, do, e):
    """The plain PyTorch version of the saved-e backward kernel, step by step
    as ``_fused_bwd_kernel``: ``flash_bwd_plain`` with ``e`` read from the
    forward's ``(B, nh, Nq, Nk)`` instead of recomputed."""
    return _bwd_from_e(e.float(), qh, kh, vh, do)


def _bwd_from_e(ef, qh, kh, vh, do):
    """The constant-shift backward from the rounded ``e`` as fp32 values."""
    s = torch.clamp(ef.sum(dim=-1, keepdim=True), min=1e-30)  # (B, nh, Nq, 1)
    do_n = (do.float() / s.permute(0, 2, 1, 3)).to(do.dtype).float()
    dv = torch.einsum("bnqk,bqnc->bknc", ef, do_n)
    dpn = torch.einsum("bqnc,bknc->bnqk", do_n, vh.float())
    r = (dpn * ef).sum(dim=-1, keepdim=True)
    dl = (ef * (dpn - r / s)).to(qh.dtype).float()
    return (*_grads(dl, qh, kh), dv.to(vh.dtype))


def exact_bwd_plain(qh, kh, vh, do):
    """The plain PyTorch version of the exact backward kernel, step by step
    as ``_bwd_kernel``; returns ``(dq, dk, dv)``."""
    logits = _logits(qh, kh)
    e = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    p = e / e.sum(dim=-1, keepdim=True)
    dp = torch.einsum("bqnc,bknc->bnqk", do.float(), vh.float())
    dl = (p * (dp - (dp * p).sum(dim=-1, keepdim=True))).to(qh.dtype).float()
    dv = torch.einsum("bnqk,bqnc->bknc", p.to(do.dtype).float(), do.float())
    return (*_grads(dl, qh, kh), dv.to(vh.dtype))


def _check(qh, kh, vh):
    if not (qh.dim() == kh.dim() == vh.dim() == 4):
        raise ValueError("expected (B, N, nh, d) q, k and v")
    B, Nq, nh, dq = qh.shape
    if kh.shape[0] != B or kh.shape[2:] != (nh, dq) or vh.shape[:3] != kh.shape[:3]:
        raise ValueError(f"mismatched shapes q {tuple(qh.shape)} k {tuple(kh.shape)} "
                         f"v {tuple(vh.shape)}")
    if not (qh.dtype == kh.dtype == vh.dtype and qh.dtype in _DTYPES):
        raise ValueError(f"q, k and v must share one dtype of {_DTYPES}, got "
                         f"{qh.dtype} {kh.dtype} {vh.dtype}")
    if not (qh.device == kh.device == vh.device):
        raise ValueError("q, k and v must lie on one device")


def _check_device(t):
    if t.device.type != "cuda":
        raise ValueError(f"no pooled-attention kernel for device {t.device}")


def _check_launch(tensors, max_dq):
    qh, vh = tensors[0], tensors[2]
    _check_device(qh)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("the pooled-attention kernels take contiguous tensors")
    B, Nq, nh, dq = qh.shape
    Nk, dv = vh.shape[1], vh.shape[3]
    if dq > max_dq or dv > _MAX_DV or 0 in (B, Nq, Nk, nh, dq, dv):
        raise ValueError(f"the pooled-attention kernel takes 0 < dq <= {max_dq} and "
                         f"0 < dv <= {_MAX_DV} and no empty axis, got q "
                         f"{tuple(qh.shape)} v {tuple(vh.shape)}")
    return B, Nq, Nk, nh, dq, dv


def _kernel(source, symbol, argtypes):
    """``symbol`` from the library built from ``csrc/<source>.cu``, with its
    C signature."""
    fn = getattr(_build.load(source), symbol)
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = argtypes
    return fn


_PTR, _I64, _I32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int


def _check_operand(t, name, shape, dtype):
    if t.shape != shape or t.dtype != dtype:
        raise ValueError(f"{name} must be {shape} {dtype}, got {tuple(t.shape)} {t.dtype}")


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def pad16(d):
    """A depth zero-padded to the tensor cores' k16 step: the tensor-core
    kernels' depth in shared memory (device memory holds the real one)."""
    return -(-d // 16) * 16


def copy_vec(tensors, d):
    """Elements per asynchronous copy (8, 4, 2 or 1 bf16: 16 to 2 bytes) of
    the ``(B, N, nh, d)`` tensors: the widest piece that every base pointer,
    the depth ``d`` and so every row and head offset are aligned to."""
    for vec in (8, 4, 2):
        size = 2 * vec
        if (2 * d) % size == 0 and all(t.data_ptr() % size == 0 for t in tensors):
            return vec
    return 1


def keys_split(B, Nq, Nk, nh, sms=_SM_COUNT_H100):
    """The q split of the tensor-core backward's keys kernel: ``(n_split,
    tiles_per_split)``. Its grid is (key chunks, nh, B) times ``n_split``
    slices of the q tiles: the fewest slices that give 8 blocks per SM
    (four waves, so the last one idles little), or one slice per q tile.
    Each slice takes ``tiles_per_split`` tiles, the last one what
    remains."""
    tiles = -(-Nq // _TILE)
    blocks = -(-Nk // _TILE) * nh * B
    want = max(1, min(tiles, -(-_KEYS_BLOCKS_PER_SM * sms // blocks)))
    per = -(-tiles // want)
    return -(-tiles // per), per


def flash_fwd_scratch(B, Nk, nh, dq, dv):
    """Shapes of the tensor-core constant-shift forward's bf16 scratch: k
    and v packed into 64-key tiles per (batch, head), each tile as deep as
    the kernel's template instance (``_FWD_QK_DEPTHS``, ``_FWD_V_DEPTHS``),
    zero past the keys and the depth."""
    tiles = -(-Nk // _TILE)
    return {"k": (B, nh, tiles, _TILE, min(d for d in _FWD_QK_DEPTHS if d >= dq)),
            "v": (B, nh, tiles, _TILE, min(d for d in _FWD_V_DEPTHS if d >= dv))}


def flash_bwd_scratch(B, Nq, Nk, nh, dq, dv, n_split):
    """Shapes and dtypes of the tensor-core constant-shift backward's
    scratch: ``r / s`` per row (fp32), ``do_n = round(do / s)`` in do's
    layout (bf16) and the keys kernel's fp32 partial dk and dv of each
    slice."""
    return {"rs": ((B, nh, Nq), torch.float32), "do_n": ((B, Nq, nh, dv), torch.bfloat16),
            "dk_part": ((n_split, B, Nk, nh, dq), torch.float32),
            "dv_part": ((n_split, B, Nk, nh, dv), torch.float32)}


def exact_bwd_scratch(B, Nq, Nk, nh, dq, dv, n_split):
    """Shapes of the tensor-core backward's fp32 scratch: the row statistics
    ``m, s, r`` and the keys kernel's partial dk and dv of each slice."""
    return {"stats": (3, B, nh, Nq), "dk_part": (n_split, B, Nk, nh, dq),
            "dv_part": (n_split, B, Nk, nh, dv)}


def _sm_count(t):
    return torch.cuda.get_device_properties(t.device).multi_processor_count


def _launch(qh, kh, vh, exact):
    global flash_launches, exact_launches
    if vh.dtype == torch.bfloat16:
        if exact:
            return _launch_exact_tc(qh, kh, vh)
        return _launch_constant_shift_tc(qh, kh, vh)
    B, Nq, Nk, nh, dq, dv = _check_launch((qh, kh, vh), _MAX_DQ)
    out = torch.empty((B, Nq, nh, dv), dtype=vh.dtype, device=vh.device)
    fn = _kernel("pooled_attention", "sf_pooled_attention",
                 [_PTR] * 4 + [_I64] * 6 + [_I32, _I32, _PTR])
    err = fn(qh.data_ptr(), kh.data_ptr(), vh.data_ptr(), out.data_ptr(),
             B, Nq, Nk, nh, dq, dv, int(exact), 0, _stream(vh))
    if err != 0:
        raise RuntimeError(f"pooled-attention kernel launch failed: CUDA error {err}")
    if exact:
        exact_launches += 1
    else:
        flash_launches += 1
    return out


def _launch_exact_tc(qh, kh, vh):
    """The bf16 exact forward on the tensor cores."""
    global exact_tc_launches
    B, Nq, Nk, nh, dq, dv = _check_launch((qh, kh, vh), _MAX_DQ)
    out = torch.empty((B, Nq, nh, dv), dtype=vh.dtype, device=vh.device)
    fn = _kernel("pooled_attention_exact", "sf_exact_attention_fwd",
                 [_PTR] * 4 + [_I64] * 6 + [_I32] * 4 + [_PTR])
    err = fn(qh.data_ptr(), kh.data_ptr(), vh.data_ptr(), out.data_ptr(),
             B, Nq, Nk, nh, dq, dv, pad16(dq), pad16(dv), copy_vec((qh, kh), dq),
             copy_vec((vh,), dv), _stream(vh))
    if err != 0:
        raise RuntimeError(f"exact pooled-attention kernel launch failed: CUDA error {err}")
    exact_tc_launches += 1
    return out


def _launch_constant_shift_tc(qh, kh, vh, save_e=False):
    """The bf16 constant-shift forward on the tensor cores: the flash
    core's output or, with ``save_e``, the fused core's ``(out, e)``, ``e``
    ``(B, nh, Nq, Nk)`` bf16 from a 16-byte aligned base. The kernel first
    packs k and v into the scratch of ``flash_fwd_scratch``."""
    global flash_tc_launches, fused_tc_launches
    B, Nq, Nk, nh, dq, dv = _check_launch((qh, kh, vh), _MAX_DQ)
    out = torch.empty((B, Nq, nh, dv), dtype=vh.dtype, device=vh.device)
    saved = ()
    if save_e:
        e = torch.empty((B, nh, Nq, Nk), dtype=vh.dtype, device=vh.device)
        if e.data_ptr() % 16:
            raise ValueError("the tensor-core forward writes e from a 16-byte aligned base")
        saved = (e.data_ptr(),)
    packed = [torch.empty(shape, dtype=torch.bfloat16, device=vh.device)
              for shape in flash_fwd_scratch(B, Nk, nh, dq, dv).values()]
    symbol = "sf_flash_attention_fwd_saved_e" if save_e else "sf_flash_attention_fwd"
    fn = _kernel("pooled_attention_flash", symbol,
                 [_PTR] * (6 + len(saved)) + [_I64] * 6 + [_I32] * 4 + [_PTR])
    err = fn(qh.data_ptr(), kh.data_ptr(), vh.data_ptr(), out.data_ptr(), *saved,
             *(t.data_ptr() for t in packed), B, Nq, Nk, nh, dq, dv, pad16(dq), pad16(dv),
             copy_vec((qh, kh), dq), copy_vec((vh,), dv), _stream(vh))
    if err != 0:
        raise RuntimeError(f"constant-shift pooled-attention kernel launch failed: "
                           f"CUDA error {err}")
    if save_e:
        fused_tc_launches += 1
        return out, e
    flash_tc_launches += 1
    return out


def _launch_fused(qh, kh, vh):
    """The saved-e forward: the flash forward's output and ``e``
    ``(B, nh, Nq, Nk)`` in v's dtype. bf16 goes to the tensor-core kernel,
    fp32 to the FMA kernel."""
    global fused_launches
    if vh.dtype == torch.bfloat16:
        return _launch_constant_shift_tc(qh, kh, vh, save_e=True)
    B, Nq, Nk, nh, dq, dv = _check_launch((qh, kh, vh), _MAX_DQ)
    out = torch.empty((B, Nq, nh, dv), dtype=vh.dtype, device=vh.device)
    e = torch.empty((B, nh, Nq, Nk), dtype=vh.dtype, device=vh.device)
    fn = _kernel("pooled_attention", "sf_pooled_attention_saved_e",
                 [_PTR] * 5 + [_I64] * 6 + [_I32, _PTR])
    err = fn(qh.data_ptr(), kh.data_ptr(), vh.data_ptr(), out.data_ptr(), e.data_ptr(),
             B, Nq, Nk, nh, dq, dv, 0, _stream(vh))
    if err != 0:
        raise RuntimeError(f"saved-e pooled-attention kernel launch failed: CUDA error {err}")
    fused_launches += 1
    return out, e


def _launch_bwd(qh, kh, vh, do, exact):
    """One backward. bf16 goes to the tensor-core kernels; fp32 to both FMA
    kernels: per q tile dq and the row statistics, then per key chunk dk
    and dv over every q tile. The statistics (``m``, ``s``, ``r``, fp32
    ``(B, nh, Nq)`` each) are scratch."""
    global flash_bwd_launches, exact_bwd_launches
    if vh.dtype == torch.bfloat16:
        if exact:
            return _launch_exact_tc_bwd(qh, kh, vh, do)
        return _launch_constant_shift_tc_bwd(qh, kh, vh, do)
    B, Nq, Nk, nh, dq, dv = _check_launch((qh, kh, vh, do), _MAX_DQ_BWD)
    _check_operand(do, "do", (B, Nq, nh, dv), vh.dtype)
    dq_out = torch.empty_like(qh)
    dk_out = torch.empty_like(kh)
    dv_out = torch.empty_like(vh)
    stats = torch.empty((3, B, nh, Nq), dtype=torch.float32, device=qh.device)
    fn = _kernel("pooled_attention_bwd", "sf_pooled_attention_bwd",
                 [_PTR] * 8 + [_I64] * 6 + [_I32, _PTR])
    err = fn(qh.data_ptr(), kh.data_ptr(), vh.data_ptr(), do.data_ptr(),
             dq_out.data_ptr(), dk_out.data_ptr(), dv_out.data_ptr(), stats.data_ptr(),
             B, Nq, Nk, nh, dq, dv, int(exact), _stream(vh))
    if err != 0:
        raise RuntimeError(f"pooled-attention backward kernel launch failed: CUDA error {err}")
    if exact:
        exact_bwd_launches += 1
    else:
        flash_bwd_launches += 1
    return dq_out, dk_out, dv_out


def _launch_exact_tc_bwd(qh, kh, vh, do):
    """The bf16 exact backward on the tensor cores: a rows kernel (dq and
    the row statistics), a keys kernel (fp32 partial dk and dv of each q
    slice, ``keys_split``) and the sum of the slices, in that order."""
    global exact_tc_bwd_launches
    B, Nq, Nk, nh, dq, dv = _check_launch((qh, kh, vh, do), _MAX_DQ_BWD)
    _check_operand(do, "do", (B, Nq, nh, dv), vh.dtype)
    n_split, per = keys_split(B, Nq, Nk, nh, _sm_count(qh))
    dq_out = torch.empty_like(qh)
    dk_out = torch.empty_like(kh)
    dv_out = torch.empty_like(vh)
    scratch = {name: torch.empty(shape, dtype=torch.float32, device=qh.device)
               for name, shape in exact_bwd_scratch(B, Nq, Nk, nh, dq, dv, n_split).items()}
    fn = _kernel("pooled_attention_exact_bwd", "sf_exact_attention_bwd",
                 [_PTR] * 10 + [_I64] * 6 + [_I32] * 6 + [_PTR])
    err = fn(qh.data_ptr(), kh.data_ptr(), vh.data_ptr(), do.data_ptr(),
             dq_out.data_ptr(), dk_out.data_ptr(), dv_out.data_ptr(),
             scratch["stats"].data_ptr(), scratch["dk_part"].data_ptr(),
             scratch["dv_part"].data_ptr(), B, Nq, Nk, nh, dq, dv, pad16(dq), pad16(dv),
             copy_vec((qh, kh), dq), copy_vec((vh, do), dv), n_split, per, _stream(vh))
    if err != 0:
        raise RuntimeError(f"exact pooled-attention backward kernel launch failed: "
                           f"CUDA error {err}")
    exact_tc_bwd_launches += 1
    return dq_out, dk_out, dv_out


def _launch_fused_bwd(qh, kh, vh, do, e):
    """The saved-e backward. bf16 goes to the tensor-core kernels; fp32 to
    both FMA kernels: per q tile dq and the row statistics from ``e``, then
    per key chunk dk and dv over every q tile. The statistics (``s``,
    ``r``, fp32 ``(B, nh, Nq)`` each) are scratch."""
    global fused_bwd_launches
    if vh.dtype == torch.bfloat16:
        return _launch_constant_shift_tc_bwd(qh, kh, vh, do, e)
    B, Nq, Nk, nh, dq, dv = _check_launch((qh, kh, vh, do, e), _MAX_DQ_BWD)
    _check_operand(do, "do", (B, Nq, nh, dv), vh.dtype)
    _check_operand(e, "e", (B, nh, Nq, Nk), vh.dtype)
    dq_out = torch.empty_like(qh)
    dk_out = torch.empty_like(kh)
    dv_out = torch.empty_like(vh)
    stats = torch.empty((2, B, nh, Nq), dtype=torch.float32, device=qh.device)
    fn = _kernel("pooled_attention_fused_bwd", "sf_pooled_attention_fused_bwd",
                 [_PTR] * 9 + [_I64] * 6 + [_PTR])
    err = fn(qh.data_ptr(), kh.data_ptr(), vh.data_ptr(), do.data_ptr(), e.data_ptr(),
             dq_out.data_ptr(), dk_out.data_ptr(), dv_out.data_ptr(), stats.data_ptr(),
             B, Nq, Nk, nh, dq, dv, _stream(vh))
    if err != 0:
        raise RuntimeError(f"saved-e pooled-attention backward kernel launch failed: "
                           f"CUDA error {err}")
    fused_bwd_launches += 1
    return dq_out, dk_out, dv_out


def _launch_constant_shift_tc_bwd(qh, kh, vh, do, e=None):
    """The bf16 constant-shift backward on the tensor cores: a rows kernel
    (dq, ``do_n`` and ``r / s``), a keys kernel (fp32 partial dk and dv of
    each q slice, ``keys_split``) and the sum of the slices, in that order.
    It recomputes ``e`` (the flash core's backward) or, given the saved-e
    forward's ``e``, reads it (the fused core's)."""
    global flash_tc_bwd_launches, fused_tc_bwd_launches
    tensors = (qh, kh, vh, do) if e is None else (qh, kh, vh, do, e)
    B, Nq, Nk, nh, dq, dv = _check_launch(tensors, _MAX_DQ_BWD)
    _check_operand(do, "do", (B, Nq, nh, dv), vh.dtype)
    if e is not None:
        _check_operand(e, "e", (B, nh, Nq, Nk), vh.dtype)
        if e.data_ptr() % 16:
            raise ValueError("the tensor-core backward reads e from a 16-byte aligned base")
    n_split, per = keys_split(B, Nq, Nk, nh, _sm_count(qh))
    dq_out = torch.empty_like(qh)
    dk_out = torch.empty_like(kh)
    dv_out = torch.empty_like(vh)
    scratch = {name: torch.empty(shape, dtype=dtype, device=qh.device) for name, (shape, dtype)
               in flash_bwd_scratch(B, Nq, Nk, nh, dq, dv, n_split).items()}
    saved = () if e is None else (e.data_ptr(),)
    symbol = "sf_flash_attention_bwd_tc" if e is None else "sf_fused_attention_bwd_tc"
    fn = _kernel("pooled_attention_flash_bwd", symbol,
                 [_PTR] * (11 + len(saved)) + [_I64] * 6 + [_I32] * 6 + [_PTR])
    err = fn(qh.data_ptr(), kh.data_ptr(), vh.data_ptr(), do.data_ptr(), *saved,
             dq_out.data_ptr(), dk_out.data_ptr(), dv_out.data_ptr(),
             *(scratch[name].data_ptr() for name in ("rs", "do_n", "dk_part", "dv_part")),
             B, Nq, Nk, nh, dq, dv, pad16(dq), pad16(dv), copy_vec((qh, kh), dq),
             copy_vec((vh, do, scratch["do_n"]), dv), n_split, per, _stream(vh))
    if err != 0:
        raise RuntimeError(f"constant-shift pooled-attention backward kernel launch failed: "
                           f"CUDA error {err}")
    if e is None:
        flash_tc_bwd_launches += 1
    else:
        fused_tc_bwd_launches += 1
    return dq_out, dk_out, dv_out
