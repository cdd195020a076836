"""MViT pooled-attention cores: softmax(q kᵀ) v per (batch, head).

Two hand-written CUDA kernels in one source (``csrc/pooled_attention.cu``),
the counterparts of the JAX package's Pallas kernels:

* ``flash_pooled_attention``, the port's default MViT core
  (``slowfast_tpu/ops/pallas_attention.py:502``, kernel :375
  ``_flash_fwd_kernel``): the constant-shift softmax
  ``e = round(exp(min(l, 50) - 20))``, ``s = max(Σe, 1e-30)``,
  ``o = (e v) / s``, with ``e`` rounded to the compute dtype before the sum
  and the product. Rows whose every ``exp`` underflows give zeros, not NaN.
* ``pooled_attention``, selected by ``TPU.PALLAS_ATTENTION``
  (``pallas_attention.py:171``, kernel :39 ``_fwd_kernel``): the exact
  softmax ``p = exp(l - max l)``, ``s = Σp`` in fp32, ``o = (round(p) v) / s``.

Both take q ``(B, Nq, nh, dq)``, k ``(B, Nk, nh, dq)`` (pre-scaled and
rel-pos augmented) and v ``(B, Nk, nh, dv)``, all bf16 or all fp32, and
return ``(B, Nq, nh, dv)`` in v's dtype. ``flash_plain`` and ``exact_plain``
are the same functions in plain PyTorch; the wrappers use them only for
tensors on the CPU, and for a CUDA tensor launch the kernel or raise.
"""

import ctypes

import torch

from . import _build

_DTYPES = (torch.bfloat16, torch.float32)
_MAX_DQ, _MAX_DV = 256, 128  # PA_MAX_DQ, PA_MAX_DV in csrc/pooled_attention.cu

# Kernel launches since the last reset; only _launch adds to them.
flash_launches = 0
exact_launches = 0


def flash_pooled_attention(qh, kh, vh):
    """Constant-shift pooled attention (the port's default MViT core)."""
    _check(qh, kh, vh)
    if qh.device.type == "cpu":
        return flash_plain(qh, kh, vh)
    return _launch(qh, kh, vh, exact=False)


def pooled_attention(qh, kh, vh):
    """Exact max-subtracted pooled attention (``TPU.PALLAS_ATTENTION``)."""
    _check(qh, kh, vh)
    if qh.device.type == "cpu":
        return exact_plain(qh, kh, vh)
    return _launch(qh, kh, vh, exact=True)


def _logits(qh, kh):
    return torch.einsum("bqnc,bknc->bnqk", qh.float(), kh.float())


def _weighted(p, vh, s):
    """``(p v) / s`` in fp32, ``(B, nh, Nq, Nk)`` -> ``(B, Nq, nh, dv)``."""
    o = torch.einsum("bnqk,bknc->bqnc", p.float(), vh.float())
    return (o / s.permute(0, 2, 1, 3)).to(vh.dtype)


def flash_plain(qh, kh, vh):
    """The plain PyTorch version of the constant-shift kernel."""
    e = torch.exp(torch.clamp(_logits(qh, kh), max=50.0) - 20.0).to(vh.dtype)
    s = torch.clamp(e.float().sum(dim=-1, keepdim=True), min=1e-30)
    return _weighted(e, vh, s)


def exact_plain(qh, kh, vh):
    """The plain PyTorch version of the exact kernel."""
    logits = _logits(qh, kh)
    p = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    return _weighted(p.to(vh.dtype), vh, p.sum(dim=-1, keepdim=True))


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


def _kernel():
    """``sf_pooled_attention`` from the built library, with its C signature."""
    fn = _build.load("pooled_attention").sf_pooled_attention
    if fn.argtypes is None:
        ptr, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        fn.restype = i32
        fn.argtypes = [ptr, ptr, ptr, ptr, i64, i64, i64, i64, i64, i64, i32, i32, ptr]
    return fn


def _launch(qh, kh, vh, exact):
    global flash_launches, exact_launches
    if qh.device.type != "cuda":
        raise ValueError(f"no pooled-attention kernel for device {qh.device}")
    if not (qh.is_contiguous() and kh.is_contiguous() and vh.is_contiguous()):
        raise ValueError("the pooled-attention kernel takes contiguous q, k and v")
    B, Nq, nh, dq = qh.shape
    Nk, dv = vh.shape[1], vh.shape[3]
    if dq > _MAX_DQ or dv > _MAX_DV or 0 in (B, Nq, Nk, nh, dq, dv):
        raise ValueError(f"the pooled-attention kernel takes 0 < dq <= {_MAX_DQ} and "
                         f"0 < dv <= {_MAX_DV} and no empty axis, got q "
                         f"{tuple(qh.shape)} v {tuple(vh.shape)}")
    out = torch.empty((B, Nq, nh, dv), dtype=vh.dtype, device=vh.device)
    err = _kernel()(qh.data_ptr(), kh.data_ptr(), vh.data_ptr(), out.data_ptr(),
                    B, Nq, Nk, nh, dq, dv, int(exact), int(vh.dtype == torch.bfloat16),
                    torch.cuda.current_stream(vh.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"pooled-attention kernel launch failed: CUDA error {err}")
    if exact:
        exact_launches += 1
    else:
        flash_launches += 1
    return out
