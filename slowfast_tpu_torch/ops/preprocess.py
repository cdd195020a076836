"""uint8 clip preprocessing on the device: normalize, flip, channel reverse
and the SlowFast pathway split.

The loader ships uint8 NTHWC clips; the per-pixel work runs on the card in
one hand-written CUDA kernel (``csrc/preprocess.cu``), the counterpart of
the JAX package's ``ops/preprocess.py:_affine_u8_kernel`` fused with the
flip and the pathway split. ``preprocess_plain`` is the same function in
plain PyTorch. The wrappers use it only for tensors on the CPU; for a CUDA
tensor they launch the kernel or raise.

Normalization is the per-channel affine ``x * (1/(255*std)) + (-mean/std)``
computed in fp32 (reference tensor_normalize, slowfast/datasets/utils.py).
"""

import ctypes

import numpy as np
import torch

from . import _build

_MAX_T = 256  # SF_MAX_T in csrc/preprocess.cu
_OUT_DTYPES = (torch.bfloat16, torch.float32)

# Kernel launches since the last reset; only _launch adds to it.
launches = 0


def scale_bias(mean, std):
    """Per-channel fp32 ``scale = 1/(255*std)`` and ``bias = -mean/std``."""
    mean = np.asarray(mean, np.float32)
    std = np.asarray(std, np.float32)
    return (1.0 / (255.0 * std)).astype(np.float32), (-mean / std).astype(np.float32)


def slow_index(num_frames, alpha):
    """Slow-pathway frame indices (reference pack_pathway_output)."""
    return np.linspace(0, num_frames - 1, num_frames // alpha).astype(np.int64)


def normalize_clips(clips_u8, mean, std, out_dtype=torch.bfloat16):
    """(B, T, H, W, C) uint8 -> normalized (B, T, H, W, C) ``out_dtype``."""
    return device_preprocess(clips_u8, mean, std, single_pathway=True,
                             out_dtype=out_dtype)[0]


def device_preprocess(clips_u8, mean, std, flips=None, alpha=8,
                      single_pathway=False, out_dtype=torch.bfloat16,
                      reverse_channels=False):
    """Normalize + optional flip and channel reverse + pathway split.

    Args:
      clips_u8: (B, T, H, W, C) uint8, contiguous.
      mean/std: length-C sequences in [0, 1] units (DATA.MEAN / DATA.STD).
      flips: optional (B,) per-clip horizontal flip flags.
      alpha: SlowFast frame-rate ratio for the slow-pathway subsample.
      reverse_channels: reverse the channel axis (DATA.REVERSE_INPUT_CHANNEL).
    Returns:
      ``[x]`` or ``[slow, fast]`` in ``out_dtype``, NTHWC.
    """
    if clips_u8.dtype != torch.uint8 or clips_u8.dim() != 5:
        raise ValueError(f"expected a (B,T,H,W,C) uint8 tensor, got "
                         f"{tuple(clips_u8.shape)} {clips_u8.dtype}")
    if out_dtype not in _OUT_DTYPES:
        raise ValueError(f"out_dtype must be one of {_OUT_DTYPES}, got {out_dtype}")
    scale, bias = scale_bias(mean, std)
    idx = None if single_pathway else slow_index(clips_u8.shape[1], alpha)
    if flips is not None:
        flips = torch.as_tensor(np.asarray(flips) != 0, device=clips_u8.device)
    if clips_u8.device.type == "cpu":
        return preprocess_plain(clips_u8, scale, bias, flips, idx, out_dtype,
                                reverse_channels)
    if clips_u8.device.type != "cuda":
        raise ValueError(f"no preprocess kernel for device {clips_u8.device}")
    return _launch(clips_u8, scale, bias, flips, idx, out_dtype, reverse_channels)


def preprocess_plain(clips_u8, scale, bias, flips, idx, out_dtype, reverse):
    """The plain PyTorch version of the kernel (same rounding: fp32 multiply,
    then fp32 add, then one cast)."""
    dev = clips_u8.device
    x = clips_u8.to(torch.float32) * torch.from_numpy(scale).to(dev)
    x = (x + torch.from_numpy(bias).to(dev)).to(out_dtype)
    if reverse:
        x = x.flip(-1)
    if flips is not None:
        x = torch.where(flips.view(-1, 1, 1, 1, 1), x.flip(3), x)
    if idx is None:
        return [x]
    return [x[:, torch.from_numpy(idx).to(dev)], x]


def _kernel():
    """``sf_preprocess_u8`` from the built library, with its C signature."""
    fn = _build.load("preprocess").sf_preprocess_u8
    if fn.argtypes is None:
        ptr, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        fn.restype = i32
        fn.argtypes = [ptr, ptr, ptr, ptr, ptr, i64, i64, i64, i64, i32, ptr, ptr,
                       i32, i32, i32, ptr]
    return fn


def _launch(x, scale, bias, flips, idx, out_dtype, reverse):
    global launches
    B, T, H, W, C = x.shape
    if C != 3 or not x.is_contiguous():
        raise ValueError(f"the preprocess kernel takes contiguous 3-channel "
                         f"clips, got {tuple(x.shape)} contiguous={x.is_contiguous()}")
    if T > _MAX_T:
        raise ValueError(f"the preprocess kernel takes at most {_MAX_T} frames, got {T}")
    fast = torch.empty(x.shape, dtype=out_dtype, device=x.device)
    t_slow = 0 if idx is None else len(idx)
    slow = (torch.empty((B, t_slow, H, W, C), dtype=out_dtype, device=x.device)
            if idx is not None else None)
    slot = np.full(T, -1, np.int32)
    if idx is not None:
        if len(set(idx.tolist())) != len(idx):
            raise ValueError(f"slow index {idx} repeats a frame")
        slot[idx] = np.arange(len(idx), dtype=np.int32)
    if flips is not None:
        flips = flips.to(torch.uint8).contiguous()
        if flips.numel() != B:
            raise ValueError(f"expected {B} flip flags, got {flips.numel()}")
    aligned = all(t.data_ptr() % 16 == 0 for t in (x, fast, slow) if t is not None)

    err = _kernel()(
        x.data_ptr(), fast.data_ptr(),
        slow.data_ptr() if slow is not None else None,
        flips.data_ptr() if flips is not None else None,
        slot.ctypes.data, B, T, H, W, t_slow, scale.ctypes.data, bias.ctypes.data,
        int(bool(reverse)), int(out_dtype == torch.bfloat16), int(aligned),
        torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"preprocess kernel launch failed: CUDA error {err}")
    launches += 1
    return [fast] if slow is None else [slow, fast]
