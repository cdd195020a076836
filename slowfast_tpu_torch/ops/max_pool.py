"""Max pooling on channels-last video with a deterministic backward
(counterpart of slowfast_tpu/ops/video_conv.py:464 _max_pool_2d_argmax_bwd,
the JAX package's argmax-saving VJP of its max pools).

The forward is ATen's ``max_pool3d`` with its indices, as the JAX package's
forward is plain XLA. The backward adds each window's gradient to the input
position that won it, gathering per input element over the windows that
cover it in a fixed order, with the sums in fp32 (float64 for float64)
rounded once to the gradient's type. On the card it is a hand-written
kernel (``csrc/max_pool3d_bwd.cu``) with no atomics, where ATen's CUDA
backward scatters with atomic adds; ``max_pool3d_bwd_plain`` is the same
gather in plain PyTorch, adding in the kernel's order, and runs on a CPU
tensor. On a CUDA tensor the kernel launches or the call raises.
``bwd_launches`` counts the kernel's launches.
"""

import ctypes

import torch
import torch.nn.functional as F

from . import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float64: 2}

# Kernel launches since the last reset; only _launch_bwd adds.
bwd_launches = 0


def _ncthw(x):
    return x.permute(0, 4, 1, 2, 3)


def _nthwc(x):
    return x.permute(0, 2, 3, 4, 1)


def windows(size, out_size, k, s, p, device=None):
    """The windows of one axis that cover each input position, in the
    kernel's order: ``D = (k - 1) // s + 1`` pairs of ``(o, valid)``, ``o``
    the window of every position (clamped into range) and ``valid`` whether
    it covers the position."""
    i = torch.arange(size, device=device)
    d = (k - 1) // s + 1
    first = torch.div(i + p, s, rounding_mode="floor") - (d - 1)
    taps = []
    for j in range(d):
        o = first + j
        taps.append((o.clamp(0, out_size - 1), (o >= 0) & (o < out_size) & (o * s - p + k > i)))
    return taps


def max_pool3d_bwd_plain(grad_out, idx, in_shape, kernel, stride, padding, dtype=None):
    """The backward in plain PyTorch. ``grad_out`` and ``idx`` ``(N, To, Ho,
    Wo, C)`` (any strides; ``idx`` ATen's index ``(t * H + h) * W + w``
    within each ``(T, H, W)`` volume), ``in_shape`` ``(N, T, H, W, C)``;
    returns the input gradient in ``dtype`` (``grad_out``'s by default)."""
    N, T, H, W, C = in_shape
    dtype = dtype or grad_out.dtype
    dev = grad_out.device
    taps = [windows(size, grad_out.shape[1 + a], kernel[a], stride[a], padding[a], dev)
            for a, size in enumerate((T, H, W))]
    pos = torch.arange(T * H * W, device=dev).view(1, T, H, W, 1)
    acc = torch.zeros(in_shape, dtype=torch.promote_types(dtype, torch.float32), device=dev)
    zero = torch.zeros((), dtype=acc.dtype, device=dev)
    for ot, vt in taps[0]:
        for oh, vh in taps[1]:
            for ow, vw in taps[2]:
                valid = (vt[:, None, None] & vh[None, :, None] & vw[None, None, :])[None, ..., None]
                g = grad_out[:, ot][:, :, oh][:, :, :, ow]
                ix = idx[:, ot][:, :, oh][:, :, :, ow]
                acc = acc + torch.where(valid & (ix == pos), g.to(acc.dtype), zero)
    return acc.to(dtype)


class MaxPool3d(torch.autograd.Function):
    """ATen's forward with its indices; the deterministic backward."""

    @staticmethod
    def forward(ctx, x, kernel, stride, padding):
        y, idx = F.max_pool3d(_ncthw(x), kernel, stride, padding, return_indices=True)
        ctx.save_for_backward(idx)
        ctx.geometry = (tuple(x.shape), x.dtype, kernel, stride, padding)
        return _nthwc(y)

    @staticmethod
    def backward(ctx, grad):
        (idx,) = ctx.saved_tensors
        shape, dtype, kernel, stride, padding = ctx.geometry
        if grad.device.type == "cpu":
            gx = max_pool3d_bwd_plain(grad, _nthwc(idx), shape, kernel, stride, padding, dtype)
        else:
            gx = _launch_bwd(grad, _nthwc(idx), shape, dtype, kernel, stride, padding)
        return gx, None, None, None


def max_pool3d(x, kernel, stride=None, padding=(0, 0, 0)):
    """Max pool of ``x`` ``(N, T, H, W, C)`` with torch's MaxPool3d rules
    (the first maximum of a window wins; padding never does)."""
    kernel = tuple(int(k) for k in kernel)
    stride = tuple(int(s) for s in (stride or kernel))
    padding = tuple(int(p) for p in padding)
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no max-pool backward for device {x.device}")
    return MaxPool3d.apply(x, kernel, stride, padding)


def _kernel():
    fn = _build.load("max_pool3d_bwd").sf_max_pool3d_bwd
    if fn.argtypes is None:
        ptr, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        fn.restype = i32
        fn.argtypes = ([ptr, ptr, ptr] + [i64] * 8 + [ctypes.POINTER(i64)] * 2
                       + [ctypes.POINTER(i32)] * 3 + [i32, ptr])
    return fn


def _launch_bwd(grad, idx, shape, dtype, kernel, stride, padding):
    global bwd_launches
    if grad.dtype != dtype or dtype not in _DTYPES:
        raise ValueError(f"the max-pool backward kernel takes {list(_DTYPES)} gradients of the "
                         f"input's type, got {grad.dtype} for a {dtype} input")
    if idx.dtype != torch.int64 or idx.shape != grad.shape or idx.device != grad.device:
        raise ValueError(f"indices {idx.dtype} {tuple(idx.shape)} on {idx.device} for a "
                         f"gradient {tuple(grad.shape)} on {grad.device}")
    out = torch.empty(shape, dtype=dtype, device=grad.device)
    as_c = (lambda vals, c_type: (c_type * len(vals))(*vals))
    gs, ist = as_c(grad.stride(), ctypes.c_longlong), as_c(idx.stride(), ctypes.c_longlong)
    k, s, p = (as_c(v, ctypes.c_int) for v in (kernel, stride, padding))
    err = _kernel()(grad.data_ptr(), idx.data_ptr(), out.data_ptr(), *shape, *grad.shape[1:4],
                    gs, ist, k, s, p, _DTYPES[dtype],
                    torch.cuda.current_stream(grad.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"max-pool backward kernel launch failed: CUDA error {err}")
    bwd_launches += 1
    return out
