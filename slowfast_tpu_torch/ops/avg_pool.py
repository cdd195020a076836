"""Average pooling on channels-last video with a deterministic backward
(counterpart of the average pools of slowfast_tpu/models/common.py:153
avg_pool3d, flax's ``nn.avg_pool``, whose VJP is plain XLA).

The forward is ATen's ``avg_pool3d`` without padding (the caller pads with
explicit zeros, which the window then counts), which is deterministic. The
backward gathers per input element over the windows that cover it, in a
fixed order (t, h, w ascending), adding ``grad_out / (kT * kH * kW)`` with
the sums in fp32 (float64 for float64). On the card it is a hand-written
kernel (``csrc/avg_pool3d_bwd.cu``) with no atomics, where ATen's CUDA
backward adds with atomics and torch's deterministic mode refuses it;
``avg_pool3d_bwd_plain`` adds the same terms in plain PyTorch, one window
offset at a time in the kernel's order of the windows, so the two give the
same bits, and runs on a CPU tensor. On a CUDA tensor the kernel
launches or the call raises. ``bwd_launches`` counts the kernel's launches.
"""

import ctypes
import math

import torch
import torch.nn.functional as F

from . import _build
from .max_pool import _ncthw, _nthwc

_DTYPES = {torch.float32: 0, torch.float64: 1}

# Kernel launches since the last reset; only _launch_bwd adds.
bwd_launches = 0


def avg_pool3d_bwd_plain(grad_out, in_shape, kernel, stride):
    """The backward in plain PyTorch. ``grad_out`` ``(N, To, Ho, Wo, C)``
    (any strides), ``in_shape`` ``(N, T, H, W, C)``; returns the input
    gradient in ``grad_out``'s dtype (fp32 or float64)."""
    # A 0-dim tensor on the gradient's device: a CUDA tensor divided by a
    # Python number is multiplied by its reciprocal, which rounds otherwise.
    div = torch.full((), math.prod(kernel), dtype=grad_out.dtype, device=grad_out.device)
    term = grad_out / div
    acc = torch.zeros(in_shape, dtype=grad_out.dtype, device=grad_out.device)
    ot, oh, ow = grad_out.shape[1:4]
    st, sh, sw = stride
    # Offset r of window o lands on input o * s + r: the offsets from the last
    # to the first add each input's windows t, h, w ascending, as the kernel.
    for rt in reversed(range(kernel[0])):
        for rh in reversed(range(kernel[1])):
            for rw in reversed(range(kernel[2])):
                acc[:, rt:rt + (ot - 1) * st + 1:st, rh:rh + (oh - 1) * sh + 1:sh,
                    rw:rw + (ow - 1) * sw + 1:sw] += term
    return acc


class AvgPool3d(torch.autograd.Function):
    """ATen's forward on ``(N, T, H, W, C)``; the deterministic backward."""

    @staticmethod
    def forward(ctx, x, kernel, stride):
        ctx.geometry = (tuple(x.shape), kernel, stride)
        return _nthwc(F.avg_pool3d(_ncthw(x), kernel, stride))

    @staticmethod
    def backward(ctx, grad):
        shape, kernel, stride = ctx.geometry
        if grad.device.type == "cpu":
            gx = avg_pool3d_bwd_plain(grad, shape, kernel, stride)
        else:
            gx = _launch_bwd(grad, shape, kernel, stride)
        return gx, None, None


def avg_pool3d(x, kernel, stride=None):
    """Average pool of ``x`` ``(N, T, H, W, C)``, fp32 or float64, with no
    padding (each window's mean)."""
    kernel = tuple(int(k) for k in kernel)
    stride = tuple(int(s) for s in (stride or kernel))
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no average-pool backward for device {x.device}")
    return AvgPool3d.apply(x, kernel, stride)


def _kernel():
    fn = _build.load("avg_pool3d_bwd").sf_avg_pool3d_bwd
    if fn.argtypes is None:
        ptr, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        fn.restype = i32
        fn.argtypes = ([ptr, ptr] + [i64] * 8 + [ctypes.POINTER(i64)]
                       + [ctypes.POINTER(i32)] * 2 + [i32, ptr])
    return fn


def _launch_bwd(grad, shape, kernel, stride):
    global bwd_launches
    if grad.dtype not in _DTYPES:
        raise ValueError(f"the average-pool backward kernel takes {list(_DTYPES)} gradients, "
                         f"got {grad.dtype}")
    out = torch.empty(shape, dtype=grad.dtype, device=grad.device)
    as_c = (lambda vals, c_type: (c_type * len(vals))(*vals))
    k, s = (as_c(v, ctypes.c_int) for v in (kernel, stride))
    err = _kernel()(grad.data_ptr(), out.data_ptr(), *shape, *grad.shape[1:4],
                    as_c(grad.stride(), ctypes.c_longlong), k, s, _DTYPES[grad.dtype],
                    torch.cuda.current_stream(grad.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"average-pool backward kernel launch failed: CUDA error {err}")
    bwd_launches += 1
    return out
