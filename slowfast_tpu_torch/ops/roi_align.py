"""ROIAlign on channels-last features, forward and backward (counterpart of
slowfast_tpu/ops/roi_align.py:106 roi_align; reference detectron2's op at
slowfast/models/head_helper.py:88-94).

The JAX package's rules, exactly: an ROI ``[b, x1, y1, x2, y2]`` in input
pixels is scaled by ``spatial_scale`` (and shifted by -0.5 when
``aligned``; its side is at least 1 when not); each of its ``P x P`` bins
averages an adaptive grid of ``clip(ceil(bin), 1, max_samples)`` samples
per axis (``sampling_ratio`` samples when it is positive); a sample outside
``[-1, H] x [-1, W]`` gives zero, the others are clamped to the map and
interpolated bilinearly. Sums are in fp32 and the output is fp32 whatever
the features' type.

On the card both directions are hand-written kernels
(``csrc/roi_align.cu``): the forward one thread per (ROI, bin, channel),
the backward a deterministic gather per feature element over the ROIs of
its batch, with no atomics. ``roi_align_plain`` is the JAX package's gather
form in plain PyTorch; on a CPU tensor ``roi_align`` runs it (autograd
gives its backward). On a CUDA tensor it launches the kernels or raises.
``launches`` and ``bwd_launches`` count the kernels' launches.
"""

import ctypes

import torch

from . import _build

_MAX_GRID = 16  # RA_MAX_GRID in csrc/roi_align.cu
_MAX_P = 32  # RA_MAX_P
_DTYPES = (torch.bfloat16, torch.float32)

# Kernel launches since the last reset; only _launch_fwd / _launch_bwd add.
launches = 0
bwd_launches = 0


def _fma(a, b, c):
    """``a * b + c`` rounded once to fp32, as the fused multiply-add that
    XLA's CPU compiler makes of the JAX function's ``y1 + ph * bin_h`` (and
    the kernels' ``fmaf``): the fp32 product is exact in float64."""
    return (a.double() * b + c).float()


def _geometry(rois, output_size, spatial_scale, sampling_ratio, aligned, max_samples):
    """Per ROI: the batch index, the box's corner, the bin size and the
    sample grid of each axis, and ``S``, the static samples per axis."""
    rois = rois.float()
    offset = 0.5 if aligned else 0.0
    scale = float(torch.tensor(spatial_scale, dtype=torch.float32))
    x1, y1, x2, y2 = (_fma(rois[:, i], scale, -offset) for i in range(1, 5))
    roi_w, roi_h = x2 - x1, y2 - y1
    if not aligned:
        roi_w, roi_h = roi_w.clamp(min=1.0), roi_h.clamp(min=1.0)
    # XLA divides by the constant P as a product with its fp32 reciprocal.
    inv_p = float(torch.tensor(1.0 / output_size, dtype=torch.float32))
    bin_h, bin_w = roi_h * inv_p, roi_w * inv_p
    if sampling_ratio > 0:
        S = sampling_ratio
        grid_h = torch.full_like(bin_h, float(sampling_ratio))
        grid_w = torch.full_like(bin_w, float(sampling_ratio))
    else:
        S = max_samples
        grid_h = torch.clamp(torch.ceil(bin_h), 1.0, float(S))
        grid_w = torch.clamp(torch.ceil(bin_w), 1.0, float(S))
    return rois[:, 0].long(), (y1, bin_h, grid_h), (x1, bin_w, grid_w), S


def _positions(start, size, grid, output_size, S):
    """``(R, P, S)`` sample coordinates along one axis and the mask of the
    samples inside the adaptive grid."""
    dev = start.device
    p = torch.arange(output_size, dtype=torch.float32, device=dev)[None, :, None]
    s = torch.arange(S, dtype=torch.float32, device=dev)[None, None, :]
    start, size, grid = (t[:, None, None] for t in (start, size, grid))
    pos = _fma(p, size.double(), start.double()) + (s + 0.5) * size / grid
    return pos, (s < grid).float()


def _bilinear(flat, base, y, x, H, W):
    """Bilinear samples of ``flat`` ((B*H*W, C) fp32) at ``(y, x)`` of the
    maps starting at row ``base``; zero outside ``[-1, H] x [-1, W]``."""
    oob = (y < -1.0) | (y > H) | (x < -1.0) | (x > W)
    y = y.clamp(0.0, H - 1.0)
    x = x.clamp(0.0, W - 1.0)
    y0, x0 = torch.floor(y), torch.floor(x)
    y1, x1 = torch.clamp(y0 + 1, max=H - 1.0), torch.clamp(x0 + 1, max=W - 1.0)
    ly, lx = y - y0, x - x0
    hy, hx = 1.0 - ly, 1.0 - lx

    def g(yi, xi):
        return flat[base + yi.long() * W + xi.long()]

    val = (g(y0, x0) * (hy * hx)[..., None] + g(y0, x1) * (hy * lx)[..., None]
           + g(y1, x0) * (ly * hx)[..., None] + g(y1, x1) * (ly * lx)[..., None])
    return torch.where(oob[..., None], torch.zeros((), dtype=flat.dtype, device=flat.device),
                       val)


def roi_align_plain(feats, rois, output_size=7, spatial_scale=1.0 / 16, sampling_ratio=0,
                    aligned=True, max_samples=4):
    """The plain PyTorch version: the JAX package's gather form
    (slowfast_tpu/ops/roi_align.py:38-64, :202-). ``feats`` ``(B, H, W, C)``,
    ``rois`` ``(R, 5)``; returns ``(R, P, P, C)`` fp32 (float64 for float64
    features: a float64 run of a model is the yardstick of its rounding)."""
    B, H, W, C = feats.shape
    P = output_size
    bidx, (y1, bin_h, grid_h), (x1, bin_w, grid_w), S = _geometry(
        rois, P, spatial_scale, sampling_ratio, aligned, max_samples)
    yy, wy = _positions(y1, bin_h, grid_h, P, S)
    xx, wx = _positions(x1, bin_w, grid_w, P, S)
    R = rois.shape[0]
    Y = yy[:, :, None, :, None].expand(R, P, P, S, S)
    X = xx[:, None, :, None, :].expand(R, P, P, S, S)
    wgt = wy[:, :, None, :, None] * wx[:, None, :, None, :]
    base = (bidx * (H * W)).view(R, 1, 1, 1, 1)
    dtype = torch.promote_types(feats.dtype, torch.float32)
    v = _bilinear(feats.to(dtype).reshape(B * H * W, C), base, Y, X, H, W)
    count = (grid_h * grid_w).view(R, 1, 1, 1)
    return (v * wgt[..., None]).sum(dim=(3, 4)) / count


def roi_align(feats, rois, output_size=7, spatial_scale=1.0 / 16, sampling_ratio=0,
              aligned=True, max_samples=4, rois_per_batch=0):
    """ROIAlign of ``feats`` ``(B, H, W, C)`` (bf16 or fp32) at ``rois``
    ``(R, 5)`` rows ``[batch_index, x1, y1, x2, y2]``; returns ``(R, P, P,
    C)`` fp32, differentiable in ``feats``. ``rois_per_batch`` M > 0 says
    that rows ``b*M .. b*M+M-1`` are batch b's (the RoI head's padded
    layout); with 0 the backward kernel sorts the ROIs by batch on the card."""
    if feats.dim() != 4 or rois.dim() != 2 or rois.shape[1] != 5:
        raise ValueError(f"expected (B,H,W,C) features and (R,5) rois, got "
                         f"{tuple(feats.shape)} and {tuple(rois.shape)}")
    args = (output_size, float(spatial_scale), int(sampling_ratio), bool(aligned),
            int(max_samples))
    if feats.device.type == "cpu":
        return roi_align_plain(feats, rois, *args)
    if feats.device.type != "cuda":
        raise ValueError(f"no ROIAlign kernel for device {feats.device}")
    return _RoIAlign.apply(feats, rois, args, int(rois_per_batch))


class _RoIAlign(torch.autograd.Function):
    """The forward kernel with the deterministic backward kernel."""

    @staticmethod
    def forward(ctx, feats, rois, args, rois_per_batch):
        rois = rois.float().contiguous()
        ctx.save_for_backward(rois)
        ctx.args, ctx.rois_per_batch = args, rois_per_batch
        ctx.shape, ctx.dtype = feats.shape, feats.dtype
        return _launch_fwd(feats, rois, *args)

    @staticmethod
    def backward(ctx, grad):
        (rois,) = ctx.saved_tensors
        return (_launch_bwd(grad, rois, ctx.shape, ctx.dtype, ctx.rois_per_batch, *ctx.args),
                None, None, None)


def batch_lists(rois, batch_size):
    """The backward kernel's per-batch ROI lists for ROIs in any order:
    ``order`` (R int32), the rows batch by batch in ascending order, and
    ``offsets`` (B + 1 int32), where batch b's run of ``order`` starts."""
    bidx = rois[:, 0].long()
    order = torch.sort(bidx, stable=True).indices.to(torch.int32)
    offsets = torch.zeros(batch_size + 1, dtype=torch.int32, device=rois.device)
    offsets[1:] = torch.cumsum(torch.bincount(bidx, minlength=batch_size)[:batch_size], 0)
    return order, offsets


def _check(feats, rois, output_size, sampling_ratio, max_samples):
    if feats.dtype not in _DTYPES:
        raise ValueError(f"the ROIAlign kernels take {_DTYPES} features, got {feats.dtype}")
    if rois.device != feats.device:
        raise ValueError(f"rois on {rois.device}, features on {feats.device}")
    if not 0 < output_size <= _MAX_P or max_samples <= 0 or max(max_samples,
                                                                 sampling_ratio) > _MAX_GRID:
        raise ValueError(f"the ROIAlign kernels take output_size <= {_MAX_P} and at most "
                         f"{_MAX_GRID} samples a bin per axis")


def _kernels():
    lib = _build.load("roi_align")
    fwd, bwd = lib.sf_roi_align_fwd, lib.sf_roi_align_bwd
    if fwd.argtypes is None:
        ptr, i64, i32, f32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_float
        fwd.restype = bwd.restype = i32
        fwd.argtypes = [ptr, ptr, ptr, i64, i64, i64, i64, i64, i32, f32, i32, i32, i32, i32,
                        ptr]
        bwd.argtypes = [ptr, ptr, ptr, ptr, ptr, i64, i64, i64, i64, i64, i32, f32, i32, i32,
                        i32, i32, i32, ptr]
    return fwd, bwd


def _launch_fwd(feats, rois, output_size, spatial_scale, sampling_ratio, aligned, max_samples):
    global launches
    _check(feats, rois, output_size, sampling_ratio, max_samples)
    feats = feats.contiguous()
    B, H, W, C = feats.shape
    R = rois.shape[0]
    out = torch.empty((R, output_size, output_size, C), dtype=torch.float32,
                      device=feats.device)
    if R == 0:
        return out
    err = _kernels()[0](
        feats.data_ptr(), rois.data_ptr(), out.data_ptr(), B, H, W, C, R, output_size,
        spatial_scale, sampling_ratio, int(aligned), max_samples,
        int(feats.dtype == torch.bfloat16), torch.cuda.current_stream(feats.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ROIAlign forward kernel launch failed: CUDA error {err}")
    launches += 1
    return out


def _launch_bwd(grad, rois, shape, dtype, rois_per_batch, output_size, spatial_scale,
                sampling_ratio, aligned, max_samples):
    global bwd_launches
    B, H, W, C = shape
    R = rois.shape[0]
    grad = grad.float().contiguous()
    if R == 0:
        return torch.zeros(shape, dtype=dtype, device=grad.device)
    out = torch.empty(shape, dtype=dtype, device=grad.device)
    order, offsets = batch_lists(rois, B) if rois_per_batch <= 0 else (None, None)
    err = _kernels()[1](
        grad.data_ptr(), rois.data_ptr(), order.data_ptr() if order is not None else None,
        offsets.data_ptr() if offsets is not None else None, out.data_ptr(), B, H, W, C, R,
        output_size, spatial_scale, sampling_ratio, int(aligned), max_samples,
        max(rois_per_batch, 0), int(dtype == torch.bfloat16),
        torch.cuda.current_stream(grad.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ROIAlign backward kernel launch failed: CUDA error {err}")
    bwd_launches += 1
    return out
