"""Common building blocks on NTHWC tensors (counterpart of
slowfast_tpu/models/common.py; reference slowfast/models/common.py).

Public tensors are NTHWC, as in the JAX package. Inside a module,
``x.permute(0, 4, 1, 2, 3)`` is a free NCTHW view with ``channels_last_3d``
strides, which ``conv3d`` and the ATen pools take directly, so no layout
copy appears between layers.
"""

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from slowfast_tpu_torch.ops import avg_pool, max_pool


def sum_dtype(dtype):
    """The dtype the CNN modules take sums and statistics in: fp32, or
    float64 for float64 tensors (a float64 run of the model is the
    yardstick of its fp32 rounding)."""
    return torch.promote_types(dtype, torch.float32)


def to_ncthw(x):
    return x.permute(0, 4, 1, 2, 3)


def to_nthwc(x):
    return x.permute(0, 2, 3, 4, 1)


def trunc_normal_(tensor, std=0.02, generator=None):
    """Normal(0, std) truncated at ±2 std (flax ``truncated_normal(std)``,
    slowfast_tpu/models/attention.py:33)."""
    with torch.no_grad():
        return nn.init.trunc_normal_(tensor, 0.0, std, -2.0 * std, 2.0 * std,
                                     generator=generator)


def linear(x, layer, dtype):
    """``layer`` applied as flax ``nn.Dense(dtype=dtype)`` does: input,
    weight and bias cast to ``dtype``."""
    bias = layer.bias.to(dtype) if layer.bias is not None else None
    return F.linear(x.to(dtype), layer.weight.to(dtype), bias)


def layer_norm(x, ln):
    """``nn.LayerNorm`` ``ln`` computed in fp32 with an fp32 output, as flax
    ``nn.LayerNorm`` without a ``dtype`` gives on fp32 parameters."""
    return F.layer_norm(x.float(), ln.normalized_shape, ln.weight, ln.bias, ln.eps)


class _GeluExact(torch.autograd.Function):
    """Exact-erf GELU with the JAX package's custom VJP
    (slowfast_tpu/models/common.py:184-210): the forward computes
    ``y = x Φ(x)`` in fp32 and saves the derivative ``Φ(x) + x φ(x)``
    rounded to the input dtype; the backward is ``round(g · d)``."""

    @staticmethod
    def forward(ctx, x):
        x32 = x.float()
        cdf = 0.5 * (1.0 + torch.erf(x32 * 2.0 ** -0.5))
        pdf = torch.exp(-0.5 * x32 * x32) * (2.0 * math.pi) ** -0.5
        ctx.save_for_backward((cdf + x32 * pdf).to(x.dtype))
        return (x32 * cdf).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        (d,) = ctx.saved_tensors
        return (g.float() * d.float()).to(g.dtype)


def gelu_exact(x):
    """Exact-erf GELU computed in fp32 and cast back, with the saved-derivative
    gradient of ``slowfast_tpu/models/common.py:184 gelu_exact``."""
    return _GeluExact.apply(x)


def dropout(x, rate, generator):
    """flax ``nn.Dropout`` in training: each element kept with probability
    ``1 - rate`` and scaled by ``1 / (1 - rate)``, the mask drawn from
    ``generator``."""
    keep = 1.0 - rate
    u = torch.rand(x.shape, generator=generator, device=x.device)
    return torch.where(u < keep, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


class Mlp(nn.Module):
    """fc1 -> exact GELU -> dropout -> fc2 -> dropout in the compute dtype
    (slowfast_tpu/models/common.py:214-246, reference
    slowfast/models/common.py:7-34). The dropouts draw from ``generator``
    (the model's, set by ``models.build.build_model``) in training and are
    identity in eval and at rate 0."""

    def __init__(self, in_features, hidden_features, out_features, drop_rate=0.0,
                 dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.drop_rate = drop_rate
        self.fc1 = nn.Linear(in_features, hidden_features)
        self.fc2 = nn.Linear(hidden_features, out_features)
        self.generator = None

    def _drop(self, x):
        if self.training and self.drop_rate > 0.0:
            return dropout(x, self.drop_rate, self.generator)
        return x

    def forward(self, x):
        x = self._drop(gelu_exact(linear(x, self.fc1, self.dtype)))
        return self._drop(linear(x, self.fc2, self.dtype))


def _linear_resize_weights(n_in, n_out):
    """``(n_in, n_out)`` weights of ``jax.image.resize(method="linear")``
    along one axis (jax/_src/image/scale.py ``compute_weight_mat``, with
    antialiasing, in fp32 as JAX computes them): a triangle kernel at
    half-pixel centres, widened by ``n_in / n_out`` when the axis shrinks,
    each column normalized to sum 1."""
    inv_scale = np.float32(1.0 / (n_out / n_in))
    kernel_scale = max(inv_scale, np.float32(1.0))
    sample = (np.arange(n_out, dtype=np.float32) + np.float32(0.5)) * inv_scale - np.float32(0.5)
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=np.float32)[:, None]) / kernel_scale
    w = np.maximum(np.float32(0.0), np.float32(1.0) - x)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                 w / np.where(total != 0, total, 1), 0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], w, 0).astype(np.float32)


def resize_linear(x, shape):
    """``x`` resized to ``shape`` as ``jax.image.resize(x, shape, "linear")``
    (or ``"trilinear"``) does: axis by axis, each axis whose size changes
    contracted with its weight matrix (``_linear_resize_weights``).

    JAX antialiases when an axis shrinks (the kernel widens to cover every
    input sample); PySlowFast's ``F.interpolate`` does not. The port follows
    JAX, the package it is held to (ROADMAP Queue 3)."""
    for axis, (n_in, n_out) in enumerate(zip(x.shape, shape)):
        if n_in != n_out:
            w = torch.from_numpy(_linear_resize_weights(n_in, n_out)).to(x.device, x.dtype)
            x = torch.movedim(torch.tensordot(x, w, dims=([axis], [0])), -1, axis)
    return x


def msra_fill_(weight, generator=None):
    """MSRA/He fan-out normal init (JAX ``variance_scaling(2, fan_out,
    normal)``, reference c2_msra_fill) for a (O, I/groups, kt, kh, kw) conv
    weight."""
    fan_out = weight.shape[0] * math.prod(weight.shape[2:])
    with torch.no_grad():
        return weight.normal_(0.0, math.sqrt(2.0 / fan_out), generator=generator)


class Conv3D(nn.Module):
    """3D conv on NTHWC inputs with torch-style symmetric integer padding.

    The weight is fp32 in torch layout (O, I/groups, kt, kh, kw) and is cast
    to the input dtype at each call, as slowfast_tpu/models/common.py:48
    does. The conv takes the ``channels_last_3d`` view of its NTHWC input,
    channelwise convs too: X3D-M's trained no faster on a contiguous NCDHW
    copy (PERF.md), as cuDNN's channelwise weight-gradient kernel takes most
    of the step either way.
    """

    def __init__(self, dim_in, dim_out, kernel, stride=(1, 1, 1),
                 padding=(0, 0, 0), groups=1, bias=False, dilation=(1, 1, 1)):
        super().__init__()
        self.stride = tuple(stride)
        self.padding = tuple(padding)
        self.dilation = tuple(dilation)
        self.groups = groups
        self.weight = nn.Parameter(torch.empty(dim_out, dim_in // groups, *kernel))
        self.bias = nn.Parameter(torch.zeros(dim_out)) if bias else None

    def forward(self, x):
        w = self.weight.to(x.dtype)
        b = self.bias.to(x.dtype) if self.bias is not None else None
        y = F.conv3d(to_ncthw(x), w, b, self.stride, self.padding,
                     self.dilation, self.groups)
        return to_nthwc(y)


class Conv2D(nn.Module):
    """2D conv on NHWC inputs (the image patch stem): the weight fp32 in
    torch layout (O, I, kh, kw), cast to the input dtype at each call, and
    the conv on the ``channels_last`` view of the input."""

    def __init__(self, dim_in, dim_out, kernel, stride=(1, 1), padding=(0, 0), bias=False):
        super().__init__()
        self.stride = tuple(stride)
        self.padding = tuple(padding)
        self.weight = nn.Parameter(torch.empty(dim_out, dim_in, *kernel))
        self.bias = nn.Parameter(torch.zeros(dim_out)) if bias else None

    def forward(self, x):
        w = self.weight.to(x.dtype)
        b = self.bias.to(x.dtype) if self.bias is not None else None
        y = F.conv2d(x.permute(0, 3, 1, 2), w, b, self.stride, self.padding)
        return y.permute(0, 2, 3, 1)


def round_width(width, multiplier, min_width=1, divisor=1):
    """X3D/MViT width rounding (reference slowfast/models/utils.py:10-25)."""
    if not multiplier:
        return width
    width *= multiplier
    min_width = min_width or divisor
    width_out = max(min_width, int(width + divisor / 2) // divisor * divisor)
    if width_out < 0.9 * width:
        width_out += divisor
    return int(width_out)


class SE(nn.Module):
    """Squeeze-and-excitation (slowfast_tpu/models/common.py:293-318,
    reference operators.py:15-59): the mean over T, H, W (in ``sum_dtype``),
    1x1x1 ``fc1`` -> ReLU -> ``fc2`` -> sigmoid, times the input. ``fc1``
    has ``round_width(dim_in, ratio)`` channels, at least 8 and a multiple
    of 8."""

    def __init__(self, dim_in, ratio):
        super().__init__()
        dim_fc = round_width(dim_in, ratio, min_width=8, divisor=8)
        self.fc1 = Conv3D(dim_in, dim_fc, (1, 1, 1), bias=True)
        self.fc2 = Conv3D(dim_fc, dim_in, (1, 1, 1), bias=True)

    def forward(self, x):
        s = x.to(sum_dtype(x.dtype)).mean(dim=(1, 2, 3), keepdim=True).to(x.dtype)
        return x * torch.sigmoid(self.fc2(F.relu(self.fc1(s))))


def max_pool3d(x, kernel, stride=None, padding=(0, 0, 0)):
    """Torch MaxPool3d on NTHWC input, with the deterministic backward of
    ``ops/max_pool.py`` (a kernel on the card)."""
    return max_pool.max_pool3d(x, kernel, stride, padding)


def avg_pool3d(x, kernel, stride=None, padding=(0, 0, 0)):
    """Torch AvgPool3d on NTHWC input (padding counted, as flax's avg_pool).

    Sums in fp32 and rounds once to the input dtype, which is what ATen's
    CUDA kernel does for bf16 and what its CPU kernel, which has no bf16
    version, then does too. The padding is explicit zeros: ATen refuses an
    input axis shorter than the kernel even when the padding covers it (an
    MViT avg-mode pool of 3 over 2 frames), and zeros counted in the window
    are what its ``count_include_pad`` computes. The pool itself is
    ``ops/avg_pool.py``'s: ATen's forward, a deterministic backward (a
    kernel on the card).
    """
    y = to_ncthw(x).to(sum_dtype(x.dtype))
    if any(padding):
        pt, ph, pw = padding
        y = F.pad(y, (pw, pw, ph, ph, pt, pt))
    return avg_pool.avg_pool3d(to_nthwc(y), kernel, stride or kernel).to(x.dtype)


class DropPath(nn.Module):
    """Stochastic depth (slowfast_tpu/models/common.py:161-181, reference
    slowfast/models/common.py:46-70): in training each sample's branch is
    kept with probability ``1 - rate`` and scaled by ``1 / (1 - rate)``;
    identity in eval and at rate 0. The keep mask is drawn from
    ``generator`` (the model's, set by ``models.build.build_model``)."""

    def __init__(self, rate=0.0):
        super().__init__()
        self.rate = rate
        self.generator = None

    def forward(self, x):
        if not self.training or self.rate == 0.0:
            return x
        keep = 1.0 - self.rate
        shape = (x.shape[0],) + (1,) * (x.dim() - 1)
        u = torch.rand(shape, generator=self.generator, device=x.device)
        return x / keep * (u < keep).to(x.dtype)


def checkpointed(fn, generator, *args):
    """``fn(*args)`` under ``torch.utils.checkpoint`` (non-reentrant). The
    checkpoint restores the global RNG states for the recompute, not the
    model's ``generator``, from which drop path and dropout draw: its state
    is kept before the first run, set again for the recompute and put back
    after it, so the recompute draws the first run's masks and leaves the
    generator where the forward left it. ``generator`` None: nothing to
    replay."""
    start = generator.get_state() if generator is not None else None
    runs = []

    def run(*a):
        if not runs or start is None:
            runs.append(1)
            return fn(*a)
        after = generator.get_state()
        generator.set_state(start)
        try:
            return fn(*a)
        finally:
            generator.set_state(after)

    return checkpoint(run, *args, use_reentrant=False)


FUSION_MODES = ("add", "max", "min", "avg", "concat", "concat_linear", "concat_linear_1",
                "concat_linear_2", "ln+mlp")


class TwoStreamFusion(nn.Module):
    """Fuses the two streams of Rev-MViT, concatenated on the channels
    (slowfast_tpu/models/common.py:254-290, reference common.py:73-146):
    ``add``, ``max``, ``min`` and ``avg`` of the halves (width ``dim // 2``),
    ``concat`` as it is, ``concat_linear``/``_1`` ``x + fuse_fn(x)``,
    ``concat_linear_2`` ``x + fuse_fn2(fuse_fn1(x))`` and ``ln+mlp``
    ``x + fuse_mlp(fuse_norm(x))`` (width ``dim``). The projections are flax
    ``nn.Dense`` without a dtype, as in JAX: they compute in fp32 (the
    promotion of the input and the fp32 weights), and so does the sum;
    ``fuse_norm`` has flax's default epsilon, 1e-6."""

    def __init__(self, mode, dim=0):
        super().__init__()
        if mode not in FUSION_MODES:
            raise NotImplementedError(f"TwoStreamFusion mode {mode}")
        self.mode = mode
        if mode in ("concat_linear", "concat_linear_1"):
            self.fuse_fn = nn.Linear(dim, dim)
        elif mode == "concat_linear_2":
            self.fuse_fn1 = nn.Linear(dim, dim)
            self.fuse_fn2 = nn.Linear(dim, dim)
        elif mode == "ln+mlp":
            self.fuse_norm = nn.LayerNorm(dim, eps=1e-6)
            self.fuse_mlp = Mlp(dim, 4 * dim, dim)

    def out_width(self, width):
        """The fused width of a ``width``-wide input."""
        return width // 2 if self.mode in ("add", "max", "min", "avg") else width

    def forward(self, x):
        mode = self.mode
        if mode == "concat":
            return x
        if mode in ("add", "max", "min", "avg"):
            a, b = x.chunk(2, dim=-1)
            if mode == "add":
                return a + b
            if mode == "max":
                return torch.maximum(a, b)
            if mode == "min":
                return torch.minimum(a, b)
            return (a + b) * 0.5
        dtype = torch.promote_types(x.dtype, torch.float32)
        if mode == "ln+mlp":
            return x + self.fuse_mlp(layer_norm(x, self.fuse_norm))
        if mode == "concat_linear_2":
            return x + linear(linear(x, self.fuse_fn1, dtype), self.fuse_fn2, dtype)
        return x + linear(x, self.fuse_fn, dtype)
