"""MViT pooling attention on (B, N, C) tokens (counterpart of
slowfast_tpu/models/attention.py; reference slowfast/models/attention.py).

Tokens stay ``(B, N, heads*head_dim)``; the head split is a reshape. Each
block pools q, k and v (``conv``: one depthwise ``conv3d`` whose per-head
kernel is repeated across heads; ``conv_unshared``: one tap per channel;
``avg``/``max``: parameter-free pools), folds the decomposed
relative-position bias into the q·kᵀ contraction as extra channels, and runs
the attention core on a hand-written CUDA kernel (``ops/attention.py``): the
constant-shift core by default, the exact-softmax core under
``TPU.PALLAS_ATTENTION``.

Dtypes follow the JAX package: the block norms ``norm1``/``norm2`` give fp32
(flax LayerNorm without a dtype), every Linear casts its input and weights
to the compute dtype, the pool norms compute in fp32 and return the compute
dtype, so the residual stream stays in the compute dtype.
"""

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from slowfast_tpu_torch.ops import attention as attention_ops

from .common import (Conv3D, DropPath, Mlp, avg_pool3d, dropout, layer_norm, linear,
                     max_pool3d, resize_linear, to_ncthw, to_nthwc)

POOL_MODES = ("conv", "conv_unshared", "avg", "max")


def pool_tokens_flat(x, thw, kernel, stride, mode, has_cls, pool_w=None, heads=1):
    """Pool ``(B, L, C)`` tokens over their (T, H, W) grid without a head
    split; returns ``(pooled, new_thw)``.

    ``conv``/``conv_unshared``: one depthwise conv (groups = C) whose kernel
    ``pool_w`` ``(d, 1, kt, kh, kw)`` is repeated ``heads`` times, so
    channel c uses tap ``c % d`` (``conv_unshared`` passes ``d = C`` and
    ``heads = 1``). ``max``/``avg``: max or average pooling, the average
    counting the zero padding as flax's ``avg_pool`` does. Padding is
    ``k // 2``; the cls token is split off first and put back.
    """
    if not kernel:
        return x, list(thw)
    B, _, C = x.shape
    cls_tok = None
    if has_cls:
        cls_tok, x = x[:, :1], x[:, 1:]
    x5 = x.reshape(B, *thw, C)
    pad = tuple(k // 2 for k in kernel)
    if mode == "max":
        y = max_pool3d(x5, kernel, stride, pad)
    elif mode == "avg":
        y = avg_pool3d(x5, kernel, stride, pad)
    else:  # conv, conv_unshared
        # Contiguous NCDHW: on a channels-last view cuDNN runs a generic
        # kernel once per channel group. On an H100 in bf16 that made the
        # MViTv2-S step's conv time 175 ms at B=8; NCDHW takes it to 4.3 ms
        # (profile_eval.py).
        w = pool_w.to(x.dtype).repeat(heads, 1, 1, 1, 1)
        y = F.conv3d(to_ncthw(x5).contiguous(), w, None, tuple(stride), pad, 1, C)
        y = to_nthwc(y)
    new_thw = list(y.shape[1:4])
    y = y.reshape(B, -1, C)
    if has_cls:
        y = torch.cat([cls_tok, y], dim=1)
    return y, new_thw


def _resize_rel_pos(rel_pos, d):
    """The ``(L, C)`` rel-pos table at ``d`` rows (reference
    attention.py:48-61), resized as the JAX package resizes it
    (``jax.image.resize(method="linear")``: ``common.resize_linear``). A
    table grows on odd grids (a q stride of 2 on 7 gives 4, while the table
    was sized for 7 // 2 = 3) and shrinks when the test input is smaller
    than the training one; shrinking is antialiased, as in JAX."""
    if rel_pos.shape[0] == d:
        return rel_pos
    return resize_linear(rel_pos, (d, rel_pos.shape[1]))


def _rel_dist(q_size, k_size):
    """Relative-distance index matrix with q/k ratio rescaling
    (reference attention.py:72-85)."""
    q_ratio = max(k_size / q_size, 1.0)
    k_ratio = max(q_size / k_size, 1.0)
    dist = np.arange(q_size)[:, None] * q_ratio - np.arange(k_size)[None, :] * k_ratio
    dist += (k_size - 1) * k_ratio
    return torch.from_numpy(dist.astype(np.int64))


def _augment_qk_relpos(q, k, scale, has_cls, q_shape, k_shape,
                       rel_pos_h, rel_pos_w, rel_pos_t):
    """Fold the decomposed rel-pos bias into q/k for one contraction
    (slowfast_tpu/models/attention.py:110).

    ``attn[q, k] = scale q·k + Rh_q[kh(k)] + Rw_q[kw(k)] + Rt_q[kt(k)]``: q
    gains the per-axis bias rows, k the matching one-hot position indicators
    (zero on the cls row and column). Returns ``(q_aug, k_aug)``.
    """
    sp = 1 if has_cls else 0
    q_t, q_h, q_w = q_shape
    k_t, k_h, k_w = k_shape
    B, Nq, nh, C = q.shape
    Nk = k.shape[1]
    dtype, dev = q.dtype, q.device
    r_q = q[:, sp:].reshape(B, q_t, q_h, q_w, nh, C)

    def table(rel_pos, q_size, k_size):
        t = _resize_rel_pos(rel_pos, 2 * max(q_size, k_size) - 1)
        return t[_rel_dist(q_size, k_size).to(dev)].to(dtype)

    def onehot_axis(axis_len, period, block):
        idx = (np.arange(k_t * k_h * k_w) // block) % period
        return torch.from_numpy(np.eye(axis_len, dtype=np.float32)[idx])

    extras_q, extras_k = [], []
    if rel_pos_h is not None:
        rel_h = torch.einsum("bxyznc,ykc->bxyznk", r_q, table(rel_pos_h, q_h, k_h))
        rel_w = torch.einsum("bxyznc,zkc->bxyznk", r_q, table(rel_pos_w, q_w, k_w))
        extras_q += [rel_h.reshape(B, Nq - sp, nh, k_h), rel_w.reshape(B, Nq - sp, nh, k_w)]
        extras_k += [onehot_axis(k_h, k_h, k_w), onehot_axis(k_w, k_w, 1)]
    if rel_pos_t is not None:
        rel_t = torch.einsum("bxyznc,xkc->bxyznk", r_q, table(rel_pos_t, q_t, k_t))
        extras_q.append(rel_t.reshape(B, Nq - sp, nh, k_t))
        extras_k.append(onehot_axis(k_t, k_t, k_h * k_w))

    eq = F.pad(torch.cat(extras_q, dim=-1), (0, 0, 0, 0, sp, 0))
    ek = F.pad(torch.cat(extras_k, dim=-1).to(dev, dtype), (0, 0, sp, 0))
    ek = ek[None, :, None, :].expand(B, Nk, nh, ek.shape[-1])
    # The scale is rounded to the compute dtype first, as JAX's weakly typed
    # Python scalar is.
    q_aug = torch.cat([q * torch.tensor(scale, dtype=dtype), eq], dim=-1)
    return q_aug, torch.cat([k, ek], dim=-1)


def _pool_spec(kernel, stride):
    """No-op pooling (every kernel and stride entry 1) is skipped
    (reference attention.py:197-200)."""
    if math.prod(kernel or (1,)) == 1 and math.prod(stride or (1,)) == 1:
        return ()
    return tuple(kernel)


class MultiScaleAttention(nn.Module):
    """Pooling attention (reference attention.py:150-392,
    slowfast_tpu/models/attention.py:298-535).

    q, k and v come from one ``qkv`` Linear, or three (``q``, ``k``, ``v``)
    under ``separate_qkv``; under ``pool_first`` the input itself is pooled
    and the three Linears follow the pooling. ``conv`` pools with a
    depthwise kernel of ``dim_conv = (dim if pool_first else dim_out) //
    heads`` taps shared across heads and normalizes per head;
    ``conv_unshared`` with one tap per channel (``dim_conv`` the whole
    width) and normalizes over the whole width; ``avg`` and ``max`` have no
    pool parameters and no pool norms. Dropout (``drop_rate``) follows the
    output projection in training."""

    def __init__(self, dim, dim_out, input_size, num_heads=8, qkv_bias=False, drop_rate=0.0,
                 kernel_q=(), kernel_kv=(), stride_q=(), stride_kv=(),
                 has_cls_embed=True, mode="conv", pool_first=False, rel_pos_spatial=False,
                 rel_pos_temporal=False, residual_pooling=False, separate_qkv=False,
                 exact_softmax=False, dtype=torch.float32):
        super().__init__()
        if mode not in POOL_MODES:
            raise ValueError(f"unknown pooling mode {mode!r}; expected one of {POOL_MODES}")
        self.num_heads = num_heads
        self.dim_out = dim_out
        self.has_cls_embed = has_cls_embed
        self.mode = mode
        self.pool_first = pool_first
        self.residual_pooling = residual_pooling
        self.exact_softmax = exact_softmax
        self.drop_rate = drop_rate
        self.dtype = dtype
        self.generator = None  # the model's, set by models.build.build_model
        head_dim = dim_out // num_heads
        self.scale = head_dim ** -0.5
        self.kernel_q = _pool_spec(kernel_q, stride_q)
        self.kernel_kv = _pool_spec(kernel_kv, stride_kv)
        self.stride_q, self.stride_kv = tuple(stride_q), tuple(stride_kv)

        if pool_first or separate_qkv:
            self.qkv = None
            for name in ("q", "k", "v"):
                setattr(self, name, nn.Linear(dim, dim_out, bias=qkv_bias))
        else:
            self.qkv = nn.Linear(dim, 3 * dim_out, bias=qkv_bias)
        self.proj = nn.Linear(dim_out, dim_out)
        # conv: taps shared across heads, norms per head; conv_unshared: a
        # tap per channel, norms over the whole width (JAX :360-368, :415).
        dim_pool = dim if pool_first else dim_out
        shared = mode == "conv"
        dim_conv = dim_pool // num_heads if shared else dim_pool
        self.pool_heads = num_heads if shared else 1
        conv_mode = mode in ("conv", "conv_unshared")
        for name, kernel in (("q", self.kernel_q), ("k", self.kernel_kv), ("v", self.kernel_kv)):
            on = conv_mode and bool(kernel)
            pool = Conv3D(dim_conv, dim_conv, kernel, groups=dim_conv) if on else None
            norm = nn.LayerNorm(dim_conv, eps=1e-6) if on else None
            setattr(self, f"pool_{name}", pool)
            setattr(self, f"norm_{name}", norm)
        self.rel_pos_h = self.rel_pos_w = self.rel_pos_t = None
        if rel_pos_spatial:
            size = input_size[1]
            rel_sp_dim = 2 * max(size // (stride_q[1] if stride_q else 1),
                                 size // (stride_kv[1] if stride_kv else 1)) - 1
            self.rel_pos_h = nn.Parameter(torch.zeros(rel_sp_dim, head_dim))
            self.rel_pos_w = nn.Parameter(torch.zeros(rel_sp_dim, head_dim))
        if rel_pos_temporal:
            self.rel_pos_t = nn.Parameter(torch.zeros(2 * input_size[0] - 1, head_dim))

    def _norm_heads(self, ln, x):
        """LayerNorm over each of ``pool_heads`` slices of the width, in fp32,
        output in the compute dtype."""
        B, L, C = x.shape
        x = x.reshape(B, L, self.pool_heads, C // self.pool_heads)
        return layer_norm(x, ln).reshape(B, L, C).to(self.dtype)

    def forward(self, x, thw, res_input=None):
        """``(out, q_shape)``; with ``res_input`` (Rev-MViT's transition
        residual, slowfast_tpu/models/attention.py:528-534) also that tensor
        pooled with the same ``pool_q`` kernel and ``norm_q`` as q:
        ``(out, q_shape, pooled_res)``."""
        B = x.shape[0]
        nh = self.num_heads
        if self.pool_first:
            q = k = v = x
        elif self.qkv is None:
            q, k, v = (linear(x, getattr(self, n), self.dtype) for n in ("q", "k", "v"))
        else:
            q, k, v = linear(x, self.qkv, self.dtype).chunk(3, dim=-1)

        def pool(t, conv, norm, kernel, stride):
            t, t_shape = pool_tokens_flat(t, thw, kernel, stride, self.mode, self.has_cls_embed,
                                          pool_w=None if conv is None else conv.weight,
                                          heads=self.pool_heads)
            return (t if norm is None else self._norm_heads(norm, t)), t_shape

        q, q_shape = pool(q, self.pool_q, self.norm_q, self.kernel_q, self.stride_q)
        k, k_shape = pool(k, self.pool_k, self.norm_k, self.kernel_kv, self.stride_kv)
        v, _ = pool(v, self.pool_v, self.norm_v, self.kernel_kv, self.stride_kv)
        if self.pool_first:
            q, k, v = (linear(t, getattr(self, n), self.dtype)
                       for t, n in ((q, "q"), (k, "k"), (v, "v")))

        Nq, Nk = q.shape[1], k.shape[1]
        qh = q.reshape(B, Nq, nh, -1)
        kh = k.reshape(B, Nk, nh, -1)
        vh = v.reshape(B, Nk, nh, -1)
        if self.rel_pos_h is not None or self.rel_pos_t is not None:
            q_in, k_in = _augment_qk_relpos(
                qh, kh, self.scale, self.has_cls_embed, q_shape, k_shape,
                self.rel_pos_h, self.rel_pos_w, self.rel_pos_t)
        else:
            q_in, k_in = qh * torch.tensor(self.scale, dtype=qh.dtype), kh
        core = (attention_ops.pooled_attention if self.exact_softmax
                else attention_ops.flash_pooled_attention)
        xo = core(q_in.contiguous(), k_in.contiguous(), vh.to(q_in.dtype).contiguous())
        if self.residual_pooling:
            # MViTv2 residual pooling (reference :381-385) skips the cls row.
            if self.has_cls_embed:
                xo = torch.cat([xo[:, :1], xo[:, 1:] + qh[:, 1:]], dim=1)
            else:
                xo = xo + qh
        x = linear(xo.reshape(B, Nq, self.dim_out), self.proj, self.dtype)
        if self.training and self.drop_rate > 0.0:
            x = dropout(x, self.drop_rate, self.generator)
        if res_input is not None:
            res, _ = pool(res_input, self.pool_q, self.norm_q, self.kernel_q, self.stride_q)
            return x, q_shape, res
        return x, q_shape


class MultiScaleBlock(nn.Module):
    """Pre-LN transformer block with pooled attention and a max-pooled
    residual (reference attention.py:395-514)."""

    def __init__(self, dim, dim_out, num_heads, input_size, mlp_ratio=4.0,
                 qkv_bias=False, drop_rate=0.0, droppath_rate=0.0, layer_scale_init_value=0.0,
                 kernel_q=(), kernel_kv=(), stride_q=(), stride_kv=(), mode="conv",
                 has_cls_embed=True, pool_first=False, rel_pos_spatial=False,
                 rel_pos_temporal=False, residual_pooling=False, dim_mul_in_att=False,
                 separate_qkv=False, exact_softmax=False, dtype=torch.float32):
        super().__init__()
        self.dim, self.dim_out = dim, dim_out
        self.dim_mul_in_att = dim_mul_in_att
        self.has_cls_embed = has_cls_embed
        self.dtype = dtype
        att_dim = dim_out if dim_mul_in_att else dim
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = MultiScaleAttention(
            dim, att_dim, input_size, num_heads=num_heads, qkv_bias=qkv_bias,
            drop_rate=drop_rate, kernel_q=kernel_q, kernel_kv=kernel_kv, stride_q=stride_q,
            stride_kv=stride_kv, has_cls_embed=has_cls_embed, mode=mode, pool_first=pool_first,
            rel_pos_spatial=rel_pos_spatial, rel_pos_temporal=rel_pos_temporal,
            residual_pooling=residual_pooling, separate_qkv=separate_qkv,
            exact_softmax=exact_softmax, dtype=dtype)
        self.gamma_1 = self.gamma_2 = None
        if layer_scale_init_value > 0:
            self.gamma_1 = nn.Parameter(torch.full((att_dim,), float(layer_scale_init_value)))
            self.gamma_2 = nn.Parameter(torch.full((dim_out,), float(layer_scale_init_value)))
        self.drop_path = DropPath(droppath_rate)
        self.norm2 = nn.LayerNorm(att_dim, eps=1e-6)
        self.mlp = Mlp(att_dim, int(att_dim * mlp_ratio), dim_out, drop_rate=drop_rate,
                       dtype=dtype)
        if dim != dim_out:
            self.proj = nn.Linear(dim, dim_out)
        self.stride_skip = tuple(stride_q)
        self.kernel_skip = tuple(s + 1 if s > 1 else s for s in stride_q)

    def forward(self, x, thw):
        x_norm = layer_norm(x, self.norm1)
        x_block, thw_new = self.attn(x_norm, thw)
        if self.gamma_1 is not None:
            x_block = self.gamma_1 * x_block
        if self.dim_mul_in_att and self.dim != self.dim_out:
            x = linear(x_norm, self.proj, self.dtype)
        if math.prod(self.stride_skip or (1,)) > 1:
            x, _ = pool_tokens_flat(x, thw, self.kernel_skip, self.stride_skip, "max",
                                    self.has_cls_embed)
        x = x + self.drop_path(x_block)
        x_norm = layer_norm(x, self.norm2)
        x_mlp = self.mlp(x_norm)
        if self.gamma_2 is not None:
            x_mlp = self.gamma_2 * x_mlp
        if not self.dim_mul_in_att and self.dim != self.dim_out:
            x = linear(x_norm, self.proj, self.dtype)
        return x + self.drop_path(x_mlp), thw_new
