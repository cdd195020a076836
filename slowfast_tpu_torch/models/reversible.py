"""Rev-MViT (counterpart of slowfast_tpu/models/reversible.py; reference
slowfast/models/reversible_mvit.py).

Two streams of tokens pass through reversible blocks, ``Y1 = X1 + F(X2)``,
``Y2 = X2 + G(Y1)``, with F the pre-LN pooling attention and G the pre-LN
MLP, each with drop path. At each ``MVIT.REV.BUFFER_LAYERS`` entry a
non-reversible ``StageTransitionBlock`` fuses the streams, pools the residual
with the attention's own q pool and starts two new ones.

A span of reversible blocks between two transitions runs, when gradients are
on, as one ``torch.autograd.Function`` (``ReversibleSpan``, the reference's
``RevBackProp``, :177-263): its forward keeps only the span's outputs, and its
backward walks the blocks in reverse, rebuilding each block's inputs by
inverting its two residual updates (``x2 = y2 - G(y1)``, ``x1 = y1 - F(x2)``)
and taking the VJPs of G and F there, their parameter gradients added into
``.grad`` as they come. The activations kept for the backward do not grow
with the span's depth. Drop path and dropout draw from the
model's generator; the span keeps the generator's state before each F and G
and sets it again for their recompute, so the rebuild applies the forward's
masks, and puts it back after. ``TPU.REV_BACKPROP False`` runs each block
under ``torch.utils.checkpoint`` instead (JAX's per-block remat), which
keeps both streams at every block boundary.
"""

import contextlib

import numpy as np
import torch
from torch import nn

from .attention import MultiScaleAttention, pool_tokens_flat
from .common import (DropPath, Mlp, TwoStreamFusion, checkpointed, dropout, layer_norm, linear,
                     round_width)


class MLPSubblock(nn.Module):
    """G: LayerNorm (fp32) -> Mlp in the compute dtype, no dropout
    (slowfast_tpu/models/reversible.py:35)."""

    def __init__(self, dim, mlp_ratio, dtype):
        super().__init__()
        self.norm = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dim, dtype=dtype)

    def forward(self, x):
        return self.mlp(layer_norm(x, self.norm))


class AttentionSubBlock(nn.Module):
    """F: LayerNorm (fp32) -> MultiScaleAttention
    (slowfast_tpu/models/reversible.py:54). With ``res_input`` it also
    returns that tensor pooled by the attention's q pool."""

    def __init__(self, spec, cfg, dtype):
        super().__init__()
        m = cfg.MVIT
        self.norm = nn.LayerNorm(spec["dim"], eps=1e-6)
        self.attn = MultiScaleAttention(
            spec["dim"], spec["dim_out"], spec["input_size"], num_heads=spec["num_heads"],
            qkv_bias=m.QKV_BIAS, drop_rate=m.DROPOUT_RATE, kernel_q=spec["kernel_q"],
            kernel_kv=spec["kernel_kv"], stride_q=spec["stride_q"],
            stride_kv=spec["stride_kv"], has_cls_embed=m.CLS_EMBED_ON, mode=m.MODE,
            pool_first=m.POOL_FIRST, rel_pos_spatial=m.REL_POS_SPATIAL,
            rel_pos_temporal=m.REL_POS_TEMPORAL, residual_pooling=m.RESIDUAL_POOLING,
            separate_qkv=m.SEPARATE_QKV, exact_softmax=bool(cfg.TPU.PALLAS_ATTENTION),
            dtype=dtype)

    def forward(self, x, thw, res_input=None):
        y = layer_norm(x, self.norm)
        if res_input is not None:
            out, _, pooled = self.attn(y, thw, res_input=res_input)
            return out, pooled
        return self.attn(y, thw)[0]


class ReversibleBlock(nn.Module):
    """``Y1 = X1 + F(X2)``, ``Y2 = X2 + G(Y1)``, drop path on F and on G
    (slowfast_tpu/models/reversible.py:106)."""

    def __init__(self, spec, cfg, dtype):
        super().__init__()
        self.F = AttentionSubBlock(spec, cfg, dtype)
        self.G = MLPSubblock(spec["dim_out"], cfg.MVIT.MLP_RATIO, dtype)
        self.drop_path = DropPath(spec["droppath"])

    def f(self, x2, thw):
        return self.drop_path(self.F(x2, thw))

    def g(self, y1):
        return self.drop_path(self.G(y1))

    def forward(self, x1, x2, thw):
        y1 = x1 + self.f(x2, thw)
        return y1, x2 + self.g(y1)


class StageTransitionBlock(nn.Module):
    """The non-reversible block at a q-pooling boundary
    (slowfast_tpu/models/reversible.py:275): ``pre_q_fuse`` of the two
    streams; the residual, projected by ``res_proj`` (before the pool, or
    after it under ``POOL_FIRST``) when the width changes, pooled by the
    attention's own ``pool_q`` and ``norm_q`` (``RES_PATH conv``) or max
    pooled with kernel ``s + 1`` for a stride ``s > 1`` (``max``); then
    ``x = res + F(x)``, ``x + G(x)`` and drop path on the sum."""

    def __init__(self, spec, cfg, dtype):
        super().__init__()
        m = cfg.MVIT
        self.dtype = dtype
        self.pool_first = m.POOL_FIRST
        self.res_path = m.REV.RES_PATH
        self.has_cls = m.CLS_EMBED_ON
        self.stride_q = tuple(spec["stride_q"])
        self.kernel_skip = tuple(s + 1 if s > 1 else s for s in self.stride_q)
        self.pre_q_fuse = TwoStreamFusion(m.REV.PRE_Q_FUSION, dim=spec["dim"])
        self.res_proj = (nn.Linear(spec["dim"], spec["dim_out"])
                         if spec["dim"] != spec["dim_out"] else None)
        self.F = AttentionSubBlock(spec, cfg, dtype)
        self.G = MLPSubblock(spec["dim_out"], m.MLP_RATIO, dtype)
        self.drop_path = DropPath(spec["droppath"])

    def forward(self, x, thw):
        x = self.pre_q_fuse(x)
        res = x
        if self.res_proj is not None and not self.pool_first:
            res = linear(res, self.res_proj, self.dtype)
        if self.res_path == "conv":
            f_x, res = self.F(x, thw, res_input=res)
        else:  # "max"
            f_x = self.F(x, thw)
            res, _ = pool_tokens_flat(res, thw, self.kernel_skip, self.stride_q, "max",
                                      self.has_cls)
        if self.res_proj is not None and self.pool_first:
            res = linear(res, self.res_proj, self.dtype)
        x = res + f_x
        x = x + self.G(x)
        return self.drop_path(x)


def rev_layer_schedule(cfg, thw):
    """Per-layer widths, heads, pool kernels and strides, drop-path rates and
    token grids of Rev-MViT from the training grid ``thw``
    (slowfast_tpu/models/reversible.py:364-421): the widths grow inside the
    q-pooling block, and a transition under a ``concat`` ``PRE_Q_FUSION``
    takes both streams' width."""
    from .mvit import mvit_block_schedule

    m = cfg.MVIT
    depth = m.DEPTH
    dpr = np.linspace(0, m.DROPPATH_RATE, depth)
    dim_mul = np.ones(depth + 1)
    head_mul = np.ones(depth + 1)
    for idx, mul in m.DIM_MUL:
        dim_mul[idx] = mul
    for idx, mul in m.HEAD_MUL:
        head_mul[idx] = mul
    sched = mvit_block_schedule(cfg)
    embed_dim, num_heads = m.EMBED_DIM, m.NUM_HEADS
    input_size = list(thw)
    layers = []
    for i in range(depth):
        num_heads = round_width(num_heads, head_mul[i])
        embed_dim = round_width(embed_dim, dim_mul[i - 1] if i > 0 else 1.0, divisor=num_heads)
        dim_out = round_width(embed_dim, dim_mul[i],
                              divisor=round_width(num_heads, head_mul[i + 1]))
        transition = i in m.REV.BUFFER_LAYERS
        input_mult = 2 if transition and "concat" in m.REV.PRE_Q_FUSION else 1
        layers.append(dict(
            transition=transition, dim=embed_dim * input_mult, dim_out=dim_out,
            num_heads=num_heads, kernel_q=sched[i]["kernel_q"], kernel_kv=sched[i]["kernel_kv"],
            stride_q=sched[i]["stride_q"], stride_kv=sched[i]["stride_kv"],
            droppath=float(dpr[i]), input_size=tuple(input_size)))
        if sched[i]["stride_q"]:
            input_size = [(s - 1) // st + 1 for s, st in zip(input_size, sched[i]["stride_q"])]
    return layers


@contextlib.contextmanager
def _replayed(generator, state):
    """``generator`` set to ``state`` inside the block and put back after;
    nothing when either is None."""
    if generator is None or state is None:
        yield
        return
    after = generator.get_state()
    generator.set_state(state)
    try:
        yield
    finally:
        generator.set_state(after)


def _state(generator):
    return None if generator is None else generator.get_state()


class ReversibleSpan(torch.autograd.Function):
    """A span of ``ReversibleBlock``s with the reversible backward
    (slowfast_tpu/models/reversible.py:213 ``_run_reversible_span``).

    ``apply(x1, x2, blocks, thws, generator, *params)``, ``params`` the
    blocks' parameters (so that the span's outputs depend on them). The
    forward runs the blocks without a graph and saves only the span's
    outputs; the backward rebuilds one block at a time, from the last:
    ``G(y1)`` recomputed with the graph on, ``x2 = y2 - G(y1)``, G's VJP;
    ``F(x2)`` recomputed, ``x1 = y1 - F(x2)``, F's VJP. Each VJP adds the
    block's parameter gradients into their ``.grad`` as it is taken, as the
    reference's ``RevBackProp`` does, so neither a block's graph nor its
    gradients outlive its turn; the parameters get no gradient from the
    return value."""

    @staticmethod
    def forward(ctx, x1, x2, blocks, thws, generator, *params):
        states = []
        with torch.no_grad():
            for blk, thw in zip(blocks, thws):
                s_f = _state(generator)
                y1 = x1 + blk.f(x2, thw)
                s_g = _state(generator)
                x2 = x2 + blk.g(y1)
                x1 = y1
                states.append((s_f, s_g))
        ctx.blocks, ctx.thws, ctx.generator, ctx.states = blocks, thws, generator, states
        ctx.n_params = len(params)
        ctx.save_for_backward(x1, x2)
        return x1, x2

    @staticmethod
    def backward(ctx, dy1, dy2):
        y1, y2 = (t.detach() for t in ctx.saved_tensors)
        dy1 = torch.zeros_like(y1) if dy1 is None else dy1
        dy2 = torch.zeros_like(y2) if dy2 is None else dy2
        gen = ctx.generator
        for blk, thw, (s_f, s_g) in reversed(list(zip(ctx.blocks, ctx.thws, ctx.states))):
            # Invert y2 = x2 + G(y1), with G's VJP at y1.
            y1 = y1.detach().requires_grad_(True)
            with torch.enable_grad(), _replayed(gen, s_g):
                g = blk.g(y1)
            torch.autograd.backward(g, dy2, inputs=[y1] + list(blk.G.parameters()))
            x2 = y2 - g.detach()
            del g
            dy1 = dy1 + y1.grad
            # Invert y1 = x1 + F(x2), with F's VJP at x2.
            x2.requires_grad_(True)
            with torch.enable_grad(), _replayed(gen, s_f):
                f = blk.f(x2, thw)
            torch.autograd.backward(f, dy1, inputs=[x2] + list(blk.F.parameters()))
            x1 = y1.detach() - f.detach()
            del f
            dy2 = dy2 + x2.grad
            y1, y2 = x1, x2.detach()
        return (dy1, dy2, None, None, None) + (None,) * ctx.n_params


class ReversibleMViT(nn.Module):
    """The reversible encoder (slowfast_tpu/models/reversible.py:351-515):
    ``layers.{i}`` are ``StageTransitionBlock``s at ``BUFFER_LAYERS`` and
    ``ReversibleBlock``s elsewhere. Takes ``(B, N, C)`` tokens on the grid
    ``thw``; returns the two streams concatenated, ``(B, N', 2 C')``, after
    ``MVIT.DROPOUT_RATE`` dropout."""

    def __init__(self, cfg, input_size, dtype):
        super().__init__()
        self.specs = rev_layer_schedule(cfg, input_size)
        self.layers = nn.ModuleList(
            (StageTransitionBlock if s["transition"] else ReversibleBlock)(s, cfg, dtype)
            for s in self.specs)
        self.rev_backprop = cfg.TPU.REV_BACKPROP
        self.dropout_rate = cfg.MVIT.DROPOUT_RATE
        self.generator = None  # the model's, set by models.build.build_model

    def _run_span(self, idx, x1, x2, thws):
        blocks = [self.layers[i] for i in idx]
        thws = [thws[i] for i in idx]
        gen = self.generator if self.training else None
        if not torch.is_grad_enabled():
            for blk, thw in zip(blocks, thws):
                x1, x2 = blk(x1, x2, thw)
            return x1, x2
        if self.rev_backprop:
            params = [p for blk in blocks for p in blk.parameters()]
            return ReversibleSpan.apply(x1, x2, blocks, thws, gen, *params)
        for blk, thw in zip(blocks, thws):
            x1, x2 = checkpointed(lambda a, b, blk=blk, thw=thw: blk(a, b, thw), gen, x1, x2)
        return x1, x2

    def forward(self, x, thw):
        thws, cur = [], list(thw)
        for spec in self.specs:
            thws.append(cur)
            if spec["stride_q"]:
                cur = [(s - 1) // st + 1 for s, st in zip(cur, spec["stride_q"])]
        x1 = x2 = None
        pending = []
        for i, spec in enumerate(self.specs):
            if spec["transition"]:
                if x1 is not None:
                    if pending:
                        x1, x2 = self._run_span(pending, x1, x2, thws)
                        pending = []
                    x = torch.cat([x1, x2], dim=-1)
                    x1 = x2 = None
                x = self.layers[i](x, thws[i])
            else:
                if x1 is None:
                    x1 = x2 = x
                pending.append(i)
        if x1 is not None:
            if pending:
                x1, x2 = self._run_span(pending, x1, x2, thws)
            x = torch.cat([x1, x2], dim=-1)
        if self.training and self.dropout_rate > 0.0:
            x = dropout(x, self.dropout_rate, self.generator)
        return x
