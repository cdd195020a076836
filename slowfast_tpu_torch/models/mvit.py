"""MViT v1/v2 and ViT on (B, N, C) tokens (counterpart of
slowfast_tpu/models/mvit.py:143-457; reference
video_model_builder.py:805-1244).

The 3D patch stem, the optional cls token, absolute pos-embeds (joint or
separable, trilinearly resized when the input grid differs from the
training one) or fixed sin-cos ones, the stem dropout and norm, the
MultiScaleBlocks (pooled attention in every mode, decomposed rel-pos,
residual pooling, the adaptive KV-stride schedule), optionally each run
under ``torch.utils.checkpoint`` (``MODEL.ACT_CHECKPOINT``), then the final
norm with the cls row or the mean of the tokens, and the transformer head,
or the RoI head of detection; or Rev-MViT's reversible encoder
(``models/reversible.py``) with its stream fusion. Under ``MVIT.PATCH_2D``
(images, ``T = 1``) the stem patchifies each frame in 2D and the patch
stride is ``[1] + PATCH_STRIDE`` (slowfast_tpu/models/mvit.py:177-215).
"""

import numpy as np
import torch
from torch import nn

from .attention import MultiScaleBlock
from .common import TwoStreamFusion, checkpointed, dropout, layer_norm, resize_linear, round_width
from .heads import ResNetRoIHead, TransformerBasicHead
from .reversible import ReversibleMViT
from .stem import PatchEmbed
from .video_models import compute_dtype


def mvit_block_schedule(cfg):
    """Per-block dims, heads and pool kernels/strides (reference
    video_model_builder.py:915-999), including the POOL_KV_STRIDE_ADAPTIVE
    schedule, without mutating the config."""
    depth = cfg.MVIT.DEPTH
    num_heads = cfg.MVIT.NUM_HEADS
    dim_mul = np.ones(depth + 1)
    head_mul = np.ones(depth + 1)
    for idx, mul in cfg.MVIT.DIM_MUL:
        dim_mul[idx] = mul
    for idx, mul in cfg.MVIT.HEAD_MUL:
        head_mul[idx] = mul

    pool_q = [[] for _ in range(depth)]
    pool_kv = [[] for _ in range(depth)]
    stride_q = [[] for _ in range(depth)]
    stride_kv = [[] for _ in range(depth)]
    for entry in cfg.MVIT.POOL_Q_STRIDE:
        i = entry[0]
        stride_q[i] = list(entry[1:])
        if cfg.MVIT.POOL_KVQ_KERNEL is not None:
            pool_q[i] = list(cfg.MVIT.POOL_KVQ_KERNEL)
        else:
            pool_q[i] = [s + 1 if s > 1 else s for s in entry[1:]]

    kv_entries = list(cfg.MVIT.POOL_KV_STRIDE)
    if cfg.MVIT.POOL_KV_STRIDE_ADAPTIVE is not None:
        _stride_kv = list(cfg.MVIT.POOL_KV_STRIDE_ADAPTIVE)
        kv_entries = []
        for i in range(depth):
            if len(stride_q[i]) > 0:
                _stride_kv = [max(_stride_kv[d] // stride_q[i][d], 1)
                              for d in range(len(_stride_kv))]
            kv_entries.append([i] + _stride_kv)
    for entry in kv_entries:
        i = entry[0]
        stride_kv[i] = list(entry[1:])
        if cfg.MVIT.POOL_KVQ_KERNEL is not None:
            pool_kv[i] = list(cfg.MVIT.POOL_KVQ_KERNEL)
        else:
            pool_kv[i] = [s + 1 if s > 1 else s for s in entry[1:]]

    blocks = []
    dim = cfg.MVIT.EMBED_DIM
    for i in range(depth):
        # num_heads accumulates across blocks (reference :984).
        num_heads = round_width(num_heads, head_mul[i])
        if cfg.MVIT.DIM_MUL_IN_ATT:
            dim_out = round_width(dim, dim_mul[i], divisor=num_heads)
        else:
            dim_out = round_width(dim, dim_mul[i + 1],
                                  divisor=round_width(num_heads, head_mul[i + 1]))
        blocks.append(dict(dim=dim, dim_out=dim_out, num_heads=num_heads,
                           kernel_q=tuple(pool_q[i]), kernel_kv=tuple(pool_kv[i]),
                           stride_q=tuple(stride_q[i]), stride_kv=tuple(stride_kv[i])))
        dim = dim_out
    return blocks


def feature_geometry(schedule, thw, depth):
    """The token grid after block ``depth`` of ``schedule`` from the grid
    ``thw``, and the q stride accumulated to it, each pooled block's
    ``(size - 1) // stride + 1`` applied in turn: a cumulative division
    differs at odd sizes (14 -> 7 -> 4, not 14 // 4 = 3)
    (slowfast_tpu/models/masked.py:221-236)."""
    size, acc = list(thw), [1, 1, 1]
    for blk in schedule[:depth + 1]:
        if blk["stride_q"]:
            size = [(s - 1) // st + 1 for s, st in zip(size, blk["stride_q"])]
            acc = [a * st for a, st in zip(acc, blk["stride_q"])]
    return size, acc


def patch_stride(cfg):
    """The (t, h, w) patch stride: ``[1] + MVIT.PATCH_STRIDE`` for the 2D
    stem (``MVIT.PATCH_2D``), else ``MVIT.PATCH_STRIDE``."""
    ps = list(cfg.MVIT.PATCH_STRIDE)
    return [1] + ps if cfg.MVIT.PATCH_2D else ps


def maskfeat_feature_size(cfg):
    """H (= W) of the deepest ``MASK.PRETRAIN_DEPTH`` feature grid, the
    geometry of the 2D MaskFeat masks (slowfast_tpu/models/mvit.py:100)."""
    size = cfg.DATA.TRAIN_CROP_SIZE // cfg.MVIT.PATCH_STRIDE[-2]
    grid, _ = feature_geometry(mvit_block_schedule(cfg), [1, size, size],
                               max(cfg.MASK.PRETRAIN_DEPTH))
    return grid[1]


def sep_pos_table(spatial, temporal, cls=None):
    """A separable pos-embed table: the ``(1, H·W, C)`` spatial rows tiled
    over time plus each time step's row of ``(1, T, C)``, with the class
    rows ``cls`` first."""
    pos = (spatial.repeat(1, temporal.shape[1], 1)
           + temporal.repeat_interleave(spatial.shape[1], dim=1))
    return pos if cls is None else torch.cat([cls, pos], dim=1)


def get_3d_sincos_pos_embed(embed_dim, grid_size, t_size, cls_token=False):
    """Fixed 3D sin-cos positional embedding (slowfast_tpu/models/mvit.py:116,
    reference models/utils.py:55-100): ``(t_size * grid_size**2 [+ 1],
    embed_dim)`` fp32, the temporal quarter first. As in the reference, the
    first spatial half encodes the W position and the second the H one
    ("w goes first"; its emb_h/emb_w names are swapped)."""
    assert embed_dim % 4 == 0
    embed_dim_spatial = embed_dim // 4 * 3
    embed_dim_temporal = embed_dim // 4

    def get_1d(dim, pos):
        omega = np.arange(dim // 2, dtype=np.float64) / (dim / 2.0)
        omega = 1.0 / 10000 ** omega
        out = np.einsum("m,d->md", pos.reshape(-1), omega)
        return np.concatenate([np.sin(out), np.cos(out)], axis=1)

    grid_h = np.arange(grid_size, dtype=np.float32)
    grid_w = np.arange(grid_size, dtype=np.float32)
    grid = np.stack(np.meshgrid(grid_w, grid_h), axis=0).reshape([2, 1, grid_size, grid_size])
    pos_embed_spatial = np.concatenate([get_1d(embed_dim_spatial // 2, grid[0]),
                                        get_1d(embed_dim_spatial // 2, grid[1])], axis=1)
    pos_embed_temporal = get_1d(embed_dim_temporal, np.arange(t_size, dtype=np.float32))
    pos_embed_temporal = np.repeat(pos_embed_temporal[:, None, :], grid_size ** 2, axis=1)
    pos_embed_spatial = np.tile(pos_embed_spatial[None, :, :], (t_size, 1, 1))
    pos_embed = np.concatenate([pos_embed_temporal, pos_embed_spatial], axis=-1)
    pos_embed = pos_embed.reshape(-1, embed_dim)
    if cls_token:
        pos_embed = np.concatenate([np.zeros([1, embed_dim]), pos_embed], axis=0)
    return pos_embed.astype(np.float32)


def _check_supported(cfg):
    m = cfg.MVIT
    if m.NORM != "layernorm":
        # The reference raises on any other norm too.
        raise NotImplementedError(f"MViT supports MVIT.NORM 'layernorm' only, not {m.NORM!r}")
    # JAX :297 (reference video_model_builder.py:1148).
    assert not (m.REV.ENABLE and m.CLS_EMBED_ON), "reversible MViT does not support a cls token"


class MViT(nn.Module):
    """Patch stem -> (cls token) -> pos-embeds -> (dropout, norm) ->
    MultiScaleBlocks -> norm -> cls row or token mean -> head; or, under
    ``DETECTION.ENABLE``, norm -> token grid -> RoI head. Under
    ``MVIT.REV.ENABLE`` the blocks are Rev-MViT's ``rev_backbone``, whose two
    streams ``fuse`` joins (``REV.RESPATH_FUSE``) around the token mean and
    the norm, in ``USE_MEAN_POOLING``'s order (JAX :286-320); the head then
    takes the fused width, ``2 * final_dim`` under a ``concat`` fusion.

    Takes ``[clips (B, T, H, W, C)]`` (and under detection the boxes) and
    returns logits (train) or activated predictions (eval; detection's RoI
    head activates in both).
    """

    def __init__(self, cfg):
        super().__init__()
        _check_supported(cfg)
        self.dtype = compute_dtype(cfg)
        m = cfg.MVIT
        ps = patch_stride(cfg)
        dim = m.EMBED_DIM
        self.cls_on = m.CLS_EMBED_ON
        self.use_mean_pooling = m.USE_MEAN_POOLING
        self.detection = cfg.DETECTION.ENABLE
        self.act_checkpoint = cfg.MODEL.ACT_CHECKPOINT
        self.dropout_rate = m.DROPOUT_RATE
        self.generator = None  # the model's, set by models.build.build_model
        self.patch_embed = PatchEmbed(cfg.DATA.INPUT_CHANNEL_NUM[0], dim, m.PATCH_KERNEL,
                                      m.PATCH_STRIDE, m.PATCH_PADDING, conv_2d=m.PATCH_2D)
        # The training grid (slowfast_tpu/models/mvit.py:184-188).
        self.patch_dims = [cfg.DATA.NUM_FRAMES // ps[0], cfg.DATA.TRAIN_CROP_SIZE // ps[1],
                           cfg.DATA.TRAIN_CROP_SIZE // ps[2]]
        T0, H0, W0 = self.patch_dims
        s = int(self.cls_on)
        if self.cls_on:
            self.cls_token = nn.Parameter(torch.zeros(1, 1, dim))
        self.register_buffer("sincos", torch.from_numpy(get_3d_sincos_pos_embed(
            dim, H0, T0, cls_token=self.cls_on))[None] if m.USE_FIXED_SINCOS_POS else None,
            persistent=False)
        # SEP_POS_EMBED is read only under USE_ABS_POS (JAX :237-238).
        self.sep_pos_embed = m.USE_ABS_POS and m.SEP_POS_EMBED
        self.joint_pos_embed = m.USE_ABS_POS and not m.SEP_POS_EMBED
        if self.sep_pos_embed:
            self.pos_embed_spatial = nn.Parameter(torch.zeros(1, H0 * W0, dim))
            self.pos_embed_temporal = nn.Parameter(torch.zeros(1, T0, dim))
            if self.cls_on:
                self.pos_embed_class = nn.Parameter(torch.zeros(1, 1, dim))
        elif self.joint_pos_embed:
            # Under USE_FIXED_SINCOS_POS the parameter stays for checkpoint
            # compatibility, but the fixed table is used (JAX :258-261).
            self.pos_embed = nn.Parameter(torch.zeros(1, T0 * H0 * W0 + s, dim))
        self.norm_stem = nn.LayerNorm(dim, eps=1e-6) if m.NORM_STEM else None

        # Static pooled-size bookkeeping (slowfast_tpu/models/mvit.py:377-385):
        # kernel s+1 or odd, pad k//2 gives (size - 1) // stride + 1.
        input_size = list(self.patch_dims)
        schedule = mvit_block_schedule(cfg)
        final_dim = schedule[-1]["dim_out"]
        self.rev = m.REV.ENABLE
        if self.rev:
            self.rev_backbone = ReversibleMViT(cfg, self.patch_dims, self.dtype)
            self.fuse = TwoStreamFusion(m.REV.RESPATH_FUSE, dim=2 * final_dim)
            # Two streams, unless the last layer is a transition (flax infers
            # the norm's and the head's widths from their inputs).
            width = final_dim if self.rev_backbone.specs[-1]["transition"] else 2 * final_dim
            fused = self.fuse.out_width(width)
            self.norm = nn.LayerNorm(fused if self.use_mean_pooling else width, eps=1e-6)
            self.head = TransformerBasicHead(
                fused, cfg.MODEL.NUM_CLASSES, dropout_rate=cfg.MODEL.DROPOUT_RATE,
                act_func=cfg.MODEL.HEAD_ACT, detach_final_fc=cfg.MODEL.DETACH_FINAL_FC,
                dtype=self.dtype)
            return
        dpr = np.linspace(0, m.DROPPATH_RATE, m.DEPTH)
        self.blocks = nn.ModuleList()
        for i, blk in enumerate(schedule):
            self.blocks.append(MultiScaleBlock(
                dim=blk["dim"], dim_out=blk["dim_out"], num_heads=blk["num_heads"],
                input_size=tuple(input_size), mlp_ratio=m.MLP_RATIO, qkv_bias=m.QKV_BIAS,
                drop_rate=m.DROPOUT_RATE, droppath_rate=float(dpr[i]),
                layer_scale_init_value=m.LAYER_SCALE_INIT_VALUE,
                kernel_q=blk["kernel_q"], kernel_kv=blk["kernel_kv"],
                stride_q=blk["stride_q"], stride_kv=blk["stride_kv"], mode=m.MODE,
                has_cls_embed=self.cls_on, pool_first=m.POOL_FIRST,
                rel_pos_spatial=m.REL_POS_SPATIAL, rel_pos_temporal=m.REL_POS_TEMPORAL,
                residual_pooling=m.RESIDUAL_POOLING, dim_mul_in_att=m.DIM_MUL_IN_ATT,
                separate_qkv=m.SEPARATE_QKV, exact_softmax=bool(cfg.TPU.PALLAS_ATTENTION),
                dtype=self.dtype))
            if blk["stride_q"]:
                input_size = [(s - 1) // st + 1 for s, st in zip(input_size, blk["stride_q"])]
        self.norm = nn.LayerNorm(final_dim, eps=1e-6)
        if self.detection:
            self.head = ResNetRoIHead(
                dim_in=[final_dim], num_classes=cfg.MODEL.NUM_CLASSES,
                resolution=[[cfg.DETECTION.ROI_XFORM_RESOLUTION] * 2],
                scale_factor=[cfg.DETECTION.SPATIAL_SCALE_FACTOR],
                dropout_rate=cfg.MODEL.DROPOUT_RATE, act_func=cfg.MODEL.HEAD_ACT,
                aligned=cfg.DETECTION.ALIGNED)
        else:
            self.head = TransformerBasicHead(
                final_dim, cfg.MODEL.NUM_CLASSES, dropout_rate=cfg.MODEL.DROPOUT_RATE,
                act_func=cfg.MODEL.HEAD_ACT, detach_final_fc=cfg.MODEL.DETACH_FINAL_FC,
                dtype=self.dtype)

    def _abs_pos(self, thw):
        """The absolute pos-embed table ``(1, N [+ 1], C)`` in fp32 for the
        token grid ``thw``, or None."""
        s = int(self.cls_on)
        if self.sep_pos_embed:
            pos = sep_pos_table(self.pos_embed_spatial, self.pos_embed_temporal,
                                self.pos_embed_class if self.cls_on else None)
        elif self.joint_pos_embed:
            pos = self.sincos if self.sincos is not None else self.pos_embed
        else:
            return None
        return self._maybe_interp_pos(pos, thw, s)

    def _maybe_interp_pos(self, pos, thw, s):
        """The table trilinearly resized from the training grid to ``thw``
        when they differ (JAX :436-457, reference :1118-1141), on
        ``resize_linear``: antialiased where an axis shrinks, as JAX is."""
        if int(np.prod(thw)) == int(np.prod(self.patch_dims)):
            return pos
        grid = pos[:, s:].reshape(1, *self.patch_dims, -1)
        grid = resize_linear(grid, (1, *thw, grid.shape[-1])).reshape(1, -1, grid.shape[-1])
        return torch.cat([pos[:, :s], grid], dim=1) if s else grid

    def forward(self, xs, bboxes=None):
        x, thw = self.patch_embed(xs[0].to(self.dtype))
        B = x.shape[0]
        s = int(self.cls_on)
        if self.sincos is not None:
            x = x + self.sincos[:, s:].to(x.dtype)
        if self.cls_on:
            cls_tokens = self.cls_token.to(x.dtype).expand(B, -1, -1)
            if self.sincos is not None:
                cls_tokens = cls_tokens + self.sincos[:, :s].to(x.dtype)
            x = torch.cat([cls_tokens, x], dim=1)
        pos = self._abs_pos(thw)
        if pos is not None:
            # Under USE_FIXED_SINCOS_POS with a joint pos_embed, the fixed
            # table is added a second time here, as in the JAX package.
            x = x + pos.to(x.dtype)
        if self.training and self.dropout_rate > 0.0:
            x = dropout(x, self.dropout_rate, self.generator)
        if self.norm_stem is not None:
            x = layer_norm(x, self.norm_stem)  # fp32, as flax's LayerNorm gives
        if self.rev:
            return self.head(self._rev_features(x, thw))
        for blk in self.blocks:
            if self.act_checkpoint and torch.is_grad_enabled():
                # Drop path and dropout replay their masks in the recompute.
                x, thw = checkpointed(lambda x, blk=blk, thw=thw: blk(x, thw),
                                      self.generator if self.training else None, x)
            else:
                x, thw = blk(x, thw)

        if self.detection:
            if bboxes is None:
                raise ValueError("the detection head needs the boxes")
            # The RoI head reads this map directly: the norm gives the
            # compute dtype (JAX :395-397).
            x = layer_norm(x, self.norm).to(self.dtype)
            x = x[:, s:].reshape(B, *thw, x.shape[-1])
            return self.head([x], bboxes)
        if self.use_mean_pooling:
            # jnp.mean: sums in fp32, rounds once to the input dtype.
            x = x[:, s:].mean(dim=1, dtype=torch.float32).to(x.dtype)
            x = layer_norm(x, self.norm)
        elif self.cls_on:
            x = layer_norm(x, self.norm)[:, 0]
        else:
            x = layer_norm(x, self.norm).mean(dim=1)
        return self.head(x)

    def _rev_features(self, x, thw):
        """Rev-MViT's encoder, then fuse, token mean and norm (mean pooling)
        or norm, fuse and token mean: the head's input."""
        x = self.rev_backbone(x, thw)
        if self.use_mean_pooling:
            x = self.fuse(x)
            x = x.mean(dim=1, dtype=torch.float32).to(x.dtype)
            return layer_norm(x, self.norm)
        return self.fuse(layer_norm(x, self.norm)).mean(dim=1)
