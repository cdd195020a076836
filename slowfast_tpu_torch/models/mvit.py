"""MViT v2 on (B, N, C) tokens (counterpart of slowfast_tpu/models/mvit.py;
reference video_model_builder.py:805-1244).

Ported for the MViTv2-S recipe (``configs/Kinetics/MVITv2_S_16x4.yaml``):
the 3D patch stem, a cls token, decomposed rel-pos, residual pooling and
the adaptive KV-stride schedule, then the final norm, the cls row and the
transformer head. Options that recipe does not use raise
``NotImplementedError``.
"""

import numpy as np
import torch
from torch import nn

from .attention import MultiScaleBlock
from .common import layer_norm, round_width
from .heads import TransformerBasicHead
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


def _check_supported(cfg):
    m = cfg.MVIT
    unported = {
        "MVIT.USE_ABS_POS / SEP_POS_EMBED (absolute pos-embeds, MViTv1)":
            m.USE_ABS_POS or m.SEP_POS_EMBED,
        "MVIT.USE_FIXED_SINCOS_POS": m.USE_FIXED_SINCOS_POS,
        "MVIT.NORM_STEM": m.NORM_STEM,
        "MVIT.POOL_FIRST": m.POOL_FIRST,
        "MVIT.SEPARATE_QKV": m.SEPARATE_QKV,
        "MVIT.USE_MEAN_POOLING": m.USE_MEAN_POOLING,
        "MVIT.CLS_EMBED_ON False": not m.CLS_EMBED_ON,
        "MVIT.PATCH_2D": m.PATCH_2D,
        f"MVIT.MODE {m.MODE!r}": m.MODE != "conv",
        f"MVIT.NORM {m.NORM!r}": m.NORM != "layernorm",
        "MVIT.REV (Rev-MViT)": m.REV.ENABLE,
        "DETECTION.ENABLE (the RoI head)": cfg.DETECTION.ENABLE,
        "MODEL.ACT_CHECKPOINT (remat)": cfg.MODEL.ACT_CHECKPOINT,
    }
    for name, on in unported.items():
        if on:
            raise NotImplementedError(f"MViT with {name} is not ported yet")


class MViT(nn.Module):
    """Patch stem -> cls token -> MultiScaleBlocks -> norm -> cls row -> head.

    Takes ``[clips (B, T, H, W, C)]`` and returns logits (train) or
    activated predictions (eval).
    """

    def __init__(self, cfg):
        super().__init__()
        _check_supported(cfg)
        self.dtype = compute_dtype(cfg)
        m = cfg.MVIT
        ps = list(m.PATCH_STRIDE)
        self.patch_embed = PatchEmbed(cfg.DATA.INPUT_CHANNEL_NUM[0], m.EMBED_DIM,
                                      m.PATCH_KERNEL, ps, m.PATCH_PADDING)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, m.EMBED_DIM))
        # Static pooled-size bookkeeping (slowfast_tpu/models/mvit.py:377-385):
        # kernel s+1 or odd, pad k//2 gives (size - 1) // stride + 1.
        input_size = [cfg.DATA.NUM_FRAMES // ps[0], cfg.DATA.TRAIN_CROP_SIZE // ps[1],
                      cfg.DATA.TRAIN_CROP_SIZE // ps[2]]
        schedule = mvit_block_schedule(cfg)
        dpr = np.linspace(0, m.DROPPATH_RATE, m.DEPTH)
        self.blocks = nn.ModuleList()
        for i, blk in enumerate(schedule):
            self.blocks.append(MultiScaleBlock(
                dim=blk["dim"], dim_out=blk["dim_out"], num_heads=blk["num_heads"],
                input_size=tuple(input_size), mlp_ratio=m.MLP_RATIO, qkv_bias=m.QKV_BIAS,
                droppath_rate=float(dpr[i]), layer_scale_init_value=m.LAYER_SCALE_INIT_VALUE,
                kernel_q=blk["kernel_q"], kernel_kv=blk["kernel_kv"],
                stride_q=blk["stride_q"], stride_kv=blk["stride_kv"], mode=m.MODE,
                has_cls_embed=True, rel_pos_spatial=m.REL_POS_SPATIAL,
                rel_pos_temporal=m.REL_POS_TEMPORAL, residual_pooling=m.RESIDUAL_POOLING,
                dim_mul_in_att=m.DIM_MUL_IN_ATT,
                exact_softmax=bool(cfg.TPU.PALLAS_ATTENTION), dtype=self.dtype))
            if blk["stride_q"]:
                input_size = [(s - 1) // st + 1 for s, st in zip(input_size, blk["stride_q"])]
        final_dim = schedule[-1]["dim_out"]
        self.norm = nn.LayerNorm(final_dim, eps=1e-6)
        self.head = TransformerBasicHead(final_dim, cfg.MODEL.NUM_CLASSES,
                                         dropout_rate=cfg.MODEL.DROPOUT_RATE,
                                         act_func=cfg.MODEL.HEAD_ACT, dtype=self.dtype)

    def forward(self, xs):
        x, thw = self.patch_embed(xs[0].to(self.dtype))
        cls_tokens = self.cls_token.to(x.dtype).expand(x.shape[0], -1, -1)
        x = torch.cat([cls_tokens, x], dim=1)
        for blk in self.blocks:
            x, thw = blk(x, thw)
        return self.head(layer_norm(x, self.norm)[:, 0])
