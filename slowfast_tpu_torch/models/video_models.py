"""SlowFast, ResNet (C2D/I3D/Slow) and X3D on NTHWC tensors (counterpart of
slowfast_tpu/models/video_models.py; reference video_model_builder.py:36-802).

Each model takes a list of NTHWC pathway tensors and returns logits (train)
or activated, position-averaged predictions (eval), per the head contract.
Under ``DETECTION.ENABLE`` SlowFast and ResNet end in the RoI head instead
and also take the boxes: ``forward(xs, bboxes)`` returns one activated row
per box (slowfast_tpu/models/video_models.py:313, :433). The T-folded fuse,
remat and ``TPU.TRUNCATE_AT`` machinery of the JAX package are TPU
workarounds and are not ported.
"""

import math

import torch
import torch.nn.functional as F
from torch import nn

from .batchnorm import norm_builder
from .common import Conv3D, max_pool3d, round_width
from .heads import ResNetBasicHead, ResNetRoIHead, X3DHead
from .resnet import ResStage
from .stem import VideoModelStem

# Stage depths per ResNet depth (reference video_model_builder.py:37).
MODEL_STAGE_DEPTH = {18: (2, 2, 2, 2), 50: (3, 4, 6, 3), 101: (3, 4, 23, 3)}

# Per-arch temporal kernel basis for [stem, res2..res5]
# (reference video_model_builder.py:41-98).
TEMPORAL_KERNEL_BASIS = {
    "2d": [[[1]], [[1]], [[1]], [[1]], [[1]]],
    "c2d": [[[1]], [[1]], [[1]], [[1]], [[1]]],
    "slow_c2d": [[[1]], [[1]], [[1]], [[1]], [[1]]],
    "i3d": [[[5]], [[3]], [[3, 1]], [[3, 1]], [[1, 3]]],
    "slow_i3d": [[[5]], [[3]], [[3, 1]], [[3, 1]], [[1, 3]]],
    "slow": [[[1]], [[1]], [[1]], [[3]], [[3]]],
    "slowfast": [[[1], [5]], [[1], [3]], [[1], [3]], [[3], [3]], [[3], [3]]],
    "x3d": [[[5]], [[3]], [[3]], [[3]], [[3]]],
    "csn": [[[3]], [[3]], [[3]], [[3]], [[3]]],
    "r2plus1d": [[[1]], [[1]], [[1]], [[1]], [[1]]],
}

# Post-res2 temporal pooling per arch (reference video_model_builder.py:100-109).
POOL1 = {
    "2d": [[1, 1, 1]],
    "c2d": [[2, 1, 1]],
    "slow_c2d": [[1, 1, 1]],
    "i3d": [[2, 1, 1]],
    "slow_i3d": [[1, 1, 1]],
    "slow": [[1, 1, 1]],
    "slowfast": [[1, 1, 1], [1, 1, 1]],
    "x3d": [[1, 1, 1]],
    "csn": [[1, 1, 1]],
    "r2plus1d": [[1, 1, 1]],
}


def compute_dtype(cfg):
    return torch.bfloat16 if cfg.TPU.COMPUTE_DTYPE == "bfloat16" else torch.float32


def _per_pathway(value):
    """A per-pathway config entry: a single value applies to both pathways."""
    return list(value) * 2 if len(value) == 1 else list(value)


def _check_heads(cfg, detection=True):
    if cfg.DETECTION.ENABLE and not detection:
        raise NotImplementedError(f"{cfg.MODEL.MODEL_NAME} has no detection head")


def _basic_head(cfg, dim_in, pool):
    """The classification head, or the contrastive MLP projection under
    ``CONTRASTIVE.NUM_MLP_LAYERS`` > 1 (slowfast_tpu/models/video_models.py:346-360)."""
    c = cfg.CONTRASTIVE
    return ResNetBasicHead(
        dim_in=dim_in, num_classes=cfg.MODEL.NUM_CLASSES, pool_size=pool,
        dropout_rate=cfg.MODEL.DROPOUT_RATE, act_func=cfg.MODEL.HEAD_ACT,
        detach_final_fc=cfg.MODEL.DETACH_FINAL_FC, mlp_layers=c.NUM_MLP_LAYERS,
        mlp_dim=c.MLP_DIM, bn_mlp=c.BN_MLP or c.BN_SYNC_MLP, dtype=compute_dtype(cfg))


def _roi_head(cfg, dim_in):
    """The RoI head of ``DETECTION.ENABLE``, one entry per pathway."""
    n = len(dim_in)
    return ResNetRoIHead(
        dim_in=dim_in, num_classes=cfg.MODEL.NUM_CLASSES,
        resolution=[[cfg.DETECTION.ROI_XFORM_RESOLUTION] * 2] * n,
        scale_factor=[cfg.DETECTION.SPATIAL_SCALE_FACTOR] * n,
        dropout_rate=cfg.MODEL.DROPOUT_RATE, act_func=cfg.MODEL.HEAD_ACT,
        aligned=cfg.DETECTION.ALIGNED, detach_final_fc=cfg.MODEL.DETACH_FINAL_FC)


def _apply_head(head, xs, bboxes):
    if isinstance(head, ResNetRoIHead):
        if bboxes is None:
            raise ValueError("the detection head needs the boxes")
        return head(xs, bboxes)
    return head(xs)


def _nonlocal_args(cfg, i, per_pathway=list):
    return dict(nonlocal_inds=per_pathway(cfg.NONLOCAL.LOCATION[i]),
                nonlocal_group=per_pathway(cfg.NONLOCAL.GROUP[i]),
                nonlocal_pool=cfg.NONLOCAL.POOL[i],
                instantiation=cfg.NONLOCAL.INSTANTIATION)


class FuseFastToSlow(nn.Module):
    """Time-strided conv on the fast pathway, concatenated onto the slow one
    (reference video_model_builder.py:112-169)."""

    def __init__(self, dim_in, fusion_conv_channel_ratio, fusion_kernel, alpha, norm,
                 whole_batch=False):
        super().__init__()
        dim_fuse = dim_in * fusion_conv_channel_ratio
        self.conv_f2s = Conv3D(dim_in, dim_fuse, (fusion_kernel, 1, 1),
                               (alpha, 1, 1), (fusion_kernel // 2, 0, 0))
        self.bn = norm(dim_fuse, whole_batch=whole_batch)

    def forward(self, xs):
        x_s, x_f = xs
        fuse = F.relu(self.bn(self.conv_f2s(x_f)))
        return [torch.cat([x_s, fuse], dim=-1), x_f]


class SlowFast(nn.Module):
    """Two-pathway SlowFast network (reference video_model_builder.py:172-441)."""

    def __init__(self, cfg):
        super().__init__()
        _check_heads(cfg)
        self.dtype = compute_dtype(cfg)
        norm = norm_builder(cfg)
        self.pool1 = POOL1[cfg.MODEL.ARCH]
        depths = MODEL_STAGE_DEPTH[cfg.RESNET.DEPTH]
        num_groups = cfg.RESNET.NUM_GROUPS
        w = cfg.RESNET.WIDTH_PER_GROUP
        dim_inner = num_groups * w
        beta_inv = cfg.SLOWFAST.BETA_INV
        ratio = cfg.SLOWFAST.FUSION_CONV_CHANNEL_RATIO
        out_dim_ratio = beta_inv // ratio
        tk = TEMPORAL_KERNEL_BASIS[cfg.MODEL.ARCH]
        fuse = dict(fusion_conv_channel_ratio=ratio,
                    fusion_kernel=cfg.SLOWFAST.FUSION_KERNEL_SZ,
                    alpha=cfg.SLOWFAST.ALPHA, norm=norm)

        self.s1 = VideoModelStem(
            dim_in=cfg.DATA.INPUT_CHANNEL_NUM,
            dim_out=[w, w // beta_inv],
            kernel=[tk[0][0] + [7, 7], tk[0][1] + [7, 7]],
            stride=[[1, 2, 2]] * 2,
            padding=[[tk[0][0][0] // 2, 3, 3], [tk[0][1][0] // 2, 3, 3]],
            norm=norm,
        )
        # Per-stage channels (reference :246-367): the slow input includes
        # the fused fast channels; fast channels are slow / beta_inv.
        ins = [w, w * 4, w * 8, w * 16]
        outs = [w * 4, w * 8, w * 16, w * 32]
        inners = [dim_inner, dim_inner * 2, dim_inner * 4, dim_inner * 8]
        # The JAX package runs a fast stage of inner width under 32 T-folded,
        # and the fuse after it (after the stem for the first stage) in that
        # layout, whose BN ignores sub_batchnorm's splits
        # (slowfast_tpu/models/video_models.py:169-183; ROADMAP Queue 3).
        can_fold = (cfg.RESNET.TRANS_FUNC == "bottleneck_transform"
                    and not cfg.MODEL.ACT_CHECKPOINT)
        folded = [can_fold and inners[i] // beta_inv < 32
                  and not (cfg.NONLOCAL.LOCATION[i][-1] if len(cfg.NONLOCAL.LOCATION[i]) > 1
                           else []) for i in range(4)]
        self.s1_fuse = FuseFastToSlow(w // beta_inv, **fuse, whole_batch=folded[0])
        for i in range(4):
            stage = ResStage(
                dim_in=[ins[i] + ins[i] // out_dim_ratio, ins[i] // beta_inv],
                dim_out=[outs[i], outs[i] // beta_inv],
                dim_inner=[inners[i], inners[i] // beta_inv],
                temp_kernel_sizes=tk[i + 1],
                stride=[cfg.RESNET.SPATIAL_STRIDES[i][0]] * 2,
                num_blocks=[depths[i]] * 2,
                num_groups=[num_groups] * 2,
                num_block_temp_kernel=_per_pathway(cfg.RESNET.NUM_BLOCK_TEMP_KERNEL[i]),
                **_nonlocal_args(cfg, i, _per_pathway),
                trans_func_name=cfg.RESNET.TRANS_FUNC,
                norm=norm,
                stride_1x1=cfg.RESNET.STRIDE_1X1,
                dilation=[cfg.RESNET.SPATIAL_DILATIONS[i][0]] * 2,
                zero_init_final_bn=cfg.RESNET.ZERO_INIT_FINAL_BN,
                drop_connect_rate=cfg.MODEL.DROPCONNECT_RATE,
            )
            self.add_module(f"s{i + 2}", stage)
            if i < 3:
                self.add_module(f"s{i + 2}_fuse", FuseFastToSlow(outs[i] // beta_inv, **fuse,
                                                                 whole_batch=folded[i]))

        if cfg.DETECTION.ENABLE:
            self.head = _roi_head(cfg, [w * 32, w * 32 // beta_inv])
            return
        p0, p1 = self.pool1
        t, crop, alpha = cfg.DATA.NUM_FRAMES, cfg.DATA.TRAIN_CROP_SIZE, cfg.SLOWFAST.ALPHA
        pool = None if (cfg.MULTIGRID.SHORT_CYCLE
                        or cfg.MODEL.MODEL_NAME == "ContrastiveModel") else [
            [t // alpha // p0[0], crop // 32 // p0[1], crop // 32 // p0[2]],
            [t // p1[0], crop // 32 // p1[1], crop // 32 // p1[2]],
        ]
        self.head = _basic_head(cfg, [w * 32, w * 32 // beta_inv], pool)

    def forward(self, xs, bboxes=None):
        xs = [x.to(self.dtype) for x in xs]
        xs = self.s1_fuse(self.s1(xs))
        xs = self.s2_fuse(self.s2(xs))
        # Post-res2 pooling (identity for slowfast's [1, 1, 1]).
        xs = [max_pool3d(x, k, k) if any(v > 1 for v in k) else x
              for x, k in zip(xs, self.pool1)]
        xs = self.s3_fuse(self.s3(xs))
        xs = self.s4_fuse(self.s4(xs))
        return _apply_head(self.head, self.s5(xs), bboxes)


class ResNet(nn.Module):
    """Single-pathway C2D/I3D/Slow ResNet (slowfast_tpu/models/video_models.py:364,
    reference :444-660). ``ResNet_nopool`` drops the temporal max pool after
    res2 (POOL1), so the head pools the full temporal extent."""

    def __init__(self, cfg):
        super().__init__()
        _check_heads(cfg)
        self.dtype = compute_dtype(cfg)
        norm = norm_builder(cfg)
        pool1 = [1, 1, 1] if cfg.MODEL.MODEL_NAME == "ResNet_nopool" else POOL1[cfg.MODEL.ARCH][0]
        self.pool1 = pool1
        depths = MODEL_STAGE_DEPTH[cfg.RESNET.DEPTH]
        num_groups = cfg.RESNET.NUM_GROUPS
        w = cfg.RESNET.WIDTH_PER_GROUP
        dim_inner = num_groups * w
        tk = TEMPORAL_KERNEL_BASIS[cfg.MODEL.ARCH]

        self.s1 = VideoModelStem(
            dim_in=cfg.DATA.INPUT_CHANNEL_NUM, dim_out=[w], kernel=[tk[0][0] + [7, 7]],
            stride=[[1, 2, 2]], padding=[[tk[0][0][0] // 2, 3, 3]], norm=norm)
        ins = [w, w * 4, w * 8, w * 16]
        outs = [w * 4, w * 8, w * 16, w * 32]
        inners = [dim_inner, dim_inner * 2, dim_inner * 4, dim_inner * 8]
        for i in range(4):
            self.add_module(f"s{i + 2}", ResStage(
                dim_in=[ins[i]], dim_out=[outs[i]], dim_inner=[inners[i]],
                temp_kernel_sizes=tk[i + 1],
                stride=cfg.RESNET.SPATIAL_STRIDES[i],
                num_blocks=[depths[i]],
                num_groups=[num_groups],
                num_block_temp_kernel=cfg.RESNET.NUM_BLOCK_TEMP_KERNEL[i],
                **_nonlocal_args(cfg, i),
                trans_func_name=cfg.RESNET.TRANS_FUNC,
                norm=norm,
                stride_1x1=cfg.RESNET.STRIDE_1X1,
                dilation=cfg.RESNET.SPATIAL_DILATIONS[i],
                zero_init_final_bn=cfg.RESNET.ZERO_INIT_FINAL_BN,
                drop_connect_rate=cfg.MODEL.DROPCONNECT_RATE,
            ))

        if cfg.DETECTION.ENABLE:
            self.head = _roi_head(cfg, [w * 32])
            return
        t, crop = cfg.DATA.NUM_FRAMES, cfg.DATA.TRAIN_CROP_SIZE
        pool = None if (cfg.MULTIGRID.SHORT_CYCLE
                        or cfg.MODEL.MODEL_NAME == "ContrastiveModel") else [
            [t // pool1[0], crop // 32 // pool1[1], crop // 32 // pool1[2]]]
        self.head = _basic_head(cfg, [w * 32], pool)

    def forward(self, xs, bboxes=None):
        xs = self.s2(self.s1([x.to(self.dtype) for x in xs]))
        if any(k > 1 for k in self.pool1):
            xs = [max_pool3d(xs[0], self.pool1, self.pool1)]
        return _apply_head(self.head, self.s5(self.s4(self.s3(xs))), bboxes)


class X3D(nn.Module):
    """X3D (slowfast_tpu/models/video_models.py:476-571, reference :663-802):
    widths and depths scaled by ``X3D.WIDTH_FACTOR`` / ``DEPTH_FACTOR`` with
    ``round_width``, channelwise 3x3x3 convs under ``X3D.CHANNELWISE_3x3x3``,
    drop-connect growing with the stage, and the X3D stem and head."""

    def __init__(self, cfg):
        super().__init__()
        _check_heads(cfg, detection=False)
        self.dtype = compute_dtype(cfg)
        norm = norm_builder(cfg)
        tk = TEMPORAL_KERNEL_BASIS[cfg.MODEL.ARCH]
        exp_stage = 2.0
        dim_c1 = cfg.X3D.DIM_C1
        dim_res2 = round_width(dim_c1, exp_stage, divisor=8) if cfg.X3D.SCALE_RES2 else dim_c1
        dim_res3 = round_width(dim_res2, exp_stage, divisor=8)
        dim_res4 = round_width(dim_res3, exp_stage, divisor=8)
        dim_res5 = round_width(dim_res4, exp_stage, divisor=8)
        # [blocks before the depth factor, width before the width factor, stride]
        block_basis = [[1, dim_res2, 2], [2, dim_res3, 2], [5, dim_res4, 2], [3, dim_res5, 2]]
        w_mul, d_mul = cfg.X3D.WIDTH_FACTOR, cfg.X3D.DEPTH_FACTOR
        dim_in = round_width(dim_c1, w_mul)

        self.s1 = VideoModelStem(
            dim_in=cfg.DATA.INPUT_CHANNEL_NUM, dim_out=[dim_in], kernel=[tk[0][0] + [3, 3]],
            stride=[[1, 2, 2]], padding=[[tk[0][0][0] // 2, 1, 1]], norm=norm,
            stem_func_name="x3d_stem")
        for stage, (blocks, width, stride) in enumerate(block_basis):
            dim_out = round_width(width, w_mul)
            dim_inner = int(cfg.X3D.BOTTLENECK_FACTOR * dim_out)
            n_rep = int(math.ceil(d_mul * blocks)) if d_mul else blocks
            self.add_module(f"s{stage + 2}", ResStage(
                dim_in=[dim_in], dim_out=[dim_out], dim_inner=[dim_inner],
                temp_kernel_sizes=tk[1],
                stride=[stride],
                num_blocks=[n_rep],
                num_groups=[dim_inner] if cfg.X3D.CHANNELWISE_3x3x3 else [cfg.RESNET.NUM_GROUPS],
                num_block_temp_kernel=[n_rep],
                # Every stage reads the first stage's non-local entries, as
                # slowfast_tpu/models/video_models.py:537 does.
                **_nonlocal_args(cfg, 0),
                trans_func_name=cfg.RESNET.TRANS_FUNC,
                norm=norm,
                stride_1x1=cfg.RESNET.STRIDE_1X1,
                dilation=cfg.RESNET.SPATIAL_DILATIONS[stage],
                zero_init_final_bn=cfg.RESNET.ZERO_INIT_FINAL_BN,
                drop_connect_rate=cfg.MODEL.DROPCONNECT_RATE * (stage + 2) / (len(block_basis) + 1),
            ))
            dim_in = dim_out

        spat_sz = int(math.ceil(cfg.DATA.TRAIN_CROP_SIZE / 32.0))
        self.head = X3DHead(
            dim_in=dim_out, dim_inner=dim_inner, dim_out=cfg.X3D.DIM_C5,
            num_classes=cfg.MODEL.NUM_CLASSES,
            pool_size=[cfg.DATA.NUM_FRAMES, spat_sz, spat_sz], norm=norm,
            dropout_rate=cfg.MODEL.DROPOUT_RATE, act_func=cfg.MODEL.HEAD_ACT,
            bn_lin5_on=cfg.X3D.BN_LIN5)

    def forward(self, xs):
        xs = self.s1([x.to(self.dtype) for x in xs])
        return self.head(self.s5(self.s4(self.s3(self.s2(xs)))))
