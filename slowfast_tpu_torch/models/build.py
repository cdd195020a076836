"""Model registry and builder (counterpart of slowfast_tpu/models/build.py;
reference slowfast/models/build.py).

``build_model`` builds the registered model, initializes it with the JAX
package's distributions (not its bits) from a ``torch.Generator`` seeded by
``cfg.RNG_SEED``, and moves it to the device, with its 5-D (conv) weights in
``channels_last_3d``. Drop path and dropout draw from one generator on the
model's device, seeded by ``cfg.RNG_SEED`` plus the process's rank, so the
ranks of a multi-process job draw different masks.
"""

import torch
from torch import nn

import math
import re

from slowfast_tpu_torch.utils.distributed import get_rank

from .common import Conv3D, msra_fill_, trunc_normal_
from .contrastive import ContrastiveModel
from .heads import MLPHead
from .masked import MaskMViT
from .mvit import MViT
from .resnet import ResBlock
from .video_models import X3D, ResNet, SlowFast

# The reference's pytorchvideo-backed names map to the native models
# (slowfast_tpu/models/__init__.py:4-19): CSN and R(2+1)D are the ResNet with
# RESNET.TRANS_FUNC csn_transform / r2plus1d_transform (their YAMLs leave it
# at bottleneck_transform); ResNet_nopool is the ResNet without the
# temporal pool after res2; PTVMViT is MViT (slowfast_tpu/models/__init__.py:27-28).
MODEL_REGISTRY = {"SlowFast": SlowFast, "PTVSlowFast": SlowFast, "MViT": MViT, "PTVMViT": MViT,
                  "MaskMViT": MaskMViT, "ResNet": ResNet, "PTVResNet": ResNet, "ResNet_nopool": ResNet,
                  "PTVCSN": ResNet, "PTVR2plus1D": ResNet, "X3D": X3D, "PTVX3D": X3D,
                  "ContrastiveModel": ContrastiveModel}


def resolve_device(device):
    """``torch.device(device)``, raising if CUDA is asked for and missing."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run on the CPU")
    return device


def init_weights(model, cfg, generator):
    """MSRA fan-out normal conv weights (zero for each residual branch's
    final conv under ``RESNET.ZERO_INIT_FINAL_CONV``) and zero conv biases
    (SE, non-local), N(0, FC_INIT_STD) projection with zero bias, the SSL
    MLP heads' Linears Xavier-uniform with zero biases (heads.py:233); BN
    starts at scale 1 (0 for zero-init BNs: final BNs, the non-local
    ``bn``), bias 0, mean 0, var 1 (slowfast_tpu/models/common.py:14, :58,
    heads.py:76-82, batchnorm.py)."""
    mlp = set()
    for m in model.modules():
        if isinstance(m, MLPHead):
            for layer in m.projection:
                if isinstance(layer, nn.Linear):
                    xavier_uniform_(layer.weight, generator)
                    if layer.bias is not None:
                        nn.init.zeros_(layer.bias)
                    mlp.add(layer)
    for m in model.modules():
        if isinstance(m, Conv3D):
            msra_fill_(m.weight, generator)
        elif isinstance(m, nn.Linear) and m not in mlp:
            with torch.no_grad():
                m.weight.normal_(0.0, cfg.MODEL.FC_INIT_STD, generator=generator)
            nn.init.zeros_(m.bias)
    if cfg.RESNET.ZERO_INIT_FINAL_CONV:
        for m in model.modules():
            if isinstance(m, ResBlock):
                nn.init.zeros_(getattr(m.branch2, m.branch2.FINAL_CONV).weight)


def xavier_uniform_(weight, generator):
    """flax ``xavier_uniform`` of a ``(out, in)`` weight: U(±sqrt(6 / (in + out)))."""
    bound = math.sqrt(6.0 / sum(weight.shape))
    with torch.no_grad():
        weight.uniform_(-bound, bound, generator=generator)


def init_contrastive_weights(model, cfg, generator):
    """``ContrastiveModel``: the backbone's own init (its head's MLP
    Xavier-uniform), the predictors Xavier-uniform, the prototypes flax's
    default ``lecun_normal`` (slowfast_tpu/models/contrastive.py:76-79)."""
    backbone = model.backbone
    init = init_mvit_weights if isinstance(backbone, MViT) else init_weights
    init(backbone, cfg, generator)
    init_weights(model.predictors, cfg, generator)
    if hasattr(model, "swav_prototypes"):
        w = model.swav_prototypes.weight
        trunc_normal_(w, math.sqrt(1.0 / w.shape[1]) / _TRUNC_STD, generator)


# MSSeparateHead's LayerNorms: the last entry of each ``transforms.{i}``.
_HEAD_NORM = re.compile(r"pred_head\.transforms\.\d+\.\d+\.(weight|bias)")
# Rev-MViT's TwoStreamFusion parameters (flax default inits).
_FUSION = re.compile(r"(^|\.)(fuse_fn[12]?|fuse_norm|fuse_mlp)\.")
# The std of a unit normal truncated at +-2 (flax's truncated_normal
# variance scaling divides by it).
_TRUNC_STD = 0.87962566103423978
_TRUNC_TABLES = ("rel_pos", "cls_token", "pos_embed", "mask_token", "decoder_pos_embed",
                 "dec_pos_embed")


def init_mvit_weights(model, cfg, generator):
    """MViT's init (slowfast_tpu/models/attention.py:31-34, mvit.py, stem.py,
    heads.py): Linear and conv weights (``qkv`` or ``q``/``k``/``v``, the
    shared or unshared pool kernels), rel-pos tables, the cls token and the
    absolute pos-embeds trunc_normal(0.02); Linear and LayerNorm biases
    0.02 (``norm_stem`` too), LayerNorm scales 1; the patch-stem conv bias
    0; the head trunc_normal(0.02 * HEAD_INIT_SCALE) with a zero bias, or,
    under detection, the RoI head's N(0, FC_INIT_STD) with a zero bias.
    Rel-pos tables are 0 under REL_POS_ZERO_INIT; layer scales keep their
    constant. ``MaskMViT`` (slowfast_tpu/models/masked.py): the mask token
    and the decoder pos-embeds trunc_normal(0.02); its heads' LayerNorms
    the default init (scale 1, bias 0) and their projections
    trunc_normal(0.02) with a zero bias; ``norm`` and ``decoder_embed`` the
    0.02 bias. Rev-MViT's stream fusions (``fuse_fn*``, ``fuse_norm``,
    ``fuse_mlp``) keep flax's defaults (slowfast_tpu/models/common.py:276-287):
    lecun_normal projections with zero biases."""
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if _FUSION.search(name):
            # flax defaults: Dense lecun_normal with zero bias, LayerNorm
            # scale 1 and bias 0, the Mlp's trunc_normal(0.02) with zero bias.
            if leaf == "bias":
                nn.init.zeros_(p)
            elif p.dim() == 1:
                nn.init.ones_(p)
            elif ".fuse_mlp." in name:
                trunc_normal_(p, 0.02, generator)
            else:
                trunc_normal_(p, math.sqrt(1.0 / p.shape[1]) / _TRUNC_STD, generator)
        elif _HEAD_NORM.fullmatch(name) or name.startswith("pred_head.projections."):
            if leaf == "weight" and p.dim() == 2:
                trunc_normal_(p, 0.02, generator)
            elif leaf == "weight":
                nn.init.ones_(p)
            else:
                nn.init.zeros_(p)
        elif name == "head.projection.weight":
            if cfg.DETECTION.ENABLE:
                with torch.no_grad():
                    p.normal_(0.0, cfg.MODEL.FC_INIT_STD, generator=generator)
            else:
                trunc_normal_(p, 0.02 * cfg.MVIT.HEAD_INIT_SCALE, generator)
        elif name in ("head.projection.bias", "patch_embed.proj.bias"):
            nn.init.zeros_(p)
        elif leaf.startswith("rel_pos") and cfg.MVIT.REL_POS_ZERO_INIT:
            nn.init.zeros_(p)
        elif leaf == "weight" and p.dim() == 1:  # LayerNorm scale
            nn.init.ones_(p)
        elif leaf == "bias":
            nn.init.constant_(p, 0.02)
        elif leaf == "weight" or leaf.startswith(_TRUNC_TABLES):
            trunc_normal_(p, 0.02, generator)



def scale_init_by_depth(model):
    """``MASK.SCALE_INIT_BY_DEPTH`` (slowfast_tpu/models/build.py:57-95,
    reference masked.py fix_init_weight): each residual branch's output
    projection (``attn.proj``, ``mlp.fc2``) of trunk block ``i`` divided by
    ``sqrt(2 (i + 1))``; in decoder block ``j`` the attention's layer id
    continues past the trunk's blocks while ``fc2``'s restarts at 1."""
    n_trunk = len(model.blocks)
    blocks = [(blk, i + 1, i + 1) for i, blk in enumerate(model.blocks)]
    for layers in model.pred_head.transforms:
        blocks += [(blk, j + 1, j + 1 + n_trunk) for j, blk in enumerate(layers[:-1])]
    with torch.no_grad():
        for blk, layer_id, attn_id in blocks:
            blk.attn.proj.weight.div_(math.sqrt(2.0 * attn_id))
            blk.mlp.fc2.weight.div_(math.sqrt(2.0 * layer_id))


def build_model(cfg, device="cuda"):
    """Build, initialize and place the model for ``cfg.MODEL.MODEL_NAME``."""
    device = resolve_device(device)
    name = cfg.MODEL.MODEL_NAME
    if name not in MODEL_REGISTRY:
        raise NotImplementedError(f"model {name!r} is not ported yet; "
                                  f"available: {sorted(MODEL_REGISTRY)}")
    model = MODEL_REGISTRY[name](cfg)
    init = init_mvit_weights if isinstance(model, (MViT, MaskMViT)) else init_weights
    if isinstance(model, ContrastiveModel):
        init = init_contrastive_weights
    init(model, cfg, torch.Generator().manual_seed(cfg.RNG_SEED))
    if cfg.MASK.ENABLE and cfg.MASK.SCALE_INIT_BY_DEPTH:
        scale_init_by_depth(model)
    model = model.to(device=device)
    with torch.no_grad():  # channels_last_3d for the 5-D conv kernels only
        for t in list(model.parameters()) + list(model.buffers()):
            if t.dim() == 5:
                t.data = t.data.contiguous(memory_format=torch.channels_last_3d)
    set_generator(model, torch.Generator(device=device).manual_seed(cfg.RNG_SEED + get_rank()))
    return model


def set_generator(model, generator):
    """Give every module that draws random numbers in training (drop path,
    dropout) ``generator``."""
    for m in model.modules():
        if hasattr(m, "generator"):
            m.generator = generator
