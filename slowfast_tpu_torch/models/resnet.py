"""3D ResNet blocks on NTHWC tensors (counterpart of
slowfast_tpu/models/resnet.py; reference resnet_helper.py).

Module names mirror the reference's (``a``/``a_bn``/..., ``branch1``/
``branch2``, ``pathway{p}_res{i}``, ``pathway{p}_nonlocal{i}``), so
reference checkpoints load with no mapping. Every transform takes the same
arguments; ``FINAL_CONV`` names the conv that ``RESNET.ZERO_INIT_FINAL_CONV``
zeroes.
"""

import torch.nn.functional as F
from torch import nn

from .common import SE, Conv3D, DropPath
from .nonlocal_block import Nonlocal


class BasicTransform(nn.Module):
    """Tx3x3 -> BN -> ReLU -> 1x3x3 -> BN (slowfast_tpu/models/resnet.py:18-63,
    reference resnet_helper.py:27-115)."""

    FINAL_CONV = "b"

    def __init__(self, dim_in, dim_out, temp_kernel_size, stride, dim_inner,
                 num_groups, norm, stride_1x1=False, dilation=1,
                 zero_init_final_bn=False, block_idx=0):
        super().__init__()
        self.a = Conv3D(dim_in, dim_out, (temp_kernel_size, 3, 3), (1, stride, stride),
                        (temp_kernel_size // 2, 1, 1))
        self.a_bn = norm(dim_out)
        self.b = Conv3D(dim_out, dim_out, (1, 3, 3), (1, 1, 1), (0, dilation, dilation),
                        dilation=(1, dilation, dilation))
        self.b_bn = norm(dim_out, zero_init_gamma=zero_init_final_bn)

    def forward(self, x):
        return self.b_bn(self.b(F.relu(self.a_bn(self.a(x)))))


class BottleneckTransform(nn.Module):
    """Tx1x1 -> 1x3x3 -> 1x1x1 bottleneck (reference resnet_helper.py:259-392)."""

    FINAL_CONV = "c"

    def __init__(self, dim_in, dim_out, temp_kernel_size, stride, dim_inner,
                 num_groups, norm, stride_1x1=False, dilation=1,
                 zero_init_final_bn=False, block_idx=0):
        super().__init__()
        str1x1, str3x3 = (stride, 1) if stride_1x1 else (1, stride)
        self.a = Conv3D(dim_in, dim_inner, (temp_kernel_size, 1, 1),
                        (1, str1x1, str1x1), (temp_kernel_size // 2, 0, 0))
        self.a_bn = norm(dim_inner)
        self.b = Conv3D(dim_inner, dim_inner, (1, 3, 3), (1, str3x3, str3x3),
                        (0, dilation, dilation), groups=num_groups,
                        dilation=(1, dilation, dilation))
        self.b_bn = norm(dim_inner)
        self.c = Conv3D(dim_inner, dim_out, (1, 1, 1))
        self.c_bn = norm(dim_out, zero_init_gamma=zero_init_final_bn)

    def forward(self, x):
        x = F.relu(self.a_bn(self.a(x)))
        x = F.relu(self.b_bn(self.b(x)))
        return self.c_bn(self.c(x))


class X3DTransform(nn.Module):
    """1x1x1 -> BN -> ReLU -> channelwise Tx3x3 -> BN -> (SE on even block
    indices) -> Swish -> 1x1x1 -> BN (slowfast_tpu/models/resnet.py:157-214,
    reference resnet_helper.py:118-256)."""

    FINAL_CONV = "c"

    def __init__(self, dim_in, dim_out, temp_kernel_size, stride, dim_inner,
                 num_groups, norm, stride_1x1=False, dilation=1,
                 zero_init_final_bn=False, block_idx=0):
        super().__init__()
        str1x1, str3x3 = (stride, 1) if stride_1x1 else (1, stride)
        self.a = Conv3D(dim_in, dim_inner, (1, 1, 1), (1, str1x1, str1x1))
        self.a_bn = norm(dim_inner)
        self.b = Conv3D(dim_inner, dim_inner, (temp_kernel_size, 3, 3), (1, str3x3, str3x3),
                        (temp_kernel_size // 2, dilation, dilation), groups=num_groups,
                        dilation=(1, dilation, dilation))
        self.b_bn = norm(dim_inner)
        # The reference's use_se: (block_idx + 1) % 2, at its se_ratio 0.0625.
        self.se = SE(dim_inner, 0.0625) if (block_idx + 1) % 2 else None
        self.c = Conv3D(dim_inner, dim_out, (1, 1, 1))
        self.c_bn = norm(dim_out, zero_init_gamma=zero_init_final_bn)

    def forward(self, x):
        x = F.relu(self.a_bn(self.a(x)))
        x = self.b_bn(self.b(x))
        if self.se is not None:
            x = self.se(x)
        return self.c_bn(self.c(F.silu(x)))


class CSNTransform(nn.Module):
    """Channel-separated bottleneck (ir-CSN): 1x1x1 -> BN -> ReLU -> channelwise
    3x3x3 (the block's stride) -> BN -> ReLU -> 1x1x1 -> BN
    (slowfast_tpu/models/resnet.py:217-256; reference ptv_model_builder.py
    PTVCSN). The temporal kernel is 3 whatever ``temp_kernel_size`` says."""

    FINAL_CONV = "c"

    def __init__(self, dim_in, dim_out, temp_kernel_size, stride, dim_inner,
                 num_groups, norm, stride_1x1=False, dilation=1,
                 zero_init_final_bn=False, block_idx=0):
        super().__init__()
        self.a = Conv3D(dim_in, dim_inner, (1, 1, 1))
        self.a_bn = norm(dim_inner)
        self.b = Conv3D(dim_inner, dim_inner, (3, 3, 3), (1, stride, stride),
                        (1, dilation, dilation), groups=dim_inner,
                        dilation=(1, dilation, dilation))
        self.b_bn = norm(dim_inner)
        self.c = Conv3D(dim_inner, dim_out, (1, 1, 1))
        self.c_bn = norm(dim_out, zero_init_gamma=zero_init_final_bn)

    def forward(self, x):
        x = F.relu(self.a_bn(self.a(x)))
        x = F.relu(self.b_bn(self.b(x)))
        return self.c_bn(self.c(x))


class R2Plus1DTransform(nn.Module):
    """(2+1)D bottleneck: 1x1x1 -> BN -> ReLU -> spatial 1x3x3 (the block's
    stride) -> BN -> ReLU -> temporal 3x1x1 -> BN -> ReLU -> 1x1x1 -> BN
    (slowfast_tpu/models/resnet.py:259-309; reference ptv_model_builder.py
    PTVR2plus1D)."""

    FINAL_CONV = "c"

    def __init__(self, dim_in, dim_out, temp_kernel_size, stride, dim_inner,
                 num_groups, norm, stride_1x1=False, dilation=1,
                 zero_init_final_bn=False, block_idx=0):
        super().__init__()
        self.a = Conv3D(dim_in, dim_inner, (1, 1, 1))
        self.a_bn = norm(dim_inner)
        self.b_spatial = Conv3D(dim_inner, dim_inner, (1, 3, 3), (1, stride, stride),
                                (0, dilation, dilation), dilation=(1, dilation, dilation))
        self.b_spatial_bn = norm(dim_inner)
        self.b_temporal = Conv3D(dim_inner, dim_inner, (3, 1, 1), padding=(1, 0, 0))
        self.b_temporal_bn = norm(dim_inner)
        self.c = Conv3D(dim_inner, dim_out, (1, 1, 1))
        self.c_bn = norm(dim_out, zero_init_gamma=zero_init_final_bn)

    def forward(self, x):
        x = F.relu(self.a_bn(self.a(x)))
        x = F.relu(self.b_spatial_bn(self.b_spatial(x)))
        x = F.relu(self.b_temporal_bn(self.b_temporal(x)))
        return self.c_bn(self.c(x))


TRANS_FUNCS = {"bottleneck_transform": BottleneckTransform,
               "basic_transform": BasicTransform,
               "x3d_transform": X3DTransform,
               "csn_transform": CSNTransform,
               "r2plus1d_transform": R2Plus1DTransform}


class ResBlock(nn.Module):
    """Residual block with optional projection shortcut and drop-connect
    (reference resnet_helper.py:395-521)."""

    def __init__(self, dim_in, dim_out, temp_kernel_size, stride, trans_func_name,
                 dim_inner, num_groups, norm, stride_1x1=False, dilation=1,
                 zero_init_final_bn=False, drop_connect_rate=0.0, block_idx=0):
        super().__init__()
        if trans_func_name not in TRANS_FUNCS:
            raise NotImplementedError(f"{trans_func_name} is not ported yet")
        if dim_in != dim_out or stride != 1:
            self.branch1 = Conv3D(dim_in, dim_out, (1, 1, 1), (1, stride, stride))
            self.branch1_bn = norm(dim_out)
        else:
            self.branch1 = None
        self.branch2 = TRANS_FUNCS[trans_func_name](
            dim_in, dim_out, temp_kernel_size, stride, dim_inner, num_groups,
            norm, stride_1x1=stride_1x1, dilation=dilation,
            zero_init_final_bn=zero_init_final_bn, block_idx=block_idx,
        )
        self.drop_path = DropPath(drop_connect_rate)

    def forward(self, x):
        f_x = self.drop_path(self.branch2(x))
        shortcut = x if self.branch1 is None else self.branch1_bn(self.branch1(x))
        return F.relu(shortcut + f_x)


def temporal_kernel_schedule(temp_kernel_sizes, num_blocks, num_block_temp_kernel):
    """Per-block temporal kernels: ``temp_kernel_sizes`` repeated, cut at
    ``num_block_temp_kernel``, the rest 1 (slowfast_tpu/models/resnet.py:448-450)."""
    tks = (list(temp_kernel_sizes) * num_blocks)[:num_block_temp_kernel]
    return tks + [1] * (num_blocks - num_block_temp_kernel)


class ResStage(nn.Module):
    """A multi-pathway stage of residual blocks, with a non-local block after
    each block whose index is in ``nonlocal_inds[p]`` (reference
    resnet_helper.py:524-726). A non-local group > 1 folds that many
    temporal groups into the batch around the block."""

    def __init__(self, dim_in, dim_out, dim_inner, temp_kernel_sizes, stride,
                 num_blocks, num_groups, num_block_temp_kernel, nonlocal_inds,
                 trans_func_name, norm, stride_1x1=False, dilation=(1, 1),
                 zero_init_final_bn=False, drop_connect_rate=0.0,
                 nonlocal_group=None, nonlocal_pool=None, instantiation="softmax"):
        super().__init__()
        self.num_pathways = len(num_blocks)
        self.num_blocks = list(num_blocks)
        self.nonlocal_inds = [list(inds) for inds in nonlocal_inds]
        self.nonlocal_group = list(nonlocal_group or [1] * self.num_pathways)
        for p in range(self.num_pathways):
            tks = temporal_kernel_schedule(temp_kernel_sizes[p], num_blocks[p],
                                           num_block_temp_kernel[p])
            # The JAX package runs a narrow bottleneck stage T-folded, and
            # its folded BN ignores sub_batchnorm's splits
            # (slowfast_tpu/models/resnet.py:464-473).
            block_norm = norm
            if (dim_inner[p] < 32 and trans_func_name == "bottleneck_transform"
                    and not self.nonlocal_inds[p]):
                def block_norm(n, zero_init_gamma=False):
                    return norm(n, zero_init_gamma, whole_batch=True)
            for i in range(num_blocks[p]):
                self.add_module(f"pathway{p}_res{i}", ResBlock(
                    dim_in[p] if i == 0 else dim_out[p], dim_out[p], tks[i],
                    stride[p] if i == 0 else 1, trans_func_name, dim_inner[p],
                    num_groups[p], block_norm, stride_1x1=stride_1x1,
                    dilation=dilation[p], zero_init_final_bn=zero_init_final_bn,
                    drop_connect_rate=drop_connect_rate, block_idx=i,
                ))
                if i in self.nonlocal_inds[p]:
                    self.add_module(f"pathway{p}_nonlocal{i}", Nonlocal(
                        dim_out[p], dim_out[p] // 2, pool_size=nonlocal_pool[p],
                        instantiation=instantiation, norm=norm))

    def forward(self, xs):
        out = []
        for p, x in enumerate(xs):
            group = self.nonlocal_group[p]
            for i in range(self.num_blocks[p]):
                x = getattr(self, f"pathway{p}_res{i}")(x)
                if i in self.nonlocal_inds[p]:
                    b, t, h, w, c = x.shape
                    x = getattr(self, f"pathway{p}_nonlocal{i}")(
                        x.reshape(b * group, t // group, h, w, c))
                    x = x.reshape(b, t, h, w, c)
            out.append(x)
        return out
