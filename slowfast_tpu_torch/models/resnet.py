"""3D ResNet blocks on NTHWC tensors (counterpart of
slowfast_tpu/models/resnet.py; reference resnet_helper.py).

Module names mirror the reference's (``a``/``a_bn``/..., ``branch1``/
``branch2``, ``pathway{p}_res{i}``), so reference checkpoints load with no
mapping.
"""

import torch.nn.functional as F
from torch import nn

from .common import Conv3D, DropPath


class BottleneckTransform(nn.Module):
    """Tx1x1 -> 1x3x3 -> 1x1x1 bottleneck (reference resnet_helper.py:259-392)."""

    def __init__(self, dim_in, dim_out, temp_kernel_size, stride, dim_inner,
                 num_groups, norm, stride_1x1=False, dilation=1,
                 zero_init_final_bn=False):
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


TRANS_FUNCS = {"bottleneck_transform": BottleneckTransform}


class ResBlock(nn.Module):
    """Residual block with optional projection shortcut and drop-connect
    (reference resnet_helper.py:395-521)."""

    def __init__(self, dim_in, dim_out, temp_kernel_size, stride, trans_func_name,
                 dim_inner, num_groups, norm, stride_1x1=False, dilation=1,
                 zero_init_final_bn=False, drop_connect_rate=0.0):
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
            zero_init_final_bn=zero_init_final_bn,
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
    """A multi-pathway stage of residual blocks (reference
    resnet_helper.py:524-726). Non-local blocks are not ported yet."""

    def __init__(self, dim_in, dim_out, dim_inner, temp_kernel_sizes, stride,
                 num_blocks, num_groups, num_block_temp_kernel, nonlocal_inds,
                 trans_func_name, norm, stride_1x1=False, dilation=(1, 1),
                 zero_init_final_bn=False, drop_connect_rate=0.0):
        super().__init__()
        if any(nonlocal_inds):
            raise NotImplementedError("Non-local blocks are not ported yet")
        self.num_pathways = len(num_blocks)
        self.num_blocks = list(num_blocks)
        for p in range(self.num_pathways):
            tks = temporal_kernel_schedule(temp_kernel_sizes[p], num_blocks[p],
                                           num_block_temp_kernel[p])
            for i in range(num_blocks[p]):
                self.add_module(f"pathway{p}_res{i}", ResBlock(
                    dim_in[p] if i == 0 else dim_out[p], dim_out[p], tks[i],
                    stride[p] if i == 0 else 1, trans_func_name, dim_inner[p],
                    num_groups[p], norm, stride_1x1=stride_1x1,
                    dilation=dilation[p], zero_init_final_bn=zero_init_final_bn,
                    drop_connect_rate=drop_connect_rate,
                ))

    def forward(self, xs):
        out = []
        for p, x in enumerate(xs):
            for i in range(self.num_blocks[p]):
                x = getattr(self, f"pathway{p}_res{i}")(x)
            out.append(x)
        return out
