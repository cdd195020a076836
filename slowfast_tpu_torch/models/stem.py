"""Video model stems on NTHWC tensors (counterpart of
slowfast_tpu/models/stem.py; reference stem_helper.py)."""

import torch.nn.functional as F
from torch import nn

from .common import Conv2D, Conv3D, max_pool3d


class ResNetBasicStem(nn.Module):
    """Conv(Txkxk) -> BN -> ReLU -> MaxPool(1x3x3, stride 1,2,2, pad 0,1,1).

    The direct path of slowfast_tpu/models/stem.py:116-127; the T-folded
    block-Toeplitz formulation there is a TPU layout workaround, whose BN
    under ``sub_batchnorm`` takes the whole batch (an RGB stem of temporal
    stride 1), as the port's does.
    """

    def __init__(self, dim_in, dim_out, kernel, stride, padding, norm):
        super().__init__()
        self.conv = Conv3D(dim_in, dim_out, kernel, stride, padding)
        self.bn = norm(dim_out, whole_batch=dim_in < 32 and stride[0] == 1)

    def forward(self, x):
        x = F.relu(self.bn(self.conv(x)))
        return max_pool3d(x, (1, 3, 3), (1, 2, 2), (0, 1, 1))


class X3DStem(nn.Module):
    """1xkxk ``conv_xy`` -> channelwise kx1x1 ``conv`` -> BN -> ReLU
    (slowfast_tpu/models/stem.py:139-173, reference stem_helper.py:204-285)."""

    def __init__(self, dim_in, dim_out, kernel, stride, padding, norm):
        super().__init__()
        self.conv_xy = Conv3D(dim_in, dim_out, (1, kernel[1], kernel[2]),
                              (1, stride[1], stride[2]), (0, padding[1], padding[2]))
        self.conv = Conv3D(dim_out, dim_out, (kernel[0], 1, 1), (stride[0], 1, 1),
                           (padding[0], 0, 0), groups=dim_out)
        self.bn = norm(dim_out)

    def forward(self, x):
        return F.relu(self.bn(self.conv(self.conv_xy(x))))


STEM_FUNCS = {"basic_stem": ResNetBasicStem, "x3d_stem": X3DStem}


class VideoModelStem(nn.Module):
    """One stem per pathway, named ``pathway{p}_stem`` as in the reference."""

    def __init__(self, dim_in, dim_out, kernel, stride, padding, norm,
                 stem_func_name="basic_stem"):
        super().__init__()
        self.num_pathways = len(dim_in)
        for p in range(self.num_pathways):
            self.add_module(
                f"pathway{p}_stem",
                STEM_FUNCS[stem_func_name](dim_in[p], dim_out[p], kernel[p], stride[p],
                                           padding[p], norm),
            )

    def forward(self, xs):
        if len(xs) != self.num_pathways:
            raise ValueError(f"Input has {len(xs)} pathways, expected {self.num_pathways}")
        return [getattr(self, f"pathway{p}_stem")(x) for p, x in enumerate(xs)]


class PatchEmbed(nn.Module):
    """MViT patchification: one ``Conv3D`` with bias on NTHWC input, or under
    ``conv_2d`` (``MVIT.PATCH_2D``) one ``Conv2D`` with bias on each frame
    as an image, with the (h, w) tail of the kernel, stride and padding
    (a 2-length image spec or a 3-length one) (slowfast_tpu/models/stem.py:220,
    reference stem_helper.py:288-320).

    Returns ``(tokens (B, T'*H'*W', C), [T', H', W'])``; the 2D stem keeps
    every frame, T' = T.
    """

    def __init__(self, dim_in=3, dim_out=768, kernel=(1, 16, 16), stride=(1, 4, 4),
                 padding=(1, 7, 7), conv_2d=False):
        super().__init__()
        self.conv_2d = conv_2d
        if conv_2d:
            self.proj = Conv2D(dim_in, dim_out, kernel[-2:], stride[-2:], padding[-2:],
                               bias=True)
        else:
            self.proj = Conv3D(dim_in, dim_out, kernel, stride, padding, bias=True)

    def forward(self, x):
        if self.conv_2d:
            B, T = x.shape[:2]
            x = self.proj(x.reshape(B * T, *x.shape[2:]))
            return x.reshape(B, -1, x.shape[-1]), [T, *x.shape[1:3]]
        x = self.proj(x)
        return x.reshape(x.shape[0], -1, x.shape[-1]), list(x.shape[1:4])
