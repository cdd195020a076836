"""Non-local block on NTHWC tensors (counterpart of
slowfast_tpu/models/nonlocal_block.py:17-65; reference
nonlocal_helper.py:10-144).

Self-attention over all T*H*W positions: 1x1x1 ``conv_theta``/``conv_phi``/
``conv_g`` (with biases), keys and values optionally max-pooled by
``pool_size``, the affinity in fp32, softmax (scaled by ``dim_inner^-0.5``)
or dot-product (divided by the number of keys) normalization, the second
product in g's dtype with an fp32 sum, ``conv_out``, a zero-init BN and the
residual. The products are plain batched matmuls: the dot-product form
takes no softmax, so it is not an attention call.
"""

import torch
from torch import nn

from .common import Conv3D, max_pool3d, sum_dtype


class Nonlocal(nn.Module):
    def __init__(self, dim, dim_inner, pool_size=None, instantiation="softmax", norm=None):
        super().__init__()
        if instantiation not in ("softmax", "dot_product"):
            raise NotImplementedError(f"Unknown non-local instantiation {instantiation}")
        self.dim_inner = dim_inner
        self.pool_size = (list(pool_size) if pool_size is not None
                          and any(s > 1 for s in pool_size) else None)
        self.instantiation = instantiation
        self.conv_theta = Conv3D(dim, dim_inner, (1, 1, 1), bias=True)
        self.conv_phi = Conv3D(dim, dim_inner, (1, 1, 1), bias=True)
        self.conv_g = Conv3D(dim, dim_inner, (1, 1, 1), bias=True)
        self.conv_out = Conv3D(dim_inner, dim, (1, 1, 1), bias=True)
        self.bn = norm(dim, zero_init_gamma=True)

    def forward(self, x):
        B, T, H, W, _ = x.shape
        d = self.dim_inner
        kv_in = x if self.pool_size is None else max_pool3d(x, self.pool_size, self.pool_size)
        theta = self.conv_theta(x).reshape(B, -1, d)
        phi = self.conv_phi(kv_in).reshape(B, -1, d)
        g = self.conv_g(kv_in).reshape(B, -1, d)
        # (B, n_q, n_kv) in fp32, as JAX's preferred_element_type=float32.
        acc = sum_dtype(x.dtype)
        aff = torch.matmul(theta.to(acc), phi.to(acc).transpose(1, 2))
        if self.instantiation == "softmax":
            aff = torch.softmax(aff * d ** -0.5, dim=2)
        else:
            aff = aff / aff.shape[2]
        out = torch.matmul(aff.to(g.dtype), g).to(x.dtype).reshape(B, T, H, W, d)
        return x + self.bn(self.conv_out(out))
