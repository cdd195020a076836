"""Batch normalization on NTHWC tensors (counterpart of
slowfast_tpu/models/batchnorm.py; reference batchnorm_helper.py).

Statistics and the per-channel affine are computed in fp32 (float64 for
float64 activations); the per-element ``x * a + b`` runs in the activation
dtype.
"""

import torch
from torch import nn

from .common import sum_dtype


class BatchNorm3D(nn.Module):
    """BatchNorm over (B, T, H, W) of an NTHWC input, torch-convention
    momentum: ``new = (1 - momentum) * old + momentum * batch``. Training
    normalizes with the biased batch variance and updates the running
    variance with the unbiased one, as ``torch.nn.BatchNorm3d`` does.
    Buffer names follow ``torch.nn.BatchNorm3d``, so reference checkpoints
    load with no mapping.

    While ``precise_sums`` holds two (C,) fp32 tensors (``engine/precise_bn.py``),
    a training forward adds its batch mean and unbiased batch variance to
    them and leaves the running statistics as they are.
    """

    def __init__(self, num_features, eps=1e-5, momentum=0.1, frozen=False,
                 zero_init_gamma=False):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.frozen = frozen
        init = torch.zeros if zero_init_gamma else torch.ones
        self.weight = nn.Parameter(init(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))
        self.register_buffer("num_batches_tracked", torch.zeros((), dtype=torch.long))
        self.precise_sums = None

    def forward(self, x):
        if self.training and not self.frozen:
            dims = tuple(range(x.dim() - 1))
            x32 = x.to(sum_dtype(x.dtype))
            mean = x32.mean(dims)
            var = x32.square().mean(dims) - mean.square()
            inv = torch.reciprocal(torch.sqrt(var + self.eps))
            with torch.no_grad():
                n = x.numel() / x.shape[-1]
                unbiased = var * (n / max(n - 1.0, 1.0))
                if self.precise_sums is not None:
                    self.precise_sums[0].add_(mean)
                    self.precise_sums[1].add_(unbiased)
                else:
                    self.running_mean.mul_(1.0 - self.momentum).add_(self.momentum * mean)
                    self.running_var.mul_(1.0 - self.momentum).add_(self.momentum * unbiased)
                    self.num_batches_tracked.add_(1)
        else:
            mean, var = self.running_mean, self.running_var
            inv = torch.reciprocal(torch.sqrt(var + self.eps))
        a = (self.weight * inv).to(x.dtype)
        b = (self.bias - mean * self.weight * inv).to(x.dtype)
        return x * a + b


def norm_builder(cfg):
    """Return ``make(num_features, zero_init_gamma=False) -> BatchNorm3D``
    configured from ``cfg.BN`` (reference get_norm, batchnorm_helper.py)."""
    norm_type = cfg.BN.NORM_TYPE
    if norm_type == "sub_batchnorm":
        raise NotImplementedError("sub_batchnorm is not ported yet")
    if norm_type not in ("batchnorm", "sync_batchnorm", "sync_batchnorm_apex"):
        raise ValueError(f"Unknown BN.NORM_TYPE {norm_type}")
    frozen = cfg.MODEL.FROZEN_BN

    def make(num_features, zero_init_gamma=False):
        return BatchNorm3D(num_features, frozen=frozen, zero_init_gamma=zero_init_gamma)

    return make
