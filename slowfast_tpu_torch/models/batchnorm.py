"""Batch normalization on NTHWC tensors (counterpart of
slowfast_tpu/models/batchnorm.py; reference batchnorm_helper.py), and the
1-D batch norm of the SSL MLP heads (flax ``nn.BatchNorm``,
slowfast_tpu/models/heads.py:219).

Statistics and the per-channel affine are computed in fp32 (float64 for
float64 activations); the per-element ``x * a + b`` runs in the activation
dtype.
"""

import torch
from torch import nn

from slowfast_tpu_torch.utils import distributed as du

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

    ``num_splits`` > 1 is ``sub_batchnorm`` (reference SubBatchNorm3d): in
    training, a batch that splits evenly is normalized per split, each with
    its own statistics, and the splits' statistics are merged into the
    batch's for the running ones, as the JAX package folds
    ``aggregate_sub_bn_stats`` into every update (batchnorm.py:82-104).

    Under a process group a training forward takes its statistics over the
    global batch, as every BN of the JAX package does under the mesh,
    whatever ``BN.NORM_TYPE`` says (slowfast_tpu/models/batchnorm.py:1-20):
    each rank's fp32 mean and mean square are averaged over the ranks by an
    all-reduce whose backward reduces the gradients too, and the running
    variance's unbiased correction counts the global batch. The loader
    gives every rank the same number of rows, so the mean of the ranks'
    means is the global mean, and one rank computes exactly what one
    process does. ``num_splits`` splits the global batch: over W ranks,
    when W divides it each rank holds whole splits and normalizes them
    alone; when it divides W each split spans ``W / num_splits``
    consecutive ranks, which reduce among themselves; the running
    statistics merge every split's over the world.
    """

    def __init__(self, num_features, eps=1e-5, momentum=0.1, frozen=False,
                 zero_init_gamma=False, num_splits=1):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.frozen = frozen
        self.num_splits = num_splits
        init = torch.zeros if zero_init_gamma else torch.ones
        self.weight = nn.Parameter(init(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))
        self.register_buffer("num_batches_tracked", torch.zeros((), dtype=torch.long))
        self.precise_sums = None

    def forward(self, x):
        if self.training and not self.frozen:
            return self._train_forward(x)
        inv = torch.reciprocal(torch.sqrt(self.running_var + self.eps))
        a = (self.weight * inv).to(x.dtype)
        b = (self.bias - self.running_mean * self.weight * inv).to(x.dtype)
        return x * a + b

    def _split_forward(self, x, s, ranks=1):
        xs = x.reshape(s, x.shape[0] // s, *x.shape[1:])
        dims = tuple(range(1, xs.dim() - 1))
        xs32 = xs.to(sum_dtype(x.dtype))
        mean_s = xs32.mean(dims)  # (s, C)
        var_s = xs32.square().mean(dims) - mean_s.square()
        inv_s = torch.reciprocal(torch.sqrt(var_s + self.eps))
        a = (self.weight * inv_s).to(x.dtype)
        b = (self.bias - mean_s * self.weight * inv_s).to(x.dtype)
        view = (s,) + (1,) * (xs.dim() - 2) + (x.shape[-1],)
        y = (xs * a.view(view) + b.view(view)).reshape(x.shape)
        self._track(x, *self._world_moments(mean_s.mean(0), (var_s + mean_s.square()).mean(0)),
                    ranks)
        return y

    def _train_forward(self, x):
        """The training forward: statistics over the global batch (this
        rank's batch when no process group runs)."""
        world, s = du.get_world_size(), self.num_splits
        if s > 1 and s % world == 0:
            local = s // world
            if x.shape[0] % local == 0:
                return self._split_forward(x, local, world)
        elif world % s:
            raise ValueError(f"BN.NUM_SPLITS {s} splits a global batch over {world} ranks "
                             "unevenly: one must divide the other")
        size = world // s if world % s == 0 else world
        dims = tuple(range(x.dim() - 1))
        x32 = x.to(sum_dtype(x.dtype))
        moments = torch.cat([x32.mean(dims), x32.square().mean(dims)])
        moments = du.all_reduce_sum_autograd(moments, du.rank_group(size)) / size
        mean, sq = moments.chunk(2)
        var = sq - mean.square()
        inv = torch.reciprocal(torch.sqrt(var + self.eps))
        if size < world:  # each split's statistics, merged over the world
            self._track(x, *self._world_moments(mean, sq), world)
        else:
            self._track(x, mean, var, world)
        a = (self.weight * inv).to(x.dtype)
        b = (self.bias - mean * self.weight * inv).to(x.dtype)
        return x * a + b

    @staticmethod
    def _world_moments(mean, sq):
        """The mean and variance of equal parts from their means and mean
        squares, averaged over the ranks under a process group."""
        with torch.no_grad():
            moments = du.all_reduce([torch.cat([mean, sq]).detach()], "mean")[0]
            mean, sq = moments.chunk(2)
            return mean, sq - mean.square()

    def _track(self, x, mean, var, ranks=1):
        """The running statistics' update from a training batch's, on
        ``ranks`` equal batches like ``x``."""
        with torch.no_grad():
            n = x.numel() / x.shape[-1] * ranks
            unbiased = var * (n / max(n - 1.0, 1.0))
            if self.precise_sums is not None:
                self.precise_sums[0].add_(mean)
                self.precise_sums[1].add_(unbiased)
            else:
                self.running_mean.mul_(1.0 - self.momentum).add_(self.momentum * mean)
                self.running_var.mul_(1.0 - self.momentum).add_(self.momentum * unbiased)
                self.num_batches_tracked.add_(1)


class BatchNorm1D(nn.Module):
    """flax ``nn.BatchNorm(momentum=0.9, epsilon=1e-5, dtype=float32)`` over
    every axis but the last, the BN of the SSL MLP heads
    (slowfast_tpu/models/heads.py:240-247): statistics and output in fp32,
    ``var = max(E[x²] - E[x]², 0)``, ``y = (x - mean) * (rsqrt(var + eps) *
    weight) + bias``, and flax's momentum convention: ``new = 0.9 * old +
    0.1 * batch``, with the biased batch variance.

    Under a process group a training forward takes its statistics over the
    global batch, as flax's BN does under the JAX package's mesh: each
    rank's mean and mean square averaged over the ranks by the autograd
    all-reduce of ``BatchNorm3D`` (every rank holds as many rows)."""

    def __init__(self, num_features, eps=1e-5, momentum=0.9):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))
        self.register_buffer("num_batches_tracked", torch.zeros((), dtype=torch.long))

    def forward(self, x):
        x = x.to(sum_dtype(x.dtype))
        if self.training:
            dims = tuple(range(x.dim() - 1))
            moments = du.all_reduce_sum_autograd(torch.cat([x.mean(dims), x.square().mean(dims)]))
            mean, sq = (moments / du.get_world_size()).chunk(2)
            var = torch.clamp(sq - mean.square(), min=0.0)
            with torch.no_grad():
                self.running_mean.mul_(self.momentum).add_((1.0 - self.momentum) * mean)
                self.running_var.mul_(self.momentum).add_((1.0 - self.momentum) * var)
                self.num_batches_tracked.add_(1)
        else:
            mean, var = self.running_mean.to(x.dtype), self.running_var.to(x.dtype)
        return (x - mean) * (torch.rsqrt(var + self.eps) * self.weight) + self.bias


def norm_builder(cfg):
    """Return ``make(num_features, zero_init_gamma=False, whole_batch=False)
    -> BatchNorm3D`` configured from ``cfg.BN`` (reference get_norm,
    batchnorm_helper.py). ``whole_batch`` keeps ``sub_batchnorm`` from
    splitting: the JAX package runs the RGB stems and the stages whose inner
    width is under 32 T-folded, and its folded BN takes the whole batch's
    statistics (slowfast_tpu/models/stem.py:50, resnet.py:464; ROADMAP
    Queue 3)."""
    norm_type = cfg.BN.NORM_TYPE
    if norm_type not in ("batchnorm", "sub_batchnorm", "sync_batchnorm", "sync_batchnorm_apex"):
        raise ValueError(f"Unknown BN.NORM_TYPE {norm_type}")
    frozen = cfg.MODEL.FROZEN_BN
    num_splits = cfg.BN.NUM_SPLITS if norm_type == "sub_batchnorm" else 1

    def make(num_features, zero_init_gamma=False, whole_batch=False):
        return BatchNorm3D(num_features, frozen=frozen, zero_init_gamma=zero_init_gamma,
                           num_splits=1 if whole_batch else num_splits)

    return make
