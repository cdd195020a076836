"""Classification head on NTHWC tensors (counterpart of
slowfast_tpu/models/heads.py:29-91; reference head_helper.py:198-350).

Training returns raw logits. Eval applies the activation per position and
then, for fully-convolutional inference on crops larger than the training
crop, averages over the remaining T/H/W positions.
"""

import torch
import torch.nn.functional as F
from torch import nn

from .common import avg_pool3d


class ResNetBasicHead(nn.Module):
    """Per-pathway avg-pool -> concat -> dropout -> linear projection.

    ``pool_size[p] is None`` (or ``pool_size is None``) means global average
    pooling. The projection is named ``projection`` as in the reference.
    """

    def __init__(self, dim_in, num_classes, pool_size, dropout_rate=0.0,
                 act_func="softmax"):
        super().__init__()
        if act_func not in ("softmax", "sigmoid", "none"):
            raise NotImplementedError(f"{act_func} is not supported as an activation function.")
        self.pool_size = pool_size
        self.dropout_rate = dropout_rate
        self.act_func = act_func
        self.projection = nn.Linear(sum(dim_in), num_classes)

    def forward(self, xs):
        pooled = []
        for p, x in enumerate(xs):
            if self.pool_size is None or self.pool_size[p] is None:
                pooled.append(x.mean(dim=(1, 2, 3), keepdim=True))
            else:
                pooled.append(avg_pool3d(x, self.pool_size[p], (1, 1, 1)))
        x = torch.cat(pooled, dim=-1)
        if self.training and self.dropout_rate > 0.0:
            raise NotImplementedError("head dropout in training is not ported yet")
        x = F.linear(x, self.projection.weight.to(x.dtype),
                     self.projection.bias.to(x.dtype))
        if not self.training:
            if self.act_func == "softmax":
                x = torch.softmax(x, dim=-1)
            elif self.act_func == "sigmoid":
                x = torch.sigmoid(x)
            if x.shape[1:4] != (1, 1, 1):
                x = x.mean(dim=(1, 2, 3), keepdim=True)
        return x.reshape(x.shape[0], -1)
