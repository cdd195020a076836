"""Classification heads, the RoI head of detection and the SSL MLP head
(counterpart of slowfast_tpu/models/heads.py:29-290; reference
head_helper.py:20-563).

Training returns raw logits, with dropout drawn from the model's generator.
Eval applies the activation; the ResNet and X3D heads apply it per position
and then, for fully-convolutional inference on crops larger than the
training crop, average over the remaining T/H/W positions. The RoI head
applies its activation in training too, as the reference does for
detection.
"""

import torch
import torch.nn.functional as F
from torch import nn

from slowfast_tpu_torch.ops.roi_align import roi_align

from .batchnorm import BatchNorm1D
from .common import Conv3D, avg_pool3d, dropout, linear


def _check_act(act_func):
    if act_func not in ("softmax", "sigmoid", "none"):
        raise NotImplementedError(f"{act_func} is not supported as an activation function.")


def _activate(x, act_func):
    if act_func == "softmax":
        return torch.softmax(x, dim=-1)
    if act_func == "sigmoid":
        return torch.sigmoid(x)
    return x


def _project(head, x):
    """Dropout (training only), ``detach_final_fc``, the projection in
    ``x``'s dtype (a Linear, or the SSL ``MLPHead``) and, in eval, the
    activation per position averaged over the positions; returns ``(B,
    num_classes)``."""
    if head.training and head.dropout_rate > 0.0:
        x = dropout(x, head.dropout_rate, head.generator)
    if getattr(head, "detach_final_fc", False):
        x = x.detach()
    if isinstance(head.projection, MLPHead):
        x = head.projection(x)
    else:
        x = linear(x, head.projection, x.dtype)
    if not head.training:
        x = _activate(x, head.act_func)
        if x.shape[1:4] != (1, 1, 1):
            x = x.mean(dim=(1, 2, 3), keepdim=True)
    return x.reshape(x.shape[0], -1)


class MLPHead(nn.Module):
    """The SSL projector and predictor MLP (slowfast_tpu/models/heads.py:219,
    reference head_helper.py:147-195): Linear, then ``num_layers - 1`` times
    [BatchNorm1D under ``bn_on``] -> ReLU -> Linear, in an ``nn.Sequential``
    named ``projection`` whose indices count the ReLUs, as the reference's
    do. Under ``bn_on`` the Linears before the last have no bias. The
    Linears run in ``dtype``, or, when it is None, in the promotion of the
    input's dtype and fp32, as a flax ``Dense`` with no dtype does; the BNs
    in fp32. Weights are Xavier-uniform, biases zero (``init_weights``)."""

    def __init__(self, dim_in, dim_out, mlp_dim, num_layers, bn_on=False, dtype=None):
        super().__init__()
        self.dtype = dtype
        layers = [nn.Linear(dim_in, mlp_dim, bias=not bn_on)]
        for i in range(1, num_layers):
            if bn_on:
                layers.append(BatchNorm1D(mlp_dim))
            layers.append(nn.ReLU())
            last = i == num_layers - 1
            layers.append(nn.Linear(mlp_dim, dim_out if last else mlp_dim,
                                    bias=last or not bn_on))
        self.projection = nn.Sequential(*layers)

    def forward(self, x):
        for layer in self.projection:
            if isinstance(layer, nn.Linear):
                dtype = self.dtype or torch.promote_types(x.dtype, layer.weight.dtype)
                x = linear(x, layer, dtype)
            else:
                x = layer(x)
        return x


class ResNetBasicHead(nn.Module):
    """Per-pathway avg-pool -> concat -> dropout -> ``detach_final_fc`` ->
    linear projection, or, with ``mlp_layers`` > 1, the contrastive
    ``MLPHead`` in the compute dtype ``dtype`` (slowfast_tpu/models/heads.py:29-91).

    ``pool_size[p] is None`` (or ``pool_size is None``) means global average
    pooling. The projection is named ``projection`` as in the reference.
    """

    def __init__(self, dim_in, num_classes, pool_size, dropout_rate=0.0,
                 act_func="softmax", detach_final_fc=False, mlp_layers=1, mlp_dim=2048,
                 bn_mlp=False, dtype=torch.float32):
        super().__init__()
        _check_act(act_func)
        self.pool_size = pool_size
        self.dropout_rate = dropout_rate
        self.act_func = act_func
        self.detach_final_fc = detach_final_fc
        if mlp_layers > 1:
            self.projection = MLPHead(sum(dim_in), num_classes, mlp_dim, mlp_layers,
                                      bn_on=bn_mlp, dtype=dtype)
        else:
            self.projection = nn.Linear(sum(dim_in), num_classes)
        self.generator = None  # the model's, set by models.build.build_model

    def forward(self, xs):
        pooled = []
        for p, x in enumerate(xs):
            if self.pool_size is None or self.pool_size[p] is None:
                pooled.append(x.mean(dim=(1, 2, 3), keepdim=True))
            else:
                pooled.append(avg_pool3d(x, self.pool_size[p], (1, 1, 1)))
        return _project(self, torch.cat(pooled, dim=-1))


class X3DHead(nn.Module):
    """conv_5 -> BN -> ReLU -> avg-pool -> lin_5 -> (BN) -> ReLU -> dropout
    -> projection (slowfast_tpu/models/heads.py:94-146, reference
    head_helper.py:353-488). ``pool_size is None`` means global average
    pooling."""

    def __init__(self, dim_in, dim_inner, dim_out, num_classes, pool_size, norm,
                 dropout_rate=0.0, act_func="softmax", bn_lin5_on=False):
        super().__init__()
        _check_act(act_func)
        self.pool_size = pool_size
        self.dropout_rate = dropout_rate
        self.act_func = act_func
        self.conv_5 = Conv3D(dim_in, dim_inner, (1, 1, 1))
        self.conv_5_bn = norm(dim_inner)
        self.lin_5 = Conv3D(dim_inner, dim_out, (1, 1, 1))
        self.lin_5_bn = norm(dim_out) if bn_lin5_on else None
        self.projection = nn.Linear(dim_out, num_classes)
        self.generator = None  # the model's, set by models.build.build_model

    def forward(self, xs):
        if len(xs) != 1:
            raise ValueError("X3DHead is single-pathway")
        x = F.relu(self.conv_5_bn(self.conv_5(xs[0])))
        if self.pool_size is None:
            x = x.mean(dim=(1, 2, 3), keepdim=True)
        else:
            x = avg_pool3d(x, self.pool_size, (1, 1, 1))
        x = self.lin_5(x)
        if self.lin_5_bn is not None:
            x = self.lin_5_bn(x)
        return _project(self, F.relu(x))


class TransformerBasicHead(nn.Module):
    """Dropout (identity in eval) -> ``detach_final_fc`` (the gradient stops
    at the projection's input) -> linear in the compute dtype -> (eval)
    activation, on ``(B, C)`` features (slowfast_tpu/models/heads.py:262)."""

    def __init__(self, dim_in, num_classes, dropout_rate=0.0, act_func="softmax",
                 detach_final_fc=False, dtype=torch.float32):
        super().__init__()
        _check_act(act_func)
        self.dropout_rate = dropout_rate
        self.act_func = act_func
        self.detach_final_fc = detach_final_fc
        self.dtype = dtype
        self.projection = nn.Linear(dim_in, num_classes)
        self.generator = None  # the model's, set by models.build.build_model

    def forward(self, x):
        if self.training and self.dropout_rate > 0.0:
            x = dropout(x, self.dropout_rate, self.generator)
        if self.detach_final_fc:
            x = x.detach()
        x = linear(x, self.projection, self.dtype)
        return x if self.training else _activate(x, self.act_func)


class ResNetRoIHead(nn.Module):
    """Per pathway: the temporal mean, ROIAlign (``1 / scale_factor``,
    adaptive sampling, ``aligned``) and the spatial max over the bins; then
    concat -> dropout (training only) -> ``detach_final_fc`` -> the
    projection in the compute dtype (the trunk's) -> the activation, in
    training and eval (slowfast_tpu/models/heads.py:148).

    ``bboxes`` is ``(B, M, 4)`` padded ``[x1, y1, x2, y2]`` per clip (each
    row gets its clip's index; padded rows are zero boxes that the loss and
    the meter mask out), or the ragged ``(R, 5)`` ``[batch_index, x1, y1,
    x2, y2]``. Returns ``(B * M, num_classes)`` (resp. ``(R,
    num_classes)``)."""

    def __init__(self, dim_in, num_classes, resolution, scale_factor, dropout_rate=0.0,
                 act_func="softmax", aligned=True, detach_final_fc=False):
        super().__init__()
        _check_act(act_func)
        self.resolution = resolution
        self.scale_factor = scale_factor
        self.dropout_rate = dropout_rate
        self.act_func = act_func
        self.aligned = aligned
        self.detach_final_fc = detach_final_fc
        self.projection = nn.Linear(sum(dim_in), num_classes)
        self.generator = None  # the model's, set by models.build.build_model

    def forward(self, xs, bboxes):
        if bboxes.dim() == 3:
            B, M = bboxes.shape[:2]
            bidx = torch.arange(B, dtype=bboxes.dtype, device=bboxes.device)
            rois = torch.cat([bidx.view(B, 1, 1).expand(B, M, 1), bboxes], dim=-1)
            rois, per_batch = rois.reshape(B * M, 5), M
        else:
            rois, per_batch = bboxes, 0
        pooled = []
        for p, x in enumerate(xs):
            out = roi_align(x.mean(dim=1), rois, output_size=self.resolution[p][0],
                            spatial_scale=1.0 / self.scale_factor[p], sampling_ratio=0,
                            aligned=self.aligned, rois_per_batch=per_batch)
            # amax splits the gradient of a tie evenly, as jnp.max's VJP does.
            pooled.append(torch.amax(out, dim=(1, 2)))
        x = torch.cat(pooled, dim=-1)
        if self.training and self.dropout_rate > 0.0:
            x = dropout(x, self.dropout_rate, self.generator)
        if self.detach_final_fc:
            x = x.detach()
        return _activate(linear(x, self.projection, xs[0].dtype), self.act_func)
