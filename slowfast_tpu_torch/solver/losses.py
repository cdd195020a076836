"""Loss functions (counterpart of slowfast_tpu/solver/losses.py:20-40;
reference slowfast/models/losses.py).

Both take ``(logits, labels)`` and compute in fp32. Labels are integer class
ids or soft distributions (mixup's targets).
"""

import torch
import torch.nn.functional as F


def _reduce(x, reduction):
    if reduction == "mean":
        return x.mean()
    if reduction == "sum":
        return x.sum()
    return x


def cross_entropy(logits, labels, reduction="mean"):
    """Softmax cross-entropy; integer labels or soft-target distributions."""
    logp = F.log_softmax(logits.float(), dim=-1)
    if labels.dim() == logits.dim():
        loss = -(labels * logp).sum(dim=-1)
    else:
        loss = -logp.gather(-1, labels.long()[..., None])[..., 0]
    return _reduce(loss, reduction)


def soft_cross_entropy(logits, labels, reduction="mean"):
    """Soft-target cross-entropy without target normalization; integer labels
    (mixup off) are one-hot encoded first."""
    logits = logits.float()
    if labels.dim() < logits.dim():
        labels = F.one_hot(labels.long(), logits.shape[-1]).float()
    loss = -(labels * F.log_softmax(logits, dim=-1)).sum(dim=-1)
    return _reduce(loss, reduction)


_LOSSES = {"cross_entropy": cross_entropy, "soft_cross_entropy": soft_cross_entropy}


def get_loss_func(loss_name):
    if loss_name not in _LOSSES:
        raise NotImplementedError(f"loss {loss_name!r} is not ported yet; "
                                  f"available: {sorted(_LOSSES)}")
    return _LOSSES[loss_name]
