"""Loss functions (counterpart of slowfast_tpu/solver/losses.py:20-56;
reference slowfast/models/losses.py).

Each takes ``(predictions, labels)`` and computes in fp32. For the
cross-entropies labels are integer class ids or soft distributions (mixup's
targets); for ``bce`` (on probabilities), ``bce_logit`` (on logits) and
``mse`` they are targets of the predictions' shape, such as multi-hot
vectors; ``contrastive_loss`` takes the SSL logits, positive first.
``multi_mse`` takes lists of predictions and targets (each target
optionally a ``(target, weight)`` pair) and returns the weighted sum and
the list of the MSEs; the masked-pretraining recipes name it, though their
train step scores with ``models.masked.masked_loss``, as the JAX package's
does.
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


def contrastive_loss(logits, labels=None, reduction="mean"):
    """Cross-entropy against index-0 targets, in fp32 or wider (slowfast_tpu/solver/losses.py:59,
    reference losses.py:14-22): the positive sits in column 0. ``labels``
    is ignored."""
    logp = F.log_softmax(logits.to(torch.promote_types(logits.dtype, torch.float32)), dim=-1)
    return _reduce(-logp[:, 0], reduction)


def soft_cross_entropy(logits, labels, reduction="mean"):
    """Soft-target cross-entropy without target normalization; integer labels
    (mixup off) are one-hot encoded first."""
    logits = logits.float()
    if labels.dim() < logits.dim():
        labels = F.one_hot(labels.long(), logits.shape[-1]).float()
    loss = -(labels * F.log_softmax(logits, dim=-1)).sum(dim=-1)
    return _reduce(loss, reduction)


def bce(probs, labels, reduction="mean"):
    """Binary cross-entropy of probabilities clipped to [1e-7, 1 - 1e-7]."""
    probs = probs.float().clamp(1e-7, 1 - 1e-7)
    loss = -(labels * torch.log(probs) + (1.0 - labels) * torch.log(1.0 - probs))
    return _reduce(loss, reduction)


def bce_logit(logits, labels, reduction="mean"):
    """Binary cross-entropy of logits, ``max(x, 0) - x·y + log1p(exp(-|x|))``."""
    logits = logits.float()
    loss = logits.clamp(min=0) - logits * labels + torch.log1p(torch.exp(-logits.abs()))
    return _reduce(loss, reduction)


def mse(preds, labels, reduction="mean"):
    return _reduce(torch.square(preds.float() - labels), reduction)


def multi_mse(preds, labels, reduction="mean"):
    """Weighted sum of MSEs over lists (slowfast_tpu/solver/losses.py:65,
    reference losses.py:25-57): ``(sum, [mse, ...])``."""
    loss_sum, multi = 0.0, []
    for xt, yt in zip(preds, labels):
        wt = 1.0
        if isinstance(yt, (tuple, list)) and len(yt) >= 2:
            yt, wt = yt[0], yt[1]
        loss = mse(xt, yt, reduction)
        loss_sum = loss_sum + loss * wt
        multi.append(loss)
    return loss_sum, multi


_LOSSES = {"cross_entropy": cross_entropy, "soft_cross_entropy": soft_cross_entropy,
           "bce": bce, "bce_logit": bce_logit, "mse": mse, "multi_mse": multi_mse,
           "contrastive_loss": contrastive_loss}
# Losses whose labels are targets of the predictions' shape: multi-label
# training (slowfast_tpu/engine/steps.py:69).
MULTI_LABEL_LOSSES = ("bce", "bce_logit")


def get_loss_func(loss_name):
    if loss_name not in _LOSSES:
        raise NotImplementedError(f"loss {loss_name!r} is not ported yet; "
                                  f"available: {sorted(_LOSSES)}")
    return _LOSSES[loss_name]
