"""Top-k accuracy metrics (counterpart of slowfast_tpu/utils/metrics.py)."""

import torch


def topks_correct(preds, labels, ks):
    """Number of top-k correct predictions for each k."""
    top_idx = torch.topk(preds, max(ks), dim=-1).indices
    correct = top_idx == labels.reshape(-1, 1)
    return [correct[:, :k].sum().to(torch.float32) for k in ks]


def topk_errors(preds, labels, ks):
    return [(1.0 - c / preds.shape[0]) * 100.0 for c in topks_correct(preds, labels, ks)]


def topk_accuracies(preds, labels, ks):
    return [c / preds.shape[0] * 100.0 for c in topks_correct(preds, labels, ks)]
