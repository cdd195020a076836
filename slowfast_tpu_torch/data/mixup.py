"""MixUp / CutMix on the device (counterpart of slowfast_tpu/data/mixup.py:17-96;
reference slowfast/datasets/mixup.py, timm-derived).

The random draws and the mixing are split: ``mix_draws`` takes the batch's
choices (mix or not, cutmix or mixup, the two Beta draws and the box
centre) from a CPU ``torch.Generator``, as Python numbers, so the step needs
no host read-back; ``mix_with`` is the mixing given those draws. The
box arithmetic is float32, as the JAX package's traced version is, so the
same draws give the same box and the same λ. The batch is mixed with its
flip (sample i with sample B-1-i); labels become one-hot with label
smoothing. Under a process group the flip is the global batch's: each
rank mixes with the flipped rows of its mirror rank (``mirror_rows``).
"""

import math

import numpy as np
import torch
import torch.nn.functional as F

from slowfast_tpu_torch.utils import distributed as du


def convert_to_one_hot(targets, num_classes, label_smoothing=0.0):
    """(reference mixup.py:22-37)"""
    off_value = label_smoothing / num_classes
    on_value = 1.0 - label_smoothing + off_value
    oh = F.one_hot(targets.long(), num_classes).float()
    return oh * on_value + (1.0 - oh) * off_value


def _gamma(generator, alpha):
    """One Gamma(alpha, 1) draw (Marsaglia and Tsang; alpha < 1 boosted by
    U^(1/alpha))."""
    boost = 1.0
    if alpha < 1.0:
        boost = float(torch.rand((), generator=generator)) ** (1.0 / alpha)
        alpha += 1.0
    d = alpha - 1.0 / 3.0
    c = 1.0 / math.sqrt(9.0 * d)
    while True:
        x = float(torch.randn((), generator=generator))
        v = (1.0 + c * x) ** 3
        if v <= 0.0:
            continue
        u = float(torch.rand((), generator=generator))
        if math.log(u) < 0.5 * x * x + d - d * v + d * math.log(v):
            return d * v * boost


def _beta(generator, alpha):
    x, y = _gamma(generator, alpha), _gamma(generator, alpha)
    return x / (x + y)


def mix_draws(generator, height, width, mixup_alpha=0.8, cutmix_alpha=1.0,
              mix_prob=1.0, switch_prob=0.5):
    """The batch's random choices (``mixup.py:56-68``), drawn on the host."""
    use_mix = float(torch.rand((), generator=generator)) < mix_prob
    use_cutmix = cutmix_alpha > 0.0 and float(torch.rand((), generator=generator)) < switch_prob
    if mixup_alpha <= 0.0 and cutmix_alpha > 0.0:
        use_cutmix = True
    lam_mix = _beta(generator, mixup_alpha) if mixup_alpha > 0.0 else 0.0
    lam_cut = _beta(generator, cutmix_alpha) if cutmix_alpha > 0.0 else 0.0
    cy = int(torch.randint(0, height, (), generator=generator))
    cx = int(torch.randint(0, width, (), generator=generator))
    return dict(use_mix=use_mix, use_cutmix=use_cutmix, lam_mix=lam_mix,
                lam_cut=lam_cut, cy=cy, cx=cx)


def _rand_bbox(height, width, lam, cy, cx):
    """Cutmix box for mixing ratio ``lam`` around (cy, cx), in float32 with
    int32 truncation (timm rand_bbox)."""
    ratio = np.sqrt(np.float32(1.0) - np.float32(lam))
    cut_h = int(np.float32(height) * ratio)
    cut_w = int(np.float32(width) * ratio)
    y1 = min(max(cy - cut_h // 2, 0), height)
    y2 = min(max(cy + cut_h // 2, 0), height)
    x1 = min(max(cx - cut_w // 2, 0), width)
    x2 = min(max(cx + cut_w // 2, 0), width)
    return y1, y2, x1, x2


def mirror_rows(inputs, labels):
    """The rows that pair with this rank's: the flipped inputs and labels
    of rank ``W - 1 - rank`` (one process: the batch's own flip)."""
    got = du.exchange_with(list(inputs) + [labels], du.get_world_size() - 1 - du.get_rank())
    return [x.flip(0) for x in got[:-1]], got[-1].flip(0)


def mix_with(inputs, labels, num_classes, use_mix, use_cutmix, lam_mix, lam_cut,
             cy, cx, label_smoothing=0.1):
    """Mix NTHWC pathway tensors and integer labels with given draws.

    Returns ``(mixed_inputs, soft_labels)``: the inputs in their own dtype
    (the blend is computed in fp32 and rounded once, which is what the JAX
    step's fp32 blend becomes at the model's first cast), the labels fp32.
    Row i of the global batch mixes with row G-1-i (``mirror_rows``).
    """
    flipped_inputs, flipped_labels = mirror_rows(inputs, labels)
    H, W = inputs[-1].shape[2], inputs[-1].shape[3]
    y1, y2, x1, x2 = _rand_bbox(H, W, lam_cut, cy, cx)
    lam_cut_adj = np.float32(1.0) - np.float32((y2 - y1) * (x2 - x1)) / np.float32(H * W)
    lam = float(lam_cut_adj if use_cutmix else np.float32(lam_mix)) if use_mix else 1.0

    def mix_one(x, flipped):
        if not use_mix:
            return x
        if use_cutmix:
            h, w = x.shape[2], x.shape[3]
            sy, sx = np.float32(h / H), np.float32(w / W)
            ys = slice(int(np.float32(y1) * sy), int(np.float32(y2) * sy))
            xs = slice(int(np.float32(x1) * sx), int(np.float32(x2) * sx))
            out = x.clone()
            out[:, :, ys, xs] = flipped[:, :, ys, xs]
            return out
        return (x.float() * lam + flipped.float() * (1.0 - lam)).to(x.dtype)

    y1h = convert_to_one_hot(labels, num_classes, label_smoothing)
    soft = y1h * lam + convert_to_one_hot(flipped_labels, num_classes, label_smoothing) * (
        1.0 - lam)
    return [mix_one(x, f) for x, f in zip(inputs, flipped_inputs)], soft


def mixup_batch(generator, inputs, labels, num_classes, mixup_alpha=0.8,
                cutmix_alpha=1.0, mix_prob=1.0, switch_prob=0.5, label_smoothing=0.1):
    """Draw from ``generator``, then mix (``mix_with``)."""
    draws = mix_draws(generator, inputs[-1].shape[2], inputs[-1].shape[3],
                      mixup_alpha, cutmix_alpha, mix_prob, switch_prob)
    return mix_with(inputs, labels, num_classes, label_smoothing=label_smoothing, **draws)
