"""HOG features, MaskFeat's targets (counterpart of
slowfast_tpu/ops/hog.py:17; reference slowfast/models/operators.py:62-112).

In the JAX package HOG is plain XLA, not a Pallas kernel; its counterpart
here is plain PyTorch, on the card as on the CPU. The separable Sobel is
shift arithmetic on the reflect-padded frame, not a convolution: at reflect
borders the two smoothed rows (columns) are bitwise equal, so the gradient
there is an exact +0.0, which keeps ``atan2``'s bin (0 or 8) in step with
the JAX package's. The orientation bin is ``floor(phase) mod nbins`` with a
floor modulo (``torch.remainder``), as JAX's integer ``%``. fp32 ``atan2``
rounds differently on the card and on the CPU, so a pixel within an ulp of
a bin edge may take the other bin there (a few hundred of 4.8M pixels of
normalized uint8 frames; ``chip_smoke.py masked_fp32``).
"""

import math

import torch


def _reflect_pad1(x):
    """``(B, H, W, C)`` padded by one row and column on each side, mode
    ``reflect`` (the edge pixel is not repeated)."""
    x = torch.cat([x[:, 1:2], x, x[:, -2:-1]], dim=1)
    return torch.cat([x[:, :, 1:2], x, x[:, :, -2:-1]], dim=2)


def orientation_bins(x, nbins=9):
    """Each pixel's gradient norm and orientation bin (int32), ``(B, H, W,
    C)`` each, for fp32 frames ``x`` ``(B, H, W, C)``."""
    xp = _reflect_pad1(x)
    sm_v = xp[:, :-2] + 2.0 * xp[:, 1:-1] + xp[:, 2:]  # (B, H, W+2, C)
    gx = sm_v[:, :, :-2] - sm_v[:, :, 2:]
    sm_h = xp[:, :, :-2] + 2.0 * xp[:, :, 1:-1] + xp[:, :, 2:]  # (B, H+2, W, C)
    gy = sm_h[:, :-2] - sm_h[:, 2:]
    norm = torch.sqrt(gx * gx + gy * gy + 1e-12)
    phase = torch.atan2(gx, gy) / math.pi * nbins  # in [-nbins, nbins]
    return norm, torch.remainder(torch.floor(phase).to(torch.int32), nbins)


def hog_features(x, nbins=9, cell_sz=8):
    """Per-cell HOG of ``x`` ``(B, H, W, 3)`` frames in fp32: ``(B, 3, nbins,
    H // cell_sz, W // cell_sz)``, L2-normalized over the bins."""
    B, H, W, C = x.shape
    norm, bin_idx = orientation_bins(x.float(), nbins)
    onehot = bin_idx[..., None] == torch.arange(nbins, dtype=torch.int32, device=x.device)
    hist = norm[..., None] * onehot  # (B, H, W, C, nbins)

    Hc, Wc = H // cell_sz, W // cell_sz
    hist = hist[:, :Hc * cell_sz, :Wc * cell_sz]
    hist = hist.reshape(B, Hc, cell_sz, Wc, cell_sz, C, nbins).sum(dim=(2, 4))
    hist = hist / torch.sqrt(torch.sum(hist * hist, dim=-1, keepdim=True) + 1e-12)
    return hist.permute(0, 3, 4, 1, 2)  # (B, C, nbins, Hc, Wc)
