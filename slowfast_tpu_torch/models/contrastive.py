"""Self-supervised contrastive models (counterpart of
slowfast_tpu/models/contrastive.py; reference slowfast/models/contrastive.py).

``ContrastiveModel`` holds what trains: the backbone (whose head is the
projection, an ``MLPHead`` under ``CONTRASTIVE.NUM_MLP_LAYERS`` > 1), the
BYOL predictors (``predictors.{i}``) and SwAV's prototypes
(``swav_prototypes``); its ``state_dict`` keeps those names. What carries
from step to step besides (the momentum encoder with its own BN
statistics, MoCo's key queue and pointer, SwAV's queue, the instance and
kNN memory banks, the step count) is an ``SSLState``, updated in place by
the train step of ``engine/ssl_steps.py``.

Random draws come from the ``torch.Generator`` the caller passes; the JAX
package draws the same distributions from ``jax.random``, so the bits
differ and the tests carry the JAX draws over.
"""

import math

import numpy as np
import torch
from torch import nn

from .common import linear
from .heads import MLPHead


def l2_normalize(x, dim=-1, eps=1e-12):
    """``x * rsqrt(sum(x²) + eps)`` along ``dim``, in ``x``'s dtype (:29)."""
    return x * torch.rsqrt(x.square().sum(dim=dim, keepdim=True) + eps)


def backbone_cls(arch):
    """The backbone class of ``MODEL.ARCH`` (:33)."""
    from .mvit import MViT
    from .video_models import X3D, ResNet, SlowFast

    table = {"slowfast": SlowFast, "slow": ResNet, "c2d": ResNet, "i3d": ResNet,
             "slow_c2d": ResNet, "slow_i3d": ResNet, "2d": ResNet, "x3d": X3D, "mvit": MViT}
    if arch not in table:
        raise NotImplementedError(f"no contrastive backbone for MODEL.ARCH {arch!r}")
    return table[arch]


class ContrastiveModel(nn.Module):
    """Backbone -> l2-normalized embedding, with the BYOL predictor stack
    and SwAV's linear prototypes (:53). ``forward(xs, use_predictor)``
    returns the embedding, or, with ``use_predictor`` and predictors, each
    predictor's l2-normalized output in turn. Train or eval mode is the
    module's."""

    def __init__(self, cfg):
        super().__init__()
        c = cfg.CONTRASTIVE
        self.backbone = backbone_cls(cfg.MODEL.ARCH)(cfg)
        dims = [cfg.MODEL.NUM_CLASSES] + [c.DIM] * len(c.PREDICTOR_DEPTHS)
        self.predictors = nn.ModuleList(
            MLPHead(dims[i], c.DIM, c.MLP_DIM, n, bn_on=c.BN_MLP or c.BN_SYNC_MLP)
            for i, n in enumerate(c.PREDICTOR_DEPTHS))
        if c.TYPE == "swav":
            self.swav_prototypes = nn.Linear(cfg.MODEL.NUM_CLASSES, 1000, bias=False)

    def encode(self, xs):
        return l2_normalize(self.backbone(xs))

    def predict(self, x):
        for p in self.predictors:
            x = l2_normalize(p(x))
        return x

    def prototypes(self, feats):
        """The prototype scores, in fp32 or wider (a flax ``Dense`` with no dtype)."""
        w = self.swav_prototypes
        return linear(feats, w, torch.promote_types(feats.dtype, w.weight.dtype))

    def forward(self, xs, use_predictor=False):
        q = self.encode(xs)
        if use_predictor and len(self.predictors):
            q = self.predict(q)
        return q


def sinkhorn(scores, eps=0.05, n_iters=3):
    """Sinkhorn-Knopp codes of ``(B, K)`` scores (:112, reference :825-863)."""
    Q = torch.exp(scores / eps).t()
    Q = Q / Q.sum()
    K, B = Q.shape
    for _ in range(n_iters):
        Q = Q / Q.sum(dim=1, keepdim=True) / K
        Q = Q / Q.sum(dim=0, keepdim=True) / B
    return (Q * B).t()


class SSLState:
    """What the SSL train step carries between steps (:123): ``hist``, the
    momentum encoder (a backbone whose BN statistics are its own EMA);
    ``queue_x`` and ``ptr``; ``queue_swav`` ``(2, SWAV_QEUE_LEN, DIM)`` and
    ``swav_filled``; ``memory`` (the instance bank, ``(LENGTH, DIM)`` or
    ``(LENGTH, DURATION, DIM)``) and ``knn_memory`` (the 2-D bank's separate
    kNN bank); ``iter``, the steps taken. Absent parts are None. Counts are
    Python ints, tensors live on the model's device."""

    TENSORS = ("queue_x", "queue_swav", "memory", "knn_memory")
    COUNTS = ("ptr", "swav_filled", "iter")

    def __init__(self):
        self.hist = None
        for name in self.TENSORS:
            setattr(self, name, None)
        for name in self.COUNTS:
            setattr(self, name, 0)

    def state_dict(self):
        """Plain tensors and ints on the CPU, for the checkpoint."""
        out = {n: getattr(self, n) for n in self.COUNTS}
        for n in self.TENSORS:
            t = getattr(self, n)
            if t is not None:
                out[n] = t.detach().cpu().clone()
        if self.hist is not None:
            out["hist"] = {k: v.detach().cpu().clone() for k, v in self.hist.state_dict().items()}
        return out

    def load_state_dict(self, state):
        """Restore from ``state_dict()``'s output; every part this state has
        must be there, with its shape (a bank sized for another dataset is
        refused, not misindexed)."""
        for n in self.COUNTS:
            setattr(self, n, int(state[n]))
        for n in self.TENSORS:
            t = getattr(self, n)
            if t is None:
                continue
            if n not in state or tuple(state[n].shape) != tuple(t.shape):
                raise ValueError(f"SSL state {n}: checkpoint has "
                                 f"{tuple(state[n].shape) if n in state else None}, "
                                 f"this run {tuple(t.shape)}")
            t.copy_(state[n])
        if self.hist is not None:
            self.hist.load_state_dict(state["hist"], strict=True)


def _uniform_bank(shape, stdv, generator):
    return (torch.rand(shape, generator=generator) * 2.0 - 1.0) * stdv


def init_ssl_state(cfg, model, generator):
    """A fresh ``SSLState`` for ``model`` (:123): the momentum encoder a copy
    of the backbone (MoCo, BYOL), the queue and banks uniform in ``±1 /
    sqrt(DIM / 3)`` drawn from ``generator`` (a CPU ``torch.Generator``),
    SwAV's queue zero."""
    c = cfg.CONTRASTIVE
    device = next(model.parameters()).device
    state = SSLState()
    stdv = 1.0 / math.sqrt(c.DIM / 3.0)
    if c.TYPE in ("moco", "byol"):
        hist = type(model.backbone)(cfg)
        hist.load_state_dict(model.backbone.state_dict())
        hist.requires_grad_(False)
        state.hist = hist.to(device=device, memory_format=torch.channels_last_3d)
        for m, src in zip(state.hist.modules(), model.backbone.modules()):
            if hasattr(src, "generator"):
                m.generator = src.generator
        state.queue_x = _uniform_bank((c.QUEUE_LEN, c.DIM), stdv, generator).to(device)
    if c.TYPE == "swav" and c.SWAV_QEUE_LEN > 0:
        state.queue_swav = torch.zeros((2, c.SWAV_QEUE_LEN, c.DIM), device=device)
    if c.TYPE == "mem" or c.KNN_ON:
        shape = (c.LENGTH, c.DIM)
        if c.TYPE == "mem" and c.MEM_TYPE == "2d":
            shape = (c.LENGTH, max(c.DURATION, 1), c.DIM)
        state.memory = _uniform_bank(shape, stdv, generator).to(device)
        if c.KNN_ON and len(shape) == 3:
            state.knn_memory = _uniform_bank((c.LENGTH, c.DIM), stdv, generator).to(device)
    return state


def ema_tensors(module):
    """A module's parameters and BN running statistics, the tensors the
    momentum encoder averages (reference _update_history EMAs every
    buffer; the JAX package's batch statistics are the running mean and
    variance)."""
    out = list(module.parameters())
    out += [b for n, b in module.named_buffers() if n.endswith(("running_mean", "running_var"))]
    return out


def momentum_update(hist, new, mmt):
    """``h = h * mmt + p * (1 - mmt)`` in place over two lists of tensors
    (:184), the weights taken in fp32 as the JAX package takes them."""
    mmt = np.float32(mmt)
    with torch.no_grad():
        torch._foreach_mul_(hist, float(mmt))
        torch._foreach_add_(hist, [p.to(h.dtype) for h, p in zip(hist, new)],
                            alpha=float(np.float32(1.0) - mmt))


def dequeue_and_enqueue(queue, ptr, keys):
    """Write ``keys`` into the ring buffer ``queue`` at ``ptr`` (wrapping);
    returns the new pointer (:191)."""
    num, length = keys.shape[0], queue.shape[0]
    idx = (ptr + torch.arange(num, device=queue.device)) % length
    queue[idx] = keys.detach().to(queue.dtype)
    return (ptr + num) % length


def memory_update(memory, indices, feats, momentum, time=None, interp=False):
    """The bank rows of ``indices`` moved toward ``feats`` in place (:200):
    ``l2_normalize(old * momentum + feats * (1 - momentum))``, ``momentum``
    the keep-old weight. A 2-D bank ``(L, T, C)`` writes the time slot
    ``floor(time)`` (clamped), or under ``interp`` both neighbours with the
    reference's weights (``w_t1 = 1 - (time - t0)``)."""
    feats = feats.detach().to(memory.dtype)
    m = float(momentum)
    if memory.dim() == 2:
        memory[indices] = l2_normalize(memory[indices] * m + feats * (1 - m))
        return memory
    duration = memory.shape[1]
    if time is None:
        time = torch.zeros(indices.shape, device=memory.device)
    t0 = torch.clamp(torch.floor(time).long(), 0, duration - 1)
    if not interp:
        memory[indices, t0] = l2_normalize(memory[indices, t0] * m + feats * (1 - m))
        return memory
    t1 = torch.clamp(t0 + 1, 0, duration - 1)
    w_t1 = (1.0 - (time - t0.to(time.dtype)))[:, None]
    w_t0 = 1.0 - w_t1
    new0 = l2_normalize(feats * w_t0 * (1 - m) + memory[indices, t0] * m)
    new1 = l2_normalize(feats * w_t1 * (1 - m) + memory[indices, t1] * m)
    memory[indices, t0] = new0
    memory[indices, t1] = new1
    return memory


def nce_sample_indices(generator, batch_index, length, k, duration=1, interp=False):
    """The ``(B, K+1)`` sampled-NCE grid (:234): column 0 each clip's own row,
    the rest uniform rows of the bank; time slots uniform in ``[0, duration
    - 1)`` (real under ``interp``) when the bank has them, else 0. Draws
    from ``generator`` on ``batch_index``'s device."""
    b, dev = batch_index.shape[0], batch_index.device
    clip_ind = torch.randint(0, length, (b, k + 1), generator=generator, device=dev)
    clip_ind[:, 0] = batch_index
    if duration > 1 and interp:
        time_ind = torch.rand((b, k + 1), generator=generator, device=dev) * float(duration - 1)
    elif duration > 1:
        time_ind = torch.randint(0, duration - 1, (b, k + 1), generator=generator, device=dev)
    else:
        time_ind = torch.zeros((b, k + 1), dtype=torch.long, device=dev)
    return clip_ind, time_ind


def nce_logits(q, memory, clip_ind, time_ind, temperature, interp=False):
    """Sampled-NCE logits (:260): one matmul of ``q`` against the flattened
    bank, then the ``(B, K+1)`` sampled entries, over ``temperature``."""
    if memory.dim() == 2:
        flat, flat_idx = memory, clip_ind
    else:
        duration = memory.shape[1]
        flat = memory.reshape(-1, memory.shape[-1])
        if interp:
            t0 = torch.clamp(torch.floor(time_ind).long(), 0, duration - 1)
            t1 = torch.clamp(t0 + 1, 0, duration - 1)
            all_sim = q @ flat.t().to(q.dtype)
            s0 = torch.gather(all_sim, 1, clip_ind * duration + t0)
            s1 = torch.gather(all_sim, 1, clip_ind * duration + t1)
            w_t1 = 1.0 - (time_ind - t0.to(time_ind.dtype))
            return (s0 * (1.0 - w_t1) + s1 * w_t1) / temperature
        flat_idx = clip_ind * duration + time_ind.long()
    all_sim = q @ flat.t().to(q.dtype)
    return torch.gather(all_sim, 1, flat_idx) / temperature
