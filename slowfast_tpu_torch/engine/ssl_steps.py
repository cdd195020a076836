"""The SSL train step and the kNN probe (counterpart of
slowfast_tpu/engine/ssl_steps.py; reference contrastive.py:358-757 and the
train_net.py contrastive hooks).

One step takes a two-view batch ``{"inputs", "inputs2", "index", "time"}``
(float pathway lists on the device, the clips' ids and temporal positions)
and updates the model, the optimizer and the ``SSLState`` in place, for
``CONTRASTIVE.TYPE`` moco, byol, simclr, swav or mem (:80-462):

* the key encoder (MoCo, BYOL) is the momentum encoder in eval mode on its
  own EMA BN statistics, except for MoCo under ``sub_batchnorm`` with
  ``NUM_SPLITS`` > 1: shuffle-BN, the keys taken in train mode on the batch
  permuted by ``shuffle_permutation`` (statistics discarded) and put back
  in order (:122-153);
* the loss in fp32: MoCo's InfoNCE against the queue, BYOL's symmetric
  similarity through the predictors (the second forward starting from the
  first's BN statistics), SimCLR's NT-Xent with the diagonal at -1e9 (the
  similarities in fp32), SwAV's swapped prediction on sinkhorn codes in
  fp32 (optionally with the queue once it is full), InstDisc's sampled NCE
  against the memory bank (``nce_sample_indices``);
* SwAV's prototypes get no gradient while the fractional epoch is at most
  1, and every prototype has unit length after the update (:304-345);
  MoCo's parameters and optimizer state stay as they are while ``step <
  QUEUE_LEN // TRAIN.BATCH_SIZE`` in epoch 0 (:320-334);
* then the momentum encoder's EMA (weights, then BN statistics, at the
  momentum of ``momentum_at``), MoCo's enqueue (under
  ``MOCO_MULTI_VIEW_QUEUE`` also the first view's keys from the encoder
  after this step's weight EMA and before its statistics', :349-373),
  SwAV's queue shift and the memory and kNN bank writes with keep-old weight
  ``1 - mmt`` (:374-413).

The LR and the momentum are functions of the fractional epoch ``iter /
steps_per_epoch``. Random draws come from one ``torch.Generator`` on the
model's device, seeded from ``(RNG_SEED, iter)`` at each step unless the
caller passes its own.

Under a process group of W ranks each rank holds its rows of the global
batch, and the step computes what the one-process step computes on the
whole of it, as the JAX package's step on the mesh does
(slowfast_tpu/engine/ssl_steps.py:1-14); the global row order is rank
order (``utils/distributed.global_rows``). Each rank's loss is the mean
over its rows and the gradients are averaged over the ranks before the
optimizer, so the update is the global loss's. MoCo's keys are gathered
for the queue; its shuffle-BN gathers the key views, permutes the global
batch with one draw (the same on every rank), encodes the rank's rows of
the permuted batch under the global-batch split rule of ``BatchNorm3D``,
gathers the keys and undoes the permutation. SimCLR gathers both views'
embeddings with a gradient (``all_gather_with_grad``) and takes the loss of
the rank's rows of the ``2·B`` against every row. SwAV's Sinkhorn codes
are computed on every rank from the gathered scores, and its queue takes
global rows (the reference's queue holds each GPU's rows). InstDisc draws
its NCE samples for the global batch and each rank takes its rows. The
queue, the banks and the momentum encoder stay replicated: every rank
writes the same global rows at the same global indices.
"""

import numpy as np
import torch
import torch.nn.functional as F

from slowfast_tpu_torch.models import contrastive
from slowfast_tpu_torch.models.contrastive import (dequeue_and_enqueue, ema_tensors, l2_normalize,
                                                   memory_update, momentum_update, sinkhorn)
from slowfast_tpu_torch.parallel.prefetch import to_device
from slowfast_tpu_torch.solver.losses import contrastive_loss
from slowfast_tpu_torch.solver.lr_policy import make_epoch_lr_fn
from slowfast_tpu_torch.solver.optimizer import get_grad_norm
from slowfast_tpu_torch.utils import distributed as du

SSL_TYPES = ("moco", "byol", "simclr", "swav", "mem")


def _fp32(x):
    """``x`` in fp32, or wider when it is."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def momentum_at(cfg, step, steps_per_epoch):
    """The EMA momentum at ``step`` (:66): ``CONTRASTIVE.MOMENTUM``, or under
    ``MOMENTUM_ANNEALING`` its cosine anneal to 1 over ``SOLVER.MAX_EPOCH``,
    in fp32 as the JAX package computes it."""
    base = np.float32(cfg.CONTRASTIVE.MOMENTUM)
    if not cfg.CONTRASTIVE.MOMENTUM_ANNEALING:
        return base
    f32 = np.float32
    epoch_exact = f32(step) / f32(steps_per_epoch)
    cos = f32(np.cos(f32(np.pi) * epoch_exact / f32(cfg.SOLVER.MAX_EPOCH)))
    return f32(1.0) - (f32(1.0) - base) * (cos + f32(1.0)) * f32(0.5)


def shuffle_permutation(n, generator):
    """Shuffle-BN's permutation of the key batch."""
    return torch.randperm(n, generator=generator, device=generator.device)


class SSLTrainStep:
    """``step(batch) -> {"loss", "grad_norm", "lr"}`` (device tensors and the
    LR), one SSL iteration on ``model``, ``optimizer`` and ``ssl`` (an
    ``SSLState``) in place. With ``keep_grads`` the step leaves each
    parameter's gradient, before the optimizer touches it, in
    ``last_grads``."""

    def __init__(self, cfg, model, optimizer, ssl, steps_per_epoch, generator=None):
        c = cfg.CONTRASTIVE
        if c.TYPE not in SSL_TYPES:
            raise NotImplementedError(f"CONTRASTIVE.TYPE {c.TYPE}")
        self.cfg, self.model, self.optimizer, self.ssl = cfg, model, optimizer, ssl
        self.type = c.TYPE
        self.steps_per_epoch = steps_per_epoch
        self.lr_fn = make_epoch_lr_fn(cfg)
        device = next(model.parameters()).device
        self.reseed = generator is None
        self.generator = generator or torch.Generator(device=device)
        self.shuffle_bn = (c.TYPE == "moco" and cfg.BN.NORM_TYPE == "sub_batchnorm"
                           and cfg.BN.NUM_SPLITS > 1)
        self.keep_grads = False
        self.last_grads = None

    # --- the key encoder -------------------------------------------------

    def encode_keys(self, xs):
        """The momentum encoder's l2-normalized keys of the global batch
        whose rows of this rank are ``xs``."""
        hist = self.ssl.hist
        with torch.no_grad():
            if not self.shuffle_bn:
                hist.eval()
                return du.global_rows(l2_normalize(hist(xs)))
            xs = [du.global_rows(x) for x in xs]
            perm = shuffle_permutation(xs[0].shape[0], self.generator)
            kept = [b.clone() for b in hist.buffers()]
            hist.train()
            out = l2_normalize(hist([du.own_rows(x[perm]) for x in xs]))
            for b, k in zip(hist.buffers(), kept):
                b.copy_(k)
            return du.global_rows(out)[torch.argsort(perm)]

    def encode_frozen(self, xs):
        hist = self.ssl.hist
        hist.eval()
        with torch.no_grad():
            return l2_normalize(hist(xs))

    # --- the losses ------------------------------------------------------

    def _swav_codes(self, s, view):
        """This rank's rows of the Sinkhorn codes of the global batch's
        scores (with the queue's in front once it is full)."""
        ssl, length = self.ssl, self.cfg.CONTRASTIVE.SWAV_QEUE_LEN
        s = _fp32(du.global_rows(s))
        if length <= 0 or ssl.swav_filled < length:
            return du.own_rows(sinkhorn(s))
        sq = _fp32(self.model.prototypes(ssl.queue_swav[view].to(s.dtype)))
        return du.own_rows(sinkhorn(torch.cat([sq, s], dim=0))[-s.shape[0]:])

    def loss(self, batch):
        """The type's loss on this rank's rows of ``batch`` in train mode;
        returns ``(loss, q, q2, keys)``: this rank's embeddings, which the
        banks take, the second view's for SwAV, and MoCo's keys of the
        global batch."""
        cfg, model, ssl = self.cfg, self.model, self.ssl
        T = cfg.CONTRASTIVE.T
        x1, x2 = batch["inputs"], batch["inputs2"]
        q2 = keys = None
        model.train()
        if self.type == "moco":
            keys = self.encode_keys(x2)
            q = l2_normalize(model(x1))
            pos = (q * du.own_rows(keys)).sum(dim=-1, keepdim=True)
            neg = q @ ssl.queue_x.t().to(q.dtype)
            loss = contrastive_loss(torch.cat([pos, neg], dim=1) / T)
        elif self.type == "byol":
            k1, k2 = self.encode_frozen(x2), self.encode_frozen(x1)
            q = model(x1, use_predictor=True)
            q_2 = model(x2, use_predictor=True)
            loss = (2.0 - 2.0 * (q * k1).sum(-1).mean()
                    + 2.0 - 2.0 * (q_2 * k2).sum(-1).mean()) * 0.5
        elif self.type == "simclr":
            q, q_2 = model(x1), model(x2)
            z = _fp32(torch.cat([du.all_gather_with_grad(q), du.all_gather_with_grad(q_2)]))
            B = z.shape[0] // 2
            sim = (z @ z.t()) / T
            eye = torch.eye(2 * B, dtype=torch.bool, device=z.device)
            sim = torch.where(eye, torch.full_like(sim, -1e9), sim)
            pos_idx = torch.cat([torch.arange(B) + B, torch.arange(B)]).to(z.device)
            logp = F.log_softmax(sim, dim=1)
            own = du.own_rows(torch.arange(B, device=z.device))
            rows = torch.cat([own, own + B])  # this rank's rows of both views
            loss = -logp[rows, pos_idx[rows]].mean()
        elif self.type == "swav":
            q, q2 = model(x1), model(x2)
            s1, s2 = model.prototypes(q), model.prototypes(q2)
            with torch.no_grad():
                code1, code2 = self._swav_codes(s1, 0), self._swav_codes(s2, 1)
            p1 = F.log_softmax(_fp32(s1) / 0.1, dim=1)
            p2 = F.log_softmax(_fp32(s2) / 0.1, dim=1)
            loss = -0.5 * ((code2 * p1).sum(1).mean() + (code1 * p2).sum(1).mean())
        else:  # mem
            c = cfg.CONTRASTIVE
            duration = max(c.DURATION, 1) if c.MEM_TYPE == "2d" else 1
            q = model(x1)
            clip_ind, time_ind = contrastive.nce_sample_indices(
                self.generator, du.global_rows(batch["index"]), c.LENGTH,
                min(c.QUEUE_LEN, c.LENGTH), duration=duration, interp=c.INTERP_MEMORY)
            logits = contrastive.nce_logits(q, ssl.memory, du.own_rows(clip_ind),
                                            du.own_rows(time_ind), T,
                                            interp=c.INTERP_MEMORY)
            loss = contrastive_loss(logits)
        return loss, q.detach(), None if q2 is None else q2.detach(), keys

    # --- one step --------------------------------------------------------

    def __call__(self, batch):
        cfg, model, ssl = self.cfg, self.model, self.ssl
        c = cfg.CONTRASTIVE
        step = ssl.iter
        epoch_exact = float(np.float32(step) / np.float32(self.steps_per_epoch))
        mmt = momentum_at(cfg, step, self.steps_per_epoch)
        if self.reseed:  # each step's draws follow from (RNG_SEED, step), so a resume repeats them
            self.generator.manual_seed(
                int(np.random.SeedSequence([cfg.RNG_SEED, step]).generate_state(1)[0]))
        for p in model.parameters():
            p.grad = None
        loss, q, q2, keys = self.loss(batch)
        loss.backward()
        du.all_reduce_grads([p for p in model.parameters() if p.requires_grad])
        swav = self.type == "swav"
        if swav and epoch_exact <= 1.0 and model.swav_prototypes.weight.grad is not None:
            model.swav_prototypes.weight.grad.mul_(0.0)
        if self.keep_grads:
            self.last_grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()
                               if p.grad is not None}
        lr = self.lr_fn(epoch_exact)
        frozen = (self.type == "moco" and cfg.TRAIN.BATCH_SIZE > 0
                  and step < c.QUEUE_LEN // cfg.TRAIN.BATCH_SIZE and epoch_exact < 1.0)
        if frozen:
            grad_norm = get_grad_norm([p.grad for p in model.parameters() if p.grad is not None])
        else:
            grad_norm = self.optimizer.step(lr)
        with torch.no_grad():
            if swav:
                w = model.swav_prototypes.weight
                w.div_(torch.clamp(torch.linalg.vector_norm(w, dim=1, keepdim=True), min=1e-12))
            self._update_state(batch, q, q2, keys, mmt)
        ssl.iter += 1
        return {"loss": loss.detach(), "grad_norm": grad_norm, "lr": lr}

    def _update_state(self, batch, q, q2, keys, mmt):
        """The momentum encoder's EMA and the writes of the global batch's
        rows (``q``, ``q2``: this rank's embeddings; ``keys``: MoCo's global
        keys) into the queues and banks, the same on every rank."""
        cfg, model, ssl = self.cfg, self.model, self.ssl
        c = cfg.CONTRASTIVE
        keep_old = float(np.float32(1.0) - mmt)
        q = du.global_rows(q)
        index = batch.get("index")
        if index is not None:
            index = du.global_rows(index)
        if self.type in ("moco", "byol"):
            n_params = len(list(ssl.hist.parameters()))
            hist, new = ema_tensors(ssl.hist), ema_tensors(model.backbone)
            momentum_update(hist[:n_params], new[:n_params], mmt)
        if self.type == "moco":
            enq = keys
            if c.MOCO_MULTI_VIEW_QUEUE:
                # Keys of the first view from the encoder's new weights and
                # its statistics before this step's EMA (:349 before :363).
                enq = torch.cat([keys, self.encode_keys(batch["inputs"])], dim=0)
            ssl.ptr = dequeue_and_enqueue(ssl.queue_x, ssl.ptr, enq)
        if self.type in ("moco", "byol"):
            momentum_update(hist[n_params:], new[n_params:], mmt)
        if self.type == "swav" and ssl.queue_swav is not None:
            B, L = q.shape[0], ssl.queue_swav.shape[1]
            rows = torch.stack([q, du.global_rows(q2)]).to(ssl.queue_swav.dtype)
            ssl.queue_swav.copy_(torch.cat([rows, ssl.queue_swav[:, :L - B]], dim=1))
            ssl.swav_filled = min(ssl.swav_filled + B, L)
        if index is None:
            return
        if self.type == "mem":
            time = batch.get("time")
            if time is not None and ssl.memory.dim() == 3:
                time = du.global_rows(time).to(ssl.memory.dtype) * (ssl.memory.shape[1] - 1)
            memory_update(ssl.memory, index, q, keep_old, time=time, interp=c.INTERP_MEMORY)
        elif ssl.memory is not None:
            memory_update(ssl.memory, index, q, keep_old)
        if ssl.knn_memory is not None:
            memory_update(ssl.knn_memory, index, q, keep_old)


def make_ssl_train_step(cfg, model, optimizer, ssl, steps_per_epoch, generator=None):
    return SSLTrainStep(cfg, model, optimizer, ssl, steps_per_epoch, generator)


def knn_eval(cfg, model, ssl, train_labels, val_loader, k=200, sigma=0.07):
    """Top-1 accuracy (percent) of the weighted kNN vote against the kNN bank
    (:465; InstDisc's protocol): each val clip's embedding (eval mode), its
    cosine similarity to every bank row, the top ``min(k, LENGTH)`` rows
    voting for their video's label with weight ``exp(sim / sigma)``. The
    2-D bank's runs read ``knn_memory``; None without a bank. On a sharded
    val loader each rank votes for its real rows (``meta["num_real"]``) and
    the counts are summed over the ranks."""
    k = min(k, cfg.CONTRASTIVE.LENGTH)
    memory = ssl.knn_memory if ssl.knn_memory is not None else ssl.memory
    if memory is None:
        return None
    if memory.dim() == 3:
        memory = memory[:, 0]
    c = cfg.CONTRASTIVE
    num_classes = cfg.MODEL.NUM_CLASSES if c.NUM_CLASSES_DOWNSTREAM == 0 else c.NUM_CLASSES_DOWNSTREAM
    labels_dev = torch.as_tensor(np.asarray(train_labels, np.int64), device=memory.device)
    model.eval()
    correct = total = 0
    with torch.inference_mode():
        for inputs, labels, _, _, meta in val_loader:
            n_real = meta.get("num_real", len(labels))
            q = model.encode(inputs)
            sim = q @ memory.t().to(q.dtype)
            top_sim, top_idx = torch.topk(sim, k, dim=1)
            weights = torch.exp(top_sim / sigma)
            onehot = F.one_hot(labels_dev[top_idx], num_classes).float()
            pred = (onehot * weights[..., None]).sum(1).argmax(-1).cpu().numpy()
            correct += int((pred[:n_real] == np.asarray(labels)[:n_real]).sum())
            total += n_real
    if du.is_initialized():
        correct, total = (int(v) for v in du.all_reduce(
            [torch.tensor([correct, total], dtype=torch.int64)], "sum")[0].tolist())
    return 100.0 * correct / max(total, 1)


def ssl_batch(views, index, times, device):
    """The step's batch from a collated SSL batch (slowfast_tpu/engine/trainer.py:253-265):
    only views 0 and 1 reach the step, whatever ``TRAIN_CROP_NUM_TEMPORAL``
    decodes; ``time`` is each clip's first view's position."""
    return {"inputs": views[0], "inputs2": views[1],
            "index": to_device(np.asarray(index), device),
            "time": to_device(np.ascontiguousarray(
                np.asarray(times, np.float32).reshape(len(index), -1)[:, 0]), device)}

