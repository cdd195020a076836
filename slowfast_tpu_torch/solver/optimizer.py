"""Parameter partition, SGD, Adam and AdamW (counterpart of
slowfast_tpu/solver/optimizer.py:22-125, :133-170, :287-361; reference
slowfast/models/optimizer.py).

The port's ``named_parameters()`` carry the dotted names that the JAX
package derives from its flax tree, so the partition rules apply to them as
they are. Each update is the optax chain ``construct_optimizer`` builds for
its method:

1. the clip: ``CLIP_GRAD_VAL`` clamps each gradient entry to ``[-v, v]``
   (``optax.clip``, :300) and then takes the place of the global-norm clip
   (``CLIP_GRAD_L2NORM``), which scales the gradients by ``max_norm /
   norm`` only when ``norm >= max_norm``, with no epsilon, as
   ``optax.clip_by_global_norm`` does (``clip_grad_norm_`` adds 1e-6);
1a. LARS (``SOLVER.LARS_ON``, :191 ``lars_adaptation``): on the raw
   gradient of every parameter that is not a BN one and has ndim > 1,
   ``g <- (g + wd * p) * 0.001 * |p| / (|g| + wd * |p| + 1e-8)`` in fp32
   where both norms are nonzero, ``g`` as it is elsewhere. LARS absorbs the
   weight decay: under it only BN parameters keep their coupled decay;
2. ``sgd``: coupled weight decay ``g + wd * p``, then momentum
   (``optax.trace``: ``v = m * v + g`` from ``v = 0``, Nesterov returns
   ``g + m * v``; with ``DAMPENING`` the first step takes ``v = g`` and later
   ones ``v = m * v + (1 - d) * g``, and Nesterov is refused). ``adam``:
   coupled weight decay, then ``scale_by_adam``. ``adamw``:
   ``scale_by_adam``, then decoupled weight decay ``+ wd * p``. Adam's eps
   is 1e-8, and the decay always reads the parameters before the update;
3. the per-parameter layer-decay scale;
4. ``p -= lr * u``, with ``lr`` given by the step, not held by the optimizer.

Every operation is a ``torch._foreach_*`` call over the parameter list and
stays on the device: nothing is read back to the host.
"""

import torch


def _is_bn_param(name):
    segs = name.split(".")
    mod = segs[-2] if len(segs) >= 2 else ""
    return mod == "bn" or mod.endswith("_bn")


def mvit_no_weight_decay(cfg):
    """Names excluded from weight decay (reference :1218-1241)."""
    names = []
    if "MVIT" not in cfg.MODEL.MODEL_NAME.upper():
        return names
    if cfg.MVIT.ZERO_DECAY_POS_CLS:
        if cfg.MVIT.USE_ABS_POS:
            if cfg.MVIT.SEP_POS_EMBED:
                names += ["pos_embed_spatial", "pos_embed_temporal", "pos_embed_class"]
            else:
                names.append("pos_embed")
        if cfg.MVIT.REL_POS_SPATIAL:
            names += ["rel_pos_h", "rel_pos_w", "rel_pos_hw"]
        if cfg.MVIT.REL_POS_TEMPORAL:
            names += ["rel_pos_t"]
        if cfg.MVIT.CLS_EMBED_ON:
            names.append("cls_token")
        if cfg.MASK.ENABLE and cfg.MASK.DECODER_SEP_POS_EMBED:
            # Only the separable decoder tables, as in the JAX package: the
            # reference's joint name "pos_embed_decoder" matches no
            # parameter, so "decoder_pos_embed" is decayed.
            names += ["dec_pos_embed_spatial", "dec_pos_embed_temporal", "dec_pos_embed_class"]
    return names


def _layer_decay_scale(name, cfg):
    """Layer-wise LR decay scale (reference get_param_groups :146-160)."""
    if name in ("cls_token", "mask_token") or name.startswith(("pos_embed", "patch_embed")):
        layer_id = 0
    elif name.startswith("blocks"):
        layer_id = int(name.split(".")[1]) + 1
    else:
        layer_id = cfg.MVIT.DEPTH + 1
    return cfg.SOLVER.LAYER_DECAY ** (cfg.MVIT.DEPTH + 1 - layer_id)


def build_param_scales(model, cfg):
    """``{name: (weight_decay, lr_scale)}`` for every trainable parameter."""
    skip = mvit_no_weight_decay(cfg)
    use_layer_decay = cfg.SOLVER.LAYER_DECAY != 1.0
    out = {}
    for name, p in model.named_parameters():
        if not p.requires_grad:
            continue
        if _is_bn_param(name):
            wd = cfg.BN.WEIGHT_DECAY
        elif skip and any(k in name for k in skip):
            wd = 0.0
        elif cfg.SOLVER.ZERO_WD_1D_PARAM and (p.dim() == 1 or name.endswith(".bias")):
            wd = 0.0
        else:
            wd = cfg.SOLVER.WEIGHT_DECAY
        scale = _layer_decay_scale(name, cfg) if use_layer_decay else 1.0
        out[name] = (float(wd), float(scale))
    return out


def get_grad_norm(grads):
    """Global L2 norm of a list of gradients, in fp32, on the device."""
    return torch.linalg.vector_norm(
        torch.stack(torch._foreach_norm([g.float() for g in grads])))


class _Chain:
    """What every method's chain shares: the parameter list in a fixed
    order, its (weight decay, LR scale) groups, the clip and the final
    update.

    ``step(lr)`` reads each parameter's ``.grad`` (a missing gradient counts
    as zeros, as JAX's gradient tree has one for every leaf), clips it and
    returns the global gradient norm before the clip, as a device tensor.
    ``state_dict()`` holds ``count`` and one ``{name: tensor}`` per state
    buffer of the method (``BUFFERS``).
    """

    BUFFERS = ()

    def __init__(self, model, cfg):
        self.max_value = cfg.SOLVER.CLIP_GRAD_VAL
        self.max_norm = cfg.SOLVER.CLIP_GRAD_L2NORM
        scales = build_param_scales(model, cfg)
        self.names = list(scales)
        named = dict(model.named_parameters())
        self.params = [named[n] for n in self.names]
        # LARS-adapted parameters and their weight decay, which LARS takes
        # over from the decay step (:306-313).
        self.lars = []
        if cfg.SOLVER.LARS_ON:
            self.lars = [(i, scales[n][0]) for i, n in enumerate(self.names)
                         if not _is_bn_param(n) and self.params[i].dim() > 1]
            scales = {n: (wd if _is_bn_param(n) else 0.0, s) for n, (wd, s) in scales.items()}
        # Parameters that share (weight decay, LR scale) are updated together.
        self.groups = {}
        for i, name in enumerate(self.names):
            self.groups.setdefault(scales[name], []).append(i)
        self.count = 0
        for buf in self.BUFFERS:
            setattr(self, buf, [torch.zeros_like(p, dtype=torch.float32)
                                for p in self.params])

    def _clipped_grads(self):
        grads = [p.grad.float() if p.grad is not None
                 else torch.zeros_like(p, dtype=torch.float32) for p in self.params]
        norm = get_grad_norm(grads)
        if self.max_value:
            torch._foreach_clamp_min_(grads, -self.max_value)
            torch._foreach_clamp_max_(grads, self.max_value)
        elif self.max_norm:
            coef = torch.where(norm < self.max_norm, torch.ones_like(norm),
                               self.max_norm / norm)
            torch._foreach_mul_(grads, coef)
        self._lars(grads)
        return grads, norm

    def _lars(self, grads, trust=0.001, eps=1e-8):
        """LARS's trust ratio on ``grads`` in place (``lars_adaptation``)."""
        if not self.lars:
            return
        idx = [i for i, _ in self.lars]
        p_norms = torch._foreach_norm([self.params[i].float() for i in idx])
        g_norms = torch._foreach_norm([grads[i] for i in idx])
        for (i, wd), pn, gn in zip(self.lars, p_norms, g_norms):
            ratio = trust * pn / (gn + wd * pn + eps)
            keep = (pn == 0) | (gn == 0)
            adapted = (grads[i] + wd * self.params[i].float()) * ratio
            grads[i].copy_(torch.where(keep, grads[i], adapted))

    def _add_decay(self, tensors):
        """``t += wd * p`` for each parameter's tensor, by group."""
        for (wd, _), idx in self.groups.items():
            if wd:
                torch._foreach_add_([tensors[i] for i in idx],
                                    [self.params[i] for i in idx], alpha=wd)

    def _apply(self, updates, lr):
        """``p -= lr * (scale * u)``, by group."""
        for (_, scale), idx in self.groups.items():
            u = [updates[i] for i in idx]
            if scale != 1.0:
                torch._foreach_mul_(u, scale)
            torch._foreach_mul_(u, lr)
            torch._foreach_sub_([self.params[i] for i in idx], u)

    def _adam_direction(self, grads, b1, b2, eps=1e-8):
        """``optax.scale_by_adam``: bias-corrected ``mu / (sqrt(nu) + eps)``.
        The corrections ``1 - b ** count`` are taken in fp32, as optax takes
        them: in double they differ by up to 2e-5 relative at ``b2 = 0.999``,
        where fp32 cancels."""
        torch._foreach_mul_(self.mu, b1)
        torch._foreach_add_(self.mu, grads, alpha=1.0 - b1)
        torch._foreach_mul_(self.nu, b2)
        torch._foreach_addcmul_(self.nu, grads, grads, value=1.0 - b2)
        count = torch.tensor(float(self.count))
        mu_hat = torch._foreach_div(self.mu, float(1.0 - torch.tensor(b1) ** count))
        nu_hat = torch._foreach_div(self.nu, float(1.0 - torch.tensor(b2) ** count))
        denom = torch._foreach_sqrt(nu_hat)
        torch._foreach_add_(denom, eps)
        return torch._foreach_div(mu_hat, denom)

    def state_dict(self):
        out = {"count": self.count}
        for buf in self.BUFFERS:
            out[buf] = {n: t.detach().cpu() for n, t in zip(self.names, getattr(self, buf))}
        return out

    def load_state_dict(self, state):
        for buf in self.BUFFERS:
            if sorted(state[buf]) != sorted(self.names):
                raise ValueError("optimizer state does not match the model's parameters")
        self.count = int(state["count"])
        for buf in self.BUFFERS:
            for t, n in zip(getattr(self, buf), self.names):
                t.copy_(state[buf][n])


class AdamW(_Chain):
    """The ``adamw`` chain: Adam, then decoupled weight decay."""

    BUFFERS = ("mu", "nu")

    def __init__(self, model, cfg):
        super().__init__(model, cfg)
        self.b1, self.b2 = (float(b) for b in cfg.SOLVER.BETAS)

    @torch.no_grad()
    def step(self, lr):
        grads, norm = self._clipped_grads()
        self.count += 1
        updates = self._adam_direction(grads, self.b1, self.b2)
        self._add_decay(updates)
        self._apply(updates, lr)
        return norm


class Adam(AdamW):
    """The ``adam`` chain: weight decay coupled into the gradient, then Adam."""

    @torch.no_grad()
    def step(self, lr):
        grads, norm = self._clipped_grads()
        self.count += 1
        self._add_decay(grads)
        self._apply(self._adam_direction(grads, self.b1, self.b2), lr)
        return norm


class SGD(_Chain):
    """The ``sgd`` chain: weight decay coupled into the gradient, then
    momentum with optional dampening or Nesterov (``optax.trace`` or the
    JAX package's ``trace_with_dampening``)."""

    BUFFERS = ("trace",)

    def __init__(self, model, cfg):
        super().__init__(model, cfg)
        self.momentum = float(cfg.SOLVER.MOMENTUM)
        self.dampening = float(cfg.SOLVER.DAMPENING)
        self.nesterov = bool(cfg.SOLVER.NESTEROV)
        if self.dampening and self.nesterov:
            # torch forbids it too (optim/sgd.py).
            raise ValueError("SOLVER.DAMPENING requires SOLVER.NESTEROV False")

    @torch.no_grad()
    def step(self, lr):
        grads, norm = self._clipped_grads()
        self._add_decay(grads)
        if self.dampening and self.count == 0:
            torch._foreach_copy_(self.trace, grads)
        else:
            torch._foreach_mul_(self.trace, self.momentum)
            torch._foreach_add_(self.trace, grads, alpha=1.0 - self.dampening)
        self.count += 1
        if self.nesterov:
            torch._foreach_add_(grads, self.trace, alpha=self.momentum)
            updates = grads
        else:
            updates = [t.clone() for t in self.trace]
        self._apply(updates, lr)
        return norm


OPTIMIZERS = {"sgd": SGD, "adam": Adam, "adamw": AdamW, "mt_adamw": AdamW}


def construct_optimizer(model, cfg):
    method = cfg.SOLVER.OPTIMIZING_METHOD
    if method not in OPTIMIZERS:
        raise NotImplementedError(f"{method!r} is not ported yet; available: "
                                  f"{sorted(OPTIMIZERS)}")
    return OPTIMIZERS[method](model, cfg)
