"""Parameter partition and AdamW (counterpart of
slowfast_tpu/solver/optimizer.py:22-125, :287-361; reference
slowfast/models/optimizer.py).

The port's ``named_parameters()`` carry the dotted names that the JAX
package derives from its flax tree, so the partition rules apply to them as
they are. The update is the optax chain ``construct_optimizer`` builds for
``adamw``:

1. global-norm clip (``CLIP_GRAD_L2NORM``): the gradients are scaled by
   ``max_norm / norm`` only when ``norm >= max_norm``, with no epsilon, as
   ``optax.clip_by_global_norm`` does (``clip_grad_norm_`` adds 1e-6);
2. ``scale_by_adam`` with ``SOLVER.BETAS`` and eps 1e-8;
3. decoupled weight decay ``+ wd * p`` on the old parameters;
4. the per-parameter layer-decay scale;
5. ``p -= lr * u``, with ``lr`` given by the step, not held by the optimizer.

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


class AdamW:
    """The ``adamw`` chain of the JAX package's ``construct_optimizer``.

    ``step(lr)`` reads each parameter's ``.grad`` (a missing gradient counts
    as zeros, as JAX's gradient tree has one for every leaf), clips it in
    place and returns the global gradient norm before the clip, as a device
    tensor.
    """

    def __init__(self, model, cfg):
        if cfg.SOLVER.OPTIMIZING_METHOD not in ("adamw", "mt_adamw"):
            raise NotImplementedError(
                f"{cfg.SOLVER.OPTIMIZING_METHOD!r} is not ported yet; only adamw is")
        if cfg.SOLVER.LARS_ON:
            raise NotImplementedError("LARS is not ported yet")
        if cfg.SOLVER.CLIP_GRAD_VAL:
            raise NotImplementedError("SOLVER.CLIP_GRAD_VAL is not ported yet")
        self.max_norm = cfg.SOLVER.CLIP_GRAD_L2NORM
        self.b1, self.b2 = (float(b) for b in cfg.SOLVER.BETAS)
        self.eps = 1e-8
        scales = build_param_scales(model, cfg)
        self.names = list(scales)
        named = dict(model.named_parameters())
        self.params = [named[n] for n in self.names]
        # Parameters that share (weight decay, LR scale) are updated together.
        self.groups = {}
        for i, name in enumerate(self.names):
            self.groups.setdefault(scales[name], []).append(i)
        self.count = 0
        self.mu = [torch.zeros_like(p, dtype=torch.float32) for p in self.params]
        self.nu = [torch.zeros_like(p, dtype=torch.float32) for p in self.params]

    @torch.no_grad()
    def step(self, lr):
        grads = [p.grad.float() if p.grad is not None
                 else torch.zeros_like(p, dtype=torch.float32) for p in self.params]
        norm = get_grad_norm(grads)
        if self.max_norm:
            coef = torch.where(norm < self.max_norm, torch.ones_like(norm),
                               self.max_norm / norm)
            torch._foreach_mul_(grads, coef)
        self.count += 1
        torch._foreach_mul_(self.mu, self.b1)
        torch._foreach_add_(self.mu, grads, alpha=1.0 - self.b1)
        torch._foreach_mul_(self.nu, self.b2)
        torch._foreach_addcmul_(self.nu, grads, grads, value=1.0 - self.b2)
        mu_hat = torch._foreach_div(self.mu, 1.0 - self.b1 ** self.count)
        nu_hat = torch._foreach_div(self.nu, 1.0 - self.b2 ** self.count)
        denom = torch._foreach_sqrt(nu_hat)
        torch._foreach_add_(denom, self.eps)
        updates = torch._foreach_div(mu_hat, denom)
        for (wd, scale), idx in self.groups.items():
            u = [updates[i] for i in idx]
            p = [self.params[i] for i in idx]
            if wd:
                torch._foreach_add_(u, p, alpha=wd)
            if scale != 1.0:
                torch._foreach_mul_(u, scale)
            torch._foreach_mul_(u, lr)
            torch._foreach_sub_(p, u)
        return norm

    def state_dict(self):
        return {"count": self.count,
                "mu": {n: t.detach().cpu() for n, t in zip(self.names, self.mu)},
                "nu": {n: t.detach().cpu() for n, t in zip(self.names, self.nu)}}

    def load_state_dict(self, state):
        if sorted(state["mu"]) != sorted(self.names):
            raise ValueError("optimizer state does not match the model's parameters")
        self.count = int(state["count"])
        for i, n in enumerate(self.names):
            self.mu[i].copy_(state["mu"][n])
            self.nu[i].copy_(state["nu"][n])


def construct_optimizer(model, cfg):
    return AdamW(model, cfg)
