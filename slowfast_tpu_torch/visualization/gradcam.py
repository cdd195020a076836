"""Grad-CAM (counterpart of slowfast_tpu/visualization/gradcam.py;
reference slowfast/visualization/gradcam_utils.py).

A forward hook on the target layer (a slash-separated PySlowFast name,
``s5/pathway0_res2`` or ``blocks/15``) hands the rest of the model a leaf
copy ``A`` of the layer's output, so ``torch.autograd.grad`` of the class
score gives ``dS/dA``, the gradient JAX's ``jax.grad`` through its
substituted activation gives. The score is the sum over the batch of the
max prediction, or of the true label's under ``use_labels``. The channel
weights are the mean of ``dS/dA`` over T, H and W; the CAM is
``ReLU(Σ_c w_c·A_c)``, min-max normalized over the whole batch and resized
trilinearly (``models/common.py resize_linear``, JAX's
``jax.image.resize``) to the pathway's (T, H, W). A transformer block's
``(B, N, C)`` tokens are laid on their (T, H, W) grid first, its cls token
left out.

The JAX module's score function reads a tuple where it wants the
predictions, so it raises on every call (ROADMAP Queue 3 #44); this one
computes what that code means.
"""

import math

import numpy as np
import torch

from slowfast_tpu_torch.models.common import resize_linear


def get_layer(model, name):
    """The submodule of a slash-separated PySlowFast name."""
    return model.get_submodule(name.replace("/", "."))


def layer_output(out):
    """The activation of a module's output: the first element of a tuple
    (a transformer block's ``(x, thw)``), the first pathway of a list."""
    val = out[0] if isinstance(out, tuple) else out
    return val[0] if isinstance(val, list) else val


class GradCAM:
    def __init__(self, model, target_layers, colormap="viridis"):
        """``target_layers``: one layer a pathway, PySlowFast names like
        ``s5/pathway0_res2``."""
        self.model = model
        self.target_layers = list(target_layers)
        self.colormap = colormap

    def _run_with_substitution(self, inputs, layer):
        """The forward with the layer's output replaced by a leaf copy of
        it; returns the predictions, the leaf and a block's token grid."""
        captured = {}

        def hook(module, args, out):
            a = layer_output(out).detach().requires_grad_(True)
            captured["act"] = a
            if isinstance(out, tuple):
                captured["thw"] = out[1] if len(out) > 1 else None
                return (a,) + tuple(out[1:])
            return a

        handle = get_layer(self.model, layer).register_forward_hook(hook)
        try:
            preds = self.model(inputs)
        finally:
            handle.remove()
        if "act" not in captured:
            raise ValueError(f"layer {layer} not found in forward")
        return preds, captured["act"], captured.get("thw")

    def layer_gradients(self, inputs, layer, labels=None, use_labels=False):
        """``(preds, A, dS/dA, thw)`` of one target layer: its activation,
        the class score's gradient there, and a block's token grid."""
        self.model.eval()
        with torch.enable_grad():
            preds, act, thw = self._run_with_substitution(inputs, layer)
            out = preds.float()
            if use_labels and labels is not None:
                idx = torch.as_tensor(labels, device=out.device).long().reshape(-1, 1)
                score = out.gather(-1, idx).sum()
            else:
                score = out.max(dim=-1).values.sum()
            (grads,) = torch.autograd.grad(score, act)
        return preds.detach(), act.detach(), grads, thw

    def __call__(self, inputs, labels=None, use_labels=False):
        """Returns (one ``(B, T, H, W)`` CAM a pathway at its input's size, as
        numpy, and the predictions)."""
        cams, preds = [], None
        for p, layer in enumerate(self.target_layers):
            preds, act, grads, thw = self.layer_gradients(inputs, layer, labels, use_labels)
            cam = class_activation_map(act.float(), grads.float(), thw)
            target = tuple(inputs[min(p, len(inputs) - 1)].shape[1:4])
            cam = resize_linear(cam, (cam.shape[0],) + target)
            cams.append(cam.cpu().numpy())
        return cams, preds.float().cpu().numpy()


def class_activation_map(act, grads, thw=None):
    """``ReLU(Σ_c mean_thw(dS/dA_c)·A_c)`` of NTHWC ``act`` (or a block's
    ``(B, N, C)`` tokens on the ``thw`` grid), min-max normalized over the
    batch."""
    if act.dim() == 3:
        n = math.prod(thw)
        act = act[:, -n:].reshape(act.shape[0], *thw, act.shape[-1])
        grads = grads[:, -n:].reshape(act.shape)
    weights = grads.mean(dim=tuple(range(1, act.dim() - 1)), keepdim=True)
    cam = torch.relu((weights * act).sum(dim=-1))
    cam = cam - cam.min()
    return cam / (cam.max() + 1e-8)


def overlay_heatmap(frames, cam, colormap="viridis", alpha=0.5):
    """A ``(T, H, W)`` CAM in [0, 1] blended onto ``(T, H, W, C)`` uint8
    frames through a matplotlib colormap."""
    import matplotlib

    matplotlib.use("Agg")
    heat = matplotlib.colormaps[colormap](np.asarray(cam))[..., :3]
    blended = (1 - alpha) * frames.astype(np.float32) / 255.0 + alpha * heat
    return (blended * 255).astype(np.uint8)
