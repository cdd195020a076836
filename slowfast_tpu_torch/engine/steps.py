"""Train and eval steps (counterpart of slowfast_tpu/engine/steps.py:54-275).

A uint8 NTHWC clip batch goes through the preprocess kernel (normalize,
channel reverse per ``DATA.REVERSE_INPUT_CHANNEL``, slow-pathway index),
then through the model in the configured compute dtype with fp32
parameters. The train step adds mixup, the fp32 loss, the backward, the
global-norm clip and the optimizer's update; the eval step runs under
``torch.inference_mode()``. Under ``DETECTION.ENABLE`` both also take the
padded boxes, and the loss is masked to the real boxes. Under
``MASK.ENABLE`` (MaskFeat, MAE) the model makes its own targets from the
clips and the loader's mask, and the loss is ``masked_loss``.

Under a process group each rank steps on its part of the global batch and
the step computes what the JAX package's step computes on the whole of it
(slowfast_tpu/engine/steps.py:54-202): the BNs take global statistics
(``models/batchnorm.py``); after the backward every gradient is replaced
by its mean over the ranks, before the clip and the update; a loss that
divides by a count of the data (the real boxes of a detection batch, the
masked positions of MaskFeat and MAE) divides by the global count and is
scaled by the world size, so that the mean of the gradients is the global
loss's; mixup pairs row i of the global batch with row G-1-i, so each rank
mixes with the flipped rows of its mirror rank, with the same draws on
every rank.
"""

import torch

from slowfast_tpu_torch.data.mixup import mixup_batch
from slowfast_tpu_torch.models.masked import masked_loss
from slowfast_tpu_torch.models.video_models import compute_dtype
from slowfast_tpu_torch.ops.preprocess import device_preprocess
from slowfast_tpu_torch.solver.losses import MULTI_LABEL_LOSSES, get_loss_func
from slowfast_tpu_torch.solver.lr_policy import make_epoch_lr_fn
from slowfast_tpu_torch.utils import distributed as du
from slowfast_tpu_torch.utils.metrics import topks_correct


def num_pathways(cfg):
    return 2 if cfg.MODEL.ARCH in cfg.MODEL.MULTI_PATHWAY_ARCH else 1


def maybe_device_preprocess(cfg, inputs):
    """uint8 single-clip input -> the model's normalized pathway list; float
    pathway lists pass through untouched."""
    if not (len(inputs) == 1 and inputs[0].dtype == torch.uint8):
        return inputs
    return device_preprocess(
        inputs[0], cfg.DATA.MEAN, cfg.DATA.STD,
        alpha=cfg.SLOWFAST.ALPHA,
        single_pathway=num_pathways(cfg) == 1,
        out_dtype=compute_dtype(cfg),
        reverse_channels=cfg.DATA.REVERSE_INPUT_CHANNEL,
    )


def masked_detection_loss(loss_fun, preds, labels, box_mask, count=lambda n: n):
    """The detection loss over the real boxes only
    (slowfast_tpu/engine/steps.py:99-116): ``preds`` ``(B*M, K)``, ``labels``
    ``(B, M, K)`` targets (or ``(B, M)`` class ids), ``box_mask`` ``(B, M)``.
    A per-(box, class) loss (``bce``) is summed and divided by
    ``max(mask.sum() * K, 1)``; a per-box loss (cross-entropy) by
    ``max(mask.sum(), 1)``. ``count`` maps the box count to the one to
    divide by (the global one under a process group)."""
    mask = box_mask.reshape(-1).float()
    per_elem = loss_fun(preds, labels.reshape(preds.shape[0], *labels.shape[2:]),
                        reduction="none")
    if per_elem.dim() == 2:
        per_elem = per_elem * mask[:, None]
        denom = torch.clamp(count(mask.sum()) * preds.shape[-1], min=1.0)
    else:
        per_elem = per_elem * mask
        denom = torch.clamp(count(mask.sum()), min=1.0)
    return per_elem.sum() / denom


def make_train_step(cfg, model, optimizer, mix_generator=None):
    """``batch -> metrics`` for one training iteration.

    ``batch`` holds ``"inputs"`` (``[clips_u8]`` or float pathways on the
    model's device), ``"labels"`` on the same device (integer, or multi-hot
    float for multi-label data) and the fractional epoch ``"epoch_exact"``
    (a float) that sets the LR. In order: preprocess, mixup (``cfg.MIXUP``,
    draws from ``mix_generator``), forward in train mode, loss in fp32,
    backward, the gradient norm before the clip, the clip, ``lr =
    lr_fn(epoch_exact)`` and the optimizer's update. Returns ``loss``,
    ``grad_norm`` and, for single-label data, ``top1_err``/``top5_err`` as
    device tensors (nothing is read back), and ``lr``. Multi-label training
    (``DATA.MULTI_LABEL`` or a ``bce``/``bce_logit`` loss) reports no top-k
    (slowfast_tpu/engine/steps.py:69). Detection batches also hold
    ``"boxes"`` ``(B, M, 4)`` and ``"box_mask"`` ``(B, M)`` on the device, with
    ``(B, M, K)`` labels; the loss is ``masked_detection_loss`` and no top-k
    is reported. Masked pretraining (``MASK.ENABLE``) passes ``batch["mask"]``
    (the loader's mask on the device, absent when the model draws its own)
    to the model and scores its ``(preds, [(target, mask)])`` with
    ``masked_loss`` in fp32; no top-k is reported
    (slowfast_tpu/engine/steps.py:117-127).
    """
    detection = cfg.DETECTION.ENABLE
    masked = cfg.MASK.ENABLE
    loss_fun = get_loss_func(cfg.MODEL.LOSS_FUNC)
    multi_label = cfg.DATA.MULTI_LABEL or cfg.MODEL.LOSS_FUNC in MULTI_LABEL_LOSSES
    lr_fn = make_epoch_lr_fn(cfg)
    mix = cfg.MIXUP

    def step(batch):
        model.train()
        world = du.get_world_size()
        inputs = maybe_device_preprocess(cfg, batch["inputs"])
        labels = batch["labels"]
        loss_labels = labels
        if mix.ENABLE:
            inputs, loss_labels = mixup_batch(
                mix_generator, inputs, labels, cfg.MODEL.NUM_CLASSES,
                mixup_alpha=mix.ALPHA, cutmix_alpha=mix.CUTMIX_ALPHA, mix_prob=mix.PROB,
                switch_prob=mix.SWITCH_PROB, label_smoothing=mix.LABEL_SMOOTH_VALUE)
        for p in model.parameters():
            p.grad = None
        if detection:
            preds = model(inputs, batch["boxes"])
            loss = masked_detection_loss(loss_fun, preds, loss_labels, batch["box_mask"],
                                         du.global_count) * world
        elif masked:
            preds, targets = model(inputs, mask=batch.get("mask"))
            loss = masked_loss(preds, targets, du.global_count) * world
        else:
            preds = model(inputs)
            loss = loss_fun(preds, loss_labels)
        loss.backward()
        du.all_reduce_grads([p for p in model.parameters() if p.requires_grad])
        lr = lr_fn(batch["epoch_exact"])
        grad_norm = optimizer.step(lr)
        metrics = {"loss": loss.detach(), "grad_norm": grad_norm, "lr": lr}
        if not (multi_label or detection or masked):
            with torch.no_grad():
                k1, k5 = topks_correct(preds.float(), labels, (1, 5))
                b = preds.shape[0]
                metrics.update(top1_err=(1.0 - k1 / b) * 100.0, top5_err=(1.0 - k5 / b) * 100.0)
        return metrics

    return step


def make_eval_step(cfg, model):
    """``batch -> preds`` for the eval/test loop; puts ``model`` in eval mode.

    ``batch["inputs"]`` is ``[clips_u8]`` or a list of float pathways, on
    the model's device; under ``DETECTION.ENABLE`` ``batch["boxes"]`` holds
    the padded boxes there too, and the predictions are one row per box.
    """
    detection = cfg.DETECTION.ENABLE
    model.eval()

    def step(batch):
        model.eval()  # a train step in between puts it back in train mode
        with torch.inference_mode():
            inputs = maybe_device_preprocess(cfg, batch["inputs"])
            return model(inputs, batch["boxes"]) if detection else model(inputs)

    return step
