"""Train and eval steps (counterpart of slowfast_tpu/engine/steps.py:54-275).

A uint8 NTHWC clip batch goes through the preprocess kernel (normalize,
channel reverse per ``DATA.REVERSE_INPUT_CHANNEL``, slow-pathway index),
then through the model in the configured compute dtype with fp32
parameters. The train step adds mixup, the fp32 loss, the backward, the
global-norm clip and the optimizer's update; the eval step runs under
``torch.inference_mode()``.
"""

import torch

from slowfast_tpu_torch.data.mixup import mixup_batch
from slowfast_tpu_torch.models.video_models import compute_dtype
from slowfast_tpu_torch.ops.preprocess import device_preprocess
from slowfast_tpu_torch.solver.losses import MULTI_LABEL_LOSSES, get_loss_func
from slowfast_tpu_torch.solver.lr_policy import make_epoch_lr_fn
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
    (slowfast_tpu/engine/steps.py:69).
    """
    if cfg.DETECTION.ENABLE or cfg.MASK.ENABLE:
        raise NotImplementedError("only classification training is ported")
    loss_fun = get_loss_func(cfg.MODEL.LOSS_FUNC)
    multi_label = cfg.DATA.MULTI_LABEL or cfg.MODEL.LOSS_FUNC in MULTI_LABEL_LOSSES
    lr_fn = make_epoch_lr_fn(cfg)
    mix = cfg.MIXUP

    def step(batch):
        model.train()
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
        preds = model(inputs)
        loss = loss_fun(preds, loss_labels)
        loss.backward()
        lr = lr_fn(batch["epoch_exact"])
        grad_norm = optimizer.step(lr)
        metrics = {"loss": loss.detach(), "grad_norm": grad_norm, "lr": lr}
        if not multi_label:
            with torch.no_grad():
                k1, k5 = topks_correct(preds.float(), labels, (1, 5))
                b = preds.shape[0]
                metrics.update(top1_err=(1.0 - k1 / b) * 100.0, top5_err=(1.0 - k5 / b) * 100.0)
        return metrics

    return step


def make_eval_step(cfg, model):
    """``batch -> preds`` for the eval/test loop; puts ``model`` in eval mode.

    ``batch["inputs"]`` is ``[clips_u8]`` or a list of float pathways, on
    the model's device.
    """
    if cfg.DETECTION.ENABLE:
        raise NotImplementedError("detection eval is not ported yet")
    model.eval()

    def step(batch):
        model.eval()  # a train step in between puts it back in train mode
        with torch.inference_mode():
            return model(maybe_device_preprocess(cfg, batch["inputs"]))

    return step
