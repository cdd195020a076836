"""Eval step (counterpart of slowfast_tpu/engine/steps.py:205-275).

A single uint8 NTHWC clip batch goes through the preprocess kernel
(normalize, channel reverse per ``DATA.REVERSE_INPUT_CHANNEL``, slow-pathway
index), then through the model under ``torch.inference_mode()`` in the
configured compute dtype.
"""

import torch

from slowfast_tpu_torch.models.video_models import compute_dtype
from slowfast_tpu_torch.ops.preprocess import device_preprocess


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


def make_eval_step(cfg, model):
    """``batch -> preds`` for the eval/test loop; puts ``model`` in eval mode.

    ``batch["inputs"]`` is ``[clips_u8]`` or a list of float pathways, on
    the model's device.
    """
    if cfg.DETECTION.ENABLE:
        raise NotImplementedError("detection eval is not ported yet")
    model.eval()

    def step(batch):
        with torch.inference_mode():
            return model(maybe_device_preprocess(cfg, batch["inputs"]))

    return step
