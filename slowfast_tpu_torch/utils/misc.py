"""NaN guard, model info, FLOP count, eval cadence (counterpart of
slowfast_tpu/utils/misc.py; reference slowfast/utils/misc.py:27-418).

``get_flop_stats`` counts the FLOPs of one clip's eval forward with
``torch.utils.flop_counter.FlopCounterMode``: two per multiply-add of the
matrix products, convolutions and attention products, nothing for
elementwise work or reductions (the JAX package reads XLA's cost analysis,
which counts those too). The model runs under ``FakeTensorMode``: a copy of
its structure whose tensors hold shapes and no data, on the CPU, so the
forward takes the plain path of every hand kernel (which the counter could
not see into) and computes nothing.
"""

import math

import torch

from . import logging as logging_utils
from .checkpoint import multigrid_period_hit
from .meters import gpu_mem_usage

logger = logging_utils.get_logger(__name__)


def check_nan_losses(loss, where=""):
    """Raise on a NaN loss (reference misc.py:27-34)."""
    if math.isnan(loss):
        raise RuntimeError(f"ERROR: Got NaN losses{where}")


def params_count(model):
    """The number of parameters of ``model``."""
    return sum(p.numel() for p in model.parameters())


def dummy_inputs(cfg, batch_size=1, crop_size=None):
    """Zero clips of every pathway, NTHWC float32 (reference misc.py:128-132)."""
    crop = crop_size or cfg.DATA.TRAIN_CROP_SIZE
    t = cfg.DATA.NUM_FRAMES
    chans = cfg.DATA.INPUT_CHANNEL_NUM
    if cfg.MODEL.ARCH in cfg.MODEL.MULTI_PATHWAY_ARCH:
        return [torch.zeros(batch_size, t // cfg.SLOWFAST.ALPHA, crop, crop, chans[0]),
                torch.zeros(batch_size, t, crop, crop, chans[1])]
    return [torch.zeros(batch_size, t, crop, crop, chans[0])]


def get_flop_stats(cfg):
    """GFLOPs of one clip through the eval forward of ``cfg``'s model (a
    detection model with one box on the clip, reference misc.py:134-139)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode

    from slowfast_tpu_torch.models.build import MODEL_REGISTRY

    with FakeTensorMode():
        model = MODEL_REGISTRY[cfg.MODEL.MODEL_NAME](cfg).eval()
        inputs = dummy_inputs(cfg)
        with FlopCounterMode(display=False) as counter, torch.no_grad():
            if cfg.DETECTION.ENABLE:
                model(inputs, torch.tensor([[[0.0, 0.0, 32.0, 32.0]]]))
            else:
                model(inputs)
    return counter.get_total_flops() / 1e9


def log_model_info(model, cfg):
    """Log the model's parameter count and GFLOPs per clip (reference
    misc.py:168-197); returns ``(params, gflops)``, ``gflops`` None where
    the count fails (as the JAX package's, it does not stop the run)."""
    n_params = params_count(model)
    logger.info("Model: %s", cfg.MODEL.MODEL_NAME)
    logger.info("Params: {:,}".format(n_params))
    try:
        gflops = get_flop_stats(cfg)
        logger.info("Flops: %.2f GFLOPs / clip", gflops)
    except Exception as e:  # noqa: BLE001 -- a log line, not the run
        gflops = None
        logger.info("Flop analysis unavailable: %r", e)
    logger.info("Mem: {:,} MB".format(int(gpu_mem_usage() * 1024)))
    return n_params, gflops


def is_eval_epoch(cfg, cur_epoch, multigrid_schedule=None):
    """Eval cadence, multigrid-aware (slowfast_tpu/engine/trainer.py:466-479):
    the last epoch, a shape's cadence under a long cycle, else every
    ``TRAIN.EVAL_PERIOD`` epochs."""
    if cur_epoch + 1 == cfg.SOLVER.MAX_EPOCH:
        return True
    hit = multigrid_period_hit(cfg, cur_epoch, multigrid_schedule)
    if hit is not None:
        return hit
    return (cur_epoch + 1) % cfg.TRAIN.EVAL_PERIOD == 0

