"""Precise BN (counterpart of slowfast_tpu/engine/precise_bn.py:23-63;
reference fvcore ``update_bn_stats``, tools/train_net.py:425-446).

Each BN's ``running_mean`` and ``running_var`` become the plain average of
the per-batch mean and the per-batch unbiased variance over the first
``num_batches`` train batches, run through the preprocess kernel in train
mode with no mixup and no gradient. The statistics are taken directly
from each batch (``BatchNorm3D.precise_sums``) rather than recovered by
inverting the running average as the JAX package does, which would scale
the fp32 rounding by ``1 / momentum``. The parameters stay as they are,
the passes leave no running-average update behind, and the model's dropout
and drop-path generator is restored afterwards, as JAX draws those masks
from a fixed key.
"""

import itertools

import torch

from slowfast_tpu_torch.engine.steps import maybe_device_preprocess
from slowfast_tpu_torch.models.batchnorm import BatchNorm3D
from slowfast_tpu_torch.utils import logging as logging_utils

logger = logging_utils.get_logger(__name__)


@torch.no_grad()
def compute_precise_bn_stats(cfg, model, loader, num_batches):
    """Set every non-frozen BN's running statistics to their precise
    averages over the first ``num_batches`` batches of ``loader`` (any
    iterable of ``(inputs, ...)`` batches); returns the number of batches
    used."""
    bns = [m for m in model.modules() if isinstance(m, BatchNorm3D) and not m.frozen]
    if not bns or num_batches <= 0:
        return 0
    generators = {id(m.generator): m.generator for m in model.modules()
                  if getattr(m, "generator", None) is not None}
    gen_states = [(g, g.get_state()) for g in generators.values()]
    was_training = model.training
    for bn in bns:
        bn.precise_sums = (torch.zeros_like(bn.running_mean), torch.zeros_like(bn.running_var))
    count = 0
    model.train()
    batches = iter(loader)
    try:
        for inputs, *_ in itertools.islice(batches, num_batches):
            model(maybe_device_preprocess(cfg, inputs))
            count += 1
        if count:
            for bn in bns:
                bn.running_mean.copy_(bn.precise_sums[0] / count)
                bn.running_var.copy_(bn.precise_sums[1] / count)
    finally:
        if hasattr(batches, "close"):  # a Loader's generator: stop its workers
            batches.close()
        for bn in bns:
            bn.precise_sums = None
        for g, state in gen_states:
            g.set_state(state)
        model.train(was_training)
    logger.info("Updated precise BN stats over %d batches.", count)
    return count
