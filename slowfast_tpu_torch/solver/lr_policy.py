"""Learning-rate policies (counterpart of slowfast_tpu/solver/lr_policy.py and
solver/optimizer.py:227 ``make_epoch_lr_fn``; reference
slowfast/utils/lr_policy.py).

The LR is a plain Python float, a function of the fractional epoch
``cur_epoch + cur_iter / iters_per_epoch``, with a linear warmup from
``WARMUP_START_LR`` below ``WARMUP_EPOCHS``.
"""

import math


def get_lr_at_epoch(cfg, cur_epoch):
    lr = get_lr_func(cfg.SOLVER.LR_POLICY)(cfg, cur_epoch)
    if cur_epoch < cfg.SOLVER.WARMUP_EPOCHS:
        lr_start = cfg.SOLVER.WARMUP_START_LR
        lr_end = get_lr_func(cfg.SOLVER.LR_POLICY)(cfg, cfg.SOLVER.WARMUP_EPOCHS)
        alpha = (lr_end - lr_start) / cfg.SOLVER.WARMUP_EPOCHS
        lr = cur_epoch * alpha + lr_start
    return lr


def lr_func_cosine(cfg, cur_epoch):
    offset = cfg.SOLVER.WARMUP_EPOCHS if cfg.SOLVER.COSINE_AFTER_WARMUP else 0.0
    if not cfg.SOLVER.COSINE_END_LR < cfg.SOLVER.BASE_LR:
        raise ValueError("SOLVER.COSINE_END_LR must be below SOLVER.BASE_LR")
    return (
        cfg.SOLVER.COSINE_END_LR
        + (cfg.SOLVER.BASE_LR - cfg.SOLVER.COSINE_END_LR)
        * (math.cos(math.pi * (cur_epoch - offset) / (cfg.SOLVER.MAX_EPOCH - offset)) + 1.0)
        * 0.5
    )


def lr_func_steps_with_relative_lrs(cfg, cur_epoch):
    return cfg.SOLVER.LRS[get_step_index(cfg, cur_epoch)] * cfg.SOLVER.BASE_LR


def lr_func_constant(cfg, cur_epoch):
    return cfg.SOLVER.BASE_LR


def get_step_index(cfg, cur_epoch):
    steps = list(cfg.SOLVER.STEPS) + [cfg.SOLVER.MAX_EPOCH]
    for ind, step in enumerate(steps):
        if cur_epoch < step:
            break
    return ind - 1


_POLICIES = {
    "cosine": lr_func_cosine,
    "steps_with_relative_lrs": lr_func_steps_with_relative_lrs,
    "constant": lr_func_constant,
}


def get_lr_func(lr_policy):
    if lr_policy not in _POLICIES:
        raise NotImplementedError(f"Unknown LR policy: {lr_policy}")
    return _POLICIES[lr_policy]


def make_epoch_lr_fn(cfg):
    """``epoch_exact -> lr`` for the train step (the per-iteration LR of the
    reference's set_lr, driven by the fractional epoch)."""
    return lambda epoch_exact: get_lr_at_epoch(cfg, epoch_exact)
