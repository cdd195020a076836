"""Multigrid training schedules (counterpart of
slowfast_tpu/utils/multigrid.py:20-171; reference slowfast/utils/multigrid.py).

The long cycle trades the batch size against the clip's length and crop,
(B, T, S), at about the same work a step: ``init_multigrid`` rewrites
``SOLVER.STEPS``, ``SOLVER.LRS`` and ``SOLVER.MAX_EPOCH`` from the schedule,
and ``update_long_cycle`` sets the epoch's shape and the BN mode its batch
needs. The short cycle is the train loader's: within an epoch its batches
cycle through the crops ``SHORT_CYCLE_FACTORS · DEFAULT_S`` and the full
crop, each batch as large as its crop allows (``data/loader.py``).
"""

import numpy as np

from . import logging as logging_utils

logger = logging_utils.get_logger(__name__)


class MultigridSchedule:
    """The long-cycle schedule, a list of ``(step index, [B factor, T, S],
    last epoch)``."""

    def init_multigrid(self, cfg):
        """Keep the default (B, T, S) in ``MULTIGRID.DEFAULT_*`` and rewrite
        the solver's steps, LRs and epochs; returns ``cfg``."""
        self.schedule = None
        cfg.MULTIGRID.DEFAULT_B = cfg.TRAIN.BATCH_SIZE
        cfg.MULTIGRID.DEFAULT_T = cfg.DATA.NUM_FRAMES
        cfg.MULTIGRID.DEFAULT_S = cfg.DATA.TRAIN_CROP_SIZE
        if cfg.MULTIGRID.LONG_CYCLE:
            self.schedule = self.get_long_cycle_schedule(cfg)
            cfg.SOLVER.STEPS = [0] + [s[-1] for s in self.schedule]
            # The fine-tuning phase splits its last step in two.
            cfg.SOLVER.STEPS[-1] = (cfg.SOLVER.STEPS[-2] + cfg.SOLVER.STEPS[-1]) // 2
            lrs = [cfg.SOLVER.GAMMA ** s[0] * s[1][0] for s in self.schedule]
            cfg.SOLVER.LRS = lrs[:-1] + [lrs[-2], lrs[-1]]
            cfg.SOLVER.MAX_EPOCH = self.schedule[-1][-1]
        elif cfg.MULTIGRID.SHORT_CYCLE:
            cfg.SOLVER.STEPS = [int(s * cfg.MULTIGRID.EPOCH_FACTOR) for s in cfg.SOLVER.STEPS]
            cfg.SOLVER.MAX_EPOCH = int(cfg.SOLVER.MAX_EPOCH * cfg.MULTIGRID.EPOCH_FACTOR)
        return cfg

    def update_long_cycle(self, cfg, cur_epoch):
        """Set the (B, T, S) of ``cur_epoch`` and its BN mode; returns
        ``(cfg, changed)``. A batch a device above ``BN_BASE_SIZE`` splits
        its BN statistics (``sub_batchnorm``, ``NUM_SPLITS``), one below
        asks for them over several devices (``sync_batchnorm``)."""
        base_b, base_t, base_s = get_current_long_cycle_shape(self.schedule, cur_epoch)
        if base_s == cfg.DATA.TRAIN_CROP_SIZE and base_t == cfg.DATA.NUM_FRAMES:
            return cfg, False
        cfg.DATA.NUM_FRAMES = base_t
        cfg.DATA.TRAIN_CROP_SIZE = base_s
        cfg.TRAIN.BATCH_SIZE = base_b * cfg.MULTIGRID.DEFAULT_B
        bs_factor = float(cfg.TRAIN.BATCH_SIZE / max(cfg.NUM_GPUS, 1)) / cfg.MULTIGRID.BN_BASE_SIZE
        if bs_factor < 1:
            cfg.BN.NORM_TYPE = "sync_batchnorm"
            cfg.BN.NUM_SYNC_DEVICES = int(1.0 / bs_factor)
        elif bs_factor > 1:
            cfg.BN.NORM_TYPE = "sub_batchnorm"
            cfg.BN.NUM_SPLITS = int(bs_factor)
        else:
            cfg.BN.NORM_TYPE = "batchnorm"
        # Kept for the log only: the clip's sampling rate stays
        # DATA.SAMPLING_RATE, as in the JAX package.
        cfg.MULTIGRID.LONG_CYCLE_SAMPLING_RATE = cfg.DATA.SAMPLING_RATE * (
            cfg.MULTIGRID.DEFAULT_T // cfg.DATA.NUM_FRAMES)
        logger.info("Long cycle updates:")
        logger.info("\tBN.NORM_TYPE: %s", cfg.BN.NORM_TYPE)
        logger.info("\tTRAIN.BATCH_SIZE: %d", cfg.TRAIN.BATCH_SIZE)
        logger.info("\tDATA.NUM_FRAMES x LONG_CYCLE_SAMPLING_RATE: %dx%d", cfg.DATA.NUM_FRAMES,
                    cfg.MULTIGRID.LONG_CYCLE_SAMPLING_RATE)
        logger.info("\tDATA.TRAIN_CROP_SIZE: %d", cfg.DATA.TRAIN_CROP_SIZE)
        return cfg, True

    def get_long_cycle_schedule(self, cfg):
        """The schedule: each solver step split among the long-cycle shapes
        in proportion to their mean batch, a fine-tuning phase at the
        default shape, the epochs scaled to ``MAX_EPOCH · EPOCH_FACTOR``."""
        steps = cfg.SOLVER.STEPS
        default_size = float(cfg.DATA.NUM_FRAMES * cfg.DATA.TRAIN_CROP_SIZE ** 2)
        default_iters = steps[-1]
        avg_bs, all_shapes = [], []
        for t_factor, s_factor in cfg.MULTIGRID.LONG_CYCLE_FACTORS:
            base_t = int(round(cfg.DATA.NUM_FRAMES * t_factor))
            base_s = int(round(cfg.DATA.TRAIN_CROP_SIZE * s_factor))
            shapes = [[base_t, base_s]]
            if cfg.MULTIGRID.SHORT_CYCLE:
                shapes = [[base_t, cfg.MULTIGRID.DEFAULT_S * f]
                          for f in cfg.MULTIGRID.SHORT_CYCLE_FACTORS[:2]] + shapes
            shapes = [[int(round(default_size / (s[0] * s[1] * s[1]))), s[0], s[1]]
                      for s in shapes]
            avg_bs.append(np.mean([s[0] for s in shapes]))
            all_shapes.append(shapes)

        total_iters = 0
        schedule = []
        for step_index in range(len(steps) - 1):
            step_epochs = steps[step_index + 1] - steps[step_index]
            for long_cycle_index, shapes in enumerate(all_shapes):
                cur_epochs = step_epochs * avg_bs[long_cycle_index] / sum(avg_bs)
                total_iters += cur_epochs / avg_bs[long_cycle_index]
                schedule.append((step_index, shapes[-1], cur_epochs))
        iter_saving = default_iters / total_iters
        # Fine-tune at the default shape.
        ft_epochs = (cfg.SOLVER.MAX_EPOCH - steps[-1]) / iter_saving * avg_bs[-1]
        schedule.append((step_index + 1, all_shapes[-1][-1], ft_epochs))

        x = cfg.SOLVER.MAX_EPOCH * cfg.MULTIGRID.EPOCH_FACTOR / sum(s[-1] for s in schedule)
        final_schedule, total_epochs = [], 0
        for s in schedule:
            total_epochs += s[2] * x
            final_schedule.append((s[0], s[1], int(round(total_epochs))))
        print_schedule(final_schedule)
        return final_schedule


def print_schedule(schedule):
    logger.info("Long cycle index\tBase shape\tEpochs")
    for s in schedule:
        logger.info("%s\t%s\t%s", s[0], s[1], s[2])


def get_current_long_cycle_shape(schedule, epoch):
    """The ``[B factor, T, S]`` of ``epoch``."""
    for s in schedule:
        if epoch < s[-1]:
            return s[1]
    return schedule[-1][1]
