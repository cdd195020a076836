"""The port's multigrid schedule and short-cycle data against the JAX
package, on the CPU.

* ``MultigridSchedule``: ``init_multigrid`` (the schedule, ``SOLVER.STEPS``,
  ``LRS``, ``MAX_EPOCH``) and ``update_long_cycle`` on every epoch (the
  (B, T, S), the BN mode and splits) equal JAX's for the three shipped
  ``*_multigrid.yaml`` and ``tests/test_multigrid.py``'s ``_mg_cfg``, at two
  batch sizes and device counts; the eval and checkpoint cadences on every
  epoch; the LR at every ``epoch_exact`` a short-cycle epoch feeds the step.
* The short cycle: the train loader's ``(index, cycle)`` batches equal JAX
  ``ShardedLoader._indices`` over two epochs, its batches equal JAX's, and
  ``Syntheticvideo`` and ``Kinetics`` items at cycle positions 0, 1 and 2
  are bit-equal to JAX's.
* ``len`` of a short-cycle loader counts batches of ``B`` as JAX's does, so
  an epoch's ``epoch_exact`` ends near 3/7 (ROADMAP Queue 3).
* Charades and SSv2 refuse the short cycle: the JAX package's items fail on
  an ``(index, cycle)`` pair (shown here); their long cycle builds.
* One train step of the narrow multigrid SlowFast at a short-cycle shape
  under ``sub_batchnorm`` (4 splits) against JAX's ``make_train_step`` from
  the same state (``tests/test_torch_multigrid_train.py hold_step``).
"""

import os
import random

import jax
import numpy as np
import pytest

from slowfast_tpu.config import get_cfg as jax_get_cfg
from slowfast_tpu.data import construct_loader as jax_construct_loader
from slowfast_tpu.data.charades import Charades as JaxCharades
from slowfast_tpu.data.kinetics import Kinetics as JaxKinetics
from slowfast_tpu.data.kinetics import Syntheticvideo as JaxSyntheticvideo
from slowfast_tpu.data.ssv2 import Ssv2 as JaxSsv2
from slowfast_tpu.engine.trainer import _is_eval_epoch as jax_is_eval_epoch
from slowfast_tpu import native as jax_native
from slowfast_tpu.solver.optimizer import make_epoch_lr_fn as jax_lr_fn
from slowfast_tpu.utils import checkpoint as jcu
from slowfast_tpu.utils.multigrid import MultigridSchedule as JaxSchedule
from slowfast_tpu_torch.config import get_cfg
from slowfast_tpu_torch.data import construct_loader
from slowfast_tpu_torch.data.kinetics import Kinetics, Syntheticvideo
from slowfast_tpu_torch.data.utils import sample_seed
from slowfast_tpu_torch.engine.trainer import is_eval_epoch
from slowfast_tpu_torch.models.batchnorm import BatchNorm3D
from slowfast_tpu_torch.solver.lr_policy import make_epoch_lr_fn
from slowfast_tpu_torch.utils import checkpoint as cu
from slowfast_tpu_torch.utils.multigrid import MultigridSchedule
from test_torch_data import BASE, corpus, same  # noqa: F401  (fixture)
from test_torch_frame_datasets import both_cfgs as frame_cfgs
from test_torch_frame_datasets import frame_root, split_dir  # noqa: F401  (fixture)
from test_torch_multigrid_train import cfgs_at, hold_step, jax_state, port_at, short_cycle_batch
from test_torch_train import one_torch_thread  # noqa: F401  (autouse fixture)

CONFIGS = os.path.join(os.path.dirname(__file__), "..", "configs")
RECIPES = {
    "kinetics": "Kinetics/SLOWFAST_8x8_R50_stepwise_multigrid.yaml",
    "charades": "Charades/SLOWFAST_16x8_R50_multigrid.yaml",
    "ssv2": "SSv2/SLOWFAST_16x8_R50_multigrid.yaml",
}
# The recipe's batch and devices, and one device's share of it.
SCALES = {"recipe": (64, 8), "one_gpu": (8, 1)}
# The keys multigrid reads or writes.
KEYS = [("TRAIN", "BATCH_SIZE"), ("DATA", "NUM_FRAMES"), ("DATA", "TRAIN_CROP_SIZE"),
        ("BN", "NORM_TYPE"), ("BN", "NUM_SPLITS"), ("BN", "NUM_SYNC_DEVICES"),
        ("SOLVER", "STEPS"), ("SOLVER", "LRS"), ("SOLVER", "MAX_EPOCH"),
        ("MULTIGRID", "DEFAULT_B"), ("MULTIGRID", "DEFAULT_T"), ("MULTIGRID", "DEFAULT_S"),
        ("MULTIGRID", "LONG_CYCLE_SAMPLING_RATE")]


def mg_cfg(get):
    """``tests/test_multigrid.py``'s ``_mg_cfg``."""
    cfg = get()
    cfg.merge_from_list(["MULTIGRID.LONG_CYCLE", "True", "SOLVER.STEPS", "[0, 16, 24, 28]",
                         "SOLVER.LRS", "[1, 0.1, 0.01, 0.001]", "SOLVER.MAX_EPOCH", "32",
                         "SOLVER.LR_POLICY", "steps_with_relative_lrs",
                         "DATA.NUM_FRAMES", "16", "DATA.TRAIN_CROP_SIZE", "224"])
    return cfg


def recipe_cfg(get, name, scale):
    if name == "mg_cfg":
        cfg = mg_cfg(get)
    else:
        cfg = get()
        cfg.merge_from_file(os.path.join(CONFIGS, RECIPES[name]))
    batch, gpus = SCALES[scale]
    cfg.merge_from_list(["TRAIN.BATCH_SIZE", str(batch), "NUM_GPUS", str(gpus)])
    return cfg


def values(cfg):
    return {f"{a}.{b}": cfg[a][b] for a, b in KEYS}


def both_schedules(name, scale):
    out = []
    for get, cls in ((jax_get_cfg, JaxSchedule), (get_cfg, MultigridSchedule)):
        cfg = recipe_cfg(get, name, scale)
        mg = cls()
        cfg = mg.init_multigrid(cfg)
        out.append((cfg, mg))
    return out


CASES = [(name, scale) for name in sorted(RECIPES) + ["mg_cfg"] for scale in sorted(SCALES)]


@pytest.mark.parametrize("name,scale", CASES)
def test_schedule_and_long_cycle_match_jax(name, scale):
    (jcfg, jmg), (cfg, mg) = both_schedules(name, scale)
    assert mg.schedule == jmg.schedule and values(cfg) == values(jcfg)
    assert len(cfg.SOLVER.STEPS) == len(cfg.SOLVER.LRS) == len(mg.schedule) + 1
    seen = set()
    for epoch in range(cfg.SOLVER.MAX_EPOCH):
        jcfg, jchanged = jmg.update_long_cycle(jcfg, epoch)
        cfg, changed = mg.update_long_cycle(cfg, epoch)
        assert changed == jchanged and values(cfg) == values(jcfg), epoch
        seen.add((cfg.TRAIN.BATCH_SIZE, cfg.DATA.NUM_FRAMES, cfg.DATA.TRAIN_CROP_SIZE,
                  cfg.BN.NORM_TYPE))
    assert len(seen) == 4


def test_kinetics_recipe_schedule_on_one_gpu():
    """The recipe at ``TRAIN.BATCH_SIZE 8``, ``NUM_GPUS 1``: 358 epochs in 13
    entries, the four shapes with the recipe's BN splits, and the 14 steps
    and LRs of ``steps_with_relative_lrs``."""
    (_, _), (cfg, mg) = both_schedules("kinetics", "one_gpu")
    assert cfg.SOLVER.MAX_EPOCH == 358 and len(mg.schedule) == 13
    assert len(cfg.SOLVER.STEPS) == len(cfg.SOLVER.LRS) == 14
    shapes = []
    for epoch in range(cfg.SOLVER.MAX_EPOCH):
        cfg, changed = mg.update_long_cycle(cfg, epoch)
        if changed:
            shapes.append((cfg.TRAIN.BATCH_SIZE, cfg.DATA.NUM_FRAMES, cfg.DATA.TRAIN_CROP_SIZE,
                           cfg.BN.NORM_TYPE, cfg.BN.NUM_SPLITS))
    assert shapes[:4] == [(64, 8, 158, "sub_batchnorm", 8), (32, 16, 158, "sub_batchnorm", 4),
                          (16, 16, 224, "sub_batchnorm", 2), (8, 32, 224, "batchnorm", 2)]
    assert [round(f * cfg.MULTIGRID.DEFAULT_S) for f in cfg.MULTIGRID.SHORT_CYCLE_FACTORS] == [
        112, 158]


@pytest.mark.parametrize("name,scale", CASES)
def test_eval_and_checkpoint_cadence_match_jax(name, scale):
    (jcfg, jmg), (cfg, mg) = both_schedules(name, scale)
    got, want = [], []
    for epoch in range(cfg.SOLVER.MAX_EPOCH):
        got.append((is_eval_epoch(cfg, epoch, mg.schedule),
                    cu.is_checkpoint_epoch(cfg, epoch, mg.schedule)))
        want.append((jax_is_eval_epoch(jcfg, epoch, jmg.schedule),
                     jcu.is_checkpoint_epoch(jcfg, epoch, jmg.schedule)))
    assert got == want and any(g[0] for g in got) and not all(g[0] for g in got)
    # The last epoch of every shape is an eval and a checkpoint epoch.
    assert all(got[s[-1] - 1] == (True, True) for s in mg.schedule)


@pytest.mark.parametrize("name", ["kinetics", "mg_cfg"])
def test_lr_matches_jax_at_every_epoch_exact(name):
    """The LR at every ``epoch_exact`` of every epoch, an epoch's steps
    counted as ``len`` counts them over a 4,096-clip set at its shape."""
    (jcfg, jmg), (cfg, mg) = both_schedules(name, "one_gpu")
    jcfg.SOLVER.WARMUP_EPOCHS = cfg.SOLVER.WARMUP_EPOCHS = 10.0
    lr, jlr = make_epoch_lr_fn(cfg), jax.jit(jax_lr_fn(jcfg))
    lrs = set()
    for epoch in range(cfg.SOLVER.MAX_EPOCH):
        cfg, _ = mg.update_long_cycle(cfg, epoch)
        steps = 4096 // cfg.TRAIN.BATCH_SIZE
        exact = np.float32(epoch) + np.arange(steps, dtype=np.float32) / np.float32(steps)
        want = np.asarray(jlr(exact))
        got = np.asarray([lr(float(e)) for e in exact])
        np.testing.assert_allclose(got, want, rtol=1e-6, err_msg=str(epoch))
        lrs.update(np.round(got, 9).tolist())
    assert len(lrs) > len(cfg.SOLVER.LRS)


SHORT = ["TRAIN.DATASET", "syntheticvideo", "DATA.SYNTHETIC_SIZE", "64", "TRAIN.BATCH_SIZE", "2",
         "DATA.NUM_FRAMES", "4", "DATA.TRAIN_CROP_SIZE", "32", "MULTIGRID.SHORT_CYCLE", "True",
         "NUM_GPUS", "1", "DATA_LOADER.NUM_WORKERS", "2"]


def short_cfgs(extra=()):
    out = []
    for get, cls in ((jax_get_cfg, JaxSchedule), (get_cfg, MultigridSchedule)):
        cfg = get()
        cfg.merge_from_list(SHORT + list(extra))
        out.append(cls().init_multigrid(cfg))
    return out


def test_short_cycle_batches_match_jax_sharded_loader():
    jcfg, cfg = short_cfgs()
    port = construct_loader(cfg, "train", device="cpu")
    jloader = jax_construct_loader(jcfg, "train")
    assert port.cycle_batches == jloader.cycle_batches == [8, 4, 2]  # crops 16, 23, 32
    for epoch in range(2):
        port.set_epoch(epoch)
        jloader.set_epoch(epoch)
        got, want = port._indices(), list(jloader._indices())
        assert got == want and len(got) == 13
        assert [c for b in got for _, c in b[:1]] == [i % 3 for i in range(13)]
        for (x, y, idx, _, _), (jx, jy, jidx, _, _) in zip(port, jloader):
            assert x[0].numpy().dtype == jx[0].dtype and x[0].shape == jx[0].shape
            np.testing.assert_array_equal(x[0].numpy(), jx[0])
            np.testing.assert_array_equal(y, jy)
            np.testing.assert_array_equal(idx, jidx)


def test_short_cycle_len_counts_full_batches_as_jax_does():
    """``len`` is ``n // B`` (64 // 2), but an epoch of the short cycle has
    13 batches (4 cycles of 8 + 4 + 2 clips, then one of 8): the last step's
    ``epoch_exact`` is 12/32, and an epoch's steps average 3/7 of ``len``
    (B · (4 + 2 + 1) / 3 clips a batch)."""
    jcfg, cfg = short_cfgs(["DATA.SYNTHETIC_SIZE", "4200"])
    port = construct_loader(cfg, "train", device="cpu")
    jloader = jax_construct_loader(jcfg, "train")
    assert len(port) == len(jloader) == 2100
    got, want = len(port._indices()), len(list(jloader._indices()))
    assert got == want == 900 and got / len(port) == pytest.approx(3 / 7)
    jcfg, cfg = short_cfgs()
    port = construct_loader(cfg, "train", device="cpu")
    assert len(port) == 32 and len(port._indices()) == 13


def test_synthetic_items_at_each_cycle_position_match_jax():
    jcfg, cfg = short_cfgs()
    ds, jds = Syntheticvideo(cfg, "train"), JaxSyntheticvideo(jcfg, "train")
    for index in range(4):
        for cycle, crop in enumerate((16, 23, 32)):
            got, want = ds[(index, cycle)], jds[(index, cycle)]
            assert got[0][0].shape == (4, crop, crop, 3)
            np.testing.assert_array_equal(got[0][0], want[0][0])
            assert got[1:3] == want[1:3]


def test_kinetics_items_at_each_cycle_position_match_jax(corpus):  # noqa: F811
    opts = BASE + ["DATA.PATH_TO_DATA_DIR", corpus, "MULTIGRID.SHORT_CYCLE", "True",
                   "DATA.TRAIN_JITTER_SCALES", "[72, 96]"]
    cfgs = []
    for get, cls in ((jax_get_cfg, JaxSchedule), (get_cfg, MultigridSchedule)):
        c = get()
        c.merge_from_list(opts)
        cfgs.append(cls().init_multigrid(c))
    ds, jds = Kinetics(cfgs[1], "train"), JaxKinetics(cfgs[0], "train")
    for index in range(len(ds)):
        for cycle, crop in enumerate((32, 45, 64)):
            seed = sample_seed(cfgs[1].RNG_SEED, 0, index)
            random.seed(seed)
            np.random.seed(seed)
            want = jds[(index, cycle)]
            got = ds[(index, cycle)]
            assert got[0][0].shape == (8, crop, crop, 3)
            same(got[0][0], want[0][0])
            assert got[1:3] == want[1:3]


@pytest.mark.parametrize("dataset", ["charades", "ssv2"])
def test_frame_datasets_refuse_the_short_cycle(frame_root, tmp_path, monkeypatch, dataset):  # noqa: F811
    """JAX's Charades and SSv2 items index their lists with the loader's
    ``(index, cycle)`` pair and fail, so the port refuses their recipes'
    short cycle and trains the long cycle."""
    monkeypatch.setattr(jax_native, "probe_jpeg", lambda path: None)
    jcfg, cfg = frame_cfgs(frame_root, split_dir(frame_root, tmp_path, dataset),
                           ["TRAIN.DATASET", dataset, "MULTIGRID.SHORT_CYCLE", "True",
                            "TRAIN.BATCH_SIZE", "1"])
    MultigridSchedule().init_multigrid(cfg)
    jds = (JaxCharades if dataset == "charades" else JaxSsv2)(jcfg, "train")
    jds[0]
    with pytest.raises(TypeError):
        jds[(0, 0)]
    with pytest.raises(NotImplementedError, match="short-cycle"):
        construct_loader(cfg, "train", device="cpu")
    cfg.MULTIGRID.SHORT_CYCLE = False
    assert len(construct_loader(cfg, "train", device="cpu")) > 0


def test_short_cycle_step_under_sub_batchnorm_matches_jax():
    jcfg, cfg = cfgs_at(2)
    assert cfg.BN.NORM_TYPE == "sub_batchnorm" and cfg.BN.NUM_SPLITS == 4
    state = jax_state(jcfg)
    model, opt = port_at(cfg, state)
    assert {m.num_splits for m in model.modules() if isinstance(m, BatchNorm3D)} == {1, 4}
    hold_step(jcfg, cfg, state, model, opt, *short_cycle_batch(cfg, 2.25, 0))
