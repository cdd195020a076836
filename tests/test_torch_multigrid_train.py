"""Multigrid training through the port's ``run_net`` against the JAX
package, on the CPU.

``SLOWFAST_8x8_R50_stepwise_multigrid.yaml`` narrowed as
``tests/test_torch_slowfast_train.py``'s ``NARROW`` (depth 18, width 8),
16 frames of 32², 16 classes, ``TRAIN.BATCH_SIZE`` 2, ``BN_BASE_SIZE`` 2
(so the BN splits step 8, 4, 2, 1 as the recipe's do on one GPU) and a
schedule shrunk to 6 epochs (``SOLVER.STEPS [0, 3]``, ``MAX_EPOCH`` 4) on 64
synthetic clips: the four long-cycle shapes (16, 4, 23), (8, 8, 23), (4, 8,
32), (2, 16, 32), each epoch one or more full short cycles.

* Every step's clip shape, BN splits, LR and ``epoch_exact`` equal what the
  JAX trainer feeds its step on the same schedule (its step, eval step,
  precise BN and checkpoint writer replaced by recorders); auto-resume from
  the third epoch's checkpoint continues on that epoch's shape, with the
  same steps as the run it resumes.
* The first step after a long-cycle transition (the model rebuilt with 2
  splits by ``carry_over``, holding the parameters, BN buffers and
  momentum) against JAX's ``make_train_step`` from the same state: the loss
  within 1e-5, and the change and momentum within ``STEP_TOL`` or a flip
  decided by JAX's float64 step, as in the 30-step trajectory
  (``hold_step``; ``tests/test_torch_multigrid.py`` holds a short-cycle
  step under ``sub_batchnorm`` with it).
"""

import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import slowfast_tpu.engine.precise_bn as jax_precise_bn
import slowfast_tpu.engine.trainer as jtrainer
from slowfast_tpu.config import get_cfg as jax_get_cfg
from slowfast_tpu.engine.steps import TrainState
from slowfast_tpu.engine.steps import make_train_step as jax_make_train_step
from slowfast_tpu.models import build as jax_build
from slowfast_tpu.models import build_model as jax_build_model
from slowfast_tpu.models.build import init_model
from slowfast_tpu.solver import optimizer as joptim
from slowfast_tpu.solver.optimizer import make_epoch_lr_fn as jax_lr_fn
from slowfast_tpu.utils import checkpoint as jcu
from slowfast_tpu.utils.multigrid import MultigridSchedule as JaxSchedule
from slowfast_tpu_torch.config import get_cfg
from slowfast_tpu_torch.engine import trainer as ttrainer
from slowfast_tpu_torch.engine.steps import make_train_step
from slowfast_tpu_torch.models.batchnorm import BatchNorm3D
from slowfast_tpu_torch.models.build import build_model
from slowfast_tpu_torch.run_net import main as run_net_main
from slowfast_tpu_torch.solver import optimizer as toptim
from slowfast_tpu_torch.utils.checkpoint import state_dict_from_jax
from slowfast_tpu_torch.utils.multigrid import MultigridSchedule
from test_torch_contrastive import jax_float64, to_float64
from test_torch_slowfast import randomize
from test_torch_slowfast_train import (FLIP_TOL, NARROW, STEP_TOL, EXACT_TOL, jax_trace,
                                      pathways64, port_step64, rel_l2, step_values)
from test_torch_train import one_torch_thread  # noqa: F401  (autouse fixture)

YAML = os.path.join(os.path.dirname(__file__), "..", "configs", "Kinetics",
                    "SLOWFAST_8x8_R50_stepwise_multigrid.yaml")
MG = NARROW + [
    "DATA.NUM_FRAMES", "16", "DATA.TRAIN_CROP_SIZE", "32", "DATA.TEST_CROP_SIZE", "32",
    "MODEL.NUM_CLASSES", "16", "NUM_GPUS", "1", "TRAIN.BATCH_SIZE", "2",
    "MULTIGRID.BN_BASE_SIZE", "2", "SOLVER.STEPS", "[0, 3]", "SOLVER.LRS", "[1, 0.1]",
    "SOLVER.MAX_EPOCH", "4", "SOLVER.WARMUP_EPOCHS", "1.0", "SOLVER.BASE_LR", "0.01",
    "TPU.COMPUTE_DTYPE", "float32",
    "TRAIN.DATASET", "syntheticvideo", "DATA.SYNTHETIC_SIZE", "64", "TEST.ENABLE", "False",
    "BN.NUM_BATCHES_PRECISE", "2", "DATA_LOADER.NUM_WORKERS", "2", "TPU.MESH_DATA", "1"]


def mg_cfg(get, extra=()):
    cfg = get()
    cfg.merge_from_file(YAML)
    cfg.merge_from_list(MG + list(extra))
    return cfg


def port_recorder(monkeypatch):
    """Record ``(clip shape, BN splits, lr, epoch_exact)`` of every step the
    port's trainer takes."""
    seen = []
    real = ttrainer.make_train_step

    def make(cfg, model, optimizer, generator=None):
        step = real(cfg, model, optimizer, generator)
        splits = max(m.num_splits for m in model.modules() if isinstance(m, BatchNorm3D))

        def run(batch):
            m = step(batch)
            seen.append((tuple(batch["inputs"][0].shape), splits, m["lr"], batch["epoch_exact"]))
            return m
        return run

    monkeypatch.setattr(ttrainer, "make_train_step", make)
    return seen


def jax_recorder(monkeypatch, cfg):
    """Run the JAX trainer on ``cfg`` with its step recording what it is fed,
    and no compute: returns the records."""
    seen = []
    lr_fn = []

    def make_step(cfg, model, tx, **kwargs):
        if not lr_fn:
            lr_fn.append(jax_lr_fn(cfg))
        splits = cfg.BN.NUM_SPLITS if cfg.BN.NORM_TYPE == "sub_batchnorm" else 1

        def step(state, batch, rng):
            exact = float(batch["epoch_exact"])
            lr = float(lr_fn[0](exact))
            seen.append((tuple(batch["inputs"][0].shape), splits, lr, exact))
            return state, {"loss": jnp.zeros(()), "lr": jnp.asarray(lr)}
        return step

    def make_eval(cfg, model, **kwargs):
        return lambda state, batch: jnp.zeros((batch["inputs"][0].shape[0], 16))

    shapes = []

    def zeros_init(model, cfg, rng=None, train=False):
        # The variables' shapes only: the recorder computes nothing.
        if not shapes:
            shapes.append(jax.eval_shape(lambda: init_model(model, cfg, rng=rng, train=train)))
        return jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), shapes[0])

    monkeypatch.setattr(jax_build, "init_model", zeros_init)
    monkeypatch.setattr(jtrainer, "make_train_step", make_step)
    monkeypatch.setattr(jtrainer, "make_eval_step", make_eval)
    monkeypatch.setattr(jax_precise_bn, "compute_precise_bn_stats", lambda c, m, state, *a: state)
    monkeypatch.setattr(jcu, "save_checkpoint", lambda *a, **k: None)
    monkeypatch.setattr(jcu, "load_train_checkpoint", lambda cfg, state: (state, 0))
    jtrainer.train(cfg)
    return seen


def run_port(tmp_path, monkeypatch):
    seen = port_recorder(monkeypatch)
    run_net_main(["--device", "cpu", "--cfg", YAML, "--opts", *MG, "OUTPUT_DIR", str(tmp_path)])
    return seen


def test_steps_match_the_jax_trainer_and_resume_lands_on_the_shape(tmp_path, monkeypatch):
    got = run_port(tmp_path, monkeypatch)
    (tmp_path / "jax").mkdir()
    want = jax_recorder(monkeypatch, mg_cfg(jax_get_cfg, ["OUTPUT_DIR", str(tmp_path / "jax")]))
    assert [g[:2] for g in got] == [w[:2] for w in want] and len(got) == 37
    np.testing.assert_allclose([g[2:] for g in got], [w[2:] for w in want], rtol=1e-6)
    # The four long-cycle shapes, each with its short cycle's crops: a
    # shape's epoch stops at the first batch its clips cannot fill.
    by_shape = {}
    for (b, t, s, _, _), splits, _, _ in got:
        by_shape.setdefault(t, set()).add((b, s, splits))
    assert by_shape == {4: {(32, 16, 8), (16, 23, 8)},
                        8: {(16, 16, 4), (8, 23, 4), (16, 16, 2), (8, 23, 2), (4, 32, 2)},
                        16: {(8, 16, 1), (4, 23, 1), (2, 32, 1)}}
    # The LR of the step before and after each transition: the schedule's
    # LRS (8, 4, 2, 0.1 of BASE_LR 0.01), warm-up over the first epoch.
    lrs = {round(g[3], 4): g[2] for g in got}
    assert lrs[0.0] == pytest.approx(0.01) and lrs[0.5] == pytest.approx(0.045)
    assert [lrs[e] for e in (1.5, 2.0, 3.625, 4.0, 4.3125, 5.0)] == pytest.approx(
        [0.08, 0.04, 0.04, 0.02, 0.02, 0.001])
    # Auto-resume from epoch 3's checkpoint: epoch 4 on (8, 8, 23), the
    # steps of the run it resumes.
    for path in glob.glob(str(tmp_path / "checkpoints" / "checkpoint_epoch_0000[4-6].pyth")):
        os.remove(path)
    got.clear()
    run_net_main(["--device", "cpu", "--cfg", YAML, "--opts", *MG, "OUTPUT_DIR", str(tmp_path)])
    resumed = [w for w in want if w[3] >= 3.0]
    assert got[0][:2] == ((16, 8, 16, 16, 3), 4)
    assert [g[:2] for g in got] == [w[:2] for w in resumed]
    np.testing.assert_allclose([g[2:] for g in got], [w[2:] for w in resumed], rtol=1e-6)


_COMPILED = {}


def jax_step(jcfg, state, batch, float64=False):
    """JAX's train step on ``jcfg`` from ``state`` (compiled once a config
    and precision; fp32 at XLA's optimization level 0); returns the new
    state and metrics as numpy."""
    def up(a):
        a = np.asarray(a)
        return a.astype(np.float64) if float64 and np.issubdtype(a.dtype, np.floating) else a

    state, batch = jax.tree.map(up, state), jax.tree.map(up, batch)
    key = (jcfg.dump(), float64)
    with jax_float64() if float64 else _nothing():
        if key not in _COMPILED:
            tx, _ = joptim.construct_optimizer(state.params, jcfg, 8)
            step = jax_make_train_step(jcfg, jax_build_model(jcfg), tx, donate=False,
                                       epoch_in_batch=True)
            lowered = step.lower(state, batch, jax.random.PRNGKey(0))
            _COMPILED[key] = lowered.compile() if float64 else lowered.compile(
                compiler_options={"xla_backend_optimization_level": "0"})
        new, metrics = _COMPILED[key](state, batch, jax.random.PRNGKey(0))
    return jax.tree.map(np.asarray, new), jax.tree.map(np.asarray, metrics)


class _nothing:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def cfgs_at(epoch):
    """The JAX and port configs of ``epoch``'s long-cycle shape, dropout off."""
    out = []
    for get, cls in ((jax_get_cfg, JaxSchedule), (get_cfg, MultigridSchedule)):
        cfg = mg_cfg(get, ["MODEL.DROPOUT_RATE", "0.0"])
        mg = cls()
        cfg = mg.init_multigrid(cfg)
        cfg, _ = mg.update_long_cycle(cfg, epoch)
        out.append(cfg)
    return out


def jax_state(jcfg):
    """Seeded random variables and a seeded random momentum."""
    shapes = jax.eval_shape(lambda: init_model(jax_build_model(jcfg), jcfg,
                                               rng=jax.random.PRNGKey(0), train=False))
    v = randomize(dict(shapes), 5)
    rs = np.random.RandomState(6)
    trace = jax.tree.map(lambda p: rs.normal(0.0, 1e-2, p.shape).astype(np.float32), v["params"])
    tx, _ = joptim.construct_optimizer(v["params"], jcfg, 8)
    opt_state = jax.tree_util.tree_map(
        lambda s: s._replace(trace=trace) if isinstance(s, optax.TraceState) else s,
        tx.init(v["params"]), is_leaf=lambda s: isinstance(s, optax.TraceState))
    return TrainState(step=jnp.asarray(20, jnp.int32), params=v["params"],
                      batch_stats=v["batch_stats"], opt_state=opt_state)


def short_cycle_batch(cfg, epoch_exact, seed):
    """A batch at short-cycle position 0: ``4·B`` clips of ``T × 16²``."""
    rs = np.random.RandomState(seed)
    n = 4 * cfg.TRAIN.BATCH_SIZE
    x = rs.randint(0, 256, (n, cfg.DATA.NUM_FRAMES, 16, 16, 3)).astype(np.uint8)
    return x, rs.randint(0, 16, (n,)), epoch_exact


def hold_step(jcfg, cfg, state, model, opt, x, y, epoch_exact):
    """The port's step (``model``, ``opt`` holding ``state``) against JAX's
    from ``state``; a flip is decided by JAX's float64 step."""
    before = state_dict_from_jax({"params": state.params, "batch_stats": state.batch_stats})
    jbatch = {"inputs": [jnp.asarray(x)], "labels": jnp.asarray(y),
              "epoch_exact": jnp.asarray(epoch_exact, jnp.float32)}
    new, jm = jax_step(jcfg, state, jbatch)
    m = make_train_step(cfg, model, opt)({"inputs": [torch.from_numpy(x)],
                                          "labels": torch.from_numpy(y),
                                          "epoch_exact": epoch_exact})
    np.testing.assert_allclose(m["loss"].item(), float(jm["loss"]), rtol=1e-5)
    np.testing.assert_allclose(m["lr"], float(jm["lr"]), rtol=1e-6)
    names = [n for n, _ in model.named_parameters()]
    sd = model.state_dict()
    want = state_dict_from_jax({"params": new.params, "batch_stats": new.batch_stats})
    for k in want:
        if "running_" in k:
            np.testing.assert_allclose(sd[k].numpy(), want[k].numpy(), atol=1e-4, err_msg=k)
    got = step_values(names, before, sd, dict(zip(opt.names, opt.trace)))
    ref = step_values(names, before, want, state_dict_from_jax({"params": jax_trace(new.opt_state)}))
    far = max(rel_l2(a, b, names) for a, b in zip(got, ref))
    if far <= STEP_TOL:
        return far
    new64, _ = jax_step(jcfg, state, jbatch, float64=True)
    exact = step_values(names, before, state_dict_from_jax({"params": new64.params}),
                        state_dict_from_jax({"params": jax_trace(new64.opt_state)}))
    m64 = to_float64(build_model(cfg, device="cpu"))
    opt64 = toptim.construct_optimizer(m64, cfg)
    opt_state = {"count": int(state.step), "trace": state_dict_from_jax(
        {"params": jax_trace(state.opt_state)})}
    port64 = step_values(names, before, *port_step64(m64, opt64, before, opt_state,
                                                     pathways64(cfg, x), y, m["lr"]))
    assert max(rel_l2(a, b, names) for a, b in zip(port64, exact)) <= EXACT_TOL
    departs = [max(rel_l2(a, b, names) for a, b in zip(v, exact)) for v in (got, ref)]
    assert far <= FLIP_TOL and max(departs) <= FLIP_TOL, (far, departs)
    return far


def port_at(cfg, state):
    model = build_model(cfg, device="cpu")
    model.load_state_dict(state_dict_from_jax({"params": state.params,
                                               "batch_stats": state.batch_stats}), strict=True)
    opt = toptim.construct_optimizer(model, cfg)
    opt.load_state_dict({"count": int(state.step), "trace": state_dict_from_jax(
        {"params": jax_trace(state.opt_state)})})
    return model, opt


def test_step_after_a_long_cycle_transition_carries_the_state():
    """The port trains at shape (8, 8, 23) with 4 splits, moves to (4, 8,
    32) with 2 through ``carry_over`` and steps; JAX steps from the same
    state at the new shape."""
    jcfg, cfg = cfgs_at(2)
    state = jax_state(jcfg)
    model, opt = port_at(cfg, state)
    mg = MultigridSchedule()
    cfg = mg.init_multigrid(mg_cfg(get_cfg, ["MODEL.DROPOUT_RATE", "0.0"]))
    cfg, _ = mg.update_long_cycle(cfg, 2)
    cfg, changed = mg.update_long_cycle(cfg, 4)
    jcfg, _ = cfgs_at(4)
    assert changed and cfg.BN.NUM_SPLITS == 2 and cfg.TRAIN.BATCH_SIZE == 4
    model, opt = ttrainer.carry_over(cfg, model, opt, "cpu")
    assert {m.num_splits for m in model.modules() if isinstance(m, BatchNorm3D)} == {1, 2}
    trace = dict(zip(opt.names, opt.trace))
    want = state_dict_from_jax({"params": jax_trace(state.opt_state)})
    assert all(torch.equal(trace[n], want[n]) for n in want) and opt.count == 20
    hold_step(jcfg, cfg, state, model, opt, *short_cycle_batch(cfg, 4.0, 1))


@pytest.fixture(autouse=True)
def _free_compiled():
    yield
    _COMPILED.clear()
