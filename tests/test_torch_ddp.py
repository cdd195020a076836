"""Data-parallel training of the port on 2 gloo ranks, on the CPU: narrow
SlowFast (R18 at width 8, 16 frames of 64², every parameter and BN
statistic seeded random) trained 3 fp32 SGD steps (Nesterov momentum,
weight decay, the cosine LR) on global batches of 4 clips, each rank on
its 2.

* Against the JAX package's ``make_train_step`` on a 2-device ``data``
  mesh (``create_mesh`` on ``jax.devices()[:2]``), the same global batches
  and variables, each port step from JAX's state before it, as the
  SlowFast trajectory test steps (run free, fp32 SlowFast parts from its
  own float64 run by 7e-4 in loss at the third step): the loss (the ranks'
  mean) within rtol 1e-5, the parameters and BN statistics after each
  step within 1e-4 relative L2.
* Against the port's step in one process on the whole global batch,
  each 2-rank step from the one process's state before it: the loss, the
  gradients and the parameters and BN statistics after the step within
  1e-6 (relative, relative L2). A fp32 miss is decided by the same steps
  in float64, as the trajectory tests decide ReLU and max-pool flips
  (ROADMAP Queue 3 #4, #5, #24): the two float64 steps agree within 1e-10
  (the loss, taken in fp32, within 2e-7), and each fp32 step is within
  5e-2 of its float64 step. (The first step's gradients differ by 4e-6 in
  fp32 and by 8e-15 in float64.)

The ranks run in one spawn for the file (``ddp_harness``); JAX is imported
inside the tests only.
"""

import numpy as np
import pytest

from ddp_harness import check_one_process, port_cfg, spawned_train_runs, train_run
from ddp_harness import one_torch_thread  # noqa: F401  (autouse fixture)

STEPS = 3
CLIPS = 4  # a global batch
SGD = ["SOLVER.OPTIMIZING_METHOD", "sgd", "SOLVER.NESTEROV", "True", "SOLVER.MOMENTUM", "0.9",
       "SOLVER.WEIGHT_DECAY", "1e-4", "SOLVER.BASE_LR", "0.01", "SOLVER.WARMUP_EPOCHS", "0.0",
       "SOLVER.LR_POLICY", "cosine", "SOLVER.MAX_EPOCH", "2", "MODEL.DROPOUT_RATE", "0.0",
       "MIXUP.ENABLE", "False", "TRAIN.BATCH_SIZE", str(CLIPS), "TPU.COMPUTE_DTYPE", "float32"]


def slowfast_opts():
    from test_torch_slowfast_train import NARROW, flagship_opts

    return flagship_opts() + NARROW + SGD + ["DATA.NUM_FRAMES", "16",
                                             "DATA.TRAIN_CROP_SIZE", "64"]


def uint8_batches(cfg, classes, seed, steps=STEPS, clips=CLIPS):
    rng = np.random.RandomState(seed)
    crop, t = cfg.DATA.TRAIN_CROP_SIZE, cfg.DATA.NUM_FRAMES
    return [{"inputs": [rng.randint(0, 256, (clips, t, crop, crop, 3)).astype(np.uint8)],
             "labels": rng.randint(0, classes, (clips,)), "epoch_exact": 0.1 * (i + 1)}
            for i in range(steps)]


def spawn_cases(tmp_dir, cases, float64=True):
    """Each case's steps (``{name: (opts, batches, jax_run, extra)}``) in
    one process (run free in fp32, and for the cases that ``float64``
    names, or all when it is True, each step again in float64 from the
    fp32 run's state) and on 2 ranks (each step from JAX's state, and from
    the one process's in fp32 and in float64), all in one spawn."""
    runs, spawned = {}, {}
    for name, (opts, batches, jax_run, extra) in cases.items():
        case = {"opts": opts, "state": jax_run["starts"][0][0], "batches": batches, **extra}
        one = train_run(**case)
        runs[name] = {"jax_run": jax_run, "one_process": one, "one_process64": None,
                      "one64": None}
        spawned.update({(name, "jax"): dict(case, starts=jax_run["starts"]),
                        (name, "one"): dict(case, starts=one["starts"])})
        if float64 is True or name in (float64 or ()):
            runs[name]["one_process64"] = train_run(**case, float64=True, starts=one["starts"])
            spawned[(name, "one64")] = dict(case, starts=one["starts"], float64=True)
    ranks = spawned_train_runs(tmp_dir, spawned)
    for name, kind in spawned:
        runs[name][kind] = [r[(name, kind)] for r in ranks]
    return runs


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from ddp_jax import jax_cfg, jax_variables, mesh_run

    opts = slowfast_opts()
    jcfg = jax_cfg(opts)
    batches = uint8_batches(port_cfg(opts), 16, 5)
    jax_run = mesh_run(jcfg, jax_variables(jcfg, 11), batches)
    return spawn_cases(tmp_path_factory.mktemp("ddp"),
                       {"slowfast": (opts, batches, jax_run, {})})["slowfast"]


def test_two_ranks_match_jax_on_a_two_device_mesh(runs):
    from ddp_jax import check_jax_steps

    assert check_jax_steps(runs["jax"], runs["jax_run"]) > 1e-4  # the steps train


def test_two_ranks_match_one_process(runs):
    check_one_process(runs["one"], runs["one_process"], runs["one64"], runs["one_process64"])
