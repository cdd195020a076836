"""What the multi-process tests share: running a function on gloo ranks on
the CPU through the port's launcher, and one train run of the port's step.

A test module puts its rank function at module level and imports JAX only
inside its test functions, so the spawned ranks, which import the module
to find the function, start without JAX. The ranks meet through a file
(``file://``) under the test's temporary directory, so concurrent test
workers never share a port. This module imports no JAX.
"""

import copy
import functools
import os

import numpy as np
import pytest
import torch

from slowfast_tpu_torch.config import get_cfg
from slowfast_tpu_torch.data.loader import rank_rows
from slowfast_tpu_torch.engine.steps import make_train_step
from slowfast_tpu_torch.models.build import build_model
from slowfast_tpu_torch.solver.optimizer import construct_optimizer
from slowfast_tpu_torch.utils import distributed as du
from slowfast_tpu_torch.utils.multiprocessing import launch_job

WORLD = 2


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread in the test process while a module runs (as
    tests/test_torch_train.py's fixture, without its JAX import), and so one
    a spawned rank: the suite runs several workers on a few cores, and
    their ranks oversubscribe them otherwise."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def launch(tmp_dir, func, *args, world=WORLD):
    """Run ``func(*args, device)`` on ``world`` gloo ranks (one host)."""
    cfg = get_cfg()
    cfg.NUM_GPUS = world
    cfg.INIT_METHOD = "file://" + os.path.join(str(tmp_dir), "rendezvous")
    launch_job(cfg, "cpu", functools.partial(_drop_cfg, func, *args))


def _drop_cfg(func, *args):
    cfg, device = args[-2:]
    return func(*args[:-2], device)


def local_rows(x):
    """This rank's rows of a global batch (the loader's layout on one
    host)."""
    if x is None or du.get_world_size() == 1:
        return x
    idx = rank_rows(list(range(x.shape[0])), du.get_rank(), du.get_world_size(), 1)
    return x[idx[0]:idx[-1] + 1]


def port_cfg(opts, yaml=None):
    cfg = get_cfg()
    if yaml:
        cfg.merge_from_file(yaml)
    cfg.merge_from_list(list(opts))
    return cfg


def to_float64(model):
    """``model`` in float64, its compute dtypes too."""
    model.double()
    for m in model.modules():
        if isinstance(getattr(m, "dtype", None), torch.dtype):
            m.dtype = torch.float64
    return model


def pathways64(cfg, x):
    """The float64 pathways of a uint8 clip batch (the preprocess's fp32
    scale and bias, the sums in float64)."""
    from slowfast_tpu_torch.engine.steps import num_pathways
    from slowfast_tpu_torch.ops.preprocess import scale_bias, slow_index

    scale, bias = (v.astype(np.float64) for v in scale_bias(cfg.DATA.MEAN, cfg.DATA.STD))
    fast = x.astype(np.float64) * scale + bias
    if num_pathways(cfg) == 1:
        return [fast]
    return [fast[:, slow_index(x.shape[1], cfg.SLOWFAST.ALPHA)], fast]


def as_float64(cfg, batch):
    """``batch`` with its clips as float64 pathways and its float arrays in
    float64."""
    out = {}
    for k, v in batch.items():
        if k == "inputs":
            v = (pathways64(cfg, v[0]) if v[0].dtype == np.uint8
                 else [x.astype(np.float64) for x in v])
        elif isinstance(v, np.ndarray) and v.dtype.kind == "f":
            v = v.astype(np.float64)
        out[k] = v
    return out


def train_run(opts, state, batches, draws=None, float64=False, starts=None, yaml=None):
    """Steps of ``make_train_step`` on this rank's rows of each global batch
    from ``state``. Returns each step's loss (this rank's), its gradients
    (as the optimizer sees them), the ``(model state, optimizer state)`` it
    started from and the model state after it. ``draws``: mixup's draws of
    each step, in place of the generator's. ``float64``: the model and the
    batches in float64. ``starts``: each step's ``(model state, optimizer
    state)``, in place of the step before's. ``yaml``: merged before
    ``opts``."""
    from slowfast_tpu_torch.data import mixup

    cfg = port_cfg(opts, yaml)
    model = build_model(cfg, device="cpu")
    model.load_state_dict(state, strict=True)
    if float64:
        to_float64(model)
        batches = [as_float64(cfg, b) for b in batches]
    optimizer = construct_optimizer(model, cfg)
    grads, update = [], optimizer.step

    def recording(lr):
        grads.append({n: p.grad.detach().clone() for n, p in model.named_parameters()
                      if p.grad is not None})
        return update(lr)

    optimizer.step = recording
    step = make_train_step(cfg, model, optimizer, torch.Generator().manual_seed(cfg.RNG_SEED))
    pending = list(draws or [])
    mix_draws = mixup.mix_draws
    if draws is not None:
        mixup.mix_draws = lambda *a, **k: pending.pop(0)
    out = {"loss": [], "grads": grads, "starts": [], "states": []}
    try:
        for i, batch in enumerate(batches):
            if starts is not None:
                model.load_state_dict(starts[i][0], strict=True)
                optimizer.load_state_dict(starts[i][1])
            out["starts"].append((state_of(model), copy.deepcopy(optimizer.state_dict())))
            local = {k: ([torch.from_numpy(local_rows(x)) for x in v] if k == "inputs"
                         else v if k == "epoch_exact" else torch.from_numpy(local_rows(v)))
                     for k, v in batch.items()}
            out["loss"].append(step(local)["loss"].item())
            out["states"].append(state_of(model))
    finally:
        mixup.mix_draws = mix_draws
    return out


def state_of(model):
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def rank_train_runs(case_file, out_dir, device):
    """A rank's ``train_run`` of every case in ``case_file``, saved to
    ``out_dir/rank{r}.pt``."""
    cases = torch.load(case_file, weights_only=False)
    out = {name: train_run(**case) for name, case in cases.items()}
    torch.save(out, os.path.join(out_dir, f"rank{du.get_rank()}.pt"))


def spawned_train_runs(tmp_dir, cases):
    """``train_run`` of each case on 2 gloo ranks; returns each rank's."""
    case_file = os.path.join(str(tmp_dir), "cases.pt")
    torch.save(cases, case_file)
    launch(tmp_dir, rank_train_runs, case_file, str(tmp_dir))
    return [torch.load(os.path.join(str(tmp_dir), f"rank{r}.pt"), weights_only=False)
            for r in range(WORLD)]


def rel_l2(got, want, names=None):
    names = list(want) if names is None else names
    if not names:
        return 0.0
    diff = torch.cat([(got[n].double() - want[n].double()).flatten() for n in names])
    return (diff.norm() / torch.cat([want[n].double().flatten() for n in names]).norm()).item()


def params_and_buffers(state):
    """The names of a ``state_dict``'s parameters and of its BN running
    statistics."""
    return ([n for n in state if "running_" not in n and "num_batches" not in n],
            [n for n in state if "running_" in n])


def global_loss(ranks, key="loss"):
    """Each step's loss of a run on several ranks: the ranks' mean."""
    return np.mean([r[key] for r in ranks], axis=0)


# How close two float64 runs of the same step are: the step takes its loss
# in fp32, so the loss differs by that rounding.
EXACT_TOL = {"loss": 2e-7, "grads": 1e-10, "params": 1e-10, "buffers": 1e-10}


def check_one_process(ranks, one, ranks64, one64, tol=1e-6, exact_tol=EXACT_TOL,
                      flip_tol=5e-2):
    """Steps on several ranks against the same steps in one process, each
    from the one process's state before it: the loss, the gradients and
    the parameters and BN statistics after the step within ``tol``
    (relative; gradients and states relative L2). A fp32 miss is decided by
    the same steps in float64 from the same states (``ranks64``,
    ``one64``), as the trajectory tests decide ReLU and max-pool flips
    (ROADMAP Queue 3 #4, #5, #24): there the two agree within
    ``exact_tol``, and each fp32 step's departure from its float64 step is
    within ``flip_tol``. Without float64 runs every step must hold in
    fp32. Returns the misses that float64 decided."""
    def errs(rk, on):
        params, buffers = params_and_buffers(on["states"][0])
        loss = np.abs(global_loss(rk) - np.asarray(on["loss"])) / np.abs(on["loss"])
        return [{"loss": loss[s],
                 "grads": max(rel_l2(r["grads"][s], on["grads"][s]) for r in rk),
                 "params": max(rel_l2(r["states"][s], on["states"][s], params) for r in rk),
                 "buffers": max(rel_l2(r["states"][s], on["states"][s], buffers) for r in rk)}
                for s in range(len(on["loss"]))]

    for r in ranks + (ranks64 or []):  # the same gradients reach the optimizer
        assert all(sorted(g) == sorted(w) for g, w in zip(r["grads"], one["grads"]))
    decided = []
    for s, got in enumerate(errs(ranks, one)):
        missed = {k: v for k, v in got.items() if v > tol}
        if not missed:
            continue
        assert ranks64 is not None, (s, missed)
        decided.append((s, missed))
        exact = errs(ranks64, one64)[s]
        assert all(v <= exact_tol[k] for k, v in exact.items()), (s, exact)
        flips = [errs([r], r64)[s] for r, r64 in zip(ranks, ranks64)] + [errs([one], one64)[s]]
        assert all(v <= flip_tol for f in flips for v in f.values()), (s, flips)
    return decided
