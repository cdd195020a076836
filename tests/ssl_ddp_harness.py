"""What the SSL multi-process tests run on the gloo ranks: the port's SSL
step on this rank's rows of each global batch, from a given state, with
given draws, and the kNN probe on a sharded val split. This module imports
no JAX, so the spawned ranks start without it (``ddp_harness``).

A case is ``{"opts", "spe", "num_shards", "starts", "batches", "draws"}``:
the config options, the steps an epoch, the rank layout's host count,
each step's start state in the port's format (``{"model", "opt",
"ssl"}``), each step's global batch (numpy, the global row order) and each
step's draws (``{"perms", "nce"}``: the shuffle-BN permutations, the
global NCE grid). A rank takes the rows ``rank_rows`` gives it (for
``num_shards`` 2 on 2 ranks, ``batch[r::2]``) of the loader's batch,
which is the case's batch read back in the loader's order.
"""

import copy
import os

import numpy as np
import torch

from ddp_harness import WORLD, launch, to_float64
from slowfast_tpu_torch.config import get_cfg
from slowfast_tpu_torch.data.loader import rank_rows
from slowfast_tpu_torch.engine import ssl_steps as tsteps
from slowfast_tpu_torch.models import contrastive as tcon
from slowfast_tpu_torch.models.build import build_model
from slowfast_tpu_torch.solver import optimizer as toptim
from slowfast_tpu_torch.utils import distributed as du


def loader_order(n, num_shards, world=WORLD):
    """The global batch's rows (rank order, the JAX package's global
    order) as the positions of the loader's batch they come from: the
    rank-order concatenation of each rank's ``rank_rows``."""
    return np.concatenate([rank_rows(list(range(n)), r, world, num_shards)
                           for r in range(world)])


def my_rows(x, num_shards):
    """This rank's rows of the loader's batch whose global batch (rank
    order) is ``x``."""
    loader = np.empty_like(x)
    loader[loader_order(len(x), num_shards)] = x
    idx = rank_rows(list(range(len(x))), du.get_rank(), du.get_world_size(), num_shards)
    return loader[idx]


def port_containers(opts):
    """The port's model, optimizer and SSL state of ``opts`` (on the CPU)."""
    cfg = get_cfg()
    cfg.merge_from_list(list(opts))
    model = build_model(cfg, device="cpu")
    opt = toptim.construct_optimizer(model, cfg)
    ssl = tcon.init_ssl_state(cfg, model, torch.Generator().manual_seed(0))
    return cfg, model, opt, ssl


def load(model, opt, ssl, start):
    model.load_state_dict(start["model"], strict=True)
    opt.load_state_dict(start["opt"])
    ssl.load_state_dict(start["ssl"])


def float64_containers(cfg, model, ssl):
    """The model, a fresh optimizer and the SSL state in float64."""
    to_float64(model)
    for n in tcon.SSLState.TENSORS:
        if getattr(ssl, n) is not None:
            setattr(ssl, n, getattr(ssl, n).double())
    if ssl.hist is not None:
        to_float64(ssl.hist)
    return type(toptim.construct_optimizer(model, cfg))(model, cfg)


def run_case(case, float64=False):
    """Each step of ``case`` from its start state on this rank's rows:
    ``[{"loss", "lr", "grads", "model", "opt", "ssl"}]``, the gradients as
    the optimizer sees them (averaged over the ranks). ``float64``: the
    model, SSL state and batches in float64."""
    cfg, model, opt, ssl = port_containers(case["opts"])
    if float64:
        opt = float64_containers(cfg, model, ssl)
    step = tsteps.make_ssl_train_step(cfg, model, opt, ssl, case["spe"],
                                      torch.Generator().manual_seed(0))
    step.keep_grads = True
    shuffle, sample = tsteps.shuffle_permutation, tcon.nce_sample_indices
    ns = case["num_shards"]
    out = []
    try:
        for start, batch, draws in zip(case["starts"], case["batches"], case["draws"]):
            load(model, opt, ssl, start)
            perms = [torch.from_numpy(p).long() for p in draws["perms"]]
            tsteps.shuffle_permutation = lambda n, g: perms.pop(0)
            ci, ti = draws["nce"]
            tcon.nce_sample_indices = lambda *a, **k: (torch.from_numpy(ci).long(),
                                                       torch.from_numpy(ti))
            dtype = np.float64 if float64 else np.float32
            local = {"inputs": [torch.from_numpy(my_rows(batch["inputs"], ns).astype(dtype))],
                     "inputs2": [torch.from_numpy(my_rows(batch["inputs2"], ns).astype(dtype))],
                     "index": torch.from_numpy(my_rows(batch["index"], ns)).long(),
                     "time": torch.from_numpy(my_rows(batch["time"], ns))}
            m = step(local)
            out.append({"loss": m["loss"].item(), "lr": m["lr"], "grads": step.last_grads,
                        "model": {k: v.clone() for k, v in model.state_dict().items()},
                        "opt": copy.deepcopy(opt.state_dict()), "ssl": ssl.state_dict()})
    finally:
        tsteps.shuffle_permutation, tcon.nce_sample_indices = shuffle, sample
    return out


def knn_run(case):
    """The kNN probe of the case's first start state on this rank's rows
    of the val batches (the last one padded for the ranks, as the loader
    pads it), and in one process when the world is 1."""
    cfg, model, opt, ssl = port_containers(case["opts"])
    load(model, opt, ssl, case["starts"][0])
    world, rank = du.get_world_size(), du.get_rank()
    val = []
    for x, y in case["knn_val"]:
        n = len(y)
        pad = list(range(n)) + [n - 1] * (-n % world)
        pos = rank_rows(list(range(len(pad))), rank, world, 1)
        rows = [pad[p] for p in pos]
        val.append(([torch.from_numpy(x[rows])], y[rows], None, None,
                    {"num_real": sum(p < n for p in pos)}))
    return tsteps.knn_eval(cfg, model, ssl, case["knn_labels"], val)


def rank_cases(case_file, out_dir, device):
    """Each case in fp32 and in float64, and its kNN probe, on one torch
    thread: the suite runs several workers on a few cores, and a rank's
    share of them oversubscribes the cores."""
    torch.set_num_threads(1)
    cases = torch.load(case_file, weights_only=False)
    out = {name: run_case(case) for name, case in cases.items()}
    out.update({(name, "float64"): run_case(case, float64=True) for name, case in cases.items()})
    out.update({(name, "knn"): knn_run(case) for name, case in cases.items()
                if "knn_val" in case})
    torch.save(out, os.path.join(out_dir, f"rank{du.get_rank()}.pt"))


def spawned_cases(tmp_dir, cases):
    """``rank_cases`` of ``cases`` on 2 gloo ranks; returns each rank's."""
    case_file = os.path.join(str(tmp_dir), "cases.pt")
    torch.save(cases, case_file)
    launch(tmp_dir, rank_cases, case_file, str(tmp_dir))
    return [torch.load(os.path.join(str(tmp_dir), f"rank{r}.pt"), weights_only=False)
            for r in range(WORLD)]
