"""The launcher: one process per device (counterpart of tools/run_net.py's
``launch_job`` and slowfast_tpu/parallel/mesh.py:20; reference
slowfast/utils/multiprocessing.py).

A job of ``NUM_SHARDS · NUM_GPUS`` ranks runs ``NUM_GPUS`` of them on each
host (shard), each started with ``torch.multiprocessing.spawn``: a rank
joins the process group (``utils/distributed.init_distributed``), takes
``cuda:local_rank`` (or the CPU over gloo) and runs the job's function. A
rank that raises makes the whole launch raise: ``spawn`` stops the other
ranks and re-raises the error in the launching process.

Each launch meets at a rendezvous of its own. torch's file store needs a
fresh, empty file for each group, and ``run_net`` launches training and
then the test on one ``INIT_METHOD``: a ``file://`` method gets the
launch's number as a suffix (the same on every shard, which launch in the
same order), and on one shard a file that an earlier group left behind is
removed before and after the launch. A store file left with the last
group's addresses sends the next group's ranks to ports no one listens
on. A ``tcp://`` method is used as given.
"""

import itertools
import os

import torch
import torch.multiprocessing as mp

from . import distributed as du


def run(local_rank, func, cfg, device):
    """One rank: join the group, run ``func(cfg, rank_device)``, leave."""
    if torch.device(device).type == "cpu":  # the host's cores shared by its ranks
        torch.set_num_threads(max(1, torch.get_num_threads() // max(cfg.NUM_GPUS, 1)))
    rank_device = du.init_distributed(cfg, local_rank, device)
    try:
        return func(cfg, rank_device)
    finally:
        du.destroy()


def check_devices(cfg, device):
    """Raise unless this host has a card for each of its ``NUM_GPUS``
    ranks (the CPU runs any number over gloo)."""
    if torch.device(device).type != "cuda":
        return
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cfg.NUM_GPUS > have:
        raise RuntimeError(f"NUM_GPUS {cfg.NUM_GPUS} asks for more cards than this host "
                           f"has ({have}); set NUM_GPUS to at most {have}, or run on the "
                           "CPU with --device cpu")


_LAUNCHES = itertools.count()


def store_file(cfg):
    """The file of a ``file://`` ``INIT_METHOD``, else None."""
    method = cfg.INIT_METHOD
    return method[len("file://"):] if method.startswith("file://") else None


def fresh_rendezvous(cfg):
    """``cfg`` with the next launch's own ``INIT_METHOD``: a ``file://``
    path with the launch's number appended; on one shard, a file left at
    that path is removed."""
    path = store_file(cfg)
    if path is None:
        return cfg
    cfg = cfg.clone()
    path = f"{path}.{next(_LAUNCHES)}"
    if cfg.NUM_SHARDS == 1 and os.path.exists(path):
        os.remove(path)
    cfg.INIT_METHOD = "file://" + path
    return cfg


def launch_job(cfg, device, func):
    """Run ``func(cfg, device)``: in this process for a job of one rank,
    else on ``NUM_GPUS`` spawned ranks of this shard, which meet at a
    rendezvous of this launch's own (``fresh_rendezvous``)."""
    check_devices(cfg, device)
    if du.job_world_size(cfg) == 1:
        return func(cfg, device)
    cfg = fresh_rendezvous(cfg)
    try:
        mp.spawn(run, args=(func, cfg, str(device)), nprocs=max(cfg.NUM_GPUS, 1), join=True)
    finally:
        path = store_file(cfg)
        if path is not None and cfg.NUM_SHARDS == 1 and os.path.exists(path):
            os.remove(path)  # the ranks' store removes it when they all end cleanly
    return None
