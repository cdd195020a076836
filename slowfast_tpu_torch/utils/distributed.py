"""Process-group helpers for multi-process data-parallel training
(counterpart of slowfast_tpu/parallel/mesh.py:20 ``init_distributed``,
:273-280 ``is_master_proc`` / ``get_world_size``, and
slowfast_tpu/utils/meters.py:21 ``gather_ragged_across_hosts``; reference
slowfast/utils/distributed.py).

One process per device: ``NUM_SHARDS`` hosts of ``NUM_GPUS`` ranks each,
rank ``SHARD_ID · NUM_GPUS + local_rank``. The group is NCCL
(``DIST_BACKEND``) on the card and gloo on the CPU. Without a process
group every helper is the identity of one process, so single-process code
paths stay as they are; in a group of one the collectives run, and give
back what they are given.
"""

import numpy as np
import torch
import torch.distributed as dist


# Subgroups of the current process group by size (``rank_group``).
_SUBGROUPS = {}


def is_initialized():
    return dist.is_available() and dist.is_initialized()


def get_world_size():
    return dist.get_world_size() if is_initialized() else 1


def get_rank():
    return dist.get_rank() if is_initialized() else 0


def is_master_proc():
    """Whether this process logs and writes checkpoints (rank 0)."""
    return get_rank() == 0


def job_world_size(cfg):
    """The ranks a job of ``cfg`` runs on: ``NUM_SHARDS · NUM_GPUS``."""
    return cfg.NUM_SHARDS * max(cfg.NUM_GPUS, 1)


def init_distributed(cfg, local_rank, device):
    """Join the job's process group as local rank ``local_rank`` of shard
    ``SHARD_ID`` through ``INIT_METHOD``: NCCL on a CUDA ``device`` (which
    becomes ``cuda:local_rank``), gloo on the CPU. Returns this rank's
    device."""
    device = torch.device(device)
    if device.type == "cuda":
        device = torch.device("cuda", local_rank)
        torch.cuda.set_device(device)
        backend = cfg.DIST_BACKEND
    else:
        backend = "gloo"
    dist.init_process_group(backend, init_method=cfg.INIT_METHOD,
                            world_size=job_world_size(cfg),
                            rank=cfg.SHARD_ID * max(cfg.NUM_GPUS, 1) + local_rank)
    return device


def destroy():
    """Leave the process group (and forget its subgroups)."""
    _SUBGROUPS.clear()
    if is_initialized():
        dist.destroy_process_group()


def check_world(cfg):
    """Raise unless this process runs as one of the job's ranks: a config
    of several ranks needs the launcher (``run_net``), which spawns them."""
    want, have = job_world_size(cfg), get_world_size()
    if want != have:
        raise ValueError(
            f"NUM_SHARDS x NUM_GPUS = {want} ranks, but this process runs in a group of "
            f"{have}: launch the job through slowfast_tpu_torch.run_net, which spawns "
            "NUM_GPUS ranks a shard, or set NUM_GPUS 1")


def barrier():
    if is_initialized():
        dist.barrier()


def _comm_device():
    """Where collectives take their tensors: the current card under NCCL,
    the CPU under gloo."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


class _AllReduceSum(torch.autograd.Function):
    """Sum over ``group`` whose backward is the sum of the gradients over
    the same group: the gradient of every rank's loss with respect to the
    summed quantity reaches each rank's inputs."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def all_reduce_sum_autograd(x, group=None):
    """``x`` summed over ``group`` (``_AllReduceSum``); one process: ``x``."""
    if not is_initialized():
        return x
    return _AllReduceSum.apply(x, group)


def all_reduce(tensors, op="mean"):
    """Reduce each tensor of ``tensors`` in place over the world, as one
    flat buffer a dtype (``op``: ``"mean"`` or ``"sum"``); returns them."""
    if not is_initialized():
        return tensors
    world = get_world_size()
    by_dtype = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for group in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in group]).to(_comm_device())
        dist.all_reduce(flat)
        if op == "mean":
            flat.div_(world)
        offset = 0
        for t in group:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()
    return tensors


def all_reduce_grads(params):
    """Every parameter's gradient replaced by its mean over the ranks, in
    flat buffers a dtype; a missing gradient counts as zeros, as the
    optimizer counts it."""
    if not is_initialized():
        return
    grads = []
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
        grads.append(p.grad)
    all_reduce(grads, "mean")


class _AllGatherWithGradient(torch.autograd.Function):
    """Every rank's rows of ``x`` in rank order (reference
    contrastive.py ``AllGatherWithGradient``): the backward sums the
    incoming gradient over the ranks and keeps this rank's rows, so every
    rank's loss on the gathered rows reaches the rows' own rank."""

    @staticmethod
    def forward(ctx, x):
        parts = [torch.empty_like(x) for _ in range(get_world_size())]
        dist.all_gather(parts, x.contiguous())
        ctx.rows = x.shape[0]
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad)
        start = get_rank() * ctx.rows
        return grad[start:start + ctx.rows]


def all_gather_with_grad(x):
    """``x``'s rows of every rank, in rank order, with a gradient that
    reaches each rank's own rows (``_AllGatherWithGradient``); one process:
    ``x``."""
    if not is_initialized():
        return x
    return _AllGatherWithGradient.apply(x)


def global_rows(x):
    """The global batch of the rows that each rank holds of it (equal
    counts a rank), without gradient; one process: ``x``.

    The order is the JAX package's global order: its loader gives host
    ``s`` the rows ``batch[s::NUM_SHARDS]`` (slowfast_tpu/data/loader.py:208)
    and ``shard_batch`` assembles the global array from the hosts' rows with
    ``make_array_from_process_local_data`` (slowfast_tpu/parallel/mesh.py:
    228) on a mesh of the devices in process order (:105), so its device
    ``d`` holds rows ``[d·b, (d+1)·b)`` of the array: rank order, the order
    of the gather, whatever ``NUM_SHARDS`` is."""
    if not is_initialized():
        return x
    x = x.detach().contiguous()
    parts = [torch.empty_like(x) for _ in range(get_world_size())]
    dist.all_gather(parts, x)
    return torch.cat(parts)


def own_rows(x_global):
    """This rank's rows of a global tensor (``global_rows``'s inverse); one
    process: ``x_global``."""
    if not is_initialized():
        return x_global
    per = x_global.shape[0] // get_world_size()
    return x_global[get_rank() * per:(get_rank() + 1) * per]


def global_count(local):
    """``local`` (a tensor) summed over the ranks, without gradient (one
    process: ``local``)."""
    if not is_initialized():
        return local
    total = local.detach().clone()
    dist.all_reduce(total)
    return total


def all_gather_unaligned(x):
    """Every rank's rows of a host array of any length (ragged across
    ranks), concatenated in rank order (reference
    distributed.all_gather_unaligned): the lengths are gathered first, each
    block is padded to the longest, gathered and trimmed. One process:
    ``x``."""
    if not is_initialized():
        return x
    world = get_world_size()
    x = np.ascontiguousarray(x)
    dev = _comm_device()
    count = torch.tensor([x.shape[0]], dtype=torch.int64, device=dev)
    counts = [torch.zeros_like(count) for _ in range(world)]
    dist.all_gather(counts, count)
    counts = [int(c.item()) for c in counts]
    block = torch.zeros((max(counts),) + x.shape[1:], dtype=torch.from_numpy(x).dtype,
                        device=dev)
    block[:x.shape[0]] = torch.from_numpy(x).to(dev)
    blocks = [torch.empty_like(block) for _ in range(world)]
    dist.all_gather(blocks, block)
    return np.concatenate([b[:n].cpu().numpy() for b, n in zip(blocks, counts)], axis=0)


def exchange_with(tensors, peer):
    """Send ``tensors`` to rank ``peer`` and return its tensors of the same
    shapes (``tensors`` themselves when ``peer`` is this rank)."""
    if peer == get_rank():
        return list(tensors)
    sent = [t.contiguous() for t in tensors]
    received = [torch.empty_like(t) for t in sent]
    ops = [dist.P2POp(dist.isend, t, peer) for t in sent]
    ops += [dist.P2POp(dist.irecv, r, peer) for r in received]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return received


def rank_group(size):
    """The group of ``size`` consecutive ranks that holds this rank (the
    world when ``size`` is the world size). Every rank creates every such
    group, in the same order, the first time one is asked for."""
    world = get_world_size()
    if size == world:
        return None
    if size not in _SUBGROUPS:
        _SUBGROUPS[size] = [dist.new_group(list(range(start, start + size)))
                            for start in range(0, world, size)]
    return _SUBGROUPS[size][get_rank() // size]
