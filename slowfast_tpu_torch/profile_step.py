"""Where a train step's time goes, op by op (counterpart of
tools/profile_step.py): ``torch.profiler`` over a few train steps of any
registered model on seeded synthetic batches that already lie on the
device, the trace written under ``--out``.

    python -m slowfast_tpu_torch.profile_step --cfg configs/Kinetics/MVITv2_S_16x4.yaml \\
        [--batch 16] [--steps 3] [--out profile_step] [--top 30] \\
        [--opts TPU.COMPUTE_DTYPE bfloat16 ...]

Every step ``run_net`` trains: the supervised step (mixup under
``MIXUP.ENABLE``), detection (``DETECTION.ENABLE``: the synthetic boxes of
``profile_eval.synthetic_batch``), masked pretraining (``MASK.ENABLE``) and
the contrastive SSL step (``ContrastiveModel``: two views of seeded normal
clips, their clip ids and times). Prints the top ATen ops by self device
time per step (self CPU time with ``--device cpu``), grouped by op and
input shapes, each with the category of the kernels it launched
(``profile_eval.CATEGORIES``), its calls per step and, where its recorded
input shapes and types give its bytes, its achieved GB/s: the inputs read
once and an output the size of the largest input written once (exact for
elementwise ops and copies, an estimate for the rest). Then the time by
category, the kernel time per step and the device's idle share of the
profiled window (``profile_eval.kernel_stats``), and one JSON line of the
same.
"""

import argparse
import collections
import json
import os

import torch
from torch.autograd import DeviceType

from slowfast_tpu_torch.config import assert_and_infer_cfg, get_cfg
from slowfast_tpu_torch.models.build import build_model, resolve_device
from slowfast_tpu_torch.profile_eval import category, kernel_stats, synthetic_batch
from slowfast_tpu_torch.solver.optimizer import construct_optimizer
from slowfast_tpu_torch.utils import profiler

_DTYPE_BYTES = {"float": 4, "c10::BFloat16": 2, "c10::Half": 2, "double": 8, "long int": 8,
                "int": 4, "unsigned char": 1, "bool": 1, "signed char": 1, "short int": 2}


def ssl_batch(cfg, n, device):
    """An SSL step's batch: two views of seeded normal pathways, clip ids and
    times."""
    gen = torch.Generator(device=device).manual_seed(0)
    shape = (n, cfg.DATA.NUM_FRAMES, cfg.DATA.TRAIN_CROP_SIZE, cfg.DATA.TRAIN_CROP_SIZE, 3)
    views = [[torch.randn(shape, generator=gen, device=device)] for _ in range(2)]
    return {"inputs": views[0], "inputs2": views[1], "index": torch.arange(n, device=device),
            "time": torch.rand(n, generator=gen, device=device)}


def make_step(cfg, batch_size, device):
    """The recipe's train step on a fresh model and its batch."""
    if cfg.MODEL.MODEL_NAME == "ContrastiveModel":  # the banks hold a row per clip id
        cfg.CONTRASTIVE.LENGTH = max(cfg.CONTRASTIVE.LENGTH, batch_size)
    model = build_model(cfg, device)
    optimizer = construct_optimizer(model, cfg)
    generator = torch.Generator().manual_seed(cfg.RNG_SEED)
    if cfg.MODEL.MODEL_NAME == "ContrastiveModel":
        from slowfast_tpu_torch.engine.ssl_steps import make_ssl_train_step
        from slowfast_tpu_torch.models.contrastive import init_ssl_state

        ssl = init_ssl_state(cfg, model, generator)
        step = make_ssl_train_step(cfg, model, optimizer, ssl, 1, generator)
        return step, ssl_batch(cfg, batch_size, device)
    from slowfast_tpu_torch.engine.steps import make_train_step

    step = make_train_step(cfg, model, optimizer, generator)
    return step, synthetic_batch(cfg, batch_size, cfg.DATA.TRAIN_CROP_SIZE, True, device)


def trace_input_types(path):
    """``{(op name, input dims as JSON): input types}`` of the ops of a
    Chrome trace written with ``record_shapes`` (where the profiler's events
    do not carry the types themselves)."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    types = {}
    for e in events:
        args = e.get("args") or {}
        if "Input type" in args and "Input Dims" in args:
            types.setdefault((e.get("name"), json.dumps(args["Input Dims"])), args["Input type"])
    return types


def op_bytes(event, trace_types):
    """Bytes of an op's recorded inputs, and of an output the size of the
    largest one; None where a shape or type is missing."""
    shapes = event.input_shapes or []
    types = (getattr(event, "input_dtypes", None)
             or trace_types.get((event.name, json.dumps(shapes))) or [])
    sizes = []
    for shape, dtype in zip(shapes, types):
        if not isinstance(shape, (list, tuple)) or not shape or dtype not in _DTYPE_BYTES:
            continue
        numel = 1
        for d in shape:
            numel *= int(d)
        sizes.append(numel * _DTYPE_BYTES[dtype])
    return sum(sizes) + max(sizes) if sizes else None


def op_table(prof, steps, device, trace_types=None):
    """Rows of ``(op, input shapes)``: time and calls per step, category,
    bytes and GB/s, the largest first."""
    trace_types = trace_types or {}
    attr = "self_device_time_total" if device.type == "cuda" else "self_cpu_time_total"
    rows = {}
    for e in prof.events():
        if e.device_type != DeviceType.CPU:
            continue
        us = getattr(e, attr, 0.0)
        if us <= 0:
            continue
        key = (e.name, str(e.input_shapes))
        kernels = getattr(e, "kernels", None) or []
        row = rows.setdefault(key, {"op": e.name, "shapes": e.input_shapes, "us": 0.0,
                                    "calls": 0, "bytes": op_bytes(e, trace_types),
                                    "category": category(kernels[0].name if kernels
                                                         else e.name)})
        row["us"] += us
        row["calls"] += 1
    out = []
    for row in sorted(rows.values(), key=lambda r: -r["us"]):
        ms = row["us"] / steps / 1e3
        calls = row["calls"] / steps
        gbps = (row["bytes"] * calls / (ms * 1e-3) / 1e9
                if row["bytes"] is not None and ms > 0 else None)
        out.append({"op": row["op"], "shapes": row["shapes"], "category": row["category"],
                    "ms_per_step": ms, "calls_per_step": calls, "gbps": gbps})
    return out


def profile_step(cfg, batch_size=16, steps=3, out="profile_step", top=30, device="cuda"):
    """Profile ``steps`` train steps of ``cfg`` after two unprofiled ones;
    returns ``{"device", "steps", "batch_size", "rows", "by_category",
    "kernel_ms_per_step", "idle_share", "trace"}`` (the last two but one
    None on the CPU)."""
    device = resolve_device(device)
    step, batch = make_step(cfg, batch_size, device)
    for _ in range(2):
        step(batch)
    timer = profiler.StepTimer(warmup=0)
    with profiler.trace(out) as prof:
        for _ in range(steps):
            timer.start()
            m = step(batch)
            timer.stop(m["loss"])
    rows = op_table(prof, steps, device, trace_input_types(os.path.join(out, "trace.json")))
    kernels, kernel_us, idle = kernel_stats(list(prof.events()))
    by_cat = collections.Counter()
    for r in rows:
        by_cat[r["category"]] += r["ms_per_step"]
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    return {"device": name, "model": cfg.MODEL.MODEL_NAME, "dtype": cfg.TPU.COMPUTE_DTYPE,
            "steps": steps, "batch_size": batch_size, "step_timer": timer.summary(),
            "rows": rows[:top], "by_category": dict(by_cat.most_common()),
            "kernel_ms_per_step": kernel_us / steps / 1e3 if kernels else None,
            "idle_share": idle, "trace": os.path.join(out, "trace.json")}


def print_table(result):
    clock = "device" if result["device"] != "cpu" else "CPU"
    print(f"top {len(result['rows'])} ops by self {clock} time per step over "
          f"{result['steps']} steps of {result['batch_size']} clips on {result['device']}:")
    for r in result["rows"]:
        bw = f"  {r['gbps']:8.1f} GB/s" if r["gbps"] is not None else ""
        print(f"{r['ms_per_step']:9.3f} ms  x{r['calls_per_step']:<6.1f} {r['category']:<15}"
              f" {r['op'][:40]:<40} {str(r['shapes'])[:60]}{bw}")
    total = sum(result["by_category"].values())
    print("-- by category --")
    for cat, ms in result["by_category"].items():
        print(f"{ms:9.3f} ms/step  {100 * ms / total if total else 0:5.1f}%  {cat}")
    if result["kernel_ms_per_step"] is not None:
        print(f"kernels {result['kernel_ms_per_step']:.3f} ms/step, device idle "
              f"{100 * result['idle_share']:.1f}% of the window")


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--cfg", required=True)
    parser.add_argument("--batch", type=int, default=16)
    parser.add_argument("--steps", type=int, default=3)
    parser.add_argument("--out", default="profile_step")
    parser.add_argument("--top", type=int, default=30)
    parser.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    parser.add_argument("--opts", nargs=argparse.REMAINDER, default=[])
    args = parser.parse_args(argv)
    cfg = get_cfg()
    cfg.merge_from_file(args.cfg)
    cfg.merge_from_list(list(args.opts))
    result = profile_step(assert_and_infer_cfg(cfg), args.batch, args.steps, args.out, args.top,
                          args.device)
    print_table(result)
    print(json.dumps(result, default=str), flush=True)
    return result


if __name__ == "__main__":
    main()
