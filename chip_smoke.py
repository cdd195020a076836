"""Drive the PyTorch port (slowfast_tpu_torch) on one NVIDIA GPU.

Run from the root of the repository:  python3 chip_smoke.py

Phases, each printing one JSON line:
  1. device   the card's name and power limit; fails without CUDA.
  2. build    builds every CUDA kernel from slowfast_tpu_torch/csrc with nvcc.
  3. kernel   each kernel against its plain PyTorch version on the card, at the
              slice's shape and a ragged one, with its device time, the plain
              version's time and its byte bound.
  4. fp32     the full-width SLOWFAST_4x16_R50 forward on the card against the
              same weights on the CPU, fp32, TF32 off.
  5. slice    the multi-view test (engine.tester.test) at full width in bf16 on
              synthetic video: 2 videos x 10 views x 3 crops; the kernel's
              launch count must equal the batch count.
  6. breakdown  the eval step alone on a batch already on the card, and the
              loader alone, per batch.
  7. kernels  one line per kernel with its launches on the main path, error,
              times and bound.
The last line is {"ok": true, "device": {...}}. Any failed check raises, and
the script exits non-zero without printing that line.
"""

import json
import os
import pickle
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
YAML = os.path.join(ROOT, "configs", "Kinetics", "SLOWFAST_4x16_R50.yaml")
OUT_DIR = os.path.join(ROOT, "chiprun_out", "chip_smoke")
# H100 SXM (80 GB HBM3) peaks, NVIDIA's data sheet: memory rate,
# non-tensor-core fp32 rate and dense bf16 tensor-core rate.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
BF16_FLOP_PER_S = 989e12  # dense, tensor cores
FULL_WIDTH_ATOL = 1e-4  # softmax, card (fp32, TF32 off) vs CPU


def emit(obj):
    print(json.dumps(obj), flush=True)


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def device_ms(fn, iters=25):
    """Median device time of ``fn`` in ms over ``iters`` runs (CUDA events).
    A sleep kernel ahead of each run keeps the card busy while the host
    enqueues, so the events time the device work and not the launch."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def slowfast_cfg(extra):
    from slowfast_tpu_torch.config import assert_and_infer_cfg, get_cfg

    cfg = get_cfg()
    cfg.merge_from_file(YAML)
    cfg.merge_from_list(["TRAIN.ENABLE", "False", "OUTPUT_DIR", OUT_DIR] + list(extra))
    return assert_and_infer_cfg(cfg)


def phase_device():
    check(torch.cuda.is_available(), "no CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    info = {"phase": "device", "name": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(), "nvidia_smi": smi,
            "torch": torch.__version__, "cuda": torch.version.cuda}
    emit(info)
    return info


def phase_build():
    from slowfast_tpu_torch.ops import _build

    t0 = time.perf_counter()
    libs = _build.build_all()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "libraries": sorted(libs)})


def phase_kernel():
    """Preprocess kernel vs its plain version; bit-equal is expected (the
    kernel rounds as the plain version does), 1 ulp is the stated limit."""
    from slowfast_tpu_torch.ops import preprocess as pp

    mean, std = [0.45, 0.45, 0.45], [0.225, 0.225, 0.225]
    scale, bias = pp.scale_bias(mean, std)
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = [((8, 32, 256, 256, 3), 8), ((3, 10, 17, 13, 3), 4)]
    max_err, max_ulp, n_checked = 0.0, 0, 0
    for shape, alpha in cases:
        x = torch.randint(0, 256, shape, dtype=torch.uint8, device="cuda", generator=gen)
        idx = pp.slow_index(shape[1], alpha)
        for dtype in (torch.bfloat16, torch.float32):
            for reverse in (False, True):
                for flip in (False, True):
                    flips = (np.arange(shape[0]) % 2 == 1) if flip else None
                    got = pp.device_preprocess(x, mean, std, flips=flips, alpha=alpha,
                                               out_dtype=dtype, reverse_channels=reverse)
                    fl = None if flips is None else torch.as_tensor(flips, device="cuda")
                    want = pp.preprocess_plain(x, scale, bias, fl, idx, dtype, reverse)
                    for g, w in zip(got, want):
                        check(g.shape == w.shape and g.dtype == w.dtype,
                              f"shape/dtype {g.shape} {g.dtype} vs {w.shape} {w.dtype}")
                        int_t = torch.int16 if dtype == torch.bfloat16 else torch.int32
                        ulp = (g.view(int_t).long() - w.view(int_t).long()).abs().max().item()
                        err = (g.float() - w.float()).abs().max().item()
                        max_ulp, max_err = max(max_ulp, ulp), max(max_err, err)
                        n_checked += 1
    check(max_ulp <= 1, f"preprocess kernel differs from plain by {max_ulp} ulps")

    # Time the main path's call: B=8, T=32, 256^2, bf16, both pathways.
    shape, alpha = cases[0]
    x = torch.randint(0, 256, shape, dtype=torch.uint8, device="cuda", generator=gen)
    idx = pp.slow_index(shape[1], alpha)
    kernel_ms = device_ms(lambda: pp.device_preprocess(x, mean, std, alpha=alpha))
    plain_ms = device_ms(
        lambda: pp.preprocess_plain(x, scale, bias, None, idx, torch.bfloat16, False))
    n = x.numel()
    out_elems = n + n * len(idx) // shape[1]
    nbytes = n + 2 * out_elems  # u8 in once, bf16 fast + slow out once
    flops = 2 * out_elems  # multiply + add per output element
    bound_ms = max(nbytes / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S) * 1e3
    row = {"phase": "kernel", "name": "preprocess_u8", "cases_checked": n_checked,
           "max_abs_err": max_err, "max_ulp": max_ulp, "shape": list(shape),
           "alpha": alpha, "dtype": "bfloat16", "ms": kernel_ms, "plain_ms": plain_ms,
           "bytes": nbytes, "bound_ms": bound_ms, "bound_by": "bytes",
           "bound_rate": "H100 SXM 3.35 TB/s", "roofline_share": bound_ms / kernel_ms}
    emit(row)
    return row


def randomize_bn(model, seed):
    """Seeded BN parameters and statistics, so no residual branch is zero."""
    from slowfast_tpu_torch.models.batchnorm import BatchNorm3D

    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, BatchNorm3D):
                c = m.weight.shape[0]
                m.weight.copy_(torch.rand(c, generator=gen) + 0.5)
                m.bias.copy_(torch.randn(c, generator=gen) * 0.1)
                m.running_mean.copy_(torch.randn(c, generator=gen) * 0.1)
                m.running_var.copy_(torch.rand(c, generator=gen) + 0.5)


def temper_head(model, clip, cfg, logit_std=2.0):
    """Scale the projection so the logits of ``clip`` have std ``logit_std``:
    with random weights at full depth they are large enough to saturate the
    softmax, and a one-hot output would compare equal whatever the error."""
    from slowfast_tpu_torch.engine.steps import make_eval_step

    feats = []
    hook = model.head.register_forward_pre_hook(lambda m, args: feats.append(args[0]))
    try:
        make_eval_step(cfg, model)({"inputs": [torch.from_numpy(clip)]})
    finally:
        hook.remove()
    pooled = torch.cat([x.float().mean(dim=(1, 2, 3)) for x in feats[0]], dim=-1)
    proj = model.head.projection
    with torch.no_grad():
        std = torch.nn.functional.linear(pooled, proj.weight, proj.bias).std().item()
        proj.weight.mul_(logit_std / std)
        proj.bias.mul_(logit_std / std)


def phase_fp32():
    from slowfast_tpu_torch.engine.steps import make_eval_step
    from slowfast_tpu_torch.models.build import build_model

    cfg = slowfast_cfg(["TPU.COMPUTE_DTYPE", "float32"])
    cpu_model = build_model(cfg, device="cpu")
    randomize_bn(cpu_model, 1)
    clip = np.random.RandomState(2).randint(
        0, 255, (1, cfg.DATA.NUM_FRAMES, cfg.DATA.TEST_CROP_SIZE, cfg.DATA.TEST_CROP_SIZE, 3)
    ).astype(np.uint8)
    temper_head(cpu_model, clip, cfg)
    gpu_model = build_model(cfg, device="cuda")
    gpu_model.load_state_dict(cpu_model.state_dict(), strict=True)
    want = make_eval_step(cfg, cpu_model)({"inputs": [torch.from_numpy(clip)]})
    tf32 = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        got = make_eval_step(cfg, gpu_model)({"inputs": [torch.from_numpy(clip).cuda()]})
        got = got.cpu()
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    err = (got - want).abs().max().item()
    check(got.shape == (1, cfg.MODEL.NUM_CLASSES) and torch.isfinite(got).all().item(),
          f"bad output {got.shape}")
    check(want.max().item() < 0.5, f"saturated softmax {want.max().item()}")
    check(err <= FULL_WIDTH_ATOL, f"card vs CPU softmax max abs err {err}")
    emit({"phase": "fp32", "max_abs_err": err, "atol": FULL_WIDTH_ATOL,
          "max_rel_err": ((got - want).abs() / want).max().item(),
          "argmax_equal": bool(got.argmax() == want.argmax()),
          "max_prob": want.max().item(), "crop": cfg.DATA.TEST_CROP_SIZE,
          "frames": cfg.DATA.NUM_FRAMES})


def phase_slice():
    from slowfast_tpu_torch.engine import tester
    from slowfast_tpu_torch.ops import preprocess as pp

    os.makedirs(OUT_DIR, exist_ok=True)
    stats_log = os.path.join(OUT_DIR, "json_stats.log")
    results = os.path.join(OUT_DIR, "results.pkl")
    for path in (stats_log, results):
        if os.path.exists(path):
            os.remove(path)
    cfg = slowfast_cfg(["TPU.COMPUTE_DTYPE", "bfloat16", "TEST.DATASET", "syntheticvideo",
                        "DATA.SYNTHETIC_SIZE", "2", "TEST.BATCH_SIZE", "8",
                        "TEST.SAVE_RESULTS_PATH", results])
    num_clips = 2 * cfg.TEST.NUM_ENSEMBLE_VIEWS * cfg.TEST.NUM_SPATIAL_CROPS
    num_batches = -(-num_clips // cfg.TEST.BATCH_SIZE)
    torch.cuda.reset_peak_memory_stats()
    pp.launches = 0
    t0 = time.perf_counter()
    (stats,) = tester.test(cfg, device="cuda")
    wall = time.perf_counter() - t0
    launches = {"preprocess_u8": pp.launches}

    with open(results, "rb") as f:
        video_preds, _ = pickle.load(f)
    per_view = cfg.TEST.NUM_ENSEMBLE_VIEWS * cfg.TEST.NUM_SPATIAL_CROPS
    row_sums = video_preds.sum(axis=1) / per_view
    with open(stats_log) as f:
        logged = [json.loads(line.split("json_stats: ", 1)[1]) for line in f]
    iters = [float(s["time_diff"]) for s in logged if s["_type"] == "test_iter"]
    check(np.isfinite(video_preds).all() and (video_preds >= 0).all(), "bad predictions")
    check(np.abs(row_sums - 1.0).max() < 1e-2, f"softmax rows do not sum to 1: {row_sums}")
    check(logged[-1]["_type"] == "test_final" and logged[-1] == stats, "no test_final")
    check(len(iters) == num_batches, f"{len(iters)} iterations, expected {num_batches}")
    check(launches["preprocess_u8"] == num_batches,
          f"kernel launched {launches['preprocess_u8']} times for {num_batches} batches")
    row = {"phase": "slice", "clips": num_clips, "batches": num_batches,
           "batch_size": cfg.TEST.BATCH_SIZE, "crop": cfg.DATA.TEST_CROP_SIZE,
           "frames": cfg.DATA.NUM_FRAMES, "dtype": "bfloat16",
           "eval_clips_per_s": num_clips / sum(iters),
           "p50_batch_ms": statistics.median(iters) * 1e3,
           "p50_clips_per_s": cfg.TEST.BATCH_SIZE / statistics.median(iters),
           "first_batch_ms": iters[0] * 1e3, "test_wall_s": wall,
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           "row_sum_max_dev": float(np.abs(row_sums - 1.0).max()),
           "top1_acc": stats["top1_acc"], "top5_acc": stats["top5_acc"],
           "launches": launches}
    emit(row)
    return launches


def count_conv_flops(model, step, batch):
    """Operations (2 per multiply-add) of every conv in one eval step, from
    the shapes the step gives them."""
    from slowfast_tpu_torch.models.common import Conv3D

    total = 0

    def hook(module, args, out):
        nonlocal total
        total += 2 * out.numel() * module.weight[0].numel()

    handles = [m.register_forward_hook(hook) for m in model.modules()
               if isinstance(m, Conv3D)]
    try:
        step(batch)
    finally:
        for h in handles:
            h.remove()
    return total


def phase_breakdown():
    """Where a test batch's time goes: the eval step alone on a batch that
    already lies on the card, and the loader alone (host clock, each
    measurement ending in a synchronize)."""
    from slowfast_tpu_torch.data import construct_loader
    from slowfast_tpu_torch.engine.steps import make_eval_step
    from slowfast_tpu_torch.models.build import build_model

    cfg = slowfast_cfg(["TPU.COMPUTE_DTYPE", "bfloat16", "TEST.DATASET", "syntheticvideo",
                        "DATA.SYNTHETIC_SIZE", "2", "TEST.BATCH_SIZE", "8"])
    model = build_model(cfg, device="cuda")
    step = make_eval_step(cfg, model)
    loader = construct_loader(cfg, "test", device="cuda")
    batches = iter(loader)
    batch = {"inputs": next(batches)[0]}
    batches.close()
    conv_flops = count_conv_flops(model, step, batch)
    step_s = []
    for _ in range(12):
        t0 = time.perf_counter()
        step(batch)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    load_s = []
    t0 = time.perf_counter()
    for inputs, *_ in loader:
        torch.cuda.synchronize()
        load_s.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
    step_p50 = statistics.median(step_s[2:])
    emit({"phase": "breakdown", "batch_size": cfg.TEST.BATCH_SIZE,
          "eval_step_p50_ms": step_p50 * 1e3,
          "conv_gflop_per_batch": conv_flops / 1e9,
          "conv_tflop_per_s": conv_flops / step_p50 / 1e12,
          "bf16_peak_share": conv_flops / step_p50 / BF16_FLOP_PER_S,
          "loader_batch_p50_ms": statistics.median(load_s) * 1e3,
          "loader_workers": loader.num_workers, "loader_batches": len(load_s)})


def main():
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device", file=sys.stderr)
        return 1
    info = phase_device()
    phase_build()
    kernel = phase_kernel()
    phase_fp32()
    launches = phase_slice()
    phase_breakdown()
    emit({"kernels": [{
        "name": "preprocess_u8", "route": "cuda",
        "source": "slowfast_tpu_torch/csrc/preprocess.cu",
        "replaces": "slowfast_tpu/ops/preprocess.py:42",
        "launches": launches["preprocess_u8"], "max_abs_err": kernel["max_abs_err"],
        "ms": kernel["ms"], "plain_ms": kernel["plain_ms"],
        "bound_ms": kernel["bound_ms"], "bound_by": kernel["bound_by"],
        "library_ms": None,
    }]})
    print(info["nvidia_smi"], flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": info["name"],
                                 "count": info["count"]}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
