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
  7. attn_kernel  both pooled-attention kernels (the constant-shift core,
              MViT's default, and the exact-softmax core of
              TPU.PALLAS_ATTENTION) against their plain versions on the
              inputs the full-width MViTv2-S 16x4 eval step gives its 16
              blocks at B=8 in bf16, at block 1 at B=1 in fp32, and at small
              ragged and extreme cases; per distinct block shape the device
              time, the plain time, SDPA's time and backend, and the bound.
              Also the MViT eval step alone on a batch already on the card.
  8. mvit_fp32  the full-width MViTv2-S forward on the card against the CPU
              on the same weights, fp32, TF32 off, once with each core.
  9. mvit_slice  the MViTv2-S multi-view test (engine.tester.test) in bf16
              on synthetic video: 4 videos x 5 views x 1 crop in batches of
              8; the constant-shift kernel must launch 16 times a batch.
 10. kernels  one line per kernel with its launches on its path, error,
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
MVIT_YAML = os.path.join(ROOT, "configs", "Kinetics", "MVITv2_S_16x4.yaml")
OUT_DIR = os.path.join(ROOT, "chiprun_out", "chip_smoke")
# H100 SXM (80 GB HBM3) peaks, NVIDIA's data sheet: memory rate,
# non-tensor-core fp32 rate and dense bf16 tensor-core rate.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
BF16_FLOP_PER_S = 989e12  # dense, tensor cores
FULL_WIDTH_ATOL = 1e-4  # softmax, card (fp32, TF32 off) vs CPU
# Exponentials: 16 a clock on each of the 132 SMs at the 1.98 GHz boost
# clock (the multi-function unit's ex2 rate, CUDA programming guide).
EXP_PER_S = 16 * 132 * 1.98e9
# Attention kernel vs its plain version, as a share of max |v| (outputs are
# convex combinations of v's rows): fp32 differs only in summation order;
# bf16 may round e, and the output, one bf16 ulp (2^-8) the other way.
ATTN_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


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


def slowfast_cfg(extra, yaml=YAML, out_dir=OUT_DIR):
    from slowfast_tpu_torch.config import assert_and_infer_cfg, get_cfg

    cfg = get_cfg()
    cfg.merge_from_file(yaml)
    cfg.merge_from_list(["TRAIN.ENABLE", "False", "OUTPUT_DIR", out_dir] + list(extra))
    return assert_and_infer_cfg(cfg)


def mvit_cfg(extra):
    return slowfast_cfg(["NUM_GPUS", "1"] + list(extra), MVIT_YAML,
                        os.path.join(OUT_DIR, "mvit"))


def reset_launches():
    from slowfast_tpu_torch.ops import attention as ta
    from slowfast_tpu_torch.ops import preprocess as pp

    pp.launches = ta.flash_launches = ta.exact_launches = 0


def read_launches():
    from slowfast_tpu_torch.ops import attention as ta
    from slowfast_tpu_torch.ops import preprocess as pp

    return {"preprocess_u8": pp.launches, "attention_flash": ta.flash_launches,
            "attention_exact": ta.exact_launches}


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
    """Scale the projection so the logits of ``clip`` have std ``logit_std``.
    With random weights at full depth SlowFast's logits saturate the softmax
    and MViT's (head init std 0.02) leave it near uniform; either way the
    comparison would pass whatever the error."""
    from slowfast_tpu_torch.engine.steps import make_eval_step

    feats = []
    hook = model.head.register_forward_pre_hook(lambda m, args: feats.append(args[0]))
    try:
        make_eval_step(cfg, model)({"inputs": [torch.from_numpy(clip)]})
    finally:
        hook.remove()
    if isinstance(feats[0], torch.Tensor):  # MViT: the (B, C) cls row
        pooled = feats[0].float()
    else:  # SlowFast: per-pathway NTHWC maps, pooled and concatenated
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


def drive_test(phase, make_cfg, out_dir, num_videos):
    """``engine.tester.test`` on the card in bf16 on synthetic video, with
    every kernel count set to 0 just before and read just after. Checks the
    predictions, the log and the batch count; returns (row, launches)."""
    from slowfast_tpu_torch.engine import tester

    os.makedirs(out_dir, exist_ok=True)
    stats_log = os.path.join(out_dir, "json_stats.log")
    results = os.path.join(out_dir, "results.pkl")
    for path in (stats_log, results):
        if os.path.exists(path):
            os.remove(path)
    cfg = make_cfg(["TPU.COMPUTE_DTYPE", "bfloat16", "TEST.DATASET", "syntheticvideo",
                    "DATA.SYNTHETIC_SIZE", str(num_videos), "TEST.BATCH_SIZE", "8",
                    "TEST.SAVE_RESULTS_PATH", results])
    per_view = cfg.TEST.NUM_ENSEMBLE_VIEWS * cfg.TEST.NUM_SPATIAL_CROPS
    num_clips = num_videos * per_view
    num_batches = -(-num_clips // cfg.TEST.BATCH_SIZE)
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    (stats,) = tester.test(cfg, device="cuda")
    wall = time.perf_counter() - t0
    launches = read_launches()

    with open(results, "rb") as f:
        video_preds, _ = pickle.load(f)
    row_sums = video_preds.sum(axis=1) / per_view
    with open(stats_log) as f:
        logged = [json.loads(line.split("json_stats: ", 1)[1]) for line in f]
    iters = [float(s["time_diff"]) for s in logged if s["_type"] == "test_iter"]
    check(np.isfinite(video_preds).all() and (video_preds >= 0).all(), "bad predictions")
    check(np.abs(row_sums - 1.0).max() < 1e-2, f"softmax rows do not sum to 1: {row_sums}")
    check(logged[-1]["_type"] == "test_final" and logged[-1] == stats, "no test_final")
    check(len(iters) == num_batches, f"{len(iters)} iterations, expected {num_batches}")
    check(launches["preprocess_u8"] == num_batches,
          f"preprocess kernel launched {launches['preprocess_u8']} times for "
          f"{num_batches} batches")
    row = {"phase": phase, "clips": num_clips, "batches": num_batches,
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
    return row, launches


def phase_slice():
    """SlowFast 4x16 R50: 2 videos x 10 views x 3 crops."""
    row, launches = drive_test("slice", slowfast_cfg, OUT_DIR, 2)
    check(launches["attention_flash"] == launches["attention_exact"] == 0,
          f"SlowFast launched an attention kernel: {launches}")
    emit(row)
    return launches


def phase_mvit_slice():
    """MViTv2-S 16x4: 4 videos x 5 views x 1 crop, 3 batches of 8 (the last
    one ragged). Every block runs the constant-shift attention kernel."""
    row, launches = drive_test("mvit_slice", mvit_cfg, os.path.join(OUT_DIR, "mvit"), 4)
    depth = mvit_cfg([]).MVIT.DEPTH
    check(launches["attention_flash"] == depth * row["batches"],
          f"attention kernel launched {launches['attention_flash']} times for "
          f"{row['batches']} batches of {depth} blocks")
    check(launches["attention_exact"] == 0, f"exact core launched: {launches}")
    emit(row)
    return launches


def attention_bound(q, k, v):
    """The least time one pooled-attention call could take on the card: its
    operations (2 per multiply-add of q kᵀ and p v) over the peak rate for
    the input type, or q, k, v and the output moved once over the memory
    rate, whichever is larger; the exponentials over the ex2 rate beside it."""
    B, Nq, nh, dq = q.shape
    Nk, dv = v.shape[1], v.shape[3]
    flops = 2 * B * nh * Nq * Nk * (dq + dv)
    nbytes = (q.numel() + k.numel() + v.numel() + B * Nq * nh * dv) * q.element_size()
    peak = BF16_FLOP_PER_S if q.dtype == torch.bfloat16 else FP32_FLOP_PER_S
    t_ops, t_bytes = flops / peak, nbytes / HBM_BYTES_PER_S
    return {"bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "gflop": flops / 1e9, "bytes": nbytes,
            "exp_bound_ms": B * nh * Nq * Nk / EXP_PER_S * 1e3}


def attention_inputs(shape, dtype, seed, extreme=False):
    """Seeded q, k, v of ``shape`` (B, Nq, Nk, nh, dq, dv) on the card. With
    ``extreme``, q rows 0-2 put every logit above the clamp at 50 and rows
    3-5 make every exp(l - 20) underflow."""
    B, Nq, Nk, nh, dq, dv = shape
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((B, Nq, nh, dq), device="cuda", generator=gen) * 0.6
    k = torch.randn((B, Nk, nh, dq), device="cuda", generator=gen) * 0.6
    v = torch.randn((B, Nk, nh, dv), device="cuda", generator=gen)
    if extreme:
        k[..., 0] = 1.0 + torch.rand(k[..., 0].shape, device="cuda", generator=gen)
        q[:, 0:3, :, 0] = 100.0
        q[:, 3:6, :, 0] = -200.0
    return q.to(dtype), k.to(dtype), v.to(dtype)


def capture_mvit_attention(batch_size, steps=6):
    """The (q, k, v) that each block of one full-width MViTv2-S 16x4 eval
    step (bf16, seeded random weights and clips) hands its attention core,
    and the eval step's own time on a batch already on the card (median
    host time of ``steps`` runs after one warm-up, each ending in a
    synchronize)."""
    from slowfast_tpu_torch.engine.steps import make_eval_step
    from slowfast_tpu_torch.models.build import build_model
    from slowfast_tpu_torch.ops import attention as ta

    cfg = mvit_cfg(["TPU.COMPUTE_DTYPE", "bfloat16"])
    model = build_model(cfg, device="cuda")
    step = make_eval_step(cfg, model)
    gen = torch.Generator(device="cuda").manual_seed(4)
    size = (batch_size, cfg.DATA.NUM_FRAMES, cfg.DATA.TEST_CROP_SIZE,
            cfg.DATA.TEST_CROP_SIZE, 3)
    batch = {"inputs": [torch.randint(0, 256, size, dtype=torch.uint8, device="cuda",
                                      generator=gen)]}
    captured, core = [], ta.flash_pooled_attention

    def recording_core(q, k, v):
        captured.append((q.clone(), k.clone(), v.clone()))
        return core(q, k, v)

    ta.flash_pooled_attention = recording_core
    try:
        step(batch)
    finally:
        ta.flash_pooled_attention = core
    step_s = []
    for _ in range(steps):
        t0 = time.perf_counter()
        step(batch)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    check(len(captured) == cfg.MVIT.DEPTH, f"captured {len(captured)} attention calls")
    return captured, statistics.median(step_s) * 1e3


def phase_attn_kernel():
    """Both attention kernels against their plain versions, and their times
    at each distinct block shape of MViTv2-S at B=8 in bf16."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend

    from slowfast_tpu_torch.ops import attention as ta

    kernels = {"flash": (ta.flash_pooled_attention, ta.flash_plain),
               "exact": (ta.pooled_attention, ta.exact_plain)}
    max_err = {name: 0.0 for name in kernels}
    fp32_err = {}
    n_checked = 0

    def compare(name, q, k, v):
        """The kernel against its plain version; returns (output, max abs err)."""
        nonlocal n_checked
        fn, plain = kernels[name]
        got, want = fn(q, k, v), plain(q, k, v)
        check(got.shape == want.shape and got.dtype == want.dtype,
              f"{name}: {got.shape} {got.dtype} vs {want.shape} {want.dtype}")
        check(torch.isfinite(got).all().item(), f"{name}: non-finite output")
        err = (got.float() - want.float()).abs().max().item()
        vmax = v.float().abs().max().item()
        check(err <= ATTN_TOL[q.dtype] * vmax,
              f"{name} kernel differs from plain by {err} (max |v| {vmax}) at "
              f"q {tuple(q.shape)} k {tuple(k.shape)} {q.dtype}")
        max_err[name] = max(max_err[name], err)
        n_checked += 1
        return got, err

    batch_size = 8
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain versions' einsums
    try:
        with torch.inference_mode():
            captured, step_ms = capture_mvit_attention(batch_size)
            block_err = [{name: compare(name, q, k, v)[1] for name in kernels}
                         for q, k, v in captured]
            block1 = [t[:1].float().contiguous() for t in captured[1]]
            for name in kernels:
                fp32_err[name] = compare(name, *block1)[1]
            for shape in [(2, 131, 13, 2, 24, 16), (1, 70, 200, 2, 20, 12)]:
                for dtype in (torch.float32, torch.bfloat16):
                    for extreme in (False, True):
                        q, k, v = attention_inputs(shape, dtype, 5, extreme)
                        for name in kernels:
                            got, _ = compare(name, q, k, v)
                            if extreme and name == "flash":
                                check(got[:, 3:6].abs().max().item() == 0.0,
                                      "underflowing rows are not zero")

            groups = {}
            for i, (q, k, v) in enumerate(captured):
                groups.setdefault((tuple(q.shape), k.shape[1], v.shape[3]), []).append(i)
            totals = {name: dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0)
                      for name in kernels}
            bound_split = {"operations": 0.0, "bytes": 0.0}  # summed bound, by kind
            for blocks in groups.values():
                q, k, v = captured[blocks[0]]
                qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
                backend = SDPBackend(torch._fused_sdp_choice(qt, kt, vt, scale=1.0)).name
                library_ms = device_ms(
                    lambda: F.scaled_dot_product_attention(qt, kt, vt, scale=1.0))
                bound = attention_bound(q, k, v)
                bound_split[bound["bound_by"]] += len(blocks) * bound["bound_ms"]
                row = {"phase": "attn_kernel", "blocks": blocks, "B": q.shape[0],
                       "Nq": q.shape[1], "Nk": k.shape[1], "nh": q.shape[2],
                       "dq": q.shape[3], "dv": v.shape[3], "dtype": "bfloat16", **bound,
                       "library_ms": library_ms, "library_backend": backend}
                for name, (fn, plain) in kernels.items():
                    ms = device_ms(lambda: fn(q, k, v))
                    plain_ms = device_ms(lambda: plain(q, k, v))
                    row[name] = {"ms": ms, "plain_ms": plain_ms,
                                 "roofline_share": bound["bound_ms"] / ms,
                                 "max_abs_err": max(block_err[i][name] for i in blocks)}
                    for key, val in (("ms", ms), ("plain_ms", plain_ms),
                                     ("bound_ms", bound["bound_ms"]),
                                     ("library_ms", library_ms)):
                        totals[name][key] += len(blocks) * val
                emit(row)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    summary = {"phase": "attn_kernel", "batch_size": batch_size, "cases_checked": n_checked,
               "max_abs_err": max_err, "fp32_block1_max_abs_err": fp32_err,
               "tolerance_of_max_abs_v": {"float32": ATTN_TOL[torch.float32],
                                          "bfloat16": ATTN_TOL[torch.bfloat16]},
               "per_forward": totals, "bound_split_ms": bound_split,
               "bound_by": max(bound_split, key=bound_split.get),
               "mvit_eval_step_p50_ms": step_ms,
               "flash_share_of_step": totals["flash"]["ms"] / step_ms}
    emit(summary)
    return summary


def phase_mvit_fp32():
    """Full-width MViTv2-S, one clip, on the card against the CPU on the same
    weights, fp32 with TF32 off, with each attention core. The head is
    tempered first, so the softmax is neither uniform nor saturated."""
    from slowfast_tpu_torch.engine.steps import make_eval_step
    from slowfast_tpu_torch.models.build import build_model

    base = ["TPU.COMPUTE_DTYPE", "float32"]
    cfg = mvit_cfg(base)
    cpu_model = build_model(cfg, device="cpu")
    clip = np.random.RandomState(3).randint(
        0, 255, (1, cfg.DATA.NUM_FRAMES, cfg.DATA.TEST_CROP_SIZE, cfg.DATA.TEST_CROP_SIZE, 3)
    ).astype(np.uint8)
    temper_head(cpu_model, clip, cfg)
    state = cpu_model.state_dict()
    num_classes = cfg.MODEL.NUM_CLASSES
    launches = {}
    for core, extra in (("flash", []), ("exact", ["TPU.PALLAS_ATTENTION", "True"])):
        cfg = mvit_cfg(base + extra)
        models = {}
        for device in ("cpu", "cuda"):
            models[device] = build_model(cfg, device=device)
            models[device].load_state_dict(state, strict=True)
        t0 = time.perf_counter()
        want = make_eval_step(cfg, models["cpu"])({"inputs": [torch.from_numpy(clip)]})
        cpu_s = time.perf_counter() - t0
        tf32 = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
        try:
            reset_launches()
            got = make_eval_step(cfg, models["cuda"])(
                {"inputs": [torch.from_numpy(clip).cuda()]})
            torch.cuda.synchronize()
            launches[core] = read_launches()
            got = got.cpu()
        finally:
            torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
        err = (got - want).abs().max().item()
        other = "exact" if core == "flash" else "flash"
        check(got.shape == (1, num_classes) and torch.isfinite(got).all().item(),
              f"bad output {got.shape}")
        check(2.0 / num_classes < want.max().item() < 0.5,
              f"softmax max {want.max().item()} outside (2/{num_classes}, 0.5)")
        check(err <= FULL_WIDTH_ATOL, f"{core}: card vs CPU softmax max abs err {err}")
        check(bool(got.argmax() == want.argmax()), f"{core}: argmax differs")
        check(launches[core][f"attention_{core}"] == cfg.MVIT.DEPTH
              and launches[core][f"attention_{other}"] == 0
              and launches[core]["preprocess_u8"] == 1,
              f"{core}: launches {launches[core]}")
        emit({"phase": "mvit_fp32", "core": core, "max_abs_err": err,
              "atol": FULL_WIDTH_ATOL,
              "max_rel_err": ((got - want).abs() / want).max().item(),
              "argmax_equal": True, "max_prob": want.max().item(),
              "crop": cfg.DATA.TEST_CROP_SIZE, "frames": cfg.DATA.NUM_FRAMES,
              "cpu_forward_s": cpu_s, "launches": launches[core]})
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
    attn = phase_attn_kernel()
    fp32_launches = phase_mvit_fp32()
    mvit_launches = phase_mvit_slice()
    lines = [{
        "name": "preprocess_u8", "route": "cuda",
        "source": "slowfast_tpu_torch/csrc/preprocess.cu",
        "replaces": "slowfast_tpu/ops/preprocess.py:42",
        "launches": launches["preprocess_u8"], "max_abs_err": kernel["max_abs_err"],
        "ms": kernel["ms"], "plain_ms": kernel["plain_ms"],
        "bound_ms": kernel["bound_ms"], "bound_by": kernel["bound_by"],
        "library_ms": None,
    }]
    # Attention: per MViTv2-S forward at B=8 in bf16, summed over its 16
    # blocks. The constant-shift core's launches are the MViT test's; the
    # exact core runs on the model path only under TPU.PALLAS_ATTENTION,
    # so its launches are those of phase mvit_fp32's exact run.
    for core, replaces, n in (
            ("flash", "slowfast_tpu/ops/pallas_attention.py:375",
             mvit_launches["attention_flash"]),
            ("exact", "slowfast_tpu/ops/pallas_attention.py:39",
             fp32_launches["exact"]["attention_exact"])):
        tot = attn["per_forward"][core]
        lines.append({
            "name": f"attention_{core}", "route": "cuda",
            "source": "slowfast_tpu_torch/csrc/pooled_attention.cu",
            "replaces": replaces, "launches": n, "max_abs_err": attn["max_abs_err"][core],
            "ms": tot["ms"], "plain_ms": tot["plain_ms"], "bound_ms": tot["bound_ms"],
            "bound_by": attn["bound_by"], "library_ms": tot["library_ms"],
        })
    emit({"kernels": lines})
    print(info["nvidia_smi"], flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": info["name"],
                                 "count": info["count"]}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
