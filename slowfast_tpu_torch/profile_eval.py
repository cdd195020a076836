"""Where an eval step's device time goes: ``torch.profiler`` over a few
steps on one seeded uint8 batch that already lies on the card, for any
registered model (train steps: ``profile_step.py``).

    python -m slowfast_tpu_torch.profile_eval --cfg configs/Kinetics/MVITv2_S_16x4.yaml \\
        [--steps 3] [--top 12] [--opts NUM_GPUS 1 TEST.BATCH_SIZE 8 ...]

The eval step runs on ``TEST.BATCH_SIZE`` clips of ``TEST_CROP_SIZE``. A
detection config (``DETECTION.ENABLE``) profiles on the synthetic
detection items of that many clips: 1-5 boxes a clip, padded to their
bucket, with multi-hot labels. A masked-pretraining recipe
(``AUG.GEN_MASK_LOADER``) gets one loader mask a clip
(``kinetics.gen_mask``, seeded).

Prints one JSON line: the median step time on the host clock (each step
ends in a synchronize), the kernel time per step, the device's idle share
of the profiled window, the kernel time by category and the top kernels by
name. Needs a CUDA card.
"""

import argparse
import collections
import json
import re
import statistics
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from slowfast_tpu_torch.config import assert_and_infer_cfg, get_cfg
from slowfast_tpu_torch.engine.steps import make_eval_step
from slowfast_tpu_torch.models.build import build_model

# First match wins; names are CUDA kernel names as the profiler reports them.
CATEGORIES = [
    ("nccl", r"nccl"),  # the process group's collectives
    ("attention_bwd", r"attention_bwd|exact_bwd|flash_bwd|fused_bwd|sum_slices"),
    ("attention_core", r"pooled_attention|exact_fwd|flash_fwd|pack_tiles"),
    ("preprocess", r"preprocess_u8"),
    ("roi_align", r"roi_align"),
    ("conv", r"conv|cudnn|implicit|depthwise|winograd|fft|dgrad|wgrad|xmma_fprop"),
    ("gemm", r"gemm|gemv|cutlass|nvjet|xmma|sm90_|sm80_|ampere|magma"),
    ("layer_norm", r"layer_norm|LayerNorm"),
    ("batch_norm", r"batch_norm|BatchNorm"),
    ("softmax", r"softmax"),
    ("pool", r"pool"),
    ("copy_cat_pad", r"Cat|cat_|copy|Copy|pad|Pad|index|Index|gather|Gather"),
    ("reduce", r"reduce|Reduce"),
    ("elementwise", r"elementwise|vectorized|unrolled|Elementwise"),
]


def category(name):
    for cat, pattern in CATEGORIES:
        if re.search(pattern, name):
            return cat
    return "other"


def merged_busy_us(intervals):
    """Length of the union of (start, end) intervals."""
    busy, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return busy


def synthetic_batch(cfg, batch_size, crop, train, device="cuda"):
    """One seeded step batch of ``batch_size`` uint8 clips of ``crop`` on
    ``device``: labels, ``epoch_exact`` 0, a detection recipe's synthetic
    items' boxes (``train`` picks the split), a masked recipe's loader masks
    (``AUG.GEN_MASK_LOADER``)."""
    gen = torch.Generator(device=device).manual_seed(0)
    size = (batch_size, cfg.DATA.NUM_FRAMES, crop, crop, 3)
    batch = {"inputs": [torch.randint(0, 256, size, dtype=torch.uint8, device=device,
                                      generator=gen)],
             "labels": torch.randint(0, cfg.MODEL.NUM_CLASSES, (batch_size,), device=device,
                                     generator=gen),
             "epoch_exact": 0.0}
    if cfg.DETECTION.ENABLE:
        from slowfast_tpu_torch.data.kinetics import Syntheticvideo
        from slowfast_tpu_torch.data.loader import detection_collate

        data = Syntheticvideo(cfg, "train" if train else "test")
        inputs, labels, _, _, meta = detection_collate([data[i] for i in range(batch_size)])
        batch.update(inputs=[torch.from_numpy(inputs[0]).to(device)],
                     labels=torch.from_numpy(labels).to(device),
                     boxes=torch.from_numpy(meta["boxes"]).to(device),
                     box_mask=torch.from_numpy(meta["box_mask"]).to(device))
    if cfg.AUG.GEN_MASK_LOADER:
        from slowfast_tpu_torch.data.kinetics import gen_mask
        from slowfast_tpu_torch.data.utils import sample_rngs

        masks = [gen_mask(cfg, *sample_rngs(cfg.RNG_SEED, 0, i)) for i in range(batch_size)]
        batch["mask"] = torch.from_numpy(np.stack(masks)).to(device)
    return batch


def kernel_stats(events):
    """``(kernel events, kernel µs, the device's idle share)`` of profiler
    ``events``: the idle share is the part of the window from the first
    event to the last in which no kernel ran."""
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    spans = [(e.time_range.start, e.time_range.end) for e in events]
    window_us = max(e for _, e in spans) - min(s for s, _ in spans) if spans else 0.0
    busy_us = merged_busy_us([(e.time_range.start, e.time_range.end) for e in kernels])
    return (kernels, sum(e.time_range.elapsed_us() for e in kernels),
            1.0 - busy_us / window_us if kernels and window_us else None)


def profile_eval(cfg, steps=3, top=12):
    """Profile ``steps`` eval steps of ``cfg``'s model on the card."""
    if not torch.cuda.is_available():
        raise RuntimeError("profile_eval needs a CUDA card")
    model = build_model(cfg, device="cuda")
    batch_size = cfg.TEST.BATCH_SIZE
    step = make_eval_step(cfg, model)
    batch = synthetic_batch(cfg, batch_size, cfg.DATA.TEST_CROP_SIZE, False)
    torch.cuda.reset_peak_memory_stats()
    for _ in range(2):
        step(batch)
    torch.cuda.synchronize()
    host_ms = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            t0 = time.perf_counter()
            step(batch)
            torch.cuda.synchronize()
            host_ms.append((time.perf_counter() - t0) * 1e3)
    kernels, kernel_us, idle = kernel_stats(list(prof.events()))
    by_name = collections.Counter()
    by_cat = collections.Counter()
    for e in kernels:
        us = e.time_range.elapsed_us()
        by_name[e.name] += us
        by_cat[category(e.name)] += us
    return {
        "model": cfg.MODEL.MODEL_NAME, "step": "eval",
        "batch_size": batch_size, "dtype": cfg.TPU.COMPUTE_DTYPE, "steps": steps,
        "max_memory_allocated": torch.cuda.max_memory_allocated(),
        "device": torch.cuda.get_device_name(0),
        "step_p50_ms": statistics.median(host_ms),
        "kernel_ms_per_step": kernel_us / steps / 1e3,
        "kernels_per_step": len(kernels) / steps,
        "idle_share": idle,
        "by_category_ms_per_step": {k: v / steps / 1e3 for k, v in by_cat.most_common()},
        "top_kernels_ms_per_step": [[n[:120], v / steps / 1e3]
                                    for n, v in by_name.most_common(top)],
    }


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--cfg", required=True)
    parser.add_argument("--steps", type=int, default=3)
    parser.add_argument("--top", type=int, default=12)
    parser.add_argument("--opts", nargs=argparse.REMAINDER, default=[])
    args = parser.parse_args(argv)
    cfg = get_cfg()
    cfg.merge_from_file(args.cfg)
    cfg.merge_from_list(list(args.opts))
    print(json.dumps(profile_eval(assert_and_infer_cfg(cfg), args.steps, args.top)),
          flush=True)


if __name__ == "__main__":
    main()
