"""The data-loading benchmark (counterpart of tools/benchmark.py; reference
slowfast/utils/benchmark.py):

    python -m slowfast_tpu_torch.utils.benchmark --cfg <yaml> [--opts ...]
    python -m slowfast_tpu_torch.utils.benchmark --cfg <yaml> --core-budget

``benchmark_data_loading`` iterates the train loader alone, no model, for
``BENCHMARK.NUM_EPOCHS`` epochs (reshuffled under ``BENCHMARK.SHUFFLE``),
logging ``{"_type": "benchmark", "epoch", "iter", "clips_per_s"}`` every
``BENCHMARK.LOG_PERIOD`` batches and each epoch's overall clips/s. The
batches land on ``--device`` (a card by default), as a training run's do;
on a card the clock is read after the copies end.

``benchmark_core_budget`` times one worker making Kinetics train items
over the port's cv2 decode path on a corpus of 340×256 mp4s: the clips
per CPU-second of one core, and the cores a device rate needs.

The JAX package's ``--jpeg`` and ``--video-decode`` time its native JPEG
and FFmpeg decoders against cv2; the port decodes with cv2 only (the
native decoders are not queued for porting), so those flags raise.
"""

import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

from slowfast_tpu_torch.utils import logging as logging_utils
from slowfast_tpu_torch.utils.logging import log_json_stats

logger = logging_utils.get_logger(__name__)

NATIVE_FLAGS = ("--jpeg", "--video-decode")
FLAGSHIP_YAML = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "configs", "Kinetics", "SLOWFAST_4x16_R50.yaml")


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def benchmark_data_loading(cfg, device="cuda"):
    """Returns each epoch's overall clips/s."""
    from slowfast_tpu_torch.data import construct_loader, shuffle_dataset
    from slowfast_tpu_torch.models.build import resolve_device

    device = resolve_device(device)
    logging_utils.setup_logging(cfg.OUTPUT_DIR)
    loader = construct_loader(cfg, "train", device)
    batch_size, log_period = cfg.TRAIN.BATCH_SIZE, cfg.BENCHMARK.LOG_PERIOD
    rates = []
    for epoch in range(cfg.BENCHMARK.NUM_EPOCHS):
        if cfg.BENCHMARK.SHUFFLE:
            shuffle_dataset(loader, epoch)
        t0 = last = time.time()
        n = 0
        for cur_iter, _ in enumerate(loader):
            n = cur_iter + 1
            if n % log_period == 0:
                _sync(device)
                now = time.time()
                log_json_stats({"_type": "benchmark", "epoch": epoch, "iter": n,
                                "clips_per_s": log_period * batch_size / (now - last)},
                               cfg.OUTPUT_DIR)
                last = now
        _sync(device)
        rates.append(n * batch_size / (time.time() - t0))
        logger.info("Epoch %d: %.1f clips/s overall", epoch, rates[-1])
    return rates


def benchmark_core_budget(cfg=None, target_rates=(182.0, 290.0), n_samples=48, corpus=None):
    """One worker's Kinetics train items over ``corpus`` (16 mp4s of
    340×256 written to a temporary directory when None), on ``cfg`` (the
    flagship SlowFast 4×16 recipe when None). Prints and returns the JSON
    record."""
    from slowfast_tpu_torch.config import assert_and_infer_cfg, get_cfg
    from slowfast_tpu_torch.data.kinetics import Kinetics
    from slowfast_tpu_torch.data.synth_media import make_video_corpus

    if cfg is None:
        cfg = get_cfg()
        cfg.merge_from_file(FLAGSHIP_YAML)
        cfg.merge_from_list(["NUM_GPUS", "1"])
        cfg = assert_and_infer_cfg(cfg)
    cfg = cfg.clone()
    cfg.TRAIN.DATASET = "kinetics"
    cfg.DATA_LOADER.NUM_WORKERS = 1
    with tempfile.TemporaryDirectory() as tmp:
        if corpus is None:
            corpus = make_video_corpus(tmp, {"train": 16}, frames=140)
        cfg.DATA.PATH_TO_DATA_DIR = corpus
        ds = Kinetics(cfg, "train")
        ds[0]  # the first file's open
        t0, cpu0 = time.time(), time.process_time()
        for i in range(n_samples):
            ds[i % len(ds)]
        wall, cpu = time.time() - t0, time.process_time() - cpu0
    per_core = n_samples / cpu
    record = {"_type": "benchmark_core_budget", "clips_per_core_sec": round(per_core, 2),
              "cpu_ms_per_clip": round(1000 * cpu / n_samples, 1),
              "wall_clips_per_sec_1worker": round(n_samples / wall, 2),
              "cores_needed": {str(r): int(np.ceil(r / per_core)) for r in target_rates}}
    print(json.dumps(record), flush=True)
    return record


def main(argv=None):
    from slowfast_tpu_torch.config import assert_and_infer_cfg
    from slowfast_tpu_torch.utils.parser import load_config, parse_args

    argv = list(sys.argv[1:] if argv is None else argv)
    for flag in NATIVE_FLAGS:
        if flag in argv:
            raise NotImplementedError(
                f"{flag} times the JAX package's native decoders (slowfast_tpu/native), which "
                "the port does not have: it decodes with cv2 for every DATA.DECODING_BACKEND")
    core_budget = "--core-budget" in argv
    if core_budget:
        argv.remove("--core-budget")
    args = parse_args(argv)
    for path_to_config in args.cfg_files or [None]:
        cfg = assert_and_infer_cfg(load_config(args, path_to_config))
        if core_budget:
            benchmark_core_budget(cfg if path_to_config else None)
        else:
            benchmark_data_loading(cfg, args.device)


if __name__ == "__main__":
    main()
