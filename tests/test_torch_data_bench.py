"""The data-loading benchmark of the port against the JAX package's
(tools/benchmark.py), on the CPU.

``benchmark_data_loading`` on ``Syntheticvideo`` (6 clips of 4 frames,
batches of 2, 2 epochs, a record every batch): the same ``benchmark``
records as the JAX tool's, epoch by epoch and batch by batch, each rate
positive; through the module's command line too. ``benchmark_core_budget``
over the port's cv2 decode path on a small mp4 corpus gives the JAX
tool's record. The JAX tool's ``--jpeg`` and ``--video-decode`` time its
native decoders, which the port does not have: they raise.
"""

import json

import pytest

from slowfast_tpu.config import get_cfg as jax_get_cfg
from slowfast_tpu_torch.config import get_cfg
from slowfast_tpu_torch.utils import benchmark

OPTS = ["TRAIN.DATASET", "syntheticvideo", "DATA.SYNTHETIC_SIZE", "6", "TRAIN.BATCH_SIZE", "2",
        "DATA.NUM_FRAMES", "4", "DATA.TRAIN_CROP_SIZE", "32", "DATA.TRAIN_JITTER_SCALES",
        "[36, 40]", "DATA.INPUT_CHANNEL_NUM", "[3]", "MODEL.ARCH", "slow", "NUM_GPUS", "1",
        "DATA_LOADER.NUM_WORKERS", "2", "BENCHMARK.NUM_EPOCHS", "2", "BENCHMARK.LOG_PERIOD",
        "1", "BENCHMARK.SHUFFLE", "True"]


def records(out_dir):
    with open(out_dir / "json_stats.log") as f:
        return [json.loads(line.split("json_stats: ", 1)[1]) for line in f]


def cfg_of(get, out_dir):
    cfg = get()
    cfg.merge_from_list(OPTS + ["OUTPUT_DIR", str(out_dir)])
    return cfg


def test_benchmark_records_match_jax(tmp_path):
    from tools.benchmark import benchmark_data_loading as jax_benchmark

    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    jax_benchmark(cfg_of(jax_get_cfg, tmp_path / "jax"))
    rates = benchmark.benchmark_data_loading(cfg_of(get_cfg, tmp_path / "port"), "cpu")
    want, got = records(tmp_path / "jax"), records(tmp_path / "port")
    strip = lambda rs: [{k: v for k, v in r.items() if k != "clips_per_s"} for r in rs]  # noqa
    assert strip(got) == strip(want) == [{"_type": "benchmark", "epoch": e, "iter": i}
                                         for e in range(2) for i in (1, 2, 3)]
    assert all(r["clips_per_s"] > 0 for r in got) and len(rates) == 2 and min(rates) > 0


def test_benchmark_command_line(tmp_path):
    benchmark.main(["--device", "cpu", "--opts", *OPTS, "BENCHMARK.NUM_EPOCHS", "1",
                    "OUTPUT_DIR", str(tmp_path)])
    assert [(r["epoch"], r["iter"]) for r in records(tmp_path)] == [(0, 1), (0, 2), (0, 3)]


def test_core_budget_record(tmp_path, capsys):
    from slowfast_tpu_torch.config import assert_and_infer_cfg
    from slowfast_tpu_torch.data.synth_media import make_video_corpus

    corpus = make_video_corpus(str(tmp_path), {"train": 2}, frames=40, size=(96, 72))
    cfg = assert_and_infer_cfg(cfg_of(get_cfg, tmp_path))
    record = benchmark.benchmark_core_budget(cfg, n_samples=4, corpus=corpus)
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == record
    # The JAX tool's record (tools/benchmark.py:193-205).
    assert sorted(record) == ["_type", "clips_per_core_sec", "cores_needed", "cpu_ms_per_clip",
                              "wall_clips_per_sec_1worker"]
    assert record["_type"] == "benchmark_core_budget" and record["clips_per_core_sec"] > 0
    assert sorted(record["cores_needed"]) == ["182.0", "290.0"]
    assert 1 <= record["cores_needed"]["182.0"] <= record["cores_needed"]["290.0"]


@pytest.mark.parametrize("flag", benchmark.NATIVE_FLAGS)
def test_native_decoder_flags_raise(flag):
    with pytest.raises(NotImplementedError, match="native decoders"):
        benchmark.main([flag])
