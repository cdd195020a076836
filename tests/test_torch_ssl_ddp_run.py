"""``run_net`` SSL pretraining on 2 gloo ranks on the CPU (``--device cpu
--opts NUM_GPUS 2``): the MoCo recipe (configs/contrastive_ssl/
MoCo_SlowR50_8x8.yaml, multi-view queue) narrowed as
tests/test_torch_ssl_run.py narrows it, on an mp4 corpus of 8 train and 3
val clips (``data/synth_media.py``), global batches of 4.

The 2-rank job trains one epoch of 2 steps, probes the kNN bank on the val
split (whose last batch the loader pads for the ranks) and writes the
epoch's checkpoint with its SSL state; a second 2-rank ``run_net`` in the
same ``OUTPUT_DIR`` with ``SOLVER.MAX_EPOCH 2`` resumes from it and trains
epoch 2. Against one process (``NUM_GPUS 1``) run the same way: the bank
sized by the whole train set; after epoch 1 (the queue's warm-up: no
update) the same parameters and the queue, bank and momentum encoder
within 1e-4 relative L2; epoch 2's change of the parameters within 5e-2
relative L2 (the decoded clips' flat regions tie in the stem's max pool,
and the two runs' fp32 forwards, an ulp apart, break the ties apart; the
per-step parity is held in float64, and against JAX, in
tests/test_torch_ssl_ddp*.py). Only the master writes the logs and
checkpoints.
"""

import json
import os

import pytest
import torch

from test_torch_train import one_torch_thread  # noqa: F401  (autouse fixture)

pytest.importorskip("cv2")

YAML = os.path.join(os.path.dirname(__file__), "..", "configs", "contrastive_ssl",
                    "MoCo_SlowR50_8x8.yaml")
NARROW = ["RESNET.DEPTH", "18", "RESNET.WIDTH_PER_GROUP", "8",
          "RESNET.NUM_BLOCK_TEMP_KERNEL", "[[2], [2], [2], [2]]", "DATA.NUM_FRAMES", "4",
          "DATA.SAMPLING_RATE", "4", "DATA.TRAIN_CROP_SIZE", "32", "DATA.TEST_CROP_SIZE", "32",
          "DATA.TRAIN_JITTER_SCALES", "[40, 48]", "CONTRASTIVE.MLP_DIM", "64",
          "CONTRASTIVE.QUEUE_LEN", "8", "DATA.TRAIN_CROP_NUM_TEMPORAL", "2",
          "TRAIN.BATCH_SIZE", "4", "TEST.ENABLE", "False", "TPU.COMPUTE_DTYPE", "float32",
          "DATA_LOADER.NUM_WORKERS", "2", "LOG_PERIOD", "1"]


def run_net(corpus, out_dir, gpus, epochs):
    from slowfast_tpu_torch.run_net import main

    # A rendezvous file of each run's own: a store file the last run left
    # behind must not meet the next run's ranks.
    main(["--device", "cpu", "--init_method", f"file://{out_dir}/rendezvous{epochs}", "--cfg", YAML,
          "--opts", *NARROW, "DATA.PATH_TO_DATA_DIR", corpus, "NUM_GPUS", str(gpus),
          "SOLVER.MAX_EPOCH", str(epochs), "OUTPUT_DIR", str(out_dir)])


def logged(out_dir):
    with open(out_dir / "json_stats.log") as f:
        return [json.loads(line.split("json_stats: ", 1)[1]) for line in f]


def checkpoint(out_dir, epoch):
    path = out_dir / "checkpoints" / f"ssl_checkpoint_epoch_{epoch:05d}.pyth"
    return torch.load(path, map_location="cpu", weights_only=True)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from slowfast_tpu_torch.data import synth_media

    corpus = synth_media.make_video_corpus(str(tmp_path_factory.mktemp("corpus")),
                                           {"train": 8, "val": 3, "test": 2},
                                           frames=80, size=(160, 120))
    two, one = tmp_path_factory.mktemp("two_ranks"), tmp_path_factory.mktemp("one")
    firsts = []
    for out_dir, gpus in ((two, 2), (one, 1)):
        run_net(corpus, out_dir, gpus, 1)
        firsts.append(checkpoint(out_dir, 1))
        run_net(corpus, out_dir, gpus, 2)
    return two, one, firsts


def rel_l2(a, b):
    return ((a.double() - b.double()).norm() / b.double().norm()).item()


def test_two_ranks_pretrain_checkpoint_and_resume(runs):
    two, one, (first, _) = runs
    assert first["epoch"] == 0 and first["ssl_state"]["iter"] == 2
    # Both views' keys of 2 global batches of 4 went into the queue of 8.
    assert first["ssl_state"]["ptr"] == 0 and first["ssl_state"]["queue_x"].shape[0] == 8
    resumed = checkpoint(two, 2)
    assert resumed["epoch"] == 1 and resumed["ssl_state"]["iter"] == 4
    stats = logged(two)
    # The resumed job logs epoch 2 only; the master alone writes the lines.
    assert [s["epoch"] for s in stats if s["_type"] == "train_epoch"] == ["1/1", "2/2"]
    assert [s["epoch"] for s in stats if s["_type"] == "knn_epoch"] == [1, 2]
    assert sum(s["_type"] == "train_iter" for s in stats) == 4
    assert not any(name.startswith("stdout") and name != "stdout.log"
                   for name in os.listdir(two))


def flat(state, names):
    return torch.cat([state[k].flatten().double() for k in names])


def test_two_ranks_match_one_process(runs):
    two, one, (got1, want1) = runs
    got, want = checkpoint(two, 2), checkpoint(one, 2)
    # CONTRASTIVE.LENGTH is the whole train set's: a bank row a clip.
    assert got["ssl_state"]["memory"].shape[0] == want["ssl_state"]["memory"].shape[0] == 8
    params = [k for k in want["model_state"] if "running" not in k and "num_batches" not in k]
    assert all(torch.equal(got1["model_state"][k], want1["model_state"][k]) for k in params)
    for k in ("queue_x", "memory"):
        assert rel_l2(got1["ssl_state"][k], want1["ssl_state"][k]) <= 1e-4, k
    hist = sorted(k for k in want1["ssl_state"]["hist"] if "num_batches" not in k)
    assert rel_l2(flat(got1["ssl_state"]["hist"], hist),
                  flat(want1["ssl_state"]["hist"], hist)) <= 1e-4
    change = [flat(a["model_state"], params) - flat(b["model_state"], params)
              for a, b in ((got, got1), (want, want1))]
    assert 0 < rel_l2(*change) <= 5e-2
    assert ([s["top1_acc"] for s in logged(two) if s["_type"] == "knn_epoch"]
            == [s["top1_acc"] for s in logged(one) if s["_type"] == "knn_epoch"])
