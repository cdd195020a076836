"""``run_net`` on 2 gloo ranks on the CPU (``--device cpu --opts NUM_GPUS
2``): the launcher spawns the ranks for training and again for the test.

Narrow Slow R18 (width 8, 4 frames of 32²) on 9 synthetic clips in global
batches of 4: an epoch of 2 steps, a val epoch whose last batch is padded
for the ranks, and the epoch's checkpoint; a second ``run_net`` in the
same ``OUTPUT_DIR`` with ``SOLVER.MAX_EPOCH 2`` resumes from it, trains
epoch 2 only and runs the 3-view test. Against one process (``NUM_GPUS
1``) on the same options: the parameters after both epochs within 1e-4
relative L2, the one process resumed the same way (the cosine LR follows
``MAX_EPOCH``; fp32 rounding moves the runs apart, the per-step parity is
held in tests/test_torch_ddp*.py), and the one process's test of the 2-rank
run's checkpoint gives the same per-video scores (within 1e-6) and
accuracies as the 2-rank test. Only the master writes the logs and
checkpoints.

Every launch of a job meets at a rendezvous of its own: the second
``run_net`` launches training and then the test on one ``file://`` path,
whose store file a group can leave behind with its ranks' addresses.
``test_two_launches_on_one_file_rendezvous_meet`` makes the first group
leave its store file and checks that the second launch on the same path
meets all the same.
"""

import functools
import json
import os
import pickle

import numpy as np
import pytest
import torch

from ddp_harness import params_and_buffers, rel_l2

from slowfast_tpu_torch.config import get_cfg
from slowfast_tpu_torch.utils.multiprocessing import fresh_rendezvous, launch_job, store_file

OPTS = ["MODEL.MODEL_NAME", "ResNet", "MODEL.ARCH", "slow", "RESNET.DEPTH", "18",
        "RESNET.WIDTH_PER_GROUP", "8", "RESNET.NUM_BLOCK_TEMP_KERNEL", "[[2],[2],[2],[2]]",
        "DATA.INPUT_CHANNEL_NUM", "[3]", "DATA.NUM_FRAMES", "4", "DATA.TRAIN_CROP_SIZE", "32",
        "DATA.TEST_CROP_SIZE", "32", "MODEL.NUM_CLASSES", "6", "MODEL.DROPOUT_RATE", "0.0",
        "TRAIN.DATASET", "syntheticvideo", "TEST.DATASET", "syntheticvideo",
        "DATA.SYNTHETIC_SIZE", "9", "TRAIN.BATCH_SIZE", "4", "TEST.BATCH_SIZE", "4",
        "TEST.NUM_ENSEMBLE_VIEWS", "3", "TEST.NUM_SPATIAL_CROPS", "1",
        "SOLVER.BASE_LR", "0.01", "SOLVER.WARMUP_EPOCHS", "0.0", "BN.USE_PRECISE_STATS", "False",
        "DATA_LOADER.NUM_WORKERS", "2", "TPU.COMPUTE_DTYPE", "float32", "LOG_PERIOD", "1"]


def run_net(out_dir, gpus, epochs, test, extra=()):
    from slowfast_tpu_torch.run_net import main

    main(["--device", "cpu", "--init_method", f"file://{out_dir}/rendezvous", "--opts", *OPTS,
          "NUM_GPUS", str(gpus), "SOLVER.MAX_EPOCH", str(epochs), "TEST.ENABLE", str(test),
          "OUTPUT_DIR", str(out_dir), "TEST.SAVE_RESULTS_PATH", f"{out_dir}/results.pkl",
          *extra])


def logged(out_dir):
    with open(out_dir / "json_stats.log") as f:
        return [json.loads(line.split("json_stats: ", 1)[1]) for line in f]


def checkpoint(out_dir, epoch):
    path = out_dir / "checkpoints" / f"checkpoint_epoch_{epoch:05d}.pyth"
    return torch.load(path, map_location="cpu", weights_only=True)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    two, one = tmp_path_factory.mktemp("two_ranks"), tmp_path_factory.mktemp("one")
    run_net(two, 2, 1, False)
    first = logged(two)
    run_net(two, 2, 2, True)
    run_net(one, 1, 1, False)
    run_net(one, 1, 2, False)
    test_dir = tmp_path_factory.mktemp("one_test")
    run_net(test_dir, 1, 2, True, ["TRAIN.ENABLE", "False", "TEST.CHECKPOINT_FILE_PATH",
                                   str(two / "checkpoints" / "checkpoint_epoch_00002.pyth")])
    return {"two": two, "one": one, "first": first, "test_dir": test_dir}


def test_two_ranks_train_checkpoint_resume_and_test(runs):
    first, after = runs["first"], logged(runs["two"])
    assert [s["epoch"] for s in first if s["_type"] == "train_epoch"] == ["1/1"]
    assert [s["epoch"] for s in first if s["_type"] == "val_epoch"] == ["1/1"]
    # The resumed run trains epoch 2 only, then tests.
    assert [s["epoch"] for s in after if s["_type"] == "train_epoch"] == ["1/1", "2/2"]
    assert [s["iter"] for s in after if s["_type"] == "train_iter"] == ["1/2", "2/2"] * 2
    assert [s for s in after if s["_type"] == "test_final"]
    assert checkpoint(runs["two"], 1)["epoch"] == 0 and checkpoint(runs["two"], 2)["epoch"] == 1


def test_two_ranks_train_as_one_process(runs):
    got, want = checkpoint(runs["two"], 2), checkpoint(runs["one"], 2)
    params, buffers = params_and_buffers(want["model_state"])
    assert rel_l2(got["model_state"], want["model_state"], params) <= 1e-4
    assert rel_l2(got["model_state"], want["model_state"], buffers) <= 1e-4
    assert got["optimizer_state"]["count"] == want["optimizer_state"]["count"] == 4


def test_two_rank_test_matches_one_process_on_its_checkpoint(runs):
    with open(runs["two"] / "results.pkl", "rb") as f:
        got = pickle.load(f)
    with open(runs["test_dir"] / "results.pkl", "rb") as f:
        want = pickle.load(f)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(got[1], want[1])
    final = lambda d: [s for s in logged(d) if s["_type"] == "test_final"]  # noqa: E731
    assert final(runs["two"]) == final(runs["test_dir"])


def _meet(leave, out_dir, cfg, device):
    """One rank: all-reduce its rank + 1 and write the sum; with ``leave``,
    end the process without leaving the group, so its store file stays."""
    import torch.distributed as dist

    x = torch.tensor([dist.get_rank() + 1.0])
    dist.all_reduce(x)
    with open(os.path.join(out_dir, f"{os.path.basename(cfg.INIT_METHOD)}.{dist.get_rank()}"),
              "w") as f:
        f.write(str(x.item()))
    if leave:
        os._exit(0)


def test_two_launches_on_one_file_rendezvous_meet(tmp_path):
    cfg = get_cfg()
    cfg.NUM_GPUS = 2
    cfg.INIT_METHOD = f"file://{tmp_path}/rendezvous"
    for leave in (True, False):
        launch_job(cfg, "cpu", functools.partial(_meet, leave, str(tmp_path)))
    sums = {p.name: p.read_text() for p in tmp_path.iterdir()}
    assert sorted(sums.values()) == ["3.0"] * 4 and len({n[:-2] for n in sums}) == 2, sums


def test_fresh_rendezvous_names_each_launch(tmp_path):
    cfg = get_cfg()
    cfg.INIT_METHOD = "tcp://localhost:9999"
    assert fresh_rendezvous(cfg).INIT_METHOD == "tcp://localhost:9999"
    cfg.INIT_METHOD = f"file://{tmp_path}/rendezvous"
    first, second = fresh_rendezvous(cfg), fresh_rendezvous(cfg)
    assert first.INIT_METHOD != second.INIT_METHOD and cfg.INIT_METHOD.endswith("rendezvous")
    assert store_file(first).startswith(f"{tmp_path}/rendezvous.")
    left = store_file(cfg) + "." + str(int(store_file(second).rsplit(".", 1)[1]) + 1)
    with open(left, "w") as f:
        f.write("an earlier group's store")
    assert store_file(fresh_rendezvous(cfg)) == left and not os.path.exists(left)
