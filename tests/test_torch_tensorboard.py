"""TensorBoard in the port's trainer against the JAX package's, on the CPU.

Narrow Slow R18 (width 8, 4 frames of 32²) on 4 synthetic clips of 6
classes, global batches of 4, 2 epochs of one step and one val batch (a
third fp32 step of the two packages can part by 1e-3 where one flips a
ReLU or max-pool near-tie, ROADMAP Queue 3 #4), with ``TENSORBOARD.ENABLE``
and the confusion matrix and top-3 histograms on. The JAX trainer
(slowfast_tpu/engine/trainer.py, on one device) and the port's ``run_net``
start from the same weights, a PySlowFast
``.pyth`` in ``TRAIN.CHECKPOINT_FILE_PATH``, and train on the same clips
in the same order. Their event files (``OUTPUT_DIR/runs-syntheticvideo``)
hold the same scalar tags (``Train/loss``, ``Train/lr``,
``Train/Top1_err``, ``Train/Top5_err`` at ``data_size · epoch + iter``,
``Val/top1_err`` and ``Val/top5_err`` at the epoch) at the same steps, the
values within 1e-4, and the same figures (``Confusion Matrix``,
``Hist/<class>``). The writer's pieces (the confusion matrix, the class
names, the subsets and parent categories) are held against the JAX
package's too. The 2-rank job is in tests/test_torch_tensorboard_ranks.py.
"""

import json
import os
import sys
import types

import numpy as np
import pytest
import torch

from test_torch_train import one_torch_thread  # noqa: F401  (autouse fixture)

OPTS = ["MODEL.MODEL_NAME", "ResNet", "MODEL.ARCH", "slow", "RESNET.DEPTH", "18",
        "RESNET.WIDTH_PER_GROUP", "8", "RESNET.NUM_BLOCK_TEMP_KERNEL", "[[2],[2],[2],[2]]",
        "DATA.INPUT_CHANNEL_NUM", "[3]", "DATA.NUM_FRAMES", "4", "DATA.TRAIN_CROP_SIZE", "32",
        "DATA.TEST_CROP_SIZE", "32", "MODEL.NUM_CLASSES", "6", "MODEL.DROPOUT_RATE", "0.0",
        "TRAIN.DATASET", "syntheticvideo", "TEST.DATASET", "syntheticvideo",
        "DATA.SYNTHETIC_SIZE", "4", "TRAIN.BATCH_SIZE", "4", "SOLVER.BASE_LR", "0.01",
        "SOLVER.WARMUP_EPOCHS", "0.0", "SOLVER.MAX_EPOCH", "2", "TRAIN.EVAL_PERIOD", "1",
        "BN.USE_PRECISE_STATS", "False",
        "DATA_LOADER.NUM_WORKERS", "2", "TPU.COMPUTE_DTYPE", "float32", "LOG_PERIOD", "1",
        "TEST.ENABLE", "False", "TRAIN.CHECKPOINT_TYPE", "pytorch", "LOG_MODEL_INFO", "False",
        "TENSORBOARD.ENABLE", "True", "TENSORBOARD.CONFUSION_MATRIX.ENABLE", "True",
        "TENSORBOARD.HISTOGRAM.ENABLE", "True", "TENSORBOARD.HISTOGRAM.TOPK", "3"]


def events(out_dir):
    """The scalars (``{tag: [(step, value)]}``), the figure tags and the
    event files under the run's TensorBoard directory."""
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    log_dir = os.path.join(str(out_dir), "runs-syntheticvideo")
    acc = EventAccumulator(log_dir, size_guidance={"scalars": 0, "images": 0})
    acc.Reload()
    scalars = {t: [(e.step, e.value) for e in acc.Scalars(t)] for t in acc.Tags()["scalars"]}
    files = [f for f in os.listdir(log_dir) if f.startswith("events.out.tfevents")]
    return scalars, sorted(acc.Tags()["images"]), files


def no_tensorflow():
    """TensorBoard's own switch to its TensorFlow stub
    (``tensorboard.compat.notf``): the writer then imports what it imports
    on the card's host, which has no TensorFlow, not this host's
    TensorFlow (12 s)."""
    sys.modules.setdefault("tensorboard.compat.notf", types.ModuleType("tensorboard.compat.notf"))


def init_checkpoint(root):
    """A PySlowFast ``.pyth`` of the port's seeded model for ``OPTS``: the
    runs' common start (``TRAIN.CHECKPOINT_FILE_PATH``)."""
    from slowfast_tpu_torch.config import get_cfg
    from slowfast_tpu_torch.models.build import build_model

    cfg = get_cfg()
    cfg.merge_from_list(OPTS)
    path = str(root / "init.pyth")
    torch.save({"model_state": build_model(cfg, device="cpu").state_dict()}, path)
    return path


def port_run(root, init, gpus):
    """The port's ``run_net`` on ``gpus`` gloo ranks from ``init``, on one
    thread a process (as ``one_torch_thread``: beside JAX's thread pools
    more threads crawl); returns its event files' ``events``."""
    from slowfast_tpu_torch.run_net import main

    out = root / f"port{gpus}"
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        main(["--device", "cpu", "--init_method", f"file://{out}_rendezvous", "--opts", *OPTS,
              "TRAIN.CHECKPOINT_FILE_PATH", init, "NUM_GPUS", str(gpus), "OUTPUT_DIR", str(out)])
    finally:
        torch.set_num_threads(threads)
    return events(out)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from slowfast_tpu.config import get_cfg as jax_get_cfg
    from slowfast_tpu.engine import trainer as jax_trainer

    no_tensorflow()
    root = tmp_path_factory.mktemp("tensorboard")
    init = init_checkpoint(root)
    port = port_run(root, init, 1)
    (root / "jax").mkdir()
    jcfg = jax_get_cfg()
    jcfg.merge_from_list(OPTS + ["TRAIN.CHECKPOINT_FILE_PATH", init, "OUTPUT_DIR",
                                 str(root / "jax"), "NUM_GPUS", "1", "TPU.MESH_DATA", "1",
                                 "TPU.DONATE", "False"])
    jax_trainer.train(jcfg)
    return events(root / "jax"), port


def assert_same_events(got, want):
    """Two runs' event files: the same scalar tags at the same steps, the
    values within 1e-4, the same figures, one event file."""
    (want_scalars, want_figures, _), (got_scalars, got_figures, files) = want, got
    assert sorted(want_scalars) == ["Train/Top1_err", "Train/Top5_err", "Train/loss", "Train/lr",
                                    "Val/top1_err", "Val/top5_err"]
    assert sorted(got_scalars) == sorted(want_scalars)
    for tag, values in want_scalars.items():
        assert [s for s, _ in got_scalars[tag]] == [s for s, _ in values] == [0, 1], tag
        np.testing.assert_allclose([v for _, v in got_scalars[tag]], [v for _, v in values],
                                   rtol=1e-4, atol=1e-4, err_msg=tag)
    assert got_figures == want_figures == sorted(
        ["Confusion Matrix"] + [f"Hist/{i}" for i in range(6)])
    assert len(files) == 1


def test_event_files_match_the_jax_trainer(runs):
    want, got = runs
    assert_same_events(got, want)


def test_writer_pieces_match_jax(tmp_path):
    from slowfast_tpu.config import get_cfg as jax_get_cfg
    from slowfast_tpu.visualization import tensorboard_vis as jvis
    from slowfast_tpu_torch.config import get_cfg
    from slowfast_tpu_torch.visualization import tensorboard_vis as tvis

    rs = np.random.RandomState(0)
    preds, labels = rs.normal(size=(40, 6)), rs.randint(0, 6, 40)
    np.testing.assert_array_equal(tvis.get_confusion_matrix(preds, labels, 6),
                                  jvis.get_confusion_matrix(preds, labels, 6))
    names = {"a": 0, "b": 1, "c": 2, "d": 4}
    (tmp_path / "names.json").write_text(json.dumps(names))
    (tmp_path / "subset.txt").write_text("b\nd\nnone\n")
    (tmp_path / "parents.json").write_text(json.dumps({"p": ["a", "c"], "q": ["d"]}))
    opts = ["MODEL.NUM_CLASSES", "6", "OUTPUT_DIR", str(tmp_path), "TENSORBOARD.ENABLE", "True",
            "TENSORBOARD.CLASS_NAMES_PATH", str(tmp_path / "names.json"),
            "TENSORBOARD.CATEGORIES_PATH", str(tmp_path / "parents.json"),
            "TENSORBOARD.CONFUSION_MATRIX.ENABLE", "True", "TENSORBOARD.HISTOGRAM.ENABLE", "True",
            "TENSORBOARD.CONFUSION_MATRIX.SUBSET_PATH", str(tmp_path / "subset.txt"),
            "TENSORBOARD.HISTOGRAM.SUBSET_PATH", str(tmp_path / "subset.txt")]
    no_tensorflow()
    writers = []
    for get, vis, sub in ((jax_get_cfg, jvis, "jax"), (get_cfg, tvis, "port")):
        cfg = get()
        cfg.merge_from_list(opts + ["TENSORBOARD.LOG_DIR", sub])
        w = vis.TensorboardWriter(cfg)
        w.plot_eval(preds, labels, global_step=3)
        w.add_scalars({"Val/top1_err": 12.5, "skipped": "text"}, global_step=3)
        w.close()
        writers.append(w)
    jw, tw = writers
    assert tw.class_names == jw.class_names == ["a", "b", "c", "3", "d", "5"]
    assert tw.cm_subset == jw.cm_subset == [1, 4]
    assert tw.hist_subset == jw.hist_subset and tw.parent_map == jw.parent_map
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    tags = []
    for sub in ("jax", "port"):
        acc = EventAccumulator(str(tmp_path / sub), size_guidance={"images": 0})
        acc.Reload()
        tags.append((sorted(acc.Tags()["images"]), sorted(acc.Tags()["scalars"])))
    assert tags[0] == tags[1] == (
        ["Confusion Matrices/p", "Confusion Matrices/q", "Confusion Matrix",
         "Confusion Matrix Subset", "Hist/b", "Hist/d"], ["Val/top1_err"])
