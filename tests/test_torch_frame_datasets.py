"""The port's frame datasets (Charades, multi-label; Something-Something V2)
against the JAX package's, on the CPU, on a small tree of JPEG frames.

Both packages read frames with cv2: the JAX package's native JPEG decoder
is switched off inside each test (``native.probe_jpeg`` returns None). The
JAX frame datasets normalize before the spatial sampling and ship float
pathways; the port ships uint8 clips and normalizes on the card. So each
item is held twice:

* bit-equal under the port's contract: the JAX dataset with its normalize
  and pathway packing made identities (monkeypatched in the test) resamples
  the same uint8 frames, and its clip must equal the port's, with equal
  labels (Charades: the multi-hot vector of every frame's labels), indices
  and times;
* against the JAX package's own float item: the port's clip normalized as
  the card does it, within one uint8 level (1 / (255 std)) of it: resizing
  before or after the affine normalize differs by cv2's uint8 rounding.

Items draw from the generators of ``sample_seed(RNG_SEED, 0, index)``; the
JAX side from its global generators seeded with the same number.
"""

import json
import os
import random

import numpy as np
import pytest

from slowfast_tpu import native as jax_native
from slowfast_tpu.config import get_cfg as jax_get_cfg
from slowfast_tpu.data import utils as jutils
from slowfast_tpu.data.charades import Charades as JaxCharades
from slowfast_tpu.data.ssv2 import Ssv2 as JaxSsv2
from slowfast_tpu_torch.config import get_cfg
from slowfast_tpu_torch.data import build_dataset
from slowfast_tpu_torch.data.utils import sample_seed

cv2 = pytest.importorskip("cv2")
MEAN, STD = 0.45, 0.225


def write_frames(root, video, n, seed):
    rs = np.random.RandomState(seed)
    os.makedirs(os.path.join(root, video), exist_ok=True)
    rels = []
    for i in range(n):
        rel = f"{video}/{video}_{i:06d}.jpg"
        cv2.imwrite(os.path.join(root, rel), (rs.rand(48, 64, 3) * 255).astype(np.uint8))
        rels.append(rel)
    return rels


@pytest.fixture(scope="module")
def frame_root(tmp_path_factory):
    """Charades: 3 videos of 7, 12 and 20 frames with per-frame labels (some
    empty); SSv2: 3 videos, one without frames; both splits alike."""
    root = str(tmp_path_factory.mktemp("frames"))
    rows = ["original_vido_id video_id frame_id path labels"]
    for v, (n, labels) in enumerate([(7, ["0,2", ""]), (12, ["1", "3,1"]), (20, ["", "4"])]):
        for i, rel in enumerate(write_frames(root, f"C{v}", n, v)):
            rows.append(f'C{v} C{v} {i} {rel} "{labels[i % 2]}"')
    for split in ("train", "val"):
        with open(os.path.join(root, f"charades_{split}.csv"), "w") as f:
            f.write("\n".join(rows) + "\n")
    with open(os.path.join(root, "something-something-v2-labels.json"), "w") as f:
        json.dump({"Pushing thing": "0", "Moving thing up": "1", "Holding thing": "2"}, f)
    videos = [("10", "Pushing [thing]"), ("11", "Holding thing"), ("12", "Moving [thing] up")]
    for split in ("train", "validation"):
        with open(os.path.join(root, f"something-something-v2-{split}.json"), "w") as f:
            json.dump([{"id": v, "template": t} for v, t in videos], f)
    rows = ["original_vido_id video_id frame_id path labels"]
    for v, n in (("10", 9), ("12", 25)):
        for i, rel in enumerate(write_frames(root, f"S{v}", n, int(v))):
            rows.append(f"{v} {v} {i} {rel} \"\"")
    for split in ("train", "val"):
        with open(os.path.join(root, f"ssv2_{split}.csv"), "w") as f:
            f.write("\n".join(rows) + "\n")
    return root


def split_dir(frame_root, tmp_path, dataset):
    """A data dir whose {train,val}.csv are ``dataset``'s lists."""
    for split in ("train", "val"):
        os.symlink(os.path.join(frame_root, f"{dataset}_{split}.csv"),
                   tmp_path / f"{split}.csv")
    for name in os.listdir(frame_root):
        if name.endswith(".json"):
            os.symlink(os.path.join(frame_root, name), tmp_path / name)
    return str(tmp_path)


def both_cfgs(frame_root, data_dir, extra):
    opts = ["DATA.PATH_TO_DATA_DIR", data_dir, "DATA.PATH_PREFIX", frame_root,
            "DATA.NUM_FRAMES", "4", "DATA.SAMPLING_RATE", "3", "DATA.TRAIN_CROP_SIZE", "32",
            "DATA.TEST_CROP_SIZE", "40", "DATA.TRAIN_JITTER_SCALES", "[36, 56]",
            "MODEL.ARCH", "c2d", "MODEL.NUM_CLASSES", "5", "NUM_GPUS", "1",
            "DATA.MEAN", f"[{MEAN}, {MEAN}, {MEAN}]", "DATA.STD", f"[{STD}, {STD}, {STD}]",
            "TEST.NUM_ENSEMBLE_VIEWS", "2", "TEST.NUM_SPATIAL_CROPS", "3"] + list(extra)
    jcfg, cfg = jax_get_cfg(), get_cfg()
    jcfg.merge_from_list(opts)
    cfg.merge_from_list(opts)
    return jcfg, cfg


DATASETS = {"charades": (JaxCharades, "Charades"), "ssv2": (JaxSsv2, "Ssv2")}
EXTRA = {"default": [], "inverse_noflip": ["DATA.INV_UNIFORM_SAMPLE", "True",
                                          "DATA.RANDOM_FLIP", "False"]}


@pytest.mark.parametrize("extra", sorted(EXTRA))
@pytest.mark.parametrize("mode", ["train", "val", "test"])
@pytest.mark.parametrize("dataset", sorted(DATASETS))
def test_items_match_jax(frame_root, tmp_path, monkeypatch, dataset, mode, extra):
    monkeypatch.setattr(jax_native, "probe_jpeg", lambda path: None)
    jax_cls, name = DATASETS[dataset]
    jcfg, cfg = both_cfgs(frame_root, split_dir(frame_root, tmp_path, dataset), EXTRA[extra])
    ds = build_dataset(name.lower(), cfg, mode)
    float_ds = jax_cls(jcfg, mode)
    views = 6 if mode == "test" else 1
    assert len(ds) == len(float_ds) == (3 if dataset == "charades" else 2) * views
    items = []
    for index in range(len(ds)):
        seed = sample_seed(cfg.RNG_SEED, 0, index)
        random.seed(seed)
        np.random.seed(seed)
        items.append((ds[index], float_ds[index]))
    # The uint8 contract: the JAX dataset with identity normalize and packing.
    monkeypatch.setattr(jutils, "tensor_normalize", lambda frames, mean, std: frames)
    monkeypatch.setattr(jutils, "pack_pathway_output", lambda cfg, frames: [frames])
    u8_ds = jax_cls(jcfg, mode)
    for index, (got, want_float) in enumerate(items):
        seed = sample_seed(cfg.RNG_SEED, 0, index)
        random.seed(seed)
        np.random.seed(seed)
        want = u8_ds[index]
        (g,), (w,) = got[0], want[0]
        assert g.dtype == np.uint8 and g.shape == w.shape
        assert np.array_equal(w, np.round(w)), "not a uint8 resample"
        np.testing.assert_array_equal(g, w.astype(np.uint8))
        np.testing.assert_array_equal(np.asarray(got[1]), np.asarray(want[1]))
        assert got[2] == want[2] == index and got[3].tolist() == want[3].tolist() == [0.0]
        if dataset == "charades":
            assert got[1].dtype == np.float32 and got[1].shape == (5,)
        (wf,) = want_float[0]
        err = np.abs((g.astype(np.float32) / 255.0 - MEAN) / STD - wf).max()
        assert err <= 1.0 / (255.0 * STD) + 1e-6, err
        np.testing.assert_array_equal(np.asarray(got[1]), np.asarray(want_float[1]))


def test_charades_labels_aggregate_the_clip_frames(frame_root, tmp_path):
    """Video C1 (12 frames, labels [1] and [3, 1] alternating): its val clip,
    frames 0, 3, 6, 9, holds classes 1 and 3; video C2 (20 frames, labels
    [] and [4]): its val clip, frames 0, 3, 6, 9, holds class 4 only."""
    cfg = both_cfgs(frame_root, split_dir(frame_root, tmp_path, "charades"), [])[1]
    ds = build_dataset("charades", cfg, "val")
    for index, want in ((1, [0, 1, 0, 1, 0]), (2, [0, 0, 0, 0, 1])):
        assert ds.get_seq_frames(index, None) == [0, 3, 6, 9]
        item = ds.sample(index, random.Random(0), np.random.RandomState(0))
        np.testing.assert_array_equal(item[1], want)


def test_run_net_trains_and_tests_multi_label_charades(frame_root, tmp_path):
    """SlowFast at depth 18, width 8, 8 frames of 32², fp32 on the CPU, on the
    Charades frames with the recipe's multi-label settings (sigmoid head,
    ``bce_logit``, ``max`` ensemble): an epoch of 3 steps, precise BN and a
    val epoch that logs the mAP, then a 2-view x 3-crop test that logs it.
    The val list gives every frame its video's labels: the test meter
    requires all views of a video to carry one label vector, as the JAX
    package's does."""
    import json

    from slowfast_tpu_torch.run_net import main as run_net_main

    data_dir = tmp_path / "data"
    data_dir.mkdir()
    rows = open(os.path.join(frame_root, "charades_val.csv")).read().splitlines()
    videos = {}
    for row in rows[1:]:
        videos.setdefault(row.split()[0], set()).update(
            x for x in row.split()[-1].strip('"').split(",") if x)
    val_rows = [rows[0]] + [" ".join(row.split()[:-1] + ['"%s"' % ",".join(
        sorted(videos[row.split()[0]]))]) for row in rows[1:]]
    yaml = os.path.join(os.path.dirname(__file__), "..", "configs", "Charades",
                        "SLOWFAST_16x8_R50.yaml")
    split_dir(frame_root, data_dir, "charades")
    os.remove(data_dir / "val.csv")
    (data_dir / "val.csv").write_text("\n".join(val_rows) + "\n")
    run_net_main(["--device", "cpu", "--cfg", yaml, "--opts",
                  "DATA.PATH_TO_DATA_DIR", str(data_dir),
                  "DATA.PATH_PREFIX", frame_root, "RESNET.DEPTH", "18",
                  "RESNET.WIDTH_PER_GROUP", "8", "DATA.NUM_FRAMES", "8", "SLOWFAST.ALPHA", "4",
                  "DATA.SAMPLING_RATE", "2", "DATA.TRAIN_CROP_SIZE", "32",
                  "DATA.TEST_CROP_SIZE", "32", "DATA.TRAIN_JITTER_SCALES", "[36, 48]",
                  "MODEL.NUM_CLASSES", "5", "NUM_GPUS", "1", "BN.NORM_TYPE", "batchnorm",
                  "TRAIN.DATASET", "charades", "TEST.DATASET", "charades",
                  "TRAIN.CHECKPOINT_FILE_PATH", "",
                  "TRAIN.BATCH_SIZE", "1", "TEST.BATCH_SIZE", "4", "SOLVER.MAX_EPOCH", "1",
                  "TEST.NUM_ENSEMBLE_VIEWS", "2", "TEST.NUM_SPATIAL_CROPS", "3",
                  "BN.NUM_BATCHES_PRECISE", "2", "DATA_LOADER.NUM_WORKERS", "2",
                  "TPU.COMPUTE_DTYPE", "float32", "OUTPUT_DIR", str(tmp_path)])
    logged = [json.loads(line.split("json_stats: ", 1)[1])
              for line in (tmp_path / "json_stats.log").read_text().splitlines()]
    by_type = {}
    for stats in logged:
        by_type.setdefault(stats["_type"], []).append(stats)
    assert np.isfinite(by_type["train_epoch"][0]["loss"])
    assert "top1_err" not in by_type["train_epoch"][0]
    (val,), (test,) = by_type["val_epoch"], by_type["test_final"]
    assert 0.0 < val["map"] <= 1.0 and 0.0 < test["map"] <= 1.0
    assert len(by_type["test_iter"]) == 5  # 3 videos x 6 views in batches of 4
