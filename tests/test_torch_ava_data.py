"""The port's AVA data layer and evaluation against the JAX package's, on
the CPU, on a small AVA corpus of JPEG frames (``make_ava_corpus``: 2
videos, keyframes 902-905, 40 x 32 frames, 6 classes).

* ``ava_helper``: frame lists, GT and predicted boxes (with
  ``DETECTION_SCORE_THRESH``), keyframes and box counts equal.
* ``Ava`` items bit-equal to the JAX package's (float pathways, multi-hot
  labels, boxes, original boxes, metadata) for train with and without the
  color augmentation (full color jitter and PCA), val, and test with the
  forced flip. Both read frames with cv2: the JAX package's native JPEG
  decoder is switched off in each test. Each port item draws from the
  generators of ``sample_seed(RNG_SEED, 0, index)``; the JAX item from
  ``np.random`` seeded with the same number.
* ``evaluate_ava`` within 1e-12 of the JAX package's on random detections,
  and the mini GT (seconds divisible by 4) of val equal.
"""

import os

import numpy as np
import pytest

from slowfast_tpu import native as jax_native
from slowfast_tpu.config import get_cfg as jax_get_cfg
from slowfast_tpu.data import ava_helper as jax_helper
from slowfast_tpu.data.ava_dataset import Ava as JaxAva
from slowfast_tpu.utils import ava_eval as jax_eval
from slowfast_tpu.utils.meters import AVAMeter as JaxAVAMeter
from slowfast_tpu_torch.config import get_cfg
from slowfast_tpu_torch.data import ava_helper, build_dataset
from slowfast_tpu_torch.data.synth_media import make_ava_corpus
from slowfast_tpu_torch.data.utils import sample_seed
from slowfast_tpu_torch.utils import ava_eval
from slowfast_tpu_torch.utils.meters import AVAMeter

pytest.importorskip("cv2")
YAML = os.path.join(os.path.dirname(__file__), "..", "configs", "AVA",
                    "SLOWFAST_32x2_R50_SHORT.yaml")
SMALL = ["DATA.NUM_FRAMES", "8", "DATA.SAMPLING_RATE", "2", "DATA.TRAIN_CROP_SIZE", "24",
         "DATA.TEST_CROP_SIZE", "28", "DATA.TRAIN_JITTER_SCALES", "[26, 36]",
         "MODEL.NUM_CLASSES", "6", "NUM_GPUS", "1"]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("ava"))
    return make_ava_corpus(root, num_videos=2, secs=range(902, 906), size=(40, 32),
                           num_classes=6, seed=1)


def both_cfgs(corpus, extra=(), output_dir=""):
    cfgs = []
    for get in (jax_get_cfg, get_cfg):
        cfg = get()
        cfg.merge_from_file(YAML)
        cfg.merge_from_list(SMALL + list(corpus) + list(extra) + ["OUTPUT_DIR", output_dir])
        cfgs.append(cfg)
    return cfgs


def test_ava_helper_matches_jax(corpus):
    jcfg, cfg = both_cfgs(corpus)
    for is_train in (True, False):
        assert ava_helper.load_image_lists(cfg, is_train) == jax_helper.load_image_lists(
            jcfg, is_train)
    for mode in ("train", "val"):
        got, want = (m.load_boxes_and_labels(c, mode) for m, c in ((ava_helper, cfg),
                                                                    (jax_helper, jcfg)))
        assert got == want and list(got) == list(want)
        kept = sum(len(v) for video in got.values() for v in video.values())
        assert kept > 0
        names = list(got)
        got_k = ava_helper.get_keyframe_data([got[n] for n in names])
        want_k = jax_helper.get_keyframe_data([want[n] for n in names])
        assert got_k == want_k
        assert (ava_helper.get_num_boxes_used(*got_k)
                == jax_helper.get_num_boxes_used(*want_k))
    # The score threshold drops some predicted val boxes: fewer than train's.
    val = ava_helper.load_boxes_and_labels(cfg, "val")
    train = ava_helper.load_boxes_and_labels(cfg, "train")
    count = lambda b: sum(len(v) for video in b.values() for v in video.values())  # noqa: E731
    assert 0 < count(val) < count(train)


ITEMS = {
    "train": ("train", []),
    "train_color": ("train", ["AVA.TRAIN_USE_COLOR_AUGMENTATION", "True",
                              "AVA.TRAIN_PCA_JITTER_ONLY", "False"]),
    "train_pca_noflip": ("train", ["AVA.TRAIN_USE_COLOR_AUGMENTATION", "True",
                                   "DATA.RANDOM_FLIP", "False", "AVA.BGR", "True"]),
    "val": ("val", []),
    "test_flip": ("test", ["AVA.TEST_FORCE_FLIP", "True"]),
}
PYTORCH = {"pytorch_train": ("train", ["AVA.IMG_PROC_BACKEND", "pytorch"])}


@pytest.mark.parametrize("name", sorted(ITEMS))
def test_items_bit_equal_to_jax(corpus, monkeypatch, name):
    monkeypatch.setattr(jax_native, "probe_jpeg", lambda path: None)
    split, extra = {**ITEMS, **PYTORCH}[name]
    jcfg, cfg = both_cfgs(corpus, extra)
    ds, jds = build_dataset("ava", cfg, split), JaxAva(jcfg, split)
    assert len(ds) == len(jds) > 2 and ds._video_idx_to_name == jds._video_idx_to_name
    for index in range(len(ds)):
        got = ds[index]
        np.random.seed(sample_seed(cfg.RNG_SEED, 0, index))
        want = jax_ds_item = jds[index]
        assert len(got[0]) == len(want[0]) == 2  # slow and fast pathways
        for g, w in zip(got[0], want[0]):
            assert g.dtype == w.dtype == np.float32 and np.array_equal(g, w), (name, index)
        crop = cfg.DATA.TRAIN_CROP_SIZE if split == "train" else cfg.DATA.TEST_CROP_SIZE
        assert got[0][1].shape == (cfg.DATA.NUM_FRAMES, crop, crop, 3)
        assert np.array_equal(got[1], want[1]) and got[1].dtype == want[1].dtype
        assert got[2] == want[2] == index
        for key in ("boxes", "ori_boxes", "metadata"):
            assert np.array_equal(np.asarray(got[4][key]), np.asarray(jax_ds_item[4][key])), key


def random_detections(rs, corpus_cfg, n_classes):
    """Per keyframe of val, its boxes (from the GT) with random scores."""
    gt = ava_eval.read_csv(os.path.join(corpus_cfg.AVA.ANNOTATION_DIR,
                                        corpus_cfg.AVA.GROUNDTRUTH_FILE))
    names = sorted({k.split(",")[0] for k in gt[0]})
    preds, boxes, meta = [], [], []
    for key, bxs in gt[0].items():
        video, sec = key.split(",")
        for y1, x1, y2, x2 in bxs:
            jitter = rs.uniform(-0.05, 0.05, 4)
            boxes.append([0, x1 + jitter[0], y1 + jitter[1], x2 + jitter[2], y2 + jitter[3]])
            meta.append([names.index(video), int(sec)])
            preds.append(rs.rand(n_classes))
    return np.asarray(preds), np.asarray(boxes), np.asarray(meta, np.float64), names, gt


def test_evaluate_ava_matches_jax(corpus):
    _, cfg = both_cfgs(corpus)
    rs = np.random.RandomState(0)
    preds, boxes, meta, names, gt = random_detections(rs, cfg, 6)
    labelmap = os.path.join(cfg.AVA.ANNOTATION_DIR, cfg.AVA.LABEL_MAP_FILE)
    categories, whitelist = ava_eval.read_label_map(labelmap)
    assert (categories, whitelist) == jax_eval.read_label_map(labelmap)
    excl = os.path.join(cfg.AVA.ANNOTATION_DIR, cfg.AVA.EXCLUSION_FILE)
    excluded = ava_eval.read_exclusions(excl)
    assert excluded == jax_eval.read_exclusions(excl) and len(excluded) == 1
    for truth in (gt, ava_eval.get_ava_mini_groundtruth(gt)):
        got = ava_eval.evaluate_ava(preds, boxes, meta, excluded, whitelist, categories,
                                    groundtruth=truth, video_idx_to_name=names)
        want = jax_eval.evaluate_ava(preds, boxes, meta, excluded, whitelist, categories,
                                     groundtruth=truth, video_idx_to_name=names)
        assert 0.0 < got < 1.0 and abs(got - want) <= 1e-12


def test_mini_groundtruth_and_meters_match_jax(corpus, tmp_path):
    jcfg, cfg = both_cfgs(corpus, output_dir=str(tmp_path))
    gt = ava_eval.read_csv(os.path.join(cfg.AVA.ANNOTATION_DIR, cfg.AVA.GROUNDTRUTH_FILE))
    mini = ava_eval.get_ava_mini_groundtruth(gt)
    assert mini == jax_eval.get_ava_mini_groundtruth(gt)
    assert mini[0] and all(int(k.split(",")[1]) % 4 == 0 for k in mini[0])
    assert set(mini[0]) < set(gt[0])
    rs = np.random.RandomState(1)
    preds, boxes, meta, names, _ = random_detections(rs, cfg, 6)
    for mode in ("val", "test"):
        meters = [AVAMeter(2, cfg, mode), JaxAVAMeter(2, jcfg, mode)]
        for m in meters:
            m.set_video_idx_to_name(names)
            half = len(preds) // 2
            for sl in (slice(0, half), slice(half, None)):
                m.update_stats(preds[sl], boxes[sl], meta[sl])
        got, want = (m.finalize_metrics() for m in meters)
        assert meters[0].groundtruth == meters[1].groundtruth
        assert abs(got - want) <= 1e-12 and got > 0.0
        assert (meters[0].groundtruth == mini) == (mode == "val")


def test_pytorch_backend_is_not_ported(corpus, monkeypatch):
    """The ``pytorch`` backend, which had raised, is ported: its train items
    equal the JAX package's (every split and option in
    tests/test_torch_ava_backend.py)."""
    test_items_bit_equal_to_jax(corpus, monkeypatch, "pytorch_train")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_box_transforms_match_jax(seed):
    """The box-aware clip transforms (scale jitter, random crop, flip, the
    uniform crop, crop and clip of boxes) against the JAX package's, the
    port drawing from ``np_rng`` where JAX draws from ``np.random``."""
    from slowfast_tpu.data import transform as jax_t
    from slowfast_tpu_torch.data import transform as t

    rs = np.random.RandomState(seed)
    clip = rs.rand(3, 30 + seed * 7, 44, 3).astype(np.float32)
    xy1 = rs.rand(4, 2) * 20
    boxes = np.concatenate([xy1, xy1 + rs.rand(4, 2) * 20 + 2], axis=1).astype(np.float32)
    np_rng = np.random.RandomState(10 + seed)
    np.random.seed(10 + seed)
    got = t.random_short_side_scale_jitter(clip, 34, 50, np_rng, boxes=boxes)
    want = jax_t.random_short_side_scale_jitter(clip, 34, 50, boxes=boxes)
    got = t.random_crop(*got[:1], 32, np_rng, boxes=got[1])
    want = jax_t.random_crop(want[0], 32, boxes=want[1])
    got = t.horizontal_flip(0.5, got[0], np_rng, boxes=got[1])
    want = jax_t.horizontal_flip(0.5, want[0], boxes=want[1])
    for g, w in zip(got, want):
        assert np.array_equal(g, w)
    for idx in (0, 1, 2):
        for g, w in zip(t.uniform_crop_with_boxes(clip, 28, idx, boxes),
                        jax_t.uniform_crop_with_boxes(clip, 28, idx, boxes)):
            assert np.array_equal(g, w)
    assert np.array_equal(t.crop_boxes(boxes, 3, 5), jax_t.crop_boxes(boxes, 3, 5))
    assert np.array_equal(t.clip_boxes_to_image(boxes, 16, 18),
                          jax_t.clip_boxes_to_image(boxes, 16, 18))
