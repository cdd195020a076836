"""The SSL data path of the port against the JAX package, on the CPU: the
colour recipe's torchvision ops, blur, temporal difference and
``color_jitter_video_ssl`` (with and without MoCo-v2's recipe) on the same
draws; ``ContrastiveModel``'s Kinetics items (the views, their float
pathways and times) and val items, and ``SSL_COLOR_JITTER`` on a uint8
model, bit for bit (floats within 1e-6) on an mp4 corpus; ``ssl_collate``;
the ``DELTA_CLIPS`` windows; the ``Syntheticvideo`` refusal.

The JAX package draws its extra SSL windows with its FFmpeg multi-window
decode and falls back to one ``decoder.decode`` per view; the port decodes
with cv2, so the JAX side is forced onto that fallback here, as
tests/test_torch_frame_datasets.py switches JAX's native JPEG decoder off.
Generators are seeded as in tests/test_torch_data.py.
"""

import math
import os

import numpy as np
import pytest

from slowfast_tpu.config import get_cfg as jax_get_cfg
from slowfast_tpu.data import decoder as jdec
from slowfast_tpu.data import transform as jtr
from slowfast_tpu.data.kinetics import Kinetics as JaxKinetics
from slowfast_tpu.data.loader import ssl_collate as jax_ssl_collate
from slowfast_tpu_torch.config import get_cfg
from slowfast_tpu_torch.data import synth_media
from slowfast_tpu_torch.data import transform as ttr
from slowfast_tpu_torch.data import utils as tutils
from slowfast_tpu_torch.data.kinetics import Kinetics, Syntheticvideo
from slowfast_tpu_torch.data.loader import construct_loader, ssl_collate
from test_torch_data import fclip, same, seeded
from test_torch_train import one_torch_thread  # noqa: F401  (autouse fixture)

cv2 = pytest.importorskip("cv2")


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Three mp4s of 160 x 120 at 30 fps, 80 frames, in every split."""
    root = str(tmp_path_factory.mktemp("ssl_k400"))
    return synth_media.make_video_corpus(root, {"train": 3, "val": 3, "test": 3},
                                         frames=80, size=(160, 120))


@pytest.fixture(autouse=True)
def no_native_decode(monkeypatch):
    def refuse(*args, **kwargs):
        raise ImportError("the FFmpeg decode service is off in this test")

    monkeypatch.setattr(jdec, "decode_native", refuse)


# --- transforms ----------------------------------------------------------------

OPS = {
    "brightness": (lambda f, r: ttr._tv_brightness(f, 1.3), lambda f: jtr._tv_brightness(f, 1.3)),
    "contrast": (lambda f, r: ttr._tv_contrast(f, 0.6), lambda f: jtr._tv_contrast(f, 0.6)),
    "saturation": (lambda f, r: ttr._tv_saturation(f, 1.4),
                   lambda f: jtr._tv_saturation(f, 1.4)),
    "hue": (lambda f, r: ttr._tv_hue(f, 0.13), lambda f: jtr._tv_hue(f, 0.13)),
    "hue_negative": (lambda f, r: ttr._tv_hue(f, -0.07), lambda f: jtr._tv_hue(f, -0.07)),
    "blur": (lambda f, r: ttr._gaussian_blur_frames(f, 1.3),
             lambda f: jtr._gaussian_blur_frames(f, 1.3)),
    "temporal_difference": (lambda f, r: ttr.temporal_difference(f, True, True),
                            lambda f: jtr.temporal_difference(f, True, True)),
    "jitter": (lambda f, r: ttr.color_jitter_video_ssl(f, r, (0.6, 0.6, 0.6), 0.15, 0.2),
               lambda f: jtr.color_jitter_video_ssl(f, (0.6, 0.6, 0.6), 0.15, 0.2)),
    "jitter_mocov2": (lambda f, r: ttr.color_jitter_video_ssl(f, r, (0.4, 0.4, 0.4), 0.1, 0.2,
                                                              moco_v2_aug=True),
                      lambda f: jtr.color_jitter_video_ssl(f, (0.4, 0.4, 0.4), 0.1, 0.2,
                                                           moco_v2_aug=True)),
    "jitter_no_hue": (lambda f, r: ttr.color_jitter_video_ssl(f, r, (0.0, 0.5, 0.0), 0.0),
                      lambda f: jtr.color_jitter_video_ssl(f, (0.0, 0.5, 0.0), 0.0)),
    "video_blur": (lambda f, r: ttr.GaussianBlurVideo((0.5, 0.1), (1.5, 2.0))(f, r),
                   lambda f: jtr.GaussianBlurVideo((0.5, 0.1), (1.5, 2.0))(f)),
}


@pytest.mark.parametrize("name", sorted(OPS))
def test_ssl_transform_matches_jax(name):
    port, jax_ = OPS[name]
    for seed in range(6):
        x = fclip(seed)
        x[0, 0, 0] = x[0, 0, 0, 0]  # a gray pixel: the hue's delta-0 branch
        rng, _ = seeded(700 + seed)
        want = jax_(x.copy())
        got = port(x.copy(), rng)
        same(np.asarray(got, np.float32), np.asarray(want, np.float32))


@pytest.mark.parametrize("prob", [0.0, 1.0, 0.5])
def test_augment_raw_frames_matches_jax(prob):
    for seed in range(4):
        x = fclip(seed) * 255.0
        rng, _ = seeded(800 + seed)
        want, w_applied = jtr.augment_raw_frames(x.copy(), time_diff_prob=prob,
                                                 gaussian_prob=prob)
        got, applied = ttr.augment_raw_frames(x.copy(), rng, time_diff_prob=prob,
                                              gaussian_prob=prob)
        assert applied == w_applied
        same(got, want)


# --- Kinetics items ------------------------------------------------------------

BASE = ["DATA.NUM_FRAMES", "4", "DATA.SAMPLING_RATE", "4", "DATA.TRAIN_CROP_SIZE", "48",
        "DATA.TEST_CROP_SIZE", "48", "DATA.TRAIN_JITTER_SCALES", "[56, 72]",
        "DATA.DECODING_BACKEND", "cv2", "NUM_GPUS", "1", "DATA.INPUT_CHANNEL_NUM", "[3]",
        "MODEL.ARCH", "slow"]
SSL = ["MODEL.MODEL_NAME", "ContrastiveModel", "MODEL.NUM_CLASSES", "32"]
MOCO = SSL + ["DATA.SSL_COLOR_JITTER", "True", "DATA.SSL_MOCOV2_AUG", "True",
              "DATA.COLOR_RND_GRAYSCALE", "0.2", "DATA.SSL_COLOR_HUE", "0.15",
              "DATA.SSL_COLOR_BRI_CON_SAT", "[0.6, 0.6, 0.6]",
              "DATA.TRAIN_JITTER_SCALES_RELATIVE", "[0.2, 0.766]",
              "DATA.TRAIN_JITTER_ASPECT_RELATIVE", "[0.75, 1.3333]"]
ITEMS = {
    # MoCo_SlowR50_8x8.yaml's data options: 4 temporal views of 1 crop.
    "moco_recipe": MOCO + ["DATA.TRAIN_CROP_NUM_TEMPORAL", "4"],
    # One window: the minimum of two views comes from two crops of it.
    "one_window_two_crops": SSL + ["DATA.TRAIN_CROP_NUM_TEMPORAL", "1"],
    "two_by_two_time_diff": SSL + ["DATA.TRAIN_CROP_NUM_TEMPORAL", "2",
                                   "DATA.TRAIN_CROP_NUM_SPATIAL", "2", "DATA.TIME_DIFF_PROB",
                                   "0.5", "DATA.SSL_COLOR_JITTER", "True"],
    "slowfast_pathways": SSL + ["MODEL.ARCH", "slowfast", "SLOWFAST.ALPHA", "2",
                                "DATA.TRAIN_CROP_NUM_TEMPORAL", "2"],
    # SSL_COLOR_JITTER on a uint8 model (finetune_ucf_*): truncated to uint8.
    "uint8_jitter": ["DATA.SSL_COLOR_JITTER", "True", "DATA.SSL_COLOR_HUE", "0.1",
                     "DATA.SSL_COLOR_BRI_CON_SAT", "[0.4, 0.4, 0.4]",
                     "DATA.COLOR_RND_GRAYSCALE", "0.2"],
}


def both_cfgs(corpus, extra):
    opts = BASE + ["DATA.PATH_TO_DATA_DIR", corpus] + list(extra)
    jcfg, cfg = jax_get_cfg(), get_cfg()
    jcfg.merge_from_list(opts)
    cfg.merge_from_list(opts)
    return jcfg, cfg


def assert_same_views(got, want):
    if isinstance(want[0][0], list):  # SSL views: lists of pathway lists
        assert len(got[0]) == len(want[0]) >= 2
        for g, w in zip(got[0], want[0]):
            assert len(g) == len(w)
            for gp, wp in zip(g, w):
                same(gp, wp)
    else:
        for gp, wp in zip(got[0], want[0]):
            same(gp, wp)
    assert got[1] == want[1] and got[2] == want[2]
    np.testing.assert_array_equal(got[3], want[3])
    assert got[3].dtype == np.float32 and got[4] == want[4] == {}


CASES = [(name, "train") for name in sorted(ITEMS)] + [("moco_recipe", "val")]


@pytest.mark.parametrize("name,mode", CASES)
def test_ssl_kinetics_items_match_jax(corpus, name, mode):
    jcfg, cfg = both_cfgs(corpus, ITEMS[name])
    jds, ds = JaxKinetics(jcfg, mode), Kinetics(cfg, mode)
    for index in range(len(ds)):
        seeded(tutils.sample_seed(cfg.RNG_SEED, 0, index))
        got, want = ds[index], jds[index]
        assert_same_views(got, want)
    if cfg.MODEL.MODEL_NAME == "ContrastiveModel":
        views = got[0] if mode == "train" else [got[0]]
        assert all(p.dtype == np.float32 for v in views for p in v)
        if mode == "train":
            n_t, n_s = cfg.DATA.TRAIN_CROP_NUM_TEMPORAL, cfg.DATA.TRAIN_CROP_NUM_SPATIAL
            assert len(got[0]) == max(n_t * n_s, 2) and got[3].shape == (len(got[0]),)
    else:
        assert got[0][0].dtype == np.uint8


def test_ssl_collate_matches_jax(corpus):
    jcfg, cfg = both_cfgs(corpus, ITEMS["slowfast_pathways"])
    ds = Kinetics(cfg, "train")
    samples = [ds[i] for i in range(3)]
    got, want = ssl_collate(samples), jax_ssl_collate(samples)
    assert len(got[0]) == len(want[0]) == 2
    for g, w in zip(got[0], want[0]):
        assert len(g) == len(w) == 2
        for gp, wp in zip(g, w):
            same(gp, wp)
    for a, b in zip(got[1:4], want[1:4]):
        np.testing.assert_array_equal(a, b)
    assert got[4] == want[4] == {}


def test_ssl_loader_batches_views_on_the_device(corpus):
    cfg = both_cfgs(corpus, ITEMS["moco_recipe"])[1]
    cfg.TRAIN.BATCH_SIZE = 2
    views, labels, index, times, meta = next(iter(construct_loader(cfg, "train", "cpu")))
    assert isinstance(views, tuple) and len(views) == 4
    assert all(v[0].shape == (2, 4, 48, 48, 3) and v[0].dtype.is_floating_point
               for v in views)
    assert times.shape == (2, 4) and meta == {}
    val = next(iter(construct_loader(cfg, "val", "cpu")))
    assert isinstance(val[0], list) and val[0][0].shape == (2, 4, 48, 48, 3)


def test_delta_clips_constrain_the_windows(corpus):
    """Under ``CONTRASTIVE.DELTA_CLIPS_{MIN,MAX}`` the windows are drawn
    jointly until every gap between them lies in the range: their times,
    scaled back to frames, keep the gaps."""
    d_min, d_max = 4, 24
    jcfg, cfg = both_cfgs(corpus, SSL + ["DATA.TRAIN_CROP_NUM_TEMPORAL", "3",
                                         "CONTRASTIVE.DELTA_CLIPS_MIN", str(d_min),
                                         "CONTRASTIVE.DELTA_CLIPS_MAX", str(d_max)])
    ds = Kinetics(cfg, "train")
    clip_size = cfg.DATA.SAMPLING_RATE * cfg.DATA.NUM_FRAMES  # 30 fps at 30 fps
    for index in range(len(ds)):
        views, _, _, times, _ = ds[index]
        starts = np.sort(times) * (80 - clip_size)
        gaps = starts[1:] - (starts[:-1] + clip_size - 1)
        assert len(views) == 3 and ((gaps >= d_min - 1e-6) & (gaps <= d_max + 1e-6)).all()
    assert math.isinf(get_cfg().CONTRASTIVE.DELTA_CLIPS_MIN)


def test_synthetic_video_refuses_contrastive(corpus):
    _, cfg = both_cfgs(corpus, SSL)
    with pytest.raises(NotImplementedError, match="ssl_collate"):
        Syntheticvideo(cfg, "train")


def test_kinetics_labels_read_for_knn(corpus):
    """The kNN probe reads the train labels from the dataset, in clip order."""
    _, cfg = both_cfgs(corpus, SSL)
    ds = Kinetics(cfg, "train")
    lines = open(os.path.join(corpus, "train.csv")).read().split()
    assert ds._labels == [int(x) for x in lines[1::2]]
