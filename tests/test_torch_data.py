"""The port's video data layer against the JAX package's, on the CPU: the
transforms, random erasing, RandAugment, the decoder's sampling and cv2
decode, and Kinetics items, on seeded inputs and a tiny mp4 corpus.

The port's functions draw from generators they are given; the JAX package's
from the modules ``random`` and ``np.random``. Seeding both modules with the
number that seeds the port's pair (``sample_seed`` for dataset items) gives
both sides the same two streams, so uint8 outputs must be bit-equal and
float outputs within 1e-6. Both packages decode with cv2
(``DATA.DECODING_BACKEND cv2``; the port always does). Also: the loader
hands each sample the generators of ``(RNG_SEED, epoch, index)``, so a
batch is the same whatever the thread count, and another epoch draws
anew; and one CPU ``run_net`` trains and tests on the mp4 corpus.
"""

import json
import math
import os
import random

import numpy as np
import pytest

from slowfast_tpu.config import get_cfg as jax_get_cfg
from slowfast_tpu.data import decoder as jdec
from slowfast_tpu.data import rand_augment as jra
from slowfast_tpu.data import random_erasing as jre
from slowfast_tpu.data import transform as jtr
from slowfast_tpu.data import utils as jutils
from slowfast_tpu.data.kinetics import Kinetics as JaxKinetics
from slowfast_tpu_torch.config import get_cfg
from slowfast_tpu_torch.data import decoder as tdec
from slowfast_tpu_torch.data import rand_augment as tra
from slowfast_tpu_torch.data import random_erasing as tre
from slowfast_tpu_torch.data import synth_media
from slowfast_tpu_torch.data import transform as ttr
from slowfast_tpu_torch.data import utils as tutils
from slowfast_tpu_torch.data.kinetics import Kinetics
from slowfast_tpu_torch.data.loader import Loader
from slowfast_tpu_torch.run_net import main as run_net_main
from test_torch_train import one_torch_thread  # noqa: F401  (autouse fixture)

cv2 = pytest.importorskip("cv2")


def seeded(seed):
    """Seed the JAX package's global generators; the port's pair with the
    same streams."""
    random.seed(seed)
    np.random.seed(seed)
    return random.Random(seed), np.random.RandomState(seed)


def clip(seed, shape=(4, 30, 40, 3)):
    return np.random.RandomState(seed).randint(0, 256, shape).astype(np.uint8)


def fclip(seed, shape=(4, 12, 16, 3)):
    return np.random.RandomState(seed).rand(*shape).astype(np.float32)


def same(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    if got.dtype == np.uint8:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Three mp4s of 160 x 120 at 30 fps, 80 frames, listed in every split."""
    root = str(tmp_path_factory.mktemp("k400"))
    return synth_media.make_video_corpus(root, {"train": 3, "val": 3, "test": 3},
                                         frames=80, size=(160, 120))


# --- transforms --------------------------------------------------------------

# (name, port call, JAX call, input): each call gets the clip; the port's
# also its two generators.
TRANSFORMS = {
    "scale_jitter": (lambda x, r, n: ttr.random_short_side_scale_jitter(x, 20, 50, n),
                     lambda x: jtr.random_short_side_scale_jitter(x, 20, 50), clip),
    "scale_jitter_inverse": (
        lambda x, r, n: ttr.random_short_side_scale_jitter(x, 20, 50, n, True),
        lambda x: jtr.random_short_side_scale_jitter(x, 20, 50, inverse_uniform_sampling=True),
        clip),
    "scale_jitter_tall": (
        lambda x, r, n: ttr.random_short_side_scale_jitter(x, 25, 36, n),
        lambda x: jtr.random_short_side_scale_jitter(x, 25, 36),
        lambda s: clip(s, (3, 40, 30, 3))),
    "scale_jitter_float": (lambda x, r, n: ttr.random_short_side_scale_jitter(x, 20, 50, n),
                           lambda x: jtr.random_short_side_scale_jitter(x, 20, 50), fclip),
    "random_crop": (lambda x, r, n: ttr.random_crop(x, 24, n),
                    lambda x: jtr.random_crop(x, 24), clip),
    "horizontal_flip": (lambda x, r, n: ttr.horizontal_flip(0.5, x, n),
                        lambda x: jtr.horizontal_flip(0.5, x), clip),
    "random_resized_crop": (
        lambda x, r, n: ttr.random_resized_crop(x, 16, 20, r, scale=(0.1, 0.9)),
        lambda x: jtr.random_resized_crop(x, 16, 20, scale=(0.1, 0.9)), clip),
    "random_resized_crop_fallback": (
        lambda x, r, n: ttr.random_resized_crop(x, 16, 16, r, scale=(2.0, 3.0),
                                                ratio=(0.2, 0.3)),
        lambda x: jtr.random_resized_crop(x, 16, 16, scale=(2.0, 3.0), ratio=(0.2, 0.3)),
        clip),
    "random_resized_crop_bicubic": (
        lambda x, r, n: ttr.random_resized_crop(x, 20, 20, r, interpolation="bicubic"),
        lambda x: jtr.random_resized_crop(x, 20, 20, interpolation="bicubic"), clip),
    "random_resized_crop_with_shift": (
        lambda x, r, n: ttr.random_resized_crop_with_shift(x, 16, 16, r),
        lambda x: jtr.random_resized_crop_with_shift(x, 16, 16), clip),
    "color_jitter": (lambda x, r, n: ttr.color_jitter(x, n, 0.4, 0.3, 0.2),
                     lambda x: jtr.color_jitter(x, 0.4, 0.3, 0.2), fclip),
    "color_jitter_two": (lambda x, r, n: ttr.color_jitter(x, n, 0.4, 0, 0.2),
                         lambda x: jtr.color_jitter(x, 0.4, 0, 0.2), fclip),
    "lighting_jitter": (
        lambda x, r, n: ttr.lighting_jitter(x, 0.1, [0.225, 0.224, 0.229],
                                            np.eye(3) + 0.1, n),
        lambda x: jtr.lighting_jitter(x, 0.1, [0.225, 0.224, 0.229], np.eye(3) + 0.1),
        fclip),
    "color_normalization": (
        lambda x, r, n: ttr.color_normalization(x, [0.45, 0.4, 0.5], [0.2, 0.25, 0.3]),
        lambda x: jtr.color_normalization(x, [0.45, 0.4, 0.5], [0.2, 0.25, 0.3]), fclip),
}
# spatial_sampling: the train branch (jitter and crop, or a relative
# resized crop with or without motion shift) and the three test crops.
SAMPLING = {
    "train": dict(spatial_idx=-1, min_scale=32, max_scale=48, crop_size=28),
    "train_inverse_noflip": dict(spatial_idx=-1, min_scale=32, max_scale=48, crop_size=28,
                                 inverse_uniform_sampling=True,
                                 random_horizontal_flip=False),
    "relative": dict(spatial_idx=-1, crop_size=24, scale=[0.08, 1.0],
                     aspect_ratio=[0.75, 1.3333]),
    "motion_shift": dict(spatial_idx=-1, crop_size=24, scale=[0.08, 1.0],
                         aspect_ratio=[0.75, 1.3333], motion_shift=True),
    **{f"test_{i}": dict(spatial_idx=i, min_scale=36, max_scale=36, crop_size=36)
       for i in range(3)},
}


@pytest.mark.parametrize("name", sorted(TRANSFORMS))
def test_transform_matches_jax(name):
    port, jax_fn, make = TRANSFORMS[name]
    for seed in range(4):
        x = make(seed)
        rng, np_rng = seeded(100 + seed)
        want = np.ascontiguousarray(jax_fn(x))
        same(np.ascontiguousarray(port(x, rng, np_rng)), want)
        assert rng.random() == random.random() and np_rng.rand() == np.random.rand()


@pytest.mark.parametrize("name", sorted(SAMPLING))
@pytest.mark.parametrize("shape", [(4, 30, 40, 3), (4, 40, 30, 3)])
def test_spatial_sampling_matches_jax(name, shape):
    for seed in range(3):
        x = clip(seed, shape)
        rng, np_rng = seeded(200 + seed)
        want = jutils.spatial_sampling(x, **SAMPLING[name])
        same(tutils.spatial_sampling(x, rng, np_rng, **SAMPLING[name]), want)


@pytest.mark.parametrize("size", [20, 24])
@pytest.mark.parametrize("shape", [(2, 20, 24, 3), (2, 24, 20, 3), (2, 24, 24, 3)])
def test_uniform_crop_matches_jax(shape, size):
    x = clip(3, shape)
    for idx in range(3):
        same(ttr.uniform_crop(x, size, idx), jtr.uniform_crop(x, size, idx))


@pytest.mark.parametrize("inverse", [False, True])
def test_sample_jitter_size_matches_jax(inverse):
    rng, _ = seeded(7)
    got = [ttr.sample_jitter_size(256, 320, rng, inverse) for _ in range(20)]
    assert got == [jtr.sample_jitter_size(256, 320, inverse) for _ in range(20)]


@pytest.mark.parametrize("dtype", ["uint8", "float32"])
@pytest.mark.parametrize("mode,max_count,cube", [("pixel", None, True), ("rand", 3, True),
                                                 ("const", None, True), ("pixel", 2, False)])
def test_random_erasing_matches_jax(mode, max_count, cube, dtype):
    kw = dict(probability=0.8, mode=mode, max_count=max_count, cube=cube)
    port, jax_re = tre.RandomErasing(**kw), jre.RandomErasing(**kw)
    for seed in range(6):
        x = clip(seed) if dtype == "uint8" else fclip(seed)
        rng, np_rng = seeded(300 + seed)
        with np.errstate(invalid="ignore"):  # negative noise cast to uint8, on both sides
            want = jax_re(x)
            got = port(x, rng, np_rng)
        same(got, want)


@pytest.mark.parametrize("policy", ["rand-m9-mstd0.5-inc1", "rand-m7-n4-mstd0",
                                    "rand-m10-n3-mstd1.0-inc0"])
def test_rand_augment_matches_jax(policy):
    hparams = dict(translate_const=10, img_mean=(115, 115, 115), interpolation="bicubic")
    port = tra.rand_augment_transform(policy, hparams)
    jax_ra = jra.rand_augment_transform(policy, hparams)
    assert (port.num_layers, port.magnitude, port.mstd, port.transforms) == (
        jax_ra.num_layers, jax_ra.magnitude, jax_ra.mstd, jax_ra.transforms)
    for seed in range(12):
        x = clip(seed, (2, 24, 32, 3))
        rng, _ = seeded(400 + seed)
        same(port(x, rng), jax_ra(x))


# --- decoder and helpers -----------------------------------------------------

@pytest.mark.parametrize("clip_idx,num_clips,use_offset", [
    (-1, 10, False), (0, 10, False), (3, 10, False), (2, 3, True), (0, 1, True)])
@pytest.mark.parametrize("video_size,clip_size", [(300, 64.0), (80, 90.5), (100, 100.0)])
def test_start_end_idx_matches_jax(video_size, clip_size, clip_idx, num_clips, use_offset):
    rng, _ = seeded(11)
    for _ in range(3):
        assert tdec.get_start_end_idx(video_size, clip_size, clip_idx, num_clips, rng,
                                      use_offset=use_offset) == jdec.get_start_end_idx(
            video_size, clip_size, clip_idx, num_clips, use_offset=use_offset)


@pytest.mark.parametrize("min_delta,max_delta", [(0, math.inf), (-math.inf, 20), (10, 60)])
def test_multiple_start_end_idx_matches_jax(min_delta, max_delta):
    rng, _ = seeded(12)
    for sizes in ([32.0], [32.0, 32.0], [16.0, 24.0, 40.0]):
        got = tdec.get_multiple_start_end_idx(200, sizes, -1, 10, rng, min_delta, max_delta)
        want = jdec.get_multiple_start_end_idx(200, sizes, -1, 10, min_delta, max_delta)
        np.testing.assert_array_equal(got, want)


def test_temporal_sampling_sequence_and_labels_match_jax():
    x = clip(5, (10, 4, 4, 3))
    for start, end, n in ((0, 9, 4), (2.5, 14.2, 8), (-3, 5, 6)):
        same(tdec.temporal_sampling(x, start, end, n), jdec.temporal_sampling(x, start, end, n))
    for args in ((5, 4, 2, 10), (0, 8, 3, 6), (9, 6, 1, 10)):
        assert tutils.get_sequence(*args) == jutils.get_sequence(*args)
    lists = [[3, 1], [], [1, 7], [0]]
    assert tutils.aggregate_labels(lists) == jutils.aggregate_labels(lists) == [0, 1, 3, 7]
    same(tutils.as_binary_vector([3, 1, 3], 8), jutils.as_binary_vector([3, 1, 3], 8))


@pytest.mark.parametrize("clip_idx,scale,rate,fps", [(-1, 0, 2, 30), (-1, 100, 4, 24),
                                                     (1, 0, 2, 30), (4, 100, 1, 30),
                                                     (-1, 200, 8, 30)])
def test_decode_matches_jax_cv2_path(corpus, clip_idx, scale, rate, fps):
    path = os.path.join(corpus, "v001.mp4")
    for seed in range(2):
        rng, _ = seeded(500 + seed)
        want = jdec.decode(path, rate, 8, clip_idx=clip_idx, num_clips=5, target_fps=fps,
                           max_spatial_scale=scale, backend="cv2")
        got = tdec.decode(path, rate, 8, rng, clip_idx=clip_idx, num_clips=5, target_fps=fps,
                          max_spatial_scale=scale)
        same(got[0], want[0])
        assert got[1:] == want[1:]
    short = min(got[0].shape[1:3])
    assert short == (scale if 0 < scale < 120 else 120)
    assert tdec.decode(os.path.join(corpus, "missing.mp4"), 2, 8, rng) is None


# --- Kinetics items ------------------------------------------------------------

BASE = ["DATA.NUM_FRAMES", "8", "DATA.SAMPLING_RATE", "2", "DATA.TRAIN_CROP_SIZE", "64",
        "DATA.TEST_CROP_SIZE", "64", "DATA.TRAIN_JITTER_SCALES", "[70, 100]",
        "DATA.DECODING_BACKEND", "cv2", "NUM_GPUS", "1", "TEST.NUM_ENSEMBLE_VIEWS", "2",
        "TEST.NUM_SPATIAL_CROPS", "3"]
AUG = ["AUG.ENABLE", "True", "AUG.RE_PROB", "0.9"]
KINETICS = {
    "decode_at_scale": [],
    "no_decode_at_scale": ["DATA.DECODE_AT_SCALE", "False", "DATA.INV_UNIFORM_SAMPLE", "True"],
    "fps_jitter": ["DATA.TRAIN_JITTER_FPS", "6.0", "DATA.USE_OFFSET_SAMPLING", "True"],
    "relative_motion_shift": ["DATA.TRAIN_JITTER_SCALES_RELATIVE", "[0.08, 1.0]",
                              "DATA.TRAIN_JITTER_ASPECT_RELATIVE", "[0.75, 1.3333]",
                              "DATA.TRAIN_JITTER_MOTION_SHIFT", "True"],
    "randaug_erasing": AUG,
    "repeated_aug": AUG + ["AUG.NUM_SAMPLE", "2"],
    "three_crops_rate_4": ["DATA.SAMPLING_RATE", "4", "DATA.RANDOM_FLIP", "False"],
}


def both_cfgs(corpus, extra):
    opts = BASE + ["DATA.PATH_TO_DATA_DIR", corpus] + list(extra)
    jcfg, cfg = jax_get_cfg(), get_cfg()
    jcfg.merge_from_list(opts)
    cfg.merge_from_list(opts)
    return jcfg, cfg


def assert_same_item(got, want):
    if isinstance(want[1], list):  # repeated augmentation: lists of NUM_SAMPLE
        assert len(got[0]) == len(want[0]) > 1
        for g, w in zip(zip(*got), zip(*want)):
            assert_same_item(g, w)
        return
    (g,), (w,) = got[0], want[0]
    same(g, w)
    assert got[1] == want[1] and got[2] == want[2]
    np.testing.assert_array_equal(got[3], want[3])
    assert got[3].dtype == np.float32 and got[4] == want[4] == {}


# The train-only options in train mode; val and test with two of them.
CASES = [(name, "train") for name in sorted(KINETICS)] + [
    (name, mode) for name in ("decode_at_scale", "three_crops_rate_4") for mode in ("val", "test")]


@pytest.mark.parametrize("name,mode", CASES)
def test_kinetics_items_match_jax(corpus, name, mode):
    jcfg, cfg = both_cfgs(corpus, KINETICS[name])
    jds, ds = JaxKinetics(jcfg, mode), Kinetics(cfg, mode)
    assert len(ds) == len(jds) == 3 * (6 if mode == "test" else 1)
    for index in range(len(ds)):
        seeded(tutils.sample_seed(cfg.RNG_SEED, 0, index))
        assert_same_item(ds[index], jds[index])


def test_kinetics_retries_a_corrupt_file(corpus, tmp_path):
    """A file that fails to decode is tried again, then replaced by another
    random video past half the retries, on both sides alike."""
    bad = tmp_path / "bad.mp4"
    bad.write_bytes(b"not a video")
    lines = open(os.path.join(corpus, "train.csv")).read()
    (tmp_path / "train.csv").write_text(f"{bad} 7\n" + lines)
    jcfg, cfg = both_cfgs(str(tmp_path), [])
    jds, ds = JaxKinetics(jcfg, "train", num_retries=10), Kinetics(cfg, "train", num_retries=10)
    seeded(tutils.sample_seed(cfg.RNG_SEED, 0, 0))
    got, want = ds[0], jds[0]
    assert_same_item(got, want)
    assert got[2] != 0 and got[1] != 7


def test_kinetics_unported_options_raise(corpus):
    # Every Kinetics option is ported now: the SSL items (ContrastiveModel,
    # DATA.SSL_COLOR_JITTER) in tests/test_torch_ssl_data.py, the 2D patch
    # stem's loader masks in tests/test_torch_imagenet.py, chunked csvs in
    # tests/test_torch_ddp_misc.py, and the float clips of
    # ``TPU.UINT8_PIPELINE False``, which had raised, in
    # tests/test_torch_float_clips.py; here they build and equal JAX's.
    jcfg, cfg = both_cfgs(corpus, ["TPU.UINT8_PIPELINE", "False"])
    jds, ds = JaxKinetics(jcfg, "train"), Kinetics(cfg, "train")
    for index in range(len(ds)):
        seeded(tutils.sample_seed(cfg.RNG_SEED, 0, index))
        got, want = ds[index], jds[index]
        assert len(got[0]) == len(want[0]) == 2  # SlowFast's pathways
        for g, w in zip(got[0], want[0]):
            assert g.dtype == np.float32
            same(g, w)
        assert got[1:3] == want[1:3]


def test_dummy_load_caches_the_first_item(corpus):
    cfg = both_cfgs(corpus, ["DATA.DUMMY_LOAD", "True"])[1]
    ds = Kinetics(cfg, "train")
    first = ds[1]
    assert ds[0] is first and ds[2] is first


# --- loader ----------------------------------------------------------------------

def loader_batches(cfg, workers, epoch):
    loader = Loader(Kinetics(cfg, "train"), 2, "cpu", num_workers=workers, shuffle=True,
                    drop_last=False, seed=cfg.RNG_SEED)
    loader.set_epoch(epoch)
    return [(inputs[0].numpy(), labels, index) for inputs, labels, index, _, _ in loader]


def test_loader_batches_do_not_depend_on_threads_and_change_with_the_epoch(corpus):
    cfg = both_cfgs(corpus, [])[1]
    one, three = loader_batches(cfg, 1, 0), loader_batches(cfg, 3, 0)
    assert [b[0].shape for b in one] == [(2, 8, 64, 64, 3), (1, 8, 64, 64, 3)]
    for a, b in zip(one, three):
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[2], b[2])
    first = {int(i): c for clips, _, idx in one for i, c in zip(idx, clips)}
    for clips, _, idx in loader_batches(cfg, 2, 1):
        for i, c in zip(idx, clips):
            assert not np.array_equal(c, first[int(i)])


# --- end to end ----------------------------------------------------------------

def test_run_net_trains_and_tests_on_mp4s(corpus, tmp_path):
    """SlowFast at depth 18, width 8, 8 frames of 32², fp32 on the CPU: one
    epoch of 2 steps on two mp4s with precise BN and a val epoch, then a
    2-view x 3-crop test of one video."""
    videos = open(os.path.join(corpus, "train.csv")).readlines()
    for split, n in (("train", 2), ("val", 2), ("test", 1)):
        (tmp_path / f"{split}.csv").write_text("".join(videos[:n]))
    yaml = os.path.join(os.path.dirname(__file__), "..", "configs", "Kinetics",
                        "SLOWFAST_4x16_R50.yaml")
    run_net_main(["--device", "cpu", "--cfg", yaml, "--opts",
                  "RESNET.DEPTH", "18", "RESNET.WIDTH_PER_GROUP", "8", "DATA.NUM_FRAMES", "8",
                  "SLOWFAST.ALPHA", "4", "DATA.TRAIN_CROP_SIZE", "32",
                  "DATA.TEST_CROP_SIZE", "32", "DATA.TRAIN_JITTER_SCALES", "[40, 48]",
                  "MODEL.NUM_CLASSES", "10", "NUM_GPUS", "1",
                  "DATA.PATH_TO_DATA_DIR", str(tmp_path),
                  "TRAIN.BATCH_SIZE", "1", "TEST.BATCH_SIZE", "4", "SOLVER.MAX_EPOCH", "1",
                  "LOG_PERIOD", "1",
                  "TEST.NUM_ENSEMBLE_VIEWS", "2", "BN.NUM_BATCHES_PRECISE", "2",
                  "DATA_LOADER.NUM_WORKERS", "2", "TPU.COMPUTE_DTYPE", "float32",
                  "OUTPUT_DIR", str(tmp_path)])
    logged = [json.loads(line.split("json_stats: ", 1)[1])
              for line in (tmp_path / "json_stats.log").read_text().splitlines()]
    by_type = {}
    for s in logged:
        by_type.setdefault(s["_type"], []).append(s)
    assert np.isfinite(by_type["train_epoch"][0]["loss"])
    assert len(by_type["val_epoch"]) == 1 and len(by_type["test_iter"]) == 2
    assert set(by_type["test_final"][0]) >= {"top1_acc", "top5_acc"}
