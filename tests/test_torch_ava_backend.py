"""The ``pytorch`` AVA backend (``AVA.IMG_PROC_BACKEND pytorch``) against
the JAX package's ``_images_and_boxes_preprocessing``
(slowfast_tpu/data/ava_dataset.py:134), on the CPU, on the AVA corpus of
tests/test_torch_ava_data.py: every item's float pathways within 1e-6 of
JAX's (they come out bit-equal), its labels, boxes, original boxes and
metadata equal, for train (the flip at p 0.5 whatever
``DATA.RANDOM_FLIP`` says), train with the full color jitter and PCA in
the BGR clip, train with PCA only and ``AVA.BGR``, val (scale and centre
crop, forced flip) and test (the short side scaled, no crop). The port
draws from the generators of ``sample_seed(RNG_SEED, 0, index)``, JAX
from ``np.random`` seeded with that number, in the same order (size, crop
y, crop x, flip, the jitters).
"""

import numpy as np
import pytest

from slowfast_tpu import native as jax_native
from slowfast_tpu.data.ava_dataset import Ava as JaxAva
from slowfast_tpu_torch.data import build_dataset
from slowfast_tpu_torch.data.synth_media import make_ava_corpus
from slowfast_tpu_torch.data.utils import sample_seed
from test_torch_ava_data import both_cfgs

pytest.importorskip("cv2")

BACKEND = ["AVA.IMG_PROC_BACKEND", "pytorch"]
ITEMS = {
    "train": ("train", ["DATA.RANDOM_FLIP", "False"]),
    "train_color": ("train", ["AVA.TRAIN_USE_COLOR_AUGMENTATION", "True",
                              "AVA.TRAIN_PCA_JITTER_ONLY", "False"]),
    "train_pca_bgr": ("train", ["AVA.TRAIN_USE_COLOR_AUGMENTATION", "True", "AVA.BGR", "True"]),
    "val_flip": ("val", ["AVA.TEST_FORCE_FLIP", "True"]),
    "test": ("test", []),
}


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("ava"))
    return make_ava_corpus(root, num_videos=2, secs=range(902, 906), size=(40, 32),
                           num_classes=6, seed=1)


@pytest.mark.parametrize("name", sorted(ITEMS))
def test_pytorch_backend_items_match_jax(corpus, monkeypatch, name):
    monkeypatch.setattr(jax_native, "probe_jpeg", lambda path: None)
    split, extra = ITEMS[name]
    jcfg, cfg = both_cfgs(corpus, BACKEND + extra)
    ds, jds = build_dataset("ava", cfg, split), JaxAva(jcfg, split)
    assert len(ds) == len(jds) > 2
    for index in range(len(ds)):
        got = ds[index]
        np.random.seed(sample_seed(cfg.RNG_SEED, 0, index))
        want = jds[index]
        assert len(got[0]) == len(want[0]) == 2  # slow and fast pathways
        for g, w in zip(got[0], want[0]):
            assert g.dtype == w.dtype == np.float32 and g.shape == w.shape
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-6, err_msg=f"{name} {index}")
        if split == "test":  # the short side scaled to the crop, the long one free
            assert got[0][1].shape[1:3] == (28, 35)
        else:
            crop = cfg.DATA.TRAIN_CROP_SIZE if split == "train" else cfg.DATA.TEST_CROP_SIZE
            assert got[0][1].shape == (cfg.DATA.NUM_FRAMES, crop, crop, 3)
        assert np.array_equal(got[1], want[1]) and got[2] == want[2] == index
        for key in ("boxes", "ori_boxes", "metadata"):
            assert np.array_equal(np.asarray(got[4][key]), np.asarray(want[4][key])), key
