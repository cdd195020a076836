"""Float clips from the loader (``TPU.UINT8_PIPELINE False``) against the
JAX package, on the CPU.

* Kinetics items (slowfast_tpu/data/kinetics.py:182, :422-434) on the mp4
  corpus of tests/test_torch_data.py: float pathways normalized on the
  host before the spatial sampling, no crop fused into the decode, within
  1e-6 of JAX's for train (decode at scale, and RandAugment with random
  erasing), val and test, on one pathway and on SlowFast's two with
  ``DATA.REVERSE_INPUT_CHANNEL``.
* ``Syntheticvideo`` items (:557-565): the same frames, normalized into
  SlowFast's pathways, equal to JAX's.
* The train and eval steps on float pathways: narrow SlowFast (as
  tests/test_torch_ddp.py), 2 fp32 SGD steps on batches of 4 clips
  normalized on the host, each port step from the JAX step's state on a
  one-device mesh (loss within 1e-5, parameters and BN statistics within
  1e-4 relative L2), and against the port's steps on the same clips as
  uint8 through row 1's plain version (within 1e-5: the host's ``(x/255 -
  mean)/std`` and row 1's ``x·scale + bias`` differ by an ulp); the float
  steps never reach row 1.
"""

import numpy as np
import pytest

from test_torch_train import one_torch_thread  # noqa: F401  (autouse fixture)

FLOAT = ["TPU.UINT8_PIPELINE", "False"]
SLOWFAST = ["MODEL.ARCH", "slowfast", "SLOWFAST.ALPHA", "4", "DATA.REVERSE_INPUT_CHANNEL",
            "True"]
AUG = ["AUG.ENABLE", "True", "AUG.RE_PROB", "0.9"]
SLOW = ["MODEL.ARCH", "slow"]
ITEMS = {"train": ("train", SLOW), "train_aug": ("train", SLOW + AUG), "val": ("val", SLOW),
         "test": ("test", SLOW), "train_slowfast": ("train", SLOWFAST),
         "test_slowfast": ("test", SLOWFAST)}


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    from slowfast_tpu_torch.data import synth_media

    pytest.importorskip("cv2")
    root = str(tmp_path_factory.mktemp("k400"))
    return synth_media.make_video_corpus(root, {"train": 3, "val": 3, "test": 3},
                                         frames=80, size=(160, 120))


def assert_same_pathways(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.float32 and g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-6)


@pytest.mark.parametrize("name", sorted(ITEMS))
def test_float_kinetics_items_match_jax(corpus, name):
    from slowfast_tpu.data.kinetics import Kinetics as JaxKinetics
    from slowfast_tpu_torch.data import utils as tutils
    from slowfast_tpu_torch.data.kinetics import Kinetics
    from test_torch_data import both_cfgs, seeded

    mode, extra = ITEMS[name]
    jcfg, cfg = both_cfgs(corpus, FLOAT + extra)
    jds, ds = JaxKinetics(jcfg, mode), Kinetics(cfg, mode)
    for index in range(len(ds)):
        seeded(tutils.sample_seed(cfg.RNG_SEED, 0, index))
        got, want = ds[index], jds[index]
        assert len(got[0]) == (2 if "slowfast" in name else 1)
        assert_same_pathways(got[0], want[0])
        assert got[1:3] == want[1:3]
        np.testing.assert_array_equal(got[3], want[3])


@pytest.mark.parametrize("mode", ["train", "test"])
def test_float_synthetic_items_match_jax(mode):
    from slowfast_tpu.config import get_cfg as jax_get_cfg
    from slowfast_tpu.data.kinetics import Syntheticvideo as JaxSynthetic
    from slowfast_tpu_torch.config import get_cfg
    from slowfast_tpu_torch.data.kinetics import Syntheticvideo

    opts = FLOAT + SLOWFAST + ["DATA.SYNTHETIC_SIZE", "3", "DATA.NUM_FRAMES", "8",
                               "DATA.TRAIN_CROP_SIZE", "32", "DATA.TEST_CROP_SIZE", "32"]
    jcfg, cfg = jax_get_cfg(), get_cfg()
    jcfg.merge_from_list(opts)
    cfg.merge_from_list(opts)
    jds, ds = JaxSynthetic(jcfg, mode), Syntheticvideo(cfg, mode)
    assert len(ds) == len(jds)
    for index in range(len(ds)):
        got, want = ds[index], jds[index]
        assert_same_pathways(got[0], want[0])
        assert got[1:3] == want[1:3]


def host_float(cfg, batch):
    """``batch`` with its uint8 clips as the pathways the host normalizes."""
    from slowfast_tpu_torch.data import utils as tutils

    paths = [tutils.pack_pathway_output(cfg, tutils.tensor_normalize(c, cfg.DATA.MEAN,
                                                                      cfg.DATA.STD))
             for c in batch["inputs"][0]]
    inputs = [np.ascontiguousarray(np.stack([p[i] for p in paths])).astype(np.float32)
              for i in range(len(paths[0]))]
    return dict(batch, inputs=inputs)


def test_float_train_step_matches_jax_and_the_uint8_step(monkeypatch):
    from ddp_harness import params_and_buffers, port_cfg, rel_l2, train_run
    from ddp_jax import check_jax_steps, jax_cfg, jax_variables, mesh_run
    from slowfast_tpu_torch.engine import steps
    from test_torch_ddp import slowfast_opts, uint8_batches

    opts = slowfast_opts() + FLOAT
    cfg = port_cfg(opts)
    u8 = uint8_batches(cfg, 16, 5, steps=2)
    batches = [host_float(cfg, b) for b in u8]
    jcfg = jax_cfg(opts)
    jax_run = mesh_run(jcfg, jax_variables(jcfg, 11), batches, devices=1)
    uint8_run = train_run(opts, jax_run["starts"][0][0], u8, starts=jax_run["starts"])

    def row_1(*args, **kwargs):
        raise AssertionError("a float batch reached the preprocess kernel")

    monkeypatch.setattr(steps, "device_preprocess", row_1)
    float_run = train_run(opts, jax_run["starts"][0][0], batches, starts=jax_run["starts"])
    assert check_jax_steps([float_run], jax_run) > 1e-4  # the steps train
    np.testing.assert_allclose(float_run["loss"], uint8_run["loss"], rtol=1e-5)
    params, buffers = params_and_buffers(jax_run["states"][-1])
    for got, want in zip(float_run["states"], uint8_run["states"]):
        assert rel_l2(got, want, params) <= 1e-5 and rel_l2(got, want, buffers) <= 1e-5


def test_float_eval_step_skips_row_1(monkeypatch):
    import torch

    from ddp_harness import port_cfg
    from slowfast_tpu_torch.engine import steps
    from slowfast_tpu_torch.models.build import build_model
    from test_torch_ddp import slowfast_opts, uint8_batches

    cfg = port_cfg(slowfast_opts() + FLOAT)
    model = build_model(cfg, device="cpu")
    u8 = uint8_batches(cfg, 16, 3, steps=1)[0]
    want = steps.make_eval_step(cfg, model)({"inputs": [torch.from_numpy(u8["inputs"][0])]})
    monkeypatch.setattr(steps, "device_preprocess", lambda *a, **k: None)
    got = steps.make_eval_step(cfg, model)(
        {"inputs": [torch.from_numpy(x) for x in host_float(cfg, u8)["inputs"]]})
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
