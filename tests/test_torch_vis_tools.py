"""The visualize tool of the port against the JAX package, on the CPU.

``GetWeightAndActivation``: the weights of the named layers against the
JAX package's parameter subtrees through the weight bridge (bit-equal, the
same count of leaves), and the activations its forward hooks take against
those of JAX's method interceptor on the same pathways, within 1e-5 (fp32;
sums in another order), on the narrow Slow (two residual blocks) and MViT
(two transformer blocks) of tests/vis_models.py. ``WrongPredictionVis``
against JAX's on the same predictions. Then ``run_net`` on a narrow
SlowFast with ``TENSORBOARD.MODEL_VIS`` (weights, activations and their
heatmaps, Grad-CAM on one layer a pathway), ``WRONG_PRED_VIS`` and the
test's saved predictions in ``PREDICTIONS_PATH``: the event file holds
every tag, and the activations and Grad-CAM took the eval step's
preprocessed pathways, not the loader's uint8 clip (ROADMAP Queue 3 #45).
"""

import pickle
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slowfast_tpu.ops.video_conv import unfold_time
from slowfast_tpu.visualization import vis as jax_vis
from slowfast_tpu_torch.config import get_cfg
from slowfast_tpu_torch.models.build import build_model
from slowfast_tpu_torch.utils.checkpoint import state_dict_from_jax
from slowfast_tpu_torch.visualization import vis

from test_torch_tensorboard import no_tensorflow
from test_torch_train import one_torch_thread  # noqa: F401  (autouse fixture)
from vis_models import MODELS, Pair, jax_path, jit_run, model_cfg

ATOL = 1e-5
LAYERS = {"slow": ["s5/pathway0_res1", "s4/pathway0_res0"], "mvit": ["blocks/1", "blocks/3"]}


@pytest.fixture(scope="module")
def pairs():
    return {name: Pair(name) for name in LAYERS}


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_weights_match_jax(pairs, name):
    pair = pairs[name]
    want = jax_vis.GetWeightAndActivation(pair.jax_model, pair.variables,
                                          [jax_path(l) for l in LAYERS[name]]).get_weights()
    got = vis.GetWeightAndActivation(pair.model, LAYERS[name]).get_weights()
    assert list(got) == LAYERS[name]
    for layer, params in got.items():
        subtree = want[jax_path(layer)]
        bridged = state_dict_from_jax({"params": subtree})
        assert len(params) == len(bridged) == len(jax.tree.leaves(subtree))
        for pname, w in params.items():
            torch.testing.assert_close(w, bridged[pname], rtol=0, atol=0)


def jax_activations(pair, layers, inputs, monkeypatch):
    """JAX's ``get_activations`` traced and compiled: its ``np.asarray``
    reads of the intercepted values pass the traced arrays through."""
    monkeypatch.setattr(jax_vis, "np", types.SimpleNamespace(asarray=lambda x, *a, **k: x))
    gwa = jax_vis.GetWeightAndActivation(pair.jax_model, None, [jax_path(l) for l in layers])

    def run(variables, xs):
        gwa.variables = variables
        return gwa.get_activations(xs)

    acts, preds = jit_run(run, pair.variables, [jnp.asarray(x.numpy()) for x in inputs])
    return {k: np.asarray(v) for k, v in acts.items()}, np.asarray(preds)


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_activations_match_jax(pairs, name, monkeypatch):
    pair = pairs[name]
    inputs = pair.pathways()
    want_acts, want_preds = jax_activations(pair, LAYERS[name], inputs, monkeypatch)
    got_acts, got_preds = vis.GetWeightAndActivation(pair.model, LAYERS[name]).get_activations(
        inputs)
    np.testing.assert_allclose(got_preds, want_preds, atol=ATOL, rtol=1e-4)
    assert list(got_acts) == LAYERS[name]
    for layer, got in got_acts.items():
        want = want_acts[jax_path(layer)]
        if want.ndim == 4 and got.ndim == 5:  # JAX's T-folded (B, H, W, T*C)
            want = np.asarray(unfold_time(want, got.shape[1]))
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=1e-4)


def test_wrong_prediction_vis_matches_jax():
    rs = np.random.RandomState(0)
    want, got = jax_vis.WrongPredictionVis(None), vis.WrongPredictionVis(None)
    for _ in range(3):
        preds, labels = rs.rand(8, 5), rs.randint(0, 5, 8)
        index = rs.permutation(100)[:8]
        want.update(preds, labels, index)
        got.update(torch.from_numpy(preds), labels, index)
    assert got.wrong_class_prediction == want.wrong_class_prediction
    assert 0 < len(got.wrong_class_prediction) < 24


def test_visualize_through_run_net(tmp_path, monkeypatch):
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    from slowfast_tpu_torch.run_net import main

    no_tensorflow()
    seen = {}
    real = vis.GetWeightAndActivation.get_activations

    def record(self, inputs, bboxes=None):
        seen["inputs"] = [(x.dtype, tuple(x.shape)) for x in inputs]
        return real(self, inputs, bboxes)

    monkeypatch.setattr(vis.GetWeightAndActivation, "get_activations", record)
    layers = ["s5/pathway0_res1", "s5/pathway1_res1"]
    opts = ["TRAIN.ENABLE", "False", "TEST.DATASET", "syntheticvideo", "DATA.SYNTHETIC_SIZE",
            "4", "TEST.NUM_ENSEMBLE_VIEWS", "1", "TEST.NUM_SPATIAL_CROPS", "1",
            "OUTPUT_DIR", str(tmp_path), "TEST.SAVE_RESULTS_PATH", str(tmp_path / "res.pkl"),
            "TENSORBOARD.ENABLE", "True", "TENSORBOARD.MODEL_VIS.ENABLE", "True",
            "TENSORBOARD.MODEL_VIS.MODEL_WEIGHTS", "True",
            "TENSORBOARD.MODEL_VIS.ACTIVATIONS", "True",
            "TENSORBOARD.MODEL_VIS.LAYER_LIST", str(layers),
            "TENSORBOARD.MODEL_VIS.GRAD_CAM.LAYER_LIST", str(layers),
            "TENSORBOARD.WRONG_PRED_VIS.ENABLE", "True",
            "TENSORBOARD.PREDICTIONS_PATH", str(tmp_path / "res.pkl"),
            "TENSORBOARD.CONFUSION_MATRIX.ENABLE", "True"]
    yaml, narrow = MODELS["slowfast"][:2]
    main(["--device", "cpu", "--cfg", yaml, "--opts", *narrow, "TPU.COMPUTE_DTYPE", "float32",
          *opts])
    with open(tmp_path / "res.pkl", "rb") as f:
        assert len(pickle.load(f)[0]) == 4
    # The hooks saw the eval step's two float pathways (slow T/alpha, fast T).
    assert seen["inputs"] == [(torch.float32, (2, 2, 40, 40, 3)),
                              (torch.float32, (2, 8, 40, 40, 3))]
    acc = EventAccumulator(str(tmp_path / "runs-kinetics"),
                           size_guidance={"images": 0, "histograms": 0})
    acc.Reload()
    hists, images = set(acc.Tags()["histograms"]), set(acc.Tags()["images"])
    model = build_model(model_cfg(get_cfg, "slowfast"), device="cpu")
    for layer in layers:
        n = len(list(model.get_submodule(layer.replace("/", ".")).parameters()))
        assert {f"weights/{layer}/{i}" for i in range(n)} <= hists
        assert f"activations/{layer}" in hists and f"Model/activations/{layer}" in images
    assert {"gradcam/pathway0", "gradcam/pathway1"} <= hists
    assert "Confusion Matrix" in images

