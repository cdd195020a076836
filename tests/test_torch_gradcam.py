"""Grad-CAM and the heatmaps of the port against the JAX package, on the CPU.

The JAX package's ``GradCAM.__call__`` raises on every call: its score
function takes ``_run_with_substitution_static``'s ``((preds, act),
None)`` for the predictions (ROADMAP Queue 3 #44, pinned by
``test_jax_gradcam_raises``). So JAX's side is computed here as that code
means it: the activation from ``GradCAM._run_with_substitution``, its
gradient by ``jax.grad`` through the substituted forward, then the
module's map (gradcam.py:66-77, JAX's T-folded activations unfolded: the
mean gradient over T, H, W as the channel weights, ReLU of the weighted
sum, min-max over the batch,
``jax.image.resize`` trilinear to the pathway's T, H, W), with a
transformer block's tokens laid on their grid first. The port's
``GradCAM`` is held to it within 1e-4 (fp32; the sums run in another
order) on the narrow Slow, the two-pathway SlowFast (one layer a pathway)
and the narrow MViT of tests/vis_models.py. ``overlay_heatmap`` and
``add_heatmap`` within one uint8 level; the writer's heatmap, video and
histogram events equal to the JAX writer's.
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from slowfast_tpu.ops.video_conv import unfold_time
from slowfast_tpu.visualization import gradcam as jax_gradcam
from slowfast_tpu.visualization import tensorboard_vis as jax_tb
from slowfast_tpu_torch.visualization import gradcam, tensorboard_vis

from test_torch_tensorboard import no_tensorflow
from test_torch_train import one_torch_thread  # noqa: F401  (autouse fixture)
from vis_models import Pair, jax_path, jit_run

TOL = 1e-4
CASES = {"slow": ["s5/pathway0_res1"],
         "slowfast": ["s5/pathway0_res1", "s5/pathway1_res1"],
         "mvit": ["blocks/1"]}


@pytest.fixture(scope="module")
def pairs():
    return {}


def pair_of(pairs, name):
    if name not in pairs:
        pairs[name] = Pair(name)
    return pairs[name]


def jax_cams(pair, inputs, layers, labels=None, use_labels=False):
    """JAX's maps and predictions, one jitted forward and ``jax.grad`` a
    layer; a T-folded activation ``(B, H, W, T·C)`` is unfolded and a
    block's tokens laid on the grid it returns beside them."""
    xs = [jnp.asarray(x.numpy()) for x in inputs]
    cam_of = jax_gradcam.GradCAM(pair.jax_model, {}, [jax_path(l) for l in layers])
    cams = []
    for p, path in enumerate(cam_of.target_layers):
        grid = {}

        def run(variables, xs, path=path, grid=grid):
            cam_of.variables = variables

            def interceptor(next_fun, args, kwargs, context):
                out = next_fun(*args, **kwargs)
                if tuple(context.module.path) == path and isinstance(out, tuple):
                    grid["thw"] = tuple(int(v) for v in out[1])
                return out

            with nn.intercept_methods(interceptor):
                preds, act = cam_of._run_with_substitution(xs, path)

            def score(a):
                out = cam_of._run_with_substitution(xs, path, sub=a)[0].astype(jnp.float32)
                if use_labels:
                    return jnp.sum(jnp.take_along_axis(out, jnp.asarray(labels)[:, None],
                                                       axis=-1))
                return jnp.sum(jnp.max(out, axis=-1))

            return preds, act, jax.grad(score)(act)

        preds, act, grads = (np.asarray(v) for v in jit_run(run, pair.variables, xs))
        if act.ndim == 4:  # T-folded (B, H, W, T*C)
            act, grads = (np.asarray(unfold_time(v, xs[p].shape[1])) for v in (act, grads))
        elif act.ndim == 3:
            n = int(np.prod(grid["thw"]))
            act = act[:, -n:].reshape(act.shape[0], *grid["thw"], act.shape[-1])
            grads = grads[:, -n:].reshape(act.shape)
        weights = grads.mean(axis=tuple(range(1, act.ndim - 1)), keepdims=True)
        cam = np.maximum((weights * act).sum(axis=-1), 0.0)
        cam = cam - cam.min()
        cam = cam / (cam.max() + 1e-8)
        target = xs[min(p, len(xs) - 1)].shape[1:4]
        cams.append(np.asarray(jax.image.resize(jnp.asarray(cam), (cam.shape[0],) + target,
                                                method="trilinear")))
    return cams, preds


@pytest.mark.parametrize("name", sorted(CASES))
def test_gradcam_matches_jax(pairs, name):
    pair = pair_of(pairs, name)
    inputs = pair.pathways()
    want, want_preds = jax_cams(pair, inputs, CASES[name])
    got, got_preds = gradcam.GradCAM(pair.model, CASES[name])(inputs)
    np.testing.assert_allclose(got_preds, want_preds, atol=TOL, rtol=TOL)
    assert len(got) == len(want) == len(inputs)
    for g, w, x in zip(got, want, inputs):
        assert g.shape == w.shape == tuple(x.shape[:4])
        assert w.max() > 0.5  # a map, not a constant
        np.testing.assert_allclose(g, w, atol=TOL, rtol=0)


def test_gradcam_true_label_matches_jax(pairs):
    pair = pair_of(pairs, "slow")
    inputs = pair.pathways(seed=2)
    labels = np.array([3, 5])
    want, _ = jax_cams(pair, inputs, CASES["slow"], labels, use_labels=True)
    got, _ = gradcam.GradCAM(pair.model, CASES["slow"])(inputs, labels=labels, use_labels=True)
    np.testing.assert_allclose(got[0], want[0], atol=TOL, rtol=0)
    plain, _ = gradcam.GradCAM(pair.model, CASES["slow"])(inputs)
    assert np.abs(plain[0] - got[0]).max() > 1e-3  # another class, another map


def test_jax_gradcam_raises(pairs):
    """Traced, so the raise comes at the trace of its score function."""
    pair = pair_of(pairs, "slow")
    xs = [jnp.asarray(x.numpy()) for x in pair.pathways()]
    with pytest.raises(AttributeError, match="'tuple' object has no attribute 'astype'"):
        jax.jit(lambda v, xs: jax_gradcam.GradCAM(pair.jax_model, v, ["s5/pathway0_res1"])(
            xs))(pair.variables, xs)


def test_gradcam_unknown_layer_raises(pairs):
    pair = pair_of(pairs, "slow")
    with pytest.raises(AttributeError):
        gradcam.GradCAM(pair.model, ["s9/pathway0_res0"])(pair.pathways())


def test_overlay_heatmap_matches_jax():
    rs = np.random.RandomState(0)
    frames = rs.randint(0, 256, (3, 16, 20, 3)).astype(np.uint8)
    cam = rs.rand(3, 16, 20).astype(np.float32)
    for colormap, alpha in (("viridis", 0.5), ("jet", 0.3)):
        want = jax_gradcam.overlay_heatmap(frames, cam, colormap, alpha)
        got = gradcam.overlay_heatmap(frames, cam, colormap, alpha)
        assert got.dtype == np.uint8 and got.shape == want.shape
        assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


@pytest.mark.parametrize("arr", [np.random.RandomState(1).normal(size=(12, 9)),
                                 np.full((4, 5), 2.5)], ids=["random", "constant"])
def test_add_heatmap_matches_jax(arr):
    want, got = jax_tb.add_heatmap(arr), tensorboard_vis.add_heatmap(arr)
    assert got.shape == want.shape == (3,) + arr.shape and got.dtype == np.float32
    assert np.abs(np.round(got * 255) - np.round(want * 255)).max() <= 1


def _events(log_dir):
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    acc = EventAccumulator(str(log_dir), size_guidance={"images": 0, "histograms": 0,
                                                        "tensors": 0})
    acc.Reload()
    tags = acc.Tags()
    images = {t: [e.encoded_image_string for e in acc.Images(t)] for t in tags["images"]}
    hists = {t: [(e.step, e.histogram_value.num, e.histogram_value.sum)
                 for e in acc.Histograms(t)] for t in tags["histograms"]}
    return images, hists, sorted(tags["tensors"])


def test_writer_events_match_jax(tmp_path):
    """``add_video``, ``plot_weights_and_activations`` and
    ``add_ndim_array`` on both writers: the same tags and events. (Neither
    host has moviepy, which ``SummaryWriter.add_video`` needs: both
    writers log that and write no video.)"""
    no_tensorflow()
    from slowfast_tpu.config import get_cfg as jax_get_cfg
    from slowfast_tpu_torch.config import get_cfg

    rs = np.random.RandomState(2)
    params = {"a": {"kernel": rs.normal(size=(3, 4)), "bias": rs.normal(size=(4,))}}
    acts = {"s5/pathway0_res1": rs.normal(size=(2, 3, 4, 5)), "vec": rs.normal(size=(7,))}
    vid = rs.randint(0, 256, (1, 4, 8, 8, 3)).astype(np.uint8)
    runs = {}
    for name, get, module in (("jax", jax_get_cfg, jax_tb), ("port", get_cfg, tensorboard_vis)):
        cfg = get()
        cfg.OUTPUT_DIR = str(tmp_path / name)
        writer = module.TensorboardWriter(cfg)
        writer.plot_weights_and_activations(params, acts, global_step=1)
        writer.add_ndim_array(acts["vec"], "extra", 2)
        writer.add_video(vid, global_step=3)
        writer.close()
        runs[name] = _events(tmp_path / name / "runs-kinetics")
    assert runs["port"][0] and runs["port"][1]
    assert runs["port"] == runs["jax"]
    assert sorted(runs["port"][0]) == ["Model/activations/s5/pathway0_res1"]
    assert len(runs["port"][1]) == 4  # two weights, the 1-D activation, "extra"
