"""Multi-label training and evaluation of the port against the JAX package,
on the CPU: the ``bce``, ``bce_logit`` and ``mse`` losses, ``get_map``
(numpy in the port, sklearn's ``average_precision_score`` in the JAX
package), the val and test meters' multi-label branches, the val epoch,
and one multi-label train step of a narrow SlowFast.

* Losses and their gradients within 1e-6 (rtol), each reduction.
* ``get_map`` within 1e-12 of the JAX package's, on random scores, scores
  with ties, all-zero label columns, one sample, one class, and the cases
  where sklearn raises and both return -1.0 (no sample, no class with a
  nonzero label, a non-finite score, labels sklearn does not take as
  multi-label indicators).
* ``TestMeter`` with ``multi_label``: ``sum`` and ``max`` ensembles of the
  same clip predictions give the JAX meter's video scores and mAP.
* The train step: ``test_torch_slowfast_train.py``'s narrow SlowFast (depth
  18, width 8, 16 frames of 64²) with a sigmoid head and ``bce_logit`` on
  multi-hot labels, dropout off: the loss within rtol 1e-5 and the
  gradients against ``jax.grad`` with that file's limits (the head's
  within 1e-3 of their max, all within 1e-3 relative L2); the port's
  ``make_train_step`` reports no top-k for multi-label data.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slowfast_tpu.config import get_cfg as jax_get_cfg
from slowfast_tpu.engine.steps import _maybe_device_preprocess as jax_preprocess
from slowfast_tpu.models import build_model as jax_build_model
from slowfast_tpu.solver import losses as jlosses
from slowfast_tpu.utils import meters as jmeters
from slowfast_tpu_torch.config import get_cfg
from slowfast_tpu_torch.engine import trainer
from slowfast_tpu_torch.engine.steps import maybe_device_preprocess, make_train_step
from slowfast_tpu_torch.solver import losses as tlosses
from slowfast_tpu_torch.solver import optimizer as toptim
from slowfast_tpu_torch.utils import meters as tmeters
from slowfast_tpu_torch.utils.checkpoint import state_dict_from_jax
from test_torch_slowfast_train import NARROW, clips, flagship_cfg, port_model, rel_l2, variables
from test_torch_train import one_torch_thread  # noqa: F401  (autouse fixture)

MULTI_LABEL = ["MODEL.HEAD_ACT", "sigmoid", "MODEL.LOSS_FUNC", "bce_logit",
               "DATA.MULTI_LABEL", "True"]


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
@pytest.mark.parametrize("name", ["bce", "bce_logit", "mse"])
def test_losses_and_gradients_match_jax(name, reduction):
    rng = np.random.RandomState(5)
    preds = rng.normal(0.0, 3.0, (6, 9)).astype(np.float32)
    if name == "bce":
        preds = 1.0 / (1.0 + np.exp(-preds))
        preds[0, :3] = [0.0, 1.0, 1e-9]  # clipped to [1e-7, 1 - 1e-7]
    labels = (rng.rand(6, 9) < 0.3).astype(np.float32)
    jfn, tfn = jlosses.get_loss_func(name), tlosses.get_loss_func(name)
    want = np.asarray(jfn(jnp.asarray(preds), jnp.asarray(labels), reduction))
    x = torch.from_numpy(preds).requires_grad_()
    got = tfn(x, torch.from_numpy(labels), reduction)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-6, atol=1e-7)
    if reduction != "none":
        got.backward()
        gwant = jax.grad(lambda p: jfn(p, jnp.asarray(labels), reduction))(jnp.asarray(preds))
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(gwant), rtol=1e-6, atol=1e-7)


def map_cases():
    rng = np.random.RandomState(7)
    cases = {}
    for n, k in ((50, 8), (7, 3), (300, 20)):
        cases[f"random_{n}x{k}"] = (rng.rand(n, k), (rng.rand(n, k) < 0.3).astype(np.int64))
    # Ties: scores quantized to 4 levels; labels as float32 multi-hot.
    cases["ties"] = (np.floor(rng.rand(40, 6) * 4) / 4,
                     (rng.rand(40, 6) < 0.4).astype(np.float32))
    cases["all_tied"] = (np.full((10, 3), 0.5), (rng.rand(10, 3) < 0.5).astype(np.int64))
    labels = (rng.rand(30, 6) < 0.3).astype(np.int64)
    labels[:, [1, 4]] = 0
    cases["zero_columns"] = (rng.rand(30, 6).astype(np.float32), labels)
    cases["one_sample"] = (rng.rand(1, 5), np.array([[1, 0, 1, 0, 0]]))
    one_class = np.zeros((9, 4), np.int64)
    one_class[[1, 4, 5], 0] = 1  # the other columns are dropped: sklearn's binary path
    cases["one_class"] = (rng.rand(9, 4), one_class)
    cases["all_positive"] = (rng.rand(5, 3), np.ones((5, 3), np.int64))
    # sklearn raises; both return -1.0.
    cases["no_sample"] = (np.zeros((0, 4)), np.zeros((0, 4), np.int64))
    cases["no_positive"] = (rng.rand(6, 4), np.zeros((6, 4), np.int64))
    nan = rng.rand(6, 3)
    nan[2, 1] = np.nan
    cases["nan_score"] = (nan, (rng.rand(6, 3) < 0.5).astype(np.int64))
    cases["three_label_values"] = (rng.rand(6, 3), np.array([[2, 0, 1], [1, 0, 0]] * 3))
    cases["fractional_label"] = (rng.rand(6, 3), np.array([[0.5, 0, 1], [0, 1, 0]] * 3))
    cases["one_class_without_1"] = (rng.rand(6, 2), np.array([[2, 0], [0, 0]] * 3))
    # Labels 1 and 2: sklearn takes the 1s as positives, the 2s as negatives.
    cases["labels_one_and_two"] = (rng.rand(8, 3), np.array([[2, 1, 1], [1, 2, 1]] * 4))
    return cases


MAP_CASES = map_cases()


@pytest.mark.parametrize("name", sorted(MAP_CASES))
def test_get_map_matches_sklearn(name):
    preds, labels = MAP_CASES[name]
    want = jmeters.get_map(preds, labels)
    got = tmeters.get_map(preds, labels)
    assert isinstance(got, float)
    assert abs(got - want) <= 1e-12, (got, want)
    if name in ("no_sample", "no_positive", "nan_score", "three_label_values",
                "fractional_label", "one_class_without_1"):
        assert got == -1.0


@pytest.mark.parametrize("ensemble", ["sum", "max"])
def test_multi_label_test_meter_matches_jax(ensemble):
    """3 videos x 4 views in shuffled batches: the ensembled scores, labels
    and mAP; a view whose labels differ from its video's raises."""
    rng = np.random.RandomState(8)
    num_videos, num_clips, num_cls = 3, 4, 6
    video_labels = (rng.rand(num_videos, num_cls) < 0.4).astype(np.float32)
    video_labels[:, 0] = 1.0
    clip_ids = rng.permutation(num_videos * num_clips)
    preds = rng.rand(num_videos * num_clips, num_cls).astype(np.float32)
    jm = jmeters.TestMeter(num_videos, num_clips, num_cls, 3, multi_label=True,
                           ensemble_method=ensemble)
    tm = tmeters.TestMeter(num_videos, num_clips, num_cls, multi_label=True,
                           ensemble_method=ensemble)
    for b in range(3):
        ids = clip_ids[b * 4:(b + 1) * 4]
        for m in (jm, tm):
            m.update_stats(preds[ids], video_labels[ids // num_clips], ids)
    np.testing.assert_array_equal(tm.video_preds, jm.video_preds)
    np.testing.assert_array_equal(tm.video_labels, jm.video_labels)
    want, got = jm.finalize_metrics(), tm.finalize_metrics()
    assert got == want and isinstance(got["map"], float) and got["map"] > 0
    with pytest.raises(ValueError, match="label consistency"):
        tm.update_stats(preds[:1], 1.0 - video_labels[:1], np.array([0]))


class ListLoader(list):
    device = torch.device("cpu")


def test_val_epoch_logs_the_map_of_its_predictions(tmp_path):
    """Two val batches of multi-hot labels through ``trainer.eval_epoch``: the
    ``val_epoch`` stats hold the mAP of the concatenated predictions, which
    the JAX val meter computes alike."""
    rng = np.random.RandomState(9)
    preds = rng.rand(10, 5).astype(np.float32)
    labels = (rng.rand(10, 5) < 0.4).astype(np.float32)
    loader = ListLoader(([None], labels[i:i + 5], np.arange(i, i + 5), None, {})
                        for i in (0, 5))
    outputs = iter(torch.from_numpy(preds[i:i + 5]) for i in (0, 5))
    cfg, jcfg = get_cfg(), jax_get_cfg()
    for c in (cfg, jcfg):
        c.merge_from_list(["DATA.MULTI_LABEL", "True", "OUTPUT_DIR", str(tmp_path)])
    stats = trainer.eval_epoch(loader, lambda batch: next(outputs), tmeters.ValMeter(2, cfg),
                               0, multi_label=True)
    jm = jmeters.ValMeter(2, jcfg)
    for i in (0, 5):
        jm.update_predictions(preds[i:i + 5], labels[i:i + 5])
    want = jm.log_epoch_stats(0)
    assert stats["map"] == want["map"] == jmeters.get_map(preds, labels)
    assert "top1_err" not in stats


def test_multi_label_train_step_gradients_match_jax_grad():
    jcfg = flagship_cfg(jax_get_cfg, NARROW + MULTI_LABEL)
    jmodel = jax_build_model(jcfg)
    v = variables("narrow")
    x = clips(0)
    y = (np.random.RandomState(400).rand(2, 16) < 0.25).astype(np.float32)
    inputs = jax_preprocess(jcfg, [jnp.asarray(x)])

    def loss_fn(params):
        preds, _ = jmodel.apply({"params": params, "batch_stats": v["batch_stats"]},
                                inputs, train=True, mutable=["batch_stats"],
                                rngs={"dropout": jax.random.PRNGKey(0)})
        return jlosses.get_loss_func("bce_logit")(preds, jnp.asarray(y))

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(v["params"])
    want = state_dict_from_jax({"params": jax.tree.map(np.asarray, grads)})
    cfg = flagship_cfg(get_cfg, NARROW + MULTI_LABEL)
    model = port_model("narrow", MULTI_LABEL)
    model.train()
    preds = model(maybe_device_preprocess(cfg, [torch.from_numpy(x)]))
    got = tlosses.get_loss_func(cfg.MODEL.LOSS_FUNC)(preds, torch.from_numpy(y))
    got.backward()
    np.testing.assert_allclose(got.item(), float(loss), rtol=1e-5)
    grads = {n: p.grad for n, p in model.named_parameters()}
    assert sorted(grads) == sorted(want)
    for n, g in grads.items():
        assert g is not None and g.abs().max() > 0, n
        if n.startswith("head."):
            share = ((g - want[n]).abs().max() / want[n].abs().max()).item()
            assert share <= 1e-3, (n, share)
    assert rel_l2(grads, want, list(grads)) <= 1e-3

    # The trainer's step on the same batch: the same loss, no top-k.
    step_model = port_model("narrow", MULTI_LABEL)
    step = make_train_step(cfg, step_model, toptim.construct_optimizer(step_model, cfg))
    m = step({"inputs": [torch.from_numpy(x)], "labels": torch.from_numpy(y),
              "epoch_exact": 0.0})
    assert set(m) == {"loss", "grad_norm", "lr"}
    np.testing.assert_allclose(m["loss"].item(), got.item(), rtol=1e-6)
