"""AVA detection through the port against the JAX package, on the CPU.

Narrow detection models of both AVA recipes: ``SLOWFAST_32x2_R50_SHORT``
(SlowFast, alpha 4, res5 at stride 1 with dilation 2: the RoI head sees
maps at 1/16) and ``SLOW_4x16_R50_DETECTION`` (the ResNet branch, res5 at
1/32), at depth 18, width 8, 6 classes, on 2 seeded uint8 clips through
the preprocess, with every parameter and BN statistic seeded random and
carried across with ``state_dict_from_jax``. SlowFast takes ``BETA_INV`` 2:
the JAX package's convolution drops the dilation of a full 3D conv with
fewer than 32 input channels (slowfast_tpu/ops/video_conv.py:348,
``conv3d_folded``), which the fast pathway's dilated res5 has at width 8
and ``BETA_INV`` 8. Boxes are padded to a bucket
(clips with 3 and 2 real boxes of 4); dropout is off where the two
frameworks would draw different masks.

* The eval step's predictions per box (fp32 within 1e-5; bf16 within 2e-2,
  the two frameworks round activations at different places).
* The masked ``bce`` loss within rtol 1e-5 and its gradients: the head's
  within 1e-3 of their max, all of them within 1e-3 relative L2 unless a
  near-tie flipped (a ReLU, a max-pool argmax or a bin max: the 49 bins of
  a box an eighth of a feature pixel wide differ little), which the same
  step in float64 decides (``flip_decided``): the port's float64 step is
  JAX's (the port's fp32 run flipped), or the port's fp32 step is its
  float64 one (JAX's flipped), or both fp32 runs flipped and the port's is
  no further from float64 than twice JAX's, the yardstick of
  ``chip_smoke.py``'s ``sf_train_fp32``. (At the trajectory's first step
  JAX's train step and its own ``jax.grad`` of the same loss sit 1e-2
  apart, and both 1e-2 from float64.)
* The loss does not change with the padding bucket, and the port's
  ``detection_collate`` equals the JAX package's.
* A 5-step teacher-forced SGD trajectory of the recipe (Nesterov, 0.9,
  warmup from 0.000125) against ``make_train_step``.
* ``run_net`` training, validating and testing both recipes on a tiny JPEG
  AVA corpus, whose test mAP equals the JAX package's ``AVAMeter`` on the
  same predictions.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slowfast_tpu.config import get_cfg as jax_get_cfg
from slowfast_tpu.data.loader import detection_collate as jax_detection_collate
from slowfast_tpu.engine.steps import TrainState, _maybe_device_preprocess as jax_preprocess
from slowfast_tpu.engine.steps import make_eval_step as jax_make_eval_step
from slowfast_tpu.engine.steps import make_train_step as jax_make_train_step
from slowfast_tpu.models import build_model as jax_build_model
from slowfast_tpu.models.build import init_model
from slowfast_tpu.solver import losses as jlosses
from slowfast_tpu.solver import optimizer as joptim
from slowfast_tpu.utils.meters import AVAMeter as JaxAVAMeter
from slowfast_tpu_torch.config import get_cfg
from slowfast_tpu_torch.data.loader import detection_collate
from slowfast_tpu_torch.data.synth_media import make_ava_corpus
from slowfast_tpu_torch.engine.steps import (make_eval_step, make_train_step,
                                             masked_detection_loss, maybe_device_preprocess)
from slowfast_tpu_torch.models.build import build_model
from slowfast_tpu_torch.run_net import main as run_net_main
from slowfast_tpu_torch.solver import losses as tlosses
from slowfast_tpu_torch.solver import optimizer as toptim
from slowfast_tpu_torch.utils import checkpoint as cu
from slowfast_tpu_torch.utils import meters as tmeters
from slowfast_tpu_torch.utils.checkpoint import state_dict_from_jax
from test_torch_slowfast import randomize
from test_torch_slowfast_train import jax_trace, rel_l2
from test_torch_train import one_torch_thread  # noqa: F401  (autouse fixture)

CONFIGS = os.path.join(os.path.dirname(__file__), "..", "configs", "AVA")
MODELS = {
    "slowfast": ("SLOWFAST_32x2_R50_SHORT.yaml",
                 ["RESNET.NUM_BLOCK_TEMP_KERNEL", "[[2,2],[2,2],[2,2],[2,2]]",
                  "DATA.NUM_FRAMES", "8", "SLOWFAST.BETA_INV", "2"]),
    "slow": ("SLOW_4x16_R50_DETECTION.yaml",
             ["RESNET.NUM_BLOCK_TEMP_KERNEL", "[[2],[2],[2],[2]]"]),
}
NARROW = ["RESNET.DEPTH", "18", "RESNET.WIDTH_PER_GROUP", "8", "MODEL.NUM_CLASSES", "6",
          "DATA.TRAIN_CROP_SIZE", "64", "DATA.TEST_CROP_SIZE", "64", "NUM_GPUS", "1",
          "MODEL.DROPOUT_RATE", "0.0", "TRAIN.BATCH_SIZE", "2"]
STEPS_PER_EPOCH = 5
STEP_TOL = 2e-4  # a trajectory step's parameter change and momentum, relative L2
FLIP_TOL = 5e-2  # the same on a step where a near-tie flipped
GRAD_TOL = 1e-3  # all gradients of one step, relative L2


def det_cfg(get, model, dtype="float32", extra=()):
    yaml, opts = MODELS[model]
    cfg = get()
    cfg.merge_from_file(os.path.join(CONFIGS, yaml))
    cfg.merge_from_list(NARROW + opts + ["TPU.COMPUTE_DTYPE", dtype] + list(extra))
    return cfg


_VARIABLES = {}


def variables(model):
    if model not in _VARIABLES:
        cfg = det_cfg(jax_get_cfg, model)
        jmodel = jax_build_model(cfg)
        shapes = jax.eval_shape(
            lambda: init_model(jmodel, cfg, rng=jax.random.PRNGKey(0), train=False))
        _VARIABLES[model] = randomize(dict(shapes), 21)
    return _VARIABLES[model]


def port_model(model, dtype="float32", extra=()):
    net = build_model(det_cfg(get_cfg, model, dtype, extra), device="cpu")
    net.load_state_dict(state_dict_from_jax(variables(model)), strict=True)
    return net


def batch(model, seed, M=4, counts=(3, 2)):
    """Seeded uint8 clips, padded boxes in the synthetic sampler's range,
    their mask and multi-hot labels."""
    cfg = det_cfg(get_cfg, model)
    rs = np.random.RandomState(seed)
    crop = cfg.DATA.TRAIN_CROP_SIZE
    clips = rs.randint(0, 256, (2, cfg.DATA.NUM_FRAMES, crop, crop, 3)).astype(np.uint8)
    boxes = np.zeros((2, M, 4), np.float32)
    mask = np.zeros((2, M), np.float32)
    labels = np.zeros((2, M, 6), np.float32)
    for b, n in enumerate(counts):
        xy1 = rs.rand(n, 2) * (crop / 2)
        boxes[b, :n] = np.concatenate([xy1, xy1 + rs.rand(n, 2) * (crop / 2) + 2.0], axis=1)
        mask[b, :n] = 1.0
        labels[b, :n] = rs.rand(n, 6) < 0.3
    return clips, boxes, mask, labels


def jax_state(model):
    v = variables(model)
    return TrainState(step=0, params=v["params"], batch_stats=v["batch_stats"], opt_state=None)


@pytest.mark.parametrize("model,dtype", [("slowfast", "float32"), ("slowfast", "bfloat16"),
                                         ("slow", "float32")])
def test_eval_predictions_per_box_match_jax(model, dtype):
    clips, boxes, _, _ = batch(model, 1)
    jcfg = det_cfg(jax_get_cfg, model, dtype)
    want = np.asarray(jax_make_eval_step(jcfg, jax_build_model(jcfg))(
        jax_state(model), {"inputs": [jnp.asarray(clips)], "boxes": jnp.asarray(boxes)}),
        np.float32)
    got = make_eval_step(det_cfg(get_cfg, model, dtype), port_model(model, dtype))(
        {"inputs": [torch.from_numpy(clips)], "boxes": torch.from_numpy(boxes)})
    assert got.shape == want.shape == (8, 6)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=1e-5 if dtype == "float32" else 2e-2)


def flip_decided(got, want, exact, names, tol):
    """How the float64 run ``exact`` explains fp32 runs ``got`` (the port's)
    and ``want`` (JAX's) that are more than ``tol`` apart, or None."""
    port_vs_exact, jax_vs_exact = rel_l2(got, exact, names), rel_l2(want, exact, names)
    if jax_vs_exact <= tol:
        return "port"
    if port_vs_exact <= tol:
        return "jax"
    return "both" if port_vs_exact <= 2.0 * jax_vs_exact else None


def jax_loss_and_grads(model, clips, boxes, mask, labels):
    """The JAX detection train step's loss and gradients
    (slowfast_tpu/engine/steps.py:99-116), dropout off."""
    cfg = det_cfg(jax_get_cfg, model)
    jmodel, v = jax_build_model(cfg), variables(model)
    inputs = jax_preprocess(cfg, [jnp.asarray(clips)])
    loss_fun = jlosses.get_loss_func(cfg.MODEL.LOSS_FUNC)

    def loss_fn(params):
        preds, _ = jmodel.apply({"params": params, "batch_stats": v["batch_stats"]}, inputs,
                                jnp.asarray(boxes), train=True, mutable=["batch_stats"],
                                rngs={"dropout": jax.random.PRNGKey(0)})
        m = jnp.asarray(mask).reshape(-1)
        per = loss_fun(preds, jnp.asarray(labels).reshape(preds.shape[0], -1),
                       reduction="none") * m[:, None]
        return jnp.sum(per) / jnp.maximum(m.sum() * preds.shape[-1], 1.0)

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(v["params"])
    return float(loss), state_dict_from_jax({"params": jax.tree.map(np.asarray, grads)})


def port_loss_and_grads(net, cfg, clips, boxes, mask, labels, dtype=torch.float32):
    net.train()
    for p in net.parameters():
        p.grad = None
    inputs = [x.to(dtype) for x in maybe_device_preprocess(cfg, [torch.from_numpy(clips)])]
    preds = net(inputs, torch.from_numpy(boxes).to(dtype))
    loss = masked_detection_loss(tlosses.get_loss_func(cfg.MODEL.LOSS_FUNC), preds,
                                 torch.from_numpy(labels).to(dtype), torch.from_numpy(mask))
    loss.backward()
    return loss.item(), {n: p.grad.clone() for n, p in net.named_parameters()}


@pytest.mark.parametrize("model", sorted(MODELS))
def test_masked_loss_and_gradients_match_jax(model):
    clips, boxes, mask, labels = batch(model, 2)
    want_loss, want = jax_loss_and_grads(model, clips, boxes, mask, labels)
    cfg = det_cfg(get_cfg, model)
    loss, grads = port_loss_and_grads(port_model(model), cfg, clips, boxes, mask, labels)
    np.testing.assert_allclose(loss, want_loss, rtol=1e-5)
    assert sorted(grads) == sorted(want)
    for n, g in grads.items():
        assert g.abs().max() > 0, n
        if n.startswith("head."):
            share = ((g - want[n]).abs().max() / want[n].abs().max()).item()
            assert share <= 1e-3, (n, share)
    names = list(grads)
    far = rel_l2(grads, want, names)
    if far > GRAD_TOL:
        # A near-tie flipped in one fp32 run: float64 decides which.
        net64 = port_model(model).double()
        net64.dtype = torch.float64
        _, exact = port_loss_and_grads(net64, cfg, clips, boxes, mask, labels, torch.float64)
        assert flip_decided(grads, want, exact, names, GRAD_TOL), far


def test_loss_does_not_change_with_the_padding_bucket():
    """The same boxes padded to 4 and to 8 rows: the masked loss and its
    gradients agree (padded rows contribute nothing), and JAX's at 8."""
    clips, boxes, mask, labels = batch("slowfast", 3)
    cfg = det_cfg(get_cfg, "slowfast")
    wide = [np.concatenate([a, np.zeros_like(a)], axis=1) for a in (boxes, mask, labels)]
    l4, g4 = port_loss_and_grads(port_model("slowfast"), cfg, clips, boxes, mask, labels)
    l8, g8 = port_loss_and_grads(port_model("slowfast"), cfg, clips, *wide)
    np.testing.assert_allclose(l8, l4, rtol=1e-6)
    assert rel_l2(g8, g4, list(g4)) <= 1e-6
    np.testing.assert_allclose(l8, jax_loss_and_grads("slowfast", clips, *wide)[0], rtol=1e-5)


def test_detection_collate_matches_jax():
    rs = np.random.RandomState(4)
    samples = []
    for i, n in enumerate([2, 5, 1]):
        pathways = [rs.rand(2, 8, 8, 3).astype(np.float32), rs.rand(8, 8, 8, 3)]
        meta = {"boxes": rs.rand(n, 4).astype(np.float32) * 8,
                "ori_boxes": rs.rand(n, 4).astype(np.float32), "metadata": [[i, 900 + i]] * n}
        samples.append((pathways, rs.randint(0, 2, (n, 6)).astype(np.int32), i, np.zeros(1),
                        meta))
    got, want = detection_collate(samples), jax_detection_collate(samples)
    for g, w in zip(got[0], want[0]):
        assert g.dtype == w.dtype == np.float32 and np.array_equal(g, w)
    for g, w in zip(got[1:4], want[1:4]):
        assert np.array_equal(g, w) and np.asarray(g).dtype == np.asarray(w).dtype
    assert sorted(got[4]) == sorted(want[4]) == ["box_mask", "boxes", "metadata", "ori_boxes"]
    for key in got[4]:
        assert np.array_equal(got[4][key], want[4][key]), key
    assert got[4]["boxes"].shape == (3, 8, 4) and got[1].shape == (3, 8, 6)


def test_five_step_sgd_trajectory_matches_jax():
    """The SlowFast recipe's SGD (Nesterov momentum 0.9, weight decay 1e-7, warmup
    from 0.000125 to 0.1 over 5 epochs of 5 steps), teacher-forced: each
    step starts the port from JAX's parameters, BN buffers and momentum."""
    model = "slowfast"
    jcfg = det_cfg(jax_get_cfg, model)
    v = variables(model)
    tx, _ = joptim.construct_optimizer(v["params"], jcfg, STEPS_PER_EPOCH)
    jstep = jax_make_train_step(jcfg, jax_build_model(jcfg), tx, donate=False,
                                steps_per_epoch=STEPS_PER_EPOCH)
    state = TrainState(step=jnp.zeros((), jnp.int32), params=v["params"],
                       batch_stats=v["batch_stats"], opt_state=tx.init(v["params"]))
    cfg = det_cfg(get_cfg, model)
    net = port_model(model)
    opt = toptim.construct_optimizer(net, cfg)
    assert isinstance(opt, toptim.SGD) and opt.momentum == 0.9 and opt.nesterov
    step = make_train_step(cfg, net, opt)
    names = [n for n, _ in net.named_parameters()]
    flips = []
    for i in range(5):
        clips, boxes, mask, labels = batch(model, 10 + i)
        before = state_dict_from_jax({"params": state.params, "batch_stats": state.batch_stats})
        net.load_state_dict(before, strict=True)
        opt_state = {"count": i, "trace": state_dict_from_jax(
            {"params": jax_trace(state.opt_state)})}
        opt.load_state_dict(opt_state)
        state, jm = jstep(state, {"inputs": [jnp.asarray(clips)], "labels": jnp.asarray(labels),
                                  "boxes": jnp.asarray(boxes), "box_mask": jnp.asarray(mask)},
                          jax.random.PRNGKey(0))
        m = step({"inputs": [torch.from_numpy(clips)], "labels": torch.from_numpy(labels),
                  "boxes": torch.from_numpy(boxes), "box_mask": torch.from_numpy(mask),
                  "epoch_exact": i / STEPS_PER_EPOCH})
        assert "top1_err" not in m
        np.testing.assert_allclose(m["loss"].item(), float(jm["loss"]), rtol=1e-5, err_msg=i)
        np.testing.assert_allclose(m["lr"], float(jm["lr"]), rtol=2e-6)
        np.testing.assert_allclose(m["grad_norm"].item(), float(jm["grad_norm"]), rtol=1e-2)
        want = state_dict_from_jax({"params": state.params, "batch_stats": state.batch_stats})
        sd = net.state_dict()
        for k in want:
            if "running_" in k:
                np.testing.assert_allclose(sd[k].numpy(), want[k].numpy(), atol=1e-4, err_msg=k)
        got = ({n: sd[n] - before[n] for n in names},
               {n: t.clone() for n, t in zip(opt.names, opt.trace)})
        ref = ({n: want[n] - before[n] for n in names},
               state_dict_from_jax({"params": jax_trace(state.opt_state)}))
        far = max(rel_l2(a, b, names) for a, b in zip(got, ref))
        if far > STEP_TOL:
            # A near-tie flipped in one fp32 run: the port's step with its
            # gradients in float64 decides which, as in
            # tests/test_torch_slowfast_train.py.
            net64 = port_model(model).double()
            net64.dtype = torch.float64
            net64.load_state_dict(before, strict=True)
            _, grads64 = port_loss_and_grads(net64, cfg, clips, boxes, mask, labels,
                                             torch.float64)
            net.load_state_dict(before, strict=True)
            opt.load_state_dict(opt_state)
            for n, p in net.named_parameters():
                p.grad = grads64[n].float()
            opt.step(m["lr"])
            exact = ({n: p.detach() - before[n] for n, p in net.named_parameters()},
                     {n: t.clone() for n, t in zip(opt.names, opt.trace)})
            cases = [flip_decided(a, b, e, names, STEP_TOL) for a, b, e in zip(got, ref, exact)]
            assert all(cases) and far <= FLIP_TOL, (i, far, cases)
            flips.append(i)
    assert m["lr"] > float(0.000125) and len(flips) <= 3, flips


def test_test_checkpoint_defaults_to_the_last_in_output_dir(tmp_path):
    """As the JAX package selects it: TEST.CHECKPOINT_FILE_PATH, else the
    last checkpoint in OUTPUT_DIR, else TRAIN.CHECKPOINT_FILE_PATH."""
    cfg = det_cfg(get_cfg, "slow", extra=["OUTPUT_DIR", str(tmp_path)])
    net = port_model("slow")
    cu.save_checkpoint(str(tmp_path), net, toptim.construct_optimizer(net, cfg), 0, cfg)
    fresh = build_model(cfg, device="cpu")
    assert not torch.equal(fresh.head.projection.weight, net.head.projection.weight)
    cu.load_test_checkpoint(cfg, fresh)
    for k, t in net.state_dict().items():
        assert torch.equal(fresh.state_dict()[k], t), k


RUN_NET = {"slowfast": ["RESNET.NUM_BLOCK_TEMP_KERNEL", "[[2,2],[2,2],[2,2],[2,2]]",
                        "SLOWFAST.BETA_INV", "2", "DATA.NUM_FRAMES", "8"],
           "slow": ["RESNET.NUM_BLOCK_TEMP_KERNEL", "[[2],[2],[2],[2]]"]}


@pytest.mark.parametrize("model", sorted(RUN_NET))
def test_run_net_trains_validates_and_tests_ava(tmp_path, monkeypatch, model):
    """``run_net`` on each AVA recipe (narrow, 32² crops, recipe dropout 0.5)
    over a JPEG AVA corpus: one epoch of train steps, a val epoch scored on
    the mini GT, the checkpoint, and the test on the full GT; the test's
    mAP equals the JAX ``AVAMeter``'s on its predictions."""
    corpus = make_ava_corpus(str(tmp_path / "ava"), num_videos=2, secs=range(902, 907),
                             size=(48, 36), num_classes=6, seed=3)
    out = tmp_path / "out"
    out.mkdir()
    opts = ["RESNET.DEPTH", "18", "RESNET.WIDTH_PER_GROUP", "8", "MODEL.NUM_CLASSES", "6",
            *RUN_NET[model], "NUM_GPUS", "1",
            "DATA.TRAIN_CROP_SIZE", "32", "DATA.TEST_CROP_SIZE", "32",
            "DATA.TRAIN_JITTER_SCALES", "[36, 44]", "TRAIN.BATCH_SIZE", "2",
            "TEST.BATCH_SIZE", "2", "SOLVER.MAX_EPOCH", "1", "DATA_LOADER.NUM_WORKERS", "2",
            "TPU.COMPUTE_DTYPE", "float32", "OUTPUT_DIR", str(out), *corpus]
    seen = {}
    finalize = tmeters.AVAMeter.finalize_metrics

    def spy(meter, log=True):
        value = finalize(meter, log)
        seen[meter.mode] = ([np.concatenate(x) for x in (
            meter.all_preds, meter.all_ori_boxes, meter.all_metadata)],
            meter.video_idx_to_name, value)
        return value

    monkeypatch.setattr(tmeters.AVAMeter, "finalize_metrics", spy)
    run_net_main(["--device", "cpu", "--cfg", os.path.join(CONFIGS, MODELS[model][0]),
                  "--opts", *opts])
    with open(out / "json_stats.log") as f:
        logged = [json.loads(line.split("json_stats: ", 1)[1]) for line in f]
    by_type = {}
    for s in logged:
        by_type.setdefault(s.get("_type", s.get("mode")), []).append(s)
    assert np.isfinite(by_type["train_epoch"][0]["loss"])
    assert by_type["val_epoch"][0]["map"] == pytest.approx(seen["val"][2], abs=1e-5)  # rounded
    assert os.path.exists(cu.get_path_to_checkpoint(str(out), 1))
    (preds, boxes, meta), names, got = seen["test"]
    assert preds.shape[1] == 6 and preds.shape[0] == boxes.shape[0] == meta.shape[0] > 0
    assert np.isfinite(preds).all() and 0.0 < got <= 1.0
    jcfg = jax_get_cfg()
    jcfg.merge_from_file(os.path.join(CONFIGS, MODELS[model][0]))
    jcfg.merge_from_list(opts)
    jmeter = JaxAVAMeter(1, jcfg, "test")
    jmeter.set_video_idx_to_name(names)
    jmeter.update_stats(preds, boxes, meta)
    assert abs(jmeter.finalize_metrics(log=False) - got) <= 1e-12
