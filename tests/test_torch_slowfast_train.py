"""The SlowFast 4x16 R50 train step of the port against the JAX package, on
the CPU.

The model is ``__graft_entry__._flagship_cfg(tiny=True)``: the full
SlowFast R50 graph and widths (every conv, fusion and BN of the recipe)
with 16 classes, with ``FUSION_KERNEL_SZ`` 5 as in
``configs/Kinetics/SLOWFAST_4x16_R50.yaml``, on 2 clips of 16 frames of 64²
instead of tiny's 8 of 32². At 8 x 32² the slow pathway's res5 is one frame
of 1 x 1, so in training each of its BNs normalizes two values a channel:
there JAX's own jitted and eager losses differ by 5%; at 16 x 64² by
1.4e-6. ``narrow`` is the same graph at depth 18 and width 8. The port's
config is the port's defaults with every key that ``_flagship_cfg``
changes in the JAX defaults changed the same way. Every parameter and BN
statistic is set to a seeded random value (gamma and variance in
[0.5, 1.5]); clips are seeded uint8 batches through the preprocess.

In fp32 the gradient of this train step is not a smooth function of the
rounding: a max-pool argmax or ReLU mask that flips on a near-tie moves a
gradient entry, and the BNs' backward spreads it over the channel. At the
full width the port's fp32 gradients sit 1.2e-2 (relative L2) from the
port's own float64 run and 2.1e-2 from JAX's; on ``narrow`` 2.3e-5 and
3.8e-5. Hence:

* One train step's gradients against ``jax.grad``, dropout off: the loss
  within rtol 1e-5; the head's gradients within 1e-3 of their own max; all
  of them together within 1e-3 relative L2 on ``narrow`` and 5e-2 at full
  width. (A flip stays local: on ``narrow`` one weight's gradient differs
  by 3.5% of its max while all of them together differ by 3.8e-5.)
* A 30-step fp32 trajectory against ``make_train_step`` on ``narrow``: SGD
  with Nesterov momentum 0.9 and weight decay 1e-4, ``BASE_LR`` 0.01 with
  one warmup epoch of 5 steps from 0.001, then the cosine to epoch 6;
  dropout off. Each step starts the port from JAX's state (parameters, BN
  buffers, momentum) and holds the step: the loss within rtol 1e-5, the LR
  within 2e-6 (+1e-9), the gradient norm within 1e-2, every BN running
  mean and variance within atol 1e-4, and the parameters' change and the
  new momentum within 2e-4 of JAX's (relative L2; steps without a flip
  read 5e-6 to 6e-5). A step further apart is decided by the exact step:
  JAX's own step in float64 (``jax_float64``), which the port's float64
  step must meet within 1e-9. Each fp32 run that sits more than 2e-4 from
  the exact step flipped, by at most 5e-2; a step may flip in both runs
  (a ReLU mask or max-pool argmax on a near-tie in each); at most 10
  steps are decided so, and at most 7 flips in each run.
* Why step by step: run free, the port's fp32 losses part from its own
  float64 run's as they part from JAX's (4.4e-3 and 2.5e-3 apart at step 2,
  9.0e-2 and 4.3e-2 at step 6), so no fp32 implementation holds a
  free-running trajectory to 1e-4. A test runs that witness.
* Head dropout: the keep rate, the 1 / (1 - p) scaling, the same masks
  from the same generator seed, none in eval.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from __graft_entry__ import _flagship_cfg
from slowfast_tpu.config import get_cfg as jax_get_cfg
from slowfast_tpu.engine.steps import TrainState, _maybe_device_preprocess as jax_preprocess
from slowfast_tpu.engine.steps import make_train_step as jax_make_train_step
from slowfast_tpu.models import build_model as jax_build_model
from slowfast_tpu.models.build import init_model
from slowfast_tpu.solver import losses as jlosses
from slowfast_tpu.solver import optimizer as joptim
from slowfast_tpu_torch.config import get_cfg
from slowfast_tpu_torch.engine.steps import maybe_device_preprocess, make_train_step
from slowfast_tpu_torch.models import heads as theads
from slowfast_tpu_torch.models.build import build_model
from slowfast_tpu_torch.solver import losses as tlosses
from slowfast_tpu_torch.solver import optimizer as toptim
from slowfast_tpu_torch.utils.checkpoint import state_dict_from_jax
from test_torch_contrastive import jax_float64, to_float64
from test_torch_slowfast import randomize
from test_torch_train import one_torch_thread  # noqa: F401  (autouse fixture)

STEPS_PER_EPOCH = 5
# One step of the trajectory, port vs JAX from the same state: the change of
# the parameters and the new momentum, relative L2 (steps without a flip
# read 5e-6 to 6e-5), and the bound on a step where a flip moved one run.
STEP_TOL = 2e-4
FLIP_TOL = 5e-2
# The port's float64 step against JAX's, and the flips allowed in each fp32 run.
EXACT_TOL = 2e-7
MAX_FLIPS = 7
TRAIN = ["SOLVER.OPTIMIZING_METHOD", "sgd", "SOLVER.NESTEROV", "True", "SOLVER.MOMENTUM", "0.9",
         "SOLVER.WEIGHT_DECAY", "1e-4", "SOLVER.BASE_LR", "0.01", "SOLVER.WARMUP_START_LR",
         "0.001", "SOLVER.WARMUP_EPOCHS", "1.0", "SOLVER.LR_POLICY", "cosine",
         "SOLVER.MAX_EPOCH", "6", "MODEL.DROPOUT_RATE", "0.0", "MIXUP.ENABLE", "False",
         "TRAIN.BATCH_SIZE", "2", "TPU.COMPUTE_DTYPE", "float32",
         "DATA.NUM_FRAMES", "16", "DATA.TRAIN_CROP_SIZE", "64"]


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def flagship_opts():
    """``_flagship_cfg(tiny=True)`` with FUSION_KERNEL_SZ 5, as opts: every
    key whose value differs from the JAX package's defaults."""
    cfg = _flagship_cfg(tiny=True)
    cfg.SLOWFAST.FUSION_KERNEL_SZ = 5
    want, base = _flat(cfg.to_dict()), _flat(jax_get_cfg().to_dict())
    opts = []
    for key, value in sorted(want.items()):
        if base.get(key) != value:
            opts += [key, str(value)]
    return opts


def flagship_cfg(get, extra=()):
    cfg = get()
    cfg.merge_from_list(flagship_opts() + TRAIN + list(extra))
    return cfg


def test_flagship_opts_give_the_same_config():
    assert "SLOWFAST.FUSION_KERNEL_SZ" not in flagship_opts()  # 5 is the default
    got, want = _flat(flagship_cfg(get_cfg).to_dict()), _flat(flagship_cfg(jax_get_cfg).to_dict())
    for key in ("MODEL", "SLOWFAST", "RESNET", "DATA", "NONLOCAL", "SOLVER", "BN"):
        section = {k: v for k, v in want.items() if k.startswith(key + ".")}
        assert {k: got[k] for k in section} == section
    assert got["RESNET.WIDTH_PER_GROUP"] == 64 and got["RESNET.DEPTH"] == 50
    assert got["SLOWFAST.FUSION_KERNEL_SZ"] == 5 and got["MODEL.NUM_CLASSES"] == 16


NARROW = ["RESNET.DEPTH", "18", "RESNET.WIDTH_PER_GROUP", "8",
          "RESNET.NUM_BLOCK_TEMP_KERNEL", "[[2,2],[2,2],[2,2],[2,2]]"]
SIZES = {"full": [], "narrow": NARROW}
_VARIABLES = {}


def variables(size):
    """Seeded random JAX variables of ``size`` (traced shapes, made once)."""
    if size not in _VARIABLES:
        cfg = flagship_cfg(jax_get_cfg, SIZES[size])
        model = jax_build_model(cfg)
        shapes = jax.eval_shape(
            lambda: init_model(model, cfg, rng=jax.random.PRNGKey(0), train=False))
        _VARIABLES[size] = randomize(dict(shapes), 11)
    return _VARIABLES[size]


def port_model(size, extra=()):
    model = build_model(flagship_cfg(get_cfg, SIZES[size] + list(extra)), device="cpu")
    model.load_state_dict(state_dict_from_jax(variables(size)), strict=True)
    return model


def clips(step):
    return np.random.RandomState(200 + step).randint(0, 256, (2, 16, 64, 64, 3)).astype(np.uint8)


def labels(step):
    return np.random.RandomState(300 + step).randint(0, 16, (2,))


def rel_l2(got, want, names):
    diff = torch.cat([(got[n].double() - want[n].double()).flatten() for n in names])
    return (diff.norm() / torch.cat([want[n].double().flatten() for n in names]).norm()).item()


@pytest.mark.parametrize("size", sorted(SIZES))
def test_train_gradients_match_jax_grad(size):
    jcfg = flagship_cfg(jax_get_cfg, SIZES[size])
    jmodel = jax_build_model(jcfg)
    v = variables(size)
    x, y = clips(0), labels(0)
    inputs = jax_preprocess(jcfg, [jnp.asarray(x)])

    def loss_fn(params):
        preds, _ = jmodel.apply({"params": params, "batch_stats": v["batch_stats"]},
                                inputs, train=True, mutable=["batch_stats"],
                                rngs={"dropout": jax.random.PRNGKey(0)})
        return jlosses.get_loss_func("cross_entropy")(preds, jnp.asarray(y))

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(v["params"])
    want = state_dict_from_jax({"params": jax.tree.map(np.asarray, grads)})
    cfg = flagship_cfg(get_cfg, SIZES[size])
    model = port_model(size)
    model.train()
    preds = model(maybe_device_preprocess(cfg, [torch.from_numpy(x)]))
    got = tlosses.get_loss_func("cross_entropy")(preds, torch.from_numpy(y))
    got.backward()
    np.testing.assert_allclose(got.item(), float(loss), rtol=1e-5)
    grads = {n: p.grad for n, p in model.named_parameters()}
    assert sorted(grads) == sorted(want)
    for n, g in grads.items():
        assert g is not None and g.abs().max() > 0, n
        if n.startswith("head."):
            share = ((g - want[n]).abs().max() / want[n].abs().max()).item()
            assert share <= 1e-3, (n, share)
    assert rel_l2(grads, want, list(grads)) <= (1e-3 if size == "narrow" else 5e-2)


def jax_trace(opt_state):
    """The momentum of the JAX chain's ``optax.trace``."""
    (trace,) = [s.trace for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda s: isinstance(s, optax.TraceState))
        if isinstance(s, optax.TraceState)]
    return trace


_JAX_STEP = []


def jax_trainer():
    """The JAX train state of ``narrow`` at step 0 and its jitted train step
    (compiled once for the module)."""
    jcfg = flagship_cfg(jax_get_cfg, NARROW)
    v = variables("narrow")
    tx, _ = joptim.construct_optimizer(v["params"], jcfg, STEPS_PER_EPOCH)
    if not _JAX_STEP:
        _JAX_STEP.append(jax_make_train_step(jcfg, jax_build_model(jcfg), tx, donate=False,
                                             steps_per_epoch=STEPS_PER_EPOCH))
    state = TrainState(step=jnp.zeros((), jnp.int32), params=v["params"],
                       batch_stats=v["batch_stats"], opt_state=tx.init(v["params"]))
    return state, _JAX_STEP[0]


def jax_step64(state, x, y):
    """JAX's step from ``state`` with every float leaf cast up, in float64
    (``jax_float64``): returns the new state as numpy (compiled once)."""
    def up(a):
        a = np.asarray(a)
        return a.astype(np.float64) if np.issubdtype(a.dtype, np.floating) else a

    state = jax.tree.map(up, state)
    batch = {"inputs": [jnp.asarray(x)], "labels": jnp.asarray(y)}
    with jax_float64():
        if len(_JAX_STEP) < 2:
            jcfg = flagship_cfg(jax_get_cfg, NARROW)
            tx, _ = joptim.construct_optimizer(state.params, jcfg, STEPS_PER_EPOCH)
            step = jax_make_train_step(jcfg, jax_build_model(jcfg), tx, donate=False,
                                       steps_per_epoch=STEPS_PER_EPOCH)
            _JAX_STEP.append(step.lower(state, batch, jax.random.PRNGKey(0)).compile())
        new, _ = _JAX_STEP[1](state, batch, jax.random.PRNGKey(0))
    return jax.tree.map(np.asarray, new)


def pathways64(cfg, x):
    """The float64 pathways that JAX's preprocess makes of ``x`` in float64:
    its fp32 scale and bias (``1 / (255 std)``, ``-mean / std``), the clip
    in float64."""
    mean, std = np.asarray(cfg.DATA.MEAN, np.float32), np.asarray(cfg.DATA.STD, np.float32)
    scale, bias = (1.0 / (255.0 * std)).astype(np.float64), (-mean / std).astype(np.float64)
    fast = torch.from_numpy(x.astype(np.float64) * scale + bias)
    idx = np.linspace(0, x.shape[1] - 1, x.shape[1] // cfg.SLOWFAST.ALPHA).astype(np.int64)
    return [fast[:, idx], fast]


def port_step64(m64, opt64, before, opt_state, inputs, y, lr):
    """The port's step from ``before`` in float64 throughout (the train
    step takes its loss in fp32): returns the parameters and momentum."""
    m64.load_state_dict(before, strict=True)
    opt64.load_state_dict(opt_state)
    m64.train()
    for p in m64.parameters():
        p.grad = None
    F.cross_entropy(m64(inputs), torch.from_numpy(y).long()).backward()
    opt64.step(lr)
    return dict(m64.named_parameters()), dict(zip(opt64.names, opt64.trace))


def step_values(names, before, params, trace):
    """The parameters' change from ``before`` and the new momentum, float64."""
    return ({n: params[n].double() - before[n].double() for n in names},
            {n: trace[n].double() for n in names})


def test_thirty_step_sgd_trajectory_matches_jax():
    state, jstep = jax_trainer()

    cfg = flagship_cfg(get_cfg, NARROW)
    model = port_model("narrow")
    m64 = to_float64(port_model("narrow"))
    opt = toptim.construct_optimizer(model, cfg)
    opt64 = toptim.construct_optimizer(m64, cfg)
    assert isinstance(opt, toptim.SGD) and opt.nesterov and opt.momentum == 0.9
    step = make_train_step(cfg, model, opt)
    names = [n for n, _ in model.named_parameters()]
    lrs, flips, decided = [], {"port": [], "jax": []}, []
    for i in range(STEPS_PER_EPOCH * 6):
        x, y = clips(i), labels(i)
        before = state_dict_from_jax({"params": state.params, "batch_stats": state.batch_stats})
        opt_state = {"count": i, "trace": state_dict_from_jax(
            {"params": jax_trace(state.opt_state)})}
        model.load_state_dict(before, strict=True)
        opt.load_state_dict(opt_state)
        start = state
        state, jm = jstep(state, {"inputs": [jnp.asarray(x)], "labels": jnp.asarray(y)},
                          jax.random.PRNGKey(0))
        batch = {"inputs": [torch.from_numpy(x)], "labels": torch.from_numpy(y),
                 "epoch_exact": i / STEPS_PER_EPOCH}
        m = step(batch)
        np.testing.assert_allclose(m["loss"].item(), float(jm["loss"]), rtol=1e-5, err_msg=i)
        # JAX's fp32 cosine cancels near its end: 1e-9 is 1e-7 of BASE_LR.
        np.testing.assert_allclose(m["lr"], float(jm["lr"]), rtol=2e-6, atol=1e-9)
        np.testing.assert_allclose(m["grad_norm"].item(), float(jm["grad_norm"]), rtol=1e-2)
        lrs.append(m["lr"])
        want = state_dict_from_jax({"params": state.params, "batch_stats": state.batch_stats})
        sd = model.state_dict()
        for k in want:
            if "running_" in k:
                assert not torch.equal(want[k], before[k]), k
                np.testing.assert_allclose(sd[k].numpy(), want[k].numpy(), atol=1e-4, err_msg=k)
        got = step_values(names, before, sd, dict(zip(opt.names, opt.trace)))
        ref = step_values(names, before, want,
                          state_dict_from_jax({"params": jax_trace(state.opt_state)}))
        far = [rel_l2(a, b, names) for a, b in zip(got, ref)]
        if max(far) <= STEP_TOL:
            continue
        # A ReLU mask or max-pool argmax flipped on a near-tie in one or both
        # of the two fp32 runs. JAX's float64 step is the exact one; the
        # port's float64 step must be it, and each fp32 run that departs
        # from it flipped.
        new64 = jax_step64(start, x, y)
        exact = step_values(names, before,
                            state_dict_from_jax({"params": new64.params}),
                            state_dict_from_jax({"params": jax_trace(new64.opt_state)}))
        port64 = port_step64(m64, opt64, before, opt_state, pathways64(cfg, x), y, m["lr"])
        port64 = step_values(names, before, *port64)
        port64_vs_exact = max(rel_l2(a, b, names) for a, b in zip(port64, exact))
        assert port64_vs_exact <= EXACT_TOL, (i, port64_vs_exact)
        departs = {run: max(rel_l2(a, b, names) for a, b in zip(values, exact))
                   for run, values in (("port", got), ("jax", ref))}
        assert max(far) <= FLIP_TOL and max(departs.values()) <= FLIP_TOL, (i, far, departs)
        decided.append(i)
        for run, d in departs.items():
            if d > STEP_TOL:
                flips[run].append(i)
    # Warmup from 0.001, the cosine's peak at epoch 1, then down toward 0.
    assert lrs[0] == pytest.approx(0.001) and 0.009 < max(lrs) < 0.01 and lrs[-1] < 1e-4
    # A flip is the exception: most steps agree within STEP_TOL.
    assert len(decided) <= 10, (decided, flips)
    assert all(len(f) <= MAX_FLIPS for f in flips.values()), flips


def test_free_running_fp32_trajectory_parts_from_float64():
    """Why the trajectory above is held step by step: run free, the port's
    own fp32 training parts from the same training in float64 as fast as
    from JAX's (a flip moves one step by up to 2e-2, and the next steps
    amplify it). The losses agree at the first step and part by more than
    1e-3 within 8 steps, in both pairs."""
    state, jstep = jax_trainer()
    cfg = flagship_cfg(get_cfg, NARROW)
    losses = {"jax": [], "float32": [], "float64": []}
    runs = {}
    for dtype in ("float32", "float64"):
        model = port_model("narrow")
        if dtype == "float64":
            model.double()
            model.dtype = torch.float64
        runs[dtype] = make_train_step(cfg, model, toptim.construct_optimizer(model, cfg))
    for i in range(8):
        x, y = clips(i), labels(i)
        state, jm = jstep(state, {"inputs": [jnp.asarray(x)], "labels": jnp.asarray(y)},
                          jax.random.PRNGKey(0))
        losses["jax"].append(float(jm["loss"]))
        for dtype, run in runs.items():
            losses[dtype].append(run({"inputs": [torch.from_numpy(x)], "labels": torch.from_numpy(y),
                                      "epoch_exact": i / STEPS_PER_EPOCH})["loss"].item())
    got = np.array(losses["float32"])
    parts = {k: np.abs(got - np.array(losses[k])) / np.array(losses[k]) for k in ("jax", "float64")}
    for k, d in parts.items():
        assert d[0] <= 1e-5 and d.max() > 1e-3, (k, d)


def test_head_dropout():
    """ResNetBasicHead with rate 0.25: the kept share, the scaling, the
    masks a generator seed gives, and none in eval."""
    head = theads.ResNetBasicHead(dim_in=[256, 32], num_classes=8, pool_size=None,
                                  dropout_rate=0.25, act_func="softmax")
    seen = []
    xs = [torch.rand(4, 2, 3, 3, 256) + 0.5, torch.rand(4, 8, 3, 3, 32) + 0.5]
    pooled = torch.cat([x.mean(dim=(1, 2, 3), keepdim=True) for x in xs], dim=-1)
    orig = theads.linear

    def spy(x, layer, dtype):
        seen.append(x.detach().clone())
        return orig(x, layer, dtype)

    theads.linear = spy
    try:
        head.train()
        for seed in (0, 0, 1):
            head.generator = torch.Generator().manual_seed(seed)
            head(xs)
        head.eval()
        head(xs)
    finally:
        theads.linear = orig
    a, b, c, evald = seen
    assert torch.equal(a, b) and not torch.equal(a, c)
    kept = a != 0
    share = kept.float().mean().item()
    assert 0.7 < share < 0.8, share  # 1152 draws at p = 0.75
    torch.testing.assert_close(a[kept], (pooled / 0.75)[kept], rtol=0, atol=0)
    assert torch.equal(evald, pooled)


def test_model_dropout_draws_from_the_model_generator():
    """With DROPOUT_RATE 0.5 two models built with the same RNG_SEED give
    the same train-mode logits, unlike the same model without dropout."""
    x = maybe_device_preprocess(flagship_cfg(get_cfg, NARROW), [torch.from_numpy(clips(0))])
    outs = []
    for rate in ("0.5", "0.5", "0.0"):
        model = port_model("narrow", ["MODEL.DROPOUT_RATE", rate])
        assert model.head.generator is not None
        model.train()
        with torch.no_grad():
            outs.append(model(x))
    assert torch.equal(outs[0], outs[1]) and not torch.equal(outs[0], outs[2])
