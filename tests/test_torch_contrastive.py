"""The port's contrastive SSL pieces against the JAX package, on the CPU:
``MLPHead`` (with and without BN, both dtypes), ``sub_batchnorm``, the
``sinkhorn``, ``momentum_update``, ``dequeue_and_enqueue`` with wrap-around,
``memory_update`` (1-D, 2-D, 2-D interpolated), ``nce_logits``, and the
weight bridge both ways (the model and the SSL state). The model's
forward is in tests/test_torch_contrastive_forward.py, LARS in
tests/test_torch_ssl_steps.py, the recipes' builds in
tests/test_torch_ssl_run.py.

The models are ``tests/test_ssl.py``'s ``_ssl_cfg`` (C2D R18, 4 frames of
32², a 2-layer projection MLP of 64, DIM 32, a queue of 64 and a bank of
50), narrowed to ``WIDTH_PER_GROUP`` 8, their parameters and BN statistics
seeded random values (``test_torch_slowfast.randomize``), carried to the
port through ``state_dict_from_jax``. Shared with
``tests/test_torch_ssl_train.py``.
"""

import contextlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import traverse_util

from slowfast_tpu.config import get_cfg as jax_get_cfg
from slowfast_tpu.engine.ssl_steps import SSLTrainState
from slowfast_tpu.models import build_model as jax_build_model
from slowfast_tpu.models import contrastive as jcon
from slowfast_tpu.models.batchnorm import BatchNorm3D as JaxBN
from slowfast_tpu.models.build import dummy_inputs
from slowfast_tpu.models.heads import MLPHead as JaxMLPHead
from slowfast_tpu.solver import optimizer as joptim
from slowfast_tpu.utils.checkpoint import load_torch_checkpoint_dict
from slowfast_tpu_torch.config import get_cfg
from slowfast_tpu_torch.models import contrastive as tcon
from slowfast_tpu_torch.models.batchnorm import BatchNorm3D
from slowfast_tpu_torch.models.build import build_model
from slowfast_tpu_torch.models.heads import MLPHead
from slowfast_tpu_torch.solver import optimizer as toptim
from slowfast_tpu_torch.utils.checkpoint import ssl_state_from_jax, state_dict_from_jax
from test_ssl import _ssl_cfg
from test_torch_slowfast import randomize
from test_torch_train import one_torch_thread  # noqa: F401  (autouse fixture)

SSL_TYPES = ["moco", "byol", "simclr", "swav", "mem"]
B = 8


def ssl_opts(ssl_type):
    """``_ssl_cfg(ssl_type)``'s settings as config options."""
    opts = ["MODEL.MODEL_NAME", "ContrastiveModel", "MODEL.ARCH", "c2d",
            "MODEL.NUM_CLASSES", "32", "MODEL.LOSS_FUNC", "contrastive_loss",
            "MODEL.HEAD_ACT", "none", "MODEL.DROPOUT_RATE", "0.0", "RESNET.DEPTH", "18",
            "RESNET.NUM_BLOCK_TEMP_KERNEL", "[[2], [2], [2], [2]]",
            "CONTRASTIVE.TYPE", ssl_type, "CONTRASTIVE.DIM", "32",
            "CONTRASTIVE.QUEUE_LEN", "64", "CONTRASTIVE.LENGTH", "50",
            "CONTRASTIVE.NUM_MLP_LAYERS", "2", "CONTRASTIVE.MLP_DIM", "64",
            "DATA.NUM_FRAMES", "4", "DATA.TRAIN_CROP_SIZE", "32", "DATA.INPUT_CHANNEL_NUM", "[3]",
            "SOLVER.BASE_LR", "0.01", "SOLVER.WARMUP_EPOCHS", "0.0",
            "TPU.COMPUTE_DTYPE", "float32", "NUM_GPUS", "1"]
    if ssl_type == "byol":
        opts += ["CONTRASTIVE.PREDICTOR_DEPTHS", "[2]"]
    return opts


NARROW = ["RESNET.WIDTH_PER_GROUP", "8"]


def make_cfg(get, ssl_type, extra=(), dtype="float32"):
    cfg = get()
    cfg.merge_from_list(ssl_opts(ssl_type) + NARROW + list(extra)
                        + ["TPU.COMPUTE_DTYPE", dtype])
    return cfg


def test_opts_give_ssl_cfg():
    for t in SSL_TYPES:
        want = _ssl_cfg(t)
        got = jax_get_cfg()
        got.merge_from_list(ssl_opts(t))
        assert got.dump() == want.dump(), t


def jax_variables(ssl_type, extra=(), seed=0):
    """Seeded random variables of the narrow JAX ``ContrastiveModel``."""
    cfg = make_cfg(jax_get_cfg, ssl_type, extra)
    model = jax_build_model(cfg)
    shapes = jax.eval_shape(lambda: model.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        dummy_inputs(cfg, 2), train=True))
    return randomize(dict(shapes), seed)


def port_model(variables, ssl_type, extra=(), dtype="float32"):
    model = build_model(make_cfg(get_cfg, ssl_type, extra, dtype), device="cpu")
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    return model


def to_float64(model):
    """``model`` in float64, its compute dtypes too."""
    model.double()
    for m in model.modules():
        if isinstance(getattr(m, "dtype", None), torch.dtype):
            m.dtype = torch.float64
    return model


@contextlib.contextmanager
def jax_float64():
    """JAX in float64: x64 on, the package's ``jnp.float32`` read as float64
    while a model or step is built and traced (the JAX package names
    float32 wherever it takes fp32), and ``jax.random.randint`` drawing
    int32 as it does without x64 (so the draws are the fp32 step's)."""
    float32, randint = jnp.float32, jax.random.randint
    with jax.enable_x64(True):
        jnp.float32 = jnp.float64
        jax.random.randint = lambda *a, dtype=jnp.int32, **k: randint(*a, dtype=dtype, **k)
        try:
            yield
        finally:
            jnp.float32 = float32
            jax.random.randint = randint


def clips(seed, n=B, t=4, s=64):
    return np.random.RandomState(seed).normal(0.0, 1.0, (n, t, s, s, 3)).astype(np.float32)


def rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def capturing(tx):
    """``tx`` whose state also holds the last gradients it was given, so a
    jitted JAX step hands them out."""
    def init(params):
        return tx.init(params), jax.tree.map(jnp.zeros_like, params)

    def update(grads, state, params=None):
        updates, inner = tx.update(grads, state[0], params)
        return updates, (inner, grads)

    return optax.GradientTransformation(init, update)


def jax_ssl_state(ssl_type, extra=(), steps_per_epoch=1, seed=0):
    """The JAX SSL train state from seeded random variables: ``(cfg, model,
    tx, state)``, the momentum encoder a copy of the backbone, the queue and
    banks ``init_ssl_state``'s."""
    cfg = make_cfg(jax_get_cfg, ssl_type, extra)
    model = jax_build_model(cfg)
    v = jax_variables(ssl_type, extra, seed)
    tx = capturing(joptim.construct_optimizer(v["params"], cfg, steps_per_epoch)[0])
    ssl = jcon.init_ssl_state(cfg, v["params"], jax.random.PRNGKey(7), v["batch_stats"])
    state = SSLTrainState(step=jnp.zeros((), jnp.int32), params=v["params"],
                          batch_stats=v["batch_stats"], opt_state=tx.init(v["params"]),
                          ssl_state=ssl)
    return cfg, model, tx, state


def jax_trace(opt_state):
    (trace,) = [s.trace for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda s: isinstance(s, optax.TraceState))
        if isinstance(s, optax.TraceState)]
    return trace


def port_from_jax(state, ssl_type, extra=(), steps_per_epoch=1):
    """The port's model, optimizer and SSL state equal to the JAX ``state``."""
    cfg = make_cfg(get_cfg, ssl_type, extra)
    model = port_model({"params": state.params, "batch_stats": state.batch_stats}, ssl_type, extra)
    opt = toptim.construct_optimizer(model, cfg)
    load_port_state(model, opt, None, state)
    ssl = tcon.init_ssl_state(cfg, model, torch.Generator().manual_seed(0))
    ssl.load_state_dict(ssl_state_from_jax(jax.tree.map(np.asarray, state.ssl_state)))
    return cfg, model, opt, ssl


def load_port_state(model, opt, ssl, state):
    """Set the port's model, optimizer (and SSL state) to JAX's ``state``."""
    model.load_state_dict(state_dict_from_jax(jax.tree.map(np.asarray, {
        "params": state.params, "batch_stats": state.batch_stats})), strict=True)
    opt.load_state_dict({"count": 0, "trace": state_dict_from_jax(
        {"params": jax.tree.map(np.asarray, jax_trace(state.opt_state[0]))})})
    if ssl is not None:
        ssl.load_state_dict(ssl_state_from_jax(jax.tree.map(np.asarray, state.ssl_state)))


# --- MLPHead and sub_batchnorm -------------------------------------------------

MLP_CASES = {"bn_3": (3, True), "plain_2": (2, False), "bn_2": (2, True)}


@pytest.mark.parametrize("case", sorted(MLP_CASES))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mlp_head_matches_jax(case, dtype):
    layers, bn = MLP_CASES[case]
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    head = JaxMLPHead(dim_out=24, mlp_dim=48, num_layers=layers, bn_on=bn, dtype=jdt)
    x = np.random.RandomState(3).normal(size=(6, 1, 1, 1, 40)).astype(np.float32)
    shapes = jax.eval_shape(lambda: head.init(jax.random.PRNGKey(0), jnp.asarray(x), train=True))
    v = randomize(dict(shapes), 1)
    port = MLPHead(40, 24, 48, layers, bn_on=bn, dtype=tdt)
    port.load_state_dict(state_dict_from_jax(v), strict=True)
    names = [n for n, _ in port.named_parameters()]
    assert names[0] == "projection.0.weight" and names[-1] == f"projection.{len(port.projection) - 1}.bias"
    tol = 1e-5 if dtype == "float32" else 2e-2
    for train in (False, True):
        out = head.apply(v, jnp.asarray(x, jdt), train=train, mutable=["batch_stats"] if train else False)
        want, stats = (out if train else (out, None))
        port.train(train)
        got = port(torch.from_numpy(x).to(tdt))
        assert got.dtype == tdt
        scale = np.abs(np.asarray(want, np.float32)).max()
        np.testing.assert_allclose(got.float().detach().numpy(), np.asarray(want, np.float32),
                                   atol=tol * scale, err_msg=f"train {train}")
        if train and bn:
            sd = state_dict_from_jax({"params": v["params"],
                                      "batch_stats": jax.tree.map(np.asarray, stats["batch_stats"])})
            for k, t in port.state_dict().items():
                if "running" in k:
                    np.testing.assert_allclose(t.numpy(), sd[k].numpy(), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("splits,batch", [(2, 4), (4, 8), (3, 4)])
def test_sub_batchnorm_matches_jax(splits, batch):
    """Per-split statistics in training (a batch that does not split evenly
    falls back to the whole batch's), the merged running statistics, and
    eval on the running ones."""
    x = np.random.RandomState(splits).normal(1.0, 2.0, (batch, 2, 3, 3, 5)).astype(np.float32)
    jbn = JaxBN(features=5, num_splits=splits)
    v = randomize(dict(jax.eval_shape(lambda: jbn.init(jax.random.PRNGKey(0), jnp.asarray(x)))), 2)
    bn = BatchNorm3D(5, num_splits=splits)
    bn.load_state_dict(state_dict_from_jax(v), strict=True)
    want, mut = jbn.apply(v, jnp.asarray(x), train=True, mutable=["batch_stats"])
    got = bn.train()(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    stats = state_dict_from_jax({"params": v["params"],
                                 "batch_stats": jax.tree.map(np.asarray, mut["batch_stats"])})
    for k in ("running_mean", "running_var"):
        np.testing.assert_allclose(bn.state_dict()[k].numpy(), stats[k].numpy(), rtol=1e-6)
    want = jbn.apply({"params": v["params"], "batch_stats": mut["batch_stats"]}, jnp.asarray(x))
    np.testing.assert_allclose(bn.eval()(torch.from_numpy(x)).detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)


def test_sub_batchnorm_splits_are_independent():
    """Under sub_batchnorm a training output depends on its own split only;
    the RGB stem and the stages of inner width under 32 normalize the whole
    batch, as the JAX package's T-folded layers do."""
    cfg = make_cfg(get_cfg, "moco", ["BN.NORM_TYPE", "sub_batchnorm", "BN.NUM_SPLITS", "2"])
    backbone = build_model(cfg, device="cpu").backbone
    assert backbone.s1.pathway0_stem.bn.num_splits == 1
    assert backbone.s2.pathway0_res0.branch2.a_bn.num_splits == 1  # inner width 8
    bn = backbone.s5.pathway0_res0.branch2.a_bn  # inner width 64
    assert bn.num_splits == 2
    x = torch.randn(4, 2, 3, 3, 64, generator=torch.Generator().manual_seed(0))
    y = x.clone()
    y[2:] += 5.0
    bn.train()
    torch.testing.assert_close(bn(x)[:2], bn(y)[:2])


# --- the model ----------------------------------------------------------------

def test_init_distributions():
    """The MLPs' Linears Xavier-uniform with zero biases, the prototypes
    lecun-normal, the classification-head init untouched elsewhere."""
    model = build_model(make_cfg(get_cfg, "swav"), device="cpu")
    for name, p in model.named_parameters():
        if ".projection." in name and name.endswith("weight") and p.dim() == 2:
            bound = np.sqrt(6.0 / sum(p.shape))
            assert p.abs().max() <= bound and p.abs().max() > 0.8 * bound, name
        elif ".projection." in name and name.endswith("bias"):
            assert not p.any(), name
    w = model.swav_prototypes.weight
    assert abs(w.std().item() - np.sqrt(1.0 / w.shape[1])) < 0.02
    assert model.swav_prototypes.bias is None


# --- state functions --------------------------------------------------------

def test_sinkhorn_matches_jax():
    s = np.random.RandomState(0).normal(0, 0.3, (12, 20)).astype(np.float32)
    want = np.asarray(jcon.sinkhorn(jnp.asarray(s)))
    got = tcon.sinkhorn(torch.from_numpy(s)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(got.sum(1), 1.0, rtol=1e-2)


def test_momentum_update_matches_jax():
    rs = np.random.RandomState(1)
    h = [rs.normal(size=(3, 4)).astype(np.float32), rs.normal(size=(5,)).astype(np.float32)]
    p = [rs.normal(size=(3, 4)).astype(np.float32), rs.normal(size=(5,)).astype(np.float32)]
    mmt = np.float32(0.994)
    want = jcon.momentum_update([jnp.asarray(a) for a in h], [jnp.asarray(a) for a in p],
                                jnp.asarray(mmt))
    got = [torch.from_numpy(a.copy()) for a in h]
    tcon.momentum_update(got, [torch.from_numpy(a) for a in p], mmt)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("ptr,num", [(0, 4), (60, 8), (62, 2)])
def test_dequeue_and_enqueue_wraps(ptr, num):
    rs = np.random.RandomState(ptr)
    queue = rs.normal(size=(64, 6)).astype(np.float32)
    keys = rs.normal(size=(num, 6)).astype(np.float32)
    wq, wp = jcon.dequeue_and_enqueue(jnp.asarray(queue), jnp.asarray(ptr, jnp.int32),
                                      jnp.asarray(keys))
    q = torch.from_numpy(queue.copy())
    got_ptr = tcon.dequeue_and_enqueue(q, ptr, torch.from_numpy(keys))
    assert got_ptr == int(wp)
    np.testing.assert_array_equal(q.numpy(), np.asarray(wq))


MEMORY_CASES = {"1d": (2, None, False), "2d": (3, [0.0, 1.7, 3.0, 2.2], False),
                "2d_interp": (3, [0.0, 1.7, 3.0, 2.2], True)}


@pytest.mark.parametrize("case", sorted(MEMORY_CASES))
def test_memory_update_matches_jax(case):
    ndim, time, interp = MEMORY_CASES[case]
    rs = np.random.RandomState(5)
    shape = (20, 6) if ndim == 2 else (20, 4, 6)
    memory = rs.normal(size=shape).astype(np.float32)
    idx = np.array([3, 7, 0, 19])
    feats = rs.normal(size=(4, 6)).astype(np.float32)
    t = None if time is None else np.asarray(time, np.float32)
    want = jcon.memory_update(jnp.asarray(memory), jnp.asarray(idx), jnp.asarray(feats),
                              jnp.float32(0.3), time=None if t is None else jnp.asarray(t),
                              interp=interp)
    m = torch.from_numpy(memory.copy())
    tcon.memory_update(m, torch.from_numpy(idx), torch.from_numpy(feats), np.float32(0.3),
                       time=None if t is None else torch.from_numpy(t), interp=interp)
    np.testing.assert_allclose(m.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("case", ["1d", "2d", "2d_interp"])
def test_nce_logits_match_jax(case):
    """The sampled logits on the JAX package's own draws."""
    rs = np.random.RandomState(9)
    q = rs.normal(size=(4, 16)).astype(np.float32)
    duration = 1 if case == "1d" else 4
    memory = rs.normal(size=(30, 16) if case == "1d" else (30, 4, 16)).astype(np.float32)
    interp = case == "2d_interp"
    clip_ind, time_ind = jcon.nce_sample_indices(jax.random.PRNGKey(3), jnp.arange(4), 30, 8,
                                                 duration=duration, interp=interp)
    want = jcon.nce_logits(jnp.asarray(q), jnp.asarray(memory), clip_ind, time_ind, 0.07,
                           interp=interp)
    got = tcon.nce_logits(torch.from_numpy(q), torch.from_numpy(memory),
                          torch.from_numpy(np.asarray(clip_ind)).long(),
                          torch.from_numpy(np.asarray(time_ind)), 0.07, interp=interp)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)
    g = torch.Generator().manual_seed(0)
    ci, ti = tcon.nce_sample_indices(g, torch.arange(4), 30, 8, duration=duration, interp=interp)
    assert ci.shape == (4, 9) and (ci[:, 0] == torch.arange(4)).all()
    assert ci.max() < 30 and (ti.max() < max(duration - 1, 1))


def test_init_ssl_state_shapes():
    for t, extra, parts in (
            ("moco", [], {"queue_x": (64, 32), "memory": (50, 32)}),
            ("swav", ["CONTRASTIVE.SWAV_QEUE_LEN", "8"], {"queue_swav": (2, 8, 32)}),
            ("mem", ["CONTRASTIVE.MEM_TYPE", "2d", "CONTRASTIVE.DURATION", "3"],
             {"memory": (50, 3, 32), "knn_memory": (50, 32)})):
        cfg = make_cfg(get_cfg, t, extra)
        model = build_model(cfg, device="cpu")
        ssl = tcon.init_ssl_state(cfg, model, torch.Generator().manual_seed(0))
        for name, shape in parts.items():
            assert tuple(getattr(ssl, name).shape) == shape, (t, name)
        bound = 1.0 / np.sqrt(32 / 3.0)
        if ssl.queue_x is not None:
            assert ssl.queue_x.abs().max() <= bound
            assert all(torch.equal(a, b) for a, b in zip(ssl.hist.state_dict().values(),
                                                          model.backbone.state_dict().values()))
            assert not any(p.requires_grad for p in ssl.hist.parameters())


# --- recipes and the bridge -----------------------------------------------------

@pytest.mark.parametrize("ssl_type", SSL_TYPES)
def test_bridge_round_trip(ssl_type):
    """The port's ``state_dict`` loads into the JAX package through
    ``load_torch_checkpoint_dict`` and gives back every leaf (the predictors
    under the JAX package's ``predictor_{i}``), and the SSL state bridge
    reproduces JAX's momentum encoder, queue and banks."""
    v = jax_variables(ssl_type)
    model = port_model(v, ssl_type)
    sd = {re.sub(r"^predictors\.(\d+)\.", r"predictor_\1.", k): t.numpy()
          for k, t in model.state_dict().items()}
    loaded, missing, unexpected = load_torch_checkpoint_dict(sd, v)
    assert not missing and not unexpected, (missing[:3], unexpected[:3])
    for col in ("params", "batch_stats"):
        want = traverse_util.flatten_dict(v[col])
        got = traverse_util.flatten_dict(loaded[col])
        assert want.keys() == got.keys()
        for path in want:
            np.testing.assert_array_equal(np.asarray(got[path]), want[path], err_msg=str(path))
    _, _, _, state = jax_ssl_state(ssl_type)
    cfg, pmodel, _, ssl = port_from_jax(state, ssl_type)
    js = jax.tree.map(np.asarray, state.ssl_state)
    for name in ("queue_x", "queue_swav", "memory", "knn_memory"):
        if name in js:
            np.testing.assert_array_equal(getattr(ssl, name).numpy(), js[name])
    if ssl.hist is not None:
        want = state_dict_from_jax({"params": js["hist_params"],
                                    "batch_stats": js["hist_batch_stats"]["backbone"]})
        for k, t in ssl.hist.state_dict().items():
            np.testing.assert_array_equal(t.numpy(), want[k].numpy(), err_msg=k)
    assert (ssl.ptr, ssl.iter) == (int(js.get("ptr", 0)), int(js["iter"]))
