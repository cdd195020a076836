"""The port's SGD and Adam against the optax chains of the JAX package's
``construct_optimizer``, on the CPU.

The parameters are those of the narrow SLOWFAST_4x16_R50 of
tests/test_torch_slowfast.py, every one set to a seeded random value. Ten
updates on seeded gradients at a varying LR, with a weight decay (0.05)
large enough to show where it enters the chain; the parameters must match
within rtol 1e-6, with an atol of 2e-7 (two fp32 ulps at |p| = 1) for the
elements that cancel to near zero, where XLA's fused multiply-adds round
once and the port's ``_foreach`` ops twice. Cases: Nesterov on (the
recipe's default) and off, dampening 0.1, a BN weight decay, ``ZERO_WD_1D_PARAM``, ``LAYER_DECAY``,
the global-norm clip, and Adam with coupled weight decay. A ``state_dict``
saved after five updates (through ``torch.save``, as the trainer's
``.pyth`` checkpoints hold it) must resume to the same parameters.
"""

import io

import jax
import numpy as np
import optax
import pytest
import torch

from slowfast_tpu.config import get_cfg as jax_get_cfg
from slowfast_tpu.models import build_model as jax_build_model
from slowfast_tpu.models.build import init_model
from slowfast_tpu.solver import optimizer as joptim
from slowfast_tpu_torch.config import get_cfg
from slowfast_tpu_torch.models.build import build_model
from slowfast_tpu_torch.solver import optimizer as toptim
from slowfast_tpu_torch.utils.checkpoint import state_dict_from_jax
from test_torch_slowfast import narrow_cfg, randomize
from test_torch_train import one_torch_thread  # noqa: F401  (autouse fixture)

BASE = ["SOLVER.WEIGHT_DECAY", "0.05"]
CASES = {
    "sgd_nesterov": [],
    "sgd_momentum": ["SOLVER.NESTEROV", "False"],
    "sgd_dampening": ["SOLVER.NESTEROV", "False", "SOLVER.DAMPENING", "0.1"],
    "sgd_bn_weight_decay": ["BN.WEIGHT_DECAY", "0.01"],
    "sgd_zero_wd_1d": ["SOLVER.ZERO_WD_1D_PARAM", "True"],
    "sgd_layer_decay": ["SOLVER.LAYER_DECAY", "0.75"],
    "sgd_clip": ["SOLVER.CLIP_GRAD_L2NORM", "1.0"],
    "adam": ["SOLVER.OPTIMIZING_METHOD", "adam", "BN.WEIGHT_DECAY", "0.01"],
}
LRS = [0.1, 0.05, 0.2, 0.1, 0.01, 0.3, 0.1, 0.02, 0.15, 0.1]


@pytest.fixture(scope="module")
def params():
    cfg = narrow_cfg(jax_get_cfg)
    model = jax_build_model(cfg)
    shapes = jax.eval_shape(
        lambda: init_model(model, cfg, rng=jax.random.PRNGKey(0), train=False))
    return randomize(dict(shapes), 3)["params"]


def port_params(params):
    return state_dict_from_jax({"params": params})


def gradients(params, step):
    rng = np.random.RandomState(100 + step)
    return jax.tree.map(lambda p: rng.normal(0.0, 0.3, p.shape).astype(np.float32), params)


def port_model(params, extra):
    model = build_model(narrow_cfg(get_cfg, extra=BASE + extra), device="cpu")
    model.load_state_dict(port_params(params), strict=False)
    return model


def port_step(model, opt, grads, lr):
    named = dict(model.named_parameters())
    for name, g in port_params(grads).items():
        named[name].grad = g.clone()
    return opt.step(lr)


@pytest.mark.parametrize("case", sorted(CASES))
def test_update_matches_optax_chain(params, case):
    extra = CASES[case]
    jcfg = narrow_cfg(jax_get_cfg, extra=BASE + extra)
    tx, _ = joptim.construct_optimizer(params, jcfg, 10)
    opt_state = tx.init(params)
    update = jax.jit(tx.update)
    model = port_model(params, extra)
    opt = toptim.construct_optimizer(model, narrow_cfg(get_cfg, extra=BASE + extra))
    want = params
    for i, lr in enumerate(LRS):
        grads = gradients(params, i)
        updates, opt_state = update(grads, opt_state, want)
        want = jax.tree.map(lambda p, u: p - lr * u, want, updates)
        norm = port_step(model, opt, grads, lr)
        np.testing.assert_allclose(float(norm), float(optax.global_norm(grads)), rtol=1e-6)
    want = port_params(want)
    start = port_params(params)
    for name, p in model.named_parameters():
        got = p.detach().numpy()
        assert not np.array_equal(got, start[name].numpy()), name
        np.testing.assert_allclose(got, want[name].numpy(), rtol=1e-6, atol=2e-7, err_msg=name)
    assert opt.count == len(LRS)


@pytest.mark.parametrize("case", ["sgd_nesterov", "sgd_dampening", "adam"])
def test_state_dict_resumes_to_the_same_parameters(params, case):
    extra = CASES[case]
    cfg = narrow_cfg(get_cfg, extra=BASE + extra)
    model = port_model(params, extra)
    opt = toptim.construct_optimizer(model, cfg)
    for i, lr in enumerate(LRS[:5]):
        port_step(model, opt, gradients(params, i), lr)
    buf = io.BytesIO()
    torch.save({"model_state": model.state_dict(), "optimizer_state": opt.state_dict()}, buf)
    buf.seek(0)
    ckpt = torch.load(buf, weights_only=True)
    resumed = build_model(cfg, device="cpu")
    resumed.load_state_dict(ckpt["model_state"], strict=True)
    resumed_opt = toptim.construct_optimizer(resumed, cfg)
    resumed_opt.load_state_dict(ckpt["optimizer_state"])
    for i, lr in enumerate(LRS[5:], start=5):
        grads = gradients(params, i)
        port_step(model, opt, grads, lr)
        port_step(resumed, resumed_opt, grads, lr)
    for (name, p), q in zip(model.named_parameters(), resumed.parameters()):
        assert torch.equal(p, q), name


def test_nesterov_with_dampening_is_refused(params):
    extra = ["SOLVER.DAMPENING", "0.1"]
    with pytest.raises(ValueError, match="DAMPENING"):
        toptim.construct_optimizer(port_model(params, extra),
                                   narrow_cfg(get_cfg, extra=BASE + extra))

