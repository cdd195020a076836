"""The port's SSL step on the CPU, beside tests/test_torch_ssl_train.py
(whose helpers and JAX steps it shares): swav's 3-step trajectory (with a
queue of 8) against JAX ``make_ssl_train_step``, and LARS trajectories
against JAX's optax chain.
"""

import jax
import numpy as np
import pytest
import torch

from slowfast_tpu.config import get_cfg as jax_get_cfg
from slowfast_tpu.solver import optimizer as joptim
from slowfast_tpu_torch.config import get_cfg
from slowfast_tpu_torch.solver import optimizer as toptim
from slowfast_tpu_torch.utils.checkpoint import state_dict_from_jax
from test_torch_contrastive import jax_variables, make_cfg, port_model
from test_torch_ssl_train import STEPS, TYPES, check_trajectory
from test_torch_train import one_torch_thread  # noqa: F401  (autouse fixture)


@pytest.mark.parametrize("ssl_type", ["swav"])
def test_three_step_trajectory_matches_jax(ssl_type, monkeypatch):
    ssl = check_trajectory(ssl_type, TYPES[ssl_type], monkeypatch, STEPS)
    assert ssl.swav_filled == 8


# --- LARS --------------------------------------------------------------------

LARS_CASES = {"sgd": [], "bn_decay": ["BN.WEIGHT_DECAY", "0.01"],
              "clip": ["SOLVER.CLIP_GRAD_L2NORM", "0.5"]}
LRS = [0.6, 0.3, 1.2, 0.6, 0.1]


@pytest.mark.parametrize("case", sorted(LARS_CASES))
def test_lars_trajectory_matches_optax_chain(case):
    """Five LARS-SGD updates on seeded gradients (one parameter's gradient
    zero, the norm-0 branch) against JAX's chain: the parameters within
    rtol 1e-6 (2e-7 absolute at cancellation)."""
    extra = ["SOLVER.LARS_ON", "True", "SOLVER.WEIGHT_DECAY", "1e-2"] + LARS_CASES[case]
    v = jax_variables("swav")
    params = v["params"]
    jcfg = make_cfg(jax_get_cfg, "swav", extra)
    tx, _ = joptim.construct_optimizer(params, jcfg, 10)
    opt_state, want = tx.init(params), params
    model = port_model(v, "swav", extra)
    opt = toptim.construct_optimizer(model, make_cfg(get_cfg, "swav", extra))
    assert opt.lars and all(model.get_parameter(opt.names[i]).dim() > 1 for i, _ in opt.lars)
    named = dict(model.named_parameters())
    for i, lr in enumerate(LRS):
        rng = np.random.RandomState(50 + i)
        grads = jax.tree.map(lambda p: rng.normal(0, 0.3, p.shape).astype(np.float32), params)
        grads["swav_prototypes"]["kernel"] = np.zeros_like(grads["swav_prototypes"]["kernel"])
        updates, opt_state = jax.jit(tx.update)(grads, opt_state, want)
        want = jax.tree.map(lambda p, u: p - lr * u, want, updates)
        for name, g in state_dict_from_jax({"params": grads}).items():
            named[name].grad = g.clone()
        opt.step(lr)
    want = state_dict_from_jax({"params": want})
    start = state_dict_from_jax({"params": params})
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), rtol=1e-6, atol=2e-7,
                                   err_msg=name)
        if name == "swav_prototypes.weight":
            assert torch.equal(p.detach(), start[name]), "a zero gradient must stay zero"
