"""20 train steps of the port against JAX ``make_train_step``, on the CPU,
in fp32, on the narrow MViTv2 of tests/test_torch_train.py (whose helpers
this file shares) with every parameter overwritten by seeded random values:
mixup, drop path and dropout off, ``BASE_LR`` 1e-3, one warmup epoch of 5
steps, then the cosine to epoch 4, with the global-norm clip engaged. The
loss within rtol 1e-4 at every step, the parameters within atol 1e-4 at
the end.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slowfast_tpu.config import get_cfg as jax_get_cfg
from slowfast_tpu.engine.steps import TrainState, make_train_step as jax_make_train_step
from slowfast_tpu.models import build_model as jax_build_model
from slowfast_tpu.solver import optimizer as joptim
from slowfast_tpu_torch.config import get_cfg
from slowfast_tpu_torch.engine.steps import make_train_step
from slowfast_tpu_torch.solver import optimizer as toptim
from slowfast_tpu_torch.solver.lr_policy import make_epoch_lr_fn
from test_torch_train import (  # noqa: F401  (one_torch_thread, variables: fixtures)
    STEPS_PER_EPOCH,
    TRAJECTORY,
    as_port,
    clips,
    labels,
    narrow_cfg,
    one_torch_thread,
    port_model,
    structurally_zero,
    variables,
)


def test_twenty_step_trajectory_matches_jax(variables):
    """fp32, BASE_LR 1e-3, one warmup epoch of 5 steps, cosine to epoch 4."""
    jcfg = narrow_cfg(jax_get_cfg, "float32", TRAJECTORY)
    jmodel = jax_build_model(jcfg)
    tx, _ = joptim.construct_optimizer(variables["params"], jcfg, STEPS_PER_EPOCH)
    state = TrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                       batch_stats={}, opt_state=tx.init(variables["params"]))
    jstep = jax_make_train_step(jcfg, jmodel, tx, donate=False, steps_per_epoch=STEPS_PER_EPOCH)

    cfg = narrow_cfg(get_cfg, "float32", TRAJECTORY)
    model = port_model(variables, "float32", TRAJECTORY)
    step = make_train_step(cfg, model, toptim.construct_optimizer(model, cfg))
    clipped = 0
    for i in range(STEPS_PER_EPOCH * 4):
        x, y = clips(i), labels(i)
        state, jm = jstep(state, {"inputs": [jnp.asarray(x)], "labels": jnp.asarray(y)},
                          jax.random.PRNGKey(0))
        m = step({"inputs": [torch.from_numpy(x)], "labels": torch.from_numpy(y),
                  "epoch_exact": i / STEPS_PER_EPOCH})
        np.testing.assert_allclose(m["loss"].item(), float(jm["loss"]), rtol=1e-4, err_msg=i)
        np.testing.assert_allclose(m["grad_norm"].item(), float(jm["grad_norm"]), rtol=1e-3)
        np.testing.assert_allclose(m["lr"], float(jm["lr"]), rtol=2e-6)
        assert m["top1_err"].item() == pytest.approx(float(jm["top1_err"]))
        clipped += float(jm["grad_norm"]) > 1.0
    assert clipped >= 5  # CLIP_GRAD_L2NORM 1.0 engaged on many steps
    want = as_port(state.params)
    start = as_port(variables["params"])
    total_lr = sum(make_epoch_lr_fn(cfg)(i / STEPS_PER_EPOCH) for i in range(20))
    for name, p in model.named_parameters():
        got = p.detach().numpy()
        if structurally_zero(name):
            # Adam scales the rounding noise to steps of up to about lr.
            assert np.abs(got - start[name].numpy()).max() <= 3 * total_lr, name
            continue
        np.testing.assert_allclose(got, want[name].numpy(), atol=1e-4, err_msg=name)


