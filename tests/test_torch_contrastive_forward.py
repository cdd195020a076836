"""The port's ``ContrastiveModel`` forward of every SSL type against the
JAX package's, on the CPU, on the narrow models of
tests/test_torch_contrastive.py (whose helpers it shares): eval in fp32
within 1e-5 of JAX's; train within 1e-5 of JAX's float64 forward and 2e-5
of its fp32 one, with the BN statistics it leaves; bf16 within 2e-2;
SwAV's prototype scores.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slowfast_tpu.config import get_cfg as jax_get_cfg
from slowfast_tpu.models import build_model as jax_build_model
from slowfast_tpu.models import contrastive as jcon
from slowfast_tpu_torch.utils.checkpoint import state_dict_from_jax
from test_torch_contrastive import (B, SSL_TYPES, clips, jax_float64, jax_variables, make_cfg,
                                    port_model, to_float64)
from test_torch_mvit_family import jit_run
from test_torch_train import one_torch_thread  # noqa: F401  (autouse fixture)


def jax_forward(ssl_type, variables, x, train, use_predictor, dtype="float32"):
    cfg = make_cfg(jax_get_cfg, ssl_type, dtype=dtype)
    model = jax_build_model(cfg)

    def fn(v, x):
        if train:
            return model.apply(v, [x], train=True, use_predictor=use_predictor,
                               mutable=["batch_stats"])
        return model.apply(v, [x], train=False, use_predictor=use_predictor), None

    out, mut = jit_run(fn, variables, jnp.asarray(x))
    return np.asarray(out, np.float32), mut


def jax_forward64(ssl_type, variables, x, use_predictor):
    """JAX's train-mode forward in float64 (``jax_float64``)."""
    up = lambda a: np.asarray(a, np.float64)  # noqa: E731
    with jax_float64():
        model = jax_build_model(make_cfg(jax_get_cfg, ssl_type))
        out = jax.jit(lambda v, x: model.apply(v, [x], train=True, use_predictor=use_predictor,
                                               mutable=["batch_stats"])[0])(
            jax.tree.map(up, variables), up(x))
        return np.asarray(out)


@pytest.mark.parametrize("ssl_type", SSL_TYPES)
def test_forward_matches_jax(ssl_type):
    """The l2-normalized embedding (BYOL: through the predictor) in eval and
    in train mode, and the BN statistics the train forward leaves; SwAV's
    prototype scores. Eval: fp32 within 1e-5 of JAX's. Train: every BN
    normalizes the batch, and JAX's fp32 embedding sits 1.2e-5 from its
    float64 one (its CPU reductions round more), so the port's fp32 is held
    within 1e-5 of JAX's float64 forward and 2e-5 of its fp32 one, the
    port's float64 forward within 1e-12 of JAX's."""
    v = jax_variables(ssl_type)
    x = clips(11)
    use_pred = ssl_type == "byol"
    model = port_model(v, ssl_type)
    for train in (False, True):
        want, mut = jax_forward(ssl_type, v, x, train, use_pred)
        model.train(train)
        got = model([torch.from_numpy(x)], use_predictor=use_pred).detach().numpy()
        np.testing.assert_allclose(got, want, atol=2e-5 if train else 1e-5,
                                   err_msg=f"train {train}")
        if train:
            exact = jax_forward64(ssl_type, v, x, use_pred)
            m64 = to_float64(port_model(v, ssl_type)).train()
            got64 = m64([torch.from_numpy(x).double()], use_predictor=use_pred).detach().numpy()
            np.testing.assert_allclose(got, exact, atol=1e-5)
            np.testing.assert_allclose(got64, exact, atol=1e-12)
            sd = state_dict_from_jax({"params": v["params"],
                                      "batch_stats": jax.tree.map(np.asarray, mut["batch_stats"])})
            for k, t in model.state_dict().items():
                if "running" in k:
                    np.testing.assert_allclose(t.numpy(), sd[k].numpy(), atol=1e-5, err_msg=k)
    if ssl_type == "swav":
        cfg = make_cfg(jax_get_cfg, ssl_type)
        q = np.random.RandomState(2).normal(size=(B, 32)).astype(np.float32)
        want = jax_build_model(cfg).apply({"params": v["params"]}, jnp.asarray(q),
                                          method=jcon.ContrastiveModel.prototypes)
        got = model.prototypes(torch.from_numpy(q)).detach().numpy()
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("ssl_type", ["moco", "byol"])
def test_bf16_forward_matches_jax(ssl_type):
    v = jax_variables(ssl_type)
    x = clips(12)
    model = port_model(v, ssl_type, dtype="bfloat16").eval()
    want, _ = jax_forward(ssl_type, v, x, False, ssl_type == "byol", dtype="bfloat16")
    got = model([torch.from_numpy(x)], use_predictor=ssl_type == "byol").float().detach().numpy()
    np.testing.assert_allclose(got, want, atol=2e-2)
