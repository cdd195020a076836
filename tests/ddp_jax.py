"""The JAX side of the multi-process tests: a config's seeded random
variables and ``make_train_step`` on a 2-device ``data`` mesh (the CPU's
virtual devices, ``tests/conftest.py``). Imported inside the tests only,
so the spawned ranks start without JAX."""

import jax
import numpy as np
import optax

from slowfast_tpu.config import get_cfg as jax_get_cfg
from slowfast_tpu.engine.steps import create_train_state, make_train_step
from slowfast_tpu.models import build_model as jax_build_model
from slowfast_tpu.models.build import init_model
from slowfast_tpu.parallel.mesh import create_mesh, shard_batch
from slowfast_tpu.solver.optimizer import construct_optimizer
from slowfast_tpu_torch.utils.checkpoint import state_dict_from_jax
from test_torch_slowfast import randomize
from test_torch_train import jax_draws

from ddp_harness import WORLD, params_and_buffers, rel_l2


def jax_cfg(opts, yaml=None):
    cfg = jax_get_cfg()
    if yaml:
        cfg.merge_from_file(yaml)
    cfg.merge_from_list(list(opts))
    return cfg


def jax_variables(cfg, seed):
    """Seeded random variables of ``cfg``'s model (every BN statistic
    too)."""
    model = jax_build_model(cfg)
    shapes = jax.eval_shape(lambda: init_model(model, cfg, rng=jax.random.PRNGKey(0),
                                               train=True))
    return randomize(dict(shapes), seed)


def port_state(params, batch_stats):
    return state_dict_from_jax({"params": jax.tree.map(np.asarray, params),
                                "batch_stats": jax.tree.map(np.asarray, batch_stats)})


def trace_of(opt_state):
    """The momentum of an SGD chain's ``optax.trace``, as port names."""
    (trace,) = [s.trace for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda s: isinstance(s, optax.TraceState))
        if isinstance(s, optax.TraceState)]
    return state_dict_from_jax({"params": jax.tree.map(np.asarray, trace)})


def mesh_run(cfg, variables, batches, devices=WORLD, seed=0):
    """``make_train_step`` on a ``devices``-device mesh over the global
    ``batches``, its key ``PRNGKey(seed)``. Returns each step's loss, the
    ``(model state, SGD optimizer state)`` each step starts from and the
    model state after each, as the port's, and the mixup draws each step
    takes."""
    model = jax_build_model(cfg)
    tx, _ = construct_optimizer(variables["params"], cfg, 1)
    state = create_train_state(cfg, model, tx, variables=variables)
    mesh = create_mesh(cfg, devices=jax.devices()[:devices])
    step = make_train_step(cfg, model, tx, mesh=mesh, donate=False, epoch_in_batch=True)
    out = {"loss": [], "starts": [], "states": [], "draws": []}
    rng = jax.random.PRNGKey(seed)
    compiled = {}
    for i, b in enumerate(batches):
        out["starts"].append((port_state(state.params, state.batch_stats),
                              {"count": i, "trace": trace_of(state.opt_state)}))
        mix_rng, _ = jax.random.split(jax.random.fold_in(rng, i))
        x = b["inputs"][-1]
        mix = cfg.MIXUP
        out["draws"].append(jax_draws(mix_rng, x.shape[2], x.shape[3], mix.ALPHA,
                                      mix.CUTMIX_ALPHA, mix.PROB, mix.SWITCH_PROB))
        batch = shard_batch({k: (np.float32(v) if k == "epoch_exact" else v)
                             for k, v in b.items()}, mesh)
        shapes = str(jax.tree.map(np.shape, batch))
        if shapes not in compiled:  # XLA's CPU optimization level 0 compiles faster
            compiled[shapes] = step.lower(state, batch, rng).compile(
                compiler_options={"xla_backend_optimization_level": "0"})
        state, m = compiled[shapes](state, batch, rng)
        out["loss"].append(float(m["loss"]))
        out["states"].append(port_state(state.params, state.batch_stats))
    return out


def check_jax_steps(ranks, jax_run, loss_tol=1e-5, state_tol=1e-4, update_tol=5e-2):
    """The ranks' steps, each from JAX's state before it, against JAX's
    steps on the mesh: the loss (the ranks' mean) within ``loss_tol``
    (relative), the parameters and BN statistics after each step within
    ``state_tol`` (relative L2), and the parameters' change within
    ``update_tol`` (relative L2: a ReLU or max-pool flip moves a change by
    up to 5e-2, ROADMAP Queue 3 #24; a gradient summed over the ranks, not
    averaged, by 1). Returns how far the parameters moved over the run
    (relative L2)."""
    losses = np.mean([r["loss"] for r in ranks], axis=0)
    np.testing.assert_allclose(losses, jax_run["loss"], rtol=loss_tol)
    params, buffers = params_and_buffers(jax_run["states"][-1])
    for got, want, (start, _) in zip(ranks[0]["states"], jax_run["states"], jax_run["starts"]):
        assert rel_l2(got, want, params) <= state_tol
        assert rel_l2(got, want, buffers) <= state_tol
        change = {n: got[n] - start[n] for n in params}
        assert rel_l2(change, {n: want[n] - start[n] for n in params}) <= update_tol
    for r in ranks[1:]:
        for got, want in zip(r["states"], ranks[0]["states"]):
            assert rel_l2(got, want, params) == 0.0  # the ranks step together
    return rel_l2(jax_run["states"][-1], jax_run["starts"][0][0], params)
