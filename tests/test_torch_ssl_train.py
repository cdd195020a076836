"""The port's SSL train step against the JAX package's ``make_ssl_train_step``,
on the CPU, on the narrow models of tests/test_torch_contrastive.py (whose
helpers this file shares).

* Three steps of each SSL type (moco with the multi-view queue, swav with
  a queue of 8), one step an epoch, SGD with momentum, on 8 clips of
  4 x 32² (the config's crop): each step starts the port from JAX's state
  (parameters, BN statistics, momentum, SSL state) with the same clips and
  JAX's own random draws (shuffle permutations, NCE samples).
* Every step is also taken in float64 by both packages: the port's model
  in float64, and JAX's step traced under x64 with the package's float32
  read as float64 (``jax_float64``). The two agree within ``EXACT_TOL``
  (2e-7: the port's optimizer takes gradients in fp32, which moves the
  change and the momentum by up to 6.5e-8; the rest agree within 1.3e-8)
  on every value. JAX's float64 step is the exact step below.
* The fp32 step is held to JAX's fp32 step: the LR; the loss within 1e-5
  relative, always; the gradients (JAX's, read out of its optimizer
  state), the parameters' change and the momentum within 1e-4 relative L2;
  the BN statistics within 1e-5; the SSL state (queue, momentum encoder's
  weights and BN statistics, SwAV's queue, the banks) within 2e-5
  relative L2; the pointer, fill and step counts equal.
* A value further from JAX's than its limit is decided by the exact step:
  the port's fp32 value within the limit of it (JAX's fp32 run is the one
  off: its CPU reductions round more, so its SSL state sits up to 3.1e-5
  from the exact step against the port's 8.9e-6, and its gradients flip a
  ReLU or max-pool near-tie in 6 of the 15 steps of the five
  trajectories), or, where the port's run flipped, JAX's within the limit
  of it and the two runs within 5e-2 (gradients, change, momentum) or 1e-3
  (the rest) of each other, as in tests/test_torch_slowfast_train.py. Only
  the gradients, the change, the momentum and the momentum encoder's
  weights (which take the change in) may be decided the second way, in at
  most one step of a trajectory (1 of the 15 here).
* MoCo's step 0 is its queue warm-up (no update; JAX keeps no gradients of
  it), SwAV's steps 0 and 1 freeze the prototypes.
This file runs moco's trajectory, MoCo's warm-up over the epoch boundary,
SwAV's freeze and unit prototypes, and ``knn_eval`` against JAX's. The
other trajectories share its helpers, one to a file so each stays under
a minute: tests/test_torch_ssl_byol.py, tests/test_torch_ssl_simclr.py,
tests/test_torch_ssl_mem.py, swav (with LARS) in
tests/test_torch_ssl_steps.py, shuffle-BN in
tests/test_torch_ssl_shuffle_bn.py.
"""

import copy
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slowfast_tpu.engine import ssl_steps as jsteps
from slowfast_tpu.models import build_model as jax_build_model
from slowfast_tpu.models import contrastive as jcon
from slowfast_tpu.solver import optimizer as joptim
from slowfast_tpu_torch.engine import ssl_steps as tsteps
from slowfast_tpu_torch.models import contrastive as tcon
from slowfast_tpu_torch.utils.checkpoint import state_dict_from_jax
from test_torch_contrastive import (B, capturing, clips, jax_float64, jax_ssl_state,
                                    load_port_state, port_from_jax, rel_l2, to_float64)
from test_torch_train import one_torch_thread  # noqa: F401  (autouse fixture)

TYPES = {"moco": ["CONTRASTIVE.MOCO_MULTI_VIEW_QUEUE", "True"], "byol": [], "simclr": [],
         "swav": ["CONTRASTIVE.SWAV_QEUE_LEN", "8"], "mem": []}
STEPS = 3
STEP_TOL = 1e-4
SSL_TOL = 2e-5
EXACT_TOL = 2e-7
FLIP_TOL = 5e-2
LIMITS = {"loss": 1e-5, "grads": STEP_TOL, "delta": STEP_TOL, "momentum": STEP_TOL,
          "bn_stats": 1e-5}
# The values that a flip may move beyond their limit: those the gradients
# reach (the momentum encoder's weights take in the change).
FLIPPABLE = re.compile(r"^(grads|delta|momentum|ssl\.hist\..*(weight|bias))$")
_COMPILED = {}


def jax_step(cfg, model, tx, state, batch, rng, spe=1):
    """The jitted JAX SSL step, compiled at XLA's CPU optimization level 0
    once per configuration."""
    key = (cfg.dump(), spe)
    if key not in _COMPILED:
        step = jsteps.make_ssl_train_step(cfg, model, tx, steps_per_epoch=spe, donate=False)
        _COMPILED[key] = step.lower(state, batch, rng).compile(
            compiler_options={"xla_backend_optimization_level": "0"})
    return _COMPILED[key](state, batch, rng)


def jax_step64(cfg, state, batch, rng, spe=1):
    """JAX's step in float64 from ``state`` (its float leaves cast up):
    ``(new state, loss)`` as numpy. Compiled at XLA's default level: at
    level 0 its float64 convolutions take seconds a step."""
    def up(a):
        a = np.asarray(a)
        return a.astype(np.float64) if np.issubdtype(a.dtype, np.floating) else a

    state, batch = jax.tree.map(up, state), jax.tree.map(up, batch)
    with jax_float64():
        key = ("float64", cfg.dump(), spe)
        if key not in _COMPILED:
            model = jax_build_model(cfg)
            tx = capturing(joptim.construct_optimizer(state.params, cfg, spe)[0])
            step = jsteps.make_ssl_train_step(cfg, model, tx, steps_per_epoch=spe, donate=False)
            _COMPILED[key] = step.lower(state, batch, rng).compile()
        new, metrics = _COMPILED[key](state, batch, rng)
        return jax.tree.map(np.asarray, new), float(metrics["loss"])


def batch_of(i):
    x1, x2 = clips(100 + i, s=32), clips(200 + i, s=32)
    index = np.array([3, 17, 8, 41, 22, 0, 35, 12][:B], np.int32) + i
    time = np.random.RandomState(300 + i).uniform(size=(B,)).astype(np.float32)
    jb = {"inputs": [jnp.asarray(x1)], "inputs2": [jnp.asarray(x2)],
          "index": jnp.asarray(index), "time": jnp.asarray(time)}
    tb = {"inputs": [torch.from_numpy(x1)], "inputs2": [torch.from_numpy(x2)],
          "index": torch.from_numpy(index).long(), "time": torch.from_numpy(time)}
    return jb, tb


def jax_draws(cfg, step, rng):
    """The random draws of JAX's step ``step``: its shuffle permutations (the
    loss keys', then the multi-view keys') and its NCE samples."""
    r = jax.random.fold_in(rng, step)
    _, r2 = jax.random.split(r)
    perms = [np.asarray(jax.random.permutation(jax.random.fold_in(r2, 17), B)),
             np.asarray(jax.random.permutation(
                 jax.random.fold_in(jax.random.fold_in(r2, 1), 17), B))]
    return r2, perms


def inject(monkeypatch, cfg, step, rng, index):
    """JAX's draws of ``step`` into the port's draw functions."""
    r2, perms = jax_draws(cfg, step, rng)
    queue = [torch.tensor(p).long() for p in perms]
    monkeypatch.setattr(tsteps, "shuffle_permutation", lambda n, g: queue.pop(0))
    c = cfg.CONTRASTIVE
    duration = max(c.DURATION, 1) if c.MEM_TYPE == "2d" else 1
    ci, ti = jcon.nce_sample_indices(jax.random.fold_in(r2, 3), index, c.LENGTH,
                                     min(c.QUEUE_LEN, c.LENGTH), duration=duration,
                                     interp=c.INTERP_MEMORY)
    monkeypatch.setattr(tcon, "nce_sample_indices", lambda *a, **k: (
        torch.from_numpy(np.asarray(ci)).long(), torch.from_numpy(np.asarray(ti))))


def ssl_arrays(ssl):
    """Copies of the SSL state's tensors, the momentum encoder's under
    ``hist.``."""
    out = {n: getattr(ssl, n).numpy().copy() for n in tcon.SSLState.TENSORS
           if getattr(ssl, n) is not None}
    if ssl.hist is not None:
        out.update({"hist." + k: v.numpy().copy() for k, v in ssl.hist.state_dict().items()
                    if "num_batches" not in k})
    return out


def float64_copies(cfg, model, opt, ssl):
    """Float64 copies of the port's model, optimizer and SSL state."""
    m64 = to_float64(copy.deepcopy(model))
    ssl64 = copy.copy(ssl)
    for n in tcon.SSLState.TENSORS:
        if getattr(ssl, n) is not None:
            setattr(ssl64, n, getattr(ssl, n).double())
    if ssl.hist is not None:
        ssl64.hist = to_float64(copy.deepcopy(ssl.hist))
    return m64, type(opt)(m64, cfg), ssl64


def port_step64(cfg, model, opt, ssl, state, batch, steps_per_epoch=1):
    """The port's step in float64 from JAX's ``state``, on float64 copies of
    the port's model and SSL state; returns the float64 loss, model,
    optimizer, SSL state and gradients."""
    m64, opt64, ssl64 = float64_copies(cfg, model, opt, ssl)
    load_port_state(m64, opt64, ssl64, state)
    step = tsteps.make_ssl_train_step(cfg, m64, opt64, ssl64, steps_per_epoch,
                                      torch.Generator().manual_seed(0))
    step.keep_grads = True
    b64 = {k: [x.double() for x in v] if isinstance(v, list) else v for k, v in batch.items()}
    m = step(b64)
    return m["loss"].item(), m64, opt64, ssl64, step.last_grads


def step_values(model, opt, ssl, names, grads, before, loss):
    sd = model.state_dict()
    cat = lambda ts: np.concatenate([np.asarray(t, np.float64).ravel() for t in ts])  # noqa: E731
    out = {"loss": np.asarray([loss]),
           "grads": cat([grads[n] if n in grads else torch.zeros_like(sd[n]) for n in names]),
           "delta": cat([sd[n].double() - before[n].double() for n in names]),
           "momentum": cat([t for t in opt.trace]),
           "bn_stats": cat([sd[k] for k in sd if "running" in k])}
    out.update({"ssl." + k: v for k, v in ssl_arrays(ssl).items()})
    return out


def jax_values(containers, names, before, state, loss):
    """``step_values`` of a JAX state (its gradients read out of its
    optimizer state), through the port's ``containers`` (a model, optimizer
    and SSL state, which it overwrites)."""
    load_port_state(*containers, state)
    grads = state_dict_from_jax({"params": jax.tree.map(np.asarray, state.opt_state[1])})
    return step_values(*containers, names, grads, before, loss)


def settle(name, got, want, exact, limit, flips):
    """``got`` (the port's fp32 value) within ``limit`` of ``want`` (JAX's);
    else a flip that the exact value decides: ``got`` within the limit of it
    (JAX's run flipped) or ``want`` (the port's run flipped, recorded in
    ``flips``), the two runs within the flip bound of each other."""
    d = rel_l2(got, want)
    if d <= limit:
        return
    d_port, d_jax = rel_l2(got, exact), rel_l2(want, exact)
    if d_port <= limit:
        return
    assert FLIPPABLE.match(name) and d_jax <= limit, (name, d, d_port, d_jax)
    assert d <= (FLIP_TOL if limit == STEP_TOL else 1e-3), (name, d, d_port, d_jax)
    flips.add(name)


@pytest.mark.parametrize("ssl_type", ["moco"])
def test_three_step_trajectory_matches_jax(ssl_type, monkeypatch):
    ssl = check_trajectory(ssl_type, TYPES[ssl_type], monkeypatch, STEPS)
    assert ssl.ptr == (2 * B * STEPS) % 64


def check_trajectory(ssl_type, extra, monkeypatch, steps):
    """``steps`` steps of the port against JAX's, each from JAX's state;
    returns the port's SSL state after the last."""
    jcfg, jmodel, tx, state = jax_ssl_state(ssl_type, extra)
    cfg, model, opt, ssl = port_from_jax(state, ssl_type, extra)
    step = tsteps.make_ssl_train_step(cfg, model, opt, ssl, 1, torch.Generator().manual_seed(0))
    step.keep_grads = True
    rng = jax.random.PRNGKey(1)
    names = [n for n, _ in model.named_parameters()]
    containers = float64_copies(cfg, model, opt, ssl)
    port_flips = []
    for i in range(steps):
        jb, tb = batch_of(i)
        load_port_state(model, opt, ssl, state)
        before = {n: p.detach().clone() for n, p in model.named_parameters()}
        inject(monkeypatch, jcfg, i, rng, jb["index"])
        new_state, jm = jax_step(jcfg, jmodel, tx, state, jb, rng)
        m = step(tb)
        np.testing.assert_allclose(m["lr"], float(jm["lr"]), rtol=1e-6)
        got = step_values(model, opt, ssl, names, step.last_grads, before, m["loss"].item())
        want = jax_values(containers, names, before, new_state, float(jm["loss"]))
        exact = jax_values(containers, names, before, *jax_step64(jcfg, state, jb, rng))
        inject(monkeypatch, jcfg, i, rng, jb["index"])
        loss64, m64, opt64, ssl64, grads64 = port_step64(cfg, model, opt, ssl, state, tb)
        port64 = step_values(m64, opt64, ssl64, names, grads64, before, loss64)
        frozen = ssl_type == "moco" and i == 0
        if frozen:  # JAX keeps no gradients of a warm-up step
            for values in (got, want, exact, port64):
                del values["grads"]
        assert sorted(got) == sorted(want) == sorted(exact) == sorted(port64)
        for k in want:
            assert rel_l2(port64[k], exact[k]) <= EXACT_TOL, (i, k, rel_l2(port64[k], exact[k]))
        assert rel_l2(got["loss"], want["loss"]) <= LIMITS["loss"], (i, got["loss"], want["loss"])
        flips = set()
        for k in want:
            settle(k, got[k], want[k], exact[k], LIMITS.get(k, SSL_TOL), flips)
        if flips:
            port_flips.append((i, sorted(flips)))
        assert (not got["delta"].any()) == frozen and (not want["delta"].any()) == frozen
        state = new_state
        assert (ssl.ptr, ssl.swav_filled, ssl.iter) == (
            int(state.ssl_state.get("ptr", 0)), int(state.ssl_state.get("swav_filled", 0)),
            int(state.ssl_state["iter"]))
    assert len(port_flips) <= 1, port_flips
    return ssl


def port_state(ssl_type, extra=(), steps_per_epoch=1):
    _, _, _, state = jax_ssl_state(ssl_type, extra)
    cfg, model, opt, ssl = port_from_jax(state, ssl_type, extra)
    step = tsteps.make_ssl_train_step(cfg, model, opt, ssl, steps_per_epoch)
    return cfg, model, opt, ssl, step


def check_moco_warmup(steps_per_epoch):
    """``QUEUE_LEN // TRAIN.BATCH_SIZE`` = 16 warm-up steps cut short by the
    epoch: the steps of epoch 0 leave the parameters and momentum bit-equal
    (the BN statistics, the momentum encoder and the queue move), the steps
    after it update."""
    cfg, model, opt, ssl, step = port_state("moco", ["TRAIN.BATCH_SIZE", "4"],
                                            steps_per_epoch=steps_per_epoch)
    assert cfg.CONTRASTIVE.QUEUE_LEN // cfg.TRAIN.BATCH_SIZE == 16
    for i in range(3):
        params = [p.detach().clone() for p in model.parameters()]
        trace = [t.clone() for t in opt.trace]
        stats = model.state_dict()["backbone.s1.pathway0_stem.bn.running_mean"].clone()
        queue = ssl.queue_x.clone()
        step(batch_of(i)[1])
        same = all(torch.equal(a, b) for a, b in zip(params, model.parameters()))
        same_trace = all(torch.equal(a, b) for a, b in zip(trace, opt.trace))
        assert same == same_trace == (i < steps_per_epoch), i
        assert not torch.equal(stats, model.state_dict()[
            "backbone.s1.pathway0_stem.bn.running_mean"])
        assert not torch.equal(queue, ssl.queue_x)
    assert ssl.ptr == 3 * B


def test_moco_warmup_over_the_epoch_boundary():
    """2 steps an epoch: steps 0 and 1 are warm-up, step 2 (epoch 1)
    updates."""
    check_moco_warmup(2)


def test_moco_warmup_of_one_step_epochs():
    """One step an epoch, as ``chip_smoke.py``'s MoCo slice runs: step 0 is
    the warm-up, steps 1 and 2 update."""
    check_moco_warmup(1)


def test_swav_prototypes_freeze_and_unit_norm():
    """SwAV, one step an epoch, weight decay on: through epoch 1 (steps 0
    and 1) the prototypes move only by their decay, which the renormalized
    rows cancel; step 2 moves them; every row has unit length after each
    step."""
    cfg, model, opt, ssl, step = port_state("swav", ["SOLVER.WEIGHT_DECAY", "0.01"])
    w = model.swav_prototypes.weight
    unit0 = (w / w.norm(dim=1, keepdim=True)).detach().clone()
    for i in range(3):
        step(batch_of(i)[1])
        torch.testing.assert_close(w.norm(dim=1), torch.ones(w.shape[0]), rtol=0, atol=1e-6)
        moved = (w - unit0).abs().max().item()
        assert (moved < 1e-6) == (i < 2), (i, moved)


def test_knn_eval_matches_jax():
    """The kNN probe's accuracy on the JAX state's bank, with k = LENGTH (50)
    neighbours, on 3 val batches whose labels the bank's votes decide."""
    cfg, model, opt, ssl, step = port_state("moco")
    jcfg, jmodel, _, state = jax_ssl_state("moco")
    train_labels = np.random.RandomState(0).randint(0, 5, 50)
    rs = np.random.RandomState(1)
    val = [([clips(40 + j)], rs.randint(0, 5, B), None, None, {}) for j in range(3)]
    want = jsteps.knn_eval(jcfg, jmodel, state, train_labels,
                           [([jnp.asarray(x[0])], y, i, t, m) for x, y, i, t, m in val])
    got = tsteps.knn_eval(cfg, model, ssl, train_labels,
                          [([torch.from_numpy(x[0])], y, i, t, m) for x, y, i, t, m in val])
    assert got == want and 0 < got < 100
