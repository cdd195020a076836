"""The JAX side of the SSL multi-process tests: three steps of the JAX
package's ``make_ssl_train_step`` on a 2-device ``data`` mesh (the CPU's
virtual devices, ``tests/conftest.py``), the cases the gloo ranks run
(``ssl_ddp_harness``), and the checks of the ranks' steps against the
mesh's. Imported inside the tests only, so the spawned ranks start without
JAX.

The models and batches are those of tests/test_torch_ssl_train.py (narrow
C2D R18, global batches of 8 clips of 4 × 32², one step an epoch, SGD with
momentum), each step of the ranks from JAX's state before it with JAX's
draws, and against the port's step in one process on the global batch
from the same state. Checks, each step:

* the loss (the ranks' mean) within 1e-5 relative of JAX's;
* the gradients (averaged over the ranks, JAX's read out of its optimizer
  state), the parameters' change and the momentum within 1e-4 relative L2,
  the BN statistics within 1e-5 and the SSL state within 2e-5 of JAX's;
* the same step in float64 on the ranks and in one process: the loss,
  the gradients and the parameters and BN statistics after it within
  ``EXACT_TOL`` of each other (1e-10): the 2-rank step computes the
  one-process step's function, and what parts the fp32 runs is rounding;
* a fp32 value past its limit is decided by the float64 step (the port's
  one-process step in float64, which the one-process SSL trajectory tests
  hold within 2e-7 of JAX's float64 step) as those tests decide it
  (``test_torch_ssl_train.settle``). The ranks' fp32 forward sits about
  1e-7 from the one process's, so a ReLU or max-pool near-tie can fall the
  other way in any step: SimCLR's 2-rank run flips one in 2 of its 3 steps
  (its gradients 6e-4 and 4.3e-3 from float64, in the stem and the early
  stages; the one process's 2e-5), so the flips are not counted. A loss
  past its limit must sit no further from the float64 loss than twice
  JAX's does (a loss near zero, as MoCo's first step on keys from the same
  weights, keeps only the fp32 rounding of logits of size 1/T: JAX's mesh
  step sits 1.2e-5 from the float64 loss there, the port's 1.6e-5);
* the rows of MoCo's queue, SwAV's queue and the banks: in float64 (the
  ranks' and the one process's steps both in float64), each within
  ``ROW_TOL`` (absolute) of the one-process step's row at the same
  position (in fp32 the two differ by up to 9e-6 an element: the ranks
  reduce their halves of the batch apart); in fp32 each within
  ``ORDER_TOL`` of JAX's row at the same position (the fp32 keys of the
  two packages differ by up to 1.5e-4 an element under shuffle-BN after an
  update; a row written at another position misses by about 0.1), or,
  where JAX's
  fp32 step flipped a ReLU or max-pool near-tie (whose change reaches the
  momentum encoder and so the keys it writes), of the float64 step's row;
  the pointer, fill and step counts equal to both;
* every rank's model, optimizer state, SSL state and gradients equal to
  rank 0's: the state stays replicated.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from slowfast_tpu.engine import ssl_steps as jsteps
from slowfast_tpu.models import contrastive as jcon
from slowfast_tpu.parallel.mesh import create_mesh
from slowfast_tpu_torch.utils.checkpoint import ssl_state_from_jax, state_dict_from_jax
from test_torch_contrastive import (B, NARROW, clips, jax_ssl_state, jax_trace, port_from_jax,
                                    rel_l2, ssl_opts)
from test_torch_ssl_train import (LIMITS, SSL_TOL, float64_copies, jax_draws, jax_values,
                                  settle, step_values)

from ssl_ddp_harness import WORLD

STEPS = 3
EXACT_TOL = 1e-10
ROW_TOL = 1e-6
ORDER_TOL = 1e-3
RNG = 1


def global_batch(i):
    """Step ``i``'s global batch (JAX's global order): numpy and JAX."""
    x1, x2 = clips(100 + i, s=32), clips(200 + i, s=32)
    index = np.array([3, 17, 8, 41, 22, 0, 35, 12][:B], np.int32) + i
    time = np.random.RandomState(300 + i).uniform(size=(B,)).astype(np.float32)
    nb = {"inputs": x1, "inputs2": x2, "index": index, "time": time}
    return nb, {"inputs": [jnp.asarray(x1)], "inputs2": [jnp.asarray(x2)],
                "index": jnp.asarray(index), "time": jnp.asarray(time)}


def port_start(state):
    """A JAX SSL train state in the port's format."""
    tree = jax.tree.map(np.asarray, {"params": state.params, "batch_stats": state.batch_stats})
    return {"model": state_dict_from_jax(tree),
            "opt": {"count": 0, "trace": state_dict_from_jax(
                {"params": jax.tree.map(np.asarray, jax_trace(state.opt_state[0]))})},
            "ssl": ssl_state_from_jax(jax.tree.map(np.asarray, state.ssl_state))}


def draws_of(cfg, step, index):
    """JAX's draws of step ``step``: the shuffle permutations and the NCE
    grid of the global batch."""
    rng = jax.random.PRNGKey(RNG)
    r2, perms = jax_draws(cfg, step, rng)
    c = cfg.CONTRASTIVE
    duration = max(c.DURATION, 1) if c.MEM_TYPE == "2d" else 1
    ci, ti = jcon.nce_sample_indices(jax.random.fold_in(r2, 3), index, c.LENGTH,
                                     min(c.QUEUE_LEN, c.LENGTH), duration=duration,
                                     interp=c.INTERP_MEMORY)
    return {"perms": perms, "nce": (np.asarray(ci), np.asarray(ti))}


def mesh_case(ssl_type, extra, num_shards=1, spe=1, knn=False, num_steps=STEPS):
    """``num_steps`` JAX steps of a case on the 2-device mesh and the case the
    ranks run: ``(case, jax_run)``."""
    jcfg, jmodel, tx, state = jax_ssl_state(ssl_type, extra, spe)
    mesh = create_mesh(jcfg, devices=jax.devices()[:WORLD])
    step = jsteps.make_ssl_train_step(jcfg, jmodel, tx, mesh=mesh, steps_per_epoch=spe,
                                      donate=False)
    rng = jax.random.PRNGKey(RNG)
    compiled, steps = None, []
    opts = ssl_opts(ssl_type) + NARROW + list(extra) + ["TPU.COMPUTE_DTYPE", "float32"]
    case = {"opts": opts, "spe": spe,  # make_cfg's options
            "num_shards": num_shards, "starts": [], "batches": [], "draws": []}
    for i in range(num_steps):
        nb, jb = global_batch(i)
        if compiled is None:  # XLA's CPU optimization level 0 compiles faster
            compiled = step.lower(state, jb, rng).compile(
                compiler_options={"xla_backend_optimization_level": "0"})
        new, m = compiled(state, jb, rng)
        steps.append({"state": state, "batch": jb, "new": new, "loss": float(m["loss"]),
                      "lr": float(m["lr"])})
        case["starts"].append(port_start(state))
        case["batches"].append(nb)
        case["draws"].append(draws_of(jcfg, i, jb["index"]))
        state = new
    if knn:
        rs = np.random.RandomState(1)
        case["knn_labels"] = rs.randint(0, 5, jcfg.CONTRASTIVE.LENGTH)
        case["knn_val"] = [(clips(40 + j, n=n, s=32), rs.randint(0, 5, n))
                           for j, n in enumerate((8, 5))]
    return case, {"cfg": jcfg, "ssl_type": ssl_type, "extra": extra, "spe": spe,
                  "steps": steps}


def run_cases(tmp_dir, cases, knn=(), num_steps=STEPS):
    """Each case of ``{name: (ssl_type, extra options)}`` on the mesh
    (``num_steps`` steps) and on 2 gloo ranks (one spawn); the kNN probe
    too for the cases ``knn`` names: ``{name: (case, jax_run, ranks)}``."""
    from ssl_ddp_harness import spawned_cases

    built = {name: mesh_case(t, extra, knn=name in knn, num_steps=num_steps)
             for name, (t, extra) in cases.items()}
    ranks = spawned_cases(tmp_dir, {name: case for name, (case, _) in built.items()})
    return {name: (case, jax_run, ranks) for name, (case, jax_run) in built.items()}


def check_case(name, case, jax_run, ranks):
    """The ranks' steps of ``name`` against the mesh's and the one
    process's (module docstring)."""
    from ssl_ddp_harness import run_case

    steps = jax_run["steps"]
    cfg, model, opt, ssl = port_from_jax(steps[0]["state"], jax_run["ssl_type"],
                                         jax_run["extra"], jax_run["spe"])
    names = [n for n, _ in model.named_parameters()]
    containers = float64_copies(cfg, model, opt, ssl)
    exact_run = run_case(dict(case, num_shards=1), float64=True)
    flipped = []
    for i, js in enumerate(steps):
        got_ranks = [r[name][i] for r in ranks]
        r0 = got_ranks[0]
        for r in got_ranks[1:]:  # replicated
            for part in ("model", "ssl"):
                _assert_equal(r[part], r0[part], (name, i, part))
            _assert_equal(r["opt"]["trace"], r0["opt"]["trace"], (name, i, "trace"))
            _assert_equal(r["grads"], r0["grads"], (name, i, "grads"))
        np.testing.assert_allclose(r0["lr"], js["lr"], rtol=1e-6)
        before = {k: v.clone() for k, v in case["starts"][i]["model"].items() if k in names}

        def values(run, loss):
            c = containers if run["model"][names[0]].dtype == torch.float64 else (model, opt, ssl)
            c[0].load_state_dict(run["model"], strict=True)
            c[1].load_state_dict(run["opt"])
            c[2].load_state_dict(run["ssl"])
            return step_values(*c, names, run["grads"], before, loss)

        loss = float(np.mean([r["loss"] for r in got_ranks]))
        got = values(r0, loss)
        state = {k: getattr(ssl, k).numpy().copy() for k in ("queue_x", "queue_swav", "memory",
                                                             "knn_memory")
                 if getattr(ssl, k) is not None}
        counts = (ssl.ptr, ssl.swav_filled, ssl.iter)
        _check_one_process(name, i, dict(ranks[0][(name, "float64")][i], loss=float(np.mean(
            [r[(name, "float64")][i]["loss"] for r in ranks]))), exact_run[i])
        want = jax_values(containers, names, before, js["new"], js["loss"])
        new_ssl = js["new"].ssl_state
        assert counts == (int(new_ssl.get("ptr", 0)), int(new_ssl.get("swav_filled", 0)),
                          int(new_ssl["iter"])), (name, i, counts)
        for k, v in state.items():  # each row where JAX has it
            err = np.abs(v - np.asarray(new_ssl[k], np.float64)).reshape(-1, v.shape[-1]).max(1)
            if err.max() > ORDER_TOL:  # a near-tie that JAX's fp32 step flipped
                exact_rows = exact_run[i]["ssl"][k].numpy()
                err = np.abs(v - exact_rows).reshape(-1, v.shape[-1]).max(1)
            assert err.max() <= ORDER_TOL, (name, i, k, err.max(), np.argmax(err))
        if not got["delta"].any() and not want["delta"].any():  # MoCo's warm-up step
            del got["grads"], want["grads"]
        assert sorted(got) == sorted(want), (name, i)
        exact = None
        flips = set()
        for k in want:
            limit = LIMITS.get(k, SSL_TOL)
            if rel_l2(got[k], want[k]) <= limit:
                continue
            if exact is None:
                exact = values(exact_run[i], exact_run[i]["loss"])
            if k == "loss":  # the loss's fp32 rounding near zero
                assert rel_l2(got[k], exact[k]) <= 2 * rel_l2(want[k], exact[k]), (
                    name, i, got[k], want[k], exact[k])
            else:
                settle(k, got[k], want[k], exact[k], limit, flips)
        if flips:
            flipped.append((i, sorted(flips)))
    return flipped


def _check_one_process(name, i, got_run, want_run):
    """A float64 2-rank step against the one-process float64 step on the
    global batch: the loss, the gradients and the parameters and BN
    statistics after it within ``EXACT_TOL``; each row of the queues and
    banks within ``ROW_TOL``, the counts equal."""
    assert abs(got_run["loss"] - want_run["loss"]) <= EXACT_TOL * abs(want_run["loss"])
    for part in ("grads", "model"):
        names = [n for n in want_run[part] if "num_batches" not in n]
        assert sorted(got_run[part]) == sorted(want_run[part]), (name, i, part)
        assert rel_l2(np.concatenate([got_run[part][n].numpy().ravel() for n in names]),
                      np.concatenate([want_run[part][n].numpy().ravel() for n in names])
                      ) <= EXACT_TOL, (name, i, part)
    got, want = got_run["ssl"], want_run["ssl"]
    assert [got[k] for k in ("ptr", "swav_filled", "iter")] == [
        want[k] for k in ("ptr", "swav_filled", "iter")], (name, i)
    rows = [k for k in ("queue_x", "queue_swav", "memory", "knn_memory") if k in want]
    assert rows == [k for k in ("queue_x", "queue_swav", "memory", "knn_memory") if k in got]
    for k in rows:
        err = (got[k] - want[k]).abs().reshape(-1, want[k].shape[-1]).amax(1)
        assert err.max() <= ROW_TOL, (name, i, k, err.max().item(), err.argmax().item())


def _assert_equal(a, b, where):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), where
        for k in a:
            _assert_equal(a[k], b[k], where + (k,))
    elif isinstance(a, torch.Tensor):
        assert torch.equal(a, b), where
    else:
        assert a == b, where
