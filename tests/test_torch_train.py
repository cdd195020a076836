"""The port's MViT training slice against the JAX package, on the CPU.

The narrow MViTv2 of tests/test_torch_mvit.py (``MVITv2_S_16x4.yaml`` at
depth 4, embed 16, 4 frames, 56² crops, 16 classes) with every parameter
overwritten by seeded random values, run through both packages:

* the LR schedule at fractional epochs and the parameter partition (weight
  decay, layer-decay LR scale) of the optimizer;
* three AdamW updates with the global-norm clip engaged, on seeded
  gradients, against the optax chain of ``construct_optimizer`` (atol 1e-6);
* the losses, mixup fed JAX's draws, drop path, dropout and the GELU
  gradient;
* the train loader's order and batches, ``run_net --device cpu`` training
  with auto-resume, and the saved ``.pyth`` loaded into the JAX package.

The train step's gradients (tests/test_torch_train_parity.py) and a 20-step
trajectory (tests/test_torch_train_trajectory.py) share this file's
helpers.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import traverse_util

from slowfast_tpu.config import get_cfg as jax_get_cfg
from slowfast_tpu.data import construct_loader as jax_construct_loader
from slowfast_tpu.data import mixup as jmixup
from slowfast_tpu.engine.steps import TrainState, make_eval_step as jax_make_eval_step
from slowfast_tpu.models import build_model as jax_build_model
from slowfast_tpu.models import common as jcommon
from slowfast_tpu.models.build import init_model
from slowfast_tpu.solver import losses as jlosses
from slowfast_tpu.solver import optimizer as joptim
from slowfast_tpu.utils.checkpoint import load_torch_checkpoint_dict
from slowfast_tpu_torch.config import assert_and_infer_cfg, get_cfg
from slowfast_tpu_torch.data import construct_loader, mixup as tmixup
from slowfast_tpu_torch.engine.steps import make_eval_step
from slowfast_tpu_torch.models import common as tcommon
from slowfast_tpu_torch.models.build import build_model
from slowfast_tpu_torch.models.heads import dropout
from slowfast_tpu_torch.ops import attention as attention_ops
from slowfast_tpu_torch.run_net import main as run_net_main
from slowfast_tpu_torch.solver import losses as tlosses
from slowfast_tpu_torch.solver import optimizer as toptim
from slowfast_tpu_torch.solver.lr_policy import make_epoch_lr_fn
from slowfast_tpu_torch.utils.checkpoint import state_dict_from_jax

YAML = os.path.join(os.path.dirname(__file__), "..", "configs", "Kinetics",
                    "MVITv2_S_16x4.yaml")
NARROW = [
    "MVIT.DEPTH", "4", "MVIT.EMBED_DIM", "16", "MVIT.NUM_HEADS", "1",
    "MVIT.DIM_MUL", "[[1,2.0],[3,2.0]]", "MVIT.HEAD_MUL", "[[1,2.0],[3,2.0]]",
    "MVIT.POOL_Q_STRIDE", "[[0,1,1,1],[1,1,2,2],[2,1,1,1],[3,1,2,2]]",
    "DATA.NUM_FRAMES", "4", "DATA.TRAIN_CROP_SIZE", "56", "DATA.TEST_CROP_SIZE", "56",
    "MODEL.NUM_CLASSES", "16", "NUM_GPUS", "1", "DATA_LOADER.NUM_WORKERS", "2",
    "TEST.BATCH_SIZE", "2", "TRAIN.BATCH_SIZE", "2",
]
# Deterministic training: no mixup, drop path or dropout.
PLAIN = ["MIXUP.ENABLE", "False", "MVIT.DROPPATH_RATE", "0.0", "MODEL.DROPOUT_RATE", "0.0"]
TRAJECTORY = PLAIN + ["SOLVER.BASE_LR", "1e-3", "SOLVER.WARMUP_EPOCHS", "1.0",
                      "SOLVER.MAX_EPOCH", "4"]
STEPS_PER_EPOCH = 5


def narrow_cfg(get, dtype="float32", extra=()):
    cfg = get()
    cfg.merge_from_file(YAML)
    cfg.merge_from_list(NARROW + ["TPU.COMPUTE_DTYPE", dtype] + list(extra))
    return cfg


def randomize(shapes, seed):
    """Seeded values for every leaf (as tests/test_torch_mvit.py does)."""
    rng = np.random.RandomState(seed)
    out = {}
    for path, s in traverse_util.flatten_dict(shapes).items():
        leaf = path[-1]
        if leaf == "kernel":
            v = rng.normal(0.0, np.sqrt(1.0 / np.prod(s.shape[:-1])), s.shape)
        elif leaf in ("scale", "gamma_1", "gamma_2"):
            v = rng.uniform(0.5, 1.5, s.shape)
        elif leaf.startswith("rel_pos"):
            v = rng.normal(0.0, 0.3, s.shape)
        elif leaf == "cls_token":
            v = rng.normal(0.0, 1.0, s.shape)
        else:
            v = rng.normal(0.0, 0.1, s.shape)
        out[path] = v.astype(np.float32)
    return traverse_util.unflatten_dict(out)


def port_name(path):
    """Flax param path -> the port's parameter name."""
    mods = [p.replace("blocks_", "blocks.") for p in path[:-1]]
    leaf = {"kernel": "weight", "scale": "weight"}.get(path[-1], path[-1])
    return ".".join(mods + [leaf])


def as_port(tree):
    """A JAX param-shaped tree as the port's ``{name: tensor}``."""
    return state_dict_from_jax({"params": tree})


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs several workers on a few cores: one torch thread each
    keeps them from oversubscribing the CPU (six concurrent runs of the
    trajectory file took 361 s each with torch's default thread count, 54 s
    with one)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def variables():
    cfg = narrow_cfg(jax_get_cfg)
    shapes = jax.eval_shape(lambda: init_model(jax_build_model(cfg), cfg,
                                               rng=jax.random.PRNGKey(0), train=True))
    return randomize(dict(shapes), 0)


def port_model(variables, dtype="float32", extra=()):
    model = build_model(narrow_cfg(get_cfg, dtype, extra), device="cpu")
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    return model


def clips(seed, n=2):
    return np.random.RandomState(seed).randint(0, 255, (n, 4, 56, 56, 3)).astype(np.uint8)


def labels(seed, n=2):
    return np.random.RandomState(1000 + seed).randint(0, 16, (n,)).astype(np.int64)


def structurally_zero(name, depth=4):
    """Gradients that vanish in exact arithmetic, so both frameworks hold
    only rounding noise (or zeros) there: a bias on every key shifts each
    logit row by a constant, which the softmax ignores (``norm_k.bias``);
    the last block's q pooling and rel-pos tables act only on the non-cls
    query rows, and only the cls row reaches the head."""
    last = f"blocks.{depth - 1}.attn."
    return name.endswith("norm_k.bias") or (
        name.startswith(last) and name[len(last):].startswith(("pool_q.", "rel_pos")))


# --- schedule and optimizer -------------------------------------------------

@pytest.mark.parametrize("extra", [
    [],  # the recipe: cosine after a 30-epoch warmup, 200 epochs
    ["SOLVER.WARMUP_EPOCHS", "1.0", "SOLVER.MAX_EPOCH", "4", "SOLVER.BASE_LR", "1e-3"],
    ["SOLVER.LR_POLICY", "steps_with_relative_lrs", "SOLVER.STEPS", "[0, 3, 5]",
     "SOLVER.LRS", "[1, 0.1, 0.01]", "SOLVER.MAX_EPOCH", "8", "SOLVER.WARMUP_EPOCHS", "0.5"],
])
def test_lr_matches_jax_epoch_lr_fn(extra):
    port = make_epoch_lr_fn(narrow_cfg(get_cfg, extra=extra))
    want = joptim.make_epoch_lr_fn(narrow_cfg(jax_get_cfg, extra=extra))
    for epoch in np.linspace(0.0, 8.0, 97):
        # JAX evaluates the schedule in fp32, the port in Python floats.
        np.testing.assert_allclose(port(float(epoch)), float(want(epoch)), rtol=1e-5)


@pytest.mark.parametrize("extra", [
    ["SOLVER.LAYER_DECAY", "1.0"],
    ["SOLVER.LAYER_DECAY", "0.75"],
    ["SOLVER.LAYER_DECAY", "0.75", "MVIT.ZERO_DECAY_POS_CLS", "True"],
])
def test_param_scales_match_jax(variables, extra):
    jcfg = narrow_cfg(jax_get_cfg, extra=extra)
    wd_tree, scale_tree = joptim.build_param_scales(variables["params"], jcfg)
    wd = traverse_util.flatten_dict(wd_tree)
    scale = traverse_util.flatten_dict(scale_tree)
    want = {port_name(p): (wd[p], scale[p]) for p in wd}
    got = toptim.build_param_scales(port_model(variables, extra=extra),
                                    narrow_cfg(get_cfg, extra=extra))
    assert got == pytest.approx(want)
    assert {w for w, _ in got.values()} == {0.0, 0.05}


def test_adamw_update_matches_optax_chain(variables):
    """Three AdamW updates on seeded gradients with norm above the clip."""
    extra = ["SOLVER.LAYER_DECAY", "0.75"]
    jcfg = narrow_cfg(jax_get_cfg, extra=extra)
    params = variables["params"]
    tx, _ = joptim.construct_optimizer(params, jcfg, STEPS_PER_EPOCH)
    opt_state = tx.init(params)
    update = jax.jit(tx.update)
    model = port_model(variables, extra=extra)
    opt = toptim.construct_optimizer(model, narrow_cfg(get_cfg, extra=extra))
    named = dict(model.named_parameters())
    rng = np.random.RandomState(7)
    for i, lr in enumerate([1e-3, 5e-4, 2e-3]):
        grads = jax.tree.map(lambda p: rng.normal(0.0, 0.3, p.shape).astype(np.float32), params)
        assert float(optax.global_norm(grads)) > 1.0  # the clip is engaged
        updates, opt_state = update(grads, opt_state, params)
        params = jax.tree.map(lambda p, u: p - lr * u, params, updates)
        for name, g in as_port(grads).items():
            named[name].grad = g.clone()
        norm = opt.step(lr)
        np.testing.assert_allclose(float(norm), float(optax.global_norm(grads)), rtol=1e-6)
    want = as_port(params)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), atol=1e-6, err_msg=name)
    assert opt.count == 3


def test_unported_optimizers_raise(variables):
    # SOLVER.LARS_ON is ported (tests/test_torch_contrastive.py), and so is
    # SOLVER.CLIP_GRAD_VAL (tests/test_torch_ddp_misc.py).
    for extra in (["SOLVER.OPTIMIZING_METHOD", "lars"],):
        with pytest.raises(NotImplementedError):
            toptim.construct_optimizer(port_model(variables), narrow_cfg(get_cfg, extra=extra))


def test_losses_match_jax():
    rng = np.random.RandomState(3)
    logits = rng.normal(0.0, 2.0, (5, 16)).astype(np.float32)
    ints = rng.randint(0, 16, (5,))
    soft = rng.dirichlet(np.ones(16), 5).astype(np.float32)
    for name in ("soft_cross_entropy", "cross_entropy"):
        for lab in (ints, soft):
            got = tlosses.get_loss_func(name)(torch.from_numpy(logits), torch.from_numpy(lab))
            want = jlosses.get_loss_func(name)(jnp.asarray(logits), jnp.asarray(lab))
            np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    got = tlosses.get_loss_func("contrastive_loss")(torch.from_numpy(logits))
    want = jlosses.get_loss_func("contrastive_loss")(jnp.asarray(logits))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    with pytest.raises(NotImplementedError):
        tlosses.get_loss_func("not_a_loss")


# --- mixup, drop path, dropout, GELU ---------------------------------------

def jax_draws(rng, H, W, mixup_alpha, cutmix_alpha, mix_prob, switch_prob):
    """The draws of ``mixup_batch`` (slowfast_tpu/data/mixup.py:56-73),
    recomputed in its split order."""
    r_use, r_switch, r_lam_m, r_lam_c, r_box = jax.random.split(rng, 5)
    r1, r2 = jax.random.split(r_box)
    return dict(
        use_mix=bool(jax.random.uniform(r_use) < mix_prob),
        use_cutmix=bool(cutmix_alpha > 0.0 and jax.random.uniform(r_switch) < switch_prob),
        lam_mix=float(jax.random.beta(r_lam_m, mixup_alpha, mixup_alpha)),
        lam_cut=float(jax.random.beta(r_lam_c, cutmix_alpha, cutmix_alpha)),
        cy=int(jax.random.randint(r1, (), 0, H)), cx=int(jax.random.randint(r2, (), 0, W)))


def _find_seed(want_cutmix):
    for seed in range(100):
        d = jax_draws(jax.random.PRNGKey(seed), 16, 12, 0.8, 1.0, 1.0, 0.5)
        if d["use_cutmix"] == want_cutmix and (not want_cutmix or 0.2 < d["lam_cut"] < 0.8):
            return seed
    raise AssertionError("no seed")


@pytest.mark.parametrize("branch,dtype", [
    ("mixup", "float32"), ("mixup", "bfloat16"), ("cutmix", "float32"), ("none", "float32"),
])
def test_mix_with_jax_draws_matches_mixup_batch(branch, dtype):
    rng = np.random.RandomState(4)
    pathways = [rng.normal(0.0, 1.0, (4, t, 16, 12, 3)).astype(np.float32) for t in (2, 4)]
    labs = np.array([3, 0, 15, 7])
    kw = dict(mixup_alpha=0.8, cutmix_alpha=1.0, switch_prob=0.5,
              mix_prob=0.0 if branch == "none" else 1.0)
    key = jax.random.PRNGKey(_find_seed(branch == "cutmix"))
    jdt = getattr(jnp, dtype)
    want_x, want_y = jmixup.mixup_batch(key, [jnp.asarray(p, jdt) for p in pathways],
                                        jnp.asarray(labs), 16, label_smoothing=0.1, **kw)
    draws = jax_draws(key, 16, 12, kw["mixup_alpha"], kw["cutmix_alpha"], kw["mix_prob"],
                      kw["switch_prob"])
    assert draws["use_mix"] == (branch != "none")
    inputs = [torch.from_numpy(p).to(getattr(torch, dtype)) for p in pathways]
    got_x, got_y = tmixup.mix_with(inputs, torch.from_numpy(labs), 16, label_smoothing=0.1,
                                   **draws)
    for g, w in zip(got_x, want_x):
        assert g.dtype == getattr(torch, dtype)
        np.testing.assert_array_equal(g.float().numpy(),
                                      np.asarray(w.astype(jdt).astype(jnp.float32)))
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), rtol=1e-6, atol=1e-7)


def test_mixup_draws_follow_their_distributions():
    gen = torch.Generator().manual_seed(0)
    draws = [tmixup.mix_draws(gen, 16, 12) for _ in range(3000)]
    lam = np.array([d["lam_mix"] for d in draws])
    cut = np.array([d["lam_cut"] for d in draws])
    # Beta(0.8, 0.8): mean 1/2, variance 1 / (4 (2 a + 1)) = 0.0962; Beta(1, 1)
    # is uniform: variance 1/12.
    assert abs(lam.mean() - 0.5) < 0.02 and abs(lam.var() - 0.0962) < 0.01
    assert abs(cut.mean() - 0.5) < 0.02 and abs(cut.var() - 1 / 12) < 0.01
    assert abs(np.mean([d["use_cutmix"] for d in draws]) - 0.5) < 0.04
    assert all(d["use_mix"] and 0 <= d["cy"] < 16 and 0 <= d["cx"] < 12 for d in draws)


@pytest.mark.parametrize("rate", [0.2, 0.5])
def test_drop_path_and_dropout_statistics(rate):
    x = torch.ones(20000, 3, 2)
    dp = tcommon.DropPath(rate)
    dp.generator = torch.Generator().manual_seed(1)
    dp.train()
    y = dp(x)
    kept = y[:, 0, 0] != 0
    assert torch.all(y[kept] == 1.0 / (1.0 - rate)) and torch.all(y[~kept] == 0.0)
    assert torch.all((y == 0).all(dim=(1, 2)) | (y != 0).all(dim=(1, 2)))  # per sample
    assert abs(1.0 - kept.float().mean().item() - rate) < 0.015
    dp.eval()
    assert dp(x) is x
    y = dropout(x, rate, torch.Generator().manual_seed(2))
    nz = y != 0
    assert torch.all(y[nz] == torch.tensor(1.0 / (1.0 - rate)))
    assert abs(1.0 - nz.float().mean().item() - rate) < 0.01
    # Same seed, same mask.
    assert torch.equal(dropout(x, rate, torch.Generator().manual_seed(2)), y)


def test_head_dropout_only_in_training(variables):
    model = port_model(variables, extra=["MODEL.DROPOUT_RATE", "0.5"])
    x = torch.ones(4, model.head.projection.in_features)
    model.head.eval()
    ev = model.head(x)
    model.head.train()
    tr = model.head(x)
    assert not torch.allclose(tr, model.head.projection(x))
    torch.testing.assert_close(ev, torch.softmax(model.head.projection(x), dim=-1))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gelu_gradient_matches_jax_custom_vjp(dtype):
    rng = np.random.RandomState(5)
    x = rng.normal(0.0, 2.0, (64, 33)).astype(np.float32)
    g = rng.normal(0.0, 1.0, (64, 33)).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    y_j, pull = jax.vjp(jcommon.gelu_exact, jnp.asarray(x, jdt))
    (dx_j,) = pull(jnp.asarray(g, jdt))
    xt = torch.from_numpy(x).to(tdt).requires_grad_()
    y_t = tcommon.gelu_exact(xt)
    (dx_t,) = torch.autograd.grad(y_t, xt, torch.from_numpy(g).to(tdt))
    assert y_t.dtype == dx_t.dtype == tdt
    for got, want in ((y_t, y_j), (dx_t, dx_j)):
        got, want = got.float().detach().numpy(), np.asarray(want.astype(jnp.float32))
        if dtype == "float32":
            np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)
        else:  # the same rounding of the saved derivative; one ulp apart at most,
            # except where Φ(x) + x φ(x) cancels for very negative x
            np.testing.assert_allclose(got, want, atol=1e-6, rtol=2 ** -7)


# --- loader, CLI, checkpoints ----------------------------------------------

def test_train_loader_matches_jax_sharded_loader():
    extra = ["TRAIN.DATASET", "syntheticvideo", "DATA.SYNTHETIC_SIZE", "7",
             "TRAIN.BATCH_SIZE", "3"]
    port = construct_loader(narrow_cfg(get_cfg, extra=extra), "train", device="cpu")
    jloader = jax_construct_loader(narrow_cfg(jax_get_cfg, extra=extra), "train")
    assert len(port) == len(jloader) == 2  # drop_last
    for epoch in range(3):
        port.set_epoch(epoch)
        jloader.set_epoch(epoch)
        got, want = port._indices(), list(jloader._indices())
        assert [list(b) for b in got] == [list(b) for b in want]
        for (x, y, idx, _, _), (jx, jy, jidx, _, _) in zip(port, jloader):
            # AUG.NUM_SAMPLE 2: each item twice, flattened into the batch.
            assert x[0].shape == (6, 4, 56, 56, 3)
            np.testing.assert_array_equal(x[0].numpy(), jx[0])
            np.testing.assert_array_equal(y, jy)
            np.testing.assert_array_equal(idx, jidx)
    val = construct_loader(narrow_cfg(get_cfg, extra=extra), "val", device="cpu")
    assert len(val) == 3 and [len(b) for b in val._indices()] == [3, 3, 1]


def _train_cli(tmp_path, max_epoch):
    run_net_main(["--device", "cpu", "--cfg", YAML, "--opts", *NARROW, *PLAIN,
                  "TPU.COMPUTE_DTYPE", "float32", "TRAIN.DATASET", "syntheticvideo",
                  "DATA.SYNTHETIC_SIZE", "4", "SOLVER.MAX_EPOCH", str(max_epoch),
                  "TEST.ENABLE", "False", "OUTPUT_DIR", str(tmp_path)])
    lines = (tmp_path / "json_stats.log").read_text().splitlines()
    return [json.loads(line.split("json_stats: ")[1]) for line in lines]


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """``run_net --device cpu`` training one epoch, then auto-resuming for a
    second one in the same OUTPUT_DIR."""
    out = tmp_path_factory.mktemp("train")
    first = _train_cli(out, 1)
    both = _train_cli(out, 2)
    return out, first, both[len(first):]


def test_run_net_trains_and_auto_resumes(trained):
    out, first, second = trained
    assert [s["_type"] for s in first] == ["train_epoch", "val_epoch"]
    assert first[0]["epoch"] == "1/1" and np.isfinite(first[0]["loss"])
    assert "top1_err" in first[1]
    # The second run resumes after epoch 1: it trains epoch 2 only.
    assert [(s["_type"], s["epoch"]) for s in second] == [("train_epoch", "2/2"),
                                                          ("val_epoch", "2/2")]
    names = sorted(os.listdir(out / "checkpoints"))
    assert names == ["checkpoint_epoch_00001.pyth", "checkpoint_epoch_00002.pyth"]
    ckpt = torch.load(out / "checkpoints" / names[-1], weights_only=True)
    assert ckpt["epoch"] == 1 and ckpt["optimizer_state"]["count"] == 4
    assert set(ckpt) == {"epoch", "model_state", "optimizer_state", "cfg"}


def test_saved_checkpoint_loads_into_jax(trained, variables):
    """The port's ``model_state`` through the JAX package's
    ``load_torch_checkpoint_dict`` gives the port's eval output."""
    out, _, _ = trained
    sd = torch.load(out / "checkpoints" / "checkpoint_epoch_00002.pyth",
                    weights_only=True)["model_state"]
    jcfg = narrow_cfg(jax_get_cfg, "float32", PLAIN)
    new_vars, missing, unexpected = load_torch_checkpoint_dict(sd, variables, strict=True)
    assert not missing and not unexpected
    state = TrainState(step=0, params=new_vars["params"], batch_stats={}, opt_state=None)
    x = clips(9)
    want = jax_make_eval_step(jcfg, jax_build_model(jcfg))(state, {"inputs": [jnp.asarray(x)]})
    cfg = narrow_cfg(get_cfg, "float32", PLAIN)
    model = build_model(cfg, device="cpu")
    model.load_state_dict(sd, strict=True)
    got = make_eval_step(cfg, model)({"inputs": [torch.from_numpy(x)]})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_jax_native_checkpoint_raises(tmp_path, variables):
    """A pickle the JAX package wrote (``format`` ``slowfast_tpu.*``) is
    refused, and read without running code from the file."""
    import pickle

    from slowfast_tpu_torch.solver.optimizer import construct_optimizer
    from slowfast_tpu_torch.utils.checkpoint import load_train_checkpoint

    path = tmp_path / "jax.pyth"
    with open(path, "wb") as f:
        pickle.dump({"epoch": 0, "model_state": b"", "format": "slowfast_tpu.msgpack.v1"}, f)
    cfg = narrow_cfg(get_cfg, extra=["TRAIN.CHECKPOINT_FILE_PATH", str(path),
                                     "OUTPUT_DIR", str(tmp_path)])
    model = port_model(variables)
    with pytest.raises(NotImplementedError, match="JAX-package checkpoint"):
        load_train_checkpoint(cfg, model, construct_optimizer(model, cfg))


def test_training_records_no_kernel_launch_on_the_cpu(trained):
    assert attention_ops.flash_bwd_launches == attention_ops.exact_bwd_launches == 0


def test_unported_training_options_raise(tmp_path):
    from slowfast_tpu_torch.engine.trainer import train

    # Chunked csvs (DATA.LOADER_CHUNK_SIZE) are ported: tests/test_torch_ddp_misc.py;
    # TENSORBOARD.ENABLE, which had raised, too: tests/test_torch_tensorboard.py.
    # The pipeline-parallel axis is not (ROADMAP Queue 1 #10).
    for extra in (["TPU.PIPELINE_PARTITIONS", "2"],):
        cfg = assert_and_infer_cfg(narrow_cfg(get_cfg, extra=extra + ["OUTPUT_DIR", str(tmp_path)]))
        with pytest.raises(NotImplementedError):
            train(cfg, device="cpu")
