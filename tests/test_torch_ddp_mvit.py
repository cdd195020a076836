"""Data-parallel training of narrow MViTv2-S (4 blocks, width 16, 4 frames
of 56², tests/test_torch_train.py's ``NARROW``, every parameter seeded
random) with MixUp and CutMix on, on 2 gloo ranks on the CPU: 3 fp32 SGD
steps on global batches of 4 clips.

The JAX package mixes inside its step, on the global batch: row i with row
G-1-i, with one draw of λ and of the box a step
(slowfast_tpu/engine/steps.py:80-90). Each port rank mixes its rows with
the flipped rows of its mirror rank, which it receives from it. Both
packages take JAX's draws here: the JAX step's own (``jax.random``, from
its key and step), handed to the port's ``mix_draws`` (the key is the
first whose three steps take both CutMix and MixUp).

* Against JAX's ``make_train_step`` on a 2-device mesh, each port step
  from JAX's state: the loss within rtol 1e-5, the parameters after each
  step within 1e-4 relative L2.
* Against the port in one process on the global batch, each 2-rank step
  from its state: the loss, gradients and parameters within 1e-6, in fp32
  (the port's MViT takes its norms and GELU in fp32, so it has no float64
  step to decide a miss by).
"""

import pytest

from ddp_harness import check_one_process, port_cfg
from ddp_harness import one_torch_thread  # noqa: F401  (autouse fixture)
from test_torch_ddp import SGD, spawn_cases, uint8_batches

CLIPS = 4
MIX = ["MIXUP.ENABLE", "True", "MIXUP.ALPHA", "0.8", "MIXUP.CUTMIX_ALPHA", "1.0",
       "MIXUP.PROB", "1.0", "MIXUP.SWITCH_PROB", "0.5", "MIXUP.LABEL_SMOOTH_VALUE", "0.1",
       "MVIT.DROPPATH_RATE", "0.0", "MODEL.DROPOUT_RATE", "0.0"]


def mvit():
    from test_torch_train import NARROW, YAML

    return YAML, NARROW + SGD + MIX + ["TRAIN.BATCH_SIZE", str(CLIPS)]


def mixed_seed(cfg, batches):
    """The first key whose steps take both CutMix and MixUp."""
    import jax

    from test_torch_train import jax_draws

    mix = cfg.MIXUP
    for seed in range(100):
        kinds = set()
        for i, b in enumerate(batches):
            rng, _ = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(seed), i))
            x = b["inputs"][-1]
            kinds.add(jax_draws(rng, x.shape[2], x.shape[3], mix.ALPHA, mix.CUTMIX_ALPHA,
                                mix.PROB, mix.SWITCH_PROB)["use_cutmix"])
        if kinds == {True, False}:
            return seed
    raise AssertionError("no key takes both")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from ddp_jax import jax_cfg, jax_variables, mesh_run

    yaml, opts = mvit()
    jcfg = jax_cfg(opts, yaml)
    batches = uint8_batches(port_cfg(opts, yaml), 16, 9)
    jax_run = mesh_run(jcfg, jax_variables(jcfg, 17), batches, seed=mixed_seed(jcfg, batches))
    assert {d["use_cutmix"] for d in jax_run["draws"]} == {True, False}
    extra = {"yaml": yaml, "draws": jax_run["draws"]}
    return spawn_cases(tmp_path_factory.mktemp("mvit"),
                       {"mvit": (opts, batches, jax_run, extra)}, float64=False)["mvit"]


def test_two_ranks_with_mixup_match_jax_on_a_two_device_mesh(runs):
    from ddp_jax import check_jax_steps

    assert check_jax_steps(runs["jax"], runs["jax_run"]) > 1e-4


def test_two_ranks_with_mixup_match_one_process(runs):
    check_one_process(runs["one"], runs["one_process"], runs["one64"], runs["one_process64"])
