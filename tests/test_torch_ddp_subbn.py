"""Sub-batch BN (``BN.NORM_TYPE sub_batchnorm``) under data parallelism, on
the CPU. The JAX package splits the *global* batch into ``BN.NUM_SPLITS``
contiguous groups (slowfast_tpu/models/batchnorm.py:73-76); the port over
W ranks keeps whole splits on a rank when W divides the split count, and
reduces each split over its ``W / NUM_SPLITS`` ranks when the split count
divides W.

* Narrow Slow R18 (width 8, 8 frames of 64², every parameter and BN
  statistic seeded random), 3 fp32 SGD steps on global batches of 8 clips
  over 2 gloo ranks, with ``NUM_SPLITS`` 4 (two splits a rank) and 1 (one
  split over both ranks): against JAX's step on a 2-device mesh, each step
  from JAX's state (loss within rtol 1e-5, parameters and BN statistics
  within 1e-4 relative L2), and against the port in one process on the
  global batch (within 1e-6, a fp32 miss decided in float64, as in
  tests/test_torch_ddp.py).
* One ``BatchNorm3D`` on 4 ranks, in float64: 2 splits (each over 2
  ranks, a subgroup) and 4 splits (one a rank) against the same module in
  one process on the global batch: outputs, input and parameter
  gradients, running statistics; and so the SSL heads' ``BatchNorm1D`` in
  training, with the global batch's statistics. 3 splits over 4 ranks
  raise.
"""

import os

import numpy as np
import pytest
import torch

from ddp_harness import check_one_process, launch, port_cfg
from ddp_harness import one_torch_thread  # noqa: F401  (autouse fixture)
from test_torch_ddp import SGD, spawn_cases, uint8_batches

CLIPS = 8
SLOW = ["MODEL.MODEL_NAME", "ResNet", "MODEL.ARCH", "slow", "RESNET.DEPTH", "18",
        "RESNET.WIDTH_PER_GROUP", "8", "RESNET.NUM_BLOCK_TEMP_KERNEL", "[[2],[2],[2],[2]]",
        "DATA.NUM_FRAMES", "8", "DATA.TRAIN_CROP_SIZE", "64", "MODEL.NUM_CLASSES", "16",
        "DATA.INPUT_CHANNEL_NUM", "[3]", "BN.NORM_TYPE", "sub_batchnorm"]
SPLITS = (4, 1)


def opts(splits):
    return SLOW + SGD + ["BN.NUM_SPLITS", str(splits), "TRAIN.BATCH_SIZE", str(CLIPS)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from ddp_jax import jax_cfg, jax_variables, mesh_run

    cases = {}
    for splits in SPLITS:
        jcfg = jax_cfg(opts(splits))
        batches = uint8_batches(port_cfg(opts(splits)), 16, 7, clips=CLIPS)
        cases[splits] = (opts(splits), batches, mesh_run(jcfg, jax_variables(jcfg, 13), batches),
                         {})
    return spawn_cases(tmp_path_factory.mktemp("subbn"), cases)


@pytest.mark.parametrize("splits", SPLITS)
def test_two_ranks_match_jax_on_a_two_device_mesh(runs, splits):
    from ddp_jax import check_jax_steps

    assert check_jax_steps(runs[splits]["jax"], runs[splits]["jax_run"]) > 1e-4


@pytest.mark.parametrize("splits", SPLITS)
def test_two_ranks_match_one_process(runs, splits):
    r = runs[splits]
    check_one_process(r["one"], r["one_process"], r["one64"], r["one_process64"])


# --- one BN on 4 ranks -------------------------------------------------------

BN_SHAPE = (8, 2, 3, 3, 5)  # (B, T, H, W, C)


def bn_inputs():
    rng = np.random.RandomState(3)
    return (rng.normal(1.0, 2.0, BN_SHAPE), rng.normal(0.0, 1.0, BN_SHAPE),
            rng.uniform(0.5, 1.5, BN_SHAPE[-1]), rng.normal(0.0, 0.1, BN_SHAPE[-1]))


def bn_step(splits, x, dy, weight, bias):
    """One training forward and backward of a float64 ``BatchNorm3D``: its
    output, the input's and parameters' gradients (summed over the ranks)
    and its running statistics."""
    from slowfast_tpu_torch.models.batchnorm import BatchNorm3D
    from slowfast_tpu_torch.utils import distributed as du

    bn = BatchNorm3D(x.shape[-1], num_splits=splits).double()
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(weight))
        bn.bias.copy_(torch.from_numpy(bias))
    x = torch.from_numpy(x).requires_grad_(True)
    y = bn(x)
    y.backward(torch.from_numpy(dy))
    grads = [bn.weight.grad, bn.bias.grad]
    du.all_reduce(grads, "sum")
    return {"y": y.detach(), "dx": x.grad, "dweight": grads[0], "dbias": grads[1],
            "mean": bn.running_mean, "var": bn.running_var}


def bn1d_step(x, dy, weight, bias):
    """``bn_step`` for the SSL heads' ``BatchNorm1D`` on the rows of
    ``x``."""
    from slowfast_tpu_torch.models.batchnorm import BatchNorm1D
    from slowfast_tpu_torch.utils import distributed as du

    c = x.shape[-1]
    bn = BatchNorm1D(c).double()
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(weight))
        bn.bias.copy_(torch.from_numpy(bias))
    x = torch.from_numpy(x.reshape(-1, c)).requires_grad_(True)
    y = bn(x)
    y.backward(torch.from_numpy(dy.reshape(-1, c)))
    grads = [bn.weight.grad, bn.bias.grad]
    du.all_reduce(grads, "sum")
    return {"y": y.detach(), "dx": x.grad, "dweight": grads[0], "dbias": grads[1],
            "mean": bn.running_mean, "var": bn.running_var}


def rank_bn(out_dir, device):
    from slowfast_tpu_torch.utils import distributed as du

    x, dy, weight, bias = bn_inputs()
    n = x.shape[0] // du.get_world_size()
    rows = slice(du.get_rank() * n, (du.get_rank() + 1) * n)
    out = {s: bn_step(s, x[rows], dy[rows], weight, bias) for s in (2, 4)}
    try:
        bn_step(3, x[rows], dy[rows], weight, bias)
    except ValueError as e:
        out["three"] = str(e)
    out["bn1d"] = bn1d_step(x[rows], dy[rows], weight, bias)
    torch.save(out, os.path.join(out_dir, f"bn{du.get_rank()}.pt"))


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("bn")
    launch(out, rank_bn, str(out), world=4)
    return [torch.load(out / f"bn{r}.pt", weights_only=False) for r in range(4)]


def test_split_bn_over_four_ranks_matches_one_process(four_ranks):
    ranks = four_ranks
    x, dy, weight, bias = bn_inputs()
    for splits in (2, 4):
        want = bn_step(splits, x, dy, weight, bias)
        for key in ("y", "dx"):
            got = torch.cat([r[splits][key] for r in ranks])
            torch.testing.assert_close(got, want[key], rtol=1e-12, atol=1e-12)
        for r in ranks:
            for key in ("dweight", "dbias", "mean", "var"):
                torch.testing.assert_close(r[splits][key], want[key], rtol=1e-12, atol=1e-12)
    assert all("NUM_SPLITS 3" in r["three"] for r in ranks)


def test_mlp_head_bn_raises_over_several_ranks(four_ranks):
    # The SSL heads' BatchNorm1D, which had raised over several ranks, takes
    # the global batch's statistics: on 4 ranks what it computes in one
    # process on the global batch.
    x, dy, weight, bias = bn_inputs()
    want = bn1d_step(x, dy, weight, bias)
    for key in ("y", "dx"):
        got = torch.cat([r["bn1d"][key] for r in four_ranks])
        torch.testing.assert_close(got, want[key], rtol=1e-12, atol=1e-12)
    for r in four_ranks:
        for key in ("dweight", "dbias", "mean", "var"):
            torch.testing.assert_close(r["bn1d"][key], want[key], rtol=1e-12, atol=1e-12)
