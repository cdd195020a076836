"""MoCo's shuffle-BN under data parallelism: the port's SSL step on 2 gloo
ranks against the JAX package's ``make_ssl_train_step`` on a 2-device
``data`` mesh, with the checks of ``tests/ssl_ddp_jax.py``. One JAX
configuration a file (its mesh step compiles in about 13 s).

* ``shuffle_bn``: MoCo with the multi-view queue under ``sub_batchnorm`` in
  2 splits (width 32, as tests/test_torch_ssl_shuffle_bn.py: the JAX
  package runs narrower stages T-folded, whose BN ignores the splits). The
  key views are gathered, JAX's permutations of the global batch (the
  loss's keys and the queue's) injected, each rank encodes its rows of
  the permuted batch (one split a rank), and the keys are gathered and put
  back in order. One step, MoCo's queue warm-up (no update), as the
  one-process shuffle-BN test takes it: on this narrow model, train-mode
  BN over 4 clips a split makes the keys that an updated encoder writes
  chaotic in fp32 in both packages (9.5e-5 from float64 in the port's run,
  6.5e-4 in JAX's, after an update; 0.06 a step later).
"""

import pytest

from test_torch_train import one_torch_thread  # noqa: F401  (autouse fixture)

CASES = {"shuffle_bn": ("moco", ["CONTRASTIVE.MOCO_MULTI_VIEW_QUEUE", "True",
                         "BN.NORM_TYPE", "sub_batchnorm", "BN.NUM_SPLITS", "2",
                         "RESNET.WIDTH_PER_GROUP", "32"])}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from ssl_ddp_jax import run_cases

    return run_cases(tmp_path_factory.mktemp("ssl_ddp"), CASES, num_steps=1)


@pytest.mark.parametrize("name", sorted(CASES))
def test_two_ranks_match_jax_on_a_two_device_mesh(runs, name):
    from ssl_ddp_jax import check_case

    check_case(name, *runs[name])
