"""The InstDisc 1-D memory bank under data parallelism: the port's SSL step on
2 gloo ranks against the JAX package's ``make_ssl_train_step`` on a 2-device
``data`` mesh, with the checks of ``tests/ssl_ddp_jax.py``. One JAX
configuration a file (its mesh step compiles in about 13 s).

* ``mem``: JAX's NCE grid of the global batch, each rank's rows of it,
  and the bank's writes at the gathered clip ids.
"""

import pytest

from test_torch_train import one_torch_thread  # noqa: F401  (autouse fixture)

CASES = {"mem": ("mem", [])}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from ssl_ddp_jax import run_cases

    return run_cases(tmp_path_factory.mktemp("ssl_ddp"), CASES)


@pytest.mark.parametrize("name", sorted(CASES))
def test_two_ranks_match_jax_on_a_two_device_mesh(runs, name):
    from ssl_ddp_jax import check_case

    check_case(name, *runs[name])
