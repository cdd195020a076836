"""MoCo under data parallelism: the port's SSL step on 2 gloo ranks against
the JAX package's ``make_ssl_train_step`` on a 2-device ``data`` mesh
(slowfast_tpu/engine/ssl_steps.py:80), on the CPU, with the checks of
``tests/ssl_ddp_jax.py``: three steps a case, each from JAX's weights,
optimizer state, SSL state and global batch, the ranks on their rows.

* ``moco``: the plain step (eval-mode keys, the queue gets the global
  batch's keys in JAX's row order; step 0 is the warm-up);
* ``two_hosts``: the plain step in the rank layout of ``NUM_SHARDS 2,
  NUM_GPUS 1`` (each rank the rows ``batch[r::2]`` of the loader's
  batch): the global batch JAX assembles from the hosts' rows
  (slowfast_tpu/parallel/mesh.py:228) is in rank order, so the queue
  takes the keys in that order; JAX's run is the plain case's;
* the kNN probe of the MoCo state on 2 ranks, on val batches of 8 and 5
  clips (the last padded for the ranks), equal to one process's.

The other types and options are in tests/test_torch_ssl_ddp_*.py, one JAX
configuration a file. The ranks run once for the file; JAX is imported
inside the fixture.
"""

import pytest

from test_torch_train import one_torch_thread  # noqa: F401  (autouse fixture)

CASES = ("moco", "two_hosts")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from ssl_ddp_harness import spawned_cases
    from ssl_ddp_jax import mesh_case

    moco, jax_run = mesh_case("moco", [], knn=True)
    two_hosts = {k: v for k, v in moco.items() if not k.startswith("knn")}
    cases = {"moco": moco, "two_hosts": dict(two_hosts, num_shards=2)}
    return cases, jax_run, spawned_cases(tmp_path_factory.mktemp("ssl_ddp"), cases)


@pytest.mark.parametrize("name", sorted(CASES))
def test_two_ranks_match_jax_on_a_two_device_mesh(runs, name):
    from ssl_ddp_jax import check_case

    cases, jax_run, ranks = runs
    check_case(name, cases[name], jax_run, ranks)


def test_knn_probe_on_two_ranks_equals_one_process(runs):
    from ssl_ddp_harness import knn_run

    cases, _, ranks = runs
    one = knn_run(cases["moco"])
    assert ranks[0][("moco", "knn")] == ranks[1][("moco", "knn")] == one
    assert 0 < one < 100
