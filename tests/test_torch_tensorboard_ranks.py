"""TensorBoard in the port's ``run_net`` on 2 gloo ranks on the CPU, on the
config and start of tests/test_torch_tensorboard.py (which holds the one
process's event file against the JAX trainer's): the master alone writes,
one event file, and it equals the one process's: the same scalar tags at
the same steps, the values within 1e-4 (the ranks' metrics are averaged
over them), the same figures (the val epoch's predictions gathered from
both ranks).
"""

import pytest

from test_torch_tensorboard import assert_same_events, init_checkpoint, no_tensorflow, port_run
from test_torch_train import one_torch_thread  # noqa: F401  (autouse fixture)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    no_tensorflow()
    root = tmp_path_factory.mktemp("tensorboard_ranks")
    init = init_checkpoint(root)
    return port_run(root, init, 1), port_run(root, init, 2)


def test_two_ranks_write_the_one_process_events(runs):
    one, two = runs
    assert_same_events(two, one)
