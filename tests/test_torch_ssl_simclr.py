"""The simclr 3-step trajectory against JAX ``make_ssl_train_step`` on the
CPU, held as tests/test_torch_ssl_train.py (whose helpers it shares) holds
moco's: each step from JAX's state with JAX's draws, the fp32 step against
JAX's, the float64 steps against each other, and a flip decided by JAX's
float64 step.
"""

import pytest

from test_torch_ssl_train import STEPS, TYPES, check_trajectory
from test_torch_train import one_torch_thread  # noqa: F401  (autouse fixture)


@pytest.mark.parametrize("ssl_type", ["simclr"])
def test_three_step_trajectory_matches_jax(ssl_type, monkeypatch):
    check_trajectory(ssl_type, TYPES[ssl_type], monkeypatch, STEPS)
