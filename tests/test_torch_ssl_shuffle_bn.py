"""Shuffle-BN in the port's MoCo step under ``sub_batchnorm``, on the CPU,
with the helpers of tests/test_torch_ssl_train.py: one step against JAX
``make_ssl_train_step`` with JAX's two permutations injected (the loss's
keys and the multi-view queue's), and what the keys are: the momentum
encoder's train-mode output on the permuted batch, put back in order, its
statistics left as they were.
"""

from unittest import mock

import torch

from slowfast_tpu_torch.engine import ssl_steps as tsteps
from slowfast_tpu_torch.models import contrastive as tcon
from test_torch_contrastive import clips
from test_torch_ssl_train import TYPES, check_trajectory, port_state
from test_torch_train import one_torch_thread  # noqa: F401  (autouse fixture)


def test_shuffle_bn_under_sub_batchnorm_matches_jax(monkeypatch):
    """MoCo with ``sub_batchnorm`` in 2 splits: both key batches (the loss's
    and the multi-view queue's) on JAX's permutations, one step. At width
    32: the JAX package runs stages whose inner width is under 32 T-folded,
    and its folded BN ignores the splits (ROADMAP Queue 3)."""
    sub = ["BN.NORM_TYPE", "sub_batchnorm", "BN.NUM_SPLITS", "2", "RESNET.WIDTH_PER_GROUP", "32"]
    check_trajectory("moco", TYPES["moco"] + sub, monkeypatch, 1)


def test_shuffle_bn_keys_are_the_shuffled_batch_unshuffled():
    """The keys are the momentum encoder's train-mode output on the permuted
    batch, put back in the batch's order; its statistics stay as they were."""
    cfg, model, opt, ssl, step = port_state("moco", ["BN.NORM_TYPE", "sub_batchnorm",
                                                     "BN.NUM_SPLITS", "2"])
    assert step.shuffle_bn
    x = [torch.from_numpy(clips(7))]
    kept = [b.clone() for b in ssl.hist.buffers()]
    perm = torch.tensor([5, 2, 7, 0, 1, 6, 3, 4])
    with mock.patch.object(tsteps, "shuffle_permutation", lambda n, g: perm):
        keys = step.encode_keys(x)
    assert all(torch.equal(a, b) for a, b in zip(ssl.hist.buffers(), kept))
    ssl.hist.train()
    with torch.no_grad():
        want = tcon.l2_normalize(ssl.hist([x[0][perm]]))[torch.argsort(perm)]
    for a, b in zip(ssl.hist.buffers(), kept):
        a.copy_(b)
    torch.testing.assert_close(keys, want)
    with torch.no_grad():
        plain = tcon.l2_normalize(ssl.hist.train()([x[0]]))
    assert not torch.allclose(keys, plain, atol=1e-4), "the splits must see other clips"
