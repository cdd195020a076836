"""The port's ROIAlign and RoI head against the JAX package's, on the CPU.

``roi_align_plain`` (the JAX gather form in PyTorch, which the CUDA kernels
are held to on the card by ``chip_smoke.py``) against
``slowfast_tpu.ops.roi_align.roi_align`` in both of its formulations
(``impl="matmul"``, the default, and ``impl="gather"``), forward and VJP,
on the AVA main path's geometry and on every edge of the rules: a 16 x 16
and a 16 x 28 map, ``aligned=False`` (the ROI's side at least 1), a bin
wider than ``max_samples`` feature pixels (the grid cap binds), boxes past
the map, a fixed ``sampling_ratio``, odd channel counts and bf16
features. Tolerances: each framework sums in fp32 in its own order, so
outputs within 1e-5 of max |out| and gradients within 1e-5 of max |grad|;
with bf16 features both round their fp32 gradient to bf16 once, so an
element may round the other way: within one bf16 rounding (2^-8) of max
|grad|. The positions round as XLA computes them (a fused multiply-add,
and 1/P for the division by P), so the port's sample grid is JAX's bit for
bit.

The RoI head's forward and its gradients (features and projection)
against ``ResNetRoIHead`` on the same weights, with padded zero boxes,
whose 49 bins sample one pixel each: a tie in the bin max, which both
frameworks split evenly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slowfast_tpu.models.heads import ResNetRoIHead as JaxRoIHead
from slowfast_tpu.ops.roi_align import roi_align as jax_roi_align
from slowfast_tpu_torch.models.heads import ResNetRoIHead
from slowfast_tpu_torch.ops import roi_align as ra
from slowfast_tpu_torch.utils.checkpoint import state_dict_from_jax

TOL = 1e-5


def ava_rois(rs, B, M, crop, n_real=None):
    """Padded ROIs as the RoI head builds them: the synthetic sampler's boxes
    (corner in [0, crop/2), sides in [2, crop/2 + 2)), zero rows past each
    clip's count."""
    rois = np.zeros((B, M, 5), np.float32)
    rois[:, :, 0] = np.arange(B)[:, None]
    for b in range(B):
        n = M if n_real is None else n_real[b]
        xy1 = rs.rand(n, 2) * (crop / 2)
        wh = rs.rand(n, 2) * (crop / 2) + 2.0
        rois[b, :n, 1:] = np.concatenate([xy1, xy1 + wh], axis=1)
    return rois.reshape(B * M, 5)


def case(name):
    """``(feats, rois, kwargs)`` of one edge case."""
    rs = np.random.RandomState(CASES.index(name))
    kw = dict(output_size=7, spatial_scale=1.0 / 16, sampling_ratio=0, aligned=True)
    if name == "ava_14x14":  # the main path at small C: 224 crop, res5 at 1/16
        feats = rs.randn(3, 14, 14, 8)
        rois = ava_rois(rs, 3, 4, 224, n_real=[4, 2, 1])
    elif name == "map_16x16":  # a 256 crop at 1/16
        feats = rs.randn(2, 16, 16, 6)
        rois = ava_rois(rs, 2, 4, 256)
    elif name == "map_16x28":  # non-square
        feats = rs.randn(2, 16, 28, 5)
        rois = ava_rois(rs, 2, 4, 448)
        rois[:, [2, 4]] = np.minimum(rois[:, [2, 4]], 256)
    elif name == "unaligned":  # the side at least 1, tiny boxes included
        feats = rs.randn(2, 14, 14, 4)
        rois = ava_rois(rs, 2, 4, 224)
        rois[1, 3:] = rois[1, 1:3] + 3.0
        kw["aligned"] = False
    elif name == "cap_binds":  # bins of 6-9 feature pixels: grid capped at 4
        feats = rs.randn(2, 64, 64, 4)
        rois = np.array([[0, 0.0, 0.0, 1024.0, 1024.0], [1, 30.0, 50.0, 900.0, 1000.0],
                         [0, 100.0, 0.0, 800.0, 700.0]], np.float32)
    elif name == "past_the_map":  # corners outside [-1, H]: zero samples
        feats = rs.randn(2, 14, 14, 4)
        rois = np.array([[0, -60.0, -40.0, 100.0, 90.0], [1, 150.0, 170.0, 300.0, 320.0],
                         [1, -200.0, 10.0, -20.0, 50.0], [0, 230.0, 230.0, 260.0, 250.0]],
                        np.float32)
    elif name == "sampling_ratio_2":
        feats = rs.randn(2, 9, 11, 3)
        rois = ava_rois(rs, 2, 3, 160)
        kw.update(output_size=5, spatial_scale=1.0 / 8, sampling_ratio=2)
    elif name == "c3":
        feats = rs.randn(2, 14, 14, 3)
        rois = ava_rois(rs, 2, 4, 224)
    elif name == "c257":
        feats = rs.randn(1, 7, 7, 257)
        rois = ava_rois(rs, 1, 4, 112)
    elif name == "bf16":
        feats = rs.randn(2, 14, 14, 8)
        rois = ava_rois(rs, 2, 4, 224, n_real=[3, 4])
    else:
        raise KeyError(name)
    feats = feats.astype(np.float32)
    if name == "bf16":
        feats = np.asarray(torch.from_numpy(feats).bfloat16().float())
    return feats, rois.astype(np.float32), kw


CASES = ["ava_14x14", "map_16x16", "map_16x28", "unaligned", "cap_binds", "past_the_map",
         "sampling_ratio_2", "c3", "c257", "bf16"]


def close(got, want, tol=TOL):
    got, want = (np.asarray(x, np.float64) for x in (got, want))
    err = np.abs(got - want).max()
    return err <= tol * max(np.abs(want).max(), 1e-30), err


@pytest.mark.parametrize("impl", ["matmul", "gather"])
@pytest.mark.parametrize("name", CASES)
def test_plain_forward_and_vjp_match_jax(name, impl):
    feats, rois, kw = case(name)
    dtype = torch.bfloat16 if name == "bf16" else torch.float32
    g = np.random.RandomState(5).randn(rois.shape[0], kw["output_size"], kw["output_size"],
                                       feats.shape[-1]).astype(np.float32)
    jdtype = jnp.bfloat16 if name == "bf16" else jnp.float32
    want, vjp = jax.vjp(lambda f: jax_roi_align(f, jnp.asarray(rois), impl=impl, **kw),
                        jnp.asarray(feats, jdtype))
    (want_grad,) = vjp(jnp.asarray(g))
    assert want_grad.dtype == jdtype
    f = torch.from_numpy(feats).to(dtype).requires_grad_(True)
    got = ra.roi_align(f, torch.from_numpy(rois), **kw)
    assert got.dtype == torch.float32 and ra.launches == 0
    ok, err = close(got.detach().numpy(), np.asarray(want))
    assert ok, (name, impl, err)
    got.backward(torch.from_numpy(g))
    assert f.grad.dtype == dtype
    ok, err = close(f.grad.float().numpy(), np.asarray(want_grad, np.float32),
                    2.0 ** -8 if name == "bf16" else TOL)
    assert ok, (name, impl, err)
    if name == "cap_binds":  # the cap decides these bins: uncapped differs
        wide = ra.roi_align_plain(torch.from_numpy(feats), torch.from_numpy(rois),
                                  max_samples=16, **kw)
        assert not torch.allclose(wide, got.detach(), atol=1e-3)


def test_ragged_rois_per_batch_lists():
    """The backward kernel's per-batch lists of ROIs in any order: each
    batch's rows in ascending order, delimited by the offsets."""
    rois = torch.tensor([[2, 0, 0, 1, 1], [0, 0, 0, 1, 1], [2, 0, 0, 1, 1], [1, 0, 0, 1, 1],
                         [0, 0, 0, 1, 1]], dtype=torch.float32)
    order, offsets = ra.batch_lists(rois, 4)
    assert order.tolist() == [1, 4, 3, 0, 2] and offsets.tolist() == [0, 2, 3, 5, 5]
    assert order.dtype == offsets.dtype == torch.int32


def test_kernel_arguments_are_checked():
    feats = torch.zeros(1, 4, 4, 2)
    with pytest.raises(ValueError):
        ra.roi_align(feats, torch.zeros(3, 4))
    with pytest.raises(ValueError):
        ra.roi_align(feats.to("meta"), torch.zeros(3, 5, device="meta"))


def head_variables(dim_in, num_classes, seed):
    rs = np.random.RandomState(seed)
    return {"params": {"projection": {
        "kernel": rs.normal(0, 0.3, (sum(dim_in), num_classes)).astype(np.float32),
        "bias": rs.normal(0, 0.1, (num_classes,)).astype(np.float32)}}}


@pytest.mark.parametrize("layout", ["padded", "ragged"])
@pytest.mark.parametrize("act", ["sigmoid", "softmax"])
def test_roi_head_matches_jax(act, layout):
    """Two pathways (T 2 and 8, C 12 and 4), 7 x 7 bins at 1/16: the
    forward in training (the activation applies) and the gradients of the
    features and the projection; the padded zero boxes make ties in the
    bin max, which both split evenly."""
    rs = np.random.RandomState(3)
    dim_in, K = [12, 4], 6
    xs = [rs.randn(2, 2, 14, 14, 12).astype(np.float32),
          rs.randn(2, 8, 14, 14, 4).astype(np.float32)]
    boxes = ava_rois(rs, 2, 4, 224, n_real=[2, 3]).reshape(2, 4, 5)
    bboxes = boxes[..., 1:] if layout == "padded" else boxes.reshape(8, 5)
    v = head_variables(dim_in, K, 4)
    jhead = JaxRoIHead(dim_in=dim_in, num_classes=K, pool_size=[[2, 1, 1], [8, 1, 1]],
                       resolution=[[7, 7]] * 2, scale_factor=[16, 16], act_func=act,
                       dtype=jnp.float32)
    g = rs.rand(8, K).astype(np.float32)

    def jfwd(params, a, b):
        return jhead.apply({"params": params}, [a, b], jnp.asarray(bboxes), train=True)

    want, vjp = jax.vjp(jfwd, v["params"], *[jnp.asarray(x) for x in xs])
    want_p, *want_x = vjp(jnp.asarray(g))

    head = ResNetRoIHead(dim_in=dim_in, num_classes=K, resolution=[[7, 7]] * 2,
                         scale_factor=[16, 16], act_func=act)
    head.load_state_dict(state_dict_from_jax(v), strict=True)
    head.train()
    tx = [torch.from_numpy(x).requires_grad_(True) for x in xs]
    got = head(tx, torch.from_numpy(bboxes))
    got.backward(torch.from_numpy(g))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=1e-6)
    for t, w in zip(tx, want_x):
        ok, err = close(t.grad.numpy(), np.asarray(w))
        assert ok, err
    want_sd = state_dict_from_jax({"params": want_p})
    for n, p in head.named_parameters():
        ok, err = close(p.grad.numpy(), want_sd[n].numpy())
        assert ok, (n, err)
    # The padded zero rows sample one pixel in all 49 bins: every bin ties.
    zero = ra.roi_align_plain(torch.from_numpy(xs[0]).mean(1), torch.from_numpy(
        boxes.reshape(8, 5))[[3, 7]])
    assert torch.equal(zero, zero[:, :1, :1].expand_as(zero))
