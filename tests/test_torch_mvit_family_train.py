"""Training the rest of the MViT family in the port against the JAX
package, on the CPU, on the narrow MViTv1 and ViT of
tests/test_torch_mvit_family.py (whose models and helpers this file
shares): one train step's loss and gradients against ``jax.grad``, as
tests/test_torch_train_parity.py holds MViTv2-S's (fp32 within 1e-5 + 1e-4
relative; bf16 as close to JAX's fp32 gradients as JAX's own bf16 ones,
within 1.5 times, relative L2); ``MODEL.DETACH_FINAL_FC``;
``MODEL.ACT_CHECKPOINT`` against JAX's ``nn.remat`` step, and, with drop
path and dropout on, checkpointed gradients bit-equal to the
uncheckpointed ones from the same generator state (a recompute that drew
new masks would differ); ``MVIT.DROPOUT_RATE`` at each of its sites; the
weight bridge for every new parameter; the optimizer's partition of the
new parameters.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from slowfast_tpu.config import get_cfg as jax_get_cfg
from slowfast_tpu.models import build_model as jax_build_model
from slowfast_tpu.solver import losses as jlosses
from slowfast_tpu.solver import optimizer as joptim
from slowfast_tpu.utils.checkpoint import load_torch_checkpoint_dict
from slowfast_tpu_torch.config import get_cfg
from slowfast_tpu_torch.models import common as tcommon
from slowfast_tpu_torch.models.attention import MultiScaleAttention
from slowfast_tpu_torch.solver import losses as tlosses
from slowfast_tpu_torch.solver import optimizer as toptim
from slowfast_tpu_torch.utils.checkpoint import state_dict_from_jax
from test_torch_mvit_family import (ATOL, DETECTION, RTOL, V1, V2, VIT, clips, jit_run,
                                    jax_variables, make_cfg, port_model)
from test_torch_train import one_torch_thread, port_name  # noqa: F401  (fixture)

# Deterministic training: no mixup, drop path or dropout.
PLAIN = ["MIXUP.ENABLE", "False", "MVIT.DROPPATH_RATE", "0.0", "MODEL.DROPOUT_RATE", "0.0",
         "MVIT.DROPOUT_RATE", "0.0"]


def jax_grads(model_name, dtype, extra=()):
    """JAX's loss and gradients (``jax.grad``) of one train step of the
    family model ``model_name`` on ``train_batch``, in the port's names."""
    return _jax_grads(model_name, dtype, tuple(extra))


@functools.lru_cache(maxsize=None)
def _jax_grads(model_name, dtype, extra):
    base = FAMILY[model_name]
    variables = jax_variables(base)
    cfg = make_cfg(jax_get_cfg, base, dtype, list(PLAIN) + list(extra))
    model = jax_build_model(cfg)
    x, y = train_batch(base)

    def loss_fn(params):
        preds = model.apply({"params": params}, [jnp.asarray(x)], train=True,
                            rngs={"dropout": jax.random.PRNGKey(0)})
        return jlosses.soft_cross_entropy(preds, jnp.asarray(y))

    loss, grads = jit_run(jax.value_and_grad(loss_fn), variables["params"])
    return float(loss), state_dict_from_jax({"params": jax.tree.map(np.asarray, grads)})


def port_grads(model_name, dtype, extra=()):
    base = FAMILY[model_name]
    model = port_model(jax_variables(base), base, dtype, list(PLAIN) + list(extra))
    model.train()
    x, y = train_batch(base)
    loss = tlosses.soft_cross_entropy(model([torch.from_numpy(x)]), torch.from_numpy(y))
    loss.backward()
    return loss.item(), {n: p.grad for n, p in model.named_parameters()}


FAMILY = {"mvitv1": V1, "vit": VIT}


def train_batch(base, n=2):
    x = clips(make_cfg(get_cfg, base), n=n)
    return x, np.random.RandomState(3).randint(0, 16, (n,)).astype(np.int64)


def structurally_zero(name, depth):
    """Zero in exact arithmetic: a bias on every key shifts a logit row by a
    constant (``norm_k.bias``); the last block's q pool acts only on the
    non-cls query rows, which do not reach the head."""
    return name.endswith("norm_k.bias") or name.startswith(f"blocks.{depth - 1}.attn.pool_q.")


def _flat(grads, names):
    return torch.cat([grads[n].flatten() for n in names])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("model_name", ["mvitv1", "vit"])
def test_train_gradients_match_jax_grad(model_name, dtype):
    """fp32: loss within 1e-5, every gradient within 1e-5 + 1e-4 relative.
    bf16: the port's gradients as close to JAX's fp32 ones as JAX's own bf16
    gradients are (relative L2 over all parameters, within 1.5 times)."""
    want_loss, want = jax_grads(model_name, "float32")
    loss, got = port_grads(model_name, dtype)
    depth = make_cfg(get_cfg, FAMILY[model_name]).MVIT.DEPTH
    for name, g in got.items():
        assert g is not None and (structurally_zero(name, depth) or g.abs().max() > 0), name
    if dtype == "float32":
        np.testing.assert_allclose(loss, want_loss, rtol=1e-5)
        for name, g in got.items():
            np.testing.assert_allclose(g.numpy(), want[name].numpy(), atol=ATOL, rtol=RTOL,
                                       err_msg=name)
        return
    _, jax_bf16 = jax_grads(model_name, "bfloat16")
    np.testing.assert_allclose(loss, want_loss, rtol=2e-2)
    names = [n for n in got if not structurally_zero(n, depth)]
    scale = _flat(want, names).norm()
    port_err = (_flat(got, names) - _flat(want, names)).norm() / scale
    jax_err = (_flat(jax_bf16, names) - _flat(want, names)).norm() / scale
    assert port_err <= 1.5 * jax_err, (port_err, jax_err)


def test_detach_final_fc_stops_the_gradient_at_the_head():
    """``MODEL.DETACH_FINAL_FC``: only the head's projection has a gradient,
    equal to JAX's; JAX's gradients of every other parameter are zero."""
    extra = ["MODEL.DETACH_FINAL_FC", "True"]
    want_loss, want = jax_grads("mvitv1", "float32", extra)
    loss, got = port_grads("mvitv1", "float32", extra)
    np.testing.assert_allclose(loss, want_loss, rtol=1e-5)
    head = {"head.projection.weight", "head.projection.bias"}
    for name, g in got.items():
        if name in head:
            assert g.abs().max() > 0
            np.testing.assert_allclose(g.numpy(), want[name].numpy(), atol=ATOL, rtol=RTOL)
        else:
            assert g is None, name
            assert not want[name].any(), name


def test_act_checkpoint_matches_jax_remat():
    """``MODEL.ACT_CHECKPOINT`` (drop path 0): the port's checkpointed step
    against JAX's ``nn.remat`` step, fp32."""
    extra = ["MODEL.ACT_CHECKPOINT", "True"]
    want_loss, want = jax_grads("mvitv1", "float32", extra)
    assert port_model(jax_variables(V1), V1, "float32", extra).act_checkpoint
    loss, got = port_grads("mvitv1", "float32", extra)
    np.testing.assert_allclose(loss, want_loss, rtol=1e-5)
    for name, g in got.items():
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), atol=ATOL, rtol=RTOL,
                                   err_msg=name)


def _stochastic_steps(act_checkpoint, rates, steps=2):
    """Two fp32 forward and backward passes in train mode with drop path,
    dropout and head dropout at ``rates`` from one generator; returns each
    pass's loss and gradients, and the generator's state after them."""
    droppath, drop, head_drop = rates
    extra = ["MIXUP.ENABLE", "False", "MVIT.DROPPATH_RATE", str(droppath),
             "MVIT.DROPOUT_RATE", str(drop), "MODEL.DROPOUT_RATE", str(head_drop),
             "MODEL.ACT_CHECKPOINT", str(act_checkpoint)]
    model = port_model(jax_variables(V1), V1, "float32", extra)
    gen = torch.Generator().manual_seed(5)
    for m in model.modules():
        if hasattr(m, "generator"):
            m.generator = gen
    model.train()
    x, y = train_batch(V1)
    out = []
    for _ in range(steps):
        for p in model.parameters():
            p.grad = None
        loss = tlosses.soft_cross_entropy(model([torch.from_numpy(x)]), torch.from_numpy(y))
        loss.backward()
        out.append((loss.item(), {n: p.grad.clone() for n, p in model.named_parameters()}))
    return out, gen.get_state()


def test_act_checkpoint_gradients_bit_equal_with_drop_path_and_dropout():
    """Drop path 0.3, ``MVIT.DROPOUT_RATE`` 0.1 and head dropout 0.5: the
    checkpointed fp32 gradients are bit-equal to the uncheckpointed ones
    from the same generator state, over two steps, and the generator ends
    in the same state. (``torch.utils.checkpoint`` restores only the global
    RNG states; a recompute that drew from the model's generator afresh
    would apply other masks in the backward.)"""
    rates = (0.3, 0.1, 0.5)
    plain, plain_gen = _stochastic_steps(False, rates)
    ckpt, ckpt_gen = _stochastic_steps(True, rates)
    assert torch.equal(plain_gen, ckpt_gen)
    for (loss_a, grads_a), (loss_b, grads_b) in zip(plain, ckpt):
        assert loss_a == loss_b
        for name in grads_a:
            assert torch.equal(grads_a[name], grads_b[name]), name
    # The masks were drawn and differ from step to step.
    deterministic, _ = _stochastic_steps(False, (0.0, 0.0, 0.0), steps=1)
    assert plain[0][0] != deterministic[0][0] and plain[0][0] != plain[1][0]


# --- dropout -----------------------------------------------------------------

def test_mvit_dropout_draws_from_the_generator():
    """``MVIT.DROPOUT_RATE`` (after the stem, the attention projection and
    in the MLP): in train mode at rate 0.1 the output depends on the
    generator (equal for equal seeds, unequal otherwise); at rate 0 it
    equals JAX's train-mode output, with or without a generator."""
    variables = jax_variables(V1)
    x = torch.from_numpy(clips(make_cfg(get_cfg, V1)))

    def train_out(rate, seed):
        extra = list(PLAIN[:-2]) + ["MVIT.DROPOUT_RATE", str(rate)]
        model = port_model(variables, V1, "float32", extra)
        for m in model.modules():
            if hasattr(m, "generator"):
                m.generator = torch.Generator().manual_seed(seed)
        model.train()
        with torch.no_grad():
            return model([x])

    a, b, c = train_out(0.1, 0), train_out(0.1, 0), train_out(0.1, 1)
    assert torch.equal(a, b) and not torch.allclose(a, c)
    jcfg = make_cfg(jax_get_cfg, V1, extra=PLAIN)
    model = jax_build_model(jcfg)
    want = jit_run(lambda v, x: model.apply(v, [x], train=True,
                                            rngs={"dropout": jax.random.PRNGKey(0)}),
                   variables, jnp.asarray(x.numpy()))
    for seed in (0, 1):
        np.testing.assert_allclose(train_out(0.0, seed).numpy(), np.asarray(want),
                                   atol=ATOL, rtol=RTOL)


def test_mlp_and_attention_dropout_sites():
    """The Mlp drops after the GELU and after fc2, the attention after its
    projection (JAX models/common.py:236-246, attention.py:525), each mask
    drawn from the module's generator in that order."""
    torch.manual_seed(0)
    mlp = tcommon.Mlp(8, 16, 8, drop_rate=0.25)
    mlp.train()
    mlp.generator = torch.Generator().manual_seed(3)
    x = torch.randn(2, 5, 8)
    got = mlp(x)
    gen = torch.Generator().manual_seed(3)
    h = tcommon.dropout(tcommon.gelu_exact(tcommon.linear(x, mlp.fc1, torch.float32)), 0.25, gen)
    want = tcommon.dropout(tcommon.linear(h, mlp.fc2, torch.float32), 0.25, gen)
    assert torch.equal(got, want)

    attn = MultiScaleAttention(8, 8, (1, 2, 2), num_heads=2, drop_rate=0.25)
    attn.generator = torch.Generator().manual_seed(4)
    x = torch.randn(2, 5, 8)
    attn.eval()
    clean, _ = attn(x, [1, 2, 2])
    attn.train()
    got, _ = attn(x, [1, 2, 2])
    keep = torch.rand(clean.shape, generator=torch.Generator().manual_seed(4)) < 0.75
    assert torch.equal(got, torch.where(keep, clean / 0.75, torch.zeros(())))


BRIDGE_CASES = {
    "separable_pos": (V1, []),
    "joint_pos": (V1, ["MVIT.SEP_POS_EMBED", "False"]),
    "norm_stem_separate_qkv": (V1, ["MVIT.NORM_STEM", "True", "MVIT.SEPARATE_QKV", "True"]),
    "pool_first": (V1, ["MVIT.POOL_FIRST", "True"]),
    "conv_unshared": (V1, ["MVIT.MODE", "conv_unshared"]),
    "vit": (VIT, []),
    "detection": (V2, DETECTION),
}
# PySlowFast's state_dict names of the new parameters, each present in one
# of the cases above.
NEW_NAMES = {"pos_embed_spatial", "pos_embed_temporal", "pos_embed_class", "pos_embed",
             "norm_stem.weight", "norm_stem.bias", "blocks.0.attn.q.weight",
             "blocks.0.attn.k.bias", "blocks.0.attn.v.weight", "blocks.1.attn.pool_q.weight",
             "head.projection.weight"}


def test_bridge_round_trip_covers_every_new_parameter():
    """JAX variables -> ``state_dict_from_jax`` -> the port (strict) -> its
    ``state_dict`` -> the JAX package's ``load_torch_checkpoint_dict``
    (strict) gives the variables back, for every new parameter."""
    seen = set()
    for base, extra in BRIDGE_CASES.values():
        variables = jax_variables(base, extra)
        model = port_model(variables, base, "float32", extra)
        sd = model.state_dict()
        seen |= set(sd)
        zeros = jax.tree.map(np.zeros_like, variables)
        back, missing, unexpected = load_torch_checkpoint_dict(sd, zeros, strict=True)
        assert not missing and not unexpected
        flat_want = traverse_util.flatten_dict(variables["params"])
        flat_got = traverse_util.flatten_dict(back["params"])
        assert flat_got.keys() == flat_want.keys()
        for path, v in flat_want.items():
            np.testing.assert_array_equal(flat_got[path], v, err_msg=str(path))
    assert NEW_NAMES <= seen, NEW_NAMES - seen
    model = port_model(jax_variables(*BRIDGE_CASES["conv_unshared"]), V1, "float32",
                       BRIDGE_CASES["conv_unshared"][1])
    # conv_unshared: a tap per channel and a norm over the whole width.
    assert model.blocks[1].attn.pool_q.weight.shape[0] == model.blocks[1].attn.dim_out
    assert model.blocks[1].attn.norm_q.normalized_shape == (model.blocks[1].attn.dim_out,)


@pytest.mark.parametrize("base,extra", [
    (VIT, ["SOLVER.LAYER_DECAY", "0.65"]),  # the ViT-B FT recipe
    (VIT, ["SOLVER.LAYER_DECAY", "0.65", "MVIT.ZERO_DECAY_POS_CLS", "True"]),
    (V1, ["MVIT.ZERO_DECAY_POS_CLS", "True", "SOLVER.LAYER_DECAY", "0.75"]),
    (V1, ["MVIT.ZERO_DECAY_POS_CLS", "True", "MVIT.SEP_POS_EMBED", "False",
          "MVIT.NORM_STEM", "True"]),
], ids=["vit_ft", "vit_zero_decay_pos_cls", "mvitv1_separable", "mvitv1_joint_norm_stem"])
def test_param_scales_match_jax(base, extra):
    """``ZERO_DECAY_POS_CLS`` and ``LAYER_DECAY`` name the pos-embeds,
    ``norm_stem`` and the head as JAX's solver/optimizer.py:49-84 does."""
    variables = jax_variables(base, extra)
    wd_tree, scale_tree = joptim.build_param_scales(variables["params"],
                                                    make_cfg(jax_get_cfg, base, extra=extra))
    wd = traverse_util.flatten_dict(wd_tree)
    scale = traverse_util.flatten_dict(scale_tree)
    want = {port_name(p): (wd[p], scale[p]) for p in wd}
    got = toptim.build_param_scales(port_model(variables, base, "float32", extra),
                                    make_cfg(get_cfg, base, extra=extra))
    assert got == pytest.approx(want)
