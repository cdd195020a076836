"""The weight bridge between the JAX package and the port, and the
synthetic dataset both packages read.

``state_dict_from_jax`` turns the JAX ``{"params", "batch_stats"}`` tree
into the port's ``state_dict`` (reference PySlowFast names); the JAX
package's own torch importer, ``load_torch_checkpoint_dict``, must map that
``state_dict`` back onto the JAX tree exactly.
"""

import os

import jax
import numpy as np
import pytest
import torch
from flax import traverse_util

from slowfast_tpu.config import get_cfg as jax_get_cfg
from slowfast_tpu.data.kinetics import Syntheticvideo as JaxSyntheticvideo
from slowfast_tpu.models import build_model as jax_build_model
from slowfast_tpu.models.build import init_model
from slowfast_tpu.utils.checkpoint import load_torch_checkpoint_dict
from slowfast_tpu_torch.config import get_cfg
from slowfast_tpu_torch.data.kinetics import Syntheticvideo
from slowfast_tpu_torch.models.build import build_model
from slowfast_tpu_torch.utils.checkpoint import load_test_checkpoint, state_dict_from_jax

YAML = os.path.join(os.path.dirname(__file__), "..", "configs", "Kinetics",
                    "SLOWFAST_4x16_R50.yaml")
MVIT_YAML = os.path.join(os.path.dirname(__file__), "..", "configs", "Kinetics",
                         "MVITv2_S_16x4.yaml")


def _cfg(get, depth):
    cfg = get()
    cfg.merge_from_file(YAML)
    blocks = "[[2,2],[2,2],[2,2],[2,2]]" if depth == 18 else "[[3,3],[4,4],[6,6],[3,3]]"
    cfg.merge_from_list([
        "RESNET.DEPTH", str(depth), "RESNET.WIDTH_PER_GROUP", "8",
        "RESNET.NUM_BLOCK_TEMP_KERNEL", blocks, "DATA.NUM_FRAMES", "8",
        "SLOWFAST.ALPHA", "4", "DATA.TRAIN_CROP_SIZE", "32", "DATA.TEST_CROP_SIZE", "32",
        "MODEL.NUM_CLASSES", "16", "NUM_GPUS", "1", "TPU.COMPUTE_DTYPE", "float32",
    ])
    return cfg


def _mvit_cfg(get):
    """MViTv2-S at depth 4 and width 16, with a stage transition (dim and
    heads double, q stride 2) and layer scale, so gamma_1/gamma_2 exist."""
    cfg = get()
    cfg.merge_from_file(MVIT_YAML)
    cfg.merge_from_list([
        "MVIT.DEPTH", "4", "MVIT.EMBED_DIM", "16", "MVIT.DIM_MUL", "[[1,2.0],[3,2.0]]",
        "MVIT.HEAD_MUL", "[[1,2.0],[3,2.0]]", "MVIT.POOL_Q_STRIDE", "[[1,1,2,2],[3,1,2,2]]",
        "MVIT.LAYER_SCALE_INIT_VALUE", "0.1", "DATA.NUM_FRAMES", "4",
        "DATA.TRAIN_CROP_SIZE", "56", "DATA.TEST_CROP_SIZE", "56",
        "MODEL.NUM_CLASSES", "16", "NUM_GPUS", "1", "TPU.COMPUTE_DTYPE", "float32",
    ])
    return cfg


def _jax_variables(depth, seed):
    """Seeded values in the JAX variable tree of the narrow model (shaped by
    a traced init, never run), and a zero tree of the same shapes."""
    cfg = _cfg(jax_get_cfg, depth) if depth else _mvit_cfg(jax_get_cfg)
    model = jax_build_model(cfg)
    shapes = jax.eval_shape(
        lambda: init_model(model, cfg, rng=jax.random.PRNGKey(0), train=False))
    rng = np.random.RandomState(seed)
    flat = traverse_util.flatten_dict(dict(shapes))
    values = {p: rng.normal(size=s.shape).astype(np.float32) for p, s in flat.items()}
    zeros = {p: np.zeros(s.shape, np.float32) for p, s in flat.items()}
    return traverse_util.unflatten_dict(values), traverse_util.unflatten_dict(zeros)


def _port_cfg(depth):
    return _cfg(get_cfg, depth) if depth else _mvit_cfg(get_cfg)


@pytest.fixture(scope="module", params=[18, 50, 0], ids=["r18", "r50", "mvit"])
def bridged(request):
    """SlowFast at depth 18 and 50, and MViTv2-S cut to depth 4 (depth 0)."""
    depth = request.param
    variables, zeros = _jax_variables(depth, depth)
    model = build_model(_port_cfg(depth), device="cpu")
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    return variables, zeros, model, depth


def test_state_dict_loads_strict_with_every_value(bridged):
    variables, _, model, depth = bridged
    sd = model.state_dict()
    if not depth:
        _check_mvit_names(variables, sd)
        return
    flat = traverse_util.flatten_dict(variables["params"])
    conv = sd["s2.pathway0_res0.branch2.a.weight"].numpy()
    np.testing.assert_array_equal(
        conv, flat[("s2", "pathway0_res0", "branch2", "a", "kernel")].transpose(4, 3, 0, 1, 2))
    np.testing.assert_array_equal(sd["head.projection.weight"].numpy(),
                                  flat[("head", "projection", "kernel")].T)
    np.testing.assert_array_equal(
        sd["s1.pathway1_stem.bn.running_var"].numpy(),
        variables["batch_stats"]["s1"]["pathway1_stem"]["bn"]["var"])


def _check_mvit_names(variables, sd):
    """PySlowFast's MViT names, with the layouts of its torch modules."""
    flat = traverse_util.flatten_dict(variables["params"])
    for name, path, layout in [
        ("patch_embed.proj.weight", ("patch_embed", "proj", "kernel"), (4, 3, 0, 1, 2)),
        ("cls_token", ("cls_token",), None),
        ("blocks.0.attn.qkv.weight", ("blocks_0", "attn", "qkv", "kernel"), (1, 0)),
        ("blocks.1.attn.pool_q.weight", ("blocks_1", "attn", "pool_q", "kernel"),
         (4, 3, 0, 1, 2)),
        ("blocks.1.attn.norm_q.weight", ("blocks_1", "attn", "norm_q", "scale"), None),
        ("blocks.1.attn.rel_pos_h", ("blocks_1", "attn", "rel_pos_h"), None),
        ("blocks.2.attn.rel_pos_t", ("blocks_2", "attn", "rel_pos_t"), None),
        ("blocks.1.proj.weight", ("blocks_1", "proj", "kernel"), (1, 0)),
        ("blocks.3.gamma_2", ("blocks_3", "gamma_2"), None),
        ("blocks.0.mlp.fc1.weight", ("blocks_0", "mlp", "fc1", "kernel"), (1, 0)),
        ("norm.weight", ("norm", "scale"), None),
        ("head.projection.weight", ("head", "projection", "kernel"), (1, 0)),
    ]:
        want = flat[path] if layout is None else flat[path].transpose(layout)
        np.testing.assert_array_equal(sd[name].numpy(), want, err_msg=name)
    # Block 1 has 2 heads of 16: the pool kernel is (d, 1, kt, kh, kw).
    assert sd["blocks.1.attn.pool_q.weight"].shape == (16, 1, 3, 3, 3)


def test_round_trip_through_jax_importer(bridged):
    """Port state_dict -> JAX load_torch_checkpoint_dict gives the JAX
    variables back exactly, with nothing missing or unexpected."""
    variables, zeros, model, _ = bridged
    new_vars, missing, unexpected = load_torch_checkpoint_dict(model.state_dict(), zeros)
    assert missing == [] and unexpected == []
    for col in ("params", "batch_stats"):
        want = traverse_util.flatten_dict(variables.get(col, {}))
        got = traverse_util.flatten_dict(new_vars[col])
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(np.asarray(got[k]), want[k], err_msg=str(k))


def test_load_test_checkpoint_reads_reference_pyth(bridged, tmp_path):
    """A reference-style .pyth (extra top-level entries) loads with no name
    mapping; the model then holds the bridged values."""
    _, _, model, depth = bridged
    path = tmp_path / "ref.pyth"
    torch.save({"epoch": 196, "model_state": model.state_dict(),
                "optimizer_state": {}, "cfg": "MODEL: {}"}, path)
    cfg = _port_cfg(depth)
    cfg.TEST.CHECKPOINT_FILE_PATH = str(path)
    fresh = build_model(cfg, device="cpu")
    load_test_checkpoint(cfg, fresh)
    for k, v in model.state_dict().items():
        assert torch.equal(fresh.state_dict()[k], v), k


@pytest.mark.parametrize("mode,views,crops", [("test", 2, 3), ("test", 1, 1), ("train", 1, 1)])
def test_synthetic_video_same_bytes_and_labels(mode, views, crops):
    extra = ["DATA.SYNTHETIC_SIZE", "3", "TEST.NUM_ENSEMBLE_VIEWS", str(views),
             "TEST.NUM_SPATIAL_CROPS", str(crops), "DATA.TEST_CROP_SIZE", "24"]
    jcfg, tcfg = _cfg(jax_get_cfg, 18), _cfg(get_cfg, 18)
    jcfg.merge_from_list(extra)
    tcfg.merge_from_list(extra)
    jds, tds = JaxSyntheticvideo(jcfg, mode), Syntheticvideo(tcfg, mode)
    assert len(jds) == len(tds) and jds.num_videos == tds.num_videos
    for i in range(len(jds)):
        (jin, jlab, jidx, _, _), (tin, tlab, tidx, _, _) = jds[i], tds[i]
        assert len(jin) == len(tin) == 1
        np.testing.assert_array_equal(tin[0], jin[0])
        assert tin[0].dtype == np.uint8
        assert (tlab, tidx) == (jlab, jidx)
