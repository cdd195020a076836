"""The port's zoo-verification tool against the JAX package's
(tools/verify_zoo.py), on the CPU.

Every ``ZOO`` entry's eval config from ``build_cfg`` equals JAX's key by key
(the port's schema adds ``INIT_METHOD``, its launcher's rendezvous, and
nothing else). The protocol of tests/test_verify_zoo.py:29 (a narrow C2D on
the synthetic dataset, 2 views of 4 videos; with ``DATA.TRAIN_CROP_SIZE``
64 beside its test crop of 64, so that the head's pool, sized from the
train crop, fits the 2 x 2 map: at 224 the JAX head averages an empty
window and the port's refuses it) runs through both testers on
one PySlowFast ``.pyth`` of the port's seeded model, which both load: the
same top-1 and top-5, and the tool's JSON line and exit code.
"""

import json

import numpy as np
import pytest
import torch

from slowfast_tpu_torch.models.build import build_model
from slowfast_tpu_torch.verify_zoo import ZOO, build_cfg, main
from tools.verify_zoo import ZOO as JAX_ZOO
from tools.verify_zoo import build_cfg as jax_build_cfg

PORT_ONLY = {"INIT_METHOD"}


def flat(node, prefix=""):
    out = {}
    for k, v in dict(node).items():
        if isinstance(v, dict):
            out.update(flat(v, prefix + k + "."))
        else:
            out[prefix + k] = v
    return out


def test_zoo_table_is_jax_s():
    assert ZOO == JAX_ZOO


@pytest.mark.parametrize("name", sorted(ZOO))
def test_build_cfg_matches_jax(name):
    got = flat(build_cfg(name, "ckpt.pyth", "/data"))
    want = flat(jax_build_cfg(name, "ckpt.pyth", "/data"))
    assert set(got) - set(want) == PORT_ONLY and not set(want) - set(got)
    assert {k: got[k] for k in want} == want


def protocol_opts(tmp_path):
    return ["RESNET.DEPTH", "18", "RESNET.NUM_BLOCK_TEMP_KERNEL", "[[2],[2],[2],[2]]",
            "DATA.NUM_FRAMES", "4", "DATA.TEST_CROP_SIZE", "64", "DATA.TRAIN_CROP_SIZE", "64",
            "TEST.DATASET",
            "syntheticvideo", "DATA.SYNTHETIC_SIZE", "4", "TEST.NUM_ENSEMBLE_VIEWS", "2",
            "TEST.NUM_SPATIAL_CROPS", "1", "MODEL.NUM_CLASSES", "16", "TPU.COMPUTE_DTYPE",
            "float32", "OUTPUT_DIR", str(tmp_path), "DATA_LOADER.NUM_WORKERS", "0",
            "TEST.CHECKPOINT_TYPE", "pytorch"]


def test_protocol_matches_jax(tmp_path, capsys):
    from slowfast_tpu.engine.tester import test as jax_test

    name = "C2D_NOPOOL_8x8_R50"
    ckpt = str(tmp_path / "c2d.pyth")
    cfg = build_cfg(name, ckpt, str(tmp_path), batch=4, opts=protocol_opts(tmp_path))
    torch.save({"model_state": build_model(cfg, device="cpu").state_dict()}, ckpt)
    want = jax_test(jax_build_cfg(name, ckpt, str(tmp_path), batch=4,
                                  opts=protocol_opts(tmp_path)))[0]
    rc = main(["--model", name, "--ckpt", ckpt, "--data-dir", str(tmp_path), "--batch", "4",
               "--device", "cpu", "--tolerance", "100", "--opts", *protocol_opts(tmp_path)])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and line["pass"] and line["model"] == name
    assert np.isfinite(line["top1"])
    assert line["top1"] == pytest.approx(float(want["top1_acc"]), abs=1e-9)
    assert line["top5"] == pytest.approx(float(want["top5_acc"]), abs=1e-9)
    assert line["delta_top1"] == round(line["top1"] - ZOO[name]["top1"], 2)
    assert main(["--model", name, "--ckpt", ckpt, "--data-dir", str(tmp_path), "--batch", "4",
                 "--device", "cpu", "--tolerance", "0", "--opts",
                 *protocol_opts(tmp_path)]) == 1
