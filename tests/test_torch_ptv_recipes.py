"""The pytorchvideo recipes of configs/Kinetics/pytorchvideo through the
port's ``run_net`` on the CPU.

* The ten recipes that set ``TENSORBOARD.ENABLE`` (every one but the X3D
  and MViT recipes) train as shipped, narrowed (depth 18, width 8, 8
  frames of 32², ``syntheticvideo`` clips): one epoch of one step with
  the recipe's precise BN, the val epoch and the checkpoint, a finite
  loss, and one event file holding the scalars the JAX trainer writes
  (tests/test_torch_tensorboard.py holds their values against it).
* ``MVIT_B_16x4_CONV``'s ``PTVMViT`` builds at full size (on the meta
  device) with the parameters of configs/Kinetics/MVIT_B_16x4_CONV.yaml,
  whose only difference is the model's name.
"""

import json
import os

import numpy as np
import pytest
import torch

from test_torch_train import one_torch_thread  # noqa: F401  (autouse fixture)

PTV = os.path.join(os.path.dirname(__file__), "..", "configs", "Kinetics", "pytorchvideo")
TB_RECIPES = sorted(f for f in os.listdir(PTV)
                    if "TENSORBOARD: {ENABLE: true}" in open(os.path.join(PTV, f)).read())
NARROW = ["RESNET.DEPTH", "18", "RESNET.WIDTH_PER_GROUP", "8",
          "RESNET.NUM_BLOCK_TEMP_KERNEL", "[[2, 2], [2, 2], [2, 2], [2, 2]]",
          "DATA.NUM_FRAMES", "8", "DATA.TRAIN_CROP_SIZE", "32", "DATA.TEST_CROP_SIZE", "32",
          "MODEL.NUM_CLASSES", "6", "TRAIN.DATASET", "syntheticvideo",
          "TEST.DATASET", "syntheticvideo", "DATA.SYNTHETIC_SIZE", "2", "TRAIN.BATCH_SIZE", "2",
          "SOLVER.MAX_EPOCH", "1", "TEST.ENABLE", "False", "NUM_GPUS", "1",
          "DATA_LOADER.NUM_WORKERS", "1", "TPU.COMPUTE_DTYPE", "float32"]


def test_the_ten_recipes_set_tensorboard():
    assert len(TB_RECIPES) == 10 and not any(r.startswith(("X3D", "MVIT")) for r in TB_RECIPES)


@pytest.mark.parametrize("yaml", TB_RECIPES)
def test_run_net_trains_the_recipe_with_tensorboard(yaml, tmp_path):
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    from slowfast_tpu_torch.run_net import main

    main(["--device", "cpu", "--cfg", os.path.join(PTV, yaml), "--opts", *NARROW,
          "OUTPUT_DIR", str(tmp_path)])
    with open(tmp_path / "json_stats.log") as f:
        stats = [json.loads(line.split("json_stats: ", 1)[1]) for line in f]
    (epoch,) = [s for s in stats if s["_type"] == "train_epoch"]
    assert np.isfinite(epoch["loss"]) and any(s["_type"] == "val_epoch" for s in stats)
    assert os.path.exists(tmp_path / "checkpoints" / "checkpoint_epoch_00001.pyth")
    log_dir = tmp_path / "runs-syntheticvideo"
    assert len([f for f in os.listdir(log_dir) if f.startswith("events.out")]) == 1
    acc = EventAccumulator(str(log_dir))
    acc.Reload()
    assert sorted(acc.Tags()["scalars"]) == ["Train/Top1_err", "Train/Top5_err", "Train/loss",
                                             "Train/lr", "Val/top1_err", "Val/top5_err"]
    assert acc.Scalars("Train/loss")[0].value == pytest.approx(epoch["loss"], rel=1e-4)


def test_ptvmvit_recipe_builds_as_mvit():
    from slowfast_tpu_torch.config import get_cfg
    from slowfast_tpu_torch.models.build import MODEL_REGISTRY

    shapes = []
    for yaml in (os.path.join(PTV, "MVIT_B_16x4_CONV.yaml"),
                 os.path.join(PTV, "..", "MVIT_B_16x4_CONV.yaml")):
        cfg = get_cfg()
        cfg.merge_from_file(yaml)
        with torch.device("meta"):
            model = MODEL_REGISTRY[cfg.MODEL.MODEL_NAME](cfg)
        shapes.append({n: tuple(p.shape) for n, p in model.state_dict().items()})
    assert cfg.MODEL.MODEL_NAME == "MViT" and shapes[0] == shapes[1]
    assert sum(np.prod(s) for s in shapes[0].values()) > 3e7
