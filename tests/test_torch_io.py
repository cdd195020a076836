"""The port's pluggable file IO (utils/io.py) against the JAX package's
(slowfast_tpu/utils/io.py and tests/test_io.py), on the CPU: handler
routing, the in-memory blob store's contract (the copy-and-delete
``replace`` that remote stores take), the fsspec bridge and the refusal
without it, longest-prefix routing, the checkpoint save / scan / resume
cycle and a Kinetics list file on a mock remote URI, and a ``run_net``
train whose ``OUTPUT_DIR`` is a registered memory store, auto-resuming
from it."""

import json
import os
import tempfile

import pytest
import torch

from slowfast_tpu.utils.io import MemoryPathHandler as JaxMemoryPathHandler
from slowfast_tpu.utils.io import PathManager as JaxPathManager
from slowfast_tpu_torch.config import assert_and_infer_cfg, get_cfg
from slowfast_tpu_torch.models.build import build_model
from slowfast_tpu_torch.run_net import main as run_net_main
from slowfast_tpu_torch.solver.optimizer import construct_optimizer
from slowfast_tpu_torch.utils import checkpoint as cu
from slowfast_tpu_torch.utils.io import (FsspecPathHandler, LocalPathHandler, MemoryPathHandler,
                                         PathManager, pathmgr)


@pytest.fixture
def mock_remote():
    handler = MemoryPathHandler()
    pathmgr.register_handler("mock://", handler)
    try:
        yield handler
    finally:
        pathmgr._handlers.pop("mock://", None)


def test_local_routing_and_ops():
    pm = PathManager()
    with tempfile.TemporaryDirectory() as tmp:
        p = os.path.join(tmp, "sub", "x.txt")
        pm.mkdirs(os.path.dirname(p))
        with pm.open(p, "w") as f:
            f.write("hello")
        assert pm.exists(p) and pm.isdir(os.path.dirname(p))
        assert pm.ls(os.path.dirname(p)) == ["x.txt"]
        with pm.open(p) as f:
            assert f.read() == "hello"
        q = os.path.join(tmp, "sub", "y.txt")
        pm.replace(p, q)
        assert not pm.exists(p) and pm.exists(q)
        pm.rm(q)
        assert not pm.exists(q)
        assert isinstance(pm._route(q), LocalPathHandler)


@pytest.mark.parametrize("impl", ["port", "jax"])
def test_memory_handler_contract(impl):
    """The same operations give the same store in both packages."""
    pm, handler = ((PathManager(), MemoryPathHandler()) if impl == "port"
                   else (JaxPathManager(), JaxMemoryPathHandler()))
    pm.register_handler("mock://", handler)
    base = "mock://bucket/dir"
    with pm.open(f"{base}/a.bin", "wb") as f:
        f.write(b"\x00\x01")
    with pm.open(f"{base}/b.txt", "w") as f:
        f.write("line1\n")
    with pm.open(f"{base}/b.txt", "a") as f:
        f.write("line2\n")
    assert pm.exists(f"{base}/a.bin") and not pm.exists(f"{base}/missing")
    assert pm.isdir(base) and pm.ls(base) == ["a.bin", "b.txt"]
    with pm.open(f"{base}/a.bin", "rb") as f:
        assert f.read() == b"\x00\x01"
    with pm.open(f"{base}/b.txt") as f:
        assert f.read().splitlines() == ["line1", "line2"]
    pm.replace(f"{base}/a.bin", f"{base}/c.bin")
    assert pm.ls(base) == ["b.txt", "c.bin"]
    with pytest.raises(FileNotFoundError):
        pm.open(f"{base}/a.bin", "rb")
    assert handler._blobs == {f"{base}/b.txt": b"line1\nline2\n", f"{base}/c.bin": b"\x00\x01"}


def test_unknown_scheme_bridges_or_raises(monkeypatch):
    """With fsspec a ``scheme://`` URI without a handler goes through it (its
    ``memory://`` store here); without fsspec it raises."""
    pytest.importorskip("fsspec")
    pm = PathManager()
    assert isinstance(pm._route("memory://bucket/x"), FsspecPathHandler)
    with pm.open("memory://bucket/x.txt", "w") as f:
        f.write("via fsspec")
    with pm.open("memory://bucket/x.txt") as f:
        assert f.read() == "via fsspec"
    assert pm.exists("memory://bucket/x.txt") and "x.txt" in pm.ls("memory://bucket")
    bare = PathManager()
    monkeypatch.setattr(bare, "_try_fsspec", lambda: None)
    with pytest.raises(ValueError, match="no PathHandler"):
        bare.open("weird://bucket/x", "r")
    with pytest.raises(ValueError, match="scheme"):
        bare.register_handler("noscheme", MemoryPathHandler())


def test_longest_prefix_wins():
    pm = PathManager()
    general, specific = MemoryPathHandler(), MemoryPathHandler()
    pm.register_handler("mock://", general)
    pm.register_handler("mock://special/", specific)
    with pm.open("mock://special/f", "w") as f:
        f.write("s")
    assert "mock://special/f" in specific._blobs and not general._blobs


def _tiny_cfg(out_dir):
    cfg = get_cfg()
    cfg.merge_from_list(["MODEL.MODEL_NAME", "ResNet", "MODEL.ARCH", "c2d",
                         "MODEL.NUM_CLASSES", "8", "RESNET.DEPTH", "18",
                         "RESNET.NUM_BLOCK_TEMP_KERNEL", "[[2], [2], [2], [2]]",
                         "RESNET.WIDTH_PER_GROUP", "8", "DATA.NUM_FRAMES", "4",
                         "DATA.TRAIN_CROP_SIZE", "32", "DATA.INPUT_CHANNEL_NUM", "[3]",
                         "TPU.COMPUTE_DTYPE", "float32", "OUTPUT_DIR", out_dir,
                         "SOLVER.WARMUP_EPOCHS", "0.0", "NUM_GPUS", "1"])
    return assert_and_infer_cfg(cfg)


def test_checkpoint_roundtrip_through_mock_remote(mock_remote):
    job = "mock://bucket/run1"
    cfg = _tiny_cfg(job)
    model = build_model(cfg, device="cpu")
    optimizer = construct_optimizer(model, cfg)
    path = cu.save_checkpoint(job, model, optimizer, 3, cfg)
    assert path.startswith("mock://bucket/run1/checkpoints/")
    assert all(not k.endswith(".tmp") for k in mock_remote._blobs)  # atomic publish
    assert cu.has_checkpoint(job) and cu.get_last_checkpoint(job) == path
    cfg.RNG_SEED = 9
    fresh = build_model(cfg, device="cpu")
    fresh_opt = construct_optimizer(fresh, cfg)
    cfg.TRAIN.AUTO_RESUME = True
    assert cu.load_train_checkpoint(cfg, fresh, fresh_opt) == 4
    for (name, a), b in zip(model.state_dict().items(), fresh.state_dict().values()):
        assert torch.equal(a, b), name


def test_dataset_list_via_mock_remote(mock_remote):
    from slowfast_tpu_torch.data.kinetics import Kinetics

    root = "mock://data/k400"
    with pathmgr.open(f"{root}/train.csv", "w") as f:
        f.write("/videos/a.mp4 0\n/videos/b.mp4 3\n")
    cfg = _tiny_cfg("/tmp")
    cfg.DATA.PATH_TO_DATA_DIR = root
    cfg.DATA.PATH_PREFIX = ""
    ds = Kinetics(cfg, "train")
    assert len(ds._path_to_videos) == 2 and ds._labels[1] == 3


def test_run_net_on_memory_output_dir(mock_remote, tmp_path):
    """``run_net`` trains a narrow C2D with its ``OUTPUT_DIR`` on the memory
    store (checkpoint, ``json_stats.log``), then a second run resumes from
    the store's checkpoint; nothing is written to the local disk."""
    out = "mock://bucket/job"
    cwd = os.getcwd()
    os.chdir(tmp_path)
    try:
        for max_epoch in (1, 2):
            run_net_main(["--device", "cpu", "--cfg",
                          os.path.join(cwd, "configs", "Kinetics", "C2D_8x8_R50.yaml"),
                          "--opts", "RESNET.DEPTH", "18", "RESNET.WIDTH_PER_GROUP", "8",
                          "RESNET.NUM_BLOCK_TEMP_KERNEL", "[[2], [2], [2], [2]]",
                          "DATA.NUM_FRAMES", "4", "DATA.TRAIN_CROP_SIZE", "32",
                          "DATA.TEST_CROP_SIZE", "32", "MODEL.NUM_CLASSES", "8",
                          "TRAIN.DATASET", "syntheticvideo", "DATA.SYNTHETIC_SIZE", "4",
                          "TRAIN.BATCH_SIZE", "2", "TPU.COMPUTE_DTYPE", "float32",
                          "SOLVER.MAX_EPOCH", str(max_epoch), "TEST.ENABLE", "False",
                          "BN.USE_PRECISE_STATS", "False", "NUM_GPUS", "1",
                          "DATA_LOADER.NUM_WORKERS", "1", "OUTPUT_DIR", out])
        assert os.listdir(tmp_path) == []
    finally:
        os.chdir(cwd)
    ckpts = sorted(k for k in mock_remote._blobs if "/checkpoints/" in k)
    assert [os.path.basename(k) for k in ckpts] == ["checkpoint_epoch_00001.pyth",
                                                     "checkpoint_epoch_00002.pyth"]
    with pathmgr.open(f"{out}/json_stats.log") as f:
        logged = [json.loads(line.split("json_stats: ")[1]) for line in f.read().splitlines()]
    epochs = [s["epoch"] for s in logged if s["_type"] == "train_epoch"]
    assert epochs == ["1/1", "2/2"]  # the second run started at epoch 2
