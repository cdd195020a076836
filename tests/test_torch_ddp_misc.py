"""The single-process parts of the multi-process slice, against the JAX
package on the CPU:

* the loader's layout: for ``NUM_SHARDS`` 2 x ``NUM_GPUS`` 2, each rank's
  items are its GPU's contiguous chunk of its host's part of JAX's
  ``ShardedLoader`` batch (``batch[s::NUM_SHARDS]``), the four ranks
  partition every global batch of the epoch's permutation, the short
  cycle's too;
* ``SOLVER.CLIP_GRAD_VAL``: the port's SGD step with the elementwise clip
  against JAX's chain (``optax.clip``) on the same gradients;
* chunked csvs: the Kinetics train split keeps the rows JAX's keeps for
  each ``DATA.SKIP_ROWS``, and the trainer moves ``SKIP_ROWS`` each epoch
  as the JAX trainer does (both trainers run with their loaders, steps and
  checkpoint writers replaced by recorders);
* resuming from a train checkpoint in ``TRAIN.CHECKPOINT_FILE_PATH``
  (ROADMAP Queue 3 #30): with ``CHECKPOINT_EPOCH_RESET False`` the epoch
  after the saved one and the saved momentum, with it ``True`` epoch 0 and
  a fresh optimizer, as JAX's ``load_train_checkpoint`` gives for its own
  checkpoint of the same state;
* the tools that the port refused until they were ported (ROADMAP Queue 3
  #31): ``run_net`` now reaches the visualize tool and the demo, and the
  test MAE's reconstruction renders (the tools themselves are held in
  tests/test_torch_{vis_tools,gradcam,demo,mae_vis}.py); the options the
  port refuses: more ranks than cards, a config of 2 ranks trained in a
  process that is not one of them.
"""

import os

import numpy as np
import pytest
import torch

from slowfast_tpu_torch.config import get_cfg
from slowfast_tpu_torch.data.loader import Loader, short_cycle_batches

SLOW = ["MODEL.MODEL_NAME", "ResNet", "MODEL.ARCH", "slow", "RESNET.DEPTH", "18",
        "RESNET.WIDTH_PER_GROUP", "8", "RESNET.NUM_BLOCK_TEMP_KERNEL", "[[2],[2],[2],[2]]",
        "DATA.INPUT_CHANNEL_NUM", "[3]", "DATA.NUM_FRAMES", "4", "DATA.TRAIN_CROP_SIZE", "32",
        "MODEL.NUM_CLASSES", "6", "TPU.COMPUTE_DTYPE", "float32",
        "SOLVER.OPTIMIZING_METHOD", "sgd", "SOLVER.MOMENTUM", "0.9", "SOLVER.NESTEROV", "True",
        "SOLVER.WEIGHT_DECAY", "1e-4"]


def cfg_of(get, opts):
    cfg = get()
    cfg.merge_from_list(list(opts))
    return cfg


# --- the loader's layout -----------------------------------------------------

@pytest.mark.parametrize("short_cycle", [False, True])
def test_ranks_partition_jax_sharded_loader_batches(short_cycle):
    from slowfast_tpu.config import get_cfg as jax_get_cfg
    from slowfast_tpu.data.loader import ShardedLoader

    shards, gpus, batch, n = 2, 2, 8, 75
    opts = ["DATA.TRAIN_CROP_SIZE", "224", "MULTIGRID.DEFAULT_S", "224", "RNG_SEED", "3"]
    jcfg = cfg_of(jax_get_cfg, opts)
    cycles = short_cycle_batches(cfg_of(get_cfg, opts), batch) if short_cycle else None
    data = list(range(n))
    for epoch in (0, 1):
        hosts = []
        for shard in range(shards):
            jax_loader = ShardedLoader(data, batch, True, True, jcfg, short_cycle=short_cycle)
            jax_loader.num_hosts, jax_loader.host_id = shards, shard
            jax_loader.host_batch = batch // shards
            jax_loader.set_epoch(epoch)
            hosts.append([[i if short_cycle else int(i) for i in b]
                          for b in jax_loader._indices()])
        ranks = []
        for rank in range(shards * gpus):
            loader = Loader(data, batch, "cpu", shuffle=True, drop_last=True, seed=3,
                            cycle_batches=cycles, rank=rank, world=shards * gpus,
                            num_shards=shards)
            loader.set_epoch(epoch)
            ranks.append(loader._indices())
        order = np.random.RandomState(3 + epoch).permutation(n).tolist()
        assert len(ranks[0]) == len(hosts[0]) > 2
        pos = 0
        for b in range(len(ranks[0])):
            for rank, items in enumerate(ranks):
                shard, gpu = divmod(rank, gpus)
                host = hosts[shard][b]
                per = len(host) // gpus
                assert items[b] == host[gpu * per:(gpu + 1) * per]
            size = sum(len(items[b]) for items in ranks)
            got = sorted(i if isinstance(i, int) else i[0] for items in ranks for i in items[b])
            assert got == sorted(order[pos:pos + size])  # the ranks partition the batch
            pos += size
        if short_cycle:
            assert [sum(len(items[b]) for items in ranks) for b in range(3)] == cycles


# --- CLIP_GRAD_VAL -------------------------------------------------------------

def test_clip_grad_val_matches_jax_clip():
    import jax

    from ddp_jax import jax_cfg, jax_variables, port_state
    from slowfast_tpu.solver.optimizer import construct_optimizer as jax_optimizer
    from slowfast_tpu_torch.models.build import build_model
    from slowfast_tpu_torch.solver.optimizer import construct_optimizer
    from slowfast_tpu_torch.utils.checkpoint import state_dict_from_jax

    opts = SLOW + ["SOLVER.CLIP_GRAD_VAL", "0.05", "SOLVER.CLIP_GRAD_L2NORM", "1e-6"]
    jcfg = jax_cfg(opts)
    v = jax_variables(jcfg, 5)
    rng = np.random.RandomState(6)
    grads = jax.tree.map(lambda p: rng.normal(0.0, 0.1, p.shape).astype(np.float32),
                         v["params"])
    tx, _ = jax_optimizer(v["params"], jcfg, 1)
    updates, _ = tx.update(grads, tx.init(v["params"]), v["params"])
    want = port_state(jax.tree.map(lambda p, u: p - 0.5 * u, v["params"], updates),
                      v["batch_stats"])

    model = build_model(cfg_of(get_cfg, opts), device="cpu")
    model.load_state_dict(port_state(v["params"], v["batch_stats"]), strict=True)
    port_grads = state_dict_from_jax({"params": grads})
    for name, p in model.named_parameters():
        p.grad = port_grads[name].clone()
    norm = construct_optimizer(model, cfg_of(get_cfg, opts)).step(0.5)
    got = model.state_dict()
    clipped = sum(int((g.abs() > 0.05).sum()) for g in port_grads.values())
    assert clipped > 1000  # the clip acts, and the tiny L2 clip gives way to it
    for name, p in model.named_parameters():
        np.testing.assert_allclose(got[name].numpy(), want[name].numpy(), rtol=1e-6, atol=1e-7,
                                   err_msg=name)
    flat = torch.cat([g.flatten() for g in port_grads.values()])
    assert float(norm) == pytest.approx(float(flat.norm()), rel=1e-5)  # before the clip


# --- chunked csvs ---------------------------------------------------------------

def write_csv(root, rows=10):
    os.makedirs(root, exist_ok=True)
    for split in ("train", "val"):
        with open(os.path.join(root, f"{split}.csv"), "w") as f:
            f.write("".join(f"video{i:02d}.mp4 {i % 3}\n" for i in range(rows)))
    return root


@pytest.mark.parametrize("skip", [0, 4, 8])
def test_chunked_kinetics_keeps_the_rows_of_jax(tmp_path, skip):
    from slowfast_tpu.config import get_cfg as jax_get_cfg
    from slowfast_tpu.data.kinetics import Kinetics as JaxKinetics
    from slowfast_tpu_torch.data.kinetics import Kinetics

    opts = ["DATA.PATH_TO_DATA_DIR", write_csv(str(tmp_path)), "DATA.LOADER_CHUNK_SIZE", "4",
            "DATA.LOADER_CHUNK_OVERALL_SIZE", "10", "DATA.SKIP_ROWS", str(skip)]
    for mode, rows in (("train", min(4, 10 - skip)), ("val", 10)):
        got = Kinetics(cfg_of(get_cfg, opts), mode)
        want = JaxKinetics(cfg_of(jax_get_cfg, opts), mode)
        assert got._path_to_videos == want._path_to_videos and len(got) == rows
        assert got._labels == list(want._labels)


class Recorder:
    """A loader that records the csv rows each train loader was built on."""

    def __init__(self, log, cfg, split):
        log.append((split, cfg.DATA.SKIP_ROWS))
        self.dataset = None

    def __len__(self):
        return 1

    def set_epoch(self, epoch):
        pass


def test_chunk_rotation_matches_the_jax_trainer(tmp_path, monkeypatch):
    from slowfast_tpu.config import get_cfg as jax_get_cfg
    from slowfast_tpu.engine import trainer as jax_trainer
    from slowfast_tpu_torch.engine import trainer

    opts = SLOW + ["DATA.LOADER_CHUNK_SIZE", "4", "DATA.LOADER_CHUNK_OVERALL_SIZE", "10",
                   "SOLVER.MAX_EPOCH", "5", "TRAIN.EVAL_PERIOD", "100", "TRAIN.CHECKPOINT_PERIOD",
                   "100", "LOG_MODEL_INFO", "False", "BN.USE_PRECISE_STATS", "False"]
    logs = {}
    for name, module, get in (("jax", jax_trainer, jax_get_cfg), ("port", trainer, get_cfg)):
        log = logs[name] = []
        monkeypatch.setattr(module, "construct_loader",
                            lambda cfg, split, *a, log=log: Recorder(log, cfg, split))
        monkeypatch.setattr(module, "make_train_step", lambda *a, **k: None)
        monkeypatch.setattr(module, "make_eval_step", lambda *a, **k: None)
        monkeypatch.setattr(module, "eval_epoch", lambda *a, **k: None)
        monkeypatch.setattr(module.cu, "save_checkpoint", lambda *a, **k: None)
        cfg = cfg_of(get, opts + ["OUTPUT_DIR", str(tmp_path / name)])
        os.makedirs(cfg.OUTPUT_DIR)
        if name == "jax":
            monkeypatch.setattr(module, "train_epoch", lambda loader, state, *a, **k: state)
            module.train(cfg)
        else:
            monkeypatch.setattr(module, "train_epoch", lambda *a, **k: None)
            module.train(cfg, "cpu")
    train_rows = lambda log: [skip for split, skip in log if split == "train"]  # noqa: E731
    assert train_rows(logs["port"]) == train_rows(logs["jax"]) == [0, 4, 8, 0, 4]


# --- resuming from TRAIN.CHECKPOINT_FILE_PATH (#30) ------------------------------

@pytest.mark.parametrize("reset", [False, True])
def test_train_checkpoint_resumes_as_jax(tmp_path, reset):
    import jax

    from ddp_jax import jax_cfg, jax_variables, port_state, trace_of
    from slowfast_tpu.engine.steps import create_train_state
    from slowfast_tpu.models import build_model as jax_build_model
    from slowfast_tpu.solver.optimizer import construct_optimizer as jax_optimizer
    from slowfast_tpu.utils import checkpoint as jcu
    from slowfast_tpu_torch.models.build import build_model
    from slowfast_tpu_torch.solver.optimizer import construct_optimizer
    from slowfast_tpu_torch.utils import checkpoint as cu

    opts = SLOW + ["TRAIN.CHECKPOINT_EPOCH_RESET", str(reset)]
    saved_epoch = 4
    # JAX: its own checkpoint of a state whose momentum is not zero.
    jcfg = jax_cfg(opts + ["OUTPUT_DIR", str(tmp_path / "jax_run")])
    v = jax_variables(jcfg, 7)
    tx, _ = jax_optimizer(v["params"], jcfg, 1)
    state = create_train_state(jcfg, jax_build_model(jcfg), tx, variables=v)
    rng = np.random.RandomState(8)
    grads = jax.tree.map(lambda p: rng.normal(0.0, 0.1, p.shape).astype(np.float32), v["params"])
    _, opt_state = tx.update(grads, state.opt_state, state.params)
    saved = state.replace(opt_state=opt_state, step=np.asarray(5, np.int32))
    path = jcu.save_checkpoint(str(tmp_path / "jax_job"), saved, saved_epoch, jcfg)
    jcfg.TRAIN.CHECKPOINT_FILE_PATH = path
    got_state, jax_epoch = jcu.load_train_checkpoint(jcfg, state)
    jax_trace = trace_of(got_state.opt_state)

    # The port: its own checkpoint of the same state.
    cfg = cfg_of(get_cfg, opts + ["OUTPUT_DIR", str(tmp_path / "port_run")])
    model = build_model(cfg, device="cpu")
    model.load_state_dict(port_state(v["params"], v["batch_stats"]), strict=True)
    optimizer = construct_optimizer(model, cfg)
    optimizer.load_state_dict({"count": 5, "trace": trace_of(opt_state)})
    cfg.TRAIN.CHECKPOINT_FILE_PATH = cu.save_checkpoint(str(tmp_path / "port_job"), model,
                                                        optimizer, saved_epoch, cfg)
    fresh = build_model(cfg_of(get_cfg, SLOW + ["RNG_SEED", "9"]), device="cpu")
    fresh_optimizer = construct_optimizer(fresh, cfg)
    epoch = cu.load_train_checkpoint(cfg, fresh, fresh_optimizer)

    assert epoch == jax_epoch == (0 if reset else saved_epoch + 1)
    restored = fresh_optimizer.state_dict()
    moved = any(bool(t.abs().sum() > 0) for t in jax_trace.values())
    assert moved == (not reset)  # JAX restores its optimizer only without the key
    for name, t in restored["trace"].items():
        torch.testing.assert_close(t, jax_trace[name], rtol=0, atol=0)
    assert restored["count"] == (0 if reset else 5)
    for name, t in fresh.state_dict().items():  # the weights load either way
        if "num_batches" not in name:
            torch.testing.assert_close(t, model.state_dict()[name], rtol=0, atol=0)


# --- the tools once refused (#31) and the launcher's checks -----------------------

@pytest.mark.parametrize("opts,tool", [
    (["TENSORBOARD.ENABLE", "True", "TENSORBOARD.MODEL_VIS.ENABLE", "True"], "visualize"),
    (["TENSORBOARD.ENABLE", "True", "TENSORBOARD.WRONG_PRED_VIS.ENABLE", "True"],
     "visualize"),
    (["DEMO.ENABLE", "True"], "demo"),
])
def test_unported_tools_raise(tmp_path, monkeypatch, opts, tool):
    """The tools that raised here until they were ported: ``run_net`` now
    calls each, on its ``--device``, after the test."""
    from slowfast_tpu_torch.run_net import main
    from slowfast_tpu_torch.visualization import demo, vis

    called = []
    monkeypatch.setattr(vis, "visualize", lambda cfg, device: called.append(("visualize", device)))
    monkeypatch.setattr(demo, "demo", lambda cfg, device: called.append(("demo", device)))
    main(["--device", "cpu", "--opts", "TRAIN.ENABLE", "False", "TEST.ENABLE", "False",
          "OUTPUT_DIR", str(tmp_path), *opts])
    assert called == [(tool, "cpu")]


def test_mae_reconstruction_renders_raise(tmp_path, monkeypatch):
    """MAE's renders, which raised here until they were ported: the test
    now hands its model and loader to ``run_mae_visualization`` in place
    of the metrics."""
    from slowfast_tpu_torch.engine.tester import test
    from slowfast_tpu_torch.visualization import mae_vis

    monkeypatch.setattr(mae_vis, "run_mae_visualization",
                        lambda cfg, model, loader: {"rendered": len(loader)})
    cfg = cfg_of(get_cfg, SLOW + ["MASK.ENABLE", "True", "MASK.MAE_ON", "True",
                                  "VIS_MASK.ENABLE", "True", "TEST.DATASET", "syntheticvideo",
                                  "DATA.SYNTHETIC_SIZE", "4", "TEST.BATCH_SIZE", "2",
                                  "TEST.NUM_ENSEMBLE_VIEWS", "1", "TEST.NUM_SPATIAL_CROPS", "1",
                                  "DATA.TEST_CROP_SIZE", "32", "OUTPUT_DIR", str(tmp_path)])
    assert test(cfg, "cpu") == [{"rendered": 2}]


def test_more_ranks_than_cards_raise(tmp_path):
    from slowfast_tpu_torch.run_net import main
    from slowfast_tpu_torch.utils.multiprocessing import check_devices

    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(RuntimeError, match=f"NUM_GPUS {have + 1} asks for more cards"):
        check_devices(cfg_of(get_cfg, ["NUM_GPUS", str(have + 1)]), "cuda")
    with pytest.raises(RuntimeError, match="more cards than this host has"):
        main(["--device", "cuda", "--opts", "NUM_GPUS", str(have + 2), "TRAIN.BATCH_SIZE",
              str(have + 2), "TEST.BATCH_SIZE", str(have + 2), "OUTPUT_DIR", str(tmp_path)])
    check_devices(cfg_of(get_cfg, ["NUM_GPUS", "8"]), "cpu")  # gloo ranks on the CPU


def test_two_rank_config_outside_its_ranks_raises(tmp_path):
    from slowfast_tpu_torch.engine.tester import test
    from slowfast_tpu_torch.engine.trainer import train

    cfg = cfg_of(get_cfg, SLOW + ["NUM_GPUS", "2", "OUTPUT_DIR", str(tmp_path)])
    for run in (train, test):
        with pytest.raises(ValueError, match="NUM_SHARDS x NUM_GPUS = 2 ranks"):
            run(cfg, "cpu")
