"""Training loop (counterpart of slowfast_tpu/engine/trainer.py:48-196 and
:298-479, classification and detection; reference tools/train_net.py).

Each epoch shuffles the train loader, runs the train step on every batch,
then, on the checkpoint or eval cadence, recomputes the BN statistics
(``BN.USE_PRECISE_STATS``), saves a checkpoint on the checkpoint cadence and
runs a val epoch on the eval cadence. The step's metrics stay on the device
and are read back only every ``LOG_PERIOD`` iterations and at the epoch's
end, so the host does not wait for the card on every step; the NaN guard
runs on the same cadence. Detection (``DETECTION.ENABLE``) trains on the
padded boxes and logs through ``AVAMeter``, whose val epoch scores the
predictions of the real boxes by AVA mAP. Masked pretraining
(``MASK.ENABLE``) hands the step the loader's mask, on the device, and
never runs a val epoch: the reconstruction objective has no val protocol
(slowfast_tpu/engine/trainer.py:426-430). ``ContrastiveModel`` trains
through ``train_ssl``: the SSL step on two views a clip, the SSL state in
the checkpoint, and a kNN probe instead of the val epoch.

Multi-process (``utils/multiprocessing.launch_job``): each rank trains on
its part of every global batch (``data/loader.py``) with the step's
reductions (``engine/steps.py``, ``engine/ssl_steps.py``); the metrics read
back every ``LOG_PERIOD`` steps are averaged over the ranks there, the val
epoch's counts summed and its predictions gathered, and only the master
logs and writes checkpoints, which every rank passes a barrier after. The
job's rank count must be the process group's (``NUM_SHARDS · NUM_GPUS``).

TensorBoard (``TENSORBOARD.ENABLE``, slowfast_tpu/engine/trainer.py:113-121,
:173-193, :363-368): the master's ``TensorboardWriter`` takes
``Train/loss``, ``Train/lr`` and, for single-label classification,
``Train/Top1_err`` and ``Train/Top5_err`` of every step at ``data_size ·
epoch + iter``, the val epoch's ``Val/top1_err``, ``Val/top5_err`` or
``Val/map`` at the epoch, and ``plot_eval`` of the epoch's predictions,
gathered from every rank, for single-label classification. SSL
pretraining writes nothing there, as the JAX package's ``train_ssl``.

Chunked csvs (``DATA.LOADER_CHUNK_SIZE``, slowfast_tpu/engine/trainer.py:
371-381): from the second epoch on, each epoch moves ``DATA.SKIP_ROWS`` to
its chunk, ``epoch % ceil(LOADER_CHUNK_OVERALL_SIZE / LOADER_CHUNK_SIZE)``
chunks in, and rebuilds the train loader on those rows.

Multigrid (``MULTIGRID.LONG_CYCLE``, ``MULTIGRID.SHORT_CYCLE``,
slowfast_tpu/engine/trainer.py:316-398): ``MultigridSchedule`` rewrites the
solver's steps and epochs at the start; each epoch takes its long-cycle
shape (B, T, S) and BN mode, and on a change the model is rebuilt for it
with the parameters, BN buffers, optimizer state and generator of the one
before, the loaders, step and meters anew. The LR stays continuous, as it
follows ``epoch_exact``. The short cycle is the train loader's. The eval
and checkpoint cadences follow the schedule. Precise BN runs on the train
loader, short cycle and all.
"""

import itertools
import math
import pprint

import numpy as np
import torch

from slowfast_tpu_torch.data import construct_loader, shuffle_dataset
from slowfast_tpu_torch.engine.precise_bn import compute_precise_bn_stats
from slowfast_tpu_torch.engine.ssl_steps import knn_eval, make_ssl_train_step, ssl_batch
from slowfast_tpu_torch.engine.steps import make_eval_step, make_train_step
from slowfast_tpu_torch.models.build import build_model, resolve_device, set_generator
from slowfast_tpu_torch.models.contrastive import init_ssl_state
from slowfast_tpu_torch.parallel.prefetch import to_device
from slowfast_tpu_torch.solver.optimizer import construct_optimizer
from slowfast_tpu_torch.utils import checkpoint as cu
from slowfast_tpu_torch.utils import distributed as du
from slowfast_tpu_torch.utils import logging as logging_utils
from slowfast_tpu_torch.utils import misc
from slowfast_tpu_torch.utils.meters import AVAMeter, EpochTimer, TrainMeter, ValMeter
from slowfast_tpu_torch.utils.metrics import topks_correct
from slowfast_tpu_torch.utils.misc import is_eval_epoch
from slowfast_tpu_torch.utils.multigrid import MultigridSchedule

logger = logging_utils.get_logger(__name__)


def _check_supported(cfg):
    if int(cfg.TPU.PIPELINE_PARTITIONS) > 1:
        raise NotImplementedError("training with TPU.PIPELINE_PARTITIONS > 1 is not ported yet")
    du.check_world(cfg)


def reduce_metrics(pending):
    """The device metrics of ``pending`` steps averaged over the ranks, in
    one all-reduce (one process: as they are)."""
    if du.get_world_size() == 1 or not pending:
        return
    keys = [k for k in ("loss", "top1_err", "top5_err") if k in pending[0][1]]
    flat = torch.stack([m[k].float() for _, m, _ in pending for k in keys])
    du.all_reduce([flat], "mean")
    for i, (_, m, _) in enumerate(pending):
        m.update({k: flat[i * len(keys) + j] for j, k in enumerate(keys)})


def drive_epoch(train_loader, step_fn, make_batch, meter, cur_epoch, cfg, writer=None):
    """One training epoch of ``step_fn`` on ``make_batch(cur_iter, item)``
    for each loader item, the metrics read back every ``LOG_PERIOD`` steps
    (averaged over the ranks), and written to ``writer`` when given.
    ``make_batch`` runs where the loader stages its batches
    (``Loader.stage_with``), as JAX's ``_drive_epoch`` stages."""
    log_period = max(int(cfg.LOG_PERIOD), 1)
    data_size = len(train_loader)
    world = du.get_world_size()
    pending = []  # (cur_iter, device metrics, global batch size)

    def flush():
        reduce_metrics(pending)
        for it, m, bs in pending:
            loss = float(m["loss"])
            misc.check_nan_losses(loss, f" at epoch {cur_epoch} iter {it}")
            if isinstance(meter, AVAMeter):
                meter.update_stats(None, None, None, loss, m["lr"])
            else:
                top1, top5 = (float(m[k]) if k in m else None for k in ("top1_err", "top5_err"))
                meter.update_stats(top1, top5, loss, m["lr"], bs)
            if writer is not None:
                scalars = {"Train/loss": loss, "Train/lr": float(m["lr"])}
                if not isinstance(meter, AVAMeter) and "top1_err" in m:
                    scalars.update({"Train/Top1_err": float(m["top1_err"]),
                                    "Train/Top5_err": float(m["top5_err"])})
                writer.add_scalars(scalars, global_step=data_size * cur_epoch + it)
            meter.log_iter_stats(cur_epoch, it)
        pending.clear()

    numbers = itertools.count()  # the loader stages its batches in order

    def stage(item):
        cur_iter = next(numbers)
        return cur_iter, make_batch(cur_iter, item), len(item[2]) * world

    meter.iter_tic()
    for cur_iter, batch, bs in train_loader.stage_with(stage):
        meter.data_toc()
        m = step_fn(batch)
        pending.append((cur_iter, m, bs))
        meter.iter_toc()
        if (cur_iter + 1) % log_period == 0:
            flush()
        meter.iter_tic()
    flush()
    meter.log_epoch_stats(cur_epoch)
    meter.reset()


def train_epoch(train_loader, step_fn, meter, cur_epoch, cfg, writer=None):
    """One training epoch."""
    data_size = len(train_loader)
    device = train_loader.device

    def make_batch(cur_iter, item):
        inputs, labels, _, _, meta = item
        batch = {"inputs": inputs, "labels": to_device(labels, device),
                 "epoch_exact": cur_epoch + cur_iter / data_size}
        if cfg.DETECTION.ENABLE:
            batch.update(boxes=meta["boxes"], box_mask=meta["box_mask"])
        if "mask" in meta:
            batch["mask"] = meta["mask"]
        return batch

    drive_epoch(train_loader, step_fn, make_batch, meter, cur_epoch, cfg, writer)


def detection_preds(eval_fn, inputs, meta):
    """The eval step's predictions of the real boxes of a detection batch,
    with the batch's ``ori_boxes`` and ``metadata`` rows, in their order;
    the boxes of a padded batch's repeated clips dropped."""
    preds = eval_fn({"inputs": inputs, "boxes": meta["boxes"]}).float().cpu().numpy()
    preds = preds[meta["box_mask"].reshape(-1).cpu().numpy() > 0]
    keep = meta["ori_boxes"][:, 0] < meta.get("num_real", len(meta["boxes"]))
    return preds[keep], meta["ori_boxes"][keep], meta["metadata"][keep]


def eval_epoch(val_loader, eval_fn, meter, cur_epoch, multi_label=False, writer=None,
               plot=False):
    """One val epoch on the eval step; returns the ``val_epoch`` stats (with
    ``multi_label``, the mAP of the epoch's predictions; with an
    ``AVAMeter``, the AVA mAP of its detections). Over several ranks the
    real rows of every rank count: the top-k counts are summed, the
    predictions gathered. ``writer`` takes the epoch's ``Val/*`` scalars
    and, under ``plot`` (which every rank must be given, as it gathers the
    predictions of single-label classification), ``plot_eval``."""
    world = du.get_world_size()
    tb_preds, tb_labels = [], []
    meter.iter_tic()
    for cur_iter, (inputs, labels, _, _, meta) in enumerate(val_loader):
        if isinstance(meter, AVAMeter):
            meter.update_stats(*detection_preds(eval_fn, inputs, meta))
            meter.iter_toc()
            meter.log_iter_stats(cur_epoch, cur_iter)
            meter.iter_tic()
            continue
        n_real = meta.get("num_real", len(labels))
        preds, labels = eval_fn({"inputs": inputs}).float().cpu()[:n_real], labels[:n_real]
        if multi_label:
            meter.update_predictions(du.all_gather_unaligned(preds.numpy()),
                                     du.all_gather_unaligned(labels))
        else:
            k1, k5 = topks_correct(preds, torch.from_numpy(labels), (1, 5))
            b = preds.shape[0]
            if world > 1:
                counts = torch.tensor([float(k1), float(k5), float(b)], dtype=torch.float64)
                k1, k5, b = du.all_reduce([counts], "sum")[0].tolist()
            meter.update_stats((1.0 - float(k1) / b) * 100.0, (1.0 - float(k5) / b) * 100.0, b)
            if plot:
                tb_preds.append(du.all_gather_unaligned(preds.numpy()))
                tb_labels.append(du.all_gather_unaligned(labels))
        meter.iter_toc()
        meter.log_iter_stats(cur_epoch, cur_iter)
        meter.iter_tic()
    stats = meter.log_epoch_stats(cur_epoch)
    if writer is not None:
        writer.add_scalars({f"Val/{k}": float(stats[k]) for k in ("top1_err", "top5_err", "map")
                            if stats and k in stats}, global_step=cur_epoch)
        if tb_preds:
            writer.plot_eval(np.concatenate(tb_preds), np.concatenate(tb_labels),
                             global_step=cur_epoch)
    meter.reset()
    return stats


def setup_rank(cfg):
    """What every rank does first: the master's logging, numpy's global
    seed (slowfast_tpu/engine/trainer.py:309), the config logged."""
    logging_utils.setup_logging(cfg.OUTPUT_DIR)
    np.random.seed(cfg.RNG_SEED)
    logger.info("Train with config:")
    logger.info(pprint.pformat(cfg.to_dict()))


def rotate_chunk(cfg, cur_epoch):
    """Move ``DATA.SKIP_ROWS`` to ``cur_epoch``'s chunk of the train csv
    (slowfast_tpu/engine/trainer.py:371-381); returns whether the train
    loader must be rebuilt."""
    if cur_epoch == 0 or cfg.DATA.LOADER_CHUNK_SIZE <= 0:
        return False
    num_chunks = math.ceil(cfg.DATA.LOADER_CHUNK_OVERALL_SIZE / cfg.DATA.LOADER_CHUNK_SIZE)
    cfg.DATA.SKIP_ROWS = cur_epoch % num_chunks * cfg.DATA.LOADER_CHUNK_SIZE
    logger.info("chunked loader: skip_rows %d", cfg.DATA.SKIP_ROWS)
    return True


def train_ssl(cfg, device):
    """SSL pretraining of ``ContrastiveModel`` (slowfast_tpu/engine/trainer.py:199);
    returns ``(model, ssl_state)``.

    ``CONTRASTIVE.LENGTH`` is set to the train set's size (the banks are
    indexed by clip id). Auto-resume restores the model, the optimizer and
    the SSL state. Each epoch: the SSL step on views 0 and 1 of every
    batch, the checkpoint (with the SSL state) on the checkpoint cadence
    and, under ``CONTRASTIVE.KNN_ON``, the kNN probe on the val split on the
    eval cadence (a ``knn_epoch`` json_stats line). Over several ranks each
    loads its rows of every global batch and of the val batches, the step
    and the probe reduce over the ranks (``engine/ssl_steps.py``), the
    master writes the checkpoint and the json line, and every rank resumes
    from the checkpoint."""
    train_loader = construct_loader(cfg, "train", device)
    steps_per_epoch = max(len(train_loader), 1)
    num_videos = train_loader.dataset.num_videos
    if num_videos and cfg.CONTRASTIVE.LENGTH != num_videos:
        logger.warning("CONTRASTIVE.LENGTH %d != dataset size %d; resizing memory banks",
                       cfg.CONTRASTIVE.LENGTH, num_videos)
        cfg.CONTRASTIVE.LENGTH = num_videos
    model = build_model(cfg, device)
    optimizer = construct_optimizer(model, cfg)
    ssl = init_ssl_state(cfg, model, torch.Generator().manual_seed(cfg.RNG_SEED))
    start_epoch = cu.load_train_checkpoint(cfg, model, optimizer, ssl)
    if start_epoch:
        logger.info("Resuming SSL training from epoch %d", start_epoch + 1)
    step_fn = make_ssl_train_step(cfg, model, optimizer, ssl, steps_per_epoch)
    meter = TrainMeter(steps_per_epoch, cfg)
    train_labels = train_loader.dataset._labels

    def make_batch(cur_iter, item):
        views, _, index, times, _ = item
        return ssl_batch(views, index, times, device)

    for cur_epoch in range(start_epoch, cfg.SOLVER.MAX_EPOCH):
        shuffle_dataset(train_loader, cur_epoch)
        drive_epoch(train_loader, step_fn, make_batch, meter, cur_epoch, cfg)
        if cu.is_checkpoint_epoch(cfg, cur_epoch):
            cu.save_checkpoint(cfg.OUTPUT_DIR, model, optimizer, cur_epoch, cfg, ssl_state=ssl)
        if cfg.CONTRASTIVE.KNN_ON and is_eval_epoch(cfg, cur_epoch):
            acc = knn_eval(cfg, model, ssl, train_labels, construct_loader(cfg, "val", device))
            if acc is not None:
                logger.info("knn eval epoch %d: top1 %.2f%%", cur_epoch + 1, acc)
                logging_utils.log_json_stats({"_type": "knn_epoch", "epoch": cur_epoch + 1,
                                              "top1_acc": acc}, cfg.OUTPUT_DIR)
    logger.info("ssl training done")
    return model, ssl


def train(cfg, device="cuda"):
    """Train entry (slowfast_tpu/engine/trainer.py:298); returns the model
    (for ``ContrastiveModel``, ``train_ssl``'s ``(model, ssl_state)``)."""
    _check_supported(cfg)
    device = resolve_device(device)
    setup_rank(cfg)
    if cfg.MODEL.MODEL_NAME == "ContrastiveModel":
        return train_ssl(cfg, device)

    multigrid = None
    if cfg.MULTIGRID.LONG_CYCLE or cfg.MULTIGRID.SHORT_CYCLE:
        multigrid = MultigridSchedule()
        cfg = multigrid.init_multigrid(cfg)
        if cfg.MULTIGRID.LONG_CYCLE:
            cfg, _ = multigrid.update_long_cycle(cfg, cur_epoch=0)
    schedule = multigrid.schedule if multigrid is not None else None

    model = build_model(cfg, device)
    if cfg.LOG_MODEL_INFO and du.is_master_proc():
        misc.log_model_info(model, cfg)
    optimizer = construct_optimizer(model, cfg)
    start_epoch = cu.load_train_checkpoint(cfg, model, optimizer)
    mix_generator = torch.Generator().manual_seed(cfg.RNG_SEED)

    def build_trainer():
        train_loader = construct_loader(cfg, "train", device)
        val_loader = construct_loader(cfg, "val", device)
        step_fn = make_train_step(cfg, model, optimizer, mix_generator)
        if cfg.DETECTION.ENABLE:
            train_meter = AVAMeter(len(train_loader), cfg, mode="train")
            val_meter = AVAMeter(len(val_loader), cfg, mode="val")
            val_meter.set_video_idx_to_name(
                getattr(val_loader.dataset, "_video_idx_to_name", None))
        else:
            train_meter = TrainMeter(len(train_loader), cfg)
            val_meter = ValMeter(len(val_loader), cfg)
        return train_loader, val_loader, step_fn, make_eval_step(cfg, model), train_meter, val_meter

    train_loader, val_loader, step_fn, eval_fn, train_meter, val_meter = build_trainer()
    epoch_timer = EpochTimer()
    writer = None
    if cfg.TENSORBOARD.ENABLE and du.is_master_proc():
        from slowfast_tpu_torch.visualization.tensorboard_vis import TensorboardWriter

        writer = TensorboardWriter(cfg)
    plot = cfg.TENSORBOARD.ENABLE and not (cfg.DETECTION.ENABLE or cfg.DATA.MULTI_LABEL)

    logger.info("Start epoch: %d", start_epoch + 1)
    for cur_epoch in range(start_epoch, cfg.SOLVER.MAX_EPOCH):
        if rotate_chunk(cfg, cur_epoch):
            train_loader = construct_loader(cfg, "train", device)
        if schedule is not None:
            cfg, changed = multigrid.update_long_cycle(cfg, cur_epoch)
            if changed:
                model, optimizer = carry_over(cfg, model, optimizer, device)
                train_loader, val_loader, step_fn, eval_fn, train_meter, val_meter = (
                    build_trainer())
        shuffle_dataset(train_loader, cur_epoch)
        epoch_timer.epoch_tic()
        train_epoch(train_loader, step_fn, train_meter, cur_epoch, cfg, writer)
        epoch_timer.epoch_toc()
        logger.info("Epoch %d takes %.2fs. Epochs from %d to %d take %.2fs in average.",
                    cur_epoch + 1, epoch_timer.last_epoch_time(), start_epoch + 1,
                    cur_epoch + 1, epoch_timer.avg_epoch_time())
        is_checkp = cu.is_checkpoint_epoch(cfg, cur_epoch, schedule)
        is_eval = is_eval_epoch(cfg, cur_epoch, schedule) and not cfg.MASK.ENABLE
        # Precise BN before the checkpoint and the val epoch (reference
        # train_net.py:698-710).
        if cfg.BN.USE_PRECISE_STATS and (is_checkp or is_eval):
            compute_precise_bn_stats(cfg, model, train_loader,
                                     min(cfg.BN.NUM_BATCHES_PRECISE, len(train_loader)))
        if is_checkp:
            cu.save_checkpoint(cfg.OUTPUT_DIR, model, optimizer, cur_epoch, cfg)
        if is_eval:
            eval_epoch(val_loader, eval_fn, val_meter, cur_epoch, cfg.DATA.MULTI_LABEL, writer,
                       plot)
            du.barrier()
    if writer is not None:
        writer.close()
    logger.info("training done")
    return model


def carry_over(cfg, model, optimizer, device):
    """The model of ``cfg``'s new long-cycle shape (its head's pooling and
    BN splits) holding ``model``'s parameters, BN buffers and generator, and
    an optimizer on it holding ``optimizer``'s state."""
    new = build_model(cfg, device)
    new.load_state_dict(model.state_dict(), strict=True)
    generator = next((m.generator for m in model.modules()
                      if getattr(m, "generator", None) is not None), None)
    if generator is not None:
        set_generator(new, generator)
    new_optimizer = construct_optimizer(new, cfg)
    new_optimizer.load_state_dict(optimizer.state_dict())
    return new, new_optimizer

