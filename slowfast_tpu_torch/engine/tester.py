"""Multi-view test driver (counterpart of slowfast_tpu/engine/tester.py:52-145,
classification and detection; reference tools/test_net.py).

Each batch of uint8 clips goes through the eval step on the device; the
per-clip predictions are ensembled per video by ``TestMeter``, which logs
``test_final`` with ``top1_acc``/``top5_acc``, or with ``map`` for
multi-label data (``DATA.MULTI_LABEL``). Detection (``DETECTION.ENABLE``)
scores the predictions of every real box with ``AVAMeter`` and returns
``{"map": ...}``. Over several ranks each tests its part of every batch;
the real rows' predictions, labels and clip ids are gathered each
iteration (the detections at the end), so every rank's meter sees every
view, and the master logs. Under ``VIS_MASK.ENABLE`` (with ``MASK.ENABLE``
and ``MASK.MAE_ON``) the test renders MAE's reconstructions in place of the
metrics (``visualization/mae_vis.py``), as slowfast_tpu/engine/tester.py:89-93
does.
"""

import pickle
import pprint

from slowfast_tpu_torch.data import construct_loader
from slowfast_tpu_torch.engine.steps import make_eval_step
from slowfast_tpu_torch.engine.trainer import detection_preds
from slowfast_tpu_torch.models.build import build_model, resolve_device
from slowfast_tpu_torch.utils import checkpoint as cu
from slowfast_tpu_torch.utils import distributed as du
from slowfast_tpu_torch.utils import logging as logging_utils
from slowfast_tpu_torch.utils.meters import AVAMeter, TestMeter

logger = logging_utils.get_logger(__name__)


def perform_test(test_loader, eval_fn, test_meter):
    test_meter.iter_tic()
    for cur_iter, (inputs, labels, video_idx, _, meta) in enumerate(test_loader):
        n = meta.get("num_real", len(labels))
        preds = eval_fn({"inputs": inputs}).float().cpu().numpy()
        preds, labels, video_idx = (du.all_gather_unaligned(x[:n])
                                    for x in (preds, labels, video_idx))
        test_meter.iter_toc()
        test_meter.update_stats(preds, labels, video_idx)
        test_meter.log_iter_stats(cur_iter)
        test_meter.iter_tic()
    test_meter.finalize_metrics()
    return test_meter


def test(cfg, device="cuda"):
    """Test entry, looping over TEST.NUM_TEMPORAL_CLIPS view counts; returns
    one stats dict per view count."""
    if cfg.MODEL.MODEL_NAME == "ContrastiveModel":
        # The JAX package's test of an SSL pretrain fails: its loader takes
        # the SSL checkpoint for a PyTorch file (ROADMAP Queue 3).
        raise NotImplementedError(
            "TEST.ENABLE after an SSL pretrain (ContrastiveModel) has no test protocol: "
            "the pretrain is judged by its kNN probe and by linear_*/finetune_* transfer; "
            "set TEST.ENABLE False")
    du.check_world(cfg)
    device = resolve_device(device)
    logging_utils.setup_logging(cfg.OUTPUT_DIR)
    logger.info("Test with config:")
    logger.info(pprint.pformat(cfg.to_dict()))

    view_counts = cfg.TEST.NUM_TEMPORAL_CLIPS or [cfg.TEST.NUM_ENSEMBLE_VIEWS]
    results = []
    for num_view in view_counts:
        cfg = cfg.clone()
        cfg.TEST.NUM_ENSEMBLE_VIEWS = num_view
        results.append(test_one(cfg, device))
    for views, stats in zip(view_counts, results):
        logger.info("Views %d: %s", views, stats)
    return results


def perform_detection_test(test_loader, eval_fn, meter):
    """The AVA test (slowfast_tpu/engine/tester.py:98-120): every real box's
    predictions into ``meter``; returns the mAP."""
    meter.iter_tic()
    for cur_iter, (inputs, _, _, _, meta) in enumerate(test_loader):
        detections = detection_preds(eval_fn, inputs, meta)
        meter.iter_toc()
        meter.update_stats(*detections)
        meter.log_iter_stats(None, cur_iter)
        meter.iter_tic()
    return meter.finalize_metrics()


def test_one(cfg, device):
    model = build_model(cfg, device)
    cu.load_test_checkpoint(cfg, model)
    test_loader = construct_loader(cfg, "test", device)
    if cfg.VIS_MASK.ENABLE and cfg.MASK.ENABLE and cfg.MASK.MAE_ON:
        from slowfast_tpu_torch.visualization.mae_vis import run_mae_visualization

        return run_mae_visualization(cfg, model, test_loader)
    eval_fn = make_eval_step(cfg, model)
    if cfg.DETECTION.ENABLE:
        meter = AVAMeter(len(test_loader), cfg, mode="test")
        meter.set_video_idx_to_name(getattr(test_loader.dataset, "_video_idx_to_name", None))
        return {"map": perform_detection_test(test_loader, eval_fn, meter)}

    num_clips = cfg.TEST.NUM_ENSEMBLE_VIEWS * cfg.TEST.NUM_SPATIAL_CROPS
    dataset = test_loader.dataset
    if dataset.num_videos % num_clips:
        raise ValueError("total test clips must be divisible by views x crops")
    test_meter = TestMeter(
        dataset.num_videos // num_clips,
        num_clips,
        cfg.MODEL.NUM_CLASSES,
        multi_label=cfg.DATA.MULTI_LABEL,
        ensemble_method=cfg.DATA.ENSEMBLE_METHOD,
        output_dir=cfg.OUTPUT_DIR,
    )
    perform_test(test_loader, eval_fn, test_meter)
    if cfg.TEST.SAVE_RESULTS_PATH and du.is_master_proc():
        with open(cfg.TEST.SAVE_RESULTS_PATH, "wb") as f:
            pickle.dump([test_meter.video_preds, test_meter.video_labels], f)
    return dict(test_meter.stats)
