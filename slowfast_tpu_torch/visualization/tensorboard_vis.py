"""TensorBoard logging of training (counterpart of
slowfast_tpu/visualization/tensorboard_vis.py; reference
slowfast/visualization/tensorboard_vis.py).

``TensorboardWriter`` writes scalars and, after a val epoch, the confusion
matrix (whole, on a subset of classes, and one for each parent category)
and each class's top-k histogram as matplotlib figures. The event files go
to ``OUTPUT_DIR/runs-<TRAIN.DATASET>`` (or ``OUTPUT_DIR/TENSORBOARD.LOG_DIR``).
``torch.utils.tensorboard`` and matplotlib are imported when a writer or a
figure is made, not with this module. The model and wrong-prediction
visualizations (``TENSORBOARD.MODEL_VIS``, ``WRONG_PRED_VIS``) are not
ported: ``run_net`` refuses them.
"""

import json
import os

import numpy as np

from slowfast_tpu_torch.utils import logging as logging_utils

logger = logging_utils.get_logger(__name__)


def load_class_names(path, num_classes):
    """The class names of a json file, ``{name: id}`` or ``[names]``
    (slowfast_tpu/visualization/video_visualizer.py:16); a class without a
    name is named by its id. No file: None."""
    if not path:
        return None
    try:
        with open(path) as f:
            mapping = json.load(f)
    except (OSError, ValueError) as e:
        logger.warning("Failed to load class names %s: %s", path, e)
        return None
    if isinstance(mapping, dict):
        names = [None] * num_classes
        for name, idx in mapping.items():
            if int(idx) < num_classes:
                names[int(idx)] = name
        return [n or str(i) for i, n in enumerate(names)]
    return list(mapping)


def load_subset(path, class_names):
    """The ids of the classes a file names, one a line; None without a file
    or class names."""
    if not path or not class_names:
        return None
    try:
        with open(path) as f:
            wanted = [line.strip() for line in f if line.strip()]
    except OSError as e:
        logger.warning("Failed to load class subset %s: %s", path, e)
        return None
    name_to_id = {n: i for i, n in enumerate(class_names)}
    return [name_to_id[n] for n in wanted if n in name_to_id]


class TensorboardWriter:
    """A ``SummaryWriter`` under the run's output directory, with the class
    names, parent categories and plotted subsets of ``cfg.TENSORBOARD``."""

    def __init__(self, cfg):
        from torch.utils.tensorboard import SummaryWriter

        self.cfg = cfg
        tb = cfg.TENSORBOARD
        sub = tb.LOG_DIR or "runs-{}".format(cfg.TRAIN.DATASET)
        self.log_dir = os.path.join(cfg.OUTPUT_DIR, sub)
        self.writer = SummaryWriter(log_dir=self.log_dir)
        self.class_names = load_class_names(tb.CLASS_NAMES_PATH, cfg.MODEL.NUM_CLASSES)
        self.parent_map = None
        if tb.CATEGORIES_PATH:
            try:
                with open(tb.CATEGORIES_PATH) as f:
                    self.parent_map = json.load(f)  # {parent: [class names]}
            except (OSError, ValueError) as e:
                logger.warning("Failed to load categories: %s", e)
        self.cm_subset = load_subset(tb.CONFUSION_MATRIX.SUBSET_PATH, self.class_names)
        self.hist_subset = load_subset(tb.HISTOGRAM.SUBSET_PATH, self.class_names)
        logger.info("To see logged results in Tensorboard, please launch using the command "
                    "`tensorboard --port=<port-number> --logdir %s`", self.log_dir)

    def add_scalars(self, data_dict, global_step=None):
        """One scalar a key; values that are not numbers are skipped."""
        for key, item in data_dict.items():
            if isinstance(item, (int, float)):
                self.writer.add_scalar(key, item, global_step)

    def plot_eval(self, preds, labels, global_step=None):
        """The confusion matrices and top-k histograms of a val epoch's
        ``(N, num_classes)`` predictions and ``(N,)`` labels."""
        tb = self.cfg.TENSORBOARD
        preds, labels = np.asarray(preds), np.asarray(labels)
        num_classes = self.cfg.MODEL.NUM_CLASSES
        figsize = tb.CONFUSION_MATRIX.FIGSIZE
        cmtx = None
        if tb.CONFUSION_MATRIX.ENABLE:
            cmtx = get_confusion_matrix(preds, labels, num_classes)
            self.writer.add_figure("Confusion Matrix", plot_confusion_matrix(
                cmtx, num_classes, self.class_names, figsize), global_step=global_step)
            if self.cm_subset:
                self.writer.add_figure("Confusion Matrix Subset", plot_confusion_matrix(
                    cmtx[np.ix_(self.cm_subset, self.cm_subset)], len(self.cm_subset),
                    [self.class_names[i] for i in self.cm_subset], figsize),
                    global_step=global_step)
            if self.parent_map and self.class_names:
                name_to_id = {n: i for i, n in enumerate(self.class_names)}
                for parent, children in self.parent_map.items():
                    ids = [name_to_id[c] for c in children if c in name_to_id]
                    if ids:
                        self.writer.add_figure(
                            "Confusion Matrices/{}".format(parent), plot_confusion_matrix(
                                cmtx[np.ix_(ids, ids)], len(ids),
                                [self.class_names[i] for i in ids], figsize),
                            global_step=global_step)
        if tb.HISTOGRAM.ENABLE:
            if cmtx is None:
                cmtx = get_confusion_matrix(preds, labels, num_classes)
            for i in self.hist_subset or range(num_classes):
                name = self.class_names[i] if self.class_names else str(i)
                self.writer.add_figure("Hist/{}".format(name), plot_topk_histogram(
                    name, cmtx[i], tb.HISTOGRAM.TOPK, self.class_names,
                    tb.HISTOGRAM.FIGSIZE), global_step=global_step)

    def flush(self):
        self.writer.flush()

    def close(self):
        self.writer.flush()
        self.writer.close()


def get_confusion_matrix(preds, labels, num_classes):
    """The ``(num_classes, num_classes)`` counts of (true, predicted) pairs,
    the prediction each row's argmax."""
    pred_cls = np.argmax(preds, axis=-1)
    cmtx = np.zeros((num_classes, num_classes), np.int64)
    np.add.at(cmtx, (np.asarray(labels).astype(int), pred_cls.astype(int)), 1)
    return cmtx


def _pyplot():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_confusion_matrix(cmtx, num_classes, class_names=None, figsize=None):
    """A figure of the confusion matrix; classes are named on the axes when
    there are at most 32."""
    plt = _pyplot()
    if class_names is None or len(class_names) != num_classes:
        class_names = [str(i) for i in range(num_classes)]
    fig = plt.figure(figsize=figsize)
    plt.imshow(cmtx, interpolation="nearest", cmap=plt.cm.Blues)
    plt.title("Confusion matrix")
    plt.colorbar()
    if num_classes <= 32:
        marks = np.arange(num_classes)
        plt.xticks(marks, class_names, rotation=45, fontsize=6)
        plt.yticks(marks, class_names, fontsize=6)
    plt.ylabel("True label")
    plt.xlabel("Predicted label")
    plt.tight_layout()
    return fig


def plot_topk_histogram(class_name, row, k, class_names=None, figsize=None):
    """A bar figure of the ``k`` classes most predicted for one true class,
    from its confusion-matrix ``row``."""
    plt = _pyplot()
    row = np.asarray(row, np.float64)
    k = min(k, len(row))
    top = np.argsort(-row)[:k]
    names = [class_names[i] if class_names and i < len(class_names) else str(i) for i in top]
    fig = plt.figure(figsize=figsize)
    plt.bar(range(k), row[top])
    plt.xticks(range(k), names, rotation=45, fontsize=6)
    plt.title("Top-{} predictions for: {}".format(k, class_name))
    plt.tight_layout()
    return fig
