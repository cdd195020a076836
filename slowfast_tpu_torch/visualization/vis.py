"""The visualize tool (counterpart of slowfast_tpu/visualization/vis.py;
reference tools/visualization.py).

On the test loader's first batches (at most 11) it writes to TensorBoard:
the histograms of the weights of ``MODEL_VIS.LAYER_LIST``'s layers and of
their activations on the first batch (``MODEL_WEIGHTS``), the activations'
heatmaps (``ACTIVATIONS``; they need matplotlib), Grad-CAM's maps of the
first batch (``GRAD_CAM``), the clips predicted wrong (``WRONG_PRED_VIS``)
and the confusion matrix and histograms of ``PREDICTIONS_PATH``'s saved
test predictions. It runs in the launching process on its device, as the
JAX package's runs outside the mesh.

The activations and Grad-CAM take the batch after the eval step's
preprocess (row 1 of the kernel table and the pathway split), which the
model is built to take; the JAX package hands them the loader's raw
pathways (ROADMAP Queue 3 #45).
"""

import pickle

import numpy as np
import torch

from slowfast_tpu_torch.utils import logging as logging_utils

from .gradcam import get_layer, layer_output

logger = logging_utils.get_logger(__name__)

MAX_BATCHES = 11  # the JAX loop's batches (vis.py:139-166)


class GetWeightAndActivation:
    """The weights and activations of named layers (slash-separated
    PySlowFast names, ``s5/pathway0_res2`` → ``s5.pathway0_res2``)."""

    def __init__(self, model, layer_ls):
        self.model = model
        self.layer_ls = list(layer_ls)

    def _layers(self):
        for name in self.layer_ls:
            try:
                yield name, get_layer(self.model, name)
            except AttributeError:
                logger.warning("Layer %s not found in the model", name)

    def get_weights(self):
        """``{layer: {parameter name: tensor}}``, the names sorted."""
        return {name: {k: p.detach() for k, p in sorted(m.named_parameters())}
                for name, m in self._layers()}

    def get_activations(self, inputs, bboxes=None):
        """``({layer: activation}, preds)`` of one eval forward, as numpy,
        the layers in ``layer_ls``'s order."""
        acts, handles = {}, []
        for name, m in self._layers():
            def hook(module, args, out, name=name):
                acts[name] = layer_output(out).detach().float().cpu().numpy()

            handles.append(m.register_forward_hook(hook))
        self.model.eval()
        try:
            with torch.no_grad():
                preds = self.model(inputs) if bboxes is None else self.model(inputs, bboxes)
        finally:
            for h in handles:
                h.remove()
        return {n: acts[n] for n in self.layer_ls if n in acts}, preds.float().cpu().numpy()


class WrongPredictionVis:
    """The clip indices whose argmax prediction is not their label."""

    def __init__(self, cfg):
        self.cfg = cfg
        self.wrong_idx = []

    def update(self, preds, labels, indices):
        wrong = np.asarray(preds).argmax(axis=-1) != np.asarray(labels)
        self.wrong_idx.extend(np.asarray(indices)[wrong].tolist())

    @property
    def wrong_class_prediction(self):
        return self.wrong_idx


def visualize(cfg, device="cuda"):
    """The visualize tool's entry (``run_net`` calls it after the test)."""
    from slowfast_tpu_torch.data import construct_loader
    from slowfast_tpu_torch.engine.steps import make_eval_step, maybe_device_preprocess
    from slowfast_tpu_torch.models.build import build_model, resolve_device
    from slowfast_tpu_torch.utils import checkpoint as cu

    from .gradcam import GradCAM
    from .tensorboard_vis import TensorboardWriter

    tb = cfg.TENSORBOARD
    vis = tb.MODEL_VIS
    if not (vis.ENABLE or tb.WRONG_PRED_VIS.ENABLE):
        return
    if cfg.DETECTION.ENABLE:
        raise NotImplementedError("the visualize tool takes classification models; its "
                                  "eval batches carry no boxes, as in the JAX package")
    device = resolve_device(device)
    logging_utils.setup_logging(cfg.OUTPUT_DIR)
    model = build_model(cfg, device)
    cu.load_test_checkpoint(cfg, model)
    writer = TensorboardWriter(cfg)
    loader = construct_loader(cfg, "test", device)
    eval_fn = make_eval_step(cfg, model)
    gwa = GetWeightAndActivation(model, vis.LAYER_LIST)

    if vis.ENABLE and vis.MODEL_WEIGHTS:
        for name, params in gwa.get_weights().items():
            for i, w in enumerate(params.values()):
                writer.writer.add_histogram(f"weights/{name}/{i}", w.float().cpu(), 0)
    wrong_vis = WrongPredictionVis(cfg) if tb.WRONG_PRED_VIS.ENABLE else None
    gradcam = None
    if vis.ENABLE and vis.GRAD_CAM.ENABLE and vis.GRAD_CAM.LAYER_LIST:
        gradcam = GradCAM(model, vis.GRAD_CAM.LAYER_LIST, colormap=vis.GRAD_CAM.COLORMAP)

    for cur_iter, (inputs, labels, index, _, _) in enumerate(loader):
        preds = eval_fn({"inputs": inputs})
        if wrong_vis is not None:
            wrong_vis.update(preds.float().cpu().numpy(), labels, index)
        if cur_iter == 0 and vis.ENABLE and (vis.MODEL_WEIGHTS or vis.ACTIVATIONS
                                             or gradcam is not None):
            x = maybe_device_preprocess(cfg, inputs)
            if vis.MODEL_WEIGHTS or vis.ACTIVATIONS:
                acts, _ = gwa.get_activations(x)
                if vis.MODEL_WEIGHTS:
                    for name, act in acts.items():
                        writer.writer.add_histogram(f"activations/{name}", act, 0)
                if vis.ACTIVATIONS:
                    writer.plot_weights_and_activations(activations=acts)
            if gradcam is not None:
                cams, _ = gradcam(x, labels=labels, use_labels=vis.GRAD_CAM.USE_TRUE_LABEL)
                for p, cam in enumerate(cams):
                    writer.writer.add_histogram(f"gradcam/pathway{p}", cam, 0)
        if cur_iter + 1 >= MAX_BATCHES:
            break

    if wrong_vis is not None:
        logger.info("Class indices with wrong predictions: %s",
                    sorted(set(wrong_vis.wrong_class_prediction))[:50])
    if tb.PREDICTIONS_PATH:
        with open(tb.PREDICTIONS_PATH, "rb") as f:
            saved_preds, saved_labels = pickle.load(f)
        writer.plot_eval(np.asarray(saved_preds), np.asarray(saved_labels))
    writer.close()
