"""The video demo (counterpart of slowfast_tpu/visualization/demo.py;
reference tools/demo_net.py and slowfast/visualization/{demo_loader,
predictor,async_predictor,ava_demo_precomputed_boxes}.py).

A webcam or a video file is read with cv2 into clips of ``DATA.NUM_FRAMES
· DATA.SAMPLING_RATE`` frames (the last ``DEMO.BUFFER_SIZE`` frames of a
clip open the next); each clip is subsampled, scaled and center-cropped on
the host, as the JAX package does, and predicted by the eval step on the
device; the annotated frames (``VideoVisualizer``) are written in order to
``DEMO.OUTPUT_FILE``. ``DEMO.THREAD_ENABLE`` reads on a thread and writes
in clip order, predicting every ``DEMO.NUM_CLIPS_SKIP + 1``-th clip;
``DEMO.NUM_VIS_INSTANCES > 1`` predicts on a worker thread with that many
clips in flight (``AsyncPredictor``). A detection model takes the motion
proposals of ``PersonDetector`` on each clip's middle frame, or the boxes
of ``DEMO.PREDS_BOXES`` (``AVAVisualizerWithPrecomputedBox``).
"""

import csv
import itertools
import os
import queue
import threading
from collections import defaultdict

import numpy as np
import torch

from slowfast_tpu_torch.utils import logging as logging_utils

from .video_visualizer import VideoVisualizer

logger = logging_utils.get_logger(__name__)


class TaskInfo:
    def __init__(self):
        self.frames = None
        self.id = -1
        self.bboxes = None
        self.action_preds = None
        self.num_buffer_frames = 0


class VideoManager:
    """Clips of a cv2 capture, with ``DEMO.BUFFER_SIZE`` frames of overlap,
    and the writer of the annotated frames."""

    def __init__(self, cfg):
        import cv2

        if cfg.DEMO.WEBCAM < 0 and not cfg.DEMO.INPUT_VIDEO:
            raise ValueError("set DEMO.WEBCAM or DEMO.INPUT_VIDEO as the demo's input")
        self.source = cfg.DEMO.WEBCAM if cfg.DEMO.WEBCAM > -1 else cfg.DEMO.INPUT_VIDEO
        self.cap = cv2.VideoCapture(self.source)
        if cfg.DEMO.DISPLAY_WIDTH > 0 and cfg.DEMO.DISPLAY_HEIGHT > 0:
            self.cap.set(cv2.CAP_PROP_FRAME_WIDTH, cfg.DEMO.DISPLAY_WIDTH)
            self.cap.set(cv2.CAP_PROP_FRAME_HEIGHT, cfg.DEMO.DISPLAY_HEIGHT)
        if not self.cap.isOpened():
            raise IOError(f"Video {self.source} cannot be opened")
        self.fps = self.cap.get(cv2.CAP_PROP_FPS) or 30
        self.output_file = None
        if cfg.DEMO.OUTPUT_FILE:
            fps = cfg.DEMO.OUTPUT_FPS if cfg.DEMO.OUTPUT_FPS > 0 else self.fps
            size = (int(self.cap.get(cv2.CAP_PROP_FRAME_WIDTH)),
                    int(self.cap.get(cv2.CAP_PROP_FRAME_HEIGHT)))
            self.output_file = cv2.VideoWriter(cfg.DEMO.OUTPUT_FILE,
                                               cv2.VideoWriter_fourcc(*"mp4v"), float(fps), size)
        self.id = -1
        self.buffer = []
        self.buffer_size = cfg.DEMO.BUFFER_SIZE
        self.seq_length = cfg.DATA.NUM_FRAMES * cfg.DATA.SAMPLING_RATE

    def __iter__(self):
        return self

    def __next__(self):
        self.id += 1
        task = TaskInfo()
        task.id = self.id
        frames = list(self.buffer)
        task.num_buffer_frames = len(frames)
        was_read = True
        while was_read and len(frames) < self.seq_length:
            was_read, frame = self.cap.read()
            if was_read:
                frames.append(frame)
        if not was_read and len(frames) < self.seq_length:
            raise StopIteration
        if self.buffer_size > 0:
            self.buffer = frames[-self.buffer_size:]
        task.frames = frames
        return task

    def display(self, task):
        """Write the clip's frames that the last clip did not write."""
        if self.output_file is not None:
            for frame in task.frames[task.num_buffer_frames:]:
                self.output_file.write(frame)

    def clean(self):
        self.cap.release()
        if self.output_file is not None:
            self.output_file.release()


class ThreadVideoManager(VideoManager):
    """A reader thread that keeps a queue of clips full, and a writer that
    writes the clips in id order; under ``DEMO.NUM_CLIPS_SKIP`` the skipped
    clips pass to the writer unannotated."""

    def __init__(self, cfg):
        super().__init__(cfg)
        self.read_queue = queue.Queue(maxsize=8)
        self.result_lock = threading.Lock()
        self.results = {}
        self.next_display = 0
        self.stopped = False
        self.num_skip = max(int(cfg.DEMO.NUM_CLIPS_SKIP), 0) + 1
        self.reader = threading.Thread(target=self._read_loop, daemon=True)
        self.reader.start()

    def _read_loop(self):
        try:
            while not self.stopped:
                task = VideoManager.__next__(self)
                if self.num_skip > 1 and task.id % self.num_skip != 0:
                    self.display(task)
                else:
                    self.read_queue.put(task)
        except StopIteration:
            pass
        finally:
            self.read_queue.put(None)

    def __next__(self):
        task = self.read_queue.get()
        if task is None:
            raise StopIteration
        return task

    def display(self, task):
        with self.result_lock:
            self.results[task.id] = task
            while self.next_display in self.results:
                VideoManager.display(self, self.results.pop(self.next_display))
                self.next_display += 1

    def clean(self):
        self.stopped = True
        super().clean()


def host_clip(cfg, frames):
    """A clip's pathways as the host makes them: ``DATA.NUM_FRAMES`` frames
    at ``linspace`` indices, BGR to RGB under ``DEMO.INPUT_FORMAT BGR``, the
    short side scaled to ``DATA.TEST_CROP_SIZE`` (cv2), the center crop,
    normalized and split into pathways; float32 numpy, one pathway each."""
    import cv2

    from slowfast_tpu_torch.data.utils import pack_pathway_output

    size = cfg.DATA.TEST_CROP_SIZE
    flip = cfg.DEMO.INPUT_FORMAT == "BGR"
    clip = []
    for i in np.linspace(0, len(frames) - 1, cfg.DATA.NUM_FRAMES).astype(int):
        f = frames[i][:, :, ::-1] if flip else frames[i]
        h, w = f.shape[:2]
        scale = size / min(h, w)
        f = cv2.resize(f, (int(round(w * scale)), int(round(h * scale))))
        h, w = f.shape[:2]
        y0, x0 = (h - size) // 2, (w - size) // 2
        clip.append(f[y0:y0 + size, x0:x0 + size])
    clip = np.stack(clip).astype(np.float32) / 255.0
    clip = (clip - np.asarray(cfg.DATA.MEAN)) / np.asarray(cfg.DATA.STD)
    return [np.ascontiguousarray(x, np.float32)
            for x in pack_pathway_output(cfg, clip.astype(np.float32))]


class Predictor:
    """The model of ``cfg`` on ``device`` with the test checkpoint, and its
    eval step on one clip at a time."""

    def __init__(self, cfg, device="cuda"):
        from slowfast_tpu_torch.engine.steps import make_eval_step
        from slowfast_tpu_torch.models.build import build_model, resolve_device
        from slowfast_tpu_torch.utils import checkpoint as cu

        self.cfg = cfg
        self.device = resolve_device(device)
        self.model = build_model(cfg, self.device)
        cu.load_test_checkpoint(cfg, self.model)
        self.eval_fn = make_eval_step(cfg, self.model)

    def __call__(self, task):
        cfg = self.cfg
        inputs = [torch.from_numpy(x[None]).to(self.device) for x in host_clip(cfg, task.frames)]
        batch = {"inputs": inputs}
        if cfg.DETECTION.ENABLE:
            if task.bboxes is None or len(task.bboxes) == 0:
                task.action_preds = np.zeros((0, cfg.MODEL.NUM_CLASSES))
                return task
            boxes = np.asarray(task.bboxes, np.float32)
            scale = cfg.DATA.TEST_CROP_SIZE / min(task.frames[0].shape[:2])
            boxes = np.concatenate([np.zeros((len(boxes), 1), np.float32), boxes * scale], axis=1)
            batch["boxes"] = torch.from_numpy(boxes).to(self.device)
        task.action_preds = self.eval_fn(batch).float().cpu().numpy()
        return task


class PersonDetector:
    """Person boxes for the live detection demo: OpenCV's MOG2 background
    subtraction and connected components, no weights (the JAX package's
    fallback). ``__call__(frame_bgr)`` → ``(N, 4)`` float32 ``[x1, y1, x2,
    y2]``: the moving blobs taller than a tenth of the frame.

    The JAX package loads a torchvision Faster R-CNN when
    ``DEMO.DETECTRON2_WEIGHTS`` names a file (and raises ``NameError``
    there, ROADMAP Queue 3 #46); torchvision is not on this port's hosts
    and the weights are not in the repository, so a weights file raises."""

    def __init__(self, cfg):
        import cv2

        weights = cfg.DEMO.DETECTRON2_WEIGHTS
        if weights and os.path.exists(weights):
            raise NotImplementedError(
                f"DEMO.DETECTRON2_WEIGHTS {weights}: the torchvision Faster R-CNN person "
                "detector is not on this host; leave DEMO.DETECTRON2_WEIGHTS empty for the "
                "motion proposals, or give DEMO.PREDS_BOXES")
        self.thresh = cfg.DEMO.DETECTRON2_THRESH
        self._bg = cv2.createBackgroundSubtractorMOG2(history=120, detectShadows=False)

    def __call__(self, frame_bgr):
        import cv2

        mask = cv2.medianBlur(self._bg.apply(frame_bgr), 5)
        n, _, stats, _ = cv2.connectedComponentsWithStats((mask > 0).astype(np.uint8))
        h_img = frame_bgr.shape[0]
        boxes = [[x, y, x + w, y + h] for x, y, w, h, area in stats[1:n]
                 if area > 0.002 * mask.size and h > 0.1 * h_img]
        return np.asarray(boxes, np.float32).reshape(-1, 4)


class AsyncPredictor:
    """A worker thread that predicts while the caller draws and writes:
    results come back in order, at most ``num_inflight`` clips wait on each
    side, and an error of the predictor is raised to the caller."""

    def __init__(self, cfg, num_inflight=2, predictor=None, device="cuda"):
        self._pred = predictor if predictor is not None else Predictor(cfg, device)
        self._in = queue.Queue(maxsize=num_inflight)
        self._out = queue.Queue(maxsize=num_inflight)
        self._stop = object()
        self._t = threading.Thread(target=self._loop, daemon=True)
        self._t.start()

    def _loop(self):
        while True:
            task = self._in.get()
            if task is self._stop:
                self._out.put(self._stop)
                return
            try:
                self._out.put(self._pred(task))
            except Exception as e:  # raised to the consumer by get()
                self._out.put(e)

    def put(self, task):
        self._in.put(task)

    def get(self):
        item = self._out.get()
        if isinstance(item, Exception):
            raise item
        return None if item is self._stop else item

    def shutdown(self):
        self._in.put(self._stop)

    def run(self, tasks):
        """The predictions of ``tasks`` in order, one clip ahead in flight."""
        it = iter(tasks)
        pending = 0
        for task in itertools.islice(it, 1):
            self.put(task)
            pending += 1
        for task in it:
            self.put(task)
            pending += 1
            yield self.get()
            pending -= 1
        while pending:
            yield self.get()
            pending -= 1


def make_visualizer(cfg, top_k=True):
    return VideoVisualizer(
        num_classes=cfg.MODEL.NUM_CLASSES, class_names_path=cfg.DEMO.LABEL_FILE_PATH,
        top_k=cfg.TENSORBOARD.MODEL_VIS.TOPK_PREDS if top_k else 1,
        thres=cfg.DEMO.COMMON_CLASS_THRES, lower_thres=cfg.DEMO.UNCOMMON_CLASS_THRES,
        common_class_names=cfg.DEMO.COMMON_CLASS_NAMES, mode=cfg.DEMO.VIS_MODE)


def run_demo(cfg, frame_provider, device="cuda", predictor=None):
    """Predict, annotate and write every clip of ``frame_provider``;
    yields each task after its frames are written."""
    async_mode = cfg.DEMO.NUM_VIS_INSTANCES > 1
    if predictor is None:
        predictor = Predictor(cfg, device)
    if async_mode:
        predictor = AsyncPredictor(cfg, num_inflight=cfg.DEMO.NUM_VIS_INSTANCES,
                                   predictor=predictor)
    vis = make_visualizer(cfg)
    detector = PersonDetector(cfg) if cfg.DETECTION.ENABLE and not cfg.DEMO.PREDS_BOXES else None

    def with_boxes(tasks):
        for t in tasks:
            if detector is not None and t.bboxes is None and t.frames:
                t.bboxes = detector(t.frames[len(t.frames) // 2])
            yield t

    tasks = with_boxes(frame_provider)
    task_iter = predictor.run(tasks) if async_mode else (predictor(t) for t in tasks)
    for task in task_iter:
        task.frames = vis.draw_clip_range(task.frames, task.action_preds, bboxes=task.bboxes)
        frame_provider.display(task)
        yield task
    if async_mode:
        predictor.shutdown()


def demo(cfg, device="cuda"):
    """The demo's entry (``run_net`` calls it under ``DEMO.ENABLE``);
    returns the number of clips processed."""
    logging_utils.setup_logging(cfg.OUTPUT_DIR)
    if cfg.DETECTION.ENABLE and cfg.DEMO.PREDS_BOXES:
        return AVAVisualizerWithPrecomputedBox(cfg, device)()
    frame_provider = ThreadVideoManager(cfg) if cfg.DEMO.THREAD_ENABLE else VideoManager(cfg)
    try:
        num = sum(1 for _ in run_demo(cfg, frame_provider, device))
    finally:
        frame_provider.clean()
    logger.info("Processed %d clips.", num)
    return num


class AVAVisualizerWithPrecomputedBox:
    """The whole video in clips of ``NUM_FRAMES · SAMPLING_RATE`` frames from
    ``DEMO.STARTING_SECOND``, each predicted on the boxes of
    ``DEMO.PREDS_BOXES`` at its second (csv rows ``video,sec,x1,y1,x2,y2
    [,score]`` in normalized coordinates, kept at
    ``AVA.DETECTION_SCORE_THRESH``), with the ground truth of
    ``DEMO.GT_BOXES`` (AVA csv rows, 1-based labels) drawn over them."""

    def __init__(self, cfg, device="cuda"):
        self.cfg = cfg
        self.source = cfg.DEMO.INPUT_VIDEO
        self.pred_boxes = self._load_boxes(cfg.DEMO.PREDS_BOXES)
        self.gt_boxes = self._load_gt_boxes(cfg.DEMO.GT_BOXES)
        self.predictor = Predictor(cfg, device)
        self.vis = make_visualizer(cfg, top_k=False)

    def _load_boxes(self, path):
        boxes = defaultdict(list)
        if path:
            with open(path) as f:
                for row in csv.reader(f):
                    score = float(row[6]) if len(row) > 6 else 1.0
                    if score >= self.cfg.AVA.DETECTION_SCORE_THRESH:
                        boxes[int(row[1])].append([float(v) for v in row[2:6]])
        return boxes

    def _load_gt_boxes(self, path):
        gt = defaultdict(dict)  # sec -> {box: set(label ids)}
        if path:
            with open(path) as f:
                for row in csv.reader(f):
                    box = tuple(float(v) for v in row[2:6])
                    label = int(row[6]) - 1 if len(row) > 6 and row[6] else 0
                    gt[int(row[1])].setdefault(box, set()).add(label)
        return gt

    def __call__(self):
        import cv2

        cfg = self.cfg
        cap = cv2.VideoCapture(self.source)
        fps = cap.get(cv2.CAP_PROP_FPS) or 30
        w, h = int(cap.get(cv2.CAP_PROP_FRAME_WIDTH)), int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
        writer = None
        if cfg.DEMO.OUTPUT_FILE:
            writer = cv2.VideoWriter(cfg.DEMO.OUTPUT_FILE, cv2.VideoWriter_fourcc(*"mp4v"),
                                     float(fps), (w, h))
        seq_len = cfg.DATA.NUM_FRAMES * cfg.DATA.SAMPLING_RATE
        frames, sec, processed = [], cfg.DEMO.STARTING_SECOND, 0
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            frames.append(frame)
            if len(frames) < seq_len:
                continue
            task = TaskInfo()
            task.id, task.frames = processed, frames
            task.bboxes = [[b[0] * w, b[1] * h, b[2] * w, b[3] * h]
                           for b in self.pred_boxes.get(sec, [])]
            task = self.predictor(task)
            annotated = self.vis.draw_clip_range(task.frames, task.action_preds,
                                                 bboxes=task.bboxes,
                                                 repeat_frame=max(int(cfg.DEMO.SLOWMO), 1))
            gt = self.gt_boxes.get(int(sec), {})
            if gt:
                gt_bx = [[b[0] * w, b[1] * h, b[2] * w, b[3] * h] for b in gt]
                gt_preds = np.zeros((len(gt), cfg.MODEL.NUM_CLASSES))
                for bi, labels in enumerate(gt.values()):
                    for lb in labels:
                        if 0 <= lb < cfg.MODEL.NUM_CLASSES:
                            gt_preds[bi, lb] = 1.0
                annotated = [self.vis.draw_one_frame(fr, gt_preds, bboxes=gt_bx,
                                                     ground_truth=True) for fr in annotated]
            if writer is not None:
                for fr in annotated:
                    writer.write(fr)
            frames = []
            sec += seq_len / fps
            processed += 1
        cap.release()
        if writer is not None:
            writer.release()
        logger.info("AVA demo processed %d clips.", processed)
        return processed
