"""Frame annotation for the demo (counterpart of
slowfast_tpu/visualization/video_visualizer.py; reference
slowfast/visualization/video_visualizer.py, which draws through
detectron2's Visualizer).

``VideoVisualizer`` draws with cv2: the top-k or thresholded labels of a
clip, or a box and its labels for each person, each label on a filled
background in its class's colour, over a range of frames around the
keyframe. The class colours come from a matplotlib colormap where
matplotlib imports; otherwise from the JAX package's seeded fallback
(``RandomState(0)``), so a host without matplotlib draws what the JAX
package draws there.
"""

import numpy as np

from .tensorboard_vis import load_class_names


def class_names_or_ids(path, num_classes):
    """The names of ``path``'s classes; without a path, the ids."""
    if not path:
        return [str(i) for i in range(num_classes)]
    names = load_class_names(path, num_classes)
    if names is None:
        raise IOError(f"cannot read the class names in {path}")
    return names


def class_colors(num_classes, colormap):
    """One RGB triple of ints a class: ``colormap(id / num_classes)``, or
    seeded draws in [64, 255) without matplotlib."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        cmap = matplotlib.colormaps[colormap]
        return [tuple(int(c * 255) for c in cmap(i / max(num_classes, 1))[:3])
                for i in range(num_classes)]
    except Exception:  # no matplotlib, or no such colormap
        rs = np.random.RandomState(0)
        return [tuple(int(v) for v in rs.randint(64, 255, 3)) for _ in range(num_classes)]


class VideoVisualizer:
    def __init__(self, num_classes, class_names_path="", top_k=1, colormap="rainbow",
                 thres=0.7, lower_thres=0.3, common_class_names=None, mode="top-k"):
        if mode not in ("top-k", "thres"):
            raise ValueError(f"unknown VIS_MODE {mode!r}: top-k or thres")
        self.num_classes = num_classes
        self.class_names = class_names_or_ids(class_names_path, num_classes)
        self.top_k = top_k
        self.thres = thres
        self.lower_thres = lower_thres
        self.common_class_names = set(common_class_names or [])
        self.mode = mode
        self._colors = class_colors(num_classes, colormap)

    def _get_color(self, class_id):
        return self._colors[int(class_id) % len(self._colors)]

    def _pred_labels(self, preds):
        """``[(class id, name, score)]``: the top k, or every class at or
        above its threshold (the lower one for the common classes)."""
        preds = np.asarray(preds).reshape(-1)
        if self.mode == "top-k":
            return [(int(i), self.class_names[i], float(preds[i]))
                    for i in np.argsort(-preds)[:self.top_k]]
        out = []
        for i, p in enumerate(preds):
            name = self.class_names[i]
            if p >= (self.lower_thres if name in self.common_class_names else self.thres):
                out.append((int(i), name, float(p)))
        return out

    def _draw_text(self, img, text, org, color, alpha=0.7, font_scale=0.5):
        """Black text on a filled box of ``color`` blended at ``alpha``, kept
        inside the frame."""
        import cv2

        (tw, th), baseline = cv2.getTextSize(text, cv2.FONT_HERSHEY_SIMPLEX, font_scale, 1)
        x = max(0, min(int(org[0]), img.shape[1] - tw - 2))
        y = max(th + 2, min(int(org[1]), img.shape[0] - 2))
        overlay = img.copy()
        cv2.rectangle(overlay, (x, y - th - baseline), (x + tw + 2, y + 2), color, -1)
        cv2.addWeighted(overlay, alpha, img, 1 - alpha, 0, dst=img)
        cv2.putText(img, text, (x + 1, y - baseline // 2), cv2.FONT_HERSHEY_SIMPLEX,
                    font_scale, (0, 0, 0), 1, cv2.LINE_AA)

    def draw_one_frame(self, frame, preds, bboxes=None, alpha=0.7, text_alpha=0.7,
                       ground_truth=False):
        """One annotated copy of an HWC uint8 frame. ``preds`` is
        ``(num_classes,)`` for a clip or ``(N, num_classes)`` for N boxes;
        ``ground_truth`` draws green boxes and labels prefixed ``[GT]``."""
        import cv2

        img = np.ascontiguousarray(frame)
        if bboxes is not None and len(np.asarray(bboxes).reshape(-1)) > 0:
            boxes = np.asarray(bboxes).reshape(-1, 4)
            preds_arr = np.asarray(preds)
            per_box = preds_arr.ndim == 2 and preds_arr.shape[0] == len(boxes)
            for bi, box in enumerate(boxes):
                x1, y1, x2, y2 = [int(v) for v in box]
                labels = self._pred_labels(preds_arr[bi] if per_box else preds_arr)
                box_color = ((80, 255, 80) if ground_truth
                             else self._get_color(labels[0][0] if labels else 0))
                cv2.rectangle(img, (x1, y1), (x2, y2), box_color, 2)
                prefix = "[GT] " if ground_truth else ""
                for li, (cid, name, score) in enumerate(labels):
                    self._draw_text(img, f"{prefix}{name}: {score:.2f}", (x1, y1 + 16 * (li + 1)),
                                    self._get_color(cid), alpha=text_alpha)
        else:
            for li, (cid, name, score) in enumerate(self._pred_labels(preds)):
                self._draw_text(img, f"{name}: {score:.2f}", (10, 25 + 18 * li),
                                self._get_color(cid), alpha=text_alpha)
        return img

    def draw_clip_range(self, frames, preds, bboxes=None, text_alpha=0.7, keyframe_idx=None,
                        draw_range=None, repeat_frame=1):
        """The frames with those in ``draw_range`` annotated (a quarter of
        the clip each side of ``keyframe_idx`` when given, else all), each
        repeated ``repeat_frame`` times."""
        frames = list(frames)
        n = len(frames)
        if draw_range is None:
            if keyframe_idx is not None:
                half = max(n // 4, 1)
                draw_range = (max(keyframe_idx - half, 0), min(keyframe_idx + half, n - 1))
            else:
                draw_range = (0, n - 1)
        lo, hi = int(draw_range[0]), int(draw_range[1])
        out = [self.draw_one_frame(f, preds, bboxes=bboxes, text_alpha=text_alpha)
               if lo <= i <= hi else np.ascontiguousarray(f) for i, f in enumerate(frames)]
        if repeat_frame > 1:
            out = [f for f in out for _ in range(repeat_frame)]
        return out
