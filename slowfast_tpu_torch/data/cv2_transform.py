"""cv2 transforms of lists of (H, W, C) float images with their (N, 4) pixel
boxes, for AVA (counterpart of slowfast_tpu/data/cv2_transform.py; reference
slowfast/datasets/cv2_transform.py).

Every random draw comes from ``np_rng``, a ``np.random.RandomState``, where
the JAX package draws from ``np.random``, in the same order.
"""

import math

import numpy as np

from .transform import clip_boxes_to_image  # noqa: F401  (this module's API, as in JAX's)


def scale(size, image):
    """The short side scaled to ``size`` (bilinear), the long side keeping the
    aspect, rounded down; an image already at ``size`` is returned as is."""
    import cv2

    height, width = image.shape[0], image.shape[1]
    if (width <= height and width == size) or (height <= width and height == size):
        return image
    if width < height:
        new_width, new_height = size, int(math.floor(height / width * size))
    else:
        new_height, new_width = size, int(math.floor(width / height * size))
    return cv2.resize(image, (new_width, new_height),
                      interpolation=cv2.INTER_LINEAR).astype(np.float32)


def scale_boxes(size, boxes, height, width):
    """Boxes scaled as ``scale`` scales an image of ``height x width``."""
    if (width <= height and width == size) or (height <= width and height == size):
        return boxes
    return boxes * (size / width if width < height else size / height)


def random_short_side_scale_jitter_list(images, min_size, max_size, np_rng, boxes=None):
    size = int(round(np_rng.uniform(min_size, max_size)))
    height, width = images[0].shape[0], images[0].shape[1]
    if boxes is not None:
        boxes = [scale_boxes(size, b, height, width) for b in boxes]
    return [scale(size, img) for img in images], boxes


def _crop(images, boxes, x_offset, y_offset, size):
    cropped = [img[y_offset:y_offset + size, x_offset:x_offset + size] for img in images]
    if boxes is not None:
        shift = np.array([[x_offset, y_offset, x_offset, y_offset]], np.float32)
        boxes = [b - shift for b in boxes]
    return cropped, boxes


def random_crop_list(images, size, np_rng, boxes=None):
    height, width = images[0].shape[0], images[0].shape[1]
    if height == size and width == size:
        return images, boxes
    y_offset = np_rng.randint(0, max(height - size, 0) + 1)
    x_offset = np_rng.randint(0, max(width - size, 0) + 1)
    return _crop(images, boxes, x_offset, y_offset, size)


def spatial_shift_crop_list(size, images, spatial_shift_pos, boxes=None):
    """The left/top (0), centre (1) or right/bottom (2) ``size`` square."""
    if spatial_shift_pos not in (0, 1, 2):
        raise ValueError(f"spatial_shift_pos {spatial_shift_pos} is not 0, 1 or 2")
    height, width = images[0].shape[0], images[0].shape[1]
    y_offset = int(math.ceil((height - size) / 2))
    x_offset = int(math.ceil((width - size) / 2))
    if height > width:
        if spatial_shift_pos == 0:
            y_offset = 0
        elif spatial_shift_pos == 2:
            y_offset = height - size
    elif spatial_shift_pos == 0:
        x_offset = 0
    elif spatial_shift_pos == 2:
        x_offset = width - size
    return _crop(images, boxes, x_offset, y_offset, size)


def horizontal_flip_list(prob, images, np_rng, boxes=None):
    if np_rng.uniform() < prob:
        width = images[0].shape[1]
        images = [np.ascontiguousarray(img[:, ::-1]) for img in images]
        if boxes is not None:
            boxes = [flip_boxes(b, width) for b in boxes]
    return images, boxes


def flip_boxes(boxes, im_width):
    flipped = boxes.copy()
    flipped[:, 0] = im_width - boxes[:, 2] - 1
    flipped[:, 2] = im_width - boxes[:, 0] - 1
    return flipped


def color_normalization(image, mean, stddev):
    mean = np.asarray(mean, np.float32).reshape(1, 1, -1)
    stddev = np.asarray(stddev, np.float32).reshape(1, 1, -1)
    return (image - mean) / stddev


def PCA_jitter(image, alphastd, eigval, eigvec, np_rng):
    """AlexNet-style PCA lighting noise, one draw per image."""
    alpha = np_rng.normal(0, alphastd, size=(1, 3))
    rgb = np.sum(np.asarray(eigvec) * alpha * np.asarray(eigval).reshape(1, 3), axis=1)
    return image + rgb.reshape(1, 1, 3).astype(image.dtype)
