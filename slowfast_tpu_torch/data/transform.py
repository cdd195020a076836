"""Spatial and color transforms of host (T, H, W, C) clips (counterpart of
slowfast_tpu/data/transform.py:14-273, the classification subset with the
box-aware crops of detection, :275-439, the SSL colour recipe, blur and
temporal difference, and :441-547, MaskFeat's block-mask generators;
reference slowfast/datasets/transform.py).

Resizes are cv2's, as in the JAX package, so the same uint8 clip and the
same draws give the same bytes. Every random draw comes from a generator
the caller passes: ``rng``, a ``random.Random``, where the JAX package
draws from the module ``random``, and ``np_rng``, a
``np.random.RandomState``, where it draws from ``np.random``, in the same
order; no function here touches the global generators.
"""

import math

import numpy as np


def _interp(img, size_wh, interpolation="bilinear"):
    import cv2

    flag = {"bilinear": cv2.INTER_LINEAR, "bicubic": cv2.INTER_CUBIC,
            "nearest": cv2.INTER_NEAREST}[interpolation]
    return cv2.resize(img, size_wh, interpolation=flag)


def sample_jitter_size(min_size, max_size, rng, inverse_uniform_sampling=False):
    """The short-side jitter size, drawn before decoding (decode at scale)."""
    if inverse_uniform_sampling:
        return int(round(1.0 / rng.uniform(1.0 / max_size, 1.0 / min_size)))
    return int(round(rng.uniform(min_size, max_size)))


def _with(frames, boxes):
    return frames if boxes is None else (frames, boxes)


def random_short_side_scale_jitter(frames, min_size, max_size, np_rng,
                                   inverse_uniform_sampling=False, boxes=None):
    """Scale the short side to a size drawn in [min_size, max_size] (reference
    transform.py:48-98); the long side keeps the aspect, rounded down. With
    ``boxes`` (N, 4) returns ``(frames, boxes)``, the boxes scaled by the
    long side's factor."""
    if inverse_uniform_sampling:
        size = int(round(1.0 / np_rng.uniform(1.0 / max_size, 1.0 / min_size)))
    else:
        size = int(round(np_rng.uniform(min_size, max_size)))
    h, w = frames.shape[1], frames.shape[2]
    if (w <= h and w == size) or (h <= w and h == size):
        return _with(frames, boxes)
    if w < h:
        new_w, new_h = size, int(math.floor(h / w * size))
        factor = float(new_h) / h
    else:
        new_w, new_h = int(math.floor(w / h * size)), size
        factor = float(new_w) / w
    out = np.stack([_interp(f, (new_w, new_h)) for f in frames])
    return _with(out, None if boxes is None else boxes * factor)


def random_crop(frames, size, np_rng, boxes=None):
    """A ``size`` square at a random offset (reference transform.py:120-149);
    with ``boxes``, also the boxes moved by the offset."""
    h, w = frames.shape[1], frames.shape[2]
    if h == size and w == size:
        return _with(frames, boxes)
    y = int(np_rng.randint(0, h - size)) if h > size else 0
    x = int(np_rng.randint(0, w - size)) if w > size else 0
    out = frames[:, y:y + size, x:x + size]
    return _with(out, None if boxes is None else crop_boxes(boxes, x, y))


def horizontal_flip(prob, frames, np_rng, boxes=None):
    """Flip along W with probability ``prob`` (reference transform.py:152-184);
    a flipped box's x becomes ``width - x - 1``."""
    if np_rng.uniform() < prob:
        if boxes is not None:
            flipped = boxes.copy()
            flipped[:, [0, 2]] = frames.shape[2] - boxes[:, [2, 0]] - 1
            boxes = flipped
        frames = frames[:, :, ::-1]
    return _with(frames, boxes)


def uniform_crop(frames, size, spatial_idx):
    """The left/top (0), centre (1) or right/bottom (2) ``size`` square along
    the long side (reference transform.py:187-243)."""
    y, x = _uniform_offset(frames, size, spatial_idx)
    return frames[:, y:y + size, x:x + size]


def _uniform_offset(frames, size, spatial_idx):
    if spatial_idx not in (0, 1, 2):
        raise ValueError(f"spatial_idx {spatial_idx} is not 0, 1 or 2")
    h, w = frames.shape[1], frames.shape[2]
    y = int(math.ceil((h - size) / 2))
    x = int(math.ceil((w - size) / 2))
    if h > w:
        if spatial_idx == 0:
            y = 0
        elif spatial_idx == 2:
            y = h - size
    elif spatial_idx == 0:
        x = 0
    elif spatial_idx == 2:
        x = w - size
    return y, x


def uniform_crop_with_boxes(frames, size, spatial_idx, boxes):
    """``uniform_crop`` and the boxes moved by its offset."""
    y, x = _uniform_offset(frames, size, spatial_idx)
    return frames[:, y:y + size, x:x + size], crop_boxes(boxes, x, y)


def crop_boxes(boxes, x_offset, y_offset):
    """Boxes moved by a crop's offset (reference transform.py:101-117)."""
    boxes = boxes.copy()
    boxes[:, [0, 2]] -= x_offset
    boxes[:, [1, 3]] -= y_offset
    return boxes


def clip_boxes_to_image(boxes, height, width):
    """Boxes clipped to ``[0, width - 1] x [0, height - 1]``."""
    boxes = boxes.copy()
    boxes[:, [0, 2]] = np.clip(boxes[:, [0, 2]], 0, width - 1)
    boxes[:, [1, 3]] = np.clip(boxes[:, [1, 3]], 0, height - 1)
    return boxes


def _sample_resized_crop(height, width, scale, ratio, rng):
    """torchvision's RandomResizedCrop window: ten tries at a random area and
    log-uniform aspect, else the centre crop clamped to ``ratio``."""
    area = height * width
    for _ in range(10):
        target_area = area * rng.uniform(*scale)
        log_ratio = (math.log(ratio[0]), math.log(ratio[1]))
        aspect = math.exp(rng.uniform(*log_ratio))
        w = int(round(math.sqrt(target_area * aspect)))
        h = int(round(math.sqrt(target_area / aspect)))
        if 0 < w <= width and 0 < h <= height:
            return rng.randint(0, height - h), rng.randint(0, width - w), h, w
    in_ratio = width / height
    if in_ratio < ratio[0]:
        w = width
        h = int(round(w / ratio[0]))
    elif in_ratio > ratio[1]:
        h = height
        w = int(round(h * ratio[1]))
    else:
        w, h = width, height
    return (height - h) // 2, (width - w) // 2, h, w


def random_resized_crop(frames, target_height, target_width, rng, scale=(0.08, 1.0),
                        ratio=(3.0 / 4.0, 4.0 / 3.0), interpolation="bilinear"):
    """Inception-style crop, one window for the clip (reference
    transform.py:519-553)."""
    i, j, ch, cw = _sample_resized_crop(frames.shape[1], frames.shape[2], scale, ratio, rng)
    return np.stack([_interp(f, (target_width, target_height), interpolation)
                     for f in frames[:, i:i + ch, j:j + cw]])


def random_resized_crop_with_shift(frames, target_height, target_width, rng,
                                   scale=(0.08, 1.0), ratio=(3.0 / 4.0, 4.0 / 3.0),
                                   interpolation="bilinear"):
    """Motion shift: the window moves linearly from one sampled crop to another
    across the clip (reference transform.py:554-598)."""
    t, h, w = frames.shape[:3]
    i, j, ch, cw = _sample_resized_crop(h, w, scale, ratio, rng)
    i_, j_, ch_, cw_ = _sample_resized_crop(h, w, scale, ratio, rng)
    i_s, j_s, h_s, w_s = (np.linspace(a, b, t).astype(np.int64)
                          for a, b in ((i, i_), (j, j_), (ch, ch_), (cw, cw_)))
    out = np.empty((t, target_height, target_width, frames.shape[3]), frames.dtype)
    for k in range(t):
        crop = frames[k, i_s[k]:i_s[k] + h_s[k], j_s[k]:j_s[k] + w_s[k]]
        out[k] = _interp(crop, (target_width, target_height), interpolation)
    return out


# Color ops on float (T, H, W, C) clips in [0, 1] (reference
# transform.py:268-476).

def blend(a, b, alpha):
    return a * alpha + b * (1.0 - alpha)


def grayscale(frames):
    g = 0.299 * frames[..., 0] + 0.587 * frames[..., 1] + 0.114 * frames[..., 2]
    return np.repeat(g[..., None], 3, axis=-1)


def brightness_jitter(var, frames, np_rng):
    alpha = 1.0 + np_rng.uniform(-var, var)
    return blend(frames, np.zeros_like(frames), alpha)


def contrast_jitter(var, frames, np_rng):
    alpha = 1.0 + np_rng.uniform(-var, var)
    g = grayscale(frames)
    g[:] = g.mean(axis=(1, 2, 3), keepdims=True)
    return blend(frames, g, alpha)


def saturation_jitter(var, frames, np_rng):
    alpha = 1.0 + np_rng.uniform(-var, var)
    return blend(frames, grayscale(frames), alpha)


_JITTERS = {"brightness": brightness_jitter, "contrast": contrast_jitter,
            "saturation": saturation_jitter}


def color_jitter(frames, np_rng, img_brightness=0, img_contrast=0, img_saturation=0):
    """The non-zero jitters in a random order (reference transform.py:312-345)."""
    jitter = [(name, var) for name, var in (("brightness", img_brightness),
                                            ("contrast", img_contrast),
                                            ("saturation", img_saturation)) if var != 0]
    if jitter:
        for idx in np_rng.permutation(len(jitter)):
            name, var = jitter[idx]
            frames = _JITTERS[name](var, frames, np_rng)
    return frames


def lighting_jitter(frames, alphastd, eigval, eigvec, np_rng):
    """AlexNet-style PCA lighting noise (reference transform.py:392-428)."""
    if alphastd == 0:
        return frames
    alpha = np_rng.normal(0, alphastd, size=(1, 3))
    rgb = np.sum(np.asarray(eigvec) * alpha * np.asarray(eigval).reshape(1, 3), axis=1)
    return frames + rgb.reshape(1, 1, 1, 3).astype(frames.dtype)


def color_normalization(frames, mean, stddev):
    mean = np.asarray(mean, frames.dtype).reshape(1, 1, 1, -1)
    stddev = np.asarray(stddev, frames.dtype).reshape(1, 1, 1, -1)
    return (frames - mean) / stddev


# SSL augmentations (slowfast_tpu/data/transform.py:275-439, reference
# transform.py:1047-1180) on float (T, H, W, C) clips.

def _tv_brightness(frames, factor):
    """torchvision ``adjust_brightness``: ``img * factor``."""
    return np.clip(frames * factor, 0.0, 1.0)


def _tv_contrast(frames, factor):
    """torchvision ``adjust_contrast``: a blend with the clip's mean gray."""
    mean = grayscale(frames)[..., 0].mean()
    return np.clip(frames * factor + mean * (1.0 - factor), 0.0, 1.0)


def _tv_saturation(frames, factor):
    """torchvision ``adjust_saturation``: a blend with each pixel's gray."""
    return np.clip(frames * factor + grayscale(frames) * (1.0 - factor), 0.0, 1.0)


def _tv_hue(frames, factor):
    """torchvision ``adjust_hue``: the hue turned by ``factor`` (in turns)
    through HSV."""
    r, g, b = frames[..., 0], frames[..., 1], frames[..., 2]
    maxc = frames.max(axis=-1)
    minc = frames.min(axis=-1)
    v = maxc
    delta = maxc - minc
    s = np.where(maxc > 0, delta / np.maximum(maxc, 1e-12), 0.0)
    dz = np.maximum(delta, 1e-12)
    rc, gc, bc = (maxc - r) / dz, (maxc - g) / dz, (maxc - b) / dz
    h = np.where(maxc == r, bc - gc, np.where(maxc == g, 2.0 + rc - bc, 4.0 + gc - rc))
    h = (h / 6.0) % 1.0
    h = np.where(delta == 0, 0.0, h)
    h = (h + factor) % 1.0
    i = np.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    i = i.astype(np.int32) % 6
    out = np.stack([np.choose(i, [v, q, p, p, t, v]), np.choose(i, [t, v, v, q, p, p]),
                    np.choose(i, [p, p, t, v, v, q])], axis=-1)
    return out.astype(frames.dtype)


def _gaussian_blur_frames(frames, sigma):
    """Each frame blurred spatially with a Gaussian of ``sigma`` (scipy,
    edges repeated)."""
    from scipy.ndimage import gaussian_filter

    return gaussian_filter(frames, sigma=(0.0, sigma, sigma, 0.0), mode="nearest").astype(
        frames.dtype)


def color_jitter_video_ssl(frames, rng, bri_con_sat=(0.4, 0.4, 0.4), hue=0.1,
                           p_convert_gray=0.0, moco_v2_aug=False):
    """The SSL colour recipe on a float [0, 1] clip, one draw for all its
    frames (:339): torchvision's ColorJitter (brightness, contrast,
    saturation, hue in a random order); with ``moco_v2_aug`` MoCo-v2's
    recipe: the jitter with p 0.8, grayscale with ``p_convert_gray``, a
    Gaussian blur of sigma U(0.1, 2) with p 0.5 (the JAX package's fixed
    range; it ignores ``DATA.SSL_BLUR_SIGMA_*``); else grayscale, then the
    jitter. Draws from ``rng`` (a ``random.Random``)."""

    def jitter(f):
        ops = []
        for var, op in zip(bri_con_sat, (_tv_brightness, _tv_contrast, _tv_saturation)):
            if var > 0:
                fac = rng.uniform(max(0.0, 1 - var), 1 + var)
                ops.append(lambda x, fac=fac, op=op: op(x, fac))
        if hue > 0:
            fac = rng.uniform(-hue, hue)
            ops.append(lambda x, fac=fac: _tv_hue(x, fac))
        rng.shuffle(ops)
        for op in ops:
            f = op(f)
        return f

    frames = np.asarray(frames, np.float32)
    if moco_v2_aug:
        if rng.random() < 0.8:
            frames = jitter(frames)
        if rng.random() < p_convert_gray:
            frames = grayscale(frames)
        if rng.random() < 0.5:
            frames = _gaussian_blur_frames(frames, rng.uniform(0.1, 2.0))
    else:
        if rng.random() < p_convert_gray:
            frames = grayscale(frames)
        frames = jitter(frames)
    return frames


class GaussianBlurVideo:
    """A Gaussian blur of a (T, H, W, C) clip over space (sigma drawn in
    ``[sigma_min[1], sigma_max[1]]``) and time (``[sigma_min[0],
    sigma_max[0]]``), never over channels (:389)."""

    def __init__(self, sigma_min=(0.0, 0.1), sigma_max=(0.0, 2.0)):
        self.sigma_min = sigma_min
        self.sigma_max = sigma_max

    def __call__(self, frames, rng):
        from scipy.ndimage import gaussian_filter

        sigma_s = rng.uniform(self.sigma_min[1], self.sigma_max[1])
        sigma_t = rng.uniform(self.sigma_min[0], self.sigma_max[0])
        return gaussian_filter(np.asarray(frames, np.float32),
                               sigma=(sigma_t, sigma_s, sigma_s, 0.0), mode="nearest")


def temporal_difference(frames, use_grayscale=False, absolute=False):
    """Each frame minus the next (the last repeats the one before), of the
    gray clip under ``use_grayscale`` (:409)."""
    frames = np.asarray(frames, np.float32)
    if use_grayscale:
        frames = grayscale(frames)
    t = frames.shape[0]
    out = np.zeros_like(frames)
    dt = frames[: t - 1] - frames[1:]
    if absolute:
        dt = np.abs(dt)
    out[: t - 1] = dt
    if t > 1:
        out[-1] = dt[-1]
    return out


def augment_raw_frames(frames, rng, time_diff_prob=0.0, gaussian_prob=0.0):
    """SSL augmentation of raw (0..255) frames (:425): a video blur with
    ``gaussian_prob``, then, with ``time_diff_prob``, the gray temporal
    difference mapped back to 0..255. Returns ``(frames, time_diff_applied)``."""
    frames = np.asarray(frames, np.float32)
    if gaussian_prob > 0.0 and rng.random() < gaussian_prob:
        frames = GaussianBlurVideo()(frames, rng)
    if time_diff_prob > 0.0 and rng.random() < time_diff_prob:
        frames = (temporal_difference(frames, use_grayscale=True) + 255.0) / 2.0
        return frames, True
    return frames, False


class MaskingGenerator:
    """2D block masking of an ``(h, w)`` window (slowfast_tpu/data/transform.py:441,
    reference transform.py:776-868): blocks of random area and aspect are
    added until ``num_masking_patches`` cells are masked or a block cannot
    be placed; the draws come from ``rng`` (a ``random.Random``)."""

    def __init__(self, mask_window_size, num_masking_patches, min_num_patches=4,
                 max_num_patches=None, min_aspect=0.3, max_aspect=None):
        if isinstance(mask_window_size, int):
            mask_window_size = (mask_window_size,) * 2
        self.height, self.width = mask_window_size
        self.num_masking_patches = num_masking_patches
        self.min_num_patches = min_num_patches
        self.max_num_patches = (num_masking_patches if max_num_patches is None
                                else max_num_patches)
        max_aspect = max_aspect or 1 / min_aspect
        self.log_aspect_ratio = (math.log(min_aspect), math.log(max_aspect))

    def _mask(self, mask, max_mask_patches, rng):
        delta = 0
        for _ in range(10):
            target_area = rng.uniform(self.min_num_patches, max_mask_patches)
            aspect_ratio = math.exp(rng.uniform(*self.log_aspect_ratio))
            h = int(round(math.sqrt(target_area * aspect_ratio)))
            w = int(round(math.sqrt(target_area / aspect_ratio)))
            if w < self.width and h < self.height:
                top = rng.randint(0, self.height - h)
                left = rng.randint(0, self.width - w)
                block = mask[top:top + h, left:left + w]
                num_masked = block.sum()
                if 0 < h * w - num_masked <= max_mask_patches:
                    delta += int((block == 0).sum())
                    block[...] = 1
                if delta > 0:
                    break
        return delta

    def __call__(self, rng):
        mask = np.zeros((self.height, self.width), np.int64)
        mask_count = 0
        while mask_count < self.num_masking_patches:
            max_mask_patches = min(self.num_masking_patches - mask_count, self.max_num_patches)
            delta = self._mask(mask, max_mask_patches, rng)
            if delta == 0:
                break
            mask_count += delta
        return mask


class MaskingGenerator3D:
    """3D (tube) block masking of a ``(t, h, w)`` window
    (slowfast_tpu/data/transform.py:499, reference transform.py:869-947); the
    draws come from ``rng`` (a ``random.Random``)."""

    def __init__(self, mask_window_size, num_masking_patches, min_num_patches=4,
                 max_num_patches=None, min_aspect=0.3, max_aspect=None):
        self.temporal, self.height, self.width = mask_window_size
        self.num_masking_patches = num_masking_patches
        self.min_num_patches = min_num_patches
        self.max_num_patches = (num_masking_patches if max_num_patches is None
                                else max_num_patches)
        max_aspect = max_aspect or 1 / min_aspect
        self.log_aspect_ratio = (math.log(min_aspect), math.log(max_aspect))

    def _mask(self, mask, max_mask_patches, rng):
        delta = 0
        for _ in range(10):
            target_area = rng.uniform(self.min_num_patches, max_mask_patches)
            aspect_ratio = math.exp(rng.uniform(*self.log_aspect_ratio))
            h = int(round(math.sqrt(target_area * aspect_ratio)))
            w = int(round(math.sqrt(target_area / aspect_ratio)))
            t = rng.randint(1, self.temporal)
            if w < self.width and h < self.height:
                top = rng.randint(0, self.height - h)
                left = rng.randint(0, self.width - w)
                t0 = rng.randint(0, self.temporal - t)
                block = mask[t0:t0 + t, top:top + h, left:left + w]
                num_masked = block.sum()
                if 0 < t * h * w - num_masked <= max_mask_patches:
                    block[...] = 1
                    delta += t * h * w - num_masked
                if delta > 0:
                    break
        return delta

    def __call__(self, rng):
        mask = np.zeros((self.temporal, self.height, self.width), np.int64)
        mask_count = 0
        while mask_count < self.num_masking_patches:
            max_mask_patches = min(self.num_masking_patches - mask_count, self.max_num_patches)
            delta = self._mask(mask, max_mask_patches, rng)
            if delta == 0:
                break
            mask_count += delta
        return mask
