"""RandAugment for uint8 (T, H, W, C) clips (counterpart of
slowfast_tpu/data/rand_augment.py; reference slowfast/datasets/
rand_augment.py, timm's ``rand-mN-mstdS[-incX]`` policies).

The ops are PIL's, as in the JAX package; PIL is imported on the first
call, so the port imports without it. Per clip, ``num_layers`` ops and their
magnitudes are drawn once from the ``random.Random`` the caller passes, and
applied to every frame.
"""

import functools
import re

import numpy as np

_MAX_LEVEL = 10.0
_FILL = (128, 128, 128)
_ENHANCE = ("Color", "Contrast", "Brightness", "Sharpness")


def _solarize_add(img, add, thresh=128):
    lut = [min(255, i + add) if i < thresh else i for i in range(256)]
    return img.point(lut * len(img.getbands()))


@functools.cache
def ops():
    """Op name -> ``f(img, arg)`` on PIL images."""
    from PIL import Image, ImageEnhance, ImageOps

    def affine(img, coeffs):
        return img.transform(img.size, Image.AFFINE, coeffs, fillcolor=_FILL)

    table = {
        "AutoContrast": lambda img, _: ImageOps.autocontrast(img),
        "Equalize": lambda img, _: ImageOps.equalize(img),
        "Invert": lambda img, _: ImageOps.invert(img),
        "Rotate": lambda img, degrees: img.rotate(degrees, fillcolor=_FILL),
        "Posterize": lambda img, bits: ImageOps.posterize(img, int(bits)),
        "Solarize": lambda img, thresh: ImageOps.solarize(img, int(thresh)),
        "SolarizeAdd": lambda img, add: _solarize_add(img, int(add)),
        "ShearX": lambda img, f: affine(img, (1, f, 0, 0, 1, 0)),
        "ShearY": lambda img, f: affine(img, (1, 0, 0, f, 1, 0)),
        "TranslateXRel": lambda img, v: affine(img, (1, 0, v * img.size[0], 0, 1, 0)),
        "TranslateYRel": lambda img, v: affine(img, (1, 0, 0, 0, 1, v * img.size[1])),
    }
    for name in _ENHANCE:
        enhance = getattr(ImageEnhance, name)
        table[name] = table[name + "Increasing"] = (
            lambda img, f, enhance=enhance: enhance(img).enhance(f))
    table["PosterizeIncreasing"] = table["Posterize"]
    table["SolarizeIncreasing"] = table["Solarize"]
    return table


_RAND_TRANSFORMS = ["AutoContrast", "Equalize", "Invert", "Rotate", "Posterize", "Solarize",
                    "SolarizeAdd", "Color", "Contrast", "Brightness", "Sharpness", "ShearX",
                    "ShearY", "TranslateXRel", "TranslateYRel"]
# timm's rand-increasing set: the same ops, magnitudes that grow with the level.
_RAND_INCREASING_TRANSFORMS = [
    n + "Increasing" if n in ("Posterize", "Solarize") + _ENHANCE else n
    for n in _RAND_TRANSFORMS]


def _level_arg(name, level, rng):
    """The op's argument at ``level``, drawing its sign from ``rng`` where it
    has one (the JAX package's table, draw for draw)."""
    m = level / _MAX_LEVEL
    if name == "Rotate":
        return rng.choice([-m * 30.0, m * 30.0])
    if name in ("ShearX", "ShearY"):
        return rng.choice([-m * 0.3, m * 0.3])
    if name in ("TranslateXRel", "TranslateYRel"):
        return m * 0.45 * rng.choice([-1, 1])
    if name == "Posterize":
        return max(1, int(4 - m * 4) + 4)
    if name == "PosterizeIncreasing":
        return max(1, 4 - int(m * 4) + 4 - 4)
    if name == "Solarize":
        return int(256 - m * 256)
    if name == "SolarizeIncreasing":
        return int(256 - (256 - m * 256))
    if name == "SolarizeAdd":
        return int(m * 110)
    if name.replace("Increasing", "") in _ENHANCE:
        return 1.0 + m * 0.9 * rng.choice([-1, 1])
    return None


class RandAugment:
    def __init__(self, num_layers=2, magnitude=9, mstd=0.5, increasing=True, hparams=None):
        self.num_layers = num_layers
        self.magnitude = magnitude
        self.mstd = mstd
        self.transforms = _RAND_INCREASING_TRANSFORMS if increasing else _RAND_TRANSFORMS
        self.hparams = hparams or {}

    def _sample_level(self, rng):
        level = rng.gauss(self.magnitude, self.mstd) if self.mstd > 0 else self.magnitude
        return min(_MAX_LEVEL, max(0, level))

    def __call__(self, frames, rng):
        chosen = [rng.choice(self.transforms) for _ in range(self.num_layers)]
        plans = []
        for name in chosen:
            level = self._sample_level(rng)
            plans.append((name, _level_arg(name, level, rng)))
        from PIL import Image

        table = ops()
        out = []
        for frame in frames:
            img = Image.fromarray(frame)
            for name, arg in plans:
                img = table[name](img, arg)
            out.append(np.asarray(img))
        return np.stack(out)


def rand_augment_transform(config_str, hparams):
    """The policy of a timm string such as ``rand-m9-mstd0.5-inc1``."""
    magnitude, num_layers, mstd, increasing = 9, 2, 0.5, False
    parts = config_str.split("-")
    if parts[0] != "rand":
        raise ValueError(f"not a RandAugment policy: {config_str!r}")
    for p in parts[1:]:
        m = re.match(r"([a-z]+)([0-9.]+)", p)
        if not m:
            continue
        key, val = m.group(1), m.group(2)
        if key == "m":
            magnitude = float(val)
        elif key == "n":
            num_layers = int(val)
        elif key == "mstd":
            mstd = float(val)
        elif key == "inc":
            increasing = bool(int(val))
    return RandAugment(num_layers, magnitude, mstd, increasing, hparams)
