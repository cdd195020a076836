"""Narrow models that the visualization tests share, on both packages.

``slow`` is a Slow R18 (width 8, 4 frames of 32², 6 classes), ``slowfast``
the narrow SLOWFAST_4x16_R50 of tests/test_torch_slowfast.py and ``mvit``
the narrow MVITv2_S_16x4 of tests/test_torch_mvit.py (4 blocks, token grids
14 → 7 → 4, the cls token). The JAX variables are shaped by a traced
``init_model`` and filled with those tests' seeded values; the port's model
takes them through the weight bridge. The inputs are the pathways the
port's eval step makes of seeded uint8 clips (its preprocess in fp32),
which both packages' models take.
"""

import contextlib
import os

import jax
import pytest
import numpy as np
import torch

from slowfast_tpu.config import get_cfg as jax_get_cfg
from slowfast_tpu.models import build_model as jax_build_model
from slowfast_tpu.models.build import init_model
from slowfast_tpu_torch.config import get_cfg
from slowfast_tpu_torch.engine.steps import maybe_device_preprocess
from slowfast_tpu_torch.models.build import build_model
from slowfast_tpu_torch.utils.checkpoint import state_dict_from_jax

import test_torch_mvit
import test_torch_slowfast

CONFIGS = os.path.join(os.path.dirname(__file__), "..", "configs")
SLOW = ["MODEL.MODEL_NAME", "ResNet", "MODEL.ARCH", "slow", "RESNET.DEPTH", "18",
        "RESNET.WIDTH_PER_GROUP", "8", "RESNET.NUM_BLOCK_TEMP_KERNEL", "[[2],[2],[2],[2]]",
        "DATA.INPUT_CHANNEL_NUM", "[3]", "DATA.NUM_FRAMES", "4", "DATA.TRAIN_CROP_SIZE", "32",
        "DATA.TEST_CROP_SIZE", "32", "MODEL.NUM_CLASSES", "6", "MODEL.DROPOUT_RATE", "0.0",
        "NUM_GPUS", "1"]
# name -> (yaml, options, the JAX tests' randomize, test crop)
MODELS = {
    "slow": (None, SLOW, test_torch_slowfast.randomize, 32),
    "slowfast": (test_torch_slowfast.YAML, test_torch_slowfast.NARROW,
                 test_torch_slowfast.randomize, 40),
    "mvit": (test_torch_mvit.YAML, test_torch_mvit.NARROW, test_torch_mvit.randomize, 56),
}


def model_cfg(get, name, extra=()):
    yaml, opts, _, _ = MODELS[name]
    cfg = get()
    if yaml:
        cfg.merge_from_file(yaml)
    cfg.merge_from_list(list(opts) + ["TPU.COMPUTE_DTYPE", "float32"] + list(extra))
    return cfg


def jit_run(fn, *args):
    """``jax.jit(fn)(*args)`` compiled at XLA's CPU optimization level 0
    (as tests/test_torch_mvit_family.py does: a shorter compile)."""
    compiled = jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_backend_optimization_level": "0"})
    return compiled(*args)


@contextlib.contextmanager
def jitted_jax_init():
    """The JAX package's ``init_model`` compiled (``jit_run``) where it is
    called eagerly, as its demo's ``Predictor`` calls it (eager, a narrow
    ResNet's init dispatches hundreds of small compiles: 25 s), and the
    ``create_train_state`` that follows it given those variables instead of
    compiling the init again (the checkpoint's weights replace them)."""
    from slowfast_tpu.engine import steps as jax_steps
    from slowfast_tpu.models import build as jax_build

    real_init, real_state = jax_build.init_model, jax_steps.create_train_state
    last = {}

    def init_model(model, cfg, rng=None, train=True):
        if rng is None or isinstance(rng, jax.core.Tracer):
            return real_init(model, cfg, rng=rng, train=train)
        last["variables"] = jit_run(lambda r: real_init(model, cfg, rng=r, train=train), rng)
        return last["variables"]

    def create_train_state(cfg, model, tx, rng=None, variables=None):
        if variables is None:
            variables = last.pop("variables", None)
        return real_state(cfg, model, tx, rng=rng, variables=variables)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_build, "init_model", init_model)
        mp.setattr(jax_steps, "create_train_state", create_train_state)
        yield


def jax_path(name):
    """A PySlowFast layer name as the JAX package's module path:
    ``blocks/1`` is its ``blocks_1``."""
    parts = name.split("/")
    if parts[0] == "blocks":
        return "/".join([f"blocks_{parts[1]}"] + parts[2:])
    return name


class Pair:
    """The JAX model and variables, and the port's model on the same
    weights, of one of ``MODELS``."""

    def __init__(self, name, seed=0):
        self.name = name
        self.jax_cfg = model_cfg(jax_get_cfg, name)
        self.jax_model = jax_build_model(self.jax_cfg)
        shapes = jax.eval_shape(lambda: init_model(self.jax_model, self.jax_cfg,
                                                   rng=jax.random.PRNGKey(0), train=False))
        self.variables = MODELS[name][2](dict(shapes), seed)
        self.cfg = model_cfg(get_cfg, name)
        self.model = build_model(self.cfg, device="cpu")
        self.model.load_state_dict(state_dict_from_jax(self.variables), strict=True)
        self.model.eval()

    def pathways(self, n=2, seed=1):
        """The fp32 pathways of ``n`` seeded uint8 clips, as torch tensors."""
        crop = MODELS[self.name][3]
        clips = np.random.RandomState(seed).randint(
            0, 256, (n, self.cfg.DATA.NUM_FRAMES, crop, crop, 3)).astype(np.uint8)
        return maybe_device_preprocess(self.cfg, [torch.from_numpy(clips)])
