"""The port stands alone: nothing in ``slowfast_tpu_torch/`` or in
``chip_smoke.py`` imports JAX, flax, the JAX package ``slowfast_tpu``
(matched as a module name, so ``slowfast_tpu_torch`` itself is allowed) or
sklearn, which the card's host may lack. cv2 and PIL, which it may lack
too, are imported only inside the functions that decode, resize or
augment: every module of the port imports, and the eval step runs, with
all three unimportable."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "flax", "slowfast_tpu", "sklearn")


def _forbidden(module):
    return any(module == f or module.startswith(f + ".") for f in FORBIDDEN)


def _sources():
    """Every source of the port; the build directory holds no source."""
    files = sorted(p for p in (ROOT / "slowfast_tpu_torch").rglob("*.py")
                   if "_build" not in p.relative_to(ROOT).parts)
    files.append(ROOT / "chip_smoke.py")
    return [pytest.param(f, id=str(f.relative_to(ROOT))) for f in files]


@pytest.mark.parametrize("path", _sources())
def test_no_jax_import_in_source(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module]
        elif (isinstance(node, ast.Call) and node.args
              and isinstance(node.args[0], ast.Constant)
              and isinstance(node.args[0].value, str)
              and getattr(node.func, "attr", getattr(node.func, "id", "")) in
              ("import_module", "__import__")):
            names = [node.args[0].value]
        else:
            continue
        bad = [n for n in names if _forbidden(n)]
        assert not bad, f"{path.name}:{node.lineno} imports {bad}"


def test_port_runs_without_jax_loaded():
    """Import every module of the port, build the model on the CPU and run
    an eval step with cv2, PIL and sklearn unimportable; jax, flax and
    slowfast_tpu stay out of sys.modules."""
    code = r"""
import importlib, pkgutil, sys
for m in ("cv2", "PIL", "sklearn"):
    sys.modules[m] = None  # import raises ImportError
import numpy as np, torch
import slowfast_tpu_torch
for m in pkgutil.walk_packages(slowfast_tpu_torch.__path__, "slowfast_tpu_torch."):
    importlib.import_module(m.name)
from slowfast_tpu_torch.config import get_cfg
from slowfast_tpu_torch.engine.steps import make_eval_step
from slowfast_tpu_torch.models.build import build_model
cfg = get_cfg()
cfg.merge_from_list(["MODEL.ARCH", "slowfast", "MODEL.MODEL_NAME", "SlowFast",
    "RESNET.DEPTH", "18", "RESNET.WIDTH_PER_GROUP", "8", "DATA.NUM_FRAMES", "8",
    "SLOWFAST.ALPHA", "4", "DATA.TRAIN_CROP_SIZE", "32", "MODEL.NUM_CLASSES", "5",
    "RESNET.NUM_BLOCK_TEMP_KERNEL", "[[2,2],[2,2],[2,2],[2,2]]",
    "TPU.COMPUTE_DTYPE", "float32"])
step = make_eval_step(cfg, build_model(cfg, device="cpu"))
clips = torch.from_numpy(np.zeros((1, 8, 32, 32, 3), np.uint8))
assert step({"inputs": [clips]}).shape == (1, 5)
bad = [m for m in sys.modules if any(m == f or m.startswith(f + ".")
       for f in ("jax", "flax", "slowfast_tpu"))]
print("LOADED", bad)
assert not bad, bad
"""
    env = {k: v for k, v in os.environ.items() if not k.startswith("PYTHONPATH")}
    env["PYTHONPATH"] = str(ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "LOADED []" in proc.stdout
