"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and compiles with ``nvcc``
for ``sm_90a`` into a shared library under ``slowfast_tpu_torch/_build/``,
named by a hash of its source and of the headers in ``csrc/``, so a stale
build is never loaded. The build
happens at first use; ``build_all`` starts one ``nvcc`` per source at once.
ptxas reports each kernel's registers, spills and shared memory
(``-Xptxas -v``); the report is kept beside the library (``log_path``).
Libraries are loaded with ``ctypes``.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded = {}


def sources():
    return sorted(p.stem for p in SRC_DIR.glob("*.cu"))


def _nvcc():
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def _lib_path(name):
    digest = hashlib.sha256((SRC_DIR / f"{name}.cu").read_bytes())
    for header in sorted(SRC_DIR.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def log_path(name):
    """nvcc's output (ptxas's report) for the current build of ``name``."""
    return _lib_path(name).with_suffix(".log")


def _start(name):
    """Start nvcc for ``name`` unless its library exists; return (proc, tmp, out)."""
    out = _lib_path(name)
    if out.exists():
        return None, None, out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SRC_DIR / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    return proc, tmp, out


def _finish(name, proc, tmp, out):
    if proc is None:
        return out
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log.decode(errors='replace')}")
    out.with_suffix(".log").write_bytes(log)
    os.replace(tmp, out)  # atomic: a concurrent builder sees all or nothing
    return out


def build_all():
    """Build every kernel source, one nvcc each, all started together."""
    started = {name: _start(name) for name in sources()}
    return {name: _finish(name, *job) for name, job in started.items()}


def load(name):
    """The ctypes library of ``csrc/<name>.cu``, built on first use."""
    if name not in _loaded:
        _loaded[name] = ctypes.CDLL(str(_finish(name, *_start(name))))
    return _loaded[name]
