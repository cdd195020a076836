"""Caffe2 Model-Zoo checkpoints (counterpart of
slowfast_tpu/utils/c2_import.py; reference slowfast/utils/c2_model_loading.py
and checkpoint.py:216-280).

A caffe2 checkpoint is a latin-1 pickle of ``{"blobs": {name: ndarray}}``
with names such as ``res4_1_branch2a_w`` or ``t_conv1_w`` (the fast pathway
prefixed ``t_``). The rules below rewrite them, in order, to the reference's
``state_dict`` names, which the port's modules carry; the momentum blobs are
dropped, BN and bias blobs with singleton axes squeezed, and the partial
load (``checkpoint.load_state_dict_partial``) does the rest. The pickle is
read by an unpickler that admits numpy's array reconstruction and nothing
else, so no other code named in the file runs.
"""

import pickle
import re

import numpy as np

from .checkpoint import load_state_dict_partial
from .io import pathmgr
from .logging import get_logger

logger = get_logger(__name__)

# Sequentially-applied (pattern, replacement) rewrites: the zoo's on-disk
# names (reference c2_model_loading.py:14-87), as the JAX package has them.
_C2_RULES = [
    (r"^nonlocal_conv([0-9]+)_([0-9]+)_(.*)", r"s\1.pathway0_nonlocal\2_\3"),
    (r"^(.*)_nonlocal([0-9]+)_(theta)(.*)", r"\1_nonlocal\2.conv_\3\4"),
    (r"^(.*)_nonlocal([0-9]+)_(g)(.*)", r"\1_nonlocal\2.conv_\3\4"),
    (r"^(.*)_nonlocal([0-9]+)_(phi)(.*)", r"\1_nonlocal\2.conv_\3\4"),
    (r"^(.*)_nonlocal([0-9]+)_(out)(.*)", r"\1_nonlocal\2.conv_\3\4"),
    (r"^(.*)_nonlocal([0-9]+)_(bn)_(.*)", r"\1_nonlocal\2.\3.\4"),
    (r"^t_pool1_subsample_bn_(.*)", r"s1_fuse.bn.\1"),
    (r"^t_pool1_subsample_(.*)", r"s1_fuse.conv_f2s.\1"),
    (
        r"^t_res([0-9]+)_([0-9]+)_branch2c_bn_subsample_bn_(.*)",
        r"s\1_fuse.bn.\3",
    ),
    (
        r"^t_res([0-9]+)_([0-9]+)_branch2c_bn_subsample_(.*)",
        r"s\1_fuse.conv_f2s.\3",
    ),
    (
        r"^res([0-9]+)_([0-9]+)_branch([0-9]+)([a-z])_(.*)",
        r"s\1.pathway0_res\2.branch\3.\4_\5",
    ),
    (r"^res_conv1_bn_(.*)", r"s1.pathway0_stem.bn.\1"),
    (r"^conv1_xy(.*)", r"s1.pathway0_stem.conv_xy\1"),
    (r"^conv1_(.*)", r"s1.pathway0_stem.conv.\1"),
    (
        r"^res([0-9]+)_([0-9]+)_branch([0-9]+)_(.*)",
        r"s\1.pathway0_res\2.branch\3_\4",
    ),
    (r"^res_conv1_(.*)", r"s1.pathway0_stem.conv.\1"),
    (
        r"^t_res([0-9]+)_([0-9]+)_branch([0-9]+)([a-z])_(.*)",
        r"s\1.pathway1_res\2.branch\3.\4_\5",
    ),
    (r"^t_res_conv1_bn_(.*)", r"s1.pathway1_stem.bn.\1"),
    (r"^t_conv1_(.*)", r"s1.pathway1_stem.conv.\1"),
    (
        r"^t_res([0-9]+)_([0-9]+)_branch([0-9]+)_(.*)",
        r"s\1.pathway1_res\2.branch\3_\4",
    ),
    (r"^t_res_conv1_(.*)", r"s1.pathway1_stem.conv.\1"),
    (r"pred_(.*)", r"head.projection.\1"),
    (r"(.*)b_bn_fc(.*)", r"\1se.fc\2"),
    (r"conv_5(.*)", r"head.conv_5\1"),
    (r"lin_5(.*)", r"head.lin_5\1"),
    (r"(.*)bn.b\Z", r"\1bn.bias"),
    (r"(.*)bn.s\Z", r"\1bn.weight"),
    (r"(.*)bn.rm\Z", r"\1bn.running_mean"),
    (r"(.*)bn.riv\Z", r"\1bn.running_var"),
    (r"(.*)[\._]b\Z", r"\1.bias"),
    (r"(.*)[\._]w\Z", r"\1.weight"),
]




def convert_c2_name(name):
    for pattern, repl in _C2_RULES:
        name = re.sub(pattern, repl, name)
    return name


# What a pickle of numpy arrays and scalars names: numpy 1's and numpy 2's
# module paths.
_NUMPY_NAMES = {(mod, name) for mod in ("numpy.core.multiarray", "numpy._core.multiarray")
                for name in ("_reconstruct", "scalar")}
_NUMPY_NAMES |= {(mod, "_frombuffer") for mod in ("numpy.core.numeric", "numpy._core.numeric")}
# A Python 3 pickle at protocol 2 writes an array's bytes through
# _codecs.encode.
_NUMPY_NAMES |= {("numpy", "ndarray"), ("numpy", "dtype"), ("_codecs", "encode")}


class _NumpyUnpickler(pickle.Unpickler):
    """Loads plain data and numpy arrays: any other class or function the
    pickle names is refused."""

    def find_class(self, module, name):
        if (module, name) in _NUMPY_NAMES:
            return super().find_class(module, name)
        raise pickle.UnpicklingError(f"{module}.{name} is not a numpy array class")


def load_caffe2_blobs(path):
    """The ``{name: value}`` blobs of a caffe2 pickle."""
    with pathmgr.open(path, "rb") as f:
        blobs = _NumpyUnpickler(f, encoding="latin1").load()
    return blobs["blobs"] if "blobs" in blobs else blobs


def load_caffe2_checkpoint(path, model, inflate=False):
    """The caffe2 pickle ``path`` into ``model`` (slowfast_tpu/utils/
    c2_import.py:85): names converted, momentum blobs dropped, 1-D-like BN
    and bias blobs flattened, then the partial load with ``inflate``.
    Returns its ``LoadReport``."""
    state_dict = {}
    for name, val in load_caffe2_blobs(path).items():
        if "momentum" in name or not isinstance(val, np.ndarray):
            continue
        torch_name = convert_c2_name(name)
        # Caffe2 BN parameters may carry trailing singleton axes
        # (reference checkpoint.py:245-262).
        if val.ndim > 1 and ("bn." in torch_name or torch_name.endswith(".bias")):
            if np.prod(val.shape) == max(val.shape):
                val = val.reshape(-1)
        state_dict[torch_name] = val
    logger.info("Converted %d caffe2 blobs", len(state_dict))
    return load_state_dict_partial(model, state_dict, inflate=inflate)
