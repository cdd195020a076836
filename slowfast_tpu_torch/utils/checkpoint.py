"""Weight bridge, train checkpoints and test-checkpoint loading.

Port modules use the reference PySlowFast ``state_dict`` names
(``s2.pathway0_res0.branch2.a.weight``, ``...a_bn.running_var``,
``blocks.0.attn.qkv.weight``, ``cls_token``, ``head.projection.weight``).
They mirror the flax paths of the JAX package one for one
(slowfast_tpu/utils/checkpoint.py:333 maps the other way), so the conversion
is mechanical: flax ``blocks_{i}`` -> ``blocks.{i}``, conv kernels
(kt,kh,kw,I,O) -> (O,I,kt,kh,kw) (the MViT pool kernels (kt,kh,kw,1,d) ->
(d,1,kt,kh,kw)), dense kernels (I,O) -> (O,I), BN and LayerNorm
scale/bias/mean/var -> weight/bias/running_mean/running_var, and parameter
tables (``cls_token``, ``rel_pos_*``, ``pos_embed*``, layer-scale
``gamma_*``, and ``MaskMViT``'s ``mask_token``, ``decoder_pos_embed`` and
``dec_pos_embed_*``) copied as they are. ``MaskMViT``'s heads map flax
``transforms_{i}_{j}`` / ``projections_{i}`` to ``transforms.{i}.{j}`` /
``projections.{i}``, the reference's ``nn.Sequential`` and ``nn.ModuleList``
keys (slowfast_tpu/utils/checkpoint.py:329-345 maps them back).

Train checkpoints follow the JAX package's path rules
(slowfast_tpu/utils/checkpoint.py:35-76: ``OUTPUT_DIR/checkpoints/
checkpoint_epoch_00001.pyth``, auto-resume from the last one) in the
reference ``.pyth`` format, a ``torch.save`` of ``{"epoch", "model_state",
"optimizer_state", "cfg"}``; ``model_state`` loads into the JAX package
through its ``load_torch_checkpoint_dict``. The JAX package's own pickled
checkpoints are not read here.
"""

import os
import pickle
import re
import zipfile

import numpy as np
import torch

from .logging import get_logger

logger = get_logger(__name__)

_PARAM_LEAF = {"scale": "weight", "bias": "bias"}
_STAT_LEAF = {"mean": "running_mean", "var": "running_var"}
_TABLE_PREFIXES = ("cls_token", "rel_pos_", "pos_embed", "gamma_", "mask_token",
                   "decoder_pos_embed", "dec_pos_embed_")
_MODULE_NAMES = ((r"^blocks_(\d+)$", r"blocks.\1"),
                 (r"^transforms_(\d+)_(\d+)$", r"transforms.\1.\2"),
                 (r"^projections_(\d+)$", r"projections.\1"))


def _torch_name(mod):
    for pattern, repl in _MODULE_NAMES:
        mod = re.sub(pattern, repl, mod)
    return mod


def _torch_path(mods):
    """Flax module names -> torch ``state_dict`` prefixes."""
    return tuple(_torch_name(m) for m in mods)


def _flatten(tree, prefix=()):
    if isinstance(tree, dict) or hasattr(tree, "items"):
        out = {}
        for k, v in tree.items():
            out.update(_flatten(v, prefix + (k,)))
        return out
    return {prefix: tree}


def state_dict_from_jax(variables):
    """The port's ``state_dict`` from a JAX ``{"params", "batch_stats"}`` tree
    of numpy arrays (or anything ``np.asarray`` takes)."""
    sd = {}
    for path, val in _flatten(variables["params"]).items():
        val = np.asarray(val, np.float32)
        mods, leaf = _torch_path(path[:-1]), path[-1]
        if leaf == "kernel":
            if val.ndim == 5:
                val = val.transpose(4, 3, 0, 1, 2)
            elif val.ndim == 2:
                val = val.T
            else:
                raise ValueError(f"unexpected kernel rank {val.ndim} at {path}")
            leaf = "weight"
        elif leaf in _PARAM_LEAF:
            leaf = _PARAM_LEAF[leaf]
        elif not leaf.startswith(_TABLE_PREFIXES):
            raise ValueError(f"unexpected parameter {path}")
        sd[".".join(mods + (leaf,))] = torch.from_numpy(np.ascontiguousarray(val))
    for path, val in _flatten(variables.get("batch_stats", {})).items():
        mods, leaf = _torch_path(path[:-1]), path[-1]
        if leaf not in _STAT_LEAF:
            raise ValueError(f"unexpected batch statistic {path}")
        sd[".".join(mods + (_STAT_LEAF[leaf],))] = torch.from_numpy(
            np.ascontiguousarray(np.asarray(val, np.float32)))
        sd.setdefault(".".join(mods + ("num_batches_tracked",)),
                      torch.zeros((), dtype=torch.long))
    return sd


def load_test_checkpoint(cfg, model):
    """Load TEST.CHECKPOINT_FILE_PATH, else the last checkpoint in
    ``OUTPUT_DIR``, else TRAIN.CHECKPOINT_FILE_PATH into ``model``
    (slowfast_tpu/utils/checkpoint.py:640): a torch file holding
    ``{"model_state": state_dict}``, the reference ``.pyth`` format, which
    loads with no name mapping."""
    if cfg.TEST.CHECKPOINT_FILE_PATH:
        path, ckpt_type = cfg.TEST.CHECKPOINT_FILE_PATH, cfg.TEST.CHECKPOINT_TYPE
    elif has_checkpoint(cfg.OUTPUT_DIR, cfg.TASK):
        path, ckpt_type = get_last_checkpoint(cfg.OUTPUT_DIR, cfg.TASK), "pytorch"
    else:
        path, ckpt_type = cfg.TRAIN.CHECKPOINT_FILE_PATH, cfg.TRAIN.CHECKPOINT_TYPE
    if not path:
        logger.info("Testing with random initialization. Only for debugging.")
        return model
    if ckpt_type != "pytorch":
        raise NotImplementedError(f"{ckpt_type} checkpoints are not ported yet")
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    model.load_state_dict(ckpt.get("model_state", ckpt), strict=True)
    logger.info("Loaded test checkpoint %s", path)
    return model


def get_checkpoint_dir(path_to_job):
    return os.path.join(path_to_job, "checkpoints")


def get_path_to_checkpoint(path_to_job, epoch, task=""):
    name = f"checkpoint_epoch_{epoch:05d}.pyth"
    return os.path.join(get_checkpoint_dir(path_to_job), f"{task}_{name}" if task else name)


def get_last_checkpoint(path_to_job, task=""):
    """The most recent checkpoint file, or None (reference checkpoint.py:61-78)."""
    d = get_checkpoint_dir(path_to_job)
    prefix = f"{task}_checkpoint" if task else "checkpoint"
    names = sorted(f for f in os.listdir(d) if f.startswith(prefix)) if os.path.isdir(d) else []
    return os.path.join(d, names[-1]) if names else None


def has_checkpoint(path_to_job, task=""):
    return get_last_checkpoint(path_to_job, task) is not None


def is_checkpoint_epoch(cfg, cur_epoch):
    """Checkpoint cadence (reference checkpoint.py:92-110, without multigrid)."""
    if cur_epoch + 1 == cfg.SOLVER.MAX_EPOCH:
        return True
    return (cur_epoch + 1) % cfg.TRAIN.CHECKPOINT_PERIOD == 0


def save_checkpoint(path_to_job, model, optimizer, epoch, cfg):
    """Write ``checkpoint_epoch_{epoch + 1:05d}.pyth`` atomically (a temporary
    file, then a rename, so auto-resume never sees a partial file); returns
    its path. ``epoch`` is the 0-based epoch just completed."""
    os.makedirs(get_checkpoint_dir(path_to_job), exist_ok=True)
    path = get_path_to_checkpoint(path_to_job, epoch + 1, cfg.TASK)
    payload = {
        "epoch": epoch,
        "model_state": {k: v.detach().cpu() for k, v in model.state_dict().items()},
        "optimizer_state": optimizer.state_dict(),
        "cfg": cfg.dump(),
    }
    tmp = os.path.join(os.path.dirname(path), "." + os.path.basename(path) + ".tmp")
    torch.save(payload, tmp)
    os.replace(tmp, path)
    return path


class _PlainUnpickler(pickle.Unpickler):
    """Loads only plain data (dicts, strings, numbers, bytes): no class or
    function is looked up, so no code from the file runs."""

    def find_class(self, module, name):
        raise pickle.UnpicklingError(f"{module}.{name} is not plain data")


def _is_jax_native(path):
    """A pickle written by the JAX package (``format`` ``slowfast_tpu.*``)."""
    if zipfile.is_zipfile(path):
        return False
    try:
        with open(path, "rb") as f:
            payload = _PlainUnpickler(f).load()
    except (pickle.UnpicklingError, EOFError, ValueError, TypeError, AttributeError):
        return False
    return isinstance(payload, dict) and str(payload.get("format", "")).startswith(
        "slowfast_tpu.")


def _load_pyth(path):
    if _is_jax_native(path):
        raise NotImplementedError(
            f"{path} is a JAX-package checkpoint; convert its variables with "
            f"state_dict_from_jax and save them as a .pyth")
    return torch.load(path, map_location="cpu", weights_only=True)


def load_train_checkpoint(cfg, model, optimizer):
    """Auto-resume or explicit init (slowfast_tpu/utils/checkpoint.py:654-677);
    returns the epoch to start from.

    With ``TRAIN.AUTO_RESUME`` and a checkpoint in ``OUTPUT_DIR`` the model
    and optimizer resume after its epoch; else ``TRAIN.CHECKPOINT_FILE_PATH``
    (a ``.pyth``) initializes the model's weights and training starts at 0.
    """
    if cfg.TRAIN.AUTO_RESUME and has_checkpoint(cfg.OUTPUT_DIR, cfg.TASK):
        path = get_last_checkpoint(cfg.OUTPUT_DIR, cfg.TASK)
        ckpt = _load_pyth(path)
        model.load_state_dict(ckpt["model_state"], strict=True)
        optimizer.load_state_dict(ckpt["optimizer_state"])
        logger.info("Resumed from %s", path)
        return ckpt["epoch"] + 1
    if cfg.TRAIN.CHECKPOINT_FILE_PATH:
        if cfg.TRAIN.CHECKPOINT_TYPE != "pytorch":
            raise NotImplementedError(
                f"{cfg.TRAIN.CHECKPOINT_TYPE} checkpoints are not ported yet")
        ckpt = _load_pyth(cfg.TRAIN.CHECKPOINT_FILE_PATH)
        model.load_state_dict(ckpt.get("model_state", ckpt), strict=True)
        logger.info("Loaded %s", cfg.TRAIN.CHECKPOINT_FILE_PATH)
    return 0
