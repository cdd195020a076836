"""Weight bridge and test-checkpoint loading.

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
``gamma_*``) copied as they are.
"""

import re

import numpy as np
import torch

from .logging import get_logger

logger = get_logger(__name__)

_PARAM_LEAF = {"scale": "weight", "bias": "bias"}
_STAT_LEAF = {"mean": "running_mean", "var": "running_var"}
_TABLE_PREFIXES = ("cls_token", "rel_pos_", "pos_embed", "gamma_")


def _torch_path(mods):
    """Flax module names -> torch ``state_dict`` prefixes."""
    return tuple(re.sub(r"^blocks_(\d+)$", r"blocks.\1", m) for m in mods)


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
    """Load TEST.CHECKPOINT_FILE_PATH (else TRAIN.CHECKPOINT_FILE_PATH) into
    ``model``: a torch file holding ``{"model_state": state_dict}``, the
    reference ``.pyth`` format, which loads with no name mapping."""
    path = cfg.TEST.CHECKPOINT_FILE_PATH or cfg.TRAIN.CHECKPOINT_FILE_PATH
    if not path:
        logger.info("Testing with random initialization. Only for debugging.")
        return model
    ckpt_type = cfg.TEST.CHECKPOINT_TYPE if cfg.TEST.CHECKPOINT_FILE_PATH else (
        cfg.TRAIN.CHECKPOINT_TYPE)
    if ckpt_type != "pytorch":
        raise NotImplementedError(f"{ckpt_type} checkpoints are not ported yet")
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    model.load_state_dict(ckpt.get("model_state", ckpt), strict=True)
    logger.info("Loaded test checkpoint %s", path)
    return model
