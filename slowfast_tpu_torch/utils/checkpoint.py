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
keys (slowfast_tpu/utils/checkpoint.py:329-345 maps them back); the SSL MLP
heads' flax ``projection_{i}`` (Linears and 1-D BNs) map to
``projection.{i}``, and ``ContrastiveModel``'s ``predictor_{i}`` to
``predictors.{i}``.

Train checkpoints follow the JAX package's path rules
(slowfast_tpu/utils/checkpoint.py:35-76: ``OUTPUT_DIR/checkpoints/
checkpoint_epoch_00001.pyth``, auto-resume from the last one) in the
reference ``.pyth`` format, a ``torch.save`` of ``{"epoch", "model_state",
"optimizer_state", "cfg"}``; ``model_state`` loads into the JAX package
through its ``load_torch_checkpoint_dict``. The JAX package's own pickled
checkpoints are not read here.

In a multi-process job only the master writes a checkpoint, and every
rank passes a barrier after it, so that none reads one half written.

A port checkpoint in ``TRAIN.CHECKPOINT_FILE_PATH`` resumes the run it
came from unless ``TRAIN.CHECKPOINT_EPOCH_RESET``: the model, the
optimizer (and an SSL state) and the epoch after the saved one, as the
JAX package does for its own checkpoints
(slowfast_tpu/utils/checkpoint.py:665-675). Other fine-tuning loads
(``TRAIN.CHECKPOINT_FILE_PATH`` otherwise, test checkpoints) are
partial, as the JAX package's import of a ``.pyth`` is
(slowfast_tpu/utils/checkpoint.py:500-607): ``load_state_dict_partial``
copies what fits by name and shape, inflates 2D kernels, resizes pos-embed
and rel-pos tables and applies the image-init surgery; caffe2 pickles go
through ``c2_import``. Auto-resume stays strict.
"""

import math
import os
import pickle
import re
import zipfile

import numpy as np
import torch

from . import distributed as du
from .io import pathmgr
from .logging import get_logger

logger = get_logger(__name__)

_PARAM_LEAF = {"scale": "weight", "bias": "bias"}
_STAT_LEAF = {"mean": "running_mean", "var": "running_var"}
_TABLE_PREFIXES = ("cls_token", "rel_pos_", "pos_embed", "gamma_", "mask_token",
                   "decoder_pos_embed", "dec_pos_embed_")
_MODULE_NAMES = ((r"^blocks_(\d+)$", r"blocks.\1"),
                 (r"^layers_(\d+)$", r"layers.\1"),
                 (r"^projection_(\d+)$", r"projection.\1"),
                 (r"^predictor_(\d+)$", r"predictors.\1"),
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


def _float(val):
    """``val`` as a float32 array, or float64 if it is float64."""
    val = np.asarray(val)
    return val if val.dtype == np.float64 else val.astype(np.float32)


def state_dict_from_jax(variables):
    """The port's ``state_dict`` from a JAX ``{"params", "batch_stats"}`` tree
    of numpy arrays (or anything ``np.asarray`` takes), in float32 (float64
    arrays stay float64)."""
    sd = {}
    for path, val in _flatten(variables["params"]).items():
        val = _float(val)
        mods, leaf = _torch_path(path[:-1]), path[-1]
        if leaf == "kernel":
            if val.ndim == 5:
                val = val.transpose(4, 3, 0, 1, 2)
            elif val.ndim == 4:  # the 2D patch stem: (kh, kw, C, D) -> (D, C, kh, kw)
                val = val.transpose(3, 2, 0, 1)
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
            np.ascontiguousarray(_float(val)))
        sd.setdefault(".".join(mods + ("num_batches_tracked",)),
                      torch.zeros((), dtype=torch.long))
    return sd


def ssl_state_from_jax(ssl_state):
    """An ``SSLState.load_state_dict`` input from the JAX package's
    ``ssl_state`` (slowfast_tpu/models/contrastive.py:123): the momentum
    encoder's ``hist_params`` and the backbone's part of
    ``hist_batch_stats`` as a backbone ``state_dict``, the queues and banks
    as tensors, the pointer, fill count and step count as ints."""
    out = {"ptr": int(ssl_state.get("ptr", 0)), "swav_filled": int(ssl_state.get("swav_filled", 0)),
           "iter": int(ssl_state["iter"])}
    for name in ("queue_x", "queue_swav", "memory", "knn_memory"):
        if name in ssl_state:
            out[name] = torch.from_numpy(np.array(_float(ssl_state[name])))
    if "hist_params" in ssl_state:
        stats = ssl_state.get("hist_batch_stats", {})
        out["hist"] = state_dict_from_jax({"params": ssl_state["hist_params"],
                                           "batch_stats": stats.get("backbone", {})})
    return out


def get_checkpoint_dir(path_to_job):
    return os.path.join(path_to_job, "checkpoints")


def get_path_to_checkpoint(path_to_job, epoch, task=""):
    name = f"checkpoint_epoch_{epoch:05d}.pyth"
    return os.path.join(get_checkpoint_dir(path_to_job), f"{task}_{name}" if task else name)


def get_last_checkpoint(path_to_job, task=""):
    """The most recent checkpoint file, or None (reference checkpoint.py:61-78)."""
    d = get_checkpoint_dir(path_to_job)
    prefix = f"{task}_checkpoint" if task else "checkpoint"
    names = sorted(f for f in pathmgr.ls(d) if f.startswith(prefix)) if pathmgr.isdir(d) else []
    return os.path.join(d, names[-1]) if names else None


def has_checkpoint(path_to_job, task=""):
    return get_last_checkpoint(path_to_job, task) is not None


def multigrid_period_hit(cfg, cur_epoch, multigrid_schedule):
    """Under a long-cycle schedule: whether ``cur_epoch`` is on the cadence
    of ``MULTIGRID.EVAL_FREQ`` a shape, counted back from the shape's last
    epoch (so that epoch always is); None without a schedule."""
    if multigrid_schedule is None:
        return None
    prev_epoch = 0
    for s in multigrid_schedule:
        if cur_epoch < s[-1]:
            period = max((s[-1] - prev_epoch) // cfg.MULTIGRID.EVAL_FREQ + 1, 1)
            return (s[-1] - 1 - cur_epoch) % period == 0
        prev_epoch = s[-1]
    return None


def is_checkpoint_epoch(cfg, cur_epoch, multigrid_schedule=None):
    """Checkpoint cadence, multigrid-aware (slowfast_tpu/utils/checkpoint.py:61-75)."""
    if cur_epoch + 1 == cfg.SOLVER.MAX_EPOCH:
        return True
    hit = multigrid_period_hit(cfg, cur_epoch, multigrid_schedule)
    if hit is not None:
        return hit
    return (cur_epoch + 1) % cfg.TRAIN.CHECKPOINT_PERIOD == 0


def save_checkpoint(path_to_job, model, optimizer, epoch, cfg, ssl_state=None):
    """Write ``checkpoint_epoch_{epoch + 1:05d}.pyth`` atomically (a temporary
    file, then a rename, so auto-resume never sees a partial file); returns
    its path. ``epoch`` is the 0-based epoch just completed. An SSL run's
    ``SSLState`` goes under its own key, ``ssl_state``, beside the model's
    ``state_dict`` (slowfast_tpu/utils/checkpoint.py:146-147). Only the
    master writes; every rank returns after the write."""
    path = get_path_to_checkpoint(path_to_job, epoch + 1, cfg.TASK)
    if du.is_master_proc():
        _write_checkpoint(path, model, optimizer, epoch, cfg, ssl_state)
    du.barrier()
    return path


def _write_checkpoint(path, model, optimizer, epoch, cfg, ssl_state):
    pathmgr.mkdirs(os.path.dirname(path))
    payload = {
        "epoch": epoch,
        "model_state": {k: v.detach().cpu() for k, v in model.state_dict().items()},
        "optimizer_state": optimizer.state_dict(),
        "cfg": cfg.dump(),
    }
    if ssl_state is not None:
        payload["ssl_state"] = ssl_state.state_dict()
    tmp = os.path.join(os.path.dirname(path), "." + os.path.basename(path) + ".tmp")
    with pathmgr.open(tmp, "wb") as f:
        torch.save(payload, f)
    pathmgr.replace(tmp, path)


class _PlainUnpickler(pickle.Unpickler):
    """Loads only plain data (dicts, strings, numbers, bytes): no class or
    function is looked up, so no code from the file runs."""

    def find_class(self, module, name):
        raise pickle.UnpicklingError(f"{module}.{name} is not plain data")


def _is_jax_native(path):
    """A pickle written by the JAX package (``format`` ``slowfast_tpu.*``)."""
    with pathmgr.open(path, "rb") as f:
        if zipfile.is_zipfile(f):
            return False
        f.seek(0)
        try:
            payload = _PlainUnpickler(f).load()
        except (pickle.UnpicklingError, EOFError, ValueError, TypeError, AttributeError):
            return False
    return isinstance(payload, dict) and str(payload.get("format", "")).startswith(
        "slowfast_tpu.")


def _refuse_jax_native(path):
    if _is_jax_native(path):
        raise NotImplementedError(
            f"{path} is a JAX-package checkpoint; convert its variables with "
            f"state_dict_from_jax and save them as a .pyth")


def _load_pyth(path):
    _refuse_jax_native(path)
    with pathmgr.open(path, "rb") as f:
        return torch.load(f, map_location="cpu", weights_only=True)


def load_train_checkpoint(cfg, model, optimizer, ssl_state=None):
    """Auto-resume or explicit init (slowfast_tpu/utils/checkpoint.py:654-677);
    returns the epoch to start from.

    With ``TRAIN.AUTO_RESUME`` and a checkpoint in ``OUTPUT_DIR`` the model
    and optimizer resume, strictly, after its epoch, and so does
    ``ssl_state`` (an ``SSLState``: the momentum encoder, queues, pointer,
    banks and step count) when given. Else a port train checkpoint in
    ``TRAIN.CHECKPOINT_FILE_PATH`` (``own_train_checkpoint``) resumes the
    same way unless ``TRAIN.CHECKPOINT_EPOCH_RESET``, as the JAX package
    resumes its own (slowfast_tpu/utils/checkpoint.py:665-675; under
    ``TRAIN.CHECKPOINT_CLEAR_NAME_PATTERN`` its weights load partially and
    the optimizer stays fresh). Any other file there (a ``.pyth``, or a
    caffe2 pickle under ``TRAIN.CHECKPOINT_TYPE caffe2``), or a port
    checkpoint with the key set, initializes the model's weights through
    the partial load (``load_weights``) at epoch 0.
    """
    if cfg.TRAIN.AUTO_RESUME and has_checkpoint(cfg.OUTPUT_DIR, cfg.TASK):
        path = get_last_checkpoint(cfg.OUTPUT_DIR, cfg.TASK)
        return _resume(path, _load_pyth(path), model, optimizer, ssl_state)
    path = cfg.TRAIN.CHECKPOINT_FILE_PATH
    ckpt = None
    if path and not cfg.TRAIN.CHECKPOINT_EPOCH_RESET:
        ckpt = own_train_checkpoint(path, cfg)
    if ckpt is not None and not cfg.TRAIN.CHECKPOINT_CLEAR_NAME_PATTERN:
        return _resume(path, ckpt, model, optimizer, ssl_state)
    if path:
        load_weights(cfg, model, path, checkpoint_type(cfg))
    # Renamed weights of a port checkpoint load as JAX loads them:
    # partially, with a fresh optimizer, at the epoch after the
    # checkpoint's (slowfast_tpu/utils/checkpoint.py:200-210).
    return 0 if ckpt is None else ckpt["epoch"] + 1


def own_train_checkpoint(path, cfg):
    """The checkpoint at ``path`` if this package wrote it in training (a
    ``.pyth`` whose optimizer state is the port's, with its step
    ``count``), else None."""
    if checkpoint_type(cfg) != "pytorch" or not zipfile.is_zipfile(path):
        return None
    ckpt = _load_pyth(path)
    own = isinstance(ckpt, dict) and "count" in ckpt.get("optimizer_state", {})
    return ckpt if own else None


def _resume(path, ckpt, model, optimizer, ssl_state=None):
    """The model (strictly), optimizer and ``ssl_state`` of ``ckpt``, read
    from ``path``; returns the epoch after its own."""
    model.load_state_dict(ckpt["model_state"], strict=True)
    optimizer.load_state_dict(ckpt["optimizer_state"])
    if ssl_state is not None:
        if "ssl_state" not in ckpt:
            raise ValueError(f"{path} holds no SSL state to resume from")
        ssl_state.load_state_dict(ckpt["ssl_state"])
    logger.info("Resumed from %s", path)
    return ckpt["epoch"] + 1


def load_test_checkpoint(cfg, model):
    """Load TEST.CHECKPOINT_FILE_PATH, else the last checkpoint in
    ``OUTPUT_DIR``, else TRAIN.CHECKPOINT_FILE_PATH into ``model``
    (slowfast_tpu/utils/checkpoint.py:640), each through the partial load
    (``load_weights``, the JAX package's ``_load_any``, :691)."""
    if cfg.TEST.CHECKPOINT_FILE_PATH:
        path, ckpt_type = cfg.TEST.CHECKPOINT_FILE_PATH, checkpoint_type(cfg)
    elif has_checkpoint(cfg.OUTPUT_DIR, cfg.TASK):
        path, ckpt_type = get_last_checkpoint(cfg.OUTPUT_DIR, cfg.TASK), "pytorch"
    else:
        path, ckpt_type = cfg.TRAIN.CHECKPOINT_FILE_PATH, checkpoint_type(cfg)
    if not path:
        logger.info("Testing with random initialization. Only for debugging.")
        return model
    load_weights(cfg, model, path, ckpt_type)
    return model


def checkpoint_type(cfg):
    """``TEST.CHECKPOINT_TYPE`` when training is off, else
    ``TRAIN.CHECKPOINT_TYPE`` (slowfast_tpu/utils/checkpoint.py:709)."""
    return cfg.TEST.CHECKPOINT_TYPE if not cfg.TRAIN.ENABLE else cfg.TRAIN.CHECKPOINT_TYPE


def load_weights(cfg, model, path, ckpt_type="pytorch"):
    """The weights of ``path`` into ``model`` as the JAX package's
    ``_load_any`` loads a file that is not its own: a caffe2 pickle through
    ``c2_import.load_caffe2_checkpoint`` (with ``TRAIN.CHECKPOINT_INFLATE``),
    a ``.pyth`` through ``load_state_dict_partial`` with the ``TRAIN``
    options (``CHECKPOINT_INFLATE``, ``CHECKPOINT_IN_INIT``,
    ``CHECKPOINT_CLEAR_NAME_PATTERN``). Logs and returns the ``LoadReport``."""
    if ckpt_type == "caffe2":
        from .c2_import import load_caffe2_checkpoint

        _refuse_jax_native(path)
        report = load_caffe2_checkpoint(path, model, inflate=cfg.TRAIN.CHECKPOINT_INFLATE)
    else:
        ckpt = _load_pyth(path)
        report = load_state_dict_partial(
            model, ckpt.get("model_state", ckpt), inflate=cfg.TRAIN.CHECKPOINT_INFLATE,
            image_init=cfg.TRAIN.CHECKPOINT_IN_INIT,
            clear_name_pattern=tuple(cfg.TRAIN.CHECKPOINT_CLEAR_NAME_PATTERN))
    logger.info("Loaded %s (%s): %d loaded, %d shape-skipped, %d missing (fresh init), "
                "%d unexpected (dropped, the shape-skipped among them)", path, ckpt_type,
                len(report.loaded), report.skipped, len(report.missing),
                len(report.unexpected))
    return report


# --- Partial loads (slowfast_tpu/utils/checkpoint.py:358-607) -----------------

class LoadReport:
    """What a partial load did: ``loaded`` (the model's names that were
    written), ``missing`` (the model's names that were not; BN's
    ``num_batches_tracked`` counts in neither, as the JAX package has no
    such leaf), ``unexpected`` (the checkpoint's names with no place in the
    model, and those whose shape fit no rule, marked
    ``" (shape mismatch)"``, as JAX lists them) and ``skipped``, the count
    of the latter."""

    def __init__(self, loaded, missing, unexpected):
        self.loaded, self.missing, self.unexpected = loaded, missing, unexpected
        self.skipped = sum(u.endswith(" (shape mismatch)") for u in unexpected)


def inflate_weight(w2d, t):
    """2D -> 3D kernel inflation: ``(O, I, h, w)`` repeated ``t`` times
    over a new time axis and divided by ``t`` (:364, reference
    checkpoint.py:148-178)."""
    return np.repeat(w2d[:, :, None], t, axis=2) / float(t)


def _interp_linear(v, n):
    """``F.interpolate(mode="linear")`` of an ``(L, C)`` table over its rows
    to ``n`` (:387, reference checkpoint.py:443-451)."""
    t = torch.from_numpy(np.ascontiguousarray(v.astype(np.float32)))
    out = torch.nn.functional.interpolate(t.t().unsqueeze(0), size=n, mode="linear")
    return out[0].t().numpy()


def _interp_bicubic_2d(v, hw):
    """Bicubic resize of a ``(1, H·W, C)`` square grid to ``hw`` x ``hw``
    (:399, reference checkpoint.py:470-487)."""
    src = int(math.sqrt(v.shape[1]))
    assert src * src == v.shape[1], "pos_embed_spatial is not square"
    t = torch.from_numpy(np.ascontiguousarray(v.astype(np.float32)))
    t = t.reshape(1, src, src, -1).permute(0, 3, 1, 2)
    t = torch.nn.functional.interpolate(t, size=(hw, hw), mode="bicubic")
    return t.reshape(1, -1, hw * hw).permute(0, 2, 1).numpy()


def _surgery_convert(name, val, ts):
    """The table surgery for a shape mismatch (:413-429): a ``rel_pos``
    table of the same width linearly over its rows, ``pos_embed_temporal``
    linearly over time, ``pos_embed_spatial`` bicubically over its square
    grid; None for anything else."""
    ts = tuple(ts)
    if "rel_pos" in name and val.ndim == 2 and len(ts) == 2 and val.shape[1] == ts[1]:
        return _interp_linear(val, ts[0])
    if "pos_embed_temporal" in name and val.ndim == 3 and len(ts) == 3 and val.shape[2] == ts[2]:
        return _interp_linear(val[0], ts[1])[None]
    if "pos_embed_spatial" in name and val.ndim == 3 and len(ts) == 3 and val.shape[2] == ts[2]:
        return _interp_bicubic_2d(val, int(round(np.sqrt(ts[1]))))
    return None


def _image_init_surgery(sd, shapes):
    """Image -> video init under ``TRAIN.CHECKPOINT_IN_INIT`` (:432-497,
    reference checkpoint.py:315-433), on the checkpoint's names before the
    load, ``shapes`` the model's parameter shapes: a joint ``pos_embed``
    split into ``pos_embed_class`` and ``pos_embed_spatial`` for a model
    with separated tables, separated ones merged into a joint one for a
    model with a joint table; the ``patch_embed.proj`` and
    ``pool_{q,k,v}`` convs repeated over the model's T, without dividing by
    T (unlike CNN inflation). Returns a new dict."""
    sd = dict(sd)
    sp_shape = shapes.get("pos_embed_spatial")
    if "pos_embed" in sd and sp_shape is not None and "pos_embed" not in shapes:
        pe = sd["pos_embed"]
        if pe.shape[1] == sp_shape[1] + 1:
            sd["pos_embed_class"] = pe[:, :1]
            sd["pos_embed_spatial"] = pe[:, 1:]
            sd.pop("pos_embed")
    joint_shape = shapes.get("pos_embed")
    if "pos_embed_spatial" in sd and joint_shape is not None and "pos_embed_spatial" not in shapes:
        pe = sd["pos_embed_spatial"]
        if "pos_embed_class" in sd and pe.shape[1] + 1 == joint_shape[1]:
            pe = np.concatenate([sd.pop("pos_embed_class"), pe], axis=1)
        if pe.shape == tuple(joint_shape):
            sd["pos_embed"] = pe
            sd.pop("pos_embed_spatial")
    for name in list(sd):
        if not name.endswith(".weight") or not (
                "patch_embed.proj" in name or any(p in name for p in ("pool_q", "pool_k", "pool_v"))):
            continue
        ts = shapes.get(_model_name(name))
        if ts is None or len(ts) != 5:
            continue
        val, t = sd[name], ts[2]
        if val.ndim == 4:
            sd[name] = np.repeat(val[:, :, None], t, axis=2)
        elif val.ndim == 5 and val.shape[2] == 1 and t > 1:
            sd[name] = np.repeat(val, t, axis=2)
    return sd


def _model_name(name):
    """A checkpoint name as the model's (a ``DataParallel`` ``module.``
    prefix dropped)."""
    return re.sub(r"^module\.", "", name)


def _as_numpy(v):
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def load_state_dict_partial(model, state_dict, inflate=False, image_init=False,
                            clear_name_pattern=()):
    """``state_dict`` (reference names, torch layouts) into ``model`` where
    it fits, as the JAX package's ``load_torch_checkpoint_dict`` (:500-607)
    does: the ``clear_name_pattern`` substrings removed from every name
    first, then (``image_init``) ``_image_init_surgery``; a tensor is copied
    where the model has its name and its shape, a 2D conv kernel inflated
    to the model's 3D one under ``inflate``, a mismatched pos-embed or
    rel-pos table resized (``_surgery_convert``); everything else is left
    at its init. Returns a ``LoadReport``."""
    sd = {}
    for k, v in state_dict.items():
        for p in clear_name_pattern:
            if p in k:
                k = k.replace(p, "")
        sd[k] = _as_numpy(v)
    target = model.state_dict()
    kernels = {n for n, p in model.named_parameters() if p.dim() >= 2}
    if image_init:
        sd = _image_init_surgery(sd, {n: tuple(p.shape) for n, p in model.named_parameters()})
    loaded, unexpected, new = [], [], {}
    for name, val in sd.items():
        mname = _model_name(name)
        if mname.endswith("num_batches_tracked"):
            continue
        if mname not in target:
            unexpected.append(name)
            continue
        ts = tuple(target[mname].shape)
        conv = val if val.shape == ts else None
        if conv is None and inflate and mname in kernels and val.ndim == 4 and len(ts) == 5:
            conv = inflate_weight(val, ts[2])
            conv = conv if conv.shape == ts else None
        if conv is None:
            conv = _surgery_convert(name, val, ts)
        if conv is None:
            unexpected.append(f"{name} (shape mismatch)")
            continue
        if conv.shape != ts:
            raise ValueError(f"{name}: the resized table has shape {conv.shape}, not {ts}")
        new[mname] = torch.from_numpy(np.ascontiguousarray(conv.astype(np.float32)))
        loaded.append(mname)
    with torch.no_grad():
        for mname, val in new.items():
            target[mname].copy_(val.to(target[mname].dtype))
    missing = [n for n in target if n not in new and not n.endswith("num_batches_tracked")]
    return LoadReport(loaded, missing, unexpected)
