"""Model registry and builder (counterpart of slowfast_tpu/models/build.py;
reference slowfast/models/build.py).

``build_model`` builds the registered model, initializes it with the JAX
package's distributions (not its bits) from a ``torch.Generator`` seeded by
``cfg.RNG_SEED``, and moves it to the device in ``channels_last_3d``.
"""

import torch
from torch import nn

from .common import Conv3D, msra_fill_
from .video_models import SlowFast

MODEL_REGISTRY = {"SlowFast": SlowFast, "PTVSlowFast": SlowFast}


def resolve_device(device):
    """``torch.device(device)``, raising if CUDA is asked for and missing."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run on the CPU")
    return device


def init_weights(model, cfg, generator):
    """MSRA fan-out normal convs, N(0, FC_INIT_STD) projection with zero
    bias; BN starts at scale 1 (0 for zero-init final BNs), bias 0, mean 0,
    var 1 (slowfast_tpu/models/common.py:14, heads.py:76-82, batchnorm.py)."""
    for name, m in model.named_modules():
        if isinstance(m, Conv3D):
            if cfg.RESNET.ZERO_INIT_FINAL_CONV and name.endswith("branch2.c"):
                nn.init.zeros_(m.weight)
            else:
                msra_fill_(m.weight, generator)
        elif isinstance(m, nn.Linear):
            with torch.no_grad():
                m.weight.normal_(0.0, cfg.MODEL.FC_INIT_STD, generator=generator)
            nn.init.zeros_(m.bias)


def build_model(cfg, device="cuda"):
    """Build, initialize and place the model for ``cfg.MODEL.MODEL_NAME``."""
    device = resolve_device(device)
    name = cfg.MODEL.MODEL_NAME
    if name not in MODEL_REGISTRY:
        raise NotImplementedError(f"model {name!r} is not ported yet; "
                                  f"available: {sorted(MODEL_REGISTRY)}")
    model = MODEL_REGISTRY[name](cfg)
    init_weights(model, cfg, torch.Generator().manual_seed(cfg.RNG_SEED))
    return model.to(device=device, memory_format=torch.channels_last_3d)
