"""Model-zoo verification: reproduce the reference MODEL_ZOO numbers
(counterpart of tools/verify_zoo.py).

The reference's bar is the top-1/top-5 of its released checkpoints under
each family's eval protocol (reference MODEL_ZOO.md:5-20, X3D table
:22-29). Given a downloaded checkpoint (a caffe2 ``.pkl`` or a PyTorch
``.pyth``) and a prepared val set, this runs the family's protocol through
the port's tester and prints measured against expected numbers.

    python -m slowfast_tpu_torch.verify_zoo --model SLOWFAST_8x8_R50 \\
        --ckpt SLOWFAST_8x8_R50.pkl --data-dir /data/kinetics400 \\
        [--tolerance 0.5] [--batch 16] [--device cuda] [--opts KEY VAL ...]

    python -m slowfast_tpu_torch.verify_zoo --list   # the verifiable zoo table

Prints one JSON line ``{"model", "top1", "top5", "expected_top1",
"expected_top5", "delta_top1", "pass"}`` and exits 0 only if top-1 lies
within ``--tolerance`` points of the expected number.
"""

import argparse
import json
import sys

from slowfast_tpu_torch.config import assert_and_infer_cfg, get_cfg

# Eval protocols + expected numbers from reference MODEL_ZOO.md (the
# "crops x clips" column is TEST.NUM_SPATIAL_CROPS x NUM_ENSEMBLE_VIEWS).
# ckpt_type: how the released file deserializes.
ZOO = {
    # MODEL_ZOO.md:7-14 (Kinetics-400, ResNet families, 3 crops x 10 clips)
    "C2D_NOPOOL_8x8_R50": dict(
        cfg="configs/Kinetics/c2/C2D_NOPOOL_8x8_R50.yaml",
        views=10, crops=3, top1=67.2, top5=87.8, ckpt_type="caffe2"),
    "I3D_8x8_R50": dict(
        cfg="configs/Kinetics/c2/I3D_8x8_R50.yaml",
        views=10, crops=3, top1=73.5, top5=90.8, ckpt_type="caffe2"),
    "I3D_NLN_8x8_R50": dict(
        cfg="configs/Kinetics/c2/I3D_NLN_8x8_R50.yaml",
        views=10, crops=3, top1=74.0, top5=91.1, ckpt_type="caffe2"),
    "SLOW_4x16_R50": dict(
        cfg="configs/Kinetics/c2/SLOW_4x16_R50.yaml",
        views=10, crops=3, top1=72.7, top5=90.3, ckpt_type="caffe2"),
    "SLOW_8x8_R50": dict(
        cfg="configs/Kinetics/c2/SLOW_8x8_R50.yaml",
        views=10, crops=3, top1=74.8, top5=91.6, ckpt_type="caffe2"),
    "SLOWFAST_4x16_R50": dict(
        cfg="configs/Kinetics/c2/SLOWFAST_4x16_R50.yaml",
        views=10, crops=3, top1=75.6, top5=92.0, ckpt_type="caffe2"),
    "SLOWFAST_8x8_R50": dict(
        cfg="configs/Kinetics/c2/SLOWFAST_8x8_R50.yaml",
        views=10, crops=3, top1=77.0, top5=92.6, ckpt_type="caffe2"),
    # MODEL_ZOO.md:15-20 (MViT families, 1 crop x 5 clips, torch ckpts)
    "MVIT_B_16x4_CONV": dict(
        cfg="configs/Kinetics/MVIT_B_16x4_CONV.yaml",
        views=5, crops=1, top1=78.4, top5=93.5, ckpt_type="pytorch"),
    "REV_MVIT_B_16x4_CONV": dict(
        cfg="configs/Kinetics/REV_MVIT_B_16x4_CONV.yaml",
        views=5, crops=1, top1=78.4, top5=93.4, ckpt_type="pytorch"),
    "MVIT_B_32x3_CONV": dict(
        cfg="configs/Kinetics/MVIT_B_32x3_CONV.yaml",
        views=5, crops=1, top1=80.4, top5=94.8, ckpt_type="pytorch"),
    "MVITv2_S_16x4": dict(
        cfg="configs/Kinetics/MVITv2_S_16x4.yaml",
        views=5, crops=1, top1=81.0, top5=94.6, ckpt_type="pytorch"),
    "MVITv2_B_32x3": dict(
        cfg="configs/Kinetics/MVITv2_B_32x3.yaml",
        views=5, crops=1, top1=82.9, top5=95.7, ckpt_type="pytorch"),
    # MODEL_ZOO.md:24-29 (X3D, 10-view column: 1 crop x 10 clips)
    "X3D_XS": dict(cfg="configs/Kinetics/X3D_XS.yaml",
                   views=10, crops=1, top1=68.7, top5=None,
                   ckpt_type="pytorch"),
    "X3D_S": dict(cfg="configs/Kinetics/X3D_S.yaml",
                  views=10, crops=1, top1=73.1, top5=None,
                  ckpt_type="pytorch"),
    "X3D_M": dict(cfg="configs/Kinetics/X3D_M.yaml",
                  views=10, crops=1, top1=75.1, top5=None,
                  ckpt_type="pytorch"),
    "X3D_L": dict(cfg="configs/Kinetics/X3D_L.yaml",
                  views=10, crops=1, top1=76.9, top5=None,
                  ckpt_type="pytorch"),
}



def build_cfg(name, ckpt, data_dir, batch=None, opts=()):
    """The eval config of zoo entry ``name`` on the port's schema."""
    entry = ZOO[name]
    cfg = get_cfg()
    cfg.merge_from_file(entry["cfg"])
    cfg.TRAIN.ENABLE = False
    cfg.TEST.ENABLE = True
    cfg.TEST.CHECKPOINT_FILE_PATH = ckpt
    cfg.TEST.CHECKPOINT_TYPE = entry["ckpt_type"]
    cfg.TEST.NUM_ENSEMBLE_VIEWS = entry["views"]
    cfg.TEST.NUM_SPATIAL_CROPS = entry["crops"]
    cfg.TEST.NUM_TEMPORAL_CLIPS = []
    cfg.DATA.PATH_TO_DATA_DIR = data_dir
    cfg.NUM_GPUS = 1
    cfg.LOG_MODEL_INFO = False
    if batch:
        cfg.TEST.BATCH_SIZE = batch
    if opts:
        cfg.merge_from_list(list(opts))
    return assert_and_infer_cfg(cfg)


def verify(name, cfg, tolerance=0.5, device="cuda"):
    """Run the protocol; returns the JSON line's dict."""
    from slowfast_tpu_torch.engine.tester import test

    stats = test(cfg, device)[0]
    entry = ZOO[name]
    top1 = float(stats["top1_acc"])
    delta = top1 - entry["top1"]
    return {"model": name, "top1": top1, "top5": float(stats.get("top5_acc", 0.0)),
            "expected_top1": entry["top1"], "expected_top5": entry["top5"],
            "delta_top1": round(delta, 2), "pass": abs(delta) <= tolerance}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", choices=sorted(ZOO), help="zoo entry")
    ap.add_argument("--ckpt", help="downloaded checkpoint path")
    ap.add_argument("--data-dir", help="dataset dir with test.csv lists")
    ap.add_argument("--tolerance", type=float, default=0.5,
                    help="max |measured-expected| top-1 to pass (pts)")
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    ap.add_argument("--list", action="store_true", help="print zoo table")
    ap.add_argument("--opts", nargs=argparse.REMAINDER, default=[])
    args = ap.parse_args(argv)

    if args.list or not args.model:
        for k, v in ZOO.items():
            print(f"{k:28s} {v['crops']}x{v['views']:<3d} "
                  f"top1={v['top1']} top5={v['top5']}  ({v['cfg']})")
        return 0
    if not args.ckpt or not args.data_dir:
        ap.error("--ckpt and --data-dir are required with --model")
    cfg = build_cfg(args.model, args.ckpt, args.data_dir, args.batch, args.opts)
    result = verify(args.model, cfg, args.tolerance, args.device)
    print(json.dumps(result))
    return 0 if result["pass"] else 1


if __name__ == "__main__":
    sys.exit(main())
