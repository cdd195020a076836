"""Argument parsing and config loading (counterpart of
slowfast_tpu/utils/parser.py, the reference CLI contract).

``--cfg`` takes one or more yaml files and ``--opts`` trailing KEY VALUE
pairs. ``--device`` picks the torch device, ``cuda`` unless asked otherwise.
"""

import argparse
import os
import sys

from slowfast_tpu_torch.config import get_cfg


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description="Run a video understanding task with the PyTorch port."
    )
    parser.add_argument(
        "--device",
        help="Torch device to run on (default: cuda).",
        default="cuda",
        type=str,
    )
    parser.add_argument(
        "--cfg",
        dest="cfg_files",
        help="Path(s) to the config file(s).",
        default=None,
        nargs="+",
    )
    parser.add_argument(
        "--opts",
        help="Config overrides: --opts KEY VALUE [KEY VALUE ...].",
        default=None,
        nargs=argparse.REMAINDER,
    )
    if argv is None and len(sys.argv) == 1:
        parser.print_help()
    return parser.parse_args(argv)


def load_config(args, path_to_config=None):
    """Build a config from defaults + yaml file + CLI overrides."""
    cfg = get_cfg()
    if path_to_config is not None:
        cfg.merge_from_file(path_to_config)
    if args.opts is not None:
        cfg.merge_from_list(args.opts)
    if cfg.OUTPUT_DIR:
        os.makedirs(cfg.OUTPUT_DIR, exist_ok=True)
    return cfg
