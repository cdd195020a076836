"""Argument parsing and config loading (counterpart of
slowfast_tpu/utils/parser.py, the reference CLI contract).

``--cfg`` takes one or more yaml files and ``--opts`` trailing KEY VALUE
pairs. ``--device`` picks the torch device, ``cuda`` unless asked otherwise.
``--shard_id``, ``--num_shards`` and ``--init_method`` set the job's hosts
and where its ranks meet (``NUM_SHARDS``, ``SHARD_ID``, ``INIT_METHOD``).
"""

import argparse
import sys

from slowfast_tpu_torch.config import get_cfg
from slowfast_tpu_torch.utils.io import pathmgr


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
        "--shard_id",
        help="Index of this host among NUM_SHARDS hosts.",
        default=0,
        type=int,
    )
    parser.add_argument(
        "--num_shards",
        help="Total number of hosts of the job.",
        default=1,
        type=int,
    )
    parser.add_argument(
        "--init_method",
        help="Where the ranks meet (torch.distributed init method): tcp://host:port "
             "or file:///path.",
        default="tcp://localhost:9999",
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
    cfg.NUM_SHARDS = args.num_shards
    cfg.SHARD_ID = args.shard_id
    cfg.INIT_METHOD = args.init_method
    if cfg.OUTPUT_DIR:
        pathmgr.mkdirs(cfg.OUTPUT_DIR)
    return cfg
