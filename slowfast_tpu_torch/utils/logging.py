"""Logging utilities (counterpart of slowfast_tpu/utils/logging.py).

Logs go to stdout and ``stdout.log`` in the output dir; machine-readable
stats are emitted as ``json_stats:`` lines (and ``json_stats.log``). In a
multi-process job only the master (rank 0) logs and writes these files;
the other ranks print warnings and errors only.
"""

import json
import logging
import os
import sys

from .distributed import is_master_proc
from .io import pathmgr

_FORMAT = "[%(asctime)s][%(levelname)s] %(filename)s: %(lineno)3d: %(message)s"


def setup_logging(output_dir=None):
    """Configure the root logger: stdout, plus ``stdout.log`` in output_dir."""
    logger = logging.getLogger()
    logger.setLevel(logging.INFO)
    for h in list(logger.handlers):
        logger.removeHandler(h)
        h.close()
    formatter = logging.Formatter(_FORMAT, datefmt="%m/%d %H:%M:%S")
    handlers = [logging.StreamHandler(stream=sys.stdout)]
    if not is_master_proc():
        logger.setLevel(logging.WARNING)
    elif output_dir:
        path = os.path.join(output_dir, "stdout.log")
        handlers.append(logging.StreamHandler(pathmgr.open(path, "a")) if "://" in path
                        else logging.FileHandler(path))
    for h in handlers:
        h.setFormatter(formatter)
        logger.addHandler(h)


def get_logger(name):
    return logging.getLogger(name)


def log_json_stats(stats, output_dir=None):
    """Log a dict as a single ``json_stats:`` line (+ json_stats.log file),
    on the master only."""
    if not is_master_proc():
        return
    stats = {k: round(v, 5) if isinstance(v, float) else v for k, v in stats.items()}
    line = "json_stats: {:s}".format(json.dumps(stats, sort_keys=True))
    get_logger(__name__).info(line)
    if output_dir:
        with pathmgr.open(os.path.join(output_dir, "json_stats.log"), "a") as f:
            f.write(line + "\n")
