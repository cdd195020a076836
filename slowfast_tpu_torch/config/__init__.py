from .cfg_node import CfgNode
from .defaults import assert_and_infer_cfg, get_cfg

__all__ = ["CfgNode", "get_cfg", "assert_and_infer_cfg"]
