"""Hierarchical configuration (own copy; no PyYAML needed)."""

from .cfgnode import CfgNode, load_cfg

__all__ = ["CfgNode", "load_cfg"]
