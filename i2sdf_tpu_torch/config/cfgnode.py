"""Hierarchical configuration nodes and a loader for the repo's YAML files.

The port's own copy of what it needs from `i2sdf_tpu/config/cfgnode.py`:
attribute access over nested dicts loaded from YAML files. It carries no
dependency on PyYAML: the
machine the port runs on is not promised to have it, so `parse_yaml`
reads the subset of YAML that `configs/*.yml` use (block mappings by
indentation, flow lists, plain and quoted scalars, comments) and
resolves scalars the way PyYAML's YAML 1.1 resolver does. Anything
outside that subset raises instead of being guessed at.
"""

from __future__ import annotations

import copy
import re
from typing import Any

_VALID_TYPES = (tuple, list, str, int, float, bool, type(None))

# PyYAML's YAML 1.1 implicit resolvers (yaml/resolver.py), minus the
# sexagesimal forms no config uses.
_BOOL = {"yes": True, "Yes": True, "YES": True, "true": True,
         "True": True, "TRUE": True, "on": True, "On": True, "ON": True,
         "no": False, "No": False, "NO": False, "false": False,
         "False": False, "FALSE": False, "off": False, "Off": False,
         "OFF": False}
_NULL = {"~", "null", "Null", "NULL", ""}
_INT = re.compile(r"^[-+]?(0|[1-9][0-9_]*)$")
_FLOAT = re.compile(
    r"^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
    r"|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?"
    r"|[-+]?\.(?:inf|Inf|INF)"
    r"|\.(?:nan|NaN|NAN))$")


def _scalar(text: str) -> Any:
    s = text.strip()
    if len(s) >= 2 and s[0] == s[-1] and s[0] in "'\"":
        body = s[1:-1]
        return body.replace("''", "'") if s[0] == "'" else body
    if s in _NULL:
        return None
    if s in _BOOL:
        return _BOOL[s]
    if _INT.match(s):
        return int(s.replace("_", ""))
    if _FLOAT.match(s):
        low = s.lower()
        if low.endswith("inf"):
            return float("-inf") if low.startswith("-") else float("inf")
        if low.endswith("nan"):
            return float("nan")
        return float(s.replace("_", ""))
    if s[0] in "[{&*!|>%@`":
        raise ValueError(f"unsupported YAML construct: {text!r}")
    return s


def _strip_comment(line: str) -> str:
    """Drop a `#` comment that is not inside quotes."""
    quote = None
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"":
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
    return line


def _flow_list(text: str) -> list:
    s = text.strip()
    if not (s.startswith("[") and s.endswith("]")):
        raise ValueError(f"unsupported YAML flow value: {text!r}")
    inner = s[1:-1].strip()
    if not inner:
        return []
    if "[" in inner or "{" in inner:
        raise ValueError(f"nested flow collections unsupported: {text!r}")
    return [_scalar(p) for p in inner.split(",")]


def parse_yaml(text: str) -> dict:
    """Parse the config subset of YAML into nested dicts."""
    root: dict = {}
    stack = [(-1, root)]  # (indent, mapping)
    for lineno, raw in enumerate(text.splitlines(), 1):
        line = _strip_comment(raw).rstrip()
        if not line.strip():
            continue
        if "\t" in line[: len(line) - len(line.lstrip())]:
            raise ValueError(f"line {lineno}: tab indentation")
        indent = len(line) - len(line.lstrip(" "))
        body = line.strip()
        if body.startswith("- ") or body == "-":
            raise ValueError(f"line {lineno}: block sequences unsupported")
        key, sep, rest = body.partition(":")
        if not sep or (rest and not rest.startswith(" ")):
            raise ValueError(f"line {lineno}: expected 'key: value'")
        key = _scalar(key)
        while stack[-1][0] >= indent:
            stack.pop()
        parent = stack[-1][1]
        if key in parent:
            raise ValueError(f"line {lineno}: duplicate key {key!r}")
        rest = rest.strip()
        if not rest:
            child: dict = {}
            parent[key] = child
            stack.append((indent, child))
        elif rest.startswith("["):
            parent[key] = _flow_list(rest)
        else:
            parent[key] = _scalar(rest)
    # PyYAML gives None for a key with nothing nested under it
    def fix(d):
        for k, v in d.items():
            if isinstance(v, dict):
                d[k] = fix(v) if v else None
        return d

    return fix(root)


class CfgNode(dict):
    """A nested dict with attribute access."""

    def __init__(self, init_dict: dict | None = None):
        super().__init__(self._create_tree(init_dict or {}))

    @classmethod
    def _create_tree(cls, d: dict) -> dict:
        out = {}
        for k, v in d.items():
            if isinstance(v, dict):
                out[k] = cls(v)
            elif isinstance(v, _VALID_TYPES):
                out[k] = copy.deepcopy(v)
            else:
                raise ValueError(
                    f"Key {k} has invalid config value type {type(v)}")
        return out

    def __getattr__(self, name: str) -> Any:
        if name in self:
            return self[name]
        raise AttributeError(f"Config has no attribute '{name}'")

    def __setattr__(self, name: str, value: Any) -> None:
        if isinstance(value, dict) and not isinstance(value, CfgNode):
            value = CfgNode(value)
        if not isinstance(value, _VALID_TYPES + (CfgNode,)):
            raise ValueError(
                f"Invalid type {type(value)} for config key '{name}'")
        self[name] = value

    def __repr__(self) -> str:
        return f"CfgNode({super().__repr__()})"


def load_cfg(path: str) -> CfgNode:
    """Load a CfgNode from a YAML file path."""
    with open(path, "r") as fh:
        return CfgNode(parse_yaml(fh.read()) or {})
