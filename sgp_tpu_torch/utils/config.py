"""Global configuration: repository paths.

Counterpart of ``sgp_tpu/utils/config.py``: a dict-like :class:`Config`
holding the repository paths (``root_dir``, ``config_dir``, ``data_dir``,
the default dataset root, and ``logs_dir``, the runners' run directories),
with ``*_dir`` keys made absolute on set, and the overrides of
``sgp_tpu_config.yaml`` at the repository root when it exists. That file
is read by :func:`read_flat_yaml` (flat ``key: value`` lines), so PyYAML
is not needed.
"""
from __future__ import annotations

import os
import re
from typing import Any

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# YAML 1.1's plain scalars, as PyYAML's safe loader resolves them
_NULL = {"", "~", "null", "Null", "NULL"}
_TRUE = {"yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON"}
_FALSE = {"no", "No", "NO", "false", "False", "FALSE", "off", "Off", "OFF"}
_INT = re.compile(r"^[-+]?(0|[1-9][0-9_]*)$")
_FLOAT = re.compile(r"^[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?$"
                    r"|^[-+]?\.[0-9_]+(?:[eE][-+][0-9]+)?$")


def _scalar(text: str, where: str):
    if text and text[0] in "[{&*!|>%@`":
        raise ValueError(f"{where}: only flat scalars are read, got {text!r}")
    if len(text) >= 2 and text[0] == text[-1] and text[0] in "'\"":
        return text[1:-1]
    if text in _NULL:
        return None
    if text in _TRUE or text in _FALSE:
        return text in _TRUE
    if _INT.match(text):
        return int(text.replace("_", ""))
    if _FLOAT.match(text):
        return float(text.replace("_", ""))
    if text.lower() in (".inf", "+.inf", "-.inf", ".nan"):
        return float(text.lower().replace(".", ""))
    if ": " in text or text.endswith(":"):
        raise ValueError(f"{where}: nested mapping {text!r}")
    return text


def read_flat_yaml(path: str) -> dict:
    """Read a flat YAML file: ``key: scalar`` lines, and ``key:`` followed
    by ``- scalar`` lines for a list. Anything nested raises."""
    out, key = {}, None
    with open(path) as fp:
        lines = fp.read().splitlines()
    for i, raw in enumerate(lines, 1):
        where = f"{path}:{i}"
        line = re.sub(r"(^|\s)#.*$", "", raw).rstrip()
        if not line.strip() or line.strip() == "---":
            continue
        item = line.lstrip()
        if item.startswith("- ") or item == "-":
            if key is None or not isinstance(out[key], list):
                raise ValueError(f"{where}: list item outside a list")
            out[key].append(_scalar(item[1:].strip(), where))
            continue
        if line[0].isspace():
            raise ValueError(f"{where}: nested entry {raw!r}")
        name, sep, value = line.partition(":")
        if not sep:
            raise ValueError(f"{where}: not a 'key: value' line: {raw!r}")
        key, value = name.strip(), value.strip()
        nxt = next((ln for ln in lines[i:] if ln.strip()
                    and not ln.lstrip().startswith("#")), "")
        if not value and nxt.lstrip().startswith("-"):
            out[key] = []
        else:
            out[key] = _scalar(value, where)
    return out


class Config(dict):
    """Dict-like config; keys ending in ``_dir`` are absolutized on set."""

    def __init__(self, **kwargs):
        super().__init__()
        for k, v in kwargs.items():
            self[k] = v

    def __setitem__(self, key: str, value: Any):
        if isinstance(key, str) and key.endswith("_dir") \
                and isinstance(value, str):
            value = os.path.abspath(os.path.expanduser(value))
        super().__setitem__(key, value)

    def __getattr__(self, item):
        try:
            return self[item]
        except KeyError as e:
            raise AttributeError(item) from e

    def update_from_yaml(self, path: str):
        for k, v in read_flat_yaml(path).items():
            self[k] = v
        return self


config = Config(
    root_dir=_REPO_ROOT,
    config_dir=os.path.join(_REPO_ROOT, "configs"),
    data_dir=os.path.join(_REPO_ROOT, "datasets"),
    logs_dir=os.path.join(_REPO_ROOT, "log"),
)

_user_cfg = os.path.join(_REPO_ROOT, "sgp_tpu_config.yaml")
if os.path.exists(_user_cfg):
    config.update_from_yaml(_user_cfg)
