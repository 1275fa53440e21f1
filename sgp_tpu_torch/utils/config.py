"""Global configuration: repository paths.

Counterpart of ``sgp_tpu/utils/config.py`` reduced to what the port reads:
``data_dir`` (the default dataset root), ``logs_dir`` (the runners' run
directories) and ``config_dir`` (where relative ``--config`` paths are
looked up). It has no YAML overrides, so PyYAML is not an import-time
dependency.
"""
from __future__ import annotations

import os

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

config = {"data_dir": os.path.join(_REPO_ROOT, "datasets"),
          "logs_dir": os.path.join(_REPO_ROOT, "log"),
          "config_dir": os.path.join(_REPO_ROOT, "configs")}
