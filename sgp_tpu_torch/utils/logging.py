"""The package's logger, ``sgp_tpu_torch``: one stdout handler, INFO and up.

The modules' ``logging.getLogger(__name__)`` loggers are its children and
reach its handler; it does not pass records on to the root logger, so a
run's ``logging.basicConfig`` prints nothing twice. Counterpart of
``sgp_tpu/utils/logging.py``.
"""
import logging
import sys

logger = logging.getLogger("sgp_tpu_torch")
if not logger.handlers:
    _h = logging.StreamHandler(sys.stdout)
    _h.setFormatter(logging.Formatter(
        "%(asctime)s [%(levelname)s] %(name)s: %(message)s"))
    logger.addHandler(_h)
    logger.setLevel(logging.INFO)
    logger.propagate = False
