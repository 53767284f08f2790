"""Logging setup for lungmask_tpu_torch (counterpart of ``lungmask_tpu.logger``).

A named, non-propagating stdout logger at INFO level with a timestamped
format. ``LUNGMASK_TPU_LOGLEVEL=DEBUG|INFO|WARNING|ERROR`` sets the level.
"""

import logging
import os
import sys

logger = logging.getLogger("lungmask_tpu_torch")
_env_level = os.environ.get("LUNGMASK_TPU_LOGLEVEL")
if _env_level is not None:
    # getLevelName returns an int only for real level names — a stray value
    # must fall back to INFO, not crash the import.
    _lvl = logging.getLevelName(_env_level.upper())
    logger.setLevel(_lvl if isinstance(_lvl, int) else logging.INFO)
elif logger.level == logging.NOTSET:
    logger.setLevel(logging.INFO)
logger.propagate = False
if not logger.handlers:
    _formatter = logging.Formatter(
        fmt="lungmask_tpu_torch %(asctime)s %(message)s", datefmt="%Y-%m-%d %H:%M:%S"
    )
    _handler = logging.StreamHandler(sys.stdout)
    _handler.setFormatter(_formatter)
    logger.addHandler(_handler)
