"""Logger setup — file + stdout, reference-compatible format
(reference: py/standard_logger.py:5-28); the port's copy of the JAX
package's utils/logging.py."""

from __future__ import annotations

import logging
import os
import sys


def get_logger(log_file: str, logger_name: str = "SD-TPU", level=logging.DEBUG) -> logging.Logger:
    logger = logging.getLogger(logger_name)
    logger.setLevel(level)
    fmt = logging.Formatter("%(asctime)s - %(name)s - %(levelname)s - %(message)s")
    # re-point the file handler when the out-dir changes (serve mode runs
    # many jobs in one process; each must log next to its own outputs)
    target = os.path.abspath(log_file)
    for h in list(logger.handlers):
        if isinstance(h, logging.FileHandler):
            if h.baseFilename == target:
                return logger
            logger.removeHandler(h)
            h.close()
    fh = logging.FileHandler(log_file, mode="a")
    fh.setFormatter(fmt)
    logger.addHandler(fh)
    if not any(
        isinstance(h, logging.StreamHandler) and not isinstance(h, logging.FileHandler)
        for h in logger.handlers
    ):
        sh = logging.StreamHandler(sys.stdout)
        sh.setFormatter(fmt)
        logger.addHandler(sh)
    return logger
