"""Run-directory logging: colored console + per-run logfile
(posfeat_tpu/core/logging_utils.py; reference trainer.py:190-249)."""

from __future__ import annotations

import logging
import os
import sys

_COLORS = {
    "DEBUG": "\033[36m",
    "INFO": "\033[37m",
    "WARNING": "\033[33m",
    "ERROR": "\033[31m",
    "CRITICAL": "\033[41m",
}
_RESET = "\033[0m"


class _ColorFormatter(logging.Formatter):
    def format(self, record):
        msg = super().format(record)
        color = _COLORS.get(record.levelname, "")
        return f"{color}{msg}{_RESET}" if sys.stderr.isatty() else msg


def make_logger(name: str, logfile: str = None, rank: int = 0) -> logging.Logger:
    logger = logging.getLogger(name)
    logger.setLevel(logging.INFO if rank == 0 else logging.ERROR)
    for h in logger.handlers:
        h.close()
    logger.handlers.clear()
    logger.propagate = False

    fmt = f"%(asctime)s - rank {rank} - %(levelname)s: %(message)s"
    ch = logging.StreamHandler()
    ch.setFormatter(_ColorFormatter(fmt))
    logger.addHandler(ch)
    if logfile:
        os.makedirs(os.path.dirname(logfile), exist_ok=True)
        fh = logging.FileHandler(logfile, mode="a")
        fh.setFormatter(logging.Formatter(fmt))
        logger.addHandler(fh)
    return logger
