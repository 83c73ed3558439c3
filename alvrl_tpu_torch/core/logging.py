"""Leveled logging, a copy of alvrl_tpu/core/logging.py (counterpart of
Logger/Appender/Formatter, src/libcore/logger.cpp): thin configuration
over the stdlib so every module logs uniformly, with optional per-node
file appenders like the reference's mitsuba.<node>.log
(mitsuba.cpp:266-272)."""

from __future__ import annotations

import logging
import sys

_FMT = "%(asctime)s %(levelname).4s [%(name)s] %(message)s"


def get_logger(name: str) -> logging.Logger:
    return logging.getLogger(f"alvrl.{name}")


def configure(level: str = "INFO", logfile: str | None = None):
    root = logging.getLogger("alvrl")
    root.setLevel(getattr(logging, level.upper()))
    root.handlers.clear()
    sh = logging.StreamHandler(sys.stderr)
    sh.setFormatter(logging.Formatter(_FMT, datefmt="%H:%M:%S"))
    root.addHandler(sh)
    if logfile:
        fh = logging.FileHandler(logfile)
        fh.setFormatter(logging.Formatter(_FMT))
        root.addHandler(fh)
    return root
