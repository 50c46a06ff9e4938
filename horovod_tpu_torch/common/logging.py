"""Leveled, rank-prefixed logging to stderr (``HOROVOD_LOG_LEVEL``,
``HOROVOD_LOG_HIDE_TIME``), as ``horovod_tpu/common/logging.py``."""

from __future__ import annotations

import os
import sys
import threading
import time

from horovod_tpu_torch.common import config as _config

TRACE, DEBUG, INFO, WARNING, ERROR, FATAL = 0, 1, 2, 3, 4, 5

_LEVEL_NAMES = {"trace": TRACE, "debug": DEBUG, "info": INFO,
                "warning": WARNING, "error": ERROR, "fatal": FATAL}
_LEVEL_TAGS = {TRACE: "T", DEBUG: "D", INFO: "I", WARNING: "W",
               ERROR: "E", FATAL: "F"}

_lock = threading.Lock()


def log(level: int, msg: str, rank: int | None = None) -> None:
    if level < _LEVEL_NAMES.get(str(_config.get("log_level")).lower(),
                                WARNING):
        return
    parts = ["[", _LEVEL_TAGS[level], "]"]
    if not _config.get("log_hide_time"):
        t = time.time()
        stamp = time.strftime("%Y-%m-%d %H:%M:%S", time.localtime(t))
        parts.insert(0, "%s.%06d " % (stamp, int((t % 1) * 1e6)))
    if rank is None:
        rank = int(os.environ.get("HOROVOD_RANK", -1))
    if rank >= 0:
        parts.append("[%d]" % rank)
    parts.append(": ")
    parts.append(msg)
    line = "".join(parts)
    with _lock:
        print(line, file=sys.stderr, flush=True)
    if level == FATAL:
        raise SystemExit(line)


def debug(msg: str, rank: int | None = None) -> None:
    log(DEBUG, msg, rank)


def info(msg: str, rank: int | None = None) -> None:
    log(INFO, msg, rank)


def warning(msg: str, rank: int | None = None) -> None:
    log(WARNING, msg, rank)


def error(msg: str, rank: int | None = None) -> None:
    log(ERROR, msg, rank)
