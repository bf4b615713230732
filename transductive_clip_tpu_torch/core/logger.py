"""File + stream logging with auto-versioned per-run filenames.

Mirrors the reference Logger / get_log_file (reference: src/utils.py:171-238).
"""

from __future__ import annotations

import logging
import os


class Logger:
    def __init__(self, module_name: str, filename: str):
        self.module_name = module_name
        self.filename = filename
        # the REGISTRY key embeds the filename (one handler set per
        # module x log file), but records must not propagate upward: dots
        # inside the path would create unintended logging-hierarchy
        # ancestors, and a configured root handler (e.g. absl's under jax)
        # would duplicate every line
        self._logger = logging.getLogger(f"{module_name}:{filename}")
        self._logger.setLevel(logging.INFO)
        self._logger.propagate = False
        if not self._logger.handlers:
            # reference line format '[module]: [LEVEL]: msg'
            # (reference: src/utils.py:177-184) — the module label alone,
            # not the registry key with the embedded path
            fmt = logging.Formatter(
                f"[{module_name}]: [%(levelname)s]: %(message)s"
            )
            os.makedirs(os.path.dirname(filename) or ".", exist_ok=True)
            fh = logging.FileHandler(filename)
            fh.setFormatter(fmt)
            sh = logging.StreamHandler()
            sh.setFormatter(fmt)
            self._logger.addHandler(fh)
            self._logger.addHandler(sh)

    def del_logger(self):
        for handler in self._logger.handlers[:]:
            handler.close()
            self._logger.removeHandler(handler)

    def info(self, msg):
        self._logger.info(msg)

    def debug(self, msg):
        self._logger.debug(msg)

    def warning(self, msg):
        self._logger.warning(msg)

    def critical(self, msg):
        self._logger.critical(msg)

    def exception(self, msg):
        self._logger.exception(msg)


def make_log_dir(log_path: str, dataset: str, method: str) -> str:
    log_dir = os.path.join(log_path, dataset, method)
    os.makedirs(log_dir, exist_ok=True)
    return log_dir


def get_log_file(log_path: str, dataset: str, method: str) -> str:
    """Auto-incrementing run log filename <log_path>/<ds>/<method>/<method>_run_<i>.log."""
    log_dir = make_log_dir(log_path, dataset, method)
    i = 0
    while os.path.exists(os.path.join(log_dir, f"{method}_run_{i}.log")):
        i += 1
    return os.path.join(log_dir, f"{method}_run_{i}.log")
