"""Logging helpers (copied from ``tecogan_tpu/utils/logging_utils.py``:
``setup_logger``, ``log_info``, ``print_options`` and, from lines 39-45,
``format_train_msg``).

The per-iteration log line ``[epoch: E | iter: I | lr_G: x] k: v, ...`` is
the JAX package's and the reference's (`base_model.py:191-202`); the
training monitor parses it.
"""

from __future__ import annotations

import logging

__all__ = ["setup_logger", "log_info", "log_warning", "print_options",
           "format_train_msg"]


def setup_logger(name: str = "base"):
    logger = logging.getLogger(name)
    if logger.handlers:
        return logger
    logger.setLevel(logging.INFO)
    fmt = logging.Formatter(fmt="%(asctime)s [%(levelname)s]: %(message)s")
    sh = logging.StreamHandler()
    sh.setFormatter(fmt)
    logger.addHandler(sh)
    return logger


def log_info(msg, logger_name: str = "base"):
    logging.getLogger(logger_name).info(msg)


def log_warning(msg, logger_name: str = "base"):
    logging.getLogger(logger_name).warning(msg)


def print_options(opt, logger_name: str = "base", tab: str = ""):
    for key, val in opt.items():
        if isinstance(val, dict):
            log_info(f"{tab}{key}:", logger_name)
            print_options(val, logger_name, tab + "  ")
        else:
            log_info(f"{tab}{key}: {val}", logger_name)


def format_train_msg(epoch, it, lr_dict, running_log):
    msg = f"[epoch: {epoch} | iter: {it}"
    for lr_type, lr in lr_dict.items():
        msg += f" | {lr_type}: {lr:.2e}"
    msg += "] "
    msg += ", ".join(f"{k}: {v:.3e}" for k, v in running_log.items())
    return msg
