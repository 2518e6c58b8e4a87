"""Run logging — same artifact format as the reference
(``utils/file_ops.py:17-28``): DEBUG-level log to
``ood_eval_info.log`` (mode='w') + stderr, ``%(asctime)s : %(message)s``."""

from __future__ import annotations

import logging
import os


def setup_log(log_directory: str, name: str = "eval_ood") -> logging.Logger:
    os.makedirs(log_directory, exist_ok=True)
    log = logging.getLogger(f"mcm_tpu_torch.{name}")
    for h in log.handlers:  # close before dropping — repeated setup_log
        h.close()           # calls must not leak file descriptors
    log.handlers.clear()
    formatter = logging.Formatter("%(asctime)s : %(message)s")
    fh = logging.FileHandler(os.path.join(log_directory, "ood_eval_info.log"),
                             mode="w")
    fh.setFormatter(formatter)
    sh = logging.StreamHandler()
    sh.setFormatter(formatter)
    log.setLevel(logging.DEBUG)
    log.addHandler(fh)
    log.addHandler(sh)
    log.propagate = False
    log.debug(f"#########{name}############")
    return log
