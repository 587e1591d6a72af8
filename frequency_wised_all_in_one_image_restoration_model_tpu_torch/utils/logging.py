"""The eval run's log file, byte for byte the reference's format (the eval
part of the JAX package's ``utils/logging.py``; ``RunLogs`` comes with the
training slice).

The reference's flat log files are parsed by its analysis scripts with
regexes (visualization_utils.py:72-82, plot_performance_curve.py:16-20):
rows of ``'<task>: <pad>PSNR/SSIM: x.xx/0.xxxx'``, the task padded to 25.
"""

from __future__ import annotations

import os

from .. import config as config_lib


def checkout(path: str) -> None:
    """mkdir-if-missing (reference dataset_utils.py:14-16)."""
    if not os.path.exists(path):
        os.makedirs(path, exist_ok=True)


def write_epoch_results_log(cfg: config_lib.Config, epochs: int,
                            rows: list[tuple[str, str]]) -> str:
    """test.py's ``epoch_<N>_results.log`` (test.py:96-100)."""
    path = os.path.join(cfg.output_path, "epoch_%s_results.log" % str(epochs))
    checkout(cfg.output_path)
    with open(path, "w") as f:
        for task, result in rows:
            f.write(task + ": " + " " * (25 - len(task)) + result + "\n")
    return path
