"""Run logging with byte-format parity to the reference's log files (a copy
of the JAX package's ``utils/logging.py``).

The reference's flat log files are a de-facto public API — its analysis
scripts parse them with regexes (visualization_utils.py:72-82,
plot_performance_curve.py:16-20). Formats preserved verbatim:

* ``train.log``: per-epoch ``'Epoch (%d)  Loss: contrast_loss:%0.4f\n'``
  (phase A, train.py:103-106) /
  ``'Epoch (%d)  Loss: l1_loss:%0.4f contrast_loss:%0.4f\n'`` (phase B,
  train.py:113-116).
* ``options.log``: the boxed flag dump (train.py:39-45).
* ``results.log``: ``'<N> Epochs Results:'`` then
  ``'<task>: <pad>PSNR/SSIM: x.xx/0.xxxx'`` rows (train.py:132-137).
"""

from __future__ import annotations

import os
from typing import TextIO

from .. import config as config_lib


def checkout(path: str) -> None:
    """mkdir-if-missing (reference dataset_utils.py:14-16)."""
    if not os.path.exists(path):
        os.makedirs(path, exist_ok=True)


class RunLogs:
    """Owns train.log / options.log / results.log under output_path."""

    def __init__(self, cfg: config_lib.Config):
        self.cfg = cfg
        checkout(cfg.output_path)
        checkout(cfg.ckpt_path)
        self.train_log: TextIO = open(os.path.join(cfg.output_path, "train.log"), "w")
        self.result_log: TextIO = open(os.path.join(cfg.output_path, "results.log"), "w")
        with open(os.path.join(cfg.output_path, "options.log"), "w") as f:
            for line in config_lib.options_log_lines(cfg):
                f.write(line + "\n")

    def log_epoch_encoder(self, epoch: int, contrast_loss: float) -> None:
        line = "Epoch (%d)  Loss: contrast_loss:%0.4f\n" % (epoch, contrast_loss)
        print(line, "\r", end="")
        self.train_log.write(line)
        self.train_log.flush()

    def log_epoch_joint(self, epoch: int, l1_loss: float, contrast_loss: float) -> None:
        line = "Epoch (%d)  Loss: l1_loss:%0.4f contrast_loss:%0.4f\n" % (
            epoch, l1_loss, contrast_loss)
        print(line, "\r", end="")
        self.train_log.write(line)
        self.train_log.flush()

    def log_results_header(self, epoch: int) -> None:
        self.result_log.write("%s Epochs Results:\n" % str(epoch))

    def log_result(self, task: str, result: str) -> None:
        self.result_log.write(task + ": " + " " * (25 - len(task)) + result + "\n")
        self.result_log.flush()

    def close(self) -> None:
        self.train_log.close()
        self.result_log.close()


def write_epoch_results_log(cfg: config_lib.Config, epochs: int,
                            rows: list[tuple[str, str]]) -> str:
    """test.py's ``epoch_<N>_results.log`` (test.py:96-100)."""
    path = os.path.join(cfg.output_path, "epoch_%s_results.log" % str(epochs))
    checkout(cfg.output_path)
    with open(path, "w") as f:
        for task, result in rows:
            f.write(task + ": " + " " * (25 - len(task)) + result + "\n")
    return path
