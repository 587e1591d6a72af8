"""File-backed test sets (a copy of the eval part of the JAX package's
``data/datasets.py``: numpy only; the train loader comes with the training
slice).

Directory layout and semantics of reference ``utils/dataset_utils.py``:

* ``<data_root>/<task>_test/{Input,GT}/`` pairs; GT name derived from the
  input file as ``pre_suffix.ext -> pre.ext`` (first '.'-split, first
  '_'-split; dataset_utils.py:31-46);
* denoising tasks read GT only and synthesize Gaussian noise with a fixed
  seed, on the uint8 scale, clipped and cast before the [0, 1] scaling
  (dataset_utils.py:122-126): numpy draws, so both packages see the same
  noise;
* every image center-cropped to a multiple of 16 (dataset_utils.py:118).
"""

from __future__ import annotations

import os
from typing import List, Tuple

import numpy as np

from ..config import Config
from . import augment, native


def load_image_rgb(path: str) -> np.ndarray:
    """Decode via the native runtime when built, PIL otherwise."""
    return native.decode_rgb(path)


def derive_gt_name(input_file: str) -> str:
    """``pre_suffix.ext -> pre.ext`` (dataset_utils.py:31-34)."""
    pre = input_file.split(".")[0].split("_")[0]
    suf = input_file.split(".")[-1]
    return pre + "." + suf


def get_data_ids(task_dir: str, need_synthesize: bool) -> Tuple[List[str], List[str]]:
    """(gt_ids, input_ids); synthesized tasks have empty input ids
    (dataset_utils.py:18-48)."""
    gt_dir = os.path.join(task_dir, "GT")
    input_dir = os.path.join(task_dir, "Input")
    gt_ids, input_ids = [], []
    if need_synthesize:
        for f in sorted(os.listdir(gt_dir)):
            gt_ids.append(os.path.join(gt_dir, f))
            input_ids.append("")
    else:
        for f in sorted(os.listdir(input_dir)):
            gt_ids.append(os.path.join(gt_dir, derive_gt_name(f)))
            input_ids.append(os.path.join(input_dir, f))
    return gt_ids, input_ids


def task_test_dir(cfg: Config, task: str) -> str:
    """Test naming: 'denoising_bsd68_15' -> 'denoising_bsd68_test'
    (dataset_utils.py:160-167)."""
    if "denoising" in task:
        sigma_len = len(task.split("_")[-1]) + 1
        return os.path.join(cfg.data_root, task[:-sigma_len] + "_test")
    return os.path.join(cfg.data_root, task + "_test")


class FileTestDataset:
    """Per-task test set yielding ``(name, degraded, clean)`` float01 HWC
    (dataset_utils.py:150-197). Denoising synthesizes with a fixed seed
    (test.py:88-89 seeds numpy globally with 0)."""

    def __init__(self, cfg: Config, task: str, seed: int = 0):
        self.cfg = cfg
        self.task = task
        d = task_test_dir(cfg, task)
        self.gt_ids, self.input_ids = get_data_ids(
            d, need_synthesize="denoising" in task)
        self.rng = np.random.default_rng(seed)
        if "denoising" in task and int(task.split("_")[-1]) == 0:
            raise ValueError("sigma=0 is invalid at test time")  # dataset_utils.py:180

    def __len__(self):
        return len(self.gt_ids)

    def __iter__(self):
        for gt_id, input_id in zip(self.gt_ids, self.input_ids):
            gt = augment.crop_img(load_image_rgb(gt_id), base=16)
            if "denoising" in self.task:
                sigma = int(self.task.split("_")[-1])
                degraded = np.clip(
                    gt + self.rng.standard_normal(gt.shape) * sigma, 0, 255
                ).astype(np.uint8)
                name = os.path.basename(gt_id).split(".")[0]
            else:
                degraded = augment.crop_img(load_image_rgb(input_id), base=16)
                name = os.path.basename(input_id).split(".")[0]
            yield name, augment.to_float01(degraded), augment.to_float01(gt)
