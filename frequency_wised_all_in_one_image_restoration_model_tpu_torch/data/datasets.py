"""File-backed degradation datasets (a copy of the JAX package's
``data/datasets.py``: numpy only).

Directory layout and semantics of reference ``utils/dataset_utils.py``:

* ``<data_root>/<task>_{train,test}/{Input,GT}/`` pairs; GT name derived from the
  input file as ``pre_suffix.ext -> pre.ext`` (first '.'-split, first
  '_'-split; dataset_utils.py:31-46);
* denoising tasks read GT only and synthesize Gaussian noise with a fixed
  seed, on the uint8 scale, clipped and cast before the [0, 1] scaling
  (dataset_utils.py:122-126): numpy draws, so both packages see the same
  noise;
* train iteration is round-robin over degradation types with a per-type
  reshuffle at each type-epoch boundary (dataset_utils.py:97-139), 400
  samples per task per epoch (dataset_utils.py:143-144), two independent
  paired random crops per sample, each forced through a random dihedral
  augmentation (dataset_utils.py:131-132), all keyed off one
  ``np.random.Generator``;
* every image center-cropped to a multiple of 16 (dataset_utils.py:118).
"""

from __future__ import annotations

import os
from typing import Dict, List, Tuple

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


def task_train_dir(cfg: Config, task: str) -> str:
    """'denoising_15' -> '<root>/denoising_train'; others '<root>/<task>_train'
    (dataset_utils.py:87-95)."""
    if "denoising" in task:
        sigma_len = len(task.split("_")[-1]) + 1
        return os.path.join(cfg.data_root, task[:-sigma_len] + "_train")
    return os.path.join(cfg.data_root, task + "_train")


def task_test_dir(cfg: Config, task: str) -> str:
    """Test naming: 'denoising_bsd68_15' -> 'denoising_bsd68_test'
    (dataset_utils.py:160-167)."""
    if "denoising" in task:
        sigma_len = len(task.split("_")[-1]) + 1
        return os.path.join(cfg.data_root, task[:-sigma_len] + "_test")
    return os.path.join(cfg.data_root, task + "_test")


class FileTrainLoader:
    """Round-robin batch iterator over on-disk degradation pairs."""

    def __init__(self, cfg: Config, seed: int = 0):
        self.cfg = cfg
        self.tasks = list(cfg.de_type)
        self.patch = cfg.patch_size
        self.rng = np.random.default_rng(seed)
        self.gt_ids: List[List[str]] = []
        self.input_ids: List[List[str]] = []
        self.cursor = [0] * len(self.tasks)
        for task in self.tasks:
            d = task_train_dir(cfg, task)
            gt, inp = get_data_ids(d, need_synthesize="denoising" in task)
            if not gt:
                raise FileNotFoundError(f"no training images under {d}")
            self.gt_ids.append(gt)
            self.input_ids.append(inp)
        for i in range(len(self.tasks)):
            self._shuffle(i)

    def _shuffle(self, i: int) -> None:
        perm = self.rng.permutation(len(self.gt_ids[i]))
        self.gt_ids[i] = [self.gt_ids[i][j] for j in perm]
        self.input_ids[i] = [self.input_ids[i][j] for j in perm]

    def total_pairs(self) -> int:
        """reference trainset.len() (dataset_utils.py:146-147)."""
        return sum(len(g) for g in self.gt_ids)

    def steps_per_epoch(self) -> int:
        """400 samples per task per epoch at one-sample-per-task batches
        (dataset_utils.py:143-144 with batch = num_tasks)."""
        if self.cfg.steps_per_epoch is not None:
            return self.cfg.steps_per_epoch
        return 400

    def _sample(self, i: int):
        task = self.tasks[i]
        gt_id = self.gt_ids[i][self.cursor[i]]
        input_id = self.input_ids[i][self.cursor[i]]
        self.cursor[i] += 1
        if self.cursor[i] >= len(self.gt_ids[i]):
            self.cursor[i] = 0
            self._shuffle(i)

        gt = augment.crop_img(load_image_rgb(gt_id), base=16)
        if "denoising" in task:
            sigma = int(task.split("_")[-1])
            if sigma == 0:
                sigma = int(self.rng.choice([15, 25, 50]))
            degraded = native.gaussian_noise_u8(
                gt, float(sigma), int(self.rng.integers(0, 2 ** 62)))
        else:
            degraded = augment.crop_img(load_image_rgb(input_id), base=16)
        name = os.path.basename(gt_id).split(".")[0]
        return name, degraded, gt

    def _crop_pair(self, degraded, gt):
        """One random window + forced dihedral for both images (fused in the
        native runtime when available)."""
        h, w = gt.shape[0], gt.shape[1]
        iy = int(self.rng.integers(0, h - self.patch + 1))
        ix = int(self.rng.integers(0, w - self.patch + 1))
        mode = int(self.rng.integers(1, 8))  # never identity (image_utils.py:177-182)
        dp = native.crop_augment_f32(degraded, iy, ix, self.patch, mode)
        cp = native.crop_augment_f32(gt, iy, ix, self.patch, mode)
        return dp, cp

    def next_batch(self) -> Dict[str, np.ndarray]:
        d1, d2, c1, c2, ids, names = [], [], [], [], [], []
        for i, task in enumerate(self.tasks):
            name, degraded, gt = self._sample(i)
            dp1, cp1 = self._crop_pair(degraded, gt)
            dp2, cp2 = self._crop_pair(degraded, gt)
            d1.append(dp1)
            d2.append(dp2)
            c1.append(cp1)
            c2.append(cp2)
            ids.append(i)
            names.append(name)
        return {"d1": np.stack(d1), "d2": np.stack(d2),
                "c1": np.stack(c1), "c2": np.stack(c2),
                "de_id": np.asarray(ids, np.int32), "names": names}

    def __iter__(self):
        while True:
            yield self.next_batch()


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
