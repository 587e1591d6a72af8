"""Variant 1: frequency histograms of the train degradations (the degraded
inputs; root ``plot_frequency_distribution_1.py``, reference
plot_frequency_distribution_1.py, which hard-codes a 6-task train set):

    python -m frequency_wised_all_in_one_image_restoration_model_tpu_torch.scripts.plot_frequency_distribution_1 <flags>
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from .. import config as config_lib
from ..analysis import frequency_dist
from ..training.loop import build_train_loader
from . import common


def main(cfg: config_lib.Config, device=None) -> Dict[str, np.ndarray]:
    common.device_of(device, cfg.cuda)
    loader = build_train_loader(cfg, seed=cfg.seed)
    per_task = {t: [] for t in cfg.de_type}
    for _ in range(8):
        b = loader.next_batch()
        for i, t in enumerate(cfg.de_type):
            per_task[t].append(b["d1"][i] * 255.0)
    hists = {}
    for t, imgs in per_task.items():
        hists[t] = frequency_dist.dataset_band_histogram(imgs)
        print(t, np.round(hists[t], 4))
    return hists


if __name__ == "__main__":
    main(config_lib.parse_args())
