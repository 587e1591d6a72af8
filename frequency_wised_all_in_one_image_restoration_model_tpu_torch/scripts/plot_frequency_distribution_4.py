"""Variant 4: clean against degraded band energy per task (root
``plot_frequency_distribution_4.py``; reference
plot_frequency_distribution_4.py):

    python -m frequency_wised_all_in_one_image_restoration_model_tpu_torch.scripts.plot_frequency_distribution_4 <flags>
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from .. import config as config_lib
from ..analysis import frequency_dist
from ..training.loop import build_train_loader
from . import common


def main(cfg: config_lib.Config, device=None
         ) -> Dict[str, Tuple[np.ndarray, np.ndarray]]:
    common.device_of(device, cfg.cuda)
    loader = build_train_loader(cfg, seed=cfg.seed)
    out = {}
    for i, task in enumerate(cfg.de_type):
        degraded, clean = [], []
        for _ in range(8):
            b = loader.next_batch()
            degraded.append(b["d1"][i] * 255.0)
            clean.append(b["c1"][i] * 255.0)
        hd = frequency_dist.dataset_band_histogram(degraded)
        hc = frequency_dist.dataset_band_histogram(clean)
        print(task, "degraded", np.round(hd, 4), "clean", np.round(hc, 4))
        out[task] = (hd, hc)
    return out


if __name__ == "__main__":
    main(config_lib.parse_args())
