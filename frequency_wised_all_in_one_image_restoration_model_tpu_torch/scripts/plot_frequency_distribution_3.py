"""Variant 3: latent-space LFC / HFC scatter through the degradation
encoder (root ``plot_frequency_distribution_3.py``; reference
plot_frequency_distribution_3.py:29-45: per test task, the encoder's
spatial map histogrammed), written to ``<output_path>/latent_lfc_hfc.png``:

    python -m frequency_wised_all_in_one_image_restoration_model_tpu_torch.scripts.plot_frequency_distribution_3 <flags>
"""

from __future__ import annotations

import os

import numpy as np

from .. import config as config_lib
from ..evaluation.runner import build_test_dataset
from ..utils.visualization import get_frequency_distribution, plot_scatter
from . import common


def main(cfg: config_lib.Config, device=None) -> str:
    device = common.device_of(device, cfg.cuda)
    bundle, _ = common.setup(cfg, device)
    lows, highs = [], []
    for task in cfg.test_de_type:
        ds = build_test_dataset(cfg, task)
        low, high = [], []
        for idx, (name, degraded, clean) in enumerate(ds):
            if idx == 8:
                break
            p = cfg.crop_test_imgs_size
            inter = common.spatial_inter(bundle, degraded[None, :p, :p])
            gray = inter[0].mean(-1)
            hist = get_frequency_distribution(gray.astype(np.float64), norm=False)
            low.append(hist[0])
            high.append(np.sum(hist[1:]))
        lows.append(low)
        highs.append(high)
    out = os.path.join(cfg.output_path, "latent_lfc_hfc.png")
    os.makedirs(cfg.output_path, exist_ok=True)
    plot_scatter(lows, highs, labels=list(cfg.test_de_type), xlabel="latent LFC",
                 ylabel="latent HFC", set_lim=False, save_path=out)
    print("wrote", out)
    return out


if __name__ == "__main__":
    main(config_lib.parse_args())
