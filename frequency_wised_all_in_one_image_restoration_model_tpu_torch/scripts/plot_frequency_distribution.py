"""Per-degradation FFT band-energy histograms of the test sets (root
``plot_frequency_distribution.py``; reference
plot_frequency_distribution.py:10-52), written to
``<output_path>/frequency_distribution.png``; the on-disk test sets, or
``--synthetic_data``:

    python -m frequency_wised_all_in_one_image_restoration_model_tpu_torch.scripts.plot_frequency_distribution <flags>
"""

from __future__ import annotations

import itertools
import os
from typing import List

import numpy as np

from .. import config as config_lib
from ..analysis import frequency_dist
from ..evaluation.runner import build_test_dataset
from ..utils.visualization import plot_curve
from . import common


def main(cfg: config_lib.Config, device=None) -> List[np.ndarray]:
    common.device_of(device, cfg.cuda)
    hists = []
    for task in cfg.test_de_type:
        ds = build_test_dataset(cfg, task)
        imgs = [np.asarray(d) * 255.0 for _, d, _ in itertools.islice(iter(ds), 8)]
        hists.append(frequency_dist.dataset_band_histogram(imgs))
        print(task, np.round(hists[-1], 4))
    out = os.path.join(cfg.output_path, "frequency_distribution.png")
    os.makedirs(cfg.output_path, exist_ok=True)
    plot_curve(hists, labels=list(cfg.test_de_type), xlabel="band",
               ylabel="energy", ylim=(0, 1), save_path=out)
    print("wrote", out)
    return hists


if __name__ == "__main__":
    main(config_lib.parse_args())
