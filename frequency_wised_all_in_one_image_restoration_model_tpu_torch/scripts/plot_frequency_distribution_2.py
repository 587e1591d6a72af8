"""Variant 2: per-sample LFC / HFC scatter across degradation tasks (root
``plot_frequency_distribution_2.py``; reference
plot_frequency_distribution_2.py:39-55), written to
``<output_path>/lfc_hfc_scatter.png``:

    python -m frequency_wised_all_in_one_image_restoration_model_tpu_torch.scripts.plot_frequency_distribution_2 <flags>
"""

from __future__ import annotations

import os

from .. import config as config_lib
from ..analysis import frequency_dist
from ..training.loop import build_train_loader
from ..utils.visualization import plot_scatter
from . import common


def main(cfg: config_lib.Config, device=None) -> str:
    common.device_of(device, cfg.cuda)
    loader = build_train_loader(cfg, seed=cfg.seed)
    xs = [[] for _ in cfg.de_type]
    ys = [[] for _ in cfg.de_type]
    for _ in range(16):
        b = loader.next_batch()
        for i in range(len(cfg.de_type)):
            lfc, hfc = frequency_dist.lfc_hfc(b["d1"][i] * 255.0)
            xs[i].append(lfc)
            ys[i].append(hfc)
    out = os.path.join(cfg.output_path, "lfc_hfc_scatter.png")
    os.makedirs(cfg.output_path, exist_ok=True)
    plot_scatter(xs, ys, labels=list(cfg.de_type), xlabel="LFC", ylabel="HFC",
                 set_lim=False, save_path=out)
    print("wrote", out)
    return out


if __name__ == "__main__":
    main(config_lib.parse_args())
