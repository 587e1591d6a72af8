"""Per-layer MSA band-energy curves across noise levels (root
``plot_MSA_frequency_curve.py``; reference plot_MSA_frequency_curve.py
parses after_MSA_<sigma>.log files, here computed from the model through a
capture), written to ``<output_path>/msa_band_curve.png``:

    python -m frequency_wised_all_in_one_image_restoration_model_tpu_torch.scripts.plot_MSA_frequency_curve <flags>
"""

from __future__ import annotations

import os

import numpy as np

from .. import config as config_lib
from ..analysis import msa_frequency
from ..data.synthetic import degrade, smooth_image
from ..utils.visualization import plot_curve
from . import common


def main(cfg: config_lib.Config, device=None) -> str:
    device = common.device_of(device, cfg.cuda)
    bundle, _ = common.setup(cfg, device)
    rng = np.random.default_rng(cfg.seed)
    p = cfg.crop_test_imgs_size
    curves, labels = [], []
    for sigma in (15, 25, 50, 75):
        clean = smooth_image(rng, p, p)
        x = degrade(clean, f"denoising_{sigma}", rng).astype(np.float32)[None] / 255.0
        x = common.images(x, device)
        ctx = common.features(bundle, x)
        report = msa_frequency.model_attention_band_report(
            bundle.decoder, bundle.decoder, x, ctx=ctx)
        layers = sorted(report)
        curves.append([float(report[k][-1]) for k in layers])  # top band share
        labels.append(f"sigma={sigma}")
    out = os.path.join(cfg.output_path, "msa_band_curve.png")
    os.makedirs(cfg.output_path, exist_ok=True)
    plot_curve(curves, labels=labels, xlabel="attention layer",
               ylabel="high-band energy share", ylim=(0, 1), save_path=out)
    print("wrote", out)
    return out


if __name__ == "__main__":
    main(config_lib.parse_args())
