"""Per-layer attention-map band-energy report (root ``plot_MSA_frequency.py``;
reference plot_MSA_frequency.py:20-111, debug_mode -> a capture):

    python -m frequency_wised_all_in_one_image_restoration_model_tpu_torch.scripts.plot_MSA_frequency <flags>
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from .. import config as config_lib
from ..analysis import msa_frequency
from . import common


def main(cfg: config_lib.Config, device=None) -> Dict[str, np.ndarray]:
    device = common.device_of(device, cfg.cuda)
    bundle, loader = common.setup(cfg, device)
    x = common.images(loader.next_batch()["d1"][:1], device)
    ctx = common.features(bundle, x)
    report = msa_frequency.model_attention_band_report(
        bundle.decoder, bundle.decoder, x, ctx=ctx)
    for path, hist in sorted(report.items()):
        print(path, np.round(hist, 4).tolist())
    return report


if __name__ == "__main__":
    main(config_lib.parse_args())
