"""PSNR-vs-epoch curves from the ``epoch_<N>_results.log`` files under
``--output_path`` (root ``plot_performance_curve.py``; reference
plot_performance_curve.py:8-26), written to ``PSNR_curve.png`` there:

    python -m frequency_wised_all_in_one_image_restoration_model_tpu_torch.scripts.plot_performance_curve <flags>
"""

from __future__ import annotations

import os
from typing import Optional

from .. import config as config_lib
from ..analysis import performance
from ..utils.visualization import plot_curve
from . import common


def main(cfg: config_lib.Config, device=None) -> Optional[str]:
    common.device_of(device, cfg.cuda)
    series = performance.parse_epoch_results(cfg.output_path, cfg.epochs)
    series = [s for s in series if s]
    if not series:
        print("no epoch_N_results.log files found under", cfg.output_path)
        return None
    out = os.path.join(cfg.output_path, "PSNR_curve.png")
    plot_curve(series, x_range=(0, len(series[0])),
               labels=list(cfg.test_de_type)[: len(series)],
               xlabel="Epochs", ylabel="PSNR", save_path=out)
    print("wrote", out)
    return out


if __name__ == "__main__":
    main(config_lib.parse_args())
