"""Contrast / L1 loss curves from ``<output_path>/train.log`` (root
``plot_loss_curve.py``; reference plot_loss_curve.py):

    python -m frequency_wised_all_in_one_image_restoration_model_tpu_torch.scripts.plot_loss_curve <flags>
"""

from __future__ import annotations

from .. import config as config_lib
from ..utils.visualization import plot_loss_curve
from . import common


def main(cfg: config_lib.Config, device=None) -> str:
    common.device_of(device, cfg.cuda)
    out = plot_loss_curve(cfg.output_path)
    print("wrote", out)
    return out


if __name__ == "__main__":
    main(config_lib.parse_args())
