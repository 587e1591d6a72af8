"""The learned per-band attention gains ``lamb`` (root
``plot_lamb_curve.py``; reference plot_lamb_curve.py:41-49):

    python -m frequency_wised_all_in_one_image_restoration_model_tpu_torch.scripts.plot_lamb_curve <flags>
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from .. import config as config_lib
from ..analysis import embeddings as emb
from . import common


def main(cfg: config_lib.Config, device=None) -> Dict[str, np.ndarray]:
    device = common.device_of(device, cfg.cuda)
    bundle, _ = common.setup(cfg, device)
    lambs = emb.extract_lamb_params({"encoder": bundle.encoder,
                                     "decoder": bundle.decoder})
    for path, val in lambs.items():
        print(path, val.tolist())
    return lambs


if __name__ == "__main__":
    main(config_lib.parse_args())
