"""The decoder's embed_lamb responses per degradation task (root
``plot_embed_lamb_curve.py``; reference plot_embed_lamb_curve.py:59-78):

    python -m frequency_wised_all_in_one_image_restoration_model_tpu_torch.scripts.plot_embed_lamb_curve <flags>
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from .. import config as config_lib
from ..analysis import embeddings as emb
from . import common


def main(cfg: config_lib.Config, device=None) -> Dict[str, Dict[str, np.ndarray]]:
    device = common.device_of(device, cfg.cuda)
    bundle, loader = common.setup(cfg, device)
    batch = loader.next_batch()
    responses = {}
    for i, task in enumerate(cfg.de_type):
        x = common.images(batch["d1"][i:i + 1], device)
        ctx = common.features(bundle, x)
        found = emb.embed_lamb_responses(bundle.decoder, x, ctx)
        print(task)
        for path, val in sorted(found.items()):
            print(" ", path, np.round(np.asarray(val).ravel(), 4).tolist())
        responses[task] = found
    return responses


if __name__ == "__main__":
    main(config_lib.parse_args())
