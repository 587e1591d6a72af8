"""t-SNE of degradation embeddings colored by task (root
``plot_TSNE_distribution.py``; reference plot_TSNE_distribution.py:74-94),
written to ``<output_path>/tsne.png``:

    python -m frequency_wised_all_in_one_image_restoration_model_tpu_torch.scripts.plot_TSNE_distribution <flags>
"""

from __future__ import annotations

import os

import torch

from .. import config as config_lib
from ..analysis import embeddings as emb
from ..utils.visualization import plot_scatter
from . import common


def main(cfg: config_lib.Config, device=None) -> str:
    device = common.device_of(device, cfg.cuda)
    bundle, loader = common.setup(cfg, device)

    def encode(x):
        with torch.inference_mode():
            return bundle.encoder(common.images(x, device))[1]

    batches = [loader.next_batch() for _ in range(16)]
    E, ids = emb.collect_embeddings(encode, batches)
    pts = emb.tsne_embed(E)
    xs = [pts[ids == i, 0] for i in range(len(cfg.de_type))]
    ys = [pts[ids == i, 1] for i in range(len(cfg.de_type))]
    out = os.path.join(cfg.output_path, "tsne.png")
    os.makedirs(cfg.output_path, exist_ok=True)
    plot_scatter(xs, ys, labels=list(cfg.de_type), set_lim=False, save_path=out)
    print("wrote", out)
    return out


if __name__ == "__main__":
    main(config_lib.parse_args())
