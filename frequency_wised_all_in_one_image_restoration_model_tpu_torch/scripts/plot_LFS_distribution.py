"""Low-frequency-sensitivity Taylor channel scores (root
``plot_LFS_distribution.py``; reference plot_LFS_distribution.py + the
truncated lfs_visualization_utils):

    python -m frequency_wised_all_in_one_image_restoration_model_tpu_torch.scripts.plot_LFS_distribution <flags>

The student embedding is computed from the same unfiltered images, at the
same weights, as the teacher, as in the root script: the KL term is 0 and
its gradient vanishes; only the restoration filters its input (ROADMAP,
R7).
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

from .. import config as config_lib
from ..analysis import lfs
from ..models.airnet import ModelBundle, restore
from . import common


def lfs_analysis(bundle: ModelBundle, batch: Dict,
                 batches: Sequence[Dict], prune_ratio: float = 0.2) -> Dict:
    """The teacher embedding of ``batch``; the objective's value on
    ``batches[0]`` and its mean gradient over ``batches`` by autograd through
    the eval forward, keyed ``encoder.<name>`` / ``decoder.<name>``; the
    Taylor scores and the channel masks."""
    device = bundle.device
    models = {"encoder": bundle.encoder, "decoder": bundle.decoder}

    def restore_fn(x):
        return restore(bundle, lfs.gaussian_filter_fft(
            common.images(x, device), cutoff=0.2))

    def embed_fn(x):
        return bundle.encoder(common.images(x, device))[1][0]

    with torch.no_grad():
        teacher = embed_fn(batch["d1"])
    loss_fn = lfs.distillation_loss_fn(restore_fn, embed_fn, teacher)
    with torch.no_grad():
        loss = float(loss_fn(batches[0]))
    params = {f"{k}.{n}": p for k, m in models.items()
              for n, p in m.named_parameters()}
    grads = lfs.lfs_gradients(loss_fn, params, batches)
    scores = lfs.taylor_scores(models, grads)
    masks, thresh = lfs.channel_mask(scores, prune_ratio=prune_ratio)
    return dict(loss=loss, grads=grads, scores=scores, masks=masks,
                thresh=thresh)


def main(cfg: config_lib.Config, device=None) -> Dict:
    device = common.device_of(device, cfg.cuda)
    bundle, loader = common.setup(cfg, device, restore=False)
    batch = loader.next_batch()
    out = lfs_analysis(bundle, batch,
                       [{k: batch[k] for k in ("d1", "c1")} for _ in range(2)])
    scores, masks = out["scores"], out["masks"]
    kept = sum(int(m.sum()) for m in masks.values())
    total = sum(m.size for m in masks.values())
    print(f"threshold={out['thresh']:.3e} kept {kept}/{total} channels")
    for name in list(scores)[:10]:
        print(name, float(np.mean(scores[name])))
    return out


if __name__ == "__main__":
    main(config_lib.parse_args())
