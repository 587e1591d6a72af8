"""Export the eval forward as a self-contained serving artifact (the port's
counterpart of the JAX package's ``tools/export_serving.py``).

Restores the newest ``<ckpt_path>/epoch_<N>.pt`` when there is one (else
exports the weights drawn from ``--seed``), exports the eval forward on the
card with ``serving.export_eval`` and writes one ``.fairm`` file: the
program and the weights. A server needs torch, this package's ``serving``
module and the kernel sources, no model code:

    from frequency_wised_all_in_one_image_restoration_model_tpu_torch import serving
    model = serving.load("flagship.fairm")
    restored = model(tiles)        # [b, p, p, 3] float32, b <= the batch

Usage (on a machine with an NVIDIA GPU):

    python -m frequency_wised_all_in_one_image_restoration_model_tpu_torch.export_serving \\
        --out flagship.fairm [--batch 8] [--check] [<the flags of test.py>]

``--check`` loads the artifact back and compares it with the eager eval
forward on random tiles: it exits with 1 where they differ by more than
1e-4 of ``max(1, max|eager|)`` in float32 (the JAX CLI's bound), 1e-2 in
bfloat16 (the port's whole-forward bound). On the CPU call
``main(argv, device="cpu")``, which exports the plain route.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from . import config as config_lib
from . import serving
from .models.airnet import build_models, eval_forward, model_dtype
from .training import checkpoint as ckpt_lib

CHECK_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}


def main(argv=None, device=None) -> int:
    ap = argparse.ArgumentParser(add_help=False)
    ap.add_argument("--out", default="flagship.fairm")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--check", action="store_true")
    ns, rest = ap.parse_known_args(argv)
    cfg = config_lib.parse_args(rest)
    device = serving.resolve_device(device)

    bundle = build_models(cfg, device)
    latest = ckpt_lib.latest_epoch(cfg.ckpt_path)
    if latest is not None:
        ckpt_lib.restore_eval(cfg.ckpt_path, latest, bundle)
        print(f"loaded checkpoint epoch_{latest}")
    else:
        print("no checkpoint found; exporting the weights drawn from the seed")
    variables = (bundle.encoder.state_dict(), bundle.decoder.state_dict())
    blob = serving.export_eval(cfg, variables, batch=ns.batch, device=device)
    serving.save(ns.out, blob)
    p = cfg.crop_test_imgs_size
    print(f"wrote {ns.out}: {len(blob) / 2**20:.1f} MiB (batch {ns.batch}, "
          f"{p}^2 tiles, {device.type})")

    if ns.check:
        model = serving.load(ns.out, device)
        rng = np.random.default_rng(0)
        tiles = torch.from_numpy(rng.uniform(
            0, 1, (max(1, ns.batch - 1), p, p, 3)).astype(np.float32))
        got = model(tiles)
        want = eval_forward(bundle, tiles.to(device))
        err = (got - want).abs().max().item() / max(
            1.0, want.abs().max().item())
        tol = CHECK_TOL[model_dtype(cfg)]
        print(f"serve-check: max|artifact - eager| / max(1, max|eager|) = "
              f"{err:.3e} ({'OK' if err <= tol else 'MISMATCH'}, bound "
              f"{tol:.0e})")
        if err > tol:
            return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
