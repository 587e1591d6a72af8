"""Convert a checkpoint of the JAX package into the PyTorch port's format.

The JAX package stores its whole train state as an Orbax tree in a
directory ``<ckpt>/epoch_<N>/``. The port evaluates from one file,
``<ckpt>/epoch_<N>.pt`` = ``torch.save({"encoder": state_dict, "decoder":
state_dict})`` in the port's ``state_dict`` names. This tool reads the
Orbax tree (no template needed: only ``params`` and the models' ``extra``
collections are used), converts both models with
``utils/weights.py::from_jax`` and writes the ``.pt`` file beside the Orbax
directory, or under ``--out``. The optimizer moments, the MoCo key encoder
and its queue are dropped: the port's eval needs none of them.

Usage:
  python tools/jax_ckpt_to_torch.py --ckpt_path output/run/ckpt/ --epoch 1500
  python -m frequency_wised_all_in_one_image_restoration_model_tpu_torch.test \
      --output_path output/run/ --epochs 1500 <the run's model flags>

This tool imports both packages (and JAX, through Orbax); the port itself
never imports it.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402


def load_eval_variables(ckpt_path: str, epoch: int):
    """``(enc_vars, dec_vars)`` of the Orbax checkpoint ``epoch_<epoch>``
    under ``ckpt_path``, as nested dicts of numpy arrays."""
    import jax
    import orbax.checkpoint as ocp

    path = os.path.abspath(os.path.join(ckpt_path, f"epoch_{epoch}"))
    if not os.path.isdir(path):
        raise FileNotFoundError(f"no Orbax checkpoint at {path}")
    with ocp.StandardCheckpointer() as ckptr:
        tree = ckptr.restore(path)
    tree = jax.tree_util.tree_map(np.asarray, tree)
    extra = tree.get("extra") or {}
    return tuple({"params": tree["params"][net], **(extra.get(net) or {})}
                 for net in ("encoder", "decoder"))


def convert(ckpt_path: str, epoch: int, out: str | None = None) -> str:
    """Write ``epoch_<epoch>.pt`` under ``out`` (default ``ckpt_path``);
    returns its path."""
    from frequency_wised_all_in_one_image_restoration_model_tpu_torch.training import (
        checkpoint as tckpt)
    from frequency_wised_all_in_one_image_restoration_model_tpu_torch.utils.weights import (
        from_jax)

    enc_vars, dec_vars = load_eval_variables(ckpt_path, epoch)
    return tckpt.save_eval(out or ckpt_path, epoch, from_jax(enc_vars),
                           from_jax(dec_vars))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ckpt_path", required=True,
                    help="the JAX run's <output_path>/ckpt/ directory")
    ap.add_argument("--epoch", type=int, required=True)
    ap.add_argument("--out", default=None,
                    help="directory for epoch_<N>.pt (default: --ckpt_path)")
    args = ap.parse_args(argv)
    print("wrote", convert(args.ckpt_path, args.epoch, args.out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
