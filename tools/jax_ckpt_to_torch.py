"""Convert a checkpoint of the JAX package into the PyTorch port's format.

The JAX package stores its whole train state as an Orbax tree in a
directory ``<ckpt>/epoch_<N>/``. The port reads one file,
``<ckpt>/epoch_<N>.pt`` = ``torch.save({"encoder": state_dict, "decoder":
state_dict, "train_state": {...}})`` in the port's ``state_dict`` names
(``training/checkpoint.py``). This tool reads the Orbax tree (no template
needed), converts it with ``utils/weights.py::train_state_from_jax`` (both
models, the MoCo key encoder, queue and pointer, Adam's moments, count and
learning rate) and writes the ``.pt`` file beside the Orbax directory, or
under ``--out``: the port's eval entry point evaluates from it and its
training entry point resumes from it (``startpoint``). ``--eval_only``
writes the two models alone.

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


def load_tree(ckpt_path: str, epoch: int):
    """The Orbax checkpoint ``epoch_<epoch>`` under ``ckpt_path`` as nested
    dicts and lists of numpy arrays."""
    import jax
    import orbax.checkpoint as ocp

    path = os.path.abspath(os.path.join(ckpt_path, f"epoch_{epoch}"))
    if not os.path.isdir(path):
        raise FileNotFoundError(f"no Orbax checkpoint at {path}")
    with ocp.StandardCheckpointer() as ckptr:
        tree = ckptr.restore(path)
    return jax.tree_util.tree_map(np.asarray, tree)


def load_eval_variables(ckpt_path: str, epoch: int):
    """``(enc_vars, dec_vars)`` of that checkpoint."""
    tree = load_tree(ckpt_path, epoch)
    extra = tree.get("extra") or {}
    return tuple({"params": tree["params"][net], **(extra.get(net) or {})}
                 for net in ("encoder", "decoder"))


def convert(ckpt_path: str, epoch: int, out: str | None = None,
            eval_only: bool = False) -> str:
    """Write ``epoch_<epoch>.pt`` under ``out`` (default ``ckpt_path``):
    the whole train state, or with ``eval_only`` the two models; returns
    its path."""
    import torch

    from frequency_wised_all_in_one_image_restoration_model_tpu_torch.training import (
        checkpoint as tckpt)
    from frequency_wised_all_in_one_image_restoration_model_tpu_torch.utils.weights import (
        from_jax, train_state_from_jax)

    tree = load_tree(ckpt_path, epoch)
    if not ("params_k" in (tree.get("moco") or {})
            and "inner_state" in (tree.get("opt_state") or {})):
        print("no key encoder or Adam state in the tree: writing the two "
              "models only")
        eval_only = True
    if eval_only:
        enc_vars, dec_vars = load_eval_variables(ckpt_path, epoch)
        return tckpt.save_eval(out or ckpt_path, epoch, from_jax(enc_vars),
                               from_jax(dec_vars))
    tree = train_state_from_jax(tree)
    os.makedirs(out or ckpt_path, exist_ok=True)
    path = tckpt.ckpt_file(out or ckpt_path, epoch)
    torch.save(tree, path)
    return path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ckpt_path", required=True,
                    help="the JAX run's <output_path>/ckpt/ directory")
    ap.add_argument("--epoch", type=int, required=True)
    ap.add_argument("--out", default=None,
                    help="directory for epoch_<N>.pt (default: --ckpt_path)")
    ap.add_argument("--eval_only", action="store_true",
                    help="write the two models only, no train state")
    args = ap.parse_args(argv)
    print("wrote", convert(args.ckpt_path, args.epoch, args.out,
                           args.eval_only))
    return 0


if __name__ == "__main__":
    sys.exit(main())
