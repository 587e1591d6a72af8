"""Experiment sweep runner (root ``multi_experiments.py``; reference
multi_experiments.py:9-53):

    python -m frequency_wised_all_in_one_image_restoration_model_tpu_torch.scripts.multi_experiments \\
        [--sweep_file FILE] [--train] [--test] [--num_hosts N --host_index I]

A sweep is a list of experiment flag-strings (one a line of
``--sweep_file``, ``#`` lines skipped; else the reference's shipped
entry). Each runs as subprocesses, ``python -m <port>.train`` then
``python -m <port>.test`` with its flags and ``--output_path
output/h<slug>/`` (the slug derived from the flags as the reference does,
:9-18), so that a crash does not end the sweep; every outcome goes to
``multi_experiments.log`` (:34-38). ``--num_hosts N --host_index I`` takes
experiments ``I, I+N, I+2N, ...``: the round robin of the root script,
here over machines with a card each.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

from . import common

PKG = __name__.split(".")[0]


def tostr(hyperparams: str) -> str:
    """Flag string -> directory slug (reference multi_experiments.py:9-18)."""
    if not hyperparams:
        return ""
    out = ""
    for sub in hyperparams.split(" "):
        if sub:
            out += "_" + sub.replace("--", "")
    return out


def experiment(hyperparams: str, train: bool, test: bool, log_file,
               python: str = sys.executable, extra=()) -> bool:
    """Run one experiment as subprocesses of ``python``; ``extra`` flags go
    to both entry points."""
    out_dir = "output/h%s/" % tostr(hyperparams)
    ok = True
    try:
        for run, entry in ((train, "train"), (test, "test")):
            if run:
                print("%s: h %s" % ("training" if entry == "train"
                                    else "testing", hyperparams))
                subprocess.run(
                    [python, "-m", f"{PKG}.{entry}"] + hyperparams.split()
                    + ["--output_path", out_dir] + list(extra), check=True)
    except Exception as e:  # noqa: BLE001 — sweep must survive any failure
        log_file.write("[Error] %s\n" % e)
        ok = False
    else:
        log_file.write("[Done]\n")
    if train:
        log_file.write("training: h%s\n" % hyperparams)
    if test:
        log_file.write("testing: h%s\n" % hyperparams)
    log_file.flush()
    return ok


DEFAULT_SWEEP = [
    # the reference's shipped sweep entry (multi_experiments.py:50)
    "--encoder_type ViT --batch_wise_decompose True "
    "--frequency_decompose_type 5_bands --crop_test_imgs_size 128 "
    "--de_type denoising_15 denoising_25 denoising_50 deraining "
    "--test_de_type denoising_bsd68_15 denoising_bsd68_25 "
    "denoising_bsd68_50 deraining",
]


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--sweep_file", type=str, default=None,
                    help="file with one experiment flag-string per line")
    ap.add_argument("--train", action="store_true")
    ap.add_argument("--test", action="store_true")
    ap.add_argument("--num_hosts", type=int, default=1,
                    help="total hosts sharding this sweep")
    ap.add_argument("--host_index", type=int, default=0)
    return ap.parse_args(argv)


def main(cfg: argparse.Namespace, device=None,
         python: str = sys.executable) -> list:
    """Run this host's share of the sweep; returns ``(flags, ok)`` per
    experiment run. The entry points run on ``device``'s card (``--cuda``
    its index); ``device="cpu"`` passes no device flag."""
    device = common.device_of(device)
    extra = (["--cuda", str(device.index or 0)] if device.type == "cuda"
             else [])
    if cfg.sweep_file:
        with open(cfg.sweep_file) as f:
            sweep = [l.strip() for l in f if l.strip() and not l.startswith("#")]
    else:
        sweep = DEFAULT_SWEEP

    os.makedirs("output", exist_ok=True)
    done = []
    with open("multi_experiments.log", "w") as log_file:
        for i, hp in enumerate(sweep):
            if i % cfg.num_hosts != cfg.host_index:
                continue
            ok = experiment(hp, train=cfg.train, test=cfg.test or not cfg.train,
                            log_file=log_file, python=python, extra=extra)
            done.append((hp, ok))
    return done


if __name__ == "__main__":
    main(parse_args())
