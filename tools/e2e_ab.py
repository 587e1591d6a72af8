"""End-to-end timings of the port on one card, for a parent / change
comparison: the eval forward (bf16, B=32, default route; ms and restored
MP/s, twice, then one ``torch.profiler`` trace with each port kernel's
device time) of the flagship, the per-scale set and ``resnet_dgrn``
(ResNet + DGRN), then their joint training steps by the default route in
bf16 (the flagship at B=32, the other two at the CLI's B=4), each split
into forward, backward and optimizer as ``chip_smoke.py`` phase 9 splits
it, and one traced flagship joint step at B=32.

It uses only the helpers of ``chip_smoke.py`` beside it, so the same
script measures any checkout that has them: run it from the root of each
checkout in turn, in one call on one card (parent, change, change,
parent):

    python3 tools/e2e_ab.py [--no-steps] [--configs NAME ...] [--trace-steps]

``--configs`` takes a subset of the three; ``--trace-steps`` traces each
one's joint step at its batch (each port kernel's device time over all of
its passes) in place of the flagship's B=32 one. Prints the card's name
and power limit first. Imports the PyTorch port only.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

BATCH = 32
CONFIGS = ("flagship", "per_scale_set", "resnet_dgrn")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--no-steps", action="store_true",
                    help="the eval forwards only")
    ap.add_argument("--configs", nargs="+", choices=CONFIGS, default=CONFIGS,
                    help="the configurations to run (default: all three)")
    ap.add_argument("--trace-steps", action="store_true",
                    help="trace each configuration's joint step")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from frequency_wised_all_in_one_image_restoration_model_tpu_torch import (
        config)
    from frequency_wised_all_in_one_image_restoration_model_tpu_torch.data import (
        synthetic)
    from frequency_wised_all_in_one_image_restoration_model_tpu_torch.models import (
        airnet)
    from frequency_wised_all_in_one_image_restoration_model_tpu_torch.ops import (
        deform_conv as dc)
    from frequency_wised_all_in_one_image_restoration_model_tpu_torch.ops.kernels import (
        lewin_block as lb, window_attention as wa)
    from frequency_wised_all_in_one_image_restoration_model_tpu_torch.training import (
        state as train_state, steps as steps_lib)

    cs.COUNTERS.modules = (lb, wa, dc)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = cs.card_line()
    print(card, flush=True)
    fields_of = {"flagship": {},
                 "per_scale_set": cs.INJECTION_CONFIGS["per_scale_set"],
                 "resnet_dgrn": cs.FAMILIES["resnet_dgrn"]}
    x = torch.from_numpy(np.random.default_rng(2).random(
        (BATCH, cs.P, cs.P, 3), dtype=np.float32)).cuda()
    for name in args.configs:
        cfg = cs.flagship_config(config, "bfloat16", **fields_of[name])
        bundle = airnet.build_models(cfg, "cuda", "default")
        cs.liven(bundle)
        fwd = lambda: airnet.eval_forward(bundle, x)
        ms = [cs.time_ms(fwd, iters=5) for _ in range(2)]
        print(f"{name} eval forward bf16 B={BATCH} default route ({card}): "
              + " / ".join(f"{t:.3f}" for t in ms) + " ms, "
              + " / ".join(f"{BATCH * cs.P * cs.P / t / 1e3:.4f}" for t in ms)
              + " MP/s", flush=True)
        cs.profile_call(fwd, f"{name} eval forward (bf16, B={BATCH}; {card})",
                        top=12)
        del bundle, fwd
        torch.cuda.empty_cache()
    if args.no_steps:
        return 0
    batch_of = {"flagship": BATCH, "per_scale_set": cs.TRAIN_BATCH,
                "resnet_dgrn": cs.TRAIN_BATCH}
    for name in args.configs:
        cs.step_times(config, airnet, train_state, steps_lib, synthetic, card,
                      name, fields_of[name] or None,
                      (("bfloat16", "default", batch_of[name]),))
        if args.trace_steps:
            cs.profile_step(config, airnet, train_state, steps_lib, synthetic,
                            card, fields_of[name] or None, name, batch_of[name])
    if not args.trace_steps:
        cs.profile_step(config, airnet, train_state, steps_lib, synthetic, card,
                        None, "flagship", BATCH)
    return 0


if __name__ == "__main__":
    sys.exit(main())
