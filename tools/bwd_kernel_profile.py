"""Where one launch of a backward block kernel (K6, K7, K8) spends its device
time: every ``__global__`` pass of the launch by name, from ``torch.profiler``,
at the flagship's res-128 shapes and the training batch; with ``--k7``, K7
at the shapes of ``chip_smoke.py``'s K7 table (res 128, C = 56 and res 16,
C = 896).

Run on a machine with an NVIDIA GPU, from the root of the checkout:

    python3 tools/bwd_kernel_profile.py [--dtype bfloat16] [--batch 4] [--k7]

Prints the card's name and power limit, then per kernel the passes in order
of device time. Imports the PyTorch port only.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dtype", default="bfloat16", choices=["bfloat16", "float32"])
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--k7", action="store_true",
                    help="K7 at the shapes of chip_smoke.py's K7 table")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke
    from frequency_wised_all_in_one_image_restoration_model_tpu_torch.ops import (
        windows)
    from frequency_wised_all_in_one_image_restoration_model_tpu_torch.ops.kernels import (
        lewin_block as lb)

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip())
    dtype = getattr(torch, args.dtype)
    if args.k7:
        cases = [c for c, _ in chip_smoke.k7_cases(lb, dtype, args.batch)]
    else:
        cases = [c for c in chip_smoke.bwd_cases(lb, windows, dtype, args.batch)
                 if "res128" in c.label]
    for case in cases:
        case.run()
        ms = chip_smoke.time_ms(case.run, iters=5, warmup=1)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            case.run()
            torch.cuda.synchronize()
        by_name, total = {}, 0.0
        for e in prof.events():
            if e.device_type != DeviceType.CUDA:
                continue
            us = e.time_range.end - e.time_range.start
            n, t = by_name.get(e.name, (0, 0.0))
            by_name[e.name] = (n + 1, t + us)
            total += us
        print(f"{case.label} {args.dtype} B={args.batch}: {ms:.4f} ms by CUDA "
              f"events, {total / 1e3:.4f} ms of device time in "
              f"{sum(n for n, _ in by_name.values())} passes")
        for name, (n, us) in sorted(by_name.items(), key=lambda kv: -kv[1][1]):
            print(f"  {us / 1e3:8.4f} ms x {n:2d}  {name[:100]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
