"""Where one launch of a backward kernel (K6, K7, K8, K10) or of K2 spends its
device time: every ``__global__`` pass of the launch by name, from
``torch.profiler``, at the flagship's res-128 shapes and the training batch;
with ``--k7``, K7 at the shapes of ``chip_smoke.py``'s K7 table (res 128,
C = 56 and res 16, C = 896); with ``--k6``, K6 at the shapes of its table
(the decoder block at res 128 and 8, the encoder's intra attention at res
128 and 8); with ``--k8``, K8 at the shapes of its table (the encoder's
inter attention at res 128, shifted and not, and res 8); with ``--k10``,
the window-attention backward K10 at ``chip_smoke.py`` phase 10's res-128
cases; with ``--k2``, the LeFF forward K2 (bf16) at every stage of its
table; with ``--k1``, the attention half K1 (bf16) at every stage of its
table (``chip_smoke.py::K1_STAGES``); with ``--k4``, the merged block K4
(bf16) at the res-32 stages the default route runs it (C = 224 and 448),
also the device clock at each of its phases' grid barriers; with ``--k3``,
the cross-band attention K3 (bf16) at every encoder stage
(``chip_smoke.py::K3_STAGES``), as ``freq_inter_path`` runs it, in its
four passes and fused where the form fits but the launch is too small for
the chooser; with ``--k11``, the DCN K11 (bf16) at
``chip_smoke.py::DCN_STAGES`` by both routes; with ``--f2``, the launches that hold the
LeFF's hidden in device memory (K2's passes, K4, K5, K13) at every stage
each serves.

Run on a machine with an NVIDIA GPU, from the root of the checkout:

    python3 tools/bwd_kernel_profile.py [--dtype bfloat16] [--batch 4]
        [--k7 | --k6 | --k8 | --k10 | --k2 | --k1 | --k4 | --k3 | --k11
         | --f2]

Prints the card's name and power limit, then per kernel the passes in order
of device time; for K1's, K2's and K3's passes and K11's column GEMM
also each product's rate. Imports
the PyTorch port only.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402


def k10_case(wa, c):
    """A phase-10 case of ``chip_smoke.py`` as a launch of K10."""
    from chip_smoke import BwdCase
    g = torch.randn(c.q.shape, device="cuda", generator=torch.Generator(
        device="cuda").manual_seed(4)).to(c.q.dtype)
    args = (c.q, c.k, c.v, c.bias, c.mask, g, c.scale, c.nW)
    return BwdCase("window_attn_bwd", f"{c.label} bwd",
                   lambda: wa.window_attention_bwd_kernel(*args),
                   lambda: wa.window_attention_bwd_plain(*args), 0.0, 0)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dtype", default="bfloat16", choices=["bfloat16", "float32"])
    ap.add_argument("--batch", type=int, default=4)
    which = ap.add_mutually_exclusive_group()
    which.add_argument("--k7", action="store_true",
                       help="K7 at the shapes of chip_smoke.py's K7 table")
    which.add_argument("--k6", action="store_true",
                       help="K6 at the shapes of chip_smoke.py's K6 table")
    which.add_argument("--k8", action="store_true",
                       help="K8 at the shapes of chip_smoke.py's K8 table")
    which.add_argument("--k2", action="store_true",
                       help="K2 (bf16) at the stages of chip_smoke.py's K2 table")
    which.add_argument("--k1", action="store_true",
                       help="K1 (bf16) at the stages of chip_smoke.py's K1 table")
    which.add_argument("--k4", action="store_true",
                       help="K4 (bf16) at res 32, C = 224 and 448, with its "
                       "phases' clock stamps")
    which.add_argument("--k10", action="store_true",
                       help="K10 at chip_smoke.py phase 10's res-128 cases")
    which.add_argument("--k3", action="store_true",
                       help="K3 (bf16) at every encoder stage of "
                       "chip_smoke.py's K3_STAGES")
    which.add_argument("--k11", action="store_true",
                       help="K11 (bf16) at chip_smoke.py's DCN_STAGES")
    which.add_argument("--f2", action="store_true",
                       help="the kernels that keep the LeFF's hidden in a "
                       "buffer (bf16): K2's passes, K4, K5 and K13 at every "
                       "stage each serves")
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
        lewin_block as lb, window_attention as wa)

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip())
    dtype = getattr(torch, args.dtype)
    if args.k7:
        cases = [c for c, _ in chip_smoke.k7_cases(lb, dtype, args.batch)]
    elif args.k6:
        cases = [c for c in chip_smoke.bwd_cases(lb, windows, dtype, args.batch)
                 if c.kernel == "lewin_attn_bwd"]
    elif args.k8:
        cases = chip_smoke.k8_cases(lb, windows, dtype, args.batch)
    elif args.k2:
        cases = [c for c, _ in chip_smoke.k2_cases(lb, args.batch)]
    elif args.k1:
        cases = [c for c, _ in chip_smoke.k1_cases(lb, windows, args.batch)]
    elif args.k4:
        cases = []
        for c, _ in chip_smoke.k4_cases(lb, windows, args.batch):
            chip_smoke.print_phases(lb, c, c.label)
            cases.append(chip_smoke.BwdCase(c.kernel, c.label, c.timed,
                                            lambda: None, c.flops, 0))
    elif args.k10:
        cases = [k10_case(wa, c) for c in chip_smoke.window_cases(
            windows, dtype, args.batch) if "res128" in c.label]
    elif args.k3:  # the launch by freq_inter_path, then the four passes,
        cases = []  # and the fused form where it fits but is not chosen
        for c, _, passes, fused in chip_smoke.k3_cases(lb, windows, args.batch):
            M, C, h, keys = c.dims
            cases += [c, passes]
            if lb.freq_inter_path(C, h, 8, torch.bfloat16) != lb.freq_inter_path(
                    C, h, 8, torch.bfloat16, 3, M // keys):
                cases.append(fused)
    elif args.f2:
        cases = f2_cases(chip_smoke, lb, windows, args.batch)
    elif args.k11:
        from frequency_wised_all_in_one_image_restoration_model_tpu_torch.ops import (
            deform_conv as dc)
        cases = chip_smoke.dcn_cases(dc, args.batch)
    else:
        cases = [c for c in chip_smoke.bwd_cases(lb, windows, dtype, args.batch)
                 if "res128" in c.label]
    for case in cases:
        case.run()
        ms = chip_smoke.time_ms(case.run, iters=5, warmup=1)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            case.run()
            torch.cuda.synchronize()
        by_name, total, gemms = {}, 0.0, []
        for e in prof.events():
            if e.device_type != DeviceType.CUDA:
                continue
            us = e.time_range.end - e.time_range.start
            n, t = by_name.get(e.name, (0, 0.0))
            by_name[e.name] = (n + 1, t + us)
            total += us
            if "gemm" in e.name:
                gemms.append((e.time_range.start, us, e.name))
        print(f"{case.label} {args.dtype} B={args.batch}: {ms:.4f} ms by CUDA "
              f"events, {total / 1e3:.4f} ms of device time in "
              f"{sum(n for n, _ in by_name.values())} passes")
        for name, (n, us) in sorted(by_name.items(), key=lambda kv: -kv[1][1]):
            print(f"  {us / 1e3:8.4f} ms x {n:2d}  {name[:100]}")
        print_products(case, sorted(gemms))
    return 0


def f2_cases(chip_smoke, lb, windows, batch):
    """The launches that hold the LeFF's hidden in device memory, bf16 on
    ``batch`` tiles: K2 where it runs its passes (C = 448 and 896), K4 at
    the shifted decoder stages of the F2 check, K5 at every
    encoder stage, K13 at the C = 896 stages."""
    from chip_smoke import BwdCase

    def as_case(c):
        return BwdCase(c.kernel, c.label, c.timed, lambda: None, c.flops, 0)
    cases = [c for c, _ in chip_smoke.k2_cases(lb, batch) if c.dims[1] >= 448]
    merged = set(chip_smoke.F2_MERGED)
    for c in chip_smoke.kernel_cases(lb, windows, torch.bfloat16, batch):
        if c.kernel == "freq_merged" or (
                c.kernel == "lewin_merged" and c.stage[2]
                and (c.stage[1], c.stage[3]) in merged):
            cases.append(as_case(c))
    cases += [as_case(c) for c in chip_smoke.split_cases(
        lb, windows, torch.bfloat16, batch) if c.kernel == "lewin_ffn_split"]
    return cases


def print_products(case, gemms) -> None:
    """The rate of each product of K1's or K2's passes (in launch order:
    qkv then proj, fc1 then fc2), from the shapes in ``case.dims``."""
    if case.kernel in ("lewin_attn", "freq_inter") and len(case.dims) == 4:
        M, C = case.dims[:2]
        shapes = (("qkv", M, 3 * C, C), ("proj", M, C, C))
    elif case.kernel == "dcn":
        M, C, cout = case.dims
        shapes = (("columns x weight", M, cout, 9 * C),)
    elif case.kernel == "lewin_ffn" and len(case.dims) == 2:
        M, C = case.dims
        shapes = (("fc1", M, 4 * C, C), ("fc2", M, C, 4 * C))
    else:
        return
    if len(gemms) != len(shapes):
        return
    for (label, m, n, k), (_, us, name) in zip(shapes, gemms):
        print(f"  product {label} [{m} x {k}] x [{k} x {n}]: {us / 1e3:.4f} ms, "
              f"{2.0 * m * n * k / us / 1e6:.1f} TFLOP/s ({name.split('(')[0]})")


if __name__ == "__main__":
    sys.exit(main())
