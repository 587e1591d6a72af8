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
each serves; with ``--k14``, the DCN backward K14 at the cases of
``chip_smoke.py::dcn_bwd_cases`` (``DCN_BWD_SHAPES`` and the convergent
offsets, B=4); with ``--k9``, the window attention K9 at every case of
``chip_smoke.py::window_cases`` (each of ``WINDOW_SHAPES`` at res 128,
shifted and not, and res 8), at B=32 and B=4, on contiguous q / k / v and
the tables tiled to the window, which every K9 takes (``--strided``: the
views and the untiled tables the unfused blocks hand it).

Run on a machine with an NVIDIA GPU, from the root of the checkout:

    python3 tools/bwd_kernel_profile.py [--dtype bfloat16] [--batch 4]
        [--k7 | --k6 | --k8 | --k10 | --k2 | --k1 | --k4 | --k3 | --k11
         | --f2 | --k14 | --k9 [--strided] | --k12 | --k13 | --k5]

Prints the card's name and power limit, then per kernel its ms by CUDA
events, its device time, the host's time to issue a call, and the passes in
order of device time; for K1's, K2's and K3's passes and K11's column GEMM
also each product's rate. Imports
the PyTorch port only.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

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


def k9_case(wa, c, attn_bound):
    """A phase-10 case of ``chip_smoke.py`` as a launch of K9, its bound in
    the label."""
    from chip_smoke import BwdCase
    args = (c.q, c.k, c.v, c.bias, c.mask, c.scale, c.nW)
    bound, by = attn_bound(c, c.q.dtype, False)
    return BwdCase("window_attn", f"{c.label} B{c.q.shape[0] // c.nW} (bound "
                   f"{bound:.4f} ms by {by})",
                   lambda: wa.window_attention_kernel(*args), lambda: None,
                   0.0, 0)


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
    which.add_argument("--k14", action="store_true",
                       help="K14 at chip_smoke.py's dcn_bwd_cases (B=4)")
    which.add_argument("--k9", action="store_true",
                       help="K9 at every case of chip_smoke.py's window_cases, "
                       "B=32 and B=4")
    ap.add_argument("--strided", action="store_true",
                    help="with --k9: the operands as the unfused blocks hand "
                    "them to K9")
    which.add_argument("--f2", action="store_true",
                       help="the kernels that keep the LeFF's hidden in a "
                       "buffer (bf16): K2's passes, K4, K5 and K13 at every "
                       "stage each serves")
    which.add_argument("--k12", action="store_true",
                       help="K12 at chip_smoke.py's split_cases, fp32 and "
                       "bf16, B = 4 and 16")
    which.add_argument("--k13", action="store_true",
                       help="K13 at chip_smoke.py's split_cases, fp32 and "
                       "bf16, B = 4 and 16")
    which.add_argument("--k5", action="store_true",
                       help="K5 at every encoder stage, shift 0 and 4, B = 4, "
                       "16 and 32, bf16 and float32, beside the chain")
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
    if args.k5:
        k5_profile(chip_smoke, lb, windows)
        return 0
    if args.k12 or args.k13:
        split_profile(chip_smoke, lb, windows, "lewin_attn_split" if args.k12
                      else "lewin_ffn_split",
                      (4, 16) if args.batch == 4 else (args.batch,))
        return 0
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
    elif args.k14:
        from frequency_wised_all_in_one_image_restoration_model_tpu_torch.ops import (
            deform_conv as dc)
        cases = chip_smoke.dcn_bwd_cases(dc, dtype, args.batch)
    elif args.k9:
        cases = [k9_case(wa, c, chip_smoke.attn_bound) for B in (32, 4)
                 for c in chip_smoke.window_cases(windows, dtype, B,
                                                  strided=args.strided)]
    else:
        cases = [c for c in chip_smoke.bwd_cases(lb, windows, dtype, args.batch)
                 if "res128" in c.label]
    for case in cases:
        batch = "" if args.k9 else f" B={args.batch}"
        gemms = profile_case(case, f"{case.label} {args.dtype}{batch}")
        print_products(case, sorted(gemms))
    return 0


def host_ms(fn, iters: int = 20) -> float:
    """The host's time to issue one call of ``fn`` (its launches, buffers
    and argument set-up), by the host clock over ``iters`` calls issued
    back to back with the card idle at the start: where this is above the
    call's device time, the card waits on the host."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / iters * 1e3


def profile_case(case, label):
    """Time ``case.run`` by CUDA events and by the host clock
    (:func:`host_ms`), then trace one launch and print its passes by device
    time and the rate of ``case.flops`` over them; returns the passes whose
    name holds ``gemm`` or ``splitk`` as (start, us, name)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke

    case.run()
    ms = chip_smoke.time_ms(case.run, iters=5, warmup=1)
    host = host_ms(case.run)
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
        if "gemm" in e.name or "splitk" in e.name:
            gemms.append((e.time_range.start, us, e.name))
    print(f"{label}: {ms:.4f} ms by CUDA events, {total / 1e3:.4f} ms of "
          f"device time in {sum(n for n, _ in by_name.values())} passes, "
          f"{host:.4f} ms a call to issue on the host")
    for name, (n, us) in sorted(by_name.items(), key=lambda kv: -kv[1][1]):
        print(f"  {us / 1e3:8.4f} ms x {n:2d}  {name[:100]}")
    if total:   # the profiler can come back without device events
        print(f"  the launch's operations over its device time: "
              f"{case.flops / total / 1e6:.1f} TFLOP/s")
    return gemms


def split_products(kernel, M, C):
    """(label, m, n, k) of the products of one K12 or K13 launch."""
    if kernel == "lewin_attn_split":
        return (("qkv", M, 3 * C, C), ("proj", M, C, C))
    return (("fc1", M, 4 * C, C), ("fc2", M, C, 4 * C))


def split_profile(chip_smoke, lb, windows, kernel, batches) -> None:
    """K12 or K13 at every case of ``chip_smoke.split_cases`` in float32
    and bfloat16 at ``batches``: the passes by device time, the bound, a
    ``torch.matmul`` yardstick of the launch's products on their shapes
    (same dtype, TF32 off) and each product's rate, where a pass is one
    product, else the rate of the launch's operations over its passes."""
    from chip_smoke import BwdCase

    torch.backends.cuda.matmul.allow_tf32 = False
    for dtype in (torch.float32, torch.bfloat16):
        name_dt = str(dtype)[6:]
        for B in batches:
            for c in chip_smoke.split_cases(lb, windows, dtype, B):
                if c.kernel != kernel:
                    continue
                x = c.args[0]
                M, C = x.numel() // x.shape[-1], x.shape[-1]
                shapes = split_products(kernel, M, C)
                ops = [(torch.randn(m, k, device="cuda").to(dtype),
                        torch.randn(k, n, device="cuda").to(dtype))
                       for _, m, n, k in shapes]
                yard = [chip_smoke.time_ms(lambda a=a, b=b: torch.matmul(a, b),
                                           iters=20, warmup=3)
                        for a, b in ops]
                bound, by = chip_smoke.bound_of(c, dtype)
                label = f"{c.label} {name_dt} B={B}"
                gemms = profile_case(BwdCase(c.kernel, label, c.timed,
                                             lambda: None, c.flops, 0), label)
                print(f"  bound {bound:.4f} ms by {by}; yardstick "
                      f"torch.matmul {sum(yard):.4f} ms (" + ", ".join(
                          f"{lab} {ms:.4f}" for (lab, *_), ms in
                          zip(shapes, yard)) + ")")
                gemms.sort()
                if len(gemms) == len(shapes):
                    for (lab, m, n, k), (_, us, name) in zip(shapes, gemms):
                        print(f"  product {lab} [{m} x {k}] x [{k} x {n}]: "
                              f"{us / 1e3:.4f} ms, "
                              f"{2.0 * m * n * k / us / 1e6:.1f} TFLOP/s "
                              f"({name.split('(')[0]})")
                del ops


def k5_profile(chip_smoke, lb, windows) -> None:
    """K5 at every case of ``chip_smoke.kernel_cases`` in bfloat16 and float32
    at B = 4, 16 and 32: the launch by ``freq_merged_path`` (ms by CUDA
    events, device time, its passes) and, where that is the band-group
    form, the parent's phases form beside it; each form's phases' clock
    stamps; the chain K1 -> K3 -> K2 around the two rolls as one (ms by
    CUDA events) and each of its five launches timed apart, and the
    bound."""
    from chip_smoke import BwdCase

    for dtype in (torch.bfloat16, torch.float32):
        name_dt = str(dtype)[6:]
        for B in (4, 16, 32):
            for case in chip_smoke.kernel_cases(lb, windows, dtype, B):
                if case.kernel != "freq_merged":
                    continue
                x, h = case.args[0], case.args[3].shape[0]
                paths = [lb.freq_merged_path(x.shape[-1], h, 8, dtype)]
                if paths == ["group"]:
                    paths.append("phases")
                for path in paths:
                    label = f"{case.label} B{B} {name_dt} ({path})"
                    profile_case(BwdCase(
                        case.kernel, label,
                        lambda path=path: case.timed(path=path), lambda: None,
                        case.flops, 0), label)
                    chip_smoke.print_phases(lb, case, label, path)
                times = [(name, chip_smoke.time_ms(fn))
                         for name, fn in chip_smoke.k5_parts(lb, case, dtype)]
                bound, by = chip_smoke.bound_of(case, dtype)
                print(f"  chain {chip_smoke.time_ms(case.chain_timed):.4f} ms "
                      f"by CUDA events (" + ", ".join(
                          f"{name} {ms:.4f}" for name, ms in times)
                      + f"; parts {sum(ms for _, ms in times):.4f}); bound "
                      f"{bound:.4f} ms by {by}", flush=True)
            torch.cuda.empty_cache()


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
