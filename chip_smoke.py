"""Smoke run of the PyTorch / CUDA port on one NVIDIA H100.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, each fatal on failure:

1. the card: needs ``torch.cuda.is_available()``; prints the card's name
   and power limit;
2. build: compiles the LeWin-block kernels from ``csrc/`` into
   ``build/kernels/``;
3. per-kernel check: every kernel against its plain PyTorch twin on the
   card at the flagship shapes, in bf16 and fp32 (TF32 off), with its time
   beside the plain version's;
4. full forward: the flagship eval forward (Uformer encoder with L=3 FFT
   bands and frequency-wise MSA, Uformer decoder with all_DC, 128x128
   patches, full width, random weights from a fixed seed) through the
   kernels against the plain path, with the kernels' launch counts;
5. requests: three synthetic images restored through ``restore_image``,
   the main path; its launch counts go into the kernels line;
6. timing: restored MP/s at 128x128, B=32, bf16, kernels against plain;
7. profile: where the device time of one such forward goes
   (``torch.profiler``), beside its time by CUDA events.

It fails too if anything of JAX or of the JAX package was imported. The
line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``. Without a CUDA device the script exits
with 1 and prints no result.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

PKG = "frequency_wised_all_in_one_image_restoration_model_tpu_torch"
JAX_ROOTS = ("jax", "jaxlib", "flax",
             "frequency_wised_all_in_one_image_restoration_model_tpu")
PALLAS = "frequency_wised_all_in_one_image_restoration_model_tpu/ops/pallas/lewin_block.py"
KERNELS = {  # counter name -> (source, the Pallas kernel it replaces)
    "lewin_attn": (f"{PKG}/csrc/lewin_attn.cu", f"{PALLAS}:119"),
    "lewin_ffn": (f"{PKG}/csrc/lewin_ffn.cu", f"{PALLAS}:805"),
    "freq_inter": (f"{PKG}/csrc/freq_inter.cu", f"{PALLAS}:1283"),
}
# per-kernel tolerance on max|kernel - plain| / max(1, max|plain|): fp32
# differs only in summation order; bf16 rounds q/k/v, the hidden and the
# output at other places than the plain path (a few bf16 ulps)
KERNEL_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# whole forward, on the same measure (outputs are O(1)). On an H100, sound
# kernels read 3.8e-7 (fp32) and 3.5e-3 (bf16); with the SW-MSA mask
# dropped from the bf16 attention core at the res-32 stages only, the bf16
# forward reads 1.2e-2. The per-kernel cases at res 32 catch that fault,
# and a dropped bias that the forward cannot see, on their own
FORWARD_TOL = {torch.float32: 1e-3, torch.bfloat16: 1e-2}
FLAGSHIP_COUNTS = {"lewin_attn": 54, "lewin_ffn": 54, "freq_inter": 10}
P = 128
BATCH = 32


class Failed(Exception):
    pass


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def compare(name: str, got: torch.Tensor, want: torch.Tensor,
            tol: float) -> float:
    got, want = got.float(), want.float()
    if got.shape != want.shape:
        raise Failed(f"{name}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    if not torch.isfinite(got).all():
        raise Failed(f"{name}: non-finite kernel output")
    err = (got - want).abs().max().item()
    ref = want.abs().max().item()
    rel = err / max(1.0, ref)
    verdict = "ok" if rel <= tol else "FAIL"
    print(f"  {name}: max_abs {err:.3e} max|ref| {ref:.3e} "
          f"err/max(1,|ref|) {rel:.3e} tol {tol:.0e} {verdict}", flush=True)
    if rel > tol:
        raise Failed(f"{name}: error {rel:.3e} over tolerance {tol:.0e}")
    return err


def kernel_cases(lb, windows, dtype, B):
    """(kernel name, label, kernel call, plain call) at the flagship shapes:
    decoder res 128 C=56 h=1, res 32 C=224 h=4 and res 8 C=896 h=16;
    encoder (L=3 bands folded into the batch) res 128 C=28 h=1, res 32
    C=112 h=4 and res 8 C=448 h=16."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    dev = "cuda"

    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale

    def attn_weights(C, h):
        d = C // h
        qkv = [rnd(h, C, d, scale=C ** -0.5) if i % 2 == 0 else
               rnd(h, d, scale=0.1) for i in range(6)]
        return qkv + [rnd(h, d, C, scale=C ** -0.5), rnd(C, scale=0.1)]

    def mask_of(res, shift):
        if not shift:
            return None
        return torch.from_numpy(windows.shift_attn_mask(res, res, 8, shift)).to(dev)

    def dps_of(n):
        return (torch.rand(n, generator=gen, device=dev) < 0.9).float() / 0.9

    L, n = 3, 64
    cases = []
    for res, C, h, shifts in ((128, 56, 1, (0, 4)), (32, 224, 4, (0, 4)),
                              (8, 896, 16, (0,))):
        for shift in shifts:
            x = rnd(B, res, res, C).to(dtype)
            ln = [1 + rnd(C, scale=0.1), rnd(C, scale=0.1)]
            weights = [*attn_weights(C, h), rnd(h, n, n, scale=0.05)]
            args = [x, *ln, *weights, mask_of(res, shift),
                    rnd(B, h, scale=0.3), 8, 1e-6, dps_of(B)]
            cases.append(("lewin_attn", f"block_attention res{res} C{C} h{h} "
                          f"shift{shift} lam", args, lb.block_attention,
                          lb.block_attention_plain))
            if shift:  # the origin block without the all_DC gain
                args = [x, *ln, *weights, mask_of(res, shift), None, 8, 1e-6,
                        None]
                cases.append(("lewin_attn", f"block_attention res{res} C{C} "
                              f"h{h} shift{shift} no lam", args,
                              lb.block_attention, lb.block_attention_plain))
            Hd = 4 * C
            fargs = [x, *ln, rnd(C, Hd, scale=C ** -0.5), rnd(Hd, scale=0.1),
                     rnd(3, 3, Hd, scale=1 / 3), rnd(Hd, scale=0.1),
                     rnd(Hd, C, scale=Hd ** -0.5), rnd(C, scale=0.1), 1e-6,
                     dps_of(B)]
            if shift == 0:
                cases.append(("lewin_ffn", f"block_ffn res{res} C{C}", fargs,
                              lb.block_ffn, lb.block_ffn_plain))
    for res, C, h, shifts in ((128, 28, 1, (0, 4)), (32, 112, 4, (0, 4)),
                              (8, 448, 16, (0,))):
        for shift in shifts:
            x = rnd(L * B, res, res, C).to(dtype)
            ln = [1 + rnd(C, scale=0.1), rnd(C, scale=0.1)]
            mask = mask_of(res, shift)
            iargs = [x, *ln, *attn_weights(C, h), rnd(L, h, n, n, scale=0.05),
                     mask, L, 8, 1e-6]
            cases.append(("lewin_attn", f"freq_intra res{res} C{C} h{h} "
                          f"shift{shift} L{L}", iargs, lb.freq_intra,
                          lb.freq_intra_plain))
            eargs = [rnd(L * B, res, res, C).to(dtype), x, *attn_weights(C, h),
                     rnd(h, L * n, L * n, scale=0.05), mask, L, 8, 1e-6,
                     dps_of(L * B)]
            cases.append(("freq_inter", f"freq_inter res{res} C{C} h{h} "
                          f"shift{shift} L{L}", eargs, lb.freq_inter,
                          lb.freq_inter_plain))
            Hd = 4 * C
            fargs = [x, *ln, rnd(C, Hd, scale=C ** -0.5), rnd(Hd, scale=0.1),
                     rnd(3, 3, Hd, scale=1 / 3), rnd(Hd, scale=0.1),
                     rnd(Hd, C, scale=Hd ** -0.5), rnd(C, scale=0.1), 1e-6,
                     dps_of(L * B)]
            if shift == 0:
                cases.append(("lewin_ffn", f"block_ffn res{res} C{C} (encoder)",
                              fargs, lb.block_ffn, lb.block_ffn_plain))
    return cases


def check_kernels(lb, windows, stats):
    """Phase 3: each kernel against its plain twin; times at bf16 B=32."""
    for dtype, B in ((torch.bfloat16, BATCH), (torch.float32, 4)):
        print(f"kernel checks, {dtype}, B={B}:", flush=True)
        for name, label, args, kern, plain in kernel_cases(lb, windows, dtype, B):
            got = kern(*args)
            torch.cuda.synchronize()
            want = plain(*args)
            err = compare(f"{label} {str(dtype)[6:]} B{B}", got, want,
                          KERNEL_TOL[dtype])
            st = stats[name]
            st["max_abs_err"] = max(st["max_abs_err"], err)
            ms = time_ms(lambda: kern(*args))
            pms = time_ms(lambda: plain(*args))
            print(f"    time: kernel {ms:.4f} ms, plain {pms:.4f} ms", flush=True)
            # the line's time: the first (res-128) case of each kernel in bf16
            if dtype == torch.bfloat16 and st["ms"] is None:
                st["ms"], st["plain_ms"] = ms, pms
            del got, want


def flagship_config(config, dtype: str):
    return config.make_config(
        encoder_type="Uformer", decoder_type="Uformer", L=3,
        encoder_msa_type="freq", degradation_embedding_method=["all_DC"],
        patch_size=P, eval_dtype=dtype, seed=0)


class Bundles:
    """The flagship models, built once per (eval dtype, impl) from seed 0."""

    def __init__(self, config, airnet):
        self.config, self.airnet, self.cache = config, airnet, {}

    def get(self, dtype: str, impl: str):
        if (dtype, impl) not in self.cache:
            t0 = time.perf_counter()
            cfg = flagship_config(self.config, dtype)
            self.cache[dtype, impl] = self.airnet.build_models(cfg, "cuda", impl)
            print(f"  built {dtype} {impl} models in "
                  f"{time.perf_counter() - t0:.1f} s", flush=True)
        return self.cache[dtype, impl]


def full_forward(bundles, airnet, lb):
    """Phase 4: the flagship eval forward, kernels against plain."""
    for dtype, B in (("bfloat16", BATCH), ("float32", 4)):
        print(f"full forward {dtype} B={B}:", flush=True)
        kb, pb = bundles.get(dtype, "kernel"), bundles.get(dtype, "plain")
        x = torch.from_numpy(np.random.default_rng(0).random(
            (B, P, P, 3), dtype=np.float32)).cuda()
        lb.reset_launches()
        got = airnet.eval_forward(kb, x)
        torch.cuda.synchronize()
        counts = dict(lb.LAUNCHES)
        print(f"  launches per forward: {counts}", flush=True)
        if counts != FLAGSHIP_COUNTS:
            raise Failed(f"launch counts {counts} != {FLAGSHIP_COUNTS}")
        want = airnet.eval_forward(pb, x)
        if got.shape != (B, P, P, 3):
            raise Failed(f"forward shape {tuple(got.shape)}")
        compare(f"eval_forward {dtype} B{B} kernel vs plain", got, want,
                FORWARD_TOL[getattr(torch, dtype)])
        del got, want


def requests(bundles, tiling, lb, stats):
    """Phase 5, the main path: three synthetic images restored through
    restore_image with the default eval dtype (float32)."""
    bundle = bundles.get("float32", "kernel")
    rng = np.random.default_rng(1)
    shapes = ((321, 481), (256, 256), (200, 328))
    imgs = [rng.random((h, w, 3), dtype=np.float32) for h, w in shapes]
    torch.cuda.synchronize()
    lb.reset_launches()
    t0 = time.perf_counter()
    outs = [tiling.restore_image(bundle, img) for img in imgs]
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = dict(lb.LAUNCHES)
    # restore_image runs the tiles in chunks of 32
    forwards = sum(math.ceil(len(tiling.tile_offsets(h, P))
                             * len(tiling.tile_offsets(w, P)) / 32)
                   for h, w in shapes)
    print(f"requests: {len(imgs)} images in {secs:.3f} s, {forwards} forwards, "
          f"launches {counts}", flush=True)
    for (h, w), out in zip(shapes, outs):
        if tuple(out.shape) != (h, w, 3) or not torch.isfinite(out).all():
            raise Failed(f"request {h}x{w}: shape {tuple(out.shape)} or "
                         "non-finite output")
    want = {k: v * forwards for k, v in FLAGSHIP_COUNTS.items()}
    if counts != want:
        raise Failed(f"request launch counts {counts} != {want}")
    for name in stats:
        stats[name]["launches"] = counts[name]


def throughput(bundles, airnet, card: str):
    """Phase 6: restored MP/s at 128x128, B=32, bf16; plain, kernel,
    kernel, plain in one process on one card."""
    x = torch.from_numpy(np.random.default_rng(2).random(
        (BATCH, P, P, 3), dtype=np.float32)).cuda()
    runs = {"plain": [], "kernel": []}
    for impl in ("plain", "kernel", "kernel", "plain"):
        bundle = bundles.get("bfloat16", impl)
        ms = time_ms(lambda: airnet.eval_forward(bundle, x), iters=5)
        runs[impl].append(BATCH * P * P / (ms / 1e3) / 1e6)
    for impl, mps in runs.items():
        print(f"throughput {impl}: {mps[0]:.4f} / {mps[1]:.4f} MP/s "
              f"(128x128, B={BATCH}, bf16; {card})", flush=True)


def profile(bundles, airnet, card: str, top: int = 15):
    """Phase 7: the device time of one bf16 B=32 kernel forward under
    ``torch.profiler``, by kernel name, and its busy time (the union of its
    device intervals) beside the untraced forward's time by CUDA events,
    in one process."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as trace

    bundle = bundles.get("bfloat16", "kernel")
    x = torch.from_numpy(np.random.default_rng(2).random(
        (BATCH, P, P, 3), dtype=np.float32)).cuda()
    fwd = time_ms(lambda: airnet.eval_forward(bundle, x), iters=5)
    with trace(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        airnet.eval_forward(bundle, x)
        torch.cuda.synchronize()
    spans, by_name = [], {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        t0, t1 = e.time_range.start, e.time_range.end   # microseconds
        spans.append((t0, t1))
        n, us = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, us + t1 - t0)
    print(f"profile (bf16, B={BATCH}; {card}): forward {fwd:.2f} ms by "
          "CUDA events, untraced", flush=True)
    if not spans:
        print("  the trace holds no device events: busy time not measured")
        return
    spans.sort()
    busy, end = 0.0, spans[0][0]
    for t0, t1 in spans:
        if t1 > end:
            busy += t1 - max(t0, end)
            end = t1
    span = end - spans[0][0]
    print(f"  traced: {len(spans)} device events, span {span / 1e3:.2f} ms, "
          f"busy {busy / 1e3:.2f} ms (idle {1 - busy / span:.3f} of the "
          f"traced span, {1 - busy / 1e3 / fwd:.3f} of the untraced forward)")
    for name, (n, us) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:top]:
        print(f"  {us / 1e3:9.3f} ms x {n:4d}  {name[:110]}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on "
              "an NVIDIA GPU", file=sys.stderr)
        return 1
    from frequency_wised_all_in_one_image_restoration_model_tpu_torch import config
    from frequency_wised_all_in_one_image_restoration_model_tpu_torch.evaluation import tiling
    from frequency_wised_all_in_one_image_restoration_model_tpu_torch.models import airnet
    from frequency_wised_all_in_one_image_restoration_model_tpu_torch.ops import windows
    from frequency_wised_all_in_one_image_restoration_model_tpu_torch.ops.kernels import (
        build, lewin_block as lb)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(card, flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)

    _, secs, log = build.build()
    regs = [ln.strip() for ln in log.splitlines() if "registers" in ln]
    print(f"build: {secs:.1f} s, source hash {build.source_hash()} "
          f"({len(regs)} kernel entries)", flush=True)
    for ln in regs:
        print(f"  {ln}")
    build.load()

    stats = {name: {"max_abs_err": 0.0, "ms": None, "plain_ms": None,
                    "launches": 0} for name in KERNELS}
    try:
        check_kernels(lb, windows, stats)
        bundles = Bundles(config, airnet)
        full_forward(bundles, airnet, lb)
        requests(bundles, tiling, lb, stats)
        throughput(bundles, airnet, card)
        profile(bundles, airnet, card)
        jax_mods = sorted(m for m in sys.modules
                          if m.split(".")[0] in JAX_ROOTS)
        if jax_mods:
            raise Failed(f"JAX modules imported: {jax_mods[:5]}")
    except Failed as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr, flush=True)
        return 1

    print(card, flush=True)
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": stats[name]["launches"],
         "max_abs_err": stats[name]["max_abs_err"], "ms": stats[name]["ms"],
         "plain_ms": stats[name]["plain_ms"]}
        for name, (src, rep) in KERNELS.items()]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
