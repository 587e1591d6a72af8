"""Smoke run of the PyTorch / CUDA port on one NVIDIA H100.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, each fatal on failure:

1. the card: needs ``torch.cuda.is_available()``; prints the card's name
   and power limit;
2. build: compiles the five LeWin-block kernels from ``csrc/`` into
   ``build/kernels/``, one ``nvcc`` per source, all started together;
3. per-kernel check: every kernel's wrapper against its plain PyTorch twin
   on the card at the flagship shapes, in bf16 and fp32 (TF32 off), the
   merged kernels K4 / K5 also against the chain of kernels they equal;
   each kernel's time (operands prepared once, as the model holds them)
   beside the plain version's, the chain's, and its bound on this card;
   for K4 / K5 at res 128 and 16, where one launch spends its time (the
   device clock at each of its grid barriers);
4. full forward: the flagship eval forward (Uformer encoder with L=3 FFT
   bands and frequency-wise MSA, Uformer decoder with all_DC, 128x128
   patches, full width, random weights from a fixed seed) by the chain of
   kernels, by the merged kernels and by the default route, each against
   the plain path, with the launch counts; the merged forward holds no
   ``aten::roll``;
5. the main paths: the eval entry point ``<port>.test.main`` on two
   synthetic test sets, in float32 and in bfloat16 (its result lines, its
   log file, and PSNR / SSIM on the card against a CPU copy, launch counts
   equal to forwards x the default route's), then three synthetic images
   through ``restore_image`` by the chain, by the merged kernels and, in
   bfloat16, by the default route; the launch counts of these runs go
   into the kernels line;
6. timing: restored MP/s at 128x128, B=32, bf16: plain, chain, merged,
   default, default, merged, chain, plain in one process;
7. profile: where the device time of one default-route forward goes
   (``torch.profiler``), beside its time by CUDA events.

``--phases 3 4`` runs only those of phases 3-7, for work on one of them:
such a partial run prints neither of the two result lines and exits with
2. The whole run fails too if anything of JAX or of the JAX package was
imported. Its line before the last is ``{"kernels": [...]}``, where
``launches`` is the sum of ``launches_by_path`` (the entry point in
float32 and in bfloat16 on the default route, the requests by the chain
and by the merged kernels in float32 and by the default route in
bfloat16); the last line is
``{"ok": true, "device": {...}}``. Without a CUDA device the script exits
with 1 and prints no result.
"""

from __future__ import annotations

import argparse
import functools
import json
import math
import subprocess
import sys
import tempfile
import time
from typing import Callable, NamedTuple, Optional

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
    "lewin_merged": (f"{PKG}/csrc/lewin_merged.cu", f"{PALLAS}:1660"),
    "freq_merged": (f"{PKG}/csrc/freq_merged.cu", f"{PALLAS}:2126"),
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
# merged against the chain of kernels it equals: the same device functions
# in the same order, so fp32 holds to 1e-4 and bf16 to the kernels' limit
CHAIN_TOL = KERNEL_TOL
# the entry point's PSNR / SSIM on the card against a CPU copy
PSNR_TOL, SSIM_TOL = 1e-3, 1e-5
ZERO = {name: 0 for name in KERNELS}
CHAIN_COUNTS = {**ZERO, "lewin_attn": 54, "lewin_ffn": 54, "freq_inter": 10}
MERGED_COUNTS = {**ZERO, "lewin_merged": 44, "freq_merged": 10}
# the default route in bf16: blocks of one forward that run merged, by the
# tiles in its batch. The decoder's shifted blocks number 2 at res 128, 2 at
# res 64 and 8 at res 32, and a stage runs them merged from 32768 tokens
# (tiles x res^2) up. In float32 every block takes the chain
DEFAULT_MERGED_BLOCKS = {4: 2, 6: 2, 12: 4, 16: 4, 32: 12}


def default_counts(dtype: str, B: int) -> dict:
    """Launches of one default-route forward of ``B`` tiles, held apart from
    the model's own route table."""
    k4 = DEFAULT_MERGED_BLOCKS[B] if dtype == "bfloat16" else 0
    return {**ZERO, "lewin_attn": 54 - k4, "lewin_ffn": 54 - k4,
            "freq_inter": 10, "lewin_merged": k4}
P = 128
BATCH = 32
# tiles in one batch of the eval entry point on the synthetic test sets,
# and in a small last chunk of a tiled request
ENTRY_BATCH = 16
SMALL_BATCH = 4
# the card's published peaks (NVIDIA H100 SXM data sheet, dense): device
# memory bytes/s, and FLOP/s by the type of the products
PEAK_BYTES = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}


ALL_PHASES = frozenset((3, 4, 5, 6, 7))


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


class Case(NamedTuple):
    """One kernel at one shape: ``wrapper(*args)`` against ``plain(*args)``;
    ``timed()`` launches it with prepared operands; for a merged kernel,
    ``timed(stamps)`` also records its phases' end times, ``chain(*args)``
    is the chain of kernel wrappers it must equal and ``chain_timed()`` that
    chain with prepared operands."""
    kernel: str
    label: str
    args: list
    wrapper: Callable
    plain: Callable
    timed: Callable
    flops: float
    stage: Optional[tuple] = None          # (msa type, res, shift) of a block
    chain: Optional[Callable] = None
    chain_timed: Optional[Callable] = None


def case_bytes(case: Case) -> int:
    """Every tensor argument read once, the output (x's shape) written once."""
    tensors = [a for a in case.args if torch.is_tensor(a)]
    return (sum(t.numel() * t.element_size() for t in tensors)
            + tensors[0].numel() * tensors[0].element_size())


def bound_of(case: Case, dtype):
    """(least ms the card could take, which resource sets it)."""
    t_bytes = case_bytes(case) / PEAK_BYTES * 1e3
    t_flops = case.flops / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_flops), ("bytes" if t_bytes >= t_flops
                                   else "operations")


def kernel_cases(lb, windows, dtype, B):
    """The kernels at the flagship shapes. Decoder blocks (origin MSA,
    all_DC ``lam``): C = 56 * 2^s, h = 2^s at res 128 >> s; encoder blocks
    (L=3 bands folded into the batch): C = 28 * 2^s. K1-K3 at res 128, 32
    and 8; the merged K4 / K5 at all five stage resolutions, shift 0 and 4.
    The operations counted are the products' (qkv, logits, P V, proj, fc1,
    the 9 taps, fc2); LayerNorm, softmax and GELU are left out."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    dev = "cuda"
    L, n = 3, 64

    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale

    def attn_weights(C, h):
        d = C // h
        qkv = [rnd(h, C, d, scale=C ** -0.5) if i % 2 == 0 else
               rnd(h, d, scale=0.1) for i in range(6)]
        return qkv + [rnd(h, d, C, scale=C ** -0.5), rnd(C, scale=0.1)]

    def ffn_weights(C):
        Hd = 4 * C
        return [rnd(C, Hd, scale=C ** -0.5), rnd(Hd, scale=0.1),
                rnd(3, 3, Hd, scale=1 / 3), rnd(Hd, scale=0.1),
                rnd(Hd, C, scale=Hd ** -0.5), rnd(C, scale=0.1)]

    def ln(C):
        return [1 + rnd(C, scale=0.1), rnd(C, scale=0.1)]

    def mask_of(res, shift):
        if not shift:
            return None
        return torch.from_numpy(windows.shift_attn_mask(res, res, 8, shift)).to(dev)

    def dps_of(count):
        return (torch.rand(count, generator=gen, device=dev) < 0.9).float() / 0.9

    def attn_flops(M, C, keys):
        return 2.0 * M * C * (4 * C + 2 * keys)

    def ffn_flops(M, C):
        return 2.0 * M * 4 * C * (2 * C + 9)

    cases = []
    for s in range(5):
        res, C, h = 128 >> s, 56 << s, 1 << s
        M = B * res * res
        for shift in ((0, 4) if res > 8 else (0,)):
            x = rnd(B, res, res, C).to(dtype)
            ln1, ln2, aw, fw = ln(C), ln(C), attn_weights(C, h), ffn_weights(C)
            bias, mask, lam = rnd(h, n, n, scale=0.05), mask_of(res, shift), rnd(B, h, scale=0.3)
            dps1, dps2 = dps_of(B), dps_of(B)
            aop = lb.attn_operands(*aw, bias, dtype)
            fop = lb.ffn_operands(*fw, dtype)
            tag = f"res{res} C{C} h{h} shift{shift}"
            if res in (128, 32, 8):
                cases.append(Case(
                    "lewin_attn", f"block_attention {tag} lam",
                    [x, *ln1, *aw, bias, mask, lam, 8, 1e-6, dps1],
                    lb.block_attention, lb.block_attention_plain,
                    lambda x=x, ln1=ln1, aop=aop, mask=mask, lam=lam, dps1=dps1:
                    lb.attention_kernel(x, *ln1, aop, mask, lam, 8, 1e-6, True,
                                        1, dps1),
                    attn_flops(M, C, n)))
                if shift:  # the origin block without the all_DC gain
                    cases.append(Case(
                        "lewin_attn", f"block_attention {tag} no lam",
                        [x, *ln1, *aw, bias, mask, None, 8, 1e-6, None],
                        lb.block_attention, lb.block_attention_plain,
                        lambda x=x, ln1=ln1, aop=aop, mask=mask:
                        lb.attention_kernel(x, *ln1, aop, mask, None, 8, 1e-6,
                                            True, 1, None),
                        attn_flops(M, C, n)))
                else:
                    cases.append(Case(
                        "lewin_ffn", f"block_ffn res{res} C{C}",
                        [x, *ln2, *fw, 1e-6, dps2], lb.block_ffn,
                        lb.block_ffn_plain,
                        lambda x=x, ln2=ln2, fop=fop, dps2=dps2:
                        lb.ffn_kernel(x, *ln2, fop, 1e-6, dps2),
                        ffn_flops(M, C)))

            def chain_timed(x=x, ln1=ln1, ln2=ln2, aop=aop, fop=fop, mask=mask,
                            lam=lam, dps1=dps1, dps2=dps2, shift=shift):
                u = lb.attention_kernel(lb.roll(x, shift), *ln1, aop, mask, lam,
                                        8, 1e-6, True, 1, dps1)
                return lb.ffn_kernel(lb.roll(u, -shift), *ln2, fop, 1e-6, dps2)

            cases.append(Case(
                "lewin_merged", f"block_merged {tag} lam",
                [x, *ln1, *aw, bias, mask, lam, *ln2, *fw, 8, shift, 1e-6, dps1,
                 dps2],
                lb.block_merged, lb.block_merged_plain,
                lambda stamps=None, x=x, ln1=ln1, ln2=ln2, aop=aop, fop=fop,
                mask=mask, lam=lam, dps1=dps1, dps2=dps2, shift=shift:
                lb.merged_kernel(x, *ln1, aop, mask, lam, *ln2, fop, 8, shift,
                                 1e-6, dps1, dps2, stamps),
                attn_flops(M, C, n) + ffn_flops(M, C), ("origin", res, shift),
                functools.partial(lb.merged_chain, lb.block_attention,
                                  lb.block_ffn), chain_timed))

    for s in range(5):
        res, C, h = 128 >> s, 28 << s, 1 << s
        LB = L * B
        M = LB * res * res
        for shift in ((0, 4) if res > 8 else (0,)):
            x = rnd(LB, res, res, C).to(dtype)
            ln1, ln2, fw = ln(C), ln(C), ffn_weights(C)
            awA, awB = attn_weights(C, h), attn_weights(C, h)
            biasA = rnd(L, h, n, n, scale=0.05)
            biasB = rnd(h, L * n, L * n, scale=0.05)
            mask = mask_of(res, shift)
            dps1, dps2 = dps_of(LB), dps_of(LB)
            opA = lb.attn_operands(*awA, biasA, dtype)
            opB = lb.attn_operands(*awB, biasB, dtype)
            fop = lb.ffn_operands(*fw, dtype)
            tag = f"res{res} C{C} h{h} shift{shift} L{L}"
            if res in (128, 32, 8):
                cases.append(Case(
                    "lewin_attn", f"freq_intra {tag}",
                    [x, *ln1, *awA, biasA, mask, L, 8, 1e-6], lb.freq_intra,
                    lb.freq_intra_plain,
                    lambda x=x, ln1=ln1, opA=opA, mask=mask:
                    lb.attention_kernel(x, *ln1, opA, mask, None, 8, 1e-6,
                                        False, L, None),
                    attn_flops(M, C, n)))
                y = rnd(LB, res, res, C).to(dtype)
                cases.append(Case(
                    "freq_inter", f"freq_inter {tag}",
                    [y, x, *awB, biasB, mask, L, 8, 1e-6, dps1], lb.freq_inter,
                    lb.freq_inter_plain,
                    lambda y=y, x=x, opB=opB, mask=mask, dps1=dps1:
                    lb.freq_inter_kernel(y, x, opB, mask, L, 8, dps1),
                    attn_flops(M, C, L * n)))
                if shift == 0:
                    cases.append(Case(
                        "lewin_ffn", f"block_ffn res{res} C{C} (encoder)",
                        [x, *ln2, *fw, 1e-6, dps2], lb.block_ffn,
                        lb.block_ffn_plain,
                        lambda x=x, ln2=ln2, fop=fop, dps2=dps2:
                        lb.ffn_kernel(x, *ln2, fop, 1e-6, dps2),
                        ffn_flops(M, C)))

            def chain_timed(x=x, ln1=ln1, ln2=ln2, opA=opA, opB=opB, fop=fop,
                            mask=mask, dps1=dps1, dps2=dps2, shift=shift):
                img = lb.roll(x, shift)
                y1 = lb.attention_kernel(img, *ln1, opA, mask, None, 8, 1e-6,
                                         False, L, None)
                u = lb.freq_inter_kernel(y1, img, opB, mask, L, 8, dps1)
                return lb.ffn_kernel(lb.roll(u, -shift), *ln2, fop, 1e-6, dps2)

            cases.append(Case(
                "freq_merged", f"block_freq_merged {tag}",
                [x, *ln1, *awA, biasA, *awB, biasB, mask, *ln2, *fw, L, 8, shift,
                 1e-6, dps1, dps2],
                lb.block_freq_merged, lb.block_freq_merged_plain,
                lambda stamps=None, x=x, ln1=ln1, ln2=ln2, opA=opA, opB=opB,
                fop=fop, mask=mask, dps1=dps1, dps2=dps2, shift=shift:
                lb.freq_merged_kernel(x, *ln1, opA, opB, mask, *ln2, fop, L, 8,
                                      shift, 1e-6, dps1, dps2, stamps),
                attn_flops(M, C, n) + attn_flops(M, C, L * n) + ffn_flops(M, C),
                ("freq", res, shift),
                functools.partial(lb.freq_merged_chain, lb.freq_intra,
                                  lb.freq_inter, lb.block_ffn), chain_timed))
    return cases


def print_phases(lb, case: Case, label: str):
    """Where one launch of a merged kernel spends its time: the device
    clock at each phase's closing grid barrier (the barrier's wait is in the
    phase it closes)."""
    names = (lb.FREQ_MERGED_PHASES if case.kernel == "freq_merged"
             else lb.MERGED_PHASES)
    stamps = torch.zeros(lb.MERGED_STAMPS, dtype=torch.int64, device="cuda")
    case.timed(stamps)
    torch.cuda.synchronize()
    t = stamps.tolist()
    if any(b < a for a, b in zip(t[:len(names)], t[1:len(names) + 1])):
        raise Failed(f"{label}: phase clock stamps {t} do not rise")
    total = (t[len(names)] - t[0]) / 1e6
    print(f"    phases of one launch, {total:.4f} ms: " + ", ".join(
        f"{name} {(b - a) / 1e6:.4f}" for name, a, b in zip(names, t, t[1:])),
        flush=True)


def check_kernels(lb, windows, default_merged, min_tokens, stats, card: str):
    """Phase 3: each kernel against its plain twin (and K4 / K5 against the
    chain); times with prepared operands. The kernels line takes each
    kernel's first (res-128) case in bf16 at B=32. The merged-against-chain
    table covers both dtypes at the batches the entry points run and marks
    the blocks that ``default_merged`` and ``min_tokens`` (the model's route
    table) run merged."""
    ab = {}
    for dtype, B in ((torch.bfloat16, BATCH), (torch.float32, 4)):
        name_dt = str(dtype)[6:]
        print(f"kernel checks, {dtype}, B={B}:", flush=True)
        for case in kernel_cases(lb, windows, dtype, B):
            label = f"{case.label} {name_dt} B{B}"
            got = case.wrapper(*case.args)
            torch.cuda.synchronize()
            want = case.plain(*case.args)
            err = compare(label, got, want, KERNEL_TOL[dtype])
            st = stats[case.kernel]
            st["max_abs_err"] = max(st["max_abs_err"], err)
            if not torch.equal(case.timed(), got):
                raise Failed(f"{label}: prepared operands give another result")
            ms = time_ms(case.timed)
            pms = time_ms(lambda: case.plain(*case.args))
            bound, by = bound_of(case, dtype)
            line = (f"    time: kernel {ms:.4f} ms, plain {pms:.4f} ms, bound "
                    f"{bound:.4f} ms by {by}")
            if case.chain is not None:
                compare(f"{label} vs chain", got, case.chain(*case.args),
                        CHAIN_TOL[dtype])
                cms = time_ms(case.chain_timed)
                ab[(*case.stage, name_dt, B)] = (ms, cms)
                line += f", chain of kernels {cms:.4f} ms"
            print(line, flush=True)
            if case.stage is not None and case.stage[1] in (128, 16):
                print_phases(lb, case, label)
            if dtype == torch.bfloat16 and st["ms"] is None:
                st.update(ms=ms, plain_ms=pms, bound_ms=bound, bound_by=by)
            del got, want
    # the other batches the entry points run (the pooled batch of the eval
    # entry point, a small last chunk), in both dtypes: times only
    for dtype, B in ((torch.bfloat16, ENTRY_BATCH), (torch.bfloat16, SMALL_BATCH),
                     (torch.float32, ENTRY_BATCH)):
        for case in kernel_cases(lb, windows, dtype, B):
            if case.chain is not None:
                ab[(*case.stage, str(dtype)[6:], B)] = (
                    time_ms(case.timed), time_ms(case.chain_timed))
    print(f"merged against chain, ms per block ({card}):", flush=True)
    for (msa, res, shift, name_dt, B), (ms, cms) in sorted(ab.items()):
        key = (msa, res, shift > 0, getattr(torch, name_dt))
        default = key in default_merged and B * res * res >= min_tokens
        print(f"  {msa:6s} res {res:3d} shift {shift} {name_dt} B={B}: merged "
              f"{ms:.4f}, chain {cms:.4f}, merged/chain {ms / cms:.3f}"
              + ("  [default: merged]" if default else ""), flush=True)


def flagship_config(config, dtype: str, **overrides):
    return config.make_config(
        encoder_type="Uformer", decoder_type="Uformer", L=3,
        encoder_msa_type="freq", degradation_embedding_method=["all_DC"],
        patch_size=P, eval_dtype=dtype, seed=0, **overrides)


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


def route_counts(bundle, airnet, uformer_lewin, B: int) -> dict:
    """The launches one forward of ``bundle`` on ``B`` tiles makes, from its
    blocks' routes (only origin blocks look at the batch)."""
    counts = dict(ZERO)
    dtype = airnet.model_dtype(bundle.cfg)
    for net in (bundle.encoder, bundle.decoder):
        for m in net.modules():
            if not isinstance(m, uformer_lewin.LeWinBlock):
                continue
            freq = m.msa_type == "freq"
            route = m.route(dtype, B)
            if route == "merged":
                counts["freq_merged" if freq else "lewin_merged"] += 1
            elif route == "kernel":
                counts["lewin_attn"] += 1
                counts["lewin_ffn"] += 1
                counts["freq_inter"] += freq
    return counts


def count_rolls(fn) -> int:
    """``aten::roll`` events in a traced call of ``fn``."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as trace

    with trace(activities=[ProfilerActivity.CPU]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(1 for e in prof.events() if e.name == "aten::roll")


def full_forward(bundles, airnet, lb, uformer_lewin, frequency):
    """Phase 4: the flagship eval forward by each route against plain. The
    encoder's FFT band split shifts its spectrum with fftshift, which is a
    roll; every other roll of a forward is a block's SW-MSA shift, and the
    merged route has none."""
    for dtype, B in (("bfloat16", BATCH), ("float32", 4)):
        print(f"full forward {dtype} B={B}:", flush=True)
        x = torch.from_numpy(np.random.default_rng(0).random(
            (B, P, P, 3), dtype=np.float32)).cuda()
        fft_rolls = count_rolls(lambda: frequency.frequency_decompose_1(
            x.permute(0, 3, 1, 2), 2))
        want = airnet.eval_forward(bundles.get(dtype, "plain"), x)
        for impl, fixed in (("kernel", CHAIN_COUNTS), ("merged", MERGED_COUNTS),
                            ("default", default_counts(dtype, B))):
            bundle = bundles.get(dtype, impl)
            lb.reset_launches()
            got = airnet.eval_forward(bundle, x)
            torch.cuda.synchronize()
            counts = dict(lb.LAUNCHES)
            print(f"  {impl}: launches per forward {counts}", flush=True)
            expect = route_counts(bundle, airnet, uformer_lewin, B)
            if counts != fixed or expect != fixed:
                raise Failed(f"{impl}: launch counts {counts}, the blocks' "
                             f"routes give {expect}, expected {fixed}")
            if got.shape != (B, P, P, 3):
                raise Failed(f"forward shape {tuple(got.shape)}")
            compare(f"eval_forward {dtype} B{B} {impl} vs plain", got, want,
                    FORWARD_TOL[getattr(torch, dtype)])
            if impl != "default":
                rolls = count_rolls(
                    lambda: airnet.eval_forward(bundle, x)) - fft_rolls
                print(f"  {impl}: aten::roll events in a forward: {rolls} "
                      f"from the blocks, {fft_rolls} from the FFT band split",
                      flush=True)
                if (impl == "merged") != (rolls == 0):
                    raise Failed(f"{impl}: {rolls} aten::roll events from "
                                 "the blocks")
            del got
        del want


def add_launches(stats, path: str, counts):
    """One main path's launches (counted from 0 just before it to just after
    it) into the kernels line: per path, and their sum."""
    for name in stats:
        stats[name]["launches_by_path"][path] = counts[name]
        stats[name]["launches"] += counts[name]


def eval_entry_point(config, airnet, runner, metrics, port_test, lb,
                     uformer_lewin, stats, dtype: str):
    """Phase 5a, the main path: ``<port>.test.main`` on the card at flagship
    width and depth, synthetic test sets, weights from the seed, the default
    route; ``--eval_dtype`` left at its default (float32) or set to
    bfloat16, where the default route runs 4 blocks of a 16-tile forward
    merged."""
    tasks = ["denoising_bsd68_25", "deraining"]
    flags = [] if dtype == "float32" else ["--eval_dtype", dtype]
    with tempfile.TemporaryDirectory() as out:
        cfg = config.parse_args(
            ["--synthetic_data", "--degradation_embedding_method", "all_DC",
             "--test_de_type", *tasks, "--output_path", out + "/",
             "--epochs", "1", *flags])
        if cfg.eval_dtype != dtype:
            raise Failed(f"eval_dtype {cfg.eval_dtype!r}, wanted {dtype!r}")
        torch.cuda.synchronize()
        lb.reset_launches()
        t0 = time.perf_counter()
        rows = port_test.main(cfg)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = dict(lb.LAUNCHES)
        with open(f"{out}/epoch_1_results.log") as f:
            log = f.read()
    print(f"eval entry point ({dtype}): {len(tasks)} tasks in {secs:.3f} s, "
          f"launches {counts}", flush=True)
    want_log = "".join(f"{t}: {' ' * (25 - len(t))}{r}\n" for t, r in rows)
    if [t for t, _ in rows] != tasks or log != want_log:
        raise Failed(f"results log {log!r} != {want_log!r}")
    # the same images once more, through the runner's parts: the launches
    # of main, and its metrics against a CPU copy of the restored images
    bundle = airnet.build_models(cfg, "cuda")
    per_forward = route_counts(bundle, airnet, uformer_lewin, ENTRY_BATCH)
    fixed = default_counts(dtype, ENTRY_BATCH)
    forwards = 0
    for task, result in rows:
        items = list(runner.build_test_dataset(cfg, task))
        tiles = sum(len(runner.tiling.tile_offsets(d.shape[0], P))
                    * len(runner.tiling.tile_offsets(d.shape[1], P))
                    for _, d, _ in items)
        if tiles != ENTRY_BATCH:        # one pool of 4 same-sized images
            raise Failed(f"{task}: {tiles} tiles, not {ENTRY_BATCH}")
        forwards += 1
        psnr, ssim = metrics.AverageMeter(), metrics.AverageMeter()
        for name, restored, clean in runner.restored_images(cfg, bundle, items):
            p, s = runner.psnr_ssim(restored, clean)
            pc, sc = runner.psnr_ssim(restored.cpu(), clean)
            if not (math.isfinite(p) and math.isfinite(s)):
                raise Failed(f"{name}: PSNR {p} SSIM {s}")
            if abs(p - pc) > PSNR_TOL or abs(s - sc) > SSIM_TOL:
                raise Failed(f"{name}: card {p:.5f}/{s:.6f} != CPU "
                             f"{pc:.5f}/{sc:.6f}")
            psnr.update(p)
            ssim.update(s)
        again = "PSNR/SSIM: %.2f/%.4f" % (psnr.avg, ssim.avg)
        print(f"  {task}: {result} ({len(items)} images; card against CPU "
              f"copy within {PSNR_TOL} dB / {SSIM_TOL})", flush=True)
        if again != result:
            raise Failed(f"{task}: main logged {result!r}, the runner's parts "
                         f"give {again!r}")
    want = {k: v * forwards for k, v in fixed.items()}
    if counts != want or per_forward != fixed:
        raise Failed(f"entry point launch counts {counts} != {want} "
                     f"({forwards} forwards; the blocks' routes give "
                     f"{per_forward} per forward)")
    add_launches(stats, f"entry_{dtype}", counts)


def requests(bundles, tiling, lb, stats):
    """Phase 5b: three synthetic images restored through restore_image: in
    the default eval dtype (float32) by the chain and by the merged kernels,
    which agree; and in bfloat16 by the default route, where the share of
    merged blocks follows each image's tiles, against the chain in bf16
    (that comparison's launches are not counted)."""
    rng = np.random.default_rng(1)
    shapes = ((321, 481), (256, 256), (200, 328))
    imgs = [rng.random((h, w, 3), dtype=np.float32) for h, w in shapes]
    # every image is one forward: restore_image runs tiles in chunks of 32
    tiles = [len(tiling.tile_offsets(h, P)) * len(tiling.tile_offsets(w, P))
             for h, w in shapes]
    if max(tiles) > 32:
        raise Failed(f"request tiles {tiles}: more than one chunk")

    def total(per_forward):
        return {k: sum(c[k] for c in per_forward) for k in ZERO}

    paths = (
        ("float32", "kernel", total([CHAIN_COUNTS] * len(tiles))),
        ("float32", "merged", total([MERGED_COUNTS] * len(tiles))),
        ("bfloat16", "default",
         total([default_counts("bfloat16", t) for t in tiles])),
    )
    outs = {}
    for dtype, impl, want in paths:
        bundle = bundles.get(dtype, impl)
        torch.cuda.synchronize()
        lb.reset_launches()
        t0 = time.perf_counter()
        outs[dtype, impl] = [tiling.restore_image(bundle, img) for img in imgs]
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = dict(lb.LAUNCHES)
        print(f"requests ({dtype}, {impl}): {len(imgs)} images in {secs:.3f} "
              f"s, forwards of {tiles} tiles, launches {counts}", flush=True)
        for (h, w), out in zip(shapes, outs[dtype, impl]):
            if tuple(out.shape) != (h, w, 3) or not torch.isfinite(out).all():
                raise Failed(f"request {h}x{w}: shape {tuple(out.shape)} or "
                             "non-finite output")
        if counts != want:
            raise Failed(f"request launch counts {counts} != {want}")
        add_launches(stats, f"requests_{dtype}_{impl}", counts)
    bundle = bundles.get("bfloat16", "kernel")
    outs["bfloat16", "kernel"] = [tiling.restore_image(bundle, img)
                                  for img in imgs]
    for dtype, impl in (("float32", "merged"), ("bfloat16", "default")):
        for (h, w), a, b in zip(shapes, outs[dtype, impl],
                                outs[dtype, "kernel"]):
            compare(f"request {h}x{w} {dtype} {impl} vs chain", a, b,
                    FORWARD_TOL[getattr(torch, dtype)])


def throughput(bundles, airnet, card: str):
    """Phase 6: restored MP/s at 128x128, every route twice in one process
    on one card: bf16 at B=32 (the metric of record), then float32 at the
    entry point's batch."""
    order = ("plain", "kernel", "merged", "default")
    for dtype, B in (("bfloat16", BATCH), ("float32", ENTRY_BATCH)):
        x = torch.from_numpy(np.random.default_rng(2).random(
            (B, P, P, 3), dtype=np.float32)).cuda()
        runs = {impl: [] for impl in order}
        for impl in order + order[::-1]:
            bundle = bundles.get(dtype, impl)
            ms = time_ms(lambda: airnet.eval_forward(bundle, x), iters=5)
            runs[impl].append(B * P * P / (ms / 1e3) / 1e6)
        for impl, mps in runs.items():
            print(f"throughput {impl}: {mps[0]:.4f} / {mps[1]:.4f} MP/s "
                  f"(128x128, B={B}, {dtype}; {card})", flush=True)


def profile(bundles, airnet, card: str, top: int = 15):
    """Phase 7: the device time of one bf16 B=32 default-route forward under
    ``torch.profiler``, by kernel name, and its busy time (the union of its
    device intervals) beside the untraced forward's time by CUDA events,
    in one process."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as trace

    bundle = bundles.get("bfloat16", "default")
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Smoke run of the port on one H100")
    ap.add_argument("--phases", type=int, nargs="+",
                    default=sorted(ALL_PHASES), choices=sorted(ALL_PHASES),
                    help="of phases 3-7, run only these: a development aid "
                    "that prints no result and exits with 2 (default: all)")
    phases = set(ap.parse_args(argv).phases)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on "
              "an NVIDIA GPU", file=sys.stderr)
        return 1
    from frequency_wised_all_in_one_image_restoration_model_tpu_torch import (
        config, test as port_test)
    from frequency_wised_all_in_one_image_restoration_model_tpu_torch.evaluation import (
        runner, tiling)
    from frequency_wised_all_in_one_image_restoration_model_tpu_torch.models import (
        airnet, uformer_lewin)
    from frequency_wised_all_in_one_image_restoration_model_tpu_torch.ops import (
        frequency, metrics, windows)
    from frequency_wised_all_in_one_image_restoration_model_tpu_torch.ops.kernels import (
        build, lewin_block as lb)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(card, flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)

    _, secs, log = build.build()
    regs = [ln.strip() for ln in log.splitlines()
            if "registers" in ln or "spill" in ln]
    print(f"build: {secs:.1f} s, source hash {build.source_hash()} "
          f"({len(regs)} ptxas lines)", flush=True)
    for ln in regs:
        print(f"  {ln}")
    build.load()

    stats = {name: {"max_abs_err": 0.0, "ms": None, "plain_ms": None,
                    "bound_ms": None, "bound_by": None, "launches": 0,
                    "launches_by_path": {}}
             for name in KERNELS}
    t0 = time.perf_counter()
    try:
        bundles = Bundles(config, airnet)
        if 3 in phases:
            check_kernels(lb, windows, uformer_lewin.DEFAULT_MERGED,
                          uformer_lewin.MERGED_MIN_TOKENS, stats, card)
        if 4 in phases:
            full_forward(bundles, airnet, lb, uformer_lewin, frequency)
        if 5 in phases:
            for dtype in ("float32", "bfloat16"):
                eval_entry_point(config, airnet, runner, metrics, port_test,
                                 lb, uformer_lewin, stats, dtype)
            requests(bundles, tiling, lb, stats)
        if 6 in phases:
            throughput(bundles, airnet, card)
        if 7 in phases:
            profile(bundles, airnet, card)
        if 5 in phases:
            idle = [n for n in KERNELS if not stats[n]["launches"]]
            if idle:
                raise Failed(f"no main path launched {idle}")
            # what the default route names must come from the entry point,
            # not from a request with a forced route
            idle = [n for n in KERNELS
                    if default_counts("bfloat16", ENTRY_BATCH)[n]
                    and not any(v for path, v in
                                stats[n]["launches_by_path"].items()
                                if path.startswith("entry_"))]
            if idle:
                raise Failed(f"the eval entry point never launched {idle}")
        jax_mods = sorted(m for m in sys.modules
                          if m.split(".")[0] in JAX_ROOTS)
        if jax_mods:
            raise Failed(f"JAX modules imported: {jax_mods[:5]}")
    except Failed as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr, flush=True)
        return 1
    print(f"phases {sorted(phases)} took {time.perf_counter() - t0:.1f} s",
          flush=True)
    if phases != ALL_PHASES:
        print(f"chip_smoke: partial run of phases {sorted(phases)}: not the "
              "check, no result printed", file=sys.stderr, flush=True)
        return 2

    print(card, flush=True)
    # no single PyTorch call computes any of these fused blocks
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         **stats[name], "library_ms": None}
        for name, (src, rep) in KERNELS.items()]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
