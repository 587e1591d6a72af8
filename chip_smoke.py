"""Smoke run of the PyTorch / CUDA port on one NVIDIA H100.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, each fatal on failure:

1. the card: needs ``torch.cuda.is_available()``; prints the card's name
   and power limit;
2. build: compiles the fourteen kernels (the ten LeWin-block kernels, seven
   forward and three backward, the window attention forward and backward,
   the DCN and its backward) from ``csrc/`` into ``build/kernels/``, one
   ``nvcc`` per source, all started together; counts the HGMMA (wgmma)
   instructions in the library's SASS and fails on none;
3. per-kernel check: every kernel's wrapper against its plain PyTorch twin
   on the card at the flagship shapes, in bf16 and fp32 (TF32 off), the
   merged kernels K4 / K5 also against the chain of kernels they equal;
   each kernel's time (operands prepared once, as the model holds them)
   beside the plain version's, the chain's, and its bound on this card;
   K4 at every decoder stage, the up path included (the merged-against-
   chain A/B the route table is set from); for K4 / K5 at res 128, 32 and
   16, where one launch spends its time (the device clock at each of its
   grid barriers); K5 at res 128 / 64 / 32 in bf16 by both forms (the band
   groups the route takes, equal to the chain bit for bit at B = 4, 16 and
   32, and the twelve phases equal to them bit for bit; each form's time
   and phases);
   then K2's table: bf16 at B = 4 and 32 at every flagship
   stage K2 serves, against its twin, its time beside the plain version's,
   the bound, a ``torch.matmul`` yardstick of fc1 and fc2, and the device
   memory one launch takes beyond its output; K1's table likewise at every
   stage K1 serves (``K1_STAGES``, yardstick: qkv, logits, P V, proj); K4's
   at res 32, C = 224 and 448, also against its chain, with its phases;
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
   (``torch.profiler``), beside its time by CUDA events;
8. backward kernels: K6 (attention / intra), K7 (FFN) and K8 (inter)
   against their plain twins at flagship stage shapes and the training
   batch, in bf16 and fp32, every output compared (``dx`` and each weight
   gradient), two launches of a case giving equal bits, with times and
   bounds (bf16 also at B=32); then each autograd Function's gradients
   against ``torch.autograd.grad`` of the forward twin; then K7's table:
   bf16 / fp32 x B = 4 / 32 x res 128 (C = 56) / res 16 (C = 896), against
   its twin, beside a yardstick of ``torch.matmul`` over its five
   products' shapes; then K6's table, the same at the shapes of K6's
   cases (decoder res 128 / 8, encoder intra res 128 / 8) beside
   ``torch.matmul`` over its eleven products' shapes; then K8's table, the
   same at the encoder's inter attention (res 128 shifted and not, res 8),
   with the bytes of workspace K8 asks for;
9. training, the main path of the training slice: the entry point
   ``<port>.train.main`` on the synthetic loader at full width, B=4,
   bfloat16 (two phase-A steps, two joint steps, the end-of-epoch eval, the
   checkpoints; losses finite, the queue pointer advanced, the key encoder
   moved, ``train.log`` / ``results.log`` in the reference's format, launch
   counts held against fixed numbers); one joint step by the default route
   against the plain route from the same state (loss and every gradient,
   fp32 and bf16); the step time and its forward / backward / optimizer
   split by CUDA events; one traced joint step at B=32 (bf16, default
   route), with each kernel's device time over all of its passes;
10. the kernels of the decoder's injection methods: the window attention
    K9 and its backward K10 against their plain versions at the main
    path's three window shapes ((n, nk, d) = (64, 64, 56), (64, 192, 56),
    (192, 192, 28)) at res 128, shifted and not, and at res 8, in bf16
    (B=32 and B=4) and fp32 (B=4); K9 on the strided views and the one
    window's tables the unfused blocks hand it, with its launches in a
    per-scale-set forward x (time - bound); K10 on the joined operands,
    every output, equal bits on a second launch; beside
    ``scaled_dot_product_attention`` with the same additive bias and mask
    (K10 over the library's backward printed for each case);
    ``WindowAttentionFn`` against autograd of the plain forward; the DCN
    K11 against ``dcn_plain`` at every deform_conv stage (C = 112 ... 896)
    and at DGRN's (C = 64, 3), exact and with offsets clamped to 2, offsets
    past the image's edges;
    ``DCNFn``'s gradients;
11. the full-width eval forward of three injection configurations (the
    per-scale set ``residual modulator self_modulator deform_conv
    attention_kv`` with the learnable modulator; ``attention_residual
    all_DC``; ``all_3_bands`` with the learnable DC ``lamb``), offset heads
    and ``lamb`` drawn at random, bf16 at B=32 and fp32 at B=4, default
    route against plain route, launch counts held against fixed numbers,
    MP/s of both routes, and a ``torch.profiler`` breakdown of the
    per-scale set;
12. the main paths of this slice: the eval entry point with no method flag
    (the CLI's default, ``residual``); the training entry point on the
    per-scale set (one phase-A step, one joint step, one eval, the
    checkpoints, launch counts held); one joint step of the per-scale set
    by the default route against the plain route, fp32 and bf16; its step
    time, split, and peak memory;
13. the split block kernels: K12 (attention, q / k / v as three [C, C]
    blocks, the projection's reduction in fp32 partials) and K13 (FFN, a sum
    over hidden blocks) against their plain versions and against K1 / K2 at
    the flagship decoder's C = 896 stages (res 8 and 16, shifted and not,
    with lam and DropPath), fp32 and bf16, B = 1, 4, 8 (res 16), 16 and 32, a
    second launch giving equal bits, the shifted K12 also on the true
    layout with the roll folded in, beside K1 / K2's time, the plain
    version's and the bound; the per-block table split against chain at
    64 ... 8192 tokens; then the float32 flagship eval forward at B = 4,
    16 and 32 by the split, chain, default and plain routes, each against
    plain, launch counts and MP/s;
14. the other model families: the eval entry point and the training entry
    point (one phase-A step, one joint step, one eval, the checkpoints) for
    ``resnet_dgrn`` (``--encoder_type ResNet --decoder_type ResNet``) and
    ``vit_freq`` (``--encoder_type ViT --decoder_type ResNet
    --frequency_decompose_type DC``) at full width, offset heads and ``lamb``
    drawn at random; the eval forward of those two, of ResNet + Uformer and
    of the origin-MSA L = 1 Uformer encoder + Uformer decoder by the default
    and the plain route (K11 launches of DGRN, 50 per forward, held); the
    joint step of the DGRN families by both routes (1 x 2 DGRN blocks), and
    its time at full depth by the default route; first, K14 (the DCN's
    backward) against ``dcn_bwd_plain`` at DGRN's and the deform LeFF's
    shapes and with every sample of an image sent to one pixel, bf16 and
    fp32, every output, equal bits on a second launch, with times, bounds
    and launches a ``resnet_dgrn`` step x (time - bound);
15. reproducible steps: three joint steps of the flagship, of the per-scale
    set (a ``deform_conv`` user) and of ``resnet_dgrn`` (bf16, B=4, full
    width and depth, the default route) twice from one saved state on a
    fresh generator of the same seed; every loss and every tensor of the
    train state after them (parameters, buffers, key encoder, queue, Adam's
    moments) equal bit for bit;
16. serving: the eval forward exported (``<port>.serving.export_eval``,
    one ``torch.export`` program whose forward kernels are ``fairm::``
    custom ops, the weights its inputs) for the flagship at full width and
    depth in bf16 at B=32 and in fp32 at B=4, the per-scale set and
    ``resnet_dgrn`` at full width in bf16 at B=4 (their depth cut); each
    artifact loaded in a clean process that imports no model code, its
    ``fairm::`` nodes and the launches of one served call equal to the
    eager forward's, the served output against the eager one (1e-4 fp32,
    1e-2 bf16; a short batch padded and cropped), export s, artifact MiB,
    load s, served and eager ms, and a trace of the first served call;
17. analysis, the flagship at full width and depth in float32 at B=4 (the
    eval CLI's dtype, the loader's batch), weights from seed 0, the default
    route against the plain route: (a) ``collect_embeddings`` over two
    batches and ``latent_band_histogram`` over two images (1e-3 of
    ``max(1, max|plain|)``); (b) under a capture (``models/capture.py``),
    ``model_attention_band_report`` of encoder and decoder and
    ``embed_lamb_responses`` on one image: one map per attention layer,
    each band energy finite and summing to 1, the captured output against
    the default eval output (1e-3), no kernel launched by a captured
    forward, each ``embed_lamb_1`` equal bit for bit to the fused route's
    gain; (c) LFS: the gradients over two batches through the eval forward
    (the blocks' autograd Functions, K6 / K7 / K8 backward), the Taylor
    scores and the masks: the loss (1e-4), every gradient on the fp32 joint
    step's measure (1e-2), the masks except within 1e-3 of the threshold;
    (d) the LeWin leftovers: a stage of two blocks at res 128 C=56 and res 8
    C=896 with ``token_projection='conv'``, ``token_mlp='ffn'`` and
    ``'mlp'``, and a ``LeFF(use_eca=True)``, bf16 B=32 and fp32 B=4,
    forward and every gradient (K9 forward, K10 backward, both launched);
    (e) ``main(cfg)`` of the CLIs that only print (``plot_MSA_frequency``,
    ``plot_embed_lamb_curve``, ``plot_lamb_curve``,
    ``plot_LFS_distribution``) with the flagship's flags and synthetic data,
    the full-width models built once for the four;
18. multi-GPU, in a process of its own (``--distributed-child``) so that no
    process group outlives it: the training entry point as in phase 9
    (two phase-A steps, two joint steps, the eval, the checkpoints) without
    a group, then as rank 0 of a world-1 NCCL group (the real
    ``init_process_group``; the step's collectives on CUDA tensors: the
    global BatchNorm statistics, the gradient all-reduce, the key gather;
    the eval's tile gather; the rank-0 checkpoints), every loss, log line,
    checkpoint name and train-state tensor equal bit for bit and the
    launches equal; the eval entry point through the group, its lines equal
    to phase 5's float32 lines and its launches to phase 5's; the joint
    step's time without and with the group and the gradient all-reduce's,
    by CUDA events; with two cards or more, two NCCL ranks (four with four
    cards; ``--mesh_task N``) against world 1 on the same global batch,
    their loss lines within phase 9's bf16 step bound; then the ``model``
    axis (mesh ``(1, 1, 2)``): the flagship at full width, one block a
    stage, bf16, B=4, two steps (A, then joint) with its parameters and
    Adam moments column-sharded by JAX's rule (``mesh.shard_params``,
    ``min_dim`` 128) on two ranks (phase 18's process and one started
    with it, whose start and reference overlap phase 18's other work; gloo
    over CUDA tensors on ``cuda:0`` with one card, NCCL a rank a card with
    two), each against the same two steps without a group: 0 train-state
    tensors differing (full size, the moments gathered), losses and
    launches equal, each rank's Adam moment elements and bytes against the
    replicated run's, the model-group gather's ms by CUDA events. The
    script fixes ``PYTHONHASHSEED`` (re-executing itself) so that both
    processes seed the synthetic test sets alike.

``--phases 3 4`` runs only those of phases 3-18, for work on one of them:
such a partial run prints neither of the two result lines and exits with
2. The whole run fails too if anything of JAX or of the JAX package was
imported. Its line before the last is ``{"kernels": [...]}``, where
``launches`` is the sum of ``launches_by_path`` (the entry point in
float32 and in bfloat16 on the default route, the requests by the chain
and by the merged kernels in float32 and by the default route in
bfloat16, the training entry point in bfloat16; phase 11's forwards, the
eval entry point with the default method, the per-scale training entry
point; phase 13's split and default forwards, phase 14's entry points and
forwards, phase 16's served calls, phase 17's analysis paths, phase 18's
training and eval entry points through the group and rank 0's model-axis
steps); the last
line is
``{"ok": true, "device": {...}}``. Without a CUDA device the script exits
with 1 and prints no result.
"""

from __future__ import annotations

import argparse
import bisect
import contextlib
import copy
import dataclasses
import functools
import itertools
import json
import math
import os
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
PALLAS_BWD = PALLAS.replace("lewin_block.py", "lewin_block_bwd.py")
KERNELS = {  # counter name -> (source, the Pallas kernel it replaces)
    "lewin_attn": (f"{PKG}/csrc/lewin_attn.cu", f"{PALLAS}:119"),
    "lewin_ffn": (f"{PKG}/csrc/lewin_ffn.cu", f"{PALLAS}:805"),
    "freq_inter": (f"{PKG}/csrc/freq_inter.cu", f"{PALLAS}:1283"),
    "lewin_merged": (f"{PKG}/csrc/lewin_merged.cu", f"{PALLAS}:1660"),
    "freq_merged": (f"{PKG}/csrc/freq_merged.cu", f"{PALLAS}:2126"),
    "lewin_attn_bwd": (f"{PKG}/csrc/lewin_attn_bwd.cu", f"{PALLAS_BWD}:121"),
    "lewin_ffn_bwd": (f"{PKG}/csrc/lewin_ffn_bwd.cu", f"{PALLAS_BWD}:480"),
    "freq_inter_bwd": (f"{PKG}/csrc/freq_inter_bwd.cu", f"{PALLAS_BWD}:676"),
}
PALLAS_WA = PALLAS.replace("lewin_block.py", "window_attention.py")
PALLAS_DCN = PALLAS.replace("lewin_block.py", "dcn.py")
KERNELS.update({  # the kernels of the decoder's injection methods
    "window_attn": (f"{PKG}/csrc/window_attn.cu", f"{PALLAS_WA}:44"),
    "window_attn_bwd": (f"{PKG}/csrc/window_attn_bwd.cu", f"{PALLAS_WA}:183"),
    "dcn": (f"{PKG}/csrc/dcn.cu", f"{PALLAS_DCN}:62"),
})
KERNELS.update({  # the split block kernels (q / k / v blocks, hidden blocks)
    "lewin_attn_split": (f"{PKG}/csrc/lewin_attn_split.cu", f"{PALLAS}:214"),
    "lewin_ffn_split": (f"{PKG}/csrc/lewin_ffn_split.cu", f"{PALLAS}:882"),
})
# K14, the DCN's backward: the JAX package has no Pallas DCN backward (its
# backward is jax.vjp of the gather composite); it replaces the backward of
# the kernel K11 ports
KERNELS["dcn_bwd"] = (f"{PKG}/csrc/dcn_bwd.cu", f"{PALLAS_DCN}:62")
BWD_KERNELS = ("lewin_attn_bwd", "lewin_ffn_bwd", "freq_inter_bwd")
INJECTION_KERNELS = ("window_attn", "window_attn_bwd", "dcn", "dcn_bwd")
SPLIT_KERNELS = ("lewin_attn_split", "lewin_ffn_split")
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
# backward kernels against their twins, on the same measure per output: the
# weight gradients are sums over up to 196608 rows, in fp32 in another
# order; in bf16 the recomputed qkv / hidden values round an ulp apart
BWD_TOL = {torch.float32: 2e-4, torch.bfloat16: 3e-2}
# a Function's gradients (forward kernel + backward kernel) against autograd
# of the forward twin, which in bf16 rounds every gradient to bf16 on its way
FUNCTION_TOL = {torch.float32: 5e-4, torch.bfloat16: 6e-2}
# one joint training step, default route against plain route from one state:
# |loss difference|, and per parameter max|g - g_plain| over
# max(max|g_plain|, 1e-3 of the largest gradient of the step)
STEP_LOSS_TOL = {"float32": 1e-4, "bfloat16": 3e-2}
STEP_GRAD_TOL = {"float32": 1e-2, "bfloat16": 0.5}
ZERO = {name: 0 for name in KERNELS}
CHAIN_COUNTS = {**ZERO, "lewin_attn": 54, "lewin_ffn": 54, "freq_inter": 10}
MERGED_COUNTS = {**ZERO, "lewin_merged": 44, "freq_merged": 10}
# the split route: every decoder block K12 -> K13, the encoder's frequency
# blocks the chain
SPLIT_COUNTS = {**ZERO, "lewin_attn": 10, "lewin_ffn": 10, "freq_inter": 10,
                "lewin_attn_split": 44, "lewin_ffn_split": 44}
# the default route runs the split kernels for the decoder's C = 896 blocks,
# held apart from the model's own table (DEFAULT_SPLIT): (res, dtype, fused
# blocks of the stage, least tokens of a batch); res 8 holds bottleneck_0
# and bottleneck_1, res 16 decoderlayer_3
DEFAULT_SPLIT_STAGES = ((8, "float32", 4, 64), (16, "float32", 8, 256),
                        (16, "bfloat16", 8, 4096))


def runs_split(res: int, dtype: str, tokens: int) -> bool:
    """Whether the default route runs a C = 896 block at ``res`` in
    ``dtype`` on a batch of ``tokens`` (tiles x res^2) through K12 -> K13."""
    return any(r == res and dt == dtype and tokens >= least
               for r, dt, _, least in DEFAULT_SPLIT_STAGES)


def split_blocks(B: int, dtype: str, blocks=None) -> int:
    """Decoder blocks of a default-route forward of ``B`` tiles in ``dtype``
    that run K12 -> K13 (``blocks``: res -> fused blocks counted, by default
    the stages' own)."""
    return sum((blocks or {}).get(res, n)
               for res, dt, n, least in DEFAULT_SPLIT_STAGES
               if dt == dtype and B * res * res >= least
               and (blocks is None or res in blocks))


# the default route in bf16, held apart from the model's own table
# (DEFAULT_MERGED): (res, C, shifted blocks, least tokens of a batch, path)
# of the decoder stages whose shifted blocks run merged from that many tokens
# (tiles x res^2) up; "down" is the way down (fused in every configuration),
# "up" the up path (fused in the flagship only). In float32 every block
# takes the chain
DEFAULT_MERGED_STAGES = ((32, 224, 4, 4096, "down"), (32, 448, 4, 16384, "up"),
                         (64, 224, 1, 131072, "up"))


def merged_blocks(B: int, paths=("down", "up")) -> int:
    """Decoder blocks of a bf16 default-route forward of ``B`` tiles that run
    merged, of the stages on ``paths``."""
    return sum(n for res, _, n, tokens, path in DEFAULT_MERGED_STAGES
               if path in paths and B * res * res >= tokens)


DEFAULT_MERGED_BLOCKS = {B: merged_blocks(B) for B in (4, 6, 12, 16, 32)}

# the default route in bf16 for the encoder's frequency blocks, held apart
# from the model's own table (DEFAULT_MERGED's "freq" entries): (res,
# shifted, least tokens of a batch, band images x res^2) of the stages whose
# blocks (one shifted, one not, a stage) run K5 from that many tokens up;
# every other frequency block, and float32, takes the chain
DEFAULT_FREQ_STAGES = ((128, True, 1572864), (64, True, 393216),
                       (32, False, 98304), (32, True, 98304))


def freq_merged_blocks(B: int, dtype: str, shifted=(False, True)) -> int:
    """Encoder frequency blocks of a default-route forward of ``B`` tiles
    (``K3_BANDS * B`` band images) in ``dtype`` that run K5, of those whose
    shift is in ``shifted``."""
    if dtype != "bfloat16":
        return 0
    return sum(1 for res, sh, least in DEFAULT_FREQ_STAGES
               if sh in shifted and K3_BANDS * B * res * res >= least)


def default_counts(dtype: str, B: int) -> dict:
    """Launches of one default-route forward of ``B`` tiles, held apart from
    the model's own route table."""
    k4 = DEFAULT_MERGED_BLOCKS[B] if dtype == "bfloat16" else 0
    k12 = split_blocks(B, dtype)
    k5 = freq_merged_blocks(B, dtype)
    return {**ZERO, "lewin_attn": 54 - k4 - k12 - k5,
            "lewin_ffn": 54 - k4 - k12 - k5, "freq_inter": 10 - k5,
            "lewin_merged": k4, "freq_merged": k5, "lewin_attn_split": k12,
            "lewin_ffn_split": k12}
TRAIN_BATCH = 4          # the training CLI's batch: one sample per task


def train_step_counts(joint: bool) -> dict:
    """Launches of one training step at B=4 in bf16 on the default route.
    The encoder's 10 frequency blocks, forward by the key and by the query
    encoder: K5 for those that run merged at this batch, the chain (K1
    intra, K3, K2) for the others; backward K6, K8, K7 each. The joint step
    adds the decoder's 44 blocks: forward K4 for those that run merged at
    this batch, K1 / K2 for the others, backward K6 and K7 for every
    block."""
    k5 = freq_merged_blocks(TRAIN_BATCH, "bfloat16")
    c = {**ZERO, "lewin_attn": 20 - 2 * k5, "freq_inter": 20 - 2 * k5,
         "lewin_ffn": 20 - 2 * k5, "freq_merged": 2 * k5,
         "lewin_attn_bwd": 10, "freq_inter_bwd": 10, "lewin_ffn_bwd": 10}
    if joint:
        k4 = DEFAULT_MERGED_BLOCKS[TRAIN_BATCH]
        c["lewin_attn"] += 44 - k4
        c["lewin_ffn"] += 44 - k4
        c["lewin_merged"] += k4
        c["lewin_attn_bwd"] += 44
        c["lewin_ffn_bwd"] += 44
    return c


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


ALL_PHASES = frozenset(range(3, 19))


class Failed(Exception):
    pass


class Counters:
    """The launch counters of every kernel module (``LAUNCHES`` of
    ``ops/kernels/lewin_block.py``, ``ops/kernels/window_attention.py`` and
    ``ops/deform_conv.py``), set to 0 and read together."""

    def __init__(self, *modules):
        self.modules = modules

    def reset(self) -> None:
        for m in self.modules:
            m.reset_launches()

    def read(self) -> dict:
        out = {}
        for m in self.modules:
            out.update(m.LAUNCHES)
        return out


COUNTERS = Counters()           # filled in by main()


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def hgmma_count(build) -> int:
    """HGMMA (wgmma) instructions in the built library's SASS
    (``cuobjdump -sass``, beside ``nvcc``)."""
    tool = os.path.join(os.path.dirname(build.nvcc()), "cuobjdump")
    out = subprocess.run([tool, "-sass", str(build.build()[0])],
                         capture_output=True, text=True, timeout=600)
    if out.returncode != 0:
        raise Failed(f"cuobjdump failed: {out.stderr[-2000:]}")
    return sum("HGMMA" in ln for ln in out.stdout.splitlines())


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
            tol: float, floor: float = 1.0) -> float:
    got, want = got.float(), want.float()
    if got.shape != want.shape:
        raise Failed(f"{name}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    if not torch.isfinite(got).all():
        raise Failed(f"{name}: non-finite kernel output")
    err = (got - want).abs().max().item()
    ref = want.abs().max().item()
    rel = err / max(floor, ref)
    verdict = "ok" if rel <= tol else "FAIL"
    print(f"  {name}: max_abs {err:.3e} max|ref| {ref:.3e} "
          f"err/max({floor:.3g},|ref|) {rel:.3e} tol {tol:.0e} {verdict}",
          flush=True)
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


# the flagship decoder's stages (res, C, heads): on the way down C = 56 *
# 2^s at res 128 >> s, then the up path's C = 112 * 2^s
DECODER_STAGES = ((128, 56, 1), (64, 112, 2), (32, 224, 4), (16, 448, 8),
                  (8, 896, 16), (16, 896, 16), (32, 448, 8), (64, 224, 4),
                  (128, 112, 2))


def kernel_cases(lb, windows, dtype, B):
    """The kernels at the flagship shapes. Decoder blocks (origin MSA,
    all_DC ``lam``) at :data:`DECODER_STAGES`; encoder blocks (L=3 bands
    folded into the batch): C = 28 * 2^s. K1-K3 at res 128, 32 and 8 of
    the way down; the merged K4 at every decoder stage, K5 at all five
    stage resolutions, shift 0 and 4.
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
    for res, C, h in DECODER_STAGES:
        M = B * res * res
        up = (res, C) not in ((128 >> s, 56 << s) for s in range(5))
        for shift in ((0, 4) if res > 8 else (0,)):
            x = rnd(B, res, res, C).to(dtype)
            ln1, ln2, aw, fw = ln(C), ln(C), attn_weights(C, h), ffn_weights(C)
            bias, mask, lam = rnd(h, n, n, scale=0.05), mask_of(res, shift), rnd(B, h, scale=0.3)
            dps1, dps2 = dps_of(B), dps_of(B)
            aop = lb.attn_operands(*aw, bias, dtype)
            fop = lb.ffn_operands(*fw, dtype)
            tag = f"res{res} C{C} h{h} shift{shift}"
            if res in (128, 32, 8) and not up:
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
                attn_flops(M, C, n) + ffn_flops(M, C), ("origin", res, shift, C),
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
            # K3 reads the per-pair tables the grouped bias is made from
            pairsB = rnd(L * L, 225, h, scale=0.05)
            biasB = lb.inter_bias(pairsB, L, 8)
            inter = functools.partial(lb.freq_inter, pairs=pairsB)
            mask = mask_of(res, shift)
            dps1, dps2 = dps_of(LB), dps_of(LB)
            opA = lb.attn_operands(*awA, biasA, dtype)
            opB = lb.attn_operands(*awB, biasB, dtype, pairsB)
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
                    [y, x, *awB, biasB, mask, L, 8, 1e-6, dps1], inter,
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
                functools.partial(lb.block_freq_merged, pairs=pairsB),
                lb.block_freq_merged_plain,
                lambda stamps=None, path=None, x=x, ln1=ln1, ln2=ln2, opA=opA,
                opB=opB, fop=fop, mask=mask, dps1=dps1, dps2=dps2, shift=shift:
                lb.freq_merged_kernel(x, *ln1, opA, opB, mask, *ln2, fop, L, 8,
                                      shift, 1e-6, dps1, dps2, stamps,
                                      path=path),
                attn_flops(M, C, n) + attn_flops(M, C, L * n) + ffn_flops(M, C),
                ("freq", res, shift, C),
                functools.partial(lb.freq_merged_chain, lb.freq_intra,
                                  inter, lb.block_ffn), chain_timed))
    return cases


def print_phases(lb, case: Case, label: str, path=None):
    """Where one launch of a merged kernel spends its time: the device
    clock at each phase's closing grid barrier (the barrier's wait is in the
    phase it closes); K5 by ``path`` (None: ``freq_merged_path``)."""
    x, wq3 = case.args[0], case.args[3]
    stamps = torch.zeros(lb.MERGED_STAMPS, dtype=torch.int64, device="cuda")
    if case.kernel == "freq_merged":
        names = lb.freq_merged_phases(x.shape[-1], wq3.shape[0], 8, x.dtype,
                                      K3_BANDS, path)
        case.timed(stamps, path)
    else:
        names = lb.merged_phases(x.shape[-1], wq3.shape[0], 8, x.dtype)
        case.timed(stamps)
    torch.cuda.synchronize()
    t = stamps.tolist()
    if any(b < a for a, b in zip(t[:len(names)], t[1:len(names) + 1])):
        raise Failed(f"{label}: phase clock stamps {t} do not rise")
    total = (t[len(names)] - t[0]) / 1e6
    print(f"    phases of one launch, {total:.4f} ms: " + ", ".join(
        f"{name} {(b - a) / 1e6:.4f}" for name, a, b in zip(names, t, t[1:])),
        flush=True)


def k5_group(lb, case: Case, dtype) -> bool:
    """Whether ``case`` is K5 at a shape its band-group form takes."""
    return case.kernel == "freq_merged" and lb.freq_merged_path(
        case.stage[3], case.args[3].shape[0], 8, dtype) == "group"


def check_kernels(lb, windows, default_merged, stats, card: str):
    """Phase 3: each kernel against its plain twin (and K4 / K5 against the
    chain); times with prepared operands; K5 where it runs its band-group
    form equal to the chain bit for bit (at every batch of the table), and
    also by its twelve phases (the parent's form), equal to it bit for
    bit. The kernels line takes each kernel's first (res-128) case in
    bf16 at B=32. The merged-against-chain
    table covers both dtypes at the batches the entry points run and marks
    the blocks that ``default_merged`` (the model's route table, each entry
    from its least batch in tokens) runs merged."""
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
                chain = case.chain(*case.args)
                compare(f"{label} vs chain", got, chain, CHAIN_TOL[dtype])
                if k5_group(lb, case, dtype) and not torch.equal(got, chain):
                    raise Failed(f"{label}: K5's band-group form differs from "
                                 "the chain in some bits")
                del chain
                cms = time_ms(case.chain_timed)
                ab[(*case.stage, name_dt, B)] = (ms, cms)
                line += f", chain of kernels {cms:.4f} ms"
            print(line, flush=True)
            if case.stage is not None and case.stage[1] in (128, 32, 16):
                print_phases(lb, case, label)
            if k5_group(lb, case, dtype):
                # the parent's form, twelve phases, beside the band groups:
                # both equal the chain bit for bit (the phases' LN2 sums a
                # row in the order of K2's fused tile)
                phases = case.timed(path="phases")
                compare(f"{label} phases form vs band groups", phases, got,
                        CHAIN_TOL[dtype])
                if not torch.equal(phases, got):
                    raise Failed(f"{label}: K5's twelve phases differ from the "
                                 "band groups (and the chain) in some bits")
                print(f"    phases form {time_ms(lambda: case.timed(path='phases')):.4f}"
                      f" ms (band groups {ms:.4f} ms), bits equal", flush=True)
                print_phases(lb, case, label, "phases")
                del phases
            # the kernels line: each kernel's first case in bf16, K4's at a
            # stage the default route runs it
            if dtype == torch.bfloat16 and (
                    st["ms"] is None or case.stage == ("origin", 32, 4, 224)):
                st.update(ms=ms, plain_ms=pms, bound_ms=bound, bound_by=by)
            del got, want
    # the other batches the entry points run (the pooled batch of the eval
    # entry point, a small last chunk), in both dtypes: times only
    for dtype, B in ((torch.bfloat16, ENTRY_BATCH), (torch.bfloat16, SMALL_BATCH),
                     (torch.float32, ENTRY_BATCH)):
        for case in kernel_cases(lb, windows, dtype, B):
            if case.chain is not None:
                if k5_group(lb, case, dtype) and not torch.equal(
                        case.timed(), case.chain_timed()):
                    raise Failed(f"{case.label} {str(dtype)[6:]} B{B}: K5's "
                                 "band-group form differs from the chain")
                ab[(*case.stage, str(dtype)[6:], B)] = (
                    time_ms(case.timed), time_ms(case.chain_timed))
    print(f"merged against chain, ms per block ({card}):", flush=True)
    for (msa, res, shift, C, name_dt, B), (ms, cms) in sorted(ab.items()):
        key = (msa, res, shift > 0, getattr(torch, name_dt), C)
        default = key in default_merged and B * res * res >= default_merged[key]
        print(f"  {msa:6s} res {res:3d} C {C:3d} shift {shift} {name_dt} B={B}: merged "
              f"{ms:.4f}, chain {cms:.4f}, merged/chain {ms / cms:.3f}"
              + ("  [default: merged]" if default else ""), flush=True)


# K2's table: (res, C, band copies) of every flagship stage whose blocks K2
# serves: the decoder's (C = 56 * 2^s on the way down, twice that on the
# way up, C = 896 at res 8 and 16) and the encoder's (C = 28 * 2^s, its
# three FFT bands folded into the batch). The C = 896 stages stand in the
# table where the bf16 default route runs them on K2 (runs_split)
K2_STAGES = ((128, 56, 1), (64, 112, 1), (32, 224, 1), (16, 448, 1),
             (8, 896, 1), (16, 896, 1), (32, 448, 1), (64, 224, 1),
             (128, 112, 1), (128, 28, 3), (64, 56, 3), (32, 112, 3),
             (16, 224, 3), (8, 448, 3))


def k2_cases(lb, B):
    """K2 in bf16 at :data:`K2_STAGES` on ``B`` tiles: a BwdCase each (its
    ``run`` the launch with prepared operands, ``plain`` the twin; ``dims``
    (rows, C)), with a yardstick: ``torch.matmul`` over K2's two products,
    fc1 [M, C] x [C, 4C] and fc2 [M, 4C] x [4C, C], on operands made once.
    Operations: the products and the 9 taps; bytes: x read, the output
    written, the weights read."""
    gen = torch.Generator(device="cuda").manual_seed(11)
    dt = torch.bfloat16

    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device="cuda") * scale

    out = []
    for res, C, bands in K2_STAGES:
        images, Hd = bands * B, 4 * C
        M = images * res * res
        if C == 896 and runs_split(res, "bfloat16", M):
            continue
        x = rnd(images, res, res, C).to(dt)
        ln2 = [1 + rnd(C, scale=0.1), rnd(C, scale=0.1)]
        fw = [rnd(C, Hd, scale=C ** -0.5), rnd(Hd, scale=0.1),
              rnd(3, 3, Hd, scale=1 / 3), rnd(Hd, scale=0.1),
              rnd(Hd, C, scale=Hd ** -0.5), rnd(C, scale=0.1)]
        dps = (torch.rand(images, generator=gen, device="cuda") < 0.9).float() / 0.9
        fop = lb.ffn_operands(*fw, dt)
        args = [x, *ln2, *fw, 1e-6, dps]
        xm, hm = rnd(M, C).to(dt), rnd(M, Hd).to(dt)
        w1, w2 = fw[0].to(dt), fw[4].to(dt)

        def yardstick(xm=xm, hm=hm, w1=w1, w2=w2):
            torch.matmul(xm, w1)
            torch.matmul(hm, w2)
        out.append((BwdCase(
            "lewin_ffn",
            f"block_ffn res{res} C{C} images{images}"
            + (" (encoder)" if bands > 1 else ""),
            lambda x=x, ln2=ln2, fop=fop, dps=dps: lb.ffn_kernel(
                x, *ln2, fop, 1e-6, dps),
            lambda a=args: lb.block_ffn_plain(*a),
            2.0 * M * Hd * (2 * C + 9),
            2 * x.numel() * x.element_size()
            + 4 * sum(t.numel() for t in (*ln2, *fw, dps)),
            (M, C)), yardstick))
    return out


def k2_table(lb, card: str):
    """Phase 3b: K2 in bf16 at every flagship stage it serves, B = 4 and 32:
    against its twin, its time beside the plain version's, the bound and
    the yardstick of :func:`k2_cases` (K2 / yardstick is the ratio two calls
    compare), and the device memory one launch takes beyond its output
    (the launcher's scratch: the hidden tensors where it keeps them)."""
    print(f"K2 table (bf16): kernel ms, plain ms, yardstick ms (torch.matmul "
          f"over fc1 and fc2), bound, scratch ({card}):", flush=True)
    for B in (SMALL_BATCH, BATCH):
        for case, yardstick in k2_cases(lb, B):
            label = f"{case.label} bf16"
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            got = case.run()
            torch.cuda.synchronize()
            scratch = (torch.cuda.max_memory_allocated() - base
                       - got.numel() * got.element_size())
            compare(label, got, case.plain(), KERNEL_TOL[torch.bfloat16])
            del got
            ms = time_ms(case.run)
            pms = time_ms(case.plain, iters=3, warmup=1)
            yms = time_ms(yardstick)
            t_bytes = case.nbytes / PEAK_BYTES * 1e3
            t_flops = case.flops / PEAK_FLOPS[torch.bfloat16] * 1e3
            bound, by = max(t_bytes, t_flops), (
                "bytes" if t_bytes >= t_flops else "operations")
            print(f"  K2 {label}: kernel {ms:.4f} ms, plain {pms:.4f} ms, "
                  f"yardstick {yms:.4f} ms, kernel / yardstick {ms / yms:.3f}, "
                  f"bound {bound:.4f} ms by {by}, scratch "
                  f"{scratch / 2 ** 20:.2f} MiB", flush=True)
        torch.cuda.empty_cache()


# K1's table: (res, C, heads, band copies) of every flagship stage whose
# attention K1 serves: the decoder's (C = 56 * 2^s on the way down, the up
# path's 112 * 2^s, d = 56), the encoder's intra attention (C = 28 * 2^s,
# d = 28, its three FFT bands folded into the batch, one bias table a band).
# The C = 896 stages stand in the table where the bf16 default route runs
# them on K1 (runs_split)
K1_STAGES = ((128, 56, 1, 1), (64, 112, 2, 1), (32, 224, 4, 1),
             (16, 448, 8, 1), (8, 896, 16, 1), (16, 896, 16, 1),
             (32, 448, 8, 1), (64, 224, 4, 1), (128, 112, 2, 1),
             (128, 28, 1, 3), (64, 56, 2, 3), (32, 112, 4, 3),
             (16, 224, 8, 3), (8, 448, 16, 3))


def k1_cases(lb, windows, B, dtype=torch.bfloat16):
    """K1 at :data:`K1_STAGES` on ``B`` tiles: a BwdCase each (``run`` the
    launch with prepared operands, ``plain`` the twin; ``dims`` (rows, C,
    heads, bands)), shifted (the SW-MSA mask) where the stage has more than
    one window, the decoder's with the all_DC ``lam`` and DropPath, with a
    yardstick: ``torch.matmul`` over K1's four products, qkv [M, C] x
    [C, 3C], the logits and P V batched over windows and heads, proj
    [M, C] x [C, C], on operands made once. Operations: the four products;
    bytes: x read, the output written, the weights and tables read."""
    gen = torch.Generator(device="cuda").manual_seed(12)
    n = 64

    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device="cuda") * scale

    out = []
    for res, C, h, bands in K1_STAGES:
        images, d = bands * B, C // h
        M = images * res * res
        if C == 896 and runs_split(res, str(dtype)[6:], M):
            continue
        shift = 4 if res > 8 else 0
        x = rnd(images, res, res, C).to(dtype)
        ln1 = [1 + rnd(C, scale=0.1), rnd(C, scale=0.1)]
        aw = [rnd(h, C, d, scale=C ** -0.5) if i % 2 == 0 else
              rnd(h, d, scale=0.1) for i in range(6)]
        aw += [rnd(h, d, C, scale=C ** -0.5), rnd(C, scale=0.1)]
        mask = (torch.from_numpy(windows.shift_attn_mask(res, res, 8, shift))
                .cuda() if shift else None)
        if bands == 1:
            bias = rnd(h, n, n, scale=0.05)
            lam, dps = rnd(images, h, scale=0.3), (torch.rand(
                images, generator=gen, device="cuda") < 0.9).float() / 0.9
            args = [x, *ln1, *aw, bias, mask, lam, 8, 1e-6, dps]
            plain = lambda a=args: lb.block_attention_plain(*a)
            run_args = (lam, 8, 1e-6, True, 1, dps)
            label = f"block_attention res{res} C{C} h{h} shift{shift} lam"
        else:
            bias = rnd(bands, h, n, n, scale=0.05)
            lam = dps = None
            args = [x, *ln1, *aw, bias, mask, bands, 8, 1e-6]
            plain = lambda a=args: lb.freq_intra_plain(*a)
            run_args = (None, 8, 1e-6, False, bands, None)
            label = f"freq_intra res{res} C{C} h{h} shift{shift} L{bands}"
        op = lb.attn_operands(*aw, bias, dtype)
        xm, w3, wp = rnd(M, C).to(dtype), rnd(C, 3 * C).to(dtype), rnd(C, C).to(dtype)
        qh, ph = rnd(M // n * h, n, d).to(dtype), rnd(M // n * h, n, n).to(dtype)

        def yardstick(xm=xm, w3=w3, wp=wp, qh=qh, ph=ph):
            torch.matmul(xm, w3)                      # qkv
            torch.matmul(qh, qh.transpose(-1, -2))    # logits
            torch.matmul(ph, qh)                      # P V
            torch.matmul(xm, wp)                      # proj
        tables = [t for t in (*ln1, bias, mask, lam, dps) if t is not None]
        out.append((BwdCase(
            "lewin_attn", f"{label} images{images}",
            lambda x=x, ln1=ln1, op=op, mask=mask, ra=run_args:
            lb.attention_kernel(x, *ln1, op, mask, *ra),
            plain, 2.0 * M * C * (4 * C + 2 * n),
            2 * x.numel() * x.element_size()
            + 4 * C * C * x.element_size() + 4 * sum(t.numel() for t in tables),
            (M, C, h, bands)), yardstick))
    return out


def k1_table(lb, windows, card: str):
    """Phase 3c: K1 in bf16 at every stage of :data:`K1_STAGES`, B = 4 and
    32: against its twin, equal bits on a second launch, its time beside
    the plain version's, the bound and the yardstick of :func:`k1_cases`
    (K1 / yardstick is the ratio two calls compare), and the device memory
    one launch takes beyond its output (0 where K1 runs fused)."""
    print(f"K1 table (bf16): kernel ms, plain ms, yardstick ms (torch.matmul "
          f"over qkv, logits, P V, proj), bound, scratch ({card}):", flush=True)
    for B in (SMALL_BATCH, BATCH):
        for case, yardstick in k1_cases(lb, windows, B):
            label = f"K1 {case.label} bf16"
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            got = case.run()
            torch.cuda.synchronize()
            scratch = (torch.cuda.max_memory_allocated() - base
                       - got.numel() * got.element_size())
            compare(label, got, case.plain(), KERNEL_TOL[torch.bfloat16])
            if not torch.equal(case.run(), got):
                raise Failed(f"{label}: two launches give different bits")
            del got
            ms = time_ms(case.run)
            pms = time_ms(case.plain, iters=3, warmup=1)
            yms = time_ms(yardstick)
            t_bytes = case.nbytes / PEAK_BYTES * 1e3
            t_flops = case.flops / PEAK_FLOPS[torch.bfloat16] * 1e3
            bound, by = max(t_bytes, t_flops), (
                "bytes" if t_bytes >= t_flops else "operations")
            print(f"    {label}: kernel {ms:.4f} ms, plain {pms:.4f} ms, "
                  f"yardstick {yms:.4f} ms, kernel / yardstick {ms / yms:.3f}, "
                  f"bound {bound:.4f} ms by {by}, scratch "
                  f"{scratch / 2 ** 20:.2f} MiB", flush=True)
        torch.cuda.empty_cache()


# the encoder's stages (res, C, heads) K3 serves: L = 3 bands, head dim 28
K3_STAGES = ((128, 28, 1), (64, 56, 2), (32, 112, 4), (16, 224, 8),
             (8, 448, 16))
K3_BANDS = 3


def k3_cases(lb, windows, B, dtype=torch.bfloat16):
    """K3 at :data:`K3_STAGES` on ``B`` tiles (``L * B`` band images), as
    the model hands it over: the per-pair tables ``[L*L, 225, h]`` with the
    grouped bias made from them, the SW-MSA mask where the stage has more
    than one window, DropPath. Per stage ``(case, yardstick, passes)``:
    ``case`` a BwdCase (``run`` the launch with prepared operands by
    ``freq_inter_path``, ``plain`` the twin; ``dims`` (rows M, C, heads,
    group tokens)); ``passes`` the launch in four passes, the parent's form
    (at the deep stages the same launch); ``yardstick`` ``torch.matmul``
    over K3's four products, qkv [M, C] x [C, 3C], the logits and P V
    batched over groups and heads, proj [M, C] x [C, C], on operands made
    once. Operations: the four products; bytes: y and the residual read,
    the output written, the weights and tables read."""
    gen = torch.Generator(device="cuda").manual_seed(13)
    L, n = K3_BANDS, 64

    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device="cuda") * scale

    out = []
    for res, C, h in K3_STAGES:
        images, d, keys = L * B, C // h, L * n
        M = images * res * res
        shift = 4 if res > 8 else 0
        y, x = rnd(images, res, res, C).to(dtype), rnd(images, res, res, C).to(dtype)
        aw = [rnd(h, C, d, scale=C ** -0.5) if i % 2 == 0 else
              rnd(h, d, scale=0.1) for i in range(6)]
        aw += [rnd(h, d, C, scale=C ** -0.5), rnd(C, scale=0.1)]
        pairs = rnd(L * L, 225, h, scale=0.05)
        bias = lb.inter_bias(pairs, L, 8)
        mask = (torch.from_numpy(windows.shift_attn_mask(res, res, 8, shift))
                .cuda() if shift else None)
        dps = (torch.rand(images, generator=gen, device="cuda") < 0.9).float() / 0.9
        args = [y, x, *aw, bias, mask, L, 8, 1e-6, dps]
        op = lb.attn_operands(*aw, bias, dtype, pairs)
        groups = M // keys
        xm, w3, wp = rnd(M, C).to(dtype), rnd(C, 3 * C).to(dtype), rnd(C, C).to(dtype)
        qh = rnd(groups * h, keys, d).to(dtype)
        ph = rnd(groups * h, keys, keys).to(dtype)

        def yardstick(xm=xm, w3=w3, wp=wp, qh=qh, ph=ph):
            torch.matmul(xm, w3)                      # qkv
            torch.matmul(qh, qh.transpose(-1, -2))    # logits
            torch.matmul(ph, qh)                      # P V
            torch.matmul(xm, wp)                      # proj
        tables = [t for t in (pairs, mask, dps) if t is not None]
        label = f"freq_inter res{res} C{C} h{h} shift{shift} L{L} images{images}"
        flops = 2.0 * M * C * (4 * C + 2 * keys)
        nbytes = (3 * y.numel() * y.element_size() + 4 * C * C * y.element_size()
                  + 4 * sum(t.numel() for t in tables))

        def case(path, tag, y=y, x=x, op=op, mask=mask, dps=dps, args=args):
            return BwdCase(
                "freq_inter", label + tag,
                lambda: lb.freq_inter_kernel(y, x, op, mask, L, 8, dps, path),
                lambda: lb.freq_inter_plain(*args), flops, nbytes,
                (M, C, h, keys))
        out.append((case(None, ""), yardstick, case("passes", " passes"),
                    case("fused", " fused")))
    return out


# K3's launches at each encoder stage (two blocks a stage): per eval
# forward and per joint step at B = 4 and 32 (the query and the key
# encoder's forward)
K3_LAUNCHES = (2, 4, 4)


def k3_table(lb, windows, stats, card: str):
    """Phase 3e: K3 in bf16 at every encoder stage of :data:`K3_STAGES`,
    B = 4 and 32, in the model's form (the per-pair tables): against its
    twin, against the four passes (the parent's form; fused where
    ``freq_inter_path`` chooses it) and on a second launch (equal bits); the
    passes' time beside the launch's, the plain version's, the bound, the
    launches of :data:`K3_LAUNCHES`, launches x (time - bound) per eval
    forward, K3 over the yardstick of :func:`k3_cases`, and the device
    memory one launch takes beyond its output (0 where K3 runs fused). The
    kernels line takes the res-128 row at B = 32."""
    print(f"K3 table (bf16): passes (parent) -> launch ms, plain ms, "
          f"yardstick ms, bound, launches (eval B=32, step B=4, step B=32), "
          f"scratch ({card}):", flush=True)
    tol = KERNEL_TOL[torch.bfloat16]
    for B in (SMALL_BATCH, BATCH):
        for case, yardstick, passes, _ in k3_cases(lb, windows, B):
            M, C, h, keys = case.dims
            path = lb.freq_inter_path(C, h, 8, torch.bfloat16, K3_BANDS,
                                      M // keys)
            label = f"K3 {case.label} bf16 ({path})"
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            got = case.run()
            torch.cuda.synchronize()
            scratch = (torch.cuda.max_memory_allocated() - base
                       - got.numel() * got.element_size())
            err = compare(label, got, case.plain(), tol)
            ref = passes.run()
            compare(f"{label} vs passes", got, ref, tol)
            if not torch.equal(case.run(), got):
                raise Failed(f"{label}: two launches give different bits")
            same = torch.equal(got, ref)
            del got, ref
            ms, pms = time_ms(case.run), time_ms(passes.run)
            plain_ms = time_ms(case.plain, iters=3, warmup=1)
            yms = time_ms(yardstick)
            t_bytes = case.nbytes / PEAK_BYTES * 1e3
            t_flops = case.flops / PEAK_FLOPS[torch.bfloat16] * 1e3
            bound, by = max(t_bytes, t_flops), (
                "bytes" if t_bytes >= t_flops else "operations")
            ev = K3_LAUNCHES[0]
            print(f"    {label}: passes {pms:.4f} -> {ms:.4f} ms "
                  f"(bits {'equal' if same else 'differ'}), plain "
                  f"{plain_ms:.4f} ms, yardstick {yms:.4f} ms, K3 / yardstick "
                  f"{pms / yms:.3f} -> {ms / yms:.3f}, bound {bound:.4f} ms by "
                  f"{by}, launches {K3_LAUNCHES}, L x (t - b) "
                  f"{ev * (pms - bound):.4f} -> {ev * (ms - bound):.4f} ms, "
                  f"scratch {scratch / 2 ** 20:.2f} MiB", flush=True)
            st = stats["freq_inter"]
            st["max_abs_err"] = max(st["max_abs_err"], err)
            if B == BATCH and case.dims[0] == K3_BANDS * B * 128 * 128:
                st.update(ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by)
        torch.cuda.empty_cache()


# F2: where the LeFF's hidden leaves the SM (K2's passes, K13, K4, K5) it
# is kept in fp32 from fc1 through the conv, as JAX keeps it. The check's
# inputs make a bf16 rounding of that hidden show: fc1's outputs sit near
# 100 (bf16 spacing 0.5) and vary by less than 1, and the conv's taps
# cancel (centre 1, the eight others -1/8), so its output, away from the
# image's rim, is the small difference of large values. A twin that rounds
# the hidden to bf16 after fc1, as the kernels did before, errs there by
# about 0.2 against the plain twin; the kernels, by their own bf16 output
# (about 0.004). F2_FACTOR = 4 leaves room for their summation order.
F2_FACTOR = 4.0
F2_FFN = ((16, 448, 1), (32, 448, 1), (8, 448, 3), (8, 896, 1), (16, 896, 1))
F2_SPLIT = ((8, 896), (16, 896))
# K4: the shifted decoder stages of DEFAULT_MERGED_STAGES and those at
# C = 112, where impl='merged' runs K4 and the default route the chain
F2_MERGED = ((64, 112), (32, 224), (32, 448), (64, 224), (128, 112))
F2_FREQ = ((32, 112, 4, 4), (8, 448, 16, 0))


def f2_check(lb, windows, card: str):
    """Phase 3f: F2 at every stage of the kernels that keep the LeFF's
    hidden in device memory (bf16, B = 4): K2's passes, K13, K4 at the
    shifted decoder stages it serves (F2_MERGED), K5 at two encoder
    stages. Each is held against its plain twin and against a twin that
    rounds the hidden after fc1 (``lewin_block.ffn_rounded_hidden_plain``)
    away from the image's rim: the kernel must be F2_FACTOR times closer to
    the plain twin."""
    gen = torch.Generator(device="cuda").manual_seed(11)
    dt, B, n = torch.bfloat16, SMALL_BATCH, 64

    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device="cuda") * scale

    def attn(C, h):
        d = C // h
        return ([rnd(h, C, d, scale=C ** -0.5) if i % 2 == 0 else
                 rnd(h, d, scale=0.1) for i in range(6)]
                + [rnd(h, d, C, scale=C ** -0.5), rnd(C, scale=0.1)])

    ln = lambda C: [torch.ones(C, device="cuda"), torch.zeros(C, device="cuda")]
    rows = []   # (kernel, label, run, plain, faulty)
    for res, C, bands in F2_FFN:
        args = [rnd(bands * B, res, res, C, scale=0.5).to(dt), *ln(C),
                *lb.f2_ffn_weights(C, rnd), 1e-6, None]
        rows.append(("lewin_ffn", f"block_ffn res{res} C{C} images{bands * B}",
                     lb.block_ffn, lb.block_ffn_plain, args,
                     lb.ffn_rounded_hidden_plain))
    for res, C in F2_SPLIT:
        args = [rnd(B, res, res, C, scale=0.5).to(dt), *ln(C),
                *lb.f2_ffn_weights(C, rnd), 1e-6, None]
        rows.append(("lewin_ffn_split", f"block_ffn_split res{res} C{C}",
                     lb.block_ffn_split, lb.lewin_ffn_split_plain, args,
                     lb.ffn_rounded_hidden_plain))
    heads = {C: h for _, C, h in DECODER_STAGES}
    for res, C in F2_MERGED:
        h = heads[C]
        mask = torch.from_numpy(windows.shift_attn_mask(res, res, 8, 4)).cuda()
        args = ([rnd(B, res, res, C, scale=0.5).to(dt), *ln(C), *attn(C, h),
                 rnd(h, n, n, scale=0.05), mask, rnd(B, h, scale=0.3), *ln(C),
                 *lb.f2_ffn_weights(C, rnd), 8, 4, 1e-6, None, None])
        rows.append(("lewin_merged", f"block_merged res{res} C{C} shift4",
                     lb.block_merged, lb.block_merged_plain, args,
                     functools.partial(lb.merged_chain, lb.block_attention_plain,
                                       lb.ffn_rounded_hidden_plain)))
    L = K3_BANDS
    for res, C, h, shift in F2_FREQ:
        mask = (torch.from_numpy(windows.shift_attn_mask(res, res, 8, shift))
                .cuda() if shift else None)
        pairs = rnd(L * L, 225, h, scale=0.05)
        args = ([rnd(L * B, res, res, C, scale=0.5).to(dt), *ln(C), *attn(C, h),
                 rnd(L, h, n, n, scale=0.05), *attn(C, h),
                 lb.inter_bias(pairs, L, 8), mask, *ln(C),
                 *lb.f2_ffn_weights(C, rnd), L, 8, shift, 1e-6, None, None])
        rows.append(("freq_merged", f"block_freq_merged res{res} C{C} shift{shift}",
                     functools.partial(lb.block_freq_merged, pairs=pairs),
                     lb.block_freq_merged_plain, args,
                     functools.partial(lb.freq_merged_chain, lb.freq_intra_plain,
                                       lb.freq_inter_plain,
                                       lb.ffn_rounded_hidden_plain)))
    print(f"F2 check (bf16, B={B}): max |. - plain| away from the rim, the "
          f"kernel's and the hidden-rounded twin's ({card}):", flush=True)
    for kernel, label, run, plain, args, faulty in rows:
        COUNTERS.reset()
        got = run(*args)
        torch.cuda.synchronize()
        if COUNTERS.read()[kernel] != 1:
            raise Failed(f"F2 {label}: {kernel} did not run")
        want, bad = plain(*args).float(), faulty(*args).float()
        if not torch.isfinite(got).all():
            raise Failed(f"F2 {label}: non-finite kernel output")
        inner = (slice(None), slice(1, -1), slice(1, -1))
        e_k = (got.float() - want)[inner].abs().max().item()
        e_f = (bad - want)[inner].abs().max().item()
        ok = e_k * F2_FACTOR <= e_f
        print(f"  F2 {kernel} {label}: kernel {e_k:.3e}, rounded twin "
              f"{e_f:.3e}, ratio {e_f / max(e_k, 1e-30):.1f} (at least "
              f"{F2_FACTOR:.0f}) {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise Failed(f"F2 {label}: the kernel is not {F2_FACTOR}x closer "
                         f"to the plain twin than the hidden-rounded twin")


def dcn_cases(dc, B, dtype=torch.bfloat16, stages=None):
    """K11 at ``stages`` ((res, C) with Cout = C; default
    :data:`DCN_STAGES`) on ``B`` images, exact (no clamp), offsets up to
    +-3.5 pixels: a BwdCase for each route K11 has in ``dtype`` (``run``
    the launch by that route, ``plain`` ``dcn_plain``; ``dims`` (rows M, C,
    Cout)), the route ``dcn_path`` chooses first. Operations: the
    contraction, 2 M 9C Cout; bytes: x, offsets, mask and weight read once,
    the output written once."""
    gen = torch.Generator(device="cuda").manual_seed(6)
    out = []
    for res, C in stages or DCN_STAGES:
        x = (torch.randn(B, res, res, C, generator=gen, device="cuda")
             * 0.5).to(dtype)
        off = (torch.rand(B, res, res, 18, generator=gen, device="cuda")
               * 7 - 3.5).to(dtype)
        mask = torch.rand(B, res, res, 9, generator=gen, device="cuda").to(dtype)
        w = (torch.randn(3, 3, C, C, generator=gen, device="cuda")
             * (9 * C) ** -0.5).to(dtype)
        args = (x, off, mask, w, None, 1, 1, None)
        M = B * res * res
        paths = ["implicit", "columns"] if dtype == torch.bfloat16 else ["columns"]
        paths.sort(key=lambda p: p != dc.dcn_path(C, C, dtype))
        for path in paths:
            out.append(BwdCase(
                "dcn", f"dcn res{res} C{C} exact B{B} {path}",
                lambda a=args, p=path: dc.dcn_kernel(*a, p),
                lambda a=args: dc.dcn_plain(*a), 2.0 * M * 9 * C * C,
                sum(t.numel() * t.element_size() for t in (x, off, mask, w))
                + x.numel() * x.element_size(), (M, C, C)))
    return out


# K4 at the res-32 stages of the default route: the shifted blocks of the
# way down, C = 224 (h = 4; the fused attention half), and of the up path,
# C = 448 (h = 8; the attention phases)
K4_STAGES = ((32, 224, 4), (32, 448, 8))


def k4_cases(lb, windows, B, dtype=torch.bfloat16):
    """K4 at :data:`K4_STAGES` (shift 4, lam, DropPath) on ``B`` tiles: a
    :class:`Case` each, with the chain of K1 and K2 it equals, and a
    yardstick: ``torch.matmul`` over its six products (qkv, logits, P V,
    proj, fc1, fc2) on operands made once."""
    gen = torch.Generator(device="cuda").manual_seed(13)
    n, out = 64, []

    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device="cuda") * scale

    for res, C, h in K4_STAGES:
        d, Hd, M, shift = C // h, 4 * C, B * res * res, 4
        x = rnd(B, res, res, C).to(dtype)
        ln1 = [1 + rnd(C, scale=0.1), rnd(C, scale=0.1)]
        ln2 = [1 + rnd(C, scale=0.1), rnd(C, scale=0.1)]
        aw = [rnd(h, C, d, scale=C ** -0.5) if i % 2 == 0 else
              rnd(h, d, scale=0.1) for i in range(6)]
        aw += [rnd(h, d, C, scale=C ** -0.5), rnd(C, scale=0.1)]
        fw = [rnd(C, Hd, scale=C ** -0.5), rnd(Hd, scale=0.1),
              rnd(3, 3, Hd, scale=1 / 3), rnd(Hd, scale=0.1),
              rnd(Hd, C, scale=Hd ** -0.5), rnd(C, scale=0.1)]
        bias, lam = rnd(h, n, n, scale=0.05), rnd(B, h, scale=0.3)
        mask = torch.from_numpy(windows.shift_attn_mask(res, res, 8, shift)).cuda()
        dps1, dps2 = ((torch.rand(B, generator=gen, device="cuda") < 0.9)
                      .float() / 0.9 for _ in range(2))
        aop, fop = lb.attn_operands(*aw, bias, dtype), lb.ffn_operands(*fw, dtype)

        def chain_timed(x=x, ln1=ln1, ln2=ln2, aop=aop, fop=fop, mask=mask,
                        lam=lam, dps1=dps1, dps2=dps2):
            u = lb.attention_kernel(lb.roll(x, shift), *ln1, aop, mask, lam,
                                    8, 1e-6, True, 1, dps1)
            return lb.ffn_kernel(lb.roll(u, -shift), *ln2, fop, 1e-6, dps2)
        xm, w3, wp = rnd(M, C).to(dtype), rnd(C, 3 * C).to(dtype), rnd(C, C).to(dtype)
        w1, w2, hm = rnd(C, Hd).to(dtype), rnd(Hd, C).to(dtype), rnd(M, Hd).to(dtype)
        qh, ph = rnd(M // n * h, n, d).to(dtype), rnd(M // n * h, n, n).to(dtype)

        def yardstick(xm=xm, w3=w3, wp=wp, w1=w1, w2=w2, hm=hm, qh=qh, ph=ph):
            torch.matmul(xm, w3)
            torch.matmul(qh, qh.transpose(-1, -2))
            torch.matmul(ph, qh)
            torch.matmul(xm, wp)
            torch.matmul(xm, w1)
            torch.matmul(hm, w2)
        out.append((Case(
            "lewin_merged", f"block_merged res{res} C{C} h{h} shift{shift} lam "
            f"B{B}",
            [x, *ln1, *aw, bias, mask, lam, *ln2, *fw, 8, shift, 1e-6, dps1,
             dps2],
            lb.block_merged, lb.block_merged_plain,
            lambda stamps=None, x=x, ln1=ln1, ln2=ln2, aop=aop, fop=fop,
            mask=mask, lam=lam, dps1=dps1, dps2=dps2:
            lb.merged_kernel(x, *ln1, aop, mask, lam, *ln2, fop, 8, shift,
                             1e-6, dps1, dps2, stamps),
            2.0 * M * C * (4 * C + 2 * n) + 2.0 * M * Hd * (2 * C + 9),
            ("origin", res, shift),
            functools.partial(lb.merged_chain, lb.block_attention,
                              lb.block_ffn), chain_timed), yardstick))
    return out


def k4_table(lb, windows, card: str):
    """Phase 3d: K4 in bf16 at :data:`K4_STAGES`, B = 4 and 32: against its
    twin and its chain, equal bits on a second launch, where one launch
    spends its time (its phases' clock stamps), its time beside the chain's,
    the plain version's, the bound and the yardstick of :func:`k4_cases`."""
    print(f"K4 table (bf16): kernel ms, chain ms, plain ms, yardstick ms "
          f"(torch.matmul over its six products), bound ({card}):", flush=True)
    dt = torch.bfloat16
    for B in (SMALL_BATCH, BATCH):
        for case, yardstick in k4_cases(lb, windows, B):
            label = f"K4 {case.label} bf16"
            got = case.wrapper(*case.args)
            torch.cuda.synchronize()
            compare(label, got, case.plain(*case.args), KERNEL_TOL[dt])
            compare(f"{label} vs chain", got, case.chain(*case.args),
                    CHAIN_TOL[dt])
            if not torch.equal(case.timed(), got):
                raise Failed(f"{label}: prepared operands or a second launch "
                             "give another result")
            del got
            print_phases(lb, case, label)
            ms, cms = time_ms(case.timed), time_ms(case.chain_timed)
            pms = time_ms(lambda: case.plain(*case.args), iters=3, warmup=1)
            yms = time_ms(yardstick)
            bound, by = bound_of(case, dt)
            print(f"    {label}: kernel {ms:.4f} ms, chain {cms:.4f} ms, plain "
                  f"{pms:.4f} ms, yardstick {yms:.4f} ms, kernel / yardstick "
                  f"{ms / yms:.3f}, bound {bound:.4f} ms by {by}", flush=True)
        torch.cuda.empty_cache()


def k5_parts(lb, case: Case, dtype):
    """The chain K5 equals, as its five launches (the two rolls, K1 intra,
    K3, K2) with prepared operands, each on its own inputs made once from
    the case's: [(name, fn)]."""
    a = case.args
    x, ln1, mask, ln2 = a[0], a[1:3], a[21], a[22:24]
    L, shift, dps1, dps2 = a[30], a[32], a[34], a[35]
    opA = lb.attn_operands(*a[3:12], dtype)
    opB = lb.attn_operands(*a[12:21], dtype, case.wrapper.keywords["pairs"])
    fop = lb.ffn_operands(*a[24:30], dtype)
    img = lb.roll(x, shift)
    y1 = lb.attention_kernel(img, *ln1, opA, mask, None, 8, 1e-6, False, L,
                             None)
    ur = lb.freq_inter_kernel(y1, img, opB, mask, L, 8, dps1)
    u = lb.roll(ur, -shift)
    return [("roll x", lambda: lb.roll(x, shift)),
            ("K1 intra", lambda: lb.attention_kernel(
                img, *ln1, opA, mask, None, 8, 1e-6, False, L, None)),
            ("K3 inter", lambda: lb.freq_inter_kernel(y1, img, opB, mask, L, 8,
                                                      dps1)),
            ("roll u", lambda: lb.roll(ur, -shift)),
            ("K2 LeFF", lambda: lb.ffn_kernel(u, *ln2, fop, 1e-6, dps2))]


def flagship_config(config, eval_dtype: str, **overrides):
    """The flagship's configuration; ``overrides`` may replace any field,
    the decoder's methods included."""
    fields = dict(encoder_type="Uformer", decoder_type="Uformer", L=3,
                  encoder_msa_type="freq", degradation_embedding_method=["all_DC"],
                  patch_size=P, eval_dtype=eval_dtype, seed=0)
    fields.update(overrides)
    return config.make_config(**fields)


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
    fused blocks' routes (a frequency block sees its L bands folded into the
    batch)."""
    counts = dict(ZERO)
    dtype = airnet.model_dtype(bundle.cfg)
    for net in (bundle.encoder, bundle.decoder):
        for m in net.modules():
            if not isinstance(m, uformer_lewin.LeWinBlock) or m.unfused:
                continue
            freq = m.msa_type == "freq"
            route = m.route(dtype, B * (m.L if freq else 1))
            if route == "merged":
                counts["freq_merged" if freq else "lewin_merged"] += 1
            elif route == "split":
                counts["lewin_attn_split"] += 1
                counts["lewin_ffn_split"] += 1
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
            COUNTERS.reset()
            got = airnet.eval_forward(bundle, x)
            torch.cuda.synchronize()
            counts = COUNTERS.read()
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
                     uformer_lewin, stats, dtype: str, method: str = "all_DC"):
    """Phase 5a, the main path: ``<port>.test.main`` on the card at flagship
    width and depth, synthetic test sets, weights from the seed, the default
    route; ``--eval_dtype`` left at its default (float32) or set to
    bfloat16, where the default route runs 4 blocks of a 16-tile forward
    merged. Phase 12a: the same with ``method=None``, no method flag: the
    CLI's default, ``residual``, whose blocks all stay fused."""
    tasks = ["denoising_bsd68_25", "deraining"]
    flags = [] if dtype == "float32" else ["--eval_dtype", dtype]
    if method is not None:
        flags += ["--degradation_embedding_method", method]
    with tempfile.TemporaryDirectory() as out:
        cfg = config.parse_args(
            ["--synthetic_data", "--test_de_type", *tasks, "--output_path",
             out + "/", "--epochs", "1", *flags])
        if cfg.eval_dtype != dtype:
            raise Failed(f"eval_dtype {cfg.eval_dtype!r}, wanted {dtype!r}")
        if method is None and cfg.degradation_embedding_method != ("residual",):
            raise Failed(f"the CLI's default method is "
                         f"{cfg.degradation_embedding_method}, not residual")
        torch.cuda.synchronize()
        COUNTERS.reset()
        t0 = time.perf_counter()
        rows = port_test.main(cfg)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = COUNTERS.read()
        with open(f"{out}/epoch_1_results.log") as f:
            log = f.read()
    print(f"eval entry point ({dtype}, {method or 'no method flag'}): "
          f"{len(tasks)} tasks in {secs:.3f} s, launches {counts}", flush=True)
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
    add_launches(stats, f"entry_{dtype}" + ("" if method else "_residual"),
                 counts)
    return rows


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
        COUNTERS.reset()
        t0 = time.perf_counter()
        outs[dtype, impl] = [tiling.restore_image(bundle, img) for img in imgs]
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = COUNTERS.read()
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
    x = torch.from_numpy(np.random.default_rng(2).random(
        (BATCH, P, P, 3), dtype=np.float32)).cuda()
    profile_forward(airnet, bundles.get("bfloat16", "default"), x,
                    "the flagship", card, top)


def profile_forward(airnet, bundle, x, label: str, card: str, top: int = 15):
    """One traced eval forward of ``bundle`` on ``x``: device time by
    kernel name, busy time against the untraced forward's."""
    profile_call(lambda: airnet.eval_forward(bundle, x),
                 f"{label} (bf16, B={x.shape[0]}; {card}): forward", top)


class LauncherRanges:
    """While active, every kernel launcher of the port's wrappers (their
    ``_run``) runs inside a profiler range named after its C entry point,
    so that a trace can add up each kernel's device time over all of its
    passes; measurement only, restored on exit."""

    def __init__(self, *modules):
        self.modules = [m for m in modules if hasattr(m, "_run")]
        self.saved = []

    def __enter__(self):
        from torch.profiler import record_function

        self.saved = [(m, m._run) for m in self.modules]
        for m, run in self.saved:
            def ranged(fn, *args, run=run):
                with record_function(fn.__name__):
                    run(fn, *args)
            m._run = ranged
        return self

    def __exit__(self, *exc):
        for m, run in self.saved:
            m._run = run


def profile_call(fn, label: str, top: int = 15):
    """One traced call of ``fn``: device time by kernel name, busy time
    against the untraced call's time by CUDA events, and the device time of
    each kernel of the port over all of its passes (its launcher's range)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as trace

    fwd = time_ms(fn, iters=5)
    with LauncherRanges(*COUNTERS.modules), trace(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    spans, by_name, ranges = [], {}, []
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        if e.name.startswith("fairm_"):  # a launcher's range on the device
            ranges.append((e.time_range.start, e.time_range.end, e.name))
            continue
        # device work only: a range such as Optimizer.step is annotated on
        # the device's timeline too
        if getattr(e, "is_user_annotation", False):
            continue
        t0, t1 = e.time_range.start, e.time_range.end   # microseconds
        spans.append((t0, t1))
        n, us = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, us + t1 - t0)
    print(f"profile of {label} {fwd:.2f} ms by CUDA events, untraced",
          flush=True)
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
          f"traced span, {1 - busy / 1e3 / fwd:.3f} of the untraced call)")
    for name, (n, us) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:top]:
        print(f"  {us / 1e3:9.3f} ms x {n:4d}  {name[:110]}")
    # each launcher's range holds only its own passes (one stream): the
    # device time of the kernels inside it
    starts, by_kernel = [t0 for t0, _ in spans], {}
    for r0, r1, name in ranges:
        i, us = bisect.bisect_left(starts, r0), 0.0
        while i < len(spans) and spans[i][0] < r1:
            us += min(spans[i][1], r1) - spans[i][0]
            i += 1
        n, total = by_kernel.get(name, (0, 0.0))
        by_kernel[name] = (n + 1, total + us)
    if by_kernel:
        print("  by kernel of the port, the device time of every pass of its "
              "launches (share of busy):")
        for name, (n, us) in sorted(by_kernel.items(), key=lambda kv: -kv[1][1]):
            print(f"  {us / 1e3:9.3f} ms x {n:4d}  {name} ({us / busy:.3f})")


# ---------------------------------------------------------------------------
# phase 8: the backward kernels
# ---------------------------------------------------------------------------


class BwdCase(NamedTuple):
    """One backward kernel at one shape: ``run()`` launches it, ``plain()``
    is its twin on the same inputs; both return the tuple of gradients."""
    kernel: str
    label: str
    run: Callable
    plain: Callable
    flops: float
    nbytes: int
    dims: tuple = ()     # K6: (rows M, C, heads, window tokens n)


def bwd_cases(lb, windows, dtype, B):
    """K6-K8 at flagship stage shapes and the training batch: the decoder's
    res 128 (C=56) and res 8 (C=896) blocks, the encoder's res 128 (C=28,
    L=3 bands) and res 8 (C=448) blocks; shifted and unshifted, with and
    without lam. The operations counted are the products' (the recomputed
    forward ones included); bytes: x and g read, dx written, weights read
    and their gradients written."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    dev, L, n = "cuda", 3, 64

    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale

    def attn_weights(C, h):
        d = C // h
        qkv = [rnd(h, C, d, scale=C ** -0.5) if i % 2 == 0 else
               rnd(h, d, scale=0.1) for i in range(6)]
        return qkv + [rnd(h, d, C, scale=C ** -0.5), rnd(C, scale=0.1)]

    def ln(C):
        return [1 + rnd(C, scale=0.1), rnd(C, scale=0.1)]

    def mask_of(res, shift):
        if not shift:
            return None
        return torch.from_numpy(windows.shift_attn_mask(res, res, 8, shift)).to(dev)

    def nbytes(x, *weights):
        return (3 * x.numel() * x.element_size()
                + 2 * sum(w.numel() * 4 for w in weights if w is not None))

    def attn_flops(M, C, keys):
        return 2.0 * M * C * (11 * C + 6 * keys)

    cases = []
    for res, C, h, shift, with_lam in ((128, 56, 1, 4, True),
                                       (128, 56, 1, 0, False),
                                       (8, 896, 16, 0, True)):
        x, g = rnd(B, res, res, C).to(dtype), rnd(B, res, res, C).to(dtype)
        args = [x, g, *ln(C), *attn_weights(C, h), rnd(h, n, n, scale=0.05),
                mask_of(res, shift), rnd(B, h, scale=0.3) if with_lam else None,
                8, 1e-6, True, 1]
        cases.append(BwdCase(
            "lewin_attn_bwd",
            f"attn_block_bwd res{res} C{C} h{h} shift{shift}"
            + (" lam" if with_lam else ""),
            lambda a=args: lb.attn_block_bwd(*a),
            lambda a=args: lb.attn_block_bwd_plain(*a),
            attn_flops(B * res * res, C, n), nbytes(x, *args[2:13]),
            (B * res * res, C, h, n)))
    for res, C, h, shift in ((128, 28, 1, 4), (8, 448, 16, 0)):
        LB = L * B
        x, g = rnd(LB, res, res, C).to(dtype), rnd(LB, res, res, C).to(dtype)
        aw, mask = attn_weights(C, h), mask_of(res, shift)
        args = [x, g, *ln(C), *aw, rnd(L, h, n, n, scale=0.05), mask, None, 8,
                1e-6, False, L]
        cases.append(BwdCase(
            "lewin_attn_bwd", f"intra bwd res{res} C{C} h{h} shift{shift} L{L}",
            lambda a=args: lb.attn_block_bwd(*a),
            lambda a=args: lb.attn_block_bwd_plain(*a),
            attn_flops(LB * res * res, C, n), nbytes(x, *args[2:13]),
            (LB * res * res, C, h, n)))
        args = [x, g, *aw, rnd(h, L * n, L * n, scale=0.05), mask, L, 8]
        cases.append(BwdCase(
            "freq_inter_bwd", f"freq_inter_bwd res{res} C{C} h{h} shift{shift} L{L}",
            lambda a=args: lb.freq_inter_bwd(*a),
            lambda a=args: lb.freq_inter_bwd_plain(*a),
            attn_flops(LB * res * res, C, L * n), nbytes(x, *args[2:11])))
    for images, res, C in ((B, 128, 56), (L * B, 128, 28), (B, 8, 896)):
        Hd = 4 * C
        x, g = rnd(images, res, res, C).to(dtype), rnd(images, res, res, C).to(dtype)
        args = [x, g, *ln(C), rnd(C, Hd, scale=C ** -0.5), rnd(Hd, scale=0.1),
                rnd(3, 3, Hd, scale=1 / 3), rnd(Hd, scale=0.1),
                rnd(Hd, C, scale=Hd ** -0.5), rnd(C, scale=0.1), 1e-6]
        M = images * res * res
        cases.append(BwdCase(
            "lewin_ffn_bwd", f"ffn_block_bwd res{res} C{C} images{images}",
            lambda a=args: lb.ffn_block_bwd(*a),
            lambda a=args: lb.ffn_block_bwd_plain(*a),
            2.0 * M * Hd * (5 * C + 27), nbytes(x, *args[2:10])))
    return cases


def compare_all(label, got, want, tol) -> float:
    """Every output against the twin's. Output 0 is dx, on the measure of the
    forward checks. The others are sums over all rows: each is measured
    against max(1, its own largest value, 1% of the largest value of any of
    them), because a sum that is zero in exact arithmetic (the k bias's
    gradient: the rows of the logits' gradient sum to zero) holds only the
    rounding of its terms, which grows with the rows and the terms' size."""
    if len(got) != len(want):
        raise Failed(f"{label}: {len(got)} outputs, the twin gives {len(want)}")
    floor = max([1.0] + [1e-2 * float(b.float().abs().max())
                         for b in want[1:] if b is not None])
    worst = 0.0
    for i, (a, b) in enumerate(zip(got, want)):
        if a is None or b is None:
            if a is not b:
                raise Failed(f"{label}: output {i} is None on one side only")
            continue
        worst = max(worst, compare(f"{label} #{i}", a, b, tol,
                                   floor if i else 1.0))
    return worst


def function_checks(lb, windows, dtype):
    """The autograd Functions on the card (forward kernel, backward
    kernels) against ``torch.autograd.grad`` of the plain forward twins:
    one decoder block (res 32, C=224, shifted, lam, DropPath) by the chain
    Functions and by BlockMerged, one encoder block (res 32, C=112, L=3) by
    the chain Functions and by BlockFreqMerged."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    B, L, n, res, shift = TRAIN_BATCH, 3, 64, 32, 4
    name_dt = str(dtype)[6:]

    def rnd(*shape, scale=1.0, grad=True):
        t = torch.randn(*shape, generator=gen, device="cuda") * scale
        return t.requires_grad_() if grad else t

    def attn_weights(C, h):
        d = C // h
        qkv = [rnd(h, C, d, scale=C ** -0.5) if i % 2 == 0 else
               rnd(h, d, scale=0.1) for i in range(6)]
        return qkv + [rnd(h, d, C, scale=C ** -0.5), rnd(C, scale=0.1)]

    def ln(C):
        return [(1 + rnd(C, scale=0.1, grad=False)).requires_grad_(),
                rnd(C, scale=0.1)]

    def ffn_weights(C):
        Hd = 4 * C
        return [rnd(C, Hd, scale=C ** -0.5), rnd(Hd, scale=0.1),
                rnd(3, 3, Hd, scale=1 / 3), rnd(Hd, scale=0.1),
                rnd(Hd, C, scale=Hd ** -0.5), rnd(C, scale=0.1)]

    def dps_of(count):
        return (torch.rand(count, generator=gen, device="cuda") < 0.7).float() / 0.7

    mask = torch.from_numpy(windows.shift_attn_mask(res, res, 8, shift)).cuda()
    tol = FUNCTION_TOL[dtype]

    C, h = 224, 4
    x = rnd(B, res, res, C, grad=False).to(dtype).requires_grad_()
    g = rnd(B, res, res, C, grad=False).to(dtype)
    ln1, aw, bias = ln(C), attn_weights(C, h), rnd(h, n, n, scale=0.05)
    lam, ln2, fw = rnd(B, h, scale=0.3), ln(C), ffn_weights(C)
    d1, d2 = dps_of(B), dps_of(B)
    ins = [x, *ln1, *aw, bias, lam, *ln2, *fw]
    args = [x, *ln1, *aw, bias, mask, lam, *ln2, *fw, 8, shift, 1e-6, d1, d2]
    want = torch.autograd.grad(lb.block_merged_plain(*args), ins, g)
    got = torch.autograd.grad(lb.BlockMerged.apply(*args), ins, g)
    compare_all(f"BlockMerged {name_dt} res{res} C{C}", got, want, tol)
    u = lb.roll(lb.BlockAttention.apply(lb.roll(x, shift), *ln1, *aw, bias, mask,
                                        lam, 8, 1e-6, d1), -shift)
    got = torch.autograd.grad(lb.BlockFFN.apply(u, *ln2, *fw, 1e-6, d2), ins, g)
    compare_all(f"BlockAttention + BlockFFN {name_dt} res{res} C{C}", got, want,
                tol)

    C, h, LB = 112, 4, L * B
    x = rnd(LB, res, res, C, grad=False).to(dtype).requires_grad_()
    g = rnd(LB, res, res, C, grad=False).to(dtype)
    ln1, ln2, fw = ln(C), ln(C), ffn_weights(C)
    awA, biasA = attn_weights(C, h), rnd(L, h, n, n, scale=0.05)
    # K3 reads the per-pair tables the grouped bias is made from; the
    # gradient is taken at the bias
    awB, pairsB = attn_weights(C, h), rnd(L * L, 225, h, scale=0.05,
                                          grad=False)
    biasB = lb.inter_bias(pairsB, L, 8).requires_grad_()
    d1, d2 = dps_of(LB), dps_of(LB)
    ins = [x, *ln1, *awA, biasA, *awB, biasB, *ln2, *fw]
    args = [x, *ln1, *awA, biasA, *awB, biasB, mask, *ln2, *fw, L, 8, shift,
            1e-6, d1, d2]
    want = torch.autograd.grad(lb.block_freq_merged_plain(*args), ins, g)
    got = torch.autograd.grad(lb.BlockFreqMerged.apply(*args, pairsB), ins, g)
    compare_all(f"BlockFreqMerged {name_dt} res{res} C{C}", got, want, tol)
    img = lb.roll(x, shift)
    y1 = lb.FreqIntra.apply(img, *ln1, *awA, biasA, mask, L, 8, 1e-6)
    u = lb.roll(lb.FreqInter.apply(y1, img, *awB, biasB, mask, L, 8, 1e-6, d1,
                                   pairsB), -shift)
    got = torch.autograd.grad(lb.BlockFFN.apply(u, *ln2, *fw, 1e-6, d2), ins, g)
    compare_all(f"FreqIntra + FreqInter + BlockFFN {name_dt} res{res} C{C}", got,
                want, tol)


# K7's table: (images, res, C) at the decoder's res-128 and res-16 stages
K7_SHAPES = ((128, 56), (16, 896))
K7_BATCHES = (TRAIN_BATCH, BATCH)


def k7_cases(lb, dtype, B):
    """K7 at the decoder's res 128 (C = 56) and res 16 (C = 896) stages,
    ``B`` images: each a BwdCase whose ``yardstick`` is ``torch.matmul``
    over the shapes of K7's five products in ``dtype`` (linear1 again,
    ``g W2^T``, ``a2^T g``, ``xn^T dh1``, ``dh1 W1^T``), on operands made
    once: a fixed measure of what the card's products cost, so that two
    calls on two cards compare K7's time over it."""
    gen = torch.Generator(device="cuda").manual_seed(8)
    out = []
    for res, C in K7_SHAPES:
        Hd, M = 4 * C, B * res * res

        def rnd(*shape, scale=1.0):
            return torch.randn(*shape, generator=gen, device="cuda") * scale

        x, g = rnd(B, res, res, C).to(dtype), rnd(B, res, res, C).to(dtype)
        args = [x, g, 1 + rnd(C, scale=0.1), rnd(C, scale=0.1),
                rnd(C, Hd, scale=C ** -0.5), rnd(Hd, scale=0.1),
                rnd(3, 3, Hd, scale=1 / 3), rnd(Hd, scale=0.1),
                rnd(Hd, C, scale=Hd ** -0.5), rnd(C, scale=0.1), 1e-6]
        mc, mh = rnd(M, C).to(dtype), rnd(M, Hd).to(dtype)
        wch, whc = rnd(C, Hd).to(dtype), rnd(Hd, C).to(dtype)

        def yardstick(mc=mc, mh=mh, wch=wch, whc=whc):
            torch.matmul(mc, wch)          # linear1
            torch.matmul(mc, whc.t())      # g W2^T
            torch.matmul(mh.t(), mc)       # dW2 = a2^T g
            torch.matmul(mc.t(), mh)       # dW1 = xn^T dh1
            torch.matmul(mh, wch.t())      # dh1 W1^T
        nbytes = (3 * x.numel() * x.element_size()
                  + 2 * 4 * sum(a.numel() for a in args[2:10]))
        out.append((BwdCase(
            "lewin_ffn_bwd", f"ffn_block_bwd res{res} C{C} images{B}",
            lambda a=args: lb.ffn_block_bwd(*a),
            lambda a=args: lb.ffn_block_bwd_plain(*a),
            2.0 * M * Hd * (5 * C + 27), nbytes), yardstick))
    return out


def k7_table(lb, card: str):
    """Phase 8b: K7 against its twin (every output, equal bits on a second
    launch) at bf16 / fp32 x B = 4 / 32 x res 128 / res 16, with its time
    beside the bound and the yardstick of its five products in
    ``torch.matmul`` (K7 / yardstick is the ratio two calls compare)."""
    print(f"K7 table: kernel ms, yardstick ms (torch.matmul over its five "
          f"products), bound ({card}):", flush=True)
    for dtype in (torch.bfloat16, torch.float32):
        name_dt = str(dtype)[6:]
        for B in K7_BATCHES:
            for case, yardstick in k7_cases(lb, dtype, B):
                label = f"{case.label} {name_dt}"
                got = case.run()
                torch.cuda.synchronize()
                compare_all(label, got, case.plain(), BWD_TOL[dtype])
                again = case.run()
                if not all(torch.equal(a, b) for a, b in zip(got, again)):
                    raise Failed(f"{label}: two launches give different bits")
                del got, again
                ms = time_ms(case.run, iters=5, warmup=1)
                yms = time_ms(yardstick, iters=5, warmup=1)
                t_bytes = case.nbytes / PEAK_BYTES * 1e3
                t_flops = case.flops / PEAK_FLOPS[dtype] * 1e3
                bound, by = max(t_bytes, t_flops), (
                    "bytes" if t_bytes >= t_flops else "operations")
                print(f"  K7 {label}: kernel {ms:.4f} ms, yardstick {yms:.4f} "
                      f"ms, kernel / yardstick {ms / yms:.3f}, bound "
                      f"{bound:.4f} ms by {by}", flush=True)
                torch.cuda.empty_cache()


def k6_yardstick(dims, dtype):
    """``torch.matmul`` over the shapes of K6's eleven products in
    ``dtype``, on operands made once: the qkv recompute, ``gw Wp^T``,
    ``out^T gw``, ``xw^T dqkv`` and ``dqkv Wqkv^T`` over the M rows, and
    per window and head the logits, ``p v``, ``dog v^T``, ``p^T dog``,
    ``dl k`` and ``dl^T q`` (batched over the windows and heads)."""
    M, C, h, n = dims
    gen = torch.Generator(device="cuda").manual_seed(9)
    rnd = lambda *shape: torch.randn(*shape, generator=gen,
                                     device="cuda").to(dtype)
    x, w3, wp, q = rnd(M, C), rnd(C, 3 * C), rnd(C, C), rnd(M // n * h, n, C // h)
    p = rnd(M // n * h, n, n)

    def run():
        qkv = torch.matmul(x, w3)              # qkv recompute
        torch.matmul(x, wp.t())                # dout = gw Wp^T
        torch.matmul(x.t(), x)                 # dWp = out^T gw
        torch.matmul(x.t(), qkv)               # dWqkv = xw^T dqkv
        torch.matmul(qkv, w3.t())              # dxw = dqkv Wqkv^T
        torch.matmul(q, q.transpose(-1, -2))   # logits
        torch.matmul(p, q)                     # og = p v
        torch.matmul(q, q.transpose(-1, -2))   # dp = dog v^T
        torch.matmul(p.transpose(-1, -2), q)   # dv = p^T dog
        torch.matmul(p, q)                     # dq = dl k
        torch.matmul(p.transpose(-1, -2), q)   # dk = dl^T q
    return run


def k6_table(lb, windows, card: str):
    """Phase 8c: K6 at the shapes of ``bwd_cases`` (the decoder block at res
    128, C = 56, and res 8, C = 896; the encoder's intra attention at res
    128, C = 28, 3 bands, and res 8, C = 448), bf16 / fp32 x B = 4 / 32:
    against its twin (every output, equal bits on a second launch), its
    time beside the plain version's, the bound, and the yardstick of
    :func:`k6_yardstick` (K6 / yardstick is the ratio two calls compare)."""
    print(f"K6 table: kernel ms, plain ms, yardstick ms (torch.matmul over "
          f"its eleven products), bound ({card}):", flush=True)
    for dtype in (torch.bfloat16, torch.float32):
        name_dt = str(dtype)[6:]
        for B in K7_BATCHES:
            for case in bwd_cases(lb, windows, dtype, B):
                if case.kernel != "lewin_attn_bwd":
                    continue
                label = f"{case.label} {name_dt} B{B}"
                got = case.run()
                torch.cuda.synchronize()
                compare_all(label, got, case.plain(), BWD_TOL[dtype])
                again = case.run()
                if not all(torch.equal(a, b) for a, b in zip(got, again)
                           if a is not None):
                    raise Failed(f"{label}: two launches give different bits")
                del got, again
                ms = time_ms(case.run, iters=5, warmup=1)
                pms = time_ms(case.plain, iters=2, warmup=1)
                yms = time_ms(k6_yardstick(case.dims, dtype), iters=5, warmup=1)
                t_bytes = case.nbytes / PEAK_BYTES * 1e3
                t_flops = case.flops / PEAK_FLOPS[dtype] * 1e3
                bound, by = max(t_bytes, t_flops), (
                    "bytes" if t_bytes >= t_flops else "operations")
                print(f"  K6 {label}: kernel {ms:.4f} ms, plain {pms:.4f} ms, "
                      f"yardstick {yms:.4f} ms, kernel / yardstick "
                      f"{ms / yms:.3f}, bound {bound:.4f} ms by {by}",
                      flush=True)
            torch.cuda.empty_cache()


# K8's table: (res, C, heads, shift) of the encoder's inter attention, L = 3
# bands of 8 x 8 windows grouped into 192 tokens; at res 8 one window covers
# the image
K8_SHAPES = ((128, 28, 1, 0), (128, 28, 1, 4), (8, 448, 16, 0))


def k8_cases(lb, windows, dtype, B):
    """K8 at :data:`K8_SHAPES` on ``B`` images of 3 bands: each a BwdCase
    whose ``dims`` (rows, C, heads, 192 tokens) give :func:`k6_yardstick`
    the shapes of K8's eleven products (those of K6 at 192 tokens a
    window). Operations and bytes are counted as in :func:`bwd_cases`."""
    gen = torch.Generator(device="cuda").manual_seed(10)
    L, n = 3, 64

    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device="cuda") * scale

    out = []
    for res, C, h, shift in K8_SHAPES:
        LB, d, M = L * B, C // h, L * B * res * res
        x, g = rnd(LB, res, res, C).to(dtype), rnd(LB, res, res, C).to(dtype)
        aw = [rnd(h, C, d, scale=C ** -0.5) if i % 2 == 0 else
              rnd(h, d, scale=0.1) for i in range(6)]
        aw += [rnd(h, d, C, scale=C ** -0.5), rnd(C, scale=0.1)]
        mask = (torch.from_numpy(windows.shift_attn_mask(res, res, 8, shift))
                .cuda() if shift else None)
        args = [x, g, *aw, rnd(h, L * n, L * n, scale=0.05), mask, L, 8]
        weights = [w for w in args[2:11] if w is not None]
        out.append(BwdCase(
            "freq_inter_bwd",
            f"freq_inter_bwd res{res} C{C} h{h} shift{shift} L{L} B{B}",
            lambda a=args: lb.freq_inter_bwd(*a),
            lambda a=args: lb.freq_inter_bwd_plain(*a),
            2.0 * M * C * (11 * C + 6 * L * n),
            3 * x.numel() * x.element_size() + 8 * sum(w.numel() for w in weights),
            (M, C, h, L * n)))
    return out


def k8_table(lb, windows, card: str):
    """Phase 8d: K8 at :data:`K8_SHAPES`, bf16 / fp32 x B = 4 / 32: against
    its twin (every output, equal bits on a second launch), its time beside
    the plain version's, the bound and the yardstick of
    :func:`k6_yardstick` (K8 / yardstick is the ratio two calls compare),
    and the bytes of workspace the kernel asks for."""
    from frequency_wised_all_in_one_image_restoration_model_tpu_torch.ops.kernels import (
        build)

    print(f"K8 table: kernel ms, plain ms, yardstick ms (torch.matmul over "
          f"its eleven products), bound, workspace ({card}):", flush=True)
    for dtype in (torch.bfloat16, torch.float32):
        name_dt = str(dtype)[6:]
        for B in K7_BATCHES:
            for case, (res, C, h, _) in zip(k8_cases(lb, windows, dtype, B),
                                            K8_SHAPES):
                label = f"{case.label} {name_dt}"
                got = case.run()
                torch.cuda.synchronize()
                compare_all(label, got, case.plain(), BWD_TOL[dtype])
                again = case.run()
                if not all(torch.equal(a, b) for a, b in zip(got, again)):
                    raise Failed(f"{label}: two launches give different bits")
                del got, again
                ms = time_ms(case.run, iters=5, warmup=1)
                pms = time_ms(case.plain, iters=2, warmup=1)
                yms = time_ms(k6_yardstick(case.dims, dtype), iters=5, warmup=1)
                ws = build.load().fairm_freq_inter_bwd_ws(
                    3 * B, res, res, C, h, 8, 3, int(dtype == torch.bfloat16))
                t_bytes = case.nbytes / PEAK_BYTES * 1e3
                t_flops = case.flops / PEAK_FLOPS[dtype] * 1e3
                bound, by = max(t_bytes, t_flops), (
                    "bytes" if t_bytes >= t_flops else "operations")
                print(f"  K8 {label}: kernel {ms:.4f} ms, plain {pms:.4f} ms, "
                      f"yardstick {yms:.4f} ms, kernel / yardstick "
                      f"{ms / yms:.3f}, bound {bound:.4f} ms by {by}, "
                      f"workspace {ws / 2 ** 20:.2f} MiB", flush=True)
                torch.cuda.empty_cache()


def check_bwd_kernels(lb, windows, stats, card: str):
    """Phase 8: K6-K8 against their twins (bf16 and fp32 at B=4, bf16 at
    B=32), the Functions, then the tables of K7, K6 and K8. The kernels line takes each
    kernel's first (res-128) case in bf16 at B=4."""
    for dtype, B in ((torch.bfloat16, TRAIN_BATCH), (torch.float32, TRAIN_BATCH),
                     (torch.bfloat16, BATCH)):
        name_dt = str(dtype)[6:]
        print(f"backward kernel checks, {dtype}, B={B} ({card}):", flush=True)
        for case in bwd_cases(lb, windows, dtype, B):
            label = f"{case.label} {name_dt}"
            got = case.run()
            torch.cuda.synchronize()
            want = case.plain()
            err = compare_all(label, got, want, BWD_TOL[dtype])
            again = case.run()
            if not all(torch.equal(a, b) for a, b in zip(got, again)
                       if a is not None):
                raise Failed(f"{label}: two launches give different bits")
            del want, again
            st = stats[case.kernel]
            st["max_abs_err"] = max(st["max_abs_err"], err)
            ms = time_ms(case.run, iters=5, warmup=1)
            pms = time_ms(case.plain, iters=3, warmup=1)
            t_bytes = case.nbytes / PEAK_BYTES * 1e3
            t_flops = case.flops / PEAK_FLOPS[dtype] * 1e3
            bound, by = max(t_bytes, t_flops), (
                "bytes" if t_bytes >= t_flops else "operations")
            print(f"    time: kernel {ms:.4f} ms, plain {pms:.4f} ms, bound "
                  f"{bound:.4f} ms by {by}; equal bits on a second launch",
                  flush=True)
            if dtype == torch.bfloat16 and st["ms"] is None:
                st.update(ms=ms, plain_ms=pms, bound_ms=bound, bound_by=by)
            del got
            torch.cuda.empty_cache()
        if B == TRAIN_BATCH:
            function_checks(lb, windows, dtype)
    k7_table(lb, card)
    k6_table(lb, windows, card)
    k8_table(lb, windows, card)


# ---------------------------------------------------------------------------
# phase 9: training
# ---------------------------------------------------------------------------


def training_entry_point(config, port_train, lb, stats):
    """Phase 9a, the main path of the training slice: ``<port>.train.main``
    on the card at flagship width and depth, the CLI's batch (4 tasks),
    bfloat16, the synthetic loader: two phase-A steps, two joint steps, the
    eval of two tasks after the joint epoch, the final and best
    checkpoints."""
    tasks = ["denoising_bsd68_25", "deraining"]
    with tempfile.TemporaryDirectory() as out:
        cfg = config.parse_args(
            ["--synthetic_data", "--degradation_embedding_method", "all_DC",
             "--test_de_type", *tasks, "--output_path", out + "/",
             "--epochs", "2", "--epochs_encoder", "1", "--steps_per_epoch", "2"])
        if (cfg.batch_size, cfg.dtype, cfg.patch_size) != (TRAIN_BATCH,
                                                          "bfloat16", P):
            raise Failed(f"training config {cfg.batch_size} {cfg.dtype} "
                         f"{cfg.patch_size}")
        seen = []
        torch.cuda.synchronize()
        COUNTERS.reset()
        t0 = time.perf_counter()
        state = port_train.main(cfg, progress=lambda e, m: seen.append((e, m)))
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = COUNTERS.read()
        with open(f"{out}/train.log") as f:
            train_log = f.read()
        with open(f"{out}/results.log") as f:
            results_log = f.read()
        files = sorted(os.listdir(f"{out}/ckpt"))
        ckpt = torch.load(f"{out}/ckpt/epoch_2.pt", map_location="cpu",
                          weights_only=True)
    print(f"training entry point (bfloat16, B={TRAIN_BATCH}): 2 + 2 steps, "
          f"eval of {len(tasks)} tasks and checkpoints in {secs:.3f} s, "
          f"launches {counts}", flush=True)
    print("  train.log: " + train_log.replace("\n", " | "), flush=True)
    print("  results.log: " + results_log.replace("\n", " | "), flush=True)
    (e0, m0), (e1, m1) = seen
    for m in (m0, m1):
        if not all(math.isfinite(v) for v in m.values()):
            raise Failed(f"non-finite training metrics {m}")
    want_log = ("Epoch (0)  Loss: contrast_loss:%0.4f\n" % m0["contrast_loss"]
                + "Epoch (1)  Loss: l1_loss:%0.4f contrast_loss:%0.4f\n" % (
                    m1["l1_loss"], m1["contrast_loss"]))
    if (e0, e1) != (0, 1) or train_log != want_log or m1["l1_loss"] <= 0:
        raise Failed(f"train.log {train_log!r} != {want_log!r}")
    lines = results_log.splitlines()
    if (len(lines) != 1 + len(tasks) or lines[0] != "2 Epochs Results:"
            or any(not ln.startswith(t + ": ") or "PSNR/SSIM: " not in ln
                   for t, ln in zip(tasks, lines[1:]))):
        raise Failed(f"results.log {results_log!r}")
    if files != ["best.pt", "epoch_2.pt"]:
        raise Failed(f"checkpoints {files}")
    ts = ckpt["train_state"]
    if (state.step, ts["step"], int(ts["queue_ptr"]), ts["optimizer"]["count"]
            ) != (4, 4, 4 * TRAIN_BATCH % (3 * TRAIN_BATCH), 4):
        raise Failed(f"after 4 steps: step {state.step} / {ts['step']}, queue "
                     f"pointer {int(ts['queue_ptr'])}, Adam count "
                     f"{ts['optimizer']['count']}")
    moved = max(float((ts["encoder_k"][k].float() - ckpt["encoder"][k].float())
                      .abs().max()) for k in ckpt["encoder"]
                if k.endswith("weight"))
    if not 0.0 < moved < 1.0:
        raise Failed(f"key encoder against query encoder: max difference {moved}")
    print(f"  step 4, queue pointer {int(ts['queue_ptr'])}, key encoder within "
          f"{moved:.3e} of the query encoder, checkpoints {files}", flush=True)
    eval_counts = default_counts("bfloat16", ENTRY_BATCH)
    want = {k: 2 * train_step_counts(False)[k] + 2 * train_step_counts(True)[k]
            + len(tasks) * eval_counts[k] for k in ZERO}
    if counts != want:
        raise Failed(f"training entry point launch counts {counts} != {want}")
    add_launches(stats, "train_entry_bfloat16", counts)


def fresh_state(config, airnet, train_state, dtype: str, impl: str, batch: int,
                fields=None):
    """A train state of the flagship, or of the configuration ``fields``
    (its offset heads and lamb made live), from seed 0."""
    cfg = flagship_config(config, "float32", dtype=dtype, synthetic_data=True,
                          **(fields or {}))
    if batch != cfg.batch_size:
        cfg = dataclasses.replace(cfg, batch_size=batch)
    bundle = airnet.build_models(cfg, "cuda", impl, eval_mode=False)
    if fields:
        liven(bundle)
    return cfg, bundle, train_state.create_train_state(cfg, bundle)


def train_batch(cfg, synthetic, steps_lib, batch: int):
    loader = synthetic.SyntheticTrainLoader(cfg, seed=0)
    one = steps_lib.array_batch(loader.next_batch(), "cuda")
    reps = batch // one["d1"].shape[0]
    return {k: v.repeat(reps, *([1] * (v.dim() - 1))) for k, v in one.items()}


def step_against_plain(config, airnet, train_state, steps_lib, synthetic,
                       name: str = "flagship", fields=None, counts=None):
    """Phase 9b (the flagship) and 12c (the per-scale set, ``fields``): one
    joint step (forward + backward) from the same state by the default
    route (kernels) and by the plain route (twins, autograd): the loss and
    every parameter's gradient; ``counts`` the default route's launches in
    bf16 (float32 runs every fused block by the chain)."""
    counts_bf16 = counts or train_step_counts(True)
    for dtype in ("float32", "bfloat16"):
        runs = {}
        for impl in ("default", "plain"):
            cfg, bundle, state = fresh_state(config, airnet, train_state, dtype,
                                             impl, TRAIN_BATCH, fields)
            batch = train_batch(cfg, synthetic, steps_lib, TRAIN_BATCH)
            step = steps_lib.make_train_step(cfg, bundle, joint=True,
                                             upto="grads")
            COUNTERS.reset()
            _, m = step(state, batch)
            torch.cuda.synchronize()
            counts = COUNTERS.read()
            grads = {f"{net}.{n}": p.grad.float().clone()
                     for net in ("encoder", "decoder")
                     for n, p in getattr(state, net).named_parameters()
                     if p.grad is not None}
            runs[impl] = (float(m["loss"]), grads, counts)
            del state, bundle
        (loss, grads, counts), (loss_p, grads_p, counts_p) = (runs["default"],
                                                             runs["plain"])
        want = dict(counts_bf16)
        if dtype == "float32":  # float32 keeps the chain for every block
            k4 = want["lewin_merged"]
            want.update(lewin_attn=want["lewin_attn"] + k4,
                        lewin_ffn=want["lewin_ffn"] + k4, lewin_merged=0)
        if counts != want or any(counts_p.values()):
            raise Failed(f"joint step launches {counts} (plain route "
                         f"{counts_p}), expected {want}")
        if set(grads) != set(grads_p):
            raise Failed("the two routes reach different parameters")
        gmax = max(float(g.abs().max()) for g in grads_p.values())
        worst, worst_name = 0.0, ""
        for pname, gp in grads_p.items():
            g = grads[pname]
            if not torch.isfinite(g).all():
                raise Failed(f"{pname}: non-finite gradient")
            rel = float((g - gp).abs().max()) / max(float(gp.abs().max()),
                                                    1e-3 * gmax)
            if rel > worst:
                worst, worst_name = rel, pname
        num = sum(float((grads[k] * grads_p[k]).sum()) for k in grads)
        den = math.sqrt(sum(float((grads[k] ** 2).sum()) for k in grads)
                        * sum(float((grads_p[k] ** 2).sum()) for k in grads))
        ok = (abs(loss - loss_p) <= STEP_LOSS_TOL[dtype]
              and worst <= STEP_GRAD_TOL[dtype])
        print(f"joint step {name} {dtype}, default against plain route: loss "
              f"{loss:.6f} / {loss_p:.6f} (limit {STEP_LOSS_TOL[dtype]}), "
              f"{len(grads)} gradients, worst max|g - g_plain| / "
              f"max(max|g_plain|, 1e-3 max|g|) = {worst:.3e} at {worst_name} "
              f"(limit {STEP_GRAD_TOL[dtype]}), cosine {num / den:.6f}, "
              f"launches {counts} {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise Failed(f"joint step {name} {dtype}: the kernel route "
                         "disagrees with the plain route")


def step_times(config, airnet, train_state, steps_lib, synthetic, card: str,
               name: str = "flagship", fields=None,
               runs_of=(("bfloat16", "default", TRAIN_BATCH),
                        ("bfloat16", "plain", TRAIN_BATCH),
                        ("float32", "default", TRAIN_BATCH),
                        ("float32", "plain", TRAIN_BATCH),
                        ("bfloat16", "default", BATCH))):
    """Phase 9c: ms per joint step and per phase-A step, and the split of
    the joint step (forward = ``upto='loss'``, backward = ``'grads'`` -
    ``'loss'``, optimizer + EMA + enqueue = ``'full'`` - ``'grads'``), by
    CUDA events. Every variant is warmed up by one step first (the
    allocator's pool grows with the first backward), then timed twice over
    two steps, forwards and back (no more: the script's time limit); the
    split is taken from each variant's lower time and both are shown."""
    variants = ((True, "loss"), (True, "grads"), (True, "full"), (False, "full"))
    torch.cuda.reset_peak_memory_stats()
    for dtype, impl, batch in runs_of:
        try:
            cfg, bundle, state = fresh_state(config, airnet, train_state, dtype,
                                             impl, batch, fields)
            data = train_batch(cfg, synthetic, steps_lib, batch)
            steps = {v: steps_lib.make_train_step(cfg, bundle, joint=v[0],
                                                  upto=v[1]) for v in variants}
            for v in variants:
                steps[v](state, data)
            runs = {v: [] for v in variants}
            for v in variants + variants[::-1]:
                runs[v].append(time_ms(lambda: steps[v](state, data), iters=2,
                                       warmup=0))
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
        except torch.cuda.OutOfMemoryError:
            print(f"step time {name} {dtype} {impl} B={batch}: does not fit "
                  "the card's memory", flush=True)
            continue
        finally:
            state = bundle = data = steps = None
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        ms = {v: min(t) for v, t in runs.items()}
        full, fwd, grads = ms[True, "full"], ms[True, "loss"], ms[True, "grads"]
        both = ", ".join(f"{'joint' if j else 'phase-A'} {u} "
                         f"{t[0]:.2f} / {t[1]:.2f}" for (j, u), t in runs.items())
        print(f"step time {name} {dtype} {impl} B={batch} ({card}): joint step "
              f"{full:.2f} ms = forward {fwd:.2f} + backward {grads - fwd:.2f} "
              f"+ optimizer {full - grads:.2f} (backward / forward "
              f"{(grads - fwd) / fwd:.2f}), {batch * P * P / full / 1e3:.4f} "
              f"trained MP/s; phase-A step {ms[False, 'full']:.2f} ms; peak "
              f"memory {peak:.2f} GiB; both runs, ms: {both}", flush=True)


# ---------------------------------------------------------------------------
# phase 10: the kernels of the decoder's injection methods
# ---------------------------------------------------------------------------


# (n, nk, d, heads at res 128, heads at res 8, what runs it): the window
# attention's three shapes on the main path
WINDOW_SHAPES = (
    (64, 64, 56, 2, 16, "decoder block"),
    (64, 192, 56, 2, 16, "decoder block, attention_kv"),
    (192, 192, 28, 1, 16, "encoder need_kv block, 3 bands"),
)
# K9's launches in one eval forward of the per-scale set, by the phase-10
# case they match ((n, nk, res, shift); counted on its forward): the decoder
# runs attention_kv's (64, 192) in every unfused block, the encoder (192,
# 192) in its need_kv blocks (the shifted last block of each stage)
K9_PER_SCALE_LAUNCHES = {(64, 64, 128, 0): 0, (64, 64, 128, 4): 0,
                         (64, 64, 8, 0): 0, (64, 192, 128, 0): 1,
                         (64, 192, 128, 4): 1, (64, 192, 8, 0): 6,
                         (192, 192, 128, 0): 0, (192, 192, 128, 4): 2,
                         (192, 192, 8, 0): 2}
# the deform_conv LeFF's DCN at every stage it runs, then DGRN's behind the
# ResNet encoder (C = 64) and behind the ViT (C = 3): (res, C)
DCN_STAGES = ((128, 112), (64, 224), (32, 448), (16, 896), (8, 896),
              (128, 64), (128, 3))


class AttnCase(NamedTuple):
    label: str
    q: torch.Tensor
    k: torch.Tensor
    v: torch.Tensor
    bias: torch.Tensor
    mask: Optional[torch.Tensor]
    scale: float
    nW: int


def window_cases(windows, dtype, B, strided=False):
    """K9 / K10 at the main path's shapes: each (n, nk, d) at res 128,
    shifted and not, and at res 8; B images, so B * (res / 8)^2 windows.
    With ``strided``, the operands as the unfused blocks hand them to K9:
    q / k / v views of the projections' outputs (the decoder's ``to_q`` /
    ``to_kv`` or ``attention_kv``'s ``to_k`` / ``to_v`` ``[B', n, h d]``, the
    encoder's band-major ``[L, B'/L, 64, h d]``), the bias one window's
    ``[h, n, 64]`` (the encoder's grouped ``[h, 192, 192]``), the SW-MSA mask
    one window's ``[nW, 64, 64]``; else contiguous ``[W, h, n, d]`` operands
    and the tables tiled to ``[n, nk]``, the form every K9 takes."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    rnd = lambda *shape, scale=1.0: torch.randn(
        *shape, generator=gen, device="cuda") * scale
    cases = []
    for n, nk, d, h128, h8, what in WINDOW_SHAPES:
        for res, h, shift in ((128, h128, 0), (128, h128, 4), (8, h8, 0)):
            nW = (res // 8) ** 2
            W, C = B * nW, h * d
            mask = None
            if shift:
                mask = torch.from_numpy(
                    windows.shift_attn_mask(res, res, 8, shift)).cuda()
            bias = rnd(h, n, nk if n == 192 else 64, scale=0.5)
            label = (f"window_attn n{n} nk{nk} d{d} h{h} res{res} shift{shift} "
                     f"({what}; {'strided' if strided else 'contiguous'})")
            if not strided:
                tile = lambda t: None if t is None else t.repeat(
                    1, n // t.shape[1], nk // t.shape[2])
                cases.append(AttnCase(
                    label, rnd(W, h, n, d).to(dtype), rnd(W, h, nk, d).to(dtype),
                    rnd(W, h, nk, d).to(dtype), tile(bias), tile(mask),
                    d ** -0.5, nW))
                continue
            split = lambda t: t.reshape(W, t.shape[1], h, d).permute(0, 2, 1, 3)
            if n == 192:  # the encoder: bands major, 64 tokens a band
                L = n // 64
                band = lambda t: t.reshape(L, W, 64, h, d).permute(1, 3, 0, 2, 4)
                xq, xkv = rnd(L, W, 64, C).to(dtype), rnd(L, W, 64, 2 * C).to(dtype)
                q, k, v = band(xq), band(xkv[..., :C]), band(xkv[..., C:])
            elif nk == n:  # to_q and to_kv
                xq, xkv = rnd(W, n, C).to(dtype), rnd(W, n, 2 * C).to(dtype)
                q, k, v = split(xq), split(xkv[..., :C]), split(xkv[..., C:])
            else:  # attention_kv: to_k and to_v on the encoder's K / V
                q = split(rnd(W, n, C).to(dtype))
                k, v = split(rnd(W, nk, C).to(dtype)), split(rnd(W, nk, C).to(dtype))
            cases.append(AttnCase(label, q, k, v, bias, mask, d ** -0.5, nW))
    return cases


def joined(c: AttnCase) -> AttnCase:
    """The case as K10 and ``scaled_dot_product_attention`` take it:
    contiguous ``[W, h, n, d]`` operands, the tables tiled to ``[n, nk]``."""
    flat = lambda t: t.reshape(t.shape[0], t.shape[1], -1, t.shape[-1]).contiguous()
    q, k, v = flat(c.q), flat(c.k), flat(c.v)
    n, nk = q.shape[2], k.shape[2]
    tile = lambda t: None if t is None else t.repeat(
        1, n // t.shape[1], nk // t.shape[2])
    return c._replace(q=q, k=k, v=v, bias=tile(c.bias), mask=tile(c.mask))


def attn_bound(c: AttnCase, dtype, backward: bool):
    """Bytes: q, k, v (and g) read, bias and mask read, the outputs written
    once; operations: the two products forward, five backward."""
    W, h, d = c.q.shape[0], c.q.shape[1], c.q.shape[-1]
    n = c.q.numel() // (W * h * d)
    nk = c.k.numel() // (W * h * d)
    size = c.q.element_size()
    qkv = (W * h * n * d + 2 * W * h * nk * d) * size
    tables = c.bias.numel() * 4 + (0 if c.mask is None else c.mask.numel() * 4)
    if backward:
        nbytes = 2 * qkv + W * h * n * d * size + 2 * tables
        flops = 5 * 2.0 * W * h * n * nk * d
    else:
        nbytes = qkv + tables + W * h * n * d * size
        flops = 2 * 2.0 * W * h * n * nk * d
    t_bytes, t_flops = nbytes / PEAK_BYTES * 1e3, flops / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_flops), "bytes" if t_bytes >= t_flops else "operations"


def sdpa_inputs(c: AttnCase):
    """The case as ``scaled_dot_product_attention`` takes it: windows split
    into (images, windows per image), the additive bias + mask broadcast."""
    c = joined(c)
    W, h, n, d = c.q.shape
    split = lambda t: t.reshape(W // c.nW, c.nW, h, t.shape[2], d)
    add = c.bias[None, None]
    if c.mask is not None:
        add = add + c.mask[None, :, None]
    return split(c.q), split(c.k), split(c.v), add.to(c.q.dtype)


def library_attention_ms(c: AttnCase, backward: bool):
    """One ``scaled_dot_product_attention`` call (forward), or the autograd
    backward of one (q, k, v and the bias take gradients); None where it
    does not run at this shape."""
    import torch.nn.functional as F
    try:
        q, k, v, add = sdpa_inputs(c)
        if not backward:
            return time_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=add, scale=c.scale), iters=5)
        c = joined(c)
        ins = [t.detach().requires_grad_() for t in (q, k, v)]
        bias = c.bias.detach().requires_grad_()
        add = bias[None, None] + (0 if c.mask is None else c.mask[None, :, None])
        out = F.scaled_dot_product_attention(*ins, attn_mask=add.to(q.dtype),
                                             scale=c.scale)
        g = torch.ones_like(out)
        return time_ms(lambda: torch.autograd.grad(
            out, ins + [bias], g, retain_graph=True), iters=3, warmup=1)
    except RuntimeError as e:
        print(f"    library call does not run here: {str(e)[:120]}", flush=True)
        return None


def check_window_attention(wa, windows, stats, card: str):
    """K9 against ``window_attention_plain`` on the strided operands and the
    untiled tables the unfused blocks hand it, and K10 against
    ``window_attention_bwd_plain`` on the joined, tiled ones, at every case,
    bf16 at the eval batch (B=32) and the training batch (B=4) and fp32 at
    B=4 (the kernels line takes K10 at B=4); K9's time beside the plain
    version's, SDPA's, the bound and its launches in a per-scale-set eval
    forward x (time - bound); K10's dbias on the floor rule of the backward
    checks, and equal bits on a second launch."""
    for dtype, B, fwd, bwd in ((torch.bfloat16, BATCH, True, True),
                               (torch.bfloat16, TRAIN_BATCH, True, True),
                               (torch.float32, TRAIN_BATCH, True, True)):
        name_dt = str(dtype)[6:]
        print(f"window attention checks, {name_dt}, B={B} ({card}):", flush=True)
        for c in window_cases(windows, dtype, B, strided=True):
            label = f"{c.label} {name_dt} B{B}"
            args = (c.q, c.k, c.v, c.bias, c.mask, c.scale, c.nW)
            if fwd:
                got = wa.window_attention_kernel(*args)
                torch.cuda.synchronize()
                err = compare(label, got, wa.window_attention_plain(*args),
                              KERNEL_TOL[dtype])
                ms = time_ms(lambda: wa.window_attention_kernel(*args))
                pms = time_ms(lambda: wa.window_attention_plain(*args), iters=3)
                lms = library_attention_ms(c, False)
                bound, by = attn_bound(c, dtype, False)
                n = c.q.numel() // (c.q.shape[0] * c.q.shape[1] * c.q.shape[-1])
                nk = c.k.numel() // (c.k.shape[0] * c.k.shape[1] * c.k.shape[-1])
                res = 8 * int(round(c.nW ** 0.5))
                runs = K9_PER_SCALE_LAUNCHES[(n, nk, res, 0 if c.mask is None
                                              else 4)]
                print(f"    time: kernel {ms:.4f} ms, plain {pms:.4f} ms, "
                      f"scaled_dot_product_attention "
                      f"{'-' if lms is None else f'{lms:.4f}'} ms, bound "
                      f"{bound:.4f} ms by {by}; {runs} launches a per-scale-set "
                      f"forward x (time - bound) {runs * (ms - bound):.3f} ms",
                      flush=True)
                st = stats["window_attn"]
                st["max_abs_err"] = max(st["max_abs_err"], err)
                if dtype == torch.bfloat16 and st["ms"] is None:
                    st.update(ms=ms, plain_ms=pms, bound_ms=bound, bound_by=by,
                              library_ms=lms)
                del got
            if bwd:
                c = joined(c)
                g = torch.randn(c.q.shape, device="cuda", generator=torch.Generator(
                    device="cuda").manual_seed(4)).to(dtype)
                bargs = (c.q, c.k, c.v, c.bias, c.mask, g, c.scale, c.nW)
                got = wa.window_attention_bwd_kernel(*bargs)
                torch.cuda.synchronize()
                err = compare_all(f"{label} bwd", got,
                                  wa.window_attention_bwd_plain(*bargs),
                                  BWD_TOL[dtype])
                again = wa.window_attention_bwd_kernel(*bargs)
                if not all(torch.equal(a, b) for a, b in zip(got, again)):
                    raise Failed(f"{label} bwd: two launches give different bits")
                ms = time_ms(lambda: wa.window_attention_bwd_kernel(*bargs),
                             iters=5, warmup=1)
                pms = time_ms(lambda: wa.window_attention_bwd_plain(*bargs),
                              iters=3, warmup=1)
                lms = library_attention_ms(c, True)
                bound, by = attn_bound(c, dtype, True)
                ratio = "" if lms is None else f", kernel / library {ms / lms:.3f}"
                print(f"    backward time: kernel {ms:.4f} ms, plain {pms:.4f} "
                      f"ms, scaled_dot_product_attention backward "
                      f"{'-' if lms is None else f'{lms:.4f}'} ms{ratio}, bound "
                      f"{bound:.4f} ms by {by}; equal bits on a second launch",
                      flush=True)
                st = stats["window_attn_bwd"]
                st["max_abs_err"] = max(st["max_abs_err"], err)
                if dtype == torch.bfloat16 and B == TRAIN_BATCH \
                        and st["ms"] is None:
                    st.update(ms=ms, plain_ms=pms, bound_ms=bound, bound_by=by,
                              library_ms=lms)
                del got, again


def check_window_function(wa, windows, dtype):
    """``WindowAttentionFn`` (K9 forward, K10 backward) against autograd of
    the plain forward, at the attention_kv shape of res 128, shifted (B=4)."""
    c = [c for c in window_cases(windows, dtype, TRAIN_BATCH, strided=True)
         if c.k.shape[2] == 192 and c.q.shape[2] == 64][1]
    ins = [t.detach().requires_grad_() for t in (c.q, c.k, c.v, c.bias)]
    g = torch.randn(c.q.shape, device="cuda", generator=torch.Generator(
        device="cuda").manual_seed(5)).to(dtype)
    want = torch.autograd.grad(wa.window_attention_plain(
        *ins, c.mask, c.scale, c.nW), ins, g)
    got = torch.autograd.grad(wa.WindowAttentionFn.apply(
        *ins, c.mask, c.scale, c.nW), ins, g)
    compare_all(f"WindowAttentionFn {str(dtype)[6:]} {c.label}", got, want,
                FUNCTION_TOL[dtype])


def check_dcn(dc, stats, card: str):
    """K11 against ``dcn_plain`` at every deform_conv stage shape and DGRN's
    (res 128, C = 64), bf16 at B=32 by both routes (the one ``dcn_path``
    chooses first) and fp32 at B=4, exact and with offsets clamped to 2;
    offsets up to +-3.5 pixels, past every edge of the image; each row with
    the device memory a launch takes beyond its output (none for the
    implicit GEMM, a column matrix for the column route); then ``DCNFn``'s
    gradients against autograd of the plain version at res 32."""
    gen = torch.Generator(device="cuda").manual_seed(6)
    for dtype, B in ((torch.bfloat16, BATCH), (torch.float32, TRAIN_BATCH)):
        name_dt = str(dtype)[6:]
        print(f"DCN checks, {name_dt}, B={B} ({card}):", flush=True)
        for res, C in DCN_STAGES:
            x = (torch.randn(B, res, res, C, generator=gen, device="cuda")
                 * 0.5).to(dtype)
            off = (torch.rand(B, res, res, 18, generator=gen, device="cuda")
                   * 7 - 3.5).to(dtype)
            mask = torch.rand(B, res, res, 9, generator=gen,
                              device="cuda").to(dtype)
            w = (torch.randn(3, 3, C, C, generator=gen, device="cuda")
                 * (9 * C) ** -0.5).to(dtype)
            default = dc.dcn_path(C, C, dtype)
            paths = [default] + [p for p in ("implicit", "columns")
                                 if p != default and dtype == torch.bfloat16]
            for clamp, path in itertools.product((None, 2.0), paths):
                label = (f"dcn res{res} C{C} {'exact' if clamp is None else 'clamp 2'}"
                         f" {name_dt} B{B} {path}"
                         f"{' (default)' if path == default else ''}")
                run = lambda: dc.dcn_kernel(x, off, mask, w, None, 1, 1, clamp,
                                            path)
                torch.cuda.synchronize()
                base = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                got = run()
                torch.cuda.synchronize()
                # the device memory a launch takes beyond its output and the
                # launcher's fp32 copies of the offsets and the mask (its
                # weight operand; on the column route the column matrix),
                # against the bytes a column matrix [B res^2, kpad(9C)]
                # takes in x's type
                extra = (torch.cuda.max_memory_allocated() - base
                         - got.numel() * got.element_size()
                         - 4 * (off.numel() + mask.numel()))
                cols = B * res * res * ((9 * C + 31) // 32 * 32) * x.element_size()
                plain = lambda: dc.dcn_plain(x, off, mask, w, None, 1, 1, clamp)
                err = compare(label, got, plain(), KERNEL_TOL[dtype])
                del got
                ms = time_ms(run, iters=5)
                pms = time_ms(plain, iters=3, warmup=1)
                nbytes = sum(t.numel() * t.element_size()
                             for t in (x, off, mask, w)) + x.numel() * x.element_size()
                t_bytes = nbytes / PEAK_BYTES * 1e3
                t_flops = 2.0 * B * res * res * 9 * C * C / PEAK_FLOPS[dtype] * 1e3
                bound, by = max(t_bytes, t_flops), (
                    "bytes" if t_bytes >= t_flops else "operations")
                print(f"    time: kernel {ms:.4f} ms, plain {pms:.4f} ms, bound "
                      f"{bound:.4f} ms by {by} (no PyTorch call computes a DCN)"
                      f"; memory beyond the output {extra / 2 ** 20:.2f} MiB "
                      f"(a column matrix {cols / 2 ** 20:.2f})", flush=True)
                if path == "implicit" and extra >= cols:
                    raise Failed(f"{label}: {extra} bytes beyond the output: "
                                 "the implicit GEMM allocates no column matrix")
                st = stats["dcn"]
                st["max_abs_err"] = max(st["max_abs_err"], err)
                if dtype == torch.bfloat16 and clamp is None \
                        and path == default and st["ms"] is None:
                    st.update(ms=ms, plain_ms=pms, bound_ms=bound, bound_by=by)
        B, res, C = TRAIN_BATCH, 32, 448
        ins = [(torch.randn(B, res, res, C, generator=gen, device="cuda") * 0.5),
               torch.rand(B, res, res, 18, generator=gen, device="cuda") * 7 - 3.5,
               torch.rand(B, res, res, 9, generator=gen, device="cuda"),
               torch.randn(3, 3, C, C, generator=gen, device="cuda") * (9 * C) ** -0.5]
        ins = [t.to(dtype).requires_grad_() for t in ins]
        g = torch.randn(B, res, res, C, generator=gen, device="cuda").to(dtype)
        want = torch.autograd.grad(dc.dcn_plain(*ins, None, 1, 1), ins, g)
        got = torch.autograd.grad(dc.DCNFn.apply(*ins, None, 1, 1), ins, g)
        compare_all(f"DCNFn {name_dt} res{res} C{C}", got, want,
                    FUNCTION_TOL[dtype])


# ---------------------------------------------------------------------------
# phases 11 and 12: the decoder's injection methods, eval and training
# ---------------------------------------------------------------------------


PER_SCALE_FLAGS = ["--degradation_embedding_method", "residual", "modulator",
                   "self_modulator", "deform_conv", "attention_kv",
                   "--learnable_modulator", "True"]
# the configurations of phase 11: the per-scale set (every per-scale method
# at once, with the learnable modulator), attention_residual with all_DC,
# and all_3_bands with the learnable DC lamb
INJECTION_CONFIGS = {
    "per_scale_set": dict(
        degradation_embedding_method=["residual", "modulator", "self_modulator",
                                      "deform_conv", "attention_kv"],
        learnable_modulator=True),
    "attention_residual_all_DC": dict(
        degradation_embedding_method=["attention_residual", "all_DC"]),
    "all_3_bands_DC": dict(degradation_embedding_method=["all_3_bands"],
                           frequency_decompose_type="DC"),
}


def injection_counts(name: str, dtype: str, B: int) -> dict:
    """Launches of one eval forward of ``B`` tiles on the default route,
    held apart from the model. The decoder's 22 down-path and bottleneck_0
    blocks stay fused (the shifted ones of the "down" stages of
    DEFAULT_MERGED_STAGES merged in bf16); its 22 bottleneck_1 and up-path
    blocks are unfused: K9 once each, and K11 for deform_conv; where the
    attention probabilities are modulated (all_3_bands, lamb) the core is
    the plain one, as in JAX. attention_kv makes the encoder's last block
    of each stage unfused (need_kv): K9 for intra and inter. bottleneck_0's
    two blocks (C = 896, res 8) run split where DEFAULT_SPLIT_STAGES say."""
    merged = merged_blocks(B, ("down",)) if dtype == "bfloat16" else 0
    c = dict(ZERO)
    k5 = freq_merged_blocks(B, dtype)
    if name == "all_3_bands_DC":       # every decoder block unfused
        fused_dec, enc_fused, k9 = 0, 10, 0
    elif name == "per_scale_set":      # the unshifted encoder blocks fused
        fused_dec, enc_fused, k9 = 22, 5, 22 + 2 * 5
        c["dcn"] = 22
        k5 = freq_merged_blocks(B, dtype, (False,))
    else:
        fused_dec, enc_fused, k9 = 22, 10, 22
    merged = merged if fused_dec else 0
    # of the fused decoder blocks, bottleneck_0's two at res 8 (C = 896)
    k12 = split_blocks(B, dtype, {8: 2}) if fused_dec else 0
    c["lewin_attn_split"] = c["lewin_ffn_split"] = k12
    c["lewin_attn"] = c["lewin_ffn"] = (fused_dec - merged - k12 + enc_fused
                                        - k5)
    c["freq_inter"] = enc_fused - k5
    c["freq_merged"] = k5
    c["lewin_merged"] = merged
    c["window_attn"] = k9
    return c


def block_counts(bundle, airnet, uformer_lewin, B: int) -> dict:
    """The same launches from the model's blocks: their routes, and what an
    unfused block runs."""
    counts = route_counts(bundle, airnet, uformer_lewin, B)
    for net in (bundle.encoder, bundle.decoder):
        for m in net.modules():
            if not (isinstance(m, uformer_lewin.LeWinBlock) and m.unfused):
                continue
            if m.msa_type == "freq":
                counts["window_attn"] += 2
                continue
            attn = m.attn
            modulated = attn.lamb_bands_num is not None or (
                attn.all_bands_num is not None and not attn.all_bands_dc)
            counts["window_attn"] += not modulated
            counts["dcn"] += "deform_conv" in m.injection
    return counts


def liven(bundle, seed: int = 7) -> None:
    """Offset heads and lamb drawn at random, the decoder's and then the
    encoder's (the ViT's band gains; JAX initialises them to zero, which
    makes every DCN offset 0 and every band gain 0): offsets of up to about
    3.5 pixels, past the image's edge at the rim."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in [*bundle.decoder.named_parameters(),
                        *bundle.encoder.named_parameters()]:
            if "conv_offset_mask" in name:
                if name.endswith("bias"):
                    r = torch.rand(p.shape, generator=gen) * 7 - 3.5
                else:
                    fan_in = p[0].numel()
                    r = torch.randn(p.shape, generator=gen) * fan_in ** -0.5
            elif name.endswith(".lamb"):
                r = 0.5 * torch.randn(p.shape, generator=gen)
            else:
                continue
            p.copy_(r.to(p.device))


def injection_forward(config, airnet, uformer_lewin, airnet_profile, card,
                      stats):
    """Phase 11: the full-width eval forward of each configuration of
    INJECTION_CONFIGS, bf16 at B=32 and fp32 at B=4, by the default route
    against the plain route, with the launch counts (each forward a path of
    the kernels line), MP/s of both routes, and one profile of the per-scale
    set."""
    for name, fields in INJECTION_CONFIGS.items():
        for dtype, B in (("bfloat16", BATCH), ("float32", 4)):
            cfg = flagship_config(config, dtype, **fields)
            x = torch.from_numpy(np.random.default_rng(0).random(
                (B, P, P, 3), dtype=np.float32)).cuda()
            bundles = {}
            for impl in ("plain", "default"):
                t0 = time.perf_counter()
                bundles[impl] = airnet.build_models(cfg, "cuda", impl)
                liven(bundles[impl])
                print(f"  built {name} {dtype} {impl} models in "
                      f"{time.perf_counter() - t0:.1f} s", flush=True)
            want = airnet.eval_forward(bundles["plain"], x)
            torch.cuda.synchronize()
            COUNTERS.reset()
            got = airnet.eval_forward(bundles["default"], x)
            torch.cuda.synchronize()
            counts = COUNTERS.read()
            fixed = injection_counts(name, dtype, B)
            expect = block_counts(bundles["default"], airnet, uformer_lewin, B)
            print(f"{name} eval forward {dtype} B={B}: launches {counts}",
                  flush=True)
            if counts != fixed or expect != fixed:
                raise Failed(f"{name} {dtype}: launch counts {counts}, the "
                             f"blocks give {expect}, expected {fixed}")
            add_launches(stats, f"forward_{name}_{dtype}", counts)
            if got.shape != (B, P, P, 3):
                raise Failed(f"forward shape {tuple(got.shape)}")
            compare(f"{name} eval_forward {dtype} B{B} default vs plain", got,
                    want, FORWARD_TOL[getattr(torch, dtype)])
            mps = {impl: B * P * P / time_ms(
                lambda b=b: airnet.eval_forward(b, x), iters=3, warmup=1) / 1e3
                for impl, b in bundles.items()}
            print(f"  MP/s default {mps['default']:.4f}, plain {mps['plain']:.4f}"
                  f" (128x128, B={B}, {dtype}; {card})", flush=True)
            if name == "per_scale_set" and dtype == "bfloat16":
                airnet_profile(bundles["default"], x, f"{name} default route")
            del bundles, got, want
            torch.cuda.empty_cache()


def profile_step(config, airnet, train_state, steps_lib, synthetic, card,
                 fields, name="per-scale set", batch=TRAIN_BATCH):
    """Phase 12d (the per-scale set at the CLI's batch) and 9d (the flagship
    at B=32): one traced joint step (full: forward, backward, Adam, EMA,
    enqueue) of ``fields`` in bf16 by the default route: device time by
    kernel name and by kernel of the port, busy and idle share."""
    cfg, bundle, state = fresh_state(config, airnet, train_state, "bfloat16",
                                     "default", batch, fields)
    data = train_batch(cfg, synthetic, steps_lib, batch)
    step = steps_lib.make_train_step(cfg, bundle, joint=True, upto="full")
    step(state, data)
    profile_call(lambda: step(state, data),
                 f"{name} joint step (bf16 default route, B={batch}; {card}): "
                 f"step")
    state = bundle = data = step = None
    torch.cuda.empty_cache()


def per_scale_train_counts(joint: bool) -> dict:
    """Launches of one training step of the per-scale set at B=4 in bf16 on
    the default route. Encoder, by the key encoder (no gradients) and the
    query encoder: 5 fused frequency blocks (K1 intra, K3, K2), 5 need_kv
    blocks (K9 for intra and inter); the query encoder's backward K6, K8,
    K7 and K10 twice per need_kv block; of the fused blocks (the unshifted
    ones) those that run merged at this batch forward K5. The joint step
    adds the decoder: 22 fused blocks (those of the "down" merged stages
    forward K4, the others K1 / K2; backward K6 and K7 each); 22 unfused
    blocks, K9, K11, K10 and K14 each."""
    k5 = freq_merged_blocks(TRAIN_BATCH, "bfloat16", (False,))
    c = {**ZERO, "lewin_attn": 10 - 2 * k5, "freq_inter": 10 - 2 * k5,
         "lewin_ffn": 10 - 2 * k5, "freq_merged": 2 * k5,
         "lewin_attn_bwd": 5, "freq_inter_bwd": 5, "lewin_ffn_bwd": 5,
         "window_attn": 20, "window_attn_bwd": 10}
    if joint:
        k4 = merged_blocks(TRAIN_BATCH, ("down",))
        c["lewin_attn"] += 22 - k4
        c["lewin_ffn"] += 22 - k4
        c["lewin_merged"] += k4
        c["lewin_attn_bwd"] += 22
        c["lewin_ffn_bwd"] += 22
        c["window_attn"] += 22
        c["window_attn_bwd"] += 22
        c["dcn"] += 22
        c["dcn_bwd"] += 22
    return c


def per_scale_training_entry_point(config, port_train, stats):
    """Phase 12b, the main path of this slice's training: ``<port>.train.main``
    on the per-scale set at flagship width and depth, the CLI's batch,
    bfloat16, synthetic loader: one phase-A step, one joint step, the eval
    of one task after the joint epoch, the checkpoints."""
    task = "denoising_bsd68_25"
    with tempfile.TemporaryDirectory() as out:
        cfg = config.parse_args(
            ["--synthetic_data", *PER_SCALE_FLAGS, "--test_de_type", task,
             "--output_path", out + "/", "--epochs", "2", "--epochs_encoder",
             "1", "--steps_per_epoch", "1"])
        seen = []
        torch.cuda.synchronize()
        COUNTERS.reset()
        t0 = time.perf_counter()
        state = port_train.main(cfg, progress=lambda e, m: seen.append((e, m)))
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = COUNTERS.read()
        with open(f"{out}/results.log") as f:
            results_log = f.read()
        files = sorted(os.listdir(f"{out}/ckpt"))
    print(f"training entry point, per-scale set (bfloat16, B={TRAIN_BATCH}): "
          f"1 + 1 steps, eval of 1 task and checkpoints in {secs:.3f} s, "
          f"launches {counts}", flush=True)
    print("  results.log: " + results_log.replace("\n", " | "), flush=True)
    if [e for e, _ in seen] != [0, 1] or not all(
            math.isfinite(v) for _, m in seen for v in m.values()):
        raise Failed(f"training metrics {seen}")
    if seen[1][1]["l1_loss"] <= 0 or state.step != 2:
        raise Failed(f"joint step: {seen[1]}, step {state.step}")
    lines = results_log.splitlines()
    if len(lines) != 2 or not lines[1].startswith(task + ": ") \
            or "PSNR/SSIM: " not in lines[1]:
        raise Failed(f"results.log {results_log!r}")
    if files != ["best.pt", "epoch_2.pt"]:
        raise Failed(f"checkpoints {files}")
    # the in-training eval runs in the training dtype
    per_eval = injection_counts("per_scale_set", "bfloat16", ENTRY_BATCH)
    want = {k: per_scale_train_counts(False)[k] + per_scale_train_counts(True)[k]
            + per_eval[k] for k in ZERO}
    if counts != want:
        raise Failed(f"per-scale training entry point launch counts {counts} "
                     f"!= {want}")
    add_launches(stats, "train_entry_per_scale_bfloat16", counts)


# ---------------------------------------------------------------------------
# phase 13: the split block kernels K12 / K13
# ---------------------------------------------------------------------------


# the flagship decoder's C = 896 stages: (res, heads); res 8 holds
# bottleneck_0 and bottleneck_1, res 16 decoderlayer_3
SPLIT_STAGES = ((8, 16), (16, 16))
SPLIT_C = 896


def split_cases(lb, windows, dtype, B, stages=SPLIT_STAGES):
    """K12 and K13 at the C = 896 stages, shifted and not, with the all_DC
    ``lam`` and DropPath; each with the chain kernel it equals (K1 / K2)
    and the number of parts its launch takes by default. The shifted K12
    cases take the image as the block has rolled it (the Pallas kernel's
    input); ``check_split_kernels`` also runs them on the true layout with
    the roll folded into K12."""
    gen = torch.Generator(device="cuda").manual_seed(13)
    C, n = SPLIT_C, 64

    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device="cuda") * scale

    cases = []
    for res, h in stages:
        d, M = C // h, B * res * res
        x = rnd(B, res, res, C).to(dtype)
        ln1 = [1 + rnd(C, scale=0.1), rnd(C, scale=0.1)]
        aw = [rnd(h, C, d, scale=C ** -0.5) if i % 2 == 0 else
              rnd(h, d, scale=0.1) for i in range(6)]
        aw += [rnd(h, d, C, scale=C ** -0.5), rnd(C, scale=0.1)]
        fw = [rnd(C, 4 * C, scale=C ** -0.5), rnd(4 * C, scale=0.1),
              rnd(3, 3, 4 * C, scale=1 / 3), rnd(4 * C, scale=0.1),
              rnd(4 * C, C, scale=(4 * C) ** -0.5), rnd(C, scale=0.1)]
        bias, lam = rnd(h, n, n, scale=0.05), rnd(B, h, scale=0.3)
        dps = (torch.rand(B, generator=gen, device="cuda") < 0.9).float() / 0.9
        aop = lb.attn_operands(*aw, bias, dtype)
        fop = lb.ffn_operands(*fw, dtype)
        kb_a = lb.split_parts(M, C, C, dtype)
        kb_f = lb.split_parts(M, C, 4 * C, dtype)
        for shift in ((0,) if res == 8 else (0, 4)):
            mask = (torch.from_numpy(windows.shift_attn_mask(res, res, 8, shift))
                    .cuda() if shift else None)
            cases.append(Case(
                "lewin_attn_split",
                f"block_attention_split res{res} C{C} h{h} shift{shift} lam "
                f"kb{kb_a}",
                [x, *ln1, *aw, bias, mask, lam, 8, 1e-6, dps, kb_a],
                lb.block_attention_split, lb.lewin_attn_split_plain,
                lambda x=x, ln1=ln1, aop=aop, mask=mask, lam=lam, dps=dps,
                kb=kb_a: lb.attention_split_kernel(x, *ln1, aop, mask, lam, 8,
                                                   1e-6, dps, kb),
                2.0 * M * C * (4 * C + 2 * n), ("origin", res, shift),
                lambda *a: lb.block_attention(*a[:-1]),
                lambda x=x, ln1=ln1, aop=aop, mask=mask, lam=lam, dps=dps:
                lb.attention_kernel(x, *ln1, aop, mask, lam, 8, 1e-6, True, 1,
                                    dps)))
        cases.append(Case(
            "lewin_ffn_split", f"block_ffn_split res{res} C{C} kb{kb_f}",
            [x, *ln1, *fw, 1e-6, dps, kb_f], lb.block_ffn_split,
            lb.lewin_ffn_split_plain,
            lambda x=x, ln1=ln1, fop=fop, dps=dps, kb=kb_f:
            lb.ffn_split_kernel(x, *ln1, fop, 1e-6, dps, kb),
            2.0 * M * 4 * C * (2 * C + 9), ("origin", res, 0),
            lambda *a: lb.block_ffn(*a[:-1]),
            lambda x=x, ln1=ln1, fop=fop, dps=dps:
            lb.ffn_kernel(x, *ln1, fop, 1e-6, dps)))
    return cases


# phase 13's batches: with the stages' resolutions, the split-against-chain
# table's 64, 256, 1024, 2048, 4096 and 8192 tokens; res 16 alone at B = 8
SPLIT_BATCHES = (1, 4, 8, 16, 32)


def check_split_kernels(lb, windows, stats, card: str):
    """Phase 13a: K12 / K13 against their plain versions and against K1 /
    K2, a second launch giving equal bits, the shifted K12 on the true
    layout with the roll folded in against the rolled result, their times
    beside K1 / K2's, the plain version's and the bound, in fp32 and bf16 at
    SPLIT_BATCHES. The kernels line takes fp32 at B = 4, res 8: the eval
    entry point's dtype and a batch of one image's tiles. Then the
    per-block table, split against chain, that sets the default route's
    DEFAULT_SPLIT."""
    blocks = {}
    for dtype in (torch.float32, torch.bfloat16):
        name_dt = str(dtype)[6:]
        for B in SPLIT_BATCHES:
            print(f"split kernel checks, {dtype}, B={B}:", flush=True)
            stages = SPLIT_STAGES if B != 8 else SPLIT_STAGES[1:]
            for case in split_cases(lb, windows, dtype, B, stages):
                label = f"{case.label} {name_dt} B{B}"
                got = case.wrapper(*case.args)
                torch.cuda.synchronize()
                want = case.plain(*case.args)
                err = compare(label, got, want, KERNEL_TOL[dtype])
                compare(f"{label} vs chain", got, case.chain(*case.args),
                        CHAIN_TOL[dtype])
                first, second = case.timed(), case.timed()
                if not (torch.equal(first, got) and torch.equal(second, got)):
                    raise Failed(f"{label}: a second launch gives other bits")
                _, res, shift = case.stage
                if case.kernel == "lewin_attn_split" and shift:
                    x, ln1s, ln1b = case.args[:3]
                    op = lb.attn_operands(*case.args[3:12], dtype)
                    mask, lam, dps, kb = (case.args[12], case.args[13],
                                          case.args[16], case.args[17])
                    folded = lb.attention_split_kernel(
                        torch.roll(x, (shift, shift), dims=(1, 2)), ln1s,
                        ln1b, op, mask, lam, 8, 1e-6, dps, kb, shift=shift)
                    rolled = torch.roll(got, (shift, shift), dims=(1, 2))
                    compare(f"{label} on the true layout, roll folded in, "
                            f"vs rolled (equal bits: "
                            f"{torch.equal(folded, rolled)})", folded, rolled,
                            KERNEL_TOL[dtype])
                    del folded, rolled
                ms = time_ms(case.timed)
                cms = time_ms(case.chain_timed)
                pms = time_ms(lambda: case.plain(*case.args), iters=3)
                bound, by = bound_of(case, dtype)
                print(f"    time: kernel {ms:.4f} ms, chain kernel {cms:.4f} "
                      f"ms, plain {pms:.4f} ms, bound {bound:.4f} ms by {by}",
                      flush=True)
                st = stats[case.kernel]
                st["max_abs_err"] = max(st["max_abs_err"], err)
                if dtype == torch.float32 and B == 4 and st["ms"] is None:
                    st.update(ms=ms, plain_ms=pms, bound_ms=bound, bound_by=by)
                blocks.setdefault((res, name_dt, B), {})[
                    case.kernel, shift] = (ms, cms)
                del got, want, first, second
    print(f"split against chain, ms per block (K12 + K13 against K1 + K2; "
          f"{card}):", flush=True)
    for (res, name_dt, B), t in sorted(blocks.items()):
        ffn = t["lewin_ffn_split", 0]
        for shift in sorted({sh for k, sh in t if k == "lewin_attn_split"}):
            ms = t["lewin_attn_split", shift][0] + ffn[0]
            cms = t["lewin_attn_split", shift][1] + ffn[1]
            print(f"  origin res {res:2d} C {SPLIT_C} shift {shift} {name_dt} "
                  f"B={B} ({B * res * res} tokens): split {ms:.4f}, chain "
                  f"{cms:.4f}, split/chain {ms / cms:.3f}", flush=True)


def split_forward(config, airnet, uformer_lewin, card: str, stats):
    """Phase 13b: the flagship eval forward in float32 (the eval entry
    point's dtype) at B = 4, 16 and 32 by the split, chain, default and
    plain routes, each against plain, with the launch counts and MP/s, the
    routes timed in turns (plain, split, kernel, default and back). The
    split and default forwards are main paths of the kernels line."""
    order = ("plain", "split", "kernel", "default")
    bundles = {impl: airnet.build_models(
        flagship_config(config, "float32"), "cuda", impl) for impl in order}
    for B in (4, 16, BATCH):
        x = torch.from_numpy(np.random.default_rng(3).random(
            (B, P, P, 3), dtype=np.float32)).cuda()
        want = airnet.eval_forward(bundles["plain"], x)
        fixed = {"split": SPLIT_COUNTS, "kernel": CHAIN_COUNTS,
                 "default": default_counts("float32", B)}
        for impl in order[1:]:
            COUNTERS.reset()
            got = airnet.eval_forward(bundles[impl], x)
            torch.cuda.synchronize()
            counts = COUNTERS.read()
            expect = route_counts(bundles[impl], airnet, uformer_lewin, B)
            print(f"  float32 B={B} {impl}: launches per forward {counts}",
                  flush=True)
            if counts != fixed[impl] or expect != fixed[impl]:
                raise Failed(f"{impl}: launch counts {counts}, the blocks' "
                             f"routes give {expect}, expected {fixed[impl]}")
            if impl != "kernel":
                add_launches(stats, f"forward_{impl}_float32_B{B}", counts)
            compare(f"eval_forward float32 B{B} {impl} vs plain", got, want,
                    FORWARD_TOL[torch.float32])
            del got
        runs = {impl: [] for impl in order}
        for impl in order + order[::-1]:
            ms = time_ms(lambda b=bundles[impl]: airnet.eval_forward(b, x),
                         iters=3, warmup=1)
            runs[impl].append(B * P * P / (ms / 1e3) / 1e6)
        for impl, mps in runs.items():
            print(f"throughput float32 B={B} {impl}: {mps[0]:.4f} / "
                  f"{mps[1]:.4f} MP/s (128x128; {card})", flush=True)
        del want
    del bundles
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 14: the other model families through both entry points
# ---------------------------------------------------------------------------


# the parity configurations of the JAX package (tools/parity_train.py:77-86)
# as command lines, and the configurations of phase 14's forwards
FAMILY_FLAGS = {
    "resnet_dgrn": ["--encoder_type", "ResNet", "--decoder_type", "ResNet"],
    "vit_freq": ["--encoder_type", "ViT", "--decoder_type", "ResNet",
                 "--frequency_decompose_type", "DC"],
}
FAMILIES = {
    "resnet_dgrn": dict(encoder_type="ResNet", decoder_type="ResNet"),
    "vit_freq": dict(encoder_type="ViT", decoder_type="ResNet",
                     frequency_decompose_type="DC"),
    "resnet_uformer": dict(encoder_type="ResNet",
                           degradation_embedding_method=["residual"]),
    "origin_l1_uformer": dict(encoder_msa_type="origin", L=1,
                              degradation_embedding_method=["residual"]),
}
# DGRN at the CLI's depth: 5 groups of 5 blocks, two DGMs each, one DCN
# (K11) per DGM
DGRN_DCNS = 50


def family_counts(name: str, B: int) -> dict:
    """Launches of one default-route eval forward of a family, held apart
    from the model: DGRN's DCNs; behind the ResNet encoder the Uformer
    decoder's 44 blocks, behind the origin-MSA L = 1 encoder also its 10
    origin blocks (both on the chain in float32, but for the decoder's
    C = 896 blocks that the default route runs split)."""
    if name in ("resnet_dgrn", "vit_freq"):
        return {**ZERO, "dcn": DGRN_DCNS}
    k12 = split_blocks(B, "float32")
    blocks = 44 + (10 if name == "origin_l1_uformer" else 0) - k12
    return {**ZERO, "lewin_attn": blocks, "lewin_ffn": blocks,
            "lewin_attn_split": k12, "lewin_ffn_split": k12}


def family_eval_entry(config, airnet, port_test, ckpt, stats, name: str):
    """Phase 14a: ``<port>.test.main`` for a family's command line at full
    width on two synthetic test sets, from seed weights with the offset
    heads (and the ViT's lamb) drawn at random, handed over as the
    checkpoint main loads."""
    tasks = ["denoising_bsd68_25", "deraining"]
    with tempfile.TemporaryDirectory() as out:
        cfg = config.parse_args(
            ["--synthetic_data", *FAMILY_FLAGS[name], "--test_de_type", *tasks,
             "--output_path", out + "/", "--epochs", "1"])
        bundle = airnet.build_models(cfg, "cuda")
        liven(bundle)
        ckpt.save_eval(cfg.ckpt_path, 1, bundle.encoder.state_dict(),
                       bundle.decoder.state_dict())
        del bundle
        torch.cuda.synchronize()
        COUNTERS.reset()
        t0 = time.perf_counter()
        rows = port_test.main(cfg)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = COUNTERS.read()
        with open(f"{out}/epoch_1_results.log") as f:
            log = f.read()
    print(f"eval entry point {name} ({cfg.eval_dtype}): {len(tasks)} tasks in "
          f"{secs:.3f} s, launches {counts}", flush=True)
    for task, result in rows:
        print(f"  {task}: {result}", flush=True)
    want_log = "".join(f"{t}: {' ' * (25 - len(t))}{r}\n" for t, r in rows)
    if [t for t, _ in rows] != tasks or log != want_log or any(
            not r.startswith("PSNR/SSIM: ") or "nan" in r for _, r in rows):
        raise Failed(f"{name}: results log {log!r}")
    # one forward of 16 tiles per task (the synthetic sets of phase 5)
    want = {k: v * len(tasks)
            for k, v in family_counts(name, ENTRY_BATCH).items()}
    if counts != want:
        raise Failed(f"{name} eval entry point launch counts {counts} != {want}")
    add_launches(stats, f"entry_{name}", counts)


def family_train_entry(config, airnet, port_train, train_state, stats,
                       name: str):
    """Phase 14b: ``<port>.train.main`` for a family's command line at full
    width, the CLI's batch and dtype, the synthetic loader, the offset heads
    (and lamb) drawn at random: one phase-A step, one joint step, the eval
    of one task after the joint epoch, the checkpoints."""
    task = "denoising_bsd68_25"
    with tempfile.TemporaryDirectory() as out:
        cfg = config.parse_args(
            ["--synthetic_data", *FAMILY_FLAGS[name], "--test_de_type", task,
             "--output_path", out + "/", "--epochs", "2", "--epochs_encoder",
             "1", "--steps_per_epoch", "1"])
        bundle = airnet.build_models(cfg, "cuda", eval_mode=False)
        liven(bundle)
        state = train_state.create_train_state(cfg, bundle)
        del bundle
        seen = []
        torch.cuda.synchronize()
        COUNTERS.reset()
        t0 = time.perf_counter()
        state = port_train.main(cfg, progress=lambda e, m: seen.append((e, m)),
                                state=state)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = COUNTERS.read()
        with open(f"{out}/results.log") as f:
            results_log = f.read()
        files = sorted(os.listdir(f"{out}/ckpt"))
        ckpt = torch.load(f"{out}/ckpt/epoch_2.pt", map_location="cpu",
                          weights_only=True)
    print(f"training entry point {name} ({cfg.dtype}, B={cfg.batch_size}): 1 + "
          f"1 steps, eval of 1 task and checkpoints in {secs:.3f} s, launches "
          f"{counts}", flush=True)
    print("  results.log: " + results_log.replace("\n", " | "), flush=True)
    if [e for e, _ in seen] != [0, 1] or not all(
            math.isfinite(v) for _, m in seen for v in m.values()):
        raise Failed(f"{name} training metrics {seen}")
    if seen[1][1]["l1_loss"] <= 0 or state.step != 2:
        raise Failed(f"{name} joint step: {seen[1]}, step {state.step}")
    lines = results_log.splitlines()
    if len(lines) != 2 or not lines[1].startswith(task + ": ") \
            or "PSNR/SSIM: " not in lines[1]:
        raise Failed(f"{name} results.log {results_log!r}")
    if files != ["best.pt", "epoch_2.pt"]:
        raise Failed(f"{name} checkpoints {files}")
    ts = ckpt["train_state"]
    if tuple(ts["queue"].shape)[0] != 1 or ts["step"] != 2:
        raise Failed(f"{name}: queue {tuple(ts['queue'].shape)}, step "
                     f"{ts['step']}")
    # the joint step's decoder forward and the eval's: K11 for every DCN;
    # the joint step's backward: K14 for every DCN
    want = {**ZERO, "dcn": 2 * DGRN_DCNS, "dcn_bwd": DGRN_DCNS}
    if counts != want:
        raise Failed(f"{name} training entry point launch counts {counts} != "
                     f"{want}")
    add_launches(stats, f"train_entry_{name}", counts)


def family_forwards(config, airnet, card: str, stats):
    """Phase 14c: the full-width eval forward of each family by the default
    and the plain route from one set of weights (offset heads and lamb made
    live), in the eval entry point's float32 at B = 4 and, for the DGRN
    families, B = 32; launch counts and MP/s of both routes."""
    for name, fields in FAMILIES.items():
        sizes = (4, BATCH) if name in FAMILY_FLAGS else (4,)
        cfg = flagship_config(config, "float32", **fields)
        bundles = {}
        for impl in ("default", "plain"):
            bundles[impl] = airnet.build_models(cfg, "cuda", impl)
            liven(bundles[impl])
        for B in sizes:
            x = torch.from_numpy(np.random.default_rng(4).random(
                (B, P, P, 3), dtype=np.float32)).cuda()
            want = airnet.eval_forward(bundles["plain"], x)
            torch.cuda.synchronize()
            COUNTERS.reset()
            got = airnet.eval_forward(bundles["default"], x)
            torch.cuda.synchronize()
            counts = COUNTERS.read()
            fixed = family_counts(name, B)
            print(f"{name} eval forward float32 B={B}: launches {counts}",
                  flush=True)
            if counts != fixed:
                raise Failed(f"{name}: launch counts {counts} != {fixed}")
            add_launches(stats, f"forward_{name}_B{B}", counts)
            if got.shape != (B, P, P, 3):
                raise Failed(f"{name}: forward shape {tuple(got.shape)}")
            compare(f"{name} eval_forward float32 B{B} default vs plain", got,
                    want, FORWARD_TOL[torch.float32])
            mps = {impl: B * P * P / time_ms(
                lambda b=b: airnet.eval_forward(b, x), iters=3, warmup=1) / 1e3
                for impl, b in bundles.items()}
            print(f"  MP/s default {mps['default']:.4f}, plain "
                  f"{mps['plain']:.4f} (128x128, B={B}, float32; {card})",
                  flush=True)
            del got, want
        del bundles
        torch.cuda.empty_cache()


# the joint step by the plain route keeps every DCN's gather for autograd:
# at full depth (50 DCNs) it does not fit the card's 80 GB at B = 4, so the
# step of both routes is compared with one DGRN group of two blocks
SHALLOW_DGRN = dict(dgrn_groups=1, dgrn_blocks=2)


def families(config, airnet, port_test, port_train, ckpt, train_state,
             steps_lib, synthetic, card: str, stats):
    """Phase 14: every family through both entry points, their forwards by
    both routes, the joint step of the DGRN families by both routes at the
    depth of SHALLOW_DGRN (the step's launches: K11 for the query decoder's
    4 DCNs), and the step time by the default route at full depth."""
    for name in FAMILY_FLAGS:
        family_eval_entry(config, airnet, port_test, ckpt, stats, name)
        family_train_entry(config, airnet, port_train, train_state, stats,
                           name)
    family_forwards(config, airnet, card, stats)
    for name in FAMILY_FLAGS:
        shallow = {**FAMILIES[name], **SHALLOW_DGRN}
        step_against_plain(config, airnet, train_state, steps_lib, synthetic,
                           f"{name} (1 x 2 DGRN blocks)", shallow,
                           {**ZERO, "dcn": 4, "dcn_bwd": 4})
        step_times(config, airnet, train_state, steps_lib, synthetic, card,
                   name, FAMILIES[name], (("bfloat16", "default", TRAIN_BATCH),))


# K14 at DGRN's DCNLayer (C = Cout = 64) and the deform LeFF's at res 128
# (C = Cout = 112), the training batch
DCN_BWD_SHAPES = (("DGRN", 128, 64), ("deform LeFF", 128, 112))


def convergent_offsets(B, res, dtype):
    """Offsets ``[B, res, res, 18]`` that send every sample of an image to
    the point (res / 2 + 0.5, res / 2 + 0.5): one base corner, so one bucket
    of ``res^2 * 9`` samples. Each offset is a half-integer below 128 in
    magnitude, exact in bf16."""
    i = torch.arange(res, device="cuda", dtype=torch.float32)
    t = torch.arange(3, device="cuda", dtype=torch.float32)
    c = res / 2 + 0.5
    dy = c - (i[:, None, None, None] - 1 + t[None, None, :, None])  # [res, 1, 3, 1]
    dx = c - (i[None, :, None, None] - 1 + t[None, None, None, :])  # [1, res, 1, 3]
    dy = dy.expand(res, res, 3, 3).reshape(res, res, 9)
    dx = dx.expand(res, res, 3, 3).reshape(res, res, 9)
    return torch.cat([dy, dx], -1)[None].expand(B, res, res, 18).to(dtype)


def dcn_bwd_cases(dc, dtype, B=TRAIN_BATCH, convergent=True):
    """K14 at ``DCN_BWD_SHAPES`` (offsets up to +-3.5, past every edge, some
    on integer coordinates, the modulation in [0.1, 0.9]), then DGRN's shape
    with the offsets of :func:`convergent_offsets`. ``nbytes``: x, offset,
    mask, weight and g read once, the four gradients written once;
    ``flops``: the dcol and dW products."""
    gen = torch.Generator(device="cuda").manual_seed(9)
    shapes = [(where, res, C, False) for where, res, C in DCN_BWD_SHAPES]
    if convergent:
        shapes.append(("DGRN, offsets to one pixel", 128, 64, True))
    cases = []
    for where, res, C, conv in shapes:
        rnd = lambda *shape: torch.rand(*shape, generator=gen, device="cuda")
        x = (torch.randn(B, res, res, C, generator=gen, device="cuda")
             * 0.5).to(dtype)
        if conv:
            off = convergent_offsets(B, res, dtype)
        else:
            off = rnd(B, res, res, 18) * 7 - 3.5
            off[:, ::3, ::2] = off[:, ::3, ::2].round()
            off = off.to(dtype)
        mask = (0.1 + 0.8 * rnd(B, res, res, 9)).to(dtype)
        w = (torch.randn(3, 3, C, C, generator=gen, device="cuda")
             * (9 * C) ** -0.5).to(dtype)
        g = torch.randn(B, res, res, C, generator=gen, device="cuda").to(dtype)
        args = (x, off, mask, w, None, g, 1, 1)
        nbytes = (sum(t.numel() * t.element_size() for t in (x, off, mask, w, g))
                  + x.numel() * x.element_size()
                  + 4 * (off.numel() + mask.numel() + w.numel()))
        cases.append(BwdCase(
            "dcn_bwd", f"dcn_bwd {where} res{res} C{C} {str(dtype)[6:]} B{B}",
            functools.partial(dc.dcn_bwd_kernel, *args),
            functools.partial(dc.dcn_bwd_plain, *args),
            2 * 2.0 * B * res * res * 9 * C * C, nbytes, (B * res * res, C)))
    return cases


def check_dcn_bwd(dc, stats, card: str):
    """Phase 14a: K14 against ``dcn_bwd_plain`` at the cases of
    :func:`dcn_bwd_cases`, bf16 and fp32, B=4: every output, equal bits on a
    second launch, time, plain time, bound and launches x (time - bound) a
    ``resnet_dgrn`` step (DGRN_DCNS launches)."""
    for dtype in (torch.bfloat16, torch.float32):
        name_dt = str(dtype)[6:]
        print(f"K14 (DCN backward) checks, {name_dt}, B={TRAIN_BATCH} "
              f"({card}):", flush=True)
        for case in dcn_bwd_cases(dc, dtype):
            got = case.run()
            torch.cuda.synchronize()
            err = compare_all(case.label, got, case.plain(), BWD_TOL[dtype])
            again = case.run()
            if not all(torch.equal(a, b) for a, b in zip(got, again)
                       if a is not None):
                raise Failed(f"{case.label}: two launches give different bits")
            del got, again
            ms = time_ms(case.run, iters=5)
            pms = time_ms(case.plain, iters=3, warmup=1)
            t_bytes = case.nbytes / PEAK_BYTES * 1e3
            t_flops = case.flops / PEAK_FLOPS[dtype] * 1e3
            bound, by = max(t_bytes, t_flops), (
                "bytes" if t_bytes >= t_flops else "operations")
            print(f"    time: kernel {ms:.4f} ms, plain {pms:.4f} ms, bound "
                  f"{bound:.4f} ms by {by}; {DGRN_DCNS} launches x (time - "
                  f"bound) {DGRN_DCNS * (ms - bound):.2f} ms; equal bits on a "
                  "second launch (no PyTorch call computes a DCN's backward)",
                  flush=True)
            st = stats["dcn_bwd"]
            st["max_abs_err"] = max(st["max_abs_err"], err)
            if dtype == torch.bfloat16 and st["ms"] is None:
                st.update(ms=ms, plain_ms=pms, bound_ms=bound, bound_by=by)
            torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 15: a training step gives equal bits when run twice
# ---------------------------------------------------------------------------


REPEAT_STEPS = 3


def _leaves(tree, prefix=""):
    """Every tensor of a state tree, by its path."""
    if torch.is_tensor(tree):
        yield prefix, tree
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")


def repeated_steps(config, airnet, train_state, steps_lib, synthetic, ckpt,
                   card: str):
    """Phase 15 (C1): for the flagship, the per-scale set (a deform_conv
    user) and ``resnet_dgrn`` at full width and depth, bf16, B=4, the
    default route: three joint steps from one saved state on a fresh
    generator of the same seed, twice. Every loss and every tensor of the
    train state after them (both models' parameters and buffers, the key
    encoder, the queue and its pointer, Adam's moments) must be equal bit
    for bit."""
    runs_of = (("flagship", None),
               ("per-scale set", INJECTION_CONFIGS["per_scale_set"]),
               ("resnet_dgrn", FAMILIES["resnet_dgrn"]))
    for name, fields in runs_of:
        cfg, bundle, state = fresh_state(config, airnet, train_state,
                                         "bfloat16", "default", TRAIN_BATCH,
                                         fields)
        loader = synthetic.SyntheticTrainLoader(cfg, seed=0)
        batches = [steps_lib.array_batch(loader.next_batch(), "cuda")
                   for _ in range(REPEAT_STEPS)]
        step = steps_lib.make_train_step(cfg, bundle, joint=True)
        saved = copy.deepcopy(ckpt.state_tree(state))
        runs = []
        for _ in range(2):
            ckpt.load_state_tree(state, saved)
            state.generator = torch.Generator(device="cuda").manual_seed(cfg.seed)
            COUNTERS.reset()
            losses = []
            for batch in batches:
                state, m = step(state, batch)
                losses.append(m["loss"].clone())
            torch.cuda.synchronize()
            counts = {k: v for k, v in COUNTERS.read().items() if v}
            after = {k: v.clone() for k, v in _leaves(ckpt.state_tree(state))}
            after["losses"] = torch.stack(losses)
            runs.append(after)
        first, second = runs
        differ = [k for k in first if not torch.equal(first[k], second[k])]
        print(f"repeated steps {name} bfloat16 B={TRAIN_BATCH} ({card}): "
              f"{REPEAT_STEPS} joint steps twice from one state, losses "
              f"{[round(float(v), 6) for v in first['losses']]}, "
              f"{len(first)} tensors compared, {len(differ)} differ; launches "
              f"a run {counts}", flush=True)
        if differ:
            raise Failed(f"{name}: a repeated step gives other bits in "
                         f"{differ[:8]}")
        del state, bundle, runs, saved
        torch.cuda.empty_cache()


# Phase 16's configurations: (label, fields, eval dtype, batch); the
# flagship at full depth in bf16 at the metric's batch (K4, K5) and in fp32
# at the CLI's small batch (K12 / K13); the per-scale set (K9, the
# deformable LeFF's K11) and resnet_dgrn (DGRN's K11) in bf16 at B=4, their
# depth cut to one block a stage and to one DGRN group of two blocks (the
# script's time limit: exporting and loading a program takes time by its
# nodes)
SERVE_CONFIGS = (
    ("flagship", {}, "bfloat16", BATCH),
    ("flagship", {}, "float32", SMALL_BATCH),
    ("per_scale_set", {**INJECTION_CONFIGS["per_scale_set"],
                       "uformer_depth_cap": 1}, "bfloat16", SMALL_BATCH),
    ("resnet_dgrn", {**FAMILIES["resnet_dgrn"], **SHALLOW_DGRN}, "bfloat16",
     SMALL_BATCH),
)
# whole served forward against the eager one: the kernels are the same, so
# fp32 holds to the JAX serving CLI's 1e-4 and bf16 to the whole-forward
# bound
SERVE_TOL = {"float32": 1e-4, "bfloat16": FORWARD_TOL[torch.bfloat16]}
# a short batch, padded to the exported one and cropped back
SERVE_SHORT = 3

# the clean process that loads one artifact: it imports the port's serving
# module only (and through it the kernels' registrations), loads the
# artifact, counts its program's fairm:: nodes, serves the tiles once (the
# launches counted from 0) and a short batch; then, once the parent writes
# the artifact's go file (one process at a time, the card otherwise idle),
# times the served call and, for the first artifact, traces it
SERVE_CHILD = r"""
import json, os, sys, time
import numpy as np
import torch
from {pkg} import serving
from {pkg}.ops.kernels import custom_ops

# the parent's settings: float32 products and convolutions without TF32
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
d, name, short, trace = sys.argv[1], sys.argv[2], int(sys.argv[3]), sys.argv[4]
t0 = time.perf_counter()
model = serving.load(f"{{d}}/{{name}}.fairm")
torch.cuda.synchronize()
load_s = time.perf_counter() - t0
x = np.load(f"{{d}}/{{name}}_x.npy")
custom_ops.reset_launches()
y = model(x)
torch.cuda.synchronize()
launches = {{k: v for k, v in custom_ops.read_launches().items() if v}}
np.save(f"{{d}}/{{name}}_y.npy", y.cpu().numpy())
np.save(f"{{d}}/{{name}}_short.npy", model(x[:short]).cpu().numpy())
while not os.path.exists(f"{{d}}/{{name}}.go"):
    time.sleep(0.05)
xs = torch.from_numpy(x).cuda()
for _ in range(2):
    model(xs)
start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
start.record()
for _ in range(10):
    model(xs)
end.record()
torch.cuda.synchronize()
if trace == "1":
    # where the served call spends its time (chip_smoke.py imports nothing
    # of the port itself)
    import chip_smoke as cs
    from {pkg}.ops import deform_conv
    from {pkg}.ops.kernels import lewin_block, window_attention
    cs.COUNTERS.modules = (lewin_block, window_attention, deform_conv)
    cs.profile_call(lambda: model(xs), f"served {{name}}")
bad = sorted(m for m in sys.modules
             if m.startswith(("{pkg}.models", "{pkg}.config")))
assert not bad, bad
print(json.dumps(dict(load_s=load_s, launches=launches,
                      graph=custom_ops.graph_launches(model.program.graph),
                      nodes=len(model.program.graph.nodes),
                      ms=start.elapsed_time(end) / 10, imported=bad)),
      flush=True)
"""


def serve_counts(label: str, bundle, airnet, uformer_lewin, dtype: str,
                 B: int) -> dict:
    """The launches one eager forward of ``B`` tiles of a phase-16
    configuration makes, held apart from the model (and, for the Uformer
    pairs, from its blocks' routes too); the kernels not launched left
    out."""
    if label == "flagship":
        held = default_counts(dtype, B)
        model = route_counts(bundle, airnet, uformer_lewin, B)
        if held != model:
            raise Failed(f"serving {label}: the held counts {held} != the "
                         f"model's routes {model}")
    elif label == "per_scale_set":    # its depth cut: from its blocks
        model = block_counts(bundle, airnet, uformer_lewin, B)
    else:                             # DGRN: two DCNs a block
        cfg = bundle.cfg
        model = {**ZERO, "dcn": 2 * cfg.dgrn_groups * cfg.dgrn_blocks}
    return {k: v for k, v in model.items() if v}


def serving_phase(config, airnet, uformer_lewin, serving, card: str, stats):
    """Phase 16: the eval forward served. Each configuration of
    :data:`SERVE_CONFIGS` at full width (offset heads and lamb drawn at
    random) is exported (``serving.export_eval``, the default
    route) and saved; its eager forward's launches must be the held counts.
    Then a clean process loads each artifact and serves it: the
    program's ``fairm::`` nodes and the launches of one served call must be
    the eager forward's, the served output within SERVE_TOL of the eager
    one (bits equal or not printed), a short batch padded and cropped
    likewise. Printed beside the card: export s, artifact MiB, load s, and
    the served against the eager call's ms by CUDA events. Each artifact
    loads in its own process while the next configuration exports; the
    served calls are timed one process at a time."""
    t_phase = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=root)
    children = {}
    with tempfile.TemporaryDirectory() as d:
        try:
            eager = {}
            for label, fields, dtype, B in SERVE_CONFIGS:
                name = f"{label}_{dtype}_B{B}"
                cfg = flagship_config(config, dtype, **fields)
                bundle = airnet.build_models(cfg, "cuda")
                if fields:
                    liven(bundle)
                x = torch.from_numpy(np.random.default_rng(16).random(
                    (B, P, P, 3), dtype=np.float32)).cuda()
                np.save(f"{d}/{name}_x.npy", x.cpu().numpy())
                want = serve_counts(label, bundle, airnet, uformer_lewin,
                                    dtype, B)
                COUNTERS.reset()
                y = airnet.eval_forward(bundle, x)
                torch.cuda.synchronize()
                got = {k: v for k, v in COUNTERS.read().items() if v}
                if got != want:
                    raise Failed(f"serving {name}: eager launches {got} != "
                                 f"{want}")
                ms = time_ms(lambda: airnet.eval_forward(bundle, x))
                t0 = time.perf_counter()
                blob = serving.export_eval(
                    cfg, (bundle.encoder.state_dict(),
                          bundle.decoder.state_dict()), batch=B)
                export_s = time.perf_counter() - t0
                # the metadata after the header's magic, version and length
                meta = json.loads(
                    blob[16:16 + int.from_bytes(blob[12:16], "little")])
                if meta["launches"] != want:
                    raise Failed(f"serving {name}: the artifact's launches "
                                 f"{meta['launches']} != {want}")
                serving.save(f"{d}/{name}.fairm", blob)
                eager[name] = dict(y=y.cpu(), ms=ms, want=want, dtype=dtype,
                                   B=B, export_s=export_s,
                                   mib=len(blob) / 2 ** 20,
                                   weights_mib=meta["weights_len"] / 2 ** 20)
                del bundle, blob, x, y
                torch.cuda.empty_cache()
                # loaded while the next configuration exports
                children[name] = subprocess.Popen(
                    [sys.executable, "-c", SERVE_CHILD.format(pkg=PKG), d,
                     name, str(SERVE_SHORT), "0" if children else "1"],
                    cwd=root, env=env, stdout=subprocess.PIPE,
                    stderr=subprocess.PIPE, text=True)
            for name, e in eager.items():
                open(f"{d}/{name}.go", "w").close()
                out, err = children[name].communicate(timeout=900)
                if children[name].returncode != 0:
                    raise Failed(f"the clean serving process of {name} "
                                 f"failed:\n{err[-4000:]}")
                lines = out.strip().splitlines()
                if lines[:-1]:
                    print("\n".join(lines[:-1]), flush=True)   # its trace
                c = json.loads(lines[-1])
                if c["graph"] != e["want"] or c["launches"] != e["want"]:
                    raise Failed(f"serving {name}: {c['graph']} fairm:: "
                                 f"nodes, {c['launches']} launches served, "
                                 f"eager {e['want']}")
                tol = SERVE_TOL[e["dtype"]]
                y = torch.from_numpy(np.load(f"{d}/{name}_y.npy"))
                short = torch.from_numpy(np.load(f"{d}/{name}_short.npy"))
                err = compare(f"served {name} vs eager", y, e["y"], tol)
                compare(f"served {name} short batch of {SERVE_SHORT} vs "
                        "eager", short, e["y"][:SERVE_SHORT], tol)
                n = e["B"] * P * P
                add_launches(stats, f"served_{name}",
                             {k: c["launches"].get(k, 0) for k in stats})
                print(f"serving {name} ({card}): export {e['export_s']:.1f} s,"
                      f" {c['nodes']} graph nodes, artifact {e['mib']:.1f} MiB "
                      f"(weights {e['weights_mib']:.1f}), load "
                      f"{c['load_s']:.1f} s in a clean process; served "
                      f"{c['ms']:.3f} ms ({n / c['ms'] / 1e3:.4f} MP/s), eager "
                      f"{e['ms']:.3f} ms ({n / e['ms'] / 1e3:.4f} MP/s); "
                      f"max_abs {err:.3e}, bits "
                      f"{'equal' if torch.equal(y, e['y']) else 'differ'}; "
                      f"launches {c['launches']}", flush=True)
        finally:
            for child in children.values():
                if child.poll() is None:
                    child.kill()
                    child.communicate()
    print(f"serving phase: {time.perf_counter() - t_phase:.1f} s", flush=True)


# phase 17: the analysis path on the flagship in float32 at B=4, the eval
# CLI's dtype and the loader's batch; the LeWin leftovers at the decoder's
# res 128 C=56 and res 8 C=896 (res, C, heads)
ANALYSIS_BATCH = 4
ANALYSIS_TOL = 1e-3          # (a), (b): of max(1, max|plain|)
MASK_BAND = 1e-3             # (c): scores this near the threshold may flip
LEFTOVER_STAGES = ((128, 56, 1), (8, 896, 16))
LEFTOVER_FIELDS = (dict(token_projection="conv"), dict(token_mlp="ffn"),
                   dict(token_mlp="mlp"))
ANALYSIS_CLIS = ("plot_MSA_frequency", "plot_embed_lamb_curve",
                 "plot_lamb_curve", "plot_LFS_distribution")


def analysis_embeddings(config, airnet, bundles, cfg, stats):
    """Phase 17a: ``collect_embeddings`` over two loader batches and
    ``latent_band_histogram`` over two of their images, by the default
    route against the plain route."""
    from frequency_wised_all_in_one_image_restoration_model_tpu_torch.analysis import (
        embeddings, frequency_dist)
    from frequency_wised_all_in_one_image_restoration_model_tpu_torch.scripts import (
        common)
    from frequency_wised_all_in_one_image_restoration_model_tpu_torch.training.loop import (
        build_train_loader)

    loader = build_train_loader(cfg, seed=cfg.seed)
    batches = [loader.next_batch() for _ in range(2)]
    images = [batches[0]["d1"][i] for i in range(2)]
    got = {}
    for impl, b in bundles.items():
        def encode(x, b=b):
            with torch.inference_mode():
                return b.encoder(common.images(x, "cuda"))[1]
        COUNTERS.reset()
        emb, ids = embeddings.collect_embeddings(encode, batches)
        hist = frequency_dist.latent_band_histogram(
            lambda x, b=b: common.spatial_inter(b, x), images)
        torch.cuda.synchronize()
        counts = COUNTERS.read()
        got[impl] = (emb, ids, hist)
        if impl == "default":
            add_launches(stats, "analysis_embeddings_float32", counts)
        elif any(counts.values()):
            raise Failed(f"the plain route launched {counts}")
    (emb, ids, hist), (emb_p, ids_p, hist_p) = got["default"], got["plain"]
    if emb.shape != (2 * ANALYSIS_BATCH, cfg.encoder_dim) or list(ids) != list(ids_p):
        raise Failed(f"embeddings {emb.shape}, ids {ids} / {ids_p}")
    compare("17a embeddings default vs plain", torch.from_numpy(emb),
            torch.from_numpy(emb_p), ANALYSIS_TOL)
    compare("17a latent band histogram default vs plain",
            torch.from_numpy(hist), torch.from_numpy(hist_p), ANALYSIS_TOL)


def analysis_capture(airnet, uformer_lewin, bundle, batch):
    """Phase 17b: ``model_attention_band_report`` of the whole model
    (encoder and decoder) and ``embed_lamb_responses`` of the decoder on one
    image: one map per attention layer, each band energy finite and summing
    to 1, the captured output against the default route's eval output, no
    kernel launched by a captured forward, and each ``embed_lamb_1`` equal
    to the gain the fused route computes (``WindowAttention.lam``)."""
    from torch import nn

    from frequency_wised_all_in_one_image_restoration_model_tpu_torch.analysis import (
        embeddings, msa_frequency)

    x = torch.from_numpy(batch["d1"][:1]).cuda()
    want = airnet.eval_forward(bundle, x)
    outs = []
    root = nn.ModuleDict({"encoder": bundle.encoder, "decoder": bundle.decoder})
    COUNTERS.reset()
    report = msa_frequency.model_attention_band_report(
        lambda t: outs.append(airnet.restore(bundle, t)), root, x)
    torch.cuda.synchronize()
    counts = COUNTERS.read()
    blocks = {net: [m for m in getattr(bundle, net).modules()
                    if isinstance(m, uformer_lewin.LeWinBlock)]
              for net in ("encoder", "decoder")}
    layers = (sum(2 if m.msa_type == "freq" else 1 for m in blocks["encoder"])
              + len(blocks["decoder"]))
    if len(report) != layers:
        raise Failed(f"17b: {len(report)} attention maps, {layers} layers")
    bad = [k for k, e in report.items()
           if not np.isfinite(e).all() or abs(float(e.sum()) - 1.0) > 1e-5]
    if bad:
        raise Failed(f"17b: band energies not finite or not summing to 1: {bad[:3]}")
    if any(counts.values()):
        raise Failed(f"17b: the captured forward launched {counts}")
    compare("17b captured forward vs default eval", outs[0], want,
            ANALYSIS_TOL)
    with torch.inference_mode():
        ctx = bundle.encoder.features(x)
    lambs = embeddings.embed_lamb_responses(bundle.decoder, x, ctx)
    modules = dict(bundle.decoder.named_modules())
    differ = []
    for key, g in lambs.items():
        attn = modules[key.rsplit("/", 2)[0].replace("/", ".")]
        with torch.inference_mode():
            lam = attn.lam(ctx.band_inter, torch.float32)
        if not torch.equal(torch.from_numpy(g).reshape(lam.shape), lam.cpu()):
            differ.append(key)
    if len(lambs) != len(blocks["decoder"]) or differ:
        raise Failed(f"17b: {len(lambs)} embed_lamb_1 gains for "
                     f"{len(blocks['decoder'])} blocks; differ from lam: "
                     f"{differ[:3]}")
    top = max(report, key=lambda k: report[k][-1])
    print(f"  17b: {len(report)} maps ({len(blocks['encoder'])} encoder "
          f"blocks x 2, {len(blocks['decoder'])} decoder), energies sum to 1; "
          f"{len(lambs)} embed_lamb_1 gains equal to lam bit for bit; the "
          f"highest top-band share {report[top][-1]:.4f} at {top}", flush=True)


def analysis_lfs(bundles, batches, stats):
    """Phase 17c: the LFS gradients over two batches, the Taylor scores and
    the masks by the default route (the blocks' autograd Functions: K6, K7,
    K8 backward) against the plain route (autograd of the twins): the loss,
    every parameter's gradient on the fp32 joint step's measure, the masks
    except where a score lies within MASK_BAND of the threshold."""
    from frequency_wised_all_in_one_image_restoration_model_tpu_torch.scripts import (
        plot_LFS_distribution)

    runs = {}
    for impl, b in bundles.items():
        t0 = time.perf_counter()
        COUNTERS.reset()
        runs[impl] = plot_LFS_distribution.lfs_analysis(b, batches[0], batches)
        torch.cuda.synchronize()
        counts = COUNTERS.read()
        secs = time.perf_counter() - t0
        print(f"  17c LFS {impl}: loss {runs[impl]['loss']:.6f}, threshold "
              f"{runs[impl]['thresh']:.4e}, {secs:.2f} s, launches "
              f"{ {k: v for k, v in counts.items() if v} }", flush=True)
        if impl == "default":
            add_launches(stats, "analysis_lfs_float32", counts)
            idle = [k for k in BWD_KERNELS if not counts[k]]
            if idle:
                raise Failed(f"17c: the LFS backward never launched {idle}")
        elif any(counts.values()):
            raise Failed(f"17c: the plain route launched {counts}")
    run, ref = runs["default"], runs["plain"]
    if abs(run["loss"] - ref["loss"]) > STEP_LOSS_TOL["float32"]:
        raise Failed(f"17c: loss {run['loss']} against {ref['loss']}")
    gmax = max(float(g.abs().max()) for g in ref["grads"].values())
    worst, worst_name = 0.0, ""
    for name, gp in ref["grads"].items():
        g = run["grads"][name]
        if not torch.isfinite(g).all():
            raise Failed(f"17c: {name}: non-finite gradient")
        rel = float((g - gp).abs().max()) / max(float(gp.abs().max()),
                                                1e-3 * gmax)
        if rel > worst:
            worst, worst_name = rel, name
    thresh = ref["thresh"]
    flips = near = 0
    for k, m in ref["masks"].items():
        band = np.abs(ref["scores"][k] - thresh) <= MASK_BAND * abs(thresh)
        differ = run["masks"][k] != m
        flips += int((differ & ~band).sum())
        near += int((differ & band).sum())
    channels = sum(m.size for m in ref["masks"].values())
    kept = sum(int(m.sum()) for m in run["masks"].values())
    print(f"  17c: {len(ref['grads'])} gradients, worst max|g - g_plain| / "
          f"max(max|g_plain|, 1e-3 max|g|) = {worst:.3e} at {worst_name} "
          f"(limit {STEP_GRAD_TOL['float32']}); thresholds {run['thresh']:.4e}"
          f" / {thresh:.4e}; kept {kept}/{channels}; masks differ at {flips} "
          f"channels off the threshold's band, {near} inside it", flush=True)
    if worst > STEP_GRAD_TOL["float32"] or flips:
        raise Failed("17c: the kernel route's LFS disagrees with the plain "
                     "route")


def leftover_cases(uformer_lewin, uformer_blocks, layers):
    """``(label, {impl: module}, res, C)`` of phase 17d: each module made
    once from seed 17 on the card, its plain twin a copy whose blocks run
    the plain route."""
    cases = []
    for res, dim, heads in LEFTOVER_STAGES:
        for f in LEFTOVER_FIELDS:
            cases.append((f"res{res} C{dim} "
                          + "/".join(f"{k}={v}" for k, v in f.items()),
                          uformer_lewin.BasicUformerLayer(dim, res, 2, heads,
                                                          impl="default", **f),
                          res, dim))
    cases.append(("res128 C56 LeFF(use_eca)",
                  uformer_blocks.LeFF(56, 224, use_eca=True), 128, 56))
    out = []
    for label, m, res, dim in cases:
        layers.trunc_normal_init(m, torch.Generator().manual_seed(17))
        m = m.cuda()
        plain = copy.deepcopy(m)
        for blk in plain.modules():
            if isinstance(blk, uformer_lewin.LeWinBlock):
                blk.impl = "plain"
        out.append((label, {"default": m, "plain": plain}, res, dim))
    return out


def analysis_leftovers(uformer_lewin, uformer_blocks, layers, stats):
    """Phase 17d: a stage of two blocks (the second shifted where the stage
    is wider than a window) at each of LEFTOVER_STAGES with each of
    LEFTOVER_FIELDS, and a ``LeFF(use_eca=True)``, in bf16 at B=32 and fp32
    at B=4: the default route (K9 forward, K10 backward) against the plain
    route, the forward at the per-kernel bound (the stage's output is in
    the compute dtype at |y| up to about 5, where one bf16 ulp is 6e-3 of
    it) and the gradient of the input and of every parameter at a
    Function's, on :func:`compare_all`'s measure."""
    cases = leftover_cases(uformer_lewin, uformer_blocks, layers)
    for dtype, B in ((torch.bfloat16, BATCH), (torch.float32, ANALYSIS_BATCH)):
        COUNTERS.reset()
        for label, modules, res, dim in cases:
            rng = np.random.default_rng(17)
            x0 = torch.from_numpy(rng.standard_normal(
                (B, res * res, dim), dtype=np.float32)).cuda().to(dtype)
            g = torch.from_numpy(rng.standard_normal(
                (B, res * res, dim), dtype=np.float32)).cuda()
            outs = {}
            for impl, m in modules.items():
                x = x0.clone().requires_grad_()
                y = m(x) if hasattr(m, "run") else m.composite(x)
                grads = torch.autograd.grad(y, [x, *m.parameters()],
                                            g.to(dtype))
                outs[impl] = (y.detach(), grads)
            (y, gr), (yp, grp) = outs["default"], outs["plain"]
            tag = f"17d {label} {str(dtype)[6:]} B{B}"
            compare(f"{tag} forward", y, yp, KERNEL_TOL[dtype])
            # every gradient on compare_all's measure (the parameters'
            # gradients are sums over the rows), the worst one printed
            floor = max([1.0] + [1e-2 * float(b.float().abs().max())
                                 for b in grp[1:]])
            rel = [float((a.float() - b.float()).abs().max())
                   / max(floor if i else 1.0, float(b.float().abs().max()))
                   for i, (a, b) in enumerate(zip(gr, grp))]
            bad = [i for i, (r, a) in enumerate(zip(rel, gr))
                   if not torch.isfinite(a).all()]
            i = int(np.argmax(rel))
            print(f"  {tag}: {len(rel)} gradients (input, parameters), "
                  f"worst err/max(floor,|ref|) {rel[i]:.3e} at #{i}, tol "
                  f"{FUNCTION_TOL[dtype]:.0e}", flush=True)
            if bad or rel[i] > FUNCTION_TOL[dtype]:
                raise Failed(f"{tag}: gradient #{i} off by {rel[i]:.3e} "
                             f"(non-finite: {bad})")
            del outs, y, gr, yp, grp
        torch.cuda.synchronize()
        counts = COUNTERS.read()
        add_launches(stats, f"leftovers_{str(dtype)[6:]}", counts)
        print(f"  17d {str(dtype)[6:]} B={B}: launches "
              f"{ {k: v for k, v in counts.items() if v} }", flush=True)
        if not (counts["window_attn"] and counts["window_attn_bwd"]):
            raise Failed(f"17d: K9 / K10 launches {counts['window_attn']} / "
                         f"{counts['window_attn_bwd']}")


def analysis_clis(config, stats):
    """Phase 17e: ``main(cfg)`` of the CLIs that only print, on the card,
    with the flagship's flags, synthetic data and a temporary output path;
    their lines go to a file, of which the first two of each are shown. The
    four build the same full-width eval models from the seed: they are
    built once and handed to each (``scripts/common.py``'s ``build_models``
    memoised for the phase; none of the four changes a weight)."""
    import contextlib
    import importlib
    import io

    from frequency_wised_all_in_one_image_restoration_model_tpu_torch.scripts import (
        common)

    build_models, built = common.build_models, {}

    def build_once(cfg, device, *args, **kwargs):
        key = (str(device), args, tuple(sorted(kwargs.items())))
        if key not in built:
            built[key] = build_models(cfg, device, *args, **kwargs)
        return built[key]

    common.build_models = build_once
    try:
        _analysis_clis(config, stats)
    finally:
        common.build_models = build_models


def _analysis_clis(config, stats):
    import contextlib
    import importlib
    import io

    flags = ["--encoder_type", "Uformer", "--decoder_type", "Uformer", "--L",
             "3", "--encoder_msa_type", "freq", "--degradation_embedding_method",
             "all_DC", "--synthetic_data"]
    with tempfile.TemporaryDirectory() as d:
        cfg = config.parse_args(flags + ["--output_path", f"{d}/"])
        COUNTERS.reset()
        for name in ANALYSIS_CLIS:
            t0 = time.perf_counter()
            mod = importlib.import_module(f"{PKG}.scripts.{name}")
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                mod.main(cfg)
            lines = out.getvalue().splitlines()
            print(f"  17e {name}: {len(lines)} lines in "
                  f"{time.perf_counter() - t0:.1f} s; "
                  + " | ".join(ln[:100] for ln in lines[:2]), flush=True)
            if name != "plot_lamb_curve" and not lines:
                raise Failed(f"17e: {name} printed nothing")
        torch.cuda.synchronize()
        add_launches(stats, "analysis_cli_float32", COUNTERS.read())


def analysis_phase(config, airnet, uformer_lewin, card: str, stats):
    """Phase 17: the analysis toolkit and its CLIs on the card, and the
    LeWin leftovers (see the module docstring)."""
    from frequency_wised_all_in_one_image_restoration_model_tpu_torch.models import (
        layers, uformer_blocks)

    t_phase = time.perf_counter()
    cfg = flagship_config(config, "float32", synthetic_data=True)
    bundles = {impl: airnet.build_models(cfg, "cuda", impl)
               for impl in ("default", "plain")}
    print(f"analysis (phase 17), flagship float32 B={ANALYSIS_BATCH}, {card}:",
          flush=True)
    marks = [("build", time.perf_counter())]
    analysis_embeddings(config, airnet, bundles, cfg, stats)
    marks.append(("a", time.perf_counter()))
    from frequency_wised_all_in_one_image_restoration_model_tpu_torch.training.loop import (
        build_train_loader)
    loader = build_train_loader(cfg, seed=cfg.seed)
    batches = [loader.next_batch() for _ in range(2)]
    analysis_capture(airnet, uformer_lewin, bundles["default"], batches[0])
    marks.append(("b", time.perf_counter()))
    analysis_lfs(bundles, batches, stats)
    marks.append(("c", time.perf_counter()))
    del bundles
    torch.cuda.empty_cache()
    analysis_leftovers(uformer_lewin, uformer_blocks, layers, stats)
    marks.append(("d", time.perf_counter()))
    analysis_clis(config, stats)
    marks.append(("e", time.perf_counter()))
    print(f"analysis phase: {time.perf_counter() - t_phase:.1f} s ("
          + ", ".join(f"{n} {b - a:.1f} s" for (_, a), (n, b)
                      in zip([("", t_phase)] + marks, marks)) + ")", flush=True)


DIST_TASKS = ["denoising_bsd68_25", "deraining"]


def dist_train_flags(out: str, mesh=()):
    """Phase 9a's training run (2 + 2 steps, the eval of two tasks, the
    checkpoints), to ``out``, with mesh flags."""
    return ["--synthetic_data", "--degradation_embedding_method", "all_DC",
            "--test_de_type", *DIST_TASKS, "--output_path", out + "/",
            "--epochs", "2", "--epochs_encoder", "1", "--steps_per_epoch", "2",
            *mesh]


def read_logs(out: str):
    with open(f"{out}/train.log") as f, open(f"{out}/results.log") as g:
        return f.read(), g.read()


def tree_copy(tree):
    """A copy of a train-state tree where it lies (the card holds two)."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().clone()
    if isinstance(tree, dict):
        return {k: tree_copy(v) for k, v in tree.items()}
    return tree


def tree_mismatches(a, b, prefix=""):
    """Paths where two trees of tensors and numbers differ in any bit."""
    bad = []
    for k in sorted(set(a) | set(b)):
        x, y = a.get(k), b.get(k)
        if isinstance(x, dict) and isinstance(y, dict):
            bad += tree_mismatches(x, y, f"{prefix}{k}.")
        elif isinstance(x, torch.Tensor) and isinstance(y, torch.Tensor):
            if x.shape != y.shape or not torch.equal(x, y):
                bad.append(prefix + k)
        elif x != y:
            bad.append(prefix + k)
    return bad


def timed_steps(step, state, batch, n: int = 2):
    """ms per step over ``n`` steps after one, by CUDA events."""
    step(state, batch)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        step(state, batch)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def distributed_child(out_json: str) -> int:
    """Phase 18's work, in a process of its own so that no process group
    outlives it: the training entry point without a group, then as rank 0
    of a world-1 NCCL group (the real ``init_process_group`` and the step's
    collectives on CUDA tensors), their states and logs compared bit for
    bit and their launches; the eval entry point through the group; the
    joint step's time without and with the group and the gradient
    all-reduce's; with two cards or more, two or four NCCL ranks against
    world 1; then the model-axis part (:func:`model_axis_part`).
    Writes its findings to ``out_json``."""
    from frequency_wised_all_in_one_image_restoration_model_tpu_torch import (
        config, test as port_test, train as port_train)
    from frequency_wised_all_in_one_image_restoration_model_tpu_torch.data import (
        synthetic)
    from frequency_wised_all_in_one_image_restoration_model_tpu_torch.ops import (
        deform_conv as dc)
    from frequency_wised_all_in_one_image_restoration_model_tpu_torch.ops.kernels import (
        build, lewin_block as lb, window_attention as wa)
    from frequency_wised_all_in_one_image_restoration_model_tpu_torch.parallel import (
        distributed)
    from frequency_wised_all_in_one_image_restoration_model_tpu_torch.training import (
        checkpoint as ckpt, steps as steps_lib)

    t_child = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    COUNTERS.modules = (lb, wa, dc)
    build.build()
    build.load()
    res = {"devices": torch.cuda.device_count()}
    with tempfile.TemporaryDirectory() as d, model_axis_peer(d) as peer:
        runs = {}
        for name in ("plain", "group"):
            if name == "group":
                distributed.initialize(config.parse_args([]), "cuda:0", 0,
                                       f"localhost:{distributed.free_port()}")
                res["backend"] = torch.distributed.get_backend()
                res["world"] = distributed.world()
            out = f"{d}/{name}"
            cfg = config.parse_args(dist_train_flags(out))
            seen = []
            torch.cuda.synchronize()
            COUNTERS.reset()
            t0 = time.perf_counter()
            state = port_train.main(
                cfg, progress=lambda e, m: seen.append((e, m)))
            torch.cuda.synchronize()
            runs[name] = {"secs": time.perf_counter() - t0,
                          "counts": COUNTERS.read(), "seen": seen,
                          "logs": read_logs(out),
                          "tree": tree_copy(ckpt.state_tree(state)),
                          "files": sorted(os.listdir(f"{out}/ckpt"))}
            # the joint step's time on this state, and the gradient
            # all-reduce's alone (the group's collective)
            step = steps_lib.make_train_step(cfg, None, joint=True)
            loader = synthetic.SyntheticTrainLoader(cfg, seed=1)
            batch = steps_lib.array_batch(loader.next_batch(), "cuda")
            runs[name]["step_ms"] = timed_steps(step, state, batch)
            if name == "group":
                params = state.parameters()
                runs[name]["allreduce_ms"] = time_ms(
                    lambda: distributed.mean_grads(params))
                res["grad_floats"] = sum(p.numel() for p in params)
            del state
            torch.cuda.empty_cache()
        plain, group = runs["plain"], runs["group"]
        res["train"] = {
            "secs": {k: v["secs"] for k, v in runs.items()},
            "counts": {k: v["counts"] for k, v in runs.items()},
            "losses": {k: v["seen"] for k, v in runs.items()},
            "logs_equal": plain["logs"] == group["logs"],
            "files": {k: v["files"] for k, v in runs.items()},
            "mismatches": tree_mismatches(plain["tree"], group["tree"]),
            "step_ms": {k: v["step_ms"] for k, v in runs.items()},
            "allreduce_ms": group["allreduce_ms"],
            "logs": plain["logs"]}
        del plain, group, runs  # the trees: the card's memory for what follows
        torch.cuda.empty_cache()
        cfg = config.parse_args(["--synthetic_data", "--test_de_type",
                                 *DIST_TASKS, "--output_path", f"{d}/eval/",
                                 "--epochs", "1",
                                 "--degradation_embedding_method", "all_DC"])
        torch.cuda.synchronize()
        COUNTERS.reset()
        t0 = time.perf_counter()
        rows = port_test.main(cfg)
        torch.cuda.synchronize()
        res["eval"] = {"rows": rows, "counts": COUNTERS.read(),
                       "secs": time.perf_counter() - t0}
        torch.distributed.destroy_process_group()
        if torch.cuda.device_count() >= 2:
            # N NCCL ranks on cuda:0 ... (4 where there are four cards, else
            # 2), 4 / N images each, against world 1 on the same global
            # batch of 4: the loss lines
            n = 4 if torch.cuda.device_count() >= 4 else 2
            out = f"{d}/ranks"
            t0 = time.perf_counter()
            port_train.main(config.parse_args(
                dist_train_flags(out, ["--mesh_task", str(n)])))
            res["ranks"] = {"n": n, "logs": read_logs(out),
                            "secs": time.perf_counter() - t0}
        torch.cuda.empty_cache()
        res["model_axis"] = model_axis_part(peer)
    res["secs"] = time.perf_counter() - t_child
    with open(out_json, "w") as f:
        json.dump(res, f)
    return 0


# phase 18's model-axis part: the flagship at full width, its depth cut to
# one block a stage (the part's time), bf16, B = 4, sharded over a model
# axis of 2 by JAX's rule at its min_dim
MODEL_AXIS_FIELDS = {"uformer_depth_cap": 1}
MODEL_AXIS_N, MODEL_AXIS_MIN_DIM = 2, 128


def model_axis_rank(rank: int, join: Callable[[], str]) -> dict:
    """Rank ``rank`` of phase 18's model-axis part (mesh ``(1, 1, 2)``):
    two steps (A, then joint) of the flagship (``MODEL_AXIS_FIELDS``) from
    its seed state without a group, the reference; then the same two steps
    from the same state as a rank of a two-rank group with the parameters
    sharded (``mesh.shard_params``): gloo over CUDA tensors with both ranks
    on ``cuda:0`` where there is one card (NCCL refuses two ranks on one
    device), else NCCL with rank r on ``cuda:r``. Returns the launches,
    losses and train-state trees compared (full size, the moments gathered
    over the model group), the Adam moments' and the gradient all-reduce's
    elements, the model-group gather's ms and the part's seconds. ``join()``
    gives the group's address once the reference has run."""
    import datetime

    from frequency_wised_all_in_one_image_restoration_model_tpu_torch import (
        config)
    from frequency_wised_all_in_one_image_restoration_model_tpu_torch.data import (
        synthetic)
    from frequency_wised_all_in_one_image_restoration_model_tpu_torch.models import (
        airnet)
    from frequency_wised_all_in_one_image_restoration_model_tpu_torch.ops import (
        deform_conv as dc)
    from frequency_wised_all_in_one_image_restoration_model_tpu_torch.ops.kernels import (
        build, lewin_block as lb, window_attention as wa)
    from frequency_wised_all_in_one_image_restoration_model_tpu_torch.parallel import (
        distributed, mesh as mesh_lib)
    from frequency_wised_all_in_one_image_restoration_model_tpu_torch.training import (
        checkpoint as ckpt, state as train_state, steps as steps_lib)

    t0 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    COUNTERS.modules = (lb, wa, dc)
    build.load()
    cards = torch.cuda.device_count()
    device = torch.device("cuda", rank if cards >= MODEL_AXIS_N else 0)
    torch.cuda.set_device(device)
    cfg = flagship_config(config, "float32", dtype="bfloat16",
                          synthetic_data=True, **MODEL_AXIS_FIELDS)
    bundle = airnet.build_models(cfg, device, "default", eval_mode=False)
    state = train_state.create_train_state(cfg, bundle)
    fresh = tree_copy(ckpt.state_tree(state))
    loader = synthetic.SyntheticTrainLoader(cfg, seed=0)
    batches = [steps_lib.array_batch(loader.next_batch(), device)
               for _ in range(2)]
    steps = [steps_lib.make_train_step(cfg, bundle, joint=j)
             for j in (False, True)]

    def run():
        COUNTERS.reset()
        losses = []
        for step, batch in zip(steps, batches):
            _, m = step(state, batch)
            losses.append({k: float(v) for k, v in m.items()})
        torch.cuda.synchronize(device)
        return {"losses": losses, "counts": COUNTERS.read(),
                "moments": sum(st["exp_avg"].numel()
                               for st in state.optimizer.state.values()),
                "reduced": sum(p.numel() for p in state.masters())}

    res = {"rank": rank, "device": str(device), "cards": cards,
           "element_size": state.parameters()[0].element_size()}
    t1 = time.perf_counter()
    res["one"] = run()
    want = tree_copy(ckpt.state_tree(state))
    ckpt.load_state_tree(state, fresh)
    del fresh
    t2 = time.perf_counter()
    backend = "nccl" if cards >= MODEL_AXIS_N else "gloo"
    torch.distributed.init_process_group(
        backend, init_method=f"tcp://{join()}", world_size=MODEL_AXIS_N,
        rank=rank, timeout=datetime.timedelta(seconds=300))
    try:
        distributed.form_groups(MODEL_AXIS_N)
        res["backend"] = torch.distributed.get_backend()
        res["world"] = distributed.world()
        mesh_lib.shard_params(state, mesh_lib.make_mesh(
            1, 1, MODEL_AXIS_N, device_type="cuda"), MODEL_AXIS_MIN_DIM)
        res["sharded_leaves"] = len(state.shards.shards)
        res["gathered"] = sum(s.block.numel() for s in state.shards.shards)
        t3 = time.perf_counter()
        res["sharded"] = run()
        t4 = time.perf_counter()
        got = ckpt.state_tree(state)
        res["mismatches"] = tree_mismatches(want, got)
        res["tensors"] = sum(1 for _ in _leaves(want))
        del got, want
        torch.cuda.synchronize(device)
        h0 = time.perf_counter()
        res["gather_ms"] = time_ms(
            lambda: distributed.gather_params(state.shards), iters=3,
            warmup=1)
        res["gather_host_ms"] = (time.perf_counter() - h0) * 1e3 / 4
    finally:
        torch.distributed.destroy_process_group()
    res["secs"] = {"setup": t1 - t0, "one": t2 - t1, "join": t3 - t2,
                   "sharded": t4 - t3, "all": time.perf_counter() - t0}
    return res


class Peer(NamedTuple):
    proc: subprocess.Popen
    out: str        # its result, JSON
    log: str        # its standard output and errors


@contextlib.contextmanager
def model_axis_peer(d: str):
    """Rank 1 of phase 18's model-axis part, started as phase 18 starts so
    that its start, build and reference run overlap phase 18's other work;
    it then waits on its standard input for the group's address
    (:func:`model_axis_part`). Killed on the way out if it still runs."""
    peer = Peer(None, f"{d}/rank1.json", f"{d}/rank1.log")
    with open(peer.log, "w") as log:
        peer = peer._replace(proc=subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--model-axis-rank",
             "1", peer.out], stdin=subprocess.PIPE, stdout=log,
            stderr=subprocess.STDOUT, text=True))
    try:
        yield peer
    finally:
        if peer.proc.poll() is None:
            peer.proc.kill()
            peer.proc.wait(timeout=30)


def model_axis_part(peer: Peer) -> dict:
    """Phase 18's model-axis part on phase 18's path: rank 0 here, the
    group's address handed to rank 1 (:func:`model_axis_peer`) once rank
    0's reference has run; both results and rank 0's seconds."""
    from frequency_wised_all_in_one_image_restoration_model_tpu_torch.parallel import (
        distributed)

    def failed(what: str) -> Failed:
        with open(peer.log) as f:
            return Failed(f"model-axis rank 1 {what}: {f.read()[-3000:]}")

    def join() -> str:
        if peer.proc.poll() is not None:
            raise failed(f"exited {peer.proc.returncode} before the group")
        address = f"localhost:{distributed.free_port()}"
        peer.proc.stdin.write(address + "\n")
        peer.proc.stdin.close()
        return address

    t0 = time.perf_counter()
    r0 = model_axis_rank(0, join)
    if peer.proc.wait(timeout=300) != 0:
        raise failed(f"exited {peer.proc.returncode}")
    with open(peer.out) as f:
        r1 = json.load(f)
    return {"ranks": [r0, r1], "secs": time.perf_counter() - t0}


def loss_lines(log: str):
    """The numbers of a train.log, line by line."""
    return [[float(t.split(":")[-1]) for t in ln.split() if ":" in t
             and t.split(":")[-1].replace(".", "", 1).isdigit()]
            for ln in log.splitlines()]


def distributed_phase(card: str, stats, eval_rows=None):
    """Phase 18: the mesh path on the card (see the module docstring),
    through ``distributed_child`` in a subprocess."""
    torch.cuda.empty_cache()  # the card's memory for phase 18's process
    with tempfile.TemporaryDirectory() as d:
        out = f"{d}/phase18.json"
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--distributed-child", out],
                           capture_output=True, text=True, timeout=600)
        secs = time.perf_counter() - t0
        if r.returncode != 0:
            raise Failed(f"phase 18's process exited {r.returncode}: "
                         f"{r.stderr[-3000:]}")
        with open(out) as f:
            res = json.load(f)
    tr, ev = res["train"], res["eval"]
    print(f"multi-GPU (phase 18), {card}: a process of {secs:.1f} s "
          f"({res['secs']:.1f} s inside); backend {res['backend']}, world "
          f"{res['world']}, {res['devices']} device(s)", flush=True)
    print(f"  training entry point without a group {tr['secs']['plain']:.3f} s,"
          f" as rank 0 of the group {tr['secs']['group']:.3f} s; losses "
          f"{tr['losses']['group']}", flush=True)
    if res["backend"] != "nccl" or res["world"] != 1:
        raise Failed(f"phase 18 ran on {res['backend']} at world {res['world']}")
    if tr["mismatches"]:
        raise Failed(f"the training entry point through the group differs "
                     f"from the run without one in {tr['mismatches'][:10]}")
    if (tr["losses"]["plain"] != tr["losses"]["group"] or not tr["logs_equal"]
            or tr["files"]["plain"] != tr["files"]["group"]
            or tr["files"]["group"] != ["best.pt", "epoch_2.pt"]):
        raise Failed(f"losses / logs / checkpoints differ: {tr['losses']}, "
                     f"logs equal {tr['logs_equal']}, {tr['files']}")
    if tr["counts"]["plain"] != tr["counts"]["group"]:
        raise Failed(f"launches through the group {tr['counts']['group']} != "
                     f"without {tr['counts']['plain']}")
    print("  every train-state tensor, loss, log line and checkpoint equal "
          "bit for bit; launches equal", flush=True)
    print(f"  joint step bf16 B={TRAIN_BATCH} ({card}): without a group "
          f"{tr['step_ms']['plain']:.3f} ms, in the world-1 group "
          f"{tr['step_ms']['group']:.3f} ms; the gradient all-reduce alone "
          f"({res['grad_floats']} floats) {tr['allreduce_ms']:.3f} ms",
          flush=True)
    rows = [tuple(r) for r in ev["rows"]]
    print(f"  eval entry point through the group: {rows} in "
          f"{ev['secs']:.3f} s", flush=True)
    if eval_rows is not None and rows != eval_rows:
        raise Failed(f"eval through the group {rows} != phase 5's {eval_rows}")
    want = {k: v * len(DIST_TASKS)
            for k, v in default_counts("float32", ENTRY_BATCH).items()}
    if ev["counts"] != want:
        raise Failed(f"eval launches through the group {ev['counts']} != "
                     f"{want}")
    if "ranks" in res:
        n, got = res["ranks"]["n"], loss_lines(res["ranks"]["logs"][0])
        one = loss_lines(tr["logs"][0])
        print(f"  {n} NCCL ranks (mesh_task {n}) against world 1, "
              f"{res['ranks']['secs']:.1f} s: loss lines {got} / {one}; "
              f"results {res['ranks']['logs'][1]!r} / {tr['logs'][1]!r}",
              flush=True)
        if len(got) != len(one) or any(
                abs(a - b) > STEP_LOSS_TOL["bfloat16"]
                for x, y in zip(got, one) for a, b in zip(x, y)):
            raise Failed(f"{n} ranks' losses {got} against world 1's {one}")
    else:
        print(f"  {res['devices']} card: the run of two ranks or more needs "
              "two cards, not made", flush=True)
    add_launches(stats, "train_entry_nccl_world1", tr["counts"]["group"])
    add_launches(stats, "entry_float32_nccl_world1", ev["counts"])
    model_axis_report(res["model_axis"], card, stats)


def model_axis_report(ma, card: str, stats):
    """Phase 18's model-axis part: its lines and its checks."""
    r0, r1 = ma["ranks"]
    want_backend = "nccl" if r0["cards"] >= MODEL_AXIS_N else "gloo"
    print(f"  model axis (mesh (1, 1, {MODEL_AXIS_N}), {card}): the flagship "
          f"at full width, {MODEL_AXIS_FIELDS}, bf16 B={TRAIN_BATCH}, steps "
          f"A then joint; ranks on {r0['device']} / {r1['device']}, backend "
          f"{r0['backend']} over CUDA tensors, world {r0['world']}; the part "
          f"{ma['secs']:.1f} s on phase 18's path (rank 1 starts with phase "
          "18; its join includes the wait for the address)", flush=True)
    for r in ma["ranks"]:
        if r["backend"] != want_backend or r["world"] != MODEL_AXIS_N:
            raise Failed(f"the model axis ran on {r['backend']} at world "
                         f"{r['world']}, not {want_backend} at {MODEL_AXIS_N}")
        one, sh, size = r["one"], r["sharded"], r["element_size"]
        print(f"    rank {r['rank']}: {r['sharded_leaves']} leaves sharded; "
              f"Adam moment elements {sh['moments']} ({2 * sh['moments'] * size}"
              f" bytes, both moments) against replicated {one['moments']} "
              f"({2 * one['moments'] * size} bytes); gradient all-reduce "
              f"{sh['reduced']} floats against {one['reduced']}; model-group "
              f"gather {r['gathered']} floats a rank, {r['gather_ms']:.3f} ms "
              f"by CUDA events ({r['gather_host_ms']:.3f} ms host); losses "
              f"{[x['loss'] for x in sh['losses']]}; s "
              + ", ".join(f"{k} {v:.1f}" for k, v in r["secs"].items()),
              flush=True)
        if r["mismatches"]:
            raise Failed(f"model-axis rank {r['rank']}: {len(r['mismatches'])}"
                         f" of {r['tensors']} train-state tensors differ from "
                         f"the one-process run: {r['mismatches'][:10]}")
        if sh["losses"] != one["losses"]:
            raise Failed(f"model-axis rank {r['rank']}: losses {sh['losses']}"
                         f" != the one-process run's {one['losses']}")
        if sh["counts"] != one["counts"] or not any(sh["counts"].values()):
            raise Failed(f"model-axis rank {r['rank']}: launches "
                         f"{sh['counts']} != the one-process run's "
                         f"{one['counts']}")
        if not sh["moments"] < one["moments"]:
            raise Failed(f"model-axis rank {r['rank']}: {sh['moments']} "
                         "moment elements, not fewer than replicated")
    print(f"    0 of {r0['tensors']} train-state tensors differ (full size, "
          "gathered) on either rank; losses and launches equal to the "
          "one-process run's; a rank's launches "
          f"{ {k: v for k, v in r0['sharded']['counts'].items() if v} }",
          flush=True)
    if ma["secs"] > 45:
        print(f"    the part took {ma['secs']:.1f} s, over its 45 s budget",
              flush=True)
    add_launches(stats, "train_model_axis_rank0", r0["sharded"]["counts"])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Smoke run of the port on one H100")
    ap.add_argument("--phases", type=int, nargs="+",
                    default=sorted(ALL_PHASES), choices=sorted(ALL_PHASES),
                    help="of phases 3-18, run only these: a development aid "
                    "that prints no result and exits with 2 (default: all)")
    ap.add_argument("--distributed-child", metavar="OUT_JSON",
                    help="phase 18's own process (started by phase 18)")
    ap.add_argument("--model-axis-rank", nargs=2,
                    metavar=("RANK", "OUT_JSON"),
                    help="a rank of phase 18's model-axis part (started by "
                    "phase 18; the group's address comes on stdin)")
    args = ap.parse_args(argv)
    if args.distributed_child:
        return distributed_child(args.distributed_child)
    if args.model_axis_rank:
        rank, out = args.model_axis_rank

        def join() -> str:
            address = sys.stdin.readline().strip()
            if not address:
                raise Failed("model-axis rank: no address on stdin")
            return address

        res = model_axis_rank(int(rank), join)
        with open(out, "w") as f:
            json.dump(res, f)
        return 0
    phases = set(args.phases)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on "
              "an NVIDIA GPU", file=sys.stderr)
        return 1
    from frequency_wised_all_in_one_image_restoration_model_tpu_torch import (
        config, serving, test as port_test, train as port_train)
    from frequency_wised_all_in_one_image_restoration_model_tpu_torch.data import (
        synthetic)
    from frequency_wised_all_in_one_image_restoration_model_tpu_torch.evaluation import (
        runner, tiling)
    from frequency_wised_all_in_one_image_restoration_model_tpu_torch.models import (
        airnet, uformer_lewin)
    from frequency_wised_all_in_one_image_restoration_model_tpu_torch.ops import (
        deform_conv as dc, frequency, metrics, windows)
    from frequency_wised_all_in_one_image_restoration_model_tpu_torch.ops.kernels import (
        build, lewin_block as lb, window_attention as wa)
    from frequency_wised_all_in_one_image_restoration_model_tpu_torch.training import (
        checkpoint as ckpt, state as train_state, steps as steps_lib)

    COUNTERS.modules = (lb, wa, dc)
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
                    "bound_ms": None, "bound_by": None, "library_ms": None,
                    "launches": 0, "launches_by_path": {}}
             for name in KERNELS}
    t0 = time.perf_counter()
    marks = []     # (phase, the time it started)
    entry_rows = {}  # phase 5's result lines by eval dtype
    try:
        hgmma = hgmma_count(build)
        print(f"HGMMA instructions in the built library: {hgmma}", flush=True)
        if not hgmma:
            raise Failed("the built library holds no wgmma (HGMMA) instruction")
        bundles = Bundles(config, airnet)
        if 3 in phases:
            marks.append((3, time.perf_counter()))
            check_kernels(lb, windows, uformer_lewin.DEFAULT_MERGED, stats,
                          card)
            k2_table(lb, card)
            k1_table(lb, windows, card)
            k4_table(lb, windows, card)
            k3_table(lb, windows, stats, card)
            f2_check(lb, windows, card)
        if 4 in phases:
            marks.append((4, time.perf_counter()))
            full_forward(bundles, airnet, lb, uformer_lewin, frequency)
        if 5 in phases:
            marks.append((5, time.perf_counter()))
            for dtype in ("float32", "bfloat16"):
                rows = eval_entry_point(config, airnet, runner, metrics,
                                        port_test, lb, uformer_lewin, stats,
                                        dtype)
                entry_rows.setdefault(dtype, rows)
            requests(bundles, tiling, lb, stats)
        if 6 in phases:
            marks.append((6, time.perf_counter()))
            throughput(bundles, airnet, card)
        if 7 in phases:
            marks.append((7, time.perf_counter()))
            profile(bundles, airnet, card)
        bundles.cache.clear()
        torch.cuda.empty_cache()
        if 8 in phases:
            marks.append((8, time.perf_counter()))
            check_bwd_kernels(lb, windows, stats, card)
        if 9 in phases:
            marks.append((9, time.perf_counter()))
            training_entry_point(config, port_train, lb, stats)
            step_against_plain(config, airnet, train_state, steps_lib,
                               synthetic)
            step_times(config, airnet, train_state, steps_lib, synthetic, card)
            profile_step(config, airnet, train_state, steps_lib, synthetic,
                         card, None, "flagship", BATCH)
        if 10 in phases:
            marks.append((10, time.perf_counter()))
            check_window_attention(wa, windows, stats, card)
            for dtype in (torch.bfloat16, torch.float32):
                check_window_function(wa, windows, dtype)
            check_dcn(dc, stats, card)
        if 11 in phases:
            marks.append((11, time.perf_counter()))
            injection_forward(
                config, airnet, uformer_lewin,
                lambda b, x, label: profile_forward(airnet, b, x, label, card),
                card, stats)
        if 12 in phases:
            marks.append((12, time.perf_counter()))
            eval_entry_point(config, airnet, runner, metrics, port_test, lb,
                             uformer_lewin, stats, "float32", method=None)
            per_scale_training_entry_point(config, port_train, stats)
            fields = INJECTION_CONFIGS["per_scale_set"]
            step_against_plain(config, airnet, train_state, steps_lib,
                               synthetic, "per-scale set", fields,
                               per_scale_train_counts(True))
            step_times(config, airnet, train_state, steps_lib, synthetic, card,
                       "per-scale set", fields, (
                           ("bfloat16", "default", TRAIN_BATCH),
                           ("bfloat16", "plain", TRAIN_BATCH),
                           ("float32", "default", TRAIN_BATCH),
                           ("float32", "plain", TRAIN_BATCH)))
            profile_step(config, airnet, train_state, steps_lib, synthetic,
                         card, fields)
        if 13 in phases:
            marks.append((13, time.perf_counter()))
            check_split_kernels(lb, windows, stats, card)
            split_forward(config, airnet, uformer_lewin, card, stats)
        if 14 in phases:
            marks.append((14, time.perf_counter()))
            check_dcn_bwd(dc, stats, card)
            families(config, airnet, port_test, port_train, ckpt, train_state,
                     steps_lib, synthetic, card, stats)
        if 15 in phases:
            marks.append((15, time.perf_counter()))
            repeated_steps(config, airnet, train_state, steps_lib, synthetic,
                           ckpt, card)
        if 16 in phases:
            marks.append((16, time.perf_counter()))
            serving_phase(config, airnet, uformer_lewin, serving, card, stats)
        if 17 in phases:
            marks.append((17, time.perf_counter()))
            analysis_phase(config, airnet, uformer_lewin, card, stats)
        if 18 in phases:
            marks.append((18, time.perf_counter()))
            distributed_phase(card, stats, entry_rows.get("float32"))
        if phases == ALL_PHASES:
            idle = [n for n in KERNELS if not stats[n]["launches"]]
            if idle:
                raise Failed(f"no main path launched {idle}")
            idle = [n for n in BWD_KERNELS if not
                    stats[n]["launches_by_path"].get("train_entry_bfloat16")]
            if idle:
                raise Failed(f"the training entry point never launched {idle}")
            idle = [n for n in INJECTION_KERNELS if not stats[n][
                "launches_by_path"].get("train_entry_per_scale_bfloat16")]
            if idle:
                raise Failed("the per-scale training entry point never "
                             f"launched {idle}")
        if 5 in phases:
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
    marks.append((None, time.perf_counter()))
    print(f"phases {sorted(phases)} took {time.perf_counter() - t0:.1f} s: "
          + ", ".join(f"{n} {b - a:.1f} s" for (n, a), (_, b)
                      in zip(marks, marks[1:])), flush=True)
    if phases != ALL_PHASES:
        print(f"chip_smoke: partial run of phases {sorted(phases)}: not the "
              "check, no result printed", file=sys.stderr, flush=True)
        return 2

    print(card, flush=True)
    # library_ms: scaled_dot_product_attention for K9 / K10 (phase 10); no
    # single PyTorch call computes a fused block or a DCN
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         **stats[name]}
        for name, (src, rep) in KERNELS.items()]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    # the synthetic test sets seed each task's images with hash(task): one
    # hash seed for this process and phase 18's, whose eval lines must equal
    # phase 5's
    if os.environ.get("PYTHONHASHSEED") != "0":
        os.environ["PYTHONHASHSEED"] = "0"
        os.execv(sys.executable, [sys.executable, os.path.abspath(__file__),
                                  *sys.argv[1:]])
    sys.exit(main())
