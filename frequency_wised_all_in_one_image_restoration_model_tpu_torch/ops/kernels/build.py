"""Build and load the CUDA kernels in ``csrc/``.

``nvcc`` compiles each ``csrc/*.cu`` for ``sm_90a`` (Hopper) into an object
file, in parallel, and links them into one shared library with a plain C
interface under ``build/kernels/<source hash>/`` at the root of the checkout.
The library is loaded with ``ctypes``. Nothing here includes PyTorch's
headers, which keeps a full build to seconds instead of minutes.

The build happens at first use and again whenever the sources change (the
directory is named by a hash of every ``csrc`` file). Importing this module
builds nothing.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import List, Tuple

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "kernels"
LIB_NAME = "libfairm_kernels.so"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_Q = ctypes.c_longlong
_F = ctypes.c_float
# C signatures of the entry points (csrc/*.cu); every pointer and the
# stream are c_void_p, so a 64-bit address is never cut to a 32-bit int
SIGNATURES = {
    # x, lns, lnb, wqkv, bqkv, wp, bp, bias, mask, lam, dps, xo, qkv, out,
    # B, H, W, C, h, win, groups, res, bf16, fused, eps, stream
    "fairm_lewin_attn": [_P] * 14 + [_I] * 10 + [_F, _P],
    # y, res, wqkv, bqkv, wp, bp, bias, pairs, mask, dps, zo, qkv, out,
    # LB, H, W, C, h, win, L, bf16, fused, stream
    "fairm_freq_inter": [_P] * 13 + [_I] * 9 + [_P],
    # C, h, win, L: 1 if the fused form of fairm_freq_inter takes the shape
    "fairm_freq_inter_fused_ok": [_I] * 4,
    # x, lns, lnb, w1t, b1, wd, bd, w2t, b2, dps, xn, hid1, hid2, out,
    # B, H, W, C, Hd, bf16, eps, stream
    "fairm_lewin_ffn": [_P] * 14 + [_I] * 6 + [_F, _P],
    # C, bf16: 1 if fairm_lewin_ffn runs fused (no xn / hid1 / hid2)
    "fairm_lewin_ffn_fused": [_I] * 2,
    # x, lns, lnb, wqkv, bqkv, wp, bp, bias, mask, lam, dps, xo, qkv, ao,
    # parts, out, B, H, W, C, h, win, shift, kb, bf16, fused, eps, stream
    "fairm_lewin_attn_split": [_P] * 16 + [_I] * 10 + [_F, _P],
    # x, lns, lnb, w1t, b1, wd, bd, w2t, b2, dps, xn, hid1, hid2, parts, out,
    # B, H, W, C, Hd, kb, bf16, eps, stream
    "fairm_lewin_ffn_split": [_P] * 15 + [_I] * 7 + [_F, _P],
    # x, ln1s, ln1b, wqkv, bqkv, wp, bp, bias, mask, lam, dps1, ln2s, ln2b,
    # w1t, b1, wd, bd, w2t, b2, dps2, scratch, out, stamps, scratch_elems,
    # B, H, W, C, h, win, shift, Hd, bf16, fused, eps, stream
    "fairm_lewin_merged": [_P] * 23 + [_Q] + [_I] * 10 + [_F, _P],
    # x, ln1s, ln1b, wqkvA, bqkvA, wpA, bpA, biasA, wqkvB, bqkvB, wpB, bpB,
    # biasB, pairsB, mask, dps1, ln2s, ln2b, w1t, b1, wd, bd, w2t, b2, dps2,
    # scratch, y1, out, stamps, scratch_elems, LB, H, W, C, h, win, shift, L,
    # Hd, bf16, group, eps, stream
    "fairm_freq_merged": [_P] * 29 + [_Q] + [_I] * 11 + [_F, _P],
    # x, g, lns, lnb, wqkv, bqkv, wp, wqkvn, wpn, bias, mask, lam, ws, dx,
    # dln, dwqkv, dbqkv, dwp, dbp, dbias, dlam, ws_bytes, B, H, W, C, h, win,
    # groups, res, bf16, eps, stream
    "fairm_lewin_attn_bwd": [_P] * 21 + [_Q] + [_I] * 9 + [_F, _P],
    # x, g, lns, lnb, w1t, w1n, b1, wd, bd, w2n, ws, dx, dln, dw1, db1, dwd,
    # dbd, dw2, db2, ws_bytes, B, H, W, C, Hd, bf16, eps, stream
    "fairm_lewin_ffn_bwd": [_P] * 19 + [_Q] + [_I] * 6 + [_F, _P],
    # y, g, wqkv, bqkv, wp, wqkvn, wpn, bias, mask, ws, dy, dwqkv, dbqkv, dwp,
    # dbp, dbias, ws_bytes, LB, H, W, C, h, win, L, bf16, stream
    "fairm_freq_inter_bwd": [_P] * 16 + [_Q] + [_I] * 8 + [_P],
    # q, k, v, out, bias, mask, desc (20 strides), W, h, n, nk, d, nW, bc,
    # mr, mc, scale, stream
    "fairm_window_attn_mma": [_P] * 7 + [_Q] + [_I] * 8 + [_F, _P],
    # q, k, v, bias, mask, out, W, h, n, nk, d, nW, scale, bf16, stream
    "fairm_window_attn": [_P] * 6 + [_I] * 6 + [_F, _I, _P],
    # q, k, v, bias, mask, g, ws, dq, dk, dv, dbias, ws_bytes, W, h, n, nk,
    # d, nW, scale, bf16, stream
    "fairm_window_attn_bwd": [_P] * 11 + [_Q] + [_I] * 6 + [_F, _I, _P],
    # x, offset, mask, wt, bias, cols, out, B, H, W, C, Ho, Wo, Cout, kh, kw,
    # pad, dil, clamp, bf16, stream
    "fairm_dcn": [_P] * 7 + [_I] * 11 + [_F, _I, _P],
    # x, offset, mask, wkn, g, ws, dx, doffset, dmask, dweight, dbias,
    # ws_bytes, B, H, W, C, Ho, Wo, Cout, kh, kw, pad, dil, bf16,
    # offset and mask in bf16, stream
    "fairm_dcn_bwd": [_P] * 11 + [_Q] + [_I] * 13 + [_P],
}
# the backward kernels' workspace sizes in bytes (they return a long long)
WORKSPACE_SIGNATURES = {
    # B, H, W, C, h, win, groups, bf16
    "fairm_lewin_attn_bwd_ws": [_I] * 8,
    # B, H, W, C, Hd, bf16
    "fairm_lewin_ffn_bwd_ws": [_I] * 6,
    # LB, H, W, C, h, win, L, bf16
    "fairm_freq_inter_bwd_ws": [_I] * 8,
    # W, h, n, nk
    "fairm_window_attn_bwd_ws": [_I] * 4,
    # B, H, W, C, Ho, Wo, Cout, kh, kw, bf16
    "fairm_dcn_bwd_ws": [_I] * 10,
}


def sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu"))


def source_hash() -> str:
    h = hashlib.sha256()
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(ARCH + FLAGS).encode())
    return h.hexdigest()[:16]


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the "
                       "CUDA toolkit is installed (on PATH or CUDA_HOME)")


def compile_command(src: Path, obj: Path) -> List[str]:
    return [nvcc(), *ARCH, *FLAGS, "-c", str(src), "-o", str(obj)]


def build() -> Tuple[Path, float, str]:
    """Compile and link the library if this source hash has none yet.
    Returns ``(library path, seconds spent building, compiler log)``;
    0 seconds and an empty log when the library was already there."""
    out_dir = BUILD_ROOT / source_hash()
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib, 0.0, ""
    t0 = time.perf_counter()
    BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_ROOT) as tmp:
        tmp = Path(tmp)
        objs = [tmp / (s.stem + ".o") for s in sources()]
        procs = [subprocess.Popen(compile_command(s, o), stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for s, o in zip(sources(), objs)]
        logs = []
        for s, p in zip(sources(), procs):
            out, _ = p.communicate()
            logs.append(f"== {s.name}\n{out}")
            if p.returncode != 0:
                for q in procs:
                    q.kill()
                    q.wait()
                raise RuntimeError(f"nvcc failed on {s.name}:\n{out}")
        link = subprocess.run([nvcc(), *ARCH, "-shared", "-o",
                               str(tmp / LIB_NAME), *map(str, objs)],
                              capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"link failed:\n{link.stdout}{link.stderr}")
        out_dir.mkdir(parents=True, exist_ok=True)
        os.replace(tmp / LIB_NAME, lib)
    return lib, time.perf_counter() - t0, "".join(logs)


@functools.lru_cache(maxsize=1)
def load() -> ctypes.CDLL:
    """The kernel library, built on first use, with typed entry points."""
    lib = ctypes.CDLL(str(build()[0]))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    for name, argtypes in WORKSPACE_SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_longlong
    return lib
