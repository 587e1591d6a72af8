"""results.log parsing + best-K summaries + PSNR-vs-epoch curves: the
port's own copy of the JAX package's ``analysis/performance.py`` (plain
Python and numpy).

Capability match for plot_performance.py:6-35 (best-1/2/3 and top-50
mean/std per task from results.log) and plot_performance_curve.py:8-26
(PSNR-vs-epoch from epoch_N_results.log files).
"""

from __future__ import annotations

import functools
import os
import re
from typing import Dict, List, Sequence, Tuple


def parse_results_log(path: str, num_tasks: int) -> List[List[Tuple[float, float]]]:
    """results.log -> per-task list of (psnr, ssim) per epoch
    (plot_performance.py:11-21 semantics: a title line then one row per
    task, repeated)."""
    perf: List[List[Tuple[float, float]]] = [[] for _ in range(num_tasks)]
    with open(path) as f:
        lines = [l for l in f if l.strip()]
    i = 0
    while i < len(lines):
        if "Epochs Results" in lines[i]:
            for j in range(num_tasks):
                i += 1
                if i >= len(lines):
                    break
                x = re.split(r"[/:,\s]", lines[i].strip())
                x = [t for t in x if t]
                perf[j].append((float(x[-2]), float(x[-1])))
        i += 1
    return perf


def best_k_summary(per_task: List[Tuple[float, float]], top: int = 50) -> Dict:
    """best-1/2/3 + top-K mean/std, sorted by PSNR then SSIM descending
    (plot_performance.py:23-35)."""
    def cmp(a, b):
        if a[0] == b[0]:
            return b[1] - a[1]
        return b[0] - a[0]

    ranked = sorted(per_task, key=functools.cmp_to_key(cmp))
    import numpy as np
    k = min(top, len(ranked))
    psnr = [r[0] for r in ranked]
    ssim = [r[1] for r in ranked]
    return {
        "best": ranked[: 3],
        "avg": (float(np.mean(psnr[:k])), float(np.mean(ssim[:k]))),
        "std": (float(np.std(psnr[:k])), float(np.std(ssim[:k]))),
    }


def parse_epoch_results(output_path: str, epochs: int,
                        step: int = 100) -> List[List[float]]:
    """PSNR per task across epoch_N_results.log files
    (plot_performance_curve.py:10-21)."""
    series: List[List[float]] = []
    for i in range(step, epochs + step, step):
        fname = os.path.join(output_path, f"epoch_{i}_results.log")
        if not os.path.exists(fname):
            continue
        with open(fname) as f:
            lines = f.readlines()
        for idx, line in enumerate(lines):
            strings = [s for s in re.split(r"[:,\s]", line.strip()) if s]
            while len(series) <= idx:
                series.append([])
            for pos, s in enumerate(strings):
                if s == "PSNR/SSIM":
                    series[idx].append(float(strings[pos + 1].split("/")[0]))
    return series
