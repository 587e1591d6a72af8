"""Best-1/2/3 and top-50 mean / std per task from
``<output_path>/results.log`` (root ``plot_performance.py``; reference
plot_performance.py:6-35):

    python -m frequency_wised_all_in_one_image_restoration_model_tpu_torch.scripts.plot_performance <flags>
"""

from __future__ import annotations

import os
from typing import Dict

from .. import config as config_lib
from ..analysis import performance
from . import common


def main(cfg: config_lib.Config, device=None) -> Dict[str, Dict]:
    common.device_of(device, cfg.cuda)
    perf = performance.parse_results_log(
        os.path.join(cfg.output_path, "results.log"), len(cfg.test_de_type))
    summaries = {}
    for task, rows in zip(cfg.test_de_type, perf):
        if not rows:
            continue
        s = summaries[task] = performance.best_k_summary(rows)
        print(task)
        for rank, (p, m) in enumerate(s["best"], 1):
            print("%d%s: %.2lf/%.4lf" % (rank, {1: "st", 2: "nd", 3: "rd"}[rank], p, m))
        print("avg: %.2lf/%.4lf" % s["avg"])
        print("var: %.4lf/%.7lf" % s["std"])
    return summaries


if __name__ == "__main__":
    main(config_lib.parse_args())
