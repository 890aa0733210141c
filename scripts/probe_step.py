#!/usr/bin/env python3
"""Where K1's and K6's many-row step spends its device time, launch by
launch, on one NVIDIA GPU.

    python3 scripts/probe_step.py [CASE ...]

CASE names ``scripts/step_turns.py``'s cases (default: K1 and K6 at 320
rows and H = F = 512 and 2048).  For each, this tree's kernels are built,
one call is made and checked against the same call a second time (the same
bits), then ``ITERS`` calls run under ``torch.profiler`` and the device
time of each kernel name is printed per call (``chip_smoke.
device_time_by_kernel``), beside the step's plan (``ops/decode_step.py::
step_plan``: each launch's tile, blocks and shared memory) and the
card's name and power limit.  The last line is the table as JSON.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.join(HERE, "scripts"))

ITERS = 10
DEFAULT = ("k1_320_h512", "k1_320_h2048", "factored_320_h512",
           "factored_320_h2048", "lstm_320_h2048")


def main(names) -> int:
    import torch

    import chip_smoke as cs
    from icee_tpu_torch.core.device import set_float32_precision
    from icee_tpu_torch.ops import cuda_lib
    from icee_tpu_torch.ops.decode_step import step_plan
    from step_turns import CASES, case_call

    if not torch.cuda.is_available():
        raise SystemExit("probe_step: CUDA is not available")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(f"nvidia-smi: {smi}", flush=True)
    device = torch.device("cuda", 0)
    cuda_lib.build_all(["decode_step", "att_decode_step"])
    set_float32_precision()
    out = {}
    with torch.inference_mode():
        for name in names:
            op, hw, n_img, k = CASES[name]
            with cs.widths(H=hw, F=hw):
                decs = cs.decoder_params(device)
                run, _ = case_call(cs, op, decs, n_img, k, 7, device)
                a, b = run(), run()
                torch.cuda.synchronize()
                same = all(torch.equal(x, y) for x, y in zip(a, b))
                rows = cs.device_time_by_kernel(
                    lambda: [run() for _ in range(ITERS)], top=None)
                extra = {} if op == "k1" else dict(a=cs.A, p=cs.P,
                                                   fs=cs.FS, k=k)
                plan = step_plan(op, n_img * k, cs.E, hw, hw, cs.V, k,
                                 **extra)
                out[name] = {
                    "same_bits_twice": same,
                    "ms": cs.cuda_ms(run, ITERS, 2),
                    "kernels": [dict(r, ms=r["ms"] / ITERS,
                                     count=r["count"] // ITERS)
                                for r in rows],
                    "plan": [list(p) for p in plan]}
                print(f"{name}: {out[name]['ms']:.4f} ms, same bits twice "
                      f"{same}", flush=True)
                for r in out[name]["kernels"]:
                    print(f"  {r['ms']:8.4f} ms x{r['count']}  "
                          f"{r['kernel']}", flush=True)
                for p in plan:
                    print(f"  plan {p}", flush=True)
                del decs
                torch.cuda.empty_cache()
    print(json.dumps({"device": smi, "cases": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:] or DEFAULT))
