#!/usr/bin/env python3
"""Phase 24 (a) of ``chip_smoke.py`` alone: K3, K4 and K8 (the training
scans) on one NVIDIA GPU at the hidden widths and batches past the
recurrence's resident plan, each direction against its plain version, with
its plan's kinds, its launches, device ms by launch group and its times
beside the bound (``chip_smoke.check_wide_scans``).

Run from the repository root on a machine with the card:

    python3 scripts/probe_wide_scan.py [kernel:B:H ...]

With no argument it runs ``chip_smoke.WIDE_SCANS``; ``K3:64:1024`` picks
one shape.  It builds only the three scans' libraries, prints the card's
name and power limit, then one JSON line of the results.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    import torch

    import chip_smoke
    from icee_tpu_torch.core.device import set_float32_precision
    from icee_tpu_torch.ops import cuda_lib

    if not torch.cuda.is_available():
        print("probe_wide_scan: CUDA is not available", file=sys.stderr)
        return 2
    libs = cuda_lib.build_all(("lstm_scan", "nic_scan", "senticap_scan"))
    for name, path in sorted(libs.items()):   # the compiler's report
        if os.path.exists(path + ".log"):
            with open(path + ".log", errors="replace") as f:
                lines = f.read().splitlines()
            for i, line in enumerate(lines):
                if "_stream_kernel" in line and "Compiling" in line:
                    print(name, line.strip(), "|", " ".join(
                        x.strip() for x in lines[i + 1:i + 3]))
    set_float32_precision()
    torch.backends.cudnn.deterministic = True
    device = torch.device("cuda", 0)
    shapes = [(k, int(b), int(h)) for k, b, h in
              (a.split(":") for a in sys.argv[1:])] or chip_smoke.WIDE_SCANS
    out = {}
    for kernel, b, h in shapes:
        out[f"{kernel} B{b} H{h}"] = chip_smoke.check_wide_scan(kernel, b, h,
                                                                device)
        torch.cuda.empty_cache()
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0])
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
