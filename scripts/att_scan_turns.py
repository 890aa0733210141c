#!/usr/bin/env python3
"""Phases 10-11 of ``chip_smoke.py`` (K5, the attention training scan, and
the StyleNet+Att / NIC+Att train steps) for several checkouts in turn on
one NVIDIA GPU, so that two versions are compared on one card.

Run from the repository root on a machine with the card, with the other
version unpacked into a directory that git ignores:

    mkdir -p _archive/parent && git archive <commit> | tar -x -C _archive/parent
    python3 scripts/att_scan_turns.py _archive/parent . . _archive/parent

(``--json PATH`` first: also write every turn's results to PATH.)

Each argument is a checkout's root.  Each turn runs in a process of its
own that imports that checkout's ``chip_smoke`` and ``icee_tpu_torch``,
builds the K5 and CE libraries into that checkout, runs ``check_k5`` for
both cells and modes and ``train_att_phase`` for both models, and hands
back what they measured.  The script prints each turn's log, then one table
of kernel times and step times by turn and a JSON line of them.  Any
failed phase fails the script.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

TAG = "TURN-RESULT "
K5_KEYS = ("name", "ms", "plain_ms", "library_ms", "bound_ms", "max_abs_err",
           "max_rel_err", "recomputed_att2_max_rel_err", "trace_flips",
           "device_ms_by_group")
STEP_KEYS = ("factual_step_ms", "captions_per_s", "plain_factual_step_ms",
             "device_busy_share", "device_ms_by_kernel")


def turn(root: str) -> None:
    """One checkout's phases 10-11; prints TAG + JSON as its last line."""
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    os.chdir(root)
    import torch

    import chip_smoke as cs
    from icee_tpu_torch.core.device import set_float32_precision
    from icee_tpu_torch.ops import cuda_lib

    if not torch.cuda.is_available():
        raise SystemExit("att_scan_turns: CUDA is not available")
    cuda_lib.build_all(["att_scan", "chunked_ce"])
    set_float32_precision()
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = True
    device = torch.device("cuda", 0)
    k5 = []
    for kind in ("factored", "lstm"):
        for sampled in (False, True):
            for entry in cs.check_k5(kind, sampled, device):
                k5.append({k: entry[k] for k in K5_KEYS if k in entry})
    steps = {}
    for factored in (True, False):
        _, stats = cs.train_att_phase(device, factored)
        steps["stylenet_att" if factored else "nic_att"] = {
            k: stats[k] for k in STEP_KEYS}
    print(TAG + json.dumps({"root": root, "k5": k5, "steps": steps}),
          flush=True)


def main(args) -> int:
    json_path = None
    if args[:1] == ["--json"]:
        json_path, args = args[1], args[2:]
    roots = args
    if not roots:
        raise SystemExit(__doc__)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(f"nvidia-smi: {smi}", flush=True)
    turns = []
    for i, root in enumerate(roots):
        proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                               "--turn", root], capture_output=True,
                              text=True)
        lines = proc.stdout.splitlines()
        print(f"--- turn {i}: {root} (exit {proc.returncode})", flush=True)
        for line in lines:
            if not line.startswith(TAG):
                print(f"  {line}", flush=True)
        if proc.returncode != 0 or not lines or not lines[-1].startswith(TAG):
            print(proc.stderr[-4000:], file=sys.stderr)
            raise SystemExit(f"turn {i} ({root}) failed")
        turns.append(dict(json.loads(lines[-1][len(TAG):]), turn=i,
                          arg=root))
    if json_path:
        with open(json_path, "w") as f:
            json.dump({"device": smi, "turns": turns}, f, indent=1)
    print("K5 kernel ms by turn (" + ", ".join(roots) + "):")
    for j, entry in enumerate(turns[0]["k5"]):
        print(f"  {entry['name']:36s} " + "  ".join(
            f"{t['k5'][j]['ms']:8.3f}" for t in turns))
    print("attention factual step at ratio 0.8, ms by turn:")
    for model in turns[0]["steps"]:
        print(f"  {model:36s} " + "  ".join(
            f"{t['steps'][model]['factual_step_ms']:8.3f}" for t in turns))
    print(json.dumps({"att_scan_turns": [
        {"arg": t["arg"], "k5_ms": {e["name"]: e["ms"] for e in t["k5"]},
         "step_ms": {m: s["factual_step_ms"] for m, s in t["steps"].items()}}
        for t in turns]}))
    print(smi)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--turn"]:
        turn(sys.argv[2])
    else:
        sys.exit(main(sys.argv[1:]))
