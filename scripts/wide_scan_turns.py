#!/usr/bin/env python3
"""K3, K4 and K8 (the StyleNet, NIC and SentiCap training scans) at the
shapes past their resident plan and at their main shapes, for several
checkouts in turn on one NVIDIA GPU, so that two versions are compared on
one card.

Run from the repository root on a machine with the card, with the other
version unpacked into a directory that git ignores:

    mkdir -p _archive/parent && git archive <commit> | tar -x -C _archive/parent
    python3 scripts/wide_scan_turns.py _archive/parent . . _archive/parent

Options, first: ``--json PATH`` also writes every turn's results to PATH;
``--cases NAME,...`` runs only those cases (names below); ``--iters N``
(default 10) sets the timed calls a direction.

Each argument is a checkout's root.  Each turn runs in a process of its
own that imports that checkout's ``chip_smoke`` and ``icee_tpu_torch``,
builds the three scan libraries into that checkout, and for each case
(``chip_smoke.wide_scan_case``'s inputs, seeded by (B, H): K3 and K4 at
E = 300, T = 25, F = H; K8 at E = 512, T = 22, gclip 5.0) measures the
forward and the backward call: their time by CUDA events (mean of
``--iters`` after two warm-ups, the wrapper's host work included), their
device time (the call's kernels summed from a profiler trace,
``chip_smoke.scan_device_groups``), and for K4 cuDNN's ``nn.LSTM``
forward and backward on the same weights (CUDA events).  Each turn keeps
its outputs (h, c, dx and every weight grad); turns of one checkout must
give the same bits, turns of two checkouts must agree within phase 24's
tolerances (h and c atol 1e-4, each grad within 1e-3 of its largest
magnitude), and the script says where they are the same bits too.  It
prints each turn's log, a table by case and turn, and a JSON line of it.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile

TAG = "TURN-RESULT "
# name -> (kernel, B, H)
CASES = {
    "k4_b4096": ("K4", 4096, 512),
    "k4_h1024": ("K4", 64, 1024),
    "k4_h2048": ("K4", 64, 2048),
    "k4_main": ("K4", 64, 512),
    "k3_b4096": ("K3", 4096, 512),
    "k3_h1024": ("K3", 64, 1024),
    "k3_main": ("K3", 64, 512),
    "k8_b4096": ("K8", 4096, 512),
    "k8_h1024": ("K8", 128, 1024),
    "k8_main": ("K8", 128, 512),
}


def turn(root: str, out_dir: str, names, iters: int) -> None:
    """One checkout's turn (in its own process, cwd = root)."""
    sys.path.insert(0, root)
    import torch

    import chip_smoke as cs
    from icee_tpu_torch.core.device import set_float32_precision
    from icee_tpu_torch.ops import cuda_lib, scan_grid

    cuda_lib.build_all(("lstm_scan", "nic_scan", "senticap_scan"))
    set_float32_precision()
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = True
    device = torch.device("cuda", 0)
    res = {}
    for name in names:
        kernel, b, h = CASES[name]
        mod, fwd, bwd, _, _, lib_f, lib_b, _ = cs.wide_scan_case(
            kernel, b, h, device)
        plan = scan_grid.plan_on(kernel, b, h, device)
        h_seq, c_seq, saved = fwd()
        grads = cs.wide_grads(bwd(h_seq, c_seq, saved))
        torch.cuda.synchronize()
        torch.save({"h": h_seq.cpu(), "c": c_seq.cpu(),
                    **{k: v.cpu() for k, v in grads.items()}},
                   os.path.join(out_dir, f"{name}.pt"))
        fwd_dev = cs.scan_device_groups(f"{name} forward", fwd, mod)
        bwd_dev = cs.scan_device_groups(
            f"{name} backward", lambda: bwd(h_seq, c_seq, saved), mod)
        r = {"plan": {f: getattr(plan, f) for f in
                      ("f_kind", "f_rows", "f_units", "f_blocks",
                       "f_stages", "b_kind", "b_units", "b_kc",
                       "b_splits", "b_blocks", "b_stages")},
             "fwd_ms": cs.cuda_ms(fwd, iters, 2),
             "bwd_ms": cs.cuda_ms(lambda: bwd(h_seq, c_seq, saved), iters,
                                  2),
             "fwd_device_ms": None if fwd_dev is None
             else fwd_dev["total_ms"],
             "bwd_device_ms": None if bwd_dev is None
             else bwd_dev["total_ms"],
             "fwd_groups": fwd_dev, "bwd_groups": bwd_dev}
        r["b_rows"] = getattr(plan, "b_rows", 64)
        if lib_f is not None:
            r["cudnn_fwd_ms"] = cs.cuda_ms(lib_f, iters, 2)
            r["cudnn_bwd_ms"] = cs.cuda_ms(lib_b, iters, 2)
        res[name] = r
        print(f"{root} {name}: {json.dumps(r)}", flush=True)
        del h_seq, c_seq, saved, grads
        torch.cuda.empty_cache()
    print(TAG + json.dumps({"root": root,
                            "card": torch.cuda.get_device_name(0),
                            "cases": res}), flush=True)


def compare(dirs, roots, names):
    """Every turn's outputs against the first turn's: -> {case: [(turn,
    "bits" | "close" | error)]}; raises on a tolerance miss."""
    import torch

    out = {}
    for name in names:
        ref = torch.load(os.path.join(dirs[0], f"{name}.pt"))
        row = []
        for i, d in enumerate(dirs[1:], 1):
            got = torch.load(os.path.join(d, f"{name}.pt"))
            bits = all(torch.equal(got[k], ref[k]) for k in ref)
            if roots[i] == roots[0] and not bits:
                raise SystemExit(f"{name}: turn {i} ({roots[i]}) differs "
                                 "from turn 0 of the same checkout")
            for k in ref:
                diff = (got[k] - ref[k]).abs().max().item()
                lim = 1e-4 if k in ("h", "c") else \
                    1e-3 * ref[k].abs().max().item()
                if not diff <= lim:
                    raise SystemExit(f"{name}: {k} differs by {diff} > {lim}"
                                     f" between {roots[0]} and {roots[i]}")
            row.append((i, "bits" if bits else "close"))
        out[name] = row
    return out


def main(args) -> int:
    out_json, names, iters = None, list(CASES), 10
    while args and args[0].startswith("--"):
        opt = args.pop(0)
        if opt == "--json":
            out_json = args.pop(0)
        elif opt == "--cases":
            names = args.pop(0).split(",")
        elif opt == "--iters":
            iters = int(args.pop(0))
        elif opt == "--turn":   # internal: one turn in this process
            root, out_dir = args[0], args[1]
            turn(root, out_dir, names, iters)
            return 0
        else:
            raise SystemExit(f"unknown option {opt}")
    if not args:
        raise SystemExit(__doc__)
    tmp = tempfile.mkdtemp(prefix="wide_scan_turns_")
    results, dirs = [], []
    for i, root in enumerate(args):
        d = os.path.join(tmp, f"turn{i}")
        os.makedirs(d)
        dirs.append(d)
        cmd = [sys.executable, os.path.abspath(__file__), "--cases",
               ",".join(names), "--iters", str(iters), "--turn",
               os.path.abspath(root), d]
        p = subprocess.run(cmd, cwd=os.path.abspath(root),
                           capture_output=True, text=True)
        print(f"--- turn {i}: {root} (rc {p.returncode})")
        print(p.stdout[-6000:])
        if p.returncode != 0:
            print(p.stderr[-6000:])
            return 1
        line = next(ln for ln in p.stdout.splitlines()
                    if ln.startswith(TAG))
        results.append(json.loads(line[len(TAG):]))
    same = compare(dirs, args, names)
    print(f"{'case':12s} " + " ".join(f"{'turn %d' % i:>22s}"
                                      for i in range(len(args))))
    for name in names:
        cells = []
        for r in results:
            c = r["cases"][name]
            cells.append(f"{c['fwd_ms']:.3f}/{c['bwd_ms']:.3f}")
        print(f"{name:12s} " + " ".join(f"{c:>22s}" for c in cells))
    summary = {"turns": results, "agreement": same}
    print(json.dumps(summary))
    if out_json:
        with open(out_json, "w") as f:
            json.dump(summary, f)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
