#!/usr/bin/env python3
"""K1 and K6 (one fused-step decode step of StyleNet, and of StyleNet+Att
and NIC+Att) for several checkouts in turn on one NVIDIA GPU, so that two
versions are compared on one card.

Run from the repository root on a machine with the card, with the other
version unpacked into a directory that git ignores:

    mkdir -p _archive/parent && git archive <commit> | tar -x -C _archive/parent
    python3 scripts/step_turns.py _archive/parent . . _archive/parent

(``--json PATH`` first: also write every turn's results to PATH;
``--cases NAME,...``: only those cases, by the names below.)

Each argument is a checkout's root.  Each turn runs in a process of its
own that imports that checkout's ``chip_smoke`` and ``icee_tpu_torch``,
builds ``decode_step`` and ``att_decode_step`` into that checkout, and on
``chip_smoke.decoder_params``' seeded weights (E = 300, V = 8192, A = 512,
P = 196, FS = 2048; H = F as the case says) times each case's kernel call
and its library yardstick (CUDA events, mean of ``ITERS`` after two
warm-ups): for K1 ``chip_smoke.k1_times``' chain (the cell, addmm,
log_softmax, topk), for K6 ``chip_smoke.att_library_step``.  The cases
are the shapes of ``PERF.md``'s kernel table: K1 and K6 (both kinds) at 64
images x 5 rows (R = 320) and H = F = 512, 1024 and 2048, K1 at 64 images
x 20 (the wide head) and at 1,024 rows with a top-1,024 (past one block),
K6 at one image x 20 and x 256 (the wide paths), and the serial shape (one
image x 5, the column-split path).  Inputs come from a generator seeded
by the case, as ``chip_smoke.check_k1`` / ``check_k6`` draw them.  Every
turn's outputs (logp, ids, h', c', alpha) must be the first turn's bits:
the kernels' arithmetic is one fmaf chain an output in every version.
The script prints each turn's log, a table by case and turn, and a JSON
line of it.
"""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys

TAG = "TURN-RESULT "
ITERS = 20
# name -> (op, H = F, images, k = top-k)
CASES = {
    "k1_320_h512": ("k1", 512, 64, 5),
    "k1_320_h1024": ("k1", 1024, 64, 5),
    "k1_320_h2048": ("k1", 2048, 64, 5),
    "k1_1280_k20": ("k1", 512, 64, 20),
    "k1_1024_k1024": ("k1", 512, 1, 1024),
    "k1_serial_5": ("k1", 512, 1, 5),
    "factored_320_h512": ("factored", 512, 64, 5),
    "factored_320_h1024": ("factored", 1024, 64, 5),
    "factored_320_h2048": ("factored", 2048, 64, 5),
    "factored_20_k20": ("factored", 512, 1, 20),
    "factored_256_k256": ("factored", 512, 1, 256),
    "factored_serial_5": ("factored", 512, 1, 5),
    "lstm_320_h512": ("lstm", 512, 64, 5),
    "lstm_320_h1024": ("lstm", 1024, 64, 5),
    "lstm_320_h2048": ("lstm", 2048, 64, 5),
    "lstm_20_k20": ("lstm", 512, 1, 20),
    "lstm_256_k256": ("lstm", 512, 1, 256),
    "lstm_serial_5": ("lstm", 512, 1, 5),
}


def case_call(cs, op: str, decs, n_img: int, k: int, seed: int, device):
    """(kernel call, library call) for one case on ``decs``' weights."""
    import torch

    from icee_tpu_torch.models import attention as att_mod
    from icee_tpu_torch.ops.att_decode_step import (att_decode_step_topk,
                                                    step_params)
    from icee_tpu_torch.ops.cells import factored_lstm_cell
    from icee_tpu_torch.ops.decode_step import decode_step_topk

    rows = n_img * k
    g = torch.Generator(device=device).manual_seed(seed)
    if op == "k1":
        dec = decs["stylenet"]["decoder"]
        x = torch.randn((rows, cs.E), generator=g, device=device) * 0.5
        h = torch.randn((rows, cs.H), generator=g, device=device) * 0.5
        c = torch.randn((rows, cs.H), generator=g, device=device) * 0.5

        def library():
            h_new, _ = factored_lstm_cell(dec, x, h, c, 1)
            return torch.topk(torch.log_softmax(
                torch.addmm(dec["C_b"], h_new, dec["C_w"]), dim=-1), k)

        return (lambda: decode_step_topk(dec, x, h, c, 1, ktop=k)), library
    dec = decs[cs.ATT_KINDS[op]]["decoder"]
    cell, att, gate = step_params(dec, op, 3 if op == "factored" else 0)
    x = torch.randn((rows, cs.E), generator=g, device=device) * 0.1
    h = torch.randn((rows, cs.H), generator=g, device=device) * 0.5
    c = torch.randn((rows, cs.H), generator=g, device=device) * 0.5
    feats = cs.att_features(device, n_img, seed)
    att1 = att_mod.att_projection(att, feats)
    args = (cell, att, gate, x, h, c, feats, att1, op, k)
    return (lambda: att_decode_step_topk(*args, ktop=k),
            lambda: cs.att_library_step(args))


def turn(root: str, names) -> None:
    """One checkout's figures; prints TAG + JSON as its last line."""
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    os.chdir(root)
    import torch

    import chip_smoke as cs
    from icee_tpu_torch.core.device import set_float32_precision
    from icee_tpu_torch.ops import cuda_lib

    if not torch.cuda.is_available():
        raise SystemExit("step_turns: CUDA is not available")
    device = torch.device("cuda", 0)
    cuda_lib.build_all(["decode_step", "att_decode_step"])
    set_float32_precision()
    out = {}
    with torch.inference_mode():
        for hw in sorted({CASES[n][1] for n in names}):
            with cs.widths(H=hw, F=hw):
                decs = cs.decoder_params(device)
                for name in names:
                    op, h, n_img, k = CASES[name]
                    if h != hw:
                        continue
                    seed = sum(map(ord, name))
                    run, library = case_call(cs, op, decs, n_img, k, seed,
                                             device)
                    res = run()
                    torch.cuda.synchronize()
                    digest = hashlib.sha256()
                    for t in res:
                        digest.update(t.cpu().numpy().tobytes())
                    out[name] = {"ms": cs.cuda_ms(run, ITERS, 2),
                                 "library_ms": cs.cuda_ms(library, ITERS, 2),
                                 "bits": digest.hexdigest()[:16]}
                    print(f"{name}: {out[name]}", flush=True)
                del decs
                torch.cuda.empty_cache()
    print(TAG + json.dumps({"root": root, "cases": out}), flush=True)


def main(args) -> int:
    json_path, names = None, list(CASES)
    while args[:1] in (["--json"], ["--cases"]):
        if args[0] == "--json":
            json_path = args[1]
        else:
            names = args[1].split(",")
        args = args[2:]
    roots = args
    if not roots or any(n not in CASES for n in names):
        raise SystemExit(__doc__)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(f"nvidia-smi: {smi}", flush=True)
    turns = []
    for i, root in enumerate(roots):
        proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                               "--turn", ",".join(names), root],
                              capture_output=True, text=True)
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
    width = max(len(n) for n in names)
    print(f"\n{'case':<{width}}  " + "  ".join(
        f"{'t%d ms' % t['turn']:>9} {'lib':>7}" for t in turns) + "  bits")
    same = True
    for name in names:
        row = [t["cases"][name] for t in turns]
        equal = all(r["bits"] == row[0]["bits"] for r in row)
        same &= equal
        print(f"{name:<{width}}  " + "  ".join(
            f"{r['ms']:9.4f} {r['library_ms']:7.4f}" for r in row)
            + ("  same" if equal else "  DIFFER"))
    print(json.dumps({"device": smi, "roots": roots, "cases": {
        n: [{"ms": t["cases"][n]["ms"],
             "library_ms": t["cases"][n]["library_ms"]} for t in turns]
        for n in names}, "same_bits": same}))
    return 0 if same else 1


if __name__ == "__main__":
    if sys.argv[1:2] == ["--turn"]:
        turn(sys.argv[3], sys.argv[2].split(","))
    else:
        sys.exit(main(sys.argv[1:]))
