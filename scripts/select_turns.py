#!/usr/bin/env python3
"""The wide selection (``csrc/wide_topk.cuh``, ``csrc/grid_beam.cuh``'s
row stage and tail) in K2 and K1, for several checkouts in turn on one
NVIDIA GPU, so that two versions are compared on one card.

Run from the repository root on a machine with the card, with the other
version unpacked into a directory that git ignores:

    mkdir -p _archive/parent && git archive <commit> | tar -x -C _archive/parent
    python3 scripts/select_turns.py _archive/parent . . _archive/parent

Options, first: ``--json PATH`` also writes every turn's results to PATH;
``--cases NAME,...`` runs only those cases (names below).

Each argument is a checkout's root.  Each turn runs in a process of its
own that imports that checkout's ``chip_smoke`` and ``icee_tpu_torch``,
builds ``beam`` and ``decode_step`` into that checkout, and on
``chip_smoke.decoder_params``' seeded StyleNet weights (E = 300, F = H =
512, V = 8192) times each case by CUDA events (mean of 3 after a warm-up;
K1 of 10): K2 (``mega_beam_decode``, serving mode, ``check_k2_shape``'s
features) at k = 5 over 1, 8 and 64 images (the narrow path), k = 20 over
64 images (two launches of 51 and 13), k = 300 over 3 images (the shape
of ``caption_batch --beam_size 300``), k = 512 and 2048 at one image (past
one block); K1 (``decode_step_topk``) at 1,024 rows and top-1,024.  Where
the checkout's K2 library has the search's profile marks
(``icee_grid_profile``), one more call of each K2 case is split into the
live-row scan and products, the row stage (narrow: the tile partials) and
the tail, summed over the call's launches and steps (block 0's
``%globaltimer`` after each barrier).  Every case's outputs (tokens,
lengths, scores; K1's log-probs and ids) must be the same bits in every
turn: the selection's order is exact.  The script prints each turn's log,
a table by case and turn, and a JSON line of it.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import os
import subprocess
import sys

TAG = "TURN-RESULT "
# name -> (op, images, k, steps)
CASES = {
    "k2_k5_img1": ("k2", 1, 5, 40),
    "k2_k5_img8": ("k2", 8, 5, 40),
    "k2_k5_img64": ("k2", 64, 5, 40),
    "k2_k20_img64": ("k2", 64, 20, 40),
    "k2_k300_img3": ("k2", 3, 300, 20),
    "k2_k512_img1": ("k2", 1, 512, 8),
    "k2_k2048_img1": ("k2", 1, 2048, 4),
    "k1_k1024_r1024": ("k1", 1, 1024, 0),
}


def digest(*ts) -> str:
    d = hashlib.sha256()
    for t in ts:
        d.update(t.detach().cpu().contiguous().numpy().tobytes())
    return d.hexdigest()


def turn(root: str, names) -> None:
    """One checkout's turn (in its own process, cwd = root)."""
    sys.path.insert(0, root)
    import torch

    import chip_smoke as cs
    from icee_tpu_torch.core.device import set_float32_precision
    from icee_tpu_torch.ops import beam, cuda_lib
    from icee_tpu_torch.ops.decode_step import decode_step_topk

    cuda_lib.build_all(("beam", "decode_step"))
    set_float32_precision()
    device = torch.device("cuda", 0)
    sty = cs.decoder_params(device)["stylenet"]["decoder"]
    lib = beam._library()
    prof = getattr(lib, "icee_grid_profile", None)
    if prof is not None:
        prof.argtypes = [ctypes.c_int, ctypes.c_void_p]
        prof.restype = ctypes.c_int
    res = {}
    with torch.inference_mode():
        for name in names:
            op, n_img, k, steps = CASES[name]
            r = {}
            if op == "k1":
                g = torch.Generator(device=device).manual_seed(7)
                x = torch.randn((k, cs.E), generator=g, device=device) * 0.5
                h = torch.randn((k, cs.H), generator=g, device=device) * 0.5
                c = torch.randn((k, cs.H), generator=g, device=device) * 0.5

                def call():
                    return decode_step_topk(sty, x, h, c, 1, ktop=k)

                r["ms"] = cs.cuda_ms(call, 10, 2)
                r["digest"] = digest(*call())
            else:
                g = torch.Generator(device=device).manual_seed(4)
                feats = torch.randn((n_img, 1, cs.E), generator=g,
                                    device=device)
                feats = feats.expand(n_img, k, cs.E).contiguous()

                def call():
                    return beam.mega_beam_decode(
                        sty, feats, 2, n_img, k=k, max_seq_length=steps,
                        cell="factored")

                r["ms"] = cs.cuda_ms(call, 3, 1)
                got = call()
                r["digest"] = digest(got.tokens, got.length, got.score)
                if prof is not None:
                    words = (ctypes.c_ulonglong * 8)()
                    torch.cuda.synchronize()
                    cuda_lib.check_rc(lib, prof(1, None), "profile on")
                    call()
                    torch.cuda.synchronize()
                    cuda_lib.check_rc(lib, prof(0, ctypes.addressof(words)),
                                      "profile off")
                    r["split_ms"] = {"products": words[0] / 1e6,
                                     "row_stage": words[1] / 1e6,
                                     "tail": words[2] / 1e6}
                    r["steps"] = int(words[4])
            res[name] = r
            print(f"{root} {name}: {json.dumps(r)}", flush=True)
            torch.cuda.empty_cache()
    print(TAG + json.dumps({"root": root,
                            "card": torch.cuda.get_device_name(0),
                            "cases": res}), flush=True)


def main(args) -> int:
    out_json, names = None, list(CASES)
    while args and args[0].startswith("--"):
        opt = args.pop(0)
        if opt == "--json":
            out_json = args.pop(0)
        elif opt == "--cases":
            names = args.pop(0).split(",")
        elif opt == "--turn":   # internal: one turn in this process
            turn(args[0], names)
            return 0
        else:
            raise SystemExit(f"unknown option {opt}")
    if not args:
        raise SystemExit(__doc__)
    results = []
    for i, root in enumerate(args):
        cmd = [sys.executable, os.path.abspath(__file__), "--cases",
               ",".join(names), "--turn", os.path.abspath(root)]
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
    bad = [n for n in names
           if len({r["cases"][n]["digest"] for r in results}) != 1]
    print(f"{'case':16s} " + " ".join(f"{'turn %d' % i:>10s}"
                                      for i in range(len(args))))
    for n in names:
        print(f"{n:16s} " + " ".join(f"{r['cases'][n]['ms']:10.3f}"
                                     for r in results))
    summary = {"turns": results, "differ": bad}
    print(json.dumps(summary))
    if out_json:
        with open(out_json, "w") as f:
            json.dump(summary, f)
    if bad:
        print(f"outputs differ between turns: {bad}")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
