#!/usr/bin/env python3
"""The whole-search kernels K2 (``csrc/beam.cu``, both cells) and K7
(``csrc/att_beam.cu``, both kinds) for several checkouts in turn on one
NVIDIA GPU, so that two versions are compared on one card.

Run from the repository root on a machine with the card, with the other
version unpacked into a directory that git ignores:

    mkdir -p _archive/parent && git archive <commit> | tar -x -C _archive/parent
    python3 scripts/search_turns.py _archive/parent . . _archive/parent

Options, first: ``--json PATH`` also writes every turn's results to PATH;
``--cases NAME,...`` runs only those cases (names below); ``--raw`` keeps
each case's stage records (stage, live rows, tiles taken, ms) in the
JSON.  A checkout argument ``ROOT@MODE`` plans that turn's searches with
their stages' tile thresholds as planned (``plan``, the default), at one
live row (``always``: every stage that may take tiles takes them) or never
(``never``: the slabs alone), where the checkout plans tiles at all (a
checkout that does not ignores it): the turns of one checkout in several
modes must give the same bits, and their stage records give the cost
model (``ops/beam.py`` ``SLAB_US``, ``TILE_US``) its constants.

Each argument is a checkout's root.  Each turn runs in a process of its
own that imports that checkout's ``chip_smoke`` and ``icee_tpu_torch``,
builds ``beam`` and ``att_beam`` into that checkout (the compiler's
register report of each is printed), and on ``chip_smoke.decoder_params``'
seeded decoders (E = 300, F = H = A = 512, FS = 2048, V = 8192; P = 196
unless the case says) times each case by CUDA events (mean of 10 after a
warm-up, 3 for a call above 5 ms): K2 (``mega_beam_decode``, serving mode,
``check_k2_shape``'s features) and K7 (``mega_att_beam_decode``,
``att_features``) at k = 5 over 1, 8 and 64 images (K7 also 2), k = 20
over 64 images (two launches of 51 and 13), P = 400 over 64 images (K7),
k = 300 over 3 images (K2, the shape of ``caption_batch --beam_size
300``) and k = 2048 at one image.  Where the checkout's library has the
search's profile marks (``icee_grid_profile``), one more call of each case
is split into the live-row scan and products, the row stage (narrow: the
tile partials) and the tail, summed over the call's launches and steps
(block 0's ``%globaltimer`` after each barrier); where it also has the
per-stage records (``icee_grid_records``), into each product stage's time
and steps by geometry (slabs or tiles).  Every case's outputs (tokens,
lengths, scores) must be the same bits in every turn: every output is one
fmaf chain in k order whatever the geometry.  The script prints each
turn's log, a table by case and turn, and a JSON line of it.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import os
import subprocess
import sys

TAG = "TURN-RESULT "
# name -> (kernel, cell or kind, images, k, steps, positions or None)
CASES = {}
for _cell in ("factored", "lstm"):
    _p = "k2" if _cell == "factored" else "k2l"
    CASES.update({
        f"{_p}_k5_img1": ("k2", _cell, 1, 5, 40, None),
        f"{_p}_k5_img8": ("k2", _cell, 8, 5, 40, None),
        f"{_p}_k5_img64": ("k2", _cell, 64, 5, 40, None),
        f"{_p}_k20_img64": ("k2", _cell, 64, 20, 40, None),
        f"{_p}_k300_img3": ("k2", _cell, 3, 300, 20, None),
        f"{_p}_k2048_img1": ("k2", _cell, 1, 2048, 4, None),
    })
for _kind in ("factored", "lstm"):
    _p = "k7" if _kind == "factored" else "k7l"
    CASES.update({
        f"{_p}_k5_img1": ("k7", _kind, 1, 5, 40, None),
        f"{_p}_k5_img2": ("k7", _kind, 2, 5, 40, None),
        f"{_p}_k5_img8": ("k7", _kind, 8, 5, 40, None),
        f"{_p}_k5_img64": ("k7", _kind, 64, 5, 40, None),
        f"{_p}_k20_img64": ("k7", _kind, 64, 20, 40, None),
        f"{_p}_p400_img64": ("k7", _kind, 64, 5, 40, 400),
        f"{_p}_k2048_img1": ("k7", _kind, 1, 2048, 4, None),
    })


def digest(*ts) -> str:
    d = hashlib.sha256()
    for t in ts:
        d.update(t.detach().cpu().contiguous().numpy().tobytes())
    return d.hexdigest()


def raw_split(lib, call) -> dict:
    """A checkout without ``search_split``: the three-part profile alone."""
    import torch

    from icee_tpu_torch.ops import cuda_lib

    prof = lib.icee_grid_profile
    prof.argtypes = [ctypes.c_int, ctypes.c_void_p]
    prof.restype = ctypes.c_int
    words = (ctypes.c_ulonglong * 8)()
    torch.cuda.synchronize()
    cuda_lib.check_rc(lib, prof(1, None), "profile on")
    call()
    torch.cuda.synchronize()
    cuda_lib.check_rc(lib, prof(0, ctypes.addressof(words)), "profile off")
    return {"products_ms": words[0] / 1e6, "row_stage_ms": words[1] / 1e6,
            "tail_ms": words[2] / 1e6, "steps": int(words[4])}


MODES = ("plan", "never", "always")


def tile_mode(mode: str) -> None:
    """Plans every search's stages in slabs only (``never``) or in tiles
    from one live row wherever a stage may take them (``always``), where
    the checkout plans tiles."""
    from icee_tpu_torch.ops import att_beam, beam

    if mode == "plan" or not hasattr(beam, "tile_min_rows"):
        return
    beam.tile_min_rows = lambda *args: 1 if mode == "always" else 0
    beam.grid_plan.cache_clear()
    att_beam.att_grid_plan.cache_clear()


def turn(root: str, names, mode: str, raw: bool) -> None:
    """One checkout's turn (in its own process, cwd = root)."""
    sys.path.insert(0, root)
    import torch

    import chip_smoke as cs
    from icee_tpu_torch.core.device import set_float32_precision
    from icee_tpu_torch.ops import att_beam, beam, cuda_lib

    paths = cuda_lib.build_all(("beam", "att_beam"))
    for name, path in paths.items():
        with open(path + ".log", errors="replace") as f:
            report = [ln.strip() for ln in f if "registers" in ln
                      or "spill" in ln]
        print(f"{root} {name} ptxas: {report}", flush=True)
    set_float32_precision()
    tile_mode(mode)
    device = torch.device("cuda", 0)
    decs = cs.decoder_params(device)
    libs = {"k2": beam._library(), "k7": att_beam._library()}
    split = getattr(beam, "search_split", None)
    res = {}
    with torch.inference_mode():
        for name in names:
            op, cell, n_img, k, steps, p = CASES[name]
            if op == "k2":
                dec = decs["stylenet" if cell == "factored" else "nic"][
                    "decoder"]
                style = 2 if cell == "factored" else 0
                g = torch.Generator(device=device).manual_seed(4)
                feats = torch.randn((n_img, 1, cs.E), generator=g,
                                    device=device)
                feats = feats.expand(n_img, k, cs.E).contiguous()

                def call():
                    return beam.mega_beam_decode(
                        dec, feats, style, n_img, k=k, max_seq_length=steps,
                        cell=cell)
            else:
                dec = decs[cs.ATT_KINDS[cell]]["decoder"]
                style = 3 if cell == "factored" else 0
                g = torch.Generator(device=device).manual_seed(14)
                feats = 0.3 * torch.rand((n_img, p or cs.P, cs.FS),
                                         generator=g, device=device)

                def call():
                    return att_beam.mega_att_beam_decode(
                        dec, feats, style, n_img, k=k, max_seq_length=steps,
                        kind=cell)

            got = call()
            torch.cuda.synchronize()
            r = {"digest": digest(got.tokens, got.length, got.score)}
            first = cs.cuda_ms(call, 1, 0)
            r["ms"] = cs.cuda_ms(call, 3 if first > 5 else 10, 1)
            lib = libs[op]
            if split is not None:
                r["split"] = split(lib, call, raw=raw)
            elif hasattr(lib, "icee_grid_profile"):
                r["split"] = raw_split(lib, call)
            res[name] = r
            shown = dict(r, split={k: v for k, v in r.get("split", {}).items()
                                   if k != "raw"})
            print(f"{root} {name}: {json.dumps(shown)}", flush=True)
            torch.cuda.empty_cache()
    print(TAG + json.dumps({"root": root, "tile": mode,
                            "card": torch.cuda.get_device_name(0),
                            "cases": res}), flush=True)


def main(args) -> int:
    out_json, names, raw = None, list(CASES), False
    while args and args[0].startswith("--"):
        opt = args.pop(0)
        if opt == "--json":
            out_json = args.pop(0)
        elif opt == "--cases":
            names = args.pop(0).split(",")
        elif opt == "--raw":
            raw = True
        elif opt == "--turn":   # internal: one turn in this process
            root, _, mode = args[0].partition("@")
            turn(root, names, mode or "plan", raw)
            return 0
        else:
            raise SystemExit(f"unknown option {opt}")
    if not args:
        raise SystemExit(__doc__)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(f"card: {smi.stdout.strip()}")
    results = []
    for i, arg in enumerate(args):
        root, _, mode = arg.partition("@")
        if mode not in ("",) + MODES:
            raise SystemExit(f"{arg}: the mode is one of {MODES}")
        cmd = [sys.executable, os.path.abspath(__file__), "--cases",
               ",".join(names)] + (["--raw"] if raw else []) + [
               "--turn", os.path.abspath(root) + "@" + (mode or "plan")]
        p = subprocess.run(cmd, cwd=os.path.abspath(root),
                           capture_output=True, text=True)
        print(f"--- turn {i}: {arg} (rc {p.returncode})")
        print(p.stdout[-8000:])
        if p.returncode != 0:
            print(p.stderr[-6000:])
            return 1
        line = next(ln for ln in p.stdout.splitlines()
                    if ln.startswith(TAG))
        results.append(json.loads(line[len(TAG):]))
    bad = [n for n in names
           if len({r["cases"][n]["digest"] for r in results}) != 1]
    print(f"{'case':18s} " + " ".join(f"{'turn %d' % i:>10s}"
                                      for i in range(len(args))))
    for n in names:
        print(f"{n:18s} " + " ".join(f"{r['cases'][n]['ms']:10.3f}"
                                     for r in results))
    print("products / row stage / tail, ms")
    for n in names:
        cells = []
        for r in results:
            s = r["cases"][n].get("split")
            cells.append("-" if s is None else
                         f"{s['products_ms']:.2f}/{s['row_stage_ms']:.2f}/"
                         f"{s['tail_ms']:.2f}")
        print(f"{n:18s} " + " ".join(f"{c:>18s}" for c in cells))
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
