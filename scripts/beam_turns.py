#!/usr/bin/env python3
"""K2 (the whole beam search of StyleNet and NIC) and the served beams
that run it, for several checkouts in turn on one NVIDIA GPU, so that two
versions are compared on one card.

Run from the repository root on a machine with the card, with the other
version unpacked into a directory that git ignores:

    mkdir -p _archive/parent && git archive <commit> | tar -x -C _archive/parent
    python3 scripts/beam_turns.py _archive/parent . . _archive/parent

(``--json PATH`` first: also write every turn's results to PATH.)

Each argument is a checkout's root.  Each turn runs in a process of its
own that imports that checkout's ``chip_smoke`` and ``icee_tpu_torch``,
builds the serving kernels into that checkout, and with
``chip_smoke.captioning_params``' seeded flagship weights (E = 300, F = H =
512, V = 8192, k = 5, 40 steps) times ``mega_beam_decode`` at 1, 8 and 64
images for both cells (CUDA events, mean of 5 after a warm-up; serving
mode, the features of ``chip_smoke.check_k2``), then builds the caption
engine as ``chip_smoke.serve_phase`` does and runs its
``request_breakdown`` (host time of each served piece, median of 5, and
its device busy share).  Every turn's K2 results must be the same bits as
the first turn's.  The script prints each turn's log, a table by turn and
a JSON line of it.
"""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys
import tempfile

TAG = "TURN-RESULT "
IMAGES = (1, 8, 64)
PIECES = ("nic_serial_beam_one_image", "batched_beam_8_images",
          "nic_batched_beam_8_images", "serial_beam_one_image")


def turn(root: str) -> None:
    """One checkout's figures; prints TAG + JSON as its last line."""
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    os.chdir(root)
    import numpy as np
    import torch
    from PIL import Image

    import chip_smoke as cs
    from icee_tpu_torch.core.device import set_float32_precision
    from icee_tpu_torch.ops import cuda_lib
    from icee_tpu_torch.ops.beam import mega_beam_decode
    from icee_tpu_torch.serve.config import ServeConfig
    from icee_tpu_torch.serve.engine import CaptionEngine

    if not torch.cuda.is_available():
        raise SystemExit("beam_turns: CUDA is not available")
    cuda_lib.build_all(["decode_step", "beam", "att_decode_step",
                        "att_beam"])
    set_float32_precision()
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = True
    device = torch.device("cuda", 0)
    params = cs.captioning_params(device)
    k2 = {}
    with torch.inference_mode():
        for cell, variant, style in (("factored", "stylenet", 2),
                                     ("lstm", "nic", 0)):
            dec = params[variant]["decoder"]
            for n in IMAGES:
                g = torch.Generator(device=device).manual_seed(4)
                feats = torch.randn((n, 1, cs.E), generator=g, device=device)
                feats = feats.expand(n, cs.K, cs.E).contiguous()

                def run(d=dec, f=feats, s=style, b=n, c=cell):
                    return mega_beam_decode(d, f, s, b, k=cs.K,
                                            max_seq_length=cs.STEPS, cell=c)

                res = run()
                digest = hashlib.sha256()
                for t in (res.tokens, res.length, res.score):
                    digest.update(t.cpu().numpy().tobytes())
                k2[f"{cell}_{n}"] = {"ms": cs.cuda_ms(run, 5),
                                     "bits": digest.hexdigest()[:16]}
    with tempfile.TemporaryDirectory() as tmp:
        rng = np.random.default_rng(5)
        paths = []
        for i in range(cs.N_REQUESTS // 2):
            base = rng.integers(0, 255, (8, 8, 3), dtype=np.uint8)
            img = Image.fromarray(base).resize((256, 256), Image.BILINEAR)
            p = os.path.join(tmp, f"photo{i}.jpg")
            img.save(p, quality=90)
            paths.append(p)
        config = ServeConfig(backend_host="127.0.0.1", backend_port=0,
                             image_folder=os.path.join(tmp, "uploads"),
                             vocab_path=cs.serving_vocab(tmp),
                             batch_window_ms=0.0)
        engine = CaptionEngine(config, image_size=224, device=device,
                               params=params)
        engine.caption(paths[0], "happy")   # warm-up: cuDNN and allocator
        pieces = cs.request_breakdown(engine, paths)
    print(TAG + json.dumps({"root": root, "k2": k2, "pieces": pieces}),
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
    for key, entry in turns[0]["k2"].items():
        for t in turns[1:]:
            if t["k2"][key]["bits"] != entry["bits"]:
                raise SystemExit(f"K2 {key}: turn {t['turn']} ({t['arg']}) "
                                 "gives other bits than turn 0")
    print("K2 ms by turn (" + ", ".join(roots) + "):")
    for key in turns[0]["k2"]:
        print(f"  {'mega_beam_decode ' + key:36s} " + "  ".join(
            f"{t['k2'][key]['ms']:8.3f}" for t in turns))
    print("served pieces, host ms (device busy share) by turn:")
    for name in PIECES:
        print(f"  {name:36s} " + "  ".join(
            f"{t['pieces'][name]['ms']:8.3f} "
            f"({t['pieces'][name]['device_busy_share'] or 0:.2f})"
            for t in turns))
    print(json.dumps({"beam_turns": [
        {"arg": t["arg"], "k2_ms": {k: e["ms"] for k, e in t["k2"].items()},
         "pieces_ms": {n: t["pieces"][n]["ms"] for n in PIECES}}
        for t in turns]}))
    print(smi)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--turn"]:
        turn(sys.argv[2])
    else:
        sys.exit(main(sys.argv[1:]))
