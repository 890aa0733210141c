#!/usr/bin/env python3
"""K2 (the whole beam search of StyleNet and NIC) or K7 (the whole
attention beam search of StyleNet+Att and NIC+Att) and the served beams
that run it, or K9 / K10 (the SentiCap beam-20 searches), for several
checkouts in turn on one NVIDIA GPU, so that two versions are compared on
one card.

Run from the repository root on a machine with the card, with the other
version unpacked into a directory that git ignores:

    mkdir -p _archive/parent && git archive <commit> | tar -x -C _archive/parent
    python3 scripts/beam_turns.py _archive/parent . . _archive/parent
    python3 scripts/beam_turns.py --kernel k7 _archive/parent . . _archive/parent
    python3 scripts/beam_turns.py --kernel k9 _archive/parent . . _archive/parent

(``--json PATH`` first: also write every turn's results to PATH;
``--kernel k2`` is the default; ``k9`` and ``k10`` take the same turns.)

Each argument is a checkout's root.  Each turn runs in a process of its
own that imports that checkout's ``chip_smoke`` and ``icee_tpu_torch``,
builds the serving kernels into that checkout, and with
``chip_smoke.captioning_params``' seeded flagship weights (E = 300, F = H =
512, V = 8192, k = 5, 40 steps; attention A = 512, P = 196, FS = 2048)
times the kernel (CUDA events, mean of 5 after a warm-up): K2,
``mega_beam_decode``, at 1, 8 and 64 images for both cells (serving mode,
the features of ``chip_smoke.check_k2``); K7, ``mega_att_beam_decode``, at
1, 2, 8 and 64 images for both kinds (the features of
``chip_smoke.check_k7``), and with it the fused-step path's h0/c0 launch,
``att_init_state``, at 1, 2, 8 and 64 images (StyleNet+Att weights, the
features of ``chip_smoke.check_att_init``; CUDA events, mean of 50 after
5 warm-ups, and its kernels' device time in a profiler trace, in all
and launch by launch, this tree's ``chip_smoke.kernels_device_ms`` and
``launches_device_ms``).  Then it builds the caption engine as
``chip_smoke.serve_phase`` does and runs its ``request_breakdown`` (host
time of each served piece, median of 5, and its device busy share; a piece
a checkout does not time shows as absent).  Every turn's kernel results
must be the same bits as the first turn's.  The script prints each turn's
log, a table by turn and a JSON line of it.

``--kernel k9`` / ``k10``: each turn builds the SentiCap decode kernels
and times K9, ``mega_senticap_beam_decode``, and K10,
``mega_senticap_switched_decode``, at 64 images, beam 20, max_len 20 on
``chip_smoke.senticap_decoder`` / ``chip_smoke.switched_params`` weights
and the features of ``chip_smoke.check_k9`` / ``check_k10`` (CUDA events,
mean of 5 after a warm-up), profiles one call by launch group (this
tree's ``chip_smoke.senticap_device_groups``, whichever checkout runs) and
times ``torch.matmul`` (float32, TF32 off) at the search's two product
shapes as a yardstick.  Turns of one checkout must give the same bits.
Between checkouts, whose products may round differently, the comparison is
margin-aware as ``chip_smoke.py``'s phases 14 and 17: each image's scores
within 1e-3, and where the tokens differ, the two sequences' plain
re-scores (``chip_smoke.senticap_rescore`` / ``switched_rescore``) within
1e-4 of each other.  Both kernels run in every turn; ``--kernel`` says
which one heads the table.
"""

from __future__ import annotations

import hashlib
import importlib.util
import json
import os
import subprocess
import sys
import tempfile

TAG = "TURN-RESULT "
# by kernel: (images a call, (cell or kind, served variant, style), the
# served pieces of request_breakdown to show)
KERNELS = {
    "k2": ((1, 8, 64), (("factored", "stylenet", 2), ("lstm", "nic", 0)),
           ("nic_serial_beam_one_image", "batched_beam_8_images",
            "nic_batched_beam_8_images", "serial_beam_one_image",
            "fused_step_beam_one_image")),
    "k7": ((1, 2, 8, 64), (("factored", "stylenet_att", 3),
                           ("lstm", "nic_att", 0)),
           ("stylenet_att_serial_beam_one_image",
            "stylenet_att_fused_step_beam_one_image",
            "nic_att_serial_beam_one_image",
            "nic_att_fused_step_beam_one_image",
            "stylenet_att_batched_beam_8_images",
            "nic_att_batched_beam_8_images", "serial_beam_one_image",
            "encode_one_image", "caption_one_image")),
}


SENTICAP = ("k9", "k10")
HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def this_tree_smoke():
    """This tree's ``chip_smoke`` (its launch-group profile), whichever
    checkout a turn imports as ``chip_smoke``."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_here", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def senticap_turn(cs, device) -> dict:
    """K9 and K10 at chip_smoke's decode shapes: ms, bits, the results,
    their plain re-scores and one call's launch groups; the matmul
    yardstick."""
    import torch

    from icee_tpu_torch.ops import senticap_decode as sd
    from icee_tpu_torch.ops import senticap_switched_decode as ssd

    here = this_tree_smoke()
    kw = dict(beam_size=cs.SC_BEAM, max_len=cs.SC_MAXLEN)
    out = {}
    for name, params_fn, seed, call, rescore in (
            ("k9", cs.senticap_decoder, 62, sd.mega_senticap_beam_decode,
             cs.senticap_rescore),
            ("k10", cs.switched_params, 66,
             ssd.mega_senticap_switched_decode, cs.switched_rescore)):
        params = params_fn(device)
        g = torch.Generator(device=device).manual_seed(seed)
        v = torch.randn((cs.SC_IMAGES, cs.SC_VIS), generator=g,
                        device=device)

        def run(params=params, v=v, call=call):
            return call(params, v, cs.SC_IMAGES, **kw)

        res = run()
        again = run()
        torch.cuda.synchronize()
        digest = hashlib.sha256()
        for t in res:
            digest.update(t.cpu().numpy().tobytes())
        rescored = rescore(params, v, res[1], res[2])
        out[name] = {"ms": cs.cuda_ms(run, 5), "bits": digest.hexdigest()[:16],
                     "same_bits_twice": all(torch.equal(a, b)
                                            for a, b in zip(res, again)),
                     "score": res[0].tolist(), "tokens": res[1].tolist(),
                     "length": res[2].tolist(),
                     "rescored": rescored.tolist(),
                     "groups": here.senticap_device_groups(name, run)}
        del params, v, res, again
    rows = cs.SC_IMAGES * cs.SC_BEAM
    yard = {}
    for shape, (m, k, n) in (("cell", (rows, cs.SC_E + cs.SC_H, 4 * cs.SC_H)),
                             ("head", (rows, cs.SC_H, cs.SC_V))):
        a = torch.randn((m, k), device=device)
        b = torch.randn((k, n), device=device)
        ms = cs.cuda_ms(lambda: torch.matmul(a, b), 20, warmup=3)
        yard[shape] = {"M": m, "K": k, "N": n, "ms": ms,
                       "tflops": 2.0 * m * n * k / ms / 1e9,
                       "allow_tf32": torch.backends.cuda.matmul.allow_tf32}
    out["matmul_yardstick"] = yard
    return out


def kernel_call(cs, kernel: str, dec, cell: str, style: int, n: int,
                device):
    """A call of the kernel on ``n`` images of the smoke's features."""
    import torch

    if kernel == "k2":
        from icee_tpu_torch.ops.beam import mega_beam_decode

        g = torch.Generator(device=device).manual_seed(4)
        feats = torch.randn((n, 1, cs.E), generator=g, device=device)
        feats = feats.expand(n, cs.K, cs.E).contiguous()
        return lambda: mega_beam_decode(dec, feats, style, n, k=cs.K,
                                        max_seq_length=cs.STEPS, cell=cell)
    from icee_tpu_torch.ops.att_beam import mega_att_beam_decode

    feats = cs.att_features(device, n, 14)
    return lambda: mega_att_beam_decode(dec, feats, style, n, k=cs.K,
                                        max_seq_length=cs.STEPS, kind=cell)


def init_turn(cs, dec, images, device) -> dict:
    """The h0/c0 launch at each image count: ms by CUDA events, its
    kernels' device ms and the bits of h0 and c0."""
    from icee_tpu_torch.ops.att_decode_step import att_init_state

    here = this_tree_smoke()
    out = {}
    for n in images:
        feats = cs.att_features(device, n, 9)

        def run(feats=feats):
            return att_init_state(dec, feats)

        digest = hashlib.sha256()
        for t in run():
            digest.update(t.cpu().numpy().tobytes())
        out[f"init_{n}"] = {
            "ms": cs.cuda_ms(run, 50, 5), "bits": digest.hexdigest()[:16],
            "device_ms": here.kernels_device_ms(run, here.INIT_KERNELS, 50),
            "by_launch": here.launches_device_ms(run, here.INIT_KERNELS, 50)}
    return out


def turn(root: str, kernel: str) -> None:
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
    from icee_tpu_torch.serve.config import ServeConfig
    from icee_tpu_torch.serve.engine import CaptionEngine

    if not torch.cuda.is_available():
        raise SystemExit("beam_turns: CUDA is not available")
    device = torch.device("cuda", 0)
    if kernel in SENTICAP:
        cuda_lib.build_all(["senticap_beam", "senticap_switched_beam"])
        set_float32_precision()
        with torch.inference_mode():
            timed = senticap_turn(cs, device)
        print(TAG + json.dumps({"root": root, "senticap": timed}),
              flush=True)
        return
    cuda_lib.build_all(["decode_step", "beam", "att_decode_step",
                        "att_beam"])
    set_float32_precision()
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = True
    params = cs.captioning_params(device)
    images, cells, _ = KERNELS[kernel]
    timed = {}
    with torch.inference_mode():
        for cell, variant, style in cells:
            dec = params[variant]["decoder"]
            for n in images:
                run = kernel_call(cs, kernel, dec, cell, style, n, device)
                res = run()
                digest = hashlib.sha256()
                for t in (res.tokens, res.length, res.score):
                    digest.update(t.cpu().numpy().tobytes())
                timed[f"{cell}_{n}"] = {"ms": cs.cuda_ms(run, 5),
                                        "bits": digest.hexdigest()[:16]}
        if kernel == "k7":
            timed.update(init_turn(cs, params["stylenet_att"]["decoder"],
                                   images, device))
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
    print(TAG + json.dumps({"root": root, "kernel": timed,
                            "pieces": pieces}), flush=True)


def main(args) -> int:
    json_path, kernel = None, "k2"
    while args[:1] in (["--json"], ["--kernel"]):
        if args[0] == "--json":
            json_path = args[1]
        else:
            kernel = args[1]
        args = args[2:]
    roots = args
    if not roots or kernel not in tuple(KERNELS) + SENTICAP:
        raise SystemExit(__doc__)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(f"nvidia-smi: {smi}", flush=True)
    turns = []
    for i, root in enumerate(roots):
        proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                               "--turn", kernel, root], capture_output=True,
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
            json.dump({"device": smi, "kernel": kernel, "turns": turns}, f,
                      indent=1)
    if kernel in SENTICAP:
        return senticap_table(kernel, roots, turns, smi)
    name = {"k2": "mega_beam_decode", "k7": "mega_att_beam_decode"}[kernel]
    for key, entry in turns[0]["kernel"].items():
        for t in turns[1:]:
            if t["kernel"][key]["bits"] != entry["bits"]:
                raise SystemExit(f"{name} {key}: turn {t['turn']} "
                                 f"({t['arg']}) gives other bits than turn 0")
    print(f"{name} ms by turn (" + ", ".join(roots) + "), then the h0/c0 "
          "launch's (CUDA events; its kernels' device ms):")
    for key in turns[0]["kernel"]:
        label = key if key.startswith("init") else f"{name} {key}"
        print(f"  {label:36s} " + "  ".join(
            f"{t['kernel'][key]['ms']:8.4f}" for t in turns))
        if key.startswith("init"):
            print(f"  {'  device':36s} " + "  ".join(
                f"{t['kernel'][key]['device_ms'] or 0:8.4f}" for t in turns))
            print(f"  {'  device by launch, gaps':36s} " + "  ".join(
                json.dumps(t["kernel"][key].get("by_launch"))
                for t in turns))
    print("served pieces, host ms (device busy share) by turn:")
    pieces = KERNELS[kernel][2]

    def cell(t, piece):
        got = t["pieces"].get(piece)
        if got is None:
            return f"{'absent':>15s}"
        return f"{got['ms']:8.3f} ({got['device_busy_share'] or 0:.2f})"

    for piece in pieces:
        print(f"  {piece:40s} " + "  ".join(cell(t, piece) for t in turns))
    print(json.dumps({"beam_turns": {"kernel": kernel, "turns": [
        {"arg": t["arg"], "ms": {k: e["ms"] for k, e in t["kernel"].items()},
         "device_ms": {k: e["device_ms"] for k, e in t["kernel"].items()
                       if "device_ms" in e},
         "pieces_ms": {n: t["pieces"][n]["ms"] for n in pieces
                       if n in t["pieces"]}}
        for t in turns]}}))
    print(smi)
    return 0


def compare_searches(key: str, a: dict, b: dict) -> list:
    """Margin-aware comparison of two turns' results of one search ->
    the images whose tokens differ (a near-tie flip each); raises where a
    score differs by more than 1e-3 or a flip's re-scores by more than
    1e-4."""
    flips = []
    for i, (sa, sb) in enumerate(zip(a["score"], b["score"])):
        n = a["length"][i]
        same = n == b["length"][i] and a["tokens"][i][:n] == b["tokens"][i][:n]
        if abs(sa - sb) > 1e-3:
            raise SystemExit(f"{key} image {i}: scores {sa} and {sb}")
        if not same:
            margin = abs(a["rescored"][i] - b["rescored"][i])
            if margin > 1e-4:
                raise SystemExit(f"{key} image {i}: tokens differ, re-scores "
                                 f"{a['rescored'][i]} and {b['rescored'][i]}")
            flips.append((i, margin))
    return flips


def senticap_table(kernel: str, roots, turns, smi: str) -> int:
    """K9 / K10 turns: bits within a checkout, margins between checkouts,
    then the table of times and launch groups by turn."""
    order = [kernel] + [k for k in SENTICAP if k != kernel]
    for key in order:
        first = {}
        for t in turns:
            entry = t["senticap"][key]
            if not entry["same_bits_twice"]:
                raise SystemExit(f"{key}: turn {t['turn']} gives other bits "
                                 "on a second call")
            ref = first.setdefault(os.path.abspath(t["arg"]), entry)
            if entry["bits"] != ref["bits"]:
                raise SystemExit(f"{key}: turn {t['turn']} ({t['arg']}) "
                                 "gives other bits than an earlier turn of "
                                 "its checkout")
        base = turns[0]["senticap"][key]
        for t in turns[1:]:
            flips = compare_searches(key, base, t["senticap"][key])
            if flips:
                print(f"{key}: turn {t['turn']} vs turn 0: near-tie flips "
                      f"(image, re-score margin) {flips}")
        same = all(t["senticap"][key]["bits"] == base["bits"] for t in turns)
        print(f"{key}: " + ("the same bits in every turn, every checkout"
                            if same else "other bits between checkouts"))
    print("ms by turn (" + ", ".join(roots) + "):")
    for key in order:
        print(f"  {key:36s} " + "  ".join(
            f"{t['senticap'][key]['ms']:8.3f}" for t in turns))
        groups = [t["senticap"][key]["groups"] or {} for t in turns]
        for g in sorted({g for gs in groups for g, v in gs.items()
                         if g.endswith("_ms") and v}):
            print(f"    {g:34s} " + "  ".join(
                f"{gs.get(g, 0.0):8.3f}" for gs in groups))
    yard = turns[0]["senticap"]["matmul_yardstick"]
    print("torch.matmul yardstick (float32, TF32 off): " + "; ".join(
        f"{s} {y['M']}x{y['K']}x{y['N']} {y['ms']:.3f} ms "
        f"{y['tflops']:.1f} TFLOP/s" for s, y in yard.items()))
    print(json.dumps({"beam_turns": {"kernel": kernel, "turns": [
        {"arg": t["arg"], "ms": {k: t["senticap"][k]["ms"] for k in order},
         "groups": {k: t["senticap"][k]["groups"] for k in order}}
        for t in turns], "matmul_yardstick": yard}}))
    print(smi)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--turn"]:
        turn(sys.argv[3], sys.argv[2])
    else:
        sys.exit(main(sys.argv[1:]))
