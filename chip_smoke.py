#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (built for H100).

Run from the repository root:  python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

1. require CUDA; print the card's name and power limit (nvidia-smi);
2. build the hand-written kernels from ``icee_tpu_torch/csrc`` (one nvcc per
   source, all at once) into ``icee_tpu_torch/_build/``;
3. turn TF32 off for matmuls and cuDNN, so float32 means float32;
4. K1 (``decode_step_topk``) vs its plain PyTorch version at E=300,
   F=H=512, V=8192: at the serial path's 5 rows (one image x 5 beams) and
   at 64 images x 5 beams = 320 rows, which is timed;
5. K2 (``mega_beam_decode``) vs the plain ``beam_search_batched`` search at
   64 images, V=8192, 40 steps, in both feature modes; where tokens differ,
   the plain model's score of the kernel's sequence must tie the plain
   winner's within 1e-4;
6. serve: a random-init StyleNet at flagship width (ResNet-152 at 224x224,
   E=300, H=F=512, V=8192, k=5, 40 steps) behind the HTTP service.  First
   with cross-request batching: concurrent ``POST /generate`` requests in
   all four modes (batched path, K2).  Then without batching: the same
   requests one by one (serial path, K1).  Captions must match, and each
   path's kernel must have launched (its count is reset to 0 just before
   the path runs and read just after);
7. print one ``{"kernels": [...]}`` line and one ``{"serve": {...}}`` line;
8. print ``{"ok": true, "device": {...}}`` as the last line.
"""

from __future__ import annotations

import contextlib
import json
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

# published H100 SXM peaks: HBM 3.35 TB/s, float32 outside the tensor cores
# 67 TFLOP/s (the kernels run float32 FMAs on the CUDA cores)
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12

B_IMAGES, K, E, F, H, V, STEPS = 64, 5, 300, 512, 512, 8192, 40
N_REQUESTS = 16
MODES = ("factual", "happy", "sad", "angry")


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"FAILED: {msg}")


def cuda_ms(fn, iters: int, warmup: int = 1) -> float:
    """Mean device time of ``fn`` over ``iters`` runs, by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(flops: float, nbytes: float):
    """(least time in ms, what bounds it) from operations and bytes."""
    t_ops, t_bytes = flops / F32_FLOP_PER_S, nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def step_flops_per_row() -> int:
    """Multiply-adds x2 of one decode step for one row: cell chain + head."""
    return 2 * (E * 4 * F + 4 * F * F + 4 * F * H + H * 4 * H + H * V)


def decoder_weight_bytes() -> int:
    return 4 * (E * 4 * F + 4 * F + 4 * F * F + 4 * F + 4 * F * H + 4 * H
                + H * 4 * H + 4 * H + H * V + V)


def captioning_params(device):
    """Seeded random weights at flagship width, shaped so beams finish at
    caption-like lengths: the smoke init's residual branches are damped
    (undamped He init grows ResNet activations ~1e4x over 50 blocks), the
    encoder head is scaled up so the step-1 feature is O(1) (the default
    init gives ~0.1, and every beam then emits <end> at once: an empty
    caption), and the decoder head is sharpened with a bias towards <end>
    (with near-uniform logits over 8192 words no beam ever completes)."""
    import torch

    from icee_tpu_torch.core.config import DecoderConfig, EncoderConfig
    from icee_tpu_torch.models import encoder, factored_lstm, resnet

    backbone = resnet.init_params(torch.Generator().manual_seed(0),
                                  device=device)
    for li in range(1, 5):
        for block in backbone[f"layer{li}"]:
            block["bn3"]["weight"].mul_(0.2)
    dec = factored_lstm.init_params(torch.Generator().manual_seed(1),
                                    DecoderConfig(vocab_size=V),
                                    device=device)
    dec["C_w"].mul_(30.0)
    dec["C_b"][2] = 2.0
    head = encoder.init_head_params(torch.Generator().manual_seed(2),
                                    EncoderConfig(), device=device)
    head["linear_w"].mul_(10.0)
    head["linear_b"].mul_(10.0)
    return {"backbone": backbone, "decoder": dec, "head": head}


# --- phase 4: K1 ------------------------------------------------------------

def check_k1(dec, device, rows: int, seed: int):
    """K1 vs its plain version on ``rows`` random rows; -> (inputs, max abs
    error, near-tie swaps).  Fails on any id outside a near tie or any
    error above 1e-4."""
    import torch

    from icee_tpu_torch.ops.cells import factored_lstm_cell
    from icee_tpu_torch.ops.decode_step import (decode_step_topk,
                                                decode_step_topk_plain)

    style = 1
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((rows, E), generator=g, device=device) * 0.5
    h = torch.randn((rows, H), generator=g, device=device) * 0.5
    c = torch.randn((rows, H), generator=g, device=device) * 0.5

    got = decode_step_topk(dec, x, h, c, style, ktop=K)
    want = decode_step_topk_plain(dec, x, h, c, style, ktop=K)
    torch.cuda.synchronize()
    gv, gi, gh, gc = got
    wv, wi, wh, wc = want
    # ids exact, except where the kernel picked an entry whose plain
    # log-prob ties the plain top-k within 1e-5 (a near-tie swap)
    h2, _ = factored_lstm_cell(dec, x, h, c, style)
    logp = torch.log_softmax(h2 @ dec["C_w"] + dec["C_b"], dim=-1)
    mism = (gi != wi).any(dim=1)
    ties = 0
    for r in torch.nonzero(mism).flatten().tolist():
        picked = logp[r, gi[r].long()]
        if (picked - wv[r]).abs().max().item() > 1e-5:
            fail(f"K1 {rows} rows, row {r}: ids {gi[r].tolist()} != "
                 f"{wi[r].tolist()} beyond a 1e-5 near-tie")
        ties += 1
    ok = ~mism
    errs = {"logp": (gv[ok] - wv[ok]).abs().max().item(),
            "h": (gh - wh).abs().max().item(),
            "c": (gc - wc).abs().max().item()}
    log(f"K1: {rows} rows, ids equal on {int(ok.sum())}, near-tie swaps "
        f"{ties}; max abs err {errs}")
    for name, err in errs.items():
        if not err <= 1e-4:
            fail(f"K1 {rows} rows: {name} error {err} > 1e-4")
    return (x, h, c, style), max(errs.values()), ties


def k1_line(dec, inputs, max_err: float, ties: int):
    """Times K1, its plain version and the library yardstick on
    ``inputs``; -> K1's entry of the kernels line."""
    import torch

    from icee_tpu_torch.ops.cells import factored_lstm_cell
    from icee_tpu_torch.ops.decode_step import (decode_step_topk,
                                                decode_step_topk_plain)

    x, h, c, style = inputs
    rows = x.shape[0]

    def library():
        h_new, _ = factored_lstm_cell(dec, x, h, c, style)
        return torch.topk(torch.log_softmax(
            torch.addmm(dec["C_b"], h_new, dec["C_w"]), dim=-1), K)

    ms = cuda_ms(lambda: decode_step_topk(dec, x, h, c, style, ktop=K), 20)
    plain_ms = cuda_ms(
        lambda: decode_step_topk_plain(dec, x, h, c, style, ktop=K), 20)
    lib_ms = cuda_ms(library, 20)
    nbytes = decoder_weight_bytes() + 4 * rows * (E + 2 * H) \
        + 4 * rows * (2 * K + 2 * H)
    b_ms, b_by = bound_ms(rows * step_flops_per_row(), nbytes)
    return {"name": "decode_step_topk", "route": "cuda",
            "source": "icee_tpu_torch/csrc/decode_step.cu",
            "replaces": "icee_tpu/ops/pallas_decode.py:261",
            "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
            "near_tie_swaps": ties}


# --- phase 5: K2 ------------------------------------------------------------

def sequence_scores(dec, feats, style: int, tokens, length):
    """Log-probability under the plain model of each image's token sequence
    (``<start>`` at 0; the feature fed at step 1 when ``feats`` is given):
    the score a beam search gives that sequence.  Summed step by step in
    float32, as the search does."""
    import torch

    from icee_tpu_torch.models import factored_lstm as fl

    tok = tokens.long()
    zeros = torch.zeros((tok.shape[0], H), device=tok.device)
    state = (zeros, zeros.clone())
    x = feats[:, 0] if feats is not None else fl.embed(dec, tok[:, 0])
    total = torch.zeros((tok.shape[0],), device=tok.device)
    for t in range(1, int(length.max())):
        logits, state = fl.decode_step(dec, x, state, style)
        lp = torch.log_softmax(logits.float(), dim=-1)
        total = torch.where(t < length, total + lp.gather(
            1, tok[:, t:t + 1])[:, 0], total)
        x = fl.embed(dec, tok[:, t])
    return total


def check_k2(dec, device):
    import torch

    from icee_tpu_torch.ops.beam import (mega_beam_decode,
                                         mega_beam_decode_plain,
                                         mega_beam_decode_steps)

    style = 2
    g = torch.Generator(device=device).manual_seed(4)
    feats = torch.randn((B_IMAGES, 1, E), generator=g, device=device)
    feats = feats.expand(B_IMAGES, K, E).contiguous()
    max_err, own_err, total_steps, flips = 0.0, 0.0, 0, 0
    for mode_feats in (feats, None):
        got, steps = mega_beam_decode_steps(dec, mode_feats, style,
                                            B_IMAGES, k=K,
                                            max_seq_length=STEPS)
        want = mega_beam_decode_plain(dec, mode_feats, style, B_IMAGES,
                                      k=K, max_seq_length=STEPS)
        # the plain model's score of the kernel's own sequences: a wrong
        # token, parent or length shows here even where the kernel's
        # reported score is right
        rescored = sequence_scores(dec, mode_feats, style, got.tokens,
                                   got.length)
        mode = "serving" if mode_feats is not None else "research"
        for i in range(B_IMAGES):
            gs, ws = got.score[i].item(), want.score[i].item()
            same = (got.length[i] == want.length[i]).item() and torch.equal(
                got.tokens[i], want.tokens[i])
            if int(got.length[i]) > 1:
                own = abs(rescored[i].item() - gs)
                own_err = max(own_err, own)
                if not own <= 1e-3:
                    fail(f"K2 {mode} image {i}: reported score {gs}, its "
                         f"sequence scores {rescored[i].item()}")
            if not same:
                # a near tie: the kernel's sequence scores within 1e-4 of
                # the plain winner's under the plain model
                margin = abs(rescored[i].item() - ws)
                if int(got.length[i]) == 1 or margin > 1e-4:
                    fail(f"K2 {mode} image {i}: tokens differ; kernel's "
                         f"sequence scores {rescored[i].item()}, plain "
                         f"winner {ws}, margin {margin} > 1e-4")
                flips += 1
                log(f"K2 {mode} image {i}: near-tie flip, margin {margin}")
            err = abs(gs - ws)
            if not err <= 1e-3:
                fail(f"K2 {mode} image {i}: score {gs} vs {ws}")
            max_err = max(max_err, err)
        lengths = got.length.float()
        log(f"K2 {mode}: {B_IMAGES} images, lengths mean "
            f"{lengths.mean().item():.2f} min {int(lengths.min())} max "
            f"{int(lengths.max())}, steps run per block min "
            f"{int(steps.min())} max {int(steps.max())}; kernel scores vs "
            f"their sequences' plain scores, max abs err so far {own_err}")
        if mode_feats is not None:
            total_steps = int(steps.sum())  # the timed, serving-mode run

    ms = cuda_ms(lambda: mega_beam_decode(dec, feats, style, B_IMAGES, k=K,
                                          max_seq_length=STEPS), 5)
    plain_ms = cuda_ms(lambda: mega_beam_decode_plain(
        dec, feats, style, B_IMAGES, k=K, max_seq_length=STEPS), 3)
    rows_per_block = (B_IMAGES * K) // steps.numel()
    row_steps = total_steps * rows_per_block
    nbytes = (decoder_weight_bytes() + 4 * B_IMAGES * K * E
              + 4 * row_steps * E + 4 * B_IMAGES * (STEPS + 4))
    b_ms, b_by = bound_ms(row_steps * step_flops_per_row(), nbytes)
    return {"name": "mega_beam_decode", "route": "cuda",
            "source": "icee_tpu_torch/csrc/beam.cu",
            "replaces": "icee_tpu/ops/pallas_beam.py:350",
            "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "near_tie_flips": flips, "max_rescore_err": own_err}


# --- phase 6: serve -----------------------------------------------------------

def _post(url: str, path: str, mode: str):
    boundary = "chip-smoke-boundary"
    with open(path, "rb") as f:
        data = f.read()
    body = (f"--{boundary}\r\nContent-Disposition: form-data; name=\"file\"; "
            f"filename=\"{os.path.basename(path)}\"\r\nContent-Type: "
            "image/jpeg\r\n\r\n").encode() + data + \
        f"\r\n--{boundary}--\r\n".encode()
    req = urllib.request.Request(
        f"{url}/generate?mode={mode}", data=body, method="POST",
        headers={"Content-Type": f"multipart/form-data; boundary={boundary}"})
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=300) as resp:
        out = resp.status, json.loads(resp.read())
    return out + (time.perf_counter() - t0,)


@contextlib.contextmanager
def serving(config, engine, device):
    """The HTTP service on an ephemeral local port, stopped on exit."""
    from icee_tpu_torch.serve.app import serve

    httpd = serve(config, engine=engine, device=device)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        yield f"http://127.0.0.1:{httpd.server_address[1]}"
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=60)


def run_requests(url, requests, concurrent: bool):
    """POST every (image, mode) request, all at once or one after another;
    -> ({index: (status, body, seconds)}, wall seconds).  Fails unless each
    answer is HTTP 200 with a non-empty stylenet caption."""
    results = {}

    def worker(j, p, m):
        results[j] = _post(url, p, m)

    t0 = time.perf_counter()
    if concurrent:
        threads = [threading.Thread(target=worker, args=(j, p, m))
                   for j, (p, m) in enumerate(requests)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
    else:
        for j, (p, m) in enumerate(requests):
            worker(j, p, m)
    wall = time.perf_counter() - t0
    if len(results) != len(requests):
        fail(f"only {len(results)} of {len(requests)} requests answered")
    for j, (p, m) in enumerate(requests):
        status, body, _ = results[j]
        if status != 200 or not body.get("stylenet") or \
                body["stylenet"] == "-":
            fail(f"request {j} ({m}): HTTP {status}, {body}")
    return results, wall


def device_busy_share(fn):
    """Share of one run of ``fn``'s wall time in which the card was busy
    (kernels and copies), from a torch.profiler trace; None when the trace
    holds no device event.  The profiler's own host cost lengthens the run,
    so the share reads low."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    busy_us = sum(e.self_device_time_total for e in prof.events()
                  if e.device_type == DeviceType.CUDA
                  and not e.is_user_annotation)
    return busy_us / wall_us if busy_us > 0 else None


def request_breakdown(engine, paths, repeats: int = 5):
    """Device-synchronised host times (ms, median of ``repeats``) of the
    pieces of a request: image decode + ResNet-152 + head for one image,
    the serial beam (fused-step path, K1) for one image, and the batched
    beam (mega path, K2) for a group of len(paths) images; and each
    piece's device busy share (one profiled run)."""
    import torch

    def timed(fn):
        times = []
        for _ in range(repeats):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)

    feat = engine.encode(paths[0], "happy")
    group = torch.cat([engine.encode(p, "happy") for p in paths])
    pieces = {
        "encode_one_image": lambda: engine.encode(paths[0], "happy"),
        "serial_beam_one_image": lambda: engine.decode(feat, "happy",
                                                       "fused-step"),
        f"batched_beam_{len(paths)}_images": lambda: engine.decode(
            group, "happy", "mega"),
    }
    return {name: {"ms": timed(fn), "device_busy_share": device_busy_share(fn)}
            for name, fn in pieces.items()}


def serve_phase(params, device):
    import dataclasses

    import numpy as np
    from PIL import Image

    from icee_tpu_torch.data.vocab import SPECIALS, Vocabulary
    from icee_tpu_torch.ops.beam import mega_beam_decode
    from icee_tpu_torch.ops.decode_step import decode_step_topk
    from icee_tpu_torch.serve.config import ServeConfig
    from icee_tpu_torch.serve.engine import BEAM_K, CaptionEngine

    with tempfile.TemporaryDirectory() as tmp:
        vocab = Vocabulary()
        for w in SPECIALS:
            vocab.add_word(w)
        for i in range(V - len(SPECIALS)):
            vocab.add_word(f"kata{i:04d}")
        vocab.save(os.path.join(tmp, "vocab.pkl"))
        rng = np.random.default_rng(5)
        paths = []
        for i in range(N_REQUESTS // 2):
            base = rng.integers(0, 255, (8, 8, 3), dtype=np.uint8)
            img = Image.fromarray(base).resize((256, 256), Image.BILINEAR)
            p = os.path.join(tmp, f"photo{i}.jpg")
            img.save(p, quality=90)
            paths.append(p)
        requests = [(paths[i // 2], MODES[(i // 2 + i % 2) % 4])
                    for i in range(N_REQUESTS)]

        config = ServeConfig(backend_host="127.0.0.1", backend_port=0,
                             image_folder=os.path.join(tmp, "uploads"),
                             vocab_path=os.path.join(tmp, "vocab.pkl"),
                             batch_window_ms=200.0)
        t0 = time.perf_counter()
        engine = CaptionEngine(config, image_size=224, device=device,
                               params=params)
        engine.caption(paths[0], "happy")   # warm-up: cuDNN and allocator
        log(f"serve: engine ready in {time.perf_counter() - t0:.1f}s "
            f"(V={len(engine.vocab)}, E={engine.dec_cfg.embed_size}, "
            f"H={engine.dec_cfg.hidden_size}, F={engine.dec_cfg.factored_size}"
            f", k={BEAM_K}, steps={engine.dec_cfg.max_seq_length})")
        # path 1, batched: concurrent requests through the BatchingEngine
        # (mega path, K2); counts from 0 just before, read just after
        decode_step_topk.launches = mega_beam_decode.launches = 0
        with serving(config, engine, device) as url:
            batched, wall = run_requests(url, requests, concurrent=True)
        launches = {"mega_beam_decode": mega_beam_decode.launches,
                    "decode_step_topk_in_batched": decode_step_topk.launches}
        # path 2, serial: the same requests one by one through the
        # CaptionEngine alone (fused-step path, K1)
        serial_config = dataclasses.replace(config, batch_window_ms=0.0)
        decode_step_topk.launches = mega_beam_decode.launches = 0
        with serving(serial_config, engine, device) as url:
            serial, serial_wall = run_requests(url, requests,
                                               concurrent=False)
        launches["decode_step_topk"] = decode_step_topk.launches
        launches["mega_beam_decode_in_serial"] = mega_beam_decode.launches

        for j, (p, m) in enumerate(requests):
            got, want = batched[j][1]["stylenet"], serial[j][1]["stylenet"]
            if got != want:
                fail(f"request {j} ({m}): batched caption {got!r} != "
                     f"serial {want!r}")
        for name in ("mega_beam_decode", "decode_step_topk"):
            if launches[name] <= 0:
                fail(f"{name} was not launched on its serving path")
        lat = sorted(r[2] * 1e3 for r in batched.values())
        serial_lat = sorted(r[2] * 1e3 for r in serial.values())
        words = [len(batched[j][1]["stylenet"].split())
                 for j in range(len(requests))]
        log(f"serve: {len(requests)} captions equal on the batched and "
            f"serial paths; words per caption {min(words)}..{max(words)}; "
            f"e.g. {batched[0][1]['stylenet']!r}")
        stats = {"requests": len(requests), "wall_s": wall,
                 "captions_per_s": len(requests) / wall,
                 "p50_ms": statistics.median(lat), "max_ms": lat[-1],
                 "batch_window_ms": config.batch_window_ms,
                 "serial_wall_s": serial_wall,
                 "serial_captions_per_s": len(requests) / serial_wall,
                 "serial_p50_ms": statistics.median(serial_lat),
                 "image_size": 224,
                 "breakdown_ms": request_breakdown(engine, paths)}
        return launches, stats


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    from icee_tpu_torch.ops import cuda_lib

    device = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    log(f"phase 1: torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}; nvidia-smi: {smi}")

    t0 = time.perf_counter()
    libs = cuda_lib.build_all()
    log(f"phase 2: built {sorted(libs)} in {time.perf_counter() - t0:.1f}s")
    for name, path in sorted(libs.items()):
        if os.path.exists(path + ".log"):
            with open(path + ".log", errors="replace") as f:
                for line in f:
                    if "registers" in line or "spill" in line:
                        log(f"  {name}: {line.strip()}")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = True
    log("phase 3: TF32 off for matmul and cuDNN; cuDNN deterministic")

    params = captioning_params(device)
    with torch.inference_mode():
        # the serial path's R = 5 (partly filled blocks in all three
        # launches), then R = 320 (full blocks), which is also timed
        _, serial_err, serial_ties = check_k1(params["decoder"], device,
                                              K, 6)
        inputs, err, ties = check_k1(params["decoder"], device,
                                     B_IMAGES * K, 3)
        k1 = k1_line(params["decoder"], inputs, max(serial_err, err),
                     serial_ties + ties)
        log(f"phase 4: K1 ok, {k1['ms']:.3f} ms vs plain "
            f"{k1['plain_ms']:.3f} ms")
        k2 = check_k2(params["decoder"], device)
        log(f"phase 5: K2 ok, {k2['ms']:.3f} ms vs plain "
            f"{k2['plain_ms']:.3f} ms")

    launches, stats = serve_phase(params, device)
    log(f"phase 6: served {stats['requests']} requests, launches {launches}")
    k1["launches"] = launches["decode_step_topk"]
    k2["launches"] = launches["mega_beam_decode"]
    print(json.dumps({"serve": stats}))
    print(json.dumps({"kernels": [k1, k2]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
