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
7. K3 (``fused_factored_scan``, forward and backward) vs its plain versions
   at B=64, T=25, E=300, F=H=512;
8. the chunked cross-entropy's row passes vs their plain versions, and the
   whole chunked loss (kernel path) vs the plain path and the materialized
   ``masked_cross_entropy``, at 64 x 25 rows, V=8192;
9. training at flagship width (outside ``torch.inference_mode``): one
   factual step on the kernel path vs the plain path (losses and grads),
   30 factual steps (B=64) then 30 emotion steps (style 1, B=96) whose loss
   must fall, with every K3 and CE kernel's count reset to 0 just before and
   read just after; 3 steps at the reference's teacher-forcing ratio 0.8;
   one ``val_step``; the step time, captions/s and device-busy share;
10. print one ``{"train": {...}}`` line, one ``{"serve": {...}}`` line and
   one ``{"kernels": [...]}`` line (K1, K2, K3 forward and backward, CE
   forward and backward);
11. print ``{"ok": true, "device": {...}}`` as the last line.
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
LOSS_FALL = 0.9    # phase 9: last cycle's mean loss <= this x the first's
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


def device_time_by_kernel(fn, top: int = 12):
    """Device time (ms) of one run of ``fn`` summed by kernel name, the
    ``top`` largest, from a torch.profiler trace."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total]
    rows.sort(key=lambda r: -r[1])
    return [{"kernel": k[:90], "ms": ms, "count": n} for k, ms, n in rows[:top]]


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


# --- phases 7-9: training ---------------------------------------------------

T_STEPS, B_EMOTION = 25, 96   # bench.py's training shape; the emotion batch
WORDS = 400                   # the training captions' active vocabulary


def max_rel_err(got, want) -> float:
    """Max abs error over the reference's largest magnitude."""
    return ((got - want).abs().max() / want.abs().max().clamp(min=1e-30)
            ).item()


def cell_flops(b: int, t: int):
    """(forward, backward) FLOPs of K3 on (b, t) rows: the input-side chain
    and the recurrence; the backward's seven products over all rows plus
    the (T - 1) recurrent dh products."""
    n = b * t
    fwd = 2 * n * (E * 4 * F + 4 * F * F + 4 * F * H + H * 4 * H)
    bwd = (2 * n * (H * 4 * H + 8 * F * H + 8 * F * F + 8 * E * F)
           + 2 * b * (t - 1) * 4 * H * H)
    return fwd, bwd


def cell_weight_floats() -> int:
    return E * 4 * F + 4 * F + 4 * F * F + 4 * F + 4 * F * H + 4 * H \
        + H * 4 * H + 4 * H


def training_decoder(device, seed: int):
    """Seeded flagship-width decoder weights with non-zero biases."""
    import torch

    from icee_tpu_torch.core.config import DecoderConfig
    from icee_tpu_torch.models import factored_lstm

    dec = factored_lstm.init_params(
        torch.Generator().manual_seed(seed),
        DecoderConfig(vocab_size=V, embed_size=E, hidden_size=H,
                      factored_size=F), device=device)
    g = torch.Generator(device=device).manual_seed(seed)
    for k in ("V_b", "S_b", "U_b", "W_b", "C_b"):
        dec[k].copy_(0.1 * torch.randn(dec[k].shape, generator=g,
                                       device=device))
    return dec


def check_k3(device):
    """K3 forward and backward vs their plain versions at B=64, T=25.
    Tolerances: h and c atol 1e-4 (float32, sums over up to 4H = 2048 terms
    in other orders, values O(1)); dx and each weight grad max abs error
    <= 1e-3 x its largest magnitude (sums over all B*T = 1600 rows and a
    25-step reverse chain, in other orders).  -> (forward, backward)
    entries of the kernels line."""
    import torch

    from icee_tpu_torch.ops import lstm_scan

    dec = training_decoder(device, 7)
    style = 1
    p = {k: dec[k] for k in lstm_scan.CELL_KEYS}
    p["S_w"], p["S_b"] = dec["S_w"][style], dec["S_b"][style]
    g = torch.Generator(device=device).manual_seed(8)
    x = 0.5 * torch.randn((B_IMAGES, T_STEPS, E), generator=g, device=device)
    dh = 0.02 * torch.randn((B_IMAGES, T_STEPS, H), generator=g,
                            device=device)
    h_seq, c_seq, saved = lstm_scan.factored_scan_fwd(p, x)
    want_h, want_c = lstm_scan.fused_factored_scan_plain(p, x)
    dx, grads = lstm_scan.factored_scan_bwd(p, x, h_seq, c_seq, dh, saved)
    want_dx, want_g = lstm_scan.factored_scan_bwd_plain(p, x, h_seq, c_seq,
                                                        dh)
    dx2, grads2 = lstm_scan.factored_scan_bwd(p, x, h_seq, c_seq, dh, saved)
    torch.cuda.synchronize()
    fwd_err = max((h_seq - want_h).abs().max().item(),
                  (c_seq - want_c).abs().max().item())
    if not fwd_err <= 1e-4:
        fail(f"K3 forward: max abs error {fwd_err} > 1e-4")
    rel = {"x": max_rel_err(dx, want_dx)}
    rel.update({k: max_rel_err(grads[k], want_g[k])
                for k in lstm_scan.CELL_KEYS})
    for name, err in rel.items():
        if not err <= 1e-3:
            fail(f"K3 backward: d{name} error {err} x max|g| > 1e-3")
    if not (torch.equal(dx, dx2) and all(torch.equal(grads[k], grads2[k])
                                         for k in grads)):
        fail("K3 backward: two runs on the same inputs differ")
    log(f"K3: h/c max abs err {fwd_err:.3g}; grads max err / max|g| "
        f"{ {k: float(f'{v:.3g}') for k, v in rel.items()} }; backward "
        "bit-identical over two runs")

    ms_f = cuda_ms(lambda: lstm_scan.factored_scan_fwd(p, x), 10)
    plain_f = cuda_ms(lambda: lstm_scan.fused_factored_scan_plain(p, x), 5)
    ms_b = cuda_ms(lambda: lstm_scan.factored_scan_bwd(
        p, x, h_seq, c_seq, dh, saved), 10)
    plain_b = cuda_ms(lambda: lstm_scan.factored_scan_bwd_plain(
        p, x, h_seq, c_seq, dh), 5)
    n = B_IMAGES * T_STEPS
    flops_f, flops_b = cell_flops(B_IMAGES, T_STEPS)
    saved_floats = n * (8 * F + 4 * H)
    bytes_f = 4 * (cell_weight_floats() + n * E + 2 * n * H + saved_floats)
    bytes_b = 4 * (2 * cell_weight_floats() + 2 * n * E + 3 * n * H
                   + saved_floats)
    common = {"route": "cuda", "source": "icee_tpu_torch/csrc/lstm_scan.cu",
              "library_ms": None,
              "library_note": "no single PyTorch call computes a factored "
                              "LSTM with h = o * c"}
    bf, bf_by = bound_ms(flops_f, bytes_f)
    bb, bb_by = bound_ms(flops_b, bytes_b)
    return (dict(common, name="fused_factored_scan_fwd",
                 replaces="icee_tpu/ops/pallas_lstm.py:224",
                 max_abs_err=fwd_err, ms=ms_f, plain_ms=plain_f,
                 bound_ms=bf, bound_by=bf_by),
            dict(common, name="fused_factored_scan_bwd",
                 replaces="icee_tpu/ops/pallas_lstm.py:298",
                 max_abs_err=max((dx - want_dx).abs().max().item(),
                                 *((grads[k] - want_g[k]).abs().max().item()
                                   for k in grads)),
                 max_rel_err=max(rel.values()), ms=ms_b, plain_ms=plain_b,
                 bound_ms=bb, bound_by=bb_by))


def chunked_ce_plain(hid, w, b, tgt, weights, t_chunk, clamp=None):
    """The chunked loss and its grads with the plain row passes, by hand
    (no autograd): -> (loss, d hid, d w, d b)."""
    import torch

    from icee_tpu_torch.ops.chunked_loss import (_to_chunks,
                                                 ce_grad_rows_plain,
                                                 ce_rows_plain)

    bsz, t = tgt.shape
    xc = _to_chunks(hid, t_chunk)
    tc = _to_chunks(tgt, t_chunk)
    wc = _to_chunks(weights, t_chunk)
    one = torch.ones((), device=hid.device)
    loss = torch.zeros((), device=hid.device)
    d_w, d_b, dxs = torch.zeros_like(w), torch.zeros_like(b), []
    for k in range(xc.shape[0]):
        x = xc[k].reshape(-1, hid.shape[-1])
        logits = torch.addmm(b, x, w)
        lse, contrib = ce_rows_plain(logits, tc[k].reshape(-1),
                                     wc[k].reshape(-1), clamp)
        loss = loss + contrib.sum()
        dl, db = ce_grad_rows_plain(logits, tc[k].reshape(-1),
                                    wc[k].reshape(-1), lse, one, clamp)
        d_b += db
        d_w += x.T @ dl
        dxs.append((dl @ w.T).reshape(bsz, t_chunk, -1))
    return loss, torch.cat(dxs, 1)[:, :t], d_w, d_b


def training_batch(device, b: int, seed: int):
    """Seeded batch: pooled features (B, 2048) >= 0 like a ReLU network's,
    captions of ids in [4, V) from a Zipf law over WORDS fixed words (a
    language the decoder can learn), lengths 8..25, all rows valid."""
    import torch

    g = torch.Generator(device=device).manual_seed(seed)
    words = 4 + torch.randperm(V - 4, generator=torch.Generator()
                               .manual_seed(99))[:WORDS].to(device)
    zipf = 1.0 / torch.arange(1, WORDS + 1, device=device,
                              dtype=torch.float32)
    ids = torch.multinomial(zipf, b * T_STEPS, replacement=True,
                            generator=g).reshape(b, T_STEPS)
    return (torch.rand((b, 2048), generator=g, device=device),
            words[ids],
            torch.randint(8, T_STEPS + 1, (b,), generator=g, device=device),
            torch.ones((b,), dtype=torch.bool, device=device))


def check_ce(device):
    """The CE row passes vs their plain versions, and the whole chunked loss
    (kernel path) vs the plain path and the materialized loss, at 64 x 25
    rows, H = 512, V = 8192, lengths 8..25, two masked rows; t_chunk 25
    (auto) and 22 (the emotion batch's, not dividing T); the clamp form.
    Tolerances: lse and w*nll atol 1e-4 (values ~9, float32 sums over 8192
    terms in other orders); dl 1e-4 x its largest magnitude; the loss atol
    1e-5 and each grad 1e-3 x its largest magnitude (as phase 7).
    -> (forward entry, backward entry, whole-loss stats)."""
    import torch
    import torch.nn.functional as Fn

    from icee_tpu_torch.evaluation.metrics import masked_cross_entropy
    from icee_tpu_torch.ops import chunked_loss as cl

    dec = training_decoder(device, 9)
    w, b = dec["C_w"], dec["C_b"]
    g = torch.Generator(device=device).manual_seed(10)
    hid = 0.5 * torch.randn((B_IMAGES, T_STEPS, H), generator=g,
                            device=device)
    _, tgt, lens, smask = training_batch(device, B_IMAGES, 11)
    smask[[5, 40]] = False
    mask = (torch.arange(T_STEPS, device=device)[None] < lens[:, None]) \
        & smask[:, None]
    weights = mask.float() / mask.sum().clamp(min=1)
    n = B_IMAGES * T_STEPS

    # the row passes at the chunk's shape (auto t_chunk = 25: one chunk)
    logits = torch.addmm(b, hid.reshape(n, H), w)
    tflat, wflat = tgt.reshape(n), weights.reshape(n)
    errs = {}
    for clamp in (None, 8.0):
        lse, contrib = cl.ce_rows(logits, tflat, wflat, clamp)
        want_lse, want_c = cl.ce_rows_plain(logits, tflat, wflat, clamp)
        db = torch.zeros((V,), device=device)
        dl = cl.ce_grad_rows(logits.clone(), tflat, wflat, lse,
                             torch.ones((1,), device=device), db, clamp)
        want_dl, want_db = cl.ce_grad_rows_plain(
            logits, tflat, wflat, want_lse,
            torch.ones((), device=device), clamp)
        torch.cuda.synchronize()
        e = {"lse": (lse - want_lse).abs().max().item(),
             "w_nll": (contrib - want_c).abs().max().item(),
             "dl_rel": max_rel_err(dl, want_dl),
             "db_rel": max_rel_err(db, want_db)}
        for name, err in e.items():
            if not err <= 1e-4:
                fail(f"CE rows (clamp {clamp}): {name} error {err} > 1e-4")
        errs[f"clamp_{clamp}"] = e
    log(f"CE rows: errors {errs}")

    # the whole loss: kernel path vs plain path vs materialized
    whole = {}
    for t_chunk, clamp in ((None, None), (22, None), (22, 8.0)):
        hg, wg, bg = (a.detach().clone().requires_grad_(True)
                      for a in (hid, w, b))
        if clamp is None:
            loss = cl.masked_ce_from_hiddens(hg, wg, bg, tgt, lens, smask,
                                             t_chunk)
        else:
            loss = cl.masked_sum_ce_from_hiddens(hg, wg, bg, tgt, weights,
                                                 clamp, t_chunk)
        loss.backward()
        got = (loss.detach(), hg.grad, wg.grad, bg.grad)
        wants = {"plain": chunked_ce_plain(hid, w, b, tgt, weights,
                                           t_chunk or T_STEPS, clamp)}
        if clamp is None:
            hm, wm, bm = (a.detach().clone().requires_grad_(True)
                          for a in (hid, w, b))
            lm = masked_cross_entropy(hm @ wm + bm, tgt, lens, smask)
            lm.backward()
            wants["materialized"] = (lm.detach(), hm.grad, wm.grad, bm.grad)
        for ref, want in wants.items():
            lerr = (got[0] - want[0]).abs().item()
            gerr = [max_rel_err(a, c) for a, c in zip(got[1:], want[1:])]
            if not (lerr <= 1e-5 and max(gerr) <= 1e-3):
                fail(f"chunked CE t_chunk={t_chunk} clamp={clamp} vs {ref}:"
                     f" loss err {lerr}, grad errs {gerr}")
            whole[f"t{t_chunk or T_STEPS}_clamp{clamp}_vs_{ref}"] = {
                "loss_err": lerr, "grad_rel_errs": gerr}
    log(f"chunked CE vs plain and materialized: {whole}")

    # times: the row passes alone, then the whole loss forward + backward
    db = torch.zeros((V,), device=device)
    scratch = logits.clone()
    one = torch.ones((1,), device=device)
    lse, _ = cl.ce_rows(logits, tflat, wflat)
    ms_f = cuda_ms(lambda: cl.ce_rows(logits, tflat, wflat), 20)
    plain_f = cuda_ms(lambda: cl.ce_rows_plain(logits, tflat, wflat), 20)
    lib_f = cuda_ms(lambda: Fn.cross_entropy(logits, tflat,
                                             reduction="none"), 20)
    ms_b = cuda_ms(lambda: cl.ce_grad_rows(scratch, tflat, wflat, lse, one,
                                           db), 20)
    plain_b = cuda_ms(lambda: cl.ce_grad_rows_plain(
        logits, tflat, wflat, lse, one.reshape(()), None), 20)
    bf, bf_by = bound_ms(5 * n * V, 4 * (n * V + 4 * n))
    bb, bb_by = bound_ms(5 * n * V, 4 * (2 * n * V + 3 * n + V))

    hk, wk, bk = (a.detach().clone().requires_grad_(True) for a in (hid, w, b))
    y_ignore = torch.where(mask, tgt, -100).reshape(n)

    def kernel_path():
        cl.masked_ce_from_hiddens(hk, wk, bk, tgt, lens, smask).backward()

    def plain_path():
        chunked_ce_plain(hid, w, b, tgt, weights, T_STEPS)

    def library():
        Fn.cross_entropy(Fn.linear(hk.reshape(n, H), wk.T, bk),
                         y_ignore).backward()

    whole_ms = {"kernel_path_ms": cuda_ms(kernel_path, 10),
                "plain_path_ms": cuda_ms(plain_path, 10),
                "library_ms": cuda_ms(library, 10)}
    whole_ms["bound_ms"], whole_ms["bound_by"] = bound_ms(
        8 * n * H * V, 4 * (n * H * 2 + 2 * H * V + 2 * V + 3 * n))
    whole_ms["errors"] = whole
    common = {"route": "cuda", "source": "icee_tpu_torch/csrc/chunked_ce.cu"}
    return (dict(common, name="ce_rows",
                 replaces="icee_tpu/ops/chunked_loss.py:71 (_ce_forward, "
                          "under masked_ce_from_hiddens :142)",
                 max_abs_err=max(max(e["lse"], e["w_nll"])
                                 for e in errs.values()),
                 ms=ms_f, plain_ms=plain_f, bound_ms=bf, bound_by=bf_by,
                 library_ms=lib_f,
                 library_note="F.cross_entropy(logits, y, reduction='none')"),
            dict(common, name="ce_grad_rows",
                 replaces="icee_tpu/ops/chunked_loss.py:103 (_ce_bwd)",
                 max_abs_err=max(e["dl_rel"] for e in errs.values()),
                 ms=ms_b, plain_ms=plain_b, bound_ms=bb, bound_by=bb_by,
                 library_ms=None,
                 library_note="no single PyTorch call forms (softmax - "
                              "onehot) * w * g and its column sum"),
            whole_ms)


def step_ms(fn, n: int):
    """Median device time of ``n`` calls of ``fn``, each bracketed by its
    own CUDA events (the whole training step, Adam included)."""
    import torch

    fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(n):
        a = torch.cuda.Event(enable_timing=True)
        z = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        z.record()
        pairs.append((a, z))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(z) for a, z in pairs)


def train_phase(device):
    """Phase 9: the StyleNet train step at flagship width."""
    import math

    import torch

    from icee_tpu_torch.core.config import (DecoderConfig, EncoderConfig,
                                            TrainConfig)
    from icee_tpu_torch.models import encoder
    from icee_tpu_torch.ops import chunked_loss as cl
    from icee_tpu_torch.ops import lstm_scan
    from icee_tpu_torch.train import optim
    from icee_tpu_torch.train.steps import make_caption_steps

    counters = {"fused_factored_scan_fwd": lstm_scan.factored_scan_fwd,
                "fused_factored_scan_bwd": lstm_scan.factored_scan_bwd,
                "ce_rows": cl.ce_rows, "ce_grad_rows": cl.ce_grad_rows}

    def reset():
        for fn in counters.values():
            fn.launches = 0

    def read():
        return {k: fn.launches for k, fn in counters.items()}

    cfg = DecoderConfig(vocab_size=V, embed_size=E, hidden_size=H,
                        factored_size=F, dropout=0.5)

    def build(**kw):
        tcfg = TrainConfig(teacher_forcing_ratio=kw.pop("ratio", 1.0), **kw)
        return make_caption_steps(cfg, tcfg,
                                  optim.make_adam(tcfg.lr_caption, tcfg),
                                  optim.make_adam(tcfg.lr_language, tcfg),
                                  device=device)

    def fresh():
        dec = training_decoder(device, 12)
        dec["C_b"].zero_()
        head = encoder.init_head_params(torch.Generator().manual_seed(13),
                                        EncoderConfig(embed_size=E),
                                        device=device)
        return dec, head

    kernel, plain = build(), build(fused_scan=False, chunked_ce=False)
    if not (kernel.use_fused and kernel.use_chunked):
        fail("the CUDA steps did not select the kernel path")
    fac_batches = [training_batch(device, B_IMAGES, 20 + i) for i in range(4)]
    emo_batches = [training_batch(device, B_EMOTION, 30 + i)
                   for i in range(4)]

    # (i) one factual step, kernel path vs plain path, same weights and
    # seed.  Tolerances: the loss atol 1e-4 (~9 in float32; the two paths
    # sum 1600 terms in other orders); each grad 1e-3 x its largest
    # magnitude, as phase 7, plus 1e-7 absolute: the head's linear_b grad
    # is 0 in exact arithmetic (the BatchNorm subtracts the batch mean), so
    # both paths give only rounding noise there
    dec, head = fresh()
    out = {}
    for name, steps in (("kernel", kernel), ("plain", plain)):
        gen = torch.Generator(device=device).manual_seed(40)
        loss, grads, _ = steps.factual_grads(dec, head, *fac_batches[0],
                                             generator=gen)
        out[name] = (loss, optim.tree_leaves(grads))
    torch.cuda.synchronize()
    loss_err = (out["kernel"][0] - out["plain"][0]).abs().item()
    pairs = [(a, b) for a, b in zip(out["kernel"][1], out["plain"][1])
             if b is not None]
    grad_errs = [max_rel_err(a, b) for a, b in pairs]
    if not (loss_err <= 1e-4 and all(
            (a - b).abs().max().item() <= 1e-3 * b.abs().max().item() + 1e-7
            for a, b in pairs)):
        fail(f"first step: kernel vs plain loss err {loss_err}, grad errs "
             f"{grad_errs}")
    log(f"phase 9 (i): first factual step, kernel vs plain: loss "
        f"{out['kernel'][0].item():.6f} vs {out['plain'][0].item():.6f}, "
        f"grad err / max|g| per leaf {[float(f'{e:.3g}') for e in grad_errs]}")

    # (ii) 30 factual then 30 emotion steps: the main training path, with
    # every K3 and CE count from 0 just before and read just after
    dec, head = fresh()
    gen = torch.Generator(device=device).manual_seed(41)
    fac_state = kernel.optimizer.init((dec, head))
    emo_state = kernel.lang_optimizer.init(dec)
    reset()
    fac_losses, emo_losses = [], []
    for i in range(30):
        *_, loss = kernel.factual_train_step(dec, head, fac_state,
                                             *fac_batches[i % 4],
                                             generator=gen)
        fac_losses.append(loss)
    for i in range(30):
        *_, loss = kernel.emotion_train_step(dec, head, emo_state,
                                             *emo_batches[i % 4], 1,
                                             generator=gen)
        emo_losses.append(loss)
    torch.cuda.synchronize()
    launches = read()
    fac_losses = [x.item() for x in fac_losses]
    emo_losses = [x.item() for x in emo_losses]
    for name, count in launches.items():
        if count <= 0:
            fail(f"{name} was not launched on the training path")
    # the loss must fall: the mean over the last cycle of the 4 batches
    # below LOSS_FALL x the mean over the first, on each track
    drops = {}
    for track, ls in (("factual", fac_losses), ("emotion", emo_losses)):
        if not all(math.isfinite(x) for x in ls):
            fail(f"{track} losses not finite: {ls}")
        first, last = sum(ls[:4]) / 4, sum(ls[-4:]) / 4
        drops[track] = last / first
        if not last <= LOSS_FALL * first:
            fail(f"{track} loss did not fall: first cycle {first}, last "
                 f"{last} > {LOSS_FALL} x first")
    log(f"phase 9 (ii): losses factual {fac_losses[0]:.4f} -> "
        f"{fac_losses[-1]:.4f}, emotion {emo_losses[0]:.4f} -> "
        f"{emo_losses[-1]:.4f}; last/first cycle {drops}; launches "
        f"{launches}")

    # per-step launches, each count from 0 before one step
    reset()
    kernel.factual_train_step(dec, head, fac_state, *fac_batches[0],
                              generator=gen)
    per_fac = read()
    reset()
    kernel.emotion_train_step(dec, head, emo_state, *emo_batches[0], 1,
                              generator=gen)
    per_emo = read()
    torch.cuda.synchronize()
    if min(per_fac.values()) <= 0:
        fail(f"a kernel missed a ratio-1.0 factual step: {per_fac}")

    # (iii) the reference's ratio 0.8: scheduled sampling in PyTorch,
    # chunked CE kernels
    sampled = build(ratio=0.8)
    reset()
    s_losses = []
    s_state = sampled.optimizer.init((dec, head))
    for i in range(3):
        *_, loss = sampled.factual_train_step(dec, head, s_state,
                                              *fac_batches[i],
                                              generator=gen)
        s_losses.append(loss.item())
    per_sampled = read()
    if not all(math.isfinite(x) for x in s_losses) or \
            per_sampled["ce_rows"] <= 0 or per_sampled["ce_grad_rows"] <= 0:
        fail(f"ratio 0.8: losses {s_losses}, launches {per_sampled}")

    # (iv) validation: free-running, head in eval mode
    v_loss, v_top5, _ = kernel.val_step(dec, head, *fac_batches[0], 0)
    v_loss, v_top5 = v_loss.item(), v_top5.item()
    if not (math.isfinite(v_loss) and 0.0 <= v_top5 <= 100.0):
        fail(f"val_step: loss {v_loss}, top5 {v_top5}")
    log(f"phase 9 (iii)-(iv): ratio 0.8 losses {s_losses}, launches "
        f"{per_sampled}; val loss {v_loss:.4f}, top-5 {v_top5:.2f}%")

    # step times: the whole factual step, Adam included
    def kernel_step():
        kernel.factual_train_step(dec, head, fac_state, *fac_batches[1],
                                  generator=gen)

    def plain_step():
        plain.factual_train_step(dec, head, plain_state, *fac_batches[1],
                                 generator=gen)

    plain_state = plain.optimizer.init((dec, head))
    ms = step_ms(kernel_step, 20)
    plain_ms = step_ms(plain_step, 10)
    busy = device_busy_share(kernel_step)
    by_kernel = device_time_by_kernel(kernel_step)
    return launches, {
        "config": {"B": B_IMAGES, "B_emotion": B_EMOTION, "T": T_STEPS,
                   "V": V, "E": E, "H": H, "F": F, "dropout": 0.5,
                   "teacher_forcing_ratio": 1.0, "lr": [2e-4, 5e-4]},
        "factual_step_ms": ms, "captions_per_s": B_IMAGES / ms * 1e3,
        "plain_factual_step_ms": plain_ms,
        "plain_captions_per_s": B_IMAGES / plain_ms * 1e3,
        "device_busy_share": busy, "device_ms_by_kernel": by_kernel,
        "launches_per_factual_step": per_fac,
        "launches_per_emotion_step": per_emo,
        "launches_per_ratio_0.8_steps": per_sampled,
        "first_step_kernel_vs_plain": {"loss_err": loss_err,
                                       "grad_rel_errs": grad_errs},
        "factual_losses": fac_losses, "emotion_losses": emo_losses,
        "last_over_first_cycle": drops, "ratio_0.8_losses": s_losses,
        "val": {"loss": v_loss, "top5": v_top5}}


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
    del params

    k3f, k3b = check_k3(device)
    log(f"phase 7: K3 ok, forward {k3f['ms']:.3f} ms (plain "
        f"{k3f['plain_ms']:.3f}), backward {k3b['ms']:.3f} ms (plain "
        f"{k3b['plain_ms']:.3f})")
    cef, ceb, ce_whole = check_ce(device)
    log(f"phase 8: CE ok, rows {cef['ms']:.4f} ms, grad rows "
        f"{ceb['ms']:.4f} ms; whole loss fwd+bwd {ce_whole}")
    train_launches, train = train_phase(device)
    train["chunked_ce_fwd_bwd"] = ce_whole
    log(f"phase 9: factual step {train['factual_step_ms']:.3f} ms, "
        f"{train['captions_per_s']:.1f} captions/s (plain "
        f"{train['plain_factual_step_ms']:.3f} ms)")
    for entry in (k3f, k3b, cef, ceb):
        entry["launches"] = train_launches[entry["name"]]
    print(json.dumps({"train": train}))
    print(json.dumps({"serve": stats}))
    print(json.dumps({"kernels": [k1, k2, k3f, k3b, cef, ceb]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
