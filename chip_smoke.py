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
   64 images, V=8192, 40 steps, in both feature modes, with the StyleNet
   cell (``cell="factored"``) and then the NIC cell (``cell="lstm"``); each
   kernel score must match its own sequence's plain score within 1e-3, and
   where tokens differ, the kernel's sequence must tie the plain winner's
   within 1e-4;
5b. K6 (``att_decode_step_topk``, the attention step) vs its plain version
   at 64 images x 5 beams = 320 rows (timed) and at the serial path's one
   image, for the StyleNet+Att cell (``kind="factored"``) and the NIC+Att
   cell (``kind="lstm"``), at A=512, P=14x14, FS=2048, E+FS=2348; and the
   h0/c0 kernel (``att_init_state``) vs ``init_hidden_state``;
5c. K7 (``mega_att_beam_decode``, the whole attention search) vs the plain
   search at 64 images, both cells, margin-aware as phase 5, with the
   steps each block ran;
6. serve: random-init StyleNet, NIC, StyleNet+Att and NIC+Att at flagship
   width (ResNet-152 at 224x224, E=300, H=F=A=512, V=8192, k=5, 40 steps)
   behind the HTTP service.  First with cross-request batching: concurrent
   ``POST /generate`` requests in all four modes (batched path: K2
   factored, K2 lstm, K7 factored, K7 lstm).  Then without batching: the
   same requests one by one (serial path: K1, K2 lstm, the h0/c0 kernel
   and K6 of both cells for one image).  Every variant's captions must
   match, and each path's kernels must have launched (the counts are reset
   to 0 just before the path runs and read just after).  Then a checkpoint
   round trip: reference-style torch checkpoints (StyleNet and
   StyleNet+Att decoder state dicts, full-module NIC and NIC+Att pickles)
   serve one request with the captions of the same weights passed as
   ``params``;
7. K3 (``fused_factored_scan``) and K4 (``fused_nic_scan``), forward and
   backward, vs their plain versions at B=64, T=25, E=300, F=H=512; K4
   also against cuDNN's ``nn.LSTM`` (the library yardstick);
8. the chunked cross-entropy's row passes vs their plain versions, and the
   whole chunked loss (kernel path) vs the plain path and the materialized
   ``masked_cross_entropy``, at 64 x 25 rows, V=8192;
9. training at flagship width (outside ``torch.inference_mode``), StyleNet
   then NIC: one factual step on the kernel path vs the plain path (losses
   and grads), 30 factual steps (B=64) then 30 emotion steps (B=96) whose
   loss must fall, with every scan and CE kernel's count reset to 0 just
   before and read just after; 3 steps at the reference's teacher-forcing
   ratio 0.8; one ``val_step``; the step time and captions/s (and, for
   StyleNet, the device-busy share and device time by kernel);
10. print one ``{"train": {...}}`` line, one ``{"serve": {...}}`` line and
   one ``{"kernels": [...]}`` line (K1, K2 factored and lstm, K6 factored
   and lstm, the h0/c0 kernel, K7 factored and lstm, K3 and K4 forward and
   backward, CE forward and backward);
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
A, P, FS = 512, 196, 2048   # attention width, 14 x 14 positions, features
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


def step_flops_per_row(cell: str = "factored") -> int:
    """Multiply-adds x2 of one decode step for one row: cell chain + head."""
    if cell == "lstm":
        return 2 * (E * 4 * H + H * 4 * H + H * V)
    return 2 * (E * 4 * F + 4 * F * F + 4 * F * H + H * 4 * H + H * V)


def decoder_weight_bytes(cell: str = "factored") -> int:
    """Bytes of the weights every step reads (the embedding is gathered by
    row and counted with the step inputs)."""
    if cell == "lstm":
        return 4 * (E * 4 * H + 4 * H + H * 4 * H + 4 * H + H * V + V)
    return 4 * (E * 4 * F + 4 * F + 4 * F * F + 4 * F + 4 * F * H + 4 * H
                + H * 4 * H + 4 * H + H * V + V)


def captioning_params(device):
    """Seeded random weights at flagship width, for the four served
    variants, shaped so beams finish at caption-like lengths: the smoke init's
    residual branches are damped (undamped He init grows ResNet activations
    ~1e4x over 50 blocks), the encoder heads are scaled up so the step-1
    feature is O(1) (the default init gives ~0.1, and every beam then emits
    <end> at once: an empty caption), and the decoder heads are sharpened
    with a bias towards <end> (with near-uniform logits over 8192 words no
    beam ever completes).  NIC's input weights are scaled up too: at
    Xavier scale its captions hardly depend on the image (every request
    got the same four words).  The attention decoders (Xavier init, research
    beams that start from <start>) get the sharpened head with a larger
    <end> bias (at 2.0 no beam over 8192 words ever completes; at 12 every
    beam ends after two words), and init_h/init_c x 6: the 14 x 14 features
    of different photos differ by ~0.01 per channel in their mean, and at
    Xavier scale h0 hardly sees it (captions of the same words for every
    image).  -> ``CaptionEngine``'s ``params``."""
    import torch

    from icee_tpu_torch.core.config import (AttentionDecoderConfig,
                                            DecoderConfig, EncoderConfig)
    from icee_tpu_torch.models import (attention, encoder, factored_lstm,
                                       lstm, resnet)

    backbone = resnet.init_params(torch.Generator().manual_seed(0),
                                  device=device)
    for li in range(1, 5):
        for block in backbone[f"layer{li}"]:
            block["bn3"]["weight"].mul_(0.2)
    out = {"backbone": backbone}
    for variant, init, head_w, seed in (
            ("stylenet", factored_lstm.init_params, "C", 1),
            ("nic", lstm.init_params, "linear", 3)):
        dec = init(torch.Generator().manual_seed(seed),
                   DecoderConfig(vocab_size=V, embed_size=E, hidden_size=H,
                                 factored_size=F), device=device)
        w, b = (("C_w", "C_b") if head_w == "C"
                else ("linear_w", "linear_b"))
        dec[w].mul_(30.0)
        dec[b][2] = 2.0
        if variant == "nic":
            dec["cell"]["W_ih"].mul_(4.0)
        head = encoder.init_head_params(
            torch.Generator().manual_seed(seed + 1),
            EncoderConfig(embed_size=E), device=device)
        head["linear_w"].mul_(10.0)
        head["linear_b"].mul_(10.0)
        out[variant] = {"decoder": dec, "head": head}
    att_cfg = AttentionDecoderConfig(vocab_size=V, embed_size=E,
                                     hidden_size=H, factored_size=F,
                                     attention_size=A, feature_size=FS)
    for variant, init, head_w, seed in (
            ("stylenet_att", attention.init_factored_att_params, "C", 5),
            ("nic_att", attention.init_rnn_att_params, "linear", 7)):
        dec = init(torch.Generator().manual_seed(seed), att_cfg,
                   device=device)
        w, b = (("C_w", "C_b") if head_w == "C"
                else ("linear_w", "linear_b"))
        dec[w].mul_(30.0)
        dec[b][2] = 7.5
        dec["init_h_w"].mul_(6.0)
        dec["init_c_w"].mul_(6.0)
        out[variant] = {"decoder": dec}
    return out


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

def sequence_scores(dec, cell: str, feats, style: int, tokens, length):
    """Log-probability under the plain model of each image's token sequence
    (``<start>`` at 0; the feature fed at step 1 when ``feats`` is given):
    the score a beam search gives that sequence.  Summed step by step in
    float32, as the search does."""
    import torch

    from icee_tpu_torch.models import factored_lstm as fl
    from icee_tpu_torch.models import lstm

    if cell == "factored":
        embed = fl.embed
        step = lambda x, s: fl.decode_step(dec, x, s, style)  # noqa: E731
    else:
        embed = lstm.embed
        step = lambda x, s: lstm.decode_step(dec, x, s)  # noqa: E731
    tok = tokens.long()
    zeros = torch.zeros((tok.shape[0], H), device=tok.device)
    state = (zeros, zeros.clone())
    x = feats[:, 0] if feats is not None else embed(dec, tok[:, 0])
    total = torch.zeros((tok.shape[0],), device=tok.device)
    for t in range(1, int(length.max())):
        logits, state = step(x, state)
        lp = torch.log_softmax(logits.float(), dim=-1)
        total = torch.where(t < length, total + lp.gather(
            1, tok[:, t:t + 1])[:, 0], total)
        x = embed(dec, tok[:, t])
    return total


def check_k2(dec, device, cell: str = "factored"):
    """K2 with ``cell`` vs its plain search; -> its entry of the kernels
    line."""
    import torch

    from icee_tpu_torch.ops.beam import (mega_beam_decode,
                                         mega_beam_decode_plain,
                                         mega_beam_decode_steps)

    style = 2 if cell == "factored" else 0
    g = torch.Generator(device=device).manual_seed(4)
    feats = torch.randn((B_IMAGES, 1, E), generator=g, device=device)
    feats = feats.expand(B_IMAGES, K, E).contiguous()
    max_err, own_err, total_steps, flips = 0.0, 0.0, 0, 0
    kw = dict(k=K, max_seq_length=STEPS, cell=cell)
    for mode_feats in (feats, None):
        got, steps = mega_beam_decode_steps(dec, mode_feats, style,
                                            B_IMAGES, **kw)
        want = mega_beam_decode_plain(dec, mode_feats, style, B_IMAGES, **kw)
        # the plain model's score of the kernel's own sequences: a wrong
        # token, parent or length shows here even where the kernel's
        # reported score is right
        rescored = sequence_scores(dec, cell, mode_feats, style, got.tokens,
                                   got.length)
        mode = ("serving" if mode_feats is not None else "research") \
            + f", {cell}"
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

    ms = cuda_ms(lambda: mega_beam_decode(dec, feats, style, B_IMAGES, **kw),
                 5)
    plain_ms = cuda_ms(lambda: mega_beam_decode_plain(
        dec, feats, style, B_IMAGES, **kw), 3)
    rows_per_block = (B_IMAGES * K) // steps.numel()
    row_steps = total_steps * rows_per_block
    nbytes = (decoder_weight_bytes(cell) + 4 * B_IMAGES * K * E
              + 4 * row_steps * E + 4 * B_IMAGES * (STEPS + 4))
    b_ms, b_by = bound_ms(row_steps * step_flops_per_row(cell), nbytes)
    lstm = cell == "lstm"
    return {"name": "mega_beam_decode" + ("_lstm" if lstm else ""),
            "route": "cuda", "source": "icee_tpu_torch/csrc/beam.cu",
            "replaces": "icee_tpu/ops/pallas_beam.py:350" + (
                " (cell=\"lstm\", :129-143)" if lstm else ""),
            "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "library_note": "no single PyTorch call computes a beam search",
            "near_tie_flips": flips, "max_rescore_err": own_err,
            "block_steps_run": total_steps}


# --- phase 5b-5c: K6 and K7 (attention) --------------------------------------

ATT_KINDS = {"factored": "stylenet_att", "lstm": "nic_att"}


def att_step_flops_per_row(kind: str) -> int:
    """Multiply-adds x2 of one attention step for one row: att2, the P
    scores, the context, the gate, then the cell on [emb; ctx] and the
    head."""
    attend = 2 * (H * A + P * A + P * FS + H * FS)
    e_in = E + FS
    if kind == "lstm":
        return attend + 2 * (e_in * 4 * H + H * 4 * H + H * V)
    return attend + 2 * (e_in * 4 * F + 4 * F * F + 4 * F * H + H * 4 * H
                         + H * V)


def att_weight_bytes(kind: str, init: bool = False) -> int:
    """Bytes of the weights every attention step reads (with ``init``, the
    h0/c0 projections too)."""
    e_in = E + FS
    attend = H * A + A + A + 1 + H * FS + FS
    if kind == "lstm":
        cell = e_in * 4 * H + H * 4 * H + 8 * H
    else:
        cell = e_in * 4 * F + 4 * F + 4 * F * F + 4 * F + 4 * F * H + 4 * H \
            + H * 4 * H + 4 * H
    return 4 * (attend + cell + H * V + V + (2 * FS * H + 2 * H if init
                                             else 0))


def att_features(device, n_img: int, seed: int):
    """Spatial features at the statistics of the served ones (post-ReLU
    ResNet maps pooled to 14 x 14: mean ~0.13 per channel)."""
    import torch

    g = torch.Generator(device=device).manual_seed(seed)
    return 0.3 * torch.rand((n_img, P, FS), generator=g, device=device)


def check_k6(dec, kind: str, device, n_img: int, seed: int):
    """K6 with ``kind`` vs its plain version on ``n_img`` images x K random
    rows; -> (inputs, max abs error, near-tie swaps).  Ids exact except in
    a 1e-5 near tie; logp, h', c' atol 1e-4, alpha atol 1e-5."""
    import torch

    from icee_tpu_torch.models import attention as att_mod
    from icee_tpu_torch.ops.att_decode_step import (
        att_decode_step_topk, att_decode_step_topk_plain, step_params)

    style = 3 if kind == "factored" else 0
    cell, att, gate = step_params(dec, kind, style)
    rows = n_img * K
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((rows, E), generator=g, device=device) * 0.1
    h = torch.randn((rows, H), generator=g, device=device) * 0.5
    c = torch.randn((rows, H), generator=g, device=device) * 0.5
    feats = att_features(device, n_img, seed)
    att1 = att_mod.att_projection(att, feats)
    args = (cell, att, gate, x, h, c, feats, att1, kind, K)
    gv, gi, gh, gc, ga = att_decode_step_topk(*args, ktop=K)
    wv, wi, wh, wc, wa = att_decode_step_topk_plain(*args, ktop=K)
    torch.cuda.synchronize()
    mism = (gi != wi).any(dim=1)
    ties = 0
    if bool(mism.any()):
        logp = torch.log_softmax(wh @ cell["C_w"] + cell["C_b"], dim=-1)
        for r in torch.nonzero(mism).flatten().tolist():
            picked = logp[r, gi[r].long()]
            if (picked - wv[r]).abs().max().item() > 1e-5:
                fail(f"K6 {kind} {rows} rows, row {r}: ids {gi[r].tolist()} "
                     f"!= {wi[r].tolist()} beyond a 1e-5 near-tie")
            ties += 1
    ok = ~mism
    errs = {"logp": (gv[ok] - wv[ok]).abs().max().item(),
            "h": (gh - wh).abs().max().item(),
            "c": (gc - wc).abs().max().item()}
    alpha_err = (ga - wa).abs().max().item()
    log(f"K6 {kind}: {rows} rows, ids equal on {int(ok.sum())}, near-tie "
        f"swaps {ties}; max abs err {errs}, alpha {alpha_err:.3g}")
    for name, err in errs.items():
        if not err <= 1e-4:
            fail(f"K6 {kind} {rows} rows: {name} error {err} > 1e-4")
    if not alpha_err <= 1e-5:
        fail(f"K6 {kind} {rows} rows: alpha error {alpha_err} > 1e-5")
    return args, max(max(errs.values()), alpha_err), ties


def att_library_step(args):
    """The attention step as a few PyTorch calls (the library yardstick):
    addmm, a broadcast relu-score, softmax, bmm for the context, the cell,
    addmm, log_softmax, topk."""
    import torch

    from icee_tpu_torch.ops.cells import factored_lstm_cell, lstm_cell

    cell, att, gate, x, h, c, feats, att1, kind, k = args
    n_img = feats.shape[0]
    att2 = torch.addmm(att["dec_b"], h, att["dec_w"])
    e = torch.relu(att1[:, None] + att2.view(n_img, k, 1, A)) @ att["full_w"]
    alpha = torch.softmax(e[..., 0] + att["full_b"], dim=-1)
    ctx = torch.bmm(alpha, feats).reshape(n_img * k, FS)
    gated = torch.sigmoid(torch.addmm(gate["f_beta_b"], h,
                                      gate["f_beta_w"])) * ctx
    xf = torch.cat([x, gated], dim=-1)
    if kind == "factored":
        stacked = dict(cell, S_w=cell["S_w"][None], S_b=cell["S_b"][None])
        h2, _ = factored_lstm_cell(stacked, xf, h, c, 0)
    else:
        h2, _ = lstm_cell(cell, xf, h, c)
    return torch.topk(torch.log_softmax(
        torch.addmm(cell["C_b"], h2, cell["C_w"]), dim=-1), k)


def k6_line(kind: str, args, serial_args, max_err: float, ties: int):
    """Times K6, its plain version and the library yardstick at the
    batched shape (64 images x K rows) and the serial one (one image);
    -> K6's entry of the kernels line."""
    from icee_tpu_torch.ops.att_decode_step import (
        att_decode_step_topk, att_decode_step_topk_plain)

    out = {}
    for tag, a in (("", args), ("serial_", serial_args)):
        n_img = a[6].shape[0]
        rows = n_img * K
        out[tag + "ms"] = cuda_ms(lambda: att_decode_step_topk(*a, ktop=K),
                                  20)
        out[tag + "plain_ms"] = cuda_ms(
            lambda: att_decode_step_topk_plain(*a, ktop=K), 5)
        out[tag + "library_ms"] = cuda_ms(lambda: att_library_step(a), 20)
        nbytes = (att_weight_bytes(kind) + 4 * n_img * P * (FS + A)
                  + 4 * rows * (E + 2 * H) + 4 * rows * (2 * K + 2 * H + P))
        out[tag + "bound_ms"], out[tag + "bound_by"] = bound_ms(
            rows * att_step_flops_per_row(kind), nbytes)
    lstm = kind == "lstm"
    return dict(out, name="att_decode_step_topk" + ("_lstm" if lstm else ""),
                route="cuda", source="icee_tpu_torch/csrc/att_decode_step.cu",
                replaces="icee_tpu/ops/pallas_att_decode.py:201 (kind=\""
                         + kind + "\")",
                max_abs_err=max_err, near_tie_swaps=ties,
                library_note="addmm, relu-score, softmax, bmm, the cell, "
                             "addmm, log_softmax, topk")


def check_att_init(dec, device):
    """The h0/c0 kernel (the serial path's start, K7's prologue) vs
    ``init_hidden_state`` at 64 images; -> its entry of the kernels line."""
    import torch

    from icee_tpu_torch.models import attention as att_mod
    from icee_tpu_torch.ops.att_decode_step import att_init_state

    feats = att_features(device, B_IMAGES, 9)
    h0, c0 = att_init_state(dec, feats)
    wh, wc = att_mod.init_hidden_state(dec, feats)
    torch.cuda.synchronize()
    err = max((h0 - wh).abs().max().item(), (c0 - wc).abs().max().item())
    log(f"att_init_state: {B_IMAGES} images, h0/c0 max abs err {err:.3g}")
    if not err <= 1e-4:
        fail(f"att_init_state: h0/c0 error {err} > 1e-4")
    flops = B_IMAGES * (P * FS + 2 * 2 * FS * H)
    nbytes = 4 * (B_IMAGES * P * FS + 2 * FS * H + 2 * H
                  + 2 * B_IMAGES * H)
    b_ms, b_by = bound_ms(flops, nbytes)
    return {"name": "att_init_state", "route": "cuda",
            "source": "icee_tpu_torch/csrc/att_decode_step.cu",
            "replaces": "icee_tpu/ops/pallas_att_decode.py:456 (the h/c "
                        "init of mega_att_beam_decode, hoisted for the "
                        "serial path as the streamed call hoists it)",
            "max_abs_err": err,
            "ms": cuda_ms(lambda: att_init_state(dec, feats), 20),
            "plain_ms": cuda_ms(
                lambda: att_mod.init_hidden_state(dec, feats), 20),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "library_note": "no single PyTorch call: a mean and two "
                            "products"}


def att_sequence_scores(dec, kind: str, feats, style: int, tokens, length):
    """Log-probability under the plain attention model of each image's
    token sequence (research semantics: ``<start>`` embedded at step 1, h0
    and c0 from the mean feature): the score a beam search gives it."""
    import torch

    from icee_tpu_torch.models import attention as att_mod

    att = att_mod.select_attention(dec, style)
    att1 = att_mod.att_projection(att, feats)
    emb = dec["B"] if kind == "factored" else dec["embed"]
    tok = tokens.long()
    state = att_mod.init_hidden_state(dec, feats)
    x = emb[tok[:, 0]]
    total = torch.zeros((tok.shape[0],), device=tok.device)
    for t in range(1, int(length.max())):
        if kind == "factored":
            logits, _, state = att_mod.factored_att_decode_step(
                dec, x, feats, state, style, att1=att1)
        else:
            logits, _, state = att_mod.rnn_att_decode_step(
                dec, x, feats, state, att1=att1)
        lp = torch.log_softmax(logits.float(), dim=-1)
        total = torch.where(t < length, total + lp.gather(
            1, tok[:, t:t + 1])[:, 0], total)
        x = emb[tok[:, t]]
    return total


def check_k7(dec, kind: str, device):
    """K7 with ``kind`` vs its plain search at 64 images, margin-aware as
    phase 5: each kernel score matches its own sequence's plain score
    within 1e-3, and where tokens differ from the plain search, the
    kernel's sequence ties the plain winner's within 1e-4; -> its entry of
    the kernels line, with the steps each block ran."""
    import torch

    from icee_tpu_torch.ops.att_beam import (mega_att_beam_decode,
                                             mega_att_beam_decode_plain,
                                             mega_att_beam_decode_steps)

    style = 3 if kind == "factored" else 0
    feats = att_features(device, B_IMAGES, 14)
    kw = dict(k=K, max_seq_length=STEPS, kind=kind)
    got, steps = mega_att_beam_decode_steps(dec, feats, style, B_IMAGES, **kw)
    want = mega_att_beam_decode_plain(dec, feats, style, B_IMAGES, **kw)
    rescored = att_sequence_scores(dec, kind, feats, style, got.tokens,
                                   got.length)
    max_err, own_err, flips = 0.0, 0.0, 0
    for i in range(B_IMAGES):
        gs, ws = got.score[i].item(), want.score[i].item()
        same = (got.length[i] == want.length[i]).item() and torch.equal(
            got.tokens[i], want.tokens[i])
        if int(got.length[i]) > 1:
            own = abs(rescored[i].item() - gs)
            own_err = max(own_err, own)
            if not own <= 1e-3:
                fail(f"K7 {kind} image {i}: reported score {gs}, its "
                     f"sequence scores {rescored[i].item()}")
        if not same:
            margin = abs(rescored[i].item() - ws)
            if int(got.length[i]) == 1 or margin > 1e-4:
                fail(f"K7 {kind} image {i}: tokens differ; kernel's sequence "
                     f"scores {rescored[i].item()}, plain winner {ws}, "
                     f"margin {margin} > 1e-4")
            flips += 1
            log(f"K7 {kind} image {i}: near-tie flip, margin {margin}")
        err = abs(gs - ws)
        if not err <= 1e-3:
            fail(f"K7 {kind} image {i}: score {gs} vs {ws}")
        max_err = max(max_err, err)
    lengths = got.length.float()
    total_steps = int(steps.sum())
    log(f"K7 {kind}: {B_IMAGES} images, lengths mean "
        f"{lengths.mean().item():.2f} min {int(lengths.min())} max "
        f"{int(lengths.max())}, steps run per block min {int(steps.min())} "
        f"mean {steps.float().mean().item():.2f} max {int(steps.max())}; "
        f"kernel scores vs their sequences' plain scores, max abs err "
        f"{own_err}")
    ms = cuda_ms(lambda: mega_att_beam_decode(dec, feats, style, B_IMAGES,
                                              **kw), 3)
    plain_ms = cuda_ms(lambda: mega_att_beam_decode_plain(
        dec, feats, style, B_IMAGES, **kw), 1)
    row_steps = total_steps * K
    flops = (row_steps * att_step_flops_per_row(kind)
             + B_IMAGES * (P * FS + 2 * 2 * FS * H))
    nbytes = (att_weight_bytes(kind, init=True) + 4 * B_IMAGES * P * (FS + A)
              + 4 * row_steps * E + 4 * B_IMAGES * (STEPS + 4))
    b_ms, b_by = bound_ms(flops, nbytes)
    lstm = kind == "lstm"
    return {"name": "mega_att_beam_decode" + ("_lstm" if lstm else ""),
            "route": "cuda", "source": "icee_tpu_torch/csrc/att_beam.cu",
            "replaces": "icee_tpu/ops/pallas_att_decode.py:733 (kind=\""
                        + kind + "\"; both calls, :974 and :907)",
            "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "library_note": "no single PyTorch call computes a beam search",
            "near_tie_flips": flips, "max_rescore_err": own_err,
            "block_steps_run": total_steps,
            "block_steps_min_mean_max": [int(steps.min()),
                                         steps.float().mean().item(),
                                         int(steps.max())],
            "caption_lengths_min_mean_max": [int(lengths.min()),
                                             lengths.mean().item(),
                                             int(lengths.max())]}


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


SERVED = ("stylenet", "nic", "stylenet_att", "nic_att")


def run_requests(url, requests, concurrent: bool):
    """POST every (image, mode) request, all at once or one after another;
    -> ({index: (status, body, seconds)}, wall seconds).  Fails unless each
    answer is HTTP 200 with a non-empty stylenet caption and an answer of
    every other variant (a random-init decoder may end a beam at once: an
    empty caption)."""
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
        if status != 200 or body.get("stylenet") in (None, "", "-") or \
                any(body.get(v) in (None, "-") for v in SERVED):
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
    pieces of a request: image decode + ResNet-152 + head for one image;
    per variant the serial beam for one image (stylenet: fused-step path,
    K1; nic: K2 lstm; the attention variants: fused-step, K6) and the
    batched beam (K2 or K7) for a group of len(paths) images; and each
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

    pieces = {"encode_one_image": lambda: engine.encode(paths[0], "happy")}
    for variant in SERVED:
        feat = engine.encode(paths[0], "happy", variant)
        group = torch.cat([engine.encode(p, "happy", variant) for p in paths])
        pre = "" if variant == "stylenet" else variant + "_"
        pieces[pre + "serial_beam_one_image"] = (
            lambda f=feat, v=variant: engine.decode(f, "happy", "fused-step",
                                                    v))
        pieces[pre + f"batched_beam_{len(paths)}_images"] = (
            lambda g=group, v=variant: engine.decode(g, "happy", "mega", v))
    return {name: {"ms": timed(fn), "device_busy_share": device_busy_share(fn)}
            for name, fn in pieces.items()}


def serving_vocab(tmp: str) -> str:
    """A vocabulary of V words pickled under ``tmp``; -> its path."""
    from icee_tpu_torch.data.vocab import SPECIALS, Vocabulary

    vocab = Vocabulary()
    for w in SPECIALS:
        vocab.add_word(w)
    for i in range(V - len(SPECIALS)):
        vocab.add_word(f"kata{i:04d}")
    path = os.path.join(tmp, "vocab.pkl")
    vocab.save(path)
    return path


def serve_phase(params, device):
    import dataclasses

    import numpy as np
    from PIL import Image

    from icee_tpu_torch.ops.att_beam import mega_att_beam_decode
    from icee_tpu_torch.ops.att_decode_step import (att_decode_step_topk,
                                                    att_init_state)
    from icee_tpu_torch.ops.beam import mega_beam_decode
    from icee_tpu_torch.ops.decode_step import decode_step_topk
    from icee_tpu_torch.serve.config import ServeConfig
    from icee_tpu_torch.serve.engine import BEAM_K, CaptionEngine

    def reset():
        decode_step_topk.launches = att_init_state.launches = 0
        mega_beam_decode.launches = mega_beam_decode.lstm_launches = 0
        att_decode_step_topk.launches = att_decode_step_topk.lstm_launches = 0
        mega_att_beam_decode.launches = 0
        mega_att_beam_decode.lstm_launches = 0

    def read():
        return {"decode_step_topk": decode_step_topk.launches,
                "mega_beam_decode": mega_beam_decode.launches,
                "mega_beam_decode_lstm": mega_beam_decode.lstm_launches,
                "att_decode_step_topk": att_decode_step_topk.launches,
                "att_decode_step_topk_lstm":
                    att_decode_step_topk.lstm_launches,
                "att_init_state": att_init_state.launches,
                "mega_att_beam_decode": mega_att_beam_decode.launches,
                "mega_att_beam_decode_lstm":
                    mega_att_beam_decode.lstm_launches}

    with tempfile.TemporaryDirectory() as tmp:
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
                             vocab_path=serving_vocab(tmp),
                             batch_window_ms=200.0)
        t0 = time.perf_counter()
        engine = CaptionEngine(config, image_size=224, device=device,
                               params=params)
        engine.caption(paths[0], "happy")   # warm-up: cuDNN and allocator
        log(f"serve: engine ready in {time.perf_counter() - t0:.1f}s "
            f"(variants {sorted(engine.models)}, V={len(engine.vocab)}, "
            f"E={engine.dec_cfg.embed_size}, H={engine.dec_cfg.hidden_size}, "
            f"F={engine.dec_cfg.factored_size}, k={BEAM_K}, "
            f"steps={engine.dec_cfg.max_seq_length}; attention "
            f"A={engine.att_cfg.attention_size}, "
            f"FS={engine.att_cfg.feature_size}, P=14x14)")
        # path 1, batched: concurrent requests through the BatchingEngine
        # (K2 factored + K2 lstm + K7 factored + K7 lstm); counts from 0
        # just before, read just after
        reset()
        with serving(config, engine, device) as url:
            batched, wall = run_requests(url, requests, concurrent=True)
        launches = {"batched": read()}
        # path 2, serial: the same requests one by one through the
        # CaptionEngine alone (K1 for stylenet, K2 lstm for nic, the h0/c0
        # kernel and K6 of both kinds for the attention variants)
        serial_config = dataclasses.replace(config, batch_window_ms=0.0)
        reset()
        with serving(serial_config, engine, device) as url:
            serial, serial_wall = run_requests(url, requests,
                                               concurrent=False)
        launches["serial"] = read()

        for j, (p, m) in enumerate(requests):
            for variant in SERVED:
                got, want = batched[j][1][variant], serial[j][1][variant]
                if got != want:
                    fail(f"request {j} ({m}) {variant}: batched caption "
                         f"{got!r} != serial {want!r}")
        for path, names in (("batched", ("mega_beam_decode",
                                         "mega_beam_decode_lstm",
                                         "mega_att_beam_decode",
                                         "mega_att_beam_decode_lstm")),
                            ("serial", ("decode_step_topk",
                                        "mega_beam_decode_lstm",
                                        "att_decode_step_topk",
                                        "att_decode_step_topk_lstm",
                                        "att_init_state"))):
            for name in names:
                if launches[path][name] <= 0:
                    fail(f"{name} was not launched on the {path} path")
        words = {v: [len(batched[j][1][v].split())
                     for j in range(len(requests))] for v in SERVED}
        for variant in SERVED[1:]:
            if max(words[variant]) == 0:
                fail(f"every {variant} caption is empty")
        distinct = {v: len({batched[j][1][v] for j in range(len(requests))})
                    for v in SERVED}
        lat = sorted(r[2] * 1e3 for r in batched.values())
        serial_lat = sorted(r[2] * 1e3 for r in serial.values())
        log(f"serve: {len(requests)} x {len(SERVED)} captions equal on the "
            f"batched and serial paths; words per caption "
            f"{ {v: (min(w), max(w)) for v, w in words.items()} }; distinct "
            f"captions of {len(requests)} {distinct}; e.g. "
            f"{ {v: batched[0][1][v] for v in SERVED} }")
        stats = {"variants": list(SERVED), "requests": len(requests),
                 "wall_s": wall, "captions_per_s": len(requests) / wall,
                 "p50_ms": statistics.median(lat), "max_ms": lat[-1],
                 "batch_window_ms": config.batch_window_ms,
                 "serial_wall_s": serial_wall,
                 "serial_captions_per_s": len(requests) / serial_wall,
                 "serial_p50_ms": statistics.median(serial_lat),
                 "image_size": 224, "launches": launches,
                 "words_min_max": {v: [min(w), max(w)]
                                   for v, w in words.items()},
                 "distinct_captions": distinct,
                 "breakdown_ms": request_breakdown(engine, paths)}
        stats["checkpoint_round_trip"] = checkpoint_phase(
            params, device, config, paths[0])
        return launches, stats


ATT_NETS = ("attention", "attention_happy", "attention_sad",
            "attention_angry")


def factored_state_dict(dec):
    """A StyleNet params tree -> the reference ``DecoderFactoredLSTM`` state
    dict (the key names of ``stylenet/model.py:52-94``)."""
    sd = {"B.weight": dec["B"], "C.weight": dec["C_w"].T,
          "C.bias": dec["C_b"]}
    for g, name in enumerate(("i", "f", "o", "c")):
        sd[f"V_{name}.weight"] = dec["V_w"][:, g * F:(g + 1) * F].T
        sd[f"V_{name}.bias"] = dec["V_b"][g]
        sd[f"U_{name}.weight"] = dec["U_w"][g].T
        sd[f"U_{name}.bias"] = dec["U_b"][g]
        sd[f"W_{name}.weight"] = dec["W_w"][:, g * H:(g + 1) * H].T
        sd[f"W_{name}.bias"] = dec["W_b"][g]
        for st, sp in enumerate(("f", "happy_", "sad_", "angry_")):
            sd[f"S_{sp}{name}.weight"] = dec["S_w"][st, g].T
            sd[f"S_{sp}{name}.bias"] = dec["S_b"][st, g]
    return sd


def att_extras_state_dict(dec, nets):
    """An attention decoder's attention nets (stacked per style when there
    are four), h/c init projections and gate -> the reference state dict
    entries (``model_att.py:32-70``, ``:140-164``)."""
    sd = {}
    for s, net in enumerate(nets):
        for ours, theirs in (("enc", "encoder_att"), ("dec", "decoder_att"),
                             ("full", "full_att")):
            w, b = dec["attention"][f"{ours}_w"], dec["attention"][f"{ours}_b"]
            if w.dim() == 3:
                w, b = w[s], b[s]
            sd[f"{net}.{theirs}.weight"] = w.T
            sd[f"{net}.{theirs}.bias"] = b
    for name in ("init_h", "init_c", "f_beta"):
        sd[f"{name}.weight"] = dec[f"{name}_w"].T
        sd[f"{name}.bias"] = dec[f"{name}_b"]
    return sd


def reference_checkpoints(params, tmp: str, device):
    """Reference-style torch checkpoints written under ``tmp``: StyleNet and
    StyleNet+Att decoder state dicts (``DecoderFactoredLSTM[Att]``) from
    ``params``; a full-module pickle of a NIC model (``EncoderCNN`` +
    ``DecoderRNN`` of ``torch.nn`` modules: Embedding, LSTMCell, Linear,
    BatchNorm1d) drawn from a seed and shaped to caption; and a full-module
    pickle of a NIC+Att model (a spatial ``EncoderCNN`` with no head and a
    ``DecoderRNNAtt`` with its ``Attention`` submodule) holding
    ``params["nic_att"]``'s weights.  The pickles' classes are gone when
    they are read.  -> ({variant: path}, the NIC weights as a ``params``
    entry, built from the modules' tensors by hand)."""
    import types

    import torch
    import torch.nn as nn

    def save_state_dict(sd, name):
        path = os.path.join(tmp, name)
        torch.save({k: v.detach().cpu().contiguous() for k, v in sd.items()},
                   path)
        return path

    sty_path = save_state_dict(
        factored_state_dict(params["stylenet"]["decoder"]),
        "stylenet_decoder.pth")
    att_dec = params["stylenet_att"]["decoder"]
    sty_att_path = save_state_dict(
        dict(factored_state_dict(att_dec),
             **att_extras_state_dict(att_dec, ATT_NETS)),
        "stylenet_att_decoder.pth")

    mod = types.ModuleType("model")

    class EncoderCNN(nn.Module):
        def __init__(self):
            super().__init__()
            self.resnet = nn.Sequential(nn.Conv2d(3, 8, 7))
            self.linear = nn.Linear(2048, E)
            self.bn = nn.BatchNorm1d(E, momentum=0.01)

    class DecoderRNN(nn.Module):
        def __init__(self):
            super().__init__()
            self.embed = nn.Embedding(V, E)
            self.lstm = nn.LSTMCell(E, H)
            self.linear = nn.Linear(H, V)

    class SpatialEncoderCNN(nn.Module):
        def __init__(self):
            super().__init__()
            self.resnet = nn.Sequential(nn.Conv2d(3, 8, 7))

    class Attention(nn.Module):
        def __init__(self):
            super().__init__()
            self.encoder_att = nn.Linear(FS, A)
            self.decoder_att = nn.Linear(H, A)
            self.full_att = nn.Linear(A, 1)

    class DecoderRNNAtt(nn.Module):
        def __init__(self):
            super().__init__()
            self.embed = nn.Embedding(V, E)
            self.lstm = nn.LSTMCell(E + FS, H)
            self.linear = nn.Linear(H, V)
            self.attention = Attention()
            self.init_h = nn.Linear(FS, H)
            self.init_c = nn.Linear(FS, H)
            self.f_beta = nn.Linear(H, FS)

    for cls in (EncoderCNN, DecoderRNN, SpatialEncoderCNN, Attention,
                DecoderRNNAtt):
        cls.__module__, cls.__qualname__ = "model", cls.__name__
        setattr(mod, cls.__name__, cls)
    sys.modules["model"] = mod
    try:
        torch.manual_seed(21)
        enc, nic = EncoderCNN(), DecoderRNN()
        with torch.no_grad():   # caption-shaped, as captioning_params
            enc.linear.weight.mul_(10.0)
            enc.linear.bias.mul_(10.0)
            nic.linear.weight.mul_(30.0)
            nic.linear.bias[2] = 2.0
        nic_path = os.path.join(tmp, "HAP_BEST_checkpoint_nic.pth.tar")
        torch.save({"epoch": 1, "encoder": enc, "decoder": nic}, nic_path)
        na = params["nic_att"]["decoder"]
        nic_att = DecoderRNNAtt()
        nic_att.load_state_dict({k: v.detach().cpu() for k, v in dict(
            att_extras_state_dict(na, ("attention",)),
            **{"embed.weight": na["embed"],
               "lstm.weight_ih": na["cell"]["W_ih"].T,
               "lstm.weight_hh": na["cell"]["W_hh"].T,
               "lstm.bias_ih": na["cell"]["b_ih"],
               "lstm.bias_hh": na["cell"]["b_hh"],
               "linear.weight": na["linear_w"].T,
               "linear.bias": na["linear_b"]}).items()})
        nic_att_path = os.path.join(tmp, "HAP_BEST_checkpoint_nic_att.pth.tar")
        torch.save({"epoch": 1, "encoder": SpatialEncoderCNN(),
                    "decoder": nic_att}, nic_att_path)
    finally:
        del sys.modules["model"]
    t = {k: v.detach().to(device) for k, v in
         list(nic.state_dict().items()) + [("enc." + k, v) for k, v in
                                           enc.state_dict().items()]}
    nic_params = {
        "decoder": {"embed": t["embed.weight"],
                    "cell": {"W_ih": t["lstm.weight_ih"].T.contiguous(),
                             "W_hh": t["lstm.weight_hh"].T.contiguous(),
                             "b_ih": t["lstm.bias_ih"],
                             "b_hh": t["lstm.bias_hh"]},
                    "linear_w": t["linear.weight"].T.contiguous(),
                    "linear_b": t["linear.bias"]},
        "head": {"linear_w": t["enc.linear.weight"].T.contiguous(),
                 "linear_b": t["enc.linear.bias"],
                 "bn": {k: t[f"enc.bn.{k}"] for k in
                        ("weight", "bias", "running_mean", "running_var")}}}
    return ({"stylenet": sty_path, "nic": nic_path,
             "stylenet_att": sty_att_path, "nic_att": nic_att_path},
            nic_params)


def checkpoint_phase(params, device, config, image_path: str):
    """The engine built from reference torch checkpoints captions one
    request as the engine built from the same weights as ``params``, all
    four variants.  The StyleNet state dict carries no encoder, so its head
    is the variant's seeded template in both engines; the attention
    variants have no head."""
    import dataclasses

    from icee_tpu_torch.core.config import MODES as ALL_MODES
    from icee_tpu_torch.serve.engine import CaptionEngine

    with tempfile.TemporaryDirectory() as tmp:
        files, nic_params = reference_checkpoints(params, tmp, device)
        paths = {v: {m: files[v] for m in ALL_MODES}
                 for v in config.checkpoint_paths}
        t0 = time.perf_counter()
        from_ckpt = CaptionEngine(
            dataclasses.replace(config, checkpoint_paths=paths),
            image_size=224, device=device,
            params={"backbone": params["backbone"]})
        load_s = time.perf_counter() - t0
    sty_head = from_ckpt.models["stylenet"]["happy"]["head"]
    from_params = CaptionEngine(config, image_size=224, device=device, params={
        "backbone": params["backbone"], "nic": nic_params,
        "stylenet": {"decoder": params["stylenet"]["decoder"],
                     "head": sty_head},
        "stylenet_att": params["stylenet_att"],
        "nic_att": params["nic_att"]})
    got = from_ckpt.caption(image_path, "sad")
    want = from_params.caption(image_path, "sad")
    if got != want:
        fail(f"checkpoint-built engine captions {got} != params-built {want}")
    log(f"checkpoints: loaded in {load_s:.1f}s; captions equal: {got}")
    return {"load_s": load_s, "captions": {v: got[v] for v in SERVED}}


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


def nic_flops(b: int, t: int):
    """(forward, backward) FLOPs of K4 on (b, t) rows: x W_ih for all rows
    and the recurrence; dW_ih, dW_hh and dx over all rows plus the (T - 1)
    recurrent dh products."""
    n = b * t
    fwd = 2 * n * (E + H) * 4 * H
    bwd = 2 * n * 4 * H * (2 * E + H) + 2 * b * (t - 1) * 4 * H * H
    return fwd, bwd


def training_nic_cell(device, seed: int):
    """Seeded flagship-width NIC cell (Xavier, as ``lstm.init_params``) with
    non-zero biases."""
    import torch

    from icee_tpu_torch.models import lstm

    cell = lstm.init_cell_params(torch.Generator().manual_seed(seed), E, H,
                                 device=device)
    g = torch.Generator(device=device).manual_seed(seed)
    for k in ("b_ih", "b_hh"):
        cell[k].copy_(0.1 * torch.randn(cell[k].shape, generator=g,
                                        device=device))
    return cell


def check_k4(device):
    """K4 forward and backward vs their plain versions at B=64, T=25,
    E=300, H=512, with K3's tolerances (h and c atol 1e-4; dx and each
    weight grad <= 1e-3 x its largest magnitude) and the same bits on a
    second run; then cuDNN's ``nn.LSTM`` with the same weights (TF32 off):
    its h against the kernel's (atol 1e-4) and its forward and backward
    times, the library yardstick.  -> (forward, backward) entries of the
    kernels line."""
    import torch

    from icee_tpu_torch.ops import nic_scan

    cell = training_nic_cell(device, 17)
    g = torch.Generator(device=device).manual_seed(18)
    x = 0.5 * torch.randn((B_IMAGES, T_STEPS, E), generator=g, device=device)
    dh = 0.02 * torch.randn((B_IMAGES, T_STEPS, H), generator=g,
                            device=device)
    h_seq, c_seq, gates = nic_scan.nic_scan_fwd(cell, x)
    want_h, want_c = nic_scan.fused_nic_scan_plain(cell, x)
    dx, grads = nic_scan.nic_scan_bwd(cell, x, h_seq, c_seq, dh, gates)
    want_dx, want_g = nic_scan.nic_scan_bwd_plain(cell, x, h_seq, c_seq, dh)
    h2, c2, _ = nic_scan.nic_scan_fwd(cell, x)
    dx2, grads2 = nic_scan.nic_scan_bwd(cell, x, h_seq, c_seq, dh, gates)
    torch.cuda.synchronize()
    fwd_err = max((h_seq - want_h).abs().max().item(),
                  (c_seq - want_c).abs().max().item())
    if not fwd_err <= 1e-4:
        fail(f"K4 forward: max abs error {fwd_err} > 1e-4")
    rel = {"x": max_rel_err(dx, want_dx)}
    rel.update({k: max_rel_err(grads[k], want_g[k])
                for k in nic_scan.CELL_KEYS})
    for name, err in rel.items():
        if not err <= 1e-3:
            fail(f"K4 backward: d{name} error {err} x max|g| > 1e-3")
    if not (torch.equal(h_seq, h2) and torch.equal(c_seq, c2)
            and torch.equal(dx, dx2)
            and all(torch.equal(grads[k], grads2[k]) for k in grads)):
        fail("K4: two runs on the same inputs differ")
    if not torch.equal(grads["b_ih"], grads["b_hh"]):
        fail("K4 backward: b_ih and b_hh grads differ")

    # the library yardstick: cuDNN's LSTM computes the same function
    lstm = torch.nn.LSTM(E, H, batch_first=True).to(device)
    with torch.no_grad():
        lstm.weight_ih_l0.copy_(cell["W_ih"].T)
        lstm.weight_hh_l0.copy_(cell["W_hh"].T)
        lstm.bias_ih_l0.copy_(cell["b_ih"])
        lstm.bias_hh_l0.copy_(cell["b_hh"])
    xl = x.detach().clone().requires_grad_(True)
    lib_h, _ = lstm(xl)
    lib_err = (lib_h.detach() - h_seq).abs().max().item()
    if not lib_err <= 1e-4:
        fail(f"K4 vs cuDNN nn.LSTM: h max abs error {lib_err} > 1e-4")
    log(f"K4: h/c max abs err {fwd_err:.3g}; grads max err / max|g| "
        f"{ {k: float(f'{v:.3g}') for k, v in rel.items()} }; bit-identical "
        f"over two runs; cuDNN nn.LSTM h max abs err {lib_err:.3g}")
    lib_inputs = [xl, *lstm.parameters()]

    def lib_fwd():
        with torch.no_grad():
            lstm(x)

    def lib_bwd():
        torch.autograd.grad(lib_h, lib_inputs, dh, retain_graph=True)

    def lib_fwd_bwd():
        out, _ = lstm(xl)
        torch.autograd.grad(out, lib_inputs, dh)

    ms_f = cuda_ms(lambda: nic_scan.nic_scan_fwd(cell, x), 10)
    plain_f = cuda_ms(lambda: nic_scan.fused_nic_scan_plain(cell, x), 5)
    lib_f = cuda_ms(lib_fwd, 10)
    ms_b = cuda_ms(lambda: nic_scan.nic_scan_bwd(cell, x, h_seq, c_seq, dh,
                                                 gates), 10)
    plain_b = cuda_ms(lambda: nic_scan.nic_scan_bwd_plain(
        cell, x, h_seq, c_seq, dh), 5)
    lib_b = cuda_ms(lib_bwd, 10)
    lib_fb = cuda_ms(lib_fwd_bwd, 10)
    n = B_IMAGES * T_STEPS
    flops_f, flops_b = nic_flops(B_IMAGES, T_STEPS)
    weights = E * 4 * H + H * 4 * H + 8 * H
    bytes_f = 4 * (weights + n * E + 2 * n * H + n * 4 * H)
    bytes_b = 4 * (2 * weights + 2 * n * E + 3 * n * H + n * 4 * H)
    common = {"route": "cuda", "source": "icee_tpu_torch/csrc/nic_scan.cu",
              "library_note": "torch.nn.LSTM(E, H, batch_first=True) "
                              "(cuDNN), TF32 off",
              "library_fwd_bwd_ms": lib_fb}
    bf, bf_by = bound_ms(flops_f, bytes_f)
    bb, bb_by = bound_ms(flops_b, bytes_b)
    return (dict(common, name="fused_nic_scan_fwd",
                 replaces="icee_tpu/ops/pallas_nic_train.py:173",
                 max_abs_err=fwd_err, ms=ms_f, plain_ms=plain_f,
                 bound_ms=bf, bound_by=bf_by, library_ms=lib_f,
                 library_max_abs_err=lib_err),
            dict(common, name="fused_nic_scan_bwd",
                 replaces="icee_tpu/ops/pallas_nic_train.py:227",
                 max_abs_err=max((dx - want_dx).abs().max().item(),
                                 *((grads[k] - want_g[k]).abs().max().item()
                                   for k in grads)),
                 max_rel_err=max(rel.values()), ms=ms_b, plain_ms=plain_b,
                 bound_ms=bb, bound_by=bb_by, library_ms=lib_b))


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


def train_phase(device, factored: bool = True):
    """Phase 9: the StyleNet (``factored``) or NIC train step at flagship
    width."""
    import math

    import torch

    from icee_tpu_torch.core.config import (DecoderConfig, EncoderConfig,
                                            TrainConfig)
    from icee_tpu_torch.models import encoder, lstm
    from icee_tpu_torch.ops import chunked_loss as cl
    from icee_tpu_torch.ops import lstm_scan, nic_scan
    from icee_tpu_torch.train import optim
    from icee_tpu_torch.train.steps import make_caption_steps

    if factored:
        counters = {"fused_factored_scan_fwd": lstm_scan.factored_scan_fwd,
                    "fused_factored_scan_bwd": lstm_scan.factored_scan_bwd}
    else:
        counters = {"fused_nic_scan_fwd": nic_scan.nic_scan_fwd,
                    "fused_nic_scan_bwd": nic_scan.nic_scan_bwd}
    counters.update(ce_rows=cl.ce_rows, ce_grad_rows=cl.ce_grad_rows)
    model = "stylenet" if factored else "nic"

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
                                  factored=factored, device=device)

    def fresh():
        if factored:
            dec = training_decoder(device, 12)
            dec["C_b"].zero_()
        else:
            dec = lstm.init_params(torch.Generator().manual_seed(12), cfg,
                                   device=device)
            dec["cell"] = training_nic_cell(device, 12)
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
    log(f"phase 9 (i), {model}: first factual step, kernel vs plain: loss "
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
    log(f"phase 9 (ii), {model}: losses factual {fac_losses[0]:.4f} -> "
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
    log(f"phase 9 (iii)-(iv), {model}: ratio 0.8 losses {s_losses}, launches "
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
    sty, nic = params["stylenet"]["decoder"], params["nic"]["decoder"]
    with torch.inference_mode():
        # the serial path's R = 5 (partly filled blocks in all three
        # launches), then R = 320 (full blocks), which is also timed
        _, serial_err, serial_ties = check_k1(sty, device, K, 6)
        inputs, err, ties = check_k1(sty, device, B_IMAGES * K, 3)
        k1 = k1_line(sty, inputs, max(serial_err, err), serial_ties + ties)
        log(f"phase 4: K1 ok, {k1['ms']:.3f} ms vs plain "
            f"{k1['plain_ms']:.3f} ms")
        k2 = check_k2(sty, device)
        k2_lstm = check_k2(nic, device, cell="lstm")
        log(f"phase 5: K2 ok, factored {k2['ms']:.3f} ms vs plain "
            f"{k2['plain_ms']:.3f} ms; lstm {k2_lstm['ms']:.3f} ms vs "
            f"plain {k2_lstm['plain_ms']:.3f} ms")
        att = {kind: params[v]["decoder"] for kind, v in ATT_KINDS.items()}
        k6 = {}
        for kind, dec in att.items():
            # the serial path's one image (a partly filled head block),
            # then 64 images, which is also timed
            serial_args, serial_err, serial_ties = check_k6(
                dec, kind, device, 1, 16)
            args, err, ties = check_k6(dec, kind, device, B_IMAGES, 15)
            k6[kind] = k6_line(kind, args, serial_args,
                               max(serial_err, err), serial_ties + ties)
        att_init = check_att_init(att["factored"], device)
        log(f"phase 5b: K6 ok, factored {k6['factored']['ms']:.3f} ms "
            f"(serial {k6['factored']['serial_ms']:.3f}) vs plain "
            f"{k6['factored']['plain_ms']:.3f}; lstm {k6['lstm']['ms']:.3f} "
            f"ms (serial {k6['lstm']['serial_ms']:.3f}) vs plain "
            f"{k6['lstm']['plain_ms']:.3f}; h0/c0 {att_init['ms']:.4f} ms")
        k7 = {kind: check_k7(dec, kind, device) for kind, dec in att.items()}
        log(f"phase 5c: K7 ok, factored {k7['factored']['ms']:.3f} ms vs "
            f"plain {k7['factored']['plain_ms']:.3f} ms; lstm "
            f"{k7['lstm']['ms']:.3f} ms vs plain "
            f"{k7['lstm']['plain_ms']:.3f} ms")

    launches, stats = serve_phase(params, device)
    log(f"phase 6: served {stats['requests']} requests, launches {launches}")
    k1["launches"] = launches["serial"]["decode_step_topk"]
    k2["launches"] = launches["batched"]["mega_beam_decode"]
    k2_lstm["launches"] = (launches["batched"]["mega_beam_decode_lstm"]
                           + launches["serial"]["mega_beam_decode_lstm"])
    k2_lstm["launches_batched_serial"] = [
        launches["batched"]["mega_beam_decode_lstm"],
        launches["serial"]["mega_beam_decode_lstm"]]
    for kind, suffix in (("factored", ""), ("lstm", "_lstm")):
        k6[kind]["launches"] = launches["serial"]["att_decode_step_topk"
                                                  + suffix]
        k7[kind]["launches"] = launches["batched"]["mega_att_beam_decode"
                                                   + suffix]
    att_init["launches"] = launches["serial"]["att_init_state"]
    del params, sty, nic, att

    k3f, k3b = check_k3(device)
    k4f, k4b = check_k4(device)
    log(f"phase 7: K3 ok, forward {k3f['ms']:.3f} ms (plain "
        f"{k3f['plain_ms']:.3f}), backward {k3b['ms']:.3f} ms (plain "
        f"{k3b['plain_ms']:.3f}); K4 ok, forward {k4f['ms']:.3f} ms (plain "
        f"{k4f['plain_ms']:.3f}, cuDNN {k4f['library_ms']:.3f}), backward "
        f"{k4b['ms']:.3f} ms (plain {k4b['plain_ms']:.3f}, cuDNN "
        f"{k4b['library_ms']:.3f})")
    cef, ceb, ce_whole = check_ce(device)
    log(f"phase 8: CE ok, rows {cef['ms']:.4f} ms, grad rows "
        f"{ceb['ms']:.4f} ms; whole loss fwd+bwd {ce_whole}")
    train_launches, train = train_phase(device)
    nic_launches, train["nic"] = train_phase(device, factored=False)
    train["chunked_ce_fwd_bwd"] = ce_whole
    log(f"phase 9: factual step {train['factual_step_ms']:.3f} ms, "
        f"{train['captions_per_s']:.1f} captions/s (plain "
        f"{train['plain_factual_step_ms']:.3f} ms); nic "
        f"{train['nic']['factual_step_ms']:.3f} ms, "
        f"{train['nic']['captions_per_s']:.1f} captions/s (plain "
        f"{train['nic']['plain_factual_step_ms']:.3f} ms)")
    for entry in (k3f, k3b):
        entry["launches"] = train_launches[entry["name"]]
    for entry in (k4f, k4b):
        entry["launches"] = nic_launches[entry["name"]]
    for entry in (cef, ceb):   # both decoders' runs use the CE kernels
        entry["launches"] = (train_launches[entry["name"]]
                             + nic_launches[entry["name"]])
    print(json.dumps({"train": train}))
    print(json.dumps({"serve": stats}))
    print(json.dumps({"kernels": [k1, k2, k2_lstm, k6["factored"],
                                  k6["lstm"], att_init, k7["factored"],
                                  k7["lstm"], k3f, k3b, k4f, k4b, cef,
                                  ceb]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
