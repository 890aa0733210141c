#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (built for H100).

Run from the repository root:  python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

1. require CUDA; print the card's name and power limit (nvidia-smi);
2. build the hand-written kernels from ``icee_tpu_torch/csrc`` (one nvcc per
   source, all at once) into ``icee_tpu_torch/_build/``;
3. turn TF32 off for matmuls and cuDNN, so float32 means float32;
4. K1 (``decode_step_topk``) vs its plain PyTorch version at E=300,
   F=H=512, V=8192: at the serial path's 5 rows (one image x 5 beams, the
   column-split path) and at 64 images x 5 beams = 320 rows (the row-tiled
   path), both timed, with the column-split path's device timeline (a
   CUDA graph replay: its time, span and per-launch start and end);
5. K2 (``mega_beam_decode``, one cooperative search over the whole card)
   vs the plain ``beam_search_batched`` search at 1, 8 and 64 images (the
   serial request, a batched call, the benchmark shape), V=8192, 40 steps,
   in both feature modes, with the StyleNet cell (``cell="factored"``) and
   then the NIC cell (``cell="lstm"``); each kernel score must match its
   own sequence's plain score within 1e-3, and where tokens differ, the
   kernel's sequence must tie the plain winner's within 1e-4; the factored
   cell must equal the serial fused-step path (K1) at atol 0; each shape
   timed, its bound from the live row-steps it ran;
5b. K6 (``att_decode_step_topk``, the attention step) vs its plain version
   at 64 images x 5 beams = 320 rows (row-tiled) and at the serial path's
   one image (column-split), both timed, with the column-split path's
   device timeline, for the StyleNet+Att cell (``kind="factored"``)
   and the NIC+Att cell (``kind="lstm"``), at A=512, P=14x14, FS=2048,
   E+FS=2348; and the h0/c0 launch (``att_init_state``: K7's own mean
   and init stages over the whole card) at 1, 2, 8 and 64 images for both
   decoders vs ``init_hidden_state`` (1e-4) and vs the h0/c0 K7 computes
   for the same images (atol 0), timed at 1 and 64 images;
5c. K7 (``mega_att_beam_decode``, one cooperative attention search over
   the whole card) vs the plain search at 1, 2, 8 and 64 images, both
   cells, margin-aware as phase 5, and vs the fused-step path (K6 per
   step) at atol 0; each shape timed, its bound from the live row-steps it
   ran;
6. serve: random-init StyleNet, NIC, StyleNet+Att and NIC+Att at flagship
   width (ResNet-152 at 224x224, E=300, H=F=A=512, V=8192, k=5, 40 steps)
   behind the HTTP service.  First with cross-request batching: concurrent
   ``POST /generate`` requests in all four modes (batched path: K2
   factored, K2 lstm, K7 factored, K7 lstm).  Then without batching: the
   same requests one by one (serial path: the same four kernels for one
   image).  Then the same requests through the engine's fused-step beams
   (K1, K2 lstm, the h0/c0 kernel and K6 of both cells for one image).
   Every variant's captions must match on all three paths, and each path's
   kernels must have launched (the counts are reset to 0 just before the
   path runs and read just after); every fused-step K1 and K6 call must
   have taken the column-split path.  Then a checkpoint
   round trip: reference-style torch checkpoints (StyleNet and
   StyleNet+Att decoder state dicts, full-module NIC and NIC+Att pickles)
   serve one request with the captions of the same weights passed as
   ``params``;
7. K3 (``fused_factored_scan``) and K4 (``fused_nic_scan``), forward and
   backward, vs their plain versions at B=64, T=25, E=300, F=H=512; K4
   also against cuDNN's ``nn.LSTM`` (the library yardstick); K3's products
   over all rows alone (3xTF32: ``wgmma`` from the weights' planes, and
   ``gemm_tf32x3.cuh`` for the weight grads) against float64, their error
   at most 4x that of ``gemm_f32.cuh``'s product on the same inputs, the
   same bits twice, with their device times and TFLOP/s beside
   ``gemm_f32.cuh``'s and ``torch.matmul``'s; one K3 call of each
   direction profiled by launch group (products, weight planes,
   recurrence, column sums), failing if a ``gemm_f32.cuh`` product ran or
   the recurrence took other than one launch; its float32 bound and its
   3xTF32 floor;
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
10. K5's product (``csrc/gemm_tf32x3.cuh``: float32 accuracy from three
   TF32 tensor-core passes) at every shape K5 launches against float64,
   its error at most 4x that of ``gemm_f32.cuh``'s CUDA-core product on
   the same inputs, the same bits twice, with both products' device times
   and achieved TFLOP/s; then K5 (``fused_att_scan`` and
   ``fused_att_scan_sampled``, the attention training scan) forward and
   backward vs their plain versions at B=128, T=25, full width (A=512,
   P=196, FS=2048), both cells, features drawn with numpy as N(0, 1) x
   0.1 (``bench.py:221-222``): the sampled argmax trace margin-aware (a
   differing token must tie the plain one within 1e-4), then the plain
   scan rerun on the kernel's trace; the backward the same bits twice;
   times of the kernel, the plain version and the library chain (per-step
   cuBLAS and torch calls, forward and through autograd); one call of each
   direction profiled, its device time by kernel split into products,
   attention passes and the rest, with no ``gemm_f32.cuh`` product in it;
11. training StyleNet+Att then NIC+Att at B=128, T=25: one factual step at
   ratio 1.0 on the kernel path vs the plain path, 30 factual + 30 emotion
   steps at the reference's ratio 0.8 (K5 sampled) whose loss must fall,
   3 steps at ratio 1.0 (K5 teacher-forced), every K5 and CE count reset
   to 0 just before and read just after; one ``val_step``; step time,
   captions/s, device-busy share and device time by kernel;
12. K8 (``fused_senticap_scan``, the SentiCap training scan) forward and
   backward vs its plain versions at B=128, T=22, E=H=512, at gclip 5.0
   and 0.01 (where the clamp on the recurrent dh binds), the same bits
   twice; times of the kernel and the plain version; its products alone,
   its launch groups and its floors as phase 7's for K3;
13. SentiCap base training at the reference COCO regime (B=128, T=22,
   E=H=512, V=8800, visual 4096, RMSProp): one step's loss and grads on
   the kernel path (K8, the chunked CE) vs the plain path, 30 steps over
   Zipf captions whose loss must fall, every K8 and CE count reset to 0
   just before and read just after; ``validation_perplexity`` on the
   chunked path; step time, captions/s, the plain step's time;
14. K9's product alone at its two shapes (3xTF32 ``wgmma`` from weight
   planes: error against float64 at most 4x ``gemm_f32.cuh``'s, the same
   bits twice, TFLOP/s); K9 (``mega_senticap_beam_decode``, the base
   model's whole beam search) vs its plain search at 64 images, beam 20,
   max_len 20, margin-aware as phase 5, with weights shaped so beams end
   at several lengths, and one call's device time by launch group (it
   fails if a ``gemm_f32.cuh`` product ran), beside its float32 bound and
   its 3xTF32 floor; then
   ``decode_split(switched=False)`` on a 64-image split, 7 timed calls
   (K9's count reset to 0 just before the first and read just after the
   last) and captions/s of the median call;
15. the SentiCap switched model's mixture CE (two heads) vs its plain
   versions at 128 x 22 rows, V=8800, gates U(0.05, 0.95): the row passes
   at the main path's chunk (the forward also vs the emulation of its
   partition), the whole loss and every gradient, the same bits twice;
   times of the row passes (CUDA events, and their kernels' device time
   cold and right after the chunk's two ``addmm``) and of the whole loss;
16. switch training at the reference's regime (B=128, T=22, E=H=512,
   V=8800, DA_SUM, LAMBDA_N = LAMBDA_GAM = 0.25, dropout on the sentiment
   path, RMSProp over the switch set at lr 1e-4) from a base trained 30
   steps as in phase 13, over sentiment-pure +1 batches with sentiment
   words at the switch positions: one step's loss and switch-set grads on the
   kernel path (two K8 scans, the mixture CE) vs the plain path, 30 steps
   whose loss must fall, every K8 and mixture-CE count reset to 0 just
   before and read just after, the frozen weights bit-identical;
   ``validation_perplexity(switched=True)`` on the chunked path; step time,
   captions/s, the plain step's time;
17. K10's products alone (both paths in one launch), as phase 14; K10
   (``mega_senticap_switched_decode``, the switched model's whole styled
   beam search with its switch-gate trace) vs its plain search at 64
   images, beam 20, max_len 20, margin-aware as phase 14, the trace within
   1e-5 where tokens agree, its launch groups as phase 14's; then
   ``decode_split(switched=True)`` on a 64-image split, 7 timed calls (K10
   and K9 counted from 0 just before the first and read just after the
   last: one launch each a call);
18. the trainers (``train/loops.py``) at flagship width on the host
   loader: ``MultitaskTrainer.train`` for StyleNet (3 epochs) and NIC (2)
   over 2,560 Zipf captions of 512 images (40 batches of 64), 320
   validation captions and 960 + 96 emotion captions, ratio 1.0; then
   ``TransferTrainer`` and ``PaperRegimeTrainer`` for an epoch each, and a
   StyleNet+Att epoch of 2 + 1 batches at B = 128, ratio 0.8.  Every count
   from 0 just before a run and read just after: K3 / K4 forward and
   backward once a step, the CE's row passes once a step and chunk, K2
   once a validation (K5 sampled on the attention epoch), and no plain
   version called; the factual train loss falls to <= LOSS_FALL x the
   first epoch's; ``restore`` gives bit-equal params and optimizer
   states; an engine from ``HAP_BEST_checkpoint_*`` captions as one from
   the params; the last sample = one K2 search = the plain
   ``beam_search``, margin-aware as phase 5.  Seconds an epoch (train,
   validation, sample, checkpoint), training captions/s with validation
   included, and a StyleNet epoch's device-busy share (the profiler);
19. print one ``{"train": {...}}`` line (with ``nic``, ``att``,
   ``senticap``, ``senticap_switched`` and ``trainer`` entries), one ``{"serve":
   {...}}`` line, one ``{"decode": {"senticap": {...},
   "senticap_switched": {...}}}`` line, one ``{"split_timeline": {...}}``
   line (phases 4 and 5b) and one ``{"kernels": [...]}`` line
   (K1, K2 factored and lstm, K6 factored and lstm, the h0/c0 kernel, K7
   factored and lstm, K3 and K4 forward and backward, CE forward and
   backward, K5 forward and backward for both cells and both modes, K8
   forward and backward, K9, the mixture CE forward and backward, K10);
20. print ``{"ok": true, "device": {...}}`` as the last line.

Without CUDA it exits 2, and where the package is not beside it 1, each
with a message and no result.
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
import urllib.error
import urllib.request

# published H100 SXM peaks: HBM 3.35 TB/s, float32 outside the tensor cores
# 67 TFLOP/s: every kernel's bound_ms counts float32 operations at this
# rate, so that it stays comparable across PRs
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
# K5's products: three TF32 tensor-core passes (495 TFLOP/s dense) per
# float32-accurate product, the floor its design faces
TF32X3_FLOP_PER_S = 495e12 / 3

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


def k1_line(dec, inputs, serial_inputs, max_err: float, ties: int):
    """Times K1, its plain version and the library yardstick at the
    batched shape (320 rows, the row-tiled path) and the serial one (5
    rows, the column-split path); -> K1's entry of the kernels line."""
    import torch

    from icee_tpu_torch.ops.cells import factored_lstm_cell
    from icee_tpu_torch.ops.decode_step import (decode_step_topk,
                                                decode_step_topk_plain)

    out = {}
    for tag, (x, h, c, style) in (("", inputs), ("serial_", serial_inputs)):
        rows = x.shape[0]

        def library():
            h_new, _ = factored_lstm_cell(dec, x, h, c, style)
            return torch.topk(torch.log_softmax(
                torch.addmm(dec["C_b"], h_new, dec["C_w"]), dim=-1), K)

        # the serial shape's calls are short and host-bound: more of them,
        # after more warm-up, for all three alike
        n, warm = (100, 10) if tag else (20, 1)
        out[tag + "ms"] = cuda_ms(
            lambda: decode_step_topk(dec, x, h, c, style, ktop=K), n, warm)
        out[tag + "plain_ms"] = cuda_ms(
            lambda: decode_step_topk_plain(dec, x, h, c, style, ktop=K), n,
            warm)
        out[tag + "library_ms"] = cuda_ms(library, n, warm)
        nbytes = decoder_weight_bytes() + 4 * rows * (E + 2 * H) \
            + 4 * rows * (2 * K + 2 * H)
        out[tag + "bound_ms"], out[tag + "bound_by"] = bound_ms(
            rows * step_flops_per_row(), nbytes)
    return dict(out, name="decode_step_topk", route="cuda",
                source="icee_tpu_torch/csrc/decode_step.cu",
                replaces="icee_tpu/ops/pallas_decode.py:261",
                max_abs_err=max_err, near_tie_swaps=ties,
                serial_source="icee_tpu_torch/csrc/split_step.cuh")


def split_timeline(fn, calls: int = 20):
    """The device side of ``fn`` (a column-split K1 or K6 call at the
    serial shape) without the host: ``fn`` captured in a CUDA graph;
    -> {"graph_ms": mean time of a replay (CUDA events, back to back),
    "span_us": mean span of one replay from its first launch's start to
    its last launch's end, "stages_us": {launch: [mean start, mean end]}
    after the first launch's start} from a torch.profiler trace of
    ``calls`` replays, synchronised one by one.  Stages overlap under
    programmatic dependent launch: a launch starts while its predecessor
    runs and waits for it inside."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph_ms = cuda_ms(graph.replay, 50, warmup=3)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            graph.replay()
            torch.cuda.synchronize()
    kernels = sorted(((e.time_range.start, e.time_range.end, e.name)
                      for e in prof.events()
                      if e.device_type == DeviceType.CUDA
                      and not e.is_user_annotation),
                     key=lambda k: k[0])
    n = len({name for _, _, name in kernels})
    if n == 0 or len(kernels) != n * calls:  # the trace missed launches
        return {"graph_ms": graph_ms, "span_us": None, "stages_us": None,
                "device_events": len(kernels)}
    stages, spans = {}, []
    for i in range(calls):
        call = kernels[i * n:(i + 1) * n]
        t0 = call[0][0]
        spans.append(max(e for _, e, _ in call) - t0)
        for b, e, name in call:
            acc = stages.setdefault(name[:90], [0.0, 0.0])
            acc[0] += (b - t0) / calls
            acc[1] += (e - t0) / calls
    return {"graph_ms": graph_ms, "span_us": sum(spans) / calls,
            "stages_us": stages}


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


def margin_check(what: str, got, want, rescored):
    """A search's results ``got`` against the plain search's ``want``,
    margin-aware: each kernel score must match its own sequence's plain
    score (``rescored``) within 1e-3, and where tokens differ from the
    plain search, the kernel's sequence must tie the plain winner's within
    1e-4; every score within 1e-3 of the plain one.  -> (max score error,
    max rescore error, near-tie flips)."""
    import torch

    max_err, own_err, flips = 0.0, 0.0, 0
    for i in range(got.length.shape[0]):
        gs, ws = got.score[i].item(), want.score[i].item()
        same = (got.length[i] == want.length[i]).item() and torch.equal(
            got.tokens[i], want.tokens[i])
        if int(got.length[i]) > 1:
            own = abs(rescored[i].item() - gs)
            own_err = max(own_err, own)
            if not own <= 1e-3:
                fail(f"{what}, image {i}: reported score {gs}, its "
                     f"sequence scores {rescored[i].item()}")
        if not same:
            # a near tie: the kernel's sequence scores within 1e-4 of the
            # plain winner's under the plain model
            margin = abs(rescored[i].item() - ws)
            if int(got.length[i]) == 1 or margin > 1e-4:
                fail(f"{what}, image {i}: tokens differ; kernel's sequence "
                     f"scores {rescored[i].item()}, plain winner {ws}, "
                     f"margin {margin} > 1e-4")
            flips += 1
            log(f"{what}, image {i}: near-tie flip, margin {margin}")
        err = abs(gs - ws)
        if not err <= 1e-3:
            fail(f"{what}, image {i}: score {gs} vs {ws}")
        max_err = max(max_err, err)
    return max_err, own_err, flips


K2_IMAGES = (1, 8, 64)   # the serial request, a batched call, the benchmark


def check_k2_shape(dec, device, cell: str, n_img: int):
    """K2 with ``cell`` for ``n_img`` images vs its plain search, in both
    feature modes; the factored cell also vs the fused-step path (K1) at
    atol 0; timed.  -> this shape's figures."""
    import torch

    from icee_tpu_torch.decode.fast import factored_decode
    from icee_tpu_torch.ops.beam import (mega_beam_decode,
                                         mega_beam_decode_plain,
                                         mega_beam_decode_steps)

    style = 2 if cell == "factored" else 0
    g = torch.Generator(device=device).manual_seed(4)
    feats = torch.randn((n_img, 1, E), generator=g, device=device)
    feats = feats.expand(n_img, K, E).contiguous()
    max_err, own_err, flips = 0.0, 0.0, 0
    kw = dict(k=K, max_seq_length=STEPS, cell=cell)
    for mode_feats in (feats, None):
        got, steps = mega_beam_decode_steps(dec, mode_feats, style, n_img,
                                            **kw)
        want = mega_beam_decode_plain(dec, mode_feats, style, n_img, **kw)
        # the plain model's score of the kernel's own sequences: a wrong
        # token, parent or length shows here even where the kernel's
        # reported score is right
        rescored = sequence_scores(dec, cell, mode_feats, style, got.tokens,
                                   got.length)
        mode = ("serving" if mode_feats is not None else "research") \
            + f", {cell}, {n_img} images"
        errs = margin_check(f"K2 {mode}", got, want, rescored)
        max_err, own_err = max(max_err, errs[0]), max(own_err, errs[1])
        flips += errs[2]
        if cell == "factored":
            # the fused-step path (K1 in the Python beam) gives the same
            # bits: column-split at <= 8 rows, row-tiled above
            fused = factored_decode("fused-step", dec, mode_feats, style,
                                    n_img, K, STEPS, 1, 2)
            for what in ("tokens", "length", "score"):
                if not torch.equal(getattr(fused, what), getattr(got, what)):
                    fail(f"K2 {mode}: {what} differ from the fused-step "
                         "path's (atol 0)")
        lengths = got.length.float()
        log(f"K2 {mode}: lengths mean {lengths.mean().item():.2f} min "
            f"{int(lengths.min())} max {int(lengths.max())}, steps run per "
            f"image min {int(steps[:, 0].min())} max "
            f"{int(steps[:, 0].max())}, live row-steps "
            f"{int(steps[:, 1].sum())}; rescore max abs err so far {own_err}"
            + ("; = fused-step at atol 0" if cell == "factored" else ""))
        if mode_feats is not None:
            serving_steps = steps   # the timed, serving-mode run

    ms = cuda_ms(lambda: mega_beam_decode(dec, feats, style, n_img, **kw), 5)
    plain_ms = cuda_ms(lambda: mega_beam_decode_plain(
        dec, feats, style, n_img, **kw), 3)
    row_steps = int(serving_steps[:, 1].sum())
    nbytes = (decoder_weight_bytes(cell) + 4 * n_img * K * E
              + 4 * row_steps * E + 4 * n_img * (STEPS + 4))
    b_ms, b_by = bound_ms(row_steps * step_flops_per_row(cell), nbytes)
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "max_abs_err": max_err,
            "max_rescore_err": own_err, "near_tie_flips": flips,
            "steps_min_max": [int(serving_steps[:, 0].min()),
                              int(serving_steps[:, 0].max())],
            "live_row_steps": row_steps}


def check_k2(dec, device, cell: str = "factored"):
    """K2 with ``cell`` at 1, 8 and 64 images (``check_k2_shape``); -> its
    entry of the kernels line: the 64-image figures, and every shape's
    under ``shapes``."""
    from icee_tpu_torch.ops.beam import max_grid

    shapes = {str(n): check_k2_shape(dec, device, cell, n)
              for n in K2_IMAGES}
    top = shapes[str(B_IMAGES)]
    lstm = cell == "lstm"
    return {"name": "mega_beam_decode" + ("_lstm" if lstm else ""),
            "route": "cuda", "source": "icee_tpu_torch/csrc/beam.cu",
            "replaces": "icee_tpu/ops/pallas_beam.py:350" + (
                " (cell=\"lstm\", :129-143)" if lstm else ""),
            "max_abs_err": max(s["max_abs_err"] for s in shapes.values()),
            "ms": top["ms"], "plain_ms": top["plain_ms"],
            "bound_ms": top["bound_ms"], "bound_by": top["bound_by"],
            "library_ms": None,
            "library_note": "no single PyTorch call computes a beam search",
            "near_tie_flips": sum(s["near_tie_flips"]
                                  for s in shapes.values()),
            "max_rescore_err": max(s["max_rescore_err"]
                                   for s in shapes.values()),
            "grid_blocks": max_grid(dec["C_w" if not lstm
                                        else "linear_w"].device),
            "shapes": shapes}


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
        # the serial shape's calls are short and host-bound: more of them,
        # after more warm-up, for all three alike
        n, n_plain, warm = (100, 100, 10) if tag else (20, 5, 1)
        out[tag + "ms"] = cuda_ms(lambda: att_decode_step_topk(*a, ktop=K),
                                  n, warm)
        out[tag + "plain_ms"] = cuda_ms(
            lambda: att_decode_step_topk_plain(*a, ktop=K), n_plain, warm)
        out[tag + "library_ms"] = cuda_ms(lambda: att_library_step(a), n,
                                          warm)
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


INIT_IMAGES = (1, 2, 8, 64)   # K7's shapes; timed at 1 and 64
INIT_KERNELS = ("att_init_kernel",)   # the h0/c0 launch's, any version


def check_att_init(att, device):
    """Phase 5b: the h0/c0 launch (``att_init_state``: K7's mean and init
    stages alone, over the whole card) for both attention decoders at 1,
    2, 8 and 64 images: within 1e-4 of ``init_hidden_state``, equal at
    atol 0 to the h0/c0 K7 computes for the same images
    (``att_beam.search_init_state``), the same bits twice.  Timed with
    the StyleNet+Att weights at one image (the fused-step path's launches)
    and 64, by CUDA events and by the device time of its kernels in a
    profiler trace (in all, and launch by launch: the mean's, the init
    stage's and the gap between), each beside its bound.  -> its entry of
    the kernels line: the one-image figures, and both shapes' under
    ``shapes``."""
    import torch

    from icee_tpu_torch.models import attention as att_mod
    from icee_tpu_torch.ops.att_beam import search_init_state
    from icee_tpu_torch.ops.att_decode_step import att_init_state

    err, shapes = 0.0, {}
    for n in INIT_IMAGES:
        feats = att_features(device, n, 9)
        for kind, dec in att.items():
            h0, c0 = att_init_state(dec, feats)
            h1, c1 = att_init_state(dec, feats)
            kh, kc = search_init_state(dec, feats, kind,
                                       3 if kind == "factored" else 0, K)
            wh, wc = att_mod.init_hidden_state(dec, feats)
            torch.cuda.synchronize()
            e = max((h0 - wh).abs().max().item(),
                    (c0 - wc).abs().max().item())
            err = max(err, e)
            if not e <= 1e-4:
                fail(f"att_init_state {kind}, {n} images: h0/c0 error {e} "
                     "> 1e-4")
            if kh is None or not (torch.equal(h0, kh)
                                  and torch.equal(c0, kc)):
                fail(f"att_init_state {kind}, {n} images: h0/c0 differ "
                     "from K7's (atol 0)")
            if not (torch.equal(h0, h1) and torch.equal(c0, c1)):
                fail(f"att_init_state {kind}, {n} images: two runs differ")
        if n not in (1, B_IMAGES):
            continue
        dec = att["factored"]
        flops = n * (P * FS + 2 * 2 * FS * H)
        nbytes = 4 * (n * P * FS + 2 * FS * H + 2 * H + 2 * n * H)
        b_ms, b_by = bound_ms(flops, nbytes)

        def run(dec=dec, feats=feats):
            return att_init_state(dec, feats)

        shapes[str(n)] = {
            "ms": cuda_ms(run, 50, 5),
            "device_ms": kernels_device_ms(run, INIT_KERNELS, 50),
            "by_launch": launches_device_ms(run, INIT_KERNELS, 50),
            "plain_ms": cuda_ms(
                lambda: att_mod.init_hidden_state(dec, feats), 20),
            "bound_ms": b_ms, "bound_by": b_by}
    log(f"att_init_state: {INIT_IMAGES} images, both decoders: h0/c0 max "
        f"abs err {err:.3g} vs init_hidden_state, = K7's at atol 0, the "
        "same bits twice; " + "; ".join(
            f"{n} images {v['ms']:.4f} ms (device {v['device_ms']}, by "
            f"launch {v['by_launch']}, plain {v['plain_ms']:.4f}, bound "
            f"{v['bound_ms']:.4f})"
            for n, v in shapes.items()))
    top = shapes["1"]
    return {"name": "att_init_state", "route": "cuda",
            "source": "icee_tpu_torch/csrc/att_beam.cu",
            "replaces": "icee_tpu/ops/pallas_att_decode.py:456 (the h/c "
                        "init of mega_att_beam_decode, hoisted for the "
                        "serial path as the streamed call hoists it)",
            "max_abs_err": err, "ms": top["ms"],
            "device_ms": top["device_ms"], "plain_ms": top["plain_ms"],
            "bound_ms": top["bound_ms"], "bound_by": top["bound_by"],
            "library_ms": None,
            "library_note": "no single PyTorch call: a mean and two "
                            "products",
            "shapes": shapes}


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


K7_IMAGES = (1, 2, 8, 64)   # the serial request, batched calls, benchmark


def check_k7_shape(dec, kind: str, device, n_img: int):
    """K7 with ``kind`` for ``n_img`` images vs its plain search,
    margin-aware as phase 5: each kernel score matches its own sequence's
    plain score within 1e-3, and where tokens differ from the plain search,
    the kernel's sequence ties the plain winner's within 1e-4; and vs the
    fused-step path (K6 per step from the h0/c0 kernel) at atol 0; timed,
    its bound from the live row-steps it ran.  -> this shape's figures."""
    import torch

    from icee_tpu_torch.decode.fast import attention_decode, nic_att_decode
    from icee_tpu_torch.ops.att_beam import (mega_att_beam_decode,
                                             mega_att_beam_decode_plain,
                                             mega_att_beam_decode_steps)

    style = 3 if kind == "factored" else 0
    feats = att_features(device, n_img, 14)
    kw = dict(k=K, max_seq_length=STEPS, kind=kind)
    got, steps = mega_att_beam_decode_steps(dec, feats, style, n_img, **kw)
    want = mega_att_beam_decode_plain(dec, feats, style, n_img, **kw)
    rescored = att_sequence_scores(dec, kind, feats, style, got.tokens,
                                   got.length)
    what = f"K7 {kind} {n_img} images"
    max_err, own_err, flips = margin_check(what, got, want, rescored)
    # the fused-step path (K6 per step: column-split at one image,
    # row-tiled above) gives the same bits
    args = (n_img, K, STEPS, 1, 2)
    fused = (attention_decode("fused-step", dec, feats, style, *args)
             if kind == "factored"
             else nic_att_decode("fused-step", dec, feats, *args))
    for name in ("tokens", "length", "score"):
        if not torch.equal(getattr(fused, name), getattr(got, name)):
            fail(f"{what}: {name} differ from the fused-step path's "
                 "(atol 0)")
    lengths = got.length.float()
    row_steps = int(steps[:, 1].sum())
    log(f"{what}: lengths mean {lengths.mean().item():.2f} min "
        f"{int(lengths.min())} max {int(lengths.max())}, steps run per image "
        f"min {int(steps[:, 0].min())} max {int(steps[:, 0].max())}, live "
        f"row-steps {row_steps}; rescore max abs err {own_err}; = fused-step "
        "at atol 0")
    ms = cuda_ms(lambda: mega_att_beam_decode(dec, feats, style, n_img, **kw),
                 5)
    plain_ms = cuda_ms(lambda: mega_att_beam_decode_plain(
        dec, feats, style, n_img, **kw), 1)
    flops = (row_steps * att_step_flops_per_row(kind)
             + n_img * (P * FS + 2 * 2 * FS * H))
    nbytes = (att_weight_bytes(kind, init=True) + 4 * n_img * P * (FS + A)
              + 4 * row_steps * E + 4 * n_img * (STEPS + 4))
    b_ms, b_by = bound_ms(flops, nbytes)
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "max_abs_err": max_err,
            "max_rescore_err": own_err, "near_tie_flips": flips,
            "steps_min_max": [int(steps[:, 0].min()), int(steps[:, 0].max())],
            "live_row_steps": row_steps,
            "caption_lengths_min_mean_max": [int(lengths.min()),
                                             lengths.mean().item(),
                                             int(lengths.max())]}


def check_k7(dec, kind: str, device):
    """K7 with ``kind`` at 1, 2, 8 and 64 images (``check_k7_shape``); ->
    its entry of the kernels line: the 64-image figures, and every shape's
    under ``shapes``."""
    from icee_tpu_torch.ops.att_beam import max_grid

    shapes = {str(n): check_k7_shape(dec, kind, device, n)
              for n in K7_IMAGES}
    top = shapes[str(B_IMAGES)]
    lstm = kind == "lstm"
    return {"name": "mega_att_beam_decode" + ("_lstm" if lstm else ""),
            "route": "cuda", "source": "icee_tpu_torch/csrc/att_beam.cu",
            "replaces": "icee_tpu/ops/pallas_att_decode.py:733 (kind=\""
                        + kind + "\"; both calls, :974 and :907)",
            "max_abs_err": max(s["max_abs_err"] for s in shapes.values()),
            "ms": top["ms"], "plain_ms": top["plain_ms"],
            "bound_ms": top["bound_ms"], "bound_by": top["bound_by"],
            "library_ms": None,
            "library_note": "no single PyTorch call computes a beam search",
            "near_tie_flips": sum(s["near_tie_flips"]
                                  for s in shapes.values()),
            "max_rescore_err": max(s["max_rescore_err"]
                                   for s in shapes.values()),
            "grid_blocks": max_grid(dec["init_h_w"].device),
            "shapes": shapes}


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
        try:
            results[j] = _post(url, p, m)
        except urllib.error.HTTPError as e:  # the service's error text
            results[j] = (e.code, {"error": e.read().decode(errors="replace")},
                          0.0)

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


def device_busy_share(fn, top: int = 0):
    """Share of one run of ``fn``'s wall time in which the card was busy
    (kernels and copies), from a torch.profiler trace; None when the trace
    holds no device event.  The profiler's own host cost lengthens the run,
    so the share reads low.  With ``top``, -> (share, the ``top`` largest
    kernels' device ms as ``device_time_by_kernel`` gives them) from the
    same trace."""
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
    share = busy_us / wall_us if busy_us > 0 else None
    if not top:
        return share
    return share, kernel_rows(prof, top)


def kernel_rows(prof, top: int | None):
    """A profiler trace's device time (ms) summed by kernel name, the
    ``top`` largest (None: all)."""
    from torch.autograd import DeviceType

    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total]
    rows.sort(key=lambda r: -r[1])
    return [{"kernel": k[:90], "ms": ms, "count": n} for k, ms, n in rows[:top]]


def kernels_device_ms(fn, frags, iters: int, prep=None):
    """Device ms a call of ``fn`` spends in the kernels whose names hold
    one of ``frags``, from a profiler trace of ``iters`` calls (``prep``
    run before each, outside the count); None where the trace holds no
    such kernel."""
    rows = device_time_by_kernel(
        lambda: [((prep() if prep else None), fn()) for _ in range(iters)],
        top=None)
    ms = sum(r["ms"] for r in rows if any(f in r["kernel"] for f in frags))
    return ms / iters if ms > 0 else None


def launches_device_ms(fn, frags, iters: int):
    """A call of ``fn`` launch by launch: the device ms of each launch of
    a kernel whose name holds one of ``frags``, by its place in the call,
    and of the gap between each and the next, means over a profiler trace
    of ``iters`` calls; None where the trace holds none of them.  ->
    {"launch_ms": [...], "gap_ms": [...]}"""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    ev = sorted((e for e in prof.events()
                 if e.device_type == DeviceType.CUDA
                 and any(f in e.name for f in frags)),
                key=lambda e: e.time_range.start)
    if not ev or len(ev) % iters:
        return None
    per = len(ev) // iters
    calls = [ev[i * per:(i + 1) * per] for i in range(iters)]
    return {"launch_ms": [statistics.mean(c[j].time_range.elapsed_us()
                                          for c in calls) / 1e3
                          for j in range(per)],
            "gap_ms": [statistics.mean(c[j + 1].time_range.start
                                       - c[j].time_range.end
                                       for c in calls) / 1e3
                       for j in range(per - 1)]}


def device_time_by_kernel(fn, top: int | None = 12):
    """Device time (ms) of one run of ``fn`` summed by kernel name, the
    ``top`` largest (None: all), from a torch.profiler trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return kernel_rows(prof, top)


def request_breakdown(engine, paths, repeats: int = 5):
    """Device-synchronised host times (ms, median of ``repeats``) of the
    pieces of a request: the whole serial request without HTTP
    (``engine.caption``: one backbone pass and four beams); image decode +
    ResNet-152 + head for one image; per variant the serial beam for one
    image (one K2 or K7 launch), for stylenet and the attention variants
    also the fused-step beam (K1 or K6 per step in a Python beam), and the
    batched beam (K2 or K7) for a group of len(paths) images; and each
    piece's device busy share and its three largest kernels' device ms
    (profiled runs)."""
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

    pieces = {"caption_one_image": lambda: engine.caption(paths[0], "happy"),
              "encode_one_image": lambda: engine.encode(paths[0], "happy")}
    for variant in SERVED:
        feat = engine.encode(paths[0], "happy", variant)
        group = torch.cat([engine.encode(p, "happy", variant) for p in paths])
        pre = "" if variant == "stylenet" else variant + "_"
        pieces[pre + "serial_beam_one_image"] = (
            lambda f=feat, v=variant: engine.decode(f, "happy", "mega", v))
        if variant != "nic":
            pieces[pre + "fused_step_beam_one_image"] = (
                lambda f=feat, v=variant: engine.decode(f, "happy",
                                                        "fused-step", v))
        pieces[pre + f"batched_beam_{len(paths)}_images"] = (
            lambda g=group, v=variant: engine.decode(g, "happy", "mega", v))
    out = {}
    for name, fn in pieces.items():
        share, kernels = device_busy_share(fn, top=3)
        out[name] = {"ms": timed(fn), "device_busy_share": share,
                     "device_ms_by_kernel": kernels}
    return out


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
    from icee_tpu_torch.serve.batching import BatchingEngine
    from icee_tpu_torch.serve.config import ServeConfig
    from icee_tpu_torch.serve.engine import BEAM_K, CaptionEngine

    step_paths = {"decode_step_topk": (decode_step_topk, ""),
                  "att_decode_step_topk": (att_decode_step_topk, ""),
                  "att_decode_step_topk_lstm": (att_decode_step_topk,
                                                "lstm_")}

    def reset():
        decode_step_topk.launches = att_init_state.launches = 0
        mega_beam_decode.launches = mega_beam_decode.lstm_launches = 0
        att_decode_step_topk.launches = att_decode_step_topk.lstm_launches = 0
        mega_att_beam_decode.launches = 0
        mega_att_beam_decode.lstm_launches = 0
        for fn, prefix in step_paths.values():
            for path in ("split_", "tiled_"):
                setattr(fn, prefix + path + "launches", 0)

    def read():
        paths = {f"{name}_{path}": getattr(fn, prefix + path + "_launches")
                 for name, (fn, prefix) in step_paths.items()
                 for path in ("split", "tiled")}
        return {**paths, "decode_step_topk": decode_step_topk.launches,
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
        batcher = BatchingEngine(engine, window_ms=config.batch_window_ms)
        with serving(config, batcher, device) as url:
            batched, wall = run_requests(url, requests, concurrent=True)
        launches = {"batched": read()}
        # images a batched call decodes (the group padded to a power of 2):
        # each group is one K2 launch per global-feature variant
        groups = [1 << (n - 1).bit_length() for n in batcher.group_sizes]
        # path 2, serial: the same requests one by one through the
        # CaptionEngine alone (one K2 launch for stylenet and for nic, one
        # K7 launch for each attention variant, one image each)
        serial_config = dataclasses.replace(config, batch_window_ms=0.0)
        reset()
        with serving(serial_config, engine, device) as url:
            serial, serial_wall = run_requests(url, requests,
                                               concurrent=False)
        launches["serial"] = read()
        # path 3, the fused-step beams: the same requests one by one
        # through CaptionEngine.caption(path="fused-step") (K1 for
        # stylenet, K2 lstm for nic, the h0/c0 kernel and K6 of both kinds
        # for the attention variants, a Python beam over one image)
        reset()
        fused = [engine.caption(p, m, path="fused-step")
                 for p, m in requests]
        launches["fused_step"] = read()

        for j, (p, m) in enumerate(requests):
            for variant in SERVED:
                want = serial[j][1][variant]
                for path, got in (("batched", batched[j][1][variant]),
                                  ("fused-step", fused[j][variant])):
                    if got != want:
                        fail(f"request {j} ({m}) {variant}: {path} caption "
                             f"{got!r} != serial {want!r}")
        mega = ("mega_beam_decode", "mega_beam_decode_lstm",
                "mega_att_beam_decode", "mega_att_beam_decode_lstm")
        for path, names in (("batched", mega), ("serial", mega),
                            ("fused_step", ("decode_step_topk",
                                            "mega_beam_decode_lstm",
                                            "att_decode_step_topk",
                                            "att_decode_step_topk_lstm",
                                            "att_init_state"))):
            for name in names:
                if launches[path][name] <= 0:
                    fail(f"{name} was not launched on the {path} path")
        # every fused-step request is one image: K1 and K6 must have taken
        # their column-split path, every time
        for name in step_paths:
            got = launches["fused_step"]
            if got[name + "_tiled"] or got[name + "_split"] != got[name]:
                fail(f"{name} on the fused-step path: "
                     f"{got[name + '_split']} column-split and "
                     f"{got[name + '_tiled']} row-tiled calls of "
                     f"{got[name]}")
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
            f"batched, serial and fused-step paths; words per caption "
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
                 "batched_images_per_call": groups,
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


# K3's and K8's launch groups, by kernel-name fragment: the products over
# all rows (the planes product and gemm_tf32x3.cuh's, its partial sums
# included), the weights' TF32 planes, the recurrence, the bias column sums
SCAN_GROUPS = (("products_ms", ("sb_product_kernel", "tf32x3_")),
               ("planes_ms", ("sb_prepare_kernel",)),
               ("recurrence_ms", ("scan_fwd_grid_kernel",
                                  "scan_bwd_grid_kernel")),
               ("column_sums_ms", ("colsum_kernel",)))


def scan_device_groups(what: str, fn):
    """Device time (ms) of one K3, K4 or K8 call ``fn`` by launch group, from
    a profiler trace, with each group's launches; fails if the call ran a
    ``gemm_f32.cuh`` product (``gemm_kernel``) or launched its recurrence
    other than once.  None where the trace holds no device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = [e for e in prof.events()
              if e.device_type == DeviceType.CUDA
              and not e.is_user_annotation and e.self_device_time_total > 0]
    if not events:
        log(f"{what}: the profiler trace holds no device time")
        return None
    if any("gemm_kernel" in e.name for e in events):
        fail(f"{what} launched a gemm_f32.cuh product: "
             f"{sorted({e.name for e in events})}")
    groups = {g: 0.0 for g, _ in SCAN_GROUPS}
    groups["other_ms"] = 0.0
    counts = {g: 0 for g in groups}
    for e in events:
        key = next((g for g, frags in SCAN_GROUPS
                    if any(f in e.name for f in frags)), "other_ms")
        groups[key] += e.self_device_time_total / 1e3
        counts[key] += 1
    if counts["recurrence_ms"] != 1:
        fail(f"{what}: {counts['recurrence_ms']} recurrence launches, "
             "expected one")
    groups["total_ms"] = sum(e.self_device_time_total for e in events) / 1e3
    groups["launches"] = counts
    return groups


def scan_products(kernel: str):
    """(direction, name, form, M, N, K, batch, bias) of every product over
    all rows that K3 or K4 (B_IMAGES x T_STEPS) or K8 (SC_B x SC_T)
    launches: 'N' and 'T' by wgmma from the weight's planes, 'A' (the
    weight grads) on ``gemm_tf32x3.cuh``."""
    if kernel == "K3":
        n = B_IMAGES * T_STEPS
        return [("fwd", "x_Vw", "N", n, 4 * F, E, 1, True),
                ("fwd", "v_S", "N", n, F, F, 4, True),
                ("fwd", "s_U", "N", n, H, F, 4, True),
                ("bwd", "dz_Ut", "T", n, F, H, 4, False),
                ("bwd", "ds_St", "T", n, F, F, 4, False),
                ("bwd", "dv_Vwt", "T", n, E, 4 * F, 1, False),
                ("bwd", "g_Ww", "A", H, 4 * H, n, 1, False),
                ("bwd", "g_U", "A", F, H, n, 4, False),
                ("bwd", "g_S", "A", F, F, n, 4, False),
                ("bwd", "g_Vw", "A", E, 4 * F, n, 1, False)]
    if kernel == "K4":
        n = B_IMAGES * T_STEPS
        return [("fwd", "x_Wih", "N", n, 4 * H, E, 1, True),
                ("bwd", "dZ_Wiht", "T", n, E, 4 * H, 1, False),
                ("bwd", "g_Wih", "A", E, 4 * H, n, 1, False),
                ("bwd", "g_Whh", "A", H, 4 * H, n, 1, False)]
    n = SC_B * SC_T
    return [("fwd", "x_Wx", "N", n, 4 * SC_H, SC_E, 1, False),
            ("bwd", "dZ_Wxt", "T", n, SC_E, 4 * SC_H, 1, False),
            ("bwd", "g_Wx", "A", SC_E, 4 * SC_H, n, 1, False),
            ("bwd", "g_Wh", "A", SC_H, 4 * SC_H, n, 1, False)]


def check_scan_products(device, kernel: str):
    """Phases 7 and 12 (i): every product K3, K4 or K8 runs over all rows,
    alone at its main-path shape (``scan_grid.scan_product``: the weight's
    planes laid out, then the wgmma product; ``gemm_tf32x3.cuh`` for the
    weight grads), batched operands strided as the scan keeps them,
    against float64: its max abs error at most 4x that of
    ``gemm_f32.cuh``'s product (``att_scan.f32_product``) on the same
    inputs, the same bits twice; device ms (planes included) and TFLOP/s
    (float32 operations) of it, of ``gemm_f32.cuh``'s and of
    ``torch.matmul`` (float32, TF32 off).  -> {direction: {name: stats}}"""
    import numpy as np
    import torch

    from icee_tpu_torch.ops import att_scan, scan_grid

    out = {"fwd": {}, "bwd": {}}
    for i, (direction, name, form, m, n, k, batch, with_bias) in enumerate(
            scan_products(kernel)):
        rng = np.random.default_rng(110 + i)
        a_rows, a_cols = (k, m) if form == "A" else (m, k)
        b_rows, b_cols = (n, k) if form == "T" else (k, n)
        a = torch.tensor(rng.uniform(-1, 1, (a_rows, batch * a_cols)).astype(
            np.float32), device=device)
        b = torch.tensor((0.05 * rng.standard_normal(
            (batch, b_rows, b_cols))).astype(np.float32), device=device)
        bias = torch.tensor(rng.standard_normal(
            (batch, n) if batch > 1 else (n,)).astype(np.float32),
            device=device) if with_bias else None
        if batch == 1:
            b = b[0]
        else:
            a = a.view(a_rows, batch, a_cols).transpose(0, 1)
        got = scan_grid.scan_product(a, b, form, bias)
        again = scan_grid.scan_product(a, b, form, bias)
        f32 = att_scan.f32_product(a, b, form, bias)
        ref = (att_scan._as_mk(a, form).double()
               @ att_scan._as_kn(b, form).double())
        if with_bias:
            ref = ref + (bias[:, None] if batch > 1 else bias).double()
        torch.cuda.synchronize()
        err = (got.double() - ref).abs().max().item()
        err_f32 = (f32.double() - ref).abs().max().item()
        if not err <= 4.0 * err_f32:
            fail(f"{kernel} product {name}: max abs error {err} > 4 x "
                 f"gemm_f32's {err_f32}")
        if not torch.equal(got, again):
            fail(f"{kernel} product {name}: two runs differ")
        del got, again, f32, ref
        aa, bb = att_scan._as_mk(a, form), att_scan._as_kn(b, form)
        ms = kernel_ms(lambda: scan_grid.scan_product(a, b, form, bias), 20)
        ms_f32 = kernel_ms(lambda: att_scan.f32_product(a, b, form, bias), 5)
        ms_lib = cuda_ms(lambda: torch.matmul(aa, bb), 20, warmup=3)
        flops = 2.0 * m * n * k * batch
        out[direction][name] = {
            "form": form, "M": m, "N": n, "K": k, "batch": batch,
            "max_abs_err": err, "f32_max_abs_err": err_f32,
            "err_over_f32": err / err_f32, "device_ms": ms,
            "tflops": flops / ms / 1e9, "f32_device_ms": ms_f32,
            "f32_tflops": flops / ms_f32 / 1e9, "matmul_ms": ms_lib,
            "matmul_tflops": flops / ms_lib / 1e9}
        if form == "A":
            # the other route for a weight grad: A^T written k-contiguous
            # (a copy), then the planes of B and the wgmma product
            ms_wg = kernel_ms(lambda: scan_grid.scan_product(
                aa.contiguous(), b, "N"), 20)
            out[direction][name]["wgmma_route_ms"] = ms_wg
            out[direction][name]["wgmma_route_tflops"] = flops / ms_wg / 1e9
        del a, b, bias, aa, bb
    return out


def scan_products_line(stats) -> str:
    return "; ".join(
        f"{n} {s['device_ms']:.4f} ms {s['tflops']:.1f} TFLOP/s (error "
        f"{s['err_over_f32']:.2f}x gemm_f32's; gemm_f32 "
        f"{s['f32_device_ms']:.4f}, torch.matmul {s['matmul_ms']:.4f}"
        + (f", transposed + wgmma {s['wgmma_route_ms']:.4f}"
           if "wgmma_route_ms" in s else "") + ")"
        for d in ("fwd", "bwd") for n, s in stats[d].items())


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

    groups_f = scan_device_groups(
        "K3 forward", lambda: lstm_scan.factored_scan_fwd(p, x))
    groups_b = scan_device_groups(
        "K3 backward", lambda: lstm_scan.factored_scan_bwd(
            p, x, h_seq, c_seq, dh, saved))
    products = check_scan_products(device, "K3")
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
                 bound_ms=bf, bound_by=bf_by,
                 bound_tf32x3_ms=flops_f / TF32X3_FLOP_PER_S * 1e3,
                 device_ms_by_group=groups_f, products=products["fwd"]),
            dict(common, name="fused_factored_scan_bwd",
                 replaces="icee_tpu/ops/pallas_lstm.py:298",
                 max_abs_err=max((dx - want_dx).abs().max().item(),
                                 *((grads[k] - want_g[k]).abs().max().item()
                                   for k in grads)),
                 max_rel_err=max(rel.values()), ms=ms_b, plain_ms=plain_b,
                 bound_ms=bb, bound_by=bb_by,
                 bound_tf32x3_ms=flops_b / TF32X3_FLOP_PER_S * 1e3,
                 device_ms_by_group=groups_b, products=products["bwd"]))


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
    times, the library yardstick; one call a direction by launch group
    (``scan_device_groups``: no ``gemm_f32.cuh`` product, one recurrence
    launch) and K4's products alone (``check_scan_products``).  ->
    (forward, backward) entries of the kernels line."""
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

    groups_f = scan_device_groups(
        "K4 forward", lambda: nic_scan.nic_scan_fwd(cell, x))
    groups_b = scan_device_groups(
        "K4 backward", lambda: nic_scan.nic_scan_bwd(cell, x, h_seq, c_seq,
                                                     dh, gates))
    products = check_scan_products(device, "K4")
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
                 bound_ms=bf, bound_by=bf_by,
                 bound_tf32x3_ms=flops_f / TF32X3_FLOP_PER_S * 1e3,
                 library_ms=lib_f, library_max_abs_err=lib_err,
                 device_ms_by_group=groups_f, products=products["fwd"]),
            dict(common, name="fused_nic_scan_bwd",
                 replaces="icee_tpu/ops/pallas_nic_train.py:227",
                 max_abs_err=max((dx - want_dx).abs().max().item(),
                                 *((grads[k] - want_g[k]).abs().max().item()
                                   for k in grads)),
                 max_rel_err=max(rel.values()), ms=ms_b, plain_ms=plain_b,
                 bound_ms=bb, bound_by=bb_by,
                 bound_tf32x3_ms=flops_b / TF32X3_FLOP_PER_S * 1e3,
                 library_ms=lib_b, device_ms_by_group=groups_b,
                 products=products["bwd"]))


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


CE_FWD_KERNELS = ("ce_rows_kernel",)
CE_BWD_KERNELS = ("ce_grad_rows_kernel", "ce_colsum_groups_kernel",
                  "ce_target_kernel", "colsum_kernel")


def ce_pass_ms(device, logits, tflat, wflat, x, w, b, iters: int = 20):
    """Device ms of one CE row pass, forward and backward, two ways: cold
    (after writing a buffer twice the L2's 50 MB, the chunk copied in
    first for the backward) and as the main path runs it (right after the
    ``addmm`` that writes the chunk from x, w, b).  Each is the summed
    device time of the pass's own kernels (``CE_FWD_KERNELS``,
    ``CE_BWD_KERNELS``) in a profiler trace of ``iters`` runs, over
    ``iters``; by CUDA events around the pass (host gaps included) where
    the trace holds none of them.  -> {"fwd_cold_ms", "fwd_after_addmm_ms",
    "bwd_cold_ms", "bwd_after_addmm_ms"}"""
    import torch

    from icee_tpu_torch.ops import chunked_loss as cl

    flush = torch.empty((100 << 20) // 4, device=device)
    scratch = torch.empty_like(logits)
    db = torch.zeros((logits.shape[1],), device=device)
    one = torch.ones((1,), device=device)
    lse, _ = cl.ce_rows(logits, tflat, wflat)

    def cold_fwd():
        flush.zero_()

    def cold_bwd():
        scratch.copy_(logits)
        flush.zero_()

    def addmm():
        torch.addmm(b, x, w, out=scratch)

    fwd = {"cold": (cold_fwd, lambda: cl.ce_rows(logits, tflat, wflat)),
           "after_addmm": (addmm, lambda: cl.ce_rows(scratch, tflat,
                                                     wflat))}
    bwd = {"cold": (cold_bwd, lambda: cl.ce_grad_rows(
        scratch, tflat, wflat, lse, one, db)),
           "after_addmm": (addmm, lambda: cl.ce_grad_rows(
               scratch, tflat, wflat, lse, one, db))}
    out = {}
    for direction, passes, frags in (("fwd", fwd, CE_FWD_KERNELS),
                                     ("bwd", bwd, CE_BWD_KERNELS)):
        for how, (prep, fn) in passes.items():
            ms = kernels_device_ms(fn, frags, iters, prep)
            if ms is None:
                log("ce_pass_ms: the profiler trace holds no CE kernel; "
                    "CUDA events")
                ms = events_after(prep, fn, iters)
            out[f"{direction}_{how}_ms"] = ms
    return out


def events_after(prep, fn, iters: int) -> float:
    """Mean device ms of ``fn`` alone by CUDA events around it, ``prep``
    run before each call outside the events."""
    import torch

    prep()
    fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(iters):
        prep()
        a = torch.cuda.Event(enable_timing=True)
        z = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        z.record()
        pairs.append((a, z))
    torch.cuda.synchronize()
    return statistics.mean(a.elapsed_time(z) for a, z in pairs)


def ce_grad_rows_raw(logits, tflat, wflat, lse, g, db, accumulate: int):
    """The backward row pass through the library's entry point with
    ``accumulate`` as given (the wrapper always adds into db)."""
    import torch

    from icee_tpu_torch.ops import chunked_loss as cl
    from icee_tpu_torch.ops import cuda_lib

    lib = cl._library()
    r, v = logits.shape
    ws = torch.empty((lib.icee_ce_grad_ws(r, v),), device=logits.device)
    p = cuda_lib.ptr
    rc = lib.icee_ce_grad_rows(p(logits), p(tflat), p(wflat), p(lse), p(g),
                               p(db), accumulate, p(ws), ws.numel(), r, v,
                               0.0, 0, cuda_lib.stream_ptr(logits.device))
    cuda_lib.check_rc(lib, rc, "ce_grad_rows (raw)")
    return logits


def check_ce(device):
    """The CE row passes vs their plain versions, and the whole chunked loss
    (kernel path) vs the plain path and the materialized loss, at 64 x 25
    rows, H = 512, V = 8192, lengths 8..25, two masked rows; t_chunk 25
    (auto) and 22 (the emotion batch's, not dividing T); the clamp form.
    Tolerances: lse and w*nll atol 1e-4 (values ~9, float32 sums over 8192
    terms in other orders); dl and db 1e-4 x their largest magnitude, db
    added into ones (accumulate on) and written alone (off); the loss atol
    1e-5 and each grad 1e-3 x its largest magnitude (as phase 7).  Both
    passes give the same bits twice.  Times: by CUDA events, and
    ``ce_pass_ms``'s cold and after-addmm device times.
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
    one = torch.ones((1,), device=device)
    for clamp in (None, 8.0):
        lse, contrib = cl.ce_rows(logits, tflat, wflat, clamp)
        lse2, contrib2 = cl.ce_rows(logits, tflat, wflat, clamp)
        want_lse, want_c = cl.ce_rows_plain(logits, tflat, wflat, clamp)
        db = torch.ones((V,), device=device)
        dl = cl.ce_grad_rows(logits.clone(), tflat, wflat, lse, one, db,
                             clamp)
        db2 = torch.ones((V,), device=device)
        dl2 = cl.ce_grad_rows(logits.clone(), tflat, wflat, lse, one, db2,
                              clamp)
        want_dl, want_db = cl.ce_grad_rows_plain(
            logits, tflat, wflat, want_lse,
            torch.ones((), device=device), clamp)
        torch.cuda.synchronize()
        e = {"lse": (lse - want_lse).abs().max().item(),
             "w_nll": (contrib - want_c).abs().max().item(),
             "dl_rel": max_rel_err(dl, want_dl),
             "db_rel": max_rel_err(db - 1.0, want_db)}
        if clamp is None:   # accumulate off: db written, not added to
            db_off = torch.full((V,), 7.0, device=device)
            ce_grad_rows_raw(logits.clone(), tflat, wflat, lse, one, db_off,
                             0)
            torch.cuda.synchronize()
            e["db_off_rel"] = max_rel_err(db_off, want_db)
        for name, err in e.items():
            if not err <= 1e-4:
                fail(f"CE rows (clamp {clamp}): {name} error {err} > 1e-4")
        if not (torch.equal(lse, lse2) and torch.equal(contrib, contrib2)
                and torch.equal(dl, dl2) and torch.equal(db, db2)):
            fail(f"CE rows (clamp {clamp}): two runs on the same inputs "
                 "differ")
        errs[f"clamp_{clamp}"] = e
    log(f"CE rows: errors {errs}; bit-identical over two runs")

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
    passes = ce_pass_ms(device, logits, tflat, wflat, hid.reshape(n, H), w,
                        b)
    log(f"CE row passes, device ms: {passes}")

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
                 cold_ms=passes["fwd_cold_ms"],
                 after_addmm_ms=passes["fwd_after_addmm_ms"],
                 library_ms=lib_f,
                 library_note="F.cross_entropy(logits, y, reduction='none')"),
            dict(common, name="ce_grad_rows",
                 replaces="icee_tpu/ops/chunked_loss.py:103 (_ce_bwd)",
                 max_abs_err=max(e["dl_rel"] for e in errs.values()),
                 ms=ms_b, plain_ms=plain_b, bound_ms=bb, bound_by=bb_by,
                 cold_ms=passes["bwd_cold_ms"],
                 after_addmm_ms=passes["bwd_after_addmm_ms"],
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


# --- phases 10-11: attention training (K5) -----------------------------------

B_ATT, B_ATT_EMOTION = 128, 96   # bench.py's attention training batch


def att_train_decoder(kind: str, device, seed: int):
    """Seeded flagship-width attention decoder (the model's init) with
    non-zero biases, and its config."""
    import numpy as np
    import torch

    from icee_tpu_torch import bridge
    from icee_tpu_torch.core.config import AttentionDecoderConfig
    from icee_tpu_torch.models import attention as att_mod

    cfg = AttentionDecoderConfig(vocab_size=V, embed_size=E, hidden_size=H,
                                 factored_size=F, feature_size=FS,
                                 attention_size=A, dropout=0.5)
    init = (att_mod.init_factored_att_params if kind == "factored"
            else att_mod.init_rnn_att_params)
    dec = bridge.to_numpy(init(torch.Generator().manual_seed(seed), cfg))
    rng = np.random.default_rng(seed)

    def noisy(tree):
        for k, v in tree.items():
            if isinstance(v, dict):
                noisy(v)
            elif k.endswith("_b") or k in ("b_ih", "b_hh"):
                tree[k] = (v + 0.1 * rng.standard_normal(v.shape)).astype(
                    np.float32)
    noisy(dec)
    return bridge.to_torch(dec, device=device), cfg


def att_train_features(device, b: int, seed: int):
    """Spatial features N(0, 1) x 0.1 drawn with numpy (bench.py:221-222)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    return torch.tensor((0.1 * rng.standard_normal((b, P, FS))).astype(
        np.float32), device=device)


def k5_inputs(kind: str, device, sampled: bool, seed: int):
    """K5's inputs at B_ATT x T_STEPS through the model's own repacking
    (style 2), captions of training_batch's language; -> (args, samp, (dh,
    dalpha) cotangents, dec)."""
    import numpy as np
    import torch

    from icee_tpu_torch.models import attention as att_mod

    dec, cfg = att_train_decoder(kind, device, seed)
    fam = att_mod._Family(dec, cfg, 2, kind == "factored")
    feats = att_train_features(device, B_ATT, seed + 1)
    _, caps, _, _ = training_batch(device, B_ATT, seed + 2)
    att = att_mod.select_attention(dec, 2)
    cell, katt = fam.kernel_params(att)
    with torch.no_grad():
        att1 = feats @ att["enc_w"] + att["enc_b"]
        h0, c0 = att_mod.init_hidden_state(dec, feats)
    args = (cell, katt, fam.embed(caps), att1, feats, h0, c0, kind)
    rng = np.random.default_rng(seed + 3)
    samp = None
    if sampled:
        coins = (rng.random(T_STEPS) < 0.8).astype(np.float32)
        coins[0] = 0.0      # the t = 0 bootstrap from emb_raw
        samp = {"head": {"C_w": fam.head_w, "C_b": fam.head_b,
                         "B": fam.table},
                "emb_raw": fam.embed(caps[:, :1]),
                "coins": torch.tensor(coins, device=device)}
    cot = tuple(torch.tensor((0.02 * rng.standard_normal(s)).astype(
        np.float32), device=device)
        for s in ((B_ATT, T_STEPS, H), (B_ATT, T_STEPS, P)))
    return args, samp, cot


def k5_flops_bytes(kind: str, sampled: bool):
    """(forward FLOPs, forward bytes, backward FLOPs, backward bytes) of K5
    at B_ATT x T_STEPS: every product and pass once per step; bytes count
    each input read once and each output written once."""
    b, t = B_ATT, T_STEPS
    ncat, ex = A + FS + 4 * H, E + FS
    g4 = 4 * (F if kind == "factored" else H)
    cell_extra = 4 * F * F + 4 * F * H if kind == "factored" else 0
    attend = P * A + P * FS
    fwd = 2 * b * t * (H * ncat + attend + ex * g4 + cell_extra)
    bwd = (2 * b * t * (g4 * ex + cell_extra + attend + ncat * H)
           + 4 * b * t * P * A
           + 2 * b * t * (H * ncat + ex * g4 + cell_extra))
    weights = H * ncat + ex * g4 + cell_extra + A + 1 + g4 + 4 * H
    if sampled:
        fwd += 2 * b * t * H * V
        weights += H * V + V + V * E
    big = b * P * (A + FS)
    seq_out = b * t * (2 * H + P)
    f_bytes = 4 * (big + weights + b * t * E + 2 * b * H + seq_out)
    b_bytes = 4 * (big + 2 * weights + 2 * b * t * E + 2 * b * H
                   + 2 * seq_out + b * P * A + 2 * b * H)
    return fwd, f_bytes, bwd, b_bytes


def k5_products():
    """(name, form, M, N, K, batch) of every product K5 launches at B_ATT x
    T_STEPS, forward, backward and weight grads (the lstm cell's x W_ih,
    dx and W_ih grad have the factored cell's shapes at F = H)."""
    ncat, ex, rows = A + FS + 4 * H, E + FS, B_ATT * T_STEPS
    return [("h_dec_fb_W", "N", B_ATT, ncat, H, 1),
            ("x_Win", "N", B_ATT, 4 * F, ex, 1),
            ("S", "N", B_ATT, F, F, 4),
            ("U", "N", B_ATT, H, F, 4),
            ("head", "N", B_ATT, V, H, 1),
            ("ds", "T", B_ATT, F, H, 4),
            ("dv", "T", B_ATT, F, F, 4),
            ("dx", "T", B_ATT, ex, 4 * F, 1),
            ("dh", "T", B_ATT, H, ncat, 1),
            ("g_Wcat", "A", H, ncat, rows, 1),
            ("g_Win", "A", ex, 4 * F, rows, 1),
            ("g_Sw", "A", F, F, rows, 4),
            ("g_Uw", "A", F, H, rows, 4)]


def k5_product_flops(kind: str, sampled: bool):
    """(forward, backward) FLOPs of K5's products alone at B_ATT x
    T_STEPS (the backward's reverse loop and its weight grads)."""
    b, t = B_ATT, T_STEPS
    ncat, ex = A + FS + 4 * H, E + FS
    g4 = 4 * (F if kind == "factored" else H)
    cell_extra = 4 * F * F + 4 * F * H if kind == "factored" else 0
    step = H * ncat + ex * g4 + cell_extra
    fwd = 2 * b * t * (step + (H * V if sampled else 0))
    return fwd, 2 * 2 * b * t * step


def kernel_ms(fn, iters: int) -> float:
    """Device time (ms) of one run of ``fn``: the kernels' own time in a
    profiler trace of ``iters`` runs, over ``iters`` (no host gaps); by
    CUDA events (host gaps included) where the trace holds no device
    time (the profiler sometimes records none)."""
    rows = device_time_by_kernel(lambda: [fn() for _ in range(iters)],
                                 top=None)
    total = sum(r["ms"] for r in rows)
    if total > 0:
        return total / iters
    log("kernel_ms: the profiler trace holds no device time; CUDA events")
    return cuda_ms(fn, iters)


def check_tf32x3(device):
    """Phase 10 (i): K5's product (``att_scan.tf32x3_product``, the
    kernels of ``csrc/gemm_tf32x3.cuh``) at every shape K5 launches
    (``k5_products``), batched operands interleaved along the rows as K5
    keeps them, against float64: its max abs error at most 4x that of
    ``gemm_f32.cuh``'s product (``f32_product``) on the same inputs, the
    same bits twice; both products' device times and achieved TFLOP/s
    (float32 operations, 2 M N K a product).  -> {name: stats}"""
    import numpy as np
    import torch

    from icee_tpu_torch.ops import att_scan

    out = {}
    for i, (name, form, m, n, k, batch) in enumerate(k5_products()):
        rng = np.random.default_rng(80 + i)
        a_rows, a_cols = (k, m) if form == "A" else (m, k)
        b_rows, b_cols = (n, k) if form == "T" else (k, n)
        a = torch.tensor(rng.uniform(-1, 1, (a_rows, batch * a_cols)).astype(
            np.float32), device=device)
        b = torch.tensor((0.05 * rng.standard_normal(
            (batch, b_rows, b_cols))).astype(np.float32), device=device)
        if batch == 1:
            b = b[0]
        else:
            a = a.view(a_rows, batch, a_cols).transpose(0, 1)
        got = att_scan.tf32x3_product(a, b, form)
        again = att_scan.tf32x3_product(a, b, form)
        f32 = att_scan.f32_product(a, b, form)
        ref = (att_scan._as_mk(a, form).double()
               @ att_scan._as_kn(b, form).double())
        torch.cuda.synchronize()
        err = (got.double() - ref).abs().max().item()
        err_f32 = (f32.double() - ref).abs().max().item()
        if not err <= 4.0 * err_f32:
            fail(f"tf32x3 product {name}: max abs error {err} > 4 x "
                 f"gemm_f32's {err_f32}")
        if not torch.equal(got, again):
            fail(f"tf32x3 product {name}: two runs on the same inputs "
                 "differ")
        del got, again, f32, ref
        ms = kernel_ms(lambda: att_scan.tf32x3_product(a, b, form), 20)
        ms_f32 = kernel_ms(lambda: att_scan.f32_product(a, b, form), 5)
        flops = 2.0 * m * n * k * batch
        out[name] = {"form": form, "M": m, "N": n, "K": k, "batch": batch,
                     "max_abs_err": err, "f32_max_abs_err": err_f32,
                     "err_over_f32": err / err_f32, "device_ms": ms,
                     "f32_device_ms": ms_f32,
                     "tflops": flops / ms / 1e9,
                     "f32_tflops": flops / ms_f32 / 1e9}
    return out


K5_ATTENTION_KERNELS = ("att_fwd_kernel", "att_bwd_kernel", "datt1_kernel")


def k5_device_groups(direction: str, fn):
    """Device time (ms) of one K5 call by kernel, from a profiler trace,
    split into the products (``tf32x3``), the attention passes and the
    rest; fails if the call ran a ``gemm_f32.cuh`` product."""
    rows = device_time_by_kernel(fn, top=None)
    if any("gemm_kernel" in r["kernel"] for r in rows):
        fail(f"K5 {direction} launched a gemm_f32.cuh product: "
             f"{[r['kernel'] for r in rows]}")
    groups = {"products_ms": 0.0, "attention_ms": 0.0, "rest_ms": 0.0}
    for r in rows:
        key = ("products_ms" if "tf32x3" in r["kernel"] else "attention_ms"
               if any(k in r["kernel"] for k in K5_ATTENTION_KERNELS)
               else "rest_ms")
        groups[key] += r["ms"]
    groups["total_ms"] = sum(r["ms"] for r in rows)
    groups["by_kernel"] = rows[:8]
    return groups


def k5_library_scan(args, samp, grad: bool = False):
    """The scan as a per-step chain of cuBLAS and torch calls (the library
    yardstick): addmm for att2 and the gate, a broadcast relu-score,
    softmax, bmm for the context, the cell's addmm / baddbmm products, and
    for the sampled scan addmm + argmax + the embedding gather.  -> (h_seq,
    alphas, the leaves) with autograd when ``grad``."""
    import torch

    cell, att, emb, att1, feats, h0, c0, kind = args
    leaves = []
    if grad:
        cell = {k: v.detach().requires_grad_(True) for k, v in cell.items()}
        att = {k: v.detach().requires_grad_(True) for k, v in att.items()}
        leaves = list(cell.values()) + list(att.values())
    with torch.set_grad_enabled(grad):
        h, c = h0, c0
        b = h.shape[0]
        prev = None if samp is None else samp["emb_raw"][:, 0]
        coins = None if samp is None else samp["coins"].tolist()
        w_in = torch.cat([cell["V_we"], cell["V_wc"]] if kind == "factored"
                         else [cell["W_ihe"], cell["W_ihc"]])
        hs, alphas = [], []
        for t in range(emb.shape[1]):
            att2 = torch.addmm(att["dec_b"], h, att["dec_w"])
            e = torch.relu(att1 + att2[:, None]) @ att["full_w"]
            alpha = torch.softmax(e[..., 0] + att["full_b"], dim=-1)
            ctx = torch.bmm(alpha[:, None], feats)[:, 0]
            gate = torch.sigmoid(torch.addmm(att["fb_b"], h, att["fb_w"]))
            x_e = emb[:, t] if coins is None or coins[t] else prev
            x = torch.cat([x_e, gate * ctx], dim=-1)
            if kind == "factored":
                v = torch.addmm(cell["V_b"].reshape(-1), x, w_in)
                v = v.reshape(b, 4, F).transpose(0, 1)
                s = torch.baddbmm(cell["S_b"][:, None], v, cell["S_w"])
                u = torch.baddbmm(cell["U_b"][:, None], s, cell["U_w"])
                z = u.transpose(0, 1) + torch.addmm(
                    cell["W_b"].reshape(-1), h, cell["W_w"]).reshape(b, 4, H)
                i_t, f_t, o_t = (torch.sigmoid(z[:, q]) for q in range(3))
                c = f_t * c + i_t * torch.tanh(z[:, 3])
                h = o_t * c
            else:
                z = (torch.addmm(cell["b_ih"], x, w_in)
                     + torch.addmm(cell["b_hh"], h, cell["W_hh"])
                     ).reshape(b, 4, H)
                i_t, f_t, o_t = (torch.sigmoid(z[:, q]) for q in (0, 1, 3))
                c = f_t * c + i_t * torch.tanh(z[:, 2])
                h = o_t * torch.tanh(c)
            if samp is not None:
                logits = torch.addmm(samp["head"]["C_b"], h.detach(),
                                     samp["head"]["C_w"])
                prev = samp["head"]["B"][torch.argmax(logits, dim=-1)]
            hs.append(h)
            alphas.append(alpha)
        return torch.stack(hs, 1), torch.stack(alphas, 1), leaves


def k5_trace_check(kind, args, samp, pidx, plain_h):
    """Margin-aware check of the kernel's argmax trace against the plain
    scan's: rows are independent, so at each row's first differing step
    the plain logits of the two tokens must lie within 1e-4 (a near tie
    that float32 sums in another order can flip).  -> number of rows that
    flipped."""
    import torch

    plain_pidx = plain_h[3]
    diff = pidx.long() != plain_pidx
    flips = 0
    for row in torch.nonzero(diff.any(0)).flatten().tolist():
        t = int(torch.nonzero(diff[:, row])[0])
        logits = (plain_h[0][row, t] @ samp["head"]["C_w"]
                  + samp["head"]["C_b"])
        gap = (logits[int(pidx[t, row])]
               - logits[int(plain_pidx[t, row])]).abs().item()
        if not gap <= 1e-4:
            fail(f"K5 sampled {kind}: row {row} step {t}: kernel token "
                 f"{int(pidx[t, row])} vs plain {int(plain_pidx[t, row])}, "
                 f"logit gap {gap} > 1e-4")
        flips += 1
    return flips


def check_k5(kind: str, sampled: bool, device):
    """Phase 10: K5 forward and backward vs the plain versions at B_ATT x
    T_STEPS, full width.  Forward: h and c atol 1e-4 (float32 sums over up
    to FS + E = 2348 terms in other orders, values O(1)), alpha atol 1e-5;
    the sampled trace margin-aware (k5_trace_check), then the plain scan
    rerun on the kernel's trace.  Backward (the plain backward from the
    kernel forward's outputs): each grad's max abs error <= 1e-3 x its
    largest magnitude, and the same bits on a second run.  -> (forward,
    backward) entries of the kernels line."""
    import torch

    from icee_tpu_torch.ops import att_scan

    args, samp, (dh, da) = k5_inputs(kind, device, sampled,
                                     50 + 2 * sampled + (kind == "lstm"))
    with torch.no_grad():
        h, a, res = att_scan.att_scan_fwd(*args, samp)
        flips = 0
        if sampled:
            plain_args = (*args[:2], samp["head"], args[2], samp["emb_raw"],
                          *args[3:7], samp["coins"], kind)
            free = att_scan.fused_att_scan_sampled_plain(*plain_args)
            flips = k5_trace_check(kind, args, samp, res["pidx"], free)
            want = att_scan.fused_att_scan_sampled_plain(
                *plain_args, forced_pidx=res["pidx"])
        else:
            want = att_scan.fused_att_scan_plain(*args)
        g = att_scan.att_scan_bwd(*args[:7], h, a, res, dh, da, kind, samp)
        g2 = att_scan.att_scan_bwd(*args[:7], h, a, res, dh, da, kind, samp)
        # the plain backward on the forward's att2: relu'(att1 + att2)
        # jumps at 0, and an att2 recomputed in another summation order
        # flips the mask of the positions within rounding of 0 (reported
        # below as the recomputed comparison, not held to the tolerance)
        att2 = res["buf"]["hp"][:, :, :A].transpose(0, 1)
        ref = att_scan.att_scan_grads_plain(*args[:7], h, a, res, dh, da,
                                            kind, samp, att2)
        ref_recomputed = att_scan.att_scan_grads_plain(
            *args[:7], h, a, res, dh, da, kind, samp)
    torch.cuda.synchronize()
    errs = {"h": (h - want[0]).abs().max().item(),
            "c": (res["c_seq"] - want[2]).abs().max().item()}
    alpha_err = (a - want[1]).abs().max().item()
    mode = "sampled" if sampled else "teacher"
    for name, err in errs.items():
        if not err <= 1e-4:
            fail(f"K5 {mode} {kind} forward: {name} error {err} > 1e-4")
    if not alpha_err <= 1e-5:
        fail(f"K5 {mode} {kind} forward: alpha error {alpha_err} > 1e-5")
    from icee_tpu_torch.train.optim import tree_leaves

    def named(tree, prefix=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from named(v, prefix + k + ".")
            else:
                yield prefix + k, v

    rel, abs_err = {}, 0.0
    ref_named = dict(named(ref))
    recomputed = dict(named(ref_recomputed))
    recomputed_rel = {}
    for name, got in named(g):
        want_g = ref_named[name]
        recomputed_rel[name] = max_rel_err(got, recomputed[name])
        abs_err = max(abs_err, (got - want_g).abs().max().item())
        if name == "att.full_b":
            # sum over all rows of sum_p d_e, 0 in exact arithmetic: both
            # sides hold rounding noise, held to 1e-5 in absolute terms
            full_b = (got.abs().item(), want_g.abs().item())
            if not max(full_b) <= 1e-5:
                fail(f"K5 {mode} {kind} backward: full_b grads {full_b}, "
                     "not within 1e-5 of 0")
            continue
        rel[name] = max_rel_err(got, want_g)
        if not rel[name] <= 1e-3:
            fail(f"K5 {mode} {kind} backward: d{name} error {rel[name]} x "
                 "max|g| > 1e-3")
    if not all(torch.equal(x, y) for x, y in zip(tree_leaves(g),
                                                  tree_leaves(g2))):
        fail(f"K5 {mode} {kind} backward: two runs on the same inputs "
             "differ")
    log(f"K5 {mode} {kind}: h/c max abs err {errs}, alpha {alpha_err:.3g}"
        f"{f', trace flips {flips}' if sampled else ''}; grads max err / "
        f"max|g| {max(rel.values()):.3g} (worst "
        f"{max(rel, key=rel.get)}), full_b {full_b}; against a plain "
        f"backward that recomputes att2 "
        f"{max(recomputed_rel.values()):.3g} (worst "
        f"{max(recomputed_rel, key=recomputed_rel.get)}); backward "
        "bit-identical over two runs")

    # times: kernel, plain version, library chain; forward then backward
    ms_f = cuda_ms(lambda: att_scan.att_scan_fwd(*args, samp), 5)
    with torch.no_grad():
        if sampled:
            plain_f = cuda_ms(lambda: att_scan.fused_att_scan_sampled_plain(
                *plain_args), 2)
        else:
            plain_f = cuda_ms(lambda: att_scan.fused_att_scan_plain(*args),
                              2)
        lib_f = cuda_ms(lambda: k5_library_scan(args, samp), 3)
        ms_b = cuda_ms(lambda: att_scan.att_scan_bwd(
            *args[:7], h, a, res, dh, da, kind, samp), 5)
        plain_b = cuda_ms(lambda: att_scan.att_scan_grads_plain(
            *args[:7], h, a, res, dh, da, kind, samp), 2)
    lh, la, leaves = k5_library_scan(args, samp, grad=True)
    lib_b = cuda_ms(lambda: torch.autograd.grad(
        (lh, la), leaves, (dh, da), retain_graph=True), 3)
    del lh, la, leaves
    with torch.no_grad():
        groups_f = k5_device_groups(
            f"{mode} {kind} forward",
            lambda: att_scan.att_scan_fwd(*args, samp))
        groups_b = k5_device_groups(
            f"{mode} {kind} backward", lambda: att_scan.att_scan_bwd(
                *args[:7], h, a, res, dh, da, kind, samp))
    flops_f, bytes_f, flops_b, bytes_b = k5_flops_bytes(kind, sampled)
    bf, bf_by = bound_ms(flops_f, bytes_f)
    bb, bb_by = bound_ms(flops_b, bytes_b)
    # the two floors the design faces: att1 and the features re-streamed
    # every step and direction, and the products at the 3xTF32 rate
    stream_floor = 4 * T_STEPS * B_ATT * P * (A + FS) / HBM_BYTES_PER_S * 1e3
    prod_f, prod_b = k5_product_flops(kind, sampled)
    name = "fused_att_scan" + ("_sampled" if sampled else "") + (
        "_lstm" if kind == "lstm" else "")
    line = ":887" if sampled else ":540"
    common = {"route": "cuda", "source": "icee_tpu_torch/csrc/att_scan.cu",
              "kind": kind, "mode": mode, "B": B_ATT, "T": T_STEPS,
              "library_note": "per-step chain: addmm, relu-score, softmax, "
                              "bmm, the cell's addmm/baddbmm"
                              + (", head addmm + argmax" if sampled else "")
                              + "; backward through autograd"}
    return (dict(common, name=name + "_fwd",
                 replaces=f"icee_tpu/ops/pallas_att_train.py:623 ({line}, "
                          f"kind=\"{kind}\")",
                 max_abs_err=max(max(errs.values()), alpha_err),
                 trace_flips=flips, ms=ms_f, plain_ms=plain_f,
                 library_ms=lib_f, bound_ms=bf, bound_by=bf_by,
                 stream_floor_ms=stream_floor,
                 tf32x3_floor_ms=prod_f / TF32X3_FLOP_PER_S * 1e3,
                 device_ms_by_group=groups_f),
            dict(common, name=name + "_bwd",
                 replaces=f"icee_tpu/ops/pallas_att_train.py:758 ({line}, "
                          f"kind=\"{kind}\")",
                 max_abs_err=abs_err, max_rel_err=max(rel.values()),
                 recomputed_att2_max_rel_err=max(recomputed_rel.values()),
                 ms=ms_b, plain_ms=plain_b, library_ms=lib_b, bound_ms=bb,
                 bound_by=bb_by, stream_floor_ms=stream_floor,
                 tf32x3_floor_ms=prod_b / TF32X3_FLOP_PER_S * 1e3,
                 device_ms_by_group=groups_b))


def att_train_batch(device, b: int, seed: int):
    """training_batch's captions (T_STEPS + 1 tokens: the model consumes
    [:, :-1] and predicts [:, 1:]) with spatial features."""
    import torch

    _, caps, lengths, mask = training_batch(device, b, seed)
    start = torch.full((b, 1), 1, dtype=caps.dtype, device=device)
    return (att_train_features(device, b, seed), torch.cat([start, caps], 1),
            lengths + 1, mask)


def k5_counters():
    from icee_tpu_torch.ops import att_scan

    out = {}
    for kind in ("factored", "lstm"):
        for sampled in (False, True):
            attr = att_scan.counter_name(kind, sampled)
            tag = "_sampled" if sampled else ""
            lstm = "_lstm" if kind == "lstm" else ""
            out[f"fused_att_scan{tag}{lstm}_fwd"] = (att_scan.att_scan_fwd,
                                                      attr)
            out[f"fused_att_scan{tag}{lstm}_bwd"] = (att_scan.att_scan_bwd,
                                                      attr)
    return out


def train_att_phase(device, factored: bool = True):
    """Phase 11: the StyleNet+Att (``factored``) or NIC+Att train step at
    flagship width, B_ATT x T_STEPS."""
    import math

    import torch

    from icee_tpu_torch.core.config import TrainConfig
    from icee_tpu_torch.ops import chunked_loss as cl
    from icee_tpu_torch.train import optim
    from icee_tpu_torch.train.steps import make_attention_steps

    kind = "factored" if factored else "lstm"
    model = "stylenet_att" if factored else "nic_att"
    counters = {k: v for k, v in k5_counters().items()
                if (k.endswith("_lstm_fwd") or k.endswith("_lstm_bwd"))
                == (not factored)}
    counters.update(ce_rows=(cl.ce_rows, "launches"),
                    ce_grad_rows=(cl.ce_grad_rows, "launches"))

    def reset():
        for fn, attr in counters.values():
            setattr(fn, attr, 0)

    def read():
        return {k: getattr(fn, attr) for k, (fn, attr) in counters.items()}

    _, cfg = att_train_decoder(kind, "cpu", 0)

    def build(**kw):
        tcfg = TrainConfig(teacher_forcing_ratio=kw.pop("ratio", 0.8), **kw)
        return make_attention_steps(cfg, tcfg,
                                    optim.make_adam(tcfg.lr_caption, tcfg),
                                    optim.make_adam(tcfg.lr_language, tcfg),
                                    factored=factored, device=device)

    kernel, plain = build(), build(fused_scan=False, chunked_ce=False)
    teacher = build(ratio=1.0)
    plain_teacher = build(ratio=1.0, fused_scan=False, chunked_ce=False)
    if not (kernel.use_fused and kernel.use_chunked):
        fail("the CUDA attention steps did not select the kernel path")
    fac_batches = [att_train_batch(device, B_ATT, 60 + i) for i in range(4)]
    emo_batches = [att_train_batch(device, B_ATT_EMOTION, 70 + i)
                   for i in range(4)]

    # (i) one factual step at ratio 1.0, kernel path vs plain path, same
    # weights and draws.  Tolerances as phase 9: loss atol 1e-4, each grad
    # 1e-3 x its largest magnitude + 1e-7.  (Ratio 0.8's argmax trace can
    # flip at a near tie between the two paths; phase 10 holds the sampled
    # kernel margin-aware.)
    dec, _ = att_train_decoder(kind, device, 12)
    out = {}
    for name, steps in (("kernel", teacher), ("plain", plain_teacher)):
        gen = torch.Generator(device=device).manual_seed(40)
        loss, grads = steps.factual_grads(dec, *fac_batches[0],
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
        fail(f"{model} first step: kernel vs plain loss err {loss_err}, "
             f"grad errs {grad_errs}")
    log(f"phase 11 (i), {model}: first factual step at ratio 1.0, kernel vs "
        f"plain: loss {out['kernel'][0].item():.6f} vs "
        f"{out['plain'][0].item():.6f}, grad err / max|g| worst "
        f"{max(grad_errs):.3g}")

    # (ii) 30 factual then 30 emotion steps at the reference's ratio 0.8:
    # the main training path, every K5 and CE count from 0 just before and
    # read just after
    dec, _ = att_train_decoder(kind, device, 12)
    gen = torch.Generator(device=device).manual_seed(41)
    fac_state = kernel.optimizer.init(dec)
    emo_state = kernel.lang_optimizer.init(dec)
    reset()
    fac_losses, emo_losses = [], []
    for i in range(30):
        *_, loss = kernel.factual_train_step(dec, fac_state,
                                             *fac_batches[i % 4],
                                             generator=gen)
        fac_losses.append(loss)
    for i in range(30):
        *_, loss = kernel.emotion_train_step(dec, emo_state,
                                             *emo_batches[i % 4], 1,
                                             generator=gen)
        emo_losses.append(loss)
    torch.cuda.synchronize()
    launches = read()
    fac_losses = [x.item() for x in fac_losses]
    emo_losses = [x.item() for x in emo_losses]
    drops = {}
    for track, ls in (("factual", fac_losses), ("emotion", emo_losses)):
        if not all(math.isfinite(x) for x in ls):
            fail(f"{model} {track} losses not finite: {ls}")
        first, last = sum(ls[:4]) / 4, sum(ls[-4:]) / 4
        drops[track] = last / first
        if not last <= LOSS_FALL * first:
            fail(f"{model} {track} loss did not fall: first cycle {first}, "
                 f"last {last} > {LOSS_FALL} x first")
    log(f"phase 11 (ii), {model}: ratio 0.8 losses factual "
        f"{fac_losses[0]:.4f} -> {fac_losses[-1]:.4f}, emotion "
        f"{emo_losses[0]:.4f} -> {emo_losses[-1]:.4f}; last/first cycle "
        f"{drops}; launches {launches}")

    # (iii) ratio 1.0: the teacher-forced K5 kernels
    t_state = teacher.optimizer.init(dec)
    before = read()
    t_losses = []
    for i in range(3):
        *_, loss = teacher.factual_train_step(dec, t_state,
                                              *fac_batches[i],
                                              generator=gen)
        t_losses.append(loss.item())
    after = read()
    t_launches = {k: after[k] - before[k] for k in after}
    for k, n in t_launches.items():
        launches[k] += n
    if not all(math.isfinite(x) for x in t_losses):
        fail(f"{model} ratio 1.0 losses {t_losses}")
    for name, count in launches.items():
        if count <= 0:
            fail(f"{name} was not launched on the {model} training path")

    # (iv) validation: free-running
    v_loss, v_top5, _ = kernel.val_step(dec, *fac_batches[0], 1)
    v_loss, v_top5 = v_loss.item(), v_top5.item()
    if not (math.isfinite(v_loss) and 0.0 <= v_top5 <= 100.0):
        fail(f"{model} val_step: loss {v_loss}, top5 {v_top5}")
    log(f"phase 11 (iii)-(iv), {model}: ratio 1.0 losses {t_losses}, "
        f"launches {t_launches}; val loss {v_loss:.4f}, top-5 "
        f"{v_top5:.2f}%")

    # step times: the whole factual step at ratio 0.8, Adam included
    def kernel_step():
        kernel.factual_train_step(dec, fac_state, *fac_batches[1],
                                  generator=gen)

    def plain_step():
        plain.factual_train_step(dec, plain_state, *fac_batches[1],
                                 generator=gen)

    plain_state = plain.optimizer.init(dec)
    ms = step_ms(kernel_step, 10)
    plain_ms = step_ms(plain_step, 3)
    busy = device_busy_share(kernel_step)
    by_kernel = device_time_by_kernel(kernel_step)
    return launches, {
        "config": {"B": B_ATT, "B_emotion": B_ATT_EMOTION, "T": T_STEPS,
                   "V": V, "E": E, "H": H, "F": F, "A": A, "P": P, "FS": FS,
                   "dropout": 0.5, "teacher_forcing_ratio": 0.8,
                   "lr": [2e-4, 5e-4], "alpha_c": 1.0},
        "factual_step_ms": ms, "captions_per_s": B_ATT / ms * 1e3,
        "plain_factual_step_ms": plain_ms,
        "plain_captions_per_s": B_ATT / plain_ms * 1e3,
        "device_busy_share": busy, "device_ms_by_kernel": by_kernel,
        "launches_ratio_1.0_3_steps": t_launches,
        "first_step_kernel_vs_plain": {"loss_err": loss_err,
                                       "grad_rel_errs_max": max(grad_errs)},
        "factual_losses": fac_losses, "emotion_losses": emo_losses,
        "last_over_first_cycle": drops, "ratio_1.0_losses": t_losses,
        "val": {"loss": v_loss, "top5": v_top5}}


# --- phases 12-14: the SentiCap base mRNN (K8, K9) ---------------------------

# the reference COCO base regime (bench.py:522-536, 625-642): emb/hidden
# 512, visual 4096, V 8800, batch 128, T = MAX_SENTENCE_LEN + 2, RMSProp;
# the test path's beam 20, max_len 20, over 64 images
SC_B, SC_T, SC_E, SC_H, SC_V, SC_VIS = 128, 22, 512, 512, 8800, 4096
SC_IMAGES, SC_BEAM, SC_MAXLEN = 64, 20, 20
SC_WORDS = 400                # the training captions' active vocabulary
SC_DECODE_CALLS = 7           # timed decode_split calls in phase 14


def senticap_conf_full(**kw):
    from icee_tpu_torch.senticap.config import senticap_conf

    return senticap_conf(emb_size=SC_E, lstm_hidden_size=SC_H,
                         visual_size=SC_VIS, **kw)


def k8_flops_bytes():
    """(fwd flops, bwd flops, fwd bytes, bwd bytes) of K8 at SC_B x SC_T:
    [x; h] W for all rows; dW = [x; h_prev]^T dZ, dx = dZ W_x^T and the
    (T - 1) recurrent dh products."""
    n, h4 = SC_B * SC_T, 4 * SC_H
    w = (SC_E + SC_H) * h4
    fwd = 2 * n * (SC_E + SC_H) * h4
    bwd = (2 * n * (SC_E + SC_H) * h4 + 2 * n * h4 * SC_E
           + 2 * SC_B * (SC_T - 1) * h4 * SC_H)
    bytes_f = 4 * (w + n * SC_E + 2 * n * SC_H + n * h4)
    bytes_b = 4 * (2 * w + 2 * n * SC_E + 3 * n * SC_H + n * h4)
    return fwd, bwd, bytes_f, bytes_b


def check_k8(device):
    """Phase 12: K8 forward and backward vs their plain versions at B=128,
    T=22, E=H=512, at gclip 5.0 and 0.01 (where the clamp binds).
    Tolerances: h and c atol 1e-4 (float32, sums of E + H = 1024 terms in
    other orders); dx and dW max abs error <= 1e-3 x its largest magnitude
    (sums over B*T = 2816 rows and a 22-step reverse chain); the same bits
    twice.  -> (forward, backward) entries of the kernels line."""
    import torch

    from icee_tpu_torch.ops import senticap_scan as ss
    from icee_tpu_torch.senticap import model

    w = model.init_params(torch.Generator().manual_seed(70), SC_V,
                          senticap_conf_full(), device=device)["w_lstm"]
    g = torch.Generator(device=device).manual_seed(71)
    x = torch.randn((SC_B, SC_T, SC_E), generator=g, device=device)
    dh = torch.randn((SC_B, SC_T, SC_H), generator=g, device=device)
    h_seq, c_seq, gates = ss.senticap_scan_fwd(w, x)
    want_h, want_c = ss.fused_senticap_scan_plain(w, x)
    h2, c2, _ = ss.senticap_scan_fwd(w, x)
    torch.cuda.synchronize()
    fwd_err = max((h_seq - want_h).abs().max().item(),
                  (c_seq - want_c).abs().max().item())
    if not fwd_err <= 1e-4:
        fail(f"K8 forward: max abs error {fwd_err} > 1e-4")
    if not (torch.equal(h_seq, h2) and torch.equal(c_seq, c2)):
        fail("K8 forward: two runs on the same inputs differ")
    rel, abs_err, binds = {}, 0.0, {}
    for gclip in (5.0, 0.01):
        dx, dw = ss.senticap_scan_bwd(w, x, h_seq, c_seq, dh, gclip, gates)
        dx2, dw2 = ss.senticap_scan_bwd(w, x, h_seq, c_seq, dh, gclip, gates)
        want_dx, want_dw = ss.senticap_scan_bwd_plain(w, x, h_seq, c_seq, dh,
                                                      gclip)
        torch.cuda.synchronize()
        for name, got, want in (("dx", dx, want_dx), ("dW", dw, want_dw)):
            rel[f"{name}@{gclip}"] = max_rel_err(got, want)
            abs_err = max(abs_err, (got - want).abs().max().item())
        if not (torch.equal(dx, dx2) and torch.equal(dw, dw2)):
            fail(f"K8 backward (gclip {gclip}): two runs differ")
        binds[gclip] = dw
    for name, err in rel.items():
        if not err <= 1e-3:
            fail(f"K8 backward: {name} error {err} x max|g| > 1e-3")
    if torch.allclose(binds[5.0], binds[0.01]):
        fail("K8 backward: gclip 0.01 did not change dW (the clamp must "
             "bind there)")
    log(f"K8: h/c max abs err {fwd_err:.3g}; grads max err / max|g| "
        f"{ {k: float(f'{v:.3g}') for k, v in rel.items()} }; bit-identical "
        f"over two runs; the clamp binds at gclip 0.01")
    groups_f = scan_device_groups("K8 forward",
                                  lambda: ss.senticap_scan_fwd(w, x))
    groups_b = scan_device_groups("K8 backward", lambda: ss.senticap_scan_bwd(
        w, x, h_seq, c_seq, dh, 5.0, gates))
    products = check_scan_products(device, "K8")
    ms_f = cuda_ms(lambda: ss.senticap_scan_fwd(w, x), 10)
    plain_f = cuda_ms(lambda: ss.fused_senticap_scan_plain(w, x), 5)
    ms_b = cuda_ms(lambda: ss.senticap_scan_bwd(w, x, h_seq, c_seq, dh, 5.0,
                                                gates), 10)
    plain_b = cuda_ms(lambda: ss.senticap_scan_bwd_plain(
        w, x, h_seq, c_seq, dh, 5.0), 5)
    flops_f, flops_b, bytes_f, bytes_b = k8_flops_bytes()
    bf, bf_by = bound_ms(flops_f, bytes_f)
    bb, bb_by = bound_ms(flops_b, bytes_b)
    common = {"route": "cuda", "source": "icee_tpu_torch/csrc/senticap_scan.cu",
              "library_ms": None,
              "library_note": "no single PyTorch call computes this cell "
                              "(h = o*c, no bias, the clamp on dh)"}
    return (dict(common, name="fused_senticap_scan_fwd",
                 replaces="icee_tpu/ops/pallas_senticap_train.py:173",
                 max_abs_err=fwd_err, ms=ms_f, plain_ms=plain_f,
                 bound_ms=bf, bound_by=bf_by,
                 bound_tf32x3_ms=flops_f / TF32X3_FLOP_PER_S * 1e3,
                 device_ms_by_group=groups_f, products=products["fwd"]),
            dict(common, name="fused_senticap_scan_bwd",
                 replaces="icee_tpu/ops/pallas_senticap_train.py:224",
                 max_abs_err=abs_err, max_rel_err=max(rel.values()),
                 ms=ms_b, plain_ms=plain_b, bound_ms=bb, bound_by=bb_by,
                 bound_tf32x3_ms=flops_b / TF32X3_FLOP_PER_S * 1e3,
                 device_ms_by_group=groups_b, products=products["bwd"]))


def senticap_split(n: int, seed: int, senti: float = -1.0):
    """A seeded SentiCap split: captions of ids in [2, SC_V) from a Zipf law
    over SC_WORDS fixed words (a language the model can learn), lengths
    6..SC_T - 1 with STOP (0) after the last word, as ``io.make_split``
    lays them out ([START, w1..wn] in, [w1..wn, STOP] out); image features
    N(0, 1) (``bench.py:550-551``); every record of sentiment ``senti``.  A
    styled split (senti > 0) marks about one word in five as an ANP switch
    position (SC_SWITCH_SHARE) and puts a sentiment word there, one of
    SC_SENTI_WORDS ids outside the base words, as the reference's styled
    captions carry their sentiment words at the switch positions."""
    import numpy as np

    from icee_tpu_torch.senticap.io import SentiDataset

    rng = np.random.default_rng(seed)
    order = 2 + np.random.default_rng(98).permutation(SC_V - 2)
    words = order[:SC_WORDS]
    zipf = 1.0 / np.arange(1, SC_WORDS + 1)
    ids = words[rng.choice(SC_WORDS, (n, SC_T), p=zipf / zipf.sum())]
    lengths = rng.integers(6, SC_T, n)
    feats = rng.standard_normal((n, SC_VIS)).astype(np.float32)
    switch = np.zeros((n, SC_T), np.float32)
    if senti > 0:
        switch = ((rng.random((n, SC_T)) < SC_SWITCH_SHARE)
                  & (np.arange(SC_T)[None] < lengths[:, None])).astype(
            np.float32)
        senti_words = order[SC_WORDS:SC_WORDS + SC_SENTI_WORDS]
        ids = np.where(switch > 0, senti_words[rng.integers(
            0, SC_SENTI_WORDS, (n, SC_T))], ids)
    x = np.zeros((n, SC_T), np.int32)
    y = np.zeros((n, SC_T), np.int32)
    mask = np.zeros((n, SC_T), np.float32)
    for i, ln in enumerate(lengths):
        x[i, 1:ln + 1] = ids[i, :ln]
        y[i, :ln] = ids[i, :ln]
        mask[i, :ln + 1] = 1.0
    return SentiDataset(X=x, Y=y, Xlen=mask, V=feats, SW=switch,
                        senti=np.full(n, senti, np.float32),
                        ids=[f"img{i}" for i in range(n)])


def train_senticap_phase(device):
    """Phase 13: the SentiCap base model trains at the reference COCO
    regime (B=128, T=22, E=H=512, V=8800, visual 4096, RMSProp,
    teacher-forced, dropout 0.5)."""
    import math

    import torch

    from icee_tpu_torch.ops import chunked_loss as cl
    from icee_tpu_torch.ops import senticap_scan as ss
    from icee_tpu_torch.senticap import io as sio
    from icee_tpu_torch.senticap import model
    from icee_tpu_torch.senticap.solver import make_solver
    from icee_tpu_torch.senticap.train import (make_base_step,
                                               validation_perplexity)

    counters = {"fused_senticap_scan_fwd": ss.senticap_scan_fwd,
                "fused_senticap_scan_bwd": ss.senticap_scan_bwd,
                "ce_rows": cl.ce_rows, "ce_grad_rows": cl.ce_grad_rows}

    def reset():
        for fn in counters.values():
            fn.launches = 0

    def read():
        return {k: fn.launches for k, fn in counters.items()}

    conf = senticap_conf_full()
    plain_conf = senticap_conf_full(FUSED_SCAN=False, CHUNKED_CE=False)
    solver = make_solver(conf)
    kernel = make_base_step(conf, solver, device=device)
    plain = make_base_step(plain_conf, solver, device=device)
    if not (kernel.use_chunked and model.fused_scan_requested(
            conf, kernel.device)):
        fail("the CUDA SentiCap step did not select the kernel path")
    ds = senticap_split(4 * SC_B, 80)
    data = sio.device_dataset(ds, device)
    batches = [torch.arange(i * SC_B, (i + 1) * SC_B, device=device)
               for i in range(4)]

    def fresh():
        return model.init_params(torch.Generator().manual_seed(81), SC_V,
                                 conf, device=device)

    # (i) one step's loss and grads, kernel path vs plain path, with the
    # same dropout masks.  Tolerances: the loss (a SUM over ~1,700 tokens,
    # ~1.5e4) rtol 1e-5; each grad 1e-3 x its largest magnitude + 1e-7
    g = torch.Generator(device=device).manual_seed(82)
    masks = dict(x_drop=(torch.rand((SC_B, SC_T, SC_E), generator=g,
                                    device=device) < 0.5).float() * 2.0,
                 y_drop=(torch.rand((SC_B, SC_T, SC_H), generator=g,
                                    device=device) < 0.5).float() * 2.0)
    params = fresh()
    out = {name: steps.grads(params, data, batches[0], **masks)
           for name, steps in (("kernel", kernel), ("plain", plain))}
    torch.cuda.synchronize()
    k_loss, p_loss = out["kernel"][0].item(), out["plain"][0].item()
    loss_err = abs(k_loss - p_loss) / abs(p_loss)
    grad_errs = {k: max_rel_err(out["kernel"][1][k], out["plain"][1][k])
                 for k in params}
    if not (loss_err <= 1e-5 and all(
            (out["kernel"][1][k] - out["plain"][1][k]).abs().max().item()
            <= 1e-3 * out["plain"][1][k].abs().max().item() + 1e-7
            for k in params)):
        fail(f"SentiCap first step: kernel vs plain loss rel err "
             f"{loss_err}, grad errs {grad_errs}")
    log(f"phase 13 (i): first step, kernel vs plain: loss {k_loss:.4f} vs "
        f"{p_loss:.4f}; grad err / max|g| "
        f"{ {k: float(f'{v:.3g}') for k, v in grad_errs.items()} }")

    # (ii) 30 steps on the kernel path, every K8 and CE count from 0 just
    # before and read just after; the loss must fall
    params = fresh()
    opt_state = solver.init(params)
    gen = torch.Generator(device=device).manual_seed(83)
    reset()
    losses = []
    for i in range(30):
        params, opt_state, loss = kernel(params, opt_state, data,
                                         batches[i % 4], gen)
        losses.append(loss)
    torch.cuda.synchronize()
    launches = read()
    losses = [x.item() for x in losses]
    for name, count in launches.items():
        if count <= 0:
            fail(f"{name} was not launched on the SentiCap training path")
    if not all(math.isfinite(x) for x in losses):
        fail(f"SentiCap losses not finite: {losses}")
    drop = (sum(losses[-4:]) / 4) / (sum(losses[:4]) / 4)
    if not drop <= LOSS_FALL:
        fail(f"SentiCap loss did not fall: last/first cycle {drop} > "
             f"{LOSS_FALL}")
    log(f"phase 13 (ii): losses {losses[0]:.1f} -> {losses[-1]:.1f}, "
        f"last/first cycle {drop:.3f}; launches {launches}")

    # (iii) validation perplexity on the chunked path (K8 forward + CE rows)
    reset()
    ppl = validation_perplexity(params, conf, senticap_split(SC_B, 84),
                                device=device)
    val_launches = read()
    if not (math.isfinite(ppl) and ppl > 1.0
            and val_launches["fused_senticap_scan_fwd"] == 1
            and val_launches["ce_rows"] > 0):
        fail(f"validation_perplexity: {ppl}, launches {val_launches}")

    # step times: the whole step, RMSProp included
    def kernel_step():
        kernel(params, opt_state, data, batches[1], gen)

    def plain_step():
        plain(params, opt_state, data, batches[1], gen)

    ms = step_ms(kernel_step, 20)
    plain_ms = step_ms(plain_step, 10)
    busy = device_busy_share(kernel_step)
    by_kernel = device_time_by_kernel(kernel_step)
    log(f"phase 13 (iii): validation perplexity {ppl:.2f}; step {ms:.3f} ms "
        f"({SC_B / ms * 1e3:.1f} captions/s), plain {plain_ms:.3f} ms")
    return launches, {
        "config": {"B": SC_B, "T": SC_T, "V": SC_V, "E": SC_E, "H": SC_H,
                   "visual": SC_VIS, "solver": conf["GRAD_METHOD"],
                   "lr": conf["learning_rate"], "dropout": 0.5,
                   "semi_forced": conf["SEMI_FORCED"]},
        "step_ms": ms, "captions_per_s": SC_B / ms * 1e3,
        "plain_step_ms": plain_ms,
        "plain_captions_per_s": SC_B / plain_ms * 1e3,
        "device_busy_share": busy, "device_ms_by_kernel": by_kernel,
        "first_step_kernel_vs_plain": {"loss_rel_err": loss_err,
                                       "grad_rel_errs": grad_errs},
        "losses": losses, "last_over_first_cycle": drop,
        "val_perplexity": ppl, "val_launches": val_launches}


def senticap_decoder(device):
    """Seeded base-model weights at the decode regime, shaped so beams end
    at several lengths: Xavier init (``model.init_params``) with the head x
    60, w_lstm x 1.5, an N(0, 1) output bias and +2.5 on STOP (at the
    plain init every beam runs to max_len on near-uniform nll)."""
    import torch

    from icee_tpu_torch.senticap import model

    p = model.init_params(torch.Generator().manual_seed(60), SC_V,
                          senticap_conf_full())
    g = torch.Generator().manual_seed(61)
    p["w"] *= 60.0
    p["w_lstm"] *= 1.5
    p["b"] = torch.randn(SC_V, generator=g)
    p["b"][0] += 2.5
    return {k: v.to(device) for k, v in p.items()}


def senticap_rescore(params, v, tokens, length):
    """The plain model's length-normalized score of each image's token
    sequence (the visual pseudo-word at step 0, then the tokens): the score
    a search gives that sequence."""
    import torch

    from icee_tpu_torch.senticap import model

    tok = tokens.long()
    n = tok.shape[0]
    h = torch.zeros((n, SC_H), device=v.device)
    c = torch.zeros_like(h)
    x = model.visual_embedding(params, v)
    total = torch.zeros((n,), device=v.device)
    for t in range(int(length.max())):
        h, c = model.cell(params, x, h, c)
        nll = -torch.log2(model.output_probs(params, h) + 1e-37)
        total = torch.where(t < length, total + nll.gather(
            1, tok[:, t:t + 1])[:, 0], total)
        x = params["wemb"][tok[:, t]]
    return total / length.float()


# the launch groups of a K9 / K10 call (senticap_device_groups), by kernel
# name; a product is the cell's before the step's gates kernel and the
# head's after it
SB_PRODUCT_KERNELS = ("gemm_kernel", "sb_product_kernel")
SB_GROUP_KERNELS = (("gates_ms", "sb_gates_kernel"),
                    ("switch_gate_ms", "sw_gate_kernel"),
                    ("row_topk_ms", "sb_row_topk_kernel"),
                    ("select_ms", "sb_select_kernel"),
                    ("init_ms", "sb_init_kernel"),
                    ("prepare_ms", "sb_prepare_kernel"))


def senticap_device_groups(what: str, fn):
    """Device time (ms) of one K9 or K10 call ``fn`` by launch group,
    summed over the steps, from a profiler trace: the cell products, the
    head products, the gates, K10's switch gate, the row softmax and
    top-k, the selection and gather, the set-up; with the launches of each
    group and the count of ``gemm_f32.cuh`` products (``gemm_kernel``).
    None where the trace holds no device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = sorted((e for e in prof.events()
                     if e.device_type == DeviceType.CUDA
                     and not e.is_user_annotation
                     and e.self_device_time_total > 0),
                    key=lambda e: e.time_range.start)
    if not events:
        log(f"{what}: the profiler trace holds no device time")
        return None
    groups = {"cell_products_ms": 0.0, "head_products_ms": 0.0}
    groups.update({g: 0.0 for g, _ in SB_GROUP_KERNELS})
    groups["other_ms"] = 0.0
    counts = {g: 0 for g in groups}
    after_gates = False
    for e in events:
        ms = e.self_device_time_total / 1e3
        if any(k in e.name for k in SB_PRODUCT_KERNELS):
            key = "head_products_ms" if after_gates else "cell_products_ms"
        else:
            key = next((g for g, k in SB_GROUP_KERNELS if k in e.name),
                       "other_ms")
            after_gates = (after_gates or key == "gates_ms") \
                and key != "select_ms"
        groups[key] += ms
        counts[key] += 1
    groups["total_ms"] = sum(e.self_device_time_total for e in events) / 1e3
    groups["launches"] = {g: n for g, n in counts.items() if n}
    groups["gemm_f32_launches"] = sum("gemm_kernel" in e.name
                                      for e in events)
    return groups


def check_sb_products(device, paths: int):
    """Phases 14 and 17 (i): the products K9 (``paths`` 1) and K10 (2, one
    launch for both paths) run every step, alone at their shapes (the cell
    1280 x 1024 x 2048, the head 1280 x 512 x 8800 + bias), from planes
    that ``prepare_weights`` lays out on the card: against float64, the
    max abs error at most 4x that of ``gemm_f32.cuh``'s product
    (``att_scan.f32_product``) on the same inputs, the same bits twice,
    and the planes the same bits as their plain layout; whether the bits
    are ``gemm_tf32x3.cuh``'s (``att_scan.tf32x3_product``, mma.sync:
    the same sums in another unit); device ms and TFLOP/s (float32
    operations) of each and of ``torch.matmul`` (``gemm_tf32x3.cuh``'s
    time at these shapes: ``scripts/probe_sb_product.py``, from CUDA
    graph replays; this profiler reads it low).
    -> {shape: stats}"""
    import numpy as np
    import torch

    from icee_tpu_torch.ops import att_scan
    from icee_tpu_torch.ops import senticap_decode as sd

    rows = SC_IMAGES * SC_BEAM
    out = {}
    for i, (shape, k, n, bias) in enumerate((
            ("cell", SC_E + SC_H, 4 * SC_H, False),
            ("head", SC_H, SC_V, True))):
        rng = np.random.default_rng(90 + 10 * paths + i)
        a = torch.tensor(rng.uniform(-1, 1, (paths, rows, k)).astype(
            np.float32), device=device)
        w = torch.tensor((0.05 * rng.standard_normal((paths, k, n))).astype(
            np.float32), device=device)
        b = torch.tensor(rng.standard_normal((paths, n)).astype(np.float32),
                         device=device) if bias else None
        planes = torch.stack([sd.prepare_weights(w[z]) for z in range(paths)])
        if not torch.equal(planes[0].cpu(),
                           sd.prepare_weights_plain(w[0].cpu())):
            fail(f"K{8 + paths} {shape} planes differ from their plain "
                 "layout")
        if paths == 1:
            a, w, planes = a[0], w[0], planes[0]
            b = b[0] if bias else None
        splits = 1 if bias else sd.product_splits(rows, n, k, paths,
                                                   sd.sm_count(device))
        got = sd.planes_product(a, planes, n, b, splits=splits)
        again = sd.planes_product(a, planes, n, b, splits=splits)
        f32 = att_scan.f32_product(a, w, "N", b)
        tc = att_scan.tf32x3_product(a, w, "N", b)
        ref = a.double() @ w.double()
        if bias:
            ref = ref + (b.double()[:, None] if paths == 2 else b.double())
        torch.cuda.synchronize()
        err = (got.double() - ref).abs().max().item()
        err_f32 = (f32.double() - ref).abs().max().item()
        if not err <= 4.0 * err_f32:
            fail(f"K{8 + paths} {shape} product: max abs error {err} > 4 x "
                 f"gemm_f32's {err_f32}")
        if not torch.equal(got, again):
            fail(f"K{8 + paths} {shape} product: two runs differ")
        same_tc = torch.equal(got, tc)
        del got, again, f32, tc, ref
        ms = kernel_ms(lambda: sd.planes_product(a, planes, n, b,
                                                 splits=splits), 20)
        ms_f32 = kernel_ms(lambda: att_scan.f32_product(a, w, "N", b), 5)
        ms_lib = cuda_ms(lambda: torch.matmul(a, w), 20, warmup=3)
        flops = 2.0 * paths * rows * n * k
        out[shape] = {"M": rows, "N": n, "K": k, "paths": paths,
                      "splits": splits,
                      "max_abs_err": err, "f32_max_abs_err": err_f32,
                      "err_over_f32": err / err_f32,
                      "same_bits_as_gemm_tf32x3": same_tc,
                      "device_ms": ms, "tflops": flops / ms / 1e9,
                      "f32_device_ms": ms_f32,
                      "f32_tflops": flops / ms_f32 / 1e9,
                      "matmul_ms": ms_lib,
                      "matmul_tflops": flops / ms_lib / 1e9}
        del a, w, b, planes
    return out


def products_line(stats) -> str:
    return "; ".join(
        f"{n} {s['device_ms']:.4f} ms {s['tflops']:.1f} TFLOP/s (k ranges "
        f"{s['splits']}, error {s['err_over_f32']:.2f}x gemm_f32's, "
        f"gemm_tf32x3's bits {s['same_bits_as_gemm_tf32x3']}; gemm_f32 "
        f"{s['f32_device_ms']:.4f}, torch.matmul {s['matmul_ms']:.4f})"
        for n, s in stats.items())


def groups_line(groups) -> str:
    if groups is None:
        return "not measured (no device time in the trace)"
    return ", ".join(f"{g[:-3]} {v:.3f}" for g, v in groups.items()
                     if g.endswith("_ms") and v)


def senticap_profile(what: str, fn):
    """``senticap_device_groups`` of one call; fails if a ``gemm_f32.cuh``
    product ran in it."""
    groups = senticap_device_groups(what, fn)
    if groups is not None and groups["gemm_f32_launches"]:
        fail(f"{what} launched {groups['gemm_f32_launches']} gemm_f32.cuh "
             f"products: {groups['launches']}")
    return groups


def check_k9(device):
    """Phase 14: K9 vs the plain search at 64 images, beam 20, max_len 20,
    margin-aware as phase 5: each kernel score matches its own sequence's
    plain re-score within 1e-3 and the plain search's within 1e-3, and
    where tokens differ, the kernel's sequence ties the plain winner within
    1e-4.  -> the kernel's entry of the kernels line."""
    import torch

    from icee_tpu_torch.ops import senticap_decode as sd

    params = senticap_decoder(device)
    g = torch.Generator(device=device).manual_seed(62)
    v = torch.randn((SC_IMAGES, SC_VIS), generator=g, device=device)
    kw = dict(beam_size=SC_BEAM, max_len=SC_MAXLEN)
    got = sd.mega_senticap_beam_decode(params, v, SC_IMAGES, **kw)
    again = sd.mega_senticap_beam_decode(params, v, SC_IMAGES, **kw)
    want = sd.mega_senticap_beam_decode_plain(params, v, SC_IMAGES, **kw)
    rescored = senticap_rescore(params, v, got[1], got[2])
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        fail("K9: two runs on the same inputs differ")
    max_err, own_err, flips = 0.0, 0.0, 0
    for i in range(SC_IMAGES):
        gs, ws, rs = got[0][i].item(), want[0][i].item(), rescored[i].item()
        n = int(got[2][i])
        same = n == int(want[2][i]) and torch.equal(got[1][i, :n],
                                                    want[1][i, :n])
        own_err = max(own_err, abs(rs - gs))
        if not abs(rs - gs) <= 1e-3:
            fail(f"K9 image {i}: reported score {gs}, its sequence scores "
                 f"{rs}")
        if not same:
            margin = abs(rs - ws)
            if margin > 1e-4:
                fail(f"K9 image {i}: tokens differ; kernel's sequence "
                     f"scores {rs}, plain winner {ws}, margin {margin}")
            flips += 1
            log(f"K9 image {i}: near-tie flip, margin {margin}")
        max_err = max(max_err, abs(gs - ws))
    if not max_err <= 1e-3:
        fail(f"K9: score error {max_err} > 1e-3")
    lengths = got[2].tolist()
    if len(set(lengths)) < 2:
        fail(f"K9: every beam ended at one length {lengths[0]}")
    log(f"K9: {SC_IMAGES} images, lengths min {min(lengths)} max "
        f"{max(lengths)} mean {sum(lengths) / len(lengths):.2f} "
        f"({len(set(lengths))} distinct); score max abs err {max_err:.3g}, "
        f"vs own re-score {own_err:.3g}; {flips} near-tie flips; "
        f"bit-identical over two runs")
    ms = cuda_ms(lambda: sd.mega_senticap_beam_decode(params, v, SC_IMAGES,
                                                      **kw), 3)
    plain_ms = cuda_ms(lambda: sd.mega_senticap_beam_decode_plain(
        params, v, SC_IMAGES, **kw), 3)
    rows, steps = SC_IMAGES * SC_BEAM, SC_MAXLEN + 1
    flops = steps * rows * 2 * ((SC_E + SC_H) * 4 * SC_H + SC_H * SC_V)
    nbytes = 4 * (SC_V * SC_E + (SC_E + SC_H) * 4 * SC_H + SC_H * SC_V + SC_V
                  + SC_IMAGES * SC_E + steps * rows * SC_E
                  + SC_IMAGES * (steps + 2))
    b_ms, b_by = bound_ms(flops, nbytes)
    groups = senticap_profile("K9", lambda: sd.mega_senticap_beam_decode(
        params, v, SC_IMAGES, **kw))
    return {"name": "mega_senticap_beam_decode", "route": "cuda",
            "source": "icee_tpu_torch/csrc/senticap_beam.cu",
            "replaces": "icee_tpu/ops/pallas_senticap_decode.py:397",
            "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by,
            "bound_tf32x3_ms": flops / TF32X3_FLOP_PER_S * 1e3,
            "device_ms_by_group": groups, "library_ms": None,
            "library_note": "no single PyTorch call computes a beam search",
            "near_tie_flips": flips, "max_rescore_err": own_err,
            "lengths": lengths}


def decode_senticap_phase(device):
    """Phase 14, the path: ``decode_split(switched=False)`` on a 64-image
    split through K9, ``SC_DECODE_CALLS`` timed calls after a warm-up, K9's
    count from 0 just before the first and read just after the last (one
    launch a call), the same captions every call; captions/s from the
    median call."""
    import torch

    from icee_tpu_torch.ops import senticap_decode as sd
    from icee_tpu_torch.senticap.train import decode_split

    params = senticap_decoder(device)
    conf = senticap_conf_full()
    ds = senticap_split(SC_IMAGES, 85)
    i2w = {i: f"w{i}" for i in range(SC_V)}
    first = decode_split(params, conf, ds, i2w, switched=False,
                         torch_device=device)
    torch.cuda.synchronize()                                    # warm-up
    sd.mega_senticap_beam_decode.launches = 0
    walls = []
    for _ in range(SC_DECODE_CALLS):
        t0 = time.perf_counter()
        out = decode_split(params, conf, ds, i2w, switched=False,
                           torch_device=device)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        if out != first:
            fail("decode_split: captions differ between calls")
    launches = sd.mega_senticap_beam_decode.launches
    if launches != SC_DECODE_CALLS:
        fail(f"decode_split launched K9 {launches} times in "
             f"{SC_DECODE_CALLS} calls")
    if len(out) != SC_IMAGES or not all(
            len(o["caption"]) <= SC_MAXLEN for o in out):
        fail(f"decode_split: {len(out)} results")
    lengths = [len(o["caption"]) for o in out]
    wall = statistics.median(walls)
    log(f"phase 14: decode_split of {SC_IMAGES} images, median of "
        f"{SC_DECODE_CALLS} calls {wall * 1e3:.2f} ms (min "
        f"{min(walls) * 1e3:.2f}, max {max(walls) * 1e3:.2f}; "
        f"{SC_IMAGES / wall:.1f} captions/s), caption words min "
        f"{min(lengths)} max {max(lengths)}; K9 launches {launches}")
    return launches, {"images": SC_IMAGES, "beam": SC_BEAM,
                      "max_len": SC_MAXLEN, "calls": SC_DECODE_CALLS,
                      "wall_ms": wall * 1e3,
                      "wall_ms_min_max": [min(walls) * 1e3,
                                          max(walls) * 1e3],
                      "captions_per_s": SC_IMAGES / wall,
                      "caption_words": lengths}


# --- phases 15-17: the SentiCap switched model (the mixture CE, K10) -------

# the reference's switch-training regime (bench.py:574-616, the MTurk
# regime; train_joint.py:328-372): the widths of phases 12-14, DA_SUM,
# LAMBDA_N = LAMBDA_GAM = 0.25, dropout 0.5 on the sentiment path only,
# RMSProp over the switch set; the test path's styled decode at beam 20
SC_SWITCH_SHARE = 0.2         # tokens marked as ANP switch positions
SC_SENTI_WORDS = 40           # the sentiment words at those positions
# The reference's switch-training learning rate (config.py), at which phase
# 16 compares the first step and runs SC_NAN_STEPS steps; and the rate its
# loss-fall check trains at.  At 1e-3 the gate, which sums 2H = 1,024
# inputs, can saturate within a few steps: sigmoid rounds to 1.0 and the
# gate term (1 - sw) * -log(1 - att) is nan.  The JAX package's step does
# the same, at the same step as the port's (tests/test_torch_senticap_
# switched.py::test_switch_training_goes_nan_at_lr_1e3_in_both_packages).
SC_REF_LR = 1e-3
SC_SWITCH_LR = 1e-4
SC_NAN_STEPS = 12


def mixture_inputs(device, base, seed: int):
    """Phase 15's inputs at 128 x 22 rows: the two heads of the switched
    model of phase 16 (``switched_params`` over ``base``), head inputs
    N(0, 1) x 0.5, gates U(0.05, 0.95), Zipf targets, weights mask x (1 +
    LAMBDA_N (1 - sw)) as the switched loss forms them."""
    import torch

    params = switched_params(device, base)
    ds = senticap_split(SC_B, seed, senti=1.0)
    g = torch.Generator(device=device).manual_seed(seed)
    hh_o, hh_n = (0.5 * torch.randn((SC_B, SC_T, SC_H), generator=g,
                                    device=device) for _ in range(2))
    att = 0.05 + 0.9 * torch.rand((SC_B, SC_T), generator=g, device=device)
    y = torch.as_tensor(ds.Y, device=device).long()
    mask = torch.as_tensor(ds.Xlen, device=device)
    sw = torch.as_tensor(ds.SW, device=device)
    weights = mask * (1.0 + 0.25 * (1.0 - sw))
    return ([hh_o, hh_n, 1.0 - att, att, params["w"], params["b"],
             params["w_sw"], params["b_sw"]], y, weights)


MIX_FWD_KERNELS = ("mixture_rows_kernel", "ce_rows_kernel")


def mixture_pass_ms(device, head_o, head_n, yf, co, cn, wf, neg_fac, lse_o,
                    iters: int = 20):
    """Device ms of the mixture CE's row passes over one chunk, as
    ``ce_pass_ms`` times the CE's: the forward (both heads, any version's
    kernel, ``MIX_FWD_KERNELS``) and the backward (``ce_grad_rows`` over
    head o's logits with weights -fac and its lse, as phase 15 checks it,
    ``CE_BWD_KERNELS``), each cold
    (after writing 100 MB) and right after the ``addmm`` that writes its
    logits (the forward: both heads' from (x, w, b) = ``head_o``,
    ``head_n``).  None where a trace holds no such kernel.  -> {"fwd_cold_ms",
    "fwd_after_addmm_ms", "bwd_cold_ms", "bwd_after_addmm_ms"}"""
    import torch

    from icee_tpu_torch.ops import chunked_loss as cl

    flush = torch.empty((100 << 20) // 4, device=device)
    lo, ln = (torch.addmm(b, x, w) for x, w, b in (head_o, head_n))
    scratch = torch.empty_like(lo)
    db = torch.zeros((lo.shape[1],), device=device)
    one = torch.ones((1,), device=device)

    def heads():
        for (x, w, b), out in ((head_o, lo), (head_n, ln)):
            torch.addmm(b, x, w, out=out)

    def cold_bwd():
        scratch.copy_(lo)
        flush.zero_()

    def bwd():
        cl.ce_grad_rows(scratch, yf, neg_fac, lse_o, one, db)

    def fwd():
        cl.mixture_ce_rows(lo, ln, yf, co, cn, wf)

    return {
        "fwd_cold_ms": kernels_device_ms(fwd, MIX_FWD_KERNELS, iters,
                                         flush.zero_),
        "fwd_after_addmm_ms": kernels_device_ms(fwd, MIX_FWD_KERNELS, iters,
                                                heads),
        "bwd_cold_ms": kernels_device_ms(bwd, CE_BWD_KERNELS, iters,
                                         cold_bwd),
        "bwd_after_addmm_ms": kernels_device_ms(
            bwd, CE_BWD_KERNELS, iters,
            lambda: torch.addmm(head_o[2], head_o[0], head_o[1],
                                out=scratch))}


def check_mixture_ce(device, base):
    """Phase 15: the mixture CE on the card vs its plain versions at 128 x
    22 rows, H = 512, V = 8800, both heads.  The row passes at the main
    path's chunk (11 steps x 128 = 1,408 rows): lse and p atol 1e-4 and
    1e-6, w*nll atol 1e-4, dl 1e-4 x its largest magnitude (the backward
    row pass is ``ce_grad_rows`` with weights -fac); the whole loss
    (a sum) rtol 1e-5 and each gradient (hh_o, hh_n, co, cn, both w, both
    b) within 1e-3 x its largest magnitude, the same bits twice (each row
    pass too); the forward also within the same tolerances of the
    emulation of its partition (``mixture_rows_partition_plain``).  Times
    of the row passes (CUDA events; their kernels' device time cold and
    after the chunk's ``addmm``, ``mixture_pass_ms``) and of the whole
    loss on the kernel and plain paths.  -> (forward entry, backward
    entry, whole-loss stats)."""
    import torch

    from icee_tpu_torch.ops import chunked_loss as cl

    args, y, weights = mixture_inputs(device, base, 90)
    names = ("hh_o", "hh_n", "co", "cn", "w_o", "b_o", "w_n", "b_n")
    t_chunk = cl.even_t_chunk(SC_B, SC_T)
    n = SC_B * t_chunk
    x_o, x_n = (a[:, :t_chunk].reshape(n, SC_H) for a in args[:2])
    lo = torch.addmm(args[5], x_o, args[4])
    ln = torch.addmm(args[7], x_n, args[6])
    yf = y[:, :t_chunk].reshape(n)
    co, cn, wf = (a[:, :t_chunk].reshape(n).contiguous()
                  for a in (args[2], args[3], weights))
    got = cl.mixture_ce_rows(lo, ln, yf, co, cn, wf)
    got2 = cl.mixture_ce_rows(lo, ln, yf, co, cn, wf)
    want = cl.mixture_ce_rows_plain(lo, ln, yf, co, cn, wf)
    emu = cl.mixture_rows_partition_plain(lo, ln, yf, co, cn, wf)
    one = torch.ones((1,), device=device)
    _, _, fac, _ = cl.mixture_row_cotangents(got[2], got[3], co, cn, wf,
                                             one[0])
    neg_fac = (-fac).contiguous()
    db = torch.zeros((SC_V,), device=device)
    db2 = torch.zeros((SC_V,), device=device)
    dl = cl.ce_grad_rows(lo.clone(), yf, neg_fac, got[0], one, db)
    dl2 = cl.ce_grad_rows(lo.clone(), yf, neg_fac, got[0], one, db2)
    want_dl, want_db = cl.ce_grad_rows_plain(lo, yf, neg_fac, got[0],
                                             one[0])
    torch.cuda.synchronize()
    rows = {}
    for tag, ref in (("", want), ("emu_", emu)):
        rows[tag + "lse"] = max((got[i] - ref[i]).abs().max().item()
                                for i in (0, 1))
        rows[tag + "p"] = max((got[i] - ref[i]).abs().max().item()
                              for i in (2, 3))
        rows[tag + "w_nll"] = (got[4] - ref[4]).abs().max().item()
    rows.update({"dl": (dl - want_dl).abs().max().item(),
                 "dl_rel": max_rel_err(dl, want_dl),
                 "db_rel": max_rel_err(db, want_db)})
    limits = {"lse": 1e-4, "p": 1e-6, "w_nll": 1e-4, "emu_lse": 1e-4,
              "emu_p": 1e-6, "emu_w_nll": 1e-4, "dl_rel": 1e-4,
              "db_rel": 1e-4}
    for name, err in ((k, rows[k]) for k in limits):
        if not err <= limits[name]:
            fail(f"mixture CE rows: {name} error {err} > {limits[name]}")
    if not (all(torch.equal(a, b) for a, b in zip(got, got2))
            and torch.equal(dl, dl2) and torch.equal(db, db2)):
        fail("mixture CE row passes: two runs on the same inputs differ")

    out = {}
    for name, fn in (("kernel", cl.mixture_ce_from_hiddens),
                     ("again", cl.mixture_ce_from_hiddens),
                     ("plain", cl.mixture_ce_plain)):
        ta = [a.detach().clone().requires_grad_(True) for a in args]
        loss = fn(*ta, y, weights)
        out[name] = (loss.detach(), torch.autograd.grad(loss, ta))
    torch.cuda.synchronize()
    (kl, kg), (al, ag), (pl, pg) = out["kernel"], out["again"], out["plain"]
    if not (torch.equal(kl, al) and all(torch.equal(a, b)
                                        for a, b in zip(kg, ag))):
        fail("mixture CE: two runs on the same inputs differ")
    loss_err = abs(kl.item() - pl.item()) / abs(pl.item())
    grad_errs = {k: max_rel_err(a, b) for k, a, b in zip(names, kg, pg)}
    if not (loss_err <= 1e-5 and max(grad_errs.values()) <= 1e-3):
        fail(f"mixture CE vs plain: loss rel err {loss_err}, grad errs "
             f"{grad_errs}")
    log(f"mixture CE: rows {rows}; loss {kl.item():.3f} vs plain "
        f"{pl.item():.3f} (rel err {loss_err:.3g}); grad err / max|g| "
        f"{ {k: float(f'{v:.3g}') for k, v in grad_errs.items()} }; "
        f"bit-identical over two runs")

    # times: the row passes alone, then the whole loss forward + backward
    scratch = lo.clone()
    ms_f = cuda_ms(lambda: cl.mixture_ce_rows(lo, ln, yf, co, cn, wf), 20)
    plain_f = cuda_ms(lambda: cl.mixture_ce_rows_plain(lo, ln, yf, co, cn,
                                                       wf), 20)
    ms_b = cuda_ms(lambda: cl.ce_grad_rows(scratch, yf, neg_fac, got[0],
                                           one, db), 20)
    plain_b = cuda_ms(lambda: cl.ce_grad_rows_plain(lo, yf, neg_fac, got[0],
                                                    one[0]), 20)
    bf, bf_by = bound_ms(2 * 5 * n * SC_V, 4 * (2 * n * SC_V + 9 * n))
    bb, bb_by = bound_ms(5 * n * SC_V, 4 * (2 * n * SC_V + 3 * n + SC_V))
    dev_ms = mixture_pass_ms(device, (x_o, args[4], args[5]),
                             (x_n, args[6], args[7]), yf, co, cn, wf,
                             neg_fac, got[0])
    log(f"mixture CE row passes at {n} x {SC_V}: CUDA events forward "
        f"{ms_f:.4f} ms, backward {ms_b:.4f}; device " + ", ".join(
            f"{k} {v}" for k, v in dev_ms.items()) + f" (bounds {bf:.4f}, "
            f"{bb:.4f})")

    def path(fn):
        def run():
            ta = [a.detach().requires_grad_(True) for a in args]
            torch.autograd.grad(fn(*ta, y, weights), ta)
        return run

    whole = {"kernel_path_ms": cuda_ms(path(cl.mixture_ce_from_hiddens), 5),
             "plain_path_ms": cuda_ms(path(cl.mixture_ce_plain), 5),
             "loss_rel_err": loss_err, "grad_rel_errs": grad_errs,
             "row_errors": rows}
    rows_all = SC_B * SC_T
    # two head products forward, dx and dW of each head backward
    whole["bound_ms"], whole["bound_by"] = bound_ms(
        2 * 6 * rows_all * SC_H * SC_V,
        4 * (4 * rows_all * SC_H + 4 * SC_H * SC_V + 4 * SC_V
             + 7 * rows_all))
    common = {"route": "cuda", "source": "icee_tpu_torch/csrc/chunked_ce.cu",
              "library_ms": None,
              "library_note": "no call mixes two softmaxes' target "
                              "probabilities"}
    return (dict(common, name="mixture_ce_rows",
                 replaces="icee_tpu/ops/chunked_loss.py:289 (_mixture_fwd, "
                          "under mixture_ce_from_hiddens :364 and :194)",
                 max_abs_err=max(rows["lse"], rows["w_nll"]), ms=ms_f,
                 plain_ms=plain_f, bound_ms=bf, bound_by=bf_by,
                 cold_ms=dev_ms["fwd_cold_ms"],
                 after_addmm_ms=dev_ms["fwd_after_addmm_ms"]),
            dict(common, name="ce_grad_rows[mixture]", wrapper="ce_grad_rows",
                 replaces="icee_tpu/ops/chunked_loss.py:297 (_mixture_bwd)",
                 max_abs_err=rows["dl"], ms=ms_b, plain_ms=plain_b,
                 bound_ms=bb, bound_by=bb_by, cold_ms=dev_ms["bwd_cold_ms"],
                 after_addmm_ms=dev_ms["bwd_after_addmm_ms"]),
            whole)


def pretrained_base(device):
    """The base model switch training starts from (the reference loads a
    pretrained COCO model, ``train_joint.py:322-451``): phase 13's Xavier
    init trained 30 steps on phase 13's split, as phase 13 (ii) trains it.
    -> CPU tensors."""
    import torch

    from icee_tpu_torch.senticap import io as sio
    from icee_tpu_torch.senticap import model
    from icee_tpu_torch.senticap.solver import make_solver
    from icee_tpu_torch.senticap.train import make_base_step

    conf = senticap_conf_full()
    data = sio.device_dataset(senticap_split(4 * SC_B, 80), device)
    params = model.init_params(torch.Generator().manual_seed(81), SC_V, conf,
                               device=device)
    solver = make_solver(conf)
    opt_state = solver.init(params)
    step = make_base_step(conf, solver, device=device)
    gen = torch.Generator(device=device).manual_seed(83)
    for i in range(30):
        params, opt_state, _ = step(params, opt_state, data, torch.arange(
            (i % 4) * SC_B, (i % 4 + 1) * SC_B, device=device), gen)
    return {k: v.cpu() for k, v in params.items()}


def switched_params(device, base=None):
    """Seeded switched weights, ``switched.init_params(base=...)`` over a
    base model: for training the pretrained ``base`` (``pretrained_base``);
    without one, for the decode, phase 14's base decoder
    (``senticap_decoder``, shaped so that beams end at several lengths)
    with the sentiment weights + 0.05 N(0, 1) as ``bench.py:705-708``
    perturbs them and ``att_w`` x 5, so that the gates spread over ~(0.05,
    0.95) (x 4: 0.06-0.83, x 8: 0.004-0.96 over a few images' traces at
    this width)."""
    import torch

    from icee_tpu_torch.senticap import switched

    train = base is not None
    if not train:
        base = {k: v.cpu() for k, v in senticap_decoder("cpu").items()}
    p = switched.init_params(torch.Generator().manual_seed(64), SC_V,
                             senticap_conf_full(), base=base)
    if not train:
        g = torch.Generator().manual_seed(65)
        for k in ("w_lstm_sw", "w_sw", "wemb_sw", "wvm_sw"):
            p[k] = p[k] + 0.05 * torch.randn(p[k].shape, generator=g)
        p["att_w"] = p["att_w"] * 5.0
    return {k: v.to(device) for k, v in p.items()}


def train_switched_phase(device, base):
    """Phase 16: switch training at the reference's regime (B=128, T=22,
    E=H=512, V=8800, DA_SUM, LAMBDA_N = LAMBDA_GAM = 0.25, dropout on the
    sentiment path, RMSProp over the switch set) over sentiment-pure +1
    batches.  The first step (kernel vs plain path) and SC_NAN_STEPS steps
    on the kernel path (where the loss goes nan, recorded, not checked) run
    at lr 1e-3 from ``senticap_decoder``'s base; the 30 steps whose loss
    must fall run at SC_SWITCH_LR from the pretrained ``base``."""
    import math

    import torch

    from icee_tpu_torch.ops import chunked_loss as cl
    from icee_tpu_torch.ops import senticap_scan as ss
    from icee_tpu_torch.senticap import io as sio
    from icee_tpu_torch.senticap import switched
    from icee_tpu_torch.senticap.solver import make_solver
    from icee_tpu_torch.senticap.train import (make_switched_step,
                                               validation_perplexity)

    counters = {"fused_senticap_scan_fwd": ss.senticap_scan_fwd,
                "fused_senticap_scan_bwd": ss.senticap_scan_bwd,
                "mixture_ce_rows": cl.mixture_ce_rows,
                "ce_grad_rows": cl.ce_grad_rows}

    def reset():
        for fn in counters.values():
            fn.launches = 0

    def read():
        return {k: fn.launches for k, fn in counters.items()}

    ds = senticap_split(4 * SC_B, 86, senti=1.0)
    data = sio.device_dataset(ds, device)
    batches = [torch.arange(i * SC_B, (i + 1) * SC_B, device=device)
               for i in range(4)]
    ref_start = switched_params("cpu", {k: v.cpu() for k, v in
                                        senticap_decoder("cpu").items()})
    start = switched_params("cpu", base)
    mask = switched.switch_param_mask(start)

    def steps_at(lr, **kw):
        conf = senticap_conf_full(learning_rate=lr, **kw)
        solver = make_solver(conf, mask)
        return conf, solver, make_switched_step(conf, solver, device=device)

    _, ref_solver, ref_kernel = steps_at(SC_REF_LR)
    _, _, ref_plain = steps_at(SC_REF_LR, FUSED_SCAN=False,
                               CHUNKED_CE=False)
    conf, solver, kernel = steps_at(SC_SWITCH_LR)
    _, _, plain = steps_at(SC_SWITCH_LR, FUSED_SCAN=False, CHUNKED_CE=False)
    # CHUNKED_CE off: the distributions come from the per-step scan, as in
    # the JAX package, whose FUSED_SCAN acts on the chunked path only
    _, _, chunked_off = steps_at(SC_SWITCH_LR, CHUNKED_CE=False)
    if not (kernel.use_chunked and ref_kernel.use_chunked):
        fail("the CUDA switched step did not select the kernel path")

    def fresh(p=start):
        return {k: v.to(device) for k, v in p.items()}

    # (i) one step's loss and switch-set grads at the reference's regime,
    # kernel vs plain path, with the same dropout masks.  Tolerances as
    # phase 13: the loss (a SUM) rtol 1e-5; each grad 1e-3 x its largest
    # magnitude + 1e-7
    g = torch.Generator(device=device).manual_seed(87)
    masks = dict(x_drop=(torch.rand((SC_B, SC_T, SC_E), generator=g,
                                    device=device) < 0.5).float() * 2.0,
                 y_drop=(torch.rand((SC_B, SC_T, SC_H), generator=g,
                                    device=device) < 0.5).float() * 2.0)
    params = fresh(ref_start)
    out = {name: steps.grads(params, data, batches[0], **masks)
           for name, steps in (("kernel", ref_kernel), ("plain", ref_plain))}
    torch.cuda.synchronize()
    k_loss, p_loss = out["kernel"][0].item(), out["plain"][0].item()
    loss_err = abs(k_loss - p_loss) / abs(p_loss)
    kg, pg = out["kernel"][1], out["plain"][1]
    if sorted(kg) != sorted(k for k in mask if mask[k]):
        fail(f"switched step: grads taken for {sorted(kg)}")
    grad_errs, bad = {}, []
    for k in kg:
        if kg[k] is None or pg[k] is None:
            if not (kg[k] is None and pg[k] is None):
                bad.append(k)
            continue
        grad_errs[k] = max_rel_err(kg[k], pg[k])
        if not ((kg[k] - pg[k]).abs().max().item()
                <= 1e-3 * pg[k].abs().max().item() + 1e-7):
            bad.append(k)
    if not (loss_err <= 1e-5 and not bad):
        fail(f"switched first step: kernel vs plain loss rel err {loss_err},"
             f" grad errs {grad_errs}, bad {bad}")
    log(f"phase 16 (i): first step at lr {SC_REF_LR}, kernel vs plain: "
        f"loss {k_loss:.4f} vs {p_loss:.4f}; grad err / max|g| "
        f"{ {k: float(f'{v:.3g}') for k, v in grad_errs.items()} }")

    # (ii-a) SC_NAN_STEPS steps on the kernel path at the reference's lr
    # from the same start: the step at which the loss stops being finite
    params = fresh(ref_start)
    opt_state = ref_solver.init(params)
    gen = torch.Generator(device=device).manual_seed(88)
    ref_losses = []
    for i in range(SC_NAN_STEPS):
        params, opt_state, loss = ref_kernel(params, opt_state, data,
                                             batches[i % 4], gen)
        ref_losses.append(loss)
    ref_losses = [x.item() for x in ref_losses]
    nan_at = next((i for i, x in enumerate(ref_losses)
                   if not math.isfinite(x)), None)
    log(f"phase 16 (ii-a): lr {SC_REF_LR}: losses {ref_losses}, first "
        f"non-finite at step {nan_at}")

    # (ii) 30 steps on the kernel path, every K8 and mixture-CE count from
    # 0 just before and read just after; the loss must fall; the frozen
    # weights stay bit-identical
    params = fresh()
    opt_state = solver.init(params)
    gen = torch.Generator(device=device).manual_seed(88)
    reset()
    losses = []
    for i in range(30):
        params, opt_state, loss = kernel(params, opt_state, data,
                                         batches[i % 4], gen)
        losses.append(loss)
    torch.cuda.synchronize()
    launches = read()
    losses = [x.item() for x in losses]
    # two K8 forwards and one backward a step; the mixture CE's two time
    # chunks (auto t_chunk 16 of T = 22), the backward on the sentiment
    # head only (the background head is frozen)
    want = {"fused_senticap_scan_fwd": 60, "fused_senticap_scan_bwd": 30,
            "mixture_ce_rows": 60, "ce_grad_rows": 60}
    if launches != want:
        fail(f"switch training launched {launches}, expected {want}")
    frozen = [k for k in start if not mask[k]
              and not torch.equal(params[k].cpu(), start[k])]
    if frozen:
        fail(f"switch training changed frozen weights {frozen}")
    if not all(math.isfinite(x) for x in losses):
        fail(f"switched losses not finite: {losses}")
    drop = (sum(losses[-4:]) / 4) / (sum(losses[:4]) / 4)
    if not drop <= LOSS_FALL:
        fail(f"switched loss did not fall: last/first cycle {drop} > "
             f"{LOSS_FALL}")
    log(f"phase 16 (ii): losses {losses[0]:.1f} -> {losses[-1]:.1f}, "
        f"last/first cycle {drop:.3f}; launches {launches}; frozen weights "
        f"bit-identical")

    # (iii) validation perplexity on the chunked path (two K8 forwards,
    # the mixture row pass)
    reset()
    ppl = validation_perplexity(params, conf, senticap_split(SC_B, 89,
                                                             senti=1.0),
                                switched=True, device=device)
    val_launches = read()
    if not (math.isfinite(ppl) and ppl > 1.0
            and val_launches["fused_senticap_scan_fwd"] == 2
            and val_launches["mixture_ce_rows"] > 0):
        fail(f"validation_perplexity(switched=True): {ppl}, launches "
             f"{val_launches}")

    def kernel_step():
        kernel(params, opt_state, data, batches[1], gen)

    def plain_step():
        plain(params, opt_state, data, batches[1], gen)

    def chunked_off_step():
        chunked_off(params, opt_state, data, batches[1], gen)

    def materialized_loss_step():
        # the kernel path with the mixture CE's plain version (each chunk's
        # logits and softmaxes materialized, autograd) in place of its own
        own = cl.mixture_ce_from_hiddens
        cl.mixture_ce_from_hiddens = cl.mixture_ce_plain
        try:
            kernel_step()
        finally:
            cl.mixture_ce_from_hiddens = own

    ms = step_ms(kernel_step, 20)
    plain_ms = step_ms(plain_step, 5)
    chunked_off_ms = step_ms(chunked_off_step, 5)
    mat_ms = step_ms(materialized_loss_step, 20)
    busy = device_busy_share(kernel_step)
    by_kernel = device_time_by_kernel(kernel_step, top=None)
    mat_by_kernel = device_time_by_kernel(materialized_loss_step, top=None)
    device_ms = sum(r["ms"] for r in by_kernel)
    mat_device_ms = sum(r["ms"] for r in mat_by_kernel)
    log(f"phase 16 (iii): validation perplexity {ppl:.2f}; step {ms:.3f} ms "
        f"({SC_B / ms * 1e3:.1f} captions/s, device {device_ms:.3f} ms), "
        f"plain {plain_ms:.3f} ms; with the mixture CE's plain version "
        f"{mat_ms:.3f} ms (device {mat_device_ms:.3f} ms); CHUNKED_CE off "
        f"{chunked_off_ms:.3f} ms")
    return launches, {
        "config": {"B": SC_B, "T": SC_T, "V": SC_V, "E": SC_E, "H": SC_H,
                   "visual": SC_VIS, "solver": conf["GRAD_METHOD"],
                   "lr": conf["learning_rate"], "dropout": 0.5,
                   "domain_adapt": conf["DOMAIN_ADAPT"],
                   "lambda_n": conf["LAMBDA_N"],
                   "lambda_gam": conf["LAMBDA_GAM"],
                   "trainable": sorted(k for k in mask if mask[k])},
        "step_ms": ms, "captions_per_s": SC_B / ms * 1e3,
        "plain_step_ms": plain_ms,
        "plain_captions_per_s": SC_B / plain_ms * 1e3,
        "device_ms": device_ms,
        "plain_mixture_ce_step_ms": mat_ms,
        "plain_mixture_ce_device_ms": mat_device_ms,
        "chunked_ce_off_step_ms": chunked_off_ms,
        "device_busy_share": busy, "device_ms_by_kernel": by_kernel[:12],
        "first_step_kernel_vs_plain": {"lr": SC_REF_LR,
                                       "loss_rel_err": loss_err,
                                       "grad_rel_errs": grad_errs},
        "ref_lr_losses": ref_losses, "ref_lr_first_nonfinite_step": nan_at,
        "losses": losses, "last_over_first_cycle": drop,
        "val_perplexity": ppl, "val_launches": val_launches}


def switched_rescore(params, v, tokens, length):
    """The plain switched model's styled (senti = +1) length-normalized
    score of each image's token sequence: the score a search gives it."""
    import torch

    from icee_tpu_torch.senticap import switched

    conf = senticap_conf_full()
    tok = tokens.long()
    n = tok.shape[0]
    step = switched.beam_step(params, conf, 1.0)
    h = torch.zeros((n, 1, 2 * SC_H), device=v.device)
    c = torch.zeros_like(h)
    words = torch.zeros((n, 1), dtype=torch.long, device=v.device)
    total = torch.zeros((n,), device=v.device)
    for t in range(int(length.max())):
        probs, h, c, _ = step(words, t == 0, h, c, v)
        nll = -torch.log2(probs[:, 0] + 1e-37)
        total = torch.where(t < length, total + nll.gather(
            1, tok[:, t:t + 1])[:, 0], total)
        words = tok[:, t:t + 1]
    return total / length.float()


def check_k10(device):
    """Phase 17: K10 vs its plain search at 64 images, beam 20, max_len 20,
    margin-aware as phase 14: each kernel score matches its own sequence's
    plain re-score within 1e-3 and the plain search's within 1e-3; where
    tokens differ, the kernel's sequence ties the plain winner within
    1e-4; where they agree, the trace within 1e-5.  -> the kernel's entry
    of the kernels line."""
    import torch

    from icee_tpu_torch.ops import senticap_switched_decode as ssd

    params = switched_params(device)
    g = torch.Generator(device=device).manual_seed(66)
    v = torch.randn((SC_IMAGES, SC_VIS), generator=g, device=device)
    kw = dict(beam_size=SC_BEAM, max_len=SC_MAXLEN)
    got = ssd.mega_senticap_switched_decode(params, v, SC_IMAGES, **kw)
    again = ssd.mega_senticap_switched_decode(params, v, SC_IMAGES, **kw)
    want = ssd.mega_senticap_switched_decode_plain(params, v, SC_IMAGES,
                                                   **kw)
    rescored = switched_rescore(params, v, got[1], got[2])
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        fail("K10: two runs on the same inputs differ")
    max_err, own_err, trace_err, flips = 0.0, 0.0, 0.0, 0
    for i in range(SC_IMAGES):
        gs, ws, rs = got[0][i].item(), want[0][i].item(), rescored[i].item()
        n = int(got[2][i])
        same = n == int(want[2][i]) and torch.equal(got[1][i, :n],
                                                    want[1][i, :n])
        own_err = max(own_err, abs(rs - gs))
        if not abs(rs - gs) <= 1e-3:
            fail(f"K10 image {i}: reported score {gs}, its sequence scores "
                 f"{rs}")
        if same:
            trace_err = max(trace_err, (got[3][i, :n] - want[3][i, :n])
                            .abs().max().item())
        else:
            margin = abs(rs - ws)
            if margin > 1e-4:
                fail(f"K10 image {i}: tokens differ; kernel's sequence "
                     f"scores {rs}, plain winner {ws}, margin {margin}")
            flips += 1
            log(f"K10 image {i}: near-tie flip, margin {margin}")
        max_err = max(max_err, abs(gs - ws))
    if not max_err <= 1e-3:
        fail(f"K10: score error {max_err} > 1e-3")
    if not trace_err <= 1e-5:
        fail(f"K10: trace error {trace_err} > 1e-5")
    lengths = got[2].tolist()
    if len(set(lengths)) < 2:
        fail(f"K10: every beam ended at one length {lengths[0]}")
    gates = torch.cat([got[3][i, :lengths[i]] for i in range(SC_IMAGES)])
    spread = [gates.min().item(), gates.max().item()]
    log(f"K10: {SC_IMAGES} images, lengths min {min(lengths)} max "
        f"{max(lengths)} mean {sum(lengths) / len(lengths):.2f} "
        f"({len(set(lengths))} distinct); gates {spread[0]:.3f}.."
        f"{spread[1]:.3f}; score max abs err {max_err:.3g}, vs own re-score "
        f"{own_err:.3g}; trace err {trace_err:.3g}; {flips} near-tie flips;"
        f" bit-identical over two runs")
    ms = cuda_ms(lambda: ssd.mega_senticap_switched_decode(
        params, v, SC_IMAGES, **kw), 3)
    plain_ms = cuda_ms(lambda: ssd.mega_senticap_switched_decode_plain(
        params, v, SC_IMAGES, **kw), 3)
    rows, steps = SC_IMAGES * SC_BEAM, SC_MAXLEN + 1
    flops = steps * rows * 2 * (2 * ((SC_E + SC_H) * 4 * SC_H + SC_H * SC_V)
                                + 2 * SC_H)
    nbytes = 4 * (2 * (SC_V * SC_E + (SC_E + SC_H) * 4 * SC_H + SC_H * SC_V
                       + SC_V) + 2 * SC_H + 1 + 2 * SC_IMAGES * SC_E
                  + 2 * steps * rows * SC_E + SC_IMAGES * (2 * steps + 2))
    b_ms, b_by = bound_ms(flops, nbytes)
    groups = senticap_profile("K10", lambda: ssd.mega_senticap_switched_decode(
        params, v, SC_IMAGES, **kw))
    return {"name": "mega_senticap_switched_decode", "route": "cuda",
            "source": "icee_tpu_torch/csrc/senticap_switched_beam.cu",
            "replaces": "icee_tpu/ops/pallas_senticap_switched_decode.py:241",
            "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by,
            "bound_tf32x3_ms": flops / TF32X3_FLOP_PER_S * 1e3,
            "device_ms_by_group": groups, "library_ms": None,
            "library_note": "no single PyTorch call computes a beam search",
            "near_tie_flips": flips, "max_rescore_err": own_err,
            "max_trace_err": trace_err, "gate_min_max": spread,
            "lengths": lengths}


def decode_switched_phase(device):
    """Phase 17, the path: ``decode_split(switched=True)`` on a 64-image
    split, ``SC_DECODE_CALLS`` timed calls after a warm-up; K10 (the styled
    decode) and K9 (the descriptive one, on the background weights) counted
    from 0 just before the first call and read just after the last (one
    launch each a call); the same records every call; captions/s (styled
    and descriptive captions of the 64 images) from the median call."""
    import torch

    from icee_tpu_torch.ops import senticap_decode as sd
    from icee_tpu_torch.ops import senticap_switched_decode as ssd
    from icee_tpu_torch.senticap.train import decode_split

    params = switched_params(device)
    conf = senticap_conf_full(MAX_SENTENCE_LEN=SC_MAXLEN)
    ds = senticap_split(SC_IMAGES, 67, senti=1.0)
    i2w = {i: f"w{i}" for i in range(SC_V)}
    first = decode_split(params, conf, ds, i2w, switched=True,
                         torch_device=device)
    torch.cuda.synchronize()                                    # warm-up
    sd.mega_senticap_beam_decode.launches = 0
    ssd.mega_senticap_switched_decode.launches = 0
    walls = []
    for _ in range(SC_DECODE_CALLS):
        t0 = time.perf_counter()
        out = decode_split(params, conf, ds, i2w, switched=True,
                           torch_device=device)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        if out != first:
            fail("decode_split(switched=True): records differ between calls")
    launches = {"mega_senticap_switched_decode":
                ssd.mega_senticap_switched_decode.launches,
                "mega_senticap_beam_decode":
                sd.mega_senticap_beam_decode.launches}
    if any(n != SC_DECODE_CALLS for n in launches.values()):
        fail(f"decode_split(switched=True) launched {launches} in "
             f"{SC_DECODE_CALLS} calls")
    if len(out) != SC_IMAGES or not all(
            len(o["positive"]) <= SC_MAXLEN
            and len(o["attention"]) == len(o["positive"]) + 1
            and all(0.0 < a < 1.0 for a in o["attention"]) for o in out):
        fail(f"decode_split(switched=True): malformed records "
             f"{out[:2]}")
    styled = [len(o["positive"]) for o in out]
    differ = sum(o["positive"] != o["descriptive"] for o in out)
    wall = statistics.median(walls)
    log(f"phase 17: decode_split(switched=True) of {SC_IMAGES} images, "
        f"median of {SC_DECODE_CALLS} calls {wall * 1e3:.2f} ms (min "
        f"{min(walls) * 1e3:.2f}, max {max(walls) * 1e3:.2f}; "
        f"{2 * SC_IMAGES / wall:.1f} captions/s), styled caption words min "
        f"{min(styled)} max {max(styled)}, {differ} styled captions differ "
        f"from the descriptive; launches {launches}")
    return launches, {"images": SC_IMAGES, "beam": SC_BEAM,
                      "max_len": SC_MAXLEN, "calls": SC_DECODE_CALLS,
                      "wall_ms": wall * 1e3,
                      "wall_ms_min_max": [min(walls) * 1e3,
                                          max(walls) * 1e3],
                      "captions_per_s": 2 * SC_IMAGES / wall,
                      "styled_caption_words": styled,
                      "styled_differ_from_descriptive": differ}


# --- phase 18: the trainers (slice 3a) ----------------------------------------

# the corpus: phase 9's Zipf language, 5 captions an image (the reference's
# Flickr8k layout); 512 training images x 5 = 40 batches of 64, 320
# validation captions, 960 + 96 emotion captions
TR_IMAGES, TR_CAPS, TR_VAL, TR_EMO, TR_EMO_VAL = 512, 5, 320, 960, 96
TR_EPOCHS = {"stylenet": 3, "nic": 2}
ATT_TR_BATCHES = (2, 1)      # the StyleNet+Att epoch: factual, emotion


def trainer_vocab():
    """V words: the four specials, then w4 .. w{V-1}."""
    from icee_tpu_torch.data.vocab import SPECIALS, Vocabulary

    vocab = Vocabulary()
    for w in SPECIALS:
        vocab.add_word(w)
    for i in range(len(SPECIALS), V):
        vocab.add_word(f"w{i}")
    return vocab


def trainer_corpus(n_images: int, n_caps: int, seed: int, tag: str):
    """CaptionExamples over ``n_images`` synthetic images, ``n_caps``
    captions each (<start> Zipf words <end>, 8..T_STEPS tokens), each
    example holding its image's captions as references."""
    import numpy as np
    import torch

    from icee_tpu_torch.data.captions import CaptionExample

    words = (4 + torch.randperm(V - 4, generator=torch.Generator()
                                .manual_seed(99))[:WORDS]).numpy()
    zipf = 1.0 / np.arange(1, WORDS + 1)
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n_images):
        caps = [[1] + words[rng.choice(WORDS, rng.integers(6, T_STEPS - 1),
                                       p=zipf / zipf.sum())].tolist() + [2]
                for _ in range(n_caps)]
        out.extend(CaptionExample(f"{tag}{i}", c, caps) for c in caps)
    return out


def trainer_features(names, seed: int, shape):
    """name -> host features U(0, 1) (pooled) or 0.1 N(0, 1) (spatial,
    bench.py:221-222), float32."""
    import numpy as np

    rng = np.random.default_rng(seed)
    if len(shape) == 1:
        return {n: rng.random(shape, dtype=np.float32) for n in names}
    return {n: (0.1 * rng.standard_normal(shape)).astype(np.float32)
            for n in names}


@contextlib.contextmanager
def plain_counters():
    """Count every call of the trainer's kernels' plain versions (each
    wrapper calls its plain version by module name, on a CPU tensor) while
    the block runs; -> the dict of counts."""
    from icee_tpu_torch.ops import att_scan, beam
    from icee_tpu_torch.ops import chunked_loss as cl
    from icee_tpu_torch.ops import lstm_scan, nic_scan

    targets = [(lstm_scan, "fused_factored_scan_plain"),
               (lstm_scan, "factored_scan_bwd_plain"),
               (nic_scan, "fused_nic_scan_plain"),
               (nic_scan, "nic_scan_bwd_plain"),
               (cl, "ce_rows_plain"), (cl, "ce_grad_rows_plain"),
               (beam, "mega_beam_decode_plain"),
               (att_scan, "fused_att_scan_plain"),
               (att_scan, "fused_att_scan_sampled_plain"),
               (att_scan, "att_scan_grads_plain")]
    counts = {name: 0 for _, name in targets}
    saved = []
    for mod, name in targets:
        fn = getattr(mod, name)
        saved.append((mod, name, fn))

        def counted(*a, _fn=fn, _name=name, **kw):
            counts[_name] += 1
            return _fn(*a, **kw)
        setattr(mod, name, counted)
    try:
        yield counts
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def trainer_counters():
    """Phase 18's launch counters: K3, K4, K5 (StyleNet+Att), the CE row
    passes and K2 (both cells)."""
    from icee_tpu_torch.ops import beam, lstm_scan, nic_scan
    from icee_tpu_torch.ops import chunked_loss as cl

    out = {"fused_factored_scan_fwd": (lstm_scan.factored_scan_fwd,
                                       "launches"),
           "fused_factored_scan_bwd": (lstm_scan.factored_scan_bwd,
                                       "launches"),
           "fused_nic_scan_fwd": (nic_scan.nic_scan_fwd, "launches"),
           "fused_nic_scan_bwd": (nic_scan.nic_scan_bwd, "launches"),
           "ce_rows": (cl.ce_rows, "launches"),
           "ce_grad_rows": (cl.ce_grad_rows, "launches"),
           "mega_beam_decode": (beam.mega_beam_decode, "launches"),
           "mega_beam_decode_lstm": (beam.mega_beam_decode,
                                     "lstm_launches")}
    out.update({k: v for k, v in k5_counters().items()
                if not k.endswith(("_lstm_fwd", "_lstm_bwd"))})
    return out


class EpochClock:
    """Wall seconds of a trainer's passes, read after a synchronize: the
    training passes, the validations, the sample inside them and the
    checkpoint writes, and each epoch's end (its ``save``)."""

    def __init__(self, tr):
        import torch

        self.marks = {"train": [], "val": [], "sample": [], "save": []}
        self.ends = []
        self.t0 = None

        def timed(kind, fn):
            def run(*a, **kw):
                torch.cuda.synchronize()
                t = time.perf_counter()
                out = fn(*a, **kw)
                torch.cuda.synchronize()
                self.marks[kind].append(time.perf_counter() - t)
                if kind == "save":
                    self.ends.append(time.perf_counter())
                return out
            return run

        tr._run_train = timed("train", tr._run_train)
        tr._run_val = timed("val", tr._run_val)
        tr.save = timed("save", tr.save)
        if tr.sample_fn is not None:
            tr.sample_fn = timed("sample", tr.sample_fn)

    def start(self):
        self.t0 = time.perf_counter()

    def stats(self, epochs: int, captions: int) -> dict:
        """Per-epoch means and training captions/s (the epoch's training
        captions over its wall time, validation, sample and checkpoint
        included)."""
        bounds = [self.t0] + self.ends
        walls = [b - a for a, b in zip(bounds, bounds[1:])]
        per = {k: sum(v) / epochs for k, v in self.marks.items()}
        return {"epoch_s": walls, "train_s": per["train"],
                "val_s": per["val"], "sample_s": per["sample"],
                "save_s": per["save"],
                "captions_per_s": [captions / w for w in walls]}


def trainer_run(device, family: str, cls: str, tmp: str, dec, head, cfg,
                tcfg, vocab, call):
    """One trainer at flagship width on the card: built, its clock set,
    ``call(trainer)`` run with every launch counter from 0 just before
    and read just after. -> (trainer, launches, clock)."""
    from icee_tpu_torch.train import loops

    os.makedirs(tmp, exist_ok=True)
    tr = getattr(loops, cls)(cfg, tcfg, vocab, dec, head, family=family,
                             model_dir=tmp, data_name="chip",
                             metrics_path=os.path.join(tmp, "metrics.jsonl"),
                             device=device)
    if not (tr.steps.use_fused and tr.steps.use_chunked):
        fail(f"phase 18 {cls} {family}: the steps did not select the "
             "kernel path")
    clock = EpochClock(tr)
    counters = trainer_counters()
    for fn, attr in counters.values():
        setattr(fn, attr, 0)
    clock.start()
    call(tr)
    import torch

    torch.cuda.synchronize()
    return tr, {k: getattr(fn, attr) for k, (fn, attr) in counters.items()}, \
        clock


def expect_launches(what: str, got: dict, want: dict):
    """Every listed count exactly as expected, every other count 0."""
    for name, n in got.items():
        if n != want.get(name, 0):
            fail(f"phase 18 {what}: {name} launched {n} times, expected "
                 f"{want.get(name, 0)} (all counts {got})")


def metrics_events(tmp: str):
    with open(os.path.join(tmp, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def clone_tree(tree):
    if isinstance(tree, dict):
        return {k: clone_tree(v) for k, v in tree.items()}
    return tree.clone()


def trees_equal(a, b) -> bool:
    import torch

    from icee_tpu_torch.train.optim import tree_leaves

    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        (x is None and y is None) or (x is not None and y is not None
                                      and torch.equal(x, y))
        for x, y in zip(la, lb))


def check_restore(tr, path: str, family: str, cfg, tcfg, vocab, dec0,
                  head0, device):
    """A fresh trainer restored from ``path`` (the last epoch's checkpoint)
    holds the trainer's params and both optimizer states bit for bit."""
    from icee_tpu_torch.train import loops

    other = loops.MultitaskTrainer(cfg, tcfg, vocab, dec0, head0,
                                   family=family, device=device,
                                   model_dir=os.path.dirname(path))
    other.restore(path)
    same = (trees_equal((other.dec, other.head), (tr.dec, tr.head))
            and all(a.count == b.count and a.hyperparams == b.hyperparams
                    and trees_equal((a.mu, a.nu), (b.mu, b.nu))
                    for a, b in ((other.opt_state, tr.opt_state),
                                 (other.lang_opt_state, tr.lang_opt_state))))
    if not same or other.start_epoch != TR_EPOCHS[
            "stylenet" if family == "factored" else "nic"]:
        fail(f"phase 18 {family}: restore from {path} is not bit-equal "
             f"(start epoch {other.start_epoch})")


def check_sample(tr, sampled, cell: str, device):
    """The trainer's last sample: equal to one K2 search on its feature,
    and that search margin-aware (phase 5's rule) against the plain
    ``beam_search`` on the card.  -> (flips, max score error)."""
    import torch

    from icee_tpu_torch.decode.beam import BeamResult, beam_search
    from icee_tpu_torch.decode.fast import factored_decode, nic_decode
    from icee_tpu_torch.models import encoder as enc_mod
    from icee_tpu_torch.models import factored_lstm as fl
    from icee_tpu_torch.models import lstm

    feat, style, words = sampled[-1]
    with torch.no_grad():
        x = enc_mod.encode_global_from_pooled(tr.head, feat)
        tiled = x[:, None, :].expand(1, 5, x.shape[1]).contiguous()
        common = (1, 5, tr.cfg.max_seq_length, 1, 2)
        got = (factored_decode("mega", tr.dec, tiled, style, *common)
               if cell == "factored" else nic_decode(tr.dec, tiled, *common))
        ids = got.tokens[0][: int(got.length[0])].tolist()
        if [tr.vocab.idx2word[i] for i in ids][: len(words)] != words:
            fail(f"phase 18 {cell}: the sample {words} is not K2's {ids}")
        if cell == "factored":
            emb = lambda t: fl.embed(tr.dec, t)  # noqa: E731
            step = lambda x_, s: fl.decode_step(tr.dec, x_, s, style)  # noqa
        else:
            emb = lambda t: lstm.embed(tr.dec, t)  # noqa: E731
            step = lambda x_, s: lstm.decode_step(tr.dec, x_, s)  # noqa
        zeros = torch.zeros((5, H), device=device)
        plain = beam_search(emb, step, (zeros, zeros.clone()), 1, 2, 5,
                            tr.cfg.max_seq_length, V, first_input=tiled[0])
        want = BeamResult(plain.tokens[None], plain.length[None],
                          plain.score[None])
        rescored = sequence_scores(tr.dec, cell, tiled, style, got.tokens,
                                   got.length)
        err, _, flips = margin_check(f"phase 18 {cell} sample", got, want,
                                     rescored)
    return flips, err


def check_engine(best: str, snapshot, device):
    """CaptionEngines from the best checkpoint and from the trainer's
    params at that epoch caption 8 pooled features alike (one K2 search
    each a mode)."""
    import torch

    from icee_tpu_torch.core.config import DecoderConfig, EncoderConfig
    from icee_tpu_torch.serve.config import ServeConfig
    from icee_tpu_torch.serve.engine import CaptionEngine

    kw = dict(dec_cfg=DecoderConfig(vocab_size=V, embed_size=E,
                                    hidden_size=H, factored_size=F,
                                    max_seq_length=STEPS),
              enc_cfg=EncoderConfig(embed_size=E), device=device)
    with tempfile.TemporaryDirectory() as tmp:
        vocab_path = os.path.join(tmp, "vocab.pkl")
        trainer_vocab().save(vocab_path)
        engines = [CaptionEngine(ServeConfig(
            vocab_path=vocab_path,
            checkpoint_paths={"stylenet": {m: best for m in MODES}}),
            params={"backbone": {}}, **kw),
            CaptionEngine(ServeConfig(vocab_path=vocab_path), params={
                "backbone": {}, "stylenet": snapshot}, **kw)]
    pooled = torch.rand((8, 2048), generator=torch.Generator(
        device=device).manual_seed(81), device=device)
    caps = []
    for eng in engines:
        caps.append([])
        for mode in ("factual", "happy"):
            res = eng.decode(eng.head(pooled, mode, "stylenet"), mode,
                             variant="stylenet")
            caps[-1].append((res.tokens.cpu(), res.length.cpu()))
    for (ta, la), (tb, lb) in zip(*caps):
        if not (torch.equal(ta, tb) and torch.equal(la, lb)):
            fail("phase 18: the engine from the best checkpoint captions "
                 "otherwise than the engine from the params")
    return len(set(caps[0][0][1].tolist()))


def trainer_phase(device):
    """Phase 18: the port's trainers on the card at flagship width."""
    import math

    import torch

    from icee_tpu_torch.core.config import (DecoderConfig, EncoderConfig,
                                            TrainConfig)
    from icee_tpu_torch.data.pipeline import (caption_dataset_loader,
                                              styled_caption_loader)
    from icee_tpu_torch.models import encoder, lstm
    from icee_tpu_torch.ops import chunked_loss as cl

    vocab = trainer_vocab()
    train = trainer_corpus(TR_IMAGES, TR_CAPS, 180, "t")
    val = trainer_corpus(TR_VAL // TR_CAPS, TR_CAPS, 181, "v")
    emo = trainer_corpus(TR_EMO // TR_CAPS, TR_CAPS, 182, "e")
    emo_val = trainer_corpus(TR_EMO_VAL // TR_CAPS + 1, TR_CAPS, 183,
                             "u")[:TR_EMO_VAL]
    names = {e.image for ds in (train, val, emo, emo_val) for e in ds}
    pooled = trainer_features(sorted(names), 184, (2048,))

    def loader(ds, b, feats=pooled, seed=0):
        return caption_dataset_loader(ds, b, T_STEPS, feats.__getitem__,
                                      seed=seed)

    cfg = DecoderConfig(vocab_size=V, embed_size=E, hidden_size=H,
                        factored_size=F, dropout=0.5, max_seq_length=STEPS)
    tcfg = TrainConfig(mode="happy", teacher_forcing_ratio=1.0,
                       max_caption_len=T_STEPS, log_step=10 ** 9,
                       log_step_emotion=10 ** 9)
    n_fac, n_emo = -(-len(train) // B_IMAGES), -(-len(emo) // B_EMOTION)
    n_val = -(-len(val) // B_IMAGES) + -(-len(emo_val) // B_EMOTION)

    def chunks(b):
        return -(-T_STEPS // cl.auto_t_chunk(b, T_STEPS))

    ce_epoch = n_fac * chunks(B_IMAGES) + n_emo * chunks(B_EMOTION)
    stats, launches = {}, {}

    def fresh(family):
        if family == "factored":
            dec = training_decoder(device, 12)
        else:
            dec = lstm.init_params(torch.Generator().manual_seed(12), cfg,
                                   device=device)
            dec["cell"] = training_nic_cell(device, 12)
        head = encoder.init_head_params(torch.Generator().manual_seed(13),
                                        EncoderConfig(embed_size=E),
                                        device=device)
        return dec, head

    def add(counts):
        for k, n in counts.items():
            launches[k] = launches.get(k, 0) + n

    with tempfile.TemporaryDirectory() as root, plain_counters() as plain:
        # (i) MultitaskTrainer.train: StyleNet 3 epochs, NIC 2
        for family, model in (("factored", "stylenet"), ("nic", "nic")):
            epochs = TR_EPOCHS[model]
            tmp = os.path.join(root, model)
            dec0, head0 = fresh(family)
            sampled, snapshot = [], {}

            def call(tr, epochs=epochs):
                sample, save = tr.sample_fn, tr.save

                def record(dec, head, feat, style):
                    words = sample(dec, head, feat, style)
                    sampled.append((feat, int(style), words))
                    return words

                def keep_best(epoch, is_best, mode_tag=None):
                    if is_best and not mode_tag:
                        snapshot.update(decoder=clone_tree(tr.dec),
                                        head=clone_tree(tr.head))
                    return save(epoch, is_best, mode_tag)

                tr.sample_fn, tr.save = record, keep_best
                tr.train(loader(train, B_IMAGES), loader(val, B_IMAGES),
                         loader(emo, B_EMOTION), loader(emo_val, B_EMOTION),
                         num_epochs=epochs)

            tr, got, clock = trainer_run(device, family, "MultitaskTrainer",
                                         tmp, dec0, head0, cfg, tcfg, vocab,
                                         call)
            scan = ("fused_factored_scan" if family == "factored"
                    else "fused_nic_scan")
            k2 = ("mega_beam_decode" if family == "factored"
                  else "mega_beam_decode_lstm")
            steps = epochs * (n_fac + n_emo)
            expect_launches(model, got, {
                f"{scan}_fwd": steps, f"{scan}_bwd": steps,
                "ce_rows": epochs * ce_epoch,
                "ce_grad_rows": epochs * ce_epoch, k2: 2 * epochs})
            add(got)
            events = metrics_events(tmp)
            fac = [e for e in events if e["event"] == "epoch_factual"]
            emo_ev = [e for e in events if e["event"] == "epoch_emotion"]
            losses = [e["train_loss"] for e in fac]
            if not all(math.isfinite(x) for x in losses) or \
                    not losses[-1] <= LOSS_FALL * losses[0]:
                fail(f"phase 18 {model}: factual train loss {losses} did "
                     f"not fall to {LOSS_FALL} x the first epoch's")
            written = sorted(os.listdir(tmp))
            if "HAP_checkpoint_chip" not in written:
                fail(f"phase 18 {model}: checkpoints {written}")
            check_restore(tr, os.path.join(tmp, "HAP_checkpoint_chip"),
                          family, cfg, tcfg, vocab, dec0, head0, device)
            flips, score_err = check_sample(tr, sampled, family, device)
            st = clock.stats(epochs, len(train) + len(emo))
            st.update(
                epochs=epochs, train_loss=losses,
                emotion_train_loss=[e["train_loss"] for e in emo_ev],
                val_loss=[e["val_loss"] for e in fac],
                bleu4=[e["bleu4"] for e in fac],
                emotion_bleu4=[e["bleu4"] for e in emo_ev],
                top5=[e["top5"] for e in fac], checkpoints=written,
                sample=sampled[-1][2], sample_flips=flips,
                sample_score_err=score_err, launches=got,
                best_bleu4=tr.best_bleu4)
            if family == "factored":
                best = os.path.join(tmp, "HAP_BEST_checkpoint_chip")
                if os.path.isdir(best):
                    st["engine_lengths"] = check_engine(best, snapshot,
                                                        device)
                else:
                    fail(f"phase 18: no best checkpoint in {written}")
                # the device-busy share of one more epoch's factual
                # training pass and validation, from the profiler
                st["device_busy_share"] = device_busy_share(
                    lambda: (tr._run_train(loader(train, B_IMAGES, seed=1),
                                           0, 10 ** 9, "FAC"),
                             tr._run_val(loader(val, B_IMAGES), 0)))
            stats[model] = st
            log(f"phase 18 (i), {model}: {epochs} epochs, s an epoch "
                f"{[round(w, 2) for w in st['epoch_s']]} (train "
                f"{st['train_s']:.2f}, val {st['val_s']:.2f}, sample "
                f"{st['sample_s']:.3f}, save {st['save_s']:.2f}), "
                f"captions/s {[round(c) for c in st['captions_per_s']]}; "
                f"train loss {[round(x, 4) for x in losses]}, BLEU-4 "
                f"{st['bleu4']}; sample {st['sample']} ({flips} near-tie "
                f"flips); launches {got}")
            del tr
            torch.cuda.empty_cache()

        # (ii) TransferTrainer, 1 epoch from the StyleNet FAC weights
        dec0, head0 = fresh("factored")
        tmp = os.path.join(root, "transfer")
        tr, got, clock = trainer_run(
            device, "factored", "TransferTrainer", tmp, dec0, head0, cfg,
            tcfg, vocab, lambda t: t.train_transfer(
                loader(emo, B_EMOTION), loader(emo_val, B_EMOTION),
                num_epochs=1))
        expect_launches("transfer", got, {
            "fused_factored_scan_fwd": n_emo,
            "fused_factored_scan_bwd": n_emo,
            "ce_rows": n_emo * chunks(B_EMOTION),
            "ce_grad_rows": n_emo * chunks(B_EMOTION),
            "mega_beam_decode": 1})
        if not torch.equal(tr.dec["B"], dec0["B"]):
            fail("phase 18 transfer: the frozen embedding B moved")
        add(got)
        stats["transfer"] = dict(clock.stats(1, len(emo)), launches=got)
        del tr

        # (iii) PaperRegimeTrainer, 1 epoch: the factual pass, then the
        # text-only happy pass (K3 on the captions alone)
        dec0, head0 = fresh("factored")
        tmp = os.path.join(root, "paper")
        ids = [e.caption_ids for e in emo]

        def paper(t):
            t.train(loader(train, B_IMAGES), {"happy": styled_caption_loader(
                ids, B_EMOTION, T_STEPS, seed=0)}, num_epochs=1)

        tr, got, clock = trainer_run(device, "factored", "PaperRegimeTrainer",
                                     tmp, dec0, head0, cfg, tcfg, vocab,
                                     paper)
        expect_launches("paper regime", got, {
            "fused_factored_scan_fwd": n_fac + n_emo,
            "fused_factored_scan_bwd": n_fac + n_emo, "ce_rows": ce_epoch,
            "ce_grad_rows": ce_epoch})
        names_ = list(tr.dec)
        st = tr.style_opt_states["happy"]
        for key in ("S_w", "S_b"):
            m = st.mu[names_.index(key)]
            if m[[0, 2, 3]].abs().max().item() != 0.0 or not torch.equal(
                    tr.dec[key][2:], dec0[key][2:]):
                fail(f"phase 18 paper regime: {key}'s other styles moved")
        add(got)
        stats["paper"] = dict(clock.stats(1, len(train) + len(emo)),
                              launches=got)
        del tr
        torch.cuda.empty_cache()

        # (iv) one StyleNet+Att epoch at B_ATT, ratio 0.8 (K5 sampled)
        att_train = trainer_corpus(
            ATT_TR_BATCHES[0] * B_ATT // TR_CAPS + 1, TR_CAPS, 185,
            "a")[:ATT_TR_BATCHES[0] * B_ATT]
        att_emo = trainer_corpus(B_ATT // TR_CAPS + 1, TR_CAPS, 186,
                                 "b")[:ATT_TR_BATCHES[1] * B_ATT]
        att_val = trainer_corpus(B_ATT // TR_CAPS + 1, TR_CAPS, 187,
                                 "c")[:B_ATT]
        spatial = trainer_features(sorted(
            {e.image for ds in (att_train, att_emo, att_val) for e in ds}),
            188, (P, FS))
        dec0, acfg = att_train_decoder("factored", device, 12)
        atcfg = TrainConfig(mode="happy", teacher_forcing_ratio=0.8,
                            max_caption_len=T_STEPS + 1, log_step=10 ** 9,
                            log_step_emotion=10 ** 9)
        tmp = os.path.join(root, "att")

        def att(t):
            t.train(*(caption_dataset_loader(ds, B_ATT, T_STEPS + 1,
                                             spatial.__getitem__, seed=0)
                      for ds in (att_train, att_val, att_emo, att_val)),
                    num_epochs=1)

        tr, got, clock = trainer_run(device, "factored_att",
                                     "MultitaskTrainer", tmp, dec0, None,
                                     acfg, atcfg, vocab, att)
        n_att = sum(ATT_TR_BATCHES)
        att_chunks = -(-T_STEPS // cl.auto_t_chunk(B_ATT, T_STEPS))
        expect_launches("stylenet_att", got, {
            "fused_att_scan_sampled_fwd": n_att,
            "fused_att_scan_sampled_bwd": n_att,
            "ce_rows": n_att * att_chunks,
            "ce_grad_rows": n_att * att_chunks})
        add(got)
        stats["stylenet_att"] = dict(clock.stats(1, n_att * B_ATT),
                                     launches=got)
        del tr
    if any(plain.values()):
        fail(f"phase 18: a plain version ran on the card: {plain}")
    stats["plain_calls"] = plain
    stats["config"] = {
        "V": V, "E": E, "H": H, "F": F, "T": T_STEPS, "B": B_IMAGES,
        "B_emotion": B_EMOTION, "B_att": B_ATT, "P": P,
        "train_captions": len(train), "val_captions": len(val),
        "emotion_captions": [len(emo), len(emo_val)],
        "teacher_forcing_ratio": [1.0, 0.8], "dropout": 0.5}
    return launches, stats


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    try:
        from icee_tpu_torch.ops import cuda_lib
    except ModuleNotFoundError as e:
        if e.name != "icee_tpu_torch":
            raise
        print("chip_smoke: the icee_tpu_torch package is not beside this "
              "script; run it from the repository root", file=sys.stderr)
        return 1

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

    from icee_tpu_torch.core.device import set_float32_precision

    set_float32_precision()   # as every CUDA entry point of the port does
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = True
    log("phase 3: TF32 off for matmul and cuDNN; cuDNN deterministic")

    from icee_tpu_torch.ops.att_decode_step import att_decode_step_topk
    from icee_tpu_torch.ops.decode_step import decode_step_topk

    params = captioning_params(device)
    sty, nic = params["stylenet"]["decoder"], params["nic"]["decoder"]
    with torch.inference_mode():
        # the serial path's R = 5 (partly filled blocks in all three
        # launches), then R = 320 (full blocks), which is also timed
        serial_inputs, serial_err, serial_ties = check_k1(sty, device, K, 6)
        inputs, err, ties = check_k1(sty, device, B_IMAGES * K, 3)
        k1 = k1_line(sty, inputs, serial_inputs, max(serial_err, err),
                     serial_ties + ties)
        stages = {"decode_step_topk": split_timeline(
            lambda: decode_step_topk(sty, *serial_inputs, ktop=K))}
        log(f"phase 4: K1 ok, {k1['ms']:.3f} ms vs plain "
            f"{k1['plain_ms']:.3f} ms (library {k1['library_ms']:.3f}); "
            f"serial {K} rows {k1['serial_ms']:.4f} ms vs plain "
            f"{k1['serial_plain_ms']:.4f}, library "
            f"{k1['serial_library_ms']:.4f}, bound "
            f"{k1['serial_bound_ms']:.4f}")
        k2 = check_k2(sty, device)
        k2_lstm = check_k2(nic, device, cell="lstm")
        log("phase 5: K2 ok, ms (plain, bound) at " + "; ".join(
            f"{n} images: factored {k2['shapes'][n]['ms']:.3f} "
            f"({k2['shapes'][n]['plain_ms']:.3f}, "
            f"{k2['shapes'][n]['bound_ms']:.3f}), lstm "
            f"{k2_lstm['shapes'][n]['ms']:.3f} "
            f"({k2_lstm['shapes'][n]['plain_ms']:.3f}, "
            f"{k2_lstm['shapes'][n]['bound_ms']:.3f})"
            for n in k2["shapes"]))
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
            stages[k6[kind]["name"]] = split_timeline(
                lambda a=serial_args: att_decode_step_topk(*a, ktop=K))
        att_init = check_att_init(att, device)
        log(f"phase 5b: K6 ok, factored {k6['factored']['ms']:.3f} ms "
            f"(serial {k6['factored']['serial_ms']:.3f}) vs plain "
            f"{k6['factored']['plain_ms']:.3f}; lstm {k6['lstm']['ms']:.3f} "
            f"ms (serial {k6['lstm']['serial_ms']:.3f}) vs plain "
            f"{k6['lstm']['plain_ms']:.3f}; h0/c0 at one image "
            f"{att_init['ms']:.4f} ms (device {att_init['device_ms']}), 64 "
            f"images {att_init['shapes'][str(B_IMAGES)]['ms']:.4f}")
        log("phases 4, 5b: column-split path at the serial shape from a "
            "CUDA graph (replay ms, span and stage start/end us): "
            + json.dumps(stages))
        k7 = {kind: check_k7(dec, kind, device) for kind, dec in att.items()}
        log("phase 5c: K7 ok, ms (plain, bound) at " + "; ".join(
            f"{n} images: factored {k7['factored']['shapes'][n]['ms']:.3f} "
            f"({k7['factored']['shapes'][n]['plain_ms']:.3f}, "
            f"{k7['factored']['shapes'][n]['bound_ms']:.3f}), lstm "
            f"{k7['lstm']['shapes'][n]['ms']:.3f} "
            f"({k7['lstm']['shapes'][n]['plain_ms']:.3f}, "
            f"{k7['lstm']['shapes'][n]['bound_ms']:.3f})"
            for n in k7["factored"]["shapes"]))

    launches, stats = serve_phase(params, device)
    log(f"phase 6: served {stats['requests']} requests, launches {launches}")
    # the served paths (batched and serial) launch the whole-search
    # kernels; the fused-step path (phase 6's third) launches K1, K6 and
    # the h0/c0 kernel
    k1["launches"] = launches["fused_step"]["decode_step_topk"]
    # by images a call: the batched calls' groups (a launch of each
    # whole-search kernel per group), the serial requests (one image
    # each); 64 images is the benchmark shape, not served
    groups = stats["batched_images_per_call"]
    for entry, name in ((k2, "mega_beam_decode"),
                        (k2_lstm, "mega_beam_decode_lstm"),
                        (k7["factored"], "mega_att_beam_decode"),
                        (k7["lstm"], "mega_att_beam_decode_lstm")):
        entry["launches"] = (launches["batched"][name]
                             + launches["serial"][name])
        entry["launches_batched_serial"] = [launches["batched"][name],
                                            launches["serial"][name]]
        by = {str(n): groups.count(n) for n in sorted(set(groups))}
        by["1"] = by.get("1", 0) + launches["serial"][name]
        entry["launches_by_images"] = by
    for kind, suffix in (("factored", ""), ("lstm", "_lstm")):
        k6[kind]["launches"] = launches["fused_step"]["att_decode_step_topk"
                                                      + suffix]
    att_init["launches"] = launches["fused_step"]["att_init_state"]
    del params, sty, nic, att

    k3f, k3b = check_k3(device)
    k4f, k4b = check_k4(device)
    log("phase 7 (i): K3's products ok: " + scan_products_line(
        {"fwd": k3f["products"], "bwd": k3b["products"]}))
    log("phase 7 (i): K4's products ok: " + scan_products_line(
        {"fwd": k4f["products"], "bwd": k4b["products"]}))
    log(f"phase 7: K3 ok, forward {k3f['ms']:.3f} ms (plain "
        f"{k3f['plain_ms']:.3f}, bound {k3f['bound_ms']:.3f}, 3xTF32 floor "
        f"{k3f['bound_tf32x3_ms']:.3f}; device ms by group: "
        f"{groups_line(k3f['device_ms_by_group'])}), backward "
        f"{k3b['ms']:.3f} ms (plain {k3b['plain_ms']:.3f}, bound "
        f"{k3b['bound_ms']:.3f}, 3xTF32 floor {k3b['bound_tf32x3_ms']:.3f}; "
        f"device ms by group: {groups_line(k3b['device_ms_by_group'])}); "
        f"K4 ok, forward {k4f['ms']:.3f} ms (plain "
        f"{k4f['plain_ms']:.3f}, cuDNN {k4f['library_ms']:.3f}, bound "
        f"{k4f['bound_ms']:.3f}, 3xTF32 floor {k4f['bound_tf32x3_ms']:.3f}; "
        f"device ms by group: {groups_line(k4f['device_ms_by_group'])}), "
        f"backward {k4b['ms']:.3f} ms (plain {k4b['plain_ms']:.3f}, cuDNN "
        f"{k4b['library_ms']:.3f}, bound {k4b['bound_ms']:.3f}, 3xTF32 floor "
        f"{k4b['bound_tf32x3_ms']:.3f}; device ms by group: "
        f"{groups_line(k4b['device_ms_by_group'])})")
    cef, ceb, ce_whole = check_ce(device)
    log(f"phase 8: CE ok, rows {cef['ms']:.4f} ms (cold "
        f"{cef['cold_ms']:.4f}, after addmm {cef['after_addmm_ms']:.4f}, "
        f"bound {cef['bound_ms']:.4f}), grad rows {ceb['ms']:.4f} ms (cold "
        f"{ceb['cold_ms']:.4f}, after addmm {ceb['after_addmm_ms']:.4f}, "
        f"bound {ceb['bound_ms']:.4f}); whole loss fwd+bwd {ce_whole}")
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
    train["att_products"] = check_tf32x3(device)
    log("phase 10 (i): K5's tf32x3 product ok, device ms / TFLOP/s / error "
        "over gemm_f32's: " + "; ".join(
            f"{n} {s['device_ms']:.4f} / {s['tflops']:.1f} / "
            f"{s['err_over_f32']:.2f} (gemm_f32 {s['f32_device_ms']:.4f} / "
            f"{s['f32_tflops']:.1f})"
            for n, s in train["att_products"].items()))
    k5 = []
    for kind in ("factored", "lstm"):
        for sampled in (False, True):
            k5.extend(check_k5(kind, sampled, device))
    log("phase 10: K5 ok, " + "; ".join(
        f"{e['name']} {e['ms']:.3f} ms (plain {e['plain_ms']:.3f}, library "
        f"{e['library_ms']:.3f}; device products / attention / rest "
        f"{e['device_ms_by_group']['products_ms']:.3f} / "
        f"{e['device_ms_by_group']['attention_ms']:.3f} / "
        f"{e['device_ms_by_group']['rest_ms']:.3f})" for e in k5))
    att_launches = {}
    train["att"] = {}
    for factored in (True, False):
        launched, stats_att = train_att_phase(device, factored)
        for k, n in launched.items():
            att_launches[k] = att_launches.get(k, 0) + n
        train["att"]["stylenet_att" if factored else "nic_att"] = stats_att
    log("phase 11: attention factual step at ratio 0.8: " + "; ".join(
        f"{m} {st['factual_step_ms']:.3f} ms, {st['captions_per_s']:.1f} "
        f"captions/s (plain {st['plain_factual_step_ms']:.3f} ms)"
        for m, st in train["att"].items()))
    for entry in k5:
        entry["launches"] = att_launches[entry["name"]]
    for entry in (cef, ceb):   # the attention steps use the CE kernels too
        entry["launches"] += att_launches[entry["name"]]
    k8f, k8b = check_k8(device)
    log("phase 12 (i): K8's products ok: " + scan_products_line(
        {"fwd": k8f["products"], "bwd": k8b["products"]}))
    log(f"phase 12: K8 ok, forward {k8f['ms']:.3f} ms (plain "
        f"{k8f['plain_ms']:.3f}, bound {k8f['bound_ms']:.3f}, 3xTF32 floor "
        f"{k8f['bound_tf32x3_ms']:.3f}; device ms by group: "
        f"{groups_line(k8f['device_ms_by_group'])}), backward "
        f"{k8b['ms']:.3f} ms (plain {k8b['plain_ms']:.3f}, bound "
        f"{k8b['bound_ms']:.3f}, 3xTF32 floor {k8b['bound_tf32x3_ms']:.3f}; "
        f"device ms by group: {groups_line(k8b['device_ms_by_group'])})")
    sc_launches, train["senticap"] = train_senticap_phase(device)
    log(f"phase 13: SentiCap step {train['senticap']['step_ms']:.3f} ms, "
        f"{train['senticap']['captions_per_s']:.1f} captions/s (plain "
        f"{train['senticap']['plain_step_ms']:.3f} ms)")
    for entry in (k8f, k8b):
        entry["launches"] = sc_launches[entry["name"]]
    for entry in (cef, ceb):   # the SentiCap steps use the CE kernels too
        entry["launches"] += sc_launches[entry["name"]]
    with torch.inference_mode():
        k9_products = check_sb_products(device, 1)
        log("phase 14 (i): K9's products ok: " + products_line(k9_products))
        k9 = check_k9(device)
        k9["products"] = k9_products
        log(f"phase 14: K9 ok, {k9['ms']:.3f} ms vs plain "
            f"{k9['plain_ms']:.3f} ms (bound {k9['bound_ms']:.3f} ms, "
            f"3xTF32 floor {k9['bound_tf32x3_ms']:.3f}); device ms by "
            f"group: {groups_line(k9['device_ms_by_group'])}")
        k9["launches"], decode = decode_senticap_phase(device)
    base = pretrained_base(device)
    mxf, mxb, train["mixture_ce_fwd_bwd"] = check_mixture_ce(device, base)
    log(f"phase 15: mixture CE ok, rows {mxf['ms']:.4f} ms (plain "
        f"{mxf['plain_ms']:.4f}), grad rows {mxb['ms']:.4f} ms (plain "
        f"{mxb['plain_ms']:.4f}); whole loss fwd+bwd "
        f"{train['mixture_ce_fwd_bwd']['kernel_path_ms']:.3f} ms (plain "
        f"{train['mixture_ce_fwd_bwd']['plain_path_ms']:.3f})")
    sw_launches, train["senticap_switched"] = train_switched_phase(device,
                                                                  base)
    log(f"phase 16: switched step "
        f"{train['senticap_switched']['step_ms']:.3f} ms, "
        f"{train['senticap_switched']['captions_per_s']:.1f} captions/s "
        f"(plain {train['senticap_switched']['plain_step_ms']:.3f} ms)")
    for entry in (k8f, k8b):   # the switch steps run K8 too
        entry["launches"] += sw_launches[entry["name"]]
    mxf["launches"] = sw_launches["mixture_ce_rows"]
    # the mixture CE's backward row pass is ce_grad_rows: its launches in
    # the switch steps, which ceb (the single-head CE) does not count
    mxb["launches"] = sw_launches["ce_grad_rows"]
    with torch.inference_mode():
        k10_products = check_sb_products(device, 2)
        log("phase 17 (i): K10's products ok: "
            + products_line(k10_products))
        k10 = check_k10(device)
        k10["products"] = k10_products
        log(f"phase 17: K10 ok, {k10['ms']:.3f} ms vs plain "
            f"{k10['plain_ms']:.3f} ms (bound {k10['bound_ms']:.3f} ms, "
            f"3xTF32 floor {k10['bound_tf32x3_ms']:.3f}); device ms by "
            f"group: {groups_line(k10['device_ms_by_group'])}")
        sw_dec_launches, decode_sw = decode_switched_phase(device)
    k10["launches"] = sw_dec_launches["mega_senticap_switched_decode"]
    k9["launches"] += sw_dec_launches["mega_senticap_beam_decode"]
    tr_launches, train["trainer"] = trainer_phase(device)
    log("phase 18: trainers ok; StyleNet epoch s "
        f"{[round(w, 2) for w in train['trainer']['stylenet']['epoch_s']]}"
        ", captions/s "
        f"{[round(c) for c in train['trainer']['stylenet']['captions_per_s']]}"
        "; NIC epoch s "
        f"{[round(w, 2) for w in train['trainer']['nic']['epoch_s']]}, "
        "captions/s "
        f"{[round(c) for c in train['trainer']['nic']['captions_per_s']]}; "
        "device-busy share of a StyleNet epoch "
        f"{train['trainer']['stylenet']['device_busy_share']}")
    # the trainers run K3, K4, K5 (sampled, factored), the CE and K2
    for entry in (k3f, k3b, k4f, k4b, cef, ceb, *k5):
        entry["launches"] += tr_launches.get(entry["name"], 0)
    k2["launches"] += tr_launches["mega_beam_decode"]
    k2_lstm["launches"] += tr_launches["mega_beam_decode_lstm"]
    print(json.dumps({"train": train}))
    print(json.dumps({"serve": stats}))
    print(json.dumps({"decode": {"senticap": decode,
                                 "senticap_switched": decode_sw}}))
    print(json.dumps({"split_timeline": stages}))
    print(json.dumps({"kernels": [k1, k2, k2_lstm, k6["factored"],
                                  k6["lstm"], att_init, k7["factored"],
                                  k7["lstm"], k3f, k3b, k4f, k4b, cef,
                                  ceb, *k5, k8f, k8b, k9, mxf, mxb, k10]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
