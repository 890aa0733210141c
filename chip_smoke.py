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
   column-split path) and at 64 images x 5 beams = 320 rows (the many-row
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
   at 64 images x 5 beams = 320 rows (many-row) and at the serial path's
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
5d. the wide paths (beam widths and top-ks of 9 to 256, ``csrc/
   wide_topk.cuh``): (a) K1 and K6 (both cells) at k = 9, 20, 64 and 256
   rows an image (top-k = k), one image and 64, against their plain
   versions as phases 4 and 5b hold them (a near-tie swap within 1e-4,
   the log-probs' own tolerance, above k = 8), launches exact, timed at
   k = 20 and 256 beside their library yardsticks; (b, c) K2 and K7
   (both cells) at the same widths, one
   image and 64 (a launch holds MAX_ROWS // k images; 40 steps at k = 9
   and 20, 12 at 64, 8 at 256), margin-aware against the plain searches,
   launches exact, and at k = 20 = the fused-step paths (K1, K6) at atol
   0, timed at k = 20 and 256; (d) k = V + 1 refused by every wrapper on
   the card and on the CPU route with the same message (the CPU route's),
   nothing launched; (e) the main path at
   beam 20: the decode entry points of ``decode/fast.py`` for 8 images of
   each variant, both paths, every count from 0 just before and read just
   after and exact, no plain version, fused-step = whole search at atol 0;
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
   the recurrence took other than one launch (counted by the library
   itself and in the trace; a trace that lost its last records is taken
   again, ``scan_device_groups``); its float32 bound and its 3xTF32
   floor;
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
   chunked path; step time, captions/s, the plain step's time; the
   chunked neglog2 sum (``masked_neglog2_sum_from_hiddens``) at 128 x 22
   rows on the kernel path and with the plain row pass, both timed;
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
19. the CLIs and the serving entry point (slice 3b) as processes on the
   card, in the demo's order, over phase 18's corpus written as caption
   files (every one of V words at least once) and 512 synthetic JPEGs, at
   flagship width (first whether the C++ batcher and JPEG decoder build
   there): ``build_vocab`` (V = 8192), ``precompute_features``
   (ResNet-152 at 224, batch 32), ``train`` (multitask StyleNet, an epoch,
   ratio 1.0 set through the stage wrapper), ``train_resident`` (the
   same with ``--device_resident --progress_chunk 4``: its checkpoint
   bit-equal to ``train``'s), ``evaluate`` in both
   semantics, ``caption_batch`` (and ``--beam_size 20``, K2's wide path,
   its captions those of this process's searches at beam 20 and
   margin-aware against the plain search's; ``--beam_size 300``, K2 with
   its survivors in device memory, must exit 0 with a caption an image,
   its launches exact and no plain version), ``sample``, ``validate``, the spatial
   ``precompute_features`` of 64 images with ``evaluate --attention`` and
   ``caption_batch --attention``, then ``python -m icee_tpu_torch.serve``
   on the trained checkpoint (one request, ``GET /``).  Each stage runs
   through a wrapper (``CLI_WRAPPER``) that prints the port's launch
   counters: K3 and the CE once a training step, K2 once a batch or
   validation, K7 once a batch, no plain version.  ``evaluate``'s BLEU must
   equal the in-process ``evaluate()``, ``caption_batch``'s captions the
   in-process call (the first batch margin-aware against the plain
   search), the served caption ``CaptionEngine``'s.  Seconds a stage, CUDA
   start-up apart, images/s and captions/s with process start included;
20. the device-resident epochs (slice 3c) at flagship width: (a) a
   StyleNet ``MultitaskTrainer`` epoch at ratio 1.0 over 6,000 images x 5
   Zipf captions (B = 64), 1,500 emotion lines (B = 96) and 2,500
   validation lines from the host loader, then from pinned splits
   (``data/device.py``): parameters, optimizer states and generator equal
   at atol 0, the same losses, BLEU and top-5, launches exact (K3 and the
   CE a step, K2 a validation), the pinned training passes run under
   ``torch.cuda.set_sync_debug_mode("warn")`` and their synchronizing
   calls counted by line; (b) the pinned epoch with a progress record
   every 64 batches, killed after the 3rd record and resumed by a fresh
   trainer: equal to (a)'s at atol 0, each record's write timed; (c)
   StyleNet+Att at ratio 0.8 over 500 spatial features (0.8 GB) x 5
   captions at B = 128, streamed through a 0.5 GB budget and pinned:
   equal at atol 0, K5 launches exact; (d) bfloat16 storage against
   float32 storage of the rounded features, at atol 0; (e) one
   StyleNet+Att step at ratio 0.8 at B = 512 and 1,024 (step ms,
   captions/s, peak memory, or the error that refuses it); (f)
   ``make_base_epoch`` / ``make_switched_epoch`` over 10 batches at phase
   13's shapes against the steps one by one, at atol 0, K8 and the
   (mixture) CE launches exact; seconds, captions/s and the device-busy
   share of each tier; no plain version called;
21. the SentiCap CLI (slice 7d) as processes on the card at the COCO
   regime (E = H = 512, visual 4096, B = 128, max_len 20, beam 20), over a
   caption JSON of 512 images x 5 Zipf captions whose words pass
   MIN_WORD_FREQ at V = 8,800 and 4096-wide features, through
   ``CLI_WRAPPER``: ``base`` (2 epochs: K8 forward and backward once a
   step, the CE row passes once a step and chunk, then
   ``validation_perplexity`` in blocks of 128 rows), ``base
   --device_resident`` (its pickle bit-equal to ``base``'s), ``train`` from
   ``base``'s pickle over 640 styled records that add 40 sentiment words
   (two K8 forwards and one backward a step, the mixture CE), ``test
   --out_dir`` over 64 images (K10 and K9 once) and ``test --base_only``
   (K9 once); launches exact, no plain version; the ``test`` decodes and
   metrics equal an in-process ``decode_split`` of the same pickle (a
   differing caption only at a 1e-4 near tie); seconds a stage with
   ``import torch`` apart and decoded captions/s with the start;
22. seq2seq (slice 6) and the utilities (slice 9): (a)
   ``Seq2SeqTrainer.train`` at ``Seq2SeqConfig``'s defaults (E = 300, H =
   512, 1 layer, dropout 0.22), V = 8192, over phase 18's corpus at B = 64
   with 960 lines a style at B = 96, ratio 0.8, 2 epochs, from the host
   loader and from pinned splits: parameters, both Adam states, the
   generator and the log equal at atol 0, the CE row passes once a step and
   chunk, no plain version, the factual loss falling; ``greedy_sample`` in
   every mode; 3 steps at ratio 1.0; (b) ``python -m
   icee_tpu_torch.cli.train --trainer seq2seq`` over phase 19's feature
   cache, with and without ``--device_resident``: the same log; (c) an
   ``adversarial.total_loss`` and an ``encode_decode.loss`` with every
   gradient on the card against the CPU, ``grad_reverse`` negating on the
   card; (d) ``utils.profiling.trace`` around one step (its file names
   ``ce_rows_kernel``) and ``StepTimer``'s p50 of the factual step with
   captions/s from it; then the run's whole wall time;
23. the data- and tensor-parallel port (slice 8) as two ranks sharing the
   card over gloo (NCCL refuses two ranks on one card), at flagship width
   over phase 19's files: (a) ``python -m torch.distributed.run
   --nproc_per_node 2`` of ``cli.train --data_parallel --dist_backend
   gloo`` (the stage wrapper on every rank), at DP 2 and at
   ``--tensor_parallel 2`` (the vocabulary split in two): each must give
   phase 19's ``train`` log (text equal, the epochs' losses within
   PAR_LOSS_RTOL, top-5 and BLEU-4 equal), every rank launching K3 and
   the CE once a step and chunk of its rows and K2 once a validation; (b)
   ``evaluate --data_parallel`` over two ranks: phase 19's ``evaluate
   --feed_feature`` (K2) and ``evaluate --attention`` (K7) lines, token
   for token, each rank launching once a batch; (c) one SentiCap base step
   at DP 2 in a spawned world (``parallel/launch.py``): both ranks' loss
   and gradients equal, and within 1e-5 / PAR_GRAD_TOL of one process's on
   the card; (d) with two cards or more, (a) over NCCL, one rank a card;
   (e) seconds a rank spends in ``import torch`` and CUDA's start, and the
   StyleNet factual step's ms a rank at DP 2 and TP 2 beside phase 9's;
   launches exact on every rank, no plain version called;
24. hidden widths and batches past the training scans' resident plan
   (``csrc/scan_grid.cuh``'s streamed plans): (a) K3 and K4 at (B, H) =
   (64, 736), (64, 1024), (64, 2048) with E = 300, F = H, T = 25, and K3
   at (2048, 512); K8 at (128, 1024), E = 512, T = 22, gclip 5.0: both
   directions against their plain versions as phase 7 holds them, the same
   bits twice, each plan's kinds printed and one recurrence launch a
   direction, timed beside the bound (K4 beside cuDNN's ``nn.LSTM``, h
   atol 1e-4); (b) K5 factored, sampled at ratio 0.8, at H = F = 1024 as
   phase 10 holds it; (c) ``cli.train --hidden_size 1024``, one epoch of
   StyleNet (``--factored_size 1024``) over 4,096 captions at
   ``--caption_batch_size 4096`` (one factual step of 4,096 rows through
   K3: phase 28's batch past 2048) and one of NIC over phase 19's corpus
   and cache at ratio 1.0, their K3 / K4, CE and K2 counts
   exact and no plain version, then ``evaluate --feed_feature`` on the
   StyleNet checkpoint: its BLEU this process's, each line the plain
   search's or a near tie; (d) SentiCap at H = 1024: one base step kernel
   against plain (phase 13 (i)), then ``decode_split`` of 8 images at beam
   20 through K9, its captions this process's K9 search's, margin-aware
   against the plain search (phase 14's rule);
25. widths that are not a multiple of 4 (the padded layout of
   ``icee_tpu_torch/ops/widths.py``): (a) K1 (5 and 320 rows, top-20 at
   160), K2 (both cells), K6 (both kinds), the h0/c0 kernel and K7 (both
   kinds) at 1 and 64 images (k = 5) and 8 images at k = 20, 20 steps,
   phase 6's seeded decoders cut to each case's widths,
   against their plain versions as phases 4-5d hold them, K2 = K1
   fused-step and K7 = K6 at atol 0, at V = 8189, 8190 and 8191 (every
   residue mod 4) with F, H, A and FS ragged across the cases (E = 300);
   K5 forward and backward at B = 128, T = 25, P = 196, both kinds, both
   modes, at the ragged A and FS; (b) ``build_vocab`` over phase 19's
   corpus with one word merged into another (V = 8191), ``train`` (one
   StyleNet epoch, its K2 sample included) and ``evaluate`` as processes,
   launches exact, no plain version; the engine and batcher for all four
   variants at V = 8191, batched captions = serial; (c) K2 and K7 (1 and
   64 images) and K1 (5 rows) at V = 8191 beside the same decoders at V =
   8192, on a line of their own;
26. beams and vocabularies past one block (``csrc/wide_topk.cuh``'s
   selection with its survivors in device memory; K9's and K10's passes
   from device memory): (a) K1 and K6 (both kinds) at k = top-k = 257,
   512, 1024 (one image), 300 over 8 images and k = top-k = V on the
   decoders cut to V = 1000, against their plain versions as phase 5d (a)
   holds them; (b) K2 (both cells) and K7 (both kinds) at k = 257, 512,
   1024, 2048 (one image; 8, 8, 6, 4 steps), 300 over 8 images, k = V =
   1000 (4 steps) and k = 5 at V = 100,000 over 1 and 8 images (20
   steps), margin-aware and re-scored as phase 5d (b, c), launches exact,
   K2 = K1 fused-step and K7 = K6 at atol 0 at k = 300, 1024 and V =
   100,000; (c) K9 and K10 at the COCO regime at beam 165, 257, 512 over
   8 images (V = 8800) and beam 20 over 64 images at V = 32,768 (both)
   and 60,000 (K9), phases 14's and 17's checks, launches exact; (d) the
   times of K1 and K6 at k = 1024, K2 and K7 at k = 512 and 2048 and at V
   = 100,000 (8 images), K9 at beam 257, K10 at V = 32,768, beside their
   bounds (and K1's and K6's library chains), on a line of their own;
   (e) the main path: ``decode/fast.py`` at beam 300 over 2 images and
   ``decode_split`` (switched at V = 32,768, beam 20; base at beam 257),
   every count from 0 just before and read just after and exact, no plain
   version, fused-step = whole search at atol 0;
27. the step and attention kernels at every width: (a) K1 and K6 (both
   kinds) at H = F = 1024 and 2048 (the many-row path's tiles recorded)
   over 64 images x 5 rows and one image x 20 as phases 4 and 5b hold
   them, timed at 64 images; at H = F = 1024, K2 (factored) = K1
   fused-step and K7 (both kinds) = K6 at atol 0 over 8 images at k = 5
   and 20, and the engine's fused-step path (8 requests one by one, then
   one batch of 8) = its whole searches for StyleNet, StyleNet+Att and
   NIC+Att, launches exact; (b) K5 (both cells and modes, forward and
   backward) at B = 128, (T, A) = (42, 2048) and (62, 1024), where the
   d_att1 pass splits A, as phase 10 holds it, the factored sampled scan
   timed; (c) K7 (both kinds) at P = 289, 400, 1024 (one image and 64 at
   k = 5, 8 at k = 20), 2304 (the softmax rows in device memory) and at A
   = 4096 (att2 from L2), margin-aware and = K6 at atol 0, the h0/c0
   launch at P = 400, and the attention decoders' main path at P = 400
   through ``decode/fast.py``, launches exact; (d) beside (a)-(c),
   ``precompute_features --spatial --grid 20`` over 64 JPEGs, ``train
   --attention --attention_size 2048`` (one epoch, ratio 0.8),
   ``evaluate --attention`` and ``caption_batch --attention`` as
   processes, launches exact, no plain version;
28. batches past 2048: (a) K3, K4 and K8 forward and backward at B =
   4096, H = 512 (streamed plans) as phase 24 (a) holds them (h, c atol
   1e-4, each grad within 1e-3 x its largest magnitude, the same bits
   twice), timed beside their bounds, K4 also beside cuDNN's nn.LSTM
   (the train CLI's step at ``--caption_batch_size 4096`` is phase 24
   (c)'s);
29. past the earlier limits: (a) K5 factored sampled, forward and
   backward, at T = 1,900 (the d_att1 pass in chunks of steps), A = 512,
   4 images, as phase 10 holds it, timed beside its bound; (b) K6 (both
   kinds) at A = 8,192, P = 196, k = 8 (att2 staged in column pieces) over
   one image and 64, as phase 5b holds it, timed, and K7 = K6 at atol 0
   over 4 images; (c) K2's time by part (products, row stage, tail) at k
   = 20 over 64 images, k = 300 over 3 and k = 2048 at one image, k = 300
   checked as phase 26 (b) and timed beside its bound;
   then the seconds of every phase, on a line of their own;
30. print one ``{"train": {...}}`` line (with ``nic``, ``att`` (with
   ``b512`` and ``b1024``), ``senticap``, ``senticap_switched``,
   ``trainer``, ``resident``, ``seq2seq``, ``wide_h`` (phase 24),
   ``wide_width`` (phase 27), ``big_batch`` (phase 28) and ``limits``
   (phase 29) entries), one
   ``{"cli": {...}}`` line (phase 19, with phase 21's ``senticap_cli``
   entry), one ``{"serve":
   {...}}`` line, one ``{"decode": {"senticap": {...},
   "senticap_switched": {...}}}`` line, one ``{"split_timeline": {...}}``
   line (phases 4 and 5b), one ``{"parallel": {...}}`` line (phase 23)
   one ``{"widths": {...}}`` line (phase 25), one
   ``{"past_block_times": {...}}`` line (phase 26), one ``{"phase_s":
   {...}}`` line and one ``{"kernels": [...]}`` line
   (K1, K2 factored and lstm, K6 factored and lstm, the h0/c0 kernel, K7
   factored and lstm, K3 and K4 forward and backward, CE forward and
   backward, K5 forward and backward for both cells and both modes, K8
   forward and backward, K9, the mixture CE forward and backward, K10, and
   the wide paths of K1, K2, K6 and K7, both cells: their launches phase
   5d (e)'s and, for K2, phase 19's beam-20 stage; K3, K4 and K8 past the
   resident plan, forward and backward: their launches phases 24's and
   28's, phase 28's B = 4096 figures among their shapes; K1,
   K2 and K7 with their phase 25 (c) times at V = 8191; K1, K2, K6, K7
   (both cells or kinds), K9 and K10 past one block: their launches
   phase 26 (e)'s; K1 and K6 (both kinds) at H = F past 8 rows a cell
   block, K5 factored sampled past the d_att1 plane and K7 (both kinds)
   past 256 positions: their launches phase 27's engine, (c)'s main path
   and (d)'s processes; phase 29's K5, K6 and K2 figures among the
   shapes of those entries);
31. print ``{"ok": true, "device": {...}}`` as the last line.

Without CUDA it exits 2, and where the package is not beside it 1, each
with a message and no result.
"""

from __future__ import annotations

import contextlib
import functools
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor

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


def step_flops_per_row(cell: str = "factored", vocab: int = V) -> int:
    """Multiply-adds x2 of one decode step for one row: cell chain + head
    (over ``vocab`` words)."""
    if cell == "lstm":
        return 2 * (E * 4 * H + H * 4 * H + H * vocab)
    return 2 * (E * 4 * F + 4 * F * F + 4 * F * H + H * 4 * H + H * vocab)


def decoder_weight_bytes(cell: str = "factored", vocab: int = V) -> int:
    """Bytes of the weights every step reads (the embedding is gathered by
    row and counted with the step inputs)."""
    if cell == "lstm":
        return 4 * (E * 4 * H + 4 * H + H * 4 * H + 4 * H + H * vocab
                    + vocab)
    return 4 * (E * 4 * F + 4 * F + 4 * F * F + 4 * F + 4 * F * H + 4 * H
                + H * 4 * H + 4 * H + H * vocab + vocab)


def head_vocab(dec) -> int:
    """The words of a decoder's head (any of the four variants)."""
    return (dec["C_w"] if "C_w" in dec else dec["linear_w"]).shape[1]


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

    from icee_tpu_torch.models import resnet

    backbone = resnet.init_params(torch.Generator().manual_seed(0),
                                  device=device)
    for li in range(1, 5):
        for block in backbone[f"layer{li}"]:
            block["bn3"]["weight"].mul_(0.2)
    return {"backbone": backbone, **decoder_params(device)}


def decoder_params(device, vocab: int = V):
    """``captioning_params`` without the backbone: the four variants'
    decoders (and the global ones' encoder heads) at this module's
    widths, over ``vocab`` words.  The heads are sharpened 30x at H = 512
    and by 30 sqrt(512 / H) at other widths, so that the logits keep the
    flagship's spread (a sum over H terms grows as sqrt(H))."""
    import torch

    from icee_tpu_torch.core.config import (AttentionDecoderConfig,
                                            DecoderConfig, EncoderConfig)
    from icee_tpu_torch.models import attention, encoder, factored_lstm, lstm

    out = {}
    sharpen = 30.0 * math.sqrt(512 / H)
    for variant, init, head_w, seed in (
            ("stylenet", factored_lstm.init_params, "C", 1),
            ("nic", lstm.init_params, "linear", 3)):
        dec = init(torch.Generator().manual_seed(seed),
                   DecoderConfig(vocab_size=vocab, embed_size=E,
                                 hidden_size=H, factored_size=F),
                   device=device)
        w, b = (("C_w", "C_b") if head_w == "C"
                else ("linear_w", "linear_b"))
        dec[w].mul_(sharpen)
        dec[b][2] = 2.0
        if variant == "nic":
            dec["cell"]["W_ih"].mul_(4.0)
        head = encoder.init_head_params(
            torch.Generator().manual_seed(seed + 1),
            EncoderConfig(embed_size=E), device=device)
        head["linear_w"].mul_(10.0)
        head["linear_b"].mul_(10.0)
        out[variant] = {"decoder": dec, "head": head}
    att_cfg = AttentionDecoderConfig(vocab_size=vocab, embed_size=E,
                                     hidden_size=H, factored_size=F,
                                     attention_size=A, feature_size=FS)
    for variant, init, head_w, seed in (
            ("stylenet_att", attention.init_factored_att_params, "C", 5),
            ("nic_att", attention.init_rnn_att_params, "linear", 7)):
        dec = init(torch.Generator().manual_seed(seed), att_cfg,
                   device=device)
        w, b = (("C_w", "C_b") if head_w == "C"
                else ("linear_w", "linear_b"))
        dec[w].mul_(sharpen)
        dec[b][2] = 7.5
        dec["init_h_w"].mul_(6.0)
        dec["init_c_w"].mul_(6.0)
        out[variant] = {"decoder": dec}
    return out


def near_tie(ktop: int) -> float:
    """The plain log-prob gap within which K1 or K6 may order two entries of
    a top-``ktop`` otherwise than the plain version: 1e-5 at the k <= 8
    widths (phases 4 and 5b); above, 1e-4, the tolerance the log-probs
    themselves are held to.  The kernels' log-probs differ from the plain
    versions' by up to ~5e-5 here (another fmaf order over H = 512), and
    below the first few ranks of V = 8192 gaps that small are common (a
    top-256 of 256 rows compares ~65,000 adjacent pairs)."""
    from icee_tpu_torch.ops.decode_step import K_MAX

    return 1e-5 if ktop <= K_MAX else 1e-4


@contextlib.contextmanager
def counted_calls(fn, want: dict, what: str):
    """Launch counters ``fn.<name>`` must grow by exactly ``want[name]``
    while the block runs (the calls a check makes, one by one)."""
    before = {n: getattr(fn, n) for n in want}
    yield
    got = {n: getattr(fn, n) - before[n] for n in want}
    if got != want:
        fail(f"{what}: launches {got}, expected {want}")


# --- phase 4: K1 ------------------------------------------------------------

def check_k1(dec, device, rows: int, seed: int, ktop: int = K):
    """K1 vs its plain version on ``rows`` random rows at top-``ktop``; ->
    (inputs, max abs error, near-tie swaps).  Fails on any id outside a
    near tie or any error above 1e-4, and unless the call launched once,
    on the path its shape and width take."""
    import torch

    from icee_tpu_torch.ops.cells import factored_lstm_cell
    from icee_tpu_torch.ops.decode_step import (K_MAX, SPLIT_ROWS,
                                                decode_step_topk,
                                                decode_step_topk_plain)

    style = 1
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((rows, E), generator=g, device=device) * 0.5
    h = torch.randn((rows, H), generator=g, device=device) * 0.5
    c = torch.randn((rows, H), generator=g, device=device) * 0.5

    with counted_calls(decode_step_topk, {
            "launches": 1, "wide_launches": int(ktop > K_MAX),
            "split_launches": int(rows <= SPLIT_ROWS),
            "tiled_launches": int(rows > SPLIT_ROWS)}, f"K1 {rows} rows"):
        got = decode_step_topk(dec, x, h, c, style, ktop=ktop)
    want = decode_step_topk_plain(dec, x, h, c, style, ktop=ktop)
    torch.cuda.synchronize()
    gv, gi, gh, gc = got
    wv, wi, wh, wc = want
    # ids exact, except where the kernel picked an entry whose plain
    # log-prob ties the plain top-k at its rank within near_tie(ktop) (a
    # near-tie swap)
    h2, _ = factored_lstm_cell(dec, x, h, c, style)
    logp = torch.log_softmax(h2 @ dec["C_w"] + dec["C_b"], dim=-1)
    mism = (gi != wi).any(dim=1)
    ties, tie = 0, near_tie(ktop)
    for r in torch.nonzero(mism).flatten().tolist():
        picked = logp[r, gi[r].long()]
        if (picked - wv[r]).abs().max().item() > tie:
            fail(f"K1 {rows} rows, row {r}: ids {gi[r].tolist()} != "
                 f"{wi[r].tolist()} beyond a {tie} near-tie")
        ties += 1
    ok = ~mism
    errs = {"logp": (gv[ok] - wv[ok]).abs().max().item(),
            "h": (gh - wh).abs().max().item(),
            "c": (gc - wc).abs().max().item()}
    log(f"K1: {rows} rows, top-{ktop}, ids equal on {int(ok.sum())}, "
        f"near-tie swaps {ties}; max abs err {errs}")
    for name, err in errs.items():
        if not err <= 1e-4:
            fail(f"K1 {rows} rows, top-{ktop}: {name} error {err} > 1e-4")
    return (x, h, c, style), max(errs.values()), ties


def k1_line(dec, inputs, serial_inputs, max_err: float, ties: int):
    """Times K1, its plain version and the library yardstick at the
    batched shape (320 rows, the many-row path) and the serial one (5
    rows, the column-split path); -> K1's entry of the kernels line."""
    out = {}
    for tag, shape_inputs in (("", inputs), ("serial_", serial_inputs)):
        # the serial shape's calls are short and host-bound: more of them,
        # after more warm-up, for all three alike
        n, warm = (100, 10) if tag else (20, 1)
        for key, val in k1_times(dec, shape_inputs, K, n, warm).items():
            out[tag + key] = val
    return dict(out, name="decode_step_topk", route="cuda",
                source="icee_tpu_torch/csrc/decode_step.cu",
                replaces="icee_tpu/ops/pallas_decode.py:261",
                max_abs_err=max_err, near_tie_swaps=ties,
                serial_source="icee_tpu_torch/csrc/split_step.cuh")


def k1_times(dec, inputs, ktop: int, n: int, warm: int) -> dict:
    """K1's, its plain version's and the library yardstick's (the cell,
    addmm, log_softmax, topk) mean ms over ``n`` calls on ``inputs`` at
    top-``ktop``, and the bound."""
    import torch

    from icee_tpu_torch.ops.cells import factored_lstm_cell
    from icee_tpu_torch.ops.decode_step import (decode_step_topk,
                                                decode_step_topk_plain)

    x, h, c, style = inputs
    rows = x.shape[0]

    def library_step():
        h_new, _ = factored_lstm_cell(dec, x, h, c, style)
        return torch.topk(torch.log_softmax(
            torch.addmm(dec["C_b"], h_new, dec["C_w"]), dim=-1), ktop)

    out = {"ms": cuda_ms(
        lambda: decode_step_topk(dec, x, h, c, style, ktop=ktop), n, warm),
        "plain_ms": cuda_ms(lambda: decode_step_topk_plain(
            dec, x, h, c, style, ktop=ktop), n, warm),
        "library_ms": cuda_ms(library_step, n, warm)}
    vocab = head_vocab(dec)
    nbytes = decoder_weight_bytes(vocab=vocab) + 4 * rows * (E + 2 * H) \
        + 4 * rows * (2 * ktop + 2 * H)
    out["bound_ms"], out["bound_by"] = bound_ms(
        rows * step_flops_per_row(vocab=vocab), nbytes)
    return out


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
    hd = (dec["W_w"] if cell == "factored" else dec["cell"]["W_hh"]).shape[0]
    zeros = torch.zeros((tok.shape[0], hd), device=tok.device)
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


def wide_selection(vocab: int, k: int, steps_max: int) -> bool:
    """Whether a whole-search launch runs the wide selection (k above
    K_MAX, or the narrow tail's partials past the ring: V above ~80k)."""
    from icee_tpu_torch.ops import beam, widths

    return beam.selection_kind(-(-widths.quad(vocab) // 256), k,
                               steps_max + 2) != beam.SEL_NARROW


def plain_by_images(search, batch: int, k: int, *args, **kw):
    """A plain search ``search(args[0], feats, args[2], n, ...)`` over
    ``batch`` images, MAX_ROWS // k images at a time (the kernels' launch
    split; the images' searches are independent), the results stacked."""
    import torch

    from icee_tpu_torch.decode.beam import BeamResult
    from icee_tpu_torch.ops.beam import launch_chunks

    dec, feats, style = args
    parts = [search(dec, None if feats is None else feats[i:i + n], style,
                    n, k=k, **kw) for i, n in launch_chunks(batch, k)]
    return BeamResult(*(torch.cat(ts) for ts in zip(*parts)))


def search_geometry(kernel: str, call) -> dict:
    """One more call of K2 or K7 (``kernel``) with the search's profile on
    (``ops/beam.py::search_split``): each product stage's steps by the
    geometry it took, {stage: {"slab" | "tile": steps}} (K7's
    scores and softmax stages left out: they have one)."""
    from icee_tpu_torch.ops import att_beam, beam

    lib = beam._library() if kernel == "k2" else att_beam._library()
    return {stage: {geo: n for geo, (n, _) in geos.items()}
            for stage, geos in beam.search_split(lib, call)["stages"].items()
            if stage not in ("scores", "softmax")}


def check_k2_shape(dec, device, cell: str, n_img: int, k: int = K,
                   steps_max: int = STEPS, fused: bool = True,
                   timed: bool = True):
    """K2 with ``cell`` for ``n_img`` images at beam ``k`` (``steps_max``
    steps) vs its plain search, in both feature modes, its launches exact;
    with ``fused``, the factored cell also vs the fused-step path (K1) at
    atol 0; with ``timed``, timed.  -> this shape's figures."""
    import torch

    from icee_tpu_torch.decode.fast import factored_decode
    from icee_tpu_torch.ops.beam import (launch_chunks, mega_beam_decode,
                                         mega_beam_decode_plain,
                                         mega_beam_decode_steps)

    style = 2 if cell == "factored" else 0
    vocab = head_vocab(dec)
    g = torch.Generator(device=device).manual_seed(4)
    feats = torch.randn((n_img, 1, E), generator=g, device=device)
    feats = feats.expand(n_img, k, E).contiguous()
    max_err, own_err, flips = 0.0, 0.0, 0
    kw = dict(max_seq_length=steps_max, cell=cell)
    pre = "" if cell == "factored" else "lstm_"
    n_launch = len(launch_chunks(n_img, k))
    for mode_feats in (feats, None):
        mode = ("serving" if mode_feats is not None else "research") \
            + f", {cell}, {n_img} images, k={k}"
        with counted_calls(mega_beam_decode, {
                pre + "launches": n_launch,
                pre + "wide_launches": n_launch * wide_selection(
                    vocab, k, steps_max)}, f"K2 {mode}"):
            got, steps = mega_beam_decode_steps(dec, mode_feats, style,
                                                n_img, k=k, **kw)
        want = plain_by_images(mega_beam_decode_plain, n_img, k, dec,
                               mode_feats, style, **kw)
        # the plain model's score of the kernel's own sequences: a wrong
        # token, parent or length shows here even where the kernel's
        # reported score is right
        rescored = sequence_scores(dec, cell, mode_feats, style, got.tokens,
                                   got.length)
        errs = margin_check(f"K2 {mode}", got, want, rescored)
        max_err, own_err = max(max_err, errs[0]), max(own_err, errs[1])
        flips += errs[2]
        if cell == "factored" and fused:
            # the fused-step path (K1 in the Python beam) gives the same
            # bits: column-split at <= 8 rows, many-row above
            fused_res = factored_decode("fused-step", dec, mode_feats, style,
                                        n_img, k, steps_max, 1, 2)
            for what in ("tokens", "length", "score"):
                if not torch.equal(getattr(fused_res, what),
                                   getattr(got, what)):
                    fail(f"K2 {mode}: {what} differ from the fused-step "
                         "path's (atol 0)")
        lengths = got.length.float()
        log(f"K2 {mode}: lengths mean {lengths.mean().item():.2f} min "
            f"{int(lengths.min())} max {int(lengths.max())}, steps run per "
            f"image min {int(steps[:, 0].min())} max "
            f"{int(steps[:, 0].max())}, live row-steps "
            f"{int(steps[:, 1].sum())}; rescore max abs err so far {own_err}"
            + ("; = fused-step at atol 0" if cell == "factored" and fused
               else ""))
        if mode_feats is not None:
            serving_steps = steps   # the timed, serving-mode run

    out = {"max_abs_err": max_err, "max_rescore_err": own_err,
           "near_tie_flips": flips, "launches_a_call": n_launch,
           "steps_min_max": [int(serving_steps[:, 0].min()),
                             int(serving_steps[:, 0].max())],
           "live_row_steps": int(serving_steps[:, 1].sum())}
    if not timed:
        return out
    out["ms"] = cuda_ms(lambda: mega_beam_decode(dec, feats, style, n_img,
                                                 k=k, **kw), 5)
    out["geometry"] = search_geometry("k2", lambda: mega_beam_decode(
        dec, feats, style, n_img, k=k, **kw))
    out["plain_ms"] = cuda_ms(lambda: plain_by_images(
        mega_beam_decode_plain, n_img, k, dec, feats, style, **kw), 3)
    row_steps = out["live_row_steps"]
    nbytes = (decoder_weight_bytes(cell, vocab) + 4 * n_img * k * E
              + 4 * row_steps * E + 4 * n_img * (steps_max + 4))
    out["bound_ms"], out["bound_by"] = bound_ms(
        row_steps * step_flops_per_row(cell, vocab), nbytes)
    return out


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


def att_step_flops_per_row(kind: str, vocab: int = V) -> int:
    """Multiply-adds x2 of one attention step for one row: att2, the P
    scores, the context, the gate, then the cell on [emb; ctx] and the
    head (over ``vocab`` words)."""
    attend = 2 * (H * A + P * A + P * FS + H * FS)
    e_in = E + FS
    if kind == "lstm":
        return attend + 2 * (e_in * 4 * H + H * 4 * H + H * vocab)
    return attend + 2 * (e_in * 4 * F + 4 * F * F + 4 * F * H + H * 4 * H
                         + H * vocab)


def att_weight_bytes(kind: str, init: bool = False, vocab: int = V) -> int:
    """Bytes of the weights every attention step reads (with ``init``, the
    h0/c0 projections too)."""
    e_in = E + FS
    attend = H * A + A + A + 1 + H * FS + FS
    if kind == "lstm":
        cell = e_in * 4 * H + H * 4 * H + 8 * H
    else:
        cell = e_in * 4 * F + 4 * F + 4 * F * F + 4 * F + 4 * F * H + 4 * H \
            + H * 4 * H + 4 * H
    return 4 * (attend + cell + H * vocab + vocab
                + (2 * FS * H + 2 * H if init else 0))


def att_features(device, n_img: int, seed: int):
    """Spatial features at the statistics of the served ones (post-ReLU
    ResNet maps pooled to 14 x 14: mean ~0.13 per channel)."""
    import torch

    g = torch.Generator(device=device).manual_seed(seed)
    return 0.3 * torch.rand((n_img, P, FS), generator=g, device=device)


def att_step_plain(args, ktop: int):
    """K6's plain version on ``args``, a group of images at a time (at most
    MAX_ROWS rows: it repeats each image's features for each of its rows),
    the outputs concatenated."""
    import torch

    from icee_tpu_torch.ops.att_decode_step import att_decode_step_topk_plain
    from icee_tpu_torch.ops.beam import MAX_ROWS

    cell, att, gate, x, h, c, feats, att1, kind, k = args
    per = max(1, MAX_ROWS // k)
    parts = [att_decode_step_topk_plain(
        cell, att, gate, x[i * k:(i + per) * k], h[i * k:(i + per) * k],
        c[i * k:(i + per) * k], feats[i:i + per], att1[i:i + per], kind, k,
        ktop=ktop) for i in range(0, feats.shape[0], per)]
    return tuple(torch.cat(ts) for ts in zip(*parts))


def check_k6(dec, kind: str, device, n_img: int, seed: int, k: int = K):
    """K6 with ``kind`` vs its plain version on ``n_img`` images x ``k``
    random rows at top-``k``; -> (inputs, max abs error, near-tie swaps).
    Ids exact except in a 1e-5 near tie; logp, h', c' atol 1e-4, alpha
    atol 1e-5; one launch, on the path the shape takes."""
    import torch

    from icee_tpu_torch.models import attention as att_mod
    from icee_tpu_torch.ops.att_decode_step import (att_decode_step_topk,
                                                    split_att_smem,
                                                    step_params)
    from icee_tpu_torch.ops.cuda_lib import SMEM_LIMIT
    from icee_tpu_torch.ops.decode_step import K_MAX, SPLIT_ROWS

    style = 3 if kind == "factored" else 0
    cell, att, gate = step_params(dec, kind, style)
    rows = n_img * k
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((rows, E), generator=g, device=device) * 0.1
    h = torch.randn((rows, H), generator=g, device=device) * 0.5
    c = torch.randn((rows, H), generator=g, device=device) * 0.5
    feats = att_features(device, n_img, seed)
    att1 = att_mod.att_projection(att, feats)
    args = (cell, att, gate, x, h, c, feats, att1, kind, k)
    pre = "" if kind == "factored" else "lstm_"
    # one image's rows on the column-split path where its launches fit a
    # block (the wrapper's rule: past A = 7,264 at k = 8 they do not)
    split = n_img == 1 and k <= SPLIT_ROWS and split_att_smem(
        kind == "factored", k, E, F if kind == "factored" else H, H, A, P,
        FS) <= SMEM_LIMIT
    with counted_calls(att_decode_step_topk, {
            pre + "launches": 1, pre + "wide_launches": int(k > K_MAX),
            pre + "split_launches": int(split),
            pre + "tiled_launches": int(not split)},
            f"K6 {kind} {n_img} images, k={k}"):
        gv, gi, gh, gc, ga = att_decode_step_topk(*args, ktop=k)
    wv, wi, wh, wc, wa = att_step_plain(args, k)
    torch.cuda.synchronize()
    mism = (gi != wi).any(dim=1)
    ties, tie = 0, near_tie(k)
    if bool(mism.any()):
        logp = torch.log_softmax(wh @ cell["C_w"] + cell["C_b"], dim=-1)
        for r in torch.nonzero(mism).flatten().tolist():
            picked = logp[r, gi[r].long()]
            if (picked - wv[r]).abs().max().item() > tie:
                fail(f"K6 {kind} {rows} rows, row {r}: ids {gi[r].tolist()} "
                     f"!= {wi[r].tolist()} beyond a {tie} near-tie")
            ties += 1
    ok = ~mism
    errs = {"logp": (gv[ok] - wv[ok]).abs().max().item(),
            "h": (gh - wh).abs().max().item(),
            "c": (gc - wc).abs().max().item()}
    alpha_err = (ga - wa).abs().max().item()
    log(f"K6 {kind}: {rows} rows, k={k}, ids equal on {int(ok.sum())}, "
        f"near-tie swaps {ties}; max abs err {errs}, alpha {alpha_err:.3g}")
    for name, err in errs.items():
        if not err <= 1e-4:
            fail(f"K6 {kind} {rows} rows, k={k}: {name} error {err} > 1e-4")
    if not alpha_err <= 1e-5:
        fail(f"K6 {kind} {rows} rows, k={k}: alpha error {alpha_err} > "
             "1e-5")
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


def k6_times(kind: str, args, n: int, n_plain: int, warm: int) -> dict:
    """K6's, its plain version's and the library yardstick's mean ms on
    ``args`` at top-k (k their rows an image), and the bound."""
    from icee_tpu_torch.ops.att_decode_step import att_decode_step_topk

    n_img, k = args[6].shape[0], args[9]
    rows, vocab = n_img * k, head_vocab(args[0])
    out = {"ms": cuda_ms(lambda: att_decode_step_topk(*args, ktop=k), n,
                         warm),
           "plain_ms": cuda_ms(lambda: att_step_plain(args, k), n_plain,
                               warm),
           "library_ms": cuda_ms(lambda: att_library_step(args), n, warm)}
    nbytes = (att_weight_bytes(kind, vocab=vocab) + 4 * n_img * P * (FS + A)
              + 4 * rows * (E + 2 * H) + 4 * rows * (2 * k + 2 * H + P))
    out["bound_ms"], out["bound_by"] = bound_ms(
        rows * att_step_flops_per_row(kind, vocab), nbytes)
    return out


def k6_line(kind: str, args, serial_args, max_err: float, ties: int):
    """Times K6, its plain version and the library yardstick at the
    batched shape (64 images x K rows) and the serial one (one image);
    -> K6's entry of the kernels line."""
    out = {}
    for tag, a in (("", args), ("serial_", serial_args)):
        # the serial shape's calls are short and host-bound: more of them,
        # after more warm-up, for all three alike
        n, n_plain, warm = (100, 100, 10) if tag else (20, 5, 1)
        for key, val in k6_times(kind, a, n, n_plain, warm).items():
            out[tag + key] = val
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


def check_k7_shape(dec, kind: str, device, n_img: int, k: int = K,
                   steps_max: int = STEPS, fused: bool = True,
                   timed: bool = True):
    """K7 with ``kind`` for ``n_img`` images at beam ``k`` (``steps_max``
    steps) vs its plain search, margin-aware as phase 5: each kernel score
    matches its own sequence's plain score within 1e-3, and where tokens
    differ from the plain search, the kernel's sequence ties the plain
    winner's within 1e-4; its launches exact; with ``fused``, vs the
    fused-step path (K6 per step from the h0/c0 kernel) at atol 0; with
    ``timed``, timed, its bound from the live row-steps it ran.  -> this
    shape's figures."""
    import torch

    from icee_tpu_torch.decode.fast import attention_decode, nic_att_decode
    from icee_tpu_torch.ops.att_beam import (mega_att_beam_decode,
                                             mega_att_beam_decode_plain,
                                             mega_att_beam_decode_steps)
    from icee_tpu_torch.ops.beam import launch_chunks

    style = 3 if kind == "factored" else 0
    vocab = head_vocab(dec)
    feats = att_features(device, n_img, 14)
    kw = dict(max_seq_length=steps_max, kind=kind)
    what = f"K7 {kind} {n_img} images, k={k}"
    pre = "" if kind == "factored" else "lstm_"
    n_launch = len(launch_chunks(n_img, k))
    with counted_calls(mega_att_beam_decode, {
            pre + "launches": n_launch,
            pre + "wide_launches": n_launch * wide_selection(
                vocab, k, steps_max)}, what):
        got, steps = mega_att_beam_decode_steps(dec, feats, style, n_img,
                                                k=k, **kw)
    want = plain_by_images(mega_att_beam_decode_plain, n_img, k, dec, feats,
                           style, **kw)
    rescored = att_sequence_scores(dec, kind, feats, style, got.tokens,
                                   got.length)
    max_err, own_err, flips = margin_check(what, got, want, rescored)
    if fused:
        # the fused-step path (K6 per step: column-split at one image of
        # k <= 8, many-row above) gives the same bits
        args = (n_img, k, steps_max, 1, 2)
        fused_res = (attention_decode("fused-step", dec, feats, style, *args)
                     if kind == "factored"
                     else nic_att_decode("fused-step", dec, feats, *args))
        for name in ("tokens", "length", "score"):
            if not torch.equal(getattr(fused_res, name), getattr(got, name)):
                fail(f"{what}: {name} differ from the fused-step path's "
                     "(atol 0)")
    lengths = got.length.float()
    row_steps = int(steps[:, 1].sum())
    log(f"{what}: lengths mean {lengths.mean().item():.2f} min "
        f"{int(lengths.min())} max {int(lengths.max())}, steps run per image "
        f"min {int(steps[:, 0].min())} max {int(steps[:, 0].max())}, live "
        f"row-steps {row_steps}; rescore max abs err {own_err}"
        + ("; = fused-step at atol 0" if fused else ""))
    out = {"max_abs_err": max_err, "max_rescore_err": own_err,
           "near_tie_flips": flips, "launches_a_call": n_launch,
           "steps_min_max": [int(steps[:, 0].min()), int(steps[:, 0].max())],
           "live_row_steps": row_steps,
           "caption_lengths_min_mean_max": [int(lengths.min()),
                                            lengths.mean().item(),
                                            int(lengths.max())]}
    if not timed:
        return out
    out["ms"] = cuda_ms(lambda: mega_att_beam_decode(
        dec, feats, style, n_img, k=k, **kw), 5)
    out["geometry"] = search_geometry("k7", lambda: mega_att_beam_decode(
        dec, feats, style, n_img, k=k, **kw))
    out["plain_ms"] = cuda_ms(lambda: plain_by_images(
        mega_att_beam_decode_plain, n_img, k, dec, feats, style, **kw), 1)
    flops = (row_steps * att_step_flops_per_row(kind, vocab)
             + n_img * (P * FS + 2 * 2 * FS * H))
    nbytes = (att_weight_bytes(kind, init=True, vocab=vocab)
              + 4 * n_img * P * (FS + A)
              + 4 * row_steps * E + 4 * n_img * (steps_max + 4))
    out["bound_ms"], out["bound_by"] = bound_ms(flops, nbytes)
    return out


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


# --- phase 5d: beam widths 9-256 (the wide paths of K1, K2, K6, K7) ---------

WIDE_KS = (9, 20, 64, 256)   # widths above K_MAX held to the plain versions
WIDE_IMAGES = (1, 64)
# a search's steps at each width: the attention decoders' captions are 6-8
# words long, so 8 steps let them end at k = 256
WIDE_STEPS = {9: STEPS, 20: STEPS, 64: 12, 256: 8}
WIDE_TIMED = (20, 256)       # widths timed for the kernels line
WIDE_FUSED = 20              # K2 = K1 fused-step and K7 = K6 at atol 0
WIDE_MAIN = (8, 20)          # the main path's images and beam (e)
WIDE_SOURCE = "icee_tpu_torch/csrc/wide_topk.cuh"


def wide_steps(sty, att, device):
    """Phase 5d (a): K1 and K6 (both cells) at top-k = rows an image k in
    WIDE_KS, at one image and at 64, against their plain versions as
    phases 4 and 5b hold them (``check_k1``, ``check_k6``: ids exact but
    in a 1e-5 near tie, 1e-4, alpha 1e-5, launches exact); timed at
    WIDE_TIMED.  -> {"k1" | kind: {"max_abs_err", "near_tie_swaps",
    "shapes"}}."""
    import torch

    out = {n: {"max_abs_err": 0.0, "near_tie_swaps": 0, "shapes": {}}
           for n in ("k1", *att)}

    def note(name, err, ties):
        out[name]["max_abs_err"] = max(out[name]["max_abs_err"], err)
        out[name]["near_tie_swaps"] += ties

    for k in WIDE_KS:
        for n_img in WIDE_IMAGES:
            rows, timed = n_img * k, k in WIDE_TIMED
            # calls a timing: fewer at the larger shapes; the library
            # yardstick at every timed shape (K6's broadcast score is 6.6
            # GB at 16,384 rows, its relu as much again: the card holds it)
            n, warm = (50, 5) if rows <= 256 else (20, 2) if rows <= 1280 \
                else (5, 1)
            inputs, err, ties = check_k1(sty, device, rows, 30 + k + n_img,
                                         ktop=k)
            note("k1", err, ties)
            if timed:
                out["k1"]["shapes"][f"k{k}_rows{rows}"] = dict(
                    k1_times(sty, inputs, k, n, warm), k=k,
                    rows=rows)
            del inputs
            for kind, dec in att.items():
                args, err, ties = check_k6(dec, kind, device, n_img,
                                           40 + k + n_img, k=k)
                note(kind, err, ties)
                if timed:
                    out[kind]["shapes"][f"k{k}_rows{rows}"] = dict(
                        k6_times(kind, args, n, max(2, n // 4), warm),
                        k=k, rows=rows)
                del args
            torch.cuda.empty_cache()
    return out


def wide_searches(sty, nic, att, device):
    """Phase 5d (b), (c): K2 (both cells) and K7 (both cells) at beam k in
    WIDE_KS for one image and 64 (WIDE_STEPS[k] steps; at 64 images and k
    above 16 a search is several launches of MAX_ROWS // k images),
    margin-aware against the plain searches as phases 5 and 5c hold them,
    launches exact; at k = WIDE_FUSED also = the fused-step paths (K1, K6)
    at atol 0; timed at WIDE_TIMED.  -> {name: {"max_abs_err",
    "near_tie_flips", "max_rescore_err", "shapes"}}."""
    import torch

    names = {("factored", False): "k2", ("lstm", False): "k2_lstm",
             ("factored", True): "k7", ("lstm", True): "k7_lstm"}
    out = {n: {"max_abs_err": 0.0, "near_tie_flips": 0,
               "max_rescore_err": 0.0, "shapes": {}}
           for n in names.values()}
    for k in WIDE_KS:
        for n_img in WIDE_IMAGES:
            kw = dict(k=k, steps_max=WIDE_STEPS[k], fused=k == WIDE_FUSED,
                      timed=k in WIDE_TIMED)
            for (cell, attends), name in names.items():
                if attends:
                    r = check_k7_shape(att[cell], cell, device, n_img, **kw)
                else:
                    r = check_k2_shape(sty if cell == "factored" else nic,
                                       device, cell, n_img, **kw)
                o = out[name]
                o["max_abs_err"] = max(o["max_abs_err"], r["max_abs_err"])
                o["max_rescore_err"] = max(o["max_rescore_err"],
                                           r["max_rescore_err"])
                o["near_tie_flips"] += r["near_tie_flips"]
                if kw["timed"]:
                    o["shapes"][f"k{k}_images{n_img}"] = dict(
                        r, k=k, images=n_img, steps=WIDE_STEPS[k])
            torch.cuda.empty_cache()
    return out


def check_wide_refusals(sty, nic, att, device):
    """Phase 5d (d): k = V + 1 on the card and on the CPU route: each wide
    wrapper raises the same ValueError on both (the CPU route's, ``k=8193
    outside [1, 8192]``), and launches nothing.  -> the messages."""
    import torch

    from icee_tpu_torch.models import attention as att_mod
    from icee_tpu_torch.ops.att_beam import mega_att_beam_decode
    from icee_tpu_torch.ops.att_decode_step import (att_decode_step_topk,
                                                    step_params)
    from icee_tpu_torch.ops.beam import mega_beam_decode
    from icee_tpu_torch.ops.decode_step import decode_step_topk

    def on(tree, dev):
        return {n: on(t, dev) if isinstance(t, dict) else t.to(dev)
                for n, t in tree.items()}

    over = V + 1
    cases = []
    for dev in (device, torch.device("cpu")):
        z = dict(device=dev)
        x, h = torch.zeros((5, E), **z), torch.zeros((5, H), **z)
        feats = att_features(device, 1, 3).to(dev)
        s_, n_ = on(sty, dev), on(nic, dev)
        route = "card" if dev.type == "cuda" else "cpu"
        cases += [
            ("K1", route, lambda s_=s_, x=x, h=h: decode_step_topk(
                s_, x, h, h, 0, ktop=over)),
            ("K2", route, lambda s_=s_: mega_beam_decode(s_, None, 0, 1,
                                                         k=over)),
            ("K2", route, lambda n_=n_: mega_beam_decode(
                n_, None, 0, 1, k=over, cell="lstm"))]
        for kind, dec in att.items():
            d_ = on(dec, dev)
            cell, at, gate = step_params(d_, kind, 0)
            att1 = att_mod.att_projection(at, feats)
            cases += [
                ("K6", route, lambda c=cell, a=at, g=gate, a1=att1, kd=kind,
                 x=x, h=h, f=feats: att_decode_step_topk(
                     c, a, g, x, h, h, f, a1, kd, 5, ktop=over)),
                ("K7", route, lambda d=d_, kd=kind, f=feats:
                 mega_att_beam_decode(d, f, 0, 1, k=over, kind=kd))]
    fns = (decode_step_topk, mega_beam_decode, att_decode_step_topk,
           mega_att_beam_decode)
    before = [dict(vars(fn)) for fn in fns]
    msgs = {}
    for name, route, call in cases:
        try:
            call()
        except ValueError as e:
            if f"={over} outside [1, {V}]" not in str(e):
                fail(f"phase 5d: k = V + 1 on {name} ({route}) raised {e!r}")
            msgs.setdefault(name, set()).add(str(e))
            continue
        fail(f"phase 5d: k = V + 1 on {name} ({route}) did not raise")
    torch.cuda.synchronize()
    if [dict(vars(fn)) for fn in fns] != before:
        fail("phase 5d: a refused call launched a kernel")
    for name, got in msgs.items():
        # one message a kernel: the card's is the CPU route's
        if len(got) != 1:
            fail(f"phase 5d: k = V + 1 on {name}: the card and the CPU "
                 f"route differ: {sorted(got)}")
    return [m for got in msgs.values() for m in got]


def wide_counters():
    """The wide paths' launch counters and the totals beside them: K1, K2
    (both cells), K6 (both cells), K7 (both cells) and the h0/c0 kernel."""
    from icee_tpu_torch.ops.att_beam import mega_att_beam_decode
    from icee_tpu_torch.ops.att_decode_step import (att_decode_step_topk,
                                                    att_init_state)
    from icee_tpu_torch.ops.beam import mega_beam_decode
    from icee_tpu_torch.ops.decode_step import decode_step_topk

    out = {"att_init_state": (att_init_state, "launches")}
    for fn, name in ((decode_step_topk, "decode_step_topk"),
                     (mega_beam_decode, "mega_beam_decode"),
                     (att_decode_step_topk, "att_decode_step_topk"),
                     (mega_att_beam_decode, "mega_att_beam_decode")):
        for attr in ("launches", "wide_launches", "lstm_launches",
                     "lstm_wide_launches"):
            if hasattr(fn, attr):
                suffix = attr[:-len("launches")].strip("_")
                out[name + ("_" + suffix if suffix else "")] = (fn, attr)
    return out


def wide_main_path(sty, nic, att, device):
    """Phase 5d (e): the main path at beam 20, through the decode entry
    points the serving engine and the CLIs call (``decode/fast.py``): for
    WIDE_MAIN[0] images, StyleNet's whole search and fused-step path, NIC's
    search, and both attention decoders' searches and fused-step paths.
    Every count from 0 just before and read just after: K2 and K7 once a
    search, K1 and K6 once a step of their fused-step paths (the steps the
    whole search runs, taken from it beforehand), the h0/c0 kernel once a
    fused-step attention path, every one of them wide; no plain version;
    each fused-step result = its whole search's at atol 0.  -> the
    counts."""
    import torch

    from icee_tpu_torch.decode.fast import (attention_decode,
                                            factored_decode, nic_att_decode,
                                            nic_decode)
    from icee_tpu_torch.ops.att_beam import mega_att_beam_decode_steps
    from icee_tpu_torch.ops.beam import mega_beam_decode_steps

    n, k = WIDE_MAIN
    g = torch.Generator(device=device).manual_seed(21)
    feats = torch.randn((n, 1, E), generator=g, device=device).expand(
        n, k, E).contiguous()
    spatial = att_features(device, n, 22)
    styles = {"factored": 3, "lstm": 0}
    # the steps each whole search runs: its fused-step path's step calls
    _, st = mega_beam_decode_steps(sty, feats, 2, n, k=k,
                                   max_seq_length=STEPS)
    att_steps = {kind: int(mega_att_beam_decode_steps(
        dec, spatial, styles[kind], n, k=k, max_seq_length=STEPS,
        kind=kind)[1][:, 0].max()) for kind, dec in att.items()}
    counters = wide_counters()
    for fn, attr in counters.values():
        setattr(fn, attr, 0)
    with plain_counters() as plain:
        res = {
            "stylenet": factored_decode("mega", sty, feats, 2, n, k, STEPS,
                                        1, 2),
            "stylenet_fused": factored_decode("fused-step", sty, feats, 2, n,
                                              k, STEPS, 1, 2),
            "nic": nic_decode(nic, feats, n, k, STEPS, 1, 2),
            "stylenet_att": attention_decode("mega", att["factored"],
                                             spatial, 3, n, k, STEPS, 1, 2),
            "stylenet_att_fused": attention_decode(
                "fused-step", att["factored"], spatial, 3, n, k, STEPS, 1,
                2),
            "nic_att": nic_att_decode("mega", att["lstm"], spatial, n, k,
                                      STEPS, 1, 2),
            "nic_att_fused": nic_att_decode("fused-step", att["lstm"],
                                            spatial, n, k, STEPS, 1, 2)}
        torch.cuda.synchronize()
    got = {name: getattr(fn, attr) for name, (fn, attr) in counters.items()}
    if any(plain.values()):
        fail(f"phase 5d (e): a plain version ran on the card: {plain}")
    s1, s6f, s6l = int(st[:, 0].max()), att_steps["factored"], \
        att_steps["lstm"]
    want = {"decode_step_topk": s1, "decode_step_topk_wide": s1,
            "mega_beam_decode": 1, "mega_beam_decode_wide": 1,
            "mega_beam_decode_lstm": 1, "mega_beam_decode_lstm_wide": 1,
            "att_decode_step_topk": s6f, "att_decode_step_topk_wide": s6f,
            "att_decode_step_topk_lstm": s6l,
            "att_decode_step_topk_lstm_wide": s6l,
            "mega_att_beam_decode": 1, "mega_att_beam_decode_wide": 1,
            "mega_att_beam_decode_lstm": 1,
            "mega_att_beam_decode_lstm_wide": 1, "att_init_state": 2}
    if got != want:
        fail(f"phase 5d (e): launches {got}, expected {want}")
    for name in ("stylenet", "stylenet_att", "nic_att"):
        for what in ("tokens", "length", "score"):
            if not torch.equal(getattr(res[name], what),
                               getattr(res[name + "_fused"], what)):
                fail(f"phase 5d (e) {name}: the fused-step path's {what} "
                     "differ from the whole search's (atol 0)")
    lengths = {name: [int(r.length.min()), int(r.length.max())]
               for name, r in res.items()}
    log(f"phase 5d (e): beam {k}, {n} images a variant: launches {got}; "
        f"caption lengths min/max {lengths}; fused-step = whole search at "
        "atol 0")
    return got


def wide_entry(name: str, source: str, replaces: str, fig: dict,
               headline: str, **extra) -> dict:
    """A wide path's entry of the kernels line: the ``headline`` shape's
    figures, every timed shape's under ``shapes``, the errors over every
    checked width and shape, and ``extra``."""
    top = fig["shapes"][headline]
    entry = dict({k: v for k, v in fig.items() if k != "shapes"},
                 name=name, route="cuda", source=source, replaces=replaces,
                 wide_source=WIDE_SOURCE, ms=top["ms"],
                 plain_ms=top["plain_ms"], bound_ms=top["bound_ms"],
                 bound_by=top["bound_by"],
                 library_ms=top.get("library_ms"),
                 headline=headline, shapes=fig["shapes"], **extra)
    if entry["library_ms"] is None:
        entry["library_note"] = "no single PyTorch call computes a beam search"
    return entry


def wide_phase(params, device):
    """Phase 5d: beam widths 9-256 in K1, K2, K6 and K7 (their wide paths,
    ``csrc/wide_topk.cuh``): (a)-(c) against their plain versions, (d) the
    refusal of k = V + 1 on both routes, (e) the main path at beam 20.
    -> (the kernels line's
    wide entries by name, the main path's counts)."""
    sty, nic = params["stylenet"]["decoder"], params["nic"]["decoder"]
    att = {kind: params[v]["decoder"] for kind, v in ATT_KINDS.items()}
    steps = wide_steps(sty, att, device)
    log("phase 5d (a): K1, K6 wide ok; ms (plain, bound, library) "
        + "; ".join(f"{n} {sh}: {f['ms']:.4f} ({f['plain_ms']:.4f}, "
                    f"{f['bound_ms']:.4f}, {f['library_ms']:.4f})"
                    for n, fig in steps.items()
                    for sh, f in fig["shapes"].items()))
    searches = wide_searches(sty, nic, att, device)
    log("phase 5d (b, c): K2, K7 wide ok; ms (plain, bound) " + "; ".join(
        f"{n} {sh}: {f['ms']:.3f} ({f['plain_ms']:.3f}, "
        f"{f['bound_ms']:.3f})" for n, fig in searches.items()
        for sh, f in fig["shapes"].items()))
    msgs = check_wide_refusals(sty, nic, att, device)
    log(f"phase 5d (d): k = V + 1 refused by every wrapper, the card as "
        f"the CPU route: {msgs}")
    counts = wide_main_path(sty, nic, att, device)
    att_step = "icee_tpu/ops/pallas_att_decode.py:201 (kind=\"{}\", k 9-256)"
    att_beam = ("icee_tpu/ops/pallas_att_decode.py:733 (kind=\"{}\"; both "
                "calls, :974 and :907; k 9-256)")
    wide_entry_ = functools.partial(wide_entry,
                                    widths_checked=list(WIDE_KS),
                                    images_checked=list(WIDE_IMAGES))
    entries = {
        "decode_step_topk_wide": wide_entry_(
            "decode_step_topk_wide", "icee_tpu_torch/csrc/decode_step.cu",
            "icee_tpu/ops/pallas_decode.py:261 (ktop 9-256)", steps["k1"],
            "k20_rows1280"),
        "mega_beam_decode_wide": wide_entry_(
            "mega_beam_decode_wide", "icee_tpu_torch/csrc/beam.cu",
            "icee_tpu/ops/pallas_beam.py:350 (k 9-256)", searches["k2"],
            "k20_images64"),
        "mega_beam_decode_lstm_wide": wide_entry_(
            "mega_beam_decode_lstm_wide", "icee_tpu_torch/csrc/beam.cu",
            "icee_tpu/ops/pallas_beam.py:350 (cell=\"lstm\", :129-143; k "
            "9-256)", searches["k2_lstm"], "k20_images64")}
    for kind, sfx in (("factored", ""), ("lstm", "_lstm")):
        entries[f"att_decode_step_topk{sfx}_wide"] = wide_entry_(
            f"att_decode_step_topk{sfx}_wide",
            "icee_tpu_torch/csrc/att_decode_step.cu", att_step.format(kind),
            steps[kind], "k20_rows1280")
        entries[f"mega_att_beam_decode{sfx}_wide"] = wide_entry_(
            f"mega_att_beam_decode{sfx}_wide",
            "icee_tpu_torch/csrc/att_beam.cu", att_beam.format(kind),
            searches["k7" + sfx], "k20_images64")
    for name, entry in entries.items():
        entry["launches"] = counts[name]
    return entries, counts


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
                     f"{got[name + '_tiled']} many-row calls of "
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
               ("planes_ms", ("sb_prepare_kernel",
                              "sg_prepare_groups_kernel")),
               ("recurrence_ms", ("scan_fwd_grid_kernel",
                                  "scan_bwd_grid_kernel",
                                  "scan_fwd_stream_kernel",
                                  "scan_bwd_stream_kernel",
                                  "scan_fwd_tma_kernel",
                                  "scan_bwd_tma_kernel")),
               ("column_sums_ms", ("colsum_kernel",)))


SCAN_TRACE_TRIES = 5       # traces of one call before its groups go unmeasured
TRACE_MARKER = "spin_kernel"   # torch.cuda._sleep's kernel, last in a window


def scan_device_groups(what: str, fn, module):
    """Device time (ms) of one K3, K4 or K8 call ``fn`` by launch group, from
    a profiler trace, with each group's launches; ``module`` is the scan's
    wrapper module (``lstm_scan``, ``nic_scan``, ``senticap_scan``).  Fails
    if the call launched its recurrence other than once, counted by the
    library itself (``icee_scan_recurrence_launches``) and in the trace, or
    ran a ``gemm_f32.cuh`` product (``gemm_kernel``).

    The trace records CUDA activity only, then a marker kernel
    (``torch.cuda._sleep``).  A trace can lose its last records
    (``scripts/probe_scan_profile.py`` on an H100: with CPU activity too,
    87 of 100 traces of a K3 backward lost some on one machine, CUDA alone
    5 of 100, while the library's count and the grid barrier's said every
    call ran its recurrence once): a trace without the marker, or without the
    recurrence's record, is taken again, up to ``SCAN_TRACE_TRIES`` times
    (``trace_retries``).  None where no trace came whole."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    lib = module._library()
    for attempt in range(SCAN_TRACE_TRIES):
        torch.cuda.synchronize()
        before = lib.icee_scan_recurrence_launches()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
        launched = lib.icee_scan_recurrence_launches() - before
        if launched != 1:
            fail(f"{what}: the library launched its recurrence {launched} "
                 "times, expected once")
        events = sorted((e for e in prof.events()
                         if e.device_type == DeviceType.CUDA
                         and not e.is_user_annotation
                         and e.self_device_time_total > 0),
                        key=lambda e: e.time_range.start)
        recurrences = sum(any(f in e.name for f in SCAN_GROUPS[2][1])
                          for e in events)
        if recurrences > 1:
            fail(f"{what}: {recurrences} recurrence launches in the trace, "
                 "expected one")
        if events and TRACE_MARKER in events[-1].name and recurrences == 1:
            break
    else:
        log(f"{what}: {SCAN_TRACE_TRIES} traces lost records; device time "
            "by group not measured")
        return None
    events = events[:-1]
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
    groups["total_ms"] = sum(e.self_device_time_total for e in events) / 1e3
    groups["launches"] = counts
    groups["trace_retries"] = attempt
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
        "K3 forward", lambda: lstm_scan.factored_scan_fwd(p, x), lstm_scan)
    groups_b = scan_device_groups(
        "K3 backward", lambda: lstm_scan.factored_scan_bwd(
            p, x, h_seq, c_seq, dh, saved), lstm_scan)
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
        "K4 forward", lambda: nic_scan.nic_scan_fwd(cell, x), nic_scan)
    groups_b = scan_device_groups(
        "K4 backward", lambda: nic_scan.nic_scan_bwd(cell, x, h_seq, c_seq,
                                                     dh, gates), nic_scan)
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


def check_k5(kind: str, sampled: bool, device, timed: bool = True):
    """Phase 10: K5 forward and backward vs the plain versions at B_ATT x
    T_STEPS, full width.  Forward: h and c atol 1e-4 (float32 sums over up
    to FS + E = 2348 terms in other orders, values O(1)), alpha atol 1e-5;
    the sampled trace margin-aware (k5_trace_check), then the plain scan
    rerun on the kernel's trace.  Backward (the plain backward from the
    kernel forward's outputs): each grad's max abs error <= 1e-3 x its
    largest magnitude, and the same bits on a second run.  -> (forward,
    backward) entries of the kernels line; untimed (``timed`` False), the
    errors alone."""
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
    if not timed:
        return ({"max_abs_err": max(max(errs.values()), alpha_err),
                 "trace_flips": flips},
                {"max_abs_err": abs_err, "max_rel_err": max(rel.values())})

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
                                  lambda: ss.senticap_scan_fwd(w, x), ss)
    groups_b = scan_device_groups("K8 backward", lambda: ss.senticap_scan_bwd(
        w, x, h_seq, c_seq, dh, 5.0, gates), ss)
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


def senticap_first_step(device, kernel, plain, data, batch, params,
                        what: str):
    """One SentiCap base step's loss and grads, the kernel path's steps
    against the plain path's, with the same dropout masks.  Tolerances: the
    loss (a SUM over ~1,700 tokens, ~1.5e4) rtol 1e-5; each grad 1e-3 x its
    largest magnitude + 1e-7.  -> (loss rel err, {name: grad err / max|g|})
    (widths SC_B, SC_T, SC_E, SC_H)."""
    import torch

    g = torch.Generator(device=device).manual_seed(82)
    masks = dict(x_drop=(torch.rand((SC_B, SC_T, SC_E), generator=g,
                                    device=device) < 0.5).float() * 2.0,
                 y_drop=(torch.rand((SC_B, SC_T, SC_H), generator=g,
                                    device=device) < 0.5).float() * 2.0)
    out = {name: steps.grads(params, data, batch, **masks)
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
        fail(f"{what}: SentiCap first step: kernel vs plain loss rel err "
             f"{loss_err}, grad errs {grad_errs}")
    log(f"{what}: first step, kernel vs plain: loss {k_loss:.4f} vs "
        f"{p_loss:.4f}; grad err / max|g| "
        f"{ {k: float(f'{v:.3g}') for k, v in grad_errs.items()} }")
    return loss_err, grad_errs


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

    # (i) one step's loss and grads, kernel path vs plain path
    loss_err, grad_errs = senticap_first_step(
        device, kernel, plain, data, batches[0], fresh(), "phase 13 (i)")

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


def check_neglog2(device):
    """``masked_neglog2_sum_from_hiddens`` (the SentiCap perplexity
    numerator: ``ce_rows`` a chunk, then one elementwise pass) at phase
    13's validation shape, 128 x 22 rows, V = 8800: the kernel path vs the
    same function with the plain row pass, both timed on the card.  No
    single PyTorch call computes it: the ``+ 1e-20`` inside the ``log2``
    (``icee_tpu/ops/chunked_loss.py:188``) is no call's.  -> figures."""
    import torch

    from icee_tpu_torch.ops import chunked_loss as cl

    g = torch.Generator(device=device).manual_seed(131)
    hh = torch.randn((SC_B, SC_T, SC_H), generator=g, device=device)
    w = 0.05 * torch.randn((SC_H, SC_V), generator=g, device=device)
    b = 0.1 * torch.randn((SC_V,), generator=g, device=device)
    y = torch.randint(0, SC_V, (SC_B, SC_T), generator=g, device=device)
    mask = (torch.rand((SC_B, SC_T), generator=g, device=device)
            < 0.8).float()

    def run():
        return cl.masked_neglog2_sum_from_hiddens(hh, w, b, y, mask)

    @contextlib.contextmanager
    def plain_rows():
        kernel = cl.ce_rows
        cl.ce_rows = cl.ce_rows_plain
        try:
            yield
        finally:
            cl.ce_rows = kernel

    with torch.no_grad():
        before = cl.ce_rows.launches
        got = run()
        if cl.ce_rows.launches == before:
            fail("neglog2: the kernel path launched no ce_rows")
        with plain_rows():
            want = run()
        err = abs(got.item() - want.item())
        if not err <= 1e-5 * abs(want.item()):
            fail(f"neglog2: {got.item()} vs the plain row pass's "
                 f"{want.item()}")
        ms = cuda_ms(run, 20)
        with plain_rows():
            plain_ms = cuda_ms(run, 20)
    rows = SC_B * SC_T
    b_ms, b_by = bound_ms(2 * rows * SC_H * SC_V, 4 * rows * SC_V)
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": None,
            "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": err,
            "value": want.item(), "rows": rows, "V": SC_V}


def senticap_decoder(device, vocab: int = SC_V):
    """Seeded base-model weights at the decode regime (over ``vocab``
    words), shaped so beams end at several lengths: Xavier init
    (``model.init_params``) with the head x 60, w_lstm x 1.5, an N(0, 1)
    output bias and +2.5 on STOP (at the plain init every beam runs to
    max_len on near-uniform nll)."""
    import torch

    from icee_tpu_torch.senticap import model

    p = model.init_params(torch.Generator().manual_seed(60), vocab,
                          senticap_conf_full())
    g = torch.Generator().manual_seed(61)
    p["w"] *= 60.0
    p["w_lstm"] *= 1.5
    p["b"] = torch.randn(vocab, generator=g)
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


def k9_margin_check(what: str, got, want, rescored):
    """K9's searches ``got`` against the plain searches ``want`` (scores,
    tokens, lengths), margin-aware as phase 5: each kernel score matches
    its own sequence's plain re-score (``rescored``) within 1e-3 and the
    plain search's within 1e-3, and where tokens differ, the kernel's
    sequence ties the plain winner within 1e-4.  -> (score error, re-score
    error, near-tie flips)."""
    import torch

    max_err, own_err, flips = 0.0, 0.0, 0
    for i in range(got[0].shape[0]):
        gs, ws, rs = got[0][i].item(), want[0][i].item(), rescored[i].item()
        n = int(got[2][i])
        same = n == int(want[2][i]) and torch.equal(got[1][i, :n],
                                                    want[1][i, :n])
        own_err = max(own_err, abs(rs - gs))
        if not abs(rs - gs) <= 1e-3:
            fail(f"{what} image {i}: reported score {gs}, its sequence "
                 f"scores {rs}")
        if not same:
            margin = abs(rs - ws)
            if margin > 1e-4:
                fail(f"{what} image {i}: tokens differ; kernel's sequence "
                     f"scores {rs}, plain winner {ws}, margin {margin}")
            flips += 1
            log(f"{what} image {i}: near-tie flip, margin {margin}")
        max_err = max(max_err, abs(gs - ws))
    if not max_err <= 1e-3:
        fail(f"{what}: score error {max_err} > 1e-3")
    return max_err, own_err, flips


def check_k9(device):
    """Phase 14: K9 vs the plain search at 64 images, beam 20, max_len 20
    (``sb_search_check``), its beams ending at several lengths.  -> the
    kernel's entry of the kernels line."""
    from icee_tpu_torch.ops import senticap_decode as sd

    params = senticap_decoder(device)
    r, v = sb_search_check("K9", False, params, SC_IMAGES, SC_BEAM, 62,
                           True)
    if len(set(r["lengths"])) < 2:
        fail(f"K9: every beam ended at one length {r['lengths'][0]}")
    kw = dict(beam_size=SC_BEAM, max_len=SC_MAXLEN)
    groups = senticap_profile("K9", lambda: sd.mega_senticap_beam_decode(
        params, v, SC_IMAGES, **kw))
    keep = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "bound_tf32x3_ms", "near_tie_flips", "max_rescore_err",
            "lengths")
    return dict({k: r[k] for k in keep}, name="mega_senticap_beam_decode",
                route="cuda", source="icee_tpu_torch/csrc/senticap_beam.cu",
                replaces="icee_tpu/ops/pallas_senticap_decode.py:397",
                device_ms_by_group=groups, library_ms=None,
                library_note="no single PyTorch call computes a beam search")


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


def switched_params(device, base=None, vocab: int = SC_V):
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
        base = {k: v.cpu() for k, v in senticap_decoder("cpu",
                                                        vocab).items()}
    p = switched.init_params(torch.Generator().manual_seed(64), vocab,
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
    """Phase 17: K10 vs its plain search at 64 images, beam 20, max_len 20
    (``sb_search_check``: margin-aware as phase 14, the gate trace within
    1e-5 where tokens agree), its beams ending at several lengths.  -> the
    kernel's entry of the kernels line."""
    from icee_tpu_torch.ops import senticap_switched_decode as ssd

    params = switched_params(device)
    r, v = sb_search_check("K10", True, params, SC_IMAGES, SC_BEAM, 66,
                           True)
    if len(set(r["lengths"])) < 2:
        fail(f"K10: every beam ended at one length {r['lengths'][0]}")
    log(f"K10: gates {r['gate_min_max'][0]:.3f}..{r['gate_min_max'][1]:.3f}")
    kw = dict(beam_size=SC_BEAM, max_len=SC_MAXLEN)
    groups = senticap_profile("K10", lambda: ssd.mega_senticap_switched_decode(
        params, v, SC_IMAGES, **kw))
    keep = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "bound_tf32x3_ms", "near_tie_flips", "max_rescore_err",
            "max_trace_err", "gate_min_max", "lengths")
    return dict({k: r[k] for k in keep},
                name="mega_senticap_switched_decode", route="cuda",
                source="icee_tpu_torch/csrc/senticap_switched_beam.cu",
                replaces="icee_tpu/ops/pallas_senticap_switched_decode.py:241",
                device_ms_by_group=groups, library_ms=None,
                library_note="no single PyTorch call computes a beam search")


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
    """Count every call of the kernels' plain versions (each wrapper calls
    its plain version by module name, on a CPU tensor) while the block
    runs; -> the dict of counts."""
    from icee_tpu_torch.ops import (att_beam, att_decode_step, att_scan,
                                    beam, decode_step)
    from icee_tpu_torch.ops import chunked_loss as cl
    from icee_tpu_torch.ops import lstm_scan, nic_scan
    from icee_tpu_torch.ops import senticap_decode as sd
    from icee_tpu_torch.ops import senticap_scan as ss
    from icee_tpu_torch.ops import senticap_switched_decode as ssd

    targets = [(decode_step, "decode_step_topk_plain"),
               (att_decode_step, "att_decode_step_topk_plain"),
               (ss, "fused_senticap_scan_plain"),
               (ss, "senticap_scan_bwd_plain"),
               (cl, "mixture_ce_rows_plain"),
               (sd, "mega_senticap_beam_decode_plain"),
               (ssd, "mega_senticap_switched_decode_plain"),
               (lstm_scan, "fused_factored_scan_plain"),
               (lstm_scan, "factored_scan_bwd_plain"),
               (nic_scan, "fused_nic_scan_plain"),
               (nic_scan, "nic_scan_bwd_plain"),
               (cl, "ce_rows_plain"), (cl, "ce_grad_rows_plain"),
               (beam, "mega_beam_decode_plain"),
               (att_beam, "mega_att_beam_decode_plain"),
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


def expect_launches(what: str, got: dict, want: dict, phase: int = 18):
    """Every listed count exactly as expected, every other count 0."""
    for name, n in got.items():
        if n != want.get(name, 0):
            fail(f"phase {phase} {what}: {name} launched {n} times, "
                 f"expected {want.get(name, 0)} (all counts {got})")


def metrics_events(tmp: str):
    with open(os.path.join(tmp, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def clone_tree(tree):
    if isinstance(tree, dict):
        return {k: clone_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(clone_tree(v) for v in tree)
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


# --- phase 19: the CLIs and the serving entry point (slice 3b) ---------------

# phase 18's caption language as files: 500 training images x 5 captions,
# each word w4 .. w{V-1} in them at least once (so build_vocab --threshold 1
# gives V); validation and emotion captions over the same images.  No count
# is a multiple of its batch, so every stage runs a padded last batch
CLI_IMAGES = 500
CLI_VAL_IMAGES, CLI_EMO_IMAGES, CLI_EMO_VAL_IMAGES = 60, 190, 20
# the augmenting train stage's corpus: the backbone runs once a caption
CLI_AUG_IMAGES, CLI_AUG_EMO_IMAGES = 24, 12
CLI_BATCH = 64             # train / evaluate / caption_batch batches (the default)
CLI_EPOCHS = 1
CLI_PROGRESS = 4           # train_resident: a progress record every 4 batches
CLI_TIMEOUT_S = 600
CLI_STYLE = "sad"          # the seeded checkpoint's mode
CLI_WIDE_BEAM = 20         # caption_batch at a beam above K_MAX (K2 wide)
CLI_SCAN_BEAM = 300        # ... above K_WIDE (survivors in device memory)
ROOT = os.path.dirname(os.path.abspath(__file__))

# Each stage runs as ``python -c CLI_WRAPPER '{"module": ..., "ratio": ...}'
# args...``: the wrapper imports torch (``import_s``), starts CUDA
# (``cuda_init_s``), imports this script and the port's kernel modules that
# hold the counters (``setup_s``; a CLI imports most of them itself), runs
# the CLI module as ``__main__`` (runpy; ``run_s``) and prints one JSON line
# of the port's launch counters and these clocks.  ``ratio`` replaces the
# teacher-forcing ratio of ``cli.common.train_config`` (no CLI flag sets
# it, in either package).  SIGTERM ends a server stage as an exit.  With
# ``counts_path`` the line goes to ``<counts_path><RANK>.json`` instead
# (phase 23's ranks share one stdout, whose long writes interleave).
CLI_WRAPPER = r"""
import json, os, runpy, signal, sys, time
t0 = time.perf_counter()
import torch
t1 = time.perf_counter()
torch.zeros(1, device="cuda")
torch.cuda.synchronize()
t2 = time.perf_counter()
import chip_smoke as cs
opts = json.loads(sys.argv[1])
if opts.get("ratio") is not None:
    import dataclasses
    from icee_tpu_torch.cli import common
    make = common.train_config
    common.train_config = lambda args: dataclasses.replace(
        make(args), teacher_forcing_ratio=opts["ratio"])
counters = cs.cli_counters()
for fn, attr in counters.values():
    setattr(fn, attr, 0)
signal.signal(signal.SIGTERM, lambda *a: sys.exit(0))
sys.argv = [opts["module"]] + sys.argv[2:]
code = 0
with cs.plain_counters() as plain:
    t3 = time.perf_counter()
    try:
        runpy.run_module(opts["module"], run_name="__main__")
    except SystemExit as e:
        code = e.code
    torch.cuda.synchronize()
t4 = time.perf_counter()
rank = int(os.environ.get("RANK", 0))
line = json.dumps({"cli_stage": {
    "rank": rank,
    "counts": {k: getattr(fn, a) for k, (fn, a) in counters.items()},
    "plain": dict(plain), "import_s": t1 - t0, "cuda_init_s": t2 - t1,
    "setup_s": t3 - t2, "run_s": t4 - t3}})
if opts.get("counts_path"):
    with open(f"{opts['counts_path']}{rank}.json", "w") as f:
        f.write(line)
else:
    print(line, flush=True)
sys.exit(code)
"""


def cli_counters():
    """The CLI stages' launch counters (phases 19, 21, 22): phase 18's (K3,
    K4, K5, the CE row passes, K2), K7 (both kinds), the wide paths of K2
    and K7 (a beam above K_MAX) and the SentiCap kernels (K8, the mixture
    CE's forward, K9, K10)."""
    from icee_tpu_torch.ops import att_beam
    from icee_tpu_torch.ops import chunked_loss as cl
    from icee_tpu_torch.ops import senticap_decode as sd
    from icee_tpu_torch.ops import senticap_scan as ss
    from icee_tpu_torch.ops import senticap_switched_decode as ssd

    out = trainer_counters()
    out["mega_att_beam_decode"] = (att_beam.mega_att_beam_decode,
                                   "launches")
    out["mega_att_beam_decode_lstm"] = (att_beam.mega_att_beam_decode,
                                        "lstm_launches")
    for name in ("mega_beam_decode", "mega_att_beam_decode"):
        for pre in ("", "lstm_"):
            fn = out[name][0]
            out[f"{name}_{pre}wide"] = (fn, pre + "wide_launches")
    out.update({
        "fused_senticap_scan_fwd": (ss.senticap_scan_fwd, "launches"),
        "fused_senticap_scan_bwd": (ss.senticap_scan_bwd, "launches"),
        "mixture_ce_rows": (cl.mixture_ce_rows, "launches"),
        "mega_senticap_beam_decode": (sd.mega_senticap_beam_decode,
                                      "launches"),
        "mega_senticap_switched_decode": (
            ssd.mega_senticap_switched_decode, "launches")})
    return out


def cli_files(root: str) -> dict:
    """The caption files and synthetic JPEGs (256 px, smooth) of phase 19's
    corpus under ``root``; -> their paths."""
    import numpy as np
    import torch
    from PIL import Image

    img_dir = os.path.join(root, "img")
    os.makedirs(img_dir)
    rng = np.random.default_rng(190)
    for i in range(CLI_IMAGES):
        small = rng.integers(0, 256, (16, 16, 3), dtype=np.uint8)
        Image.fromarray(small, "RGB").resize((256, 256), Image.BILINEAR).save(
            os.path.join(img_dir, f"t{i}.jpg"), quality=90)
    # every word of the vocabulary, spread over the training captions
    rare = (4 + torch.randperm(V - 4, generator=torch.Generator()
                               .manual_seed(191))).tolist()

    def write(name, examples, extra=False):
        path = os.path.join(root, name)
        seen = {}
        with open(path, "w") as f:
            for c, e in enumerate(examples):
                ids = e.caption_ids[1:-1]
                if extra:
                    ids = ids + rare[c::len(examples)]
                j = seen[e.image] = seen.get(e.image, -1) + 1
                f.write(f"{e.image}.jpg#{j}\t"
                        + " ".join(f"w{i}" for i in ids) + "\n")
        return path

    def over(images, seed, first=0):
        ex = trainer_corpus(images, TR_CAPS, seed, "t")
        for e in ex:   # image names t{first} .. : the training images
            e.image = f"t{int(e.image[1:]) + first}"
        return ex

    return {
        "img": img_dir,
        "train": write("train.txt", trainer_corpus(CLI_IMAGES, TR_CAPS, 180,
                                                   "t"), extra=True),
        "val": write("val.txt", over(CLI_VAL_IMAGES, 181)),
        "happy": write("happy.txt", over(CLI_EMO_IMAGES, 182)),
        "val_happy": write("val_happy.txt", over(CLI_EMO_VAL_IMAGES, 183,
                                                 CLI_EMO_IMAGES)),
        "train_aug": write("train_aug.txt", over(CLI_AUG_IMAGES, 184)),
        "happy_aug": write("happy_aug.txt", over(CLI_AUG_EMO_IMAGES, 185)),
    }


GATES, STYLES = ("i", "f", "o", "c"), ("f", "happy_", "sad_", "angry_")


def reference_decoder_state_dict(dec) -> dict:
    """The port's FactoredLSTM tree -> the reference ``DecoderFactoredLSTM``
    state dict (the inverse of ``checkpoint/torch_import.py``'s importer),
    CPU tensors."""
    f, h = dec["U_w"].shape[1], dec["W_w"].shape[0]
    sd = {"B.weight": dec["B"], "C.weight": dec["C_w"].T,
          "C.bias": dec["C_b"]}
    for g, name in enumerate(GATES):
        sd[f"V_{name}.weight"] = dec["V_w"][:, g * f:(g + 1) * f].T
        sd[f"V_{name}.bias"] = dec["V_b"][g]
        sd[f"U_{name}.weight"] = dec["U_w"][g].T
        sd[f"U_{name}.bias"] = dec["U_b"][g]
        sd[f"W_{name}.weight"] = dec["W_w"][:, g * h:(g + 1) * h].T
        sd[f"W_{name}.bias"] = dec["W_b"][g]
        for s, sp in enumerate(STYLES):
            sd[f"S_{sp}{name}.weight"] = dec["S_w"][s, g].T
            sd[f"S_{sp}{name}.bias"] = dec["S_b"][s, g]
    return {k: v.detach().cpu().contiguous() for k, v in sd.items()}


def reference_head_state_dict(head) -> dict:
    """The port's encoder head -> the reference ``EncoderCNN``'s
    ``linear.*`` and ``bn.*`` entries, CPU tensors."""
    sd = {"linear.weight": head["linear_w"].T,
          "linear.bias": head["linear_b"],
          **{f"bn.{k}": v for k, v in head["bn"].items()}}
    return {k: v.detach().cpu().contiguous() for k, v in sd.items()}


def resnet_state_dict(backbone) -> dict:
    """The port's HWIO ResNet-152 tree -> numpy arrays in torchvision's
    state-dict names (OIHW), the inverse of
    ``models/resnet.py::import_torch_state_dict``."""

    def conv(w):
        return w.permute(3, 2, 0, 1).contiguous().cpu().numpy()

    def bn(prefix, p):
        return {f"{prefix}.{k}": v.cpu().numpy() for k, v in p.items()}

    sd = {"conv1.weight": conv(backbone["conv1"]),
          **bn("bn1", backbone["bn1"])}
    for li in range(1, 5):
        for bi, p in enumerate(backbone[f"layer{li}"]):
            pre = f"layer{li}.{bi}"
            for j in (1, 2, 3):
                sd[f"{pre}.conv{j}.weight"] = conv(p[f"conv{j}"])
                sd.update(bn(f"{pre}.bn{j}", p[f"bn{j}"]))
            if "downsample_conv" in p:
                sd[f"{pre}.downsample.0.weight"] = conv(p["downsample_conv"])
                sd.update(bn(f"{pre}.downsample.1", p["downsample_bn"]))
    return sd


def seeded_decode_weights(params, feats: dict):
    """Phase 6's seeded StyleNet decoder and encoder head
    (``captioning_params``), the head's BatchNorm running statistics those
    of ``feats``, the cached features of phase 19's images: each image's
    step-1 feature is then O(1) about the images' mean, and images get
    captions of their own.  (The trained checkpoint, fitted to captions
    that do not depend on the image, gives one caption to every image, so
    it could not show a feature put in another image's row.)  -> (dec,
    head)."""
    import numpy as np
    import torch

    src = params["stylenet"]["head"]
    pooled = torch.from_numpy(np.stack([feats[n] for n in sorted(feats)]))
    with torch.no_grad():
        z = pooled.to(src["linear_w"].device) @ src["linear_w"] \
            + src["linear_b"]
    head = {"linear_w": src["linear_w"], "linear_b": src["linear_b"],
            "bn": {**src["bn"], "running_mean": z.mean(0),
                   "running_var": z.var(0, unbiased=False)}}
    return params["stylenet"]["decoder"], head


def flat_tree(tree, prefix: str = "") -> dict:
    """A tensor tree (dicts and lists) -> {path: the tensor's bytes and
    shape}, to compare two trees whatever their key order."""
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items()
                for k, v in flat_tree(sub, f"{prefix}/{key}").items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, sub in enumerate(tree)
                for k, v in flat_tree(sub, f"{prefix}/{i}").items()}
    t = tree.detach().cpu().contiguous()
    return {prefix: (str(t.dtype), tuple(t.shape), t.numpy().tobytes())}


def cli_env() -> dict:
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("CHECKPOINT_PATH_") and k not in (
               "VOCAB_PATH", "RESNET_WEIGHTS", "BACKBONE_DTYPE",
               "BATCH_WINDOW_MS", "IMAGE_FOLDER")}
    env["PYTHONPATH"] = ROOT + (os.pathsep + env["PYTHONPATH"]
                                if env.get("PYTHONPATH") else "")
    return env


def cli_cmd(module: str, args, ratio=None):
    return [sys.executable, "-c", CLI_WRAPPER,
            json.dumps({"module": module, "ratio": ratio}), *map(str, args)]


def cli_record(name: str, out: str, want: dict, wall: float, logs: str,
               phase: int = 19):
    """The wrapper's JSON line from a stage's output, its counts held to
    ``want`` (every other count 0, no plain version) -> (stats, counts)."""
    lines = [ln for ln in out.splitlines() if ln.startswith('{"cli_stage"')]
    if not lines:
        fail(f"phase {phase} {name}: no counter line (output in {logs})")
    rec = json.loads(lines[-1])["cli_stage"]
    if any(rec["plain"].values()):
        fail(f"phase {phase} {name}: a plain version ran on the card: "
             f"{rec['plain']}")
    for k, n in rec["counts"].items():
        if n != want.get(k, 0):
            fail(f"phase {phase} {name}: {k} launched {n} times, expected "
                 f"{want.get(k, 0)} (all counts {rec['counts']})")
    stats = {"wall_s": wall, **{k: rec[k] for k in (
        "import_s", "cuda_init_s", "setup_s", "run_s")}}
    return stats, rec["counts"]


def cli_stage(name: str, module: str, args, logs: str, want: dict,
              ratio=None, phase: int = 19):
    """One CLI as its own process; it must exit 0 and launch ``want``.
    -> (stats, counts, stdout)."""
    t = time.perf_counter()
    proc = subprocess.run(cli_cmd(module, args, ratio), cwd=ROOT,
                          env=cli_env(), capture_output=True, text=True,
                          timeout=CLI_TIMEOUT_S)
    wall = time.perf_counter() - t
    log_path = os.path.join(logs, f"{name}.log")
    with open(log_path, "w") as f:
        f.write(proc.stdout + "\n--- stderr ---\n" + proc.stderr)
    if proc.returncode != 0:
        fail(f"phase {phase} {name}: exit {proc.returncode}: "
             f"{proc.stderr[-3000:]}")
    stats, counts = cli_record(name, proc.stdout, want, wall, log_path,
                               phase)
    log(f"phase {phase} {name}: {wall:.2f} s (import torch "
        f"{stats['import_s']:.2f} s, CUDA start-up {stats['cuda_init_s']:.2f}"
        f" s, counters {stats['setup_s']:.2f} s, run {stats['run_s']:.2f} "
        f"s); launches { {k: n for k, n in counts.items() if n} }")
    return stats, counts, proc.stdout


def bleu_lines(out: str):
    return [float(ln.split()[1]) for ln in out.splitlines()
            if ln.startswith("BLEU-")]


def cli_searches(dec, head, feats: dict, names, style: int, vocab, device,
                 k: int = K):
    """Each image's search at beam ``k`` in this process, its cached
    feature taken by name and put through ``head``: K2 over ``names`` in
    batches of CLI_BATCH (zero rows pad the last), and the plain search
    over all of them (MAX_ROWS // k images at a time).  -> (features (n,
    k, E), kernel result, plain result, the plain model's score of each
    kernel sequence), rows in ``names`` order."""
    import numpy as np
    import torch

    from icee_tpu_torch.decode.beam import BeamResult
    from icee_tpu_torch.decode.fast import factored_decode
    from icee_tpu_torch.models.encoder import encode_global_from_pooled
    from icee_tpu_torch.ops.beam import mega_beam_decode_plain

    xs, parts = [], []
    with torch.no_grad():
        for i in range(0, len(names), CLI_BATCH):
            chunk = names[i:i + CLI_BATCH]
            x = encode_global_from_pooled(head, torch.from_numpy(np.stack(
                [feats[n] for n in chunk])).to(device))
            xs.append(x)
            x = torch.cat([x, x.new_zeros((CLI_BATCH - len(chunk), E))])
            res = factored_decode(
                "mega", dec, x[:, None, :].expand(CLI_BATCH, k, E)
                .contiguous(), style, CLI_BATCH, k, STEPS, vocab.start,
                vocab.end)
            parts.append([t[:len(chunk)] for t in res])
        kern = BeamResult(*(torch.cat(ts) for ts in zip(*parts)))
        n = len(names)
        tiled = torch.cat(xs)[:, None, :].expand(n, k, E).contiguous()
        plain = plain_by_images(mega_beam_decode_plain, n, k, dec, tiled,
                                style, start_token=vocab.start,
                                end_token=vocab.end, max_seq_length=STEPS)
        rescored = sequence_scores(dec, "factored", tiled, style,
                                   kern.tokens, kern.length)
    return tiled, kern, plain, rescored


def check_cli_captions(got: dict, names, kern, plain, rescored, vocab):
    """``caption_batch``'s JSON against this process's searches of the same
    images: each image's caption the detokenized K2 sequence of its own
    feature (so a feature decoded in another image's row, or dropped,
    fails), the K2 sequences margin-aware (phase 5's rule) against the
    plain search's, and most images with a caption of their own.  -> (near-
    tie flips, distinct captions)."""
    want = {}
    for i, name in enumerate(names):
        words = vocab.decode(kern.tokens[i, :int(kern.length[i])].tolist())
        while words and words[-1] == "<unk>":
            words.pop()
        want[name] = " ".join(words)
    if sorted(got) != list(names):
        fail(f"phase 19 caption_batch: {len(got)} captions for "
             f"{len(names)} images")
    bad = [n for n in names if got[n] != want[n]]
    if bad:
        fail(f"phase 19 caption_batch: {len(bad)} captions differ from "
             f"their image's search (first {bad[0]}: {got[bad[0]]!r} vs "
             f"{want[bad[0]]!r})")
    distinct = len(set(got.values()))
    if distinct < len(names) // 2:
        fail(f"phase 19 caption_batch: {distinct} distinct captions of "
             f"{len(names)}: the check cannot see a row mix-up")
    _, _, flips = margin_check("phase 19 caption_batch", kern, plain,
                               rescored)
    return flips, distinct


def check_eval_lines(what: str, out: str, dataset, row: dict, tiled, plain,
                     dec, style: int, vocab):
    """``evaluate``'s printed predictions, line by line, against the plain
    search of that line's image (``row``: image -> row of ``plain``): equal,
    or a near tie (the printed sequence scores within 1e-4 of the plain
    winner under the plain model).  -> near-tie flips."""
    import torch

    preds = [ln.split()[1:] for ln in out.splitlines()
             if ln.startswith("pred ")]
    if len(preds) != len(dataset):
        fail(f"{what}: {len(preds)} predictions for {len(dataset)} lines")
    flips = 0
    for j, (ex, words) in enumerate(zip(dataset, preds)):
        r = row[ex.image]
        want = plain.tokens[r, :int(plain.length[r])].tolist()
        ids = [vocab.word2idx[w] for w in words]
        if ids == want:
            continue
        toks = torch.full((1, plain.tokens.shape[1]), vocab.end,
                          dtype=plain.tokens.dtype, device=tiled.device)
        toks[0, :len(ids)] = torch.tensor(ids, dtype=toks.dtype)
        with torch.no_grad():
            score = sequence_scores(dec, "factored", tiled[r:r + 1], style,
                                    toks, torch.tensor([len(ids)],
                                                       device=tiled.device))
        margin = abs(score.item() - plain.score[r].item())
        if len(ids) <= 1 or margin > 1e-4:
            fail(f"{what}, line {j} ({ex.image}): predicted {words}, the "
                 f"plain search {vocab.decode(want, False)}; margin "
                 f"{margin} > 1e-4")
        flips += 1
        log(f"{what}, line {j}: near-tie flip, margin {margin}")
    return flips


def cli_phase(device, keep: str = None):
    """Phase 19: the demo's stages as processes on the card, at flagship
    width (E = 300, H = F = 512, 40 steps, k = 5, V = 8192), with phase
    6's seeded weights made anew: the backbone for every image stage, the
    StyleNet decoder and head for the decode stages.  ``keep``: a
    directory that receives the vocabulary, the feature caches, the caption
    files (phase 22 trains seq2seq on them), the seeded backbone (phase 27
    encodes its grids with it), the ``train`` stage's log and checkpoint
    and the ``evaluate`` stages' outputs (phase 23 holds its multi-rank
    runs to them)."""
    import numpy as np
    import torch

    from icee_tpu_torch.checkpoint.ckpt import load_checkpoint, load_params
    from icee_tpu_torch.cli.evaluate import evaluate
    from icee_tpu_torch.cli.sample import caption_image
    from icee_tpu_torch.core.config import DecoderConfig, mode_id
    from icee_tpu_torch.data.captions import load_caption_dataset
    from icee_tpu_torch.data.transforms import host_decode_resize, normalize
    from icee_tpu_torch.data.vocab import load_vocab
    from icee_tpu_torch.models import resnet
    from icee_tpu_torch.models.encoder import encode_global_from_pooled
    from icee_tpu_torch.ops import chunked_loss as cl
    from icee_tpu_torch.ops.beam import launch_chunks

    from icee_tpu_torch import native
    from icee_tpu_torch.native import imagedec

    stats, launches = {}, {}
    m = "icee_tpu_torch.cli."
    params = captioning_params(device)
    # the host-side C++ libraries (g++ at first use; NumPy / PIL otherwise)
    stats["native_available"] = {"batcher": native.native_available(),
                                 "imagedec": imagedec.native_available()}
    log(f"phase 19: native libraries built: {stats['native_available']}")
    cfg = DecoderConfig(vocab_size=V, embed_size=E, hidden_size=H,
                        factored_size=F, max_seq_length=STEPS)
    t_cap = STEPS + 2

    def add(counts):
        for k, n in counts.items():
            launches[k] = launches.get(k, 0) + n

    def ce_launches(*steps):
        """The CE row passes of ``(steps, batch)`` pairs of training
        steps: one launch a time chunk."""
        return sum(n * -(-t_cap // cl.auto_t_chunk(b, t_cap))
                   for n, b in steps)

    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        files = cli_files(root)
        # phase 6's seeded backbone (residual branches damped), in
        # torchvision's names, for every stage that runs the backbone
        backbone = os.path.join(root, "resnet152.npz")
        np.savez(backbone, **resnet_state_dict(params["backbone"]))
        stats["corpus_s"] = time.perf_counter() - t0
        logs = os.path.join(root, "logs")
        os.makedirs(logs)
        vocab_path = os.path.join(root, "vocab.pkl")
        cache = os.path.join(root, "features.npz")
        models = os.path.join(root, "models")

        def stage(name, module, args, want=None, ratio=None):
            st, counts, out = cli_stage(name, module, args, logs, want or {},
                                        ratio)
            stats[name] = st
            add(counts)
            return out

        def train_args(caps, happy, epochs, model_dir, name, source):
            return [
                "--trainer", "multitask", "--family", "stylenet", "--mode",
                "happy", "--vocab_path", vocab_path, "--caption_path", caps,
                "--val_caption_path", files["val"], "--happy_path", happy,
                "--val_happy_path", files["val_happy"], *source,
                "--num_epochs", epochs, "--caption_batch_size", CLI_BATCH,
                "--language_batch_size", B_EMOTION, "--model_path",
                model_dir, "--log_path", os.path.join(root, f"{name}.log"),
                "--metrics_path", os.path.join(root, f"{name}.jsonl"),
                "--data_name", name, "--log_step", 10 ** 9,
                "--log_step_emotion", 10 ** 9]

        def train_events(name, epochs):
            with open(os.path.join(root, f"{name}.jsonl")) as f:
                events = [json.loads(line) for line in f]
            losses = [e["train_loss"] for e in events
                      if e["event"] == "epoch_factual"]
            if len(events) != 2 * epochs or len(losses) != epochs or not all(
                    np.isfinite(x) for x in losses):
                fail(f"phase 19 {name}: events {events}")
            return events, losses

        # 1/6 the vocabulary
        stage("build_vocab", m + "build_vocab", [
            "--caption_path", files["train"], "--vocab_path", vocab_path,
            "--threshold", 1])
        vocab = load_vocab(vocab_path)
        if len(vocab) != V:
            fail(f"phase 19: build_vocab gave {len(vocab)} words, not {V}")
        # 2/6 the feature cache: ResNet-152 at 224 on the card, batch 32
        stage("precompute_features", m + "precompute_features", [
            "--caption_path", files["train"], "--image_dir", files["img"],
            "--out", cache, "--batch_size", 32, "--resnet_weights",
            backbone])
        stats["precompute_features"]["images_per_s"] = \
            CLI_IMAGES / stats["precompute_features"]["wall_s"]
        with np.load(cache) as f:
            feats = dict(f)
        names = sorted(feats)
        if len(names) != CLI_IMAGES:
            fail(f"phase 19 precompute_features: {len(names)} features")
        # 3/6 (i) an epoch of the multitask regime on the feature cache
        # at ratio 1.0, so that every step takes the teacher-forced path
        # (K3)
        n_fac = -(-CLI_IMAGES * TR_CAPS // CLI_BATCH)
        n_emo = -(-CLI_EMO_IMAGES * TR_CAPS // B_EMOTION)
        ce = CLI_EPOCHS * ce_launches((n_fac, CLI_BATCH), (n_emo, B_EMOTION))
        steps = CLI_EPOCHS * (n_fac + n_emo)
        stage("train", m + "train", train_args(
            files["train"], files["happy"], CLI_EPOCHS, models, "chip",
            ["--feature_cache", cache]),
            {"fused_factored_scan_fwd": steps,
             "fused_factored_scan_bwd": steps, "ce_rows": ce,
             "ce_grad_rows": ce, "mega_beam_decode": 2 * CLI_EPOCHS},
            ratio=1.0)
        events, losses = train_events("chip", CLI_EPOCHS)
        written = sorted(os.listdir(models))
        best = os.path.join(models, "HAP_BEST_checkpoint_chip")
        if not os.path.isdir(best):
            best = os.path.join(models, "HAP_checkpoint_chip")
        stats["train"].update(
            steps=steps, train_loss=losses, checkpoints=written,
            bleu4=[e["bleu4"] for e in events],
            served_checkpoint=os.path.basename(best),
            captions_per_s=CLI_EPOCHS * (CLI_IMAGES + CLI_EMO_IMAGES)
            * TR_CAPS / stats["train"]["wall_s"])
        # 3/6 (i') the same run with the splits on the card and a progress
        # record every CLI_PROGRESS batches: the same final checkpoint, bit
        # for bit (the same seed, cache and ratio)
        resident = os.path.join(root, "models_resident")
        stage("train_resident", m + "train", train_args(
            files["train"], files["happy"], CLI_EPOCHS, resident, "chipres",
            ["--feature_cache", cache, "--device_resident",
             "--progress_chunk", CLI_PROGRESS]),
            {"fused_factored_scan_fwd": steps,
             "fused_factored_scan_bwd": steps, "ce_rows": ce,
             "ce_grad_rows": ce, "mega_beam_decode": 2 * CLI_EPOCHS},
            ratio=1.0)
        res_events, res_losses = train_events("chipres", CLI_EPOCHS)
        res_written = sorted(os.listdir(resident))
        same = [n.replace("chipres", "chip") for n in res_written] == written
        for name in written if same else []:
            same = same and saved_equal(
                load_checkpoint(os.path.join(models, name)),
                load_checkpoint(os.path.join(
                    resident, name.replace("_chip", "_chipres"))))
        if not same or [{k: v for k, v in e.items() if k != "t"}
                        for e in res_events] != [
                            {k: v for k, v in e.items() if k != "t"}
                            for e in events]:
            fail(f"phase 19 train_resident: checkpoints {res_written} or "
                 "their contents or events differ from the train stage's")
        stats["train_resident"].update(
            steps=steps, train_loss=res_losses, checkpoints=res_written,
            equal_to_train=True, captions_per_s=CLI_EPOCHS * (
                CLI_IMAGES + CLI_EMO_IMAGES) * TR_CAPS
            / stats["train_resident"]["wall_s"])
        # 3/6 (ii) one epoch as a user runs it: the default ratio (0.8:
        # the scheduled-sampling loop, the chunked CE, no K3) and the
        # backbone over --image_dir on a fresh crop and flip each call
        n_fac = -(-CLI_AUG_IMAGES * TR_CAPS // CLI_BATCH)
        n_emo = -(-CLI_AUG_EMO_IMAGES * TR_CAPS // B_EMOTION)
        ce = ce_launches((n_fac, CLI_BATCH), (n_emo, B_EMOTION))
        stage("train_augment", m + "train", train_args(
            files["train_aug"], files["happy_aug"], 1,
            os.path.join(root, "models_aug"), "aug",
            ["--image_dir", files["img"], "--resnet_weights", backbone]),
            {"ce_rows": ce, "ce_grad_rows": ce, "mega_beam_decode": 2})
        _, aug_losses = train_events("aug", 1)
        stats["train_augment"].update(
            steps=n_fac + n_emo, train_loss=aug_losses,
            augmented_captions=(CLI_AUG_IMAGES + CLI_AUG_EMO_IMAGES)
            * TR_CAPS)
        # the seeded decoder as the reference's torch checkpoints, turned
        # into a port checkpoint by the export CLI
        dec, head = seeded_decode_weights(params, feats)
        dec_pth = os.path.join(root, "decoder.pth")
        enc_pth = os.path.join(root, "encoder.pth")
        torch.save(reference_decoder_state_dict(dec), dec_pth)
        torch.save(reference_head_state_dict(head), enc_pth)
        style = mode_id(CLI_STYLE)
        tag = CLI_STYLE.upper()[:3]
        stage("export", m + "export", [
            "--decoder_path", dec_pth, "--encoder_path", enc_pth,
            "--vocab_path", vocab_path, "--out_dir", os.path.join(
                root, "seeded"), "--data_name", "seeded", "--mode",
            CLI_STYLE])
        seeded = os.path.join(root, "seeded", f"{tag}_checkpoint_seeded")
        exported = load_params(seeded, device)
        if flat_tree(exported) != flat_tree({"decoder": dec, "head": head}):
            fail("phase 19 export: the checkpoint's params are not the "
                 "exported ones")
        tiled, kern, plain, rescored = cli_searches(dec, head, feats, names,
                                                    style, vocab, device)
        row = {n: i for i, n in enumerate(names)}
        # 4/6 BLEU over the validation captions: research semantics on the
        # trained checkpoint (the feature never fed), serving semantics on
        # the seeded one, whose lines are held to their images' searches
        n_val = CLI_VAL_IMAGES * TR_CAPS
        dataset = load_caption_dataset(files["val"], vocab)
        common = ["--vocab_path", vocab_path, "--feature_cache", cache,
                  "--batch_size", CLI_BATCH]
        trained = load_params(best, device)
        outs = {}
        for name, path, mode, extra in (
                ("evaluate", best, "happy", []),
                ("evaluate_feed_feature", seeded, CLI_STYLE,
                 ["--feed_feature"])):
            out = outs[name] = stage(name, m + "evaluate", common + [
                "--checkpoint_path", path, "--test_path", files["val"],
                "--mode", mode, *extra],
                {"mega_beam_decode": -(-n_val // CLI_BATCH)})
            got = bleu_lines(out)
            w = exported if extra else trained
            want = evaluate(w["decoder"], w["head"], cfg, vocab, dataset,
                            feats.__getitem__, mode_id(mode),
                            batch_size=CLI_BATCH, k=K, print_pairs=False,
                            feed_feature=bool(extra), device=device)
            if got != list(want):
                fail(f"phase 19 {name}: BLEU {got} != the in-process "
                     f"evaluate()'s {list(want)}")
            stats[name].update(bleu=got,
                               captions_per_s=n_val / stats[name]["wall_s"])
        stats["evaluate_feed_feature"]["near_tie_flips"] = check_eval_lines(
            "phase 19 evaluate --feed_feature",
            outs["evaluate_feed_feature"], dataset, row, tiled,
            plain, dec, style, vocab)
        # every image of the directory, serving semantics
        captions = os.path.join(root, "captions.json")
        seeded_args = ["--vocab_path", vocab_path, "--feature_cache", cache,
                       "--checkpoint_path", seeded, "--mode", CLI_STYLE,
                       "--batch_size", CLI_BATCH]
        stage("caption_batch", m + "caption_batch", seeded_args + [
            "--image_dir", files["img"], "--out", captions],
            {"mega_beam_decode": -(-CLI_IMAGES // CLI_BATCH)})
        with open(captions) as f:
            got = json.load(f)
        flips, distinct = check_cli_captions(got, names, kern, plain,
                                             rescored, vocab)
        stats["caption_batch"].update(
            near_tie_flips=flips, distinct_captions=distinct,
            captions_per_s=CLI_IMAGES / stats["caption_batch"]["wall_s"])
        # a beam above K_MAX takes K2's wide path: every image's caption
        # that of this process's search at that beam, margin-aware against
        # the plain search's; one launch a MAX_ROWS // k images of a batch
        wide = f"caption_batch_beam_{CLI_WIDE_BEAM}"
        n_wide = -(-CLI_IMAGES // CLI_BATCH) * len(
            launch_chunks(CLI_BATCH, CLI_WIDE_BEAM))
        stage(wide, m + "caption_batch", seeded_args + [
            "--image_dir", files["img"], "--out", os.path.join(
                root, f"{wide}.json"), "--beam_size", CLI_WIDE_BEAM],
            {"mega_beam_decode": n_wide, "mega_beam_decode_wide": n_wide})
        with open(os.path.join(root, f"{wide}.json")) as f:
            got = json.load(f)
        _, kern_w, plain_w, rescored_w = cli_searches(
            dec, head, feats, names, style, vocab, device, CLI_WIDE_BEAM)
        flips, distinct = check_cli_captions(got, names, kern_w, plain_w,
                                             rescored_w, vocab)
        stats[wide].update(
            near_tie_flips=flips, distinct_captions=distinct,
            captions_per_s=CLI_IMAGES / stats[wide]["wall_s"])
        del kern_w, plain_w, rescored_w
        # a beam above K_WIDE: K2 with its survivors in device memory, one
        # launch a MAX_ROWS // k images of a batch, no plain version
        scan = f"caption_batch_beam_{CLI_SCAN_BEAM}"
        n_scan = -(-CLI_IMAGES // CLI_BATCH) * len(
            launch_chunks(CLI_BATCH, CLI_SCAN_BEAM))
        stage(scan, m + "caption_batch", seeded_args + [
            "--image_dir", files["img"], "--out", os.path.join(
                root, f"{scan}.json"), "--beam_size", CLI_SCAN_BEAM],
            {"mega_beam_decode": n_scan, "mega_beam_decode_wide": n_scan})
        with open(os.path.join(root, f"{scan}.json")) as f:
            got = json.load(f)
        if sorted(got) != sorted(names) or not all(
                isinstance(c, str) for c in got.values()):
            fail(f"phase 19 {scan}: captions for {len(got)} images")
        stats[scan].update(captions_per_s=CLI_IMAGES / stats[scan]["wall_s"],
                           launches=n_scan)
        # 5/6 one image, its feature from the backbone on the card, the
        # weights from the reference's torch checkpoints
        image = os.path.join(files["img"], "t0.jpg")
        out = stage("sample", m + "sample", [
            "--image", image, "--vocab_path", vocab_path, "--decoder_path",
            dec_pth, "--encoder_path", enc_pth, "--resnet_weights", backbone,
            "--mode", CLI_STYLE], {"mega_beam_decode": 1})
        with torch.no_grad():
            pooled = resnet.Backbone(params["backbone"])(normalize(
                torch.tensor(host_decode_resize(image, 224), device=device)
                [None]))
            want = caption_image(dec, cfg, vocab, encode_global_from_pooled(
                head, pooled)[0], style)
        sampled = out.splitlines()[-2]
        if sampled != want or not want:
            fail(f"phase 19 sample: {sampled!r}; in this process {want!r}")
        stats["sample"].update(caption=sampled,
                               same_as_caption_batch=sampled == got["t0.jpg"])
        out = stage("validate", m + "validate", [
            "--caption_path", files["val"], "--checkpoint_path", best,
            *common])
        stats["validate"]["line"] = [ln for ln in out.splitlines()
                                     if ln.startswith("Val Loss")][-1]
        # the attention decoder over spatial features of the validation
        # images, random weights
        spatial = os.path.join(root, "spatial.npz")
        stage("precompute_features_spatial", m + "precompute_features", [
            "--caption_path", files["val"], "--image_dir", files["img"],
            "--out", spatial, "--batch_size", 32, "--spatial",
            "--resnet_weights", backbone])
        stats["precompute_features_spatial"]["images_per_s"] = \
            CLI_VAL_IMAGES / stats["precompute_features_spatial"]["wall_s"]
        att = ["--vocab_path", vocab_path, "--feature_cache", spatial,
               "--attention", "--batch_size", CLI_BATCH]
        outs["evaluate_attention"] = stage(
            "evaluate_attention", m + "evaluate", att + [
                "--test_path", files["val"]],
            {"mega_att_beam_decode": -(-n_val // CLI_BATCH)})
        stats["evaluate_attention"]["captions_per_s"] = \
            n_val / stats["evaluate_attention"]["wall_s"]
        stage("caption_batch_attention", m + "caption_batch", att + [
            "--out", os.path.join(root, "att_captions.json")],
            {"mega_att_beam_decode": -(-CLI_VAL_IMAGES // CLI_BATCH)})
        stats["caption_batch_attention"]["captions_per_s"] = \
            CLI_VAL_IMAGES / stats["caption_batch_attention"]["wall_s"]
        if keep:
            import shutil

            for path in (vocab_path, cache, files["train"], files["val"],
                         files["happy"], files["val_happy"], spatial,
                         backbone, os.path.join(root, "chip.log"),
                         os.path.join(root, "chip.jsonl")):
                shutil.copy(path, keep)
            shutil.copytree(seeded, os.path.join(keep, "seeded_checkpoint"))
            for name in ("evaluate_feed_feature", "evaluate_attention"):
                with open(os.path.join(keep, f"{name}.out"), "w") as f:
                    f.write(outs[name])
        # 6/6 the server: the trained checkpoint as StyleNet's happy model,
        # the seeded one as its sad model
        stats["serve"] = serve_stage(device, root, vocab_path, backbone,
                                     {"happy": best, CLI_STYLE: seeded},
                                     files["img"], logs, add)
        stats["config"] = {
            "V": V, "E": E, "H": H, "F": F, "max_seq_length": STEPS,
            "k": K, "images": CLI_IMAGES, "train_captions": CLI_IMAGES
            * TR_CAPS, "val_captions": n_val, "emotion_captions":
            [CLI_EMO_IMAGES * TR_CAPS, CLI_EMO_VAL_IMAGES * TR_CAPS],
            "batch": CLI_BATCH, "emotion_batch": B_EMOTION,
            "epochs": CLI_EPOCHS, "teacher_forcing_ratio": [1.0, "default"],
            "augment_captions": [CLI_AUG_IMAGES * TR_CAPS,
                                 CLI_AUG_EMO_IMAGES * TR_CAPS],
            "attention_images": CLI_VAL_IMAGES}
    return launches, stats


def serve_stage(device, root: str, vocab_path: str, backbone: str,
                checkpoints: dict, img_dir: str, logs: str, add):
    """``python -m icee_tpu_torch.serve`` through the wrapper on a free
    port, with a ``.env`` that serves ``checkpoints`` (mode -> path) as
    StyleNet's models: one ``POST /generate`` of one image in each mode and
    one of a second image in the last, then ``GET /``, then SIGTERM.  Each
    served caption must be ``CaptionEngine``'s for that checkpoint, the
    last mode's two images must get captions of their own, the page must
    be the bundled ``index.html``, and K2 must launch once a request."""
    import signal
    import socket

    from icee_tpu_torch.serve.config import ServeConfig
    from icee_tpu_torch.serve.engine import CaptionEngine

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env_file = os.path.join(root, "serve.env")
    uploads = os.path.join(root, "uploads")
    suffix = {"factual": "FAC", "happy": "HAP", "sad": "SAD", "angry": "ANG"}
    with open(env_file, "w") as f:
        f.write(f"BACKEND_HOST=127.0.0.1\nIMAGE_FOLDER={uploads}\n"
                f"VOCAB_PATH={vocab_path}\nRESNET_WEIGHTS={backbone}\n"
                + "".join(f"CHECKPOINT_PATH_STYLENET_{suffix[mode]}={path}\n"
                          for mode, path in checkpoints.items()))
    url = f"http://127.0.0.1:{port}"
    modes = list(checkpoints)
    requests = [(os.path.join(img_dir, "t1.jpg"), mode) for mode in modes]
    requests.append((os.path.join(img_dir, "t2.jpg"), modes[-1]))
    t = time.perf_counter()
    proc = subprocess.Popen(
        cli_cmd("icee_tpu_torch.serve", ["--env", env_file, "--port", port]),
        cwd=ROOT, env=cli_env(), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        while True:
            try:
                urllib.request.urlopen(url + "/index.js", timeout=5).read()
                break
            except (urllib.error.URLError, ConnectionError):
                if proc.poll() is not None or \
                        time.perf_counter() - t > CLI_TIMEOUT_S:
                    fail(f"phase 19 serve: the server did not start: "
                         f"{proc.stderr.read()[-3000:]}")
                time.sleep(0.2)
        up = time.perf_counter() - t
        answers = [_post(url, image, mode) for image, mode in requests]
        with urllib.request.urlopen(url + "/", timeout=30) as r:
            page = r.read()
    finally:
        proc.send_signal(signal.SIGTERM)
        try:
            out, err = proc.communicate(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            out, err = proc.communicate()
    wall = time.perf_counter() - t
    log_path = os.path.join(logs, "serve.log")
    with open(log_path, "w") as f:
        f.write(out + "\n--- stderr ---\n" + err)
    if proc.returncode != 0:
        fail(f"phase 19 serve: exit {proc.returncode}: {err[-3000:]}")
    stats, counts = cli_record("serve", out, {"mega_beam_decode": len(
        requests)}, wall, log_path)
    add(counts)
    with open(os.path.join(ROOT, "icee_tpu_torch", "serve", "static",
                           "index.html"), "rb") as f:
        if page != f.read():
            fail("phase 19 serve: GET / is not the bundled index.html")
    engine = CaptionEngine(ServeConfig(
        vocab_path=vocab_path, resnet_weights=backbone,
        checkpoint_paths={"stylenet": checkpoints}), device=device)
    captions = []
    for (image, mode), (status, served, _) in zip(requests, answers):
        want = engine.caption(image, mode)["stylenet"]
        if status != 200 or served.get("stylenet") != want or \
                served.get("nic") != "-":
            fail(f"phase 19 serve: {os.path.basename(image)} ({mode}) "
                 f"answered {status} {served}; the engine captions "
                 f"{want!r}")
        captions.append(want)
    if captions[-1] == captions[-2]:
        fail(f"phase 19 serve: two images got one caption {captions[-1]!r}"
             f" from the seeded checkpoint")
    stats.update(up_s=up, request_s=[a[2] for a in answers],
                 captions=captions)
    log(f"phase 19 serve: up in {up:.2f} s, requests "
        f"{[round(a[2], 3) for a in answers]} s, {wall:.2f} s in all; "
        f"captions {captions}")
    return stats


# --- phase 20: device-resident epochs and mid-epoch progress (slice 3c) ------

# a Flickr8k-sized split: 6,000 images x 5 Zipf captions (30,000 at B = 64),
# an emotion corpus of 1,500 lines at B = 96, 500 x 5 validation lines
RES_IMAGES, RES_EMO, RES_VAL = 6000, 1500, 500
RES_PROGRESS = 64          # (b): a record every 64 batches: 8 in the pass
RES_KILL_AFTER = 3         # (b): the hook raises after this record
RES_ATT_IMAGES = 500       # (c): 196 x 2048 float32 features, 0.8 GB
RES_ATT_BUDGET_GB = 0.5    # (c): below the split's features: it streams
RES_BF16_BATCHES = 10      # (d)
RES_BIG_B = (512, 1024)    # (e): one attention step at each
RES_SC_BATCHES = 10        # (f)
RES_BUSY_BATCHES = 20      # the busy share's pass of each tier


@contextlib.contextmanager
def sync_warnings():
    """Run the block under ``torch.cuda.set_sync_debug_mode("warn")``;
    -> the list of its synchronizing calls, each the Python stack (file,
    line) that made it, innermost last."""
    import traceback
    import warnings

    import torch

    calls = []

    def record(message, category, filename, lineno, file=None, line=None):
        if "synchronizing" in str(message):
            calls.append([(f.filename, f.lineno)
                          for f in traceback.extract_stack()[:-1]
                          if not f.filename.endswith("warnings.py")])

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield calls
        finally:
            torch.cuda.set_sync_debug_mode(0)


def sync_sites(calls) -> dict:
    """Synchronizing calls counted by the innermost line of this
    repository that made them, with the innermost line outside it (file,
    line and text) where there is one."""
    import linecache

    out = {}
    for stack in calls:
        ours = [f"{os.path.relpath(f, ROOT)}:{n}" for f, n in stack
                if os.path.abspath(f).startswith(ROOT + os.sep)]
        key = ours[-1] if ours else "?"
        if stack and not os.path.abspath(stack[-1][0]).startswith(ROOT):
            f, n = stack[-1]
            key += (f" via {os.path.basename(f)}:{n} "
                    f"`{linecache.getline(f, n).strip()}`")
        out[key] = out.get(key, 0) + 1
    return out


def saved_equal(a, b) -> bool:
    """Two trees as ``torch.load`` gives them equal: tensors bit for bit,
    everything else by ``==``."""
    import torch

    if isinstance(a, dict):
        return (isinstance(b, dict) and set(a) == set(b)
                and all(saved_equal(a[k], b[k]) for k in a))
    if isinstance(a, (list, tuple)):
        return (isinstance(b, (list, tuple)) and len(a) == len(b)
                and all(saved_equal(x, y) for x, y in zip(a, b)))
    if isinstance(a, torch.Tensor):
        return isinstance(b, torch.Tensor) and torch.equal(a, b)
    return a == b


def trainer_state_equal(a, b) -> bool:
    """Two trainers' params, both optimizer states and generators equal bit
    for bit."""
    import torch

    return (trees_equal((a.dec, a.head), (b.dec, b.head))
            and all(x.count == y.count and x.hyperparams == y.hyperparams
                    and trees_equal((x.mu, x.nu), (y.mu, y.nu))
                    for x, y in ((a.opt_state, b.opt_state),
                                 (a.lang_opt_state, b.lang_opt_state)))
            and torch.equal(a.generator.get_state(),
                            b.generator.get_state()))


def same_events(a: str, b: str) -> bool:
    """Two trainers' JSONL events equal but for their clocks."""
    def strip(events):
        return [{k: v for k, v in e.items() if k != "t"} for e in events]
    return strip(metrics_events(a)) == strip(metrics_events(b))


def resident_phase(device):
    """Phase 20: the device-resident epochs (``data/device.py``) and the
    mid-epoch progress records (``checkpoint/progress.py``) at flagship
    width.  -> (launches, stats, large-batch attention steps)."""
    import torch

    from icee_tpu_torch.core.config import (DecoderConfig, EncoderConfig,
                                            TrainConfig)
    from icee_tpu_torch.data import device as dd
    from icee_tpu_torch.data.pipeline import caption_dataset_loader
    from icee_tpu_torch.models import encoder
    from icee_tpu_torch.ops import chunked_loss as cl
    from icee_tpu_torch.train import loops

    vocab = trainer_vocab()
    train = trainer_corpus(RES_IMAGES, TR_CAPS, 200, "r")
    emo = trainer_corpus(RES_EMO // TR_CAPS, TR_CAPS, 201, "q")
    val = trainer_corpus(RES_VAL, TR_CAPS, 202, "s")
    names = {e.image for ds in (train, emo, val) for e in ds}
    pooled = trainer_features(sorted(names), 203, (2048,))
    cfg = DecoderConfig(vocab_size=V, embed_size=E, hidden_size=H,
                        factored_size=F, dropout=0.5, max_seq_length=STEPS)

    def tcfg(**kw):
        return TrainConfig(mode="happy", teacher_forcing_ratio=1.0,
                           max_caption_len=T_STEPS, log_step=10 ** 9,
                           log_step_emotion=10 ** 9, **kw)

    def host(ds, b, shuffle=True):
        return caption_dataset_loader(ds, b, T_STEPS, pooled.__getitem__,
                                      shuffle=shuffle, seed=0)

    def pinned(ds, b, shuffle=True, feats=pooled, **kw):
        return dd.from_examples(ds, b, T_STEPS, feats.__getitem__,
                                shuffle=shuffle, seed=0, device=device, **kw)

    def splits(make):
        return (make(train, B_IMAGES), make(val, B_IMAGES, False),
                make(emo, B_EMOTION), make(val, B_EMOTION, False))

    dec0 = training_decoder(device, 20)
    head0 = encoder.init_head_params(torch.Generator().manual_seed(21),
                                     EncoderConfig(embed_size=E),
                                     device=device)
    n_fac, n_emo = -(-len(train) // B_IMAGES), -(-len(emo) // B_EMOTION)

    def chunks(b, t=T_STEPS):
        return -(-t // cl.auto_t_chunk(b, t))

    ce_epoch = n_fac * chunks(B_IMAGES) + n_emo * chunks(B_EMOTION)
    epoch_want = {"fused_factored_scan_fwd": n_fac + n_emo,
                  "fused_factored_scan_bwd": n_fac + n_emo,
                  "ce_rows": ce_epoch, "ce_grad_rows": ce_epoch,
                  "mega_beam_decode": 2}
    stats, launches = {}, {}

    def add(counts):
        for k, n in counts.items():
            launches[k] = launches.get(k, 0) + n

    def run(tmp, call, cls="MultitaskTrainer", family="factored", dec=dec0,
            head=head0, conf=cfg, tc=None):
        return trainer_run(device, family, cls, tmp, clone_tree(dec),
                           None if head is None else clone_tree(head), conf,
                           tc or tcfg(), vocab, call)

    def tier_stats(clock, got):
        st = clock.stats(1, len(train) + len(emo))
        st["launches"] = got
        return st

    with tempfile.TemporaryDirectory() as root, plain_counters() as plain:
        # (a) one epoch from the host loader, then from pinned splits with
        # the same weights and seed, its training under the sync check
        host_splits = splits(host)
        host_tr, got, clock = run(os.path.join(root, "host"),
                                  lambda t: t.train(*host_splits,
                                                    num_epochs=1))
        expect_launches("(a) host", got, epoch_want, 20)
        add(got)
        stats["host"] = tier_stats(clock, got)
        caught = []
        pin_splits = splits(pinned)

        def synced(tr):
            run_device = tr._run_train_device

            def checked(*a, **kw):
                with sync_warnings() as calls:
                    try:
                        return run_device(*a, **kw)
                    finally:
                        caught.extend(calls)
            tr._run_train_device = checked
            tr.train(*pin_splits, num_epochs=1)

        pin_dir = os.path.join(root, "pinned")
        pin_tr, got, clock = run(pin_dir, synced)
        expect_launches("(a) pinned", got, epoch_want, 20)
        add(got)
        stats["pinned"] = tier_stats(clock, got)
        sites = sync_sites(caught)
        stats["pinned"].update(
            sync_calls=len(caught), sync_sites=sites,
            port_sync_calls=sum(n for k, n in sites.items()
                                if k.startswith("icee_tpu_torch/")))
        if not trainer_state_equal(pin_tr, host_tr):
            fail("phase 20 (a): the pinned epoch's state is not the host "
                 "epoch's")
        if not same_events(pin_dir, os.path.join(root, "host")):
            fail("phase 20 (a): the pinned epoch's losses, BLEU or top-5 "
                 "differ from the host epoch's")
        log(f"phase 20 (a): pinned = host epoch at atol 0; epoch s host "
            f"{stats['host']['epoch_s'][0]:.2f} (train "
            f"{stats['host']['train_s']:.2f}), pinned "
            f"{stats['pinned']['epoch_s'][0]:.2f} (train "
            f"{stats['pinned']['train_s']:.2f}); synchronizing calls in "
            f"the pinned training passes {stats['pinned']['sync_calls']} "
            f"({stats['pinned']['port_sync_calls']} in the port) at "
            f"{stats['pinned']['sync_sites']}")

        # (b) the pinned epoch with a record every RES_PROGRESS batches,
        # killed after the RES_KILL_AFTER-th, resumed by a fresh trainer
        writes = []
        save = loops.progress.save_progress

        def timed_save(*a, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = save(*a, **kw)
            writes.append(time.perf_counter() - t)
            return out

        class Killed(RuntimeError):
            pass

        def killed(tr, runs=splits(pinned)):
            def hook(epoch, pass_idx, row):
                if len(writes) == RES_KILL_AFTER:
                    raise Killed(f"after row {row}")
            tr._progress_hook = hook
            try:
                tr.train(*runs, num_epochs=1)
            except Killed:
                return
            fail("phase 20 (b): the progress hook never killed the run")

        kill_dir = os.path.join(root, "killed")
        loops.progress.save_progress = timed_save
        try:
            _, got_k, _ = run(kill_dir, killed,
                              tc=tcfg(progress_chunk=RES_PROGRESS))
            resume_splits = splits(pinned)
            resumed, got_r, clock = run(
                kill_dir, lambda t: t.train(*resume_splits, num_epochs=1),
                tc=tcfg(progress_chunk=RES_PROGRESS))
        finally:
            loops.progress.save_progress = save
        both = {k: got_k[k] + got_r[k] for k in got_k}
        expect_launches("(b) killed + resumed", both, epoch_want,
                        20)
        add(both)
        if not trainer_state_equal(resumed, pin_tr):
            fail("phase 20 (b): the resumed run's state is not the "
                 "uninterrupted pinned epoch's")
        if not same_events(kill_dir, pin_dir):
            fail("phase 20 (b): the resumed run's losses, BLEU or top-5 "
                 "differ from the uninterrupted pinned epoch's")
        if any(n.startswith("progress_checkpoint")
               for n in os.listdir(kill_dir)):
            fail("phase 20 (b): the progress record was not cleared")
        records = -(-n_fac // RES_PROGRESS) + -(-n_emo // RES_PROGRESS)
        if len(writes) != records:
            fail(f"phase 20 (b): {len(writes)} records, expected {records}")
        stats["resumed"] = dict(
            tier_stats(clock, both), records=len(writes),
            killed_after_records=RES_KILL_AFTER, record_write_s=writes,
            record_write_mean_s=statistics.mean(writes))
        log(f"phase 20 (b): killed after {RES_KILL_AFTER} records, resumed "
            f"= uninterrupted at atol 0; a record write "
            f"{statistics.mean(writes):.3f} s (of {len(writes)})")

        # the device-busy share of a RES_BUSY_BATCHES-batch training pass of
        # each tier, from the profiler
        part = train[:RES_BUSY_BATCHES * B_IMAGES]
        stats["host"]["device_busy_share"] = device_busy_share(
            lambda: host_tr._run_train(host(part, B_IMAGES), 0, 10 ** 9,
                                       "FAC"))
        stats["pinned"]["device_busy_share"] = device_busy_share(
            lambda: pin_tr._run_train(pinned(part, B_IMAGES), 0, 10 ** 9,
                                      "FAC"))
        del host_tr, pin_tr, resumed
        torch.cuda.empty_cache()

        # (c) StyleNet+Att at ratio 0.8: a split over the budget streams;
        # the same split pinned
        att_ds = trainer_corpus(RES_ATT_IMAGES, TR_CAPS, 204, "x")
        spatial = trainer_features(sorted({e.image for e in att_ds}), 205,
                                   (P, FS))
        budget = int(RES_ATT_BUDGET_GB * (1 << 30))
        if dd.pin_plan(RES_ATT_IMAGES, (P, FS), budget) != "stream":
            fail("phase 20 (c): pin_plan did not stream the spatial split")
        dec_att, acfg = att_train_decoder("factored", device, 22)
        atc = TrainConfig(mode="happy", teacher_forcing_ratio=0.8,
                          max_caption_len=T_STEPS + 1, log_step=10 ** 9,
                          log_step_emotion=10 ** 9)
        n_att = -(-len(att_ds) // B_ATT)
        att_ce = n_att * chunks(B_ATT)
        att_want = {"fused_att_scan_sampled_fwd": n_att,
                    "fused_att_scan_sampled_bwd": n_att,
                    "ce_rows": att_ce, "ce_grad_rows": att_ce}
        att = {}
        for tier in ("streamed", "pinned"):
            if tier == "streamed":
                split = dd.from_examples_streamed(
                    att_ds, B_ATT, T_STEPS + 1, spatial.__getitem__, seed=0,
                    budget_bytes=budget, device=device)
            else:
                split = dd.from_examples(att_ds, B_ATT, T_STEPS + 1,
                                         spatial.__getitem__, seed=0,
                                         device=device)
            tr, got, clock = run(
                os.path.join(root, f"att_{tier}"),
                lambda t, s=split: t._run_train(s, 0, 10 ** 9, "FAC"),
                family="factored_att", dec=dec_att, head=None, conf=acfg,
                tc=atc)
            expect_launches(f"(c) {tier}", got, att_want, 20)
            add(got)
            att[tier] = (tr, dict(train_s=clock.marks["train"][0],
                                  captions_per_s=len(att_ds)
                                  / clock.marks["train"][0],
                                  launches=got))
            if tier == "streamed":
                att[tier][1].update(capacity=split.capacity,
                                    rows_per_chunk=split.rows_per_chunk)
            del split
        if not trainer_state_equal(att["streamed"][0], att["pinned"][0]):
            fail("phase 20 (c): the streamed epoch's state is not the "
                 "pinned epoch's")
        stats["att_streamed"] = att["streamed"][1]
        stats["att_pinned"] = att["pinned"][1]
        log(f"phase 20 (c): StyleNet+Att streamed = pinned at atol 0; "
            f"train s streamed {stats['att_streamed']['train_s']:.2f} "
            f"(capacity {stats['att_streamed']['capacity']} features), "
            f"pinned {stats['att_pinned']['train_s']:.2f}")
        del att, spatial
        torch.cuda.empty_cache()

        # (d) bfloat16 storage against the same features rounded to
        # bfloat16 and stored as float32
        part = train[:RES_BF16_BATCHES * B_IMAGES]
        rounded = {n: torch.from_numpy(v).bfloat16().float().numpy()
                   for n, v in pooled.items()}
        bf = []
        for split in (pinned(part, B_IMAGES, feature_dtype=torch.bfloat16),
                      pinned(part, B_IMAGES, feats=rounded)):
            tr, got, _ = run(os.path.join(root, f"bf16_{len(bf)}"),
                             lambda t, s=split: t._run_train(
                                 s, 0, 10 ** 9, "FAC"))
            add(got)
            bf.append(tr)
        if not trainer_state_equal(bf[0], bf[1]):
            fail("phase 20 (d): bfloat16 storage is not float32 storage of "
                 "the rounded features")
        stats["bf16_equal"] = True
        del bf

    # (e) one StyleNet+Att step at ratio 0.8 at large batches
    from icee_tpu_torch.train import optim
    from icee_tpu_torch.train.steps import make_attention_steps

    big = {}
    steps = make_attention_steps(
        acfg, atc, optim.make_adam(atc.lr_caption, atc),
        optim.make_adam(atc.lr_language, atc), factored=True, device=device)
    for b in RES_BIG_B:
        try:
            dec, _ = att_train_decoder("factored", device, 23)
            opt = steps.optimizer.init(dec)
            feats, caps, lens, mask = att_train_batch(device, b, 90 + b)
            g = torch.Generator(device=device).manual_seed(b)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(device)
            ms = step_ms(lambda: steps.factual_train_step(
                dec, opt, feats, caps, lens, mask, generator=g), 3)
            big[f"b{b}"] = {"step_ms": ms, "captions_per_s": b / ms * 1e3,
                            "max_memory_allocated_bytes":
                                torch.cuda.max_memory_allocated(device)}
        except (RuntimeError, ValueError) as e:
            big[f"b{b}"] = {"refused": f"{type(e).__name__}: {e}"}
        dec = opt = feats = caps = lens = mask = None
        torch.cuda.empty_cache()
    log(f"phase 20 (e): StyleNet+Att steps at ratio 0.8: {big}")

    # (f) SentiCap whole epochs against the same steps called one by one
    stats["senticap"] = senticap_epochs(device, add)
    if any(plain.values()):
        fail(f"phase 20: a plain version ran on the card: {plain}")
    stats["plain_calls"] = plain
    stats["config"] = {
        "V": V, "E": E, "H": H, "F": F, "T": T_STEPS, "B": B_IMAGES,
        "B_emotion": B_EMOTION, "images": RES_IMAGES,
        "train_captions": len(train), "emotion_captions": len(emo),
        "val_captions": len(val), "progress_chunk": RES_PROGRESS,
        "att_images": RES_ATT_IMAGES, "att_budget_gb": RES_ATT_BUDGET_GB,
        "B_att": B_ATT, "P": P, "FS": FS}
    return launches, stats, big


def senticap_epochs(device, add) -> dict:
    """Phase 20 (f): ``make_base_epoch`` and ``make_switched_epoch`` at the
    COCO regime (phase 13's and 16's shapes) over RES_SC_BATCHES index
    rows against the step called row by row from the same state and
    generator: the same params, solver state and losses, the same K8, CE
    and mixture-CE launches."""
    import numpy as np
    import torch

    from icee_tpu_torch.ops import chunked_loss as cl
    from icee_tpu_torch.ops import senticap_scan as ss
    from icee_tpu_torch.senticap import io as sio
    from icee_tpu_torch.senticap import model, switched
    from icee_tpu_torch.senticap import train as st
    from icee_tpu_torch.senticap.solver import make_solver

    counters = {"fused_senticap_scan_fwd": ss.senticap_scan_fwd,
                "fused_senticap_scan_bwd": ss.senticap_scan_bwd,
                "ce_rows": cl.ce_rows, "ce_grad_rows": cl.ce_grad_rows,
                "mixture_ce_rows": cl.mixture_ce_rows}
    out = {}
    for kind in ("base", "switched"):
        base = model.init_params(torch.Generator().manual_seed(94), SC_V,
                                 senticap_conf_full())
        if kind == "base":
            conf = senticap_conf_full()
            ds = senticap_split(RES_SC_BATCHES * SC_B, 95)
            start = {k: v.to(device) for k, v in base.items()}
            mask = None
            make_epoch, make_step = st.make_base_epoch, st.make_base_step
        else:
            conf = senticap_conf_full(learning_rate=SC_SWITCH_LR)
            ds = senticap_split(RES_SC_BATCHES * SC_B, 96, senti=1.0)
            start = switched_params(device, base)
            mask = switched.switch_param_mask(start)
            make_epoch, make_step = (st.make_switched_epoch,
                                     st.make_switched_step)
        data = sio.device_dataset(ds, device)
        rows = torch.as_tensor(st._epoch_indices(
            RES_SC_BATCHES * SC_B, SC_B, np.random.default_rng(97)),
            device=device)
        runs = []
        for whole in (True, False):
            params = {k: v.clone() for k, v in start.items()}
            solver = make_solver(conf, mask)
            opt = solver.init(params)
            gen = torch.Generator(device=device).manual_seed(98)
            for fn in counters.values():
                fn.launches = 0
            torch.cuda.synchronize()
            t = time.perf_counter()
            if whole:
                params, opt, gen, losses = make_epoch(
                    conf, solver, device=device)(params, opt, data, rows,
                                                 gen)
                losses = losses.tolist()
            else:
                step = make_step(conf, solver, device=device)
                losses = []
                for idx in rows:
                    params, opt, loss = step(params, opt, data, idx, gen)
                    losses.append(float(loss))
            torch.cuda.synchronize()
            counts = {k: fn.launches for k, fn in counters.items()}
            # the switched step's ce_grad_rows is the mixture's backward
            add({f"{k}_mixture" if kind == "switched" and k == "ce_grad_rows"
                 else k: n for k, n in counts.items()})
            runs.append((params, opt, gen.get_state(), losses, counts,
                         time.perf_counter() - t))
        (p1, o1, g1, l1, c1, s1), (p2, o2, g2, l2, c2, s2) = runs
        # a switch step scans both paths forward and the sentiment path
        # (the trainable one) backward
        scans = RES_SC_BATCHES * (2 if kind == "switched" else 1)
        if not (trees_equal(p1, p2) and trees_equal(o1, o2)
                and torch.equal(g1, g2) and l1 == l2):
            fail(f"phase 20 (f) {kind}: the whole epoch differs from the "
                 "step loop")
        if c1 != c2 or c1["fused_senticap_scan_fwd"] != scans or \
                c1["fused_senticap_scan_bwd"] != RES_SC_BATCHES or (
                    kind == "switched"
                    and c1["mixture_ce_rows"] != 2 * RES_SC_BATCHES):
            fail(f"phase 20 (f) {kind}: launches {c1} (step loop {c2})")
        out[kind] = {"epoch_s": s1, "step_loop_s": s2, "launches": c1,
                     "losses": l1}
    log(f"phase 20 (f): SentiCap epochs = the step loops; launches "
        f"{ {k: v['launches'] for k, v in out.items()} }")
    return out


# --- phase 21: the SentiCap CLI as processes (slice 7d) ----------------------

# the COCO regime of phases 12-14 as the CLI runs it: 512 images x 5 Zipf
# captions (phase 13's language) whose words pass MIN_WORD_FREQ = 5 at SC_V
# words (a tail after the Zipf words holds every word 5 times: the
# vocabulary counts every token, the split keeps the first 20), 4096-wide
# N(0, 1) features; SCC_SENTI styled records with SC_SENTI_WORDS new
# sentiment words at their switch positions, so that ``train``'s vocab
# surgery adds them; ``test`` over the first SCC_TEST_IMAGES images, each
# with its 5 captions as references
SCC_IMAGES, SCC_CAPS, SCC_SENTI, SCC_TEST_IMAGES = 512, 5, 640, 64
SCC_EPOCHS = 2
SCC_MIN_FREQ = 5


def senticap_cli_files(root: str) -> dict:
    """The caption JSONs and the feature npz of phase 21 under ``root``."""
    import numpy as np

    rng = np.random.default_rng(210)
    order = 2 + np.random.default_rng(98).permutation(SC_V - 2)
    words = order[:SC_WORDS]
    zipf = 1.0 / np.arange(1, SC_WORDS + 1)
    tail = list(range(1, SC_V)) * SCC_MIN_FREQ
    rng.shuffle(tail)
    n = SCC_IMAGES * SCC_CAPS
    caps = []
    for c in range(n):
        ids = words[rng.choice(SC_WORDS, rng.integers(6, SC_MAXLEN),
                               p=zipf / zipf.sum())].tolist() + tail[c::n]
        caps.append({"image": f"i{c // SCC_CAPS}",
                     "tokens": [f"w{i}" for i in ids]})
    senti = []
    for r in range(SCC_SENTI):
        ids = words[rng.choice(SC_WORDS, rng.integers(6, SC_MAXLEN),
                               p=zipf / zipf.sum())].tolist()
        toks = [f"w{i}" for i in ids]
        switch = (rng.random(len(toks)) < SC_SWITCH_SHARE).astype(int)
        switch[rng.integers(len(toks))] = 1
        for j in np.flatnonzero(switch):
            toks[j] = f"s{rng.integers(SC_SENTI_WORDS)}"
        senti.append({"image": f"i{r % SCC_IMAGES}", "tokens": toks,
                      "switch": switch.tolist()})
    out = {}
    for name, recs in (("captions", caps), ("senti", senti),
                       ("test", caps[:SCC_TEST_IMAGES * SCC_CAPS])):
        out[name] = os.path.join(root, f"{name}.json")
        with open(out[name], "w") as f:
            json.dump(recs, f)
    out["features"] = os.path.join(root, "feats.npz")
    np.savez(out["features"], **{
        f"i{k}": rng.standard_normal(SC_VIS).astype(np.float32)
        for k in range(SCC_IMAGES)})
    return out


def pickle_equal(a: str, b: str) -> bool:
    """Two SentiCap model pickles: the same params bit for bit, the same
    conf, solver state and vocabulary."""
    import pickle

    import numpy as np

    with open(a, "rb") as f:
        pa = pickle.load(f)
    with open(b, "rb") as f:
        pb = pickle.load(f)
    return (set(pa["params"]) == set(pb["params"]) and all(
        np.array_equal(pa["params"][k], pb["params"][k])
        and pa["params"][k].dtype == pb["params"][k].dtype
        for k in pa["params"]) and pa["conf"] == pb["conf"]
        and pa["w2i"] == pb["w2i"]
        and pa["solver_state"] == pb["solver_state"])


def metrics_line(out: str) -> dict:
    """``test --out_dir``'s metrics JSON line in a stage's output."""
    lines = [ln for ln in out.splitlines()
             if ln.startswith("{") and not ln.startswith('{"cli_stage"')]
    if len(lines) != 1:
        fail(f"phase 21 test: {len(lines)} metrics lines")
    return json.loads(lines[0])


def check_test_stage(what: str, out: str, model: str, files: dict,
                     base_only: bool, device):
    """``test``'s printed decodes and metrics JSON against an in-process
    ``decode_split`` of the same pickle (K9 / K10 again in this process):
    equal line by line, or where an image's caption differs, a near tie
    (the two sequences' scores under the plain model within 1e-4: phase
    14's rule).  -> (decoded captions, near-tie flips)."""
    import torch

    from icee_tpu_torch.senticap import io as sio
    from icee_tpu_torch.senticap.eval_out import score_decodes
    from icee_tpu_torch.senticap.train import decode_split

    params, conf, _, w2i = sio.load_model(model, device)
    i2w = {i: w for w, i in w2i.items()}
    records = sio.load_captions_json(files["test"])
    seen, unique = set(), []
    for r in records:
        if r["image"] not in seen:
            seen.add(r["image"])
            unique.append(r)
    ds = sio.make_split(unique, sio.load_features(files["features"]), w2i,
                        max_len=conf["MAX_SENTENCE_LEN"],
                        visual_size=conf["visual_size"])
    want = decode_split(params, conf, ds, i2w, switched=not base_only,
                        torch_device=device)
    keys = ("caption",) if base_only else ("positive", "descriptive")
    refs = {}
    for r in records:
        refs.setdefault(r["image"], []).append(r["tokens"])
    printed = [ln for ln in out.splitlines() if ln.startswith("[")]
    got = []
    for ln in printed:
        image, rest = ln[1:].split("] ", 1)
        if not base_only:
            rest = rest.split(": ", 1)[1]
        got.append((image, rest.split()))
    exp = [(rec["image"], rec[k]) for rec in want for k in keys]
    if [g[0] for g in got] != [e[0] for e in exp]:
        fail(f"phase 21 {what}: {len(got)} printed decodes for "
             f"{len(exp)} expected")
    flips = 0
    v = torch.as_tensor(ds.V, device=device)
    for j, ((image, words), (_, want_words)) in enumerate(zip(got, exp)):
        if words == want_words:
            continue
        i = j // len(keys)
        styled = keys[j % len(keys)] == "positive"
        scores = []
        for ws in (words, want_words):
            ids = [w2i[w] for w in ws] + [0]
            tok = torch.tensor([ids], device=device)
            ln = torch.tensor([len(ids)], device=device)
            rescore = switched_rescore if styled else senticap_rescore
            scores.append(rescore(params, v[i:i + 1], tok, ln).item())
        margin = abs(scores[0] - scores[1])
        if margin > 1e-4:
            fail(f"phase 21 {what}, {image}: decoded {words}, in this "
                 f"process {want_words}; margin {margin} > 1e-4")
        flips += 1
    if not base_only and flips == 0 and metrics_line(out) != json.loads(
            json.dumps(score_decodes(want, refs), default=float)):
        fail(f"phase 21 {what}: metrics {metrics} differ from the "
             "in-process decode's")
    return len(exp), flips


def senticap_cli_phase(device):
    """Phase 21: ``python -m icee_tpu_torch.cli.senticap_train`` as
    processes on the card at the COCO regime (E = H = 512, visual 4096,
    B = 128, max_len 20, beam 20): ``base`` (2 epochs), ``base
    --device_resident`` (its pickle bit-equal to ``base``'s), ``train``
    from ``base``'s pickle (lr 1e-4, phase 16's: at the CLI's 1e-3 switch
    training can go nan at this width), ``test --out_dir`` over 64 images
    and ``test --base_only``, each through ``CLI_WRAPPER`` with its
    launches exact and no plain version called."""
    from icee_tpu_torch.ops import chunked_loss as cl

    stats, launches = {}, {}
    m = "icee_tpu_torch.cli.senticap_train"
    t_cap = SC_MAXLEN + 1
    chunks = -(-t_cap // cl.auto_t_chunk(SC_B, t_cap))
    steps = SCC_EPOCHS * (SCC_IMAGES * SCC_CAPS // SC_B)
    val_blocks = -(-SCC_IMAGES * SCC_CAPS // SC_B)
    sw_steps = SCC_EPOCHS * (SCC_SENTI // SC_B)
    widths = ["--emb_size", SC_E, "--hidden_size", SC_H, "--visual_size",
              SC_VIS, "--batch_size", SC_B, "--max_len", SC_MAXLEN]
    with tempfile.TemporaryDirectory() as root:
        files = senticap_cli_files(root)
        logs = os.path.join(root, "logs")
        os.makedirs(logs)
        data = ["--features", files["features"]]

        def stage(name, args, want):
            st, counts, out = cli_stage(name, m, args, logs, want, phase=21)
            stats[name] = st
            for k, n in counts.items():
                launches.setdefault(name, {})[k] = n
            return out

        base_want = {"fused_senticap_scan_fwd": steps + val_blocks,
                     "fused_senticap_scan_bwd": steps,
                     "ce_rows": (steps + val_blocks) * chunks,
                     "ce_grad_rows": steps * chunks}
        paths = {k: os.path.join(root, f"{k}.pik")
                 for k in ("base", "base_resident", "switched")}
        outs = {}
        for name, extra in (("base", []),
                            ("base_resident", ["--device_resident"])):
            outs[name] = stage(name, [
                "base", "--captions", files["captions"], *data, *widths,
                "--num_epochs", SCC_EPOCHS, "--model_out", paths[name],
                *extra], base_want)
        vocab_line = [ln for ln in outs["base"].splitlines()
                      if ln.startswith("vocab ")]
        if vocab_line != [f"vocab {SC_V}, split "
                          f"({SCC_IMAGES * SCC_CAPS}, {t_cap})"]:
            fail(f"phase 21 base: {vocab_line}")
        ppl = [float(ln.split()[-1]) for ln in outs["base"].splitlines()
               if ln.startswith("val perplexity:")]
        losses = [float(ln.split()[5]) for ln in outs["base"].splitlines()
                  if ln.startswith("[senticap base] epoch")]
        if len(losses) != SCC_EPOCHS or not losses[-1] < losses[0] or \
                len(ppl) != 1 or not ppl[0] < SC_V:
            fail(f"phase 21 base: losses {losses}, perplexity {ppl}")
        def kept(text):     # the stage's lines but its clocks and paths
            return [ln for ln in text.splitlines() if not ln.startswith((
                "[senticap base] epoch", "saved", '{"cli_stage"'))]

        if not pickle_equal(paths["base"], paths["base_resident"]) or \
                kept(outs["base"]) != kept(outs["base_resident"]):
            fail("phase 21 base_resident: the pickle or the perplexity "
                 "differs from base's")
        stats["base"].update(steps=steps, losses=losses, perplexity=ppl[0],
                             captions_per_s=SCC_EPOCHS * SCC_IMAGES
                             * SCC_CAPS / stats["base"]["wall_s"])
        stats["base_resident"].update(equal_to_base=True)
        out = stage("train", [
            "train", "--captions", files["senti"], *data, "-s", "pos",
            "--base_model", paths["base"], "--batch_size", SC_B,
            "--num_epochs", SCC_EPOCHS, "--lr", SC_SWITCH_LR,
            "--model_out", paths["switched"]],
            {"fused_senticap_scan_fwd": 2 * sw_steps,
             "fused_senticap_scan_bwd": sw_steps,
             "mixture_ce_rows": sw_steps * chunks,
             "ce_grad_rows": sw_steps * chunks})
        added = [ln.split()[0] for ln in out.splitlines()
                 if ln.startswith("  ")]
        sw_losses = [float(ln.split()[5]) for ln in out.splitlines()
                     if ln.startswith("[senticap switch] epoch")]
        if sorted(added) != sorted(f"s{i}" for i in range(SC_SENTI_WORDS)) \
                or f"vocab surgery: +{SC_SENTI_WORDS} sentiment words" \
                not in out or len(sw_losses) != SCC_EPOCHS or not all(
                    math.isfinite(x) for x in sw_losses):
            fail(f"phase 21 train: added {added}, losses {sw_losses}")
        stats["train"].update(steps=sw_steps, added_words=len(added),
                               losses=sw_losses)
        for name, model, extra, want in (
                ("test", paths["switched"],
                 ["--out_dir", os.path.join(root, "eval")],
                 {"mega_senticap_switched_decode": 1,
                  "mega_senticap_beam_decode": 1}),
                ("test_base_only", paths["base"], ["--base_only"],
                 {"mega_senticap_beam_decode": 1})):
            out = stage(name, ["test", "--captions", files["test"], *data,
                               "--model_in", model, "--print_n",
                               SCC_TEST_IMAGES, *extra], want)
            if name == "test" and not all(os.path.exists(os.path.join(
                    root, "eval", f)) for f in (
                    "output_pos", "output_des", "reference0", "reference4",
                    "highlight.html")):
                fail("phase 21 test: the eval files are missing")
            n, flips = check_test_stage(name, out, model, files,
                                        name == "test_base_only", device)
            stats[name].update(captions=n, near_tie_flips=flips,
                               captions_per_s=n / stats[name]["wall_s"])
            if name == "test":
                stats[name]["metrics"] = metrics_line(out)
    stats["config"] = {"E": SC_E, "H": SC_H, "visual": SC_VIS, "V": SC_V,
                       "batch": SC_B, "max_len": SC_MAXLEN, "beam": SC_BEAM,
                       "captions": SCC_IMAGES * SCC_CAPS,
                       "styled_records": SCC_SENTI, "epochs": SCC_EPOCHS,
                       "test_images": SCC_TEST_IMAGES,
                       "switch_lr": SC_SWITCH_LR}
    log("phase 21: SentiCap CLI ok; s a stage (import torch; run) "
        + ", ".join(f"{k} {v['wall_s']:.1f} ({v['import_s']:.1f}; "
                    f"{v['run_s']:.1f})"
                    for k, v in stats.items() if "wall_s" in v)
        + f"; decoded captions/s with the start: test "
        f"{stats['test']['captions_per_s']:.1f}, base_only "
        f"{stats['test_base_only']['captions_per_s']:.1f}")
    return launches, stats


# --- phase 22: seq2seq style transfer on the card (slices 6, 9) --------------

# Seq2SeqConfig's defaults (E 300, H 512, 1 layer, dropout 0.22, 40 steps of
# greedy_sample, feature 2048) at V = 8192 over phase 18's corpus (B = 64)
# with S2S_EMO lines a style at B = 96, at the reference's ratio 0.8, plus
# S2S_TF_STEPS steps at 1.0; the CLI over phase 19's feature cache
S2S_EPOCHS, S2S_EMO, S2S_TF_STEPS, S2S_TIMED = 2, 960, 3, 12
S2S_CLI_EPOCHS = 1


def seq2seq_phase(device, cli_files: str):
    """Phase 22: (a) ``Seq2SeqTrainer.train`` from the host loader and from
    pinned splits, equal at atol 0, the CE row passes counted, then
    ``greedy_sample`` for every mode and S2S_TF_STEPS teacher-forced
    steps; (b) ``cli.train --trainer seq2seq`` as two processes over
    phase 19's cache, host loader and ``--device_resident``, the same log;
    (c) an adversarial and an encoder-decoder SentiCap loss with their
    gradients on the card against the CPU, and ``grad_reverse`` on the
    card; (d) ``utils.profiling.trace`` around one step and ``StepTimer``
    over S2S_TIMED."""
    import torch

    from icee_tpu_torch.core.config import (EncoderConfig, Seq2SeqConfig,
                                            TrainConfig)
    from icee_tpu_torch.data import device as ddev
    from icee_tpu_torch.data.pipeline import caption_dataset_loader
    from icee_tpu_torch.models import encoder
    from icee_tpu_torch.models import seq2seq as s2s
    from icee_tpu_torch.ops import chunked_loss as cl
    from icee_tpu_torch.train import optim
    from icee_tpu_torch.train.loops import Seq2SeqTrainer
    from icee_tpu_torch.train.steps import make_seq2seq_steps
    from icee_tpu_torch.utils import profiling

    stats, launches = {}, {}
    vocab = trainer_vocab()
    train = trainer_corpus(TR_IMAGES, TR_CAPS, 180, "t")
    val = trainer_corpus(TR_VAL // TR_CAPS, TR_CAPS, 181, "v")
    emo = {e: trainer_corpus(S2S_EMO // TR_CAPS, TR_CAPS, 220 + i, e[0])
           for i, e in enumerate(("happy", "sad", "angry"))}
    emo_val = {e: trainer_corpus(TR_EMO_VAL // TR_CAPS + 1, TR_CAPS,
                                 230 + i, e[0] + "v")[:TR_EMO_VAL]
               for i, e in enumerate(emo)}
    names = {x.image for ds in (train, val, *emo.values(),
                                *emo_val.values()) for x in ds}
    pooled = trainer_features(sorted(names), 184, (2048,))
    scfg = Seq2SeqConfig(vocab_size=V)
    tcfg = TrainConfig(teacher_forcing_ratio=0.8, max_caption_len=T_STEPS,
                       caption_batch_size=B_IMAGES,
                       language_batch_size=B_EMOTION)
    params0 = s2s.init_params(torch.Generator().manual_seed(220), scfg,
                              device=device)
    head0 = encoder.init_head_params(torch.Generator().manual_seed(221),
                                     EncoderConfig(embed_size=scfg.embed_size),
                                     device=device)

    def chunks(b, t):
        return -(-t // cl.auto_t_chunk(b, t))

    n_fac = -(-len(train) // B_IMAGES)
    n_emo = sum(-(-len(d) // B_EMOTION) for d in emo.values())
    ce_epoch = (n_fac * chunks(B_IMAGES, T_STEPS)
                + n_emo * chunks(B_EMOTION, T_STEPS - 1))
    counters = {"ce_rows": cl.ce_rows, "ce_grad_rows": cl.ce_grad_rows}

    def split(ds, b, shuffle, pinned):
        if pinned:
            return ddev.from_examples(ds, b, T_STEPS, pooled.__getitem__,
                                      shuffle=shuffle, seed=0, device=device)
        return caption_dataset_loader(ds, b, T_STEPS, pooled.__getitem__,
                                      shuffle=shuffle, seed=0)

    runs = {}
    with tempfile.TemporaryDirectory() as root, plain_counters() as plain:
        # (a) two epochs, host loader then pinned
        for tier in ("host", "pinned"):
            pinned = tier == "pinned"
            log_path = os.path.join(root, f"{tier}.log")
            tr = Seq2SeqTrainer(scfg, tcfg, vocab, params0, head0,
                                log_path=log_path, device=device)
            loaders = (split(train, B_IMAGES, True, pinned),
                       {e: split(d, B_EMOTION, True, pinned)
                        for e, d in emo.items()},
                       split(val, B_IMAGES, False, pinned),
                       {e: split(d, B_EMOTION, False, pinned)
                        for e, d in emo_val.items()})
            for fn in counters.values():
                fn.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tr.train(loaders[0], loaders[1], S2S_EPOCHS, loaders[2],
                     loaders[3])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = {k: fn.launches for k, fn in counters.items()}
            launches[f"train_{tier}"] = counts
            if counts != {"ce_rows": S2S_EPOCHS * ce_epoch,
                          "ce_grad_rows": S2S_EPOCHS * ce_epoch}:
                fail(f"phase 22 (a) {tier}: CE launches {counts}, expected "
                     f"{S2S_EPOCHS * ce_epoch} each")
            with open(log_path) as f:
                text = f.read()
            fac = [float(ln.split()[-1]) for ln in text.splitlines()
                   if "[FAC], Loss" in ln]
            runs[tier] = (tr, text)
            captions = S2S_EPOCHS * (len(train) + sum(map(len, emo.values())))
            stats[tier] = {"wall_s": wall, "epoch_s": wall / S2S_EPOCHS,
                           "factual_loss": fac, "captions_per_s":
                           captions / wall}
        (host, host_log), (pin, pin_log) = runs["host"], runs["pinned"]
        same = (host_log == pin_log
                and trees_equal((host.params, host.head),
                                (pin.params, pin.head))
                and all(x.count == y.count and trees_equal((x.mu, x.nu),
                                                           (y.mu, y.nu))
                        for x, y in ((host.opt_state, pin.opt_state),
                                     (host.emotion_opt_state,
                                      pin.emotion_opt_state)))
                and torch.equal(host.generator.get_state(),
                                pin.generator.get_state()))
        if not same:
            fail("phase 22 (a): the pinned epochs are not the host loader's "
                 f"at atol 0 (params, both Adam states, the log; the logs "
                 f"equal: {host_log == pin_log})")
        fac = stats["host"]["factual_loss"]
        if len(fac) != S2S_EPOCHS or not fac[-1] < fac[0]:
            fail(f"phase 22 (a): factual losses {fac} did not fall")
        # greedy_sample in every mode from the trained weights
        feats = encoder.encode_global_from_pooled(pin.head, torch.stack([
            torch.from_numpy(pooled[x.image]) for x in val[:8]]).to(device))
        samples = {}
        for mode, emotion in (("factual", None), ("happy", 0), ("sad", 1),
                              ("angry", 2)):
            ids = s2s.greedy_sample(pin.params, scfg, feats, vocab.start,
                                    emotion)
            if ids.shape != (8, scfg.max_seq_length) or not (
                    (ids >= 0) & (ids < V)).all():
                fail(f"phase 22 (a): greedy_sample({mode}) {ids.shape}")
            samples[mode] = vocab.decode(ids[0].tolist())[:12]
        # S2S_TF_STEPS teacher-forced steps (ratio 1.0), and the timed
        # steps at 0.8 with the trace around one
        batch = next(iter(caption_dataset_loader(
            train, B_IMAGES, T_STEPS, pooled.__getitem__, seed=0,
            prefetch=0)))
        pooled_b, caps, lens, smask = (
            torch.from_numpy(batch.images).float().to(device),
            torch.from_numpy(batch.captions).long().to(device),
            torch.from_numpy(batch.lengths).long().to(device),
            torch.from_numpy(batch.sample_mask).to(device))
        tf_losses, timer = [], profiling.StepTimer(warmup=2)
        for fn in counters.values():
            fn.launches = 0
        for ratio, n in ((1.0, S2S_TF_STEPS), (0.8, S2S_TIMED)):
            tc = TrainConfig(teacher_forcing_ratio=ratio,
                             max_caption_len=T_STEPS)
            adam = optim.make_adam(tc.lr_caption, tc)
            fac_step = make_seq2seq_steps(scfg, tc, adam, adam,
                                          device).factual_train_step
            p = {k: clone_tree(v) if k == "encoder" else v
                 for k, v in pin.params.items()}
            h = {k: clone_tree(v) for k, v in pin.head.items()}
            st = adam.init((p["encoder"], h))
            gen = torch.Generator(device=device).manual_seed(222)
            for _ in range(n):
                with timer if ratio < 1.0 else contextlib.nullcontext():
                    p, h, st, loss = fac_step(p, h, st, pooled_b, caps,
                                              lens, smask, gen)
                if ratio == 1.0:
                    tf_losses.append(float(loss))
            if ratio < 1.0:
                trace_dir = os.path.join(root, "trace")
                with profiling.trace(trace_dir):
                    fac_step(p, h, st, pooled_b, caps, lens, smask, gen)
                    torch.cuda.synchronize()
                with open(os.path.join(trace_dir, "trace.json")) as f:
                    trace_text = f.read()
                if "ce_rows_kernel" not in trace_text:
                    fail("phase 22 (d): the trace names no ce_rows_kernel")
        counts = {k: fn.launches for k, fn in counters.items()}
        launches["steps"] = counts
        per = chunks(B_IMAGES, T_STEPS)
        if counts != {"ce_rows": (S2S_TF_STEPS + S2S_TIMED + 1) * per,
                      "ce_grad_rows": (S2S_TF_STEPS + S2S_TIMED + 1) * per}:
            fail(f"phase 22 (a), (d): CE launches {counts}")
        if not all(math.isfinite(x) for x in tf_losses):
            fail(f"phase 22 (a): ratio 1.0 losses {tf_losses}")
        summary = timer.summary()
        stats["steps"] = {"ratio_1_losses": tf_losses, "timer": summary,
                          "captions_per_s": B_IMAGES
                          / (summary["p50_ms"] / 1e3),
                          "trace_bytes": len(trace_text)}
        stats["samples"] = samples
        if any(plain.values()):
            fail(f"phase 22: a plain version ran on the card: {plain}")
    log(f"phase 22 (a): seq2seq pinned = host at atol 0; epoch s host "
        f"{stats['host']['epoch_s']:.2f}, pinned "
        f"{stats['pinned']['epoch_s']:.2f}; training captions/s host "
        f"{stats['host']['captions_per_s']:.0f}, pinned "
        f"{stats['pinned']['captions_per_s']:.0f}; factual losses "
        f"{[round(x, 3) for x in fac]}; samples {samples}")
    log(f"phase 22 (d): factual step at 0.8 p50 "
        f"{summary['p50_ms']:.2f} ms ({stats['steps']['captions_per_s']:.0f}"
        f" captions/s), the trace names ce_rows_kernel")
    stats["cli"] = seq2seq_cli_stages(cli_files, launches)
    stats["variants"] = senticap_variants(device)
    stats["config"] = {"V": V, "E": scfg.embed_size, "H": scfg.hidden_size,
                       "layers": scfg.num_layers, "dropout": scfg.dropout,
                       "max_seq_length": scfg.max_seq_length,
                       "T": T_STEPS, "batch": B_IMAGES,
                       "emotion_batch": B_EMOTION, "emotion_lines": S2S_EMO,
                       "epochs": S2S_EPOCHS, "ratio": 0.8}
    return launches, stats


def seq2seq_cli_stages(files: str, launches: dict) -> dict:
    """Phase 22 (b): ``cli.train --trainer seq2seq`` on phase 19's files
    (``files``: the vocabulary, cache and caption files it kept), with and
    without ``--device_resident``: the same log, the CE row passes once a
    step and chunk."""
    from icee_tpu_torch.data.captions import load_caption_dataset
    from icee_tpu_torch.data.vocab import load_vocab
    from icee_tpu_torch.ops import chunked_loss as cl

    def at(name):
        return os.path.join(files, name)

    vocab = load_vocab(at("vocab.pkl"))
    t_cap = 40 + 2
    n_fac = -(-len(load_caption_dataset(at("train.txt"), vocab)) // B_IMAGES)
    n_emo = -(-len(load_caption_dataset(at("happy.txt"), vocab))
              // B_EMOTION)
    per = (n_fac * -(-t_cap // cl.auto_t_chunk(B_IMAGES, t_cap))
           + 3 * n_emo * -(-(t_cap - 1) // cl.auto_t_chunk(B_EMOTION,
                                                           t_cap - 1)))
    want = {"ce_rows": S2S_CLI_EPOCHS * per,
            "ce_grad_rows": S2S_CLI_EPOCHS * per}
    stats, logs, emo = {}, {}, []
    stage_logs = at("stage_logs")
    os.makedirs(stage_logs, exist_ok=True)
    for key in ("happy", "sad", "angry"):
        emo += [f"--{key}_path", at("happy.txt"), f"--val_{key}_path",
                at("val_happy.txt")]
    for name, extra in (("seq2seq", []),
                        ("seq2seq_resident", ["--device_resident"])):
        logs[name] = at(f"{name}.log")
        st, counts, _ = cli_stage(name, "icee_tpu_torch.cli.train", [
            "--trainer", "seq2seq", "--vocab_path", at("vocab.pkl"),
            "--caption_path", at("train.txt"), "--val_caption_path",
            at("val.txt"), *emo, "--feature_cache", at("features.npz"),
            "--num_epochs", S2S_CLI_EPOCHS, "--caption_batch_size",
            B_IMAGES, "--language_batch_size", B_EMOTION, "--dropout",
            0.22, "--log_path", logs[name], "--model_path",
            at(f"models_{name}"), *extra], stage_logs, want, phase=22)
        launches[name] = counts
        stats[name] = st
    with open(logs["seq2seq"]) as f:
        host = f.read()
    with open(logs["seq2seq_resident"]) as f:
        resident = f.read()
    if host != resident or host.count("Epoch [") != 4 * S2S_CLI_EPOCHS:
        fail("phase 22 (b): the --device_resident run's log differs from "
             "the host loader's")
    stats["log"] = host.splitlines()
    log("phase 22 (b): cli.train --trainer seq2seq, s (import torch; run) "
        + ", ".join(f"{k} {stats[k]['wall_s']:.1f} "
                    f"({stats[k]['import_s']:.1f}; {stats[k]['run_s']:.1f})"
                    for k in ("seq2seq", "seq2seq_resident"))
        + "; the two logs equal")
    return stats


def senticap_variants(device) -> dict:
    """Phase 22 (c): ``adversarial.total_loss`` (MSQ_LOSS, the style
    regressor behind ``grad_reverse``) and ``encode_decode.loss`` at the
    COCO widths (E = H = 512, visual 4096, V = 8800, B = 128, T = 22), loss
    and every gradient on the card against the same on the CPU: the loss
    (a masked SUM) rtol 1e-5, each gradient within 1e-3 x its largest
    magnitude (phase 13's rule); ``grad_reverse`` negates on the card."""
    import numpy as np
    import torch

    from icee_tpu_torch.senticap import adversarial as adv
    from icee_tpu_torch.senticap import encode_decode as ed

    x = torch.randn(64, 32, device=device, requires_grad=True)
    g = torch.randn(64, 32, device=device)
    (got,) = torch.autograd.grad(adv.grad_reverse(x), x, g)
    if not torch.equal(got, -g):
        fail("phase 22 (c): grad_reverse does not negate on the card")
    ds = senticap_split(SC_B, 240)
    enc_words = senticap_split(SC_B, 241).X
    kw = dict(emb_size=SC_E, lstm_hidden_size=SC_H, visual_size=SC_VIS)
    out = {}
    for name, conf, init, loss in (
            ("adversarial", adv.adv_conf(**kw), adv.init_params,
             lambda p, c, t: adv.total_loss(p, c, t["X"], t["Y"], t["Xlen"],
                                            t["V"], t["style"])),
            ("encode_decode", ed.encdec_conf(**kw), ed.init_params,
             lambda p, c, t: ed.loss(p, c, t["X"], t["Y"], t["Xlen"],
                                     t["enc"], t["V"]))):
        params = init(torch.Generator().manual_seed(242), SC_V, conf)
        host = {"X": ds.X, "Y": ds.Y, "Xlen": ds.Xlen, "V": ds.V,
                "enc": enc_words, "style": np.arange(SC_B) % 2}
        res = []
        for dev in (torch.device("cpu"), device):
            leaves = []

            def put(tree):
                if isinstance(tree, dict):
                    return {k: put(v) for k, v in tree.items()}
                t = tree.detach().to(dev).requires_grad_(True)
                leaves.append(t)
                return t

            p = put(params)
            t = {k: torch.as_tensor(np.asarray(v)).to(dev)
                 for k, v in host.items()}
            if dev.type == "cuda":
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            value = loss(p, conf, t)
            grads = torch.autograd.grad(value, leaves, allow_unused=True)
            if dev.type == "cuda":
                torch.cuda.synchronize()
            res.append((value.item(), [
                (torch.zeros_like(l_) if gr is None else gr).detach().cpu()
                for l_, gr in zip(leaves, grads)],
                time.perf_counter() - t0))
        (lc, gc, sc), (lg, gg, sg) = res
        worst = max(float((a - b).abs().max())
                    / max(float(b.abs().max()), 1e-30)
                    for a, b in zip(gg, gc))
        if not abs(lg - lc) <= 1e-5 * abs(lc) or not worst <= 1e-3:
            fail(f"phase 22 (c) {name}: loss {lg} vs CPU {lc}, worst grad "
                 f"error {worst} of its largest magnitude")
        out[name] = {"loss": lg, "cpu_loss": lc, "worst_grad_rel": worst,
                     "card_s": sg, "cpu_s": sc}
    log("phase 22 (c): " + "; ".join(
        f"{k} loss {v['loss']:.4f} (CPU {v['cpu_loss']:.4f}), worst grad "
        f"{v['worst_grad_rel']:.2e} of its largest" for k, v in out.items())
        + "; grad_reverse negates on the card")
    return out


PAR_RANKS = 2              # phase 23: ranks, two on one card (gloo)
PAR_TIMED_STEPS = 8        # (e) timed steps a rank and mesh
PAR_LOSS_RTOL = 1e-5       # (a) the epochs' losses against phase 19's
PAR_GRAD_TOL = 1e-5        # (c) each grad within this x its largest |g|


def torchrun_cmd(wrapper: str, module: str, args, counts_path: str,
                 ratio=None, nproc: int = PAR_RANKS):
    """``python -m torch.distributed.run --standalone`` of ``nproc`` ranks,
    each running the stage wrapper (``CLI_WRAPPER``, written to
    ``wrapper``) around ``module``, its counter line written to
    ``<counts_path><RANK>.json``."""
    return [sys.executable, "-m", "torch.distributed.run", "--standalone",
            "--nproc_per_node", str(nproc), wrapper,
            json.dumps({"module": module, "ratio": ratio,
                        "counts_path": counts_path}), *map(str, args)]


def ranks_stage(name: str, wrapper: str, module: str, args, logs: str,
                want: dict, ratio=None, nproc: int = PAR_RANKS):
    """One CLI as ``nproc`` ranks under torchrun; it must exit 0 and every
    rank must launch ``want`` (every other count 0, no plain version).
    -> (stats with each rank's clocks, the counts summed over the ranks,
    stdout)."""
    t = time.perf_counter()
    counts_path = os.path.join(logs, f"{name}_counts_")
    proc = subprocess.run(torchrun_cmd(wrapper, module, args, counts_path,
                                       ratio, nproc),
                          cwd=ROOT, env=cli_env(), capture_output=True,
                          text=True, timeout=CLI_TIMEOUT_S)
    wall = time.perf_counter() - t
    log_path = os.path.join(logs, f"{name}.log")
    with open(log_path, "w") as f:
        f.write(proc.stdout + "\n--- stderr ---\n" + proc.stderr)
    if proc.returncode != 0:
        fail(f"phase 23 {name}: exit {proc.returncode}: "
             f"{proc.stderr[-3000:]}")
    recs = []
    for r in range(nproc):
        if os.path.exists(f"{counts_path}{r}.json"):
            with open(f"{counts_path}{r}.json") as f:
                recs.append(json.load(f)["cli_stage"])
    if [r["rank"] for r in recs] != list(range(nproc)):
        fail(f"phase 23 {name}: counter lines of ranks "
             f"{[r['rank'] for r in recs]} (output in {log_path})")
    total = {}
    for rec in recs:
        if any(rec["plain"].values()):
            fail(f"phase 23 {name}: a plain version ran on rank "
                 f"{rec['rank']}: {rec['plain']}")
        for k, n in rec["counts"].items():
            if n != want.get(k, 0):
                fail(f"phase 23 {name}: rank {rec['rank']} launched {k} "
                     f"{n} times, expected {want.get(k, 0)} (all counts "
                     f"{rec['counts']})")
            total[k] = total.get(k, 0) + n
    stats = {"wall_s": wall, "ranks": [
        {k: rec[k] for k in ("import_s", "cuda_init_s", "setup_s",
                             "run_s")} for rec in recs]}
    log(f"phase 23 {name}: {wall:.2f} s; per rank import torch "
        + ", ".join(f"{r['import_s']:.2f}" for r in stats["ranks"])
        + " s, CUDA start-up " + ", ".join(
            f"{r['cuda_init_s']:.2f}" for r in stats["ranks"])
        + " s, run " + ", ".join(f"{r['run_s']:.2f}"
                                 for r in stats["ranks"])
        + f" s; launches a rank { {k: n for k, n in want.items() if n} }")
    return stats, total, proc.stdout


def compare_runs(name: str, got_dir: str, got_name: str, want_dir: str,
                 want_name: str) -> dict:
    """A multi-rank training run's log and JSONL events against the
    one-process run's: the log's text with its numbers masked equal, the
    events' kinds equal, the losses within PAR_LOSS_RTOL, top-5 and BLEU-4
    equal, the learning rates 1e-6.  -> the largest differences."""
    import re

    def text(path):
        with open(path) as f:
            body = re.sub(r"Batch Time: [\d.]+, ", "", f.read())
        return re.sub(r"\d+\.\d+(e-?\d+)?", "#", body)

    def events(d, n):
        with open(os.path.join(d, f"{n}.jsonl")) as f:
            return [json.loads(line) for line in f]

    if text(os.path.join(got_dir, f"{got_name}.log")) != text(
            os.path.join(want_dir, f"{want_name}.log")):
        fail(f"phase 23 {name}: the log's text differs from phase 19's")
    got, want = events(got_dir, got_name), events(want_dir, want_name)
    if [e["event"] for e in got] != [e["event"] for e in want]:
        fail(f"phase 23 {name}: events {[e['event'] for e in got]}")
    diff = {"loss_rel": 0.0, "top5_abs": 0.0, "lr_rel": 0.0, "bleu4_abs": 0.0}
    for g, w in zip(got, want):
        for k in ("train_loss", "val_loss"):
            diff["loss_rel"] = max(diff["loss_rel"],
                                   abs(g[k] - w[k]) / abs(w[k]))
        diff["top5_abs"] = max(diff["top5_abs"], abs(g["top5"] - w["top5"]))
        diff["lr_rel"] = max(diff["lr_rel"], abs(g["lr"] - w["lr"]) / w["lr"])
        diff["bleu4_abs"] = max(diff["bleu4_abs"],
                                abs(g["bleu4"] - w["bleu4"]))
    if not (diff["loss_rel"] <= PAR_LOSS_RTOL and diff["top5_abs"] == 0
            and diff["bleu4_abs"] == 0 and diff["lr_rel"] <= 1e-6):
        fail(f"phase 23 {name}: against phase 19's one-process run {diff}")
    return diff


def parallel_rank(mesh, payload) -> dict:
    """Phase 23's work on each rank of a spawned world on the card: (c) one
    SentiCap base step's loss and gradients at DP 2 (phase 13's model,
    split and dropout masks, the global batch of SC_B rows), and (e) the
    StyleNet factual step (phase 9's weights and batch, B = 64 global) at
    DP 2 and at TP 2, timed; each part's launches counted from 0 and no
    plain version called."""
    import torch

    from icee_tpu_torch.core.config import (DecoderConfig, EncoderConfig,
                                            TrainConfig)
    from icee_tpu_torch.core.device import set_float32_precision
    from icee_tpu_torch.models import encoder
    from icee_tpu_torch.ops import chunked_loss as cl
    from icee_tpu_torch.ops import lstm_scan
    from icee_tpu_torch.ops import senticap_scan as ss
    from icee_tpu_torch.parallel.mesh import make_mesh
    from icee_tpu_torch.parallel.train import shard_decoder
    from icee_tpu_torch.senticap import io as sio
    from icee_tpu_torch.senticap import model
    from icee_tpu_torch.senticap.solver import make_solver
    from icee_tpu_torch.senticap.train import make_base_step
    from icee_tpu_torch.train import optim
    from icee_tpu_torch.train.steps import make_caption_steps

    set_float32_precision()
    device = mesh.device
    counters = {"fused_factored_scan_fwd": lstm_scan.factored_scan_fwd,
                "fused_factored_scan_bwd": lstm_scan.factored_scan_bwd,
                "fused_senticap_scan_fwd": ss.senticap_scan_fwd,
                "fused_senticap_scan_bwd": ss.senticap_scan_bwd,
                "ce_rows": cl.ce_rows, "ce_grad_rows": cl.ce_grad_rows}

    def counted(fn):
        for c in counters.values():
            c.launches = 0
        with plain_counters() as plain:
            out = fn()
            if device.type == "cuda":
                torch.cuda.synchronize()
        return out, {k: c.launches for k, c in counters.items()}, \
            dict(plain)

    res = {"rank": mesh.rank}
    # (c) SentiCap base, DP 2
    conf = senticap_conf_full()
    step = make_base_step(conf, make_solver(conf), mesh, device)
    data = sio.device_dataset(senticap_split(4 * SC_B, 80), device)
    g = torch.Generator(device=device).manual_seed(82)
    masks = dict(x_drop=(torch.rand((SC_B, SC_T, SC_E), generator=g,
                                    device=device) < 0.5).float() * 2.0,
                 y_drop=(torch.rand((SC_B, SC_T, SC_H), generator=g,
                                    device=device) < 0.5).float() * 2.0)
    params = model.init_params(torch.Generator().manual_seed(81), SC_V,
                               conf, device=device)
    idx = torch.arange(SC_B, device=device)
    (loss, grads), counts, plain = counted(
        lambda: step.grads(params, data, idx, **masks))
    res["senticap"] = {"loss": loss.item(), "counts": counts,
                       "plain": plain, "grads": {
                           k: v.cpu() for k, v in grads.items()}}
    # (e) the StyleNet factual step at DP 2 and TP 2
    cfg = DecoderConfig(vocab_size=V, embed_size=E, hidden_size=H,
                        factored_size=F, dropout=0.5)
    tcfg = TrainConfig(teacher_forcing_ratio=1.0)
    res["steps"] = {}
    for shape in ((PAR_RANKS, 1), (1, PAR_RANKS)):
        m = mesh if shape == mesh.shape else make_mesh(
            shape, device=device, backend=mesh.backend)
        steps = make_caption_steps(cfg, tcfg, optim.make_adam(1e-3, tcfg),
                                   optim.make_adam(1e-3, tcfg),
                                   device=device, mesh=m)
        dec = training_decoder(device, 12)
        dec["C_b"].zero_()
        dec = shard_decoder(dec, m)
        head = encoder.init_head_params(torch.Generator().manual_seed(13),
                                        EncoderConfig(embed_size=E),
                                        device=device)
        batch = training_batch(device, B_IMAGES, 20)
        gen = torch.Generator(device=device).manual_seed(41)
        state = steps.optimizer.init((dec, head))

        def one():
            return steps.factual_train_step(dec, head, state, *batch,
                                            generator=gen)[3]

        loss, counts, plain = counted(one)
        ms = step_ms(one, PAR_TIMED_STEPS) if device.type == "cuda" else None
        res["steps"][f"{shape[0]}x{shape[1]}"] = {
            "first_loss": loss.item(), "counts": counts, "plain": plain,
            "step_ms": ms}
    return res


def parallel_world(device, backend: str) -> list:
    """Phase 23 (c) and (e) as a spawned world of PAR_RANKS ranks on the
    card -> each rank's results."""
    from icee_tpu_torch.parallel.launch import spawn

    with tempfile.TemporaryDirectory() as work:
        return spawn(parallel_rank, PAR_RANKS, None, workdir=work,
                     shape=(PAR_RANKS, 1), device="cuda", backend=backend)


def parallel_phase(device, keep: str, one_step_ms: float):
    """Phase 23: the data- and tensor-parallel port (slice 8) as processes
    on the card, two ranks sharing it over gloo.  (a) ``cli.train
    --data_parallel`` under torchrun over phase 19's feature cache, at DP 2
    and at ``--tensor_parallel 2``: phase 19's ``train`` stage, whose log
    and events it must give (``compare_runs``); (b) ``evaluate
    --data_parallel``: phase 19's ``evaluate --feed_feature`` (K2) and
    ``evaluate --attention`` (K7) lines, token for token; (c) one SentiCap
    base step at DP 2: loss and gradients against one process's on the
    card; (d) with two cards or more, (a) over NCCL, one rank a card; (e)
    the seconds of a rank's start and its step ms at DP 2 and TP 2 beside
    phase 9's one-process step.  Launches exact on every rank, no plain
    version.  The stages of (a) run at once, then those of (b).  ->
    (launches summed over the ranks, stats)."""
    import torch

    from icee_tpu_torch.ops import chunked_loss as cl

    m = "icee_tpu_torch.cli."
    stats, launches = {}, {}

    def add(counts):
        for k, n in counts.items():
            launches[k] = launches.get(k, 0) + n

    with tempfile.TemporaryDirectory() as root:
        logs = os.path.join(root, "logs")
        os.makedirs(logs)
        wrapper = os.path.join(root, "stage_wrapper.py")
        with open(wrapper, "w") as f:
            f.write(CLI_WRAPPER)
        vocab = os.path.join(keep, "vocab.pkl")
        cache = os.path.join(keep, "features.npz")
        t_cap = STEPS + 2

        def ce(b_fac, b_emo):
            """CE row-pass launches of a rank's training steps at these
            local batches: one a time chunk."""
            n_fac = -(-CLI_IMAGES * TR_CAPS // CLI_BATCH)
            n_emo = -(-CLI_EMO_IMAGES * TR_CAPS // B_EMOTION)
            return CLI_EPOCHS * sum(
                n * -(-t_cap // cl.auto_t_chunk(b, t_cap))
                for n, b in ((n_fac, b_fac), (n_emo, b_emo)))

        steps = CLI_EPOCHS * (-(-CLI_IMAGES * TR_CAPS // CLI_BATCH)
                              + -(-CLI_EMO_IMAGES * TR_CAPS // B_EMOTION))
        runs = [("train_dp2", ["--dist_backend", "gloo"],
                 (CLI_BATCH // PAR_RANKS, B_EMOTION // PAR_RANKS)),
                ("train_tp2", ["--dist_backend", "gloo", "--tensor_parallel",
                               PAR_RANKS], (CLI_BATCH, B_EMOTION))]
        if torch.cuda.device_count() >= PAR_RANKS:
            runs.append(("train_dp2_nccl", [],
                         (CLI_BATCH // PAR_RANKS, B_EMOTION // PAR_RANKS)))
        else:
            stats["train_dp2_nccl"] = (f"not run: {torch.cuda.device_count()}"
                                       " card(s), NCCL takes one a rank")

        def train_stage(name, extra, b_fac, b_emo):
            n_ce = ce(b_fac, b_emo)
            return ranks_stage(name, wrapper, m + "train", [
                "--trainer", "multitask", "--family", "stylenet", "--mode",
                "happy", "--vocab_path", vocab, "--caption_path",
                os.path.join(keep, "train.txt"), "--val_caption_path",
                os.path.join(keep, "val.txt"), "--happy_path",
                os.path.join(keep, "happy.txt"), "--val_happy_path",
                os.path.join(keep, "val_happy.txt"), "--feature_cache",
                cache, "--num_epochs", CLI_EPOCHS, "--caption_batch_size",
                CLI_BATCH, "--language_batch_size", B_EMOTION,
                "--model_path", os.path.join(root, name), "--log_path",
                os.path.join(root, f"{name}.log"), "--metrics_path",
                os.path.join(root, f"{name}.jsonl"), "--data_name", "chip",
                "--log_step", 10 ** 9, "--log_step_emotion", 10 ** 9,
                "--data_parallel", *extra], logs,
                {"fused_factored_scan_fwd": steps,
                 "fused_factored_scan_bwd": steps, "ce_rows": n_ce,
                 "ce_grad_rows": n_ce, "mega_beam_decode": 2 * CLI_EPOCHS},
                ratio=1.0)

        # (b) evaluate over two ranks: phase 19's one-card lines
        n_val = CLI_VAL_IMAGES * TR_CAPS
        evals = (("evaluate_feed_feature", [
                      "--feature_cache", cache, "--checkpoint_path",
                      os.path.join(keep, "seeded_checkpoint"), "--mode",
                      CLI_STYLE, "--feed_feature"], "mega_beam_decode"),
                 ("evaluate_attention", [
                      "--feature_cache", os.path.join(keep, "spatial.npz"),
                      "--attention"], "mega_att_beam_decode"))

        def eval_stage(name, args, kernel):
            return ranks_stage(
                f"{name}_dp2", wrapper, m + "evaluate", args + [
                    "--vocab_path", vocab, "--test_path",
                    os.path.join(keep, "val.txt"), "--batch_size",
                    CLI_BATCH, "--data_parallel", "--dist_backend", "gloo"],
                logs, {kernel: -(-n_val // CLI_BATCH)})

        # the stages of (a), then of (b), run at once: their ranks share
        # the card (each stage's seconds then include the others' load)
        with ThreadPoolExecutor(len(runs)) as pool:
            done = [(name, pool.submit(train_stage, name, extra, *b))
                    for name, extra, b in runs]
            for name, job in done:
                st, counts, _ = job.result()
                add(counts)
                st["against_one_process"] = compare_runs(name, root, name,
                                                         keep, "chip")
                st["checkpoints"] = sorted(os.listdir(os.path.join(root,
                                                                   name)))
                stats[name] = st
        with ThreadPoolExecutor(len(evals)) as pool:
            done = [(name, pool.submit(eval_stage, name, args, kernel))
                    for name, args, kernel in evals]
            for name, job in done:
                st, counts, out = job.result()
                add(counts)
                with open(os.path.join(keep, f"{name}.out")) as f:
                    want = [ln for ln in f.read().splitlines()
                            if ln.startswith(("ref ", "pred ", "BLEU-"))]
                got = [ln for ln in out.splitlines()
                       if ln.startswith(("ref ", "pred ", "BLEU-"))]
                if got != want or len(want) != 2 * n_val + 4:
                    fail(f"phase 23 {name}_dp2: {len(got)} lines, "
                         f"{sum(a != b for a, b in zip(got, want))} differ "
                         "from phase 19's one-card run")
                st["lines_equal"] = len(got)
                stats[f"{name}_dp2"] = st

    world_launches, world = parallel_world_checks(device, one_step_ms)
    add(world_launches)
    stats.update(world)
    stats["config"] = {"ranks": PAR_RANKS, "backend": "gloo",
                       "cards": torch.cuda.device_count(),
                       "train_batch": CLI_BATCH, "emotion_batch": B_EMOTION,
                       "epochs": CLI_EPOCHS, "V": V, "E": E, "H": H, "F": F}
    return launches, stats


def parallel_world_checks(device, one_step_ms: float):
    """Phase 23 (c) and (e): the spawned world's results held to one
    process's on the card -> (launches summed over the ranks, stats)."""
    import torch

    from icee_tpu_torch.ops import chunked_loss as cl
    from icee_tpu_torch.senticap import io as sio
    from icee_tpu_torch.senticap import model
    from icee_tpu_torch.senticap.solver import make_solver
    from icee_tpu_torch.senticap.train import make_base_step

    stats, launches = {}, {}

    def add(counts):
        for k, n in counts.items():
            launches[k] = launches.get(k, 0) + n

    t = time.perf_counter()
    ranks = parallel_world(device, "gloo")
    stats["world_s"] = time.perf_counter() - t
    sc = [r["senticap"] for r in ranks]
    for r in ranks:
        for part in (r["senticap"], *r["steps"].values()):
            if any(part["plain"].values()):
                fail(f"phase 23: a plain version ran on rank {r['rank']}: "
                     f"{part['plain']}")
    for r in sc:
        want = {"fused_senticap_scan_fwd": 1, "fused_senticap_scan_bwd": 1,
                "ce_rows": -(-SC_T // cl.auto_t_chunk(SC_B // PAR_RANKS,
                                                      SC_T))}
        want["ce_grad_rows"] = want["ce_rows"]
        if {k: n for k, n in r["counts"].items() if n} != want:
            fail(f"phase 23 (c): launches {r['counts']}, expected {want}")
        add(r["counts"])
    conf = senticap_conf_full()
    step = make_base_step(conf, make_solver(conf), device=device)
    data = sio.device_dataset(senticap_split(4 * SC_B, 80), device)
    g = torch.Generator(device=device).manual_seed(82)
    masks = dict(x_drop=(torch.rand((SC_B, SC_T, SC_E), generator=g,
                                    device=device) < 0.5).float() * 2.0,
                 y_drop=(torch.rand((SC_B, SC_T, SC_H), generator=g,
                                    device=device) < 0.5).float() * 2.0)
    params = model.init_params(torch.Generator().manual_seed(81), SC_V,
                               conf, device=device)
    loss, grads = step.grads(params, data, torch.arange(SC_B, device=device),
                             **masks)
    errs = {k: ((sc[0]["grads"][k] - v.cpu()).abs().max()
                / v.abs().max().clamp(min=1e-30)).item()
            for k, v in grads.items()}
    loss_err = abs(sc[0]["loss"] - loss.item()) / abs(loss.item())
    same = all(torch.equal(sc[1]["grads"][k], sc[0]["grads"][k])
               for k in grads) and sc[1]["loss"] == sc[0]["loss"]
    if not (same and loss_err <= 1e-5 and max(errs.values()) <= PAR_GRAD_TOL):
        fail(f"phase 23 (c): ranks equal {same}, loss rel err {loss_err}, "
             f"grad err / max|g| {errs}")
    stats["senticap_dp2_step"] = {
        "loss_rel_err": loss_err, "grad_err_over_max": max(errs.values()),
        "ranks_equal": same}
    # (e) step ms a rank, DP 2 and TP 2, beside phase 9's one process
    stats["factual_step_ms"] = {"one_process": one_step_ms}
    for mesh_name in ranks[0]["steps"]:
        per = [r["steps"][mesh_name] for r in ranks]
        b_local = B_IMAGES // PAR_RANKS if mesh_name.endswith("x1") \
            else B_IMAGES
        want = {"fused_factored_scan_fwd": 1, "fused_factored_scan_bwd": 1,
                "ce_rows": -(-T_STEPS // cl.auto_t_chunk(b_local, T_STEPS))}
        want["ce_grad_rows"] = want["ce_rows"]
        for p in per:
            if {k: n for k, n in p["counts"].items() if n} != want:
                fail(f"phase 23 (e) {mesh_name}: launches {p['counts']}, "
                     f"expected {want}")
            add(p["counts"])
        if len({p["first_loss"] for p in per}) != 1:
            fail(f"phase 23 (e) {mesh_name}: the ranks' losses differ: "
                 f"{[p['first_loss'] for p in per]}")
        stats["factual_step_ms"][mesh_name] = [p["step_ms"] for p in per]
    return launches, stats


# --- phase 24: hidden widths and batches past the resident plan --------------
#
# K3, K4 and K8 where no resident partition of the recurrence fits (H from
# 736, large B): a direction streams W_h's planes (csrc/scan_grid.cuh's
# plans of kind SG_STREAMED).  (a) each scan against its plain version at
# the shapes below; (b) K5 factored at H = F = 1024; (c) the train and
# evaluate CLIs at --hidden_size 1024; (d) SentiCap at H = 1024.

# (kernel, B, H): K3 and K4 at E = 300, F = H, T = 25; K8 at E = 512,
# T = 22, gclip 5.0
WIDE_SCANS = (("K3", 64, 736), ("K3", 64, 1024), ("K3", 64, 2048),
              ("K3", 2048, 512), ("K4", 64, 736), ("K4", 64, 1024),
              ("K4", 64, 2048), ("K8", 128, 1024))
WIDE_H = 1024                 # the width of (b), (c), (d) and the entries
WIDE_SC_IMAGES = 8            # (d): decode_split's images at beam 20
WIDE_WRAPPERS = {"K3": ("factored_scan_fwd", "factored_scan_bwd"),
                 "K4": ("nic_scan_fwd", "nic_scan_bwd"),
                 "K8": ("senticap_scan_fwd", "senticap_scan_bwd")}
KIND_NAMES = ("resident", "streamed")


def wide_scan_flops_bytes(kernel: str, b: int, t: int, e: int, h: int):
    """(fwd flops, bwd flops, fwd bytes, bwd bytes) of K3 (F = H), K4 or
    K8 at (B, T, E, H): the products over all rows, the recurrence, the
    backward's (T - 1) recurrent dh products; each weight and activation
    read once, each output written once."""
    n, h4 = b * t, 4 * h
    if kernel == "K3":
        f = h
        fwd = 2 * n * (e * 4 * f + 4 * f * f + 4 * f * h + h * h4)
        bwd = (2 * n * (h * h4 + 8 * f * h + 8 * f * f + 8 * e * f)
               + 2 * b * (t - 1) * h4 * h)
        w = e * 4 * f + 4 * f + 4 * f * f + 4 * f + 4 * f * h + h4 + h * h4 \
            + h4
        saved = n * (8 * f + h4)
        return (fwd, bwd, 4 * (w + n * e + 2 * n * h + saved),
                4 * (2 * w + 2 * n * e + 3 * n * h + saved))
    if kernel == "K4":
        w = e * h4 + h * h4 + 2 * h4
        fwd = 2 * n * (e + h) * h4
        bwd = 2 * n * h4 * (2 * e + h) + 2 * b * (t - 1) * h4 * h
    else:
        w = (e + h) * h4
        fwd = 2 * n * (e + h) * h4
        bwd = (2 * n * (e + h) * h4 + 2 * n * h4 * e
               + 2 * b * (t - 1) * h4 * h)
    return (fwd, bwd, 4 * (w + n * e + 2 * n * h + n * h4),
            4 * (2 * w + 2 * n * e + 3 * n * h + n * h4))


def wide_scan_case(kernel: str, b: int, h: int, device):
    """(forward, backward, plain forward, plain backward, library forward
    or None, library backward or None, plain versions' arguments) of one
    phase 24 (a) shape, its inputs seeded from (B, H)."""
    import torch

    from icee_tpu_torch.ops import lstm_scan, nic_scan
    from icee_tpu_torch.ops import senticap_scan as ss

    seed = 240 + b + h
    g = torch.Generator(device=device).manual_seed(seed)

    def uni(shape, fan, scale=1.0):
        return scale * (2 * torch.rand(shape, generator=g, device=device)
                        - 1) / math.sqrt(fan)

    def nrm(shape, scale):
        return scale * torch.randn(shape, generator=g, device=device)

    if kernel == "K3":
        e, f, t = E, h, T_STEPS
        p = {"V_w": uni((e, 4 * f), e), "V_b": nrm((4, f), 0.1),
             "S_w": uni((4, f, f), f), "S_b": nrm((4, f), 0.1),
             "U_w": uni((4, f, h), f), "U_b": nrm((4, h), 0.1),
             "W_w": uni((h, 4 * h), h, 1.5), "W_b": nrm((4, h), 0.1)}
        x, dh = nrm((b, t, e), 0.5), nrm((b, t, h), 0.02)

        def fwd():
            return lstm_scan.factored_scan_fwd(p, x)

        def bwd(hs, cs, saved):
            return lstm_scan.factored_scan_bwd(p, x, hs, cs, dh, saved)

        return (lstm_scan, fwd, bwd,
                lambda: lstm_scan.fused_factored_scan_plain(p, x),
                lambda hs, cs: lstm_scan.factored_scan_bwd_plain(
                    p, x, hs, cs, dh), None, None, (e, t))
    if kernel == "K4":
        e, t = E, T_STEPS
        cell = {"W_ih": uni((e, 4 * h), e), "W_hh": uni((h, 4 * h), h, 1.5),
                "b_ih": nrm((4 * h,), 0.1), "b_hh": nrm((4 * h,), 0.1)}
        x, dh = nrm((b, t, e), 0.5), nrm((b, t, h), 0.02)
        lstm = torch.nn.LSTM(e, h, batch_first=True).to(device)
        with torch.no_grad():
            lstm.weight_ih_l0.copy_(cell["W_ih"].T)
            lstm.weight_hh_l0.copy_(cell["W_hh"].T)
            lstm.bias_ih_l0.copy_(cell["b_ih"])
            lstm.bias_hh_l0.copy_(cell["b_hh"])
        xl = x.detach().clone().requires_grad_(True)
        lib_h, _ = lstm(xl)
        lib_inputs = [xl, *lstm.parameters()]

        def lib_fwd():
            with torch.no_grad():
                return lstm(x)[0]

        def lib_bwd():
            return torch.autograd.grad(lib_h, lib_inputs, dh,
                                       retain_graph=True)

        def fwd():
            return nic_scan.nic_scan_fwd(cell, x)

        def bwd(hs, cs, gates):
            return nic_scan.nic_scan_bwd(cell, x, hs, cs, dh, gates)

        return (nic_scan, fwd, bwd,
                lambda: nic_scan.fused_nic_scan_plain(cell, x),
                lambda hs, cs: nic_scan.nic_scan_bwd_plain(cell, x, hs, cs,
                                                           dh),
                lib_fwd, lib_bwd, (e, t))
    e, t, gclip = SC_E, SC_T, 5.0
    w = uni((e + h, 4 * h), e + h, 1.2)
    x, dh = nrm((b, t, e), 1.0), nrm((b, t, h), 1.0)

    def fwd():
        return ss.senticap_scan_fwd(w, x)

    def bwd(hs, cs, gates):
        return ss.senticap_scan_bwd(w, x, hs, cs, dh, gclip, gates)

    return (ss, fwd, bwd, lambda: ss.fused_senticap_scan_plain(w, x),
            lambda hs, cs: ss.senticap_scan_bwd_plain(w, x, hs, cs, dh,
                                                      gclip),
            None, None, (e, t))


def wide_grads(got):
    """A backward's (dx, grads) as {name: tensor} (K8's grads are dW)."""
    dx, grads = got
    out = {"x": dx}
    out.update(grads.items() if isinstance(grads, dict) else [("W", grads)])
    return out


def check_wide_scan(kernel: str, b: int, h: int, device,
                    phase: str = "24 (a)") -> dict:
    """Phase 24 (a) (or ``phase``), one shape: the scan's forward and backward on the card
    against its plain versions, held as phase 7 holds them (h and c atol
    1e-4; dx and each weight grad <= 1e-3 x its largest magnitude; the
    same bits twice), its plan's kinds, exactly one recurrence launch a
    direction (the library's count and the wrappers'), device ms by launch
    group, times beside the bound and, for K4, cuDNN's ``nn.LSTM`` (h atol
    1e-4) as the library call."""
    import torch

    from icee_tpu_torch.ops import scan_grid

    mod, fwd, bwd, plain_f, plain_b, lib_f, lib_b, (e, t) = wide_scan_case(
        kernel, b, h, device)
    plan = scan_grid.plan_on(kernel, b, h, device)
    what = f"phase {phase} {kernel} B {b} H {h}"
    lib = mod._library()
    wrappers = [getattr(mod, n) for n in WIDE_WRAPPERS[kernel]]
    counts = [w.launches for w in wrappers]
    torch.cuda.synchronize()
    before = lib.icee_scan_recurrence_launches()
    h_seq, c_seq, saved = fwd()
    torch.cuda.synchronize()
    mid = lib.icee_scan_recurrence_launches()
    got = wide_grads(bwd(h_seq, c_seq, saved))
    torch.cuda.synchronize()
    after = lib.icee_scan_recurrence_launches()
    if (mid - before, after - mid) != (1, 1):
        fail(f"{what}: recurrence launches {mid - before} forward, "
             f"{after - mid} backward, expected one each")
    if [w.launches - n for w, n in zip(wrappers, counts)] != [1, 1]:
        fail(f"{what}: the wrappers counted "
             f"{[w.launches - n for w, n in zip(wrappers, counts)]}")
    h2, c2, saved2 = fwd()
    again = wide_grads(bwd(h_seq, c_seq, saved))
    want_h, want_c = plain_f()
    want = wide_grads(plain_b(h_seq, c_seq))
    torch.cuda.synchronize()
    fwd_err = max((h_seq - want_h).abs().max().item(),
                  (c_seq - want_c).abs().max().item())
    if not fwd_err <= 1e-4:
        fail(f"{what} forward: max abs error {fwd_err} > 1e-4")
    rel = {k: max_rel_err(got[k], want[k]) for k in want}
    for name, err in rel.items():
        if not err <= 1e-3:
            fail(f"{what} backward: d{name} error {err} x max|g| > 1e-3")
    if not (torch.equal(h_seq, h2) and torch.equal(c_seq, c2)
            and all(torch.equal(got[k], again[k]) for k in got)):
        fail(f"{what}: two runs on the same inputs differ")
    abs_b = max((got[k] - want[k]).abs().max().item() for k in want)
    del h2, c2, saved2, again, want_h, want_c, want
    out = {"B": b, "H": h, "E": e, "T": t,
           "plan": {"forward": KIND_NAMES[plan.f_kind],
                    "backward": KIND_NAMES[plan.b_kind],
                    "f_units": plan.f_units, "f_blocks": plan.f_blocks,
                    "f_stages": plan.f_stages, "b_units": plan.b_units,
                    "b_kc": plan.b_kc, "b_splits": plan.b_splits,
                    "b_blocks": plan.b_blocks, "b_stages": plan.b_stages},
           "fwd_max_abs_err": fwd_err, "bwd_max_abs_err": abs_b,
           "bwd_max_rel_err": max(rel.values())}
    if lib_f is not None:
        lib_err = (lib_f() - h_seq).abs().max().item()
        if not lib_err <= 1e-4:
            fail(f"{what} vs cuDNN nn.LSTM: h max abs error {lib_err} > "
                 "1e-4")
        out["library_max_abs_err"] = lib_err
    out["device_ms_by_group_fwd"] = scan_device_groups(
        f"{what} forward", fwd, mod)
    out["device_ms_by_group_bwd"] = scan_device_groups(
        f"{what} backward", lambda: bwd(h_seq, c_seq, saved), mod)
    out["fwd_ms"] = cuda_ms(fwd, 5)
    out["bwd_ms"] = cuda_ms(lambda: bwd(h_seq, c_seq, saved), 5)
    out["plain_fwd_ms"] = cuda_ms(plain_f, 2)
    out["plain_bwd_ms"] = cuda_ms(lambda: plain_b(h_seq, c_seq), 2)
    out["library_fwd_ms"] = None if lib_f is None else cuda_ms(lib_f, 5)
    out["library_bwd_ms"] = None if lib_b is None else cuda_ms(lib_b, 5)
    flops_f, flops_b, bytes_f, bytes_b = wide_scan_flops_bytes(kernel, b, t,
                                                               e, h)
    out["bound_fwd_ms"], out["bound_fwd_by"] = bound_ms(flops_f, bytes_f)
    out["bound_bwd_ms"], out["bound_bwd_by"] = bound_ms(flops_b, bytes_b)
    log(f"{what}: plan {out['plan']}; h/c err {fwd_err:.3g}, grads err / "
        f"max|g| {max(rel.values()):.3g}; ms fwd {out['fwd_ms']:.3f} (plain "
        f"{out['plain_fwd_ms']:.3f}, bound {out['bound_fwd_ms']:.3f}), bwd "
        f"{out['bwd_ms']:.3f} (plain {out['plain_bwd_ms']:.3f}, bound "
        f"{out['bound_bwd_ms']:.3f})"
        + ("" if lib_f is None else
           f"; cuDNN fwd {out['library_fwd_ms']:.3f}, bwd "
           f"{out['library_bwd_ms']:.3f}, h err "
           f"{out['library_max_abs_err']:.3g}"))
    return out


def check_wide_scans(device) -> dict:
    """Phase 24 (a): every WIDE_SCANS shape -> {"K3 B64 H1024": stats}."""
    import torch

    out = {}
    for kernel, b, h in WIDE_SCANS:
        out[f"{kernel} B{b} H{h}"] = check_wide_scan(kernel, b, h, device)
        torch.cuda.empty_cache()
    return out


@contextlib.contextmanager
def widths(**kw):
    """This module's width constants (H, F, SC_H ...) set to ``kw`` for the
    block's duration: phase 24 runs phase 10's, 13's and 14's checks, which
    read them, at H = 1024."""
    old = {k: globals()[k] for k in kw}
    globals().update(kw)
    try:
        yield
    finally:
        globals().update(old)


def wide_k5(device) -> dict:
    """Phase 24 (b): K5, factored, sampled at ratio 0.8, at H = F = 1024
    (B = 128, T = 25), both directions against its plain versions as phase
    10 holds them (``check_k5``)."""
    with widths(H=WIDE_H, F=WIDE_H):
        fwd, bwd = check_k5("factored", True, device)
    keep = ("max_abs_err", "max_rel_err", "trace_flips", "ms", "plain_ms",
            "library_ms", "bound_ms", "bound_by", "device_ms_by_group")
    return {"H": WIDE_H, "F": WIDE_H, "B": B_ATT, "T": T_STEPS,
            "fwd": {k: fwd[k] for k in keep if k in fwd},
            "bwd": {k: bwd[k] for k in keep if k in bwd}}


def wide_cli(device, keep: str) -> tuple:
    """Phase 24 (c): the train CLI at --hidden_size 1024, one epoch a
    family at ratio 1.0 (every step teacher-forced: K3 or K4 a step):
    StyleNet (F = 1024) over ``big_batch_files``' BIG_B captions at
    --caption_batch_size BIG_B (one factual step of BIG_B rows through K3:
    phase 28's batch past 2048), then NIC over phase 19's corpus and
    feature cache (``keep``) at CLI_BATCH; phase 19's emotion captions
    for both; their K3 / K4, CE and K2 counts exact and no plain version;
    then ``evaluate --feed_feature`` on the StyleNet checkpoint: its BLEU that
    of this process's ``evaluate()`` (K2), each printed line the plain
    search's of its image or a near tie (phase 19's rule).  -> (launches,
    stats)."""
    from icee_tpu_torch.checkpoint.ckpt import load_params
    from icee_tpu_torch.cli.evaluate import evaluate
    from icee_tpu_torch.core.config import DecoderConfig, mode_id
    from icee_tpu_torch.data.captions import load_caption_dataset
    from icee_tpu_torch.data.vocab import load_vocab
    from icee_tpu_torch.ops import chunked_loss as cl

    import numpy as np

    m = "icee_tpu_torch.cli."
    launches, stats = {}, {}
    logs = os.path.join(keep, "wide_logs")
    os.makedirs(logs, exist_ok=True)
    files = {n: os.path.join(keep, f"{n}.txt")
             for n in ("train", "val", "happy", "val_happy")}
    vocab_path = os.path.join(keep, "vocab.pkl")
    cache = os.path.join(keep, "features.npz")
    t_cap = STEPS + 2
    n_emo = -(-CLI_EMO_IMAGES * TR_CAPS // B_EMOTION)
    big_train, big_cache = big_batch_files(keep)
    for family, scan, beam, extra, (caps, feats, batch, n_cap) in (
            ("stylenet", "fused_factored_scan", "mega_beam_decode",
             ["--factored_size", WIDE_H], (big_train, big_cache, BIG_B,
                                           BIG_B)),
            ("nic", "fused_nic_scan", "mega_beam_decode_lstm", [],
             (files["train"], cache, CLI_BATCH, CLI_IMAGES * TR_CAPS))):
        n_fac = -(-n_cap // batch)
        steps = n_fac + n_emo
        ce = sum(n * -(-t_cap // cl.auto_t_chunk(b, t_cap))
                 for n, b in ((n_fac, batch), (n_emo, B_EMOTION)))
        name = f"train_{family}_h{WIDE_H}"
        st, counts, _ = cli_stage(name, m + "train", [
            "--trainer", "multitask", "--family", family, "--mode", "happy",
            "--hidden_size", WIDE_H, *extra, "--vocab_path", vocab_path,
            "--caption_path", caps, "--val_caption_path",
            files["val"], "--happy_path", files["happy"],
            "--val_happy_path", files["val_happy"], "--feature_cache", feats,
            "--num_epochs", 1, "--caption_batch_size", batch,
            "--language_batch_size", B_EMOTION, "--model_path",
            os.path.join(keep, f"models_{name}"), "--log_path",
            os.path.join(logs, f"{name}.txt"), "--metrics_path",
            os.path.join(logs, f"{name}.jsonl"), "--data_name", name,
            "--log_step", 10 ** 9, "--log_step_emotion", 10 ** 9], logs,
            {f"{scan}_fwd": steps, f"{scan}_bwd": steps, "ce_rows": ce,
             "ce_grad_rows": ce, beam: 2}, ratio=1.0, phase=24)
        with open(os.path.join(logs, f"{name}.jsonl")) as f:
            losses = [e["train_loss"] for e in map(json.loads, f)
                      if e["event"] == "epoch_factual"]
        if len(losses) != 1 or not np.isfinite(losses[0]):
            fail(f"phase 24 (c) {name}: factual losses {losses}")
        stats[name] = dict(st, steps=steps, factual_batch=batch,
                           train_loss=losses,
                           captions_per_s=(n_cap + CLI_EMO_IMAGES * TR_CAPS)
                           / st["wall_s"])
        for k, n in counts.items():
            launches[k] = launches.get(k, 0) + n
    # evaluate on the StyleNet checkpoint, serving semantics
    name = f"train_stylenet_h{WIDE_H}"
    models = os.path.join(keep, f"models_{name}")
    best = os.path.join(models, f"HAP_BEST_checkpoint_{name}")
    if not os.path.isdir(best):
        best = os.path.join(models, f"HAP_checkpoint_{name}")
    vocab = load_vocab(vocab_path)
    dataset = load_caption_dataset(files["val"], vocab)
    n_val = len(dataset)
    st, counts, out = cli_stage(
        f"evaluate_h{WIDE_H}", m + "evaluate", [
            "--vocab_path", vocab_path, "--feature_cache", cache,
            "--batch_size", CLI_BATCH, "--checkpoint_path", best,
            "--test_path", files["val"], "--mode", "happy",
            "--feed_feature"], logs,
        {"mega_beam_decode": -(-n_val // CLI_BATCH)}, phase=24)
    for k, n in counts.items():
        launches[k] = launches.get(k, 0) + n
    w = load_params(best, device)
    cfg = DecoderConfig(vocab_size=V, embed_size=E, hidden_size=WIDE_H,
                        factored_size=WIDE_H, max_seq_length=STEPS)
    with np.load(cache) as f:
        feats = dict(f)
    got = bleu_lines(out)
    want = evaluate(w["decoder"], w["head"], cfg, vocab, dataset,
                    feats.__getitem__, mode_id("happy"),
                    batch_size=CLI_BATCH, k=K, print_pairs=False,
                    feed_feature=True, device=device)
    if got != list(want):
        fail(f"phase 24 (c) evaluate: BLEU {got} != the in-process "
             f"evaluate()'s {list(want)}")
    names = sorted({ex.image for ex in dataset})
    style = mode_id("happy")
    tiled, kern, plain, rescored = cli_searches(
        w["decoder"], w["head"], feats, names, style, vocab, device)
    _, _, search_flips = margin_check("phase 24 (c) K2 at H 1024", kern,
                                      plain, rescored)
    flips = check_eval_lines("phase 24 (c) evaluate", out, dataset,
                             {n: i for i, n in enumerate(names)}, tiled,
                             plain, w["decoder"], style, vocab)
    stats[f"evaluate_h{WIDE_H}"] = dict(
        st, bleu=got, near_tie_flips=flips, search_near_tie_flips=search_flips,
        captions_per_s=n_val / st["wall_s"])
    return launches, stats


def wide_senticap(device) -> tuple:
    """Phase 24 (d): SentiCap at H = 1024 (phase 13's COCO regime
    otherwise): one base step, kernel path against plain (phase 13 (i)),
    K8 launched once a direction; then ``decode_split`` of
    WIDE_SC_IMAGES images at beam 20 through K9 (one launch), its
    captions those of this process's K9 search of the same features, which
    holds margin-aware against the plain search (phase 14's rule).  ->
    (launches, stats)."""
    import torch

    from icee_tpu_torch.ops import chunked_loss as cl
    from icee_tpu_torch.ops import senticap_decode as sd
    from icee_tpu_torch.ops import senticap_scan as ss
    from icee_tpu_torch.senticap import io as sio
    from icee_tpu_torch.senticap import model
    from icee_tpu_torch.senticap.solver import make_solver
    from icee_tpu_torch.senticap.train import decode_split, make_base_step

    counters = {"fused_senticap_scan_fwd": ss.senticap_scan_fwd,
                "fused_senticap_scan_bwd": ss.senticap_scan_bwd,
                "ce_rows": cl.ce_rows, "ce_grad_rows": cl.ce_grad_rows,
                "mega_senticap_beam_decode": sd.mega_senticap_beam_decode}
    stats = {"H": WIDE_H}
    with widths(SC_H=WIDE_H):
        conf = senticap_conf_full()
        plain_conf = senticap_conf_full(FUSED_SCAN=False, CHUNKED_CE=False)
        solver = make_solver(conf)
        kernel = make_base_step(conf, solver, device=device)
        plain = make_base_step(plain_conf, solver, device=device)
        data = sio.device_dataset(senticap_split(SC_B, 80), device)
        batch = torch.arange(SC_B, device=device)
        params = model.init_params(torch.Generator().manual_seed(81), SC_V,
                                   conf, device=device)
        for fn in counters.values():
            fn.launches = 0
        loss_err, grad_errs = senticap_first_step(
            device, kernel, plain, data, batch, params, "phase 24 (d)")
        launches = {k: fn.launches for k, fn in counters.items()}
        if (launches["fused_senticap_scan_fwd"],
                launches["fused_senticap_scan_bwd"]) != (1, 1):
            fail(f"phase 24 (d): the base steps launched {launches}")
        opt_state = solver.init(params)
        gen = torch.Generator(device=device).manual_seed(83)
        stats["step_ms"] = step_ms(lambda: kernel(params, opt_state, data,
                                                  batch, gen), 10)
        stats["plain_step_ms"] = step_ms(lambda: plain(
            params, opt_state, data, batch, gen), 3)
        stats["first_step_kernel_vs_plain"] = {"loss_rel_err": loss_err,
                                               "grad_rel_errs": grad_errs}
        # decode_split through K9
        dec = senticap_decoder(device)
        ds = senticap_split(WIDE_SC_IMAGES, 85)
        i2w = {i: f"w{i}" for i in range(SC_V)}
        sd.mega_senticap_beam_decode.launches = 0
        t0 = time.perf_counter()
        out = decode_split(dec, conf, ds, i2w, switched=False,
                           torch_device=device)
        torch.cuda.synchronize()
        stats["decode_split_ms"] = (time.perf_counter() - t0) * 1e3
        n = sd.mega_senticap_beam_decode.launches
        launches["mega_senticap_beam_decode"] += n
        if n != 1:
            fail(f"phase 24 (d): decode_split launched K9 {n} times")
        v = torch.as_tensor(ds.V, device=device)
        kw = dict(beam_size=SC_BEAM, max_len=SC_MAXLEN)
        with torch.inference_mode():
            got = sd.mega_senticap_beam_decode(dec, v, WIDE_SC_IMAGES, **kw)
            want = sd.mega_senticap_beam_decode_plain(dec, v,
                                                      WIDE_SC_IMAGES, **kw)
            rescored = senticap_rescore(dec, v, got[1], got[2])
        for i, o in enumerate(out):
            ids = got[1][i, :int(got[2][i])].tolist()
            if o["caption"] != [i2w[w] for w in ids[:-1]]:
                fail(f"phase 24 (d): decode_split's caption of image {i} "
                     f"{o['caption']} is not this process's K9 search's")
        err, own, flips = k9_margin_check("phase 24 (d) K9", got, want,
                                          rescored)
        stats.update(decode_images=WIDE_SC_IMAGES, beam=SC_BEAM,
                     k9_score_err=err, k9_rescore_err=own,
                     k9_near_tie_flips=flips,
                     k9_ms=cuda_ms(lambda: sd.mega_senticap_beam_decode(
                         dec, v, WIDE_SC_IMAGES, **kw), 3),
                     k9_plain_ms=cuda_ms(
                         lambda: sd.mega_senticap_beam_decode_plain(
                             dec, v, WIDE_SC_IMAGES, **kw), 1))
    log(f"phase 24 (d): SentiCap at H {WIDE_H}: step {stats['step_ms']:.3f}"
        f" ms (plain {stats['plain_step_ms']:.3f}); decode_split of "
        f"{WIDE_SC_IMAGES} images {stats['decode_split_ms']:.2f} ms, K9 "
        f"{stats['k9_ms']:.3f} ms (plain {stats['k9_plain_ms']:.3f}), "
        f"{flips} near-tie flips; launches {launches}")
    return launches, stats


def wide_scan_entries(scans: dict, launches: dict, suffix: str = "wide_h",
                      heads=("B64 H1024", "B64 H1024", "B128 H1024"),
                      reach: str = "H >= 736, large B") -> list:
    """The kernels line's entries of phase 24 (and, with ``suffix``,
    ``heads`` and ``reach``, phase 28): K3, K4 and K8 forward and backward
    past the resident plan, at the headline shape (``heads``: B 64, H
    1024; K8 B 128), every (a) shape's figures under ``shapes``, the
    launches those of (c) (K3, K4) and (d) (K8)."""
    rows = (("K3", "fused_factored_scan", "lstm_scan.cu", "pallas_lstm.py",
             (":224", ":298"), heads[0], None),
            ("K4", "fused_nic_scan", "nic_scan.cu", "pallas_nic_train.py",
             (":173", ":227"), heads[1],
             "torch.nn.LSTM(E, H, batch_first=True) (cuDNN), TF32 off"),
            ("K8", "fused_senticap_scan", "senticap_scan.cu",
             "pallas_senticap_train.py", (":173", ":224"), heads[2],
             None))
    out = []
    for kernel, name, src, tpu, lines, head, lib in rows:
        for d, line in zip(("fwd", "bwd"), lines):
            shapes = {k.split(" ", 1)[1]: {
                "plan": f["plan"], "ms": f[f"{d}_ms"],
                "plain_ms": f[f"plain_{d}_ms"],
                "bound_ms": f[f"bound_{d}_ms"],
                "bound_by": f[f"bound_{d}_by"],
                "library_ms": f[f"library_{d}_ms"],
                "max_abs_err": f[f"{d}_max_abs_err"],
                "device_ms_by_group": f[f"device_ms_by_group_{d}"]}
                for k, f in scans.items() if k.startswith(kernel + " ")}
            top = shapes[head]
            out.append({
                "name": f"{name}_{d}_{suffix}", "route": "cuda",
                "source": f"icee_tpu_torch/csrc/{src} + "
                          "icee_tpu_torch/csrc/scan_grid.cuh (streamed "
                          "plans)",
                "replaces": f"icee_tpu/ops/{tpu}{line} ({reach})",
                "launches": launches.get(f"{name}_{d}", 0),
                "max_abs_err": max(s["max_abs_err"] for s in shapes.values()),
                "ms": top["ms"], "plain_ms": top["plain_ms"],
                "bound_ms": top["bound_ms"], "bound_by": top["bound_by"],
                "library_ms": top["library_ms"], "headline": head,
                "library_note": lib or "no single PyTorch call computes "
                                       "this cell", "shapes": shapes})
    return out


def wide_h_phase(device, keep: str) -> tuple:
    """Phase 24, (a)-(d) -> (the kernels line's entries, stats)."""
    import torch

    t0 = time.perf_counter()
    scans = check_wide_scans(device)
    log("phase 24 (a): K3, K4, K8 past the resident plan ok: " + "; ".join(
        f"{k} {f['plan']['forward']}/{f['plan']['backward']} fwd "
        f"{f['fwd_ms']:.3f} (plain {f['plain_fwd_ms']:.3f}, bound "
        f"{f['bound_fwd_ms']:.3f}) bwd {f['bwd_ms']:.3f} (plain "
        f"{f['plain_bwd_ms']:.3f}, bound {f['bound_bwd_ms']:.3f})"
        for k, f in scans.items()))
    k5 = wide_k5(device)
    torch.cuda.empty_cache()
    log(f"phase 24 (b): K5 factored sampled at H = F = {WIDE_H} ok: fwd "
        f"{k5['fwd']['ms']:.3f} ms (plain {k5['fwd']['plain_ms']:.3f}), bwd "
        f"{k5['bwd']['ms']:.3f} ms (plain {k5['bwd']['plain_ms']:.3f})")
    launches, cli = wide_cli(device, keep)
    sc_launches, senticap = wide_senticap(device)
    for k, n in sc_launches.items():
        launches[k] = launches.get(k, 0) + n
    entries = wide_scan_entries(scans, launches)
    stats = {"scans": scans, "k5": k5, "cli": cli, "senticap": senticap,
             "launches": launches, "phase_s": time.perf_counter() - t0}
    log(f"phase 24: hidden widths past the resident plan ok in "
        f"{stats['phase_s']:.1f} s; launches {launches}")
    return entries, stats

# --- phase 25: widths that are not a multiple of 4 ---------------------------

# (a)'s cases: V of every residue mod 4 (8192 is phases 4-5d's), ragged F,
# H, A and FS across them, E = 300
RAG_CASES = (dict(V=8189, F=512, H=512, A=512, FS=2048),
             dict(V=8190, F=510, H=511, A=509, FS=2046),
             dict(V=8191, F=511, H=509, A=510, FS=2047))
RAG_STEPS = 20          # (a)'s searches: steps (cut as phase 5d cuts them)
RAG_WIDE = (8, 20)      # (a)'s wide shape: images, k
RAG_K5 = {8190: (("factored", False), ("lstm", True)),   # (a): K5's modes
          8191: (("factored", True), ("lstm", False))}   # at each case
RAG_V = 8191            # (b), (c): the vocabulary build_vocab gives
RAG_REQUESTS = 8        # (b): the engine's requests (4 images x 2 modes)
RAG_TIMED_IMAGES = (1, 64)   # (c)


def ragged_kernels(device) -> dict:
    """Phase 25 (a): K1 (R = 5, R = 320; top-20 at 160 rows), K2 (both
    cells at 1 and 64 images, k = 5, and RAG_WIDE), K6 (both kinds at 1
    and 64 images, k = 5, and one image at k = 20), the h0/c0 kernel (1 and
    64 images) and K7 (as K2), each RAG_CASES case, against their plain
    versions as phases 4-5d hold them (``check_k1``, ``check_k2_shape``,
    ``check_k6``, ``check_k7_shape``: launches exact, K2 = K1 fused-step
    and K7 = K6 at atol 0); K5 (``check_k5``, untimed) forward and
    backward at B = 128, T = 25, P = 196 in the modes ``RAG_K5`` gives a
    case.  -> {case: {kernel: max abs err}}."""
    import torch

    from icee_tpu_torch.models import attention as att_mod
    from icee_tpu_torch.ops.att_beam import search_init_state
    from icee_tpu_torch.ops.att_decode_step import att_init_state

    out = {}
    seeded = decoder_params(device)
    for case in RAG_CASES:
        tag = "V{V} F{F} H{H} A{A} FS{FS}".format(**case)
        errs = {}

        def note(name, err):
            errs[name] = max(errs.get(name, 0.0), err)

        params = {v: cut_decoder(p["decoder"], **case)
                  for v, p in seeded.items()}
        with widths(**case):
            sty, nic = params["stylenet"], params["nic"]
            att = {kind: params[v] for kind, v in ATT_KINDS.items()}
            with torch.inference_mode():
                for rows, ktop in ((K, K), (B_IMAGES * K, K),
                                   (RAG_WIDE[0] * RAG_WIDE[1], RAG_WIDE[1])):
                    note("k1", check_k1(sty, device, rows, 7 + rows,
                                        ktop=ktop)[1])
                for cell, dec in (("factored", sty), ("lstm", nic)):
                    for n_img, k in ((1, K), (B_IMAGES, K), RAG_WIDE):
                        note("k2_" + cell, check_k2_shape(
                            dec, device, cell, n_img, k=k,
                            steps_max=RAG_STEPS, timed=False)["max_abs_err"])
                for kind, dec in att.items():
                    for n_img, k in ((1, K), (B_IMAGES, K), (1, 20)):
                        note("k6_" + kind, check_k6(dec, kind, device, n_img,
                                                    60 + n_img, k=k)[1])
                    for n_img in (1, B_IMAGES):
                        feats = att_features(device, n_img, 61)
                        h0, c0 = att_init_state(dec, feats)
                        want = att_mod.init_hidden_state(dec, feats)
                        k7 = search_init_state(dec, feats, kind, 3
                                               if kind == "factored" else 0)
                        err = max((h0 - want[0]).abs().max().item(),
                                  (c0 - want[1]).abs().max().item())
                        if not err <= 1e-4 or not (
                                torch.equal(h0, k7[0])
                                and torch.equal(c0, k7[1])):
                            fail(f"phase 25 (a) {tag}: h0/c0 {kind} at "
                                 f"{n_img} images: error {err} or not K7's")
                        note("att_init", err)
                    for n_img, k in ((1, K), (B_IMAGES, K), RAG_WIDE):
                        note("k7_" + kind, check_k7_shape(
                            dec, kind, device, n_img, k=k,
                            steps_max=RAG_STEPS, timed=False)["max_abs_err"])
            del params, sty, nic, att
            torch.cuda.empty_cache()
            for kind, sampled in RAG_K5.get(case["V"], ()):
                fwd, bwd = check_k5(kind, sampled, device, timed=False)
                name = "k5_" + kind + ("_sampled" if sampled else "")
                note(name + "_fwd", fwd["max_abs_err"])
                note(name + "_bwd_rel", bwd["max_rel_err"])
        torch.cuda.empty_cache()
        out[tag] = errs
        log(f"phase 25 (a) {tag}: every kernel ok, max abs err {errs}")
    return out


def ragged_files(keep: str, root: str) -> dict:
    """Phase 19's caption files (in ``keep``) with the word w{V-1} written
    as w{V-2} throughout, under ``root``: ``build_vocab --threshold 1``
    then gives V - 1 = RAG_V words.  -> their paths."""
    drop, into = f"w{V - 1}", f"w{V - 2}"
    out = {}
    for name in ("train", "val", "happy", "val_happy"):
        with open(os.path.join(keep, f"{name}.txt")) as f:
            lines = f.read().splitlines()
        out[name] = os.path.join(root, f"{name}.txt")
        with open(out[name], "w") as f:
            for line in lines:
                key, caption = line.split("\t")
                f.write(key + "\t" + " ".join(
                    into if w == drop else w for w in caption.split())
                    + "\n")
    return out


def ragged_cli(keep: str) -> tuple:
    """Phase 25 (b): the demo's path at a vocabulary that is not a multiple
    of 4, as processes over phase 19's files (``keep``): ``build_vocab``
    (V = RAG_V), ``train`` (one StyleNet epoch at ratio 1.0 on the feature
    cache: K3 and the CE a step, K2 for the validation and the sample) and
    ``evaluate --feed_feature`` (K2 a batch), launches exact and no plain
    version.  -> (launches, stats)."""
    from icee_tpu_torch.data.captions import load_caption_dataset
    from icee_tpu_torch.data.vocab import load_vocab
    from icee_tpu_torch.ops import chunked_loss as cl

    import numpy as np

    m = "icee_tpu_torch.cli."
    launches, stats = {}, {}
    root = os.path.join(keep, "ragged")
    logs = os.path.join(root, "logs")
    os.makedirs(logs)
    files = ragged_files(keep, root)
    vocab_path = os.path.join(root, "vocab.pkl")
    cache = os.path.join(keep, "features.npz")

    def stage(name, module, args, want, ratio=None):
        st, counts, out = cli_stage(name, module, args, logs, want, ratio,
                                    phase=25)
        stats[name] = st
        for k, n in counts.items():
            launches[k] = launches.get(k, 0) + n
        return out

    stage("build_vocab", m + "build_vocab", [
        "--caption_path", files["train"], "--vocab_path", vocab_path,
        "--threshold", 1], {})
    vocab = load_vocab(vocab_path)
    if len(vocab) != RAG_V:
        fail(f"phase 25 (b): build_vocab gave {len(vocab)} words, not "
             f"{RAG_V}")
    t_cap = STEPS + 2
    n_fac = -(-CLI_IMAGES * TR_CAPS // CLI_BATCH)
    n_emo = -(-CLI_EMO_IMAGES * TR_CAPS // B_EMOTION)
    ce = sum(n * -(-t_cap // cl.auto_t_chunk(b, t_cap))
             for n, b in ((n_fac, CLI_BATCH), (n_emo, B_EMOTION)))
    models = os.path.join(root, "models")
    stage("train", m + "train", [
        "--trainer", "multitask", "--family", "stylenet", "--mode", "happy",
        "--vocab_path", vocab_path, "--caption_path", files["train"],
        "--val_caption_path", files["val"], "--happy_path", files["happy"],
        "--val_happy_path", files["val_happy"], "--feature_cache", cache,
        "--num_epochs", 1, "--caption_batch_size", CLI_BATCH,
        "--language_batch_size", B_EMOTION, "--model_path", models,
        "--log_path", os.path.join(logs, "train.txt"), "--metrics_path",
        os.path.join(logs, "train.jsonl"), "--data_name", "ragged",
        "--log_step", 10 ** 9, "--log_step_emotion", 10 ** 9],
        {"fused_factored_scan_fwd": n_fac + n_emo,
         "fused_factored_scan_bwd": n_fac + n_emo, "ce_rows": ce,
         "ce_grad_rows": ce, "mega_beam_decode": 2}, ratio=1.0)
    with open(os.path.join(logs, "train.jsonl")) as f:
        losses = [e["train_loss"] for e in map(json.loads, f)
                  if e["event"] == "epoch_factual"]
    if len(losses) != 1 or not np.isfinite(losses[0]):
        fail(f"phase 25 (b) train: factual losses {losses}")
    stats["train"]["train_loss"] = losses
    best = os.path.join(models, "HAP_BEST_checkpoint_ragged")
    if not os.path.isdir(best):
        best = os.path.join(models, "HAP_checkpoint_ragged")
    n_val = len(load_caption_dataset(files["val"], vocab))
    out = stage("evaluate", m + "evaluate", [
        "--vocab_path", vocab_path, "--feature_cache", cache, "--batch_size",
        CLI_BATCH, "--checkpoint_path", best, "--test_path", files["val"],
        "--mode", "happy", "--feed_feature"],
        {"mega_beam_decode": -(-n_val // CLI_BATCH)})
    bleu = bleu_lines(out)
    if len(bleu) != 4 or not all(np.isfinite(b) for b in bleu):
        fail(f"phase 25 (b) evaluate: BLEU lines {bleu}")
    stats["evaluate"]["bleu"] = bleu
    return launches, stats


def ragged_serving(device, root: str) -> tuple:
    """Phase 25 (b), in process: ``CaptionEngine`` with phase 6's four
    seeded variants cut to V = RAG_V (``cut_decoder``; E = 300, H = F =
    A = 512, FS = 2048),
    RAG_REQUESTS requests one by one, then the same through the
    ``BatchingEngine`` all at once: the batched captions those of the
    serial ones; K2 (both cells) and K7 (both kinds) launched on each
    path, no plain version.  -> (launches, stats)."""
    import numpy as np
    import torch
    from PIL import Image

    from icee_tpu_torch.ops.att_beam import mega_att_beam_decode
    from icee_tpu_torch.ops.beam import mega_beam_decode
    from icee_tpu_torch.serve.batching import BatchingEngine
    from icee_tpu_torch.serve.config import ServeConfig
    from icee_tpu_torch.serve.engine import CaptionEngine

    counters = {"mega_beam_decode": (mega_beam_decode, "launches"),
                "mega_beam_decode_lstm": (mega_beam_decode,
                                          "lstm_launches"),
                "mega_att_beam_decode": (mega_att_beam_decode, "launches"),
                "mega_att_beam_decode_lstm": (mega_att_beam_decode,
                                              "lstm_launches")}
    rng = np.random.default_rng(25)
    paths = []
    for i in range(RAG_REQUESTS // 2):
        base = rng.integers(0, 255, (8, 8, 3), dtype=np.uint8)
        p = os.path.join(root, f"photo{i}.jpg")
        Image.fromarray(base).resize((256, 256), Image.BILINEAR).save(
            p, quality=90)
        paths.append(p)
    requests = [(paths[i // 2], MODES[(i // 2 + i % 2) % 4])
                for i in range(RAG_REQUESTS)]
    params = captioning_params(device)
    for variant in SERVED:
        params[variant]["decoder"] = cut_decoder(params[variant]["decoder"],
                                                 V=RAG_V)
    with widths(V=RAG_V):
        config = ServeConfig(backend_host="127.0.0.1", backend_port=0,
                             image_folder=os.path.join(root, "uploads"),
                             vocab_path=serving_vocab(root),
                             batch_window_ms=200.0)
    engine = CaptionEngine(config, image_size=224, device=device,
                           params=params)
    if len(engine.vocab) != RAG_V:
        fail(f"phase 25 (b): the engine's vocabulary {len(engine.vocab)}")
    engine.caption(paths[0], "happy")     # warm-up
    launches = {}
    results = {}
    for path in ("serial", "batched"):
        for fn, attr in counters.values():
            setattr(fn, attr, 0)
        t0 = time.perf_counter()
        with plain_counters() as plain:
            if path == "serial":
                results[path] = [engine.caption(p, m) for p, m in requests]
            else:
                batcher = BatchingEngine(engine,
                                         window_ms=config.batch_window_ms)
                with ThreadPoolExecutor(len(requests)) as pool:
                    results[path] = list(pool.map(
                        lambda r: batcher.caption(*r), requests))
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if any(plain.values()):
            fail(f"phase 25 (b) {path}: a plain version ran: {plain}")
        launches[path] = {k: getattr(fn, a) for k, (fn, a) in
                          counters.items()}
        if not all(launches[path].values()):
            fail(f"phase 25 (b) {path}: launches {launches[path]}")
        launches[path]["wall_s"] = wall
    for j, (p, m) in enumerate(requests):
        if results["batched"][j] != results["serial"][j]:
            fail(f"phase 25 (b) request {j} ({m}): batched "
                 f"{results['batched'][j]} != serial {results['serial'][j]}")
    words = {v: [len(r[v].split()) for r in results["serial"]]
             for v in SERVED}
    if not all(max(w) for w in words.values()):
        fail(f"phase 25 (b): every caption of a variant is empty: {words}")
    log(f"phase 25 (b): the engine at V = {RAG_V}: {len(requests)} x "
        f"{len(SERVED)} captions batched = serial; words per caption "
        f"{ {v: (min(w), max(w)) for v, w in words.items()} }; e.g. "
        f"{results['serial'][0]}; launches {launches}")
    total = {k: launches["serial"][k] + launches["batched"][k]
             for k in counters}
    return total, {"requests": len(requests), "launches": launches,
                   "words_min_max": {v: [min(w), max(w)]
                                     for v, w in words.items()}}


def cut_decoder(dec, **dims):
    """A decoder seeded at this module's widths cut to ``dims`` (any of V,
    F, H, A, FS): the leading corner of each weight (of each gate block),
    the rest shared (``ops/widths.py::cut``): the same model less the cut
    units and words, whose beams keep phase 5's lengths."""
    from icee_tpu_torch.ops import widths as layout

    w = {n: (dims.get(n, full), full) for n, full in (
        ("E", E), ("F", F), ("H", H), ("V", V), ("A", A), ("FS", FS))}
    fs = w["FS"] if "attention" in dec else (0, 0)
    w["X"] = (E + fs[0], E + fs[1])
    return layout.pad_tree(dec, w, layout.cut)


def ragged_times(device) -> dict:
    """Phase 25 (c): K2 (factored) and K7 (factored) at 1 and 64 images,
    40 steps, k = 5, and K1 at R = 5, with phase 6's seeded decoders at V
    = 8192 and the same decoders cut to V = RAG_V (``cut_decoder``): CUDA
    events, aligned, ragged, aligned, ragged, each the mean of its calls;
    the ragged/aligned ratio of the means, and each search's live
    row-steps (the work, the same where the beams are).  -> figures."""
    import torch

    from icee_tpu_torch.ops.att_beam import (mega_att_beam_decode,
                                             mega_att_beam_decode_steps)
    from icee_tpu_torch.ops.beam import (mega_beam_decode,
                                         mega_beam_decode_steps)
    from icee_tpu_torch.ops.decode_step import decode_step_topk

    params = decoder_params(device)
    sty = params["stylenet"]["decoder"]
    att = params["stylenet_att"]["decoder"]
    decs = {"aligned": (sty, att),
            "ragged": (cut_decoder(sty, V=RAG_V), cut_decoder(att, V=RAG_V))}
    out = {"V": [V, RAG_V]}
    g = torch.Generator(device=device).manual_seed(25)
    with torch.inference_mode():
        x = torch.randn((K, E), generator=g, device=device) * 0.5
        h = torch.randn((K, H), generator=g, device=device) * 0.5
        for name, (s, _) in decs.items():
            decode_step_topk(s, x, h, h, 1)
        fns = {"k1_r5": lambda s, a, n: decode_step_topk(s, x, h, h, 1)}
        feats = {}
        for n in RAG_TIMED_IMAGES:
            feats[n] = (torch.randn((n, 1, E), generator=g, device=device)
                        .expand(n, K, E).contiguous(),
                        att_features(device, n, 25))
            fns[f"k2_images{n}"] = lambda s, a, n: mega_beam_decode(
                s, feats[n][0], 2, n, k=K, max_seq_length=STEPS)
            fns[f"k7_images{n}"] = lambda s, a, n: mega_att_beam_decode(
                a, feats[n][1], 3, n, k=K, max_seq_length=STEPS)
            for name, (s, a) in decs.items():
                _, st = mega_beam_decode_steps(s, feats[n][0], 2, n, k=K,
                                               max_seq_length=STEPS)
                _, st7 = mega_att_beam_decode_steps(a, feats[n][1], 3, n,
                                                    k=K, max_seq_length=STEPS)
                out.setdefault(f"k2_images{n}", {})[f"{name}_row_steps"] = \
                    int(st[:, 1].sum())
                out.setdefault(f"k7_images{n}", {})[f"{name}_row_steps"] = \
                    int(st7[:, 1].sum())
        for key, fn in fns.items():
            n = int(key.rsplit("images", 1)[1]) if "images" in key else K
            iters = (100, 10) if key == "k1_r5" else (5, 1)
            runs = {"aligned": [], "ragged": []}
            for name in ("aligned", "ragged", "aligned", "ragged"):
                s, a = decs[name]
                runs[name].append(cuda_ms(lambda: fn(s, a, n), *iters))
            fig = out.setdefault(key, {})
            for name, ms in runs.items():
                fig[f"{name}_ms"] = sum(ms) / len(ms)
                fig[f"{name}_runs_ms"] = ms
            fig["ratio"] = fig["ragged_ms"] / fig["aligned_ms"]
    return out


def ragged_phase(device, keep: str) -> tuple:
    """Phase 25: (b)'s processes (``ragged_cli``) on a thread of their own
    while this process runs (a) and (b)'s engine, then (c) alone on the
    card.  -> (launches of (b), stats)."""
    t0 = time.perf_counter()
    with ThreadPoolExecutor(1) as pool:
        cli = pool.submit(ragged_cli, keep)
        stats = {"kernels": ragged_kernels(device)}
        t_a = time.perf_counter() - t0
        serve_root = os.path.join(keep, "ragged_serve")
        os.makedirs(serve_root)
        launches, stats["serve"] = ragged_serving(device, serve_root)
        cli_launches, stats["cli"] = cli.result()
    for k, n in cli_launches.items():
        launches[k] = launches.get(k, 0) + n
    t_b = time.perf_counter() - t0
    stats["times"] = ragged_times(device)
    stats["phase_s"] = {"a": t_a, "a_b": t_b, "whole":
                        time.perf_counter() - t0}
    log("phase 25 (c): ragged vocabulary times: "
        + json.dumps({"widths_times": stats["times"]}))
    log(f"phase 25: widths that are not a multiple of 4 ok in "
        f"{stats['phase_s']['whole']:.1f} s ((a) {t_a:.1f} s, (a) and (b) "
        f"{t_b:.1f} s); launches {launches}")
    return launches, stats


# --- phase 26: beams and vocabularies past one block -------------------------

PB_KS = (257, 512, 1024)      # (a): K1 and K6 at one image, k = top-k
PB_MANY = (300, 8)            # (a), (b): k = 300 over 8 images
PB_V = 1000                   # k = top-k = V on the decoders cut to V
PB_V_STEPS = 4                # (b) at k = V
PB_SEARCHES = {257: 8, 512: 8, 1024: 6, 2048: 4}   # (b) one image: steps
PB_FUSED = (300, 1024)        # K2 = K1 and K7 = K6 at atol 0 (also big V)
PB_TIMED = (512, 2048)        # (b) timed at one image
PB_K1_TIMED = 1024            # (a) timed at one image
PB_BIG_V, PB_BIG_K, PB_BIG_STEPS = 100000, 5, 20   # the wide tail at k <= 8
PB_BIG_IMAGES = (1, 8)
PB_SC_BEAMS = (165, 257, 512)  # (c) at V = 8800 over PB_SC_IMAGES images
PB_SC_IMAGES = 8
PB_SC_TIMED_BEAM = 257
PB_SC_VOCABS = {32768: ("K9", "K10"), 60000: ("K9",)}  # beam 20, 64 images
PB_SC_TIMED_V = 32768
PB_MAIN = (2, 300)            # (e): images and beam of the main path


def past_block_steps(sty, att, cuts, device):
    """Phase 26 (a): K1 and K6 (both kinds) above K_WIDE against their plain
    versions as phase 5d (a) holds them (``check_k1``, ``check_k6``: ids
    exact but in a 1e-4 near tie, values 1e-4, launches exact): k = top-k
    in PB_KS at one image, 300 over 8 images, and k = top-k = V on the
    decoders cut to PB_V words; timed at PB_K1_TIMED.  -> {"k1" | kind:
    {"max_abs_err", "near_tie_swaps", "shapes"}}."""
    import torch

    out = {n: {"max_abs_err": 0.0, "near_tie_swaps": 0, "shapes": {}}
           for n in ("k1", *att)}

    def note(name, err, ties):
        out[name]["max_abs_err"] = max(out[name]["max_abs_err"], err)
        out[name]["near_tie_swaps"] += ties

    cases = [(k, 1, sty, att) for k in PB_KS]
    cases += [(PB_MANY[0], PB_MANY[1], sty, att),
              (PB_V, 1, cuts["stylenet"], {k: cuts[k] for k in att})]
    for k, n_img, k1_dec, att_decs in cases:
        rows, timed = n_img * k, n_img == 1 and k == PB_K1_TIMED
        inputs, err, ties = check_k1(k1_dec, device, rows, 70 + k + n_img,
                                     ktop=k)
        note("k1", err, ties)
        if timed:
            out["k1"]["shapes"][f"k{k}_rows{rows}"] = dict(
                k1_times(k1_dec, inputs, k, 10, 2), k=k, rows=rows)
        del inputs
        for kind, dec in att_decs.items():
            args, err, ties = check_k6(dec, kind, device, n_img,
                                       80 + k + n_img, k=k)
            note(kind, err, ties)
            if timed:
                out[kind]["shapes"][f"k{k}_rows{rows}"] = dict(
                    k6_times(kind, args, 10, 3, 2), k=k, rows=rows)
            del args
        torch.cuda.empty_cache()
    return out


def past_block_searches(decs, big, cuts, device):
    """Phase 26 (b): K2 (both cells) and K7 (both kinds) against their plain
    searches, margin-aware and re-scored as phase 5d (b, c) holds them
    (``check_k2_shape``, ``check_k7_shape``; launches exact): k in
    PB_SEARCHES at one image (its steps cut as phase 5d cuts them), 300
    over 8 images, k = V = PB_V over PB_V_STEPS steps, and k = PB_BIG_K at
    V = PB_BIG_V over PB_BIG_IMAGES images (the wide selection at k <= 8);
    K2 = K1 fused-step and K7 = K6 at atol 0 at k in PB_FUSED and at
    PB_BIG_V; timed at PB_TIMED and PB_BIG_V over 8 images.  -> {name:
    {"max_abs_err", "near_tie_flips", "max_rescore_err", "shapes"}}."""
    import torch

    names = {("factored", False): "k2", ("lstm", False): "k2_lstm",
             ("factored", True): "k7", ("lstm", True): "k7_lstm"}
    out = {n: {"max_abs_err": 0.0, "near_tie_flips": 0,
               "max_rescore_err": 0.0, "shapes": {}}
           for n in names.values()}
    cases = [(k, 1, steps, decs, k in PB_FUSED, k in PB_TIMED)
             for k, steps in PB_SEARCHES.items()]
    cases += [(PB_MANY[0], PB_MANY[1], PB_SEARCHES[257], decs, True, False),
              (PB_V, 1, PB_V_STEPS, cuts, False, False)]
    cases += [(PB_BIG_K, n, PB_BIG_STEPS, big, True, n == 8)
              for n in PB_BIG_IMAGES]
    for k, n_img, steps, ds, fused, timed in cases:
        kw = dict(k=k, steps_max=steps, fused=fused, timed=timed)
        for (cell, attends), name in names.items():
            if attends:
                dec = ds["stylenet_att" if cell == "factored" else "nic_att"]
                r = check_k7_shape(dec, cell, device, n_img, **kw)
            else:
                dec = ds["stylenet" if cell == "factored" else "nic"]
                r = check_k2_shape(dec, device, cell, n_img, **kw)
            o = out[name]
            o["max_abs_err"] = max(o["max_abs_err"], r["max_abs_err"])
            o["max_rescore_err"] = max(o["max_rescore_err"],
                                       r["max_rescore_err"])
            o["near_tie_flips"] += r["near_tie_flips"]
            if timed:
                o["shapes"][f"v{head_vocab(dec)}_k{k}_images{n_img}"] = \
                    dict(r, k=k, images=n_img, steps=steps,
                         vocab=head_vocab(dec))
        torch.cuda.empty_cache()
    return out


def sb_search_check(what: str, switched: bool, params, n_img: int,
                    beam: int, seed: int, timed: bool) -> dict:
    """K9 (or, ``switched``, K10) against its plain search over ``n_img``
    images at ``beam`` (max_len 20), margin-aware as phase 5: two runs
    bit-identical and one launch each; each kernel score within 1e-3 of
    its own sequence's plain re-score and of the plain search's, a token
    mismatch tying the plain winner within 1e-4; K10's gate trace within
    1e-5 where tokens agree.  -> (this shape's figures (with ``timed``, ms,
    plain ms and the bound), the visual features searched)."""
    import torch

    from icee_tpu_torch.ops import senticap_decode as sd
    from icee_tpu_torch.ops import senticap_switched_decode as ssd

    vocab, paths = params["w"].shape[1], 2 if switched else 1
    fn = (ssd.mega_senticap_switched_decode if switched
          else sd.mega_senticap_beam_decode)
    plain = (ssd.mega_senticap_switched_decode_plain if switched
             else sd.mega_senticap_beam_decode_plain)
    device = params["w"].device
    g = torch.Generator(device=device).manual_seed(seed)
    v = torch.randn((n_img, SC_VIS), generator=g, device=device)
    kw = dict(beam_size=beam, max_len=SC_MAXLEN)
    with counted_calls(fn, {"launches": 2}, what):
        got = fn(params, v, n_img, **kw)
        again = fn(params, v, n_img, **kw)
    want = plain(params, v, n_img, **kw)
    rescore = switched_rescore if switched else senticap_rescore
    rescored = rescore(params, v, got[1], got[2])
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        fail(f"{what}: two runs on the same inputs differ")
    max_err, own_err, flips = k9_margin_check(what, got, want, rescored)
    trace_err = 0.0
    if switched:
        for i in range(n_img):
            n = int(got[2][i])
            if n == int(want[2][i]) and torch.equal(got[1][i, :n],
                                                    want[1][i, :n]):
                trace_err = max(trace_err, (got[3][i, :n] - want[3][i, :n])
                                .abs().max().item())
        if not trace_err <= 1e-5:
            fail(f"{what}: trace error {trace_err} > 1e-5")
    plan = sd.launch_plan(what, n_img, beam, SC_E, SC_H, vocab, SC_MAXLEN,
                          paths)
    lengths = got[2].tolist()
    log(f"{what}: {n_img} images, beam {beam}, V {vocab} (row pass from "
        f"{'device' if plan.topk_wide else 'shared'} memory, selection from "
        f"{'device' if plan.select_wide else 'shared'} memory); lengths min "
        f"{min(lengths)} max {max(lengths)} mean "
        f"{sum(lengths) / len(lengths):.2f} ({len(set(lengths))} distinct);"
        f" score max abs err {max_err:.3g}, vs own re-score {own_err:.3g}, "
        f"trace {trace_err:.3g}; {flips} near-tie flips; bit-identical over "
        "two runs")
    out = {"max_abs_err": max_err, "max_rescore_err": own_err,
           "near_tie_flips": flips, "lengths": lengths,
           "topk_wide": plan.topk_wide, "select_wide": plan.select_wide,
           "images": n_img, "beam": beam, "vocab": vocab}
    if switched:
        out["max_trace_err"] = trace_err
        gates = torch.cat([got[3][i, :lengths[i]] for i in range(n_img)])
        out["gate_min_max"] = [gates.min().item(), gates.max().item()]
    if not timed:
        return out, v
    out["ms"] = cuda_ms(lambda: fn(params, v, n_img, **kw), 3)
    out["plain_ms"] = cuda_ms(lambda: plain(params, v, n_img, **kw), 3)
    rows, steps = n_img * beam, SC_MAXLEN + 1
    gate = 2 * SC_H if switched else 0   # K10's switch gate, a row a step
    flops = steps * rows * 2 * (paths * ((SC_E + SC_H) * 4 * SC_H
                                         + SC_H * vocab) + gate)
    nbytes = 4 * (paths * (vocab * SC_E + (SC_E + SC_H) * 4 * SC_H
                           + SC_H * vocab + vocab) + (gate + 1 if switched
                                                      else 0)
                  + paths * (n_img * SC_E + steps * rows * SC_E)
                  + n_img * (paths * steps + 2))
    out["bound_ms"], out["bound_by"] = bound_ms(flops, nbytes)
    out["bound_tf32x3_ms"] = flops / TF32X3_FLOP_PER_S * 1e3
    return out, v


def past_block_senticap(device) -> dict:
    """Phase 26 (c): K9 and K10 at the COCO regime (E = H = 512, max_len
    20) past one block: beam in PB_SC_BEAMS over PB_SC_IMAGES images at V
    = 8800 (the selection from device memory, the row pass too above 256),
    beam 20 over 64 images at V in PB_SC_VOCABS (the row pass from device
    memory); ``sb_search_check`` each.  -> {"k9" | "k10": {"max_abs_err",
    "near_tie_flips", "max_rescore_err", "max_trace_err", "shapes"}}."""
    import torch

    out = {n: {"max_abs_err": 0.0, "near_tie_flips": 0,
               "max_rescore_err": 0.0, "max_trace_err": 0.0, "shapes": {}}
           for n in ("k9", "k10")}

    def run(name, switched, params, n_img, beam, timed):
        what = f"{name.upper()} past one block"
        r, _ = sb_search_check(what, switched, params, n_img, beam,
                               90 + beam + n_img, timed)
        o = out[name]
        for key in ("max_abs_err", "max_rescore_err", "max_trace_err"):
            o[key] = max(o[key], r.get(key, 0.0))
        o["near_tie_flips"] += r["near_tie_flips"]
        o["shapes"][f"v{r['vocab']}_beam{beam}_images{n_img}"] = r

    base, sw = senticap_decoder(device), switched_params(device)
    for beam in PB_SC_BEAMS:
        run("k9", False, base, PB_SC_IMAGES, beam,
            beam == PB_SC_TIMED_BEAM)
        run("k10", True, sw, PB_SC_IMAGES, beam, False)
    del base, sw
    for vocab, kernels in PB_SC_VOCABS.items():
        sw = switched_params(device, vocab=vocab)
        base = {k: sw[k] for k in ("wemb", "w_lstm", "w", "b", "wvm",
                                   "bmv")}
        if "K9" in kernels:
            run("k9", False, base, SC_IMAGES, SC_BEAM, False)
        if "K10" in kernels:
            run("k10", True, sw, SC_IMAGES, SC_BEAM,
                vocab == PB_SC_TIMED_V)
        del sw, base
        torch.cuda.empty_cache()
    return out


def past_block_main_path(decs, device) -> dict:
    """Phase 26 (e): the main path past one block, through the entry points
    the engines and the CLIs call, every count from 0 just before and read
    just after: ``decode/fast.py`` at beam PB_MAIN[1] over PB_MAIN[0]
    images (StyleNet's whole search and fused-step path, NIC's search, both
    attention decoders' searches and fused-step paths: K2 and K7 once a
    search, K1 and K6 once a step, the h0/c0 kernel once a fused-step
    attention path, each fused-step result = its whole search's at atol
    0), then ``senticap/train.py::decode_split``: switched at V = 32,768,
    beam 20 (K10 with its row pass from device memory, K9 on the
    background weights) and base at beam 257 over V = 8800 (K9 from device
    memory); no plain version.  -> the counts."""
    import torch

    from icee_tpu_torch.decode.fast import (attention_decode,
                                            factored_decode, nic_att_decode,
                                            nic_decode)
    from icee_tpu_torch.ops import senticap_decode as sd
    from icee_tpu_torch.ops import senticap_switched_decode as ssd
    from icee_tpu_torch.ops.att_beam import mega_att_beam_decode_steps
    from icee_tpu_torch.ops.beam import mega_beam_decode_steps
    from icee_tpu_torch.senticap.train import decode_split

    n, k = PB_MAIN
    sty, nic = decs["stylenet"], decs["nic"]
    att = {"factored": decs["stylenet_att"], "lstm": decs["nic_att"]}
    g = torch.Generator(device=device).manual_seed(26)
    feats = torch.randn((n, 1, E), generator=g, device=device).expand(
        n, k, E).contiguous()
    spatial = att_features(device, n, 27)
    styles = {"factored": 3, "lstm": 0}
    _, st = mega_beam_decode_steps(sty, feats, 2, n, k=k,
                                   max_seq_length=STEPS)
    att_steps = {kind: int(mega_att_beam_decode_steps(
        dec, spatial, styles[kind], n, k=k, max_seq_length=STEPS,
        kind=kind)[1][:, 0].max()) for kind, dec in att.items()}
    conf = senticap_conf_full(MAX_SENTENCE_LEN=SC_MAXLEN)
    sw = switched_params(device, vocab=PB_SC_TIMED_V)
    ds_sw = senticap_split(PB_SC_IMAGES, 68, senti=1.0)
    base = senticap_decoder(device)
    ds_base = senticap_split(PB_SC_IMAGES, 69)
    i2w = {i: f"w{i}" for i in range(PB_SC_TIMED_V)}
    counters = dict(wide_counters(),
                    mega_senticap_beam_decode=(sd.mega_senticap_beam_decode,
                                               "launches"),
                    mega_senticap_switched_decode=(
                        ssd.mega_senticap_switched_decode, "launches"))
    for fn, attr in counters.values():
        setattr(fn, attr, 0)
    with plain_counters() as plain:
        res = {
            "stylenet": factored_decode("mega", sty, feats, 2, n, k, STEPS,
                                        1, 2),
            "stylenet_fused": factored_decode("fused-step", sty, feats, 2, n,
                                              k, STEPS, 1, 2),
            "nic": nic_decode(nic, feats, n, k, STEPS, 1, 2),
            "stylenet_att": attention_decode("mega", att["factored"],
                                             spatial, 3, n, k, STEPS, 1, 2),
            "stylenet_att_fused": attention_decode(
                "fused-step", att["factored"], spatial, 3, n, k, STEPS, 1,
                2),
            "nic_att": nic_att_decode("mega", att["lstm"], spatial, n, k,
                                      STEPS, 1, 2),
            "nic_att_fused": nic_att_decode("fused-step", att["lstm"],
                                            spatial, n, k, STEPS, 1, 2)}
        styled = decode_split(sw, conf, ds_sw, i2w, switched=True,
                              torch_device=device)
        captions = decode_split(base, conf, ds_base, i2w, switched=False,
                                beam_size=PB_SC_TIMED_BEAM,
                                torch_device=device)
        torch.cuda.synchronize()
    got = {name: getattr(fn, attr) for name, (fn, attr) in counters.items()}
    if any(plain.values()):
        fail(f"phase 26 (e): a plain version ran on the card: {plain}")
    s1, s6f, s6l = int(st[:, 0].max()), att_steps["factored"], \
        att_steps["lstm"]
    want = {"decode_step_topk": s1, "decode_step_topk_wide": s1,
            "mega_beam_decode": 1, "mega_beam_decode_wide": 1,
            "mega_beam_decode_lstm": 1, "mega_beam_decode_lstm_wide": 1,
            "att_decode_step_topk": s6f, "att_decode_step_topk_wide": s6f,
            "att_decode_step_topk_lstm": s6l,
            "att_decode_step_topk_lstm_wide": s6l,
            "mega_att_beam_decode": 1, "mega_att_beam_decode_wide": 1,
            "mega_att_beam_decode_lstm": 1,
            "mega_att_beam_decode_lstm_wide": 1, "att_init_state": 2,
            "mega_senticap_beam_decode": 2,
            "mega_senticap_switched_decode": 1}
    if got != want:
        fail(f"phase 26 (e): launches {got}, expected {want}")
    for name in ("stylenet", "stylenet_att", "nic_att"):
        for what in ("tokens", "length", "score"):
            if not torch.equal(getattr(res[name], what),
                               getattr(res[name + "_fused"], what)):
                fail(f"phase 26 (e) {name}: the fused-step path's {what} "
                     "differ from the whole search's (atol 0)")
    if len(styled) != PB_SC_IMAGES or len(captions) != PB_SC_IMAGES or any(
            len(o["attention"]) != len(o["positive"]) + 1 for o in styled):
        fail("phase 26 (e): decode_split's records are malformed")
    log(f"phase 26 (e): beam {k}, {n} images a variant, decode_split "
        f"switched at V = {PB_SC_TIMED_V} and base at beam "
        f"{PB_SC_TIMED_BEAM}: launches {got}; fused-step = whole search at "
        "atol 0")
    return got


def past_block_phase(device) -> tuple:
    """Phase 26: every beam width and vocabulary that the CPU route takes,
    on the card, past one block's shared memory: (a) K1 and K6, (b) K2 and
    K7, (c) K9 and K10 against their plain versions, (d) their times, (e)
    the main path.  -> (the kernels line's entries, the times line)."""
    import torch

    t0 = time.perf_counter()
    with torch.inference_mode():
        decs = {n: d["decoder"] for n, d in decoder_params(device).items()}
        cuts = {n: cut_decoder(d, V=PB_V) for n, d in decs.items()}
        att = {"factored": decs["stylenet_att"], "lstm": decs["nic_att"]}
        steps = past_block_steps(decs["stylenet"], att, {
            "stylenet": cuts["stylenet"], "factored": cuts["stylenet_att"],
            "lstm": cuts["nic_att"]}, device)
        log(f"phase 26 (a): K1, K6 ok at k = {PB_KS}, {PB_MANY[0]} over "
            f"{PB_MANY[1]} images and V = {PB_V}; " + "; ".join(
                f"{n} max err {f['max_abs_err']:.3g}, near-tie swaps "
                f"{f['near_tie_swaps']}" for n, f in steps.items()))
        big = {n: d["decoder"] for n, d in decoder_params(
            device, PB_BIG_V).items()}
        searches = past_block_searches(decs, big, cuts, device)
        del big
        torch.cuda.empty_cache()
        log("phase 26 (b): K2, K7 ok; " + "; ".join(
            f"{n} max err {f['max_abs_err']:.3g}, re-score "
            f"{f['max_rescore_err']:.3g}, near-tie flips "
            f"{f['near_tie_flips']}" for n, f in searches.items()))
        sc = past_block_senticap(device)
        log("phase 26 (c): K9, K10 ok; " + "; ".join(
            f"{n} max err {f['max_abs_err']:.3g}, re-score "
            f"{f['max_rescore_err']:.3g}, trace {f['max_trace_err']:.3g}, "
            f"near-tie flips {f['near_tie_flips']}" for n, f in sc.items()))
        counts = past_block_main_path(decs, device)
    att_step = "icee_tpu/ops/pallas_att_decode.py:201 (kind=\"{}\", k > 256)"
    att_beam = ("icee_tpu/ops/pallas_att_decode.py:733 (kind=\"{}\"; k > "
                "256, V past the narrow tail)")
    k1h = k6h = f"k{PB_K1_TIMED}_rows{PB_K1_TIMED}"
    gh = f"v{V}_k{PB_TIMED[0]}_images1"
    entries = [
        wide_entry(
            "decode_step_topk_past_block", "icee_tpu_torch/csrc/decode_step.cu",
            "icee_tpu/ops/pallas_decode.py:261 (ktop > 256)", steps["k1"],
            k1h, launches=counts["decode_step_topk_wide"]),
        wide_entry(
            "mega_beam_decode_past_block", "icee_tpu_torch/csrc/beam.cu",
            "icee_tpu/ops/pallas_beam.py:350 (k > 256, V past the narrow "
            "tail)", searches["k2"], gh,
            launches=counts["mega_beam_decode_wide"]),
        wide_entry(
            "mega_beam_decode_lstm_past_block", "icee_tpu_torch/csrc/beam.cu",
            "icee_tpu/ops/pallas_beam.py:350 (cell=\"lstm\", :129-143; k > "
            "256, V past the narrow tail)", searches["k2_lstm"], gh,
            launches=counts["mega_beam_decode_lstm_wide"])]
    for kind, sfx in (("factored", ""), ("lstm", "_lstm")):
        entries.append(wide_entry(
            f"att_decode_step_topk{sfx}_past_block",
            "icee_tpu_torch/csrc/att_decode_step.cu", att_step.format(kind),
            steps[kind], k6h,
            launches=counts[f"att_decode_step_topk{sfx}_wide"]))
        entries.append(wide_entry(
            f"mega_att_beam_decode{sfx}_past_block",
            "icee_tpu_torch/csrc/att_beam.cu", att_beam.format(kind),
            searches["k7" + sfx], gh,
            launches=counts[f"mega_att_beam_decode{sfx}_wide"]))
    entries.append(wide_entry(
        "mega_senticap_beam_decode_past_block",
        "icee_tpu_torch/csrc/senticap_beam.cu",
        "icee_tpu/ops/pallas_senticap_decode.py:397 (beam > 164, V past the "
        "row block)", sc["k9"],
        f"v{SC_V}_beam{PB_SC_TIMED_BEAM}_images{PB_SC_IMAGES}",
        launches=counts["mega_senticap_beam_decode"]))
    entries.append(wide_entry(
        "mega_senticap_switched_decode_past_block",
        "icee_tpu_torch/csrc/senticap_switched_beam.cu",
        "icee_tpu/ops/pallas_senticap_switched_decode.py:241 (beam > 159, "
        "V > 28,800)", sc["k10"],
        f"v{PB_SC_TIMED_V}_beam{SC_BEAM}_images{SC_IMAGES}",
        launches=counts["mega_senticap_switched_decode"]))
    times = {e["name"]: {sh: {k: f[k] for k in (
        "ms", "plain_ms", "bound_ms", "bound_by", "library_ms") if k in f}
        for sh, f in e["shapes"].items() if "ms" in f} for e in entries}
    log(f"phase 26 done in {time.perf_counter() - t0:.1f} s")
    return entries, times


# --- phase 27: the step and attention kernels at every width ----------------
#
# K1 and K6 (both kinds) at H = F = 1024 and 2048 (where the earlier
# row-tiled cell launch held 4 and 2 rows a block; since the many-row
# redesign one register-tiled launch a product over all rows); K5 (both cells and modes) where the d_att1
# pass splits A into column blocks; K7 (both kinds) past 256 positions (the
# softmax rows at their own stride, past 1,784 positions in device memory)
# and past A = 3,840 (att2 from L2), the h0/c0 launch at P = 400; then the
# path a user takes there as processes: spatial features at --grid 20,
# train --attention at A = 2048, evaluate and caption_batch.

WW_HS = (1024, 2048)           # (a): K1, K6 at H = F (E = 300, FS = 2048)
WW_STEP_SHAPES = ((B_IMAGES, K), (1, 20))   # (a): images, k (= top-k)
WW_FUSED_H = 1024              # (a): K2 = K1, K7 = K6 at atol 0; the engine
WW_FUSED_IMAGES, WW_FUSED_KS = 8, (5, 20)
WW_REQUESTS = 8                # (a): the engine's requests
WW_K5 = ((42, 2048), (62, 1024))   # (b): K5's (T, A) at B_ATT
WW_PS = (289, 400, 1024)       # (c): K7's positions (grids 17, 20, 32)
WW_P_SHAPES = ((1, K), (B_IMAGES, K), (8, 20))   # (c): images, k
WW_P_TIMED = (400, 1024)       # (c): timed at B_IMAGES images
WW_P_DEVICE = 2304             # (c): alpha in device memory, one image
WW_WIDE_A = 4096               # (c): att2 from L2, one image
WW_INIT_P = 400                # (c): the h0/c0 launch, 1 and B_IMAGES images
WW_GRID = 20                   # (d): precompute_features --grid (P = 400)
WW_CLI_IMAGES, WW_CLI_VAL, WW_CLI_EMO = 64, 16, 32   # (d): images
WW_CLI_A = 2048                # (d): train --attention_size


def plan_tiles(plan) -> dict:
    """{launch: "BMxBN"} of a many-row step plan's product launches."""
    return {name: f"{t[0]}x{t[1]}" for name, t, *_ in plan if t}


def ww_steps(device) -> dict:
    """Phase 27 (a): K1 and K6 (both kinds) against their plain versions as
    phases 4 and 5b hold them (``check_k1``, ``check_k6``: ids exact but in
    a near tie, values 1e-4, alpha 1e-5, one launch each on the many-row
    path) at H = F in WW_HS over 64 images x 5 rows and one image x 20,
    the first timed.  -> {"k1" | kind: {"max_abs_err", "near_tie_swaps",
    "shapes"}}."""
    import torch

    from icee_tpu_torch.ops.decode_step import step_plan

    out = {n: {"max_abs_err": 0.0, "near_tie_swaps": 0, "shapes": {}}
           for n in ("k1", "factored", "lstm")}

    def note(name, err, ties):
        out[name]["max_abs_err"] = max(out[name]["max_abs_err"], err)
        out[name]["near_tie_swaps"] += ties

    for hw in WW_HS:
        with widths(H=hw, F=hw):
            decs = decoder_params(device)
            sty = decs["stylenet"]["decoder"]
            for n_img, k in WW_STEP_SHAPES:
                rows, timed = n_img * k, n_img == B_IMAGES
                tag = f"h{hw}_rows{rows}"
                inputs, err, ties = check_k1(sty, device, rows, 270 + hw % 7,
                                             ktop=k)
                note("k1", err, ties)
                if timed:
                    out["k1"]["shapes"][tag] = dict(
                        k1_times(sty, inputs, k, 5, 1), H=hw, F=hw,
                        rows=rows, tiles=plan_tiles(step_plan(
                            "k1", rows, E, hw, hw, V, k)))
                del inputs
                for kind, variant in ATT_KINDS.items():
                    dec = decs[variant]["decoder"]
                    args, err, ties = check_k6(dec, kind, device, n_img,
                                               275 + hw % 7, k=k)
                    note(kind, err, ties)
                    if timed:
                        out[kind]["shapes"][tag] = dict(
                            k6_times(kind, args, 5, 2, 1), H=hw, F=hw,
                            rows=rows, tiles=plan_tiles(step_plan(
                                kind, rows, E, hw, hw, V, k, A, P, FS, k)))
                    del args
            del decs, sty
            torch.cuda.empty_cache()
    return out


def ww_fused(device) -> dict:
    """Phase 27 (a): at H = F = WW_FUSED_H, K2 (factored) against its plain
    search and the fused-step path (K1 per step, the many-row path) at
    atol 0, K7 (both kinds) likewise against K6
    (``check_k2_shape``, ``check_k7_shape``), over WW_FUSED_IMAGES images
    at each k of WW_FUSED_KS.  -> {name: errors}."""
    import torch

    out = {}
    with widths(H=WW_FUSED_H, F=WW_FUSED_H):
        decs = decoder_params(device)
        for k in WW_FUSED_KS:
            kw = dict(k=k, fused=True, timed=False)
            for name, r in (
                    ("k2", check_k2_shape(decs["stylenet"]["decoder"],
                                          device, "factored",
                                          WW_FUSED_IMAGES, **kw)),
                    *((f"k7_{kind}", check_k7_shape(
                        decs[variant]["decoder"], kind, device,
                        WW_FUSED_IMAGES, **kw))
                      for kind, variant in ATT_KINDS.items())):
                o = out.setdefault(name, {"max_abs_err": 0.0,
                                          "near_tie_flips": 0})
                o["max_abs_err"] = max(o["max_abs_err"], r["max_abs_err"])
                o["near_tie_flips"] += r["near_tie_flips"]
        del decs
        torch.cuda.empty_cache()
    log(f"phase 27 (a): at H = F = {WW_FUSED_H}, {WW_FUSED_IMAGES} images, "
        f"k = {WW_FUSED_KS}: K2 = K1 fused-step and K7 = K6 at atol 0; "
        + json.dumps(out))
    return out


def ww_engine(device, root: str) -> dict:
    """Phase 27 (a): ``CaptionEngine`` with phase 6's seeded variants at H
    = F = WW_FUSED_H: WW_REQUESTS requests one by one through
    ``caption(path="fused-step")`` (K1 and K6 on the column-split path,
    the h0/c0 launch, NIC's K2) and ``caption(path="mega")`` (K2, K7),
    then the same images as one batch through ``decode`` on both paths (K1
    and K6 many-row); the fused-step captions those
    of the whole searches.  Every count from 0 just before and read just
    after, exact: K1 and K6 once a step the searches ran (``*_steps``), no
    plain version.  -> the counts."""
    import numpy as np
    import torch
    from PIL import Image

    from icee_tpu_torch.core.config import mode_id
    from icee_tpu_torch.decode.beam import BeamResult
    from icee_tpu_torch.ops.att_beam import mega_att_beam_decode_steps
    from icee_tpu_torch.ops.beam import mega_beam_decode_steps
    from icee_tpu_torch.serve.config import ServeConfig
    from icee_tpu_torch.serve.engine import BEAM_K, CaptionEngine

    rng = np.random.default_rng(27)
    paths = []
    for i in range(WW_REQUESTS):
        small = rng.integers(0, 255, (8, 8, 3), dtype=np.uint8)
        p = os.path.join(root, f"photo{i}.jpg")
        Image.fromarray(small).resize((256, 256), Image.BILINEAR).save(
            p, quality=90)
        paths.append(p)
    mode = "happy"
    with widths(H=WW_FUSED_H, F=WW_FUSED_H):
        params = captioning_params(device)
        config = ServeConfig(backend_host="127.0.0.1", backend_port=0,
                             image_folder=os.path.join(root, "uploads"),
                             vocab_path=serving_vocab(root))
    engine = CaptionEngine(config, image_size=224, device=device,
                           params=params)
    widths_h = {v: engine.models[v]["happy"]["decoder"][w].shape[0]
                for v, w in (("stylenet", "W_w"), ("stylenet_att", "W_w"),
                             ("nic_att", "init_h_b"))}
    if set(widths_h.values()) != {WW_FUSED_H}:
        fail(f"phase 27 (a): the engine's decoders' H {widths_h}")
    counters = wide_counters()
    step, att_step = (counters[n][0] for n in ("decode_step_topk",
                                               "att_decode_step_topk"))
    for p in ("split", "tiled"):   # the path each step call took
        counters[f"decode_step_topk_{p}"] = (step, f"{p}_launches")
        counters[f"att_decode_step_topk_{p}"] = (att_step, f"{p}_launches")
        counters[f"att_decode_step_topk_lstm_{p}"] = (att_step,
                                                      f"lstm_{p}_launches")
    steps_max = engine.dec_cfg.max_seq_length
    with torch.inference_mode():
        feats = {v: torch.cat([engine.encode(p, mode, v) for p in paths])
                 for v in ("stylenet", "stylenet_att", "nic_att")}
        n = len(paths)
        sty = engine.models["stylenet"][mode]["decoder"]
        tiled = feats["stylenet"][:, None, :].expand(
            n, BEAM_K, feats["stylenet"].shape[1]).contiguous()
        s1 = mega_beam_decode_steps(sty, tiled, mode_id(mode), n, k=BEAM_K,
                                    max_seq_length=steps_max)[1][:, 0]
        s6 = {kind: mega_att_beam_decode_steps(
            engine.models[v][mode]["decoder"], feats[v], mode_id(mode), n,
            k=BEAM_K, max_seq_length=engine.att_cfg.max_seq_length,
            kind=kind)[1][:, 0] for kind, v in ATT_KINDS.items()}
    # one image a request: the column-split path, K1 / K6 once a step of
    # its search; one batch: the many-row path, once a step of the longest
    want = {}
    for how, agg, p in (("serial", lambda s: int(s.sum()), "split"),
                        ("batched", lambda s: int(s.max()), "tiled")):
        want[how] = {"att_init_state": 2 * (n if how == "serial" else 1)}
        for name, s in (("decode_step_topk", s1),
                        ("att_decode_step_topk", s6["factored"]),
                        ("att_decode_step_topk_lstm", s6["lstm"])):
            want[how][name] = want[how][f"{name}_{p}"] = agg(s)
    want["serial"]["mega_beam_decode_lstm"] = n   # NIC's one path, K2
    got, captions = {}, {}
    for how in ("serial", "batched"):
        for fn, attr in counters.values():
            setattr(fn, attr, 0)
        with plain_counters() as plain:
            if how == "serial":
                captions["fused"] = [engine.caption(p, mode, path="fused-step")
                                     for p in paths]
            else:
                captions["fused_batched"] = {
                    v: engine.decode(feats[v], mode, "fused-step", v)
                    for v in feats}
            torch.cuda.synchronize()
        got[how] = {k: getattr(fn, a) for k, (fn, a) in counters.items()}
        if any(plain.values()):
            fail(f"phase 27 (a) engine {how}: a plain version ran: {plain}")
        nonzero = {k: v for k, v in got[how].items() if v}
        if nonzero != want[how]:
            fail(f"phase 27 (a) engine {how}: launches {nonzero}, expected "
                 f"{want[how]}")
    captions["mega"] = [engine.caption(p, mode) for p in paths]
    with torch.inference_mode():
        mega_batched = {v: engine.decode(feats[v], mode, "mega", v)
                        for v in feats}
    for j in range(n):
        for v in feats:
            if captions["fused"][j][v] != captions["mega"][j][v]:
                fail(f"phase 27 (a) engine request {j} {v}: fused-step "
                     f"{captions['fused'][j][v]!r} != mega "
                     f"{captions['mega'][j][v]!r}")
    for v, res in captions["fused_batched"].items():
        want_res = mega_batched[v]
        if not all(torch.equal(getattr(res, f), getattr(want_res, f))
                   for f in BeamResult._fields):
            fail(f"phase 27 (a) engine batched {v}: the fused-step beams "
                 "differ from the whole search's (atol 0)")
    words = {v: [len(c[v].split()) for c in captions["mega"]] for v in feats}
    log(f"phase 27 (a) engine at H = F = {WW_FUSED_H}: {n} requests and "
        f"one batch of {n}, fused-step = mega for {sorted(feats)}; words "
        f"{ {v: (min(w), max(w)) for v, w in words.items()} }; launches "
        f"{ {h: {k: v for k, v in g.items() if v} for h, g in got.items()} }")
    del engine, params
    torch.cuda.empty_cache()
    return {k: got["serial"][k] + got["batched"][k] for k in got["serial"]}


def ww_k5(device) -> dict:
    """Phase 27 (b): K5, both cells, teacher-forced and sampled, forward and
    backward, against its plain versions as phase 10 holds them
    (``check_k5``) at B = B_ATT and each (T, A) of WW_K5, where the d_att1
    pass splits A (2 column blocks at each); the factored sampled scan
    timed.  -> {"T{t}_A{a}": {"fwd", "bwd"}} of the timed runs, and the
    largest errors."""
    from icee_tpu_torch.ops.att_scan import datt1_plan

    out, errs = {}, {"fwd": 0.0, "bwd": 0.0, "trace_flips": 0}
    for t, a in WW_K5:
        with widths(T_STEPS=t, A=a):
            for kind in ("factored", "lstm"):
                for sampled in (False, True):
                    timed = kind == "factored" and sampled
                    fwd, bwd = check_k5(kind, sampled, device, timed=timed)
                    errs["fwd"] = max(errs["fwd"], fwd["max_abs_err"])
                    errs["bwd"] = max(errs["bwd"], bwd["max_rel_err"])
                    errs["trace_flips"] += fwd["trace_flips"]
                    if timed:
                        out[f"T{t}_A{a}"] = {
                            "fwd": fwd, "bwd": bwd,
                            "datt1_plan": datt1_plan(t, a)}
    log(f"phase 27 (b): K5 ok at (T, A) {WW_K5}, B {B_ATT}: forward max abs "
        f"err {errs['fwd']:.3g}, backward max err / max|g| "
        f"{errs['bwd']:.3g}, trace flips {errs['trace_flips']}; "
        + "; ".join(f"{s}: fwd {v['fwd']['ms']:.3f} ms (bound "
                    f"{v['fwd']['bound_ms']:.3f}), bwd {v['bwd']['ms']:.3f} "
                    f"(bound {v['bwd']['bound_ms']:.3f})"
                    for s, v in out.items()))
    return {"shapes": out, **errs}


def ww_k7(device) -> dict:
    """Phase 27 (c): K7 (both kinds) against its plain search,
    margin-aware, and the fused-step path (K6 per step) at atol 0
    (``check_k7_shape``): at P in WW_PS over one image and B_IMAGES at k =
    5 and 8 images at k = 20 (timed at B_IMAGES images where P is in
    WW_P_TIMED), at P = WW_P_DEVICE (the softmax rows in device memory) and
    at A = WW_WIDE_A (att2 from L2) over one image, timed; the h0/c0
    launch at P = WW_INIT_P within 1e-4 of ``init_hidden_state`` and =
    K7's at atol 0.  -> {kind: {"max_abs_err", ..., "shapes"}, "init"}."""
    import torch

    from icee_tpu_torch.models import attention as att_mod
    from icee_tpu_torch.ops.att_beam import alpha_layout, search_init_state
    from icee_tpu_torch.ops.att_decode_step import att_init_state

    out = {kind: {"max_abs_err": 0.0, "near_tie_flips": 0,
                  "max_rescore_err": 0.0, "shapes": {}}
           for kind in ATT_KINDS}
    cases = [(p, n, k, n == B_IMAGES and p in WW_P_TIMED)
             for p in WW_PS for n, k in WW_P_SHAPES]
    cases += [(WW_P_DEVICE, 1, K, True)]
    decs = decoder_params(device)
    for p, n_img, k, timed in cases:
        with widths(P=p):
            for kind, variant in ATT_KINDS.items():
                r = check_k7_shape(decs[variant]["decoder"], kind, device,
                                   n_img, k=k, timed=timed)
                o = out[kind]
                o["max_abs_err"] = max(o["max_abs_err"], r["max_abs_err"])
                o["max_rescore_err"] = max(o["max_rescore_err"],
                                           r["max_rescore_err"])
                o["near_tie_flips"] += r["near_tie_flips"]
                if timed:
                    o["shapes"][f"p{p}_a{A}_images{n_img}"] = dict(
                        r, P=p, A=A, images=n_img, k=k,
                        alpha_layout=alpha_layout(p, A))
        torch.cuda.empty_cache()
    del decs
    with widths(A=WW_WIDE_A):
        decs = decoder_params(device)
        for kind, variant in ATT_KINDS.items():
            r = check_k7_shape(decs[variant]["decoder"], kind, device, 1,
                               timed=True)
            o = out[kind]
            o["max_abs_err"] = max(o["max_abs_err"], r["max_abs_err"])
            o["max_rescore_err"] = max(o["max_rescore_err"],
                                       r["max_rescore_err"])
            o["near_tie_flips"] += r["near_tie_flips"]
            o["shapes"][f"p{P}_a{WW_WIDE_A}_images1"] = dict(
                r, P=P, A=WW_WIDE_A, images=1, k=K,
                alpha_layout=alpha_layout(P, WW_WIDE_A))
        del decs
        torch.cuda.empty_cache()
    decs = decoder_params(device)
    init_err = 0.0
    with widths(P=WW_INIT_P):
        for n in (1, B_IMAGES):
            feats = att_features(device, n, 31)
            for kind, variant in ATT_KINDS.items():
                dec = decs[variant]["decoder"]
                h0, c0 = att_init_state(dec, feats)
                kh, kc = search_init_state(dec, feats, kind,
                                           3 if kind == "factored" else 0, K)
                wh, wc = att_mod.init_hidden_state(dec, feats)
                torch.cuda.synchronize()
                e = max((h0 - wh).abs().max().item(),
                        (c0 - wc).abs().max().item())
                init_err = max(init_err, e)
                if not e <= 1e-4:
                    fail(f"phase 27 (c) att_init_state {kind}, P = "
                         f"{WW_INIT_P}, {n} images: error {e} > 1e-4")
                if kh is None or not (torch.equal(h0, kh)
                                      and torch.equal(c0, kc)):
                    fail(f"phase 27 (c) att_init_state {kind}, P = "
                         f"{WW_INIT_P}, {n} images: h0/c0 differ from K7's")
    out["init"] = {"P": WW_INIT_P, "max_abs_err": init_err}
    out["main_counts"] = ww_main_path(decs, device)
    del decs
    torch.cuda.empty_cache()
    log(f"phase 27 (c): K7 ok at P {WW_PS} (1 and {B_IMAGES} images, k = "
        f"{K}; 8 at k = 20), {WW_P_DEVICE} and A = {WW_WIDE_A} (one image); "
        + "; ".join(f"{kind} max err {o['max_abs_err']:.3g}, re-score "
                    f"{o['max_rescore_err']:.3g}, near-tie flips "
                    f"{o['near_tie_flips']}" for kind, o in out.items()
                    if kind in ATT_KINDS)
        + f"; h0/c0 at P = {WW_INIT_P} max err {init_err:.3g}, = K7's")
    return out


def ww_main_path(decs, device) -> dict:
    """Phase 27 (c): the attention decoders' main path at P = WW_INIT_P
    through ``decode/fast.py`` (what the engines and the CLIs call), every
    count from 0 just before and read just after: 2 images at k = 5, each
    kind's whole search (K7 once) and fused-step path (the h0/c0 launch
    once, K6 once a step the search ran), each fused-step result = its
    whole search's at atol 0; no plain version.  -> the counts."""
    import torch

    from icee_tpu_torch.decode.fast import attention_decode, nic_att_decode
    from icee_tpu_torch.ops.att_beam import mega_att_beam_decode_steps

    n, styles = 2, {"factored": 3, "lstm": 0}
    att = {kind: decs[v]["decoder"] for kind, v in ATT_KINDS.items()}
    with widths(P=WW_INIT_P):
        spatial = att_features(device, n, 32)
    steps = {kind: int(mega_att_beam_decode_steps(
        dec, spatial, styles[kind], n, k=K, max_seq_length=STEPS,
        kind=kind)[1][:, 0].max()) for kind, dec in att.items()}
    counters = wide_counters()
    for fn, attr in counters.values():
        setattr(fn, attr, 0)
    with plain_counters() as plain:
        res = {}
        for path in ("mega", "fused-step"):
            res["factored", path] = attention_decode(
                path, att["factored"], spatial, styles["factored"], n, K,
                STEPS, 1, 2)
            res["lstm", path] = nic_att_decode(path, att["lstm"], spatial,
                                               n, K, STEPS, 1, 2)
        torch.cuda.synchronize()
    got = {k: getattr(fn, a) for k, (fn, a) in counters.items()}
    if any(plain.values()):
        fail(f"phase 27 (c) main path: a plain version ran: {plain}")
    want = {"mega_att_beam_decode": 1, "mega_att_beam_decode_lstm": 1,
            "att_decode_step_topk": steps["factored"],
            "att_decode_step_topk_lstm": steps["lstm"], "att_init_state": 2}
    if {k: v for k, v in got.items() if v} != want:
        fail(f"phase 27 (c) main path: launches {got}, expected {want}")
    for kind in att:
        a, b = res[kind, "mega"], res[kind, "fused-step"]
        if not all(torch.equal(x, y) for x, y in zip(a, b)):
            fail(f"phase 27 (c) main path {kind}: the fused-step path's "
                 "beams differ from the whole search's (atol 0)")
    log(f"phase 27 (c) main path at P = {WW_INIT_P}: {n} images, k = {K}, "
        f"launches {want}; fused-step = whole search at atol 0")
    return got


def ww_cli(keep: str) -> tuple:
    """Phase 27 (d): the spatial path as processes over WW_CLI_IMAGES fresh
    JPEGs, phase 19's vocabulary and seeded backbone (``keep``):
    ``precompute_features --spatial --grid WW_GRID`` (P = 400), ``train --attention
    --attention_size WW_CLI_A`` for one epoch at ratio 0.8 (K5 sampled a
    step, forward and backward, its d_att1 pass in 2 column blocks; the CE
    a step and chunk), ``evaluate --attention`` and ``caption_batch
    --attention`` from its checkpoint (K7 a batch); each exits 0 with its
    launches exact and no plain version.  -> (launches, stats)."""
    import numpy as np
    from PIL import Image

    from icee_tpu_torch.ops import chunked_loss as cl

    m = "icee_tpu_torch.cli."
    root = os.path.join(keep, "grid20")
    logs = os.path.join(root, "logs")
    img_dir = os.path.join(root, "img")
    os.makedirs(logs)
    os.makedirs(img_dir)
    rng = np.random.default_rng(270)
    for i in range(WW_CLI_IMAGES):
        small = rng.integers(0, 256, (16, 16, 3), dtype=np.uint8)
        Image.fromarray(small, "RGB").resize((256, 256), Image.BILINEAR).save(
            os.path.join(img_dir, f"g{i}.jpg"), quality=90)

    def write(name, examples):
        path = os.path.join(root, name)
        seen = {}
        with open(path, "w") as f:
            for e in examples:
                j = seen[e.image] = seen.get(e.image, -1) + 1
                f.write(f"{e.image}.jpg#{j}\t"
                        + " ".join(f"w{i}" for i in e.caption_ids[1:-1])
                        + "\n")
        return path

    files = {name: write(f"{name}.txt", trainer_corpus(n, TR_CAPS, seed, "g"))
             for name, n, seed in (("train", WW_CLI_IMAGES, 271),
                                   ("val", WW_CLI_VAL, 272),
                                   ("happy", WW_CLI_EMO, 273),
                                   ("val_happy", WW_CLI_VAL, 274))}
    launches, stats = {}, {}

    def stage(name, module, args, want, ratio=None):
        st, counts, out = cli_stage(name, module, args, logs, want, ratio,
                                    phase=27)
        stats[name] = st
        for k, n in counts.items():
            launches[k] = launches.get(k, 0) + n
        return out

    vocab_path = os.path.join(keep, "vocab.pkl")
    spatial = os.path.join(root, "spatial.npz")
    stage("precompute_features_grid", m + "precompute_features", [
        "--caption_path", files["train"], "--image_dir", img_dir, "--out",
        spatial, "--batch_size", 32, "--spatial", "--grid", WW_GRID,
        "--resnet_weights", os.path.join(keep, "resnet152.npz")], {})
    with np.load(spatial) as z:
        shapes = [z[n].shape for n in z.files]
    if set(shapes) != {(WW_GRID * WW_GRID, FS)} or \
            len(shapes) != WW_CLI_IMAGES:
        fail(f"phase 27 (d) precompute_features: {len(shapes)} features, "
             f"shapes {set(shapes)}")
    width = ["--attention", "--attention_size", WW_CLI_A]
    t_in = STEPS + 1   # targets of captions padded to max_seq_length + 2
    n_fac = -(-WW_CLI_IMAGES * TR_CAPS // CLI_BATCH)
    n_emo = -(-WW_CLI_EMO * TR_CAPS // B_EMOTION)
    ce = sum(n * -(-t_in // cl.auto_t_chunk(b, t_in))
             for n, b in ((n_fac, CLI_BATCH), (n_emo, B_EMOTION)))
    models = os.path.join(root, "models")
    stage("train_attention", m + "train", [
        "--trainer", "multitask", "--family", "stylenet", *width, "--mode",
        "happy", "--vocab_path", vocab_path, "--caption_path",
        files["train"], "--val_caption_path", files["val"], "--happy_path",
        files["happy"], "--val_happy_path", files["val_happy"],
        "--feature_cache", spatial, "--num_epochs", 1,
        "--caption_batch_size", CLI_BATCH, "--language_batch_size",
        B_EMOTION, "--model_path", models, "--log_path",
        os.path.join(logs, "train.txt"), "--metrics_path",
        os.path.join(logs, "train.jsonl"), "--data_name", "grid20",
        "--log_step", 10 ** 9, "--log_step_emotion", 10 ** 9],
        {"fused_att_scan_sampled_fwd": n_fac + n_emo,
         "fused_att_scan_sampled_bwd": n_fac + n_emo, "ce_rows": ce,
         "ce_grad_rows": ce}, ratio=0.8)
    with open(os.path.join(logs, "train.jsonl")) as f:
        losses = [e["train_loss"] for e in map(json.loads, f)
                  if e["event"].startswith("epoch_")]
    if len(losses) != 2 or not all(np.isfinite(losses)):
        fail(f"phase 27 (d) train: epoch losses {losses}")
    stats["train_attention"]["train_loss"] = losses
    best = os.path.join(models, "HAP_BEST_checkpoint_grid20")
    if not os.path.isdir(best):
        best = os.path.join(models, "HAP_checkpoint_grid20")
    common = ["--vocab_path", vocab_path, "--feature_cache", spatial,
              "--batch_size", CLI_BATCH, "--checkpoint_path", best, *width]
    n_val = WW_CLI_VAL * TR_CAPS
    out = stage("evaluate_attention", m + "evaluate", common + [
        "--test_path", files["val"], "--mode", "happy"],
        {"mega_att_beam_decode": -(-n_val // CLI_BATCH)})
    bleu = bleu_lines(out)
    if len(bleu) != 4 or not all(np.isfinite(b) for b in bleu):
        fail(f"phase 27 (d) evaluate: BLEU lines {bleu}")
    stats["evaluate_attention"]["bleu"] = bleu
    caps = os.path.join(root, "captions.json")
    stage("caption_batch_attention", m + "caption_batch", common + [
        "--mode", "happy", "--out", caps],
        {"mega_att_beam_decode": -(-WW_CLI_IMAGES // CLI_BATCH)})
    with open(caps) as f:
        got = json.load(f)
    if len(got) != WW_CLI_IMAGES:
        fail(f"phase 27 (d) caption_batch: {len(got)} captions")
    stats["config"] = {"images": WW_CLI_IMAGES, "grid": WW_GRID,
                       "P": WW_GRID * WW_GRID, "A": WW_CLI_A,
                       "T": t_in, "batch": CLI_BATCH,
                       "emotion_batch": B_EMOTION}
    return launches, stats


def ww_entries(steps, k5, k7, counts) -> list:
    """Phase 27's entries of the kernels line: K1, K6 (both kinds) at H = F
    = 1024 (their launches the engine's at that width), K5 factored sampled
    forward and backward at (T, A) = (42, 2048) (launches (d)'s train), K7
    (both kinds) at P = 400 over 64 images (launches (c)'s main path and,
    the factored kind, (d)'s evaluate and caption_batch), every timed
    shape under ``shapes``."""
    step = "icee_tpu/ops/pallas_att_decode.py:201 (kind=\"{}\"; H = F past "
    k1h = k6h = f"h{WW_FUSED_H}_rows{B_IMAGES * K}"
    entries = [wide_entry(
        "decode_step_topk_wide_hidden", "icee_tpu_torch/csrc/decode_step.cu",
        "icee_tpu/ops/pallas_decode.py:261 (H = F past 772: the many-row "
        "path's products)", steps["k1"], k1h,
        launches=counts["decode_step_topk"])]
    for kind, sfx in (("factored", ""), ("lstm", "_lstm")):
        entries.append(wide_entry(
            f"att_decode_step_topk{sfx}_wide_hidden",
            "icee_tpu_torch/csrc/att_decode_step.cu",
            step.format(kind) + "544: the many-row path's products)",
            steps[kind], k6h, launches=counts[f"att_decode_step_topk{sfx}"]))
    for d, line in (("fwd", ":623"), ("bwd", ":758")):
        shapes = {s: v[d] for s, v in k5["shapes"].items()}
        top = shapes[f"T{WW_K5[0][0]}_A{WW_K5[0][1]}"]
        entries.append(dict(
            {k: top[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms",
                                 "bound_by", "max_abs_err")},
            name=f"fused_att_scan_sampled_{d}_wide_attention",
            route="cuda", source="icee_tpu_torch/csrc/att_scan.cu",
            replaces=f"icee_tpu/ops/pallas_att_train.py{line} (:887, "
                     "T x (A + 28) past one block's d_att1 plane)",
            launches=counts[f"fused_att_scan_sampled_{d}"],
            headline=f"T{WW_K5[0][0]}_A{WW_K5[0][1]}", shapes=shapes,
            datt1_plans={s: v["datt1_plan"] for s, v in
                         k5["shapes"].items()}))
    k7h = f"p{WW_INIT_P}_a{A}_images{B_IMAGES}"
    for kind, sfx in (("factored", ""), ("lstm", "_lstm")):
        entries.append(wide_entry(
            f"mega_att_beam_decode{sfx}_wide_positions",
            "icee_tpu_torch/csrc/att_beam.cu",
            f"icee_tpu/ops/pallas_att_decode.py:733 (kind=\"{kind}\"; the "
            "P-streamed call :907, any P; A past 3,840)", k7[kind], k7h,
            launches=counts.get(f"mega_att_beam_decode{sfx}", 0)
            + k7["main_counts"][f"mega_att_beam_decode{sfx}"],
            init_at_p400=k7["init"]))
    return entries


def wide_width_phase(device, keep: str) -> tuple:
    """Phase 27: the step and attention kernels at every width the JAX
    package takes: (a) K1, K6, the atol-0 checks and the engine at H = F
    past 8 rows a cell block, (b) K5 past the d_att1 plane, (c) K7 past 256
    positions and A = 3,840, (d) the spatial path's processes, on a thread
    beside (a)-(c).  -> (the kernels line's entries, stats)."""
    import torch

    t0 = time.perf_counter()
    with ThreadPoolExecutor(1) as pool:
        cli_job = pool.submit(ww_cli, keep)
        with torch.inference_mode():
            steps = ww_steps(device)
            log("phase 27 (a): K1, K6 ok at H = F = " + ", ".join(
                map(str, WW_HS)) + "; " + "; ".join(
                    f"{n} max err {f['max_abs_err']:.3g}, near-tie swaps "
                    f"{f['near_tie_swaps']}" for n, f in steps.items())
                + "; ms (library, bound) " + "; ".join(
                    f"{n} {tag} {s['ms']:.3f} ({s['library_ms']:.3f}, "
                    f"{s['bound_ms']:.3f})" for n, f in steps.items()
                    for tag, s in f["shapes"].items()))
            fused = ww_fused(device)
            with tempfile.TemporaryDirectory() as root:
                engine_counts = ww_engine(device, root)
        t_a = time.perf_counter() - t0
        k5 = ww_k5(device)
        t_b = time.perf_counter() - t0
        with torch.inference_mode():
            k7 = ww_k7(device)
        t_c = time.perf_counter() - t0
        cli_counts, cli = cli_job.result()
    counts = dict(engine_counts)
    for k, n in cli_counts.items():
        counts[k] = counts.get(k, 0) + n
    entries = ww_entries(steps, k5, k7, counts)
    stats = {"fused": fused, "cli": cli, "launches": counts,
             "phase_s": {"a": t_a, "b": t_b - t_a, "c": t_c - t_b,
                         "whole": time.perf_counter() - t0}}
    log(f"phase 27 done in {stats['phase_s']['whole']:.1f} s ((a) "
        f"{t_a:.1f}, (b) {t_b - t_a:.1f}, (c) {t_c - t_b:.1f}; (d) beside "
        f"them); launches {counts}")
    return entries, stats


# --- phase 28: batches past 2048 (K3, K4, K8) ---------------------------------
#
# The streamed plan takes any B (it cut the batch into 64-row items from
# the first; the cap of 2048 guarded nothing): K3, K4 and K8 forward and
# backward at B = 4096, H = 512 against their plain versions at phase 24's
# limits, timed beside the bound (K4 also beside cuDNN's nn.LSTM).  The
# train CLI's step at --caption_batch_size 4096 through K3 is phase 24
# (c)'s StyleNet epoch (at --hidden_size 1024: one process for both).

BIG_B, BIG_H = 4096, 512
BIG_SCANS = (("K3", BIG_B, BIG_H), ("K4", BIG_B, BIG_H), ("K8", BIG_B, BIG_H))
BIG_CAPS = 4                  # captions an image: BIG_B // BIG_CAPS images


def big_batch_files(keep: str) -> tuple:
    """BIG_B training captions (BIG_B // BIG_CAPS images t0 .., BIG_CAPS
    each, phase 19's words) and a feature cache of random 2048-d vectors
    for those images and phase 19's (its validation and emotion captions
    name images t0 .. t209) under ``keep``: phase 24 (c)'s StyleNet epoch
    trains on them at --caption_batch_size BIG_B.  -> (captions, cache)."""
    import numpy as np

    n_img = BIG_B // BIG_CAPS
    train = os.path.join(keep, "big_train.txt")
    with open(train, "w") as f:
        for j, e in enumerate(trainer_corpus(n_img, BIG_CAPS, 280, "t")):
            f.write(f"{e.image}.jpg#{j % BIG_CAPS}\t"
                    + " ".join(f"w{i}" for i in e.caption_ids[1:-1]) + "\n")
    cache = os.path.join(keep, "big_features.npz")
    rng = np.random.default_rng(281)
    np.savez(cache, **{f"t{i}.jpg": rng.random(2048, dtype=np.float32)
                       for i in range(max(n_img, CLI_IMAGES))})
    return train, cache


def big_batch_phase(device) -> tuple:
    """Phase 28 -> (entries of its shapes, each named as phase 24's entry
    it joins with ``_big_b`` for ``_wide_h``, stats)."""
    import torch

    t0 = time.perf_counter()
    scans = {}
    for kernel, b, h in BIG_SCANS:
        scans[f"{kernel} B{b} H{h}"] = check_wide_scan(kernel, b, h, device,
                                                       "28")
        torch.cuda.empty_cache()
    log("phase 28: K3, K4, K8 at B = 4096 ok: " + "; ".join(
        f"{k} {f['plan']['forward']}/{f['plan']['backward']} fwd "
        f"{f['fwd_ms']:.3f} (plain {f['plain_fwd_ms']:.3f}, bound "
        f"{f['bound_fwd_ms']:.3f}) bwd {f['bwd_ms']:.3f} (plain "
        f"{f['plain_bwd_ms']:.3f}, bound {f['bound_bwd_ms']:.3f})"
        for k, f in scans.items()))
    head = f"B{BIG_B} H{BIG_H}"
    entries = wide_scan_entries(scans, {}, "big_b", (head,) * 3, "B > 2048")
    stats = {"scans": scans, "phase_s": time.perf_counter() - t0}
    log(f"phase 28: batches past 2048 ok in {stats['phase_s']:.1f} s")
    return entries, stats


# --- phase 29: K5 past T = 1,816, K6 past A = 7,264, the selection ----------
#
# (a) K5 factored, sampled, forward and backward at T = 1,900 (the d_att1
# pass in chunks of steps, ``att_scan.datt1_steps``) over P29_K5_IMAGES
# images at A = 512, as phase 10 holds it, timed beside its bound; (b) K6
# (both kinds) at A = 8,192, P = 196 over one image and 64 at k = 8 (a
# group's 8 att2 rows past a block's shared memory: the scores launch in
# column pieces), as phase 5b holds it, timed, and K7 (both kinds) = K6 at
# atol 0 there over P29_K7_IMAGES images; (c) where K2's time goes (the
# search's profile marks: products, row stage, tail) at k = 20 over 64
# images, k = 300 over 3 (``caption_batch --beam_size 300``'s launch) and
# k = 2048 at one image, K2 at k = 300 timed beside its bound.

P29_K5 = (1900, 512)          # (a): T, A
P29_K5_IMAGES = 4
P29_A, P29_K = 8192, 8        # (b): A, k (= top-k)
P29_K6_IMAGES = (1, B_IMAGES)
P29_K7_IMAGES, P29_K7_STEPS = 4, 8
P29_SPLITS = ((20, 64, 40), (300, 3, 20), (2048, 1, 4))   # (c): k, images,
P29_K2_TIMED = (300, 3, 20)                               # steps


def grid_split(call) -> dict:
    """One call of a K2 search with the search's profile marks on
    (``csrc/grid_beam.cuh`` gb_mark): ms of its live-row scans and
    products, its row stages and its tails, summed over its launches and
    steps, and the steps."""
    import ctypes

    import torch

    from icee_tpu_torch.ops import beam, cuda_lib

    lib = beam._library()
    fn = lib.icee_grid_profile
    fn.argtypes, fn.restype = [ctypes.c_int, ctypes.c_void_p], ctypes.c_int
    words = (ctypes.c_ulonglong * 8)()
    torch.cuda.synchronize()
    cuda_lib.check_rc(lib, fn(1, None), "grid profile on")
    call()
    torch.cuda.synchronize()
    cuda_lib.check_rc(lib, fn(0, ctypes.addressof(words)), "grid profile off")
    return {"products_ms": words[0] / 1e6, "row_stage_ms": words[1] / 1e6,
            "tail_ms": words[2] / 1e6, "steps": int(words[4])}


def p29_k5(device) -> dict:
    """Phase 29 (a): ``check_k5``'s checks, then the kernel's and the plain
    version's times on its inputs (the plain ones once: a plain step loop
    of 1,900 steps) beside the bound -> {"fwd", "bwd"}."""
    import torch

    from icee_tpu_torch.ops import att_scan
    from icee_tpu_torch.ops.att_scan import datt1_plan, datt1_steps

    t, a = P29_K5
    with widths(T_STEPS=t, A=a, B_ATT=P29_K5_IMAGES):
        err_f, err_b = check_k5("factored", True, device, timed=False)
        # check_k5's inputs (its seed for the sampled factored scan)
        args, samp, (dh, da) = k5_inputs("factored", device, True, 52)
        with torch.no_grad():
            h, al, res = att_scan.att_scan_fwd(*args, samp)
            plain_args = (*args[:2], samp["head"], args[2], samp["emb_raw"],
                          *args[3:7], samp["coins"], "factored")
            fwd = {"ms": cuda_ms(lambda: att_scan.att_scan_fwd(*args, samp),
                                 3),
                   "plain_ms": cuda_ms(
                       lambda: att_scan.fused_att_scan_sampled_plain(
                           *plain_args), 1, 0)}
            bwd = {"ms": cuda_ms(lambda: att_scan.att_scan_bwd(
                       *args[:7], h, al, res, dh, da, "factored", samp), 3),
                   "plain_ms": cuda_ms(lambda: att_scan.att_scan_grads_plain(
                       *args[:7], h, al, res, dh, da, "factored", samp), 1,
                       0)}
        # the library chain (the per-step PyTorch calls, autograd
        # backward), once each
        with torch.no_grad():
            fwd["library_ms"] = cuda_ms(lambda: k5_library_scan(args, samp),
                                        1, 0)
        lh, la, leaves = k5_library_scan(args, samp, grad=True)
        bwd["library_ms"] = cuda_ms(lambda: torch.autograd.grad(
            (lh, la), leaves, (dh, da), retain_graph=True), 1, 0)
        del lh, la, leaves
        flops_f, bytes_f, flops_b, bytes_b = k5_flops_bytes("factored", True)
        fwd["bound_ms"], fwd["bound_by"] = bound_ms(flops_f, bytes_f)
        bwd["bound_ms"], bwd["bound_by"] = bound_ms(flops_b, bytes_b)
        for d in (fwd, bwd):
            d.update(T=t, A=a, B=P29_K5_IMAGES)
        fwd.update(max_abs_err=err_f["max_abs_err"],
                   trace_flips=err_f["trace_flips"])
        bwd.update(max_abs_err=err_b["max_abs_err"],
                   max_rel_err=err_b["max_rel_err"])
        del args, samp, h, al, res
        torch.cuda.empty_cache()
    plan = (*datt1_plan(t, a), datt1_steps(t, a))
    log(f"phase 29 (a): K5 sampled factored ok at T = {t}, A = {a}, B = "
        f"{P29_K5_IMAGES} (d_att1: {plan[0]} columns x {plan[1]} blocks, "
        f"{plan[2]} steps a chunk): fwd {fwd['ms']:.3f} ms (plain "
        f"{fwd['plain_ms']:.3f}, library {fwd['library_ms']:.3f}, bound "
        f"{fwd['bound_ms']:.3f}), bwd {bwd['ms']:.3f} (plain "
        f"{bwd['plain_ms']:.3f}, library {bwd['library_ms']:.3f}, bound "
        f"{bwd['bound_ms']:.3f})")
    return {"fwd": dict(fwd, datt1_plan=plan),
            "bwd": dict(bwd, datt1_plan=plan)}


def p29_attention(device) -> tuple:
    """Phase 29 (b) -> ({kind: {"a8192_rows{R}": times}}, errors)."""
    import torch

    from icee_tpu_torch.ops.att_decode_step import scores_cols

    out, errs = {kind: {} for kind in ATT_KINDS}, {}
    with widths(A=P29_A):
        decs = decoder_params(device)
        with torch.inference_mode():
            for kind, variant in ATT_KINDS.items():
                dec = decs[variant]["decoder"]
                for n_img in P29_K6_IMAGES:
                    rows = n_img * P29_K
                    args, err, ties = check_k6(dec, kind, device, n_img,
                                               290 + n_img, k=P29_K)
                    errs[f"k6_{kind}_images{n_img}"] = [err, ties]
                    out[kind][f"a{P29_A}_rows{rows}"] = dict(
                        k6_times(kind, args, 5, 2, 1), A=P29_A, rows=rows,
                        scores_cols=scores_cols(P29_K, P29_A))
                    del args
                r = check_k7_shape(dec, kind, device, P29_K7_IMAGES,
                                   k=P29_K, steps_max=P29_K7_STEPS,
                                   fused=True, timed=False)
                errs[f"k7_{kind}"] = [r["max_abs_err"], r["near_tie_flips"]]
        del decs
        torch.cuda.empty_cache()
    log(f"phase 29 (b): K6 ok at A = {P29_A}, P = {P}, k = {P29_K} (att2 in "
        f"column pieces of {scores_cols(P29_K, P29_A)}), K7 = K6 at atol 0 "
        f"over {P29_K7_IMAGES} images; errors {json.dumps(errs)}; ms "
        + "; ".join(f"{kind} {tag} {f['ms']:.3f} (plain {f['plain_ms']:.3f}"
                    f", library {f['library_ms']:.3f}, bound "
                    f"{f['bound_ms']:.3f})" for kind, shapes in out.items()
                    for tag, f in shapes.items()))
    return out, errs


def p29_splits(device) -> dict:
    """Phase 29 (c) -> {"v{V}_k{k}_images{n}": split (and, at
    P29_K2_TIMED, check_k2_shape's figures)}."""
    import torch

    from icee_tpu_torch.ops.beam import (mega_beam_decode,
                                         mega_beam_decode_plain)

    out = {}
    with torch.inference_mode():
        sty = decoder_params(device)["stylenet"]["decoder"]
        for k, n_img, steps in P29_SPLITS:
            g = torch.Generator(device=device).manual_seed(4)
            feats = torch.randn((n_img, 1, E), generator=g, device=device)
            feats = feats.expand(n_img, k, E).contiguous()
            def search():
                return mega_beam_decode(sty, feats, 2, n_img, k=k,
                                        max_seq_length=steps,
                                        cell="factored")

            fig = {}
            if (k, n_img, steps) == P29_K2_TIMED:
                # phase 26 (b)'s checks; the plain search timed once
                fig = check_k2_shape(sty, device, "factored", n_img, k=k,
                                     steps_max=steps, fused=False,
                                     timed=False)
                kw = dict(max_seq_length=steps, cell="factored")
                fig["ms"] = cuda_ms(search, 3)
                fig["plain_ms"] = cuda_ms(lambda: plain_by_images(
                    mega_beam_decode_plain, n_img, k, sty, feats, 2, **kw),
                    1, 0)
                nbytes = (decoder_weight_bytes("factored", V)
                          + 4 * n_img * k * E
                          + 4 * fig["live_row_steps"] * E
                          + 4 * n_img * (steps + 4))
                fig["bound_ms"], fig["bound_by"] = bound_ms(
                    fig["live_row_steps"] * step_flops_per_row("factored", V),
                    nbytes)
            fig["split"] = grid_split(search)
            out[f"v{V}_k{k}_images{n_img}"] = dict(fig, k=k, images=n_img,
                                                   steps=steps)
        del sty
        torch.cuda.empty_cache()
    log("phase 29 (c): K2's time by part (ms: products, row stage, tail; "
        "steps) " + "; ".join(
            f"{tag} {f['split']['products_ms']:.3f} / "
            f"{f['split']['row_stage_ms']:.3f} / {f['split']['tail_ms']:.3f}"
            f"; {f['split']['steps']}" for tag, f in out.items()))
    return out


def limits_phase(device) -> tuple:
    """Phase 29 -> (K5's, K6's and K2's figures to join their entries,
    stats)."""
    t0 = time.perf_counter()
    k5 = p29_k5(device)
    att, errs = p29_attention(device)
    splits = p29_splits(device)
    stats = {"k6_k7_errors": errs, "phase_s": time.perf_counter() - t0}
    log(f"phase 29 done in {stats['phase_s']:.1f} s")
    return {"k5": k5, "k6": att, "k2": splits}, stats


def main() -> int:
    import shutil

    import torch

    t_run = time.perf_counter()
    phase_s, t_mark = {}, [t_run]

    def done(phase: str) -> None:
        """Logs and keeps the seconds since the last phase ended."""
        now = time.perf_counter()
        phase_s[phase] = round(now - t_mark[0], 2)
        t_mark[0] = now
        log(f"phase {phase}: {phase_s[phase]:.1f} s")

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
    done("1-3")

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
        done("4")
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
        done("5")
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
            f"{k6['factored']['plain_ms']:.3f}, library "
            f"{k6['factored']['library_ms']:.3f}; lstm "
            f"{k6['lstm']['ms']:.3f} ms (serial "
            f"{k6['lstm']['serial_ms']:.3f}) vs plain "
            f"{k6['lstm']['plain_ms']:.3f}, library "
            f"{k6['lstm']['library_ms']:.3f}; h0/c0 at one image "
            f"{att_init['ms']:.4f} ms (device {att_init['device_ms']}), 64 "
            f"images {att_init['shapes'][str(B_IMAGES)]['ms']:.4f}")
        log("phases 4, 5b: column-split path at the serial shape from a "
            "CUDA graph (replay ms, span and stage start/end us): "
            + json.dumps(stages))
        done("5b")
        k7 = {kind: check_k7(dec, kind, device) for kind, dec in att.items()}
        log("phase 5c: K7 ok, ms (plain, bound) at " + "; ".join(
            f"{n} images: factored {k7['factored']['shapes'][n]['ms']:.3f} "
            f"({k7['factored']['shapes'][n]['plain_ms']:.3f}, "
            f"{k7['factored']['shapes'][n]['bound_ms']:.3f}), lstm "
            f"{k7['lstm']['shapes'][n]['ms']:.3f} "
            f"({k7['lstm']['shapes'][n]['plain_ms']:.3f}, "
            f"{k7['lstm']['shapes'][n]['bound_ms']:.3f})"
            for n in k7["factored"]["shapes"]))
        done("5c")
        t5d = time.perf_counter()
        wide, _ = wide_phase(params, device)
        log(f"phase 5d: beam widths {WIDE_KS} ok in "
            f"{time.perf_counter() - t5d:.1f} s; at beam 20, 64 images: "
            + "; ".join(f"{n} {e['ms']:.3f} ms (plain {e['plain_ms']:.3f}, "
                        f"bound {e['bound_ms']:.3f})"
                        for n, e in wide.items()))
        done("5d")

    launches, stats = serve_phase(params, device)
    log(f"phase 6: served {stats['requests']} requests, launches {launches}")
    done("6")
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
    done("7")
    cef, ceb, ce_whole = check_ce(device)
    log(f"phase 8: CE ok, rows {cef['ms']:.4f} ms (cold "
        f"{cef['cold_ms']:.4f}, after addmm {cef['after_addmm_ms']:.4f}, "
        f"bound {cef['bound_ms']:.4f}), grad rows {ceb['ms']:.4f} ms (cold "
        f"{ceb['cold_ms']:.4f}, after addmm {ceb['after_addmm_ms']:.4f}, "
        f"bound {ceb['bound_ms']:.4f}); whole loss fwd+bwd {ce_whole}")
    done("8")
    train_launches, train = train_phase(device)
    nic_launches, train["nic"] = train_phase(device, factored=False)
    train["chunked_ce_fwd_bwd"] = ce_whole
    log(f"phase 9: factual step {train['factual_step_ms']:.3f} ms, "
        f"{train['captions_per_s']:.1f} captions/s (plain "
        f"{train['plain_factual_step_ms']:.3f} ms); nic "
        f"{train['nic']['factual_step_ms']:.3f} ms, "
        f"{train['nic']['captions_per_s']:.1f} captions/s (plain "
        f"{train['nic']['plain_factual_step_ms']:.3f} ms)")
    done("9")
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
    done("10")
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
    done("11")
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
    done("12")
    sc_launches, train["senticap"] = train_senticap_phase(device)
    train["senticap"]["neglog2"] = check_neglog2(device)
    log(f"phase 13: SentiCap step {train['senticap']['step_ms']:.3f} ms, "
        f"{train['senticap']['captions_per_s']:.1f} captions/s (plain "
        f"{train['senticap']['plain_step_ms']:.3f} ms); neglog2 sum "
        f"{train['senticap']['neglog2']['ms']:.4f} ms (plain row pass "
        f"{train['senticap']['neglog2']['plain_ms']:.4f} ms)")
    done("13")
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
    done("14")
    base = pretrained_base(device)
    mxf, mxb, train["mixture_ce_fwd_bwd"] = check_mixture_ce(device, base)
    log(f"phase 15: mixture CE ok, rows {mxf['ms']:.4f} ms (plain "
        f"{mxf['plain_ms']:.4f}), grad rows {mxb['ms']:.4f} ms (plain "
        f"{mxb['plain_ms']:.4f}); whole loss fwd+bwd "
        f"{train['mixture_ce_fwd_bwd']['kernel_path_ms']:.3f} ms (plain "
        f"{train['mixture_ce_fwd_bwd']['plain_path_ms']:.3f})")
    done("15")
    sw_launches, train["senticap_switched"] = train_switched_phase(device,
                                                                  base)
    log(f"phase 16: switched step "
        f"{train['senticap_switched']['step_ms']:.3f} ms, "
        f"{train['senticap_switched']['captions_per_s']:.1f} captions/s "
        f"(plain {train['senticap_switched']['plain_step_ms']:.3f} ms)")
    done("16")
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
    done("17")
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
    done("18")
    # the trainers run K3, K4, K5 (sampled, factored), the CE and K2
    for entry in (k3f, k3b, k4f, k4b, cef, ceb, *k5):
        entry["launches"] += tr_launches.get(entry["name"], 0)
    k2["launches"] += tr_launches["mega_beam_decode"]
    k2_lstm["launches"] += tr_launches["mega_beam_decode_lstm"]
    keep = tempfile.mkdtemp(prefix="chip_smoke_cli_")
    cli_launches, cli = cli_phase(device, keep)
    log("phase 19: CLIs ok; s a stage (CUDA start-up) " + ", ".join(
        f"{name} {st['wall_s']:.1f} ({st.get('cuda_init_s', 0.0):.1f})"
        for name, st in cli.items() if isinstance(st, dict)
        and "wall_s" in st) + f"; precompute_features "
        f"{cli['precompute_features']['images_per_s']:.1f} images/s, "
        f"evaluate {cli['evaluate']['captions_per_s']:.1f} and "
        f"caption_batch {cli['caption_batch']['captions_per_s']:.1f} "
        "captions/s, process start included")
    done("19")
    # the CLIs run K3, the CE and K2 (train, evaluate, caption_batch,
    # sample, serve; caption_batch at beam 20 its wide path) and K7 (the
    # attention stages)
    for entry in (k3f, k3b, cef, ceb):
        entry["launches"] += cli_launches.get(entry["name"], 0)
    k2["launches"] += (cli_launches["mega_beam_decode"]
                       - cli_launches["mega_beam_decode_wide"])
    wide["mega_beam_decode_wide"]["launches"] += \
        cli_launches["mega_beam_decode_wide"]
    k7["factored"]["launches"] += cli_launches["mega_att_beam_decode"]
    res_launches, train["resident"], big = resident_phase(device)
    train["att"].update(big)
    res = train["resident"]
    log("phase 20: device-resident epochs ok; epoch s host "
        f"{res['host']['epoch_s'][0]:.2f}, pinned "
        f"{res['pinned']['epoch_s'][0]:.2f}, resumed "
        f"{res['resumed']['epoch_s'][0]:.2f}; training captions/s host "
        f"{res['host']['captions_per_s'][0]:.0f}, pinned "
        f"{res['pinned']['captions_per_s'][0]:.0f}; busy share host "
        f"{res['host']['device_busy_share']}, pinned "
        f"{res['pinned']['device_busy_share']}; synchronizing calls "
        f"{res['pinned']['sync_calls']}; launches {res_launches}")
    done("20")
    # the resident epochs run K3, the CE, K2, K5 (sampled, factored), K8
    # and the mixture CE
    for entry in (k3f, k3b, cef, ceb, k8f, k8b, *k5):
        entry["launches"] += res_launches.get(entry["name"], 0)
    k2["launches"] += res_launches["mega_beam_decode"]
    mxf["launches"] += res_launches["mixture_ce_rows"]
    mxb["launches"] += res_launches["ce_grad_rows_mixture"]
    sc_launches, cli["senticap_cli"] = senticap_cli_phase(device)
    # base and base_resident run K8 and the CE, train K8 and the mixture
    # CE (its backward the CE's backward row pass), test K10 and K9
    for stage, counts in sc_launches.items():
        for entry in (k8f, k8b, k9, k10):
            entry["launches"] += counts.get(entry["name"], 0)
        if stage == "train":
            mxf["launches"] += counts["mixture_ce_rows"]
            mxb["launches"] += counts["ce_grad_rows"]
        else:
            for entry in (cef, ceb):
                entry["launches"] += counts.get(entry["name"], 0)
    done("21")
    try:
        s2s_launches, train["seq2seq"] = seq2seq_phase(device, keep)
        for counts in s2s_launches.values():   # the CE row passes only
            for entry in (cef, ceb):
                entry["launches"] += counts.get(entry["name"], 0)
        done("22")
        par_launches, par = parallel_phase(device, keep,
                                           train["factual_step_ms"])
        done("23")
        wide_h, train["wide_h"] = wide_h_phase(device, keep)
        done("24")
        rag_launches, ragged = ragged_phase(device, keep)
        done("25")
        past_block, past_block_times = past_block_phase(device)
        log(f"phase 26 (d): times {json.dumps(past_block_times)}")
        done("26")
        wide_width, train["wide_width"] = wide_width_phase(device, keep)
        done("27")
        big_batch, train["big_batch"] = big_batch_phase(device)
        done("28")
        limits, train["limits"] = limits_phase(device)
        done("29")
        # phase 29's shapes join the entries of the same kernels' paths
        for e in wide_width:
            for d in ("fwd", "bwd"):
                if e["name"] == f"fused_att_scan_sampled_{d}_wide_attention":
                    e["shapes"][f"T{P29_K5[0]}_A{P29_K5[1]}"] = \
                        limits["k5"][d]
            for kind, sfx in (("factored", ""), ("lstm", "_lstm")):
                if e["name"] == f"att_decode_step_topk{sfx}_wide_hidden":
                    e["shapes"].update(limits["k6"][kind])
        for e in past_block:
            if e["name"] == "mega_beam_decode_past_block":
                for tag, f in limits["k2"].items():
                    e["shapes"].setdefault(tag, {}).update(f)
        wide["mega_beam_decode_wide"]["split_k20_images64"] = \
            limits["k2"][f"v{V}_k20_images{B_IMAGES}"]["split"]
        # phase 28's shapes and launches join phase 24's entries: the same
        # kernels past the resident plan
        for e in wide_h:
            big = next(b for b in big_batch
                       if b["name"] == e["name"].replace("_wide_h", "_big_b"))
            e["shapes"].update(big["shapes"])
            e["max_abs_err"] = max(e["max_abs_err"], big["max_abs_err"])
            e["replaces"] = e["replaces"].replace("large B", "B > 2048")
    finally:
        shutil.rmtree(keep, ignore_errors=True)
    # every rank's launches: K3, the CE, K2 and K7 (phase 19's stages over
    # two ranks), K8 (the SentiCap step)
    for entry in (k3f, k3b, cef, ceb, k8f, k8b):
        entry["launches"] += par_launches.get(entry["name"], 0)
    k2["launches"] += par_launches.get("mega_beam_decode", 0)
    k7["factored"]["launches"] += par_launches.get("mega_att_beam_decode", 0)
    par["phase_s"] = phase_s["23"]
    log(f"phase 23: slice 8 ok in {par['phase_s']:.1f} s; against phase "
        "19's one-process train "
        + ", ".join(f"{n} {par[n]['against_one_process']}" for n in par
                    if isinstance(par[n], dict)
                    and "against_one_process" in par[n])
        + f"; SentiCap DP 2 step {par['senticap_dp2_step']}; factual step "
        f"ms a rank {par['factual_step_ms']}; launches {par_launches}")
    # phase 24's CE row passes (its CLI epochs and SentiCap step) and K2
    # (the CLI's validations and evaluate); its K3, K4, K8 counts are the
    # wide entries'
    for entry in (cef, ceb):
        entry["launches"] += train["wide_h"]["launches"].get(entry["name"],
                                                             0)
    k2["launches"] += train["wide_h"]["launches"].get("mega_beam_decode", 0)
    k2_lstm["launches"] += train["wide_h"]["launches"].get(
        "mega_beam_decode_lstm", 0)
    k9["launches"] += train["wide_h"]["launches"].get(
        "mega_senticap_beam_decode", 0)
    # phase 25's (b): K3, the CE and K2 (train, evaluate, the engine), K2
    # lstm and K7 (the engine)
    for entry in (k3f, k3b, cef, ceb, k2, k2_lstm, k7["factored"],
                  k7["lstm"]):
        entry["launches"] += rag_launches.get(entry["name"], 0)
    # phase 27's CE row passes ((d)'s train); its K1, K6, K5 and K7 counts
    # are its own entries'
    for entry in (cef, ceb):
        entry["launches"] += train["wide_width"]["launches"].get(
            entry["name"], 0)
    times = ragged["times"]
    k1["ragged_v8191"] = times["k1_r5"]
    k2["ragged_v8191"] = {f"images{n}": times[f"k2_images{n}"]
                          for n in RAG_TIMED_IMAGES}
    k7["factored"]["ragged_v8191"] = {f"images{n}": times[f"k7_images{n}"]
                                      for n in RAG_TIMED_IMAGES}
    log(f"phases 21-29 done; seconds a phase {json.dumps(phase_s)}; the "
        f"whole run {time.perf_counter() - t_run:.1f} s (the kernels' build "
        "included)")
    print(json.dumps({"train": train}))
    print(json.dumps({"cli": cli}))
    print(json.dumps({"serve": stats}))
    print(json.dumps({"decode": {"senticap": decode,
                                 "senticap_switched": decode_sw}}))
    print(json.dumps({"split_timeline": stages}))
    print(json.dumps({"parallel": par}))
    print(json.dumps({"widths": ragged}))
    print(json.dumps({"past_block_times": past_block_times}))
    print(json.dumps({"phase_s": phase_s}))
    print(json.dumps({"kernels": [k1, k2, k2_lstm, k6["factored"],
                                  k6["lstm"], att_init, k7["factored"],
                                  k7["lstm"], k3f, k3b, k4f, k4b, cef,
                                  ceb, *k5, k8f, k8b, k9, mxf, mxb, k10,
                                  *wide.values(), *wide_h, *past_block,
                                  *wide_width]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
