#!/usr/bin/env python3
"""Probe of the whole-card searches, K2 (``icee_tpu_torch/csrc/beam.cu``)
and K7 (``csrc/att_beam.cu``), on one NVIDIA GPU: where a search's time
goes, stage by stage.

Run from the repository root on a machine with the card:

    python3 scripts/probe_grid_beam.py [--kernel k2|k7] [cw ...]

Copies ``icee_tpu_torch`` into ``icee_tpu_torch/_build/probe_grid/``
(ignored by git) and adds to the kernel's step loop a ``%globaltimer``
stamp by thread 0 of every block at each step's start, after its live-row
scan, and after each stage's work and after its grid barrier (K7: also
around the mean of the features before step 1), and to the shared product
stage (``csrc/grid_beam.cuh``) ``clock64`` counts of its parts.  Then,
with ``chip_smoke.captioning_params``' seeded flagship weights (k = 5, 40
steps; K2 in serving mode on ``chip_smoke.check_k2``'s features at 1, 8
and 64 images, K7 on ``chip_smoke.check_k7``'s at 1, 2, 8 and 64), it runs
the search once per shape for both cells and prints, summed over the steps
it ran: each stage's span (first block in to last block done) and barrier
(last block done to last block out), the scan, and the whole call's span
from the stamps.  Each ``cw`` argument (16, 32 or 64) runs the same with
every product stage's column slabs forced to that width (the row block as
``plan_stage`` sizes it), for comparison with the plan.

Nothing here is used by the package; the instrumented copy builds with
the package's own nvcc flags.
"""

from __future__ import annotations

import os
import shutil
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROBE = os.path.join(ROOT, "icee_tpu_torch", "_build", "probe_grid")
MAXB, MAXT, NS, MAXS = 256, 64, 24, 8

# the probe's device globals, before the shared product stage
GLOBALS = f"""__device__ unsigned long long g_stamp[{MAXB}][{MAXT}][{NS}];
__device__ unsigned long long g_mean[{MAXB}][3];
#define STAMP(t, i) \\
  if (threadIdx.x == 0 && blockIdx.x < {MAXB} && (t) < {MAXT}) {{ \\
    unsigned long long now; \\
    asm volatile("mov.u64 %0, %globaltimer;" : "=l"(now)); \\
    g_stamp[blockIdx.x][t][i] = now; \\
  }}
#define MEAN(i) \\
  if (threadIdx.x == 0 && blockIdx.x < {MAXB}) {{ \\
    unsigned long long now; \\
    asm volatile("mov.u64 %0, %globaltimer;" : "=l"(now)); \\
    g_mean[blockIdx.x][i] = now; \\
  }}
__shared__ int g_sid;  // the stage run_stage runs
__device__ long long g_cyc[{MAXB}][{MAXS}][4];
__device__ long long g_tcyc[{MAXB}][4];
__device__ long long g_clk[{MAXB}][{MAXT}];
"""

SCAN = "    StepCtx c = step_ctx(a, t);\n    scan_rows(a, sm, c);\n"
SCAN_STAMPED = (
    "    STAMP(t, 0)\n"
    f"    if (threadIdx.x == 0 && blockIdx.x < {MAXB} && t < {MAXT})"
    " g_clk[blockIdx.x][t] = clock64();\n" + SCAN + "    STAMP(t, 1)\n")


def stamped(call: str, slot: str, indent: str = "    ") -> str:
    """``call`` and the grid barrier after it, stamped as slot ``slot``."""
    return (f"{indent}{call}\n{indent}STAMP(t, 2 + 2 * ({slot}))\n"
            f"{indent}grid_sync(a.bar, gen);\n"
            f"{indent}STAMP(t, 3 + 2 * ({slot}))\n")


# the kernel's step loop, by kernel: slots in order (stamps 2 + 2j done,
# 3 + 2j out); the stage ids run_stage's cycle counts are kept under
KERNEL_EDITS = {
    "k2": ("beam.cu", [
        (SCAN, SCAN_STAMPED),
        ("      run_stage(a, stages[s], sm, c);\n"
         "      grid_sync(a.bar, gen);\n",
         "      if (threadIdx.x == 0) g_sid = s;\n"
         + stamped("run_stage(a, stages[s], sm, c);", "s", "      ")),
        ("    run_partials(a, sm, c.n);\n    grid_sync(a.bar, gen);\n",
         stamped("run_partials(a, sm, c.n);", "a.n_stages")),
        ("    run_tail(a, sm, c);\n    grid_sync(a.bar, gen);\n",
         stamped("run_tail(a, sm, c);", "a.n_stages + 1")),
    ]),
    "k7": ("att_beam.cu", [
        ("  run_mean(a);\n  grid_sync(a.bar, gen);\n",
         "  MEAN(0)\n  run_mean(a);\n  MEAN(1)\n  grid_sync(a.bar, gen);\n"
         "  MEAN(2)\n"),
        (SCAN, SCAN_STAMPED),
        ("      run_stage(a, stages[s < 0 ? init : s], sm, c);\n"
         "      grid_sync(a.bar, gen);\n",
         "      if (threadIdx.x == 0) g_sid = s < 0 ? init : s;\n"
         + stamped("run_stage(a, stages[s < 0 ? init : s], sm, c);",
                   "s < 0 ? 0 : s == 0 ? 1 : s + 2", "      ")),
        ("        run_scores(a, sm, c);\n        grid_sync(a.bar, gen);\n",
         stamped("run_scores(a, sm, c);", "2", "        ")),
        ("    run_partials(a, sm, c.n);\n    grid_sync(a.bar, gen);\n",
         stamped("run_partials(a, sm, c.n);", "init + 2")),
        ("    run_tail(a, sm, c);\n    grid_sync(a.bar, gen);\n",
         stamped("run_tail(a, sm, c);", "init + 3")),
    ]),
}
SLOTS = {
    ("k2", "factored"): ["x V, h W", "v S", "gates", "logits", "partials",
                         "tail"],
    ("k2", "lstm"): ["gates", "logits", "partials", "tail"],
    ("k7", "factored"): ["init", "pre", "scores", "ctx", "vrows", "style",
                         "gates", "logits", "partials", "tail"],
    ("k7", "lstm"): ["init", "pre", "scores", "ctx", "gates", "logits",
                     "partials", "tail"],
}
STAGE_IDS = {  # run_stage's stage index -> name
    ("k2", "factored"): ["x V, h W", "v S", "gates", "logits"],
    ("k2", "lstm"): ["gates", "logits"],
    ("k7", "factored"): ["pre", "ctx", "vrows", "style", "gates", "logits",
                         "init"],
    ("k7", "lstm"): ["pre", "ctx", "gates", "logits", "init"],
}

SYNC = ("      __syncthreads();             // ... for every thread; "
        "slot it - 1 free\n")
EPI = ("    if (cc.ch + 1 == cc.x.nch) "
       "epilogue(a, S, sm, c, t, cc.x, acc, acc0);\n")
SHARED_EDITS = [
    ("__device__ void run_stage(", GLOBALS + "__device__ void run_stage("),
    ("  float acc[2][4] = {}, acc0[2][4] = {};\n",
     "  float acc[2][4] = {}, acc0[2][4] = {};\n"
     "  const int sid = g_sid;\n"
     "  long long cy[4] = {0, 0, 0, 0}, q0;\n"),
    ("    if (it >= 0) {\n      cp_async_wait<NSLOT - 2>();",
     "    q0 = clock64();\n"
     "    if (it >= 0) {\n      cp_async_wait<NSLOT - 2>();"),
    (SYNC + "    }\n",
     SYNC + "    }\n    cy[0] += clock64() - q0;\n    q0 = clock64();\n"),
    ("    cp_async_commit();\n    if (it < 0) continue;\n",
     "    cp_async_commit();\n    cy[1] += clock64() - q0;\n"
     "    if (it < 0) continue;\n"),
    ("    if (cc.act) {\n      const int k0",
     "    q0 = clock64();\n    if (cc.act) {\n      const int k0"),
    (EPI, "    cy[2] += clock64() - q0;\n    q0 = clock64();\n" + EPI
     + "    cy[3] += clock64() - q0;\n"),
    ("  cp_async_wait<0>();\n}\n",
     "  cp_async_wait<0>();\n"
     f"  if (threadIdx.x == 0 && blockIdx.x < {MAXB})\n"
     "    for (int j = 0; j < 4; ++j) g_cyc[blockIdx.x][sid][j] += cy[j];\n"
     "}\n"),
    ("    if (live_rows == 0) continue;\n",
     "    if (live_rows == 0) continue;\n    long long tq = clock64();\n"),
    ("    __syncthreads();\n    // beam select: exact top-k",
     "    __syncthreads();\n"
     f"    if (tid == 0 && blockIdx.x < {MAXB}) {{\n"
     "      g_tcyc[blockIdx.x][0] += clock64() - tq; tq = clock64(); }\n"
     "    // beam select: exact top-k"),
    ("    __syncthreads();\n"
     "    for (int e = tid; e < k * L; e += GB_THREADS) {\n"
     "      const int q = e / L, pos = e % L;\n      const int v",
     "    __syncthreads();\n"
     f"    if (tid == 0 && blockIdx.x < {MAXB}) {{\n"
     "      g_tcyc[blockIdx.x][1] += clock64() - tq; tq = clock64(); }\n"
     "    for (int e = tid; e < k * L; e += GB_THREADS) {\n"
     "      const int q = e / L, pos = e % L;\n      const int v"),
    ("    __syncthreads();\n    if (keep[0])",
     "    __syncthreads();\n"
     f"    if (tid == 0 && blockIdx.x < {MAXB}) {{\n"
     "      g_tcyc[blockIdx.x][2] += clock64() - tq; tq = clock64(); }\n"
     "    if (keep[0])"),
    ("        a.tok[(size_t)img * L + e] = nseq[keep[1] * L + e];\n"
     "    __syncthreads();\n",
     "        a.tok[(size_t)img * L + e] = nseq[keep[1] * L + e];\n"
     "    __syncthreads();\n"
     f"    if (tid == 0 && blockIdx.x < {MAXB})\n"
     "      g_tcyc[blockIdx.x][3] += clock64() - tq;\n"),
]

READERS = """
extern "C" int probe_clear() {
  void* p = nullptr;
  cudaError_t e = cudaGetSymbolAddress(&p, g_stamp);
  if (e == cudaSuccess) e = cudaMemset(p, 0, sizeof(g_stamp));
  if (e == cudaSuccess) e = cudaGetSymbolAddress(&p, g_cyc);
  if (e == cudaSuccess) e = cudaMemset(p, 0, sizeof(g_cyc));
  if (e == cudaSuccess) e = cudaGetSymbolAddress(&p, g_tcyc);
  if (e == cudaSuccess) e = cudaMemset(p, 0, sizeof(g_tcyc));
  if (e == cudaSuccess) e = cudaGetSymbolAddress(&p, g_mean);
  if (e == cudaSuccess) e = cudaMemset(p, 0, sizeof(g_mean));
  return e;
}
extern "C" int probe_read(void* host, void* cyc, void* tcyc, void* clk,
                          void* mean) {
  cudaError_t e = cudaMemcpyFromSymbol(host, g_stamp, sizeof(g_stamp));
  if (e == cudaSuccess) e = cudaMemcpyFromSymbol(mean, g_mean, sizeof(g_mean));
  if (e == cudaSuccess) e = cudaMemcpyFromSymbol(cyc, g_cyc, sizeof(g_cyc));
  if (e == cudaSuccess)
    e = cudaMemcpyFromSymbol(tcyc, g_tcyc, sizeof(g_tcyc));
  if (e == cudaSuccess) e = cudaMemcpyFromSymbol(clk, g_clk, sizeof(g_clk));
  return e;
}
"""


def instrumented_copy(kernel: str) -> None:
    shutil.rmtree(PROBE, ignore_errors=True)
    shutil.copytree(os.path.join(ROOT, "icee_tpu_torch"),
                    os.path.join(PROBE, "icee_tpu_torch"),
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    csrc = os.path.join(PROBE, "icee_tpu_torch", "csrc")
    source, edits = KERNEL_EDITS[kernel]
    for name, changes, tail in ((source, edits, READERS),
                                ("grid_beam.cuh", SHARED_EDITS, "")):
        path = os.path.join(csrc, name)
        with open(path) as f:
            src = f.read()
        for old, new in changes:
            if old not in src:
                raise SystemExit(f"probe: {name} changed; no {old!r}")
            src = src.replace(old, new)
        with open(path, "w") as f:
            f.write(src + tail)


def report(tag: str, stamps, slots, stage_ids, grid: int, cyc, tcyc, clk,
           mean) -> dict:
    import numpy as np

    s = stamps[:grid].astype(np.int64)
    last = 3 + 2 * (len(slots) - 1)
    steps = [t for t in range(MAXT) if s[0, t, last] > 0]
    rows = {n: [0.0, 0.0] for n in ["scan"] + slots}
    for t in steps:
        st = s[:, t]
        rows["scan"][0] += (st[:, 1].max() - st[:, 0].min()) / 1e6
        prev = 1
        for j, n in enumerate(slots):
            done, out = 2 + 2 * j, 3 + 2 * j
            if st[:, done].max() == 0:   # not run this step
                continue
            rows[n][0] += (st[:, done].max() - st[:, prev].min()) / 1e6
            rows[n][1] += (st[:, out].max() - st[:, done].max()) / 1e6
            prev = out
    m = mean[:grid].astype(np.int64)
    if m[:, 0].max() > 0:
        rows["mean"] = [(m[:, 1].max() - m[:, 0].min()) / 1e6,
                        (m[:, 2].max() - m[:, 1].max()) / 1e6]
    start = m[:, 0].min() if m[:, 0].max() > 0 else s[:, steps[0], 0].min()
    span = (s[:, steps[-1], last].max() - start) / 1e6
    t0, t1 = steps[0], steps[-1]
    mhz = ((clk[0, t1] - clk[0, t0]) /
           max((s[0, t1, 0] - s[0, t0, 0]) / 1e3, 1.0))
    print(f"{tag}: {len(steps)} steps, span {span:.3f} ms, SM clock "
          f"{mhz:.0f} MHz; per stage (work span ms, barrier ms), summed "
          "over the steps:")
    print("  " + "; ".join(f"{n} {w:.3f} / {b:.3f}"
                           for n, (w, b) in rows.items()))
    cyc = cyc[:grid]
    per = {}
    for j, n in enumerate(stage_ids):
        busy = cyc[:, j, 2] > 0
        c = cyc[busy, j].mean(axis=0) / len(steps) if busy.any() else \
            np.zeros(4)
        per[n] = [float(v) for v in c]
    busy = tcyc[:grid, 0] > 0
    tail = (tcyc[:grid][busy].mean(axis=0) / len(steps)).tolist()
    print("  cycles a step, mean over working blocks: " + "; ".join(
        f"{n}: wait {v[0]:.0f} issue {v[1]:.0f} compute {v[2]:.0f} "
        f"epilogue {v[3]:.0f}" for n, v in per.items())
        + f"; tail: merge {tail[0]:.0f} select {tail[1]:.0f} extend+track "
        f"{tail[2]:.0f} tok {tail[3]:.0f}")
    return {"steps": len(steps), "span_ms": span, "stages": rows,
            "sm_mhz": float(mhz), "cycles": per, "tail_cycles": tail}


def main(args) -> int:
    import ctypes
    import json

    kernel = "k2"
    if args[:1] == ["--kernel"]:
        kernel, args = args[1], args[2:]
    if kernel not in KERNEL_EDITS:
        raise SystemExit(__doc__)
    instrumented_copy(kernel)
    sys.path.insert(0, PROBE)
    sys.path.insert(1, ROOT)
    import numpy as np
    import torch

    import icee_tpu_torch
    if not icee_tpu_torch.__file__.startswith(PROBE):
        raise SystemExit("probe: the instrumented copy did not load")
    import chip_smoke as cs
    from icee_tpu_torch.core.device import set_float32_precision
    from icee_tpu_torch.ops import att_beam, beam

    set_float32_precision()
    dev = torch.device("cuda", 0)
    params = cs.captioning_params(dev)
    mod = beam if kernel == "k2" else att_beam
    lib = mod._library()
    lib.probe_read.argtypes = [ctypes.c_void_p] * 5
    planned = mod.plan_stage
    grid = mod.max_grid(dev)
    cells = ((("factored", "stylenet", 2), ("lstm", "nic", 0))
             if kernel == "k2" else
             (("factored", "stylenet_att", 3), ("lstm", "nic_att", 0)))
    out = {}
    for cw in [None] + [int(w) for w in args]:
        mod.plan_stage = (planned if cw is None else
                          lambda jobs, g, rows, cw=cw:
                          beam.stage_with_width(jobs, cw))
        (beam.grid_plan if kernel == "k2" else
         att_beam.att_grid_plan).cache_clear()
        for cell, variant, style in cells:
            dec = params[variant]["decoder"]
            for n in ((1, 8, 64) if kernel == "k2" else (1, 2, 8, 64)):
                if kernel == "k2":
                    g = torch.Generator(device=dev).manual_seed(4)
                    feats = torch.randn((n, 1, cs.E), generator=g,
                                        device=dev)
                    feats = feats.expand(n, cs.K, cs.E).contiguous()
                    fn = beam.mega_beam_decode_steps
                    kw = dict(cell=cell)
                else:
                    feats = cs.att_features(dev, n, 14)
                    fn = att_beam.mega_att_beam_decode_steps
                    kw = dict(kind=cell)
                with torch.inference_mode():
                    def run():
                        return fn(dec, feats, style, n, k=cs.K,
                                  max_seq_length=cs.STEPS, **kw)
                    for _ in range(3):
                        run()
                    torch.cuda.synchronize()
                    if lib.probe_clear() != 0:
                        raise SystemExit("probe: clearing failed")
                    _, ran = run()
                    torch.cuda.synchronize()
                    stamps = np.zeros((MAXB, MAXT, NS), dtype=np.uint64)
                    cyc = np.zeros((MAXB, MAXS, 4), dtype=np.int64)
                    tcyc = np.zeros((MAXB, 4), dtype=np.int64)
                    clk = np.zeros((MAXB, MAXT), dtype=np.int64)
                    mean = np.zeros((MAXB, 3), dtype=np.uint64)
                    if lib.probe_read(stamps.ctypes.data, cyc.ctypes.data,
                                      tcyc.ctypes.data, clk.ctypes.data,
                                      mean.ctypes.data):
                        raise SystemExit("probe: reading failed")
                    ms = cs.cuda_ms(run, 3)
                tag = (f"{kernel} {cell} {n} images, cw {cw or 'planned'}: "
                       f"{ms:.3f} ms (events), live row-steps "
                       f"{int(ran[:, 1].sum())}")
                out[f"{kernel}_{cell}_{n}_{cw or 'planned'}"] = dict(
                    report(tag, stamps, SLOTS[kernel, cell],
                           STAGE_IDS[kernel, cell], grid, cyc, tcyc, clk,
                           mean), ms=ms)
    print(json.dumps({"probe_grid_beam": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
