#!/usr/bin/env python3
"""Probe of K2's whole-card search (``icee_tpu_torch/csrc/beam.cu``) on one
NVIDIA GPU: where a search's time goes, stage by stage.

Run from the repository root on a machine with the card:

    python3 scripts/probe_grid_beam.py [cw ...]

Copies ``icee_tpu_torch`` into ``icee_tpu_torch/_build/probe_grid/``
(ignored by git) and adds to the kernel's step loop a ``%globaltimer``
stamp by thread 0 of every block at each step's start, after its live-row
scan, and after each stage's work and after its grid barrier.  Then, with
``chip_smoke.captioning_params``' seeded flagship weights (serving mode,
``chip_smoke.check_k2``'s features, k = 5, 40 steps), it runs the search
once at 1, 8 and 64 images for both cells and prints, summed over the
steps it ran: each stage's span (first block in to last block done) and
barrier (last block done to last block out), the scan, and the whole
call's span from the stamps.  Each ``cw`` argument (16, 32 or 64) runs the
same with every product stage's column slabs forced to that width (the
row block as ``plan_stage`` sizes it), for comparison with the plan.

Nothing here is used by the package; the instrumented copy builds with
the package's own nvcc flags.
"""

from __future__ import annotations

import os
import shutil
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROBE = os.path.join(ROOT, "icee_tpu_torch", "_build", "probe_grid")
MAXB, MAXT, NS = 256, 64, 16

EDITS = [
    ("__global__ void __launch_bounds__(GB_THREADS, 1)\ngrid_beam_kernel",
     f"""__device__ unsigned long long g_stamp[{MAXB}][{MAXT}][{NS}];
#define STAMP(t, i) \\
  if (threadIdx.x == 0 && blockIdx.x < {MAXB} && (t) < {MAXT}) {{ \\
    unsigned long long now; \\
    asm volatile("mov.u64 %0, %globaltimer;" : "=l"(now)); \\
    g_stamp[blockIdx.x][t][i] = now; \\
  }}
__global__ void __launch_bounds__(GB_THREADS, 1)\ngrid_beam_kernel"""),
    ("    StepCtx c;\n    c.t = t;",
     "    STAMP(t, 0)\n    StepCtx c;\n    c.t = t;"),
    ("    c.n = scan_rows(a, sm, t);\n",
     "    c.n = scan_rows(a, sm, t);\n    STAMP(t, 1)\n"),
    ("      run_stage(a, stages[s], sm, c);\n      grid_sync(a.bar, gen);\n",
     "      if (threadIdx.x == 0) g_sid = s;\n"
     "      run_stage(a, stages[s], sm, c);\n      STAMP(t, 2 + 2 * s)\n"
     "      grid_sync(a.bar, gen);\n      STAMP(t, 3 + 2 * s)\n"),
    ("    run_partials(a, sm, c.n);\n    grid_sync(a.bar, gen);\n",
     "    run_partials(a, sm, c.n);\n    STAMP(t, 2 + 2 * a.n_stages)\n"
     "    grid_sync(a.bar, gen);\n    STAMP(t, 3 + 2 * a.n_stages)\n"),
    ("    run_tail(a, sm, c);\n    grid_sync(a.bar, gen);\n",
     "    run_tail(a, sm, c);\n    STAMP(t, 4 + 2 * a.n_stages)\n"
     "    grid_sync(a.bar, gen);\n    STAMP(t, 5 + 2 * a.n_stages)\n"),
]

SYNC = ("      __syncthreads();             // ... for every thread; "
        "slot it - 1 free\n")
EPI = ("    if (cc.ch + 1 == cc.x.nch) "
       "epilogue(a, S, sm, c, t, cc.x, acc, acc0);\n")
CYCLES = [
    ("__device__ void run_stage(",
     f"""__shared__ int g_sid;  // the stage run_stage runs
__device__ long long g_cyc[{MAXB}][4][4];
__device__ long long g_tcyc[{MAXB}][4];
__device__ long long g_clk[{MAXB}][{MAXT}];
__device__ void run_stage("""),
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
    ("    STAMP(t, 0)\n",
     "    STAMP(t, 0)\n"
     f"    if (threadIdx.x == 0 && blockIdx.x < {MAXB} && t < {MAXT})"
     " g_clk[blockIdx.x][t] = clock64();\n"),
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
  return e;
}
extern "C" int probe_read(void* host, void* cyc, void* tcyc, void* clk) {
  cudaError_t e = cudaMemcpyFromSymbol(host, g_stamp, sizeof(g_stamp));
  if (e == cudaSuccess) e = cudaMemcpyFromSymbol(cyc, g_cyc, sizeof(g_cyc));
  if (e == cudaSuccess)
    e = cudaMemcpyFromSymbol(tcyc, g_tcyc, sizeof(g_tcyc));
  if (e == cudaSuccess) e = cudaMemcpyFromSymbol(clk, g_clk, sizeof(g_clk));
  return e;
}
"""

STAGES = {"factored": ["x V, h W", "v S", "gates", "logits"],
          "lstm": ["gates", "logits"]}


def instrumented_copy() -> None:
    shutil.rmtree(PROBE, ignore_errors=True)
    shutil.copytree(os.path.join(ROOT, "icee_tpu_torch"),
                    os.path.join(PROBE, "icee_tpu_torch"),
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    path = os.path.join(PROBE, "icee_tpu_torch", "csrc", "beam.cu")
    with open(path) as f:
        src = f.read()
    for old, new in EDITS + CYCLES:
        if old not in src:
            raise SystemExit(f"probe: beam.cu changed; no {old!r}")
        src = src.replace(old, new)
    with open(path, "w") as f:
        f.write(src + READERS)


def report(tag: str, stamps, names, grid: int, cyc, tcyc, clk) -> dict:
    import numpy as np

    s = stamps[:grid].astype(np.int64)
    n_st = len(names)
    last = 3 + 2 * (n_st + 1)
    steps = [t for t in range(MAXT) if s[0, t, last] > 0]
    rows = {n: [0.0, 0.0] for n in ["scan"] + names + ["partials", "tail"]}
    for t in steps:
        st = s[:, t]
        rows["scan"][0] += (st[:, 1].max() - st[:, 0].min()) / 1e6
        prev = 1
        for j, n in enumerate(names + ["partials", "tail"]):
            done, out = 2 + 2 * j, 3 + 2 * j
            rows[n][0] += (st[:, done].max() - st[:, prev].min()) / 1e6
            rows[n][1] += (st[:, out].max() - st[:, done].max()) / 1e6
            prev = out
    span = (s[:, steps[-1], last].max() - s[:, steps[0], 0].min()) / 1e6
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
    for j, n in enumerate(names):
        busy = cyc[:, j, 2] > 0
        m = cyc[busy, j].mean(axis=0) / len(steps) if busy.any() else \
            np.zeros(4)
        per[n] = [float(v) for v in m]
    busy = tcyc[:grid, 0] > 0
    tail = (tcyc[:grid][busy].mean(axis=0) / len(steps)).tolist()
    print("  cycles a step, mean over working blocks: " + "; ".join(
        f"{n}: wait {v[0]:.0f} issue {v[1]:.0f} compute {v[2]:.0f} "
        f"epilogue {v[3]:.0f}" for n, v in per.items())
        + f"; tail: merge {tail[0]:.0f} select {tail[1]:.0f} extend+track "
        f"{tail[2]:.0f} tok {tail[3]:.0f}")
    return {"steps": len(steps), "span_ms": span, "stages": rows,
            "sm_mhz": float(mhz), "cycles": per, "tail_cycles": tail}


def main(widths) -> int:
    import ctypes
    import json

    instrumented_copy()
    sys.path.insert(0, PROBE)
    sys.path.insert(1, ROOT)
    import numpy as np
    import torch

    import icee_tpu_torch
    if not icee_tpu_torch.__file__.startswith(PROBE):
        raise SystemExit("probe: the instrumented copy did not load")
    import chip_smoke as cs
    from icee_tpu_torch.core.device import set_float32_precision
    from icee_tpu_torch.ops import beam

    set_float32_precision()
    dev = torch.device("cuda", 0)
    params = cs.captioning_params(dev)
    lib = beam._library()
    lib.probe_read.argtypes = [ctypes.c_void_p] * 4
    planned = beam.plan_stage
    grid = beam.max_grid(dev)
    out = {}
    for cw in [None] + [int(w) for w in widths]:
        beam.plan_stage = (planned if cw is None else
                           lambda jobs, g, rows, cw=cw:
                           beam.stage_with_width(jobs, cw))
        beam.grid_plan.cache_clear()
        for cell, variant, style in (("factored", "stylenet", 2),
                                     ("lstm", "nic", 0)):
            dec = params[variant]["decoder"]
            for n in (1, 8, 64):
                g = torch.Generator(device=dev).manual_seed(4)
                feats = torch.randn((n, 1, cs.E), generator=g, device=dev)
                feats = feats.expand(n, cs.K, cs.E).contiguous()
                with torch.inference_mode():
                    def run():
                        return beam.mega_beam_decode_steps(
                            dec, feats, style, n, k=cs.K,
                            max_seq_length=cs.STEPS, cell=cell)
                    for _ in range(3):
                        run()
                    torch.cuda.synchronize()
                    if lib.probe_clear() != 0:
                        raise SystemExit("probe: clearing failed")
                    _, ran = run()
                    torch.cuda.synchronize()
                    stamps = np.zeros((MAXB, MAXT, NS), dtype=np.uint64)
                    cyc = np.zeros((MAXB, 4, 4), dtype=np.int64)
                    tcyc = np.zeros((MAXB, 4), dtype=np.int64)
                    clk = np.zeros((MAXB, MAXT), dtype=np.int64)
                    if lib.probe_read(stamps.ctypes.data, cyc.ctypes.data,
                                      tcyc.ctypes.data, clk.ctypes.data):
                        raise SystemExit("probe: reading failed")
                    ms = cs.cuda_ms(run, 3)
                tag = (f"{cell} {n} images, cw {cw or 'planned'}: "
                       f"{ms:.3f} ms (events), live row-steps "
                       f"{int(ran[:, 1].sum())}")
                out[f"{cell}_{n}_{cw or 'planned'}"] = dict(
                    report(tag, stamps, STAGES[cell], grid, cyc, tcyc,
                           clk), ms=ms)
    print(json.dumps({"probe_grid_beam": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
