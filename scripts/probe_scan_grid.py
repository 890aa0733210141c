#!/usr/bin/env python3
"""Probe of the training scans' recurrence (K3's and K8's cooperative
launches, ``icee_tpu_torch/csrc/scan_grid.cuh``) on one NVIDIA GPU: where
a step's time goes.

Run from the repository root on a machine with the card:

    python3 scripts/probe_scan_grid.py [variant ...]

Builds ``csrc/lstm_scan.cu`` and ``csrc/senticap_scan.cu`` into
``icee_tpu_torch/_build/probe_scan/<variant>/`` (ignored by git) beside a
copy of ``scan_grid.cuh`` with a ``%globaltimer`` stamp by thread 0 of
every block at each step's start, when its first tile has landed, after
its product, before and after each grid barrier (the backward: after the
partial sums' barrier and after the gate pass).  Then it runs one forward
and one backward call of K3 (B 64, T 25, E 300, F = H = 512) and of K8
(B 128, T 22, E = H = 512)
on ``scripts/scan_turns.py``'s seeded inputs and prints, averaged over the
steps and blocks: the product, the epilogue or gate pass, the barriers,
and the step's period (one block's start to its next start).  Variants are
text edits of the header (``shipped`` is the header as it is):

- ``ring4`` / ``ring3``: the A ring held at 4 / 3 stages, whatever the
  plan says;
- ``no_mma``: the step product without its wgmmas (the copies, waits
  and splits alone);
- ``no_load``: the step product without its tile copies (the wgmmas on
  whatever the ring holds).

Nothing here is used by the package; the copies build with the package's
own nvcc flags.  The results are wrong by design in the edited variants.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))
PROBE = os.path.join(ROOT, "icee_tpu_torch", "_build", "probe_scan")
CSRC = os.path.join(ROOT, "icee_tpu_torch", "csrc")
MAXB, MAXT, NS = 160, 32, 10

STAMPS = f"""namespace icee {{

__device__ unsigned long long g_stamp[{MAXB}][{MAXT}][{NS}];
__device__ long long g_clk[{MAXB}][{MAXT}];   // clock64 at each step's start
__shared__ int g_step, g_first;  // the step, whether no tile landed yet
__shared__ int g_pass;           // whether the step's first pass runs
#define STAMP(t, i) \\
  if (threadIdx.x == 0 && blockIdx.x < {MAXB} && (t) < {MAXT}) {{ \\
    unsigned long long now; \\
    asm volatile("mov.u64 %0, %globaltimer;" : "=l"(now)); \\
    g_stamp[blockIdx.x][t][i] = now; \\
  }}
"""

# (old, new) text edits that place the stamps
EDITS = [
    ("namespace icee {\n", STAMPS),
    # forward: 0 start, 1 after the product, 2 before the barrier, 3 after
    ("  for (int t = 0; t < a.T; ++t) {\n",
     "  for (int t = 0; t < a.T; ++t) {\n    STAMP(t, 0);\n"
     "    if (threadIdx.x == 0) { g_step = t; g_first = 1; g_pass = 1; }\n"
     f"    if (threadIdx.x == 0 && blockIdx.x < {MAXB} && t < {MAXT}) "
     "g_clk[blockIdx.x][t] = clock64();\n"),
    # 5: the step's first tile has landed
    ("    __syncthreads();       // ... and everyone's; stage kt - 1 is free\n",
     "    __syncthreads();       // ... and everyone's; stage kt - 1 is free\n"
     "    if (threadIdx.x == 0 && g_first) {\n"
     "      STAMP(g_step, 5);\n      g_first = 0;\n    }\n"),
    ("          out[i] = 0.f;\n        __syncthreads();\n      }\n",
     "          out[i] = 0.f;\n        __syncthreads();\n      }\n"
     "      STAMP(t, 1);\n"),
    ("    if (t + 1 < a.T) grid_sync(a.count, gen);\n",
     "    STAMP(t, 2);\n    if (t + 1 < a.T) grid_sync(a.count, gen);\n"
     "    STAMP(t, 3);\n"),
    # backward: 0 start, 1 after the product, 2 after the first barrier,
    # 3 after the gate pass, 4 after the second barrier
    ("  for (int s = a.T - 1; s >= 0; --s) {\n",
     "  for (int s = a.T - 1; s >= 0; --s) {\n    STAMP(s, 0);\n"
     "    if (threadIdx.x == 0) { g_step = s; g_first = 1; g_pass = 1; }\n"),
    # inside the step's first pass: 6 the ring filled, 7 the k loop done,
    # 8 the copies waited for, 9 the halves met
    ("  for (int kt = 0; kt < nk; ++kt) {\n    sg_wait(stages - 2);",
     "  if (threadIdx.x == 0 && g_pass) STAMP(g_step, 6);\n"
     "  for (int kt = 0; kt < nk; ++kt) {\n    sg_wait(stages - 2);"),
    ("  tc_wait<0>();\n  // acc[4 j + 2 h + q]",
     "  if (threadIdx.x == 0 && g_pass) STAMP(g_step, 7);\n"
     "  tc_wait<0>();\n"
     "  if (threadIdx.x == 0 && g_pass) STAMP(g_step, 8);\n"
     "  // acc[4 j + 2 h + q]"),
    ("      x = __fadd_rn(acc[i], x);\n    }\n  }\n  __syncthreads();\n}\n",
     "      x = __fadd_rn(acc[i], x);\n    }\n  }\n  __syncthreads();\n"
     "  if (threadIdx.x == 0 && g_pass) {\n    STAMP(g_step, 9);\n"
     "    g_pass = 0;\n  }\n}\n"),
    ("      }\n      grid_sync(a.count, gen);\n    } else {\n",
     "      }\n      STAMP(s, 1);\n      grid_sync(a.count, gen);\n"
     "      STAMP(s, 2);\n    } else {\n"),
    ("    if (s > 0) {\n      load_gate(s - 1);",
     "    STAMP(s, 3);\n    if (s > 0) {\n      load_gate(s - 1);"),
    ("      grid_sync(a.count, gen);\n    }\n  }\n}\n",
     "      grid_sync(a.count, gen);\n    }\n    STAMP(s, 4);\n  }\n}\n"),
]

READ = f"""
extern "C" int icee_probe_read(void* out) {{
  return (int)cudaMemcpyFromSymbol(out, icee::g_stamp,
                                   sizeof(unsigned long long) * {MAXB} *
                                   {MAXT} * {NS});
}}
extern "C" int icee_probe_clock(void* out) {{
  return (int)cudaMemcpyFromSymbol(out, icee::g_clk,
                                   sizeof(long long) * {MAXB} * {MAXT});
}}
"""

VARIANTS = {
    "shipped": [],
    "ring4": [("  const int nk = (kd + SG_BK - 1) / SG_BK;\n",
               "  const int nk = (kd + SG_BK - 1) / SG_BK;\n"
               "  stages = stages < 4 ? stages : 4;\n")],
    "ring3": [("  const int nk = (kd + SG_BK - 1) / SG_BK;\n",
               "  const int nk = (kd + SG_BK - 1) / SG_BK;\n"
               "  stages = stages < 3 ? stages : 3;\n")],
    "no_mma": [("      sg_mma<NC>(t, al[s8], dh + d, s8);\n"
                "      sg_mma<NC>(t, ah[s8], dl + d, 1);\n"
                "      sg_mma<NC>(t, ah[s8], dh + d, 1);\n",
                "      t[0] += __uint_as_float(ah[s8][0] ^ al[s8][1]);\n")],
    "no_load": [("    if (st < nk) sg_load(A, lda, nrows, kd, st * SG_BK, vec, "
                 "ring + st * STAGE);\n", ""),
                ("      sg_load(A, lda, nrows, kd, nxt * SG_BK, vec,\n"
                 "              ring + (nxt % stages) * STAGE);\n", "      ;\n")],
}


def build(name: str, edits) -> dict:
    from icee_tpu_torch.ops import cuda_lib

    d = os.path.join(PROBE, name)
    os.makedirs(d, exist_ok=True)
    text = open(os.path.join(CSRC, "scan_grid.cuh")).read()
    for old, new in EDITS + list(edits):
        if old not in text:
            raise SystemExit(f"{name}: edit target not found: {old[:70]!r}")
        text = text.replace(old, new, 1)
    with open(os.path.join(d, "scan_grid.cuh"), "w") as f:
        f.write(text)
    procs, libs = {}, {}
    for src in ("lstm_scan", "senticap_scan"):
        with open(os.path.join(CSRC, src + ".cu")) as f, \
                open(os.path.join(d, src + ".cu"), "w") as g:
            g.write(f.read() + READ)
        libs[src] = os.path.join(d, src + ".so")
        procs[src] = subprocess.Popen(
            [cuda_lib.nvcc_path(), *cuda_lib.NVCC_FLAGS, "-I", CSRC, "-o",
             libs[src], os.path.join(d, src + ".cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    for src, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"{name}/{src}: nvcc failed\n{out.decode()}")
    return libs


def stamps(lib, blocks: int, steps: int):
    import numpy as np

    buf = np.zeros((MAXB, MAXT, NS), dtype=np.uint64)
    rc = lib.icee_probe_read(ctypes.c_void_p(buf.ctypes.data))
    if rc:
        raise SystemExit(f"icee_probe_read: CUDA error {rc}")
    return buf[:blocks, :steps].astype(np.float64) / 1e3   # us


def _inner(st) -> str:
    """The step's first pass: start to the ring filled, the k loop, the
    copies' wait, the halves' meeting."""
    import numpy as np

    parts = [st[..., 6] - st[..., 0], st[..., 7] - st[..., 6],
             st[..., 8] - st[..., 7], st[..., 9] - st[..., 8]]
    return "first pass: fill {:.2f}, k loop {:.2f}, wait {:.2f}, meet {:.2f}" \
        .format(*(np.mean(p) for p in parts))


def report(name: str, st, backward: bool) -> str:
    import numpy as np

    steps = st.shape[1]
    if not backward:
        first = st[:, 1:, 5] - st[:, 1:, 0]
        prod = st[:, 1:, 1] - st[:, 1:, 0]
        epi = st[:, :, 2] - st[:, :, 1]
        bar = st[:, :-1, 3] - st[:, :-1, 2]
        period = st[:, 1:, 0] - st[:, :-1, 0]
        inner = _inner(st[:, 1:])
        return (f"{name}: step period {np.mean(period):.2f} us; first tile "
                f"in {np.mean(first):.2f} ({inner}), product "
                f"{np.mean(prod):.2f}, epilogue {np.mean(epi):.2f}, barrier "
                f"{np.mean(bar):.2f} (max over blocks, mean over steps: "
                f"product {np.mean(prod.max(0)):.2f}, barrier "
                f"{np.mean(bar.max(0)):.2f})")
    # backward: steps run s = T-1 .. 0; product at s < T-1
    first = st[:, :-1, 5] - st[:, :-1, 0]
    prod = st[:, :-1, 1] - st[:, :-1, 0]
    bar1 = st[:, :-1, 2] - st[:, :-1, 1]
    gate = st[:, :-1, 3] - st[:, :-1, 2]
    bar2 = st[:, 1:, 4] - st[:, 1:, 3]
    period = st[:, :-1, 0] - st[:, 1:, 0]
    inner = _inner(st[:, :-1])
    return (f"{name}: step period {np.mean(period):.2f} us; first tile in "
            f"{np.mean(first):.2f} ({inner}), product "
            f"{np.mean(prod):.2f}, barrier 1 {np.mean(bar1):.2f}, gate pass "
            f"{np.mean(gate):.2f}, barrier 2 {np.mean(bar2):.2f} (max over "
            f"blocks: product {np.mean(prod.max(0)):.2f}, gate pass "
            f"{np.mean(gate.max(0)):.2f})")


def run(name: str, libs) -> None:
    import numpy as np
    import torch

    import scan_turns
    from icee_tpu_torch.ops import cuda_lib, lstm_scan, scan_grid
    from icee_tpu_torch.ops import senticap_scan as ss

    real = cuda_lib.build_all
    cuda_lib.build_all = lambda names: {n: libs[n] for n in names}
    cuda_lib._libs.clear()
    try:
        device = torch.device("cuda", 0)
        (p, x, dh), (w, x8, dh8) = scan_turns.scan_inputs(device)
        for kname, fwd, bwd, b, t, lib in (
                ("K3", lambda: lstm_scan.factored_scan_fwd(p, x),
                 lambda r: lstm_scan.factored_scan_bwd(p, x, r[0], r[1], dh,
                                                       r[2]),
                 64, 25, lstm_scan._library()),
                ("K8", lambda: ss.senticap_scan_fwd(w, x8),
                 lambda r: ss.senticap_scan_bwd(w, x8, r[0], r[1], dh8, 5.0,
                                                r[2]),
                 128, 22, ss._library())):
            lib.icee_probe_read.argtypes = [ctypes.c_void_p]
            plan = scan_grid.plan_on(kname, b, 512, device)
            res = fwd()
            fwd()
            torch.cuda.synchronize()
            st = stamps(lib, plan.f_blocks, t)
            print(report(f"{name} {kname} forward", st, False), flush=True)
            clk = np.zeros((MAXB, MAXT), dtype=np.int64)
            lib.icee_probe_clock.argtypes = [ctypes.c_void_p]
            lib.icee_probe_clock(ctypes.c_void_p(clk.ctypes.data))
            clk = clk[:plan.f_blocks, :t].astype(np.float64)
            print(f"  SM clock over the forward: "
                  f"{np.mean((clk[:, -1] - clk[:, 0]) / (st[:, -1, 0] - st[:, 0, 0])):.0f}"
                  " MHz", flush=True)
            bwd(res)
            bwd(res)
            torch.cuda.synchronize()
            print(report(f"{name} {kname} backward", stamps(
                lib, plan.b_blocks, t), True), flush=True)
    finally:
        cuda_lib.build_all = real
        cuda_lib._libs.clear()


def main(args) -> int:
    import torch

    from icee_tpu_torch.core.device import set_float32_precision

    if not torch.cuda.is_available():
        raise SystemExit("probe_scan_grid: CUDA is not available")
    set_float32_precision()
    names = args or ["shipped"]
    shutil.rmtree(PROBE, ignore_errors=True)
    for name in names:
        if name not in VARIANTS:
            raise SystemExit(f"unknown variant {name}; choose from "
                             f"{sorted(VARIANTS)}")
        run(name, build(name, VARIANTS[name]))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
