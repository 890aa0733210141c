#!/usr/bin/env python3
"""Probe of K5's tensor-core product (``icee_tpu_torch/csrc/gemm_tf32x3.cuh``)
on one NVIDIA GPU: what its inner loop's time is made of.

Run from the repository root on a machine with the card:

    python3 scripts/probe_tf32x3.py

Builds variants of the header into ``icee_tpu_torch/_build/probe_tf32x3/``
(ignored by git), each by a text edit of the shipped source, with the
package's own nvcc flags:

- ``shipped``: the header as it is (3 mma passes over a hi/lo split
  rounded by integer operations on the bit pattern);
- ``cvt_split``: the split by ``cvt.rna.tf32.f32`` (the same bits);
- ``no_split``: the operands' raw bits as hi and 0 as lo (no split, still 3
  mmas): the split's cost is shipped - no_split;
- ``hi_only``: the split, but only the hi x hi mma;
- ``tf32``: raw bits, one mma: single-pass TF32 on the same tiles, the
  ceiling of this tiling and pipeline;
- ``direct_acc``: the 3 mmas straight into the accumulator (no per-k-tile
  fragment and rounded add): that add's cost, and its error;
- ``one_wave``: the split-K schedule aimed at one block an SM (132 blocks)
  instead of two; ``one_wave_cvt``: that and ``cvt_split``, the first
  design;
- ``no_load``: no tile copies (the loop computes on whatever shared
  memory holds): the compute side alone; ``no_mma``: the copies and the
  ring's waits without the tile's arithmetic: the memory side alone;
- ``stages4``: a 4-stage ring; ``one_block_an_sm``: no cap on registers
  for 2 blocks an SM.

``python3 scripts/probe_tf32x3.py name ...`` builds and times only the
variants named.

It first times ``mma.sync`` m16n8k8 TF32 alone (from registers, every
SM, 32 warps an SM) with the SM clock and power that ``nvidia-smi`` reads
meanwhile.  Then, for each variant and each of a few of K5's product
shapes, it prints the
device time of one launch (CUDA events over back-to-back launches), the
float32-equivalent TFLOP/s and the max abs error against float64.
Nothing here is used by the package.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

PROBE = os.path.join(ROOT, "icee_tpu_torch", "_build", "probe_tf32x3")
HEADER = os.path.join(ROOT, "icee_tpu_torch", "csrc", "gemm_tf32x3.cuh")

SPLIT = """  hi = tf32_rna(x);
  lo = tf32_rna(__fsub_rn(x, __uint_as_float(hi)));"""
CVT = """  asm("cvt.rna.tf32.f32 %0, %1;\\n" : "=r"(hi) : "f"(x));
  const float r = __fsub_rn(x, __uint_as_float(hi));
  asm("cvt.rna.tf32.f32 %0, %1;\\n" : "=r"(lo) : "f"(r));"""
RAW = """  hi = __float_as_uint(x);
  lo = 0u;"""
LO_MMAS = """        tc_mma(t[i][j], al[i], bh[j]);
        tc_mma(t[i][j], ah[i], bl[j]);
"""
TILE_ACC = "tc_mma(t[i][j]"
ADD_T = "acc[i][j][q] = __fadd_rn(acc[i][j][q], t[i][j][q]);"
PLAN = """  long long ns = tiles > 0 ? (2 * TC_SMS + tiles / 2) / tiles : 1;
  const int least = tiles >= TC_SMS * 7 / 8 ? TC_DEEP_CHUNK : TC_MIN_DEPTH;
  if (ns > K / least) ns = K / least;"""
ONE_WAVE = """  long long ns = tiles > 0 ? (TC_SMS + tiles / 2) / tiles : 1;
  if (ns > K / TC_MIN_DEPTH) ns = K / TC_MIN_DEPTH;"""

VARIANTS = {
    "shipped": [],
    "cvt_split": [(SPLIT, CVT)],
    "no_split": [(SPLIT, RAW)],
    "hi_only": [(LO_MMAS, "")],
    "tf32": [(SPLIT, RAW), (LO_MMAS, "")],
    "direct_acc": [(TILE_ACC, "tc_mma(acc[i][j]"), (ADD_T, ";")],
    "one_wave": [(PLAN, ONE_WAVE)],
    "one_wave_cvt": [(PLAN, ONE_WAVE), (SPLIT, CVT)],
    "no_load": [("  const int tid = threadIdx.x;\n  if (A_KC) {",
                 "  return;\n  const int tid = threadIdx.x;\n  if (A_KC) {")],
    "no_mma": [("    tc_tile<A_KC, B_NC>(As, As + TC_A_FLOATS, wm, wn, gr, tq, acc);",
                "")],
    "stages4": [("TC_STAGES = 3;", "TC_STAGES = 4;")],
    "one_block_an_sm": [("__launch_bounds__(TC_THREADS, 2)",
                         "__launch_bounds__(TC_THREADS, 1)")],
}

# (name, form, M, N, K, batch): K5's per-step products at B = 128 and a
# weight grad over T B = 3200 rows
SHAPES = [("x_Win", "N", 128, 2048, 2348, 1),
          ("S", "N", 128, 512, 512, 4),
          ("h_dec_fb_W", "N", 128, 4608, 512, 1),
          ("head", "N", 128, 8192, 512, 1),
          ("ds", "T", 128, 512, 512, 4),
          ("dx", "T", 128, 2348, 2048, 1),
          ("dh", "T", 128, 512, 4608, 1),
          ("g_Sw", "A", 512, 512, 3200, 4),
          ("g_Win", "A", 2348, 2048, 3200, 1)]

LAUNCHER = """
extern "C" int probe_gemm(int form, const float* A, long long lda,
                          const float* B, long long ldb, float* C,
                          long long ldc, int M, int N, int K, int batch,
                          long long za, long long zb, long long zc,
                          float* part, void* stream) {
  return icee::tf32x3_gemm((char)form, A, lda, B, ldb, C, ldc, nullptr, M,
                           N, K, batch, za, zb, zc, 0, part,
                           static_cast<cudaStream_t>(stream));
}
extern "C" long long probe_part(int M, int N, int K, int batch) {
  return icee::tf32x3_part_floats(M, N, K, batch);
}
"""


# mma.sync m16n8k8 TF32 alone: 8 warps a block, 4 blocks an SM, each warp
# 8 independent fragments fed from registers, no memory traffic
PEAK = """
extern "C" __global__ void mma_peak_kernel(float* out, int iters) {
  unsigned a[4], b[2];
  for (int q = 0; q < 4; ++q) a[q] = __float_as_uint(1.0f + threadIdx.x * q);
  for (int q = 0; q < 2; ++q) b[q] = __float_as_uint(0.5f + threadIdx.x * q);
  float d[8][4];
  for (int j = 0; j < 8; ++j)
    for (int q = 0; q < 4; ++q) d[j][q] = 0.f;
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) icee::tc_mma(d[j], a, b);
  }
  float s = 0.f;
  for (int j = 0; j < 8; ++j)
    for (int q = 0; q < 4; ++q) s += d[j][q];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
extern "C" int mma_peak(float* out, int blocks, int iters, void* stream) {
  mma_peak_kernel<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      out, iters);
  return cudaGetLastError();
}
"""


def mma_peak(nvcc_flags, nvcc):
    """(TFLOP/s of mma.sync m16n8k8 TF32 from registers on the whole card,
    nvidia-smi's SM clock and power samples over the ~2 s it runs)."""
    import torch

    cu = os.path.join(PROBE, "mma_peak.cu")
    with open(cu, "w") as f:
        f.write(open(HEADER).read() + PEAK)
    lib = os.path.join(PROBE, "mma_peak.so")
    subprocess.run([nvcc, *nvcc_flags, "-o", lib, cu], check=True,
                   capture_output=True)
    dll = ctypes.CDLL(lib)
    dll.mma_peak.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                             ctypes.c_void_p]
    dll.mma_peak.restype = ctypes.c_int
    blocks, iters = 4 * 132, 4096
    out = torch.empty(blocks * 256, device="cuda")
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    assert dll.mma_peak(out.data_ptr(), blocks, iters, stream) == 0
    torch.cuda.synchronize()
    sampler = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
         "--format=csv,noheader,nounits", "-lms", "100"],
        stdout=subprocess.PIPE, text=True)
    try:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        runs = 400
        start.record()
        for _ in range(runs):
            dll.mma_peak(out.data_ptr(), blocks, iters, stream)
        end.record()
        torch.cuda.synchronize()
    finally:
        sampler.terminate()
        samples = [x for x in sampler.communicate()[0].split("\n") if x]
    ms = start.elapsed_time(end) / runs
    flops = blocks * 8 * iters * 8 * 2.0 * 16 * 8 * 8
    return flops / ms / 1e9, samples


def build(variants) -> dict:
    from icee_tpu_torch.ops import cuda_lib

    os.makedirs(PROBE, exist_ok=True)
    src = open(HEADER).read()
    procs = {}
    for name, edits in variants.items():
        text = src
        for old, new in edits:
            if old not in text:
                raise SystemExit(f"variant {name}: edit target not found")
            text = text.replace(old, new)
        cu = os.path.join(PROBE, f"{name}.cu")
        with open(cu, "w") as f:
            f.write(text + LAUNCHER)
        lib = os.path.join(PROBE, f"{name}.so")
        procs[name] = (subprocess.Popen(
            [cuda_lib.nvcc_path(), *cuda_lib.NVCC_FLAGS, "-o", lib, cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT), lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for {name}:\n{out.decode()}")
        regs = [ln.strip() for ln in out.decode().splitlines()
                if "registers" in ln]
        print(f"{name}: {regs[:3]}", flush=True)
        dll = ctypes.CDLL(lib)
        vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        dll.probe_gemm.argtypes = ([i, vp, ll, vp, ll, vp, ll] + [i] * 4
                                   + [ll] * 3 + [vp, vp])
        dll.probe_gemm.restype = i
        dll.probe_part.argtypes = [i] * 4
        dll.probe_part.restype = ll
        libs[name] = dll
    return libs


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("probe_tf32x3: CUDA is not available")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(f"nvidia-smi: {smi}", flush=True)
    libs = build({k: VARIANTS[k] for k in (sys.argv[1:] or VARIANTS)})
    from icee_tpu_torch.ops import cuda_lib

    peak, samples = mma_peak(cuda_lib.NVCC_FLAGS, cuda_lib.nvcc_path())
    print(f"mma.sync m16n8k8 TF32 alone: {peak:.1f} TFLOP/s; nvidia-smi "
          f"clocks.sm, power.draw meanwhile: {samples}", flush=True)
    dev = torch.device("cuda", 0)
    stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
    rows = []
    for sname, form, m, n, k, batch in SHAPES:
        rng = np.random.default_rng(0)
        a_rows, a_cols = (k, m) if form == "A" else (m, k)
        b_rows, b_cols = (n, k) if form == "T" else (k, n)
        a = torch.tensor(rng.uniform(-1, 1, (a_rows, batch * a_cols)),
                         dtype=torch.float32, device=dev)
        b = torch.tensor(0.05 * rng.standard_normal((batch, b_rows, b_cols)),
                         dtype=torch.float32, device=dev)
        a3 = a.view(a_rows, batch, a_cols).transpose(0, 1)
        a_mk = a3.transpose(1, 2) if form == "A" else a3
        b_kn = b.transpose(1, 2) if form == "T" else b
        ref = a_mk.double() @ b_kn.double()
        c = torch.empty((batch, m, n), dtype=torch.float32, device=dev)
        for vname, lib in libs.items():
            part = torch.empty((max(1, lib.probe_part(m, n, k, batch)),),
                               dtype=torch.float32, device=dev)

            def run():
                rc = lib.probe_gemm(ord(form), a.data_ptr(), batch * a_cols,
                                    b.data_ptr(), b_cols, c.data_ptr(), n,
                                    m, n, k, batch, a_cols, b_rows * b_cols,
                                    m * n, part.data_ptr(), stream)
                if rc != 0:
                    raise SystemExit(f"{vname} {sname}: CUDA error {rc}")

            run()
            torch.cuda.synchronize()
            err = (c.double() - ref).abs().max().item()
            iters = 50
            for _ in range(5):
                run()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                run()
            end.record()
            torch.cuda.synchronize()
            ms = start.elapsed_time(end) / iters
            flops = 2.0 * m * n * k * batch
            rows.append({"shape": sname, "variant": vname, "ms": ms,
                         "tflops": flops / ms / 1e9, "max_abs_err": err})
            print(f"{sname:11s} {vname:12s} {ms:8.4f} ms "
                  f"{flops / ms / 1e9:7.1f} TFLOP/s  err {err:.3g}",
                  flush=True)
    print(json.dumps({"probe_tf32x3": rows}))
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
