#!/usr/bin/env python3
"""Probe of the column-split decode step (``icee_tpu_torch/csrc/
split_step.cuh``) on one NVIDIA GPU: where a stage's time goes.

Run from the repository root on a machine with the card:

    python3 scripts/probe_split_step.py

1. Copies ``icee_tpu_torch`` into ``icee_tpu_torch/_build/probe/`` (ignored
   by git) and adds to its ``slab_kernel`` per-block ``%globaltimer``
   stamps (start, after the dependency wait, after the input rows' copy,
   after the chunk loop, end) and ``clock64`` counts of the loop's cycles
   spent waiting for weight chunks, in the fmaf chains and at the closing
   barrier; then runs K1 and K6 (both cells) once at the serial serving
   shape (one image x 5 beams, flagship widths, ``chip_smoke``'s weights)
   and prints, per stage, the mean of those over the blocks, and the SM
   clock they imply.
2. Microbenchmarks the chain loop alone on shared-memory data (128 blocks,
   5 rows x 16 columns, K = 2048): cycles per k step of a bare register
   fmaf chain, of the unrolled 128-row chunk (``chain_chunk``) and of the
   same loop with a trip count known only at run time.

Nothing here is used by the package; the instrumented copy builds with
the package's own nvcc flags.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROBE = os.path.join(ROOT, "icee_tpu_torch", "_build", "probe")

STAMPS = [
    ("enum Stage { PRE, CTX, VROWS, STYLE, GATES_F, GATES_L, LOGITS };",
     """enum Stage { PRE, CTX, VROWS, STYLE, GATES_F, GATES_L, LOGITS };
__device__ unsigned long long g_stamp[8][1024][5];
__device__ long long g_cyc[8][1024][4];
__device__ __forceinline__ unsigned long long gtime() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %globaltimer;" : "=l"(t));
  return t;
}
#define STAMP(i) \\
  if (threadIdx.x == 0 && blockIdx.x < 1024) g_stamp[S][blockIdx.x][i] = gtime();
"""),
    ("  const int tid = threadIdx.x, nt = blockDim.x, R = a.R;\n",
     "  const int tid = threadIdx.x, nt = blockDim.x, R = a.R;\n  STAMP(0)\n"),
    ("  pdl_launch_next();\n  pdl_wait();\n\n  // the input rows",
     "  pdl_launch_next();\n  pdl_wait();\n  STAMP(1)\n  // the input rows"),
    ("  if constexpr (S == CTX)\n    for (int r = tid >> 5;",
     "  STAMP(2)\n  long long cs0 = clock64();\n"
     "  if constexpr (S == CTX)\n    for (int r = tid >> 5;"),
    ("    cp_async_wait<RING - 1>();  // chunk ch has landed\n"
     "    __syncthreads();\n    if (valid) {",
     "    long long c0 = clock64();\n"
     "    cp_async_wait<RING - 1>();  // chunk ch has landed\n"
     "    __syncthreads();\n    long long c1 = clock64();\n    if (valid) {"),
    ("          acc = fmaf(ak[kl], w[kl * 4 * SLAB_F4], acc);\n    }\n"
     "    __syncthreads();\n  }",
     "          acc = fmaf(ak[kl], w[kl * 4 * SLAB_F4], acc);\n    }\n"
     "    long long c2 = clock64();\n    __syncthreads();\n"
     "    if (tid == 0 && blockIdx.x < 1024) {\n"
     "      g_cyc[S][blockIdx.x][0] += c1 - c0;\n"
     "      g_cyc[S][blockIdx.x][1] += c2 - c1;\n"
     "      g_cyc[S][blockIdx.x][2] += clock64() - c2;\n    }\n  }\n"
     "  if (tid == 0 && blockIdx.x < 1024)\n"
     "    g_cyc[S][blockIdx.x][3] = clock64() - cs0;\n  STAMP(3)"),
    ("        J.bias != nullptr ? acc + J.bias[col] : acc;\n  }\n}",
     "        J.bias != nullptr ? acc + J.bias[col] : acc;\n  }\n"
     "  __syncthreads();\n  STAMP(4)\n}"),
]

READERS = """
extern "C" int probe_read(void* stamps, void* cycles) {
  cudaError_t e = cudaMemcpyFromSymbol(stamps, icee::g_stamp,
                                       sizeof(icee::g_stamp));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaMemcpyFromSymbol(cycles, icee::g_cyc, sizeof(icee::g_cyc));
}
extern "C" int probe_clear() {
  static unsigned long long z[8][1024][5];
  static long long zc[8][1024][4];
  cudaError_t e = cudaMemcpyToSymbol(icee::g_cyc, zc, sizeof(zc));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaMemcpyToSymbol(icee::g_stamp, z, sizeof(z));
}
"""

LOOP_CU = r"""
#include <cuda_runtime.h>
constexpr int KC = 128;  // chunk_rows of split_step.cuh
__global__ void __launch_bounds__(128, 1)
loop_kernel(int K, int kc_runtime, int variant, long long* cyc, float* out) {
  extern __shared__ __align__(16) float sm[];
  float* ring = sm;                       // KC x 16
  const int Kp = ((K + 31) & ~31) + 4;
  float* As = ring + KC * 16;             // 5 x Kp
  for (int i = threadIdx.x; i < KC * 16; i += blockDim.x)
    ring[i] = 0.001f * (i % 17);
  for (int i = threadIdx.x; i < 5 * Kp; i += blockDim.x)
    As[i] = 0.01f * (i % 13);
  __syncthreads();
  const int tid = threadIdx.x, r = tid / 16, cl = tid % 16;
  float acc = 0.f;
  const long long c0 = clock64();
  if (tid < 80) {
    const float* as = As + r * Kp;
    const float* w = ring + cl;
    for (int k0 = 0; k0 < K; k0 += KC) {
      const float* ak = as + k0;
      if (variant == 0) {         // a bare dependent fmaf chain
        const float a0 = ak[0], w0 = w[0];
#pragma unroll 16
        for (int k = 0; k < KC; ++k) acc = fmaf(a0, w0, acc);
      } else if (variant == 1) {  // chain_chunk: unrolled whole
#pragma unroll
        for (int k = 0; k < KC; k += 4) {
          const float4 av = *reinterpret_cast<const float4*>(ak + k);
          acc = fmaf(av.x, w[(k + 0) * 16], acc);
          acc = fmaf(av.y, w[(k + 1) * 16], acc);
          acc = fmaf(av.z, w[(k + 2) * 16], acc);
          acc = fmaf(av.w, w[(k + 3) * 16], acc);
        }
      } else {                    // the same steps, trip count at run time
        for (int k = 0; k < kc_runtime; ++k)
          acc = fmaf(ak[k], w[k * 16], acc);
      }
      __syncthreads();
    }
  }
  const long long c1 = clock64();
  if (tid == 0) cyc[blockIdx.x] = c1 - c0;
  out[blockIdx.x * 128 + tid] = acc;
}
extern "C" int run(int K, int variant, int blocks, long long* cyc_host) {
  long long* cyc;
  float* out;
  cudaMalloc(&cyc, blocks * sizeof(long long));
  cudaMalloc(&out, blocks * 128 * sizeof(float));
  const size_t smem = (KC * 16 + 5 * (((K + 31) & ~31) + 4)) * sizeof(float);
  cudaFuncSetAttribute(loop_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  for (int i = 0; i < 2; ++i)
    loop_kernel<<<blocks, 128, smem>>>(K, KC, variant, cyc, out);
  cudaError_t e = cudaDeviceSynchronize();
  cudaMemcpy(cyc_host, cyc, blocks * sizeof(long long), cudaMemcpyDeviceToHost);
  cudaFree(cyc);
  cudaFree(out);
  return (int)e;
}
"""

NAMES = {0: "pre", 1: "ctx", 2: "vrows", 3: "style", 4: "gates_f",
         5: "gates_l", 6: "logits"}
# the chains' length at the flagship widths (pre mixes 300 and 512)
STAGE_K = {1: 196, 2: 2048, 3: 512, 4: 512, 5: 2048, 6: 512}


def instrumented_copy() -> None:
    shutil.rmtree(PROBE, ignore_errors=True)
    shutil.copytree(os.path.join(ROOT, "icee_tpu_torch"),
                    os.path.join(PROBE, "icee_tpu_torch"),
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    csrc = os.path.join(PROBE, "icee_tpu_torch", "csrc")
    path = os.path.join(csrc, "split_step.cuh")
    with open(path) as f:
        src = f.read()
    for old, new in STAMPS:
        if old not in src:
            raise SystemExit(f"probe: split_step.cuh changed; no {old!r}")
        src = src.replace(old, new)
    with open(path, "w") as f:
        f.write(src)
    for lib in ("decode_step.cu", "att_decode_step.cu"):
        with open(os.path.join(csrc, lib), "a") as f:
            f.write(READERS)


def stage_report(tag: str, lib, fn) -> None:
    import numpy as np
    import torch

    lib.probe_read.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    with torch.inference_mode():
        for _ in range(20):
            fn()
        torch.cuda.synchronize()
        if lib.probe_clear() != 0:
            raise SystemExit("probe: clearing the stamps failed")
        fn()
        torch.cuda.synchronize()
    stamps = np.zeros((8, 1024, 5), dtype=np.uint64)
    cyc = np.zeros((8, 1024, 4), dtype=np.int64)
    if lib.probe_read(stamps.ctypes.data, cyc.ctypes.data) != 0:
        raise SystemExit("probe: reading the stamps failed")
    used = [s for s in NAMES if (stamps[s][:, 0] > 0).any()]
    t0 = min(int(stamps[s][stamps[s][:, 0] > 0][:, 0].min()) for s in used)
    print(f"{tag}: per stage, mean over blocks (us after the call's first "
          "stamp; cycles a k step of the chunk loop)")
    for s in used:
        m = stamps[s][:, 0] > 0
        t = (stamps[s][m].astype(np.int64) - t0) / 1000.0
        c = cyc[s][m]
        mhz = np.mean(c[:, 3] / np.maximum((t[:, 3] - t[:, 2]) * 1e3, 1)) * 1e3
        per_k = (f" = {c[:, 1].mean() / STAGE_K[s]:4.1f} a k step"
                 if STAGE_K.get(s) else "")
        print(f"  {NAMES[s]:8s} blocks {m.sum():4d}  dependency met "
              f"{t[:, 1].mean():6.1f}  input rows +{np.mean(t[:, 2] - t[:, 1]):4.2f}"
              f"  loop +{np.mean(t[:, 3] - t[:, 2]):5.2f}  epilogue "
              f"+{np.mean(t[:, 4] - t[:, 3]):4.2f}  end {t[:, 4].max():6.1f}"
              f" | loop cycles: chunk wait {c[:, 0].mean():6.0f}, chains "
              f"{c[:, 1].mean():6.0f}{per_k}, barrier {c[:, 2].mean():5.0f}; SM "
              f"clock {mhz:5.0f} MHz")


def probe_stages() -> None:
    import torch

    sys.path.insert(0, PROBE)
    sys.path.insert(1, ROOT)
    import icee_tpu_torch
    if not icee_tpu_torch.__file__.startswith(PROBE):
        raise SystemExit("probe: the instrumented copy did not load")
    import chip_smoke as cs
    from icee_tpu_torch.core.device import set_float32_precision
    from icee_tpu_torch.ops import att_decode_step as ads
    from icee_tpu_torch.ops import decode_step as ds

    set_float32_precision()
    dev = torch.device("cuda", 0)
    params = cs.captioning_params(dev)
    sty = params["stylenet"]["decoder"]
    g = torch.Generator(device=dev).manual_seed(6)
    x, h, c = (torch.randn((cs.K, d), generator=g, device=dev) * 0.5
               for d in (cs.E, cs.H, cs.H))
    stage_report("K1", ds._library(),
                 lambda: ds.decode_step_topk(sty, x, h, c, 1, ktop=cs.K))
    for kind, variant in cs.ATT_KINDS.items():
        with torch.inference_mode():
            args, _, _ = cs.check_k6(params[variant]["decoder"], kind, dev,
                                     1, 16)
        stage_report(f"K6 {kind}", ads._library(),
                     lambda a=args: ads.att_decode_step_topk(*a, ktop=cs.K))


def probe_loop() -> None:
    import numpy as np

    from icee_tpu_torch.ops import cuda_lib

    src = os.path.join(PROBE, "loop.cu")
    lib_path = os.path.join(PROBE, "loop.so")
    with open(src, "w") as f:
        f.write(LOOP_CU)
    flags = [f for f in cuda_lib.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    subprocess.run([cuda_lib.nvcc_path(), *flags, "-o", lib_path, src],
                   check=True)
    lib = ctypes.CDLL(lib_path)
    K, blocks = 2048, 128
    print(f"chain loop alone, {blocks} blocks, 5 rows x 16 columns, K = {K}:")
    for variant, what in ((0, "bare register fmaf chain"),
                          (1, "unrolled chunk (chain_chunk)"),
                          (2, "same steps, run-time trip count")):
        cyc = np.zeros(blocks, dtype=np.int64)
        rc = lib.run(K, variant, blocks, cyc.ctypes.data_as(ctypes.c_void_p))
        if rc != 0:
            raise SystemExit(f"probe: loop kernel failed (CUDA error {rc})")
        print(f"  {what:34s} {cyc.mean() / K:5.2f} cycles a k step")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("probe_split_step: CUDA is not available", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"card: {smi}")
    instrumented_copy()
    probe_stages()
    probe_loop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
