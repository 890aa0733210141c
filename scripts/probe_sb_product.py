#!/usr/bin/env python3
"""Probe of the product K9 and K10 run every step
(``icee_tpu_torch/csrc/planes_product.cuh``'s ``sb_product_kernel``: 3xTF32
by ``wgmma`` from the weights' pre-split hi / lo planes) on one NVIDIA GPU:
what its time is made of.

Run from the repository root on a machine with the card:

    python3 scripts/probe_sb_product.py [variant ...]

Builds variants of the header into ``icee_tpu_torch/_build/probe_sb/``
(ignored by git), each by a text edit of the shipped source and compiled
with ``csrc/senticap_beam.cu`` and the package's own nvcc flags:

- ``shipped``: the header as it is;
- ``no_load``: no tile copies (the loop computes on whatever shared memory
  holds): the compute side alone;
- ``no_mma``: the copies and the ring's waits without the wgmmas: the
  memory side alone;
- ``no_a_split``: A's raw bits as hi and 0 as lo (still 3 wgmmas): the
  cost of splitting A in registers;
- ``tf32``: that and only the hi x hi wgmma: one TF32 pass on the same
  tiles, the ceiling of this tiling and ring;
- ``mbarriers``: each stage's copies tracked by an mbarrier (all threads'
  cp.async) and its release by another (every warp, after its wgmmas), in
  place of the barrier a k tile, so that the two warpgroups run apart;
- ``stages2`` / ``stages4``: a 2- or 4-stage ring.

For each variant, each of K9's and K10's product shapes (64 images x beam
20 = 1,280 rows) in one k range and in two (the cells' split) it prints
the device time of one launch (CUDA events over 30 launches replayed from
a CUDA graph, so that no host time falls between them), the
float32-equivalent TFLOP/s, the bytes the tiles copy from L2 over that
time, and the max abs error against float64; then
``gemm_tf32x3.cuh``'s product (K5's: both operands split in registers,
called straight through ctypes as the variants are) and ``torch.matmul``
(float32, TF32 off) at the same shapes.  Nothing here is used by the
package.
"""

from __future__ import annotations

import ctypes
import json
import math
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

PROBE = os.path.join(ROOT, "icee_tpu_torch", "_build", "probe_sb")
CSRC = os.path.join(ROOT, "icee_tpu_torch", "csrc")

SPLIT_A = "for (int q = 0; q < 4; ++q) tf32_split(v[q], ah[s][q], al[s][q]);"
RAW_A = ("for (int q = 0; q < 4; ++q) { ah[s][q] = __float_as_uint(v[q]); "
         "al[s][q] = 0u; }")
LOAD = """  const int tid = threadIdx.x;
  for (int i = tid; i < 2 * SP_BN * 8; i += SP_THREADS) {"""
MMAS = """      wg_mma_n64(t, al[s], dh + 2 * s, s);
      wg_mma_n64(t, ah[s], dl + 2 * s, 1);
      wg_mma_n64(t, ah[s], dh + 2 * s, 1);
"""

# the mbarrier ring: each stage's copies tracked by full[s] (all threads'
# cp.async), its release by empty[s] (every warp, after its wgmmas), so the
# two warpgroups run apart instead of meeting at a barrier each k tile
MB_HELPERS = """
__device__ __forceinline__ void mb_init(unsigned bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\\n" ::"r"(bar),
               "r"(count) : "memory");
}
__device__ __forceinline__ void mb_arrive(unsigned bar) {
  asm volatile("{\\n.reg .b64 st;\\nmbarrier.arrive.shared::cta.b64 st, [%0];\\n}\\n"
               ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mb_arrive_copies(unsigned bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\\n" ::"r"(
                   bar) : "memory");
}
__device__ __forceinline__ void mb_wait(unsigned bar, unsigned parity) {
  for (long long i = 0;; ++i) {
    unsigned done;
    asm volatile("{\\n.reg .pred p;\\n"
                 "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\\n"
                 "selp.u32 %0, 1, 0, p;\\n}\\n"
                 : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (i > (1ll << 26)) __trap();
  }
}

"""
KERNEL_HEAD = """template <bool BIAS>
__global__ void __launch_bounds__(SP_THREADS, 2)
sb_product_kernel(SbProduct g) {"""
LOOP_OLD = r"""#pragma unroll
  for (int st = 0; st < SP_STAGES - 1; ++st) {
    if (st < nk)
      sp_load(g, A, P, ring + st * STAGE, m0, n0, (kt0 + st) * SP_BK);
    tc_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    tc_wait<SP_STAGES - 2>();  // tile kt has landed (this thread's copies)
    // the copies' writes, made visible to wgmma's reads (the async proxy)
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();           // ... and everyone's; stage kt - 1 is free
    const int nxt = kt + SP_STAGES - 1;
    if (nxt < nk)
      sp_load(g, A, P, ring + (nxt % SP_STAGES) * STAGE, m0, n0,
              (kt0 + nxt) * SP_BK);
    tc_commit();
"""
LOOP_NEW = r"""  const unsigned full0 = ring_s + SP_STAGES * STAGE;
  if (threadIdx.x == 0) {
    for (int s = 0; s < SP_STAGES; ++s) {
      mb_init(full0 + 8 * s, SP_THREADS);
      mb_init(full0 + 8 * (SP_STAGES + s), SP_THREADS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
#pragma unroll
  for (int st = 0; st < SP_STAGES - 1; ++st)
    if (st < nk) {
      sp_load(g, A, P, ring + st * STAGE, m0, n0, (kt0 + st) * SP_BK);
      mb_arrive_copies(full0 + 8 * st);
    }
  for (int kt = 0; kt < nk; ++kt) {
    const int nxt = kt + SP_STAGES - 1;
    if (nxt < nk) {
      const int ns = nxt % SP_STAGES;
      if (kt >= 1)   // tile kt - 1 released stage ns
        mb_wait(full0 + 8 * (SP_STAGES + ns), ((kt - 1) / SP_STAGES) & 1);
      sp_load(g, A, P, ring + ns * STAGE, m0, n0, (kt0 + nxt) * SP_BK);
      mb_arrive_copies(full0 + 8 * ns);
    }
    mb_wait(full0 + 8 * (kt % SP_STAGES), (kt / SP_STAGES) & 1);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
"""
WAIT_OLD = r"""    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
    for (int i = 0; i < SP_BN / 2; ++i) {   // t is read only after the wait"""
WAIT_NEW = r"""    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    if (lane == 0) mb_arrive(full0 + 8 * (SP_STAGES + kt % SP_STAGES));
#pragma unroll
    for (int i = 0; i < SP_BN / 2; ++i) {   // t is read only after the wait"""
SMEM_OLD = ("return SP_STAGES * sp_stage_bytes() + 1024;   "
            "// + aligning the ring")
SMEM_NEW = "return SP_STAGES * sp_stage_bytes() + 1024 + 64;"

VARIANTS = {
    "shipped": [],
    "no_load": [(LOAD, "  return;\n" + LOAD)],
    "no_mma": [(MMAS, "")],
    "no_a_split": [(SPLIT_A, RAW_A)],
    "tf32": [(SPLIT_A, RAW_A),
             (MMAS, "      wg_mma_n64(t, ah[s], dh + 2 * s, s);\n")],
    "mbarriers": [(KERNEL_HEAD, MB_HELPERS + KERNEL_HEAD),
                  (LOOP_OLD, LOOP_NEW), (WAIT_OLD, WAIT_NEW),
                  ("  }\n  tc_wait<0>();\n\n  // acc[4 j", "  }\n\n  // acc[4 j"),
                  (SMEM_OLD, SMEM_NEW)],
    "stages2": [("SP_STAGES = 3", "SP_STAGES = 2")],
    "stages4": [("SP_STAGES = 3", "SP_STAGES = 4")],
}

# (name, paths, M, K, N, bias): K9's and K10's products at 1,280 rows
SHAPES = [("k9_cell", 1, 1280, 1024, 2048, False),
          ("k9_head", 1, 1280, 512, 8800, True),
          ("k10_cells", 2, 1280, 1024, 2048, False),
          ("k10_heads", 2, 1280, 512, 8800, True)]


def build(variants) -> dict:
    from icee_tpu_torch.ops import cuda_lib

    os.makedirs(PROBE, exist_ok=True)
    src = open(os.path.join(CSRC, "planes_product.cuh")).read()
    procs = {}
    for name, edits in variants.items():
        text = src
        for old, new in edits:
            if old not in text:
                raise SystemExit(f"variant {name}: edit target not found: "
                                 f"{old[:60]!r}")
            text = text.replace(old, new)
        d = os.path.join(PROBE, name)
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, "planes_product.cuh"), "w") as f:
            f.write(text)
        # the source and the header that includes the product beside the
        # edited header, so that their quoted includes find that one
        # first; the other headers come from csrc
        for fn in ("senticap_beam.cu", "senticap_beam.cuh"):
            with open(os.path.join(CSRC, fn)) as f, \
                    open(os.path.join(d, fn), "w") as g:
                g.write(f.read())
        lib = os.path.join(d, "probe.so")
        procs[name] = (subprocess.Popen(
            [cuda_lib.nvcc_path(), *cuda_lib.NVCC_FLAGS, "-I", CSRC,
             "-o", lib, os.path.join(d, "senticap_beam.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, cwd=d), lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for {name}:\n{out.decode()}")
        regs = [ln.strip() for ln in out.decode().splitlines()
                if "registers" in ln]
        print(f"{name}: {regs[:4]}", flush=True)
        dll = ctypes.CDLL(lib)
        vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        dll.icee_sb_product.argtypes = ([vp, ll, ll, vp, ll, i, vp, vp, vp,
                                         ll, ll, ll] + [i] * 5 + [vp])
        dll.icee_sb_product.restype = i
        dll.icee_sb_prepare.argtypes = [vp, i, i, vp, vp]
        dll.icee_sb_prepare.restype = i
        libs[name] = dll
    return libs


def device_ms(run, iters: int = 30) -> float:
    """Mean ms of ``run(stream)`` over ``iters`` launches replayed from a
    CUDA graph (no host time between them), by CUDA events."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):   # warm-up, outside the capture
        for _ in range(3):
            run(ctypes.c_void_p(side.cuda_stream))
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
        for _ in range(iters):
            run(stream)
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("probe_sb_product: CUDA is not available")
    from icee_tpu_torch.core.device import set_float32_precision
    from icee_tpu_torch.ops import att_scan
    from icee_tpu_torch.ops import senticap_decode as sd

    set_float32_precision()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(f"nvidia-smi: {smi}", flush=True)
    libs = build({k: VARIANTS[k] for k in (sys.argv[1:] or VARIANTS)})
    dev = torch.device("cuda", 0)
    stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
    rows = []
    for sname, paths, m, k, n, bias in SHAPES:
        rng = np.random.default_rng(m + k + n)
        a = torch.tensor(rng.uniform(-1, 1, (paths, m, k)),
                         dtype=torch.float32, device=dev)
        w = torch.tensor(0.05 * rng.standard_normal((paths, k, n)),
                         dtype=torch.float32, device=dev)
        b = (torch.tensor(rng.standard_normal((paths, n)),
                          dtype=torch.float32, device=dev) if bias else None)
        planes = torch.stack([sd.prepare_weights(w[z]) for z in range(paths)])
        ref = a.double() @ w.double()
        if bias:
            ref = ref + b.double()[:, None]
        c = torch.empty((2, paths, m, n), dtype=torch.float32, device=dev)
        n_p, two_kp = planes.shape[1:]
        flops = 2.0 * paths * m * n * k
        for vname, lib in libs.items():
            for splits in ((1, 2) if b is None else (1,)):
                def run(stream=stream):
                    rc = lib.icee_sb_product(
                        a.data_ptr(), k, m * k, planes.data_ptr(),
                        n_p * two_kp, two_kp // 2,
                        None if b is None else b[0].data_ptr(),
                        None if b is None else b[-1].data_ptr(),
                        c.data_ptr(), n, m * n, paths * m * n, m, n, k,
                        paths, splits, stream)
                    if rc != 0:
                        raise SystemExit(f"{vname} {sname}: CUDA error {rc}")

                run()
                torch.cuda.synchronize()
                got = c[0] if splits == 1 else c[0] + c[1]
                err = (got.double() - ref).abs().max().item()
                ms = device_ms(run)
                tiles = math.ceil(m / 128) * math.ceil(n / 64) * paths
                copied = tiles * (128 * k * 4 + 64 * two_kp * 4)
                rows.append({"shape": sname, "variant": vname,
                             "splits": splits,
                             "ms": ms, "tflops": flops / ms / 1e9,
                             "l2_tb_s": copied / ms / 1e9,
                             "max_abs_err": err})
                print(f"{sname:10s} {vname:12s} k ranges {splits} "
                      f"{ms:8.4f} ms {flops / ms / 1e9:6.1f} TFLOP/s, "
                      f"tiles copy {copied / ms / 1e9:5.2f} TB/s, "
                      f"err {err:.3g}",
                      flush=True)
        a2 = a if paths == 2 else a[0]
        w2 = w if paths == 2 else w[0]
        b2 = None if b is None else (b if paths == 2 else b[0])
        # gemm_tf32x3.cuh's product called straight through ctypes, as the
        # variants above are (its Python wrapper's checks cost more host
        # time than the kernel takes at these shapes)
        tlib = att_scan._library()
        out = torch.empty((paths, m, n), dtype=torch.float32, device=dev)
        part = torch.empty((max(1, tlib.icee_tf32x3_part_floats(
            m, n, k, paths)),), dtype=torch.float32, device=dev)

        def tf32x3(stream=stream):
            rc = tlib.icee_tf32x3_gemm(
                ord("N"), a.data_ptr(), k, w.data_ptr(), n, out.data_ptr(),
                n, None if b is None else b.data_ptr(), m, n, k, paths,
                m * k, k * n, m * n, 0 if b is None else n, part.data_ptr(),
                stream)
            if rc != 0:
                raise SystemExit(f"gemm_tf32x3 {sname}: CUDA error {rc}")

        for lname, fn in (("gemm_tf32x3", tf32x3),
                          ("torch.matmul",
                           lambda stream=None: torch.matmul(a2, w2))):
            ms = device_ms(fn)
            rows.append({"shape": sname, "variant": lname, "ms": ms,
                         "tflops": flops / ms / 1e9})
            print(f"{sname:10s} {lname:12s}            {ms:8.4f} ms "
                  f"{flops / ms / 1e9:6.1f} TFLOP/s", flush=True)
        del a, w, b, planes, ref, c
    print(json.dumps({"probe_sb_product": rows}))
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
