// The recurrence of the teacher-forced training scans K3 (lstm_scan.cu,
// the FactoredLSTM), K4 (nic_scan.cu, the torch-order LSTM) and K8
// (senticap_scan.cu, the SentiCap mRNN) as ONE cooperative launch a
// direction, with each block's slice of W_h (H, 4H)
// resident in shared memory for all T steps and each step's product on the
// tensor cores at float32 accuracy (3xTF32 wgmma).
//
//   forward  scan_fwd_grid_kernel: for t = 0 .. T-1, z_t = (input side)_t
//            (+) (h_{t-1} W_h [+ b]) and the gates (a cell_gates.cuh
//            policy: the input side first, then the recurrent sum); one
//            grid barrier a step.  Block (row group, unit group) owns `f_rows` batch rows
//            and `f_units` hidden units j, i.e. the 4 f_units gate columns
//            g H + j of W_h (all H rows of them, resident).  It reads
//            h_{t-1} (its rows x H) from L2 a step.
//   backward scan_bwd_grid_kernel: for s = T-1 .. 0, dh_carry =
//            dZ_{s+1} W_h^T, then the gate derivatives -> dZ_s and the
//            carried dc.  The product's depth is 4H, and every block would
//            read all of dZ_{s+1} (B x 4H) were the blocks cut by units
//            alone (4-8 MB of W_h cannot be spread over 132 blocks any
//            other way), so block (unit group, k range) owns `b_units`
//            units (rows j of W_h) over a `b_kc`-deep range of 4H, resident,
//            and writes its partial sums for all B rows; after a grid
//            barrier each block's gate pass adds the partials of its `b_per`
//            (b, j) elements in range order, clamps the sum to +-gclip
//            where the policy says so (K8's GradClip on h: after the whole
//            4H-deep sum, as before), and runs the gate derivatives; a
//            second barrier ends the step.
//
// The step product.  The W_h slice is split once at launch into TF32 hi
// and lo planes (gemm_tf32x3.cuh's tf32_split) laid out as
// planes_product.cuh lays out a B tile, so that wgmma reads it from shared
// memory by descriptor for all T steps and no thread splits B again.  A
// (h_{t-1} or dZ_{s+1}) streams from L2 by cp.async.cg through a ring of
// 64 x 32 tiles (up to 8 in flight, as shared memory allows) and is split
// in registers.  Two warpgroups, each on all 64 rows
// of a pass and all of the block's columns (wgmma's N: 16, 32 or 64), take
// the two halves of each 32-deep k tile; each output adds lo_a hi_b,
// hi_a lo_b, hi_a hi_b (small terms first) a k8 step into a fragment
// zeroed a k tile, then a rounded add into the float32 accumulator:
// gemm_tf32x3.cuh's arithmetic, so the recurrence keeps float32 accuracy
// through T steps.  The halves meet in shared memory at the pass's end.
//
// What bounds a step (scripts/probe_scan_grid.py, stamps from inside the
// kernel at the main shapes, NVIDIA H100 80GB HBM3, 700 W): the k loop,
// ~0.7 us a 32-deep tile, about equally its copies from L2 (alone, ~0.4
// a tile) and its arithmetic's latency (alone, ~0.45), which overlap
// little; then ~1.3-2 us a grid barrier and ~1.3-2.5 us of epilogue or
// gate pass.  A forward step reads 16 tiles (all of h_{t-1}'s H for its
// rows), a backward pass 4 (its 128-deep range of dZ).  Tried and not
// kept, each within ~10% of the shipped step: the product on mma.sync
// (the first design: 8 warps over the rows and the columns, the slice read
// by fragment loads), 3 to 16 tiles in flight, the epilogue's operands
// copied in a step ahead, the wgmmas pipelined two tiles deep, and (for
// K3's forward) half as many blocks reading half the bytes.  The
// backward's gate-pass operands are copied in a step ahead, during the
// barrier.
//
// The launch plan (ScanPlan, derived by sg_plan here and by
// ops/scan_grid.py::scan_plan, whose ctypes mirror is _CPlan; the entry
// points refuse a plan that differs) is a pure function of (B, H) and the
// card's SM count: at most one block an SM (cooperative launches need
// every block resident), shared memory within SG_SMEM_LIMIT, and among
// the partitions that fit, the least work a block, then the fewest bytes
// through L2 a step.  A shape with no partition raises in the wrapper.
//
// No atomics in any sum (the grid barrier counts arrivals only): a call
// gives the same bits on every run.
#pragma once

#include "cell_gates.cuh"      // the Gates policies, sigm, ICEE_TRY
#include "grid_common.cuh"     // grid_sync
#include "planes_product.cuh"  // wg_desc, wg_mma_n64; tf32_split, tc_copy*

namespace icee {

constexpr int SG_THREADS = 256;    // two warpgroups: the halves of a k tile
constexpr int SG_ROWS = 64;        // batch rows of one pass
constexpr int SG_BK = 32;          // k tile
constexpr int SG_LDA = SG_BK + 4;  // A tile rows in shared memory (floats)
constexpr int SG_MAX_STAGES = 9;   // A ring: at most 8 tiles in flight
constexpr int SG_SMEM_LIMIT = 232448;  // bytes of shared memory a block
constexpr int SG_TILE_BYTES = 4 * SG_ROWS * SG_LDA;   // one ring stage

struct ScanPlan {
  int B, H;        // the shapes the plan is for
  int sms;         // the card's SM count (blocks of one launch: at most it)
  int f_rows;      // forward: batch rows a block (a multiple of SG_ROWS)
  int f_units;     // forward: hidden units a block (4 f_units columns)
  int f_blocks;    // forward: ceil(B / f_rows) x ceil(H / f_units)
  int f_stages;    // forward: A ring stages
  int b_units;     // backward: hidden units a block (dh columns)
  int b_kc;        // backward: depth of a block's range of 4H
  int b_splits;    // backward: k ranges, ceil(4H / b_kc)
  int b_blocks;    // backward: ceil(H / b_units) x b_splits
  int b_stages;    // backward: A ring stages
  int b_per;       // backward: (b, j) elements a block's gate pass owns
  long long f_smem, b_smem;  // dynamic shared memory a block (bytes)
};

__host__ __device__ inline int sg_round_up(int x, int to) {
  return (x + to - 1) / to * to;
}
inline int sg_cdiv(int x, int to) { return (x + to - 1) / to; }

// Bytes of a resident slice of nc columns, kd deep (hi and lo planes),
// with the 1024 bytes that align it for wgmma.
inline long long sg_slice_bytes(int nc, int kd) {
  return 2LL * 4 * nc * sg_round_up(kd, SG_BK) + 1024;
}

// Bytes of the forward's tiles besides the slice and the ring: the out
// tile of a pass (64 x nc + 1) and c of the block's rows (rows x units).
inline long long sg_fwd_tiles(int nc, int rows) {
  return 4LL * (SG_ROWS * (nc + 1) + rows * (nc / 4));
}

// Bytes of the backward's tiles besides the slice and the ring: the out
// tile of a pass (64 x units + 1), and the gate pass's: the activations
// (in) and dz (out, in place) 4 an element, c_t, c_{t-1}, dh, the carried
// dc.
inline long long sg_bwd_tiles(int units, int per) {
  return 4LL * (SG_ROWS * (units + 1) + 8 * per);
}

// Stages of a ring for nk k tiles a pass beside `rest` bytes: every tile
// of a pass in flight where shared memory allows; 0 where not even two fit.
inline int sg_stages(int nk, long long rest) {
  const long long fit = (SG_SMEM_LIMIT - rest) / SG_TILE_BYTES;
  int s = nk + 1 < SG_MAX_STAGES ? nk + 1 : SG_MAX_STAGES;
  if (fit < s) s = (int)fit;
  return s >= 2 ? s : 0;
}

// The plan for (B, H) on a card of `sms` SMs; f_blocks 0 (or b_blocks 0)
// where no partition fits.  Forward candidates: units 4, 8, 16 (4 units
// are 16 columns: two fragments a warp); rows 64 r.  Backward: units 16,
// 32, 64, k ranges 32 x 2^i up to the first that covers 4H.  Keys, in
// order: a block's work a step, then the words through L2 a step (A's
// reads; the backward's partials written and read), then more units.
inline ScanPlan sg_plan(int B, int H, int sms) {
  ScanPlan p = {};
  p.B = B; p.H = H; p.sms = sms;
  long long best0 = -1, best1 = 0;
  const int nkf = sg_cdiv(H, SG_BK);
  for (int u = 4; u <= 16; u *= 2) {
    const int nc = 4 * u;
    for (int r = 1; r <= sg_cdiv(B, SG_ROWS); ++r) {
      const int rows = SG_ROWS * r;
      const long long blocks = (long long)sg_cdiv(B, rows) * sg_cdiv(H, u);
      const long long rest = sg_slice_bytes(nc, H) + sg_fwd_tiles(nc, rows);
      const int stages = sg_stages(nkf, rest);
      if (blocks > sms || stages == 0) continue;
      const long long k0 = (long long)r * nc, k1 = blocks * rows;
      if (best0 < 0 || k0 < best0 || (k0 == best0 && k1 < best1) ||
          (k0 == best0 && k1 == best1 && u > p.f_units)) {
        best0 = k0; best1 = k1;
        p.f_rows = rows; p.f_units = u; p.f_blocks = (int)blocks;
        p.f_stages = stages;
        p.f_smem = rest + (long long)stages * SG_TILE_BYTES;
      }
    }
  }
  const int h4 = 4 * H, h4p = sg_round_up(h4, SG_BK);
  best0 = -1;
  for (int u = 16; u <= 64; u *= 2) {
    for (int kc = SG_BK;; kc *= 2) {
      const int kd = kc < h4p ? kc : h4p;
      const int splits = sg_cdiv(h4, kc);
      const long long blocks = (long long)sg_cdiv(H, u) * splits;
      const int per = sg_round_up(
          (int)(((long long)B * H + blocks - 1) / blocks), 4);
      const long long rest = sg_slice_bytes(u, kd) + sg_bwd_tiles(u, per);
      const int stages = sg_stages(kd / SG_BK, rest);
      if (blocks <= sms && stages > 0) {
        const long long k0 = (long long)u * kd;
        const long long k1 = blocks * B * kd + 2LL * splits * B * H;
        if (best0 < 0 || k0 < best0 || (k0 == best0 && k1 < best1) ||
            (k0 == best0 && k1 == best1 && u > p.b_units)) {
          best0 = k0; best1 = k1;
          p.b_units = u; p.b_kc = kc; p.b_splits = splits;
          p.b_blocks = (int)blocks; p.b_stages = stages; p.b_per = per;
          p.b_smem = rest + (long long)stages * SG_TILE_BYTES;
        }
      }
      if (kc >= h4) break;
    }
  }
  return p;
}

// 0 where `p` is the plan this source derives for (B, H) on this card and
// the card takes cooperative launches.
inline int sg_check_plan(const ScanPlan& p, int B, int H) {
  int dev = 0, sms = 0, coop = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e != cudaSuccess) return (int)e;
  if (!coop) return (int)cudaErrorNotSupported;
  const ScanPlan q = sg_plan(B, H, sms);
  const bool ok = p.B == q.B && p.H == q.H && p.sms == q.sms &&
                  p.f_rows == q.f_rows && p.f_units == q.f_units &&
                  p.f_blocks == q.f_blocks && p.f_stages == q.f_stages &&
                  p.b_units == q.b_units && p.b_kc == q.b_kc &&
                  p.b_splits == q.b_splits && p.b_blocks == q.b_blocks &&
                  p.b_stages == q.b_stages && p.b_per == q.b_per &&
                  p.f_smem == q.f_smem && p.b_smem == q.b_smem &&
                  q.f_blocks > 0 && q.b_blocks > 0;
  return ok ? 0 : (int)cudaErrorInvalidValue;
}

// ---- the step product ----------------------------------------------------

// Wait until at most n of this thread's cp.async groups are pending (n
// known only at run time: the ring's depth is the plan's).
__device__ __forceinline__ void sg_wait(int n) {
  switch (n) {
    case 0: tc_wait<0>(); break;
    case 1: tc_wait<1>(); break;
    case 2: tc_wait<2>(); break;
    case 3: tc_wait<3>(); break;
    case 4: tc_wait<4>(); break;
    case 5: tc_wait<5>(); break;
    case 6: tc_wait<6>(); break;
    case 7: tc_wait<7>(); break;
    case 8: tc_wait<8>(); break;
    case 9: tc_wait<9>(); break;
    case 10: tc_wait<10>(); break;
    case 11: tc_wait<11>(); break;
    case 12: tc_wait<12>(); break;
    case 13: tc_wait<13>(); break;
    case 14: tc_wait<14>(); break;
    default: tc_wait<15>(); break;
  }
}

// One 64 x 32 tile of A (rows < nrows and k < kd valid, zeros elsewhere)
// into a ring stage: 16-byte copies where `vec` (A and lda 16-byte
// aligned), else 4-byte ones.
__device__ __forceinline__ void sg_load(const float* A, long long lda,
                                        int nrows, int kd, int k0, bool vec,
                                        float* As) {
  const int tid = threadIdx.x;
  if (vec) {
    for (int i = tid; i < SG_ROWS * SG_BK / 4; i += SG_THREADS) {
      const int m = i / (SG_BK / 4), k = (i % (SG_BK / 4)) * 4;
      const int gk = k0 + k;
      const bool in = m < nrows && gk < kd;
      tc_copy16(As + m * SG_LDA + k, in ? A + m * lda + gk : A,
                in ? 4 * min(4, kd - gk) : 0);
    }
  } else {
    for (int i = tid; i < SG_ROWS * SG_BK; i += SG_THREADS) {
      const int m = i / SG_BK, k = i % SG_BK;
      const int gk = k0 + k;
      const bool in = m < nrows && gk < kd;
      tc_copy4(As + m * SG_LDA + k, in ? A + m * lda + gk : A, in ? 4 : 0);
    }
  }
}

// t (+)= a b on a 64 x 16 or 64 x 32 tile, as planes_product.cuh's
// wg_mma_n64 on 64 columns.
__device__ __forceinline__ void wg_mma_n16(float (&t)[8],
                                          const unsigned (&a)[4],
                                          unsigned long long b, int acc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1;\n"
      "}\n"
      : "+f"(t[0]), "+f"(t[1]), "+f"(t[2]), "+f"(t[3]),
        "+f"(t[4]), "+f"(t[5]), "+f"(t[6]), "+f"(t[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}

__device__ __forceinline__ void wg_mma_n32(float (&t)[16],
                                          const unsigned (&a)[4],
                                          unsigned long long b, int acc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n"
      "}\n"
      : "+f"(t[0]), "+f"(t[1]), "+f"(t[2]), "+f"(t[3]),
        "+f"(t[4]), "+f"(t[5]), "+f"(t[6]), "+f"(t[7]),
        "+f"(t[8]), "+f"(t[9]), "+f"(t[10]), "+f"(t[11]),
        "+f"(t[12]), "+f"(t[13]), "+f"(t[14]), "+f"(t[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}

template <int NC>
__device__ __forceinline__ void sg_mma(float (&t)[NC / 2],
                                       const unsigned (&a)[4],
                                       unsigned long long b, int acc) {
  if constexpr (NC == 16) wg_mma_n16(t, a, b, acc);
  if constexpr (NC == 32) wg_mma_n32(t, a, b, acc);
  if constexpr (NC == 64) wg_mma_n64(t, a, b, acc);
}

// Byte offset of (column c, depth k) in a resident slice of nc columns:
// for each 32-deep k tile its hi plane, then its lo plane, each nc rows of
// 128 bytes in wgmma's K-major 128-byte swizzle (planes_product.cuh's B
// tile layout: 8-row atoms of 1024 bytes, 16-byte chunk q of row c at
// q ^ (c % 8)).
__device__ __forceinline__ int sg_slice_at(int c, int k, int nc, int lo) {
  const int kt = k / SG_BK, kk = k % SG_BK;
  return (2 * kt + lo) * nc * 128 + (c >> 3) * 1024 + (c & 7) * 128 +
         (((kk >> 2) ^ (c & 7)) << 4) + 4 * (kk & 3);
}

// Split x into the slice's hi and lo planes at (column c, depth k).
__device__ __forceinline__ void sg_put(unsigned char* slice, int c, int k,
                                       int nc, float x) {
  unsigned h, l;
  tf32_split(x, h, l);
  *reinterpret_cast<unsigned*>(slice + sg_slice_at(c, k, nc, 0)) = h;
  *reinterpret_cast<unsigned*>(slice + sg_slice_at(c, k, nc, 1)) = l;
}

// xo (nrows x NC, row stride NC + 1) = A (nrows x kd) W, W the resident
// slice at shared address slice_s (sg_slice_at's layout, NC columns).
// Warpgroup g (warps 4 g .. 4 g + 3, 16 rows each: a pass is 64 rows)
// takes the k8 steps 2 g and 2 g + 1 of each 32-deep tile, so that no two
// warps split the same A values: for each, lo_a hi_b, hi_a lo_b, hi_a
// hi_b by wgmma (A from registers, split as gemm_tf32x3.cuh splits it, B
// the slice's planes), into a fragment the tile's first wgmma starts from
// 0, then a rounded add into the float32 accumulator (planes_product.cuh's
// arithmetic); the two halves' sums meet in xo (the first's plus the
// second's, rounded).  A streams through a ring of `stages` stages
// (stages - 1 tiles in flight); older cp.async groups of the thread
// complete by the first tile.  Ends with every stage free and xo written.
template <int NC>
__device__ __forceinline__ void sg_pass(const float* A, long long lda,
                                        int nrows, int kd, bool vec,
                                        unsigned slice_s, float* ring,
                                        int stages, float* xo) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gr = lane >> 2, tq = lane & 3, wg = warp >> 2;
  const int r = 16 * (warp & 3) + gr;
  const int nk = (kd + SG_BK - 1) / SG_BK;
  constexpr int STAGE = SG_ROWS * SG_LDA;
  float acc[NC / 2], t[NC / 2];
#pragma unroll
  for (int i = 0; i < NC / 2; ++i) acc[i] = t[i] = 0.f;
  for (int st = 0; st < stages - 1; ++st) {
    if (st < nk) sg_load(A, lda, nrows, kd, st * SG_BK, vec, ring + st * STAGE);
    tc_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    sg_wait(stages - 2);   // tile kt has landed (this thread's copies)
    __syncthreads();       // ... and everyone's; stage kt - 1 is free
    const int nxt = kt + stages - 1;
    if (nxt < nk)
      sg_load(A, lda, nrows, kd, nxt * SG_BK, vec,
              ring + (nxt % stages) * STAGE);
    tc_commit();
    const float* As = ring + (kt % stages) * STAGE;
    unsigned ah[2][4], al[2][4];
#pragma unroll
    for (int s8 = 0; s8 < 2; ++s8) {
      const int k = 16 * wg + 8 * s8 + tq;
      float v[4];
      v[0] = As[r * SG_LDA + k];
      v[1] = As[(r + 8) * SG_LDA + k];
      v[2] = As[r * SG_LDA + k + 4];
      v[3] = As[(r + 8) * SG_LDA + k + 4];
#pragma unroll
      for (int q = 0; q < 4; ++q) tf32_split(v[q], ah[s8][q], al[s8][q]);
    }
    const unsigned tile = slice_s + 2 * kt * NC * 128;
    const unsigned long long dh = wg_desc(tile), dl = wg_desc(tile + NC * 128);
#pragma unroll
    for (int i = 0; i < NC / 2; ++i) asm volatile("" : "+f"(t[i])::"memory");
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int s8 = 0; s8 < 2; ++s8) {   // + 32 bytes (2 x 16) a k8 step
      const int d = 2 * (2 * wg + s8);
      sg_mma<NC>(t, al[s8], dh + d, s8);
      sg_mma<NC>(t, ah[s8], dl + d, 1);
      sg_mma<NC>(t, ah[s8], dh + d, 1);
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
    for (int i = 0; i < NC / 2; ++i) {   // t is read only after the wait
      asm volatile("" : "+f"(t[i])::"memory");
      acc[i] = __fadd_rn(acc[i], t[i]);
    }
  }
  tc_wait<0>();
  // acc[4 j + 2 h + q] holds (row r + 8 h, column 8 j + 2 tq + q): the
  // second warpgroup's half into xo, then the first adds its own
  if (wg == 1) {
#pragma unroll
    for (int i = 0; i < NC / 2; ++i)
      xo[(r + 8 * ((i >> 1) & 1)) * (NC + 1) + 8 * (i >> 2) + 2 * tq +
         (i & 1)] = acc[i];
  }
  __syncthreads();   // every warp is done with the ring; xo holds half
  if (wg == 0) {
#pragma unroll
    for (int i = 0; i < NC / 2; ++i) {
      float& x = xo[(r + 8 * ((i >> 1) & 1)) * (NC + 1) + 8 * (i >> 2) +
                    2 * tq + (i & 1)];
      x = __fadd_rn(acc[i], x);
    }
  }
  __syncthreads();
}

// 4 bytes from src into dst, asynchronously; where !in, zeros (and
// `base`, a valid global address, in place of src: nothing is read).
__device__ __forceinline__ void sg_copy4(float* dst, const float* src,
                                         bool in, const float* base) {
  tc_copy4(dst, in ? src : base, in ? 4 : 0);
}

// ---- the forward ---------------------------------------------------------

struct ScanFwdArgs {
  const float* Wh;     // (H, 4H) rows
  const float* Wb;     // (4H,) or null (the policy decides)
  float* zg;           // (B T, 4H): the input side in, the gates out
  float* h_seq;        // (B, T, H)
  float* c_seq;        // (B, T, H)
  unsigned* count;     // the grid barrier's counter, zero at launch
  int B, T, H, rows, units, unit_groups, stages, vec;
};

// Shared memory: the slice (hi and lo planes), the ring, the pass's out
// tile (64 x nc + 1: (h W)[row][g U + u]) and c of the block's rows
// (carried from step to step).  A pass: the product over h_{t-1} into the
// out tile, then one thread an element runs the policy on its row of the
// input side (which it overwrites with the gate activations) and writes h
// and c.  (Copying the input side in a step ahead, during the barrier,
// made the step slower: scripts/probe_scan_grid.py.)
template <class Gates, int NC>
__global__ void __launch_bounds__(SG_THREADS, 1)
scan_fwd_grid_kernel(ScanFwdArgs a) {
  extern __shared__ __align__(16) unsigned char sg_raw[];
  const int U = a.units, nc = 4 * U, H = a.H, H4 = 4 * H;
  const int kdp = sg_round_up(H, SG_BK);
  const unsigned raw = (unsigned)__cvta_generic_to_shared(sg_raw);
  unsigned char* slice = sg_raw + ((1024 - (raw & 1023)) & 1023);
  const unsigned slice_s = (unsigned)__cvta_generic_to_shared(slice);
  float* ring = reinterpret_cast<float*>(slice + 8 * nc * kdp);
  float* out = ring + a.stages * SG_ROWS * SG_LDA;   // [64][nc + 1]
  float* cst = out + SG_ROWS * (nc + 1);             // [rows][U]
  const int tid = threadIdx.x;
  const int rg = blockIdx.x / a.unit_groups, ug = blockIdx.x % a.unit_groups;
  const int j0 = ug * U, r0 = rg * a.rows;

  // the slice: column c = g U + u is W_h's column g H + j0 + u
  for (int i = tid; i < nc * kdp; i += SG_THREADS) {
    const int k = i / nc, c = i % nc;
    const int g = c / U, j = j0 + c % U;
    sg_put(slice, c, k, nc,
           k < H && j < H ? a.Wh[(long long)k * H4 + g * H + j] : 0.f);
  }
  // the slice's writes, made visible to wgmma's reads (the async proxy)
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  for (int i = tid; i < a.rows * U; i += SG_THREADS) cst[i] = 0.f;
  __syncthreads();

  unsigned gen = 0;
  const int r_end = min(a.B, r0 + a.rows);
  const int passes = (r_end - r0 + SG_ROWS - 1) / SG_ROWS;
  for (int t = 0; t < a.T; ++t) {
    for (int p = 0; p < passes; ++p) {
      const int row0 = r0 + p * SG_ROWS, nrows = min(SG_ROWS, r_end - row0);
      if (t > 0) {   // h_{t-1} of rows row0 ..: row b at (b T + t - 1) H
        sg_pass<NC>(a.h_seq + ((long long)row0 * a.T + t - 1) * H,
                    (long long)a.T * H, nrows, H, a.vec != 0, slice_s, ring,
                    a.stages, out);
      } else {
        for (int i = tid; i < SG_ROWS * (nc + 1); i += SG_THREADS)
          out[i] = 0.f;
        __syncthreads();
      }
      for (int e = tid; e < SG_ROWS * U; e += SG_THREADS) {
        const int rr = e / U, u = e % U, j = j0 + u;
        if (rr >= nrows || j >= H) continue;
        const float* o = out + rr * (nc + 1);
        const float acc4[4] = {o[u], o[U + u], o[2 * U + u], o[3 * U + u]};
        const long long row = (long long)(row0 + rr) * a.T + t;
        float& c = cst[(row0 - r0 + rr) * U + u];
        float c_new, h_new;
        Gates::forward(a.zg + row * H4, a.Wb, acc4, H, j, c, c_new, h_new);
        c = c_new;
        a.c_seq[row * H + j] = c_new;
        a.h_seq[row * H + j] = h_new;
      }
      __syncthreads();   // the out tile is free for the next pass
    }
    if (t + 1 < a.T) grid_sync(a.count, gen);
  }
}

// ---- the backward --------------------------------------------------------

struct ScanBwdArgs {
  const float* Wh;     // (H, 4H) rows
  const float* gates;  // (B T, 4H): the forward's gate activations
  const float* c_seq;  // (B, T, H)
  const float* dh_seq; // (B, T, H)
  float* dZ;           // (B T, 4H) out
  float* part;         // (splits, B, H): a step's partial sums
  unsigned* count;     // the grid barrier's counter, zero at launch
  int B, T, H, units, kc, splits, stages, per;
  float gclip;
};

// Shared memory: the slice (hi, lo), the ring, then the gate pass's tiles
// for the block's `per` elements i = b H + j (from blockIdx.x per): gs (4
// x per: the gate activations in, dz out, in place), c_t, c_{t-1}, dh (per
// each, copied in a step ahead, during the grid barrier, by the threads
// that read them) and dc (per, carried from step to step).
template <class Gates, int NC>
__global__ void __launch_bounds__(SG_THREADS, 1)
scan_bwd_grid_kernel(ScanBwdArgs a) {
  extern __shared__ __align__(16) unsigned char sg_raw[];
  const int U = a.units, H = a.H, H4 = 4 * H, B = a.B, per = a.per;
  const int kdp = min(a.kc, sg_round_up(H4, SG_BK));
  const unsigned raw = (unsigned)__cvta_generic_to_shared(sg_raw);
  unsigned char* slice = sg_raw + ((1024 - (raw & 1023)) & 1023);
  const unsigned slice_s = (unsigned)__cvta_generic_to_shared(slice);
  float* ring = reinterpret_cast<float*>(slice + 8 * U * kdp);
  float* xo = ring + a.stages * SG_ROWS * SG_LDA;   // [64][U + 1]
  float* gs = xo + SG_ROWS * (U + 1);                // [4][per]
  float* cn = gs + 4 * per;
  float* cp = cn + per;
  float* dhs = cp + per;
  float* dcs = dhs + per;
  const int tid = threadIdx.x;
  const int ug = blockIdx.x / a.splits, kr = blockIdx.x % a.splits;
  const int j0 = ug * U, k0 = kr * a.kc, kd = min(a.kc, H4 - k0);
  const long long bh = (long long)B * H;   // < 2^31: the plan's elements
  const int e0 = blockIdx.x * per;
  const int ne = max(0, min(per, (int)bh - e0));

  // the slice: column c is W_h's row j0 + c over [k0, k0 + kd)
  for (int i = tid; i < U * kdp; i += SG_THREADS) {
    const int c = i / kdp, k = i % kdp, j = j0 + c;
    sg_put(slice, c, k, U,
           j < H && k < kd ? a.Wh[(long long)j * H4 + k0 + k] : 0.f);
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  for (int e = tid; e < per; e += SG_THREADS) dcs[e] = 0.f;
  __syncthreads();

  unsigned gen = 0;
  // the gate pass's operands of step s (one cp.async group, issued a step
  // ahead so that it lands during the barrier)
  auto load_gate = [&](int s) {
    for (int e = tid; e < ne; e += SG_THREADS) {
      const int i = e0 + e, b = i / H, j = i % H;
      const long long row = (long long)b * a.T + s;
#pragma unroll
      for (int g = 0; g < 4; ++g)
        sg_copy4(gs + g * per + e, a.gates + row * H4 + g * H + j, true,
                 a.gates);
      sg_copy4(cn + e, a.c_seq + row * H + j, true, a.c_seq);
      sg_copy4(cp + e, a.c_seq + (row - 1) * H + j, s > 0, a.c_seq);
      sg_copy4(dhs + e, a.dh_seq + row * H + j, true, a.dh_seq);
    }
    tc_commit();
  };
  load_gate(a.T - 1);
  for (int s = a.T - 1; s >= 0; --s) {
    if (s + 1 < a.T) {
      for (int row0 = 0; row0 < B; row0 += SG_ROWS) {
        const int nrows = min(SG_ROWS, B - row0);
        // dZ_{s+1} of rows row0 ..: row b at (b T + s + 1) 4H, from k0
        sg_pass<NC>(a.dZ + ((long long)row0 * a.T + s + 1) * H4 + k0,
                    (long long)a.T * H4, nrows, kd, true, slice_s, ring,
                    a.stages, xo);
        for (int i = tid; i < nrows * U; i += SG_THREADS) {
          const int rr = i / U, c = i % U;
          if (j0 + c < H)
            a.part[kr * bh + (long long)(row0 + rr) * H + j0 + c] =
                xo[rr * (U + 1) + c];
        }
        __syncthreads();   // xo is free for the next pass
      }
      grid_sync(a.count, gen);
    } else {
      tc_wait<0>();
      __syncthreads();
    }
    for (int e = tid; e < ne; e += SG_THREADS) {
      const int i = e0 + e, b = i / H, j = i % H;
      float acc = 0.f;
      if (s + 1 < a.T) {
        acc = __ldcg(a.part + i);
        for (int q = 1; q < a.splits; ++q)
          acc = __fadd_rn(acc, __ldcg(a.part + q * bh + i));
      }
      if (Gates::kClipCarry) acc = fminf(fmaxf(acc, -a.gclip), a.gclip);
      const float dc_in = s + 1 < a.T ? dcs[e] : 0.f;
      const float dh_total = dhs[e] + acc;
      // the policy on the tiles (stride per): gs's activations in, dz out
      dcs[e] = Gates::backward(gs + e, gs + e, per, 0, cn[e], cp[e],
                               dh_total, dc_in);
      float* dz = a.dZ + ((long long)b * a.T + s) * H4 + j;
#pragma unroll
      for (int g = 0; g < 4; ++g) dz[g * H] = gs[g * per + e];
    }
    if (s > 0) {
      load_gate(s - 1);   // this thread's elements only: no barrier needed
      grid_sync(a.count, gen);
    }
  }
}

// ---- the launches --------------------------------------------------------

template <class Kernel, class Args>
inline cudaError_t sg_launch(Kernel kernel, const Args& a, int blocks,
                             long long smem, cudaStream_t st) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  int per = 0, dev = 0, sms = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, kernel, SG_THREADS,
                                                    (size_t)smem);
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  if (blocks > per * sms) return cudaErrorCooperativeLaunchTooLarge;
  void* args[] = {const_cast<Args*>(&a)};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel),
                                  dim3(blocks), dim3(SG_THREADS), args,
                                  (size_t)smem, st);
  return e != cudaSuccess ? e : cudaGetLastError();
}

// The forward recurrence over the input side in zg (B T, 4H); `count`
// points at one word of device memory (zeroed here).
template <class Gates>
inline cudaError_t scan_fwd_grid(const ScanPlan& p, const float* Wh,
                                 const float* Wb, float* zg, float* h_seq,
                                 float* c_seq, unsigned* count, int B, int T,
                                 int H, cudaStream_t st) {
  cudaError_t e = cudaMemsetAsync(count, 0, sizeof(unsigned), st);
  if (e != cudaSuccess) return e;
  ScanFwdArgs a;
  a.Wh = Wh; a.Wb = Wb; a.zg = zg; a.h_seq = h_seq; a.c_seq = c_seq;
  a.count = count; a.B = B; a.T = T; a.H = H; a.rows = p.f_rows;
  a.units = p.f_units; a.unit_groups = sg_cdiv(H, p.f_units);
  a.stages = p.f_stages;
  a.vec = H % 4 == 0 && tc_aligned16(h_seq);
  switch (4 * p.f_units) {
    case 16: return sg_launch(scan_fwd_grid_kernel<Gates, 16>, a, p.f_blocks,
                              p.f_smem, st);
    case 32: return sg_launch(scan_fwd_grid_kernel<Gates, 32>, a, p.f_blocks,
                              p.f_smem, st);
    case 64: return sg_launch(scan_fwd_grid_kernel<Gates, 64>, a, p.f_blocks,
                              p.f_smem, st);
  }
  return cudaErrorInvalidValue;
}

// The backward recurrence -> dZ (B T, 4H); part (splits, B, H) scratch,
// `count` one word (zeroed here); dZ 16-byte aligned.
template <class Gates>
inline cudaError_t scan_bwd_grid(const ScanPlan& p, const float* Wh,
                                 const float* gates, const float* c_seq,
                                 const float* dh_seq, float* dZ, float* part,
                                 unsigned* count, int B, int T, int H,
                                 float gclip, cudaStream_t st) {
  if (!tc_aligned16(dZ)) return cudaErrorInvalidValue;
  cudaError_t e = cudaMemsetAsync(count, 0, sizeof(unsigned), st);
  if (e != cudaSuccess) return e;
  ScanBwdArgs a;
  a.Wh = Wh; a.gates = gates; a.c_seq = c_seq; a.dh_seq = dh_seq;
  a.dZ = dZ; a.part = part; a.count = count;
  a.B = B; a.T = T; a.H = H; a.units = p.b_units; a.kc = p.b_kc;
  a.splits = p.b_splits; a.stages = p.b_stages; a.per = p.b_per;
  a.gclip = gclip;
  switch (p.b_units) {
    case 16: return sg_launch(scan_bwd_grid_kernel<Gates, 16>, a, p.b_blocks,
                              p.b_smem, st);
    case 32: return sg_launch(scan_bwd_grid_kernel<Gates, 32>, a, p.b_blocks,
                              p.b_smem, st);
    case 64: return sg_launch(scan_bwd_grid_kernel<Gates, 64>, a, p.b_blocks,
                              p.b_smem, st);
  }
  return cudaErrorInvalidValue;
}

}  // namespace icee
