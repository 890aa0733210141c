// The recurrence of the teacher-forced training scans K3 (lstm_scan.cu,
// the FactoredLSTM), K4 (nic_scan.cu, the torch-order LSTM) and K8
// (senticap_scan.cu, the SentiCap mRNN) as ONE cooperative launch a
// direction, with each block's slice of W_h (H, 4H)
// resident in shared memory for all T steps (or, past that plan's reach,
// streamed from device memory a pass: "Streamed plans" below) and each
// step's product on the tensor cores at float32 accuracy (3xTF32 wgmma).
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
// through L2 a step.  Both sides derive a plan once a shape: the entry
// points remember the plans they checked, and the card's SM count, its
// kernels' shared-memory attribute and occupancy are read once.
//
// Streamed plans.  A resident slice is a block's share of W_h's 32 H^2
// bytes of planes (33.5 MB at H = 1024, more than the card's shared memory
// holds), and the backward's gate pass keeps 8 floats an element, so the
// resident search finds no plan past H ~ 704 or at large B (2048 at
// H = 512).  There a direction takes a plan of kind SG_STREAMED, and also
// where the resident ring would hold one k tile in flight (2 stages) for
// passes of several: at B = 4096 the resident forward gave a block 2,048
// rows behind 2 stages, every one of its 512 tiles a step waiting on L2.
// The call lays W_h out once as planes in device memory
// (planes_product.cuh sb_prepare, W_h^T's for the backward; the forward's
// in unit-group order for the TMA ring, sg_prepare_groups), and each pass
// copies its k tiles of the planes through the ring beside the A tiles,
// into the swizzled layout wgmma reads (from L2 while the planes fit it).  The work is cut into
// items of MT M tiles of 64 rows (MT = 1 or 2: two register fragments
// an output and two A buffers; forward: 64 MT rows x f_units units;
// backward: 64 MT rows x b_units units x one b_kc-deep k range, any
// multiple of 32), dealt to min(items, SMs) blocks round robin; the MT M
// tiles share each tile of the planes copied, so the planes are copied
// once a row group where 64-row items copied them once a 64-row pass.
// The plan's key is what the busiest block's items cost a step in bytes
// copied, each k tile no cheaper than SG_FLIGHT_BYTES over the tiles its
// ring keeps in flight (sg_tile_cost): every B and every H up to
// SG_STREAM_MAX has a plan on any card, its state in device memory, every
// row offset 64-bit (B H < 2^31 is the one bound on B, the gate pass's
// element count).  Where the operands allow it (the forward: H % 4 == 0;
// the backward always) the ring is fed by TMA (the streamed ring
// section below): thread 0 copies a stage's tiles, an mbarrier a stage
// counts them in and another counts the warps out, so no block barrier
// sits in the k loop, and a tile's wgmma group runs while the warps split
// the next tile's A; elsewhere (the forward at H % 4 != 0, items of one M
// tile) every thread copies by cp.async.  The forward loads its gate
// operands before it runs the policy and reads c_{t-1} from c_seq; the
// backward's gate pass reads its operands from device memory and carries
// dc there (no per-element state in shared memory).  The arithmetic is the resident passes' own; the
// backward's partials are added in range order, then clamped, as there.
// An H past SG_STREAM_MAX with no resident plan raises in the wrapper.
//
// What bounds a streamed step (scripts/wide_scan_turns.py, NVIDIA H100
// 80GB HBM3, 700 W): the k loop, ~1.5 us a tile of 64 columns and two M
// tiles fed by TMA (2.5 with every thread copying and a block barrier a
// tile) against ~0.4 us of wgmma work, the two operands' 32 KB a tile of
// every block through L2; at H = 2048 the planes, 2 x 67 MB, stream from
// HBM every step.
//
// No atomics in any sum (the grid barrier counts arrivals only): a call
// gives the same bits on every run.
#pragma once

#include <cuda.h>          // CUtensorMap
#include <cudaTypedefs.h>  // PFN_cuTensorMapEncodeTiled

#include <mutex>

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
constexpr int SG_RESIDENT = 0;     // a plan's kind: W_h's slice resident
constexpr int SG_STREAMED = 1;     // ... W_h's planes streamed a pass
constexpr int SG_STREAM_MAX = 2048;   // H a streamed plan takes
constexpr int SG_ITEM_TILES = 2;   // a streamed item's fixed cost, in k tiles
constexpr int SG_MAX_MT = 2;       // 64-row M tiles of a streamed item
                                   // (registers: 64 columns x 2 tiles, two
                                   // fragments an output, two A buffers)
constexpr int SG_FLIGHT_BYTES = 49152;  // bytes a block keeps in flight to
                                        // cover L2's latency (the plan key)

struct ScanPlan {
  int B, H;        // the shapes the plan is for
  int sms;         // the card's SM count (blocks of one launch: at most it)
  int f_rows;      // forward: batch rows a block (a multiple of SG_ROWS;
                   // streamed: an item's, 64 a M tile)
  int f_units;     // forward: hidden units a block (4 f_units columns)
  int f_blocks;    // forward: ceil(B / f_rows) x ceil(H / f_units)
                   // (streamed: min(items, sms), items dealt round robin)
  int f_stages;    // forward: A ring stages
  int b_units;     // backward: hidden units a block (dh columns)
  int b_kc;        // backward: depth of a block's range of 4H
  int b_splits;    // backward: k ranges, ceil(4H / b_kc)
  int b_blocks;    // backward: ceil(H / b_units) x b_splits (streamed:
                   // min(items, sms))
  int b_stages;    // backward: A ring stages
  int b_per;       // backward: (b, j) elements a block's gate pass owns
  int f_kind, b_kind;        // SG_RESIDENT or SG_STREAMED a direction
  long long f_smem, b_smem;  // dynamic shared memory a block (bytes)
  int b_rows;      // backward: rows of a pass (streamed: an item's, 64 a M
                   // tile; resident: 64, a block's passes cover all B)
};

__host__ __device__ inline int sg_round_up(int x, int to) {
  return (x + to - 1) / to * to;
}
__host__ __device__ inline int sg_cdiv(int x, int to) {
  return (x + to - 1) / to;
}

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

// One stage of a streamed plan's ring: B's hi and lo tiles (nc rows of
// 128 bytes each), then the mt A tiles; a multiple of 1024 bytes.
inline long long sg_stream_stage_bytes(int nc, int mt = 1) {
  return 2LL * nc * SG_BK * 4 + (long long)mt * SG_TILE_BYTES;
}

// Bytes of a streamed block besides its ring: the 1024 that align the
// ring and the out tile of an item (64 mt x nc + 1).
inline long long sg_stream_rest(int nc, int mt = 1) {
  return 1024 + 4LL * SG_ROWS * mt * (nc + 1);
}

// Stages of a streamed ring for nk k tiles a pass (sg_stages' rule).
inline int sg_stream_stages(int nk, int nc, int mt = 1) {
  const long long fit = (SG_SMEM_LIMIT - sg_stream_rest(nc, mt)) /
                        sg_stream_stage_bytes(nc, mt);
  int s = nk + 1 < SG_MAX_STAGES ? nk + 1 : SG_MAX_STAGES;
  if (fit < s) s = (int)fit;
  return s >= 2 ? s : 0;
}

// What a ring's k tile costs a block, in bytes: the bytes it copies (A's
// mt tiles of 64 x 32 and B's planes, nc columns x 32, hi and lo: 0 for a
// resident slice), and no less than SG_FLIGHT_BYTES over the tiles in
// flight (stages - 1): a ring too shallow to cover L2's latency waits for
// it whatever it copies.
inline long long sg_tile_cost(int mt, int nc_streamed, int stages) {
  const long long bytes =
      (long long)mt * 4 * SG_ROWS * SG_BK + 8LL * nc_streamed * SG_BK;
  const long long wait = SG_FLIGHT_BYTES / (stages - 1);
  return bytes > wait ? bytes : wait;
}

// What one item of a streamed pass costs: its nk k tiles and SG_ITEM_TILES
// tiles more for the ring's fill and the item's epilogue (sg_tile_cost).
inline long long sg_stream_item_bytes(int nk, int nc, int mt = 1,
                                      int stages = SG_MAX_STAGES) {
  return (long long)(nk + SG_ITEM_TILES) * sg_tile_cost(mt, nc, stages);
}

// The plan for (B, H) on a card of `sms` SMs; f_blocks 0 (or b_blocks 0)
// where no partition fits.  Resident forward candidates: units 4, 8, 16 (4
// units are 16 columns: two fragments a warp); rows 64 r.  Backward: units
// 16, 32, 64, k ranges 32 x 2^i up to the first that covers 4H.  Keys, in
// order: a block's work a step, then the words through L2 a step (A's
// reads; the backward's partials written and read), then more units.
// At H <= SG_STREAM_MAX each direction also has its streamed plan: forward
// units 8, 16, backward units 32, 64 (the widths whose wgmma keeps the
// tensor cores fed) and k ranges of every multiple of 32 (s ranges of 32
// ceil(nk / s) tiles), each with items of mt = 1 or 2 M tiles of 64 rows
// (2 only where TMA feeds a forward's ring) sharing each tile of W_h's
// planes; keys: what the busiest block's items cost a step
// (sg_stream_item_bytes: the A rows re-read once a unit group, the plane
// tiles once a row group, each k tile no cheaper than the latency its ring
// covers), then the cost of every item (and the partials written and
// read), then more units.  A direction streams where no resident
// partition fits, or where the resident ring has 2 stages for passes of
// more than one k tile (one tile in flight) and the streamed plan's
// busiest block costs less than the resident one's (its passes' A tiles
// at sg_tile_cost: B = 4096's 2,048 rows a block behind such a ring wait
// on L2 every tile).
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
          p.b_rows = SG_ROWS;
        }
      }
      if (kc >= h4) break;
    }
  }
  if (H > SG_STREAM_MAX || (long long)B * H > 0x7fffffffLL) return p;
  // the resident plans' busiest block a step: its passes' A tiles
  const long long f_res =
      p.f_blocks == 0 ? -1
                      : (long long)sg_cdiv(p.f_rows < B ? p.f_rows : B,
                                           SG_ROWS) *
                            nkf * sg_tile_cost(1, 0, p.f_stages);
  const long long b_res =
      p.b_blocks == 0 ? -1
                      : (long long)sg_cdiv(B, SG_ROWS) *
                            (sg_round_up(p.b_kc < h4p ? p.b_kc : h4p,
                                         SG_BK) / SG_BK) *
                            sg_tile_cost(1, 0, p.b_stages);
  best0 = -1;
  ScanPlan f = p;
  for (int u = 8; u <= 16; u *= 2) {   // streamed: 32 or 64 columns
    const int nc = 4 * u;
    // two M tiles an item where TMA feeds the ring (H % 4 == 0)
    for (int mt = 1; mt <= (H % 4 ? 1 : SG_MAX_MT); mt *= 2) {
      const long long items =
          (long long)sg_cdiv(B, SG_ROWS * mt) * sg_cdiv(H, u);
      const long long blocks = items < sms ? items : sms;
      const int stages = sg_stream_stages(nkf, nc, mt);
      if (stages == 0) continue;
      const long long item = sg_stream_item_bytes(nkf, nc, mt, stages);
      const long long k0 = (items + blocks - 1) / blocks * item;
      const long long k1 = items * item;
      if (best0 < 0 || k0 < best0 || (k0 == best0 && k1 < best1) ||
          (k0 == best0 && k1 == best1 && u > f.f_units)) {
        best0 = k0; best1 = k1;
        f.f_rows = SG_ROWS * mt; f.f_units = u; f.f_blocks = (int)blocks;
        f.f_stages = stages; f.f_kind = SG_STREAMED;
        f.f_smem = sg_stream_rest(nc, mt) +
                   stages * sg_stream_stage_bytes(nc, mt);
      }
    }
  }
  if (best0 >= 0 &&
      (f_res < 0 || (p.f_stages == 2 && nkf > 1 && best0 < f_res))) {
    p.f_rows = f.f_rows; p.f_units = f.f_units; p.f_blocks = f.f_blocks;
    p.f_stages = f.f_stages; p.f_kind = f.f_kind; p.f_smem = f.f_smem;
  }
  best0 = -1;
  ScanPlan b = p;
  const int nkt = h4p / SG_BK;
  for (int u = 32; u <= 64; u *= 2) {   // streamed: 32 or 64 units
    for (int mt = 1; mt <= SG_MAX_MT; mt *= 2) {
      for (int sp = 1; sp <= nkt; ++sp) {
        const int nk = sg_cdiv(nkt, sp), kc = SG_BK * nk;
        if (sg_cdiv(h4, kc) != sp) continue;   // sp ranges of this depth
        const long long items =
            (long long)sg_cdiv(B, SG_ROWS * mt) * sg_cdiv(H, u) * sp;
        const long long blocks = items < sms ? items : sms;
        const int stages = sg_stream_stages(nk, u, mt);
        if (stages == 0) continue;
        const long long item = sg_stream_item_bytes(nk, u, mt, stages);
        const long long k0 = (items + blocks - 1) / blocks * item;
        const long long k1 = items * item + 8LL * sp * B * H;
        if (best0 < 0 || k0 < best0 || (k0 == best0 && k1 < best1) ||
            (k0 == best0 && k1 == best1 && u > b.b_units)) {
          best0 = k0; best1 = k1;
          b.b_units = u; b.b_kc = kc; b.b_splits = sp;
          b.b_blocks = (int)blocks; b.b_stages = stages;
          b.b_per = sg_round_up(
              (int)(((long long)B * H + blocks - 1) / blocks), 4);
          b.b_kind = SG_STREAMED; b.b_rows = SG_ROWS * mt;
          b.b_smem = sg_stream_rest(u, mt) +
                     stages * sg_stream_stage_bytes(u, mt);
        }
      }
    }
  }
  if (best0 >= 0 &&
      (b_res < 0 || (p.b_stages == 2 &&
                     (p.b_kc < h4p ? p.b_kc : h4p) > SG_BK &&
                     best0 < b_res))) {
    p.b_units = b.b_units; p.b_kc = b.b_kc; p.b_splits = b.b_splits;
    p.b_blocks = b.b_blocks; p.b_stages = b.b_stages; p.b_per = b.b_per;
    p.b_kind = b.b_kind; p.b_rows = b.b_rows; p.b_smem = b.b_smem;
  }
  return p;
}

// The card's SM count and cooperative-launch support, read once a device.
inline cudaError_t sg_card(int& dev, int& sms) {
  static std::mutex mu;
  static int known[64] = {};   // 0 unread, else SM count (-1: no coop)
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> lock(mu);
  if (known[dev] == 0) {
    int n = 0, coop = 0;
    e = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
    if (e != cudaSuccess) return e;
    known[dev] = coop ? n : -1;
  }
  if (known[dev] < 0) return cudaErrorNotSupported;
  sms = known[dev];
  return cudaSuccess;
}

// 0 where `p` is the plan this source derives for (B, H) on this card and
// the card takes cooperative launches.  A plan once checked is remembered
// (the last few), so that a second call with the same plan derives none.
inline int sg_check_plan(const ScanPlan& p, int B, int H) {
  int dev = 0, sms = 0;
  cudaError_t e = sg_card(dev, sms);
  if (e != cudaSuccess) return (int)e;
  auto same = [](const ScanPlan& x, const ScanPlan& y) {
    return x.B == y.B && x.H == y.H && x.sms == y.sms &&
           x.f_rows == y.f_rows && x.f_units == y.f_units &&
           x.f_blocks == y.f_blocks && x.f_stages == y.f_stages &&
           x.b_units == y.b_units && x.b_kc == y.b_kc &&
           x.b_splits == y.b_splits && x.b_blocks == y.b_blocks &&
           x.b_stages == y.b_stages && x.b_per == y.b_per &&
           x.f_kind == y.f_kind && x.b_kind == y.b_kind &&
           x.f_smem == y.f_smem && x.b_smem == y.b_smem &&
           x.b_rows == y.b_rows;
  };
  if (p.B != B || p.H != H || p.sms != sms) return (int)cudaErrorInvalidValue;
  constexpr int KEEP = 8;
  static std::mutex mu;
  static ScanPlan ok_plans[KEEP];
  static int n_ok = 0, next = 0;
  {
    std::lock_guard<std::mutex> lock(mu);
    for (int i = 0; i < n_ok; ++i)
      if (same(ok_plans[i], p)) return 0;
  }
  const ScanPlan q = sg_plan(B, H, sms);
  if (!same(p, q) || q.f_blocks == 0 || q.b_blocks == 0)
    return (int)cudaErrorInvalidValue;
  std::lock_guard<std::mutex> lock(mu);
  ok_plans[next] = q;
  next = (next + 1) % KEEP;
  if (n_ok < KEEP) ++n_ok;
  return 0;
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

// Streamed B (a plan of kind SG_STREAMED): the weight's planes in device
// memory (planes_product.cuh's layout: rows of ld = 2 Kp floats, each
// 32-deep k tile as its 32 hi values, then its 32 lo values).  Column c of
// a pass is planes row (c / U) gs + j0 + c % U, zero where j0 + c % U >= H
// (the forward: gate c / U's column of unit j0 + c % U; the backward, U =
// NC: W_h's row j0 + c); the pass starts at k tile kt0.
struct SgStream {
  const float* P;
  long long ld;
  int U, gs, H, j0, kt0;
};

// k tile kt0 + kt of streamed B into a stage's hi and lo tiles (NC rows of
// 128 bytes each, sg_slice_at's swizzle), as planes_product.cuh's sp_load.
template <int NC>
__device__ __forceinline__ void sg_load_b(const SgStream& w, int kt,
                                          unsigned char* dst) {
  for (int i = threadIdx.x; i < 2 * NC * 8; i += SG_THREADS) {
    const int c = i >> 4, lo = (i >> 3) & 1, q = i & 7;
    const int j = w.j0 + c % w.U;
    const bool in = j < w.H;
    const float* src = w.P + (long long)((c / w.U) * w.gs + j) * w.ld +
                       2 * SG_BK * (w.kt0 + kt) + SG_BK * lo + 4 * q;
    tc_copy16(reinterpret_cast<float*>(dst + lo * NC * 128 + (c >> 3) * 1024 +
                                       (c & 7) * 128 + ((q ^ (c & 7)) << 4)),
              in ? src : w.P, in ? 16 : 0);
  }
}

// xo (nrows x NC, row stride NC + 1) = A (nrows x kd) W, W the resident
// slice at shared address slice_s (sg_slice_at's layout, NC columns), or
// where STREAM, W's k tiles streamed from `w` through the ring (each stage
// B's tiles, then A's; the ring 1024-byte aligned).
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
template <int NC, bool STREAM = false>
__device__ __forceinline__ void sg_pass(const float* A, long long lda,
                                        int nrows, int kd, bool vec,
                                        unsigned slice_s, float* ring,
                                        int stages, float* xo,
                                        const SgStream& w = SgStream{}) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gr = lane >> 2, tq = lane & 3, wg = warp >> 2;
  const int r = 16 * (warp & 3) + gr;
  const int nk = (kd + SG_BK - 1) / SG_BK;
  constexpr int BF = STREAM ? 2 * NC * SG_BK : 0;   // B's floats a stage
  constexpr int STAGE = BF + SG_ROWS * SG_LDA;
  const unsigned ring_s = STREAM ? (unsigned)__cvta_generic_to_shared(ring)
                                 : 0u;
  float acc[NC / 2], t[NC / 2];
#pragma unroll
  for (int i = 0; i < NC / 2; ++i) acc[i] = t[i] = 0.f;
  for (int st = 0; st < stages - 1; ++st) {
    if (st < nk) {
      if constexpr (STREAM)
        sg_load_b<NC>(w, st, reinterpret_cast<unsigned char*>(
                                 ring + st * STAGE));
      sg_load(A, lda, nrows, kd, st * SG_BK, vec, ring + st * STAGE + BF);
    }
    tc_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    sg_wait(stages - 2);   // tile kt has landed (this thread's copies)
    if constexpr (STREAM)  // the B tiles' writes, made visible to wgmma
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();       // ... and everyone's; stage kt - 1 is free
    const int nxt = kt + stages - 1;
    if (nxt < nk) {
      if constexpr (STREAM)
        sg_load_b<NC>(w, nxt, reinterpret_cast<unsigned char*>(
                                  ring + (nxt % stages) * STAGE));
      sg_load(A, lda, nrows, kd, nxt * SG_BK, vec,
              ring + (nxt % stages) * STAGE + BF);
    }
    tc_commit();
    const float* As = ring + (kt % stages) * STAGE + BF;
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
    const unsigned tile = STREAM ? ring_s + 4 * (kt % stages) * STAGE
                                 : slice_s + 2 * kt * NC * 128;
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
  const float* P;      // streamed: W_h's planes (H deep, 4H rows of ld)
  long long ld;
  int B, T, H, rows, units, unit_groups, stages, vec;
  CUtensorMap tm_a, tm_b;   // streamed by TMA: h_seq (H, T, B) and the
                            // planes in unit-group order (sg_prepare_groups)
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

// A streamed forward item's policy from its out tile (64 MT x NC + 1: the
// item's rows' (h W)[row][g U + u]) at step t: each thread's PER elements'
// operands loaded first (the input side, the bias, c_{t-1}: their loads
// in flight together), then the policy on the copies (H = 1, j = 0: the
// same arithmetic as on zg), then the stores of the gate activations, c
// and h.
template <class Gates, int NC, int MT>
__device__ __forceinline__ void sg_fwd_gates(const ScanFwdArgs& a,
                                             const float* out, int row0,
                                             int j0, int nrows, int t) {
  constexpr int U = NC / 4, PER = SG_ROWS * MT * U / SG_THREADS;
  const int H = a.H, H4 = 4 * H, tid = threadIdx.x;
  float zl[PER][4], wl[PER][4], cl[PER];
#pragma unroll
  for (int q = 0; q < PER; ++q) {
    const int e = tid + q * SG_THREADS, rr = e / U, j = j0 + e % U;
    const bool in = rr < nrows && j < H;
    const long long row = (long long)(row0 + rr) * a.T + t;
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      zl[q][g] = in ? a.zg[row * H4 + g * H + j] : 0.f;
      wl[q][g] = in && a.Wb != nullptr ? a.Wb[g * H + j] : 0.f;
    }
    cl[q] = in && t > 0 ? __ldcg(a.c_seq + (row - 1) * H + j) : 0.f;
  }
#pragma unroll
  for (int q = 0; q < PER; ++q) {
    const int e = tid + q * SG_THREADS, rr = e / U, u = e % U;
    const int j = j0 + u;
    if (rr >= nrows || j >= H) continue;
    const float* o = out + rr * (NC + 1);
    const float acc4[4] = {o[u], o[U + u], o[2 * U + u], o[3 * U + u]};
    const long long row = (long long)(row0 + rr) * a.T + t;
    float c_new, h_new;
    Gates::forward(zl[q], wl[q], acc4, 1, 0, cl[q], c_new, h_new);
#pragma unroll
    for (int g = 0; g < 4; ++g) a.zg[row * H4 + g * H + j] = zl[q][g];
    a.c_seq[row * H + j] = c_new;
    a.h_seq[row * H + j] = h_new;
  }
}

// The streamed forward at H % 4 != 0 (a plan of kind SG_STREAMED whose
// rows TMA cannot stride; items of one M tile): items (64 rows, U units),
// item i of a step on block i % gridDim.x; each a pass over h_{t-1} with
// W_h's k tiles streamed by every thread's cp.async (sg_pass<NC, true>),
// then the policy (sg_fwd_gates) with c_{t-1} read from c_seq.  Shared
// memory: the ring (1024-byte aligned), then the out tile (64 x nc + 1).
template <class Gates, int NC>
__global__ void __launch_bounds__(SG_THREADS, 1)
scan_fwd_stream_kernel(ScanFwdArgs a) {
  extern __shared__ __align__(16) unsigned char sg_raw[];
  constexpr int U = NC / 4, ROWS = SG_ROWS;
  const int H = a.H;
  const unsigned raw = (unsigned)__cvta_generic_to_shared(sg_raw);
  float* ring =
      reinterpret_cast<float*>(sg_raw + ((1024 - (raw & 1023)) & 1023));
  float* out = ring + a.stages * (2 * NC * SG_BK + SG_ROWS * SG_LDA);
  const int tid = threadIdx.x;
  const int items = sg_cdiv(a.B, ROWS) * a.unit_groups;
  unsigned gen = 0;
  for (int t = 0; t < a.T; ++t) {
    for (int it = blockIdx.x; it < items; it += gridDim.x) {
      const int row0 = (it / a.unit_groups) * ROWS;
      const int j0 = (it % a.unit_groups) * U;
      const int nrows = min(ROWS, a.B - row0);
      if (t > 0) {   // h_{t-1} of rows row0 ..: row b at (b T + t - 1) H
        const SgStream w = {a.P, a.ld, U, H, H, j0, 0};
        sg_pass<NC, true>(a.h_seq + ((long long)row0 * a.T + t - 1) * H,
                          (long long)a.T * H, nrows, H, a.vec != 0, 0u, ring,
                          a.stages, out, w);
      } else {
        for (int i = tid; i < ROWS * (NC + 1); i += SG_THREADS) out[i] = 0.f;
        __syncthreads();
      }
      sg_fwd_gates<Gates, NC, 1>(a, out, row0, j0, nrows, t);
      __syncthreads();   // the out tile is free for the next item
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
  const float* P;      // streamed: W_h^T's planes (4H deep, H rows of ld)
  long long ld;
  float* dcb;          // streamed: (B, H), the carried dc
  int B, T, H, units, kc, splits, stages, per;
  float gclip;
  CUtensorMap tm_a, tm_b;   // streamed: dZ (4H, T, B) and W_h^T's planes
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

// ---- the streamed ring fed by TMA ------------------------------------------
//
// The streamed kernels' ring, fed by the Tensor Memory Accelerator where the
// operands allow it (the forward: H % 4 == 0, h_seq's rows 16-byte strided;
// the backward always): thread 0 copies each stage's tiles with
// cp.async.bulk.tensor (B's hi and lo planes, NC rows of 128 bytes each in
// wgmma's 128-byte swizzle; the item's MT A tiles, 64 rows of 32 floats in
// the same swizzle, rows past B and k past the operand zero-filled by the
// copy), an mbarrier a stage counting its bytes in; the eight warps wait on
// it, and each releases the stage on a second mbarrier when its wgmma group
// has read it, so no block-wide barrier sits in the k loop.  The forward's
// planes are laid out in unit-group order (sg_prepare_groups: a group's 4 U
// gate columns contiguous), so B is one copy a plane.  The products are
// sg_pass<NC, true, MT>'s: the same operations on every output.

__device__ __forceinline__ void sg_mbar_init(unsigned bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void sg_mbar_expect(unsigned bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(bar), "r"(bytes) : "memory");
}
__device__ __forceinline__ void sg_mbar_arrive(unsigned bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               ::"r"(bar) : "memory");
}
__device__ __forceinline__ void sg_mbar_wait(unsigned bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "SG_WAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra SG_WAIT_%=;\n"
      "}\n" ::"r"(bar), "r"(parity) : "memory");
}
__device__ __forceinline__ void sg_tma2(unsigned dst, const CUtensorMap* m,
                                        int c0, int c1, unsigned bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n"
      ::"r"(dst), "l"(reinterpret_cast<unsigned long long>(m)), "r"(c0),
      "r"(c1), "r"(bar) : "memory");
}
__device__ __forceinline__ void sg_tma3(unsigned dst, const CUtensorMap* m,
                                        int c0, int c1, int c2,
                                        unsigned bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n"
      ::"r"(dst), "l"(reinterpret_cast<unsigned long long>(m)), "r"(c0),
      "r"(c1), "r"(c2), "r"(bar) : "memory");
}

// The forward's planes of W_h (H, 4H) in unit-group order: row ug NC + g U
// + u holds W_h's column g H + ug U + u (zeros past H), 2 Kp floats as
// planes_product.cuh lays a row out (each 32-deep k tile's 32 hi values,
// then its 32 lo values; tf32_split, the same bits).  Block (k tile, unit
// group): the tile through shared memory, so that each plane row is
// written in 128-byte pieces.
template <int NC>
__global__ void __launch_bounds__(256)
sg_prepare_groups_kernel(const float* __restrict__ W, int H, int Kp,
                         float* P) {
  constexpr int U = NC / 4;
  __shared__ float tile[SG_BK][NC + 1];
  const int kt = blockIdx.x, ug = blockIdx.y, j0 = ug * U, H4 = 4 * H;
  for (int i = threadIdx.x; i < SG_BK * NC; i += blockDim.x) {
    const int kk = i / NC, c = i % NC, g = c / U, j = j0 + c % U;
    const int k = kt * SG_BK + kk;
    tile[kk][c] = k < H && j < H ? W[(long long)k * H4 + g * H + j] : 0.f;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < NC * 2 * SG_BK; i += blockDim.x) {
    const int c = i / (2 * SG_BK), lo = (i / SG_BK) & 1, kk = i % SG_BK;
    unsigned h, l;
    tf32_split(tile[kk][c], h, l);
    P[(long long)(ug * NC + c) * 2 * Kp + 2 * SG_BK * kt + SG_BK * lo + kk] =
        __uint_as_float(lo ? l : h);
  }
}

// One streamed item's pass with the TMA ring: xo (rows x NC, stride NC + 1)
// = A W for its k tiles 0 .. nk - 1.  issue(kt, stage, bar) copies k tile
// kt's B and A tiles into the stage at shared address `stage` (thread 0
// calls it).  tile_no: the block's running count of tiles (every thread's
// the same), which gives each tile its stage and its mbarriers' phase.
// Every thread of the block must call it; it ends with xo written.
template <int NC, int MT, class Issue>
__device__ __forceinline__ void sg_pass_tma(int nk, unsigned ring_s,
                                            const float* ring, int stages,
                                            unsigned full0, unsigned empty0,
                                            unsigned& tile_no, Issue issue,
                                            float* xo) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gr = lane >> 2, tq = lane & 3, wg = warp >> 2;
  const int r = 16 * (warp & 3) + gr;
  constexpr int BB = 2 * NC * 128, AB = SG_ROWS * SG_BK * 4;
  constexpr int STAGE = BB + MT * AB;   // bytes, a multiple of 1024
  auto stage_of = [&](int kt) { return (tile_no + kt) % stages; };
  auto produce = [&](int kt) {   // thread 0
    const unsigned g = tile_no + kt, st = g % stages, use = g / stages;
    if (use > 0) sg_mbar_wait(empty0 + 8 * st, (use - 1) & 1);
    sg_mbar_expect(full0 + 8 * st, STAGE);
    issue(kt, ring_s + st * STAGE, full0 + 8 * st);
  };
  auto wait_full = [&](int kt) {
    const unsigned g = tile_no + kt;
    sg_mbar_wait(full0 + 8 * (g % stages), (g / stages) & 1);
  };
  if (threadIdx.x == 0)
    for (int kt = 0; kt < nk && kt < stages - 1; ++kt) produce(kt);
  __syncwarp();
  float acc[MT][NC / 2], t[MT][NC / 2];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int i = 0; i < NC / 2; ++i) acc[m][i] = t[m][i] = 0.f;
  // k tile kt's A values of this thread (the swizzled tile: 16-byte chunk
  // q of row r at q ^ (r % 8)), split into TF32 hi and lo
  auto split = [&](int kt, unsigned (&ah)[MT][2][4],
                   unsigned (&al)[MT][2][4]) {
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      const float* As = ring + (stage_of(kt) * STAGE + BB + m * AB) / 4;
#pragma unroll
      for (int s8 = 0; s8 < 2; ++s8) {
        const int q = 4 * wg + 2 * s8;   // the chunk of k = 16 wg + 8 s8
        float v[4];
        v[0] = As[r * SG_BK + ((q ^ (r & 7)) << 2) + tq];
        v[1] = As[(r + 8) * SG_BK + ((q ^ (r & 7)) << 2) + tq];
        v[2] = As[r * SG_BK + (((q + 1) ^ (r & 7)) << 2) + tq];
        v[3] = As[(r + 8) * SG_BK + (((q + 1) ^ (r & 7)) << 2) + tq];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          tf32_split(v[e], ah[m][s8][e], al[m][s8][e]);
      }
    }
  };
  auto mma = [&](int kt, unsigned (&ah)[MT][2][4],
                 unsigned (&al)[MT][2][4]) {
    const unsigned tile = ring_s + stage_of(kt) * STAGE;
    const unsigned long long dh = wg_desc(tile), dl = wg_desc(tile + NC * 128);
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int i = 0; i < NC / 2; ++i)
        asm volatile("" : "+f"(t[m][i])::"memory");
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int m = 0; m < MT; ++m) {
#pragma unroll
      for (int s8 = 0; s8 < 2; ++s8) {   // + 32 bytes (2 x 16) a k8 step
        const int d = 2 * (2 * wg + s8);
        sg_mma<NC>(t[m], al[m][s8], dh + d, s8);
        sg_mma<NC>(t[m], ah[m][s8], dl + d, 1);
        sg_mma<NC>(t[m], ah[m][s8], dh + d, 1);
      }
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  };
  unsigned ah0[MT][2][4], al0[MT][2][4], ah1[MT][2][4], al1[MT][2][4];
  // tile kt's group runs while the warp waits for tile kt + 1 and splits
  // its A; then the group's end, each output's rounded add, the stage's
  // release, and (thread 0) the copies of tile kt + stages - 1 into the
  // stage tile kt - 1 freed
  auto step = [&](int kt, unsigned (&ah)[MT][2][4], unsigned (&al)[MT][2][4],
                  unsigned (&bh)[MT][2][4], unsigned (&bl)[MT][2][4]) {
    mma(kt, ah, al);
    if (kt + 1 < nk) {
      wait_full(kt + 1);
      split(kt + 1, bh, bl);
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int i = 0; i < NC / 2; ++i) {
        asm volatile("" : "+f"(t[m][i])::"memory");
        acc[m][i] = __fadd_rn(acc[m][i], t[m][i]);
      }
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int i = 0; i < 8; ++i)
        asm volatile("" : "+r"(ah[m][i >> 2][i & 3]),
                     "+r"(al[m][i >> 2][i & 3])::"memory");
    __syncwarp();
    if (lane == 0) sg_mbar_arrive(empty0 + 8 * stage_of(kt));
    if (threadIdx.x == 0 && kt + stages - 1 < nk) produce(kt + stages - 1);
    __syncwarp();
  };
  if (nk > 0) {
    wait_full(0);
    split(0, ah0, al0);
  }
  for (int kt = 0; kt < nk; kt += 2) {
    step(kt, ah0, al0, ah1, al1);
    if (kt + 1 < nk) step(kt + 1, ah1, al1, ah0, al0);
  }
  tile_no += nk;
  // acc[m][4 j + 2 h + q] holds (row 64 m + r + 8 h, column 8 j + 2 tq +
  // q): the second warpgroup's half into xo, then the first adds its own
  if (wg == 1) {
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int i = 0; i < NC / 2; ++i)
        xo[(SG_ROWS * m + r + 8 * ((i >> 1) & 1)) * (NC + 1) +
           8 * (i >> 2) + 2 * tq + (i & 1)] = acc[m][i];
  }
  __syncthreads();
  if (wg == 0) {
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int i = 0; i < NC / 2; ++i) {
        float& x = xo[(SG_ROWS * m + r + 8 * ((i >> 1) & 1)) * (NC + 1) +
                      8 * (i >> 2) + 2 * tq + (i & 1)];
        x = __fadd_rn(acc[m][i], x);
      }
  }
  __syncthreads();
}

// The ring's layout in a TMA kernel's shared memory: the ring 1024-byte
// aligned (stages of 2 NC 128 + MT 8192 bytes), the out tile (64 MT x NC +
// 1 floats), then a full and an empty mbarrier a stage; within the plan's
// shared memory (sg_stream_rest and sg_stream_stage_bytes count 9216 bytes
// an A tile, 1024 more a stage than TMA's dense tile).
struct SgTmaSmem {
  unsigned ring_s, full0, empty0;
  float* ring;
  float* out;
};
template <int NC, int MT>
__device__ __forceinline__ SgTmaSmem sg_tma_smem(unsigned char* raw_p,
                                                 int stages) {
  SgTmaSmem m;
  const unsigned raw = (unsigned)__cvta_generic_to_shared(raw_p);
  const unsigned pad = (1024 - (raw & 1023)) & 1023;
  m.ring = reinterpret_cast<float*>(raw_p + pad);
  m.ring_s = raw + pad;
  const int stage = 2 * NC * 128 + MT * SG_ROWS * SG_BK * 4;
  m.out = reinterpret_cast<float*>(raw_p + pad + stages * stage);
  const unsigned bars =
      (m.ring_s + stages * stage + 4 * SG_ROWS * MT * (NC + 1) + 7) & ~7u;
  m.full0 = bars;
  m.empty0 = bars + 8 * stages;
  if (threadIdx.x == 0) {
    for (int i = 0; i < stages; ++i) {
      sg_mbar_init(m.full0 + 8 * i, 1);
      sg_mbar_init(m.empty0 + 8 * i, SG_THREADS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  return m;
}

// The streamed forward with the TMA ring (scan_fwd_stream_kernel's items
// and policy; that kernel takes the H that TMA cannot stride, H % 4 != 0,
// whose plans keep items of one M tile).
// a.tm_b: the planes in unit-group order; a.tm_a: h_seq as (H, T, B).
template <class Gates, int NC, int MT>
__global__ void __launch_bounds__(SG_THREADS, 1)
scan_fwd_tma_kernel(const __grid_constant__ ScanFwdArgs a) {
  extern __shared__ __align__(16) unsigned char sg_raw[];
  constexpr int U = NC / 4, ROWS = SG_ROWS * MT;
  constexpr int BB = 2 * NC * 128, AB = SG_ROWS * SG_BK * 4;
  const int nk = sg_cdiv(a.H, SG_BK);
  const SgTmaSmem sm = sg_tma_smem<NC, MT>(sg_raw, a.stages);
  float* out = sm.out;
  const int tid = threadIdx.x;
  const int items = sg_cdiv(a.B, ROWS) * a.unit_groups;
  unsigned gen = 0, tile_no = 0;
  for (int t = 0; t < a.T; ++t) {
    for (int it = blockIdx.x; it < items; it += gridDim.x) {
      const int row0 = (it / a.unit_groups) * ROWS;
      const int ug = it % a.unit_groups, j0 = ug * U;
      const int nrows = min(ROWS, a.B - row0);
      if (t > 0) {   // h_{t-1} of rows row0 ..: (k, t - 1, b) of tm_a
        sg_pass_tma<NC, MT>(
            nk, sm.ring_s, sm.ring, a.stages, sm.full0, sm.empty0, tile_no,
            [&](int kt, unsigned st, unsigned bar) {
              sg_tma2(st, &a.tm_b, 2 * SG_BK * kt, ug * NC, bar);
              sg_tma2(st + NC * 128, &a.tm_b, 2 * SG_BK * kt + SG_BK,
                      ug * NC, bar);
#pragma unroll
              for (int m = 0; m < MT; ++m)
                sg_tma3(st + BB + m * AB, &a.tm_a, SG_BK * kt, t - 1,
                        row0 + SG_ROWS * m, bar);
            },
            out);
      } else {
        for (int i = tid; i < ROWS * (NC + 1); i += SG_THREADS) out[i] = 0.f;
        __syncthreads();
      }
      sg_fwd_gates<Gates, NC, MT>(a, out, row0, j0, nrows, t);
      __syncthreads();   // the out tile is free for the next item
    }
    if (t + 1 < a.T) {
      // h_t, written here, is read by the copy engine next step
      asm volatile("fence.proxy.async.global;\n" ::: "memory");
      grid_sync(a.count, gen);
      asm volatile("fence.proxy.async.global;\n" ::: "memory");
    }
  }
}

// The streamed backward (a plan of kind SG_STREAMED), its ring fed by TMA:
// items (64 MT rows, U units, k range kr), item i of a step on block i %
// gridDim.x; each a pass over its range of dZ_{s+1} (sg_pass_tma), its
// partial sums written; after a grid barrier the gate pass of the block's
// `per` elements as the resident kernel's, its operands read from device
// memory and the carried dc kept in dcb.  a.tm_b: W_h^T's planes; a.tm_a:
// dZ as (4H, T, B).
template <class Gates, int NC, int MT>
__global__ void __launch_bounds__(SG_THREADS, 1)
scan_bwd_tma_kernel(const __grid_constant__ ScanBwdArgs a) {
  extern __shared__ __align__(16) unsigned char sg_raw[];
  constexpr int U = NC, ROWS = SG_ROWS * MT;
  constexpr int BB = 2 * NC * 128, AB = SG_ROWS * SG_BK * 4;
  const int H = a.H, H4 = 4 * H, B = a.B, per = a.per;
  const SgTmaSmem sm = sg_tma_smem<NC, MT>(sg_raw, a.stages);
  float* xo = sm.out;
  const int tid = threadIdx.x;
  const int groups = sg_cdiv(H, U);
  const int items = sg_cdiv(B, ROWS) * groups * a.splits;
  const long long bh = (long long)B * H;   // < 2^31: the plan's elements
  const int e0 = blockIdx.x * per;
  const int ne = max(0, min(per, (int)bh - e0));
  unsigned gen = 0, tile_no = 0;
  for (int s = a.T - 1; s >= 0; --s) {
    if (s + 1 < a.T) {
      for (int it = blockIdx.x; it < items; it += gridDim.x) {
        const int kr = it % a.splits, rest = it / a.splits;
        const int row0 = (rest / groups) * ROWS, j0 = (rest % groups) * U;
        const int nrows = min(ROWS, B - row0);
        const int k0 = kr * a.kc, kd = min(a.kc, H4 - k0);
        const int kt0 = k0 / SG_BK;
        // dZ_{s+1} of rows row0 ..: (k, s + 1, b) of tm_a, from k0
        sg_pass_tma<NC, MT>(
            sg_cdiv(kd, SG_BK), sm.ring_s, sm.ring, a.stages, sm.full0,
            sm.empty0, tile_no,
            [&](int kt, unsigned st, unsigned bar) {
              sg_tma2(st, &a.tm_b, 2 * SG_BK * (kt0 + kt), j0, bar);
              sg_tma2(st + NC * 128, &a.tm_b, 2 * SG_BK * (kt0 + kt) + SG_BK,
                      j0, bar);
#pragma unroll
              for (int m = 0; m < MT; ++m)
                sg_tma3(st + BB + m * AB, &a.tm_a, k0 + SG_BK * kt, s + 1,
                        row0 + SG_ROWS * m, bar);
            },
            xo);
        for (int i = tid; i < nrows * U; i += SG_THREADS) {
          const int rr = i / U, c = i % U;
          if (j0 + c < H)
            a.part[kr * bh + (long long)(row0 + rr) * H + j0 + c] =
                xo[rr * (U + 1) + c];
        }
        __syncthreads();   // xo is free for the next item
      }
      grid_sync(a.count, gen);
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
      const float dc_in = s + 1 < a.T ? __ldcg(a.dcb + i) : 0.f;
      const long long row = (long long)b * a.T + s;
      const float dh_total = a.dh_seq[row * H + j] + acc;
      const float c_prev = s > 0 ? a.c_seq[(row - 1) * H + j] : 0.f;
      __stcg(a.dcb + i,
             Gates::backward(a.gates + row * H4, a.dZ + row * H4, H, j,
                             a.c_seq[row * H + j], c_prev, dh_total, dc_in));
    }
    if (s > 0) {
      // dZ_s, written here, is read by the copy engine next step
      asm volatile("fence.proxy.async.global;\n" ::: "memory");
      grid_sync(a.count, gen);
      asm volatile("fence.proxy.async.global;\n" ::: "memory");
    }
  }
}

// libcuda's cuTensorMapEncodeTiled, looked up once through the runtime (so
// the library needs no link against libcuda).
inline cudaError_t sg_encoder(PFN_cuTensorMapEncodeTiled_v12000* out) {
  static std::mutex mu;
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  std::lock_guard<std::mutex> lock(mu);
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                            cudaEnableDefault, &q);
    if (e != cudaSuccess) return e;
    if (q != cudaDriverEntryPointSuccess || p == nullptr)
      return cudaErrorNotSupported;
    fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
  }
  *out = fn;
  return cudaSuccess;
}

// A float32 tensor map of `rank` dims (dims innermost first, strides in
// bytes of dims 1 ..), box `box`, 128-byte swizzle, zeros out of bounds.
inline cudaError_t sg_tmap(CUtensorMap* m, const float* base, int rank,
                           const unsigned long long* dims,
                           const unsigned long long* strides,
                           const unsigned* box) {
  PFN_cuTensorMapEncodeTiled_v12000 enc = nullptr;
  cudaError_t e = sg_encoder(&enc);
  if (e != cudaSuccess) return e;
  const unsigned elem[3] = {1, 1, 1};
  const CUresult r = enc(
      m, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, rank, const_cast<float*>(base),
      reinterpret_cast<const cuuint64_t*>(dims),
      reinterpret_cast<const cuuint64_t*>(strides),
      reinterpret_cast<const cuuint32_t*>(box),
      reinterpret_cast<const cuuint32_t*>(elem),
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// ---- the launches --------------------------------------------------------

// Recurrence launches this library has issued: cooperative launches that
// returned success (read by each scan's icee_scan_recurrence_launches, so
// a check can count them without a profiler trace).
inline unsigned long long& sg_launches() {
  static unsigned long long n = 0;
  return n;
}

// A kernel's blocks an SM at `smem` bytes, its shared-memory attribute
// raised to at least that first: read once a (kernel, smem, device) and
// remembered (the attribute only ever rises, so a remembered launch still
// fits under it).
inline cudaError_t sg_blocks_per_sm(const void* kernel, long long smem,
                                    int dev, int& per) {
  struct Seen { const void* k; long long smem; int dev, per; };
  struct Raised { const void* k; int dev; long long smem; };
  static std::mutex mu;
  static Seen seen[64];
  static Raised raised[64];
  static int n = 0, nr = 0;
  std::lock_guard<std::mutex> lock(mu);
  for (int i = 0; i < n; ++i)
    if (seen[i].k == kernel && seen[i].smem == smem && seen[i].dev == dev) {
      per = seen[i].per;
      return cudaSuccess;
    }
  int r = 0;
  while (r < nr && !(raised[r].k == kernel && raised[r].dev == dev)) ++r;
  cudaError_t e = cudaSuccess;
  if (r == nr || raised[r].smem < smem) {
    e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    if (r < nr)
      raised[r].smem = smem;
    else if (nr < 64)
      raised[nr++] = {kernel, dev, smem};
  }
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, kernel, SG_THREADS,
                                                    (size_t)smem);
  if (e != cudaSuccess) return e;
  if (n < 64) seen[n++] = {kernel, smem, dev, per};
  return cudaSuccess;
}

template <class Kernel, class Args>
inline cudaError_t sg_launch(Kernel kernel, const Args& a, int blocks,
                             long long smem, cudaStream_t st) {
  int per = 0, dev = 0, sms = 0;
  cudaError_t e = sg_card(dev, sms);
  if (e == cudaSuccess)
    e = sg_blocks_per_sm(reinterpret_cast<const void*>(kernel), smem, dev,
                         per);
  if (e != cudaSuccess) return e;
  if (blocks > per * sms) return cudaErrorCooperativeLaunchTooLarge;
  void* args[] = {const_cast<Args*>(&a)};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel),
                                  dim3(blocks), dim3(SG_THREADS), args,
                                  (size_t)smem, st);
  if (e == cudaSuccess) e = cudaGetLastError();
  if (e == cudaSuccess) ++sg_launches();
  return e;
}

// Floats of device memory the recurrence of plan p needs beside the
// caller's buffers (16-byte aligned at its start): a streamed forward W_h's
// planes; a streamed backward W_h^T's planes, then the carried dc (B, H).
inline long long sg_fwd_ws_floats(const ScanPlan& p) {
  return p.f_kind == SG_STREAMED ? sp_planes_floats(p.H, 4 * p.H) : 0;
}
inline long long sg_bwd_ws_floats(const ScanPlan& p) {
  return p.b_kind == SG_STREAMED
             ? sp_planes_floats(4 * p.H, p.H) + (long long)p.B * p.H
             : 0;
}

// The forward recurrence over the input side in zg (B T, 4H); `count`
// points at one word of device memory (zeroed here); ws holds
// sg_fwd_ws_floats(p) floats.
template <class Gates>
inline cudaError_t scan_fwd_grid(const ScanPlan& p, const float* Wh,
                                 const float* Wb, float* zg, float* h_seq,
                                 float* c_seq, unsigned* count, float* ws,
                                 int B, int T, int H, cudaStream_t st) {
  cudaError_t e = cudaMemsetAsync(count, 0, sizeof(unsigned), st);
  if (e != cudaSuccess) return e;
  ScanFwdArgs a;
  a.Wh = Wh; a.Wb = Wb; a.zg = zg; a.h_seq = h_seq; a.c_seq = c_seq;
  a.count = count; a.B = B; a.T = T; a.H = H; a.rows = p.f_rows;
  a.units = p.f_units; a.unit_groups = sg_cdiv(H, p.f_units);
  a.stages = p.f_stages;
  a.vec = H % 4 == 0 && tc_aligned16(h_seq);
  a.P = ws; a.ld = 2LL * sp_round_up(H, SP_BK);
  if (p.f_kind == SG_STREAMED) {
    if (!tc_aligned16(ws)) return cudaErrorInvalidValue;
    const int nc = 4 * p.f_units, mt = p.f_rows / SG_ROWS;
    if (H % 4 == 0 && tc_aligned16(h_seq)) {
      // the TMA ring: the planes in unit-group order, h_seq as (H, T, B);
      // its ring holds 3 stages or more wherever a pass has 2 k tiles or
      // more (sg_pass_tma's thread 0 copies tile kt + stages - 1 after it
      // waited for tile kt + 1)
      const int kp = sp_round_up(H, SP_BK);
      if (p.f_stages < 3 && kp > SG_BK) return cudaErrorInvalidValue;
      switch (nc) {
        case 32: sg_prepare_groups_kernel<32><<<dim3(kp / SG_BK,
            a.unit_groups), 256, 0, st>>>(Wh, H, kp, ws); break;
        case 64: sg_prepare_groups_kernel<64><<<dim3(kp / SG_BK,
            a.unit_groups), 256, 0, st>>>(Wh, H, kp, ws); break;
        default: return cudaErrorInvalidValue;
      }
      if ((e = cudaGetLastError()) != cudaSuccess) return e;
      const unsigned long long bd[2] = {2ull * kp,
                                        (unsigned long long)a.unit_groups *
                                            nc},
                               bs[1] = {8ull * kp};
      const unsigned bb[2] = {SG_BK, (unsigned)nc};
      const unsigned long long ad[3] = {(unsigned long long)H,
                                        (unsigned long long)T,
                                        (unsigned long long)B},
                               as[2] = {4ull * H, 4ull * T * H};
      const unsigned ab[3] = {SG_BK, 1, SG_ROWS};
      if ((e = sg_tmap(&a.tm_b, ws, 2, bd, bs, bb)) != cudaSuccess ||
          (e = sg_tmap(&a.tm_a, h_seq, 3, ad, as, ab)) != cudaSuccess)
        return e;
      switch (nc * 8 + mt) {
#define SG_FWD_TMA(NC, MT)                                               \
  case NC * 8 + MT:                                                      \
    return sg_launch(scan_fwd_tma_kernel<Gates, NC, MT>, a, p.f_blocks,  \
                     p.f_smem, st);
        SG_FWD_TMA(32, 1) SG_FWD_TMA(32, 2) SG_FWD_TMA(64, 1)
        SG_FWD_TMA(64, 2)
#undef SG_FWD_TMA
      }
      return cudaErrorInvalidValue;
    }
    e = sb_prepare(Wh, H, 4 * H, ws, st);   // W_h's planes, rows g H + j
    if (e != cudaSuccess) return e;
    if (p.f_rows != SG_ROWS) return cudaErrorInvalidValue;
    switch (nc) {
      case 32: return sg_launch(scan_fwd_stream_kernel<Gates, 32>, a,
                                p.f_blocks, p.f_smem, st);
      case 64: return sg_launch(scan_fwd_stream_kernel<Gates, 64>, a,
                                p.f_blocks, p.f_smem, st);
    }
    return cudaErrorInvalidValue;
  }
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
// `count` one word (zeroed here), ws sg_bwd_ws_floats(p) floats; dZ
// 16-byte aligned.
template <class Gates>
inline cudaError_t scan_bwd_grid(const ScanPlan& p, const float* Wh,
                                 const float* gates, const float* c_seq,
                                 const float* dh_seq, float* dZ, float* part,
                                 unsigned* count, float* ws, int B, int T,
                                 int H, float gclip, cudaStream_t st) {
  if (!tc_aligned16(dZ)) return cudaErrorInvalidValue;
  cudaError_t e = cudaMemsetAsync(count, 0, sizeof(unsigned), st);
  if (e != cudaSuccess) return e;
  ScanBwdArgs a;
  a.Wh = Wh; a.gates = gates; a.c_seq = c_seq; a.dh_seq = dh_seq;
  a.dZ = dZ; a.part = part; a.count = count;
  a.B = B; a.T = T; a.H = H; a.units = p.b_units; a.kc = p.b_kc;
  a.splits = p.b_splits; a.stages = p.b_stages; a.per = p.b_per;
  a.gclip = gclip;
  a.P = ws; a.ld = 2LL * sp_round_up(4 * H, SP_BK);
  a.dcb = nullptr;
  if (p.b_kind == SG_STREAMED) {
    a.dcb = ws + sp_planes_floats(4 * H, H);
    if (!tc_aligned16(ws)) return cudaErrorInvalidValue;
    // W_h^T's planes (4H deep, H rows): W_h's own rows
    e = sb_prepare_strided(Wh, 4 * H, H, 1, 4 * H, 0, 1, ws, st);
    if (e != cudaSuccess) return e;
    // the TMA ring: W_h^T's planes, dZ as (4H, T, B); its ring holds 3
    // stages or more wherever a pass has 2 k tiles or more
    const int kp = sp_round_up(4 * H, SP_BK);
    if (p.b_stages < 3 && p.b_kc > SG_BK) return cudaErrorInvalidValue;
    const unsigned long long bd[2] = {2ull * kp,
                                      (unsigned long long)sp_round_up(H,
                                                                      SP_NP)},
                             bs[1] = {8ull * kp};
    const unsigned bb[2] = {SG_BK, (unsigned)p.b_units};
    const unsigned long long ad[3] = {4ull * H, (unsigned long long)T,
                                      (unsigned long long)B},
                             as[2] = {16ull * H, 16ull * T * H};
    const unsigned ab[3] = {SG_BK, 1, SG_ROWS};
    if ((e = sg_tmap(&a.tm_b, ws, 2, bd, bs, bb)) != cudaSuccess ||
        (e = sg_tmap(&a.tm_a, dZ, 3, ad, as, ab)) != cudaSuccess)
      return e;
    switch (p.b_units * 8 + p.b_rows / SG_ROWS) {   // (units, mt)
#define SG_BWD_TMA(NC, MT)                                               \
  case NC * 8 + MT:                                                      \
    return sg_launch(scan_bwd_tma_kernel<Gates, NC, MT>, a, p.b_blocks,  \
                     p.b_smem, st);
      SG_BWD_TMA(32, 1) SG_BWD_TMA(32, 2) SG_BWD_TMA(64, 1)
      SG_BWD_TMA(64, 2)
#undef SG_BWD_TMA
    }
    return cudaErrorInvalidValue;
  }
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
