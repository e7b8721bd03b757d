// bf16 flash attention (forward) for Hopper (sm_90a) through TMA and
// wgmma: O = softmax(Q K^T * scale + mask) V over q (B, Sq, H, hd) and k, v
// (B, Sk, KV, hd) with GQA, hd 16, 32, 64 or 128, f32 softmax state.
//
// Replaces, for bf16 operands that TMA can describe, the TPU kernel
// src/repro/kernels/flash_attention/kernel.py (_flash_kernel, launched by
// flash_attention_kernel through pl.pallas_call): a (B*H, Sq/BLK_Q,
// Sk/BLK_K) grid with K innermost, running max m, sum l and an f32
// accumulator in VMEM scratch, rescaled by exp(m_prev - m_new), the finite
// NEG_INF = -1e30 for masked scores, and acc / max(l, 1e-30) at the end.
// Here the K grid dimension is a loop inside the block, and the block is
// persistent: one block an SM walks work items, each a (b*h, 128-row Q
// tile), keeping m, l and the accumulator of the item in registers.  Every
// bf16 call takes this kernel but those with few query rows at hd 64 / 128
// (flash_decode.cu); f32 calls take tma_wgmma_flash_tf32x3.cu (ops.route()
// decides; a rule, not a fallback).
//
// What bounds it on an H100: at the yi-6b prefill (4 x 2048 tokens, 32
// heads of 128, GQA 4, causal) the work is 4 hd per live (q, k) pair,
// 1.4e11 FLOP, against 151 MB of q, k, v and o: far above the ~295
// FLOP/byte ridge, so it is bound by the tensor cores, 0.139 ms at the 989
// TFLOP/s of bf16 wgmma.  The port's first, mma.sync kernel reached a sixth
// of that.
//
// Below hd 64 a live pair costs 4 hd FLOP of products (64 at hd 16, 128 at
// hd 32) and one exp2, and the special-function units give 16 exp2 a clock
// an SM: 2.6e-13 s a pair at the 1830 MHz of the bf16 peak, against 6.5e-14
// / 1.3e-13 s of products.  So there the softmax's exp, not the tensor
// cores, bounds the kernel (all-MiniLM-L6-v2's attention, 64 x 512 tokens,
// 12 heads of 32: 0.0521 ms).  The design keeps one exp2 a computed score
// (scale * log2(e) folded into the FFMA before it; only diagonal, window-
// edge and ragged tiles run the mask) and a 128-key tile, whose row max
// and sum reductions are small beside its 64 exp2s a thread.  Measured on
// an H100 (PERF.md): a 256-key tile was slower at the hd-16 prefill; a
// degree-3 polynomial taking a quarter of the exps on the FMA pipe, two Q
// buffers and issuing without turns were no faster at both real shapes;
// none is kept.  Three consumer warpgroups did not build at the 256-key
// tile (512 threads hold ptxas to 128 registers a thread, and its S asks
// for 154).
//
// What this design does about it:
//
//   * both products on wgmma, Hopper's only path to the full tensor-core
//     rate: S = Q K^T as m64n128k16 with Q and K K-major in shared memory
//     (SS), O += P V as m64n{hd}k16 with P from registers (RS: the f32 S
//     accumulator, rounded to bf16 pairs, is already in the layout of
//     wgmma's A fragment) and V MN-major in shared memory;
//   * 128-row Q tiles over two consumer warpgroups of 64 rows, and K/V
//     tiles of 128 keys: each K/V element staged in shared memory feeds
//     128 query rows (the first kernel's: 64);
//   * one producer warpgroup whose single elected thread issues every TMA
//     copy (Q once an item; K and V of each tile into a ring of D stages, as
//     boxes of min(hd, 64) hd columns by 128 rows, each swizzled by its 32-,
//     64- or 128-byte row); no consumer
//     thread spends an instruction or a register on a copy, and setmaxnreg
//     moves registers from the producer (24) to the consumers (240);
//   * ping-pong: the two consumer warpgroups take turns issuing their
//     wgmma (named barriers 1 and 2: a warpgroup waits for its turn with
//     bar.sync and hands it over with bar.arrive once its products are
//     issued), so one warpgroup's softmax (exp2, max, sum on the CUDA cores)
//     runs while the other's products run on the tensor cores; and within
//     a warpgroup (D >= 2) the PV product of tile i-1 is issued together
//     with the QK^T product of tile i, so the softmax of tile i overlaps
//     it too.  The softmax uses exp2 with scale * log2(e) folded into the
//     scores; S is one register set (no second S buffer);
//   * causal tiles wholly above the frontier and tiles wholly before the
//     sliding window are skipped through the loop bounds; only the
//     diagonal, window-edge and ragged tiles run the per-element mask, and
//     a tile inside every row's live keys folds the scale into the FFMA
//     before exp2;
//   * persistent blocks: items are numbered longest causal rows first and
//     block c takes items c, c + gridDim.x, ...; the K/V ring runs on
//     across items, so the producer loads the next item's first tiles and
//     its Q while the consumers finish the last one, and no block start,
//     barrier set-up or ring fill sits between items;
//   * a 16-byte store epilogue: a quad exchanges its bf16 pairs (two
//     shuffles a 16-byte group) so each thread stores 16 contiguous bytes.
//
// bf16 P: like the reference's chunked_attention, P is rounded to bf16
// for the PV product; l is summed over the f32 P.
//
// The synchronization is the compiler's output, as in the TMA matmul.  The
// wrapper (ops.py) plans the K-loop with pipelined_matmul.ops.
// hopper_schedule(depth): plan() under HOPPER_PROCESSORS, ISSUE and LOAD
// on the producer, COMPUTE on the consumers.  It keeps exactly two
// cross-processor dependences at every depth D, and each is one mbarrier a
// ring slot:
//
//   full[s]   LOAD -> COMPUTE.  The producer arrives once with expect_tx
//             of the stage's K and V bytes (whole boxes: TMA counts the
//             zero fill past Sk as bytes too); the consumers wait on it
//             before reading slot s.
//   empty[s]  COMPUTE -> LOAD at distance D (slot reuse).  One thread of
//             each consumer warpgroup arrives (count 2) once the wgmma
//             group that read V of slot s has RETIRED (wgmma is
//             asynchronous); the producer waits on it before refilling s.
//             At D >= 2 a warpgroup holds two slots at once (V of tile i-1
//             while S of tile i is computed); at D = 1 it computes tile i
//             to the end, PV included, before it waits for tile i+1.
//
// Parity: the ring runs on across items; the i-th tile a block loads (all
// items counted) is in slot i mod D, round r = i / D; consumers wait on
// full with parity r & 1, the producer on empty with (r & 1) ^ 1, so its
// first D waits pass on the fresh barriers.  No __syncthreads sits in the
// loop.  The host entry refuses a schedule without both waits.
//
// Q is outside the K-loop plan: it is loaded once an item, into one
// buffer, with a pair of barriers of its own.  q_full (the producer's
// expect_tx of Q) is awaited once before the item's K-loop; q_empty (one
// arrival a consumer warpgroup, once the item's last QK^T has retired) is
// awaited by the producer before it loads the next item's Q, which it
// issues right after that item's first K/V tile.
//
// Tensor maps are 4-D, (hd, heads, S, B) innermost first, built from the
// tensors' own strides (ops.tensor_map computes them; strides multiples
// of 16 bytes, bases 16-byte aligned), so q, k and v are read in place and
// a ragged Sk is zero-filled at the end of its own batch, never read from
// the next.  A zero stride (a broadcast dimension) is one the maps take.
// Smem tiles are 1024-byte aligned: the swizzle that TMA applies and wgmma
// undoes repeats every 8 rows of ROW = 2 min(hd, 64) bytes (256, 512 or
// 1024 bytes).  Descriptors (hopper::swizzled_desc<ROW>): Q and K K-major,
// SBO 8 ROW (the next 8 rows), a k16 step 32 bytes along the row and the
// next 64 hd columns in the next box; V MN-major (transpose bit set), LBO
// = one box (the next 64 hd columns), SBO 8 ROW (the next 8 keys), a k16
// step 16 rows = 16 ROW bytes further.
//
// Masks are on query positions q_offset + i (the prefill continuation of
// the reference's chunked_attention) and key positions j.
//
// Epilogue: O / max(l, 1e-30) in registers, converted to bf16, stored by
// stride in 16-byte pieces (4-byte pairs at hd 16) with rows past Sq
// masked.
//
// Plain C interface, loaded with ctypes; the tensor maps are encoded on the
// host per call and passed as __grid_constant__ parameters.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int BQ = 128;           // query rows a block: two consumer warpgroups
constexpr int BK = 128;           // keys a K/V tile
constexpr int BOX = 64;           // hd columns of the widest box (128 bytes)
constexpr int THREADS = 384;      // producer + 2 consumers
constexpr int MAX_STAGES = 4;
constexpr int PRODUCER_REGS = 24;
constexpr int CONSUMER_REGS = 240;
constexpr int TURN_BAR = 1;       // named barriers 1, 2: consumer c's turn
constexpr int SMEM_PER_BLOCK = 232448;
constexpr int SMEM_BYTES_EXTRA = 1024 + 8 * (2 + 2 * MAX_STAGES);  // align, bars

static_assert(128 * PRODUCER_REGS + 256 * CONSUMER_REGS <= 65536,
              "the register split must fit the SM's file");

// The smem tiles of one hd: Q and each K / V tile as boxes of COLS =
// min(hd, 64) hd columns, a box row of ROW = 2 COLS bytes (the swizzle's
// span: 32, 64 or 128 bytes) by BQ or BK rows
template <int HD>
struct Layout {
  static constexpr int COLS = HD < BOX ? HD : BOX;
  static constexpr int ROW = 2 * COLS;
  static constexpr int BOXES = HD / COLS;
  static constexpr int KSTEPS = COLS / 16;            // k16 steps a box
  static constexpr int Q_BOX_BYTES = BQ * ROW;
  static constexpr int KV_BOX_BYTES = BK * ROW;
  static constexpr int Q_BYTES = BOXES * Q_BOX_BYTES;
  static constexpr int K_BYTES = BOXES * KV_BOX_BYTES;
  static constexpr int STAGE_BYTES = 2 * K_BYTES;    // K and V of one tile
  static constexpr int smem(int stages) {
    return Q_BYTES + stages * STAGE_BYTES + SMEM_BYTES_EXTRA;
  }
  static_assert(Q_BOX_BYTES % 1024 == 0 && KV_BOX_BYTES % 1024 == 0,
                "tiles must stay 1024-byte aligned");
};

struct Params {
  int B, H, KV, Sq, Sk;
  int n_qt;                    // Q tiles a head: ceil(Sq / BQ)
  int n_items;                 // B * H * n_qt
  long long o_sb, o_ss, o_sh;  // output strides in elements
  int causal;
  int window;                  // <= 0: none; else keys k > q - window
  int q_offset;                // the position of query row 0
  float scale_log2;            // hd**-0.5 * log2(e)
};

// One work item: a (b, h) and a 128-row Q tile, and the key tiles
// [kt_lo, kt_hi) its rows reach.  Items are numbered longest causal rows
// first (the last Q tile of every head, then the one before, ...), and
// block c takes items c, c + gridDim.x, ...
struct Item {
  int b, h, kvh, q0, kt_lo, kt_hi;
};

__device__ __forceinline__ Item item_of(const Params& p, int w) {
  const int heads = p.B * p.H;
  const int bh = w % heads;
  Item it;
  it.b = bh / p.H;
  it.h = bh % p.H;
  it.kvh = it.h / (p.H / p.KV);
  it.q0 = (p.n_qt - 1 - w / heads) * BQ;
  const int q_last = p.q_offset + min(it.q0 + BQ, p.Sq) - 1;  // a position
  int k_lo = 0, k_hi = p.Sk;
  if (p.causal) k_hi = min(k_hi, q_last + 1);
  if (p.window > 0) k_lo = max(0, p.q_offset + it.q0 - p.window + 1);
  it.kt_lo = k_lo / BK;
  it.kt_hi = k_hi > k_lo ? (k_hi + BK - 1) / BK : it.kt_lo;
  return it;
}

template <bool B>
struct Bool {
  static constexpr bool value = B;
};

// 2^x on the MUFU in one instruction (subnormal results flush to 0)
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// O += P V of 16 keys: m64n{HD}k16 RS
template <int HD>
__device__ __forceinline__ void wgmma_pv(float (&o)[HD / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t desc_v) {
  if constexpr (HD == 128)
    hopper::wgmma_m64n128k16_rs(o, a, desc_v);
  else if constexpr (HD == 64)
    hopper::wgmma_m64n64k16_rs(o, a, desc_v);
  else if constexpr (HD == 32)
    hopper::wgmma_m64n32k16_rs(o, a, desc_v);
  else
    hopper::wgmma_m64n16k16_rs(o, a, desc_v);
}

template <int HD, int STAGES>
__global__ void __launch_bounds__(THREADS, 1)
    flash_bf16_tma_kernel(const __grid_constant__ CUtensorMap map_q,
                          const __grid_constant__ CUtensorMap map_k,
                          const __grid_constant__ CUtensorMap map_v,
                          __nv_bfloat16* __restrict__ O, const Params p) {
  using L = Layout<HD>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t q_smem = (hopper::smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t ring = q_smem + L::Q_BYTES;
  const uint32_t q_full = ring + STAGES * L::STAGE_BYTES;
  const uint32_t q_empty = q_full + 8;
  const uint32_t full = q_empty + 8;  // full[s] = full + 8 s
  const uint32_t empty = full + 8 * MAX_STAGES;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    hopper::mbar_init(q_full, 1);   // the producer's expect_tx
    hopper::mbar_init(q_empty, 2);  // one per consumer warpgroup
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(full + 8 * s, 1);
      hopper::mbar_init(empty + 8 * s, 2);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {
    // ---------------------------------------------------- producer
    hopper::setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      int s = 0;
      uint32_t phase = 0;  // parity of the ring's current round
      uint32_t q_round = 0;  // Q tiles loaded so far
      for (int w = blockIdx.x; w < p.n_items; w += gridDim.x) {
        const Item it = item_of(p, w);
        for (int kt = it.kt_lo; kt < it.kt_hi; ++kt) {
          hopper::mbar_wait(empty + 8 * s, phase ^ 1);  // slot s is free
          const uint32_t bar = full + 8 * s;
          hopper::mbar_arrive_expect_tx(bar, L::STAGE_BYTES);
          const uint32_t k_dst = ring + s * L::STAGE_BYTES;
#pragma unroll
          for (int j = 0; j < L::BOXES; ++j) {
            hopper::tma_load_4d(k_dst + j * L::KV_BOX_BYTES, &map_k, bar,
                                j * L::COLS, it.kvh, kt * BK, it.b);
            hopper::tma_load_4d(k_dst + L::K_BYTES + j * L::KV_BOX_BYTES,
                                &map_v, bar, j * L::COLS, it.kvh, kt * BK, it.b);
          }
          if (kt == it.kt_lo) {
            // this item's Q, once the previous item's last QK^T has
            // retired (its first K/V tile is already on the way)
            hopper::mbar_wait(q_empty, (q_round & 1) ^ 1);
            hopper::mbar_arrive_expect_tx(q_full, L::Q_BYTES);
#pragma unroll
            for (int j = 0; j < L::BOXES; ++j)
              hopper::tma_load_4d(q_smem + j * L::Q_BOX_BYTES, &map_q, q_full,
                                  j * L::COLS, it.h, it.q0, it.b);
            ++q_round;
          }
          if (++s == STAGES) {
            s = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    // --------------------------------------------------- consumers
    hopper::setmaxnreg_inc<CONSUMER_REGS>();
    const int c = wg - 1;  // rows 64 c .. 64 c + 63 of each Q tile
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32;
    const int col0 = 2 * (lane % 4);  // within each 8-column group
    const bool signals = tid == 0;
    const uint32_t q_base = q_smem + c * 64 * L::ROW;  // this warpgroup's rows

    float o[HD / 2];
    float sc[BK / 2];           // S of one tile, then P in f32
    uint32_t pf[BK / 16][4];   // P in bf16 pairs: the A operand of PV
    float m[2], l[2];           // l: this thread's part of the row sums
    float corr[2];
    int row0 = 0, wq0 = 0;      // this thread's rows: row0, row0 + 8

    // S = Q K^T of the tile in `slot` (overwrites S)
    auto issue_qk = [&](int slot) {
      const uint32_t k_base = ring + slot * L::STAGE_BYTES;
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) hopper::fence_operand(sc[i]);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        hopper::wgmma_m64n128k16_ss(
            sc,
            hopper::swizzled_desc<L::ROW>(
                q_base + (kk / L::KSTEPS) * L::Q_BOX_BYTES + (kk % L::KSTEPS) * 32,
                16, 8 * L::ROW),
            hopper::swizzled_desc<L::ROW>(
                k_base + (kk / L::KSTEPS) * L::KV_BOX_BYTES + (kk % L::KSTEPS) * 32,
                16, 8 * L::ROW),
            kk > 0);
      hopper::wgmma_commit();
    };
    // O += P V of the tile in `slot`
    auto issue_pv = [&](int slot) {
      const uint32_t v_base = ring + slot * L::STAGE_BYTES + L::K_BYTES;
#pragma unroll
      for (int i = 0; i < HD / 2; ++i) hopper::fence_operand(o[i]);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
        for (int i = 0; i < 4; ++i) hopper::fence_operand(pf[kk][i]);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_pv<HD>(o, pf[kk],
                     hopper::swizzled_desc<L::ROW>(v_base + kk * 16 * L::ROW,
                                                   L::KV_BOX_BYTES, 8 * L::ROW));
      hopper::wgmma_commit();
    };
    auto retire_s = [&]() {
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) hopper::fence_operand(sc[i]);
    };
    auto retire_pv = [&]() {
#pragma unroll
      for (int i = 0; i < HD / 2; ++i) hopper::fence_operand(o[i]);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
        for (int i = 0; i < 4; ++i) hopper::fence_operand(pf[kk][i]);
    };
    // online softmax of tile kt: P (f32) in sc, m and l updated, corr the
    // factor the accumulator still owes.  A tile inside every row's live
    // keys (mask = Bool<false>) folds the scale into one FFMA before exp2;
    // a tile that crosses a row's edge (Bool<true>) scales first and sets
    // the masked scores to NEG_INF, as the reference does.  Row r keeps
    // keys [lo, hi): hi = min(Sk, r + 1) causal or Sk, lo = r - window + 1
    // or 0, here relative to the thread's first column.  Maxima and sums
    // run as four chains each, so the softmax's latency is short.
    auto softmax = [&](int kt, auto mask) {
      constexpr bool MASKED = decltype(mask)::value;
      if constexpr (MASKED) {
        const int k0 = kt * BK + col0;
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) sc[i] *= p.scale_log2;
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const int qp = p.q_offset + row0 + 8 * rr;
          const int hi = (p.causal ? min(p.Sk, qp + 1) : p.Sk) - k0;
          const int lo = (p.window > 0 ? qp - p.window + 1 : 0) - k0;
#pragma unroll
          for (int j = 0; j < BK / 8; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int kc = 8 * j + e;
              if (kc < lo || kc >= hi) sc[4 * j + 2 * rr + e] = NEG_INF;
            }
        }
      }
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        float mc[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) mc[i] = sc[4 * (i / 2) + 2 * rr + i % 2];
#pragma unroll
        for (int j = 2; j < BK / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            mc[2 * (j % 2) + e] = fmaxf(mc[2 * (j % 2) + e], sc[4 * j + 2 * rr + e]);
        float mx = fmaxf(fmaxf(mc[0], mc[1]), fmaxf(mc[2], mc[3]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        mx = fmaxf(m[rr], MASKED ? mx : mx * p.scale_log2);
        corr[rr] = exp2_ftz(m[rr] - mx);
        m[rr] = mx;
        float sum[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
        for (int j = 0; j < BK / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float& x = sc[4 * j + 2 * rr + e];
            x = MASKED ? exp2_ftz(x - mx) : exp2_ftz(fmaf(x, p.scale_log2, -mx));
            sum[2 * (j % 2) + e] += x;
          }
        l[rr] = l[rr] * corr[rr] + ((sum[0] + sum[1]) + (sum[2] + sum[3]));
      }
    };
    auto rescale_o = [&]() {
#pragma unroll
      for (int j = 0; j < HD / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[4 * j + e] *= corr[e / 2];
    };
    auto convert_p = [&]() {
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          pf[kk][i] = pack_bf16(sc[8 * kk + 2 * i], sc[8 * kk + 2 * i + 1]);
    };

    // warpgroup 0 takes the first turn
    const int my_turn = TURN_BAR + c, other_turn = TURN_BAR + 1 - c;
    if (c == 0) hopper::bar_arrive(my_turn, 256);

    int slot = 0;
    uint32_t phase = 0;    // parity of the ring's current round
    uint32_t q_round = 0;  // Q tiles consumed so far
    auto advance = [&]() {
      if (++slot == STAGES) {
        slot = 0;
        phase ^= 1;
      }
    };
    // S of tile kt: wait for its slot and this warpgroup's turn, issue
    // QK^T (with the PV of the previous tile when `pv`), hand the turn on
    auto start_tile = [&](bool pv, int prev) {
      hopper::mbar_wait(full + 8 * slot, phase);  // the tile is in slot
      hopper::bar_sync(my_turn, 256);
      issue_qk(slot);
      if (pv) {
        rescale_o();  // O owes the previous tile's correction
        issue_pv(prev);
      }
      hopper::bar_arrive(other_turn, 256);
    };

    for (int w = blockIdx.x; w < p.n_items; w += gridDim.x) {
      const Item it = item_of(p, w);
      row0 = it.q0 + 64 * c + 16 * warp + lane / 4;
      wq0 = p.q_offset + it.q0 + 64 * c;  // the warpgroup's first position
      const int wq_last = wq0 + 63;
      // whether tile kt crosses the live-key edge of any of this
      // warpgroup's rows: the causal diagonal, the window's far edge or
      // the end of Sk
      auto crosses = [&](int kt) {
        const int k0 = kt * BK, k_last = k0 + BK - 1;
        return k_last >= p.Sk || (p.causal && k_last > wq0) ||
               (p.window > 0 && k0 <= wq_last - p.window);
      };
      auto online_softmax = [&](int kt) {
        if (crosses(kt))
          softmax(kt, Bool<true>{});
        else
          softmax(kt, Bool<false>{});
      };
#pragma unroll
      for (int i = 0; i < HD / 2; ++i) o[i] = 0.0f;
      m[0] = m[1] = NEG_INF;
      l[0] = l[1] = 0.0f;

      if (it.kt_lo < it.kt_hi) {
        hopper::mbar_wait(q_full, q_round & 1);
        if constexpr (STAGES == 1) {
          for (int kt = it.kt_lo; kt < it.kt_hi; ++kt) {
            start_tile(false, 0);
            hopper::wgmma_wait<0>();
            retire_s();
            if (kt + 1 == it.kt_hi && signals) hopper::mbar_arrive(q_empty);
            online_softmax(kt);
            rescale_o();
            convert_p();
            issue_pv(slot);
            hopper::wgmma_wait<0>();  // the PV that read V has retired
            retire_pv();
            if (signals) hopper::mbar_arrive(empty + 8 * slot);
            advance();
          }
        } else {
          // the first tile: S and its softmax; its PV goes out with the
          // next tile's S, so a warpgroup holds two slots at a time
          start_tile(false, 0);
          hopper::wgmma_wait<0>();
          retire_s();
          if (it.kt_lo + 1 == it.kt_hi && signals) hopper::mbar_arrive(q_empty);
          online_softmax(it.kt_lo);
          convert_p();
          int prev = slot;
          advance();
          for (int kt = it.kt_lo + 1; kt < it.kt_hi; ++kt) {
            start_tile(true, prev);
            hopper::wgmma_wait<1>();  // S has retired; PV may still run
            retire_s();
            if (kt + 1 == it.kt_hi && signals) hopper::mbar_arrive(q_empty);
            online_softmax(kt);
            hopper::wgmma_wait<0>();  // the PV that read V of prev has retired
            retire_pv();
            if (signals) hopper::mbar_arrive(empty + 8 * prev);
            convert_p();
            prev = slot;
            advance();
          }
          rescale_o();
          issue_pv(prev);
          hopper::wgmma_wait<0>();
          retire_pv();
          if (signals) hopper::mbar_arrive(empty + 8 * prev);
        }
        ++q_round;
      }

      // epilogue: the row sums over the quad, O / max(l, 1e-30), bf16.
      // A quad holds 8 columns of a row in each 8-column group, 4 bytes a
      // thread; two exchanges (lanes t ^ 1, then t ^ 2) give thread t all
      // 16 bytes of group 4 m + t, stored with one 16-byte store (hd 16, two
      // groups a row: each thread's 4-byte pairs as they are).
      __nv_bfloat16* og = O + it.b * p.o_sb + it.h * p.o_sh;
      const int t = lane % 4;
      const bool odd = t & 1, upper = t & 2;
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        float sum = l[rr];
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        const float inv = 1.0f / fmaxf(sum, 1e-30f);
        const int qp = row0 + 8 * rr;
        __nv_bfloat16* row = og + static_cast<long long>(qp) * p.o_ss;
        if constexpr (HD == 16) {
          // 32 bytes a row: each thread stores its two bf16 pairs
#pragma unroll
          for (int j = 0; j < 2; ++j)
            if (qp < p.Sq)
              *reinterpret_cast<uint32_t*>(row + 8 * j + col0) =
                  pack_bf16(o[4 * j + 2 * rr] * inv, o[4 * j + 2 * rr + 1] * inv);
        }
#pragma unroll
        for (int mq = 0; mq < HD / 32; ++mq) {
          uint32_t w[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int j = 4 * mq + i;
            w[i] = pack_bf16(o[4 * j + 2 * rr] * inv, o[4 * j + 2 * rr + 1] * inv);
          }
          // lanes t, t ^ 1: 8 contiguous bytes of groups 4mq + {0, 2}
          // (even t) or 4mq + {1, 3} (odd t)
          const uint32_t r0 = __shfl_xor_sync(0xffffffffu, odd ? w[0] : w[1], 1);
          const uint32_t r1 = __shfl_xor_sync(0xffffffffu, odd ? w[2] : w[3], 1);
          const uint32_t x0 = odd ? r0 : w[0], x1 = odd ? w[1] : r0;
          const uint32_t y0 = odd ? r1 : w[2], y1 = odd ? w[3] : r1;
          // lanes t, t ^ 2: all 16 bytes of group 4mq + t
          const uint32_t s0 = __shfl_xor_sync(0xffffffffu, upper ? x0 : y0, 2);
          const uint32_t s1 = __shfl_xor_sync(0xffffffffu, upper ? x1 : y1, 2);
          const uint4 out = upper ? make_uint4(s0, s1, y0, y1) : make_uint4(x0, x1, s0, s1);
          if (qp < p.Sq)
            *reinterpret_cast<uint4*>(row + 8 * (4 * mq + t)) = out;
        }
      }
    }
  }
}

template <int HD, int STAGES>
int launch(const CUtensorMap& mq, const CUtensorMap& mk, const CUtensorMap& mv,
           void* o, const Params& p, cudaStream_t stream) {
  constexpr int smem = Layout<HD>::smem(STAGES);
  if constexpr (smem > SMEM_PER_BLOCK) {
    return static_cast<int>(cudaErrorInvalidValue);
  } else {
    static bool attr_set = false;
    if (!attr_set) {
      const cudaError_t err = cudaFuncSetAttribute(
          flash_bf16_tma_kernel<HD, STAGES>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return static_cast<int>(err);
      attr_set = true;
    }
    // persistent: one block an SM, each walking its share of the items
    int device = 0, sms = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int grid = p.n_items < sms ? p.n_items : sms;
    flash_bf16_tma_kernel<HD, STAGES><<<grid, THREADS, smem, stream>>>(
        mq, mk, mv, static_cast<__nv_bfloat16*>(o), p);
    return static_cast<int>(cudaGetLastError());
  }
}

template <int HD>
int launch_stages(int stages, const CUtensorMap& mq, const CUtensorMap& mk,
                  const CUtensorMap& mv, void* o, const Params& p,
                  cudaStream_t st) {
  switch (stages) {
    case 1: return launch<HD, 1>(mq, mk, mv, o, p, st);
    case 2: return launch<HD, 2>(mq, mk, mv, o, p, st);
    case 3: return launch<HD, 3>(mq, mk, mv, o, p, st);
    default: return launch<HD, 4>(mq, mk, mv, o, p, st);
  }
}

}  // namespace

// dims: B, H, KV, Sq, Sk, hd.  maps: for q, k and v in turn, the tensor
// map as ops.tensor_map computes it: 4 dims (hd, heads, S, B), 3 byte
// strides (heads, S, B) and the 4-element box.  o_strides: the batch,
// sequence and head strides (elements) of o.  q_offset: the position of
// query row 0.  `full` and `empty` are the plan's two waits; the kernel
// needs both.  Returns the cudaError_t of the
// launch, or -1000 - r when a tensor map could not be encoded (r: the
// CUresult, -1 without cuTensorMapEncodeTiled).
extern "C" int fa_forward_tma(const void* q, const void* k, const void* v,
                              void* o, const long long* dims,
                              const long long* maps,
                              const long long* o_strides, int causal,
                              int window, int q_offset, float scale_log2,
                              int stages, int full, int empty, void* stream) {
  const long long B = dims[0], H = dims[1], KV = dims[2], Sq = dims[3],
                  Sk = dims[4], hd = dims[5];
  if (!full || !empty || B <= 0 || H <= 0 || KV <= 0 || H % KV || Sq <= 0 ||
      Sk <= 0 || (hd != 16 && hd != 32 && hd != 64 && hd != 128) || stages < 1 ||
      stages > MAX_STAGES || B * H * ((Sq + BQ - 1) / BQ) > 0x7fffffffLL ||
      Sq > 0x3fffffffLL || Sk > 0x3fffffffLL || q_offset < -0x3fffffff ||
      q_offset > 0x3fffffff ||
      reinterpret_cast<uintptr_t>(o) % 16 != 0 || o_strides[0] % 8 ||
      o_strides[1] % 8 || o_strides[2] % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long cols = hd < BOX ? hd : BOX;
  const void* bases[3] = {q, k, v};
  const long long rows[3] = {BQ, BK, BK};
  const long long heads[3] = {H, KV, KV};
  const long long seq[3] = {Sq, Sk, Sk};
  CUtensorMap tm[3];
  for (int t = 0; t < 3; ++t) {
    const long long* m = maps + 11 * t;
    uint64_t d[4], st[3];
    uint32_t box[4];
    for (int i = 0; i < 4; ++i) d[i] = static_cast<uint64_t>(m[i]);
    for (int i = 0; i < 3; ++i) st[i] = static_cast<uint64_t>(m[4 + i]);
    for (int i = 0; i < 4; ++i) box[i] = static_cast<uint32_t>(m[7 + i]);
    // the boxes this kernel's shared-memory tiles are laid out for
    if (m[0] != hd || m[1] != heads[t] || m[2] != seq[t] || m[3] != B ||
        box[0] != cols || box[1] != 1 ||
        box[2] != rows[t] || box[3] != 1 ||
        reinterpret_cast<uintptr_t>(bases[t]) % 16 != 0 || st[0] % 16 ||
        st[1] % 16 || st[2] % 16)
      return static_cast<int>(cudaErrorInvalidValue);
    const int rc = hopper::encode_bf16_4d(&tm[t], bases[t], d, st, box);
    if (rc != 0) return -1000 - rc;
  }
  Params p;
  p.B = static_cast<int>(B);
  p.H = static_cast<int>(H);
  p.KV = static_cast<int>(KV);
  p.Sq = static_cast<int>(Sq);
  p.Sk = static_cast<int>(Sk);
  p.n_qt = static_cast<int>((Sq + BQ - 1) / BQ);
  p.n_items = static_cast<int>(B * H) * p.n_qt;
  p.o_sb = o_strides[0];
  p.o_ss = o_strides[1];
  p.o_sh = o_strides[2];
  p.causal = causal;
  p.window = window;
  p.q_offset = q_offset;
  p.scale_log2 = scale_log2;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 128: return launch_stages<128>(stages, tm[0], tm[1], tm[2], o, p, st);
    case 64: return launch_stages<64>(stages, tm[0], tm[1], tm[2], o, p, st);
    case 32: return launch_stages<32>(stages, tm[0], tm[1], tm[2], o, p, st);
    default: return launch_stages<16>(stages, tm[0], tm[1], tm[2], o, p, st);
  }
}
