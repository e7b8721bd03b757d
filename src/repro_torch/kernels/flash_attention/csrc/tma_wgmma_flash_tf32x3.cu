// f32 flash attention (forward) for Hopper (sm_90a) on the tensor cores, in
// 3xTF32: O = softmax(Q K^T * scale + mask) V over q (B, Sq, H, hd) and k,
// v (B, Sk, KV, hd) with GQA, hd 16, 32, 64 or 128, f32 operands and f32
// softmax state.
//
// Replaces, for f32 operands, the TPU kernel
// src/repro/kernels/flash_attention/kernel.py (_flash_kernel, launched by
// flash_attention_kernel through pl.pallas_call): a (B*H, Sq/BLK_Q,
// Sk/BLK_K) grid with K innermost, both products in f32
// (preferred_element_type=f32), running max m, sum l and an f32
// accumulator in VMEM scratch, rescaled by exp(m_prev - m_new), the finite
// NEG_INF = -1e30 for masked scores, and acc / max(l, 1e-30) at the end.
// Here the K grid dimension is a loop inside the block, and the block is
// persistent, as in tma_wgmma_flash.cu (the bf16 route).  Every f32 call
// takes this kernel (ops.route()), at every hd.
//
// What bounds it on an H100: at the yi-6b prefill (4 x 2048 tokens, 32
// heads of 128, GQA 4, causal) the work is 4 hd per live (q, k) pair, 1.4e11
// FLOP, against 302 MB of f32 q, k, v and o: bound by operations.  On the
// CUDA cores (67 TFLOP/s of FFMA) that is 2.05 ms, which the port's first,
// FFMA kernel reached to 39 %.  One TF32 product keeps 11 significant bits of each
// operand and misses the f32 limit (2e-5 per output row, relative L2), so
// each product is three TF32 products on the tensor cores, the small ones
// first: S = Q_lo K_hi^T + Q_hi K_lo^T + Q_hi K_hi^T and PV = P_lo V_hi +
// P_hi V_lo + P_hi V_hi, with hi = rna_tf32(x) and lo = rna_tf32(x - hi)
// (lo lo, some 2^-22 of a product, is dropped).  3 x 1.4e11 FLOP at 495
// TFLOP/s of TF32 is 0.83 ms.  What this design does about it:
//
//   * the K / V split is one pre-pass launch (split_kv_kernel): it reads k
//     and v by their strides (so KV-cache slices are read in place) and
//     writes K hi / lo as (B, KV, Sk, hd) and V^T hi / lo as (B, KV, hd,
//     Sk8), Sk8 = Sk rounded up to 8, zero-filled.  wgmma takes .tf32
//     operands K-major only (no transpose bit), and V is the B operand of
//     PV with the keys as its K dimension, so V has to be transposed
//     somewhere.  Each K / V element then feeds every Q tile of its KV head
//     (256 at the yi-6b prefill), so the pass is a few percent of the work;
//   * Q is split once an item, in shared memory: TMA lands the plain f32 Q
//     tile in the lo buffer, and each consumer thread writes hi =
//     rna_tf32(x) into the hi buffer and lo = rna_tf32(x - hi) in place.
//     Both buffers have the same 128-byte-swizzled layout, so the split is
//     elementwise and the swizzle does not matter.  A Q pre-pass would
//     write 268 MB of hi / lo at the yi-6b shape;
//   * P never leaves registers: the PV products are wgmma with A from
//     registers (RS), P_hi = rna_tf32(p) and P_lo = rna_tf32(p - P_hi).
//     The f32 accumulator gives a thread keys 2t and 2t + 1 (t = lane % 4)
//     of each 8-key group, the tf32 A fragment wants keys t and t + 4.  No
//     shuffle: the pre-pass writes V^T's keys in the order (0, 2, 4, 6, 1,
//     3, 5, 7) within each group of 8, and a = {d[4j], d[4j+2], d[4j+1],
//     d[4j+3]} is then the A fragment as it stands (PV's sum over keys is
//     unchanged by the order);
//   * promotion: Hopper's TF32 accumulator truncates (chip_smoke.py reads
//     it through the 3xTF32 matmul), so each tile's PV goes into its own
//     accumulator (scale-d 0 on its first product) and is added as O = O
//     corr + PV_tile in f32 registers: runs of BK <= 32 keys.  S sums over hd <= 128, inside the 256 of K that
//     the 3xTF32 matmul promotes at;
//   * the shape of tma_wgmma_flash.cu: one producer warpgroup whose elected
//     thread issues every TMA copy (Q once an item; K hi / lo and V^T hi /
//     lo of each tile into a ring of D stages) and gives its registers to
//     the consumers (setmaxnreg); two consumer warpgroups of 64 rows of a
//     128-row Q tile taking turns to issue their wgmma (named barriers 1
//     and 2), so one warpgroup's softmax runs while the other's products
//     run; within a warpgroup (D >= 2) the PV of tile i-1 is issued with
//     the S of tile i; persistent blocks take items longest causal rows
//     first, and the K / V ring runs on across items;
//   * the tile is set by shared memory.  Q hi + lo is 2 x 128 x hd x 4
//     bytes (128 KB at hd 128, 64 KB at hd 64); a stage of BK keys holds K
//     hi / lo and V^T hi / lo, 4 x BK x hd x 4 bytes.  At hd 128, BK = 16
//     (32 KB a stage) takes D <= 3 and BK = 32 (64 KB) only D = 1; at hd 64
//     BK = 32 (32 KB) takes D <= 4.  Each hd takes the tile with the deeper
//     ring, key_tile(hd) (ops.TF32X3_BK).  At hd 16 and 32 a stage is a
//     fraction of the budget and every depth fits, so the tile is the wider
//     BK = 64: an item takes half the tiles, and each tile's fixed cost
//     (its barrier waits, the row max and sum, the promotion) is spread
//     over twice the keys (measured on an H100, PERF.md: 0.86-0.88 of BK
//     32's time at both real shapes).  PV is m64n{hd}k8 RS with V^T's rows of BK keys
//     in one 64-byte (BK 16) or 128-byte (BK 32) swizzle span, or at BK 64
//     in two boxes of 32 keys;
//   * S is SS, Q and K K-major as loaded (boxes of min(hd, 32) columns, a
//     64- or 128-byte swizzled row), and its A operand, a 64 x 8 slice of
//     Q, is read from shared memory by every wgmma: 2 KB for 64 x BK x 8
//     multiply-adds, so by a count of bytes the products of S wait on
//     shared memory at BK 16 or 32, not on the tensor cores.  So the stage
//     holds each box's K lo rows and then its K hi rows, and a k8 step of
//     S is two wgmma, not three: Q_lo K_hi^T
//     (m64n{BK}k8) and Q_hi [K_lo | K_hi]^T (m64n{2 BK}k8, one B operand of
//     2 BK rows), which reads Q_hi once.  The three products meet in f32
//     registers, (Q_lo K_hi^T + Q_hi K_lo^T) + Q_hi K_hi^T.
//
// Masks: causal and sliding-window, on query positions q_offset + i (the
// prefill continuation of the reference's chunked_attention); key tiles
// wholly past the causal frontier or before the window are skipped through
// the loop bounds, and only tiles that cross a row's edge run the
// per-element mask.  Sk8's zero keys meet P = 0: exp2(NEG_INF - m) is 0 in
// f32 once a row has a live key.  A query row with no live key at all is
// outside the contract: the wrapper raises for it (ops._check_live_keys).
//
// The synchronization is the compiler's output, as in tma_wgmma_flash.cu.
// The wrapper (ops.py) plans the K-loop with pipelined_matmul.ops.
// hopper_schedule(depth), which keeps two cross-processor dependences at
// every depth D, each one mbarrier a ring slot:
//
//   full[s]   LOAD -> COMPUTE.  The producer arrives once with expect_tx of
//             the stage's bytes (TMA counts the zero fill as bytes too);
//             the consumers wait on it before reading slot s.
//   empty[s]  COMPUTE -> LOAD at distance D (slot reuse).  One thread of
//             each consumer warpgroup arrives (count 2) once the wgmma group
//             that read V^T of slot s has RETIRED; the producer waits on it
//             before refilling s.
//
// Parity as in tma_wgmma_flash.cu: the i-th tile a block loads (all items
// counted) is in slot i mod D, round r = i / D; consumers wait on full with
// parity r & 1, the producer on empty with (r & 1) ^ 1.  The host entry
// refuses a schedule without both waits.
//
// Q is outside the K-loop plan, with a pair of barriers of its own: q_full
// (the producer's expect_tx of Q) is awaited before the split; q_empty (one
// arrival a consumer warpgroup once the item's last S has retired, which
// also covers its split) is awaited by the producer before it loads the
// next item's Q.  After the split each thread fences its shared-memory
// writes for the async proxy (fence.proxy.async) and the warpgroup meets at
// a named barrier (3 or 4) before its first wgmma reads them.
//
// Tensor maps: Q's is 4-D, (hd, H, Sq, B), from q's own strides (ops.
// tensor_map; a box past Sq is zero-filled inside its own batch); the split
// arrays' are 4-D too, (hd, Sk, KV, B) and (Sk8, hd, KV, B), encoded here.
//
// Plain C interface, loaded with ctypes; the tensor maps are encoded on the
// host per call and passed as __grid_constant__ parameters.  One host call
// (fa_forward_tf32x3) launches both the pre-pass and the product: at a
// short ragged shape the host's enqueue, not the device, sets the time.

#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int BQ = 128;           // query rows a block: two consumer warpgroups
constexpr int BOX = 32;           // hd columns of the widest box (128 bytes)
constexpr int THREADS = 384;      // producer + 2 consumers
constexpr int MAX_STAGES = 4;
constexpr int PRODUCER_REGS = 24;
constexpr int CONSUMER_REGS = 240;
constexpr int TURN_BAR = 1;       // named barriers 1, 2: consumer c's turn
constexpr int SPLIT_BAR = 3;      // named barriers 3, 4: consumer c's Q split
constexpr int SMEM_PER_BLOCK = 232448;
constexpr int SMEM_BYTES_EXTRA = 1024 + 8 * (2 + 2 * MAX_STAGES);  // align, bars
constexpr int SPLIT_THREADS = 256;
constexpr int SPLIT_KEYS = 32;    // keys a pre-pass block

static_assert(128 * PRODUCER_REGS + 256 * CONSUMER_REGS <= 65536,
              "the register split must fit the SM's file");

// The keys of a stage at each hd: the tile whose ring is the deeper in
// SMEM_PER_BLOCK (BK 16, D <= 3 at hd 128; BK 32, D <= 4 at hd 64), and at
// hd 16 and 32, where every depth fits, the wider BK 64 (a V^T row of two
// 128-byte swizzle spans, two boxes), which halves the tiles an item takes
constexpr int key_tile(int hd) { return hd == 128 ? 16 : hd == 64 ? 32 : 64; }

// Q and K as boxes of COLS = min(hd, 32) hd columns, a box row of ROW = 4
// COLS bytes (the swizzle's span: 64 or 128 bytes)
template <int HD, int BK>
struct Layout {
  static constexpr int COLS = HD < BOX ? HD : BOX;
  static constexpr int ROW = 4 * COLS;
  static constexpr int BOXES = HD / COLS;
  static constexpr int KSTEPS = COLS / 8;              // k8 steps a box
  static constexpr int Q_BOX_BYTES = BQ * ROW;
  static constexpr int Q_BYTES = BOXES * Q_BOX_BYTES;  // one of Q hi, Q lo
  static constexpr int K_BOX_BYTES = BK * ROW;         // BK rows
  // K lo and then K hi of one 32-column box: the 2 BK rows of Q_hi's B
  static constexpr int KK_BOX_BYTES = 2 * K_BOX_BYTES;
  static constexpr int K_BYTES = BOXES * K_BOX_BYTES;  // one of K hi, K lo
  // V^T as boxes of HD rows by V_KEYS keys, a row of V_SPAN bytes (its
  // swizzle: 64 bytes at BK 16, else 128)
  static constexpr int V_KEYS = BK < 32 ? BK : 32;
  static constexpr int V_SPAN = 4 * V_KEYS;
  static constexpr int V_BOXES = BK / V_KEYS;
  static constexpr int V_BOX_BYTES = HD * V_SPAN;
  static constexpr int V_BYTES = V_BOXES * V_BOX_BYTES;  // one of V^T hi, lo
  static constexpr int STAGE_BYTES = 2 * K_BYTES + 2 * V_BYTES;
  static constexpr int smem(int stages) {
    return 2 * Q_BYTES + stages * STAGE_BYTES + SMEM_BYTES_EXTRA;
  }
  static_assert(BK == 16 || BK == 32 || BK == 64,
                "a V^T row is a 64-byte swizzle span or 128-byte ones");
  static_assert(K_BOX_BYTES % 1024 == 0 && V_BOX_BYTES % 1024 == 0,
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

// One work item: a (b, h) and a 128-row Q tile, and the key tiles [kt_lo,
// kt_hi) its rows reach.  Items are numbered longest causal rows first.
struct Item {
  int b, h, kvh, q0, kt_lo, kt_hi;
};

template <int BK>
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

// S's products: wgmma m64n{N}k8 tf32 SS, N = BK or 2 BK
template <int N>
__device__ __forceinline__ void wgmma_s(float (&d)[N / 2], uint64_t desc_a,
                                        uint64_t desc_b, int scale_d) {
  if constexpr (N == 16)
    hopper::wgmma_m64n16k8_tf32_ss(d, desc_a, desc_b, scale_d);
  else if constexpr (N == 32)
    hopper::wgmma_m64n32k8_tf32_ss(d, desc_a, desc_b, scale_d);
  else if constexpr (N == 64)
    hopper::wgmma_m64n64k8_tf32_ss(d, desc_a, desc_b, scale_d);
  else
    hopper::wgmma_m64n128k8_tf32_ss(d, desc_a, desc_b, scale_d);
}

template <int HD>
__device__ __forceinline__ void wgmma_pv(float (&d)[HD / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t desc_b, int scale_d) {
  if constexpr (HD == 128)
    hopper::wgmma_m64n128k8_tf32_rs(d, a, desc_b, scale_d);
  else if constexpr (HD == 64)
    hopper::wgmma_m64n64k8_tf32_rs(d, a, desc_b, scale_d);
  else if constexpr (HD == 32)
    hopper::wgmma_m64n32k8_tf32_rs(d, a, desc_b, scale_d);
  else
    hopper::wgmma_m64n16k8_tf32_rs(d, a, desc_b, scale_d);
}

// The descriptor of k8 step j of V^T from base: the step's 32 bytes of a
// box's rows (HD rows of V_SPAN bytes, 8 rows every 8 V_SPAN bytes)
template <int HD, int BK>
__device__ __forceinline__ uint64_t v_desc(uint32_t base, int j) {
  using L = Layout<HD, BK>;
  constexpr int STEPS = L::V_KEYS / 8;  // k8 steps a box
  const uint32_t addr = base + (j / STEPS) * L::V_BOX_BYTES + (j % STEPS) * 32;
  if constexpr (L::V_SPAN == 64)
    return hopper::sw64_desc(addr, 16, 8 * 64);
  else
    return hopper::sw128_desc(addr, 16, 8 * 128);
}

template <int HD, int BK, int STAGES>
__global__ void __launch_bounds__(THREADS, 1)
    flash_tf32x3_kernel(const __grid_constant__ CUtensorMap map_q,
                        const __grid_constant__ CUtensorMap map_k_hi,
                        const __grid_constant__ CUtensorMap map_k_lo,
                        const __grid_constant__ CUtensorMap map_vt_hi,
                        const __grid_constant__ CUtensorMap map_vt_lo,
                        float* __restrict__ O, const Params p) {
  using L = Layout<HD, BK>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = hopper::smem_u32(smem_raw);
  const uint32_t q_lo = (raw + 1023) & ~1023u;  // TMA lands Q here
  const uint32_t q_hi = q_lo + L::Q_BYTES;
  const uint32_t ring = q_hi + L::Q_BYTES;
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
      uint32_t phase = 0;    // parity of the ring's current round
      uint32_t q_round = 0;  // Q tiles loaded so far
      for (int w = blockIdx.x; w < p.n_items; w += gridDim.x) {
        const Item it = item_of<BK>(p, w);
        for (int kt = it.kt_lo; kt < it.kt_hi; ++kt) {
          hopper::mbar_wait(empty + 8 * s, phase ^ 1);  // slot s is free
          const uint32_t bar = full + 8 * s;
          hopper::mbar_arrive_expect_tx(bar, L::STAGE_BYTES);
          const uint32_t k_dst = ring + s * L::STAGE_BYTES;
#pragma unroll
          for (int j = 0; j < L::BOXES; ++j) {
            const uint32_t box = k_dst + j * L::KK_BOX_BYTES;
            hopper::tma_load_4d(box, &map_k_lo, bar, j * L::COLS, kt * BK, it.kvh, it.b);
            hopper::tma_load_4d(box + L::K_BOX_BYTES, &map_k_hi, bar, j * L::COLS,
                                kt * BK, it.kvh, it.b);
          }
          const uint32_t v_dst = k_dst + 2 * L::K_BYTES;
#pragma unroll
          for (int j = 0; j < L::V_BOXES; ++j) {
            const int key = kt * BK + j * L::V_KEYS;
            hopper::tma_load_4d(v_dst + j * L::V_BOX_BYTES, &map_vt_hi, bar, key, 0,
                                it.kvh, it.b);
            hopper::tma_load_4d(v_dst + L::V_BYTES + j * L::V_BOX_BYTES, &map_vt_lo, bar,
                                key, 0, it.kvh, it.b);
          }
          if (kt == it.kt_lo) {
            // this item's Q, once the previous item's last S has retired
            // (its first K/V tile is already on the way)
            hopper::mbar_wait(q_empty, (q_round & 1) ^ 1);
            hopper::mbar_arrive_expect_tx(q_full, L::Q_BYTES);
#pragma unroll
            for (int j = 0; j < L::BOXES; ++j)
              hopper::tma_load_4d(q_lo + j * L::Q_BOX_BYTES, &map_q, q_full,
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
    // this warpgroup's 64 rows of each 128-row box of Q
    const uint32_t my_q_lo = q_lo + c * 64 * L::ROW;
    const uint32_t my_q_hi = q_hi + c * 64 * L::ROW;

    float o[HD / 2];           // the output: O corr + PV of each tile
    float pv[HD / 2];          // PV of one tile (a wgmma accumulator)
    float s_lo[BK / 2];        // Q_lo K_hi^T of one tile (a wgmma accumulator)
    float s_hi[BK];            // Q_hi [K_lo | K_hi]^T of one tile (another)
    float sc[BK / 2];          // S of one tile, then P in f32
    uint32_t ph[BK / 8][4];    // P hi, lo: the A operands of PV
    uint32_t pl[BK / 8][4];
    float m[2], l[2];          // l: this thread's part of the row sums
    float corr[2];             // the factor O owes for this tile's max
    float corr_pv[2];          // ... and for the tile whose PV is in flight
    int row0 = 0;              // this thread's rows: row0, row0 + 8

    // The three products of S = Q_lo K_hi^T + Q_hi K_lo^T + Q_hi K_hi^T of
    // the tile in `slot` as two wgmma a k8 step: Q_lo K_hi^T (N = BK) and
    // Q_hi [K_lo | K_hi]^T (N = 2 BK: the stage holds each box's K lo rows
    // and then its K hi rows, one B operand), so Q_hi, the A operand read
    // from shared memory, is read once a step and not twice
    auto issue_s = [&](int slot) {
      const uint32_t kk = ring + slot * L::STAGE_BYTES;
      // Q's bases, opaque to the compiler at each tile: its 2 x hd / 8
      // descriptors are the same for every tile of an item, and hoisted out
      // of the K-loop they would hold 4 x hd / 8 registers for good
      uint32_t q_lo_s = my_q_lo, q_hi_s = my_q_hi;
      asm volatile("" : "+r"(q_lo_s), "+r"(q_hi_s));
      auto desc = [&](uint32_t base, int box_bytes, int k8) {
        return hopper::swizzled_desc<L::ROW>(
            base + (k8 / L::KSTEPS) * box_bytes + (k8 % L::KSTEPS) * 32, 16, 8 * L::ROW);
      };
      // the first product of each overwrites its accumulator; the stores
      // end the registers' lives from the sum of the last tile to here
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) s_lo[i] = 0.0f;
#pragma unroll
      for (int i = 0; i < BK; ++i) s_hi[i] = 0.0f;
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) hopper::fence_operand(s_lo[i]);
#pragma unroll
      for (int i = 0; i < BK; ++i) hopper::fence_operand(s_hi[i]);
      hopper::wgmma_fence();
#pragma unroll
      for (int k8 = 0; k8 < HD / 8; ++k8) {
        wgmma_s<BK>(s_lo, desc(q_lo_s, L::Q_BOX_BYTES, k8),
                    desc(kk + L::K_BOX_BYTES, L::KK_BOX_BYTES, k8), k8 > 0);
        wgmma_s<2 * BK>(s_hi, desc(q_hi_s, L::Q_BOX_BYTES, k8),
                        desc(kk, L::KK_BOX_BYTES, k8), k8 > 0);
      }
      hopper::wgmma_commit();
    };
    // PV = P_lo V_hi + P_hi V_lo + P_hi V_hi of the tile in `slot`, into its
    // own accumulator
    auto issue_pv = [&](int slot) {
      const uint32_t v_hi = ring + slot * L::STAGE_BYTES + 2 * L::K_BYTES;
      const uint32_t v_lo = v_hi + L::V_BYTES;
      // the first product overwrites pv; the stores end its registers'
      // lives from the last tile's promotion to here
#pragma unroll
      for (int i = 0; i < HD / 2; ++i) pv[i] = 0.0f;
#pragma unroll
      for (int i = 0; i < HD / 2; ++i) hopper::fence_operand(pv[i]);
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          hopper::fence_operand(ph[j][i]);
          hopper::fence_operand(pl[j][i]);
        }
      hopper::wgmma_fence();
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        wgmma_pv<HD>(pv, pl[j], v_desc<HD, BK>(v_hi, j), j > 0);
        wgmma_pv<HD>(pv, ph[j], v_desc<HD, BK>(v_lo, j), 1);
      }
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
        wgmma_pv<HD>(pv, ph[j], v_desc<HD, BK>(v_hi, j), 1);
      hopper::wgmma_commit();
    };
    // once S has retired: S = (Q_lo K_hi^T + Q_hi K_lo^T) + Q_hi K_hi^T in
    // f32, the small products first (columns BK .. 2 BK of s_hi are the
    // same keys as 0 .. BK, 4 (BK / 8) accumulator registers further)
    auto retire_s = [&]() {
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) hopper::fence_operand(s_lo[i]);
#pragma unroll
      for (int i = 0; i < BK; ++i) hopper::fence_operand(s_hi[i]);
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) sc[i] = (s_lo[i] + s_hi[i]) + s_hi[i + BK / 2];
    };
    // once the PV in flight has retired: O = O corr + PV, in f32 (the
    // promotion), and its A operands are free again
    auto retire_pv = [&]() {
#pragma unroll
      for (int i = 0; i < HD / 2; ++i) hopper::fence_operand(pv[i]);
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          hopper::fence_operand(ph[j][i]);
          hopper::fence_operand(pl[j][i]);
        }
#pragma unroll
      for (int j = 0; j < HD / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          o[4 * j + e] = fmaf(o[4 * j + e], corr_pv[e / 2], pv[4 * j + e]);
    };
    // online softmax of tile kt: P (f32) in sc, m and l updated, corr the
    // factor O owes.  A tile inside every row's live keys (Bool<false>)
    // folds the scale into one FFMA before exp2; a tile that crosses a
    // row's edge (Bool<true>) scales first and sets the masked scores to
    // NEG_INF, as the reference does.  Row position r keeps keys [lo, hi):
    // hi = min(Sk, r + 1) causal or Sk, lo = r - window + 1 or 0, here
    // relative to the thread's first column.
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
    // P in sc -> the A fragments of PV, hi and lo: the accumulator's keys
    // (2t, 2t + 1) become k-positions (t, t + 4) of each 8-key step, which
    // V^T's key order (0, 2, 4, 6, 1, 3, 5, 7) matches
    auto convert_p = [&]() {
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        const float x[4] = {sc[4 * j], sc[4 * j + 2], sc[4 * j + 1], sc[4 * j + 3]};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float h = hopper::rna_tf32(x[i]);
          ph[j][i] = __float_as_uint(h);
          pl[j][i] = __float_as_uint(hopper::rna_tf32(x[i] - h));
        }
      }
      corr_pv[0] = corr[0];
      corr_pv[1] = corr[1];
    };
    // this warpgroup's 64 rows of Q: lo holds x as TMA landed it; write hi =
    // rna_tf32(x) and lo = rna_tf32(x - hi) in place, then hand both to the
    // async proxy
    auto split_q = [&]() {
#pragma unroll
      for (int bx = 0; bx < L::BOXES; ++bx) {
        float4* lo4 = reinterpret_cast<float4*>(
            smem_raw + (my_q_lo + bx * L::Q_BOX_BYTES - raw));
        float4* hi4 = reinterpret_cast<float4*>(
            smem_raw + (my_q_hi + bx * L::Q_BOX_BYTES - raw));
#pragma unroll
        for (int i = tid; i < 64 * L::COLS / 4; i += 128) {
          const float4 x = lo4[i];
          float4 h, r;
          h.x = hopper::rna_tf32(x.x);
          h.y = hopper::rna_tf32(x.y);
          h.z = hopper::rna_tf32(x.z);
          h.w = hopper::rna_tf32(x.w);
          r.x = hopper::rna_tf32(x.x - h.x);
          r.y = hopper::rna_tf32(x.y - h.y);
          r.z = hopper::rna_tf32(x.z - h.z);
          r.w = hopper::rna_tf32(x.w - h.w);
          hi4[i] = h;
          lo4[i] = r;
        }
      }
      hopper::fence_proxy_async_shared();
      hopper::bar_sync(SPLIT_BAR + c, 128);
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
    // S of the tile in `slot`: wait for it and this warpgroup's turn, issue
    // S (with the PV of the previous tile when `pv`), hand the turn on
    auto start_tile = [&](bool with_pv, int prev) {
      hopper::mbar_wait(full + 8 * slot, phase);  // the tile is in slot
      hopper::bar_sync(my_turn, 256);
      issue_s(slot);
      if (with_pv) issue_pv(prev);
      hopper::bar_arrive(other_turn, 256);
    };

    for (int w = blockIdx.x; w < p.n_items; w += gridDim.x) {
      const Item it = item_of<BK>(p, w);
      const int wq0 = p.q_offset + it.q0 + 64 * c;  // first row's position
      const int wq_last = wq0 + 63;
      row0 = it.q0 + 64 * c + 16 * warp + lane / 4;
      // whether tile kt crosses the live-key edge of any of this
      // warpgroup's rows: the causal diagonal, the window's far edge or the
      // end of Sk
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
        split_q();
        if constexpr (STAGES == 1) {
          for (int kt = it.kt_lo; kt < it.kt_hi; ++kt) {
            start_tile(false, 0);
            hopper::wgmma_wait<0>();
            retire_s();
            if (kt + 1 == it.kt_hi && signals) hopper::mbar_arrive(q_empty);
            online_softmax(kt);
            convert_p();
            issue_pv(slot);
            hopper::wgmma_wait<0>();  // the PV that read V^T has retired
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
            hopper::wgmma_wait<0>();  // the PV that read V^T of prev has retired
            retire_pv();
            if (signals) hopper::mbar_arrive(empty + 8 * prev);
            convert_p();
            prev = slot;
            advance();
          }
          issue_pv(prev);
          hopper::wgmma_wait<0>();
          retire_pv();
          if (signals) hopper::mbar_arrive(empty + 8 * prev);
        }
        ++q_round;
      }

      // epilogue: the row sums over the quad, O / max(l, 1e-30), stored by
      // stride as f32 pairs, rows past Sq masked
      float* og = O + it.b * p.o_sb + it.h * p.o_sh;
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        float sum = l[rr];
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        const float inv = 1.0f / fmaxf(sum, 1e-30f);
        const int qr = row0 + 8 * rr;
        if (qr >= p.Sq) continue;
        float* row = og + static_cast<long long>(qr) * p.o_ss;
#pragma unroll
        for (int j = 0; j < HD / 8; ++j)
          *reinterpret_cast<float2*>(row + 8 * j + col0) =
              make_float2(o[4 * j + 2 * rr] * inv, o[4 * j + 2 * rr + 1] * inv);
      }
    }
  }
}

// --------------------------------------------------------------------- //
// The K / V split pre-pass
// --------------------------------------------------------------------- //

__device__ __forceinline__ float4 split_hi(const float4 x) {
  return make_float4(hopper::rna_tf32(x.x), hopper::rna_tf32(x.y),
                     hopper::rna_tf32(x.z), hopper::rna_tf32(x.w));
}

__device__ __forceinline__ float4 split_lo(const float4 x, const float4 h) {
  return make_float4(hopper::rna_tf32(x.x - h.x), hopper::rna_tf32(x.y - h.y),
                     hopper::rna_tf32(x.z - h.z), hopper::rna_tf32(x.w - h.w));
}

// k-position p of an 8-key step of V^T holds key KEY_ORDER(p) of its group:
// (0, 2, 4, 6, 1, 3, 5, 7), the tf32 A fragment's view of the accumulator
__device__ __forceinline__ int key_order(int p) {
  return p < 4 ? 2 * p : 2 * (p - 4) + 1;
}

struct SplitParams {
  int KV, Sk, Sk8, hd;
  long long k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;  // elements
};

// Block (x, y): keys [32 x, 32 x + 32) of KV head y % KV of batch y / KV.
// K: hi and lo of each 16-byte piece, in place of layout (B, KV, Sk, hd).
// V: a 32-key x 32-column tile through shared memory (row stride 33; at hd
// 16 its first 16 columns), then written transposed as (B, KV, hd, Sk8)
// with the key order above; keys from Sk to Sk8 are zeros.
__global__ void __launch_bounds__(SPLIT_THREADS)
    split_kv_kernel(const float* __restrict__ k, const float* __restrict__ v,
                    float* __restrict__ k_hi, float* __restrict__ k_lo,
                    float* __restrict__ vt_hi, float* __restrict__ vt_lo,
                    const SplitParams sp) {
  __shared__ float tile[SPLIT_KEYS][SPLIT_KEYS + 1];
  const int b = blockIdx.y / sp.KV, kvh = blockIdx.y % sp.KV;
  const int key0 = blockIdx.x * SPLIT_KEYS;
  const int per_row = sp.hd / 4;
  const float* kg = k + b * sp.k_sb + kvh * sp.k_sh;
  const size_t k_base = static_cast<size_t>(blockIdx.y) * sp.Sk * sp.hd;
  for (int i = threadIdx.x; i < SPLIT_KEYS * per_row; i += SPLIT_THREADS) {
    const int key = key0 + i / per_row, col = 4 * (i % per_row);
    if (key >= sp.Sk) continue;
    const float4 x = *reinterpret_cast<const float4*>(kg + key * sp.k_ss + col);
    const float4 h = split_hi(x);
    const size_t at = k_base + static_cast<size_t>(key) * sp.hd + col;
    *reinterpret_cast<float4*>(k_hi + at) = h;
    *reinterpret_cast<float4*>(k_lo + at) = split_lo(x, h);
  }

  const float* vg = v + b * sp.v_sb + kvh * sp.v_sh;
  const size_t v_base = static_cast<size_t>(blockIdx.y) * sp.hd * sp.Sk8;
  for (int d0 = 0; d0 < sp.hd; d0 += SPLIT_KEYS) {
    {
      const int r = threadIdx.x / 8, c = 4 * (threadIdx.x % 8);
      float4 x = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (key0 + r < sp.Sk && d0 + c < sp.hd)
        x = *reinterpret_cast<const float4*>(vg + (key0 + r) * sp.v_ss + d0 + c);
      tile[r][c] = x.x;
      tile[r][c + 1] = x.y;
      tile[r][c + 2] = x.z;
      tile[r][c + 3] = x.w;
    }
    __syncthreads();
    {
      // row d0 + d of V^T, k-positions q .. q + 3 of this block's 32 keys
      const int d = threadIdx.x / 8, q = 4 * (threadIdx.x % 8);
      const int g = q & ~7, p0 = q & 7;
      if (key0 + q < sp.Sk8 && d0 + d < sp.hd) {
        const float4 x = make_float4(
            tile[g + key_order(p0)][d], tile[g + key_order(p0 + 1)][d],
            tile[g + key_order(p0 + 2)][d], tile[g + key_order(p0 + 3)][d]);
        const float4 h = split_hi(x);
        const size_t at =
            v_base + static_cast<size_t>(d0 + d) * sp.Sk8 + key0 + q;
        *reinterpret_cast<float4*>(vt_hi + at) = h;
        *reinterpret_cast<float4*>(vt_lo + at) = split_lo(x, h);
      }
    }
    __syncthreads();
  }
}

// --------------------------------------------------------------------- //
// Host side
// --------------------------------------------------------------------- //

struct Maps {
  CUtensorMap q, k_hi, k_lo, vt_hi, vt_lo;
};

template <int HD, int BK, int STAGES>
int launch(const Maps& maps, void* o, const Params& p, cudaStream_t stream) {
  constexpr int smem = Layout<HD, BK>::smem(STAGES);
  if constexpr (smem > SMEM_PER_BLOCK) {
    return static_cast<int>(cudaErrorInvalidValue);
  } else {
    static bool attr_set = false;
    if (!attr_set) {
      const cudaError_t err = cudaFuncSetAttribute(
          flash_tf32x3_kernel<HD, BK, STAGES>,
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
    flash_tf32x3_kernel<HD, BK, STAGES><<<grid, THREADS, smem, stream>>>(
        maps.q, maps.k_hi, maps.k_lo, maps.vt_hi, maps.vt_lo,
        static_cast<float*>(o), p);
    return static_cast<int>(cudaGetLastError());
  }
}

template <int HD, int BK>
int launch_stages(int stages, const Maps& maps, void* o, const Params& p,
                  cudaStream_t st) {
  switch (stages) {
    case 1: return launch<HD, BK, 1>(maps, o, p, st);
    case 2: return launch<HD, BK, 2>(maps, o, p, st);
    case 3: return launch<HD, BK, 3>(maps, o, p, st);
    default: return launch<HD, BK, 4>(maps, o, p, st);
  }
}

bool aligned16(const void* ptr) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
}

long long round8(long long n) { return (n + 7) / 8 * 8; }

// The split pre-pass of one call: its parameters, grid and the four
// outputs, laid one after the other in one workspace of 2 (n_k + n_v)
// floats (n_k = B KV Sk hd, n_v = B KV hd Sk8; each a multiple of 64, so
// every output stays 256-byte aligned).
struct Split {
  const float* k;
  const float* v;
  float *k_hi, *k_lo, *vt_hi, *vt_lo;
  SplitParams sp;
  dim3 grid;
};

// dims: B, Sk, KV, hd; strides: k's and v's batch, sequence and head
// strides (elements).  cudaErrorInvalidValue for what the pass cannot read.
int split_plan(const void* k, const void* v, void* ws, const long long* dims,
               const long long* strides, Split* s) {
  const long long B = dims[0], Sk = dims[1], KV = dims[2], hd = dims[3];
  if (B <= 0 || Sk <= 0 || KV <= 0 || (hd != 16 && hd != 32 && hd != 64 && hd != 128) ||
      B * KV > 65535 || Sk > 0x7fffffffLL - 8 || !aligned16(k) ||
      !aligned16(v) || !aligned16(ws))
    return static_cast<int>(cudaErrorInvalidValue);
  for (int i = 0; i < 6; ++i)
    if (strides[i] < 0 || strides[i] % 4) return static_cast<int>(cudaErrorInvalidValue);
  const long long n_k = B * KV * Sk * hd, n_v = B * KV * hd * round8(Sk);
  s->k = static_cast<const float*>(k);
  s->v = static_cast<const float*>(v);
  s->k_hi = static_cast<float*>(ws);
  s->k_lo = s->k_hi + n_k;
  s->vt_hi = s->k_lo + n_k;
  s->vt_lo = s->vt_hi + n_v;
  s->sp.KV = static_cast<int>(KV);
  s->sp.Sk = static_cast<int>(Sk);
  s->sp.Sk8 = static_cast<int>(round8(Sk));
  s->sp.hd = static_cast<int>(hd);
  s->sp.k_sb = strides[0];
  s->sp.k_ss = strides[1];
  s->sp.k_sh = strides[2];
  s->sp.v_sb = strides[3];
  s->sp.v_ss = strides[4];
  s->sp.v_sh = strides[5];
  s->grid = dim3((s->sp.Sk8 + SPLIT_KEYS - 1) / SPLIT_KEYS, static_cast<unsigned>(B * KV));
  return 0;
}

int split_launch(const Split& s, cudaStream_t stream) {
  split_kv_kernel<<<s.grid, SPLIT_THREADS, 0, stream>>>(
      s.k, s.v, s.k_hi, s.k_lo, s.vt_hi, s.vt_lo, s.sp);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The pre-pass alone: k and v (B, Sk, KV, hd), read by their batch,
// sequence and head strides (elements; multiples of 4, bases 16-byte
// aligned), into the workspace ws as k_hi, k_lo (B, KV, Sk, hd) and vt_hi,
// vt_lo (B, KV, hd, Sk8) with V^T's keys in the order (0, 2, 4, 6, 1, 3,
// 5, 7) within each group of 8.  dims: B, Sk, KV, hd.  Returns the
// cudaError_t of the launch.
extern "C" int fa_split_kv_tf32(const void* k, const void* v, void* ws,
                                const long long* dims,
                                const long long* strides, void* stream) {
  Split s;
  const int rc = split_plan(k, v, ws, dims, strides, &s);
  return rc != 0 ? rc : split_launch(s, static_cast<cudaStream_t>(stream));
}

// One f32 call: the pre-pass of k and v into ws (as fa_split_kv_tf32), then
// the product from it and q, two launches on one stream; nothing is
// launched unless every argument checks out and every tensor map encodes.
// dims: B, H, KV, Sq, Sk, hd.  q_map: q's
// tensor map as ops.tensor_map computes it: 4 dims (hd, H, Sq, B), 3 byte
// strides (head, seq, batch) and the box (32, 1, 128, 1).  kv_strides: k's
// and v's batch, sequence and head strides; o_strides: o's (elements).
// stages: the ring depth of key_tile(hd)-key stages; `full` and `empty`
// are the plan's two waits, and the kernel needs both.  Returns the
// cudaError_t of the first launch that fails, or -1000 - r when a tensor
// map could not be encoded (r: the CUresult, -1 without
// cuTensorMapEncodeTiled).
extern "C" int fa_forward_tf32x3(const void* q, const void* k, const void* v,
                                 void* ws, void* o, const long long* dims,
                                 const long long* q_map,
                                 const long long* kv_strides,
                                 const long long* o_strides, int causal,
                                 int window, int q_offset, float scale_log2,
                                 int stages, int full, int empty,
                                 void* stream) {
  const long long B = dims[0], H = dims[1], KV = dims[2], Sq = dims[3],
                  Sk = dims[4], hd = dims[5];
  if (!full || !empty || B <= 0 || H <= 0 || KV <= 0 || H % KV || Sq <= 0 ||
      Sk <= 0 || (hd != 16 && hd != 32 && hd != 64 && hd != 128) || stages < 1 ||
      stages > MAX_STAGES ||
      B * H * ((Sq + BQ - 1) / BQ) > 0x7fffffffLL || Sq > 0x3fffffffLL ||
      Sk > 0x3fffffffLL || q_offset < -0x3fffffff || q_offset > 0x3fffffff ||
      reinterpret_cast<uintptr_t>(o) % 8 != 0 || o_strides[0] % 2 ||
      o_strides[1] % 2 || o_strides[2] % 2 || !aligned16(q))
    return static_cast<int>(cudaErrorInvalidValue);
  Split pre;
  {
    const long long split_dims[4] = {B, Sk, KV, hd};
    const int rc = split_plan(k, v, ws, split_dims, kv_strides, &pre);
    if (rc != 0) return rc;
  }
  // the box this kernel's Q tile is laid out for
  const long long* m = q_map;
  const uint32_t cols = static_cast<uint32_t>(hd < BOX ? hd : BOX);
  if (m[0] != hd || m[1] != H || m[2] != Sq || m[3] != B || m[4] < 0 || m[4] % 16 ||
      m[5] < 0 || m[5] % 16 || m[6] < 0 || m[6] % 16 || m[7] != cols || m[8] != 1 ||
      m[9] != BQ || m[10] != 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Maps maps;
  {
    const uint64_t d[4] = {static_cast<uint64_t>(m[0]), static_cast<uint64_t>(m[1]),
                           static_cast<uint64_t>(m[2]), static_cast<uint64_t>(m[3])};
    const uint64_t st[3] = {static_cast<uint64_t>(m[4]), static_cast<uint64_t>(m[5]),
                            static_cast<uint64_t>(m[6])};
    const uint32_t box[4] = {cols, 1, BQ, 1};
    const int rc = hopper::encode_4d(&maps.q, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, q,
                                     d, st, box, hopper::swizzle_for_row(4 * cols));
    if (rc != 0) return -1000 - rc;
  }
  const int bk = key_tile(static_cast<int>(hd));
  const uint64_t sk8 = static_cast<uint64_t>(round8(Sk));
  const uint64_t k_dims[4] = {static_cast<uint64_t>(hd), static_cast<uint64_t>(Sk),
                              static_cast<uint64_t>(KV), static_cast<uint64_t>(B)};
  const uint64_t k_st[3] = {static_cast<uint64_t>(hd) * 4,
                            static_cast<uint64_t>(Sk * hd) * 4,
                            static_cast<uint64_t>(KV * Sk * hd) * 4};
  const uint32_t k_box[4] = {cols, static_cast<uint32_t>(bk), 1, 1};
  const CUtensorMapSwizzle k_swizzle = hopper::swizzle_for_row(4 * cols);
  const uint64_t v_dims[4] = {sk8, static_cast<uint64_t>(hd),
                              static_cast<uint64_t>(KV), static_cast<uint64_t>(B)};
  const uint64_t v_st[3] = {sk8 * 4, sk8 * hd * 4, sk8 * hd * KV * 4};
  const uint32_t v_box[4] = {static_cast<uint32_t>(bk < 32 ? bk : 32),
                             static_cast<uint32_t>(hd), 1, 1};
  const CUtensorMapSwizzle v_swizzle =
      bk == 16 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B;
  const struct {
    CUtensorMap* map;
    const void* base;
    const uint64_t* dims;
    const uint64_t* strides;
    const uint32_t* box;
    CUtensorMapSwizzle swizzle;
  } split[4] = {
      {&maps.k_hi, pre.k_hi, k_dims, k_st, k_box, k_swizzle},
      {&maps.k_lo, pre.k_lo, k_dims, k_st, k_box, k_swizzle},
      {&maps.vt_hi, pre.vt_hi, v_dims, v_st, v_box, v_swizzle},
      {&maps.vt_lo, pre.vt_lo, v_dims, v_st, v_box, v_swizzle},
  };
  for (const auto& t : split) {
    const int rc = hopper::encode_4d(t.map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                                     t.base, t.dims, t.strides, t.box, t.swizzle);
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
  const int rc = split_launch(pre, st);
  if (rc != 0) return rc;
  switch (hd) {
    case 128: return launch_stages<128, key_tile(128)>(stages, maps, o, p, st);
    case 64: return launch_stages<64, key_tile(64)>(stages, maps, o, p, st);
    case 32: return launch_stages<32, key_tile(32)>(stages, maps, o, p, st);
    default: return launch_stages<16, key_tile(16)>(stages, maps, o, p, st);
  }
}
