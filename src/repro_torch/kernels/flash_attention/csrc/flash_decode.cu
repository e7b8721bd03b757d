// Flash attention (forward) for calls with few query rows, on Hopper
// (sm_90a): O = softmax(Q K^T * scale + mask) V over q (B, Sq, H, hd) and
// k, v (B, Sk, KV, hd) with GQA, bf16 operands, f32 softmax state, hd 64 or
// 128.  The flash_decode route of ops.py: a decode step (Sq = 1) or a short
// prompt over a long key set, as whisper's cross attention over 1500
// encoder frames.
//
// Serves the TPU kernel src/repro/kernels/flash_attention/kernel.py
// (_flash_kernel, launched by flash_attention_kernel through
// pl.pallas_call) in its few-row case: the reference wrapper's caller picks
// a small blk_q for few query rows.  It computes what _flash_kernel
// computes: the running max m, the sum l and an f32 accumulator, rescaled
// by exp(m_prev - m_new), and acc / max(l, 1e-30); causal, window and
// q_offset by position (query i at q_offset + i, key j at j), GQA by KV
// head (query head h reads KV head h / (H / KV)).
//
// What bounds it on an H100: bytes.  At whisper-medium's decode step (B 4,
// 16 heads of 64, Sk 1500) the call reads 24.6 MB of K and V for 25 MFLOP:
// 7.3 us at 3.35 TB/s, against 0.03 us of tensor-core time.  So the design
// is about reading K and V once, with the whole card, as soon as the
// launch starts, and about spending nothing else: one launch a call, no
// workspace in device memory.
//
//   - One launch, a cluster a KV head.  The grid is (B * KV, splits) and
//     the launch's cluster is (1, splits, 1): block y of a cluster takes
//     one contiguous range of the call's live keys of that KV head of that
//     batch, and its rank in the cluster is y.  ops.decode_splits picks as
//     many ranges as keep the blocks within two an SM, at most 8 (the
//     portable cluster size; whisper's decode: 64 heads x 4 ranges of 375
//     keys = 64 clusters of 4).  After its loop each block leaves its
//     merged (m, l, acc) in its own shared memory; behind a cluster
//     barrier each block reads every peer's state through distributed
//     shared memory (mapa + ld.shared::cluster) for its own share of the
//     output rows, rescales each range by exp2(m_s - M), divides by the
//     sum of l_s exp2(m_s - M) (at least 1e-30), in the order of the ranges,
//     and stores bf16 with 16-byte stores; a second cluster barrier keeps
//     every block's shared memory alive until its peers have read it (a block
//     alone needs neither, and is launched without a cluster).
//   - K/V through a ring of D stages filled by TMA.  Thread 0 issues a
//     stage's tile loads (64 keys x 64 hd columns of K and of V, one box
//     each, two of each at hd 128) through 4-D tensor maps of k and v;
//     they complete on the stage's mbarrier (arrive.expect_tx of the
//     stage's bytes), and every warp waits on the stage's parity.  The
//     boxes are 128-byte swizzled, and ldmatrix reads them through the same
//     swizzle, without bank conflicts.  The maps span all Sk keys, so that
//     they depend on the operands alone and not on the call's live span: a
//     decode step's cache grows by one key a step, and its maps, encoded
//     once for each (k, v, shape, strides) by fa_decode_maps and kept by
//     ops._decode_maps, serve every step of a round.  The live span [lo,
//     hi) is a launch argument.  No range starts before lo; keys past a
//     range but below hi are real keys (masked, P = 0); the last tile of
//     the span may reach past hi, and those keys (a cache's unwritten
//     slots, maybe NaN) are masked in S and zeroed in the V fragments,
//     since 0 * NaN in the PV product would be NaN (keys from Sk on arrive
//     as zeros).  One bulk copy a key row instead (128 bytes, no tensor
//     map) is ~750 copies a block, and the copy engine's rate on them held
//     such a kernel at 3.5x this one's time (PERF.md).  The ring is
//     ops.DECODE_DEPTH = 2 stages deep (1 for a range of one tile): deeper
//     rings read no faster at whisper's shapes, and a ring of 6 stages (a
//     whole 375-key range in flight from the start) leaves room for 62 of
//     the 64 clusters (PERF.md).  The kernel holds rings up to MAX_STAGES.
//   - Read each K/V byte once.  A block takes all Sq * H / KV query rows of
//     its KV head (1..4 at whisper, the whole group with GQA), up to four
//     16-row mma tiles (RT), on four warps.  With fewer than four row
//     tiles the KG = 4 / RT warps of a row tile split each 64-key stage
//     between them instead of idling, and merge their states in shared
//     memory before the cluster merge.  At hd 64 with one row tile
//     (whisper's calls) a warp's 16 keys of K and V fit in 32 registers:
//     it loads them and frees the stage before its products, so a refill
//     waits on no warp's arithmetic (PERF.md: freeing the stage after the
//     products left the refills 2.3 us behind the loads).
//   - Products on mma.sync m16n8k16 (bf16 in, f32 accumulators), rows
//     padded to 16: the products are ~0.1 % of the time, and mma.sync keeps
//     S in registers and turns it into P without a trip through shared
//     memory; wgmma's 64-row tiles would pad one row to 64.
//
// bf16 P: like the reference's chunked_attention (which casts p to the
// value dtype before the PV product), P is rounded to bf16 for the PV mma;
// l is summed over the f32 P.  A range with no live key for a row keeps
// m = -inf, l = 0 and acc = 0 (scores are -inf where masked, and exp2 of
// -inf less a finite base is 0), so it adds exactly 0 in the merge and
// never a NaN.  ops.py's plain version, ref.flash_decode_ref, computes the
// same steps range by range and merges them in the same order.
//
// The synchronization is the compiler's output.  The wrapper reads
// hopper_schedule(D), the K-loop plan of
// repro_torch.kernels.pipelined_matmul under the Hopper processor map
// (thread 0 issues and the copy engine loads; the warps compute), and
// raises unless it asks for the waits this kernel has:
//
//   full[s]   LOAD -> COMPUTE.  Thread 0 arrives once with expect_tx of
//             the stage's bytes; the TMA loads complete the rest.  Tile t
//             is in stage t mod D; every warp waits with parity
//             (t / D) & 1.
//   empty[s]  COMPUTE -> LOAD at distance D (slot reuse).  Where tile t + D
//             refills stage s, each warp's lane 0 arrives once its
//             fragments of tile t are in registers (after its products
//             where they do not fit), and thread 0 waits with parity
//             (t / D) & 1 before it issues the refill.  A range of at
//             most D tiles never refills a stage, so the wait is never
//             reached there.
//
// The query rows have a barrier of their own, q_full, completed once by warp
// 0's bulk copies and awaited by each warp before its first tile.  After the
// loop a block barrier frees the ring, which then holds the warps' states and
// the block's merged state for the cluster merge.
//
// Plain C interface, loaded with ctypes: fa_decode_maps encodes the tensor
// maps of k and v (0, or -1000 less the CUresult of an encoding);
// fa_decode launches the kernel on the caller's stream with them,
// returning the cudaError_t of the launch; fa_decode_clusters reports how
// many of a shape's clusters the card holds at once; fa_decode_probe
// launches one of two timing probes, instantiations of their own
// (template argument STOP) at hd 64 with one row tile, which leave the
// output unwritten.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

#include "hopper.cuh"

namespace {

constexpr int BK = 64;            // keys of a K/V stage
constexpr int MAX_STAGES = 6;     // ops.DECODE_MAX_STAGES
constexpr int MAX_CLUSTER = 8;    // ops.DECODE_MAX_CLUSTER: the portable size
constexpr int MAX_ROW_TILES = 4;  // 16-row tiles a block: Sq * H / KV <= 64
constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int SMEM_LIMIT = 232448;  // 227 KB of dynamic shared memory a block
constexpr int BOX = 64;             // hd columns of a TMA box (128 bytes)
constexpr int BOX_BYTES = BK * BOX * 2;

struct Params {
  const void* q;
  void* o;
  int B, H, KV, Sq;
  long long q_sb, q_ss, q_sh;  // strides in elements: batch, sequence, head
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;
  int causal;
  int window;    // <= 0: none; else keys k > q - window
  int q_offset;  // the position of query row 0
  float scale_log2;
  int lo, hi, chunk;  // the live keys [lo, hi) in ranges of chunk keys
  int stages;         // D, the ring's depth
};

// a compile-time flag for a generic lambda's argument
template <bool B>
struct Flag {
  static constexpr bool value = B;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ldmatrix at a shared address, with a memory clobber: a warp's reads of a
// stage stay before its arrival on the stage's empty barrier
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// The byte offset of row r, column col (a multiple of 8) in a K or V tile
// as TMA leaves it: HD / 64 boxes of 64 rows x 128 bytes, each 16-byte
// chunk of a row at its index XOR (r mod 8) (the 128-byte swizzle)
__device__ __forceinline__ uint32_t swizzled(int r, int col) {
  return (col / BOX) * BOX_BYTES + r * 128 + ((((col % BOX) / 8) ^ (r & 7)) << 4);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// 8 f32 values (scaled by inv) as 8 bf16 in one 16-byte store
__device__ __forceinline__ void store8_bf16(__nv_bfloat16* dst,
                                            const float (&x)[8], float inv) {
  uint4 packed;
  packed.x = pack_bf16(x[0] * inv, x[1] * inv);
  packed.y = pack_bf16(x[2] * inv, x[3] * inv);
  packed.z = pack_bf16(x[4] * inv, x[5] * inv);
  packed.w = pack_bf16(x[6] * inv, x[7] * inv);
  *reinterpret_cast<uint4*>(dst) = packed;
}

// RT 16-row tiles of query rows; with fewer than four, KG warps a tile
// split each K/V stage's keys.  EARLY: a warp's K and V fragments of a
// stage fit in 32 registers (hd 64, 16 keys a warp), so it loads them all and
// frees the stage before its products.  Shared memory: 1 KB to align the
// ring, the ring (which, after the loop, holds the warps' states and then the
// block's merged state), Q (rows padded to HD + 8 elements), then the full
// and empty barriers.  ops.decode_smem_bytes is the same sum.
template <int HD, int RT>
struct Shape {
  static constexpr int KG = RT >= 4 ? 1 : 4 / RT;
  static_assert(RT * KG == WARPS, "four warps a block");
  static constexpr int KW = BK / KG;  // keys a warp takes of a stage
  static constexpr bool EARLY = 8 * (HD / 16) * (KW / 16) <= 32;
  static constexpr int SS = HD + 8;   // Q's row stride in elements (16-byte pad)
  static constexpr int ROW_BYTES = HD * 2;  // one query row's bulk copy
  static constexpr int Q_ELEMS = RT * 16 * SS;
  static constexpr int TILE_BYTES = BK * ROW_BYTES;  // one K (or V) tile
  static constexpr int STAGE_BYTES = 2 * TILE_BYTES;
  // the warps' states (acc 16 x HD, m, l a warp), then the block's (acc
  // RT*16 x HD, m, l)
  static constexpr int WARP_FLOATS = WARPS * 16 * (HD + 2);
  static constexpr int MERGE_BYTES = (WARP_FLOATS + RT * 16 * (HD + 2)) * 4;
  static_assert(KW % 16 == 0, "a warp takes whole 16-key mma steps");
  __host__ __device__ static constexpr int ring_bytes(int stages) {
    return stages * STAGE_BYTES > MERGE_BYTES ? stages * STAGE_BYTES : MERGE_BYTES;
  }
  __host__ __device__ static constexpr int bytes(int stages) {
    return 1024 + ring_bytes(stages) + Q_ELEMS * 2 + (2 * MAX_STAGES + 1) * 8;
  }
};

// STOP 0: the route's kernel.  The timing probes: 1, the K-loop alone (no
// merge, no output); 2, the loads alone (no products either).
template <int HD, int RT, int STOP>
__global__ void __launch_bounds__(THREADS)
    flash_decode_kernel(const Params p, const __grid_constant__ CUtensorMap map_k,
                        const __grid_constant__ CUtensorMap map_v) {
  using S = Shape<HD, RT>;
  constexpr int SS = S::SS, KG = S::KG, KW = S::KW;
  constexpr int NT = KW / 8;  // S n-tiles a warp
  constexpr int OT = HD / 8;  // O n-tiles
  constexpr int CH = HD / 8;  // 16-byte chunks of a row
  extern __shared__ __align__(128) unsigned char smem_raw[];
  // the same offset in every block of the cluster: the merge maps it
  unsigned char* ring = smem_raw + ((1024 - smem_addr(smem_raw) % 1024) % 1024);
  const uint32_t ring_at = smem_addr(ring);
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(ring + S::ring_bytes(p.stages));
  const uint32_t full0 = smem_addr(qs + S::Q_ELEMS);
  const uint32_t empty0 = full0 + 8 * MAX_STAGES;  // full[s] = full0 + 8 s
  const uint32_t q_full = empty0 + 8 * MAX_STAGES;

  const int b = blockIdx.x / p.KV, kvh = blockIdx.x % p.KV;
  const int split = blockIdx.y;  // the range, and the block's cluster rank
  const int splits = gridDim.y;
  const int G = p.H / p.KV, R = p.Sq * G;  // row r: query r / G, head kvh*G + r % G
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int rt = warp % RT, kg = warp / RT;
  const int g = lane / 4, t = lane % 4;
  const int k0 = min(p.hi, p.lo + split * p.chunk);
  const int k1 = min(p.hi, k0 + p.chunk);
  const int n_tiles = (k1 - k0 + BK - 1) / BK;
  const int D = p.stages;

  // thread 0, the producer: the loads of tile `tile` into its stage, K
  // then V
  auto issue = [&](int tile) {
    const int s = tile % D;
    const uint32_t bar = full0 + 8 * s;
    hopper::mbar_arrive_expect_tx(bar, S::STAGE_BYTES);
    const uint32_t ks = ring_at + s * S::STAGE_BYTES;
#pragma unroll
    for (int j = 0; j < HD / BOX; ++j) {
      hopper::tma_load_4d(ks + j * BOX_BYTES, &map_k, bar, j * BOX, kvh,
                          k0 + tile * BK, b);
      hopper::tma_load_4d(ks + S::TILE_BYTES + j * BOX_BYTES, &map_v, bar,
                          j * BOX, kvh, k0 + tile * BK, b);
    }
  };
  if (threadIdx.x == 0) {
    for (int s = 0; s < D; ++s) {
      hopper::mbar_init(full0 + 8 * s, 1);    // the producer's expect_tx
      hopper::mbar_init(empty0 + 8 * s, WARPS);  // one arrival a warp
    }
    hopper::mbar_init(q_full, 1);
    hopper::mbar_fence_init();
    if (n_tiles > 0) hopper::mbar_arrive_expect_tx(q_full, R * S::ROW_BYTES);
    for (int tile = 0; tile < min(D, n_tiles); ++tile) issue(tile);
  }
  __syncthreads();
  // warp 0: the block's query rows, one bulk copy a row, lanes side by side
  if (warp == 0 && n_tiles > 0) {
    const __nv_bfloat16* qg = static_cast<const __nv_bfloat16*>(p.q) + b * p.q_sb;
    for (int r = lane; r < R; r += 32)
      hopper::bulk_load(smem_addr(qs + r * SS),
                        qg + (r / G) * p.q_ss + (kvh * G + r % G) * p.q_sh,
                        S::ROW_BYTES, q_full);
  }

  // this thread's rows of its tile, rt*16 + g and + 8, and their positions
  int qpos[2];
  bool row_in[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int r = rt * 16 + g + rr * 8;
    row_in[rr] = r < R;
    qpos[rr] = p.q_offset + (row_in[rr] ? r / G : 0);
  }

  uint32_t qf[HD / 16][4];
  float o[OT][4];
#pragma unroll
  for (int j = 0; j < OT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.0f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};

  // one tile, every warp its KW keys of it; TAIL: the tile reaches past the
  // live span's end hi (the span's last tile, shorter than BK), whose keys
  // from hi on are read from memory and zeroed in V (a cache's unwritten
  // slots may hold NaN, and 0 * NaN in the PV product is NaN); the other
  // tiles run without that mask
  auto tile_step = [&](const int tile, auto tail) {
    constexpr bool TAIL = decltype(tail)::value;
    const int s = tile % D;
    hopper::mbar_wait(full0 + 8 * s, (tile / D) & 1);  // tile is in stage s
    if (tile == 0) {
      hopper::mbar_wait(q_full, 0);
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        ldmatrix_x4(qf[kk], smem_addr(qs + (rt * 16 + lane % 16) * SS + kk * 16 +
                                      (lane / 16) * 8));
    }
    // this warp's keys of the stage's K and V tiles, as mma fragments
    const uint32_t ks = ring_at + s * S::STAGE_BYTES;
    const uint32_t vs = ks + S::TILE_BYTES;
    auto k_frag = [&](uint32_t (&r)[4], int kk, int np) {
      ldmatrix_x4(r, ks + swizzled(kg * KW + np * 16 + (lane / 16) * 8 + lane % 8,
                                   kk * 16 + ((lane / 8) % 2) * 8));
    };
    const int key_w = k0 + tile * BK + kg * KW;  // this warp's first key of the tile
    auto v_frag = [&](uint32_t (&r)[4], int kk, int np) {
      ldmatrix_x4_trans(r, vs + swizzled(kg * KW + kk * 16 + lane % 16,
                                         np * 16 + (lane / 16) * 8));
      // r[e] holds keys 2t and 2t + 1 (+ 8 for odd e) of the 16-key step,
      // the lower key in the lower half: keys from hi on are zeroed
      if constexpr (TAIL) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = key_w + kk * 16 + (e % 2) * 8 + 2 * t;
          r[e] &= (key < p.hi ? 0x0000ffffu : 0u) | (key + 1 < p.hi ? 0xffff0000u : 0u);
        }
      }
    };
    // the stage is free once every warp has read it (with EARLY, as soon
    // as its fragments are in registers); tile + D refills it
    auto release = [&]() {
      if (tile + D < n_tiles) {
        __syncwarp();
        if (lane == 0) hopper::mbar_arrive(empty0 + 8 * s);
        if (threadIdx.x == 0) {
          hopper::mbar_wait(empty0 + 8 * s, (tile / D) & 1);
          issue(tile + D);
        }
        __syncwarp();  // warp 0 whole again for its next ldmatrix
      }
    };
    if constexpr (STOP == 2) {  // a timing probe: the loads alone
      release();
      return;
    }
    uint32_t kf[S::EARLY ? HD / 16 : 1][S::EARLY ? NT / 2 : 1][4];
    uint32_t vf[S::EARLY ? KW / 16 : 1][S::EARLY ? OT / 2 : 1][4];
    if constexpr (S::EARLY) {
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) k_frag(kf[kk][np], kk, np);
#pragma unroll
      for (int kk = 0; kk < KW / 16; ++kk)
#pragma unroll
        for (int np = 0; np < OT / 2; ++np) v_frag(vf[kk][np], kk, np);
      release();
    }

    // S = Q K^T (16 rows x KW keys)
    float sc[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t r[4];
        if constexpr (S::EARLY) {
#pragma unroll
          for (int e = 0; e < 4; ++e) r[e] = kf[kk][np][e];
        } else {
          k_frag(r, kk, np);
        }
        mma_bf16(sc[2 * np], qf[kk], r[0], r[1]);
        mma_bf16(sc[2 * np + 1], qf[kk], r[2], r[3]);
      }
    }

    // scale (log2 units), mask to -inf, online softmax over rows g, g + 8
    // (a row's scores spread over the 4 threads of a quad)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int rr = e / 2, kp = key_w + j * 8 + 2 * t + (e % 2);
        const bool live = row_in[rr] && kp < k1 &&
                          (!p.causal || qpos[rr] >= kp) &&
                          (p.window <= 0 || kp > qpos[rr] - p.window);
        sc[j][e] = live ? sc[j][e] * p.scale_log2 : -INFINITY;
      }
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < NT; ++j)
        mx = fmaxf(mx, fmaxf(sc[j][2 * rr], sc[j][2 * rr + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[rr], mx);
      const float base = m_new == -INFINITY ? 0.0f : m_new;
      const float corr = exp2f(m[rr] - base);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float pv = exp2f(sc[j][2 * rr + e] - base);
          sc[j][2 * rr + e] = pv;
          sum += pv;
        }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      l[rr] = l[rr] * corr + sum;
      m[rr] = m_new;
#pragma unroll
      for (int j = 0; j < OT; ++j) {
        o[j][2 * rr] *= corr;
        o[j][2 * rr + 1] *= corr;
      }
    }

    // O += P V: the S accumulator of key n-tiles 2kk, 2kk+1 is the A
    // fragment of the kk-th 16-key step
#pragma unroll
    for (int kk = 0; kk < KW / 16; ++kk) {
      uint32_t a[4];
      a[0] = pack_bf16(sc[2 * kk][0], sc[2 * kk][1]);
      a[1] = pack_bf16(sc[2 * kk][2], sc[2 * kk][3]);
      a[2] = pack_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1]);
      a[3] = pack_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3]);
#pragma unroll
      for (int np = 0; np < OT / 2; ++np) {
        uint32_t r[4];
        if constexpr (S::EARLY) {
#pragma unroll
          for (int e = 0; e < 4; ++e) r[e] = vf[kk][np][e];
        } else {
          v_frag(r, kk, np);
        }
        mma_bf16(o[2 * np], a, r[0], r[1]);
        mma_bf16(o[2 * np + 1], a, r[2], r[3]);
      }
    }
    if constexpr (!S::EARLY) release();
  };
  for (int tile = 0; tile < n_tiles; ++tile) {
    if (k0 + (tile + 1) * BK > p.hi)
      tile_step(tile, Flag<true>{});
    else
      tile_step(tile, Flag<false>{});
  }
  if constexpr (STOP != 0) return;  // a timing probe: no merge, no peer reads
  __syncthreads();  // every warp is done with the ring

  // each warp's state into the ring, then the KG warps of a row tile merged
  // into the block's state (log2 units: M the largest m, L and acc relative
  // to it)
  float* warp_acc = reinterpret_cast<float*>(ring);  // [WARPS][16][HD]
  float* warp_m = warp_acc + WARPS * 16 * HD;        // [WARPS * 16]
  float* warp_l = warp_m + WARPS * 16;
  float* blk_acc = reinterpret_cast<float*>(ring) + S::WARP_FLOATS;  // [RT*16][HD]
  float* blk_m = blk_acc + RT * 16 * HD;  // [RT * 16]
  float* blk_l = blk_m + RT * 16;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int row = warp * 16 + g + rr * 8;
#pragma unroll
    for (int j = 0; j < OT; ++j)
      *reinterpret_cast<float2*>(warp_acc + row * HD + j * 8 + 2 * t) =
          make_float2(o[j][2 * rr], o[j][2 * rr + 1]);
    if (t == 0) {
      warp_m[row] = m[rr];
      warp_l[row] = l[rr];
    }
  }
  __syncthreads();
  for (int it = threadIdx.x; it < R * CH; it += THREADS) {
    const int r = it / CH, c = (it % CH) * 8;
    float M = -INFINITY;
#pragma unroll
    for (int w = 0; w < KG; ++w)
      M = fmaxf(M, warp_m[(w * RT + r / 16) * 16 + r % 16]);
    const float base = M == -INFINITY ? 0.0f : M;
    float L = 0.0f, acc[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[e] = 0.0f;
#pragma unroll
    for (int w = 0; w < KG; ++w) {
      const int row = (w * RT + r / 16) * 16 + r % 16;
      const float wt = exp2f(warp_m[row] - base);
      L += wt * warp_l[row];
      const float4 a0 = *reinterpret_cast<const float4*>(warp_acc + row * HD + c);
      const float4 a1 = *reinterpret_cast<const float4*>(warp_acc + row * HD + c + 4);
      acc[0] += wt * a0.x; acc[1] += wt * a0.y; acc[2] += wt * a0.z; acc[3] += wt * a0.w;
      acc[4] += wt * a1.x; acc[5] += wt * a1.y; acc[6] += wt * a1.z; acc[7] += wt * a1.w;
    }
    float* dst = blk_acc + r * HD + c;
    *reinterpret_cast<float4*>(dst) = make_float4(acc[0], acc[1], acc[2], acc[3]);
    *reinterpret_cast<float4*>(dst + 4) = make_float4(acc[4], acc[5], acc[6], acc[7]);
    if (c == 0) {
      blk_m[r] = M;  // -inf where the range holds no live key of the row
      blk_l[r] = L;
    }
  }

  // the cluster merge: every block's state is written, then block `split`
  // merges the ranges of its share of the (row, 8 columns) items, reading
  // each range's state from that range's block in the order of the ranges
  // (a block alone in its cluster reads its own state behind its own
  // barrier)
  if (splits > 1) {
    hopper::cluster_arrive();
    hopper::cluster_wait();
  } else {
    __syncthreads();
  }
  const uint32_t acc_at = smem_addr(blk_acc), m_at = smem_addr(blk_m),
                 l_at = smem_addr(blk_l);
  for (int it = split * THREADS + threadIdx.x; it < R * CH; it += splits * THREADS) {
    const int r = it / CH, c = (it % CH) * 8;
    // every range's state of the item in one round of loads, then the merge
    float ms[MAX_CLUSTER], ls[MAX_CLUSTER];
    float4 a0[MAX_CLUSTER], a1[MAX_CLUSTER];
#pragma unroll
    for (int x = 0; x < MAX_CLUSTER; ++x) {
      if (x < splits) {
        ms[x] = hopper::ld_cluster_f32(hopper::cluster_map(m_at + 4 * r, x));
        ls[x] = hopper::ld_cluster_f32(hopper::cluster_map(l_at + 4 * r, x));
        const uint32_t at = hopper::cluster_map(acc_at + 4 * (r * HD + c), x);
        a0[x] = hopper::ld_cluster_f32x4(at);
        a1[x] = hopper::ld_cluster_f32x4(at + 16);
      }
    }
    float M = -INFINITY;
#pragma unroll
    for (int x = 0; x < MAX_CLUSTER; ++x)
      if (x < splits) M = fmaxf(M, ms[x]);
    const float base = M == -INFINITY ? 0.0f : M;
    float L = 0.0f, acc[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[e] = 0.0f;
#pragma unroll
    for (int x = 0; x < MAX_CLUSTER; ++x) {
      if (x < splits) {
        const float wt = exp2f(ms[x] - base);  // 0 for a range without a live key
        L += wt * ls[x];
        acc[0] += wt * a0[x].x; acc[1] += wt * a0[x].y; acc[2] += wt * a0[x].z;
        acc[3] += wt * a0[x].w; acc[4] += wt * a1[x].x; acc[5] += wt * a1[x].y;
        acc[6] += wt * a1[x].z; acc[7] += wt * a1[x].w;
      }
    }
    const int i = r / G, h = kvh * G + r % G;
    store8_bf16(static_cast<__nv_bfloat16*>(p.o) + b * p.o_sb + i * p.o_ss +
                    h * p.o_sh + c,
                acc, 1.0f / fmaxf(L, 1e-30f));
  }
  // no block leaves (and frees its shared memory) before its peers have
  // read it
  if (splits > 1) {
    hopper::cluster_arrive();
    hopper::cluster_wait();
  }
}

template <int HD, int RT>
cudaLaunchConfig_t launch_config(const Params& p, int splits, cudaStream_t stream,
                                 cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.B * p.KV, splits, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = Shape<HD, RT>::bytes(p.stages);
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = 1;
  attr->val.clusterDim.y = splits;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = splits > 1 ? 1 : 0;  // one range: a block is its own cluster
  return cfg;
}

// The instantiation's dynamic shared memory limit, raised once.
template <int HD, int RT, int STOP>
cudaError_t allow_smem() {
  static const cudaError_t err = cudaFuncSetAttribute(
      flash_decode_kernel<HD, RT, STOP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_LIMIT);
  return err;
}

// maps: k's and v's tensor maps (fa_decode_maps), copied into the launch's
// arguments.  clusters != nullptr: the clusters of this shape the card
// holds at once, written instead of a launch.
template <int HD, int RT, int STOP>
int launch(const Params& p, int splits, const void* maps, cudaStream_t stream,
           int* clusters) {
  if (Shape<HD, RT>::bytes(p.stages) > SMEM_LIMIT)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = allow_smem<HD, RT, STOP>();
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = launch_config<HD, RT>(p, splits, stream, &attr);
  if (clusters != nullptr) {
    cudaLaunchConfig_t counted = cfg;  // counted as clusters, even of one block
    counted.numAttrs = 1;
    err = cudaOccupancyMaxActiveClusters(clusters, flash_decode_kernel<HD, RT, STOP>,
                                         &counted);
    return static_cast<int>(err);
  }
  CUtensorMap map_k, map_v;
  memcpy(&map_k, maps, sizeof(CUtensorMap));
  memcpy(&map_v, static_cast<const unsigned char*>(maps) + sizeof(CUtensorMap),
         sizeof(CUtensorMap));
  err = cudaLaunchKernelEx(&cfg, flash_decode_kernel<HD, RT, STOP>, p, map_k, map_v);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int launch_hd(const Params& p, int splits, const void* maps, cudaStream_t stream,
              int* clusters) {
  const int tiles = (p.Sq * (p.H / p.KV) + 15) / 16;
  if (tiles <= 1) return launch<HD, 1, 0>(p, splits, maps, stream, clusters);
  if (tiles <= 2) return launch<HD, 2, 0>(p, splits, maps, stream, clusters);
  return launch<HD, MAX_ROW_TILES, 0>(p, splits, maps, stream, clusters);
}

// The call's checks, then its Params, or false.
bool params(Params* p, const void* q, void* o, const long long* dims,
            const long long* strides, int causal, int window, int q_offset,
            float scale_log2, int stages, int full, int empty) {
  const long long B = dims[0], H = dims[1], KV = dims[2], Sq = dims[3],
                  Sk = dims[4], hd = dims[5], lo = dims[6], hi = dims[7],
                  chunk = dims[8], splits = dims[9];
  if (!full || !empty || B <= 0 || H <= 0 || KV <= 0 || H % KV || Sq <= 0 ||
      Sk <= 0 || Sq * (H / KV) > 16 * MAX_ROW_TILES || (hd != 64 && hd != 128) ||
      lo < 0 || hi > Sk || lo >= hi || chunk < 1 || splits < 1 ||
      splits > MAX_CLUSTER || (splits - 1) * chunk >= hi - lo ||
      splits * chunk < hi - lo || B * KV > 0x7fffffffLL || Sk > 0x3fffffffLL ||
      q_offset < -0x3fffffff || q_offset > 0x3fffffff || stages < 1 ||
      stages > MAX_STAGES)
    return false;
  for (int i = 0; i < 12; ++i)  // TMA boxes, 16-byte copies and stores
    if (strides[i] % 8 || strides[i] < 0) return false;  // 0: a broadcast dim
  p->q = q;
  p->o = o;
  p->B = static_cast<int>(B);
  p->H = static_cast<int>(H);
  p->KV = static_cast<int>(KV);
  p->Sq = static_cast<int>(Sq);
  p->q_sb = strides[0]; p->q_ss = strides[1]; p->q_sh = strides[2];
  p->k_sb = strides[3]; p->k_ss = strides[4]; p->k_sh = strides[5];
  p->v_sb = strides[6]; p->v_ss = strides[7]; p->v_sh = strides[8];
  p->o_sb = strides[9]; p->o_ss = strides[10]; p->o_sh = strides[11];
  p->causal = causal;
  p->window = window;
  p->q_offset = q_offset;
  p->scale_log2 = scale_log2;
  p->lo = static_cast<int>(lo);
  p->hi = static_cast<int>(hi);
  p->chunk = static_cast<int>(chunk);
  p->stages = stages;
  return true;
}

}  // namespace

// dims: B, H, KV, Sq, Sk, hd, lo, hi, chunk, splits.  strides: the batch,
// sequence and head strides (elements) of q, k, v and o in turn; q, k and
// v 16-byte aligned.

// Writes k's and then v's tensor map (128 bytes each) into maps: (hd, KV,
// Sk, B), innermost first, in boxes of 64 columns of one head of one batch
// by BK keys; a box past Sk stays in its batch and arrives as zeros.  The
// maps read no lo, hi, chunk or splits of dims: one encoding serves every
// live span over the same operands.  Returns 0, or -1000 less the CUresult
// of an encoding (-1001: the driver lacks cuTensorMapEncodeTiled).
extern "C" int fa_decode_maps(const void* k, const void* v, const long long* dims,
                              const long long* strides, void* maps) {
  const long long hd = dims[5];
  const void* bases[2] = {k, v};
  const uint64_t d[4] = {static_cast<uint64_t>(hd), static_cast<uint64_t>(dims[2]),
                         static_cast<uint64_t>(dims[4]), static_cast<uint64_t>(dims[0])};
  const uint32_t box[4] = {BOX, 1, BK, 1};
  for (int t = 0; t < 2; ++t) {
    const long long* st = strides + 3 + 3 * t;  // batch, sequence, head
    const uint64_t bytes[3] = {static_cast<uint64_t>(st[2]) * 2,
                               static_cast<uint64_t>(st[1]) * 2,
                               static_cast<uint64_t>(st[0]) * 2};
    CUtensorMap map;
    const int rc = hopper::encode_bf16_4d(&map, bases[t], d, bytes, box);
    if (rc != 0) return rc < 0 ? -1001 : -1000 - rc;
    memcpy(static_cast<unsigned char*>(maps) + t * sizeof(CUtensorMap), &map,
           sizeof(CUtensorMap));
  }
  return 0;
}

// The launch.  maps: fa_decode_maps's for these dims and strides.  stages:
// the ring's depth D; full and empty: the plan's two waits (the kernel has
// both and takes no plan without them).
extern "C" int fa_decode(const void* q, void* o, const void* maps, const long long* dims,
                         const long long* strides, int causal, int window, int q_offset,
                         float scale_log2, int stages, int full, int empty, void* stream) {
  Params p;
  if (!params(&p, q, o, dims, strides, causal, window, q_offset, scale_log2, stages,
              full, empty))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n = static_cast<int>(dims[9]);
  return dims[5] == 64 ? launch_hd<64>(p, n, maps, s, nullptr)
                       : launch_hd<128>(p, n, maps, s, nullptr);
}

// fa_decode's timing probes, hd 64 with one row tile only: stop 1 the
// K-loop alone (no merge), 2 the loads alone (no products); the output is
// left unwritten.
extern "C" int fa_decode_probe(const void* q, void* o, const void* maps,
                               const long long* dims, const long long* strides,
                               int causal, int window, int q_offset, float scale_log2,
                               int stages, int full, int empty, void* stream, int stop) {
  Params p;
  if (!params(&p, q, o, dims, strides, causal, window, q_offset, scale_log2, stages,
              full, empty) ||
      dims[5] != 64 || p.Sq * (p.H / p.KV) > 16 || (stop != 1 && stop != 2))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n = static_cast<int>(dims[9]);
  return stop == 1 ? launch<64, 1, 1>(p, n, maps, s, nullptr)
                   : launch<64, 1, 2>(p, n, maps, s, nullptr);
}

// The same dims and strides (no pointer is read): writes into *clusters how
// many clusters of the launch fa_decode would make the card holds at once
// (cudaOccupancyMaxActiveClusters; 0: a cluster cannot be placed) and
// returns the cudaError_t of the query.
extern "C" int fa_decode_clusters(const long long* dims, const long long* strides,
                                  int stages, int* clusters) {
  *clusters = 0;
  Params p;
  if (!params(&p, nullptr, nullptr, dims, strides, 0, 0, 0, 0.0f, stages, 1, 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const int n = static_cast<int>(dims[9]);
  return dims[5] == 64 ? launch_hd<64>(p, n, nullptr, nullptr, clusters)
                       : launch_hd<128>(p, n, nullptr, nullptr, clusters);
}
