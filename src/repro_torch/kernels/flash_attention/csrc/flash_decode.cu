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
// 7.3 us at 3.35 TB/s, against 0.03 us of tensor-core time.  Counted
// exactly, the bytes are Q + K + V + O plus the workspace's round trip (the
// ranges' m, l and acc written once and read once), which is below 2 % of
// K and V at that shape.  The tma_wgmma route spends a 128-row Q tile on
// one live row and lays its persistent grid over (batch, head, Q tile)
// items: 64 items on 132 SMs there, each walking all 1500 keys.  So this
// kernel's design is about reading K and V once with the whole card:
//
//   - Fill the card.  The grid is (B * KV, splits): a block takes one KV
//     head of one batch over one contiguous range of the call's live keys.
//     ops.decode_splits picks as many splits as keep the blocks within two
//     an SM, one wave at any occupancy this kernel reaches (whisper's
//     decode: 64 heads x 4 ranges of 375 keys = 256 blocks).  Five ranges
//     (320 blocks) and more measured slower (PERF.md, flash_decode).
//   - Read each K/V byte once.  A block takes all Sq * H / KV query rows of
//     its KV head (1..4 at whisper, the whole group with GQA), up to four
//     16-row mma tiles (RT).  With fewer than four tiles the block's four
//     warps split each 64-key tile between them (KG key groups of
//     64 / KG keys) instead of idling, and merge their states at the end.
//     Eight tiles (128 rows: yi-6b's GQA group at 16 rows) took 212
//     registers a thread, one block an SM, and measured slower than
//     tma_wgmma (PERF.md, flash_decode), so the route stops at 64 rows.
//   - Products on mma.sync m16n8k16 (bf16 in, f32 accumulators), rows
//     padded to 16, as flash_attention.cu's bf16 kernel: the products are
//     ~0.1 % of the time, and mma.sync keeps S in registers and turns it
//     into P without a trip through shared memory, which the CUDA cores
//     would need for their row reductions.  wgmma's 64-row tiles would pad
//     one row to 64.
//   - Combine: each range writes (m, l, acc) in f32 to a workspace that the
//     wrapper allocates; a second small kernel on the same stream
//     (combine_kernel, launched by the same host call and counted in
//     combine_splits.launches) rescales each range by exp(m_s - M) and
//     divides by the sum of l_s exp(m_s - M).  A second kernel, and not the
//     last-arriving block of a head through an atomic ticket: the ticket
//     needs a zeroed counter each call (one more operation on the stream)
//     or a persistent one that two streams could share, and a wait across
//     blocks that the K-loop plan does not cover.  A call of one range
//     writes the output from the split kernel and launches nothing else.
//   - Output bf16 with 16-byte stores, 8 head-dim columns a thread.
//
// bf16 P: like the reference's chunked_attention (which casts p to the
// value dtype before the PV product) and flash_attention.cu, P is rounded
// to bf16 for the PV mma; l is summed over the f32 P.  A range with no
// live key for a row keeps m = -inf, l = 0 and acc = 0 (scores are -inf
// where masked, and exp2 of -inf less a finite base is 0), so it adds
// exactly 0 in the combine and never a NaN.  ops.py's plain version,
// ref.flash_decode_ref, computes the same steps range by range.
//
// The synchronization is the compiler's output, as in flash_attention.cu.
// The wrapper reads kernel_schedule(2), the K-loop plan of
// repro_torch.kernels.pipelined_matmul.schedule.plan_pipeline(2), and
// raises unless it asks for the waits this kernel has (issue, arrival).
// K/V tiles stream through a cp.async ring of STAGES = 2 slots; per K-step
// i:
//
//   arrival wait  cp.async.wait_all + __syncthreads: tile i (and, at the
//                 first step, the Q rows) has landed.  The same barrier
//                 orders every warp's compute of step i-1 before any
//                 thread's refill of its slot, so no credit wait is needed.
//   ISSUE(i)      the block's threads start the copy of tile i+1 into slot
//                 (i+1) mod 2.
//   COMPUTE(i)    each warp: S = Q K^T over its keys, the masked online
//                 softmax, O += P V.
//
// After the loop one more __syncthreads frees the ring, which then holds
// the warps' states for their merge.  The combine kernel reads what the
// split kernel wrote by stream order: no wait inside either kernel.
//
// Plain C interface, loaded with ctypes: fa_decode launches the split
// kernel (and the combine) on the caller's stream, fa_decode_combine the
// combine alone; each returns the cudaError_t of its launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BK = 64;            // keys of a K/V tile
constexpr int STAGES = 2;         // the K/V ring: kernel_schedule(2)
constexpr int MAX_ROW_TILES = 4;  // 16-row tiles a block: Sq * H / KV <= 64
constexpr int COMBINE_THREADS = 256;
constexpr float LN2 = 0.693147180559945309f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* acc;  // workspace: (splits, B, H, Sq, hd)
  float* m;    // (splits, B, H, Sq), natural-log units
  float* l;    // (splits, B, H, Sq)
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
};

struct CombineParams {
  const float* acc;
  const float* m;
  const float* l;
  void* o;
  int splits, H, Sq;
  long long rows;  // B * H * Sq
  long long o_sb, o_ss, o_sh;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
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
// split each K/V tile's keys
template <int HD, int RT>
struct Shape {
  static constexpr int KG = RT >= 4 ? 1 : 4 / RT;
  static constexpr int WARPS = RT * KG;
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int KW = BK / KG;  // keys a warp takes of a tile
  static constexpr int SS = HD + 8;   // row stride in elements (16-byte pad)
  static constexpr int Q_ELEMS = RT * 16 * SS;
  static constexpr int KV_ELEMS = BK * SS;  // one K (or V) tile
  static constexpr int RING_BYTES = STAGES * 2 * KV_ELEMS * 2;
  // the warps' states after the loop, in the ring: acc (16 x HD), m, l
  static constexpr int MERGE_BYTES = WARPS * 16 * (HD + 2) * 4;
  static_assert(MERGE_BYTES <= RING_BYTES, "the merge must fit in the ring");
  static_assert(KW % 16 == 0, "a warp takes whole 16-key mma steps");
  static constexpr size_t bytes() { return Q_ELEMS * 2 + RING_BYTES; }
};

template <int HD, int RT>
__global__ void __launch_bounds__(Shape<HD, RT>::THREADS)
    flash_decode_kernel(const Params p) {
  using S = Shape<HD, RT>;
  constexpr int SS = S::SS, KG = S::KG, KW = S::KW;
  constexpr int NT = KW / 8;  // S n-tiles a warp
  constexpr int OT = HD / 8;  // O n-tiles
  constexpr int CH = HD / 8;  // 16-byte chunks of a row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* ring = qs + S::Q_ELEMS;

  const int b = blockIdx.x / p.KV, kvh = blockIdx.x % p.KV;
  const int split = blockIdx.y;
  const int G = p.H / p.KV, R = p.Sq * G;  // row r: query r / G, head kvh*G + r % G
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int rt = warp % RT, kg = warp / RT;
  const int g = lane / 4, t = lane % 4;
  const int k0 = min(p.hi, p.lo + split * p.chunk);
  const int k1 = min(p.hi, k0 + p.chunk);
  const int n_tiles = (k1 - k0 + BK - 1) / BK;

  // the block's query rows, rows past R zero-filled
  const __nv_bfloat16* qg = static_cast<const __nv_bfloat16*>(p.q) + b * p.q_sb;
  for (int ch = threadIdx.x; ch < RT * 16 * CH; ch += S::THREADS) {
    const int r = ch / CH, c = (ch % CH) * 8;
    const bool in = r < R;
    const __nv_bfloat16* src =
        in ? qg + (r / G) * p.q_ss + (kvh * G + r % G) * p.q_sh + c : qg;
    cp_async16(qs + r * SS + c, src, in ? 16 : 0);
  }
  cp_async_commit();

  const __nv_bfloat16* kg_ = static_cast<const __nv_bfloat16*>(p.k) +
                             b * p.k_sb + kvh * p.k_sh;
  const __nv_bfloat16* vg_ = static_cast<const __nv_bfloat16*>(p.v) +
                             b * p.v_sb + kvh * p.v_sh;
  // keys past the range are zero-filled: their P is 0, and 0 * V must not
  // meet stale shared memory
  auto issue = [&](int tile) {
    __nv_bfloat16* ks = ring + (tile % STAGES) * 2 * S::KV_ELEMS;
    const int key0 = k0 + tile * BK;
    for (int ch = threadIdx.x; ch < BK * CH; ch += S::THREADS) {
      const int r = ch / CH, c = (ch % CH) * 8;
      const bool in = key0 + r < k1;
      const long long key = in ? key0 + r : 0;
      cp_async16(ks + r * SS + c, kg_ + key * p.k_ss + c, in ? 16 : 0);
      cp_async16(ks + S::KV_ELEMS + r * SS + c, vg_ + key * p.v_ss + c,
                 in ? 16 : 0);
    }
    cp_async_commit();
  };
  if (n_tiles > 0) issue(0);

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

  for (int tile = 0; tile < n_tiles; ++tile) {
    cp_async_wait_all();
    __syncthreads();  // arrival wait (LOAD -> COMPUTE)
    if (tile + 1 < n_tiles) issue(tile + 1);  // ISSUE(tile)
    if (tile == 0) {
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        ldmatrix_x4(qf[kk], qs + (rt * 16 + lane % 16) * SS + kk * 16 +
                                (lane / 16) * 8);
    }
    // this warp's keys of the tile
    const __nv_bfloat16* ks =
        ring + (tile % STAGES) * 2 * S::KV_ELEMS + kg * KW * SS;
    const __nv_bfloat16* vs = ks + S::KV_ELEMS;

    // S = Q K^T (16 rows x KW keys)
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t r[4];
        ldmatrix_x4(r, ks + (np * 16 + (lane / 16) * 8 + lane % 8) * SS +
                           kk * 16 + ((lane / 8) % 2) * 8);
        mma_bf16(s[2 * np], qf[kk], r[0], r[1]);
        mma_bf16(s[2 * np + 1], qf[kk], r[2], r[3]);
      }
    }

    // scale (log2 units), mask to -inf, online softmax over rows g, g + 8
    // (a row's scores spread over the 4 threads of a quad)
    const int key_w = k0 + tile * BK + kg * KW;
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int rr = e / 2, kp = key_w + j * 8 + 2 * t + (e % 2);
        const bool live = row_in[rr] && kp < k1 &&
                          (!p.causal || qpos[rr] >= kp) &&
                          (p.window <= 0 || kp > qpos[rr] - p.window);
        s[j][e] = live ? s[j][e] * p.scale_log2 : -INFINITY;
      }
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < NT; ++j)
        mx = fmaxf(mx, fmaxf(s[j][2 * rr], s[j][2 * rr + 1]));
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
          const float pv = exp2f(s[j][2 * rr + e] - base);
          s[j][2 * rr + e] = pv;
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
      a[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      a[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      a[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      a[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int np = 0; np < OT / 2; ++np) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, vs + (kk * 16 + lane % 16) * SS + np * 16 +
                                 (lane / 16) * 8);
        mma_bf16(o[2 * np], a, r[0], r[1]);
        mma_bf16(o[2 * np + 1], a, r[2], r[3]);
      }
    }
  }
  cp_async_wait_all();  // an empty range leaves the Q copy in flight
  __syncthreads();      // every warp is done with the ring

  // each warp's state into the ring, then the KG warps of a row tile merged
  float* merge_acc = reinterpret_cast<float*>(ring);  // [WARPS][16][HD]
  float* merge_m = merge_acc + S::WARPS * 16 * HD;    // [WARPS][16]
  float* merge_l = merge_m + S::WARPS * 16;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int row = warp * 16 + g + rr * 8;
#pragma unroll
    for (int j = 0; j < OT; ++j)
      *reinterpret_cast<float2*>(merge_acc + row * HD + j * 8 + 2 * t) =
          make_float2(o[j][2 * rr], o[j][2 * rr + 1]);
    if (t == 0) {
      merge_m[row] = m[rr];
      merge_l[row] = l[rr];
    }
  }
  __syncthreads();

  const bool direct = gridDim.y == 1;
  const long long rows = static_cast<long long>(p.B) * p.H * p.Sq;
  for (int it = threadIdx.x; it < R * CH; it += S::THREADS) {
    const int r = it / CH, c = (it % CH) * 8;
    float M = -INFINITY;
#pragma unroll
    for (int w = 0; w < KG; ++w)
      M = fmaxf(M, merge_m[(w * RT + r / 16) * 16 + r % 16]);
    const float base = M == -INFINITY ? 0.0f : M;
    float L = 0.0f, acc[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[e] = 0.0f;
#pragma unroll
    for (int w = 0; w < KG; ++w) {
      const int row = (w * RT + r / 16) * 16 + r % 16;
      const float wt = exp2f(merge_m[row] - base);
      L += wt * merge_l[row];
      const float4 a0 = *reinterpret_cast<const float4*>(merge_acc + row * HD + c);
      const float4 a1 = *reinterpret_cast<const float4*>(merge_acc + row * HD + c + 4);
      acc[0] += wt * a0.x; acc[1] += wt * a0.y; acc[2] += wt * a0.z; acc[3] += wt * a0.w;
      acc[4] += wt * a1.x; acc[5] += wt * a1.y; acc[6] += wt * a1.z; acc[7] += wt * a1.w;
    }
    const int i = r / G, h = kvh * G + r % G;
    if (direct) {
      store8_bf16(static_cast<__nv_bfloat16*>(p.o) + b * p.o_sb + i * p.o_ss +
                      h * p.o_sh + c,
                  acc, 1.0f / fmaxf(L, 1e-30f));
    } else {
      const long long row =
          split * rows + (static_cast<long long>(b) * p.H + h) * p.Sq + i;
      float* dst = p.acc + row * HD + c;
      *reinterpret_cast<float4*>(dst) = make_float4(acc[0], acc[1], acc[2], acc[3]);
      *reinterpret_cast<float4*>(dst + 4) = make_float4(acc[4], acc[5], acc[6], acc[7]);
      if (c == 0) {
        p.m[row] = M * LN2;  // -inf stays -inf
        p.l[row] = L;
      }
    }
  }
}

// One thread a (row, 8 columns): the ranges' states rescaled to the
// largest m, summed, divided, stored as bf16.
template <int HD>
__global__ void __launch_bounds__(COMBINE_THREADS)
    combine_kernel(const CombineParams p) {
  constexpr int CH = HD / 8;
  const long long it = static_cast<long long>(blockIdx.x) * COMBINE_THREADS + threadIdx.x;
  if (it >= p.rows * CH) return;
  const long long row = it / CH;
  const int c = static_cast<int>(it % CH) * 8;
  float M = -INFINITY;
  for (int s = 0; s < p.splits; ++s) M = fmaxf(M, p.m[s * p.rows + row]);
  const float base = M == -INFINITY ? 0.0f : M;
  float L = 0.0f, acc[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) acc[e] = 0.0f;
  for (int s = 0; s < p.splits; ++s) {
    const long long at = s * p.rows + row;
    const float wt = expf(p.m[at] - base);  // 0 for a range with no live key
    L += wt * p.l[at];
    const float4 a0 = *reinterpret_cast<const float4*>(p.acc + at * HD + c);
    const float4 a1 = *reinterpret_cast<const float4*>(p.acc + at * HD + c + 4);
    acc[0] += wt * a0.x; acc[1] += wt * a0.y; acc[2] += wt * a0.z; acc[3] += wt * a0.w;
    acc[4] += wt * a1.x; acc[5] += wt * a1.y; acc[6] += wt * a1.z; acc[7] += wt * a1.w;
  }
  const int i = static_cast<int>(row % p.Sq);
  const long long bh = row / p.Sq;
  const int h = static_cast<int>(bh % p.H);
  const long long b = bh / p.H;
  store8_bf16(static_cast<__nv_bfloat16*>(p.o) + b * p.o_sb + i * p.o_ss +
                  h * p.o_sh + c,
              acc, 1.0f / fmaxf(L, 1e-30f));
}

template <int HD, int RT>
int launch_split(const Params& p, int splits, cudaStream_t stream) {
  using S = Shape<HD, RT>;
  const size_t smem = S::bytes();
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_decode_kernel<HD, RT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  flash_decode_kernel<HD, RT>
      <<<dim3(p.B * p.KV, splits), S::THREADS, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int launch_split_hd(const Params& p, int splits, cudaStream_t stream) {
  const int tiles = (p.Sq * (p.H / p.KV) + 15) / 16;
  if (tiles <= 1) return launch_split<HD, 1>(p, splits, stream);
  if (tiles <= 2) return launch_split<HD, 2>(p, splits, stream);
  return launch_split<HD, MAX_ROW_TILES>(p, splits, stream);
}

int launch_combine(const CombineParams& c, int hd, cudaStream_t stream) {
  const long long items = c.rows * (hd / 8);
  const long long blocks = (items + COMBINE_THREADS - 1) / COMBINE_THREADS;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  if (hd == 64)
    combine_kernel<64><<<static_cast<unsigned>(blocks), COMBINE_THREADS, 0, stream>>>(c);
  else
    combine_kernel<128><<<static_cast<unsigned>(blocks), COMBINE_THREADS, 0, stream>>>(c);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dims: B, H, KV, Sq, Sk, hd, lo, hi, chunk, splits.  strides: the batch,
// sequence and head strides (elements) of q, k, v and o in turn.  ws: the
// f32 workspace of splits * B * H * Sq * (hd + 2) floats (acc, then m,
// then l), unused (may be null) with one range.
extern "C" int fa_decode(const void* q, const void* k, const void* v, void* o,
                         float* ws, const long long* dims,
                         const long long* strides, int causal, int window,
                         int q_offset, float scale_log2, void* stream) {
  const long long B = dims[0], H = dims[1], KV = dims[2], Sq = dims[3],
                  Sk = dims[4], hd = dims[5], lo = dims[6], hi = dims[7],
                  chunk = dims[8], splits = dims[9];
  if (B <= 0 || H <= 0 || KV <= 0 || H % KV || Sq <= 0 || Sk <= 0 ||
      Sq * (H / KV) > 16 * MAX_ROW_TILES || (hd != 64 && hd != 128) ||
      lo < 0 || hi > Sk || lo >= hi || chunk < 1 || splits < 1 ||
      splits > 65535 || (splits - 1) * chunk >= hi - lo ||
      splits * chunk < hi - lo || B * KV > 0x7fffffffLL ||
      Sk > 0x3fffffffLL || q_offset < -0x3fffffff || q_offset > 0x3fffffff ||
      (splits > 1 && ws == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  for (int i = 0; i < 12; ++i)  // 16-byte copies and stores
    if (strides[i] % 8) return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  const long long rows = B * H * Sq;
  p.acc = ws;
  p.m = ws ? ws + splits * rows * hd : nullptr;
  p.l = ws ? p.m + splits * rows : nullptr;
  p.B = static_cast<int>(B);
  p.H = static_cast<int>(H);
  p.KV = static_cast<int>(KV);
  p.Sq = static_cast<int>(Sq);
  p.q_sb = strides[0]; p.q_ss = strides[1]; p.q_sh = strides[2];
  p.k_sb = strides[3]; p.k_ss = strides[4]; p.k_sh = strides[5];
  p.v_sb = strides[6]; p.v_ss = strides[7]; p.v_sh = strides[8];
  p.o_sb = strides[9]; p.o_ss = strides[10]; p.o_sh = strides[11];
  p.causal = causal;
  p.window = window;
  p.q_offset = q_offset;
  p.scale_log2 = scale_log2;
  p.lo = static_cast<int>(lo);
  p.hi = static_cast<int>(hi);
  p.chunk = static_cast<int>(chunk);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rc = hd == 64 ? launch_split_hd<64>(p, static_cast<int>(splits), s)
                          : launch_split_hd<128>(p, static_cast<int>(splits), s);
  if (rc != 0 || splits == 1) return rc;
  CombineParams c;
  c.acc = p.acc;
  c.m = p.m;
  c.l = p.l;
  c.o = o;
  c.splits = static_cast<int>(splits);
  c.H = p.H;
  c.Sq = p.Sq;
  c.rows = rows;
  c.o_sb = p.o_sb; c.o_ss = p.o_ss; c.o_sh = p.o_sh;
  return launch_combine(c, static_cast<int>(hd), s);
}

// The combine alone.  dims: splits, B, H, Sq, hd; acc (splits, B, H, Sq,
// hd), m and l (splits, B, H, Sq) contiguous f32; o_strides: the batch,
// sequence and head strides (elements) of the bf16 output.
extern "C" int fa_decode_combine(const float* acc, const float* m,
                                 const float* l, void* o,
                                 const long long* dims,
                                 const long long* o_strides, void* stream) {
  const long long splits = dims[0], B = dims[1], H = dims[2], Sq = dims[3],
                  hd = dims[4];
  if (splits < 1 || splits > 0x7fffffffLL || B <= 0 || H <= 0 || Sq <= 0 ||
      (hd != 64 && hd != 128))
    return static_cast<int>(cudaErrorInvalidValue);
  CombineParams c;
  c.acc = acc;
  c.m = m;
  c.l = l;
  c.o = o;
  c.splits = static_cast<int>(splits);
  c.H = static_cast<int>(H);
  c.Sq = static_cast<int>(Sq);
  c.rows = B * H * Sq;
  c.o_sb = o_strides[0]; c.o_ss = o_strides[1]; c.o_sh = o_strides[2];
  return launch_combine(c, static_cast<int>(hd), static_cast<cudaStream_t>(stream));
}
