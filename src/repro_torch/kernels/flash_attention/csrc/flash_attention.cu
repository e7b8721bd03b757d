// Flash attention (forward) for Hopper (sm_90a): O = softmax(Q K^T * scale
// + mask) V over q (B, Sq, H, hd) and k, v (B, Sk, KV, hd) with GQA, f32
// softmax state, bf16 or f32 operands.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py
// (_flash_kernel, launched by flash_attention_kernel through pl.pallas_call):
// a (B*H, Sq/BLK_Q, Sk/BLK_K) grid with K innermost, running max m, sum l
// and an f32 accumulator in VMEM scratch across K-steps, rescaled by
// exp(m_prev - m_new), the finite NEG_INF = -1e30 for masked scores, and
// acc / max(l, 1e-30) at the last K-step.  On Hopper the K grid dimension
// becomes a loop inside the block: one block owns one (b*h, Q tile) for the
// whole loop and keeps m, l and the accumulator in registers.
//
// What bounds it on an H100: at the shapes of the port's main path (a yi-6b
// prefill, 4 x 2048 tokens, 32 heads of 128, causal) the work is
// 4 * hd * (live q-k pairs) = 1.4e11 FLOP against 151 MB of q, k, v and o:
// far above the card's ~295 FLOP/byte ridge, so it is bound by operations,
// the tensor-core rate for bf16 and the FFMA rate for f32.  The design
// answers that the plain way first: Q stays in shared memory (and, for bf16,
// in registers as mma fragments) for the whole loop, each K/V tile staged in
// shared memory feeds a 64-row Q tile, QK^T and PV run on mma.sync m16n8k16
// with f32 accumulators (bf16) or on FFMA (f32, never TF32: the f32
// tolerance is 2e-5), and P never leaves registers in the bf16 path.  wgmma,
// TMA and a warp-specialised producer are later work.
//
// bf16 P: like the reference's chunked_attention (which casts p to the value
// dtype before the PV product), the bf16 path rounds P to bf16 for the PV
// mma; the row sum l is taken over the f32 P.  The Pallas kernel keeps P in
// f32; both are inside the 3e-2 bf16 tolerance.
//
// The synchronization is the compiler's output, as in pipelined_matmul.cu.
// The wrapper (ops.py) reads kernel_schedule(2), the K-loop plan of
// repro_torch.kernels.pipelined_matmul.schedule.plan_pipeline(2), and raises
// unless it asks for the waits this kernel has (issue, arrival).  K/V tiles stream through
// a cp.async ring of STAGES = 2 slots; per K-step i:
//
//   arrival wait  cp.async.wait_all + __syncthreads: tile i (and, at the
//                 first step, the Q tile) has landed.  The same barrier
//                 orders every thread's compute of step i-1 before any
//                 thread's refill of its slot, so no credit wait is needed.
//   ISSUE(i)      the block's threads start the copy of tile i+1 into slot
//                 (i+1) mod 2.
//   COMPUTE(i)    S = Q K^T, the masked online softmax, O += P V.
//
// Tiles are skipped through the loop bounds, as the Pallas kernel skips
// them by pl.when: a Q tile's loop starts at the first K tile that reaches
// into the sliding window and ends at the last one the causal frontier
// reaches.  The per-element mask (causal, window, keys past Sk) runs only on
// the tiles that need it.  Query row i sits at position q_offset + i (the
// prefill continuation of the reference's chunked_attention), key j at j.
// Ragged Sq and Sk are masked here: rows past the end are zero-filled by
// cp.async's src-size operand and outputs past Sq are not stored.  The KV
// head of query head h is h / (H / KV); nothing is repeated or copied.
//
// Plain C interface, loaded with ctypes: fa_forward launches on the
// caller's stream and returns the cudaError_t of the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int BQ = 64;  // query rows per block
constexpr int STAGES = 2;  // the K/V ring: kernel_schedule(2)

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int B, H, KV, Sq, Sk;
  long long q_sb, q_ss, q_sh;  // strides in elements: batch, sequence, head
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;
  int causal;
  int window;    // <= 0: none; else keys k > q - window
  int q_offset;  // the position of query row 0
  float scale;
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

// Copy rows [r0, r0 + ROWS) of a (rows x HD) row set (row stride ld
// elements, rows >= n_rows zero-filled) into shared memory s (row stride SS).
template <typename T, int ROWS, int HD, int SS, int THREADS>
__device__ __forceinline__ void load_rows(T* s, const T* g, long long ld,
                                          int r0, int n_rows) {
  constexpr int V = 16 / sizeof(T);  // elements per 16-byte chunk
  constexpr int PER_ROW = HD / V;
  for (int ch = threadIdx.x; ch < ROWS * PER_ROW; ch += THREADS) {
    const int r = ch / PER_ROW;
    const int c = (ch % PER_ROW) * V;
    const bool in = r0 + r < n_rows;
    const T* src = in ? g + static_cast<long long>(r0 + r) * ld + c : g;
    cp_async16(s + r * SS + c, src, in ? 16 : 0);
  }
}

// The K tiles [kt_lo, kt_hi) of size BK that the rows [q0, q0 + BQ) of a
// Q tile reach, and whether tile kt needs the per-element mask.
struct KeyRange {
  int kt_lo, kt_hi;
};

template <int BK>
__device__ __forceinline__ KeyRange key_range(const Params& p, int q0) {
  const int q_last = p.q_offset + min(q0 + BQ, p.Sq) - 1;  // a position
  int k_lo = 0, k_hi = p.Sk;
  if (p.causal) k_hi = min(k_hi, q_last + 1);
  if (p.window > 0) k_lo = max(0, p.q_offset + q0 - p.window + 1);
  KeyRange kr;
  kr.kt_lo = k_lo / BK;
  kr.kt_hi = k_hi > k_lo ? (k_hi + BK - 1) / BK : kr.kt_lo;
  return kr;
}

template <int BK>
__device__ __forceinline__ bool tile_needs_mask(const Params& p, int q0,
                                                int kt) {
  const int k0 = kt * BK, k_last = k0 + BK - 1;
  const int qp0 = p.q_offset + q0, qp_last = qp0 + BQ - 1;  // positions
  return k_last >= p.Sk || (p.causal && k_last > qp0) ||
         (p.window > 0 && k0 <= qp_last - p.window);
}

// whether key kp is live for query row qr (a row of q, at position
// q_offset + qr)
__device__ __forceinline__ bool live(const Params& p, int qr, int kp) {
  const int qp = p.q_offset + qr;
  return kp < p.Sk && (!p.causal || qp >= kp) &&
         (p.window <= 0 || kp > qp - p.window);
}

// --------------------------------------------------------------------- //
// bf16: four warps, each owning 16 query rows of the 64-row Q tile.  K/V
// tiles of 64 keys.  Fragments come from shared memory through ldmatrix
// (V through its transposing form); the S accumulator turns into the A
// operand of the PV product in registers.
// --------------------------------------------------------------------- //

constexpr int BF_BK = 64;
constexpr int BF_THREADS = 128;

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

template <int HD>
struct BfLayout {
  static constexpr int SS = HD + 8;  // row stride in elements (16-byte pad)
  static constexpr int Q_ELEMS = BQ * SS;
  static constexpr int KV_ELEMS = BF_BK * SS;  // one K (or V) tile
  static constexpr size_t bytes() {
    return (Q_ELEMS + 2 * STAGES * KV_ELEMS) * sizeof(__nv_bfloat16);
  }
};

template <int HD>
__global__ void __launch_bounds__(BF_THREADS)
    flash_bf16_kernel(const Params p) {
  using L = BfLayout<HD>;
  constexpr int SS = L::SS;
  constexpr int NT = BF_BK / 8;  // S n-tiles per warp row block
  constexpr int OT = HD / 8;     // O n-tiles
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* ring = qs + L::Q_ELEMS;

  const int bh = blockIdx.x;
  const int qt = gridDim.y - 1 - blockIdx.y;  // longest causal rows first
  const int b = bh / p.H, h = bh % p.H, kvh = h / (p.H / p.KV);
  const int q0 = qt * BQ;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, t = lane % 4;

  const __nv_bfloat16* qg = static_cast<const __nv_bfloat16*>(p.q) +
                            b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* kg = static_cast<const __nv_bfloat16*>(p.k) +
                            b * p.k_sb + kvh * p.k_sh;
  const __nv_bfloat16* vg = static_cast<const __nv_bfloat16*>(p.v) +
                            b * p.v_sb + kvh * p.v_sh;

  const KeyRange kr = key_range<BF_BK>(p, q0);

  auto issue = [&](int kt) {
    __nv_bfloat16* ks = ring + ((kt - kr.kt_lo) % STAGES) * 2 * L::KV_ELEMS;
    load_rows<__nv_bfloat16, BF_BK, HD, SS, BF_THREADS>(ks, kg, p.k_ss,
                                                        kt * BF_BK, p.Sk);
    load_rows<__nv_bfloat16, BF_BK, HD, SS, BF_THREADS>(
        ks + L::KV_ELEMS, vg, p.v_ss, kt * BF_BK, p.Sk);
    cp_async_commit();
  };

  load_rows<__nv_bfloat16, BQ, HD, SS, BF_THREADS>(qs, qg, p.q_ss, q0, p.Sq);
  cp_async_commit();
  if (kr.kt_lo < kr.kt_hi) issue(kr.kt_lo);

  uint32_t qf[HD / 16][4];
  float o[OT][4];
#pragma unroll
  for (int j = 0; j < OT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.0f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.0f, 0.0f};
  const int row0 = q0 + warp * 16 + g;  // this thread's rows: row0, row0 + 8

  for (int kt = kr.kt_lo; kt < kr.kt_hi; ++kt) {
    cp_async_wait_all();
    __syncthreads();  // arrival wait (LOAD -> COMPUTE)
    if (kt + 1 < kr.kt_hi) issue(kt + 1);  // ISSUE(kt)
    if (kt == kr.kt_lo) {
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        ldmatrix_x4(qf[kk], qs + (warp * 16 + lane % 16) * SS + kk * 16 +
                                (lane / 16) * 8);
    }
    const __nv_bfloat16* ks =
        ring + ((kt - kr.kt_lo) % STAGES) * 2 * L::KV_ELEMS;
    const __nv_bfloat16* vs = ks + L::KV_ELEMS;

    // S = Q K^T (16 rows x 64 keys per warp)
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

    // scale, mask, online softmax (rows row0 and row0 + 8; a row's 64
    // scores are spread over the 4 threads of a quad)
    const bool masked = tile_needs_mask<BF_BK>(p, q0, kt);
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * p.scale;
        if (masked) {
          const int qr = row0 + (e / 2) * 8;
          const int kp = kt * BF_BK + j * 8 + 2 * t + (e % 2);
          if (!live(p, qr, kp)) x = NEG_INF;
        }
        s[j][e] = x;
      }
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < NT; ++j)
        mx = fmaxf(mx, fmaxf(s[j][2 * rr], s[j][2 * rr + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[rr], mx);
      const float corr = expf(m[rr] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float pv = expf(s[j][2 * rr + e] - m_new);
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

    // O += P V: the S accumulator of key tiles 2kk, 2kk+1 is the A fragment
    // of the kk-th 16-key step
#pragma unroll
    for (int kk = 0; kk < BF_BK / 16; ++kk) {
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
  cp_async_wait_all();  // an empty key range leaves the Q copy in flight

  __nv_bfloat16* og = static_cast<__nv_bfloat16*>(p.o) + b * p.o_sb +
                      h * p.o_sh;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int qp = row0 + rr * 8;
    if (qp >= p.Sq) continue;
    const float inv = 1.0f / fmaxf(l[rr], 1e-30f);
    __nv_bfloat16* row = og + static_cast<long long>(qp) * p.o_ss;
#pragma unroll
    for (int j = 0; j < OT; ++j)
      *reinterpret_cast<__nv_bfloat162*>(row + j * 8 + 2 * t) =
          __floats2bfloat162_rn(o[j][2 * rr] * inv, o[j][2 * rr + 1] * inv);
  }
}

// --------------------------------------------------------------------- //
// f32: FFMA on CUDA cores, 256 threads as 16 (ty) x 16 (tx).  Thread (ty,
// tx) owns query rows ty + 16 i (i < 4), score columns tx + 16 j of a
// 32-key tile (j < 2) and output columns tx + 16 j (j < HD / 16).  P goes
// through shared memory between the two products.
// --------------------------------------------------------------------- //

constexpr int F_BK = 32;
constexpr int F_THREADS = 256;

template <int HD>
struct F32Layout {
  static constexpr int SS = HD + 4;      // Q/K/V row stride (16-byte rows)
  static constexpr int PS = F_BK + 1;    // P row stride
  static constexpr int Q_ELEMS = BQ * SS;
  static constexpr int KV_ELEMS = F_BK * SS;
  static constexpr int P_ELEMS = BQ * PS;
  static constexpr size_t bytes() {
    return (Q_ELEMS + 2 * STAGES * KV_ELEMS + P_ELEMS) * sizeof(float);
  }
};

template <int HD>
__global__ void __launch_bounds__(F_THREADS)
    flash_f32_kernel(const Params p) {
  using L = F32Layout<HD>;
  constexpr int SS = L::SS, PS = L::PS;
  constexpr int OJ = HD / 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* qs = reinterpret_cast<float*>(smem_raw);
  float* ps = qs + L::Q_ELEMS;
  float* ring = ps + L::P_ELEMS;

  const int bh = blockIdx.x;
  const int qt = gridDim.y - 1 - blockIdx.y;
  const int b = bh / p.H, h = bh % p.H, kvh = h / (p.H / p.KV);
  const int q0 = qt * BQ;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  const float* qg = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* kg = static_cast<const float*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const float* vg = static_cast<const float*>(p.v) + b * p.v_sb + kvh * p.v_sh;

  const KeyRange kr = key_range<F_BK>(p, q0);

  auto issue = [&](int kt) {
    float* ks = ring + ((kt - kr.kt_lo) % STAGES) * 2 * L::KV_ELEMS;
    load_rows<float, F_BK, HD, SS, F_THREADS>(ks, kg, p.k_ss, kt * F_BK, p.Sk);
    load_rows<float, F_BK, HD, SS, F_THREADS>(ks + L::KV_ELEMS, vg, p.v_ss,
                                              kt * F_BK, p.Sk);
    cp_async_commit();
  };

  load_rows<float, BQ, HD, SS, F_THREADS>(qs, qg, p.q_ss, q0, p.Sq);
  cp_async_commit();
  if (kr.kt_lo < kr.kt_hi) issue(kr.kt_lo);

  float o[4][OJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < OJ; ++j) o[i][j] = 0.0f;
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.0f;
  }

  for (int kt = kr.kt_lo; kt < kr.kt_hi; ++kt) {
    cp_async_wait_all();
    __syncthreads();  // arrival wait (LOAD -> COMPUTE)
    if (kt + 1 < kr.kt_hi) issue(kt + 1);  // ISSUE(kt)
    const float* ks = ring + ((kt - kr.kt_lo) % STAGES) * 2 * L::KV_ELEMS;
    const float* vs = ks + L::KV_ELEMS;

    float s[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) s[i][0] = s[i][1] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      float4 qv[4], kv[2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(qs + (ty + 16 * i) * SS + d);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        kv[j] = *reinterpret_cast<const float4*>(ks + (tx + 16 * j) * SS + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
          s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
          s[i][j] = fmaf(qv[i].z, kv[j].z, s[i][j]);
          s[i][j] = fmaf(qv[i].w, kv[j].w, s[i][j]);
        }
    }

    const bool masked = tile_needs_mask<F_BK>(p, q0, kt);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qr = q0 + ty + 16 * i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        float x = s[i][j] * p.scale;
        if (masked && !live(p, qr, kt * F_BK + tx + 16 * j)) x = NEG_INF;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = 1; off < 16; off *= 2)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float pv = expf(s[i][j] - m_new);
        ps[(ty + 16 * i) * PS + tx + 16 * j] = pv;
        sum += pv;
      }
#pragma unroll
      for (int off = 1; off < 16; off *= 2)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < OJ; ++j) o[i][j] *= corr;
    }
    __syncthreads();  // P complete

#pragma unroll 4
    for (int c = 0; c < F_BK; ++c) {
      float pr[4], vv[OJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) pr[i] = ps[(ty + 16 * i) * PS + c];
#pragma unroll
      for (int j = 0; j < OJ; ++j) vv[j] = vs[c * SS + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < OJ; ++j) o[i][j] = fmaf(pr[i], vv[j], o[i][j]);
    }
  }
  cp_async_wait_all();

  float* og = static_cast<float*>(p.o) + b * p.o_sb + h * p.o_sh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q0 + ty + 16 * i;
    if (qp >= p.Sq) continue;
    const float inv = 1.0f / fmaxf(l[i], 1e-30f);
    float* row = og + static_cast<long long>(qp) * p.o_ss;
#pragma unroll
    for (int j = 0; j < OJ; ++j) row[tx + 16 * j] = o[i][j] * inv;
  }
}

template <typename Kernel>
int launch(Kernel kernel, int threads, size_t smem, const Params& p,
           void* stream) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(p.B * p.H, (p.Sq + BQ - 1) / BQ);
  kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int launch_hd(int dtype, const Params& p, void* stream) {
  if (dtype == 1)
    return launch(flash_bf16_kernel<HD>, BF_THREADS,
                  BfLayout<HD>::bytes(), p, stream);
  return launch(flash_f32_kernel<HD>, F_THREADS, F32Layout<HD>::bytes(),
                p, stream);
}

}  // namespace

// dtype: 0 float32, 1 bfloat16.  dims: B, H, KV, Sq, Sk, hd.  strides: the
// batch, sequence and head strides (elements) of q, k, v and o in turn.
// q_offset: the position of query row 0.
extern "C" int fa_forward(int dtype, const void* q, const void* k,
                          const void* v, void* o, const long long* dims,
                          const long long* strides, int causal, int window,
                          int q_offset, float scale, void* stream) {
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.B = static_cast<int>(dims[0]);
  p.H = static_cast<int>(dims[1]);
  p.KV = static_cast<int>(dims[2]);
  p.Sq = static_cast<int>(dims[3]);
  p.Sk = static_cast<int>(dims[4]);
  const long long hd = dims[5];
  p.q_sb = strides[0]; p.q_ss = strides[1]; p.q_sh = strides[2];
  p.k_sb = strides[3]; p.k_ss = strides[4]; p.k_sh = strides[5];
  p.v_sb = strides[6]; p.v_ss = strides[7]; p.v_sh = strides[8];
  p.o_sb = strides[9]; p.o_ss = strides[10]; p.o_sh = strides[11];
  p.causal = causal;
  p.window = window;
  p.q_offset = q_offset;
  p.scale = scale;
  if (p.B <= 0 || p.H <= 0 || p.KV <= 0 || p.H % p.KV || p.Sq <= 0 ||
      p.Sk <= 0 || (p.Sq + BQ - 1) / BQ > 65535 ||
      q_offset < -0x3fffffff || q_offset > 0x3fffffff ||
      dims[3] > 0x3fffffffLL || dims[4] > 0x3fffffffLL ||
      (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  switch (hd) {
    case 16: return launch_hd<16>(dtype, p, stream);
    case 32: return launch_hd<32>(dtype, p, stream);
    case 64: return launch_hd<64>(dtype, p, stream);
    case 128: return launch_hd<128>(dtype, p, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
