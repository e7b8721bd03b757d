// Pipelined blocked matmul for Hopper (sm_90a): C[M,N] = A[M,K] @ B[K,N],
// row-major operands, f32 or bf16, f32 accumulation.
//
// Replaces the TPU kernel src/repro/kernels/pipelined_matmul/kernel.py
// (_matmul_kernel, launched by pipelined_matmul through pl.pallas_call): a
// (M/BM, N/BN, K/BK) grid with K innermost, an f32 accumulator zeroed at
// k = 0 and cast to the input dtype after the last k.  On Hopper the K grid
// dimension becomes a loop inside the block, and each block owns one output
// tile for the whole loop.
//
// What bounds it on an H100: at the shapes the port drives it with (a
// 2048-token prefill through yi-6b's MLP, 2048 x 4096 x 11008 and back) the
// work is 2MNK = 185 GFLOP against ~150 MB of bf16 operands, far above the
// card's ~295 FLOP/byte ridge, so it is bound by operations: the tensor-core
// rate for bf16, the CUDA-core FFMA rate for f32.  The design answers that
// with 128 x 128 block tiles (every operand byte staged in shared memory
// feeds 128 multiply-adds), mma.sync m16n8k16 with f32 accumulators for
// bf16, and FFMA for f32 (one TF32 product misses the f32 tolerance of
// 2e-5 sqrt(K); f32 operands that TMA can describe take the tensor cores in
// 3xTF32 instead, tma_wgmma_tf32x3.cu, and bf16 ones tma_wgmma_matmul.cu).
// The TPU's 128^3 f32 tiles (256 KB for two stages) do not fit the 227 KB
// of shared memory and are not copied.
//
// The synchronization is the compiler's output, not constants.  The wrapper
// (ops.py) reads the K-loop plan of
// repro_torch.kernels.pipelined_matmul.schedule.plan_pipeline(depth), maps
// every retained cross-processor dependence to one wait of this kernel, and
// passes:
//
//   stages  the shared-memory ring depth D (the plan's buffer depth);
//   credit  1 when the slot-reuse anti dependence COMPUTE -> LOAD survived
//           the transitive reduction (only at D = 1).
//
// ISSUE and COMPUTE share one processor in the plan (the block's threads),
// LOAD runs on the copy engine (cp.async).  Per K-step i:
//
//   arrival wait  cp.async.wait_all + __syncthreads: tile i has landed in
//                 slot i mod D (the retained LOAD -> COMPUTE flow).  The same
//                 barrier orders every thread's COMPUTE(i-1) before any
//                 thread's ISSUE(i): the processor order through which the
//                 reduction covered the anti dependence at D >= 2.
//   ISSUE(i)      the block's threads start the copy of tile i+1 into slot
//                 (i+1) mod D (prefetch distance 1, the ISSUE -> LOAD flow:
//                 a copy starts only once issued, by program order).
//   COMPUTE(i)    accumulate from slot i mod D.
//   credit wait   only with `credit`: a second __syncthreads after
//                 COMPUTE(i) and before the refill of the slot just read.
//
// So D >= 2 takes one barrier per K-step and overlaps the copy of tile i+1
// with the compute of tile i; D = 1 takes two and overlaps nothing.
//
// Ragged edges are masked here, with no padding copy on the host: operand
// bytes past the matrix are zero-filled by cp.async's src-size operand, and
// outputs past it are not stored.  The 16-byte copy path needs row strides
// and base addresses that are multiples of 16 bytes (`vec`); other shapes
// take an element-granular path (4-byte cp.async for f32, plain loads for
// bf16) through the same ring and barriers.
//
// Plain C interface, loaded with ctypes: each entry point launches on the
// caller's stream and returns the cudaError_t of the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;
constexpr int BN = 128;
constexpr int THREADS = 256;
constexpr int MAX_STAGES = 4;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// cp.async with zero fill: copies src_bytes (<= the copy size) and writes
// zeros to the rest of the destination.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
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

// Copy the ROWS x COLS tile at (r0, c0) of the row-major rows x cols matrix
// g (leading dimension ld) into shared memory s (row stride SS elements).
template <typename T, int ROWS, int COLS, int SS, bool VEC>
__device__ __forceinline__ void load_tile(T* s, const T* g, int rows,
                                          int cols, int ld, int r0, int c0) {
  const int tid = threadIdx.x;
  if constexpr (VEC) {
    constexpr int V = 16 / sizeof(T);  // elements per 16-byte chunk
    constexpr int CHUNKS = ROWS * COLS / V;
    static_assert(CHUNKS % THREADS == 0, "tile must split evenly");
#pragma unroll
    for (int i = 0; i < CHUNKS / THREADS; ++i) {
      const int ch = tid + i * THREADS;
      const int r = ch / (COLS / V);
      const int c = (ch % (COLS / V)) * V;
      const int gr = r0 + r, gc = c0 + c;
      int valid = 0;
      if (gr < rows && gc < cols) valid = min(V, cols - gc);
      const T* src = valid > 0 ? g + static_cast<size_t>(gr) * ld + gc : g;
      cp_async16(s + r * SS + c, src, valid * static_cast<int>(sizeof(T)));
    }
  } else {
    constexpr int ELEMS = ROWS * COLS;
    static_assert(ELEMS % THREADS == 0, "tile must split evenly");
#pragma unroll 4
    for (int i = 0; i < ELEMS / THREADS; ++i) {
      const int e = tid + i * THREADS;
      const int r = e / COLS, c = e % COLS;
      const int gr = r0 + r, gc = c0 + c;
      const bool in = gr < rows && gc < cols;
      const T* src = in ? g + static_cast<size_t>(gr) * ld + gc : g;
      if constexpr (sizeof(T) == 4) {
        cp_async4(s + r * SS + c, src, in ? 4 : 0);
      } else {
        // there is no 2-byte cp.async: a plain load into the same ring
        // slot, published by the arrival barrier like an async copy
        s[r * SS + c] = in ? *src : T(0.0f);
      }
    }
  }
}

// --------------------------------------------------------------------- //
// f32: FFMA on CUDA cores.  Block tile 128 x 128 x 16; thread (tx, ty) of a
// 16 x 16 layout owns rows ty + 16 i and columns 4 tx + 64 h + q of the
// output (i < 8, h < 2, q < 4).
// --------------------------------------------------------------------- //

constexpr int F32_BK = 16;
constexpr int F32_AS = F32_BK + 4;  // A row stride in floats (80-byte rows)
constexpr int F32_BS = BN + 4;      // B row stride in floats (528-byte rows)
constexpr int F32_STAGE = BM * F32_AS + F32_BK * F32_BS;  // floats

template <bool VEC>
__global__ void __launch_bounds__(THREADS)
    matmul_f32_kernel(const float* __restrict__ A, const float* __restrict__ B,
                      float* __restrict__ C, int M, int N, int K, int stages,
                      int credit) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* smem = reinterpret_cast<float*>(smem_raw);
  const int bm = blockIdx.y * BM, bn = blockIdx.x * BN;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int n_k = (K + F32_BK - 1) / F32_BK;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  auto issue = [&](int kt) {
    float* as = smem + (kt % stages) * F32_STAGE;
    float* bs = as + BM * F32_AS;
    load_tile<float, BM, F32_BK, F32_AS, VEC>(as, A, M, K, K, bm, kt * F32_BK);
    load_tile<float, F32_BK, BN, F32_BS, VEC>(bs, B, K, N, N, kt * F32_BK, bn);
    cp_async_commit();
  };

  issue(0);
  for (int kt = 0; kt < n_k; ++kt) {
    cp_async_wait_all();
    __syncthreads();  // arrival wait (LOAD -> COMPUTE)
    if (!credit && kt + 1 < n_k) issue(kt + 1);  // ISSUE(kt)
    const float* as = smem + (kt % stages) * F32_STAGE;
    const float* bs = as + BM * F32_AS;
#pragma unroll
    for (int k = 0; k < F32_BK; ++k) {
      float a[8], b[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = as[(ty + 16 * i) * F32_AS + k];
      const float4 b0 =
          *reinterpret_cast<const float4*>(bs + k * F32_BS + 4 * tx);
      const float4 b1 =
          *reinterpret_cast<const float4*>(bs + k * F32_BS + 64 + 4 * tx);
      b[0] = b0.x; b[1] = b0.y; b[2] = b0.z; b[3] = b0.w;
      b[4] = b1.x; b[5] = b1.y; b[6] = b1.z; b[7] = b1.w;
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    if (credit && kt + 1 < n_k) {
      __syncthreads();  // credit wait (COMPUTE -> LOAD): the slot is free
      issue(kt + 1);    // ISSUE(kt) into the slot just read
    }
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = bm + ty + 16 * i;
    if (r >= M) continue;
    float* row = C + static_cast<size_t>(r) * N;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = bn + 64 * h + 4 * tx;
      const float* v = &acc[i][4 * h];
      if (VEC && c + 3 < N) {
        *reinterpret_cast<float4*>(row + c) = make_float4(v[0], v[1], v[2], v[3]);
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (c + q < N) row[c + q] = v[q];
      }
    }
  }
}

// --------------------------------------------------------------------- //
// bf16: mma.sync m16n8k16 with f32 accumulators.  Block tile 128 x 128 x
// 32, eight warps as 2 (M) x 4 (N), each warp a 64 x 32 tile of 4 x 4 mma
// tiles.  Fragments come from shared memory through ldmatrix (B through its
// transposing form, since B is stored k-major).
// --------------------------------------------------------------------- //

constexpr int BF_BK = 32;
constexpr int BF_AS = BF_BK + 8;  // A row stride in elements (80-byte rows)
constexpr int BF_BS = BN + 8;     // B row stride in elements (272-byte rows)
constexpr int BF_STAGE = BM * BF_AS + BF_BK * BF_BS;  // elements

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

template <bool VEC>
__global__ void __launch_bounds__(THREADS)
    matmul_bf16_kernel(const __nv_bfloat16* __restrict__ A,
                       const __nv_bfloat16* __restrict__ B,
                       __nv_bfloat16* __restrict__ C, int M, int N, int K,
                       int stages, int credit) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* smem = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  const int bm = blockIdx.y * BM, bn = blockIdx.x * BN;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int wm = (warp / 4) * 64, wn = (warp % 4) * 32;
  const int n_k = (K + BF_BK - 1) / BF_BK;

  float acc[4][4][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mi][ni][q] = 0.0f;

  auto issue = [&](int kt) {
    __nv_bfloat16* as = smem + (kt % stages) * BF_STAGE;
    __nv_bfloat16* bs = as + BM * BF_AS;
    load_tile<__nv_bfloat16, BM, BF_BK, BF_AS, VEC>(as, A, M, K, K, bm,
                                                    kt * BF_BK);
    load_tile<__nv_bfloat16, BF_BK, BN, BF_BS, VEC>(bs, B, K, N, N,
                                                    kt * BF_BK, bn);
    cp_async_commit();
  };

  issue(0);
  for (int kt = 0; kt < n_k; ++kt) {
    cp_async_wait_all();
    __syncthreads();  // arrival wait (LOAD -> COMPUTE)
    if (!credit && kt + 1 < n_k) issue(kt + 1);  // ISSUE(kt)
    const __nv_bfloat16* as = smem + (kt % stages) * BF_STAGE;
    const __nv_bfloat16* bs = as + BM * BF_AS;
#pragma unroll
    for (int kk = 0; kk < BF_BK; kk += 16) {
      uint32_t af[4][4], bf[2][4];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
        ldmatrix_x4(af[mi], as + (wm + mi * 16 + lane % 16) * BF_AS + kk +
                                (lane / 16) * 8);
#pragma unroll
      for (int p = 0; p < 2; ++p)
        ldmatrix_x4_trans(bf[p], bs + (kk + lane % 16) * BF_BS + wn + p * 16 +
                                     (lane / 16) * 8);
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
          mma_bf16(acc[mi][ni], af[mi], bf[ni / 2][(ni % 2) * 2],
                   bf[ni / 2][(ni % 2) * 2 + 1]);
    }
    if (credit && kt + 1 < n_k) {
      __syncthreads();  // credit wait (COMPUTE -> LOAD): the slot is free
      issue(kt + 1);    // ISSUE(kt) into the slot just read
    }
  }

  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = bm + wm + mi * 16 + g + 8 * h;
        const int c = bn + wn + ni * 8 + 2 * t;
        if (r >= M) continue;
        __nv_bfloat16* out = C + static_cast<size_t>(r) * N + c;
        const float v0 = acc[mi][ni][2 * h], v1 = acc[mi][ni][2 * h + 1];
        if (VEC && c + 1 < N) {
          *reinterpret_cast<__nv_bfloat162*>(out) = __floats2bfloat162_rn(v0, v1);
        } else {
          if (c < N) out[0] = __float2bfloat16_rn(v0);
          if (c + 1 < N) out[1] = __float2bfloat16_rn(v1);
        }
      }
}

bool bad_args(int M, int N, int K, int stages, int credit) {
  // a one-barrier step refills slot (i+1) mod D while slot i mod D is read,
  // so it needs a second slot; a single slot needs the credit wait
  return M <= 0 || N <= 0 || K <= 0 || stages < 1 || stages > MAX_STAGES ||
         (!credit && stages < 2) || (M + BM - 1) / BM > 65535;
}

template <typename T>
int launch(void (*kernel)(const T*, const T*, T*, int, int, int, int, int),
           size_t stage_bytes, const void* A, const void* B, void* C, int M,
           int N, int K, int stages, int credit, void* stream) {
  if (bad_args(M, N, K, stages, credit))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(stages) * stage_bytes;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(A), static_cast<const T*>(B), static_cast<T*>(C),
      M, N, K, stages, credit);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int pm_matmul_f32(const void* A, const void* B, void* C, int M,
                             int N, int K, int stages, int credit, int vec,
                             void* stream) {
  return launch<float>(
      vec ? matmul_f32_kernel<true> : matmul_f32_kernel<false>,
      F32_STAGE * sizeof(float), A, B, C, M, N, K, stages, credit, stream);
}

extern "C" int pm_matmul_bf16(const void* A, const void* B, void* C, int M,
                              int N, int K, int stages, int credit, int vec,
                              void* stream) {
  return launch<__nv_bfloat16>(
      vec ? matmul_bf16_kernel<true> : matmul_bf16_kernel<false>,
      BF_STAGE * sizeof(__nv_bfloat16), A, B, C, M, N, K, stages, credit,
      stream);
}
