// f32 matmul for Hopper (sm_90a) on the tensor cores, in 3xTF32: C[M,N] =
// A[M,K] @ B[K,N], row-major f32 operands, f32 result.
//
// Replaces, for every f32 operand pair, the TPU kernel
// src/repro/kernels/pipelined_matmul/kernel.py (_matmul_kernel, launched by
// pipelined_matmul through pl.pallas_call): a (M/BM, N/BN, K/BK) grid with
// K innermost and an f32 accumulator in VMEM scratch.  Here the K grid
// dimension is a loop inside the block, and each block owns one output tile
// for the whole loop.  bf16 operands take tma_wgmma_matmul.cu (ops.route()
// decides by the dtype; it is a rule, not a fallback).
//
// What bounds it on an H100: at the shapes the port drives it with (a
// 2048-token prefill through yi-6b's MLP, 2048 x 4096 x 11008 and back) the
// work is 2MNK = 185 GFLOP.  On the CUDA cores that is 2.76 ms at 67 TFLOP/s
// of FFMA, which an FFMA kernel of the first port reached to 52 % and
// cuBLAS's SGEMM to 74 %: no FFMA kernel can beat SGEMM by much.  The tensor cores run TF32 at
// 495 TFLOP/s, but one TF32 product keeps 11 significant bits of each
// operand and misses the f32 limit (2e-5 sqrt(K) + 2e-5 |C|) by some forty
// times.  So each operand is split, x = hi + lo with hi = rna_tf32(x) and
// lo = rna_tf32(x - hi), and the product is the three TF32 products
// a_lo b_hi + a_hi b_lo + a_hi b_hi (a_lo b_lo, some 2^-22 of the product,
// is dropped): the GPU form of a TPU's bf16_3x for an f32 product at
// precision HIGH.  That is 3 x 185 GFLOP, 1.12 ms at 495 TFLOP/s, the split
// excluded.
//
// Two kernels, one source:
//
//   split_tf32   the pre-pass.  It reads a row-major f32 matrix once and
//                writes hi and lo as two f32 arrays of TF32 values, both
//                K-major: A (M, K) keeps its layout, B (K, N) is written
//                transposed, (N, K), through a shared-memory tile so that
//                reads and writes stay coalesced.  wgmma takes .tf32
//                operands only K-major from shared memory (the transpose
//                bits exist for f16 / bf16 only), so B has to be transposed
//                somewhere; the split has to happen somewhere too.  Both
//                are written at a leading dimension ld = K rounded up to 4,
//                TMA's 16-byte row stride, whatever K, N and the source's
//                base are: the reference zero-pads its operands before
//                pl.pallas_call, and the split, which rewrites them anyway,
//                pads them here at no launch more.  The product's tensor
//                maps keep the true K with the stride ld, so TMA zero-fills
//                past K and the padding is never read.  Rows are read
//                whatever their alignment: the row split with one or two
//                16-byte aligned loads a 16-byte chunk (hopper::
//                ld_window16), the transposing split 16 bytes at a time
//                where its rows allow it and one element at a time (masked)
//                where they do not.  It is bound by bytes: 4 read and 8
//                written an element.
//
//   matmul_tf32x3  the product, in tma_wgmma_matmul.cu's shape: one producer
//                warpgroup whose elected thread issues cp.async.bulk.tensor
//                copies of the four K-major operands (A_hi, A_lo: 128 x 32
//                boxes; B_hi, B_lo: 128 x 32 boxes of the (N, K) arrays) into
//                a ring of D stages of 64 KB; two consumer warpgroups of 64
//                rows, each issuing wgmma m64n128k8 f32.tf32.tf32 SS
//                products over a 128 x 128 block tile.  A K-step is 32 f32 =
//                128 bytes, one 128-byte-swizzled box wide; in each K-step the
//                two small products (a_lo b_hi, a_hi b_lo) of its four k8
//                slices go first, then a_hi b_hi.  setmaxnreg moves
//                registers from the producer (40) to the consumers (232).
//
// Partial sums are promoted every RUN_K of K.  The tensor core adds each k8
// slice into its f32 accumulator with a rounding of its own; earlier NVIDIA
// tensor cores were measured to truncate there.  In emulation
// (tests/test_torch_matmul.py) a truncating accumulator carried over all
// of K = 11008 misses the limit, while one restarted every 256 of K and
// added into a register sum by one round-to-nearest FADD stays far inside
// it; the same file pins RUN_K to ops.TF32X3_RUN_K.  So each run of at
// most RUN_K starts its wgmma accumulator afresh (scale-d 0 on its first
// product); at the run's end wgmma.wait_group 0 retires it and a consumer
// thread adds its 64 accumulators into 64 sum registers.  A ragged last
// run, and K shorter than one run or one K-step, end the same way.  A
// consumer thread holds 128 f32 (accumulator and sum): a 128 x 256 tile
// would need 256 and does not fit 255 registers, so the block tile is 128
// x 128.
//
// The synchronization is the compiler's output, not constants.  The wrapper
// (ops.py) plans the K-loop with hopper_schedule(depth) (ISSUE and LOAD on
// the producer, COMPUTE on the consumers), which keeps exactly two
// cross-processor dependences at every depth D; each is one mbarrier a ring
// slot:
//
//   full[s]   LOAD -> COMPUTE, distance 0.  The producer arrives once with
//             expect_tx of the stage's 64 KB (TMA counts the zero fill past a
//             ragged edge as bytes too); the consumers wait on it before
//             reading slot s.
//   empty[s]  COMPUTE -> LOAD, distance D (slot reuse).  One thread of each
//             consumer warpgroup arrives (count 2) once the wgmma group that
//             read slot s has RETIRED.  Within a run (D >= 2) the consumers
//             commit step i's group, wait_group 1 retires step i-1's, and
//             only then release slot (i-1) mod D.  At a run's end (and at
//             every step when D = 1) wait_group 0 retires everything, and
//             both the pending release of step i-1's slot, if any, and step
//             i's are made there, so each slot is released exactly once a
//             round.  The producer waits on empty[s] before it refills s.
//
// Parity as in tma_wgmma_matmul.cu: slot s of K-step i is in round r = i /
// D; consumers wait on full[s] with parity r & 1, the producer on empty[s]
// with (r & 1) ^ 1.  The host entry point refuses a schedule without both
// waits.  The default depth is the deepest ring that fits the 227 KB of
// shared memory: 3 stages of 64 KB.
//
// Layouts: stages are 1024-byte aligned (the 128-byte swizzle repeats every
// 1024 bytes).  Every operand is K-major with 128-byte rows: SBO 1024 (the
// next 8 rows), a k8 slice 32 bytes along the row; consumer c's 64 rows of
// A start 8 KB into the A box.
//
// Operands: any M, N and K; the split halves at 16-byte aligned bases with
// the leading dimension ld (a multiple of 4).  Ragged M and N are
// zero-filled by TMA and masked in the epilogue, which stores f32 pairs
// from registers where N is even and single values where it is odd (a
// pair at row * N + col would be misaligned on every other row), one
// instantiation each; ragged K is zero-filled by TMA.
//
// Plain C interface, loaded with ctypes; the tensor maps are encoded on the
// host per call (cuTensorMapEncodeTiled, fetched from the CUDA driver at
// run time) and passed as __grid_constant__ parameters.

#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int BM = 128;                      // two consumer warpgroups
constexpr int BN = 128;                      // one m64n128k8 wide
constexpr int BK = 32;                       // 128 bytes of f32
constexpr int RUN_K = 256;                   // K of one promotion run
constexpr int RUN_STEPS = RUN_K / BK;
constexpr int THREADS = 384;                 // producer + 2 consumers
constexpr int MAX_STAGES = 3;                // 3 x 64 KB of the 227 KB
constexpr int A_BYTES = BM * BK * 4;         // 16 KB, one of A_hi, A_lo
constexpr int A_HALF_BYTES = A_BYTES / 2;    // one consumer's 64 rows
constexpr int B_BYTES = BN * BK * 4;         // 16 KB, one of B_hi, B_lo
constexpr int STAGE_BYTES = 2 * A_BYTES + 2 * B_BYTES;  // 64 KB
constexpr int SMEM_BYTES_EXTRA = 1024 + 2 * MAX_STAGES * 8;  // align, bars
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;
constexpr int SPLIT_THREADS = 256;
constexpr int SPLIT_WARPS = SPLIT_THREADS / 32;  // rows a row-split block takes
constexpr int TILE = 32;                     // the transposing split's tile

static_assert(RUN_K % BK == 0, "a run is whole K-steps");
static_assert(STAGE_BYTES % 1024 == 0, "stages must stay 1024-byte aligned");
static_assert(MAX_STAGES * STAGE_BYTES + SMEM_BYTES_EXTRA <= 232448,
              "the ring must fit the 227 KB of shared memory");
static_assert(128 * PRODUCER_REGS + 256 * CONSUMER_REGS <= 65536,
              "the register split must fit the SM's file");

// --------------------------------------------------------------------- //
// The split pre-pass
// --------------------------------------------------------------------- //

__device__ __forceinline__ void split4(const float4 v, float4& h, float4& l) {
  h.x = hopper::rna_tf32(v.x);
  h.y = hopper::rna_tf32(v.y);
  h.z = hopper::rna_tf32(v.z);
  h.w = hopper::rna_tf32(v.w);
  l.x = hopper::rna_tf32(v.x - h.x);  // x - hi is exact in f32
  l.y = hopper::rna_tf32(v.y - h.y);
  l.z = hopper::rna_tf32(v.z - h.z);
  l.w = hopper::rna_tf32(v.w - h.w);
}

// hi, lo of the row-major rows x cols x (any 4-byte aligned base), written
// as row-major rows x (4 * chunks) arrays, chunks = ceil(cols / 4).  Block
// (32, SPLIT_WARPS): a warp takes 32 neighbouring 16-byte chunks of a row,
// the block SPLIT_WARPS rows of them, striding over the rows by the grid.
// The chunk holding a row's last columns is zero past them (the split of
// 0).
__global__ void __launch_bounds__(SPLIT_THREADS)
    split_rows_kernel(const float* __restrict__ x, float4* __restrict__ hi,
                      float4* __restrict__ lo, int rows, int cols,
                      int chunks) {
  const int c = blockIdx.x * 32 + threadIdx.x;
  if (c >= chunks) return;
  const int live = min(4, cols - 4 * c);  // floats of the chunk
  for (int r = blockIdx.y * SPLIT_WARPS + threadIdx.y; r < rows;
       r += gridDim.y * SPLIT_WARPS) {
    const uint4 w =
        hopper::ld_window16(x + static_cast<size_t>(r) * cols + 4 * c, 4 * live);
    float4 h, l;
    split4(make_float4(__uint_as_float(w.x), __uint_as_float(w.y),
                       __uint_as_float(w.z), __uint_as_float(w.w)),
           h, l);
    const size_t at = static_cast<size_t>(r) * chunks + c;
    hi[at] = h;
    lo[at] = l;
  }
}

// hi, lo of the row-major rows x cols x, written as the row-major cols x ld
// arrays of its transpose (ld = rows rounded up to 4; the columns past rows
// are zero).  A block moves a 32 x 32 tile through shared memory (row
// stride 33: neither phase has a bank conflict); each thread reads four
// neighbouring values along a row of x and writes one float4 along a row of
// the transpose.  With VEC (cols % 4 == 0 and a 16-byte aligned base) the
// four are one float4, in or out of the matrix as a whole; without it they
// are four masked loads.
template <bool VEC>
__global__ void __launch_bounds__(SPLIT_THREADS)
    split_transpose_kernel(const float* __restrict__ x, float* __restrict__ hi,
                           float* __restrict__ lo, int rows, int cols,
                           int ld) {
  __shared__ float tile[TILE][TILE + 1];
  const int r0 = blockIdx.y * TILE, c0 = blockIdx.x * TILE;
  {
    const int r = threadIdx.x / 8, c = (threadIdx.x % 8) * 4;
    float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (r0 + r < rows) {
      const float* src = x + static_cast<size_t>(r0 + r) * cols + c0 + c;
      if constexpr (VEC) {
        if (c0 + c < cols) {
          const float4 f = *reinterpret_cast<const float4*>(src);
          v[0] = f.x;
          v[1] = f.y;
          v[2] = f.z;
          v[3] = f.w;
        }
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (c0 + c + i < cols) v[i] = src[i];
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) tile[r][c + i] = v[i];
  }
  __syncthreads();
  const int c = threadIdx.x / 8, r = (threadIdx.x % 8) * 4;
  if (c0 + c < cols && r0 + r < rows) {
    const float4 v =
        make_float4(tile[r][c], tile[r + 1][c], tile[r + 2][c], tile[r + 3][c]);
    float4 h, l;
    split4(v, h, l);
    const size_t at = static_cast<size_t>(c0 + c) * ld + r0 + r;
    *reinterpret_cast<float4*>(hi + at) = h;
    *reinterpret_cast<float4*>(lo + at) = l;
  }
}

// --------------------------------------------------------------------- //
// The 3xTF32 product
// --------------------------------------------------------------------- //

template <int STAGES, bool PAIRS>
__global__ void __launch_bounds__(THREADS, 1)
    matmul_tf32x3_kernel(const __grid_constant__ CUtensorMap map_a_hi,
                         const __grid_constant__ CUtensorMap map_a_lo,
                         const __grid_constant__ CUtensorMap map_b_hi,
                         const __grid_constant__ CUtensorMap map_b_lo,
                         float* __restrict__ C, int M, int N, int K) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t ring = (hopper::smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t full = ring + STAGES * STAGE_BYTES;  // full[s] = full + 8 s
  const uint32_t empty = full + 8 * MAX_STAGES;
  const int bm = blockIdx.x * BM, bn = blockIdx.y * BN;
  const int n_k = (K + BK - 1) / BK;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(full + 8 * s, 1);   // the producer's expect_tx
      hopper::mbar_init(empty + 8 * s, 2);  // one per consumer warpgroup
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
      for (int kt = 0; kt < n_k; ++kt) {
        hopper::mbar_wait(empty + 8 * s, phase ^ 1);  // slot s is free
        const uint32_t bar = full + 8 * s;
        const uint32_t dst = ring + s * STAGE_BYTES;
        hopper::mbar_arrive_expect_tx(bar, STAGE_BYTES);
        hopper::tma_load_2d(dst, &map_a_hi, bar, kt * BK, bm);
        hopper::tma_load_2d(dst + A_BYTES, &map_a_lo, bar, kt * BK, bm);
        hopper::tma_load_2d(dst + 2 * A_BYTES, &map_b_hi, bar, kt * BK, bn);
        hopper::tma_load_2d(dst + 2 * A_BYTES + B_BYTES, &map_b_lo, bar,
                            kt * BK, bn);
        if (++s == STAGES) {
          s = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    // --------------------------------------------------- consumers
    hopper::setmaxnreg_inc<CONSUMER_REGS>();
    const int c = wg - 1;  // rows 64 c .. 64 c + 63 of the block's tile
    const bool signals = threadIdx.x % 128 == 0;
    float d[64], sum[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) d[i] = sum[i] = 0.0f;

    int s = 0, prev = 0;
    bool pending = false;  // slot prev awaits its release
    uint32_t phase = 0;
    for (int kt = 0; kt < n_k; ++kt) {
      const bool run_start = kt % RUN_STEPS == 0;
      const bool run_end = (kt + 1) % RUN_STEPS == 0 || kt + 1 == n_k;
      hopper::mbar_wait(full + 8 * s, phase);  // tile kt is in slot s
      const uint32_t a_hi = ring + s * STAGE_BYTES + c * A_HALF_BYTES;
      const uint32_t a_lo = a_hi + A_BYTES;
      const uint32_t b_hi = ring + s * STAGE_BYTES + 2 * A_BYTES;
      const uint32_t b_lo = b_hi + B_BYTES;
#pragma unroll
      for (int i = 0; i < 64; ++i) hopper::fence_operand(d[i]);
      hopper::wgmma_fence();
#pragma unroll
      for (int k = 0; k < BK / 8; ++k) {
        hopper::wgmma_m64n128k8_tf32_ss(
            d, hopper::sw128_desc(a_lo + 32 * k, 16, 1024),
            hopper::sw128_desc(b_hi + 32 * k, 16, 1024),
            !(run_start && k == 0));  // a run starts its accumulator afresh
        hopper::wgmma_m64n128k8_tf32_ss(
            d, hopper::sw128_desc(a_hi + 32 * k, 16, 1024),
            hopper::sw128_desc(b_lo + 32 * k, 16, 1024), 1);
      }
#pragma unroll
      for (int k = 0; k < BK / 8; ++k)
        hopper::wgmma_m64n128k8_tf32_ss(
            d, hopper::sw128_desc(a_hi + 32 * k, 16, 1024),
            hopper::sw128_desc(b_hi + 32 * k, 16, 1024), 1);
      hopper::wgmma_commit();
      if (STAGES == 1 || run_end) {
        hopper::wgmma_wait<0>();  // steps kt-1 and kt have retired
        if (signals) {
          if (pending) hopper::mbar_arrive(empty + 8 * prev);
          hopper::mbar_arrive(empty + 8 * s);
        }
        pending = false;
#pragma unroll
        for (int i = 0; i < 64; ++i) hopper::fence_operand(d[i]);
        if (run_end) {
#pragma unroll
          for (int i = 0; i < 64; ++i) sum[i] += d[i];  // the promotion
        }
      } else {
        hopper::wgmma_wait<1>();  // step kt-1's group has retired
        if (pending && signals) hopper::mbar_arrive(empty + 8 * prev);
        pending = true;
        prev = s;
      }
#pragma unroll
      for (int i = 0; i < 64; ++i) hopper::fence_operand(d[i]);
      if (++s == STAGES) {
        s = 0;
        phase ^= 1;
      }
    }

    // Accumulator layout of m64nNk8: warp w of the warpgroup holds rows 16 w
    // + lane / 4 (sum[4j], sum[4j+1]) and 8 further (sum[4j+2], sum[4j+3]),
    // columns 8 j + 2 (lane % 4) and the next.  With PAIRS (N even) a column
    // pair is in or out of the matrix as a whole and 8-byte aligned.
    const int lane = threadIdx.x % 32, warp = (threadIdx.x % 128) / 32;
    const int row0 = bm + c * 64 + warp * 16 + lane / 4;
    const int col0 = bn + 2 * (lane % 4);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = col0 + 8 * j;
      if (col >= N) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row0 + 8 * h;
        if (row >= M) continue;
        float* at = C + static_cast<size_t>(row) * N + col;
        if constexpr (PAIRS) {
          *reinterpret_cast<float2*>(at) =
              make_float2(sum[4 * j + 2 * h], sum[4 * j + 2 * h + 1]);
        } else {
          at[0] = sum[4 * j + 2 * h];
          if (col + 1 < N) at[1] = sum[4 * j + 2 * h + 1];
        }
      }
    }
  }
}

template <int STAGES, bool PAIRS>
int launch(const CUtensorMap (&maps)[4], void* C, int M, int N, int K,
           cudaStream_t stream) {
  constexpr int smem = STAGES * STAGE_BYTES + SMEM_BYTES_EXTRA;
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        matmul_tf32x3_kernel<STAGES, PAIRS>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_set = true;
  }
  const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN);
  matmul_tf32x3_kernel<STAGES, PAIRS><<<grid, THREADS, smem, stream>>>(
      maps[0], maps[1], maps[2], maps[3], static_cast<float*>(C), M, N, K);
  return static_cast<int>(cudaGetLastError());
}

template <bool PAIRS>
int launch_depth(int stages, const CUtensorMap (&maps)[4], void* C, int M,
                 int N, int K, cudaStream_t stream) {
  switch (stages) {
    case 1: return launch<1, PAIRS>(maps, C, M, N, K, stream);
    case 2: return launch<2, PAIRS>(maps, C, M, N, K, stream);
    default: return launch<3, PAIRS>(maps, C, M, N, K, stream);
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// hi and lo of the row-major rows x cols f32 matrix X (any 4-byte aligned
// base): row-major rows x ld arrays, or with `transpose` row-major cols x
// ld ones, ld the width (cols, or rows) rounded up to 4, at 16-byte aligned
// bases; the columns past the width are zero.  Returns the cudaError_t of
// the launch.
extern "C" int pm_split_tf32(const void* X, void* hi, void* lo, int rows,
                             int cols, int ld, int transpose, void* stream) {
  const int width = transpose ? rows : cols;
  if (rows <= 0 || cols <= 0 || ld != (width + 3) / 4 * 4 ||
      reinterpret_cast<uintptr_t>(X) % 4 != 0 || !aligned16(hi) ||
      !aligned16(lo) || (transpose && (rows + TILE - 1) / TILE > 65535))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* x = static_cast<const float*>(X);
  if (transpose) {
    const dim3 grid((cols + TILE - 1) / TILE, (rows + TILE - 1) / TILE);
    if (cols % 4 == 0 && aligned16(X))
      split_transpose_kernel<true><<<grid, SPLIT_THREADS, 0, st>>>(
          x, static_cast<float*>(hi), static_cast<float*>(lo), rows, cols, ld);
    else
      split_transpose_kernel<false><<<grid, SPLIT_THREADS, 0, st>>>(
          x, static_cast<float*>(hi), static_cast<float*>(lo), rows, cols, ld);
  } else {
    const int chunks = ld / 4;
    const int row_blocks = (rows + SPLIT_WARPS - 1) / SPLIT_WARPS;
    const dim3 grid((chunks + 31) / 32, row_blocks < 65535 ? row_blocks : 65535);
    split_rows_kernel<<<grid, dim3(32, SPLIT_WARPS), 0, st>>>(
        x, static_cast<float4*>(hi), static_cast<float4*>(lo), rows, cols,
        chunks);
  }
  return static_cast<int>(cudaGetLastError());
}

// C = A @ B from the split operands: a_hi, a_lo (M, K) and bt_hi, bt_lo
// (N, K), all row-major TF32 values in f32 words stored with the leading
// dimension ld (a multiple of 4, at least K).  Returns the cudaError_t of
// the launch, or -1000 - r when the tensor maps could not be encoded (r:
// the CUresult, -1 without cuTensorMapEncodeTiled).  `full` and `empty`
// are the plan's two waits; the kernel needs both.
extern "C" int pm_matmul_f32_tf32x3(const void* a_hi, const void* a_lo,
                                    const void* bt_hi, const void* bt_lo,
                                    void* C, int M, int N, int K, int ld,
                                    int stages, int full, int empty,
                                    void* stream) {
  const bool pairs = N % 2 == 0;
  if (!full || !empty || M <= 0 || N <= 0 || K <= 0 || stages < 1 ||
      stages > MAX_STAGES || ld < K || ld % 4 != 0 || !aligned16(a_hi) ||
      !aligned16(a_lo) || !aligned16(bt_hi) || !aligned16(bt_lo) ||
      reinterpret_cast<uintptr_t>(C) % (pairs ? 8 : 4) != 0 ||
      (N + BN - 1) / BN > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap maps[4];
  const void* bases[4] = {a_hi, a_lo, bt_hi, bt_lo};
  for (int t = 0; t < 4; ++t) {  // A_hi, A_lo (M, K); B_hi, B_lo (N, K)
    const int rows = t < 2 ? M : N, box_rows = t < 2 ? BM : BN;
    const int rc =
        hopper::encode_f32_2d(&maps[t], bases[t], rows, K, ld, box_rows, BK);
    if (rc != 0) return -1000 - rc;
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return pairs ? launch_depth<true>(stages, maps, C, M, N, K, st)
               : launch_depth<false>(stages, maps, C, M, N, K, st);
}
