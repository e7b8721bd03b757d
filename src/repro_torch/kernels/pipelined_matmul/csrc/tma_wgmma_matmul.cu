// bf16 matmul for Hopper (sm_90a) through TMA and wgmma: C[M,N] = A[M,K] @
// B[K,N], row-major bf16 operands, f32 accumulation, bf16 result.
//
// Replaces, for every bf16 operand pair, the TPU kernel
// src/repro/kernels/pipelined_matmul/kernel.py (_matmul_kernel, launched by
// pipelined_matmul through pl.pallas_call): a (M/BM, N/BN, K/BK) grid with
// K innermost and an f32 accumulator in VMEM scratch.  Here the K grid
// dimension is a loop inside the block, and each block owns one output tile
// for the whole loop.  f32 operands take tma_wgmma_tf32x3.cu (ops.route()
// decides by the dtype; it is a rule, not a fallback).
//
// Two kernels, one source:
//
//   stage_bf16   the stage.  TMA needs a 16-byte aligned base and a row
//                stride that is a multiple of 16 bytes.  The reference
//                zero-pads its operands to block multiples (jnp.pad) before
//                pl.pallas_call; here an operand whose base or row (K or N
//                not a multiple of 8) TMA cannot describe is copied, once,
//                into a buffer whose rows are rounded up to 8 elements, and
//                the product's tensor map keeps the true extent with the
//                padded stride, so TMA zero-fills past it and the padding
//                is never read.  One launch restages A, B or both
//                (blockIdx.z picks the operand).  A thread writes one
//                16-byte chunk of a row, neighbouring threads neighbouring
//                chunks, and reads it with one or two 16-byte aligned loads
//                funnel-shifted into place (hopper::ld_window16), whatever
//                the row's alignment.  It is bound by bytes: each restaged
//                byte read once and written once, 2 x 201 MB = 0.120 ms at
//                3.35 TB/s for granite-3-2b's LM head (B 2048 x 49155).
//
//   matmul_bf16_tma  the product, described below.
//
// What bounds the product on an H100: at the shapes the port drives it with
// (a 2048-token prefill through yi-6b's MLP, 2048 x 4096 x 11008 and back)
// the work is 2MNK = 185 GFLOP against ~150 MB of operands, far above the
// card's ~295 FLOP/byte ridge, so it is bound by operations: 0.187 ms at
// the 989 TFLOP/s of bf16 wgmma.  A cp.async / mma.sync kernel (the first
// port) reached a fifth of that.  What this design does about it:
//
//   * wgmma m64n256k16 reads both operands straight from shared memory:
//     Hopper's only path to the full tensor-core rate, with no ldmatrix and
//     no fragment registers;
//   * 128 x 256 output tiles with K-steps of 64 (128 bytes): each operand
//     element staged in shared memory feeds 256 (A) or 128 (B) multiply-adds,
//     and a 48 KB stage keeps 8 wgmma (1024 tensor-core cycles) busy;
//   * one producer warpgroup whose single elected thread issues the TMA
//     copies (A as one 128 x 64 box, B as four 64 x 64 boxes, since B is
//     (K, N) row-major and a 128-byte-swizzled box is at most 128 bytes
//     wide) into a ring of D stages; no consumer thread spends an
//     instruction or a register on a copy, and D - 1 stages are in flight;
//   * two consumer warpgroups, 64 rows each, 128 f32 accumulators a
//     thread; setmaxnreg moves registers from the producer (40) to them
//     (232).  The producer / consumer split is the one if / else at the
//     kernel's top, so ptxas can honour setmaxnreg.
//
// The synchronization is the compiler's output, not constants.  The wrapper
// (ops.py) plans the K-loop with hopper_schedule(depth): plan() under the
// processor map of this kernel, ISSUE and LOAD on the producer (the elected
// thread issues the copy, the copy engine completes it into the ring, in
// that thread's program order) and COMPUTE on the consumers.  At every depth
// D the ISD reduction keeps exactly two cross-processor dependences, and
// each is one mbarrier per ring slot:
//
//   full[s]   LOAD -> COMPUTE, distance 0.  The producer arrives once with
//             expect_tx of the stage's 48 KB (zero fill past a ragged edge
//             counts too); the TMA completes the bytes; the consumers wait
//             on it before reading slot s.
//   empty[s]  COMPUTE -> LOAD, distance D (slot reuse).  One thread of each
//             consumer warpgroup arrives (count 2) once the wgmma group that
//             read slot s has RETIRED, not when it was issued: wgmma is
//             asynchronous, and an arrival at issue would let the producer
//             overwrite a slot still being read.  At K-step i (D >= 2) the
//             consumers commit step i's group, wait_group 1 retires step
//             i-1's, and only then release slot (i-1) mod D.  At D = 1 they
//             wait_group 0 and release slot 0 for step i at once.  The
//             producer waits on empty[s] before it refills s.
//
// Parity: slot s of K-step i is in its round r = i / D.  The consumers wait
// on full[s] with parity r & 1 (its r-th completion); the producer waits on
// empty[s] with parity (r & 1) ^ 1, so its first D waits pass on the fresh
// barriers.  The host entry point refuses a schedule without both waits.
//
// Layouts: the ring's stages are 1024-byte aligned, as the 128-byte swizzle
// that TMA applies and wgmma undoes repeats every 1024 bytes.  A is K-major
// (8-row groups 1024 bytes apart: SBO 1024); a k16 slice starts 32 bytes
// further along the 128-byte row.  B is MN-major (N contiguous), so its
// wgmma takes the transpose bit, with LBO 8192 (the next 64-column box) and
// SBO 1024 (the next 8 K-rows); a k16 slice starts 2048 bytes further.
//
// Operands: 16-byte aligned bases and leading dimensions lda, ldb that are
// multiples of 8 (TMA's 16-byte row strides); K and N are any.  Ragged M,
// N and K are zero-filled by TMA and masked in the epilogue, which converts
// to bf16 in registers and stores to global memory: bf16 pairs where N is
// even, single values where it is odd (a pair at row * N + col would be
// misaligned on every other row), one instantiation each.  Blocks walk M
// fastest, so a wave shares B's column slabs and keeps A in L2.
//
// Plain C interface, loaded with ctypes; the tensor maps are encoded on the
// host per call (cuTensorMapEncodeTiled, fetched from the CUDA driver at
// run time) and passed as __grid_constant__ parameters.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int BM = 128;                         // two consumer warpgroups
constexpr int BN = 256;                         // one m64n256k16 wide
constexpr int BK = 64;                          // 128 bytes of bf16
constexpr int B_BOX_N = 64;                     // a swizzled box's width
constexpr int THREADS = 384;                    // producer + 2 consumers
constexpr int MAX_STAGES = 4;                   // 4 x 48 KB of the 227 KB
constexpr int A_BYTES = BM * BK * 2;            // 16 KB
constexpr int A_HALF_BYTES = A_BYTES / 2;       // one consumer's 64 rows
constexpr int B_BOX_BYTES = BK * B_BOX_N * 2;   // 8 KB
constexpr int STAGE_BYTES = A_BYTES + BK * BN * 2;  // 48 KB
constexpr int SMEM_BYTES_EXTRA = 1024 + 2 * MAX_STAGES * 8;  // align, bars
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;

constexpr int STAGE_WARPS = 8;                  // rows a stage block takes

static_assert(STAGE_BYTES % 1024 == 0, "stages must stay 1024-byte aligned");
static_assert(128 * PRODUCER_REGS + 256 * CONSUMER_REGS <= 65536,
              "the register split must fit the SM's file");

// --------------------------------------------------------------------- //
// The stage
// --------------------------------------------------------------------- //

// One operand to restage: the row-major rows x cols bf16 matrix at src (any
// 2-byte aligned base) into the row-major rows x (8 * chunks) one at dst
// (16-byte aligned), chunks = ceil(cols / 8).
struct StageJob {
  const __nv_bfloat16* src;
  uint4* dst;
  int rows, cols, chunks;
};

struct StageJobs {
  StageJob job[2];
};

// Block (32, STAGE_WARPS): a warp takes 32 neighbouring chunks of a row,
// the block STAGE_WARPS rows of them, striding over the rows by the grid.
// The chunk holding a row's last columns has zeros past them.
__global__ void __launch_bounds__(32 * STAGE_WARPS)
    stage_bf16_kernel(const __grid_constant__ StageJobs jobs) {
  const StageJob& j = jobs.job[blockIdx.z];
  const int c = blockIdx.x * 32 + threadIdx.x;
  if (c >= j.chunks) return;
  const int live = min(8, j.cols - 8 * c);  // bf16 values of the chunk
  for (int r = blockIdx.y * STAGE_WARPS + threadIdx.y; r < j.rows;
       r += gridDim.y * STAGE_WARPS)
    j.dst[static_cast<size_t>(r) * j.chunks + c] = hopper::ld_window16(
        j.src + static_cast<size_t>(r) * j.cols + 8 * c, 2 * live);
}

// --------------------------------------------------------------------- //
// The product
// --------------------------------------------------------------------- //

// D[64 x 256] += A[64 x 16] * B[16 x 256]: A K-major, B MN-major
// (imm-trans-b = 1), both 128-byte swizzled in shared memory.  scale-d is
// a predicate operand, set to true: D is accumulated, never overwritten.
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128],
                                                 uint64_t desc_a,
                                                 uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])

      : "l"(desc_a), "l"(desc_b), "r"(1));
}

template <int STAGES, bool PAIRS>
__global__ void __launch_bounds__(THREADS, 1)
    matmul_bf16_tma_kernel(const __grid_constant__ CUtensorMap map_a,
                           const __grid_constant__ CUtensorMap map_b,
                           __nv_bfloat16* __restrict__ C, int M, int N,
                           int K) {
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
        hopper::mbar_arrive_expect_tx(full + 8 * s, STAGE_BYTES);
        const uint32_t a_dst = ring + s * STAGE_BYTES;
        hopper::tma_load_2d(a_dst, &map_a, full + 8 * s, kt * BK, bm);
#pragma unroll
        for (int j = 0; j < BN / B_BOX_N; ++j)
          hopper::tma_load_2d(a_dst + A_BYTES + j * B_BOX_BYTES, &map_b,
                              full + 8 * s, bn + j * B_BOX_N, kt * BK);
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
    float d[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) d[i] = 0.0f;

    int s = 0, prev = 0;
    uint32_t phase = 0;
    for (int kt = 0; kt < n_k; ++kt) {
      hopper::mbar_wait(full + 8 * s, phase);  // tile kt is in slot s
      const uint32_t a_base = ring + s * STAGE_BYTES + c * A_HALF_BYTES;
      const uint32_t b_base = ring + s * STAGE_BYTES + A_BYTES;
#pragma unroll
      for (int i = 0; i < 128; ++i) hopper::fence_operand(d[i]);
      hopper::wgmma_fence();
#pragma unroll
      for (int k = 0; k < BK / 16; ++k)
        wgmma_m64n256k16(d, hopper::sw128_desc(a_base + 32 * k, 16, 1024),
                         hopper::sw128_desc(b_base + 2048 * k, B_BOX_BYTES,
                                            1024));
      hopper::wgmma_commit();
      if constexpr (STAGES > 1) {
        hopper::wgmma_wait<1>();  // step kt-1's group has retired
        if (kt > 0 && signals) hopper::mbar_arrive(empty + 8 * prev);
      } else {
        hopper::wgmma_wait<0>();  // step kt's group has retired
        if (signals) hopper::mbar_arrive(empty + 8 * s);
      }
#pragma unroll
      for (int i = 0; i < 128; ++i) hopper::fence_operand(d[i]);
      prev = s;
      if (++s == STAGES) {
        s = 0;
        phase ^= 1;
      }
    }
    hopper::wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < 128; ++i) hopper::fence_operand(d[i]);

    // Accumulator layout of m64nNk16: warp w of the warpgroup holds rows
    // 16 w + lane / 4 (d[4j], d[4j+1]) and 8 further (d[4j+2], d[4j+3]),
    // columns 8 j + 2 (lane % 4) and the next.  With PAIRS (N even) a column
    // pair is in or out of the matrix as a whole and 4-byte aligned.
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
        __nv_bfloat16* at = C + static_cast<size_t>(row) * N + col;
        if constexpr (PAIRS) {
          *reinterpret_cast<__nv_bfloat162*>(at) =
              __floats2bfloat162_rn(d[4 * j + 2 * h], d[4 * j + 2 * h + 1]);
        } else {
          at[0] = __float2bfloat16_rn(d[4 * j + 2 * h]);
          if (col + 1 < N) at[1] = __float2bfloat16_rn(d[4 * j + 2 * h + 1]);
        }
      }
    }
  }
}

template <int STAGES, bool PAIRS>
int launch(const CUtensorMap& map_a, const CUtensorMap& map_b, void* C, int M,
           int N, int K, cudaStream_t stream) {
  constexpr int smem = STAGES * STAGE_BYTES + SMEM_BYTES_EXTRA;
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        matmul_bf16_tma_kernel<STAGES, PAIRS>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_set = true;
  }
  const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN);
  matmul_bf16_tma_kernel<STAGES, PAIRS><<<grid, THREADS, smem, stream>>>(
      map_a, map_b, static_cast<__nv_bfloat16*>(C), M, N, K);
  return static_cast<int>(cudaGetLastError());
}

template <bool PAIRS>
int launch_depth(int stages, const CUtensorMap& map_a,
                 const CUtensorMap& map_b, void* C, int M, int N, int K,
                 cudaStream_t stream) {
  switch (stages) {
    case 1: return launch<1, PAIRS>(map_a, map_b, C, M, N, K, stream);
    case 2: return launch<2, PAIRS>(map_a, map_b, C, M, N, K, stream);
    case 3: return launch<3, PAIRS>(map_a, map_b, C, M, N, K, stream);
    default: return launch<4, PAIRS>(map_a, map_b, C, M, N, K, stream);
  }
}

// Fills `job` for a rows x cols operand restaged at ld; false if the call
// is not one the stage takes.
bool stage_job(StageJob& job, const void* src, void* dst, int rows, int cols,
               int ld) {
  if (rows <= 0 || cols <= 0 || ld != (cols + 7) / 8 * 8 ||
      reinterpret_cast<uintptr_t>(src) % 2 != 0 ||
      reinterpret_cast<uintptr_t>(dst) % 16 != 0)
    return false;
  job = {static_cast<const __nv_bfloat16*>(src), static_cast<uint4*>(dst),
         rows, cols, ld / 8};
  return true;
}

}  // namespace

// Restages the bf16 operands whose source is not null: A (rows_a x cols_a,
// row-major at any 2-byte aligned base) into a_dst (rows_a x lda, lda =
// cols_a rounded up to 8, 16-byte aligned), and B likewise, in one launch.
// Returns the cudaError_t of the launch (cudaErrorInvalidValue for a call
// it does not take, or with neither operand).
extern "C" int pm_stage_bf16(const void* A, void* a_dst, const void* B,
                             void* b_dst, int rows_a, int cols_a, int lda,
                             int rows_b, int cols_b, int ldb, void* stream) {
  StageJobs jobs;
  int n = 0, chunks = 0, rows = 0;
  if (A != nullptr) {
    if (!stage_job(jobs.job[n], A, a_dst, rows_a, cols_a, lda))
      return static_cast<int>(cudaErrorInvalidValue);
    chunks = jobs.job[n].chunks > chunks ? jobs.job[n].chunks : chunks;
    rows = rows_a > rows ? rows_a : rows;
    ++n;
  }
  if (B != nullptr) {
    if (!stage_job(jobs.job[n], B, b_dst, rows_b, cols_b, ldb))
      return static_cast<int>(cudaErrorInvalidValue);
    chunks = jobs.job[n].chunks > chunks ? jobs.job[n].chunks : chunks;
    rows = rows_b > rows ? rows_b : rows;
    ++n;
  }
  if (n == 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 1) jobs.job[1] = jobs.job[0];
  const int row_blocks = (rows + STAGE_WARPS - 1) / STAGE_WARPS;
  const dim3 grid((chunks + 31) / 32, row_blocks < 65535 ? row_blocks : 65535,
                  n);
  stage_bf16_kernel<<<grid, dim3(32, STAGE_WARPS), 0,
                      static_cast<cudaStream_t>(stream)>>>(jobs);
  return static_cast<int>(cudaGetLastError());
}

// C (M x N, row-major) = A @ B for A (M x K) and B (K x N) stored with
// leading dimensions lda and ldb (multiples of 8, at least K and N) at
// 16-byte aligned bases.  Returns the cudaError_t of the launch, or -1000 -
// r when the tensor maps could not be encoded (r: the CUresult, -1 without
// cuTensorMapEncodeTiled).  `full` and `empty` are the plan's two waits;
// the kernel needs both.
extern "C" int pm_matmul_bf16_tma(const void* A, const void* B, void* C,
                                  int M, int N, int K, int lda, int ldb,
                                  int stages, int full, int empty,
                                  void* stream) {
  const bool pairs = N % 2 == 0;
  if (!full || !empty || M <= 0 || N <= 0 || K <= 0 || stages < 1 ||
      stages > MAX_STAGES || lda < K || ldb < N || lda % 8 != 0 ||
      ldb % 8 != 0 || reinterpret_cast<uintptr_t>(A) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(B) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(C) % (pairs ? 4 : 2) != 0 ||
      (N + BN - 1) / BN > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap map_a, map_b;
  int rc = hopper::encode_bf16_2d(&map_a, A, M, K, lda, BM, BK);
  if (rc == 0) rc = hopper::encode_bf16_2d(&map_b, B, K, N, ldb, BK, B_BOX_N);
  if (rc != 0) return -1000 - rc;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return pairs ? launch_depth<true>(stages, map_a, map_b, C, M, N, K, st)
               : launch_depth<false>(stages, map_a, map_b, C, M, N, K, st);
}
