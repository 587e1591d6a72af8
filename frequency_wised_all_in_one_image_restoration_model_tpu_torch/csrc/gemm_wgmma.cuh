// The bf16 GEMM on Hopper's tensor cores: TMA loads into a ring of
// shared-memory stages, wgmma (m64nNk16, bf16 operands, fp32 accumulators)
// reading both operands from shared memory in the 128-byte swizzle, and
// gemm.cuh's epilogue contract (GemmArgs: bias, tanh-GELU, dps, residual,
// the RowMap scatter of C's rows, C in bf16 or, with c_f32, in fp32). Part
// of gemm.cuh, which includes it after GemmArgs and the epilogue pieces,
// before launch_gemm.
//
// A k-tile is BK = 64 columns, one 128-byte row of the swizzle. The host
// encodes a tensor map for A [M, lda] and one for Wt [N, lda]
// (cuTensorMapEncodeTiled, reached through cudaGetDriverEntryPoint: no
// link against the driver library); each has the contracted width (lda,
// or ktiles * 32) as its inner extent, so TMA zero-fills the ragged last
// k-tile (kpad(C) = 224) and the rows past M and N.
//
// Two forms:
// - gemm_wgmma_kernel: 128 x 128 output tiles, one persistent CTA an SM;
//   two consumer warpgroups (rows 0-63 and 64-127, m64n128k16) and a
//   producer warp that keeps WGK_STAGES k-tiles in flight (full / empty
//   mbarriers), into the next tile while the consumers stage this one's
//   fp32 C tile in shared memory of its own and write whole rows.
// - gemm_wgmma_tile64: a 128 x 64 output tile for one warpgroup of 128
//   threads, for the persistent loop of the merged kernel (merged.cuh):
//   thread 0 issues the loads of the same warpgroup's ring, a barrier of
//   the block releases a stage. Its mbarriers live in a slot of shared
//   memory that no other phase touches, and a count of the k-tiles the
//   block has consumed carries their phases from tile to tile.
//
// What bounds a product on the H100: operations where K and N are wide
// (989 TFLOP/s in bf16, about 295 operations a byte), bytes below.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums only: the encoder is found at run time

namespace fairm {

constexpr int WG_BK = 64;       // bf16 columns of a k-tile: one swizzle row
constexpr int WG_BM = 128;      // output rows of a tile
constexpr int WGK_BN = 128;     // output columns of the kernel form's tile
constexpr int WGK_STAGES = 4;   // the kernel form's ring
constexpr int WGK_THREADS = 288;  // two consumer warpgroups and a producer warp

// ---- host: tensor maps ------------------------------------------------------

typedef CUresult (*TensorMapEncodeTiled)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

inline cudaError_t tensor_map_encoder(TensorMapEncodeTiled* fn) {
  static TensorMapEncodeTiled cached = nullptr;
  if (!cached) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
    if (err != cudaSuccess) return err;
    if (q != cudaDriverEntryPointSuccess || !p) return cudaErrorSymbolNotFound;
    cached = reinterpret_cast<TensorMapEncodeTiled>(p);
  }
  *fn = cached;
  return cudaSuccess;
}

// a [rows, ld] bf16 matrix, its first ``cols`` columns, in boxes of
// box_rows x 64 with the 128-byte swizzle; reads past rows / cols give 0
inline cudaError_t tensor_map(CUtensorMap* m, const void* base, long long rows,
                              int cols, int ld, int box_rows) {
  TensorMapEncodeTiled enc;
  const cudaError_t err = tensor_map_encoder(&enc);
  if (err != cudaSuccess) return err;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * sizeof(bf16_t)};
  const cuuint32_t box[2] = {(cuuint32_t)WG_BK, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = enc(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                         const_cast<void*>(base), dims, strides, box, elem,
                         CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// the columns a GEMM contracts (lda, or its first ktiles k-tiles of GBK)
__host__ __device__ inline int gemm_kcols(const GemmArgs& a) {
  return a.ktiles ? a.ktiles * GBK : a.lda;
}

// ---- device: barriers, TMA, wgmma ------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  const uint32_t s = smem_u32(p);
  return p + (((s + 1023u) & ~1023u) - s);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t b = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(b), "r"(parity)
        : "memory");
  }
}

// generic-proxy writes to shared memory made visible to TMA and wgmma
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// one box of the tensor map at (column x, row y) into dst, completing on bar
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int x, int y) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(x), "r"(y)
      : "memory");
}

// a wgmma descriptor of a K-major tile in the 128-byte swizzle (rows of 128
// bytes, 8-row groups 1024 bytes apart, the tile 1024-byte aligned); +2
// steps it 16 bf16 columns along K
__device__ __forceinline__ uint64_t wgmma_desc(const void* tile) {
  const uint64_t a = smem_u32(tile);
  return ((a & 0x3FFFF) >> 4) | (1ull << 16) | ((uint64_t)(1024 >> 4) << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// D[64 x 64] += A[64 x 16] B[64 x 16]^T, A and B K-major in shared memory
// (128-byte swizzle), D in registers: 32 floats a thread
__device__ __forceinline__ void wgmma_m64n64(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "n"(1));
}

// D[64 x 128] += A[64 x 16] B[128 x 16]^T, A and B K-major in shared memory
// (128-byte swizzle), D in registers: 64 floats a thread
__device__ __forceinline__ void wgmma_m64n128(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "n"(1));
}

// The accumulator layout of m64nNk16 for thread t of the warpgroup: d[4j +
// e] is row 16 (t / 32) + (t % 32) / 4 + 8 (e / 2), column 8 j + 2 (t % 4)
// + e % 2. Writes rows r0 .. r0 + 63 of an fp32 tile Cs [*, ldc] at
// column c0.
template <int N>
__device__ __forceinline__ void wgmma_store_acc(const float* d, float* Cs,
                                                int ldc, int r0, int c0) {
  const int t = threadIdx.x & 127;
  const int row = r0 + 16 * (t >> 5) + ((t & 31) >> 2);
  const int col = c0 + 2 * (t & 3);
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<float2*>(Cs + (row + 8 * h) * ldc + col + 8 * j) =
          make_float2(d[4 * j + 2 * h], d[4 * j + 2 * h + 1]);
}

// every row of the staged fp32 tile through gemm.cuh's epilogue: threads
// ``tid`` of ``nt`` write four adjacent columns each
template <int BN>
__device__ __forceinline__ void wgmma_epilogue(const GemmArgs& a, const float* Cs,
                                               int ldc, const long long* s_crow,
                                               const float* s_scale, int n0,
                                               int tid, int nt) {
  const bool vec = gemm_vec<bf16_t>(a), vec32 = gemm_vec<float>(a);
  for (int idx = tid; idx < WG_BM * (BN / 4); idx += nt) {
    const int row = idx / (BN / 4), cv = idx % (BN / 4);
    const int col = n0 + cv * 4;
    const long long pc = s_crow[row];
    if (pc < 0 || col >= a.N) continue;
    gemm_store4_any<bf16_t>(
        a, pc, s_scale[row], col,
        *reinterpret_cast<const float4*>(Cs + row * ldc + cv * 4), vec, vec32);
  }
}

// ---- the kernel form --------------------------------------------------------

constexpr size_t WGK_STAGE_BYTES = sizeof(bf16_t) * (WG_BM + WGK_BN) * WG_BK;
constexpr int WGK_LDC = WGK_BN + 8;
// the ring, the C tile (fp32), the mbarriers, the tile's C rows and scales
constexpr size_t WGK_CS = WGK_STAGES * WGK_STAGE_BYTES;
constexpr size_t WGK_BARS = WGK_CS + sizeof(float) * WG_BM * WGK_LDC;
constexpr size_t WGK_ROWS = WGK_BARS + 2 * WGK_STAGES * sizeof(uint64_t);
constexpr size_t wgk_smem_bytes() {
  return 1024 /* alignment */ + WGK_ROWS +
         WG_BM * (sizeof(long long) + sizeof(float));
}

// Persistent: block b takes output tiles b, b + grid, ... (row-major over
// 128 x 128 tiles, so neighbouring blocks share A's rows). The producer
// warp walks the same tiles and runs up to WGK_STAGES k-tiles ahead, into
// the next tile while the consumers write this one's C.
static __global__ void __launch_bounds__(WGK_THREADS, 1)
    gemm_wgmma_kernel(const __grid_constant__ CUtensorMap ta,
                      const __grid_constant__ CUtensorMap tb, const GemmArgs a,
                      int KT, int tiles_n, int tiles) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* sm = align1024(smem_raw);
  bf16_t* As = reinterpret_cast<bf16_t*>(sm);
  bf16_t* Bs = As + WGK_STAGES * WG_BM * WG_BK;
  float* Cs = reinterpret_cast<float*>(sm + WGK_CS);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + WGK_BARS);
  uint64_t* empty = full + WGK_STAGES;
  long long* s_crow = reinterpret_cast<long long*>(sm + WGK_ROWS);
  float* s_scale = reinterpret_cast<float*>(s_crow + WG_BM);

  const int tid = threadIdx.x, wg = tid >> 7;
  if (tid == 0) {
    for (int s = 0; s < WGK_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);  // one arrival per consumer warpgroup
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 2) {  // the producer warp
    if (tid == 256) {
      uint32_t it = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = (tile / tiles_n) * WG_BM, n0 = (tile % tiles_n) * WGK_BN;
        for (int kt = 0; kt < KT; ++kt, ++it) {
          const int s = it % WGK_STAGES;
          if (it >= WGK_STAGES)
            mbar_wait(&empty[s], ((it / WGK_STAGES) - 1) & 1);
          mbar_expect_tx(&full[s], (uint32_t)WGK_STAGE_BYTES);
          tma_load(As + s * WG_BM * WG_BK, &ta, &full[s], kt * WG_BK, m0);
          tma_load(Bs + s * WGK_BN * WG_BK, &tb, &full[s], kt * WG_BK, n0);
        }
      }
    }
    return;
  }

  uint32_t it = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long m0 = (long long)(tile / tiles_n) * WG_BM;
    const int n0 = (tile % tiles_n) * WGK_BN;
    float acc[WGK_BN / 2];
#pragma unroll
    for (int i = 0; i < WGK_BN / 2; ++i) acc[i] = 0.f;
    for (int kt = 0; kt < KT; ++kt, ++it) {
      const int s = it % WGK_STAGES;
      mbar_wait(&full[s], (it / WGK_STAGES) & 1);
      const uint64_t da = wgmma_desc(As + s * WG_BM * WG_BK + wg * 64 * WG_BK);
      const uint64_t db = wgmma_desc(Bs + s * WGK_BN * WG_BK);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < WG_BK / 16; ++kk)
        wgmma_m64n128(acc, da + 2 * kk, db + 2 * kk);
      wgmma_commit();
      // the previous k-tile's products are done: release its stage
      wgmma_wait<1>();
      if (kt > 0 && (tid & 127) == 0)
        mbar_arrive(&empty[(it - 1) % WGK_STAGES]);
    }
    wgmma_wait<0>();
    if ((tid & 127) == 0) mbar_arrive(&empty[(it - 1) % WGK_STAGES]);

    // the last tile's C is written out: this tile's rows, then its C tile
    asm volatile("bar.sync 1, 256;\n" ::: "memory");
    for (int i = tid; i < WG_BM; i += 256) {
      const long long r = m0 + i;
      const bool ok = r < a.M;
      const long long pc = ok ? map_row(a.cmap, r) : -1;
      s_crow[i] = pc;
      s_scale[i] = (ok && a.dps) ? a.dps[pc / a.hw] : 1.f;
    }
    wgmma_store_acc<WGK_BN>(acc, Cs, WGK_LDC, wg * 64, 0);
    asm volatile("bar.sync 1, 256;\n" ::: "memory");
    wgmma_epilogue<WGK_BN>(a, Cs, WGK_LDC, s_crow, s_scale, n0, tid, 256);
  }
}

// the host side of the kernel form: a grid of one block an SM at most; the
// tensor maps are encoded per launch
inline cudaError_t launch_gemm_wgmma(const GemmArgs& a, cudaStream_t st) {
  const int kcols = gemm_kcols(a);
  CUtensorMap ta, tb;
  cudaError_t err = tensor_map(&ta, a.A, a.M, kcols, a.lda, WG_BM);
  if (err != cudaSuccess) return err;
  if ((err = tensor_map(&tb, a.Wt, a.N, kcols, a.lda, WGK_BN)) != cudaSuccess)
    return err;
  const size_t smem = wgk_smem_bytes();
  err = cudaFuncSetAttribute(gemm_wgmma_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const long long tm = (a.M + WG_BM - 1) / WG_BM;
  const int tn = (a.N + WGK_BN - 1) / WGK_BN;
  if (tm * tn > 0x7fffffffLL) return cudaErrorInvalidValue;
  const int tiles = (int)(tm * tn);
  const int grid = tiles < sms ? tiles : sms;
  gemm_wgmma_kernel<<<grid, WGK_THREADS, smem, st>>>(
      ta, tb, a, (kcols + WG_BK - 1) / WG_BK, tn, tiles);
  return cudaSuccess;
}

// ---- the device-function form (one warpgroup, the merged kernel's loop) -----

constexpr int WG64_BN = 64;
constexpr int WG64_LDC = WG64_BN + 8;

// the ring of S stages, then the tile's C rows and DropPath scales; the
// C tile is staged over the ring
template <int S>
constexpr size_t wg64_smem_bytes() {
  return sizeof(bf16_t) * S * (WG_BM + WG64_BN) * WG_BK +
         WG_BM * (sizeof(long long) + sizeof(float));
}

// the block's k-tile count: stage it % S, phase (it / S) & 1 of full[stage]
struct WgPipe {
  uint64_t* full;   // S mbarriers, initialised once by the kernel
  uint32_t it;
};

// output tile (bx, by) of 128 x 64 for a block of 128 threads; ``ring``
// 1024-byte aligned, wg64_smem_bytes<S>() long. Ends with a barrier.
template <int S>
__device__ __forceinline__ void gemm_wgmma_tile64(const GemmArgs& a,
                                                  const CUtensorMap* ta,
                                                  const CUtensorMap* tb,
                                                  long long bx, int by,
                                                  unsigned char* ring,
                                                  WgPipe& pipe) {
  static_assert(sizeof(float) * WG_BM * WG64_LDC <=
                    sizeof(bf16_t) * S * (WG_BM + WG64_BN) * WG_BK,
                "the C tile must fit the ring");
  constexpr uint32_t STAGE_TX = sizeof(bf16_t) * (WG_BM + WG64_BN) * WG_BK;
  bf16_t* As = reinterpret_cast<bf16_t*>(ring);
  bf16_t* Bs = As + S * WG_BM * WG_BK;
  long long* s_crow = reinterpret_cast<long long*>(Bs + S * WG64_BN * WG_BK);
  float* s_scale = reinterpret_cast<float*>(s_crow + WG_BM);
  const long long m0 = bx * WG_BM;
  const int n0 = by * WG64_BN;
  const int KT = (gemm_kcols(a) + WG_BK - 1) / WG_BK;
  const uint32_t base = pipe.it;

  auto issue = [&](int kt) {
    const int s = (int)((base + kt) % S);
    mbar_expect_tx(&pipe.full[s], STAGE_TX);
    tma_load(As + s * WG_BM * WG_BK, ta, &pipe.full[s], kt * WG_BK, (int)m0);
    tma_load(Bs + s * WG64_BN * WG_BK, tb, &pipe.full[s], kt * WG_BK, n0);
  };

  gemm_rows<WG_BM>(a, m0, s_crow, s_scale);
  fence_proxy_async();  // the last phase's writes to the ring, before TMA
  __syncthreads();
  if (threadIdx.x == 0)
    for (int kt = 0; kt < S && kt < KT; ++kt) issue(kt);

  float acc[2][WG64_BN / 2];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int i = 0; i < WG64_BN / 2; ++i) acc[m][i] = 0.f;
  for (int kt = 0; kt < KT; ++kt) {
    const uint32_t it = base + kt;
    const int s = (int)(it % S);
    mbar_wait(&pipe.full[s], (it / S) & 1);
    const uint64_t da = wgmma_desc(As + s * WG_BM * WG_BK);
    const uint64_t db = wgmma_desc(Bs + s * WG64_BN * WG_BK);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < WG_BK / 16; ++kk) {
      wgmma_m64n64(acc[0], da + 2 * kk, db + 2 * kk);
      wgmma_m64n64(acc[1], da + 2 * kk + ((64 * WG_BK * 2) >> 4), db + 2 * kk);
    }
    wgmma_commit();
    wgmma_wait<0>();
    __syncthreads();  // every warp is done with stage s
    if (threadIdx.x == 0 && kt + S < KT) issue(kt + S);
  }
  pipe.it = base + KT;

  float* Cs = reinterpret_cast<float*>(ring);
  wgmma_store_acc<WG64_BN>(acc[0], Cs, WG64_LDC, 0, 0);
  wgmma_store_acc<WG64_BN>(acc[1], Cs, WG64_LDC, 64, 0);
  __syncthreads();
  wgmma_epilogue<WG64_BN>(a, Cs, WG64_LDC, s_crow, s_scale, n0, threadIdx.x,
                          blockDim.x);
  __syncthreads();
}

// Where launch_gemm's bf16 path takes the kernel form: wide products (K1's
// and K2's passes at K = 448 ... 3584 ran 13-39% faster on it than on
// gemm_mma_tile on an H100, PERF.md section 6); narrow ones keep the old
// tile. TMA needs 16-byte aligned operands
inline bool gemm_wgmma_ok(const GemmArgs& a) {
  return gemm_kcols(a) >= 192 && a.N > 64 &&
         ((reinterpret_cast<uintptr_t>(a.A) |
           reinterpret_cast<uintptr_t>(a.Wt)) % 16) == 0;
}

}  // namespace fairm
