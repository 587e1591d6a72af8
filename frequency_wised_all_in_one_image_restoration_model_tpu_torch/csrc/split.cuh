// Shared pieces of the split block kernels K12 (lewin_attn_split.cu) and
// K13 (lewin_ffn_split.cu): the fp32 product core, a GEMM on it with
// split-K parts, the bf16 split-K parts on the TMA / wgmma tile in one
// launch, and the fixed-order reduction of the parts.
//
// At the deep stages (C = 896 at res 8 and 16) the blocks' products have
// few rows (M = 64 B at res 8, where one 8 x 8 window is the whole image)
// and long reductions. TF32 stays off, so in fp32 they run on the CUDA
// cores, whose bound is 67 TFLOP/s.
//
// fma_mainloop: the fp32 core. A block of FNT = 256 threads accumulates a
// BM x BN tile of A B^T (A [BM rows, K], B [BN rows, K], both K-contiguous,
// rows handed over by pointer, a null row read as zeros) in registers:
// thread (tx, ty) owns rows ty + TYN i and columns tx + TXN j. K-tiles of
// FK = 32 columns come in by cp.async (16 bytes a copy) into a ring of S
// stages, [rows][FK + 4] each: the 4-float pad puts eight consecutive rows
// on eight distinct 16-byte bank groups, so that each thread reads float4
// runs along k (a quarter-warp reads one A row, a broadcast, and eight
// consecutive B rows): TM + TN shared loads of 16 bytes feed 4 TM TN FMAs.
// The k-tiles are added in order, each column k after k - 1 (fmaf), so a
// second launch gives equal bits.
//
// fma_gemm_kernel: C[cmap(r), :] = epilogue(A[r, :] Wt^T) on the core,
// tiles of 64 (128 where M fills the card) x 112, or with kb > 1 raw fp32
// parts [kb, M, N] of kb k-ranges for split_reduce. 112 columns make the
// C = 896 stages' widths whole numbers of tiles that fill the card's waves
// (896 = 8 tiles, 3584 = 32: 256 tiles at M = 1024 against 224 of 128
// columns on 132 SMs; PERF.md, PR 13).
// split_reduce: C[cmap(r), c] = res + dps[image] * (sum_z parts[z, r, c] +
// bias[c]), the parts added in the order z = 0, 1, ... (no atomics),
// rounded once to the output type.

#pragma once

#include <algorithm>

#include "gemm.cuh"

namespace fairm {

// ---- the fp32 core ----------------------------------------------------------

constexpr int FNT = 256;        // threads of a block
constexpr int FK = 32;          // k columns a stage
constexpr int FLD = FK + 4;     // a stage row's stride (floats)

// rows [0, rows) of a k-tile (columns k0 .. k0 + 31) into dst [rows][FLD];
// row(r) is the row's first element or null (zeros)
template <typename Row>
__device__ __forceinline__ void fma_load(float* dst, int rows, Row row, int k0,
                                         const float* any) {
  for (int c = threadIdx.x; c < rows * (FK / 4); c += FNT) {
    const int r = c >> 3, j = (c & 7) * 4;
    const float* p = row(r);
    cp_async16(dst + r * FLD + j, p ? p + k0 + j : any, p != nullptr);
  }
}

// acc += A[:, 32 k-columns] B[:, same]^T for A rows of stride lda, B rows
// of stride FLD: a float4 of k-columns of each row, then every accumulator
// takes the first column, then the second, ... (each accumulator's sum in
// k order, and TM TN independent FMAs between two that depend)
template <int TM, int TN, int TXN>
__device__ __forceinline__ void fma_step(float (&acc)[TM][TN], const float* As,
                                         int lda, const float* Bs) {
  constexpr int TYN = FNT / TXN;
  const int tx = threadIdx.x % TXN, ty = threadIdx.x / TXN;
#pragma unroll
  for (int kk = 0; kk < FK; kk += 4) {
    float4 a[TM], b[TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
      a[i] = *reinterpret_cast<const float4*>(As + (ty + TYN * i) * lda + kk);
#pragma unroll
    for (int j = 0; j < TN; ++j)
      b[j] = *reinterpret_cast<const float4*>(Bs + (tx + TXN * j) * FLD + kk);
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i].x, b[j].x, acc[i][j]);
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i].y, b[j].y, acc[i][j]);
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i].z, b[j].z, acc[i][j]);
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i].w, b[j].w, acc[i][j]);
  }
}

template <int TM, int TN, int TXN, int S>
constexpr size_t fma_ring_floats() {
  return (size_t)S * (TM * (FNT / TXN) + TN * TXN) * FLD;
}

// acc += A B^T over k-tiles [kt0, kt0 + nkt); ``ring`` holds
// fma_ring_floats<TM, TN, TXN, S>() floats. Ends with a barrier.
template <int TM, int TN, int TXN, int S, typename ARow, typename BRow>
__device__ __forceinline__ void fma_mainloop(float (&acc)[TM][TN], ARow arow,
                                             BRow brow, int kt0, int nkt,
                                             float* ring, const float* any) {
  constexpr int BM = TM * (FNT / TXN), BN = TN * TXN;
  constexpr int STAGE = (BM + BN) * FLD;
  auto load = [&](int s, int kt) {
    float* st = ring + s * STAGE;
    fma_load(st, BM, arow, (kt0 + kt) * FK, any);
    fma_load(st + BM * FLD, BN, brow, (kt0 + kt) * FK, any);
  };
#pragma unroll
  for (int s = 0; s < S - 1; ++s) {
    if (s < nkt) load(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < nkt; ++kt) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(S - 2));
    __syncthreads();
    const int nxt = kt + S - 1;
    if (nxt < nkt) load(nxt % S, nxt);
    cp_async_commit();
    const float* st = ring + (kt % S) * STAGE;
    fma_step<TM, TN, TXN>(acc, st, FLD, st + BM * FLD);
  }
  cp_async_wait_all();
  __syncthreads();
}

// ---- a GEMM on the core -----------------------------------------------------

constexpr int FG_STAGES = 3;
constexpr int FG_TN = 7;             // a thread's columns
constexpr int FG_BN = 16 * FG_TN;    // 112: 896 = 8 tiles, 3584 = 32

template <int TM>
constexpr size_t fma_gemm_smem() {
  return 16 * TM * (sizeof(long long) + sizeof(float)) +
         sizeof(float) * fma_ring_floats<TM, FG_TN, 16, FG_STAGES>();
}

// tile (blockIdx.x, blockIdx.y) of 16 TM x FG_BN (112); part blockIdx.z of
// gridDim.z over kt k-tiles each
template <int TM>
__global__ void __launch_bounds__(FNT)
    fma_gemm_kernel(const GemmArgs a, int kt) {
  constexpr int TN = FG_TN, TXN = 16, BM = TM * 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  long long* s_crow = reinterpret_cast<long long*>(smem_raw);
  float* s_scale = reinterpret_cast<float*>(s_crow + BM);
  float* ring = s_scale + BM;
  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * FG_BN, z = blockIdx.z;
  const float* A = static_cast<const float*>(a.A);
  const float* Wt = static_cast<const float*>(a.Wt);
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
  fma_mainloop<TM, TN, TXN, FG_STAGES>(
      acc,
      [&](int r) -> const float* {
        return m0 + r < a.M ? A + (m0 + r) * a.lda : nullptr;
      },
      [&](int c) -> const float* {
        return n0 + c < a.N ? Wt + (long long)(n0 + c) * a.lda : nullptr;
      },
      z * kt, kt, ring, A);
  const int tx = threadIdx.x % TXN, ty = threadIdx.x / TXN;
  if (gridDim.z > 1) {  // raw part z
    float* P = static_cast<float*>(a.C) + (long long)z * a.M * a.N;
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const long long r = m0 + ty + 16 * i;
      if (r >= a.M) continue;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int c = n0 + tx + TXN * j;
        if (c < a.N) P[r * a.N + c] = acc[i][j];
      }
    }
    return;
  }
  gemm_rows<BM>(a, m0, s_crow, s_scale);
  __syncthreads();
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j)
      gemm_store<float>(a, s_crow, s_scale, ty + 16 * i, n0 + tx + TXN * j,
                        acc[i][j]);
}

// 128-row tiles where they alone put a block on every SM, else 64
inline bool fma_gemm_wide(long long M, int N) {
  return ((M + 127) / 128) * ((N + FG_BN - 1) / FG_BN) >= 132;
}

// fp32 C = epilogue(A Wt^T) (kb = 1) or parts [kb, M, N] = its kb k-ranges
// (a.C the parts; no epilogue); the k-tiles must divide by kb
inline cudaError_t launch_fma_gemm(const GemmArgs& a, int kb, cudaStream_t st) {
  const int KT = a.ktiles ? a.ktiles : a.lda / GBK;
  if (kb < 1 || KT % kb) return cudaErrorInvalidValue;
  auto run = [&](auto kernel, int bm, size_t smem) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((unsigned)((a.M + bm - 1) / bm),
                    (unsigned)((a.N + FG_BN - 1) / FG_BN), (unsigned)kb);
    kernel<<<grid, FNT, smem, st>>>(a, KT / kb);
    return cudaSuccess;
  };
  if (fma_gemm_wide(a.M, a.N))
    return run(fma_gemm_kernel<8>, 128, fma_gemm_smem<8>());
  return run(fma_gemm_kernel<4>, 64, fma_gemm_smem<4>());
}

// ---- the reduction ----------------------------------------------------------

// V adjacent columns a thread (4 where N allows: one 16-byte read a part)
template <typename T, int V>
__global__ void __launch_bounds__(256)
    split_reduce_kernel(const float* parts, int kb, long long M, int N,
                        const float* bias, const float* dps, long long hw,
                        const T* res, T* out, RowMap cmap) {
  const long long total = M * N;
  const int nv = N / V;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < M * nv; i += (long long)gridDim.x * blockDim.x) {
    const long long r = i / nv;
    const int c = (int)(i - r * nv) * V;
    const long long e = r * N + c;
    float v[V];
    if constexpr (V == 4) {
      const float4 p = *reinterpret_cast<const float4*>(parts + e);
      v[0] = p.x, v[1] = p.y, v[2] = p.z, v[3] = p.w;
      for (int z = 1; z < kb; ++z) {
        const float4 q = *reinterpret_cast<const float4*>(parts + z * total + e);
        v[0] += q.x, v[1] += q.y, v[2] += q.z, v[3] += q.w;
      }
    } else {
      v[0] = parts[e];
      for (int z = 1; z < kb; ++z) v[0] += parts[z * total + e];
    }
    const long long pc = map_row(cmap, r);
    const float scale = dps ? dps[pc / hw] : 1.f;
    const long long off = pc * N + c;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      float x = v[j];
      if (bias) x += bias[c + j];
      if (dps) x *= scale;
      if (res) x += to_f(res[off + j]);
      out[off + j] = from_f<T>(x);
    }
  }
}

template <typename T>
inline void launch_split_reduce(const float* parts, int kb, long long M, int N,
                                const float* bias, const float* dps,
                                long long hw, const void* res, void* out,
                                RowMap cmap, cudaStream_t st) {
  const bool vec = N % 4 == 0 && reinterpret_cast<uintptr_t>(parts) % 16 == 0;
  const long long items = M * N / (vec ? 4 : 1);
  const long long blocks = std::min<long long>((items + 255) / 256, 132 * 16);
  auto run = [&](auto kernel) {
    kernel<<<(unsigned)blocks, 256, 0, st>>>(
        parts, kb, M, N, bias, dps, hw, static_cast<const T*>(res),
        static_cast<T*>(out), cmap);
  };
  if (vec)
    run(split_reduce_kernel<T, 4>);
  else
    run(split_reduce_kernel<T, 1>);
}

// ---- bf16 split-K parts on the TMA / wgmma tile -----------------------------

// gemm_wgmma.cuh's kernel form for one 128 x 128 tile a block: block
// (tile, part z) contracts the 64-column k-tiles [z kt, (z + 1) kt) of A
// [M, lda] and Wt [N, lda] (the k-range is a TMA coordinate, so one pair of
// tensor maps serves every part) into the fp32 part z of a.C [kb, M, N]
static __global__ void __launch_bounds__(WGK_THREADS, 1)
    splitk_wgmma_kernel(const __grid_constant__ CUtensorMap ta,
                        const __grid_constant__ CUtensorMap tb, const GemmArgs a,
                        int kt, int tiles_n) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* sm = align1024(smem_raw);
  bf16_t* As = reinterpret_cast<bf16_t*>(sm);
  bf16_t* Bs = As + WGK_STAGES * WG_BM * WG_BK;
  float* Cs = reinterpret_cast<float*>(sm + WGK_CS);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + WGK_BARS);
  uint64_t* empty = full + WGK_STAGES;
  long long* s_crow = reinterpret_cast<long long*>(sm + WGK_ROWS);
  float* s_scale = reinterpret_cast<float*>(s_crow + WG_BM);
  const int tid = threadIdx.x, wg = tid >> 7, z = blockIdx.y;
  const long long m0 = (long long)(blockIdx.x / tiles_n) * WG_BM;
  const int n0 = (blockIdx.x % tiles_n) * WGK_BN;
  if (tid == 0) {
    for (int s = 0; s < WGK_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);  // one arrival per consumer warpgroup
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 2) {  // the producer warp
    if (tid == 256)
      for (int k = 0; k < kt; ++k) {
        const int s = k % WGK_STAGES;
        if (k >= WGK_STAGES) mbar_wait(&empty[s], ((k / WGK_STAGES) - 1) & 1);
        mbar_expect_tx(&full[s], (uint32_t)WGK_STAGE_BYTES);
        tma_load(As + s * WG_BM * WG_BK, &ta, &full[s], (z * kt + k) * WG_BK,
                 (int)m0);
        tma_load(Bs + s * WGK_BN * WG_BK, &tb, &full[s], (z * kt + k) * WG_BK,
                 n0);
      }
    return;
  }

  float acc[WGK_BN / 2];
#pragma unroll
  for (int i = 0; i < WGK_BN / 2; ++i) acc[i] = 0.f;
  for (int k = 0; k < kt; ++k) {
    const int s = k % WGK_STAGES;
    mbar_wait(&full[s], (k / WGK_STAGES) & 1);
    const uint64_t da = wgmma_desc(As + s * WG_BM * WG_BK + wg * 64 * WG_BK);
    const uint64_t db = wgmma_desc(Bs + s * WGK_BN * WG_BK);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < WG_BK / 16; ++kk)
      wgmma_m64n128(acc, da + 2 * kk, db + 2 * kk);
    wgmma_commit();
    // the previous k-tile's products are done: release its stage
    wgmma_wait<1>();
    if (k > 0 && (tid & 127) == 0) mbar_arrive(&empty[(k - 1) % WGK_STAGES]);
  }
  wgmma_wait<0>();

  GemmArgs p = a;
  p.C = static_cast<float*>(a.C) + (long long)z * a.M * a.N;
  for (int i = tid; i < WG_BM; i += 256) {
    s_crow[i] = m0 + i < a.M ? m0 + i : -1;
    s_scale[i] = 1.f;
  }
  wgmma_store_acc<WGK_BN>(acc, Cs, WGK_LDC, wg * 64, 0);
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
  wgmma_epilogue<WGK_BN>(p, Cs, WGK_LDC, s_crow, s_scale, n0, tid, 256);
}

// the bf16 parts [kb, M, N] of A Wt^T in one launch; a part must be whole
// 64-column k-tiles
inline cudaError_t launch_splitk_wgmma(const GemmArgs& a, int kb,
                                       cudaStream_t st) {
  if (a.lda % (WG_BK * kb)) return cudaErrorInvalidValue;
  CUtensorMap ta, tb;
  cudaError_t err = tensor_map(&ta, a.A, a.M, a.lda, a.lda, WG_BM);
  if (err != cudaSuccess) return err;
  if ((err = tensor_map(&tb, a.Wt, a.N, a.lda, a.lda, WGK_BN)) != cudaSuccess)
    return err;
  const size_t smem = wgk_smem_bytes();
  err = cudaFuncSetAttribute(splitk_wgmma_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  const long long tm = (a.M + WG_BM - 1) / WG_BM;
  const int tn = (a.N + WGK_BN - 1) / WGK_BN;
  splitk_wgmma_kernel<<<dim3((unsigned)(tm * tn), (unsigned)kb), WGK_THREADS,
                        smem, st>>>(ta, tb, a, a.lda / WG_BK / kb, tn);
  return cudaSuccess;
}

// C[cmap(r), :] = res + dps * (A Wt^T + bias) over kb parts of the
// reduction: one product with its epilogue (kb = 1), else kb products into
// the fp32 parts and the fixed-order reduction. fp32 on the core above,
// bf16 on gemm.cuh's launch_gemm (kb = 1) or the parts in one launch on the
// TMA / wgmma tile, each part whole 64-column k-tiles (else
// cudaErrorInvalidValue: lewin_block.py's split_cols refuses such a kb).
template <typename T>
inline cudaError_t split_product(const void* A, const void* Wt, int lda,
                                 long long M, int N, const float* bias,
                                 const float* dps, long long hw,
                                 const void* res, void* out, RowMap cmap,
                                 int kb, float* parts, cudaStream_t st) {
  const int KT = lda / GBK;
  if (kb < 1 || KT % kb) return cudaErrorInvalidValue;
  GemmArgs g{};
  g.A = A;
  g.Wt = Wt;
  g.lda = lda;
  g.M = M;
  g.N = N;
  if (kb == 1) {
    g.bias = bias;
    g.dps = dps;
    g.hw = hw;
    g.res = res;
    g.C = out;
    g.cmap = cmap;
    if constexpr (std::is_same<T, float>::value) return launch_fma_gemm(g, 1, st);
    return launch_gemm<T>(g, st);
  }
  g.hw = 1;
  g.cmap = identity_map();
  cudaError_t err;
  if constexpr (std::is_same<T, float>::value) {
    g.C = parts;
    err = launch_fma_gemm(g, kb, st);
  } else {
    g.C = parts;
    g.c_f32 = 1;
    err = launch_splitk_wgmma(g, kb, st);
  }
  if (err != cudaSuccess) return err;
  launch_split_reduce<T>(parts, kb, M, N, bias, dps, hw, res, out, cmap, st);
  return cudaSuccess;
}

}  // namespace fairm
