// Split-K products of the split block kernels K12 (lewin_attn_split.cu) and
// K13 (lewin_ffn_split.cu).
//
// At the deep stages (C = 896 at res 8 and 16) the blocks' products have
// few rows and long reductions: the FFN's linear2 at res 8 and B = 4 has
// M = 256, N = 896, K = 3584, which the tiled GEMM covers with 28 output
// tiles on 132 SMs, each over 112 k-tiles. Splitting the reduction into kb
// parts puts kb times the CTAs on the card.
//
// splitk_gemm: grid (row tiles, column tiles, kb); part z contracts the
// k-tiles [z kt, (z + 1) kt) of A [M, lda] and Wt [N, lda] (the shared tile
// of gemm.cuh, bf16 on the tensor cores with fp32 accumulation, fp32 on
// the CUDA cores in full precision) into the fp32 partial z of
// parts [kb, M, N].
// split_reduce: C[cmap(r), c] = res + dps[image] * (sum_z parts[z, r, c] +
// bias[c]), the parts added in the order z = 0, 1, ..., so that a second
// launch gives equal bits (no atomics), rounded once to the output type.

#pragma once

#include <algorithm>

#include "gemm.cuh"

namespace fairm {

template <int BN>
__global__ void __launch_bounds__(BN * 2)
    splitk_mma_kernel(const GemmArgs a, int kt) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int z = blockIdx.z;
  GemmArgs s = a;
  s.A = static_cast<const bf16_t*>(a.A) + (long long)z * kt * GBK;
  s.Wt = static_cast<const bf16_t*>(a.Wt) + (long long)z * kt * GBK;
  s.C = static_cast<float*>(a.C) + (long long)z * a.M * a.N;
  s.ktiles = kt;
  gemm_mma_tile<BN, float>(s, blockIdx.x, blockIdx.y, smem_raw);
}

static __global__ void __launch_bounds__(FMA_NT)
    splitk_fma_kernel(const GemmArgs a, int kt) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int z = blockIdx.z;
  GemmArgs s = a;
  s.A = static_cast<const float*>(a.A) + (long long)z * kt * GBK;
  s.Wt = static_cast<const float*>(a.Wt) + (long long)z * kt * GBK;
  s.C = static_cast<float*>(a.C) + (long long)z * a.M * a.N;
  s.ktiles = kt;
  gemm_fma_tile(s, blockIdx.x, blockIdx.y, smem_raw);
}

// parts [kb, M, N] = the kb k-ranges of A Wt^T; lda / GBK must divide by kb
template <typename T>
inline cudaError_t launch_splitk(const void* A, const void* Wt, int lda,
                                 long long M, int N, int kb, float* parts,
                                 cudaStream_t st) {
  const int KT = lda / GBK;
  if (kb < 1 || KT % kb) return cudaErrorInvalidValue;
  GemmArgs a{};
  a.A = A;
  a.Wt = Wt;
  a.lda = lda;
  a.hw = 1;
  a.C = parts;
  a.cmap = identity_map();
  a.M = M;
  a.N = N;
  if constexpr (std::is_same<T, float>::value) {
    const dim3 grid((unsigned)((M + FMA_BM - 1) / FMA_BM),
                    (unsigned)((N + FMA_BN - 1) / FMA_BN), (unsigned)kb);
    splitk_fma_kernel<<<grid, FMA_NT, FMA_SMEM, st>>>(a, KT / kb);
    return cudaSuccess;
  } else {
    auto run = [&](auto kernel, int bn, size_t smem) {
      cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return err;
      const dim3 grid((unsigned)((M + MMA_BM - 1) / MMA_BM),
                      (unsigned)((N + bn - 1) / bn), (unsigned)kb);
      kernel<<<grid, bn * 2, smem, st>>>(a, KT / kb);
      return cudaSuccess;
    };
    if (N <= 64) return run(splitk_mma_kernel<64>, 64, mma_smem_bytes<64>());
    return run(splitk_mma_kernel<128>, 128, mma_smem_bytes<128>());
  }
}

template <typename T>
__global__ void __launch_bounds__(256)
    split_reduce_kernel(const float* parts, int kb, long long M, int N,
                        const float* bias, const float* dps, long long hw,
                        const T* res, T* out, RowMap cmap) {
  const long long total = M * N;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < total; i += (long long)gridDim.x * blockDim.x) {
    const long long r = i / N;
    const int c = (int)(i - r * N);
    float v = 0.f;
    for (int z = 0; z < kb; ++z) v += parts[z * total + i];
    if (bias) v += bias[c];
    const long long pc = map_row(cmap, r);
    if (dps) v *= dps[pc / hw];
    const long long off = pc * N + c;
    if (res) v += to_f(res[off]);
    out[off] = from_f<T>(v);
  }
}

template <typename T>
inline void launch_split_reduce(const float* parts, int kb, long long M, int N,
                                const float* bias, const float* dps,
                                long long hw, const void* res, void* out,
                                RowMap cmap, cudaStream_t st) {
  const long long blocks = std::min<long long>((M * N + 255) / 256, 132 * 16);
  split_reduce_kernel<T><<<(unsigned)blocks, 256, 0, st>>>(
      parts, kb, M, N, bias, dps, hw, static_cast<const T*>(res),
      static_cast<T*>(out), cmap);
}

}  // namespace fairm
