// Shared pieces of the LeWin-block kernels (K1-K3): the row prep pass and
// the tiled GEMM.
//
// prep_rows: gathers rows of a [pixels, K] tensor through a RowMap (the
// window partition and the frequency-band regroup are such gathers),
// optionally LayerNorms them (fp32 statistics, two passes), and writes a
// dense [M, kpad(K)] matrix whose pad columns are zero.
//
// gemm: C[cmap(r), :] = epilogue(A[r, :] @ Wt^T) with A [M, lda] and
// Wt [N, lda] dense, lda = kpad(K) (a multiple of 32, rows 16-byte
// aligned, zero pad). Epilogue in fp32: + bias[col], optional tanh-GELU,
// x dps[image] (DropPath branch scale), + residual in C's layout, rounded to
// the output type; the C rows are scattered through cmap (the window
// reverse). bf16: a 3-stage cp.async pipeline into padded shared-memory
// tiles, ldmatrix fragments and mma.sync m16n8k16 with fp32 accumulation,
// warps of 64 x 32. fp32: shared-memory tiled FMA in full fp32 (no TF32).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace fairm {

typedef __nv_bfloat16 bf16_t;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16_t v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16_t from_f<bf16_t>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// tanh-approximate GELU, as jax.nn.gelu(approximate=True)
__device__ __forceinline__ float gelu_tanh(float x) {
  const float k = 0.7978845608028654f;  // sqrt(2 / pi)
  return 0.5f * x * (1.f + tanhf(k * (x + 0.044715f * x * x * x)));
}

constexpr int GBK = 32;
inline int kpad(int k) { return (k + GBK - 1) / GBK * GBK; }

// Logical row -> physical row of a [images * H * W, C] pixel tensor.
//  mode 0: identity.
//  mode 1: window-major. Row r = (b * nW + window) * n + token of a
//          [B, H, W] image batch cut into win x win windows.
//  mode 2: band-grouped windows. Row r = (b * nW + window) * L*n + l * n +
//          token, where the pixel lives in image l * B + b of a band-major
//          [L * B, H, W] batch (the frequency-MSA inter regroup).
struct RowMap {
  int mode;
  int H, W, win, B, L;
};

inline RowMap identity_map() { return RowMap{0, 1, 1, 1, 1, 1}; }

__device__ __forceinline__ long long map_row(const RowMap& m, long long r) {
  if (m.mode == 0) return r;
  const int n = m.win * m.win;
  const int nWc = m.W / m.win;
  const int nW = (m.H / m.win) * nWc;
  long long img;
  int wi, t;
  if (m.mode == 1) {
    const long long w = r / n;
    t = (int)(r - w * n);
    img = w / nW;
    wi = (int)(w - img * nW);
  } else {
    const int Ln = m.L * n;
    const long long grp = r / Ln;
    const int tt = (int)(r - grp * Ln);
    const int l = tt / n;
    t = tt - l * n;
    const long long b = grp / nW;
    wi = (int)(grp - b * nW);
    img = (long long)l * m.B + b;
  }
  const int y = (wi / nWc) * m.win + t / m.win;
  const int x = (wi % nWc) * m.win + t % m.win;
  return (img * m.H + y) * m.W + x;
}

// ---------------------------------------------------------------------------
// prep: gather (+ LayerNorm) + zero pad, one warp per row
// ---------------------------------------------------------------------------

template <typename T>
__global__ void prep_rows_kernel(const T* src, int K, RowMap amap, long long M,
                                 const float* ln_g, const float* ln_b,
                                 float eps, T* dst, int ldd) {
  const int lane = threadIdx.x & 31;
  const long long r = (long long)blockIdx.x * (blockDim.x / 32) + (threadIdx.x >> 5);
  if (r >= M) return;
  const T* row = src + map_row(amap, r) * K;
  float mu = 0.f, rs = 1.f;
  if (ln_g) {
    float s = 0.f;
    for (int k = lane; k < K; k += 32) s += to_f(row[k]);
    mu = warp_sum(s) / K;
    float var = 0.f;
    for (int k = lane; k < K; k += 32) {
      const float dv = to_f(row[k]) - mu;
      var += dv * dv;
    }
    rs = rsqrtf(warp_sum(var) / K + eps);
  }
  T* out = dst + r * ldd;
  for (int k = lane; k < ldd; k += 32) {
    float v = 0.f;
    if (k < K) {
      v = to_f(row[k]);
      if (ln_g) v = (v - mu) * rs * ln_g[k] + ln_b[k];
    }
    out[k] = from_f<T>(v);
  }
}

template <typename T>
inline void launch_prep(const void* src, int K, RowMap amap, long long M,
                        const float* ln_g, const float* ln_b, float eps,
                        void* dst, cudaStream_t st) {
  const int rows_per_block = 8;
  const long long blocks = (M + rows_per_block - 1) / rows_per_block;
  prep_rows_kernel<T><<<(unsigned)blocks, 32 * rows_per_block, 0, st>>>(
      static_cast<const T*>(src), K, amap, M, ln_g, ln_b, eps,
      static_cast<T*>(dst), kpad(K));
}

// ---------------------------------------------------------------------------
// GEMM
// ---------------------------------------------------------------------------

struct GemmArgs {
  const void* A;       // [M, lda]
  const void* Wt;      // [N, lda]
  int lda;             // kpad(K)
  const float* bias;   // [N] or null
  const float* dps;    // per-image scale, image = physical C row / hw; or null
  long long hw;
  const void* res;     // residual in C's layout, or null
  void* C;             // [*, N], rows through cmap
  RowMap cmap;
  long long M;
  int N;
  int act;             // 1: tanh-GELU after the bias
};

template <typename T>
struct alignas(2 * sizeof(T)) Vec2 {
  T v[2];
};

template <typename T>
__device__ __forceinline__ void gemm_store(const GemmArgs& a,
                                           const long long* s_crow,
                                           const float* s_scale, int lr,
                                           int col, float v) {
  const long long pc = s_crow[lr];
  if (pc < 0 || col >= a.N) return;
  if (a.bias) v += a.bias[col];
  if (a.act) v = gelu_tanh(v);
  if (a.dps) v *= s_scale[lr];
  const long long off = pc * a.N + col;
  if (a.res) v += to_f(static_cast<const T*>(a.res)[off]);
  static_cast<T*>(a.C)[off] = from_f<T>(v);
}

// two adjacent columns (col even, N even) in one 4-byte (bf16) or 8-byte
// (fp32) access
template <typename T>
__device__ __forceinline__ void gemm_store2(const GemmArgs& a,
                                            const long long* s_crow,
                                            const float* s_scale, int lr,
                                            int col, float v0, float v1) {
  if (a.N & 1) {  // rows not 2-element aligned
    gemm_store<T>(a, s_crow, s_scale, lr, col, v0);
    gemm_store<T>(a, s_crow, s_scale, lr, col + 1, v1);
    return;
  }
  const long long pc = s_crow[lr];
  if (pc < 0 || col >= a.N) return;
  if (a.bias) {
    v0 += a.bias[col];
    v1 += a.bias[col + 1];
  }
  if (a.act) {
    v0 = gelu_tanh(v0);
    v1 = gelu_tanh(v1);
  }
  if (a.dps) {
    v0 *= s_scale[lr];
    v1 *= s_scale[lr];
  }
  const long long off = pc * a.N + col;
  Vec2<T>* dst = reinterpret_cast<Vec2<T>*>(static_cast<T*>(a.C) + off);
  if (a.res) {
    const Vec2<T> r = *reinterpret_cast<const Vec2<T>*>(
        static_cast<const T*>(a.res) + off);
    v0 += to_f(r.v[0]);
    v1 += to_f(r.v[1]);
  }
  Vec2<T> o;
  o.v[0] = from_f<T>(v0);
  o.v[1] = from_f<T>(v1);
  *dst = o;
}

template <int BM>
__device__ __forceinline__ void gemm_rows(const GemmArgs& a, long long m0,
                                          long long* s_crow, float* s_scale) {
  for (int i = threadIdx.x; i < BM; i += blockDim.x) {
    const long long r = m0 + i;
    const bool ok = r < a.M;
    const long long pc = ok ? map_row(a.cmap, r) : -1;
    s_crow[i] = pc;
    s_scale[i] = (ok && a.dps) ? a.dps[pc / a.hw] : 1.f;
  }
}

// ---- bf16: cp.async pipeline + ldmatrix + mma.sync ------------------------

constexpr int MMA_BM = 128, MMA_STAGES = 3, MMA_LDS = GBK + 8;  // +8: no bank conflicts

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  const int bytes = valid ? 16 : 0;  // 0: zero-fill the 16 bytes
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(bytes));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* smem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const void* smem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

// two floats -> a bf16x2 register, the first in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ void mma_bf16_16816(float* c, const uint32_t* a,
                                               const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <int BN>
constexpr size_t mma_smem_bytes() {
  return sizeof(bf16_t) * MMA_STAGES * (MMA_BM + BN) * MMA_LDS;
}

// BM = 128; BN = 64 (4 warps) or 128 (8 warps); each warp owns 64 x 32
template <int BN>
__global__ void __launch_bounds__(BN * 2) gemm_mma_kernel(const GemmArgs a) {
  constexpr int NT = BN * 2;
  constexpr int WARPS_N = BN / 32;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16_t* As = reinterpret_cast<bf16_t*>(smem_raw);
  bf16_t* Bs = As + MMA_STAGES * MMA_BM * MMA_LDS;
  __shared__ long long s_crow[MMA_BM];
  __shared__ float s_scale[MMA_BM];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long long m0 = (long long)blockIdx.x * MMA_BM;
  const int n0 = blockIdx.y * BN;
  const bf16_t* A = static_cast<const bf16_t*>(a.A);
  const bf16_t* Wt = static_cast<const bf16_t*>(a.Wt);
  const int KT = a.lda / GBK;

  auto load_tile = [&](int stage, int kt) {
    bf16_t* as = As + stage * MMA_BM * MMA_LDS;
    bf16_t* bs = Bs + stage * BN * MMA_LDS;
    const int k0 = kt * GBK;
    // 4 chunks of 16 bytes per 32-wide row
    for (int c = tid; c < MMA_BM * 4; c += NT) {
      const int i = c >> 2, j = (c & 3) * 8;
      const long long r = m0 + i;
      const bool ok = r < a.M;
      cp_async16(as + i * MMA_LDS + j, A + (ok ? r : 0) * a.lda + k0 + j, ok);
    }
    for (int c = tid; c < BN * 4; c += NT) {
      const int i = c >> 2, j = (c & 3) * 8;
      const int nn = n0 + i;
      const bool ok = nn < a.N;
      cp_async16(bs + i * MMA_LDS + j, Wt + (long long)(ok ? nn : 0) * a.lda + k0 + j,
                 ok);
    }
  };

  gemm_rows<MMA_BM>(a, m0, s_crow, s_scale);

#pragma unroll
  for (int s = 0; s < MMA_STAGES - 1; ++s) {
    if (s < KT) load_tile(s, s);
    asm volatile("cp.async.commit_group;\n" ::);
  }

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  for (int kt = 0; kt < KT; ++kt) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(MMA_STAGES - 2));
    __syncthreads();
    const int next = kt + MMA_STAGES - 1;
    if (next < KT) load_tile(next % MMA_STAGES, next);
    asm volatile("cp.async.commit_group;\n" ::);

    const bf16_t* as = As + (kt % MMA_STAGES) * MMA_BM * MMA_LDS;
    const bf16_t* bs = Bs + (kt % MMA_STAGES) * BN * MMA_LDS;
#pragma unroll
    for (int kk = 0; kk < GBK; kk += 16) {
      uint32_t af[4][4], bfr[4][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        const int r = wm * 64 + mi * 16 + (lane & 15);
        ldmatrix_x4(af[mi], as + r * MMA_LDS + kk + (lane >> 4) * 8);
      }
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        // matrices: (n 0-7, k lo), (n 0-7, k hi), (n 8-15, k lo), (n 8-15, k hi)
        const int nr = wn * 32 + np * 16 + (lane & 7) + ((lane >> 4) << 3);
        uint32_t t[4];
        ldmatrix_x4(t, bs + nr * MMA_LDS + kk + ((lane >> 3) & 1) * 8);
        bfr[np * 2][0] = t[0];
        bfr[np * 2][1] = t[1];
        bfr[np * 2 + 1][0] = t[2];
        bfr[np * 2 + 1][1] = t[3];
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_bf16_16816(acc[mi][ni], af[mi], bfr[ni]);
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::);

  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; e += 2)
        gemm_store2<bf16_t>(a, s_crow, s_scale,
                            wm * 64 + mi * 16 + g + (e >= 2 ? 8 : 0),
                            n0 + wn * 32 + ni * 8 + t4 * 2, acc[mi][ni][e],
                            acc[mi][ni][e + 1]);
}

// ---- fp32: shared-memory tiled FMA -----------------------------------------

constexpr int FMA_BM = 128, FMA_BN = 64, FMA_NT = 128;

static __global__ void __launch_bounds__(FMA_NT) gemm_fma_kernel(const GemmArgs a) {
  __shared__ float As[FMA_BM][GBK + 1];
  __shared__ float Ws[FMA_BN][GBK + 1];
  __shared__ long long s_crow[FMA_BM];
  __shared__ float s_scale[FMA_BM];

  const int tid = threadIdx.x;
  const long long m0 = (long long)blockIdx.x * FMA_BM;
  const int n0 = blockIdx.y * FMA_BN;
  const float* A = static_cast<const float*>(a.A);
  const float* Wt = static_cast<const float*>(a.Wt);
  gemm_rows<FMA_BM>(a, m0, s_crow, s_scale);

  // thread (tm, tn) owns rows tm + 16 i and columns tn + 8 j
  const int tm = tid & 15, tn = tid >> 4;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < a.lda; k0 += GBK) {
    for (int e = tid; e < FMA_BM * GBK; e += FMA_NT) {
      const int i = e / GBK, kk = e % GBK;
      const long long r = m0 + i;
      As[i][kk] = r < a.M ? A[r * a.lda + k0 + kk] : 0.f;
    }
    for (int e = tid; e < FMA_BN * GBK; e += FMA_NT) {
      const int j = e / GBK, kk = e % GBK, nn = n0 + j;
      Ws[j][kk] = nn < a.N ? Wt[(long long)nn * a.lda + k0 + kk] : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int k = 0; k < GBK; ++k) {
      float av[8], bv[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) av[i] = As[tm + 16 * i][k];
#pragma unroll
      for (int j = 0; j < 8; ++j) bv[j] = Ws[tn + 8 * j][k];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
      gemm_store<float>(a, s_crow, s_scale, tm + 16 * i, n0 + tn + 8 * j,
                        acc[i][j]);
}

template <typename T>
inline cudaError_t launch_gemm(const GemmArgs& a, cudaStream_t st) {
  const int ncols = a.N;
  if constexpr (std::is_same<T, float>::value) {
    const dim3 grid((unsigned)((a.M + FMA_BM - 1) / FMA_BM),
                    (unsigned)((ncols + FMA_BN - 1) / FMA_BN));
    gemm_fma_kernel<<<grid, FMA_NT, 0, st>>>(a);
    return cudaSuccess;
  } else {
    auto run = [&](auto kernel, int bn, size_t smem) {
      cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return err;
      const dim3 grid((unsigned)((a.M + MMA_BM - 1) / MMA_BM),
                      (unsigned)((ncols + bn - 1) / bn));
      kernel<<<grid, bn * 2, smem, st>>>(a);
      return cudaSuccess;
    };
    if (ncols <= 64) return run(gemm_mma_kernel<64>, 64, mma_smem_bytes<64>());
    return run(gemm_mma_kernel<128>, 128, mma_smem_bytes<128>());
  }
}

}  // namespace fairm
