// Shared pieces of the LeWin-block kernels (K1-K5): the row prep pass and
// the tiled GEMM. Each piece is a __device__ function over one unit of work
// (a row, an output tile) for a block of 128 threads (256 for the 128-wide
// bf16 tile); the __global__ kernels of K1-K3 call it with their block
// index, the persistent kernels of K4/K5 (merged.cuh) loop over the units.
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
// the output type (or, with c_f32, stored in fp32: the LeFF's hidden after
// fc1, which JAX keeps in fp32 through the depthwise conv); the C rows are
// scattered through cmap (the window reverse). bf16, wide products (gemm_wgmma_ok): TMA and wgmma
// (gemm_wgmma.cuh); other bf16 products: a 3-stage cp.async pipeline into
// padded shared-memory tiles, ldmatrix fragments and mma.sync m16n8k16 with
// fp32 accumulation, warps of 64 x 32, the epilogue staged through shared
// memory so that C is written in whole rows. fp32: shared-memory tiled FMA
// in full fp32 (no TF32).

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

// tanh-approximate GELU, as jax.nn.gelu(approximate=True):
// 0.5 x (1 + tanh(u)) = x / (1 + exp(-2u)), u = sqrt(2/pi) (x + 0.044715 x^3),
// through the fast exponential and division (a few ulps; tanhf costs several
// times the instructions, and the hidden tensor takes two GELUs per element)
__device__ __forceinline__ float gelu_tanh(float x) {
  const float k = 0.7978845608028654f;  // sqrt(2 / pi)
  const float u = k * (x + 0.044715f * x * x * x);
  // exp(80) is finite and large enough for the quotient to vanish
  return __fdividef(x, 1.f + __expf(fminf(-2.f * u, 80.f)));
}

constexpr int GBK = 32;
__host__ __device__ inline int kpad(int k) { return (k + GBK - 1) / GBK * GBK; }

// Logical row -> physical row of a [images * H * W, C] pixel tensor.
//  mode 0: identity.
//  mode 1: window-major. Row r = (b * nW + window) * n + token of a
//          [B, H, W] image batch cut into win x win windows.
//  mode 2: band-grouped windows. Row r = (b * nW + window) * L*n + l * n +
//          token, where the pixel lives in image l * B + b of a band-major
//          [L * B, H, W] batch (the frequency-MSA inter regroup).
//  shift (modes 1, 2): the logical image is the physical one rolled by
//          -shift along H and W (the SW-MSA cyclic shift): logical pixel
//          (y, x) lives at physical ((y + shift) % H, (x + shift) % W).
struct RowMap {
  int mode;
  int H, W, win, B, L;
  int shift;
};

__host__ __device__ inline RowMap identity_map() {
  return RowMap{0, 1, 1, 1, 1, 1, 0};
}

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
  int y = (wi / nWc) * m.win + t / m.win;
  int x = (wi % nWc) * m.win + t % m.win;
  if (m.shift) {
    y += m.shift;
    if (y >= m.H) y -= m.H;
    x += m.shift;
    if (x >= m.W) x -= m.W;
  }
  return (img * m.H + y) * m.W + x;
}

// ---------------------------------------------------------------------------
// prep: gather (+ LayerNorm) + zero pad
// ---------------------------------------------------------------------------

// one warp: row r of the logical matrix, an element at a time (any K)
template <typename T>
__device__ __forceinline__ void prep_row(const T* src, int K, const RowMap& amap,
                                         long long r, const float* ln_g,
                                         const float* ln_b, float eps, T* dst,
                                         int ldd) {
  const int lane = threadIdx.x & 31;
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

// Rows as 4-element vectors (8 bytes of bf16, 16 of fp32), for K % 4 == 0
// and rows of at most 1024 columns: G lanes share a row (32 / G rows per
// warp), a lane holds NV vectors of it, and a warp works on 8 / NV such row
// sets at once. The row is read once and stays in registers for both
// LayerNorm passes; a warp keeps up to 8 vector loads per lane in flight,
// which is what a block that holds few warps per SM (the persistent kernels
// of K4 / K5) needs to fill the memory pipe.
template <typename T>
struct alignas(4 * sizeof(T)) Vec4 {
  T v[4];
};

__host__ __device__ inline int prep_nv(int ldd) {
  const int oc = ldd / 4;
  return oc <= 32 ? 1 : oc <= 64 ? 2 : oc <= 128 ? 4 : 8;
}

__host__ __device__ inline int prep_group(int ldd) {
  const int nv = prep_nv(ldd);
  const int c = (ldd / 4 + nv - 1) / nv;
  int g = 8;
  while (g < c) g <<= 1;
  return g;
}

__host__ __device__ inline bool prep_vec_ok(int K) {
  return K % 4 == 0 && kpad(K) <= 1024;
}

// rows one warp handles per step of its loop
__host__ __device__ inline int prep_rows_per_step(int K) {
  if (!prep_vec_ok(K)) return 1;
  return (32 / prep_group(kpad(K))) * (8 / prep_nv(kpad(K)));
}

template <typename T, int NV>
__device__ __forceinline__ void prep_rows_vec(const T* src, int K,
                                              const RowMap& amap, long long M,
                                              const float* ln_g,
                                              const float* ln_b, float eps,
                                              T* dst, int ldd, long long warp,
                                              long long warps) {
  constexpr int U = 8 / NV;
  const int lane = threadIdx.x & 31;
  const int G = prep_group(ldd);
  const int sub = lane / G, li = lane % G, rpw = 32 / G;
  const int kc = K / 4, oc = ldd / 4;
  const long long step = (long long)rpw * U;
  for (long long base = warp * step; base < M; base += warps * step) {
    float x[U][NV][4];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long r = base + u * rpw + sub;
      const T* row = src + (r < M ? map_row(amap, r) : 0) * K;
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        const int c = li + v * G;
        if (r < M && c < kc) {
          const Vec4<T> e = reinterpret_cast<const Vec4<T>*>(row)[c];
#pragma unroll
          for (int i = 0; i < 4; ++i) x[u][v][i] = to_f(e.v[i]);
        } else {
#pragma unroll
          for (int i = 0; i < 4; ++i) x[u][v][i] = 0.f;
        }
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long r = base + u * rpw + sub;
      float mu = 0.f, rs = 1.f;
      if (ln_g) {
        float s = 0.f;
#pragma unroll
        for (int v = 0; v < NV; ++v)
#pragma unroll
          for (int i = 0; i < 4; ++i) s += x[u][v][i];  // pad entries are 0
        for (int o = G >> 1; o > 0; o >>= 1)
          s += __shfl_xor_sync(0xffffffffu, s, o);
        mu = s / K;
        float var = 0.f;
#pragma unroll
        for (int v = 0; v < NV; ++v)
          if (li + v * G < kc) {
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const float dv = x[u][v][i] - mu;
              var += dv * dv;
            }
          }
        for (int o = G >> 1; o > 0; o >>= 1)
          var += __shfl_xor_sync(0xffffffffu, var, o);
        rs = rsqrtf(var / K + eps);
      }
      if (r >= M) continue;
      T* out = dst + r * ldd;
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        const int c = li + v * G;
        if (c >= oc) continue;
        Vec4<T> e;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float val = 0.f;
          if (c < kc) {
            val = x[u][v][i];
            if (ln_g) val = (val - mu) * rs * ln_g[c * 4 + i] + ln_b[c * 4 + i];
          }
          e.v[i] = from_f<T>(val);
        }
        reinterpret_cast<Vec4<T>*>(out)[c] = e;
      }
    }
  }
}

// rows warp, warp + warps, ... (in steps of prep_rows_per_step rows) of the
// logical matrix; every lane of the warp calls it
template <typename T>
__device__ __noinline__ void prep_rows(const T* src, int K, RowMap amap,
                                       long long M, const float* ln_g,
                                       const float* ln_b, float eps, T* dst,
                                       int ldd, long long warp,
                                       long long warps) {
  const bool vec =
      prep_vec_ok(K) && ldd == kpad(K) &&
      (reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(dst)) %
              (4 * sizeof(T)) == 0;
  if (!vec) {
    for (long long r = warp; r < M; r += warps)
      prep_row<T>(src, K, amap, r, ln_g, ln_b, eps, dst, ldd);
    return;
  }
  switch (prep_nv(ldd)) {
    case 1: prep_rows_vec<T, 1>(src, K, amap, M, ln_g, ln_b, eps, dst, ldd, warp, warps); break;
    case 2: prep_rows_vec<T, 2>(src, K, amap, M, ln_g, ln_b, eps, dst, ldd, warp, warps); break;
    case 4: prep_rows_vec<T, 4>(src, K, amap, M, ln_g, ln_b, eps, dst, ldd, warp, warps); break;
    default: prep_rows_vec<T, 8>(src, K, amap, M, ln_g, ln_b, eps, dst, ldd, warp, warps);
  }
}

template <typename T>
__global__ void prep_rows_kernel(const T* src, int K, RowMap amap, long long M,
                                 const float* ln_g, const float* ln_b,
                                 float eps, T* dst, int ldd) {
  const int wpb = blockDim.x / 32;
  prep_rows<T>(src, K, amap, M, ln_g, ln_b, eps, dst, ldd,
               (long long)blockIdx.x * wpb + (threadIdx.x >> 5),
               (long long)gridDim.x * wpb);
}

template <typename T>
inline void launch_prep(const void* src, int K, RowMap amap, long long M,
                        const float* ln_g, const float* ln_b, float eps,
                        void* dst, cudaStream_t st) {
  const long long rows_per_block = 8LL * prep_rows_per_step(K);  // 8 warps
  const long long blocks = (M + rows_per_block - 1) / rows_per_block;
  prep_rows_kernel<T><<<(unsigned)blocks, 256, 0, st>>>(
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
  int ktiles;          // GBK-wide k-tiles to contract from A, Wt (0: lda / GBK)
  int c_f32;           // 1: C is fp32 whatever the operands' type (no res)
};

// one element of C at physical row pc
template <typename T>
__device__ __forceinline__ void gemm_store_at(const GemmArgs& a, long long pc,
                                              float scale, int col, float v) {
  if (a.bias) v += a.bias[col];
  if (a.act) v = gelu_tanh(v);
  if (a.dps) v *= scale;
  const long long off = pc * a.N + col;
  if (a.res) v += to_f(static_cast<const T*>(a.res)[off]);
  static_cast<T*>(a.C)[off] = from_f<T>(v);
}

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

// four adjacent columns (col % 4 == 0) of physical row pc; ``vec``: N % 4 ==
// 0 and C, res aligned to four elements, so the four move as one access
template <typename T>
__device__ __forceinline__ void gemm_store4(const GemmArgs& a, long long pc,
                                            float scale, int col,
                                            const float4& acc, bool vec) {
  float x[4] = {acc.x, acc.y, acc.z, acc.w};
  if (!vec) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (col + i < a.N) gemm_store_at<T>(a, pc, scale, col + i, x[i]);
    return;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (a.bias) x[i] += a.bias[col + i];
    if (a.act) x[i] = gelu_tanh(x[i]);
    if (a.dps) x[i] *= scale;
  }
  const long long off = pc * a.N + col;
  if (a.res) {
    const Vec4<T> r =
        *reinterpret_cast<const Vec4<T>*>(static_cast<const T*>(a.res) + off);
#pragma unroll
    for (int i = 0; i < 4; ++i) x[i] += to_f(r.v[i]);
  }
  Vec4<T> o;
#pragma unroll
  for (int i = 0; i < 4; ++i) o.v[i] = from_f<T>(x[i]);
  *reinterpret_cast<Vec4<T>*>(static_cast<T*>(a.C) + off) = o;
}

// C's four-column stores may be one access: N % 4 == 0, C and res aligned
template <typename TC>
__device__ __forceinline__ bool gemm_vec(const GemmArgs& a) {
  return a.N % 4 == 0 &&
         (reinterpret_cast<uintptr_t>(a.C) | reinterpret_cast<uintptr_t>(a.res)) %
                 (4 * sizeof(TC)) == 0;
}

// four adjacent columns of C in C's type: TC, or fp32 where a.c_f32
template <typename TC>
__device__ __forceinline__ void gemm_store4_any(const GemmArgs& a, long long pc,
                                                float scale, int col,
                                                const float4& acc, bool vec,
                                                bool vec32) {
  if (a.c_f32)
    gemm_store4<float>(a, pc, scale, col, acc, vec32);
  else
    gemm_store4<TC>(a, pc, scale, col, acc, vec);
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

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
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

// the operand stages, then the tile's C rows and DropPath scales
template <int BN>
constexpr size_t mma_smem_bytes() {
  return sizeof(bf16_t) * MMA_STAGES * (MMA_BM + BN) * MMA_LDS +
         MMA_BM * (sizeof(long long) + sizeof(float));
}

// output tile (bx, by) of BM = 128 rows x BN columns; BN = 64 (4 warps) or
// 128 (8 warps), each warp owns 64 x 32; C of type TC. Ends with a barrier,
// so the next tile may reuse the shared memory.
template <int BN, typename TC = bf16_t>
__device__ __forceinline__ void gemm_mma_tile(const GemmArgs& a, long long bx,
                                              int by, unsigned char* smem_raw) {
  constexpr int NT = BN * 2;
  constexpr int WARPS_N = BN / 32;
  bf16_t* As = reinterpret_cast<bf16_t*>(smem_raw);
  bf16_t* Bs = As + MMA_STAGES * MMA_BM * MMA_LDS;
  long long* s_crow = reinterpret_cast<long long*>(Bs + MMA_STAGES * BN * MMA_LDS);
  float* s_scale = reinterpret_cast<float*>(s_crow + MMA_BM);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long long m0 = bx * MMA_BM;
  const int n0 = by * BN;
  const bf16_t* A = static_cast<const bf16_t*>(a.A);
  const bf16_t* Wt = static_cast<const bf16_t*>(a.Wt);
  const int KT = a.ktiles ? a.ktiles : a.lda / GBK;

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

  // Epilogue through shared memory: the accumulators of RP rows go to a
  // fp32 tile over the operand stages, then every thread writes four
  // adjacent columns of a row, so a warp's stores cover whole rows of the
  // tile instead of 8-byte pieces of 8 rows.
  constexpr int RP = BN == 64 ? MMA_BM : MMA_BM / 2;  // rows per pass
  constexpr int LDC = BN + 8;  // conflict-free float2 writes
  static_assert(sizeof(float) * RP * LDC <=
                    sizeof(bf16_t) * MMA_STAGES * (MMA_BM + BN) * MMA_LDS,
                "the C tile must fit the operand stages");
  float* Cs = reinterpret_cast<float*>(smem_raw);
  const bool vec = gemm_vec<TC>(a), vec32 = gemm_vec<float>(a);
  const int g = lane >> 2, t4 = lane & 3;
  const int rbase = (wm * 64) % RP;
#pragma unroll
  for (int pass = 0; pass < MMA_BM / RP; ++pass) {
    __syncthreads();  // the stages (or the last pass's tile) are read out
    if (RP == MMA_BM || wm == pass) {
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
#pragma unroll
          for (int e = 0; e < 4; e += 2)
            *reinterpret_cast<float2*>(
                Cs + (rbase + mi * 16 + g + (e >= 2 ? 8 : 0)) * LDC + wn * 32 +
                ni * 8 + t4 * 2) = make_float2(acc[mi][ni][e], acc[mi][ni][e + 1]);
    }
    __syncthreads();
    for (int idx = tid; idx < RP * (BN / 4); idx += NT) {
      const int lr = idx / (BN / 4), cv = idx % (BN / 4);
      const int row = pass * RP + lr, col = n0 + cv * 4;
      const long long pc = s_crow[row];
      if (pc < 0 || col >= a.N) continue;
      gemm_store4_any<TC>(
          a, pc, s_scale[row], col,
          *reinterpret_cast<const float4*>(Cs + lr * LDC + cv * 4), vec, vec32);
    }
  }
  __syncthreads();
}

template <int BN>
__global__ void __launch_bounds__(BN * 2) gemm_mma_kernel(const GemmArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  gemm_mma_tile<BN>(a, blockIdx.x, blockIdx.y, smem_raw);
}

// ---- fp32: shared-memory tiled FMA -----------------------------------------

constexpr int FMA_BM = 128, FMA_BN = 64, FMA_NT = 128;

constexpr int FMA_LDS = GBK + 1;
constexpr size_t FMA_SMEM = sizeof(float) * (FMA_BM + FMA_BN) * FMA_LDS +
                            FMA_BM * (sizeof(long long) + sizeof(float));

// output tile (bx, by) of 128 x 64, 128 threads; ends with a barrier
__device__ __forceinline__ void gemm_fma_tile(const GemmArgs& a, long long bx,
                                              int by, unsigned char* smem_raw) {
  long long* s_crow = reinterpret_cast<long long*>(smem_raw);
  float* s_scale = reinterpret_cast<float*>(s_crow + FMA_BM);
  float(*As)[FMA_LDS] = reinterpret_cast<float(*)[FMA_LDS]>(s_scale + FMA_BM);
  float(*Ws)[FMA_LDS] = As + FMA_BM;

  const int tid = threadIdx.x;
  const long long m0 = bx * FMA_BM;
  const int n0 = by * FMA_BN;
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

  const int kend = a.ktiles ? a.ktiles * GBK : a.lda;
  for (int k0 = 0; k0 < kend; k0 += GBK) {
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
  __syncthreads();
}

static __global__ void __launch_bounds__(FMA_NT) gemm_fma_kernel(const GemmArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  gemm_fma_tile(a, blockIdx.x, blockIdx.y, smem_raw);
}

}  // namespace fairm

#include "gemm_wgmma.cuh"

namespace fairm {

template <typename T>
inline cudaError_t launch_gemm(const GemmArgs& a, cudaStream_t st) {
  const int ncols = a.N;
  if constexpr (std::is_same<T, float>::value) {
    const dim3 grid((unsigned)((a.M + FMA_BM - 1) / FMA_BM),
                    (unsigned)((ncols + FMA_BN - 1) / FMA_BN));
    gemm_fma_kernel<<<grid, FMA_NT, FMA_SMEM, st>>>(a);
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
    if (gemm_wgmma_ok(a)) return launch_gemm_wgmma(a, st);
    if (ncols <= 64) return run(gemm_mma_kernel<64>, 64, mma_smem_bytes<64>());
    return run(gemm_mma_kernel<128>, 128, mma_smem_bytes<128>());
  }
}

}  // namespace fairm
