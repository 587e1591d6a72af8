// Shared pieces of the backward kernels (K6-K8, K14): a workspace
// carver, the fixed-order reductions that take the place of the TPU's
// sequential accumulation, column sums and the LayerNorm backward pass (the
// products run on bwd_gemm.cuh).
//
// The Pallas backward bodies accumulate every weight gradient into a
// VMEM-resident block across a sequential grid. Thread blocks on the card run
// together, so a sum over the M = images * H * W rows is done in two steps
// here: the rows are cut into chunks, every chunk writes its partial sum to
// scratch, and reduce_kernel adds the partials in ascending order. No float
// atomics: two runs give equal bits.

#pragma once

#include "gemm.cuh"

namespace fairm {

// a value rounded to the compute type, as a float
template <typename T>
__device__ __forceinline__ float rt(float v) {
  return to_f(from_f<T>(v));
}

// d/dx of gelu_tanh, through the same fast exponential: with
// s = 1 / (1 + exp(-2u)), gelu = x s and gelu' = s + 2 x s (1 - s) u'
__device__ __forceinline__ float gelu_tanh_grad(float x) {
  const float k = 0.7978845608028654f;  // sqrt(2 / pi)
  const float u = k * (x + 0.044715f * x * x * x);
  const float s = __fdividef(1.f, 1.f + __expf(fminf(-2.f * u, 80.f)));
  const float du = k * (1.f + 3.f * 0.044715f * x * x);
  return s + 2.f * x * s * (1.f - s) * du;
}

// Bump allocator over one device buffer. With a null base it only counts,
// which is how the *_ws entry points size the buffer the caller allocates.
struct Workspace {
  unsigned char* base;
  size_t off;
  template <typename U>
  U* take(long long n) {
    off = (off + 255) / 256 * 256;
    U* p = base ? reinterpret_cast<U*>(base + off) : nullptr;
    off += sizeof(U) * (size_t)n;
    return p;
  }
};

// rows of M per chunk of a sum over rows: at most 128 chunks, at least 512
// rows each, a multiple of 32 (a whole number of the kernels' k steps)
__host__ __device__ inline long long chunk_rows(long long M) {
  long long s = (M + 511) / 512;
  if (s < 1) s = 1;
  if (s > 128) s = 128;
  const long long rc = (M + s - 1) / s;
  return (rc + 31) / 32 * 32;
}

__host__ __device__ inline long long chunk_count(long long M) {
  const long long rc = chunk_rows(M);
  return (M + rc - 1) / rc;
}

// out[b, n] = sum_s in[b, s, n], s ascending
static __global__ void reduce_kernel(const float* in, float* out, long long S,
                                     long long N, long long total) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const long long b = idx / N, n = idx - b * N;
  const float* p = in + b * S * N + n;
  float acc = 0.f;
  for (long long s = 0; s < S; ++s) acc += p[s * N];
  out[idx] = acc;
}

inline void launch_reduce(const float* in, float* out, long long batches,
                          long long S, long long N, cudaStream_t st) {
  const long long total = batches * N;
  reduce_kernel<<<(unsigned)((total + 255) / 256), 256, 0, st>>>(in, out, S, N,
                                                                  total);
}

// part[z, n] = sum of X[m, n] over the rows of chunk z: a block takes 32
// columns of a chunk, its eight warps eight row lanes (a warp reads 32
// adjacent columns of a row, and many rows are in flight), the lanes' sums
// added in lane order
constexpr int CS_NT = 256;

template <typename T>
__global__ void __launch_bounds__(CS_NT) colsum_kernel(const void* X, int x_f32,
                                                       long long ld, long long M,
                                                       int N, long long rc,
                                                       float* part) {
  __shared__ float red[CS_NT / 32][32];
  const int c = threadIdx.x & 31, lr = threadIdx.x >> 5;
  const int n = blockIdx.x * 32 + c;
  const long long lo = (long long)blockIdx.y * rc;
  const long long hi = lo + rc < M ? lo + rc : M;
  float acc = 0.f;
  if (n < N) {
    if (x_f32) {
      const float* x = static_cast<const float*>(X);
#pragma unroll 4
      for (long long m = lo + lr; m < hi; m += CS_NT / 32) acc += x[m * ld + n];
    } else {
      const T* x = static_cast<const T*>(X);
#pragma unroll 4
      for (long long m = lo + lr; m < hi; m += CS_NT / 32) acc += to_f(x[m * ld + n]);
    }
  }
  red[lr][c] = acc;
  __syncthreads();
  if (lr == 0 && n < N) {
    float v = 0.f;
#pragma unroll
    for (int l = 0; l < CS_NT / 32; ++l) v += red[l][c];
    part[(long long)blockIdx.y * N + n] = v;
  }
}

// out[n] = sum_m X[m, n]
template <typename T>
inline void column_sums(const void* X, int x_f32, long long ld, long long M,
                        int N, float* part, float* out, cudaStream_t st) {
  const long long rc = chunk_rows(M), S = chunk_count(M);
  const dim3 grid((unsigned)((N + 31) / 32), (unsigned)S);
  colsum_kernel<T><<<grid, CS_NT, 0, st>>>(X, x_f32, ld, M, N, rc, part);
  launch_reduce(part, out, 1, S, N, st);
}

// ---------------------------------------------------------------------------
// LayerNorm backward (+ scatter through a row map, + the residual's gradient)
// ---------------------------------------------------------------------------

constexpr int LNB_NT = 128;

// rows per block of the LayerNorm backward: at most 1024 blocks, at least 8
// rows (two a warp), so that a few rows of C = 896 still fill the card
__host__ __device__ inline long long ln_bwd_rows(long long M) {
  long long r = (M + 1023) / 1024;
  return r < 8 ? 8 : r;
}

__host__ __device__ inline long long ln_bwd_blocks(long long M) {
  const long long r = ln_bwd_rows(M);
  return (M + r - 1) / r;
}

// Logical row r (a window token) lives at pixel pc = map(r). With
// xhat = (x - mu) rsig recomputed from x[pc] and dxn = dxw[r]:
//   dx[pc] = rsig (dxn g - mean(dxn g) - xhat mean(dxn g xhat)) [+ gin[pc]]
// and the block's partial sums of dxn xhat and dxn go to part [blocks, 2C].
template <typename T>
__global__ void __launch_bounds__(LNB_NT) ln_bwd_kernel(
    const T* x, const T* gin, const float* dxw, const float* lns, RowMap map,
    long long M, int C, float eps, int res, long long rpb, T* dx, float* part) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* acc = reinterpret_cast<float*>(smem_raw);  // [warps][2C]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* mine = acc + (long long)warp * 2 * C;
  for (int c = lane; c < 2 * C; c += 32) mine[c] = 0.f;
  const long long lo = (long long)blockIdx.x * rpb;
  long long hi = lo + rpb;
  if (hi > M) hi = M;
  for (long long r = lo + warp; r < hi; r += LNB_NT / 32) {
    const long long pc = map_row(map, r);
    const T* xr = x + pc * C;
    const float* dr = dxw + r * C;
    float s = 0.f;
    for (int c = lane; c < C; c += 32) s += to_f(xr[c]);
    const float mu = warp_sum(s) / C;
    float var = 0.f;
    for (int c = lane; c < C; c += 32) {
      const float dv = to_f(xr[c]) - mu;
      var += dv * dv;
    }
    const float rs = rsqrtf(warp_sum(var) / C + eps);
    float m1 = 0.f, m2 = 0.f;
    for (int c = lane; c < C; c += 32) {
      const float xh = (to_f(xr[c]) - mu) * rs;
      const float dn = dr[c];
      const float dh = dn * lns[c];
      m1 += dh;
      m2 += dh * xh;
      mine[c] += dn * xh;
      mine[C + c] += dn;
    }
    m1 = warp_sum(m1) / C;
    m2 = warp_sum(m2) / C;
    for (int c = lane; c < C; c += 32) {
      const float xh = (to_f(xr[c]) - mu) * rs;
      float v = rs * (dr[c] * lns[c] - m1 - xh * m2);
      if (res) v += to_f(gin[pc * C + c]);
      dx[pc * C + c] = from_f<T>(v);
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < 2 * C; c += LNB_NT) {
    float v = 0.f;
    for (int w = 0; w < LNB_NT / 32; ++w) v += acc[(long long)w * 2 * C + c];
    part[(long long)blockIdx.x * 2 * C + c] = v;
  }
}

// The same for C <= 64 (the res-128 stages): eight lanes a row, so a warp
// takes four rows at once, each lane holding channels lane, lane + 8, ... of
// x and dxn in registers (one read each); the rows of a warp's four groups
// are walked in step so that the group shuffles see every lane. Partials
// per group of eight lanes, added in group order.
constexpr int LNS_LANES = 8, LNS_CPL = 8, LNS_GROUPS = LNB_NT / LNS_LANES;

template <typename T>
__global__ void __launch_bounds__(LNB_NT) ln_bwd_small_kernel(
    const T* x, const T* gin, const float* dxw, const float* lns, RowMap map,
    long long M, int C, float eps, int res, long long rpb, T* dx, float* part) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* acc = reinterpret_cast<float*>(smem_raw);  // [groups][2C]
  const int grp = threadIdx.x / LNS_LANES, sub = threadIdx.x % LNS_LANES;
  float* mine = acc + (long long)grp * 2 * C;
  float sa[LNS_CPL], sb[LNS_CPL];
#pragma unroll
  for (int i = 0; i < LNS_CPL; ++i) sa[i] = sb[i] = 0.f;
  const long long lo = (long long)blockIdx.x * rpb;
  const long long hi = lo + rpb < M ? lo + rpb : M;
  auto gsum = [](float v) {
    v += __shfl_xor_sync(0xffffffffu, v, 1);
    v += __shfl_xor_sync(0xffffffffu, v, 2);
    return v + __shfl_xor_sync(0xffffffffu, v, 4);
  };
  for (long long base = lo; base < hi; base += LNS_GROUPS) {
    const long long r = base + grp;
    const bool ok = r < hi;
    const long long pc = ok ? map_row(map, r) : 0;
    float xv[LNS_CPL], dv[LNS_CPL], lv[LNS_CPL];
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < LNS_CPL; ++i) {
      const int c = sub + i * LNS_LANES;
      const bool in = ok && c < C;
      xv[i] = in ? to_f(x[pc * C + c]) : 0.f;
      dv[i] = in ? dxw[r * C + c] : 0.f;
      lv[i] = in ? lns[c] : 0.f;
      s += xv[i];
    }
    const float mu = gsum(s) / C;
    float var = 0.f;
#pragma unroll
    for (int i = 0; i < LNS_CPL; ++i) {
      const float d = sub + i * LNS_LANES < C ? xv[i] - mu : 0.f;
      var += d * d;
    }
    const float rs = rsqrtf(gsum(var) / C + eps);
    float m1 = 0.f, m2 = 0.f;
#pragma unroll
    for (int i = 0; i < LNS_CPL; ++i) {
      const float xh = (xv[i] - mu) * rs, dh = dv[i] * lv[i];
      m1 += dh;
      m2 += dh * xh;
      sa[i] += dv[i] * xh;  // zero where the row or channel is absent
      sb[i] += dv[i];
    }
    m1 = gsum(m1) / C;
    m2 = gsum(m2) / C;
#pragma unroll
    for (int i = 0; i < LNS_CPL; ++i) {
      const int c = sub + i * LNS_LANES;
      if (!ok || c >= C) continue;
      const float xh = (xv[i] - mu) * rs;
      float v = rs * (dv[i] * lv[i] - m1 - xh * m2);
      if (res) v += to_f(gin[pc * C + c]);
      dx[pc * C + c] = from_f<T>(v);
    }
  }
#pragma unroll
  for (int i = 0; i < LNS_CPL; ++i) {
    const int c = sub + i * LNS_LANES;
    if (c < C) {
      mine[c] = sa[i];
      mine[C + c] = sb[i];
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < 2 * C; c += LNB_NT) {
    float v = 0.f;
    for (int g = 0; g < LNS_GROUPS; ++g) v += acc[(long long)g * 2 * C + c];
    part[(long long)blockIdx.x * 2 * C + c] = v;
  }
}

// dx and dln [2, C] = (sum dxn xhat, sum dxn)
template <typename T>
inline cudaError_t launch_ln_bwd(const void* x, const void* gin,
                                 const float* dxw, const float* lns, RowMap map,
                                 long long M, int C, float eps, int res,
                                 void* dx, float* part, float* dln,
                                 cudaStream_t st) {
  const bool small = C <= LNS_LANES * LNS_CPL;
  const auto kernel = small ? ln_bwd_small_kernel<T> : ln_bwd_kernel<T>;
  const size_t smem =
      sizeof(float) * (small ? LNS_GROUPS : LNB_NT / 32) * 2 * (size_t)C;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const long long rpb = ln_bwd_rows(M), blocks = ln_bwd_blocks(M);
  kernel<<<(unsigned)blocks, LNB_NT, smem, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(gin), dxw, lns, map, M, C,
      eps, res, rpb, static_cast<T*>(dx), part);
  launch_reduce(part, dln, 1, blocks, 2LL * C, st);
  return cudaSuccess;
}

}  // namespace fairm
