// Shared pieces of the backward kernels (K6-K8, K14): a workspace
// carver, a strided GEMM with fp32 output, the fixed-order reductions that
// take the place of the TPU's sequential accumulation, and the LayerNorm
// backward pass.
//
// The Pallas backward bodies accumulate every weight gradient into a
// VMEM-resident block across a sequential grid. Thread blocks on the card run
// together, so a sum over the M = images * H * W rows is done in two steps
// here: the rows are cut into chunks, every chunk writes its partial sum to
// scratch, and reduce_kernel adds the partials in ascending order. No float
// atomics: two runs give equal bits.
//
// bgemm: C[z][m, n] = epilogue(sum_k A(m, k) B(k, n)) over k in chunk z, with
// A and B addressed by element strides, so that A^T B (the weight gradients,
// k = rows), A W^T and A W all go through one kernel. Operands are stored in
// the compute type T, or in fp32 and rounded to T on load (the Pallas bodies
// cast to the compute dtype before each product); products accumulate in
// fp32 and the output is fp32. fp32 runs on the CUDA cores in full precision
// (no TF32); bf16 runs on the tensor cores (wmma m16n16k16, operands staged
// in shared memory as bf16, which they already are in value).

#pragma once

#include <mma.h>

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

// ---------------------------------------------------------------------------
// bgemm
// ---------------------------------------------------------------------------

struct BGemmArgs {
  const void* A;
  const void* B;
  float* C;             // [chunks, M, N]
  long long sam, sak;   // A(m, k) = A[m * sam + k * sak]
  long long sbk, sbn;   // B(k, n) = B[k * sbk + n * sbn]
  int a_f32, b_f32;     // stored in fp32 (rounded to T on load), else in T
  long long M;
  int N;
  long long K;
  long long kc;         // k per chunk (blockIdx.z); K for one chunk
  const float* bias;    // + bias[n], or null
  const float* aux;     // x gelu'(aux[m, n]), aux in C's layout, or null
};

constexpr int BG_BM = 64, BG_BN = 64, BG_BK = 16, BG_NT = 256;

template <typename T>
__device__ __forceinline__ float bg_load(const void* p, long long idx, int is_f32) {
  if (is_f32) return rt<T>(static_cast<const float*>(p)[idx]);
  return to_f(static_cast<const T*>(p)[idx]);
}

template <typename T>
__global__ void __launch_bounds__(BG_NT) bgemm_kernel(const BGemmArgs a) {
  __shared__ float As[BG_BK][BG_BM + 1];
  __shared__ float Bs[BG_BK][BG_BN + 1];
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const long long m0 = (long long)blockIdx.x * BG_BM;
  const int n0 = blockIdx.y * BG_BN;
  const long long k_lo = (long long)blockIdx.z * a.kc;
  long long k_hi = k_lo + a.kc;
  if (k_hi > a.K) k_hi = a.K;

  // thread (ty, tx) owns rows ty + 16 i and columns tx + 16 j
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (long long k0 = k_lo; k0 < k_hi; k0 += BG_BK) {
    // neighbouring threads walk the operand's contiguous axis
    for (int e = tid; e < BG_BM * BG_BK; e += BG_NT) {
      int m, k;
      if (a.sak == 1) {
        m = e / BG_BK;
        k = e % BG_BK;
      } else {
        k = e / BG_BM;
        m = e % BG_BM;
      }
      const long long gm = m0 + m, gk = k0 + k;
      As[k][m] = (gm < a.M && gk < k_hi)
                     ? bg_load<T>(a.A, gm * a.sam + gk * a.sak, a.a_f32)
                     : 0.f;
    }
    for (int e = tid; e < BG_BN * BG_BK; e += BG_NT) {
      int nn, k;
      if (a.sbk == 1) {
        nn = e / BG_BK;
        k = e % BG_BK;
      } else {
        k = e / BG_BN;
        nn = e % BG_BN;
      }
      const long long gn = n0 + nn, gk = k0 + k;
      Bs[k][nn] = (gn < a.N && gk < k_hi)
                      ? bg_load<T>(a.B, gk * a.sbk + gn * a.sbn, a.b_f32)
                      : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < BG_BK; ++k) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = As[k][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = Bs[k][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

  float* C = a.C + (long long)blockIdx.z * a.M * a.N;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long gm = m0 + ty + 16 * i;
    if (gm >= a.M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + tx + 16 * j;
      if (gn >= a.N) continue;
      float v = acc[i][j];
      if (a.bias) v += a.bias[gn];
      if (a.aux) v *= gelu_tanh_grad(a.aux[gm * a.N + gn]);
      C[gm * a.N + gn] = v;
    }
  }
}

// The bf16 form of bgemm_kernel: the same tiles of 64 x 64 and the same
// strided loads, 32 of k per step; 8 warps in 4 x 2, each 16 x 32 of C as two
// wmma accumulators; C goes through shared memory to the same epilogue.
constexpr int BW_BK = 32, BW_LDA = BW_BK + 8, BW_LDB = BG_BN + 8,
              BW_LDC = BG_BN + 4;

static __global__ void __launch_bounds__(BG_NT) bgemm_wmma_kernel(const BGemmArgs a) {
  namespace wmma = nvcuda::wmma;
  __shared__ __align__(32) bf16_t As[BG_BM * BW_LDA];  // [m][k]
  __shared__ __align__(32) bf16_t Bs[BW_BK * BW_LDB];  // [k][n]
  __shared__ __align__(32) float Cs[BG_BM * BW_LDC];
  const int tid = threadIdx.x, warp = tid >> 5;
  const int wm = warp >> 1, wn = warp & 1;
  const long long m0 = (long long)blockIdx.x * BG_BM;
  const int n0 = blockIdx.y * BG_BN;
  const long long k_lo = (long long)blockIdx.z * a.kc;
  long long k_hi = k_lo + a.kc;
  if (k_hi > a.K) k_hi = a.K;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2];
  wmma::fill_fragment(acc[0], 0.f);
  wmma::fill_fragment(acc[1], 0.f);

  for (long long k0 = k_lo; k0 < k_hi; k0 += BW_BK) {
    for (int e = tid; e < BG_BM * BW_BK; e += BG_NT) {
      int m, k;
      if (a.sak == 1) {
        m = e / BW_BK;
        k = e % BW_BK;
      } else {
        k = e / BG_BM;
        m = e % BG_BM;
      }
      const long long gm = m0 + m, gk = k0 + k;
      As[m * BW_LDA + k] = from_f<bf16_t>(
          (gm < a.M && gk < k_hi)
              ? bg_load<bf16_t>(a.A, gm * a.sam + gk * a.sak, a.a_f32)
              : 0.f);
    }
    for (int e = tid; e < BG_BN * BW_BK; e += BG_NT) {
      int nn, k;
      if (a.sbk == 1) {
        nn = e / BW_BK;
        k = e % BW_BK;
      } else {
        k = e / BG_BN;
        nn = e % BG_BN;
      }
      const long long gn = n0 + nn, gk = k0 + k;
      Bs[k * BW_LDB + nn] = from_f<bf16_t>(
          (gn < a.N && gk < k_hi)
              ? bg_load<bf16_t>(a.B, gk * a.sbk + gn * a.sbn, a.b_f32)
              : 0.f);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BW_BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16_t, wmma::row_major> fa;
      wmma::load_matrix_sync(fa, As + wm * 16 * BW_LDA + kk, BW_LDA);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16_t, wmma::row_major> fb;
        wmma::load_matrix_sync(fb, Bs + kk * BW_LDB + wn * 32 + j * 16, BW_LDB);
        wmma::mma_sync(acc[j], fa, fb, acc[j]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int j = 0; j < 2; ++j)
    wmma::store_matrix_sync(Cs + wm * 16 * BW_LDC + wn * 32 + j * 16, acc[j],
                            BW_LDC, wmma::mem_row_major);
  __syncthreads();

  float* C = a.C + (long long)blockIdx.z * a.M * a.N;
  for (int e = tid; e < BG_BM * BG_BN; e += BG_NT) {
    const int m = e / BG_BN, nn = e % BG_BN;
    const long long gm = m0 + m;
    const int gn = n0 + nn;
    if (gm >= a.M || gn >= a.N) continue;
    float v = Cs[m * BW_LDC + nn];
    if (a.bias) v += a.bias[gn];
    if (a.aux) v *= gelu_tanh_grad(a.aux[gm * a.N + gn]);
    C[gm * a.N + gn] = v;
  }
}

// the grid's z is the chunk of k; the kernel by the compute type
template <typename T>
inline void launch_bgemm_chunks(const BGemmArgs& a, long long chunks,
                                cudaStream_t st) {
  const dim3 grid((unsigned)((a.M + BG_BM - 1) / BG_BM),
                  (unsigned)((a.N + BG_BN - 1) / BG_BN), (unsigned)chunks);
  if constexpr (std::is_same<T, bf16_t>::value)
    bgemm_wmma_kernel<<<grid, BG_NT, 0, st>>>(a);
  else
    bgemm_kernel<T><<<grid, BG_NT, 0, st>>>(a);
}

// one chunk: C [M, N] = A B over all of K
template <typename T>
inline void launch_bgemm(BGemmArgs a, cudaStream_t st) {
  a.kc = a.K;
  launch_bgemm_chunks<T>(a, 1, st);
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

// dW [Mw, N] = A^T B, a sum over ``rows``: A(i, r) = A[r * lda + i],
// B(r, j) = B[r * ldb + j]; chunk partials in ``part``, then the reduction
template <typename T>
inline void weight_grad(const void* A, long long lda, int a_f32, const void* B,
                        long long ldb, int b_f32, long long rows, int Mw, int N,
                        float* part, float* out, cudaStream_t st) {
  BGemmArgs a{};
  a.A = A;
  a.B = B;
  a.C = part;
  a.sam = 1;
  a.sak = lda;
  a.sbk = ldb;
  a.sbn = 1;
  a.a_f32 = a_f32;
  a.b_f32 = b_f32;
  a.M = Mw;
  a.N = N;
  a.K = rows;
  a.kc = chunk_rows(rows);
  const long long S = chunk_count(rows);
  launch_bgemm_chunks<T>(a, S, st);
  launch_reduce(part, out, 1, S, (long long)Mw * N, st);
}

// part[z, n] = sum of X[m, n] over the rows of chunk z
template <typename T>
__global__ void colsum_kernel(const void* X, int x_f32, long long ld,
                              long long M, int N, long long rc, float* part) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const long long lo = (long long)blockIdx.y * rc;
  long long hi = lo + rc;
  if (hi > M) hi = M;
  float acc = 0.f;
  if (x_f32) {
    const float* x = static_cast<const float*>(X);
    for (long long m = lo; m < hi; ++m) acc += x[m * ld + n];
  } else {
    const T* x = static_cast<const T*>(X);
    for (long long m = lo; m < hi; ++m) acc += to_f(x[m * ld + n]);
  }
  part[(long long)blockIdx.y * N + n] = acc;
}

// out[n] = sum_m X[m, n]
template <typename T>
inline void column_sums(const void* X, int x_f32, long long ld, long long M,
                        int N, float* part, float* out, cudaStream_t st) {
  const long long rc = chunk_rows(M), S = chunk_count(M);
  const dim3 grid((unsigned)((N + 127) / 128), (unsigned)S);
  colsum_kernel<T><<<grid, 128, 0, st>>>(X, x_f32, ld, M, N, rc, part);
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

// dx and dln [2, C] = (sum dxn xhat, sum dxn)
template <typename T>
inline cudaError_t launch_ln_bwd(const void* x, const void* gin,
                                 const float* dxw, const float* lns, RowMap map,
                                 long long M, int C, float eps, int res,
                                 void* dx, float* part, float* dln,
                                 cudaStream_t st) {
  const size_t smem = sizeof(float) * (LNB_NT / 32) * 2 * (size_t)C;
  cudaError_t err = cudaFuncSetAttribute(
      ln_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const long long rpb = ln_bwd_rows(M), blocks = ln_bwd_blocks(M);
  ln_bwd_kernel<T><<<(unsigned)blocks, LNB_NT, smem, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(gin), dxw, lns, map, M, C,
      eps, res, rpb, static_cast<T*>(dx), part);
  launch_reduce(part, dln, 1, blocks, 2LL * C, st);
  return cudaSuccess;
}

}  // namespace fairm
