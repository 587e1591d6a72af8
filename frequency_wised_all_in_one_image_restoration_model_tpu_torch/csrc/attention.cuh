// Window attention core shared by K1 (lewin_attn.cu), K3 (freq_inter.cu) and
// the merged blocks K4 / K5 (merged.cuh).
//
// One unit of work per (window group, head), done by a block of 128 threads
// (a __device__ function: the kernels of K1 / K3 call it with their block
// index, the persistent kernels of K4 / K5 loop over the units), over the
// group's n tokens (from the qkv GEMM's output rows; the d^-0.5 scale is
// already in q): fp32 logits with
// the additive bias [h, n, n] and mask [n0, n0] (tiled over n / n0),
// per-row-max softmax, P.V, and the normalisation after P.V. The optional
// all_DC rank-1 term (1 + lam) o - (lam / n) sum_m v[m] uses lam[b, h].
// The logits never leave the SM.
//
// Two cores, chosen by what the launch can observe:
// - attn_mma_kernel, bf16 with n = 64 or 192 and d <= 64 (every window of
//   the flagship): both products on the tensor cores (mma.sync), the head
//   dims 28 and 56 zero-padded to 32 and 64 in shared memory;
// - attn_kernel, fp32 (full precision, no TF32) and any other shape: CUDA
//   cores over the true d, q/k/v in shared memory in fp32.

#pragma once

#include <math.h>

#include "gemm.cuh"

namespace fairm {

struct AttnArgs {
  const void* qkv;    // [groups * n, 3C]: q | k | v, head-major columns
  void* out;          // [groups * n, ldo], ldo = kpad(C); pad columns zero
  const float* bias;  // [bias groups, h, n, n]
  const float* mask;  // [nW, n0, n0] additive, or null
  const float* lam;   // [B, h] all_DC gain, or null
  int n, n0, d, C, h, ldo;
  int nW;             // windows per image: group g is window g % nW of image g / nW
  int imgs_per_bias;  // image b uses bias group b / imgs_per_bias
};

constexpr int ANT = 128;

inline size_t attn_smem_bytes(int n, int d) {
  return sizeof(float) *
         ((size_t)n * d * 2 + (size_t)n * (d + 1) + (ANT / 32) * (size_t)n + d);
}

// group g, head hh; ends with a barrier, so the next unit may reuse sm
template <typename T>
__device__ __forceinline__ void attn_tile(const AttnArgs& a, long long g,
                                          int hh, float* sm) {
  const int n = a.n, d = a.d;
  float* q = sm;
  float* k = q + n * d;        // row stride d + 1: conflict-free column walk
  float* v = k + n * (d + 1);
  float* pbuf = v + n * d;     // one row of probabilities per warp
  float* vsum = pbuf + (ANT / 32) * n;

  const T* src = static_cast<const T*>(a.qkv) + g * n * 3LL * a.C + hh * d;
  for (int e = threadIdx.x; e < n * d; e += ANT) {
    const int i = e / d, c = e - i * d;
    const T* row = src + (long long)i * 3 * a.C + c;
    q[i * d + c] = to_f(row[0]);
    k[i * (d + 1) + c] = to_f(row[a.C]);
    v[i * d + c] = to_f(row[2 * a.C]);
  }
  __syncthreads();

  const long long b = g / a.nW;
  const int wi = (int)(g - b * a.nW);
  float lam = 0.f;
  if (a.lam) {
    lam = a.lam[b * a.h + hh];
    for (int c = threadIdx.x; c < d; c += ANT) {
      float s = 0.f;
      for (int j = 0; j < n; ++j) s += v[j * d + c];
      vsum[c] = s;
    }
    __syncthreads();
  }
  const float* bias =
      a.bias + ((b / a.imgs_per_bias) * a.h + hh) * (long long)n * n;
  const float* mask = a.mask ? a.mask + (long long)wi * a.n0 * a.n0 : nullptr;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* p = pbuf + warp * n;
  T* out = static_cast<T*>(a.out) + g * (long long)n * a.ldo + hh * d;
  for (int i = warp; i < n; i += ANT / 32) {
    const float* qi = q + i * d;
    float mx = -INFINITY;
    for (int j = lane; j < n; j += 32) {
      const float* kj = k + j * (d + 1);
      float s = 0.f;
      for (int c = 0; c < d; ++c) s = fmaf(qi[c], kj[c], s);
      s += bias[i * n + j];
      if (mask) s += mask[(i % a.n0) * a.n0 + (j % a.n0)];
      p[j] = s;
      mx = fmaxf(mx, s);
    }
    mx = warp_max(mx);
    float sum = 0.f;
    for (int j = lane; j < n; j += 32) {
      const float e = expf(p[j] - mx);
      p[j] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    __syncwarp();
    for (int c = lane; c < d; c += 32) {
      float o = 0.f;
      for (int j = 0; j < n; ++j) o = fmaf(p[j], v[j * d + c], o);
      o /= sum;
      if (a.lam) o = (1.f + lam) * o - (lam / n) * vsum[c];
      out[(long long)i * a.ldo + c] = from_f<T>(o);
    }
    __syncwarp();
  }
  if (hh == 0) {  // the zero pad of the next GEMM's A operand
    const int pad = a.ldo - a.C;
    for (int e = threadIdx.x; e < n * pad; e += ANT)
      out[(long long)(e / pad) * a.ldo + a.C + e % pad] = from_f<T>(0.f);
  }
  __syncthreads();
}

template <typename T>
__global__ void __launch_bounds__(ANT) attn_kernel(const AttnArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  attn_tile<T>(a, blockIdx.x, blockIdx.y, reinterpret_cast<float*>(smem_raw));
}

// bf16 on the tensor cores, for windows of n = 16k tokens and d <= DP:
// one warp per 16 query rows; S = Q K^T (mma.sync, fp32 accumulators in
// registers), bias + mask, per-row-max softmax in registers, P rounded to
// bf16 as the A operand of P V (as the Pallas kernel rounds e), the
// normalisation after P V. q/k/v sit in shared memory as bf16 with the
// head dim zero-padded to DP inside the kernel.
template <int N, int DP>
constexpr size_t attn_mma_smem_bytes() {
  return sizeof(bf16_t) * 3 * N * (DP + 8) + sizeof(float) * DP;
}

// The tensor-core core for one (window group, head) whose q / k / v sit in
// shared memory as bf16 [N][LDS] (LDS = DP + 8 by default; a wider stride
// when heads sit side by side), the head dims past d zero: four warps
// (``warp`` 0-3 of them) take 16 query rows at a time; row i of the
// output goes to out[i * ldo + c] for c < d (rounded to bf16). ``vsum``
// holds sum_j v[j, c] when ``lam`` is set (the all_DC gain of this head);
// bias [N, N], mask [n0, n0] (tiled over N / n0) or null.
template <int N, int DP, int LDS = DP + 8>
__device__ __forceinline__ void attn_mma_core(const bf16_t* q, const bf16_t* k,
                                              const bf16_t* v,
                                              const float* vsum,
                                              const float* bias,
                                              const float* mask, int n0,
                                              int d, const float* lam,
                                              bf16_t* out, long long ldo,
                                              int warp) {
  constexpr int NT = N / 8;    // key tiles of 8 tokens
  const float lm = lam ? *lam : 0.f;
  const int lane = threadIdx.x & 31;
  const int gq = lane >> 2, t4 = lane & 3;
  for (int r0 = warp * 16; r0 < N; r0 += 16 * (ANT / 32)) {
    uint32_t qf[DP / 16][4];
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk)
      ldmatrix_x4(qf[kk], q + (r0 + (lane & 15)) * LDS + kk * 16 + (lane >> 4) * 8);

    float s[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        uint32_t t[4];
        const int kr = np * 16 + (lane & 7) + ((lane >> 4) << 3);
        ldmatrix_x4(t, k + kr * LDS + kk * 16 + ((lane >> 3) & 1) * 8);
        const uint32_t b0[2] = {t[0], t[1]}, b1[2] = {t[2], t[3]};
        mma_bf16_16816(s[2 * np], qf[kk], b0);
        mma_bf16_16816(s[2 * np + 1], qf[kk], b1);
      }
    }

    // bias + mask, row max (rows r0 + gq and r0 + gq + 8)
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = r0 + gq + (e >= 2 ? 8 : 0), j = nt * 8 + t4 * 2 + (e & 1);
        float val = s[nt][e] + bias[i * N + j];
        if (mask) val += mask[(i % n0) * n0 + j % n0];
        s[nt][e] = val;
        mx[e >> 1] = fmaxf(mx[e >> 1], val);
      }
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      mx[h2] = fmaxf(mx[h2], __shfl_xor_sync(0xffffffffu, mx[h2], 1));
      mx[h2] = fmaxf(mx[h2], __shfl_xor_sync(0xffffffffu, mx[h2], 2));
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float ex = expf(s[nt][e] - mx[e >> 1]);
        s[nt][e] = ex;
        sum[e >> 1] += ex;
      }
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      sum[h2] += __shfl_xor_sync(0xffffffffu, sum[h2], 1);
      sum[h2] += __shfl_xor_sync(0xffffffffu, sum[h2], 2);
    }

    // O = P V: P's accumulator layout is the A-fragment layout of m16k16
    float o[DP / 8][4];
#pragma unroll
    for (int ct = 0; ct < DP / 8; ++ct)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[ct][e] = 0.f;
#pragma unroll
    for (int j = 0; j < N / 16; ++j) {
      uint32_t pf[4];
      pf[0] = pack_bf16(s[2 * j][0], s[2 * j][1]);
      pf[1] = pack_bf16(s[2 * j][2], s[2 * j][3]);
      pf[2] = pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]);
      pf[3] = pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3]);
#pragma unroll
      for (int cp = 0; cp < DP / 16; ++cp) {
        uint32_t t[4];
        const int vr = j * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
        ldmatrix_x4_trans(t, v + vr * LDS + cp * 16 + (lane >> 4) * 8);
        const uint32_t b0[2] = {t[0], t[1]}, b1[2] = {t[2], t[3]};
        mma_bf16_16816(o[2 * cp], pf, b0);
        mma_bf16_16816(o[2 * cp + 1], pf, b1);
      }
    }
#pragma unroll
    for (int ct = 0; ct < DP / 8; ++ct)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = r0 + gq + (e >= 2 ? 8 : 0), c = ct * 8 + t4 * 2 + (e & 1);
        if (c >= d) continue;
        float val = o[ct][e] / sum[e >> 1];
        if (lam) val = (1.f + lm) * val - (lm / N) * vsum[c];
        out[(long long)i * ldo + c] = from_f<bf16_t>(val);
      }
  }
}

// sum_j v[j, c] for c < d over the N rows of a [N][LDS] bf16 tile; the
// caller synchronises after it
template <int N, int LDS>
__device__ __forceinline__ void attn_vsum(const bf16_t* v, int d, float* vsum) {
  for (int c = threadIdx.x; c < d; c += ANT) {
    float s = 0.f;
    for (int j = 0; j < N; ++j) s += to_f(v[j * LDS + c]);
    vsum[c] = s;
  }
}

template <int N, int DP>
__device__ __forceinline__ void attn_mma_tile(const AttnArgs& a, long long g,
                                              int hh, unsigned char* smem_raw) {
  constexpr int LDS = DP + 8;
  bf16_t* q = reinterpret_cast<bf16_t*>(smem_raw);
  bf16_t* k = q + N * LDS;
  bf16_t* v = k + N * LDS;
  float* vsum = reinterpret_cast<float*>(v + N * LDS);

  const int d = a.d;
  const bf16_t* src = static_cast<const bf16_t*>(a.qkv) + g * N * 3LL * a.C + hh * d;
  for (int e = threadIdx.x; e < N * DP; e += ANT) {
    const int i = e / DP, c = e % DP;
    const bf16_t* row = src + (long long)i * 3 * a.C + c;
    const bf16_t z = from_f<bf16_t>(0.f);
    q[i * LDS + c] = c < d ? row[0] : z;
    k[i * LDS + c] = c < d ? row[a.C] : z;
    v[i * LDS + c] = c < d ? row[2 * a.C] : z;
  }
  __syncthreads();

  const long long b = g / a.nW;
  const int wi = (int)(g - b * a.nW);
  if (a.lam) {
    attn_vsum<N, LDS>(v, d, vsum);
    __syncthreads();
  }
  const float* bias = a.bias + ((b / a.imgs_per_bias) * a.h + hh) * (long long)N * N;
  const float* mask = a.mask ? a.mask + (long long)wi * a.n0 * a.n0 : nullptr;
  bf16_t* out = static_cast<bf16_t*>(a.out) + g * (long long)N * a.ldo + hh * d;
  attn_mma_core<N, DP>(q, k, v, vsum, bias, mask, a.n0, d,
                       a.lam ? a.lam + b * a.h + hh : nullptr, out, a.ldo,
                       threadIdx.x >> 5);
  if (hh == 0) {  // the zero pad of the next GEMM's A operand
    const int pad = a.ldo - a.C;
    for (int e = threadIdx.x; e < N * pad; e += ANT)
      out[(long long)(e / pad) * a.ldo + a.C + e % pad] = from_f<bf16_t>(0.f);
  }
  __syncthreads();
}

template <int N, int DP>
__global__ void __launch_bounds__(ANT) attn_mma_kernel(const AttnArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  attn_mma_tile<N, DP>(a, blockIdx.x, blockIdx.y, smem_raw);
}

template <int N, int DP>
inline cudaError_t launch_attn_mma(const AttnArgs& a, long long groups,
                                   cudaStream_t st) {
  const size_t smem = attn_mma_smem_bytes<N, DP>();
  const cudaError_t err = cudaFuncSetAttribute(
      attn_mma_kernel<N, DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  attn_mma_kernel<N, DP>
      <<<dim3((unsigned)groups, (unsigned)a.h), ANT, smem, st>>>(a);
  return cudaSuccess;
}

// bf16 windows of 64 or 192 tokens with d <= 64 (every window of the
// flagship) take the tensor cores; fp32, and any other shape, the CUDA cores
template <typename T>
inline cudaError_t launch_attn(const AttnArgs& a, long long groups,
                               cudaStream_t st) {
  if constexpr (std::is_same<T, bf16_t>::value) {
    if (a.n == 64 && a.d <= 32) return launch_attn_mma<64, 32>(a, groups, st);
    if (a.n == 64 && a.d <= 64) return launch_attn_mma<64, 64>(a, groups, st);
    if (a.n == 192 && a.d <= 32) return launch_attn_mma<192, 32>(a, groups, st);
    if (a.n == 192 && a.d <= 64) return launch_attn_mma<192, 64>(a, groups, st);
  }
  const size_t smem = attn_smem_bytes(a.n, a.d);
  const cudaError_t err = cudaFuncSetAttribute(
      attn_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  attn_kernel<T><<<dim3((unsigned)groups, (unsigned)a.h), ANT, smem, st>>>(a);
  return cudaSuccess;
}

}  // namespace fairm
