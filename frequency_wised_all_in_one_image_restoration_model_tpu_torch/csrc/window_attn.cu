// K9: standalone window attention, softmax(q k^T * scale + bias [+ mask]) v,
// the attention core of the unfused LeWin block (the decoder's injection
// methods, the learnable modulator, the encoder's need_kv blocks).
//
// Replaces the Pallas kernel _kernel of fused_window_attention
// (frequency_wised_all_in_one_image_restoration_model_tpu/ops/pallas/
// window_attention.py): q [W, h, n, d], k / v [W, h, nk, d] (nk = n, or a
// multiple of n: 192 encoder keys for the decoder's 64-token windows under
// attention_kv), bias [h, n, nk] fp32, mask [nW, n, nk] fp32 or null
// (window w takes mask[w % nW]); out [W, h, n, d] in q's type. The rounding
// points are the Pallas body's: q.k accumulated in fp32, then the scale,
// the bias and the mask; a per-row-max softmax in fp32, the probabilities
// normalised and then rounded to v's type, p.v accumulated in fp32.
//
// The TPU kernel packs two 64-token windows into one 128-wide MXU tile and
// kills the cross-window logits with -1e9; here every (window, head) is one
// block of 128 threads and no packing is needed.
//
// What bounds it on the H100: the logits, 2 n nk d multiply-adds per window
// and head for each of the two products, against reading q, k, v once and
// writing out once; at d = 28..56 it sits near the ridge of the tensor
// cores. What the design does about it: the logits never leave the SM; in
// bf16, for the three window shapes of the port's main path (n, nk) = (64,
// 64), (64, 192), (192, 192) with d <= 64, both products run on the tensor
// cores (mma.sync m16n8k16, fp32 accumulators; one warp per 16 query rows,
// the head dim zero-padded to 32 or 64 in shared memory); fp32 (full
// precision, no TF32) and every other shape take the CUDA cores.

#include "gemm.cuh"

using namespace fairm;

namespace {

struct WinArgs {
  const void* q;
  const void* k;
  const void* v;
  const float* bias;  // [h, n, nk]
  const float* mask;  // [nW, n, nk] or null
  void* out;
  int h, n, nk, d, nW;
  float scale;
};

constexpr int WNT = 128;

size_t generic_smem(int n, int nk, int d) {
  return sizeof(float) *
         ((size_t)n * d + (size_t)nk * (d + 1) * 2 + (WNT / 32) * (size_t)nk);
}

// CUDA cores: one warp per query row, fp32 in shared memory
template <typename T>
__global__ void __launch_bounds__(WNT) win_attn_kernel(const WinArgs a) {
  extern __shared__ __align__(16) float sm[];
  const int n = a.n, nk = a.nk, d = a.d;
  const long long w = blockIdx.x;
  const int hh = blockIdx.y;
  float* q = sm;
  float* k = q + n * d;                 // row stride d + 1: conflict-free
  float* v = k + nk * (d + 1);
  float* pbuf = v + nk * (d + 1);       // one row of probabilities per warp

  const long long wh = w * a.h + hh;
  const T* qs = static_cast<const T*>(a.q) + wh * n * d;
  const T* ks = static_cast<const T*>(a.k) + wh * nk * d;
  const T* vs = static_cast<const T*>(a.v) + wh * nk * d;
  for (int e = threadIdx.x; e < n * d; e += WNT) q[e] = to_f(qs[e]);
  for (int e = threadIdx.x; e < nk * d; e += WNT) {
    const int j = e / d, c = e - j * d;
    k[j * (d + 1) + c] = to_f(ks[e]);
    v[j * (d + 1) + c] = to_f(vs[e]);
  }
  __syncthreads();

  const float* bias = a.bias + (long long)hh * n * nk;
  const float* mask = a.mask ? a.mask + (w % a.nW) * n * (long long)nk : nullptr;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* p = pbuf + warp * nk;
  T* out = static_cast<T*>(a.out) + wh * n * d;
  for (int i = warp; i < n; i += WNT / 32) {
    const float* qi = q + i * d;
    float mx = -INFINITY;
    for (int j = lane; j < nk; j += 32) {
      const float* kj = k + j * (d + 1);
      float s = 0.f;
      for (int c = 0; c < d; ++c) s = fmaf(qi[c], kj[c], s);
      s = s * a.scale + bias[i * nk + j];
      if (mask) s += mask[i * nk + j];
      p[j] = s;
      mx = fmaxf(mx, s);
    }
    mx = warp_max(mx);
    float sum = 0.f;
    for (int j = lane; j < nk; j += 32) {
      const float e = expf(p[j] - mx);
      p[j] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    for (int j = lane; j < nk; j += 32) p[j] = to_f(from_f<T>(p[j] / sum));
    __syncwarp();
    for (int c = lane; c < d; c += 32) {
      float o = 0.f;
      for (int j = 0; j < nk; ++j) o = fmaf(p[j], v[j * (d + 1) + c], o);
      out[(long long)i * d + c] = from_f<T>(o);
    }
    __syncwarp();
  }
}

template <int N, int NK, int DP>
constexpr size_t mma_smem() {
  return sizeof(bf16_t) * (N + 2 * NK) * (DP + 8);
}

// bf16 on the tensor cores: N queries, NK keys, head dim d <= DP
template <int N, int NK, int DP>
__global__ void __launch_bounds__(WNT) win_attn_mma_kernel(const WinArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int LDS = DP + 8;  // 16-byte row offsets spread over the banks
  constexpr int NT = NK / 8;   // key tiles of 8 tokens
  bf16_t* q = reinterpret_cast<bf16_t*>(smem_raw);
  bf16_t* k = q + N * LDS;
  bf16_t* v = k + NK * LDS;

  const int d = a.d;
  const long long w = blockIdx.x;
  const int hh = blockIdx.y;
  const long long wh = w * a.h + hh;
  const bf16_t* qs = static_cast<const bf16_t*>(a.q) + wh * N * d;
  const bf16_t* ks = static_cast<const bf16_t*>(a.k) + wh * NK * d;
  const bf16_t* vs = static_cast<const bf16_t*>(a.v) + wh * NK * d;
  const bf16_t z = from_f<bf16_t>(0.f);
  for (int e = threadIdx.x; e < N * DP; e += WNT) {
    const int i = e / DP, c = e % DP;
    q[i * LDS + c] = c < d ? qs[i * d + c] : z;
  }
  for (int e = threadIdx.x; e < NK * DP; e += WNT) {
    const int j = e / DP, c = e % DP;
    k[j * LDS + c] = c < d ? ks[j * d + c] : z;
    v[j * LDS + c] = c < d ? vs[j * d + c] : z;
  }
  __syncthreads();

  const float* bias = a.bias + (long long)hh * N * NK;
  const float* mask = a.mask ? a.mask + (w % a.nW) * N * (long long)NK : nullptr;
  bf16_t* out = static_cast<bf16_t*>(a.out) + wh * N * d;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, t4 = lane & 3;
  for (int r0 = warp * 16; r0 < N; r0 += 16 * (WNT / 32)) {
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

    // scale, bias, mask; row max of rows r0 + gq and r0 + gq + 8
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = r0 + gq + (e >= 2 ? 8 : 0), j = nt * 8 + t4 * 2 + (e & 1);
        float val = s[nt][e] * a.scale + bias[i * NK + j];
        if (mask) val += mask[i * NK + j];
        s[nt][e] = val;
        mx[e >> 1] = fmaxf(mx[e >> 1], val);
      }
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      mx[h2] = fmaxf(mx[h2], __shfl_xor_sync(0xffffffffu, mx[h2], 1));
      mx[h2] = fmaxf(mx[h2], __shfl_xor_sync(0xffffffffu, mx[h2], 2));
    }
    float sum[2] = {0.f, 0.f};
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

    // O = P V with P normalised before its rounding to bf16, as the Pallas
    // body does; P's accumulator layout is the A-fragment layout of m16k16
    float o[DP / 8][4];
#pragma unroll
    for (int ct = 0; ct < DP / 8; ++ct)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[ct][e] = 0.f;
#pragma unroll
    for (int j = 0; j < NK / 16; ++j) {
      uint32_t pf[4];
      pf[0] = pack_bf16(s[2 * j][0] / sum[0], s[2 * j][1] / sum[0]);
      pf[1] = pack_bf16(s[2 * j][2] / sum[1], s[2 * j][3] / sum[1]);
      pf[2] = pack_bf16(s[2 * j + 1][0] / sum[0], s[2 * j + 1][1] / sum[0]);
      pf[3] = pack_bf16(s[2 * j + 1][2] / sum[1], s[2 * j + 1][3] / sum[1]);
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
        if (c < d) out[(long long)i * d + c] = from_f<bf16_t>(o[ct][e]);
      }
  }
}

template <int N, int NK, int DP>
cudaError_t launch_mma(const WinArgs& a, long long W, cudaStream_t st) {
  constexpr size_t smem = mma_smem<N, NK, DP>();
  const cudaError_t err = cudaFuncSetAttribute(
      win_attn_mma_kernel<N, NK, DP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  win_attn_mma_kernel<N, NK, DP>
      <<<dim3((unsigned)W, (unsigned)a.h), WNT, smem, st>>>(a);
  return cudaSuccess;
}

template <typename T>
cudaError_t launch(const WinArgs& a, long long W, cudaStream_t st) {
  if constexpr (std::is_same<T, bf16_t>::value) {
    const int dp = a.d <= 32 ? 32 : (a.d <= 64 ? 64 : 0);
    if (dp == 32) {
      if (a.n == 64 && a.nk == 64) return launch_mma<64, 64, 32>(a, W, st);
      if (a.n == 64 && a.nk == 192) return launch_mma<64, 192, 32>(a, W, st);
      if (a.n == 192 && a.nk == 192) return launch_mma<192, 192, 32>(a, W, st);
    } else if (dp == 64) {
      if (a.n == 64 && a.nk == 64) return launch_mma<64, 64, 64>(a, W, st);
      if (a.n == 64 && a.nk == 192) return launch_mma<64, 192, 64>(a, W, st);
      if (a.n == 192 && a.nk == 192) return launch_mma<192, 192, 64>(a, W, st);
    }
  }
  const size_t smem = generic_smem(a.n, a.nk, a.d);
  const cudaError_t err = cudaFuncSetAttribute(
      win_attn_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  win_attn_kernel<T><<<dim3((unsigned)W, (unsigned)a.h), WNT, smem, st>>>(a);
  return cudaSuccess;
}

}  // namespace

extern "C" int fairm_window_attn(const void* q, const void* k, const void* v,
                                 const void* bias, const void* mask, void* out,
                                 int W, int h, int n, int nk, int d, int nW,
                                 float scale, int is_bf16, void* stream) {
  const WinArgs a{q, k, v, (const float*)bias, (const float*)mask, out,
                  h, n, nk, d, nW, scale};
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = is_bf16 ? launch<bf16_t>(a, W, st) : launch<float>(a, W, st);
  if (err == cudaSuccess) err = cudaGetLastError();
  return (int)err;
}
