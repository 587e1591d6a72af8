// Shared pieces of the DCN kernels K11 (dcn.cu, forward) and K14 (dcn_bwd.cu,
// backward): the bilinear footing of a sample and the pass that writes the
// modulated columns.
//
// Layouts (NHWC): x [B, H, W, C], offset [B, Ho, Wo, 2K] (all K dy, then all K
// dx), mask [B, Ho, Wo, K] (already sigmoided), both fp32. The sample of tap
// t at output pixel (oy, ox) is the bilinear sample of the zero-padded image
// at (oy - pad + (t / kw) dil + dy, ox - pad + (t % kw) dil + dx), with
// _bilinear_gather's rim rule: the coordinates clipped to [-1, H] and the
// base corner to H - 1, every corner outside the image reading zero. A clamp
// >= 0 first clamps every offset to [-clamp, clamp].

#pragma once

#include "gemm.cuh"

namespace fairm {

struct ColArgs {
  const void* x;
  const float* off;
  const float* mask;
  void* cols;
  int B, H, W, C, Ho, Wo, kh, kw, pad, dil, ldc;
  float clamp;
  int bf16_om;  // offset and mask stored in bf16 (else fp32)
};

// element i of the offset or the mask
__device__ __forceinline__ float om_at(const ColArgs& a, const float* p,
                                       long long i) {
  return a.bf16_om ? __bfloat162float(reinterpret_cast<const bf16_t*>(p)[i]) : p[i];
}

// V consecutive channels moved as one access (16 bytes when the rows allow)
template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T v[V];
};

// where the sample of tap t at output pixel pix = (b, oy, ox) lands
struct Footing {
  float yy, xx;  // the sampling coordinates before the rim clip
  float fy, fx;  // the fractions within the base cell
  int iy, ix;    // the base corner, in [-1, H - 1] x [-1, W - 1]
};

__device__ __forceinline__ Footing footing(const ColArgs& a, long long pix,
                                           int oy, int ox, int t) {
  const int K = a.kh * a.kw;
  float dy = om_at(a, a.off, pix * 2 * K + t),
        dx = om_at(a, a.off, pix * 2 * K + K + t);
  if (a.clamp >= 0.f) {
    dy = fminf(fmaxf(dy, -a.clamp), a.clamp);
    dx = fminf(fmaxf(dx, -a.clamp), a.clamp);
  }
  Footing f;
  f.yy = (float)(oy - a.pad + (t / a.kw) * a.dil) + dy;
  f.xx = (float)(ox - a.pad + (t % a.kw) * a.dil) + dx;
  const float yyc = fminf(fmaxf(f.yy, -1.f), (float)a.H);
  const float xxc = fminf(fmaxf(f.xx, -1.f), (float)a.W);
  const float y0 = fminf(fmaxf(floorf(yyc), -1.f), (float)(a.H - 1));
  const float x0 = fminf(fmaxf(floorf(xxc), -1.f), (float)(a.W - 1));
  f.fy = yyc - y0;
  f.fx = xxc - x0;
  f.iy = (int)y0;
  f.ix = (int)x0;
  return f;
}

template <typename T, int V>
__device__ __forceinline__ void add_corner(float* s, float w, const T* p) {
  const Pack<T, V> x = *reinterpret_cast<const Pack<T, V>*>(p);
#pragma unroll
  for (int i = 0; i < V; ++i) s[i] += w * to_f(x.v[i]);
}

// cols[pix, t C + c] = mask * sample, rounded once to T; the pad columns up
// to ldc are zero. One warp per output pixel; its lanes walk the pixel's
// (tap, V channels) items, so that every lane has work at any C.
template <typename T, int V>
__global__ void __launch_bounds__(256) cols_kernel(const ColArgs a) {
  const int K = a.kh * a.kw;
  const long long pix = (blockIdx.x * (long long)blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (pix >= (long long)a.B * a.Ho * a.Wo) return;  // whole warps
  const int hw = a.Ho * a.Wo;
  const long long b = pix / hw;
  const int rem = (int)(pix - b * hw);
  const int oy = rem / a.Wo, ox = rem - oy * a.Wo;
  const int cv = a.C / V;
  const T* xb = static_cast<const T*>(a.x) + b * a.H * (long long)a.W * a.C;
  T* dst = static_cast<T*>(a.cols) + pix * a.ldc;

  for (int e = lane; e < K * cv; e += 32) {
    const int t = e / cv, c = (e - t * cv) * V;
    const Footing f = footing(a, pix, oy, ox, t);
    const float m = om_at(a, a.mask, pix * K + t);
    const float fy = f.fy, fx = f.fx;
    const int iy = f.iy, ix = f.ix;
    const bool r0 = iy >= 0, r1 = iy + 1 < a.H, c0 = ix >= 0, c1 = ix + 1 < a.W;
    const T* p00 = xb + ((long long)iy * a.W + ix) * a.C + c;
    const T* p10 = p00 + (long long)a.W * a.C;
    float s[V];
#pragma unroll
    for (int i = 0; i < V; ++i) s[i] = 0.f;
    if (r0 && c0) add_corner<T, V>(s, (1.f - fy) * (1.f - fx), p00);
    if (r0 && c1) add_corner<T, V>(s, (1.f - fy) * fx, p00 + a.C);
    if (r1 && c0) add_corner<T, V>(s, fy * (1.f - fx), p10);
    if (r1 && c1) add_corner<T, V>(s, fy * fx, p10 + a.C);
    Pack<T, V> out;
#pragma unroll
    for (int i = 0; i < V; ++i) out.v[i] = from_f<T>(s[i] * m);
    *reinterpret_cast<Pack<T, V>*>(dst + t * a.C + c) = out;
  }
  for (int c = K * a.C + lane; c < a.ldc; c += 32)  // the GEMM operand's zero pad
    dst[c] = from_f<T>(0.f);
}

// channels per access: 16 bytes where C and x allow it, else one
template <typename T>
__host__ __device__ inline bool dcn_vec_ok(int C, const void* x) {
  return C % (16 / sizeof(T)) == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
}

template <typename T>
inline cudaError_t launch_cols(const ColArgs& c, cudaStream_t st) {
  const long long blocks = ((long long)c.B * c.Ho * c.Wo * 32 + 255) / 256;
  constexpr int V = 16 / sizeof(T);
  if (dcn_vec_ok<T>(c.C, c.x))
    cols_kernel<T, V><<<(unsigned)blocks, 256, 0, st>>>(c);
  else
    cols_kernel<T, 1><<<(unsigned)blocks, 256, 0, st>>>(c);
  return cudaGetLastError();
}

}  // namespace fairm
