// K11: modulated deformable convolution v2 (stride 1), the LeFF's DCN of the
// decoder's deform_conv injection.
//
// Replaces the Pallas kernel _kernel of dcn_shift_kernel
// (frequency_wised_all_in_one_image_restoration_model_tpu/ops/pallas/dcn.py)
// with the semantics of the JAX package's default, the exact gather
// composite _exact_dcn (ops/deform_conv.py): x [B, H, W, C] (NHWC), offset
// [B, Ho, Wo, 2K] (all K dy, then all K dx), mask [B, Ho, Wo, K] (already
// sigmoided), the weight as the GEMM operand Wt [Cout, kpad(K C)] (row o,
// column t C + c = weight[t / kw, t % kw, c, o]), bias [Cout] fp32 or null;
// out [B, Ho, Wo, Cout]. The sample of tap t at output pixel (y, x) is the
// bilinear sample of the zero-padded image at (y - pad + (t / kw) dil + dy,
// x - pad + (t % kw) dil + dx), with _bilinear_gather's rim rule: the
// coordinates clipped to [-1, H] and the base corner to H - 1, every corner
// outside the image reading zero. A clamp >= 0 first clamps every offset to
// [-clamp, clamp]: the semantics of the TPU kernel, which clamps to a radius
// R so that it can replace the gather by a static shift-sum (a workaround
// for Mosaic's gather limits that costs about six times the arithmetic).
//
// What bounds it on the H100: the contraction, 2 B Ho Wo K C Cout
// operations (118 GFLOP per block at B = 32, 128^2, C = 112); the gather
// reads each input pixel about 4 K times, mostly from L2. What the design
// does about it: pass 1, one warp per output pixel whose lanes walk its (tap,
// 16 bytes of channels) items (vector reads of the four corners, every lane
// busy at any C), writes the modulated sample, rounded once to x's type,
// into a column matrix [B Ho Wo, kpad(K C)]
// in device memory; pass 2 is the port's tiled GEMM (gemm.cuh: bf16 on the
// tensor cores with fp32 accumulation, fp32 on the CUDA cores in full
// precision), with the bias in its epilogue. Keeping the columns on the SM
// (an implicit GEMM that builds its A tile in shared memory) is the open
// step.

#include "gemm.cuh"

using namespace fairm;

namespace {

struct ColArgs {
  const void* x;
  const float* off;
  const float* mask;
  void* cols;
  int B, H, W, C, Ho, Wo, kh, kw, pad, dil, ldc;
  float clamp;
};

// V consecutive channels moved as one access (16 bytes when the rows allow)
template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T v[V];
};

template <typename T, int V>
__device__ __forceinline__ void add_corner(float* s, float w, const T* p) {
  const Pack<T, V> x = *reinterpret_cast<const Pack<T, V>*>(p);
#pragma unroll
  for (int i = 0; i < V; ++i) s[i] += w * to_f(x.v[i]);
}

// one warp per output pixel; its lanes walk the pixel's (tap, V channels)
// items, so that every lane has work at any C
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
    float dy = a.off[pix * 2 * K + t], dx = a.off[pix * 2 * K + K + t];
    if (a.clamp >= 0.f) {
      dy = fminf(fmaxf(dy, -a.clamp), a.clamp);
      dx = fminf(fmaxf(dx, -a.clamp), a.clamp);
    }
    const float m = a.mask[pix * K + t];
    const float yy = (float)(oy - a.pad + (t / a.kw) * a.dil) + dy;
    const float xx = (float)(ox - a.pad + (t % a.kw) * a.dil) + dx;
    const float yyc = fminf(fmaxf(yy, -1.f), (float)a.H);
    const float xxc = fminf(fmaxf(xx, -1.f), (float)a.W);
    const float y0 = fminf(fmaxf(floorf(yyc), -1.f), (float)(a.H - 1));
    const float x0 = fminf(fmaxf(floorf(xxc), -1.f), (float)(a.W - 1));
    const float fy = yyc - y0, fx = xxc - x0;
    const int iy = (int)y0, ix = (int)x0;
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

template <typename T>
cudaError_t run(const ColArgs& c, const void* wt, const float* bias, void* out,
                int Cout, cudaStream_t st) {
  const long long blocks = ((long long)c.B * c.Ho * c.Wo * 32 + 255) / 256;
  constexpr int V = 16 / sizeof(T);
  if (c.C % V == 0 && reinterpret_cast<uintptr_t>(c.x) % 16 == 0)
    cols_kernel<T, V><<<(unsigned)blocks, 256, 0, st>>>(c);
  else
    cols_kernel<T, 1><<<(unsigned)blocks, 256, 0, st>>>(c);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  GemmArgs g{};
  g.A = c.cols;
  g.Wt = wt;
  g.lda = c.ldc;
  g.bias = bias;
  g.dps = nullptr;
  g.hw = 1;
  g.res = nullptr;
  g.C = out;
  g.cmap = identity_map();
  g.M = (long long)c.B * c.Ho * c.Wo;
  g.N = Cout;
  g.act = 0;
  return launch_gemm<T>(g, st);
}

}  // namespace

extern "C" int fairm_dcn(const void* x, const void* off, const void* mask,
                         const void* wt, const void* bias, void* cols, void* out,
                         int B, int H, int W, int C, int Ho, int Wo, int Cout,
                         int kh, int kw, int pad, int dil, float clamp,
                         int is_bf16, void* stream) {
  const ColArgs c{x, (const float*)off, (const float*)mask, cols, B, H, W, C,
                  Ho, Wo, kh, kw, pad, dil, kpad(kh * kw * C), clamp};
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err =
      is_bf16 ? run<bf16_t>(c, wt, (const float*)bias, out, Cout, st)
              : run<float>(c, wt, (const float*)bias, out, Cout, st);
  if (err == cudaSuccess) err = cudaGetLastError();
  return (int)err;
}
