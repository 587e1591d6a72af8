// K1: the attention half of a LeWin block, and the per-band intra attention
// of the frequency-MSA block.
//
// Replaces the Pallas kernel _attn_kernel (frequency_wised_all_in_one_image_
// restoration_model_tpu/ops/pallas/lewin_block.py, reached through
// fused_block_attention and fused_freq_intra):
//   out = [x +] dps * proj(window_attention(LN1(x)))
// with the relative-position bias per bias group (1, or L bands of the
// band-major folded batch), the additive SW-MSA mask and the all_DC rank-1
// gain lam. The caller applies the cyclic roll.
//
// What bounds it on the H100: at the shallow stages (C = 28, 56 at 128^2)
// the products are thin (K = C) and the kernel moves bytes: the image, the
// [M, 3C] qkv rows and the [M, C] attention rows. At the deep stages the
// qkv / proj products dominate.
// What the design does about it: four launches. One pass applies LN1 and
// the window partition (a row gather) into a dense, padded matrix, so the
// qkv GEMM streams aligned tiles (cp.async, mma.sync in bf16); the logits
// stay on the SM (in bf16 both attention products run on the tensor
// cores); the proj GEMM's epilogue adds the bias, scales by dps, scatters
// back to image rows and adds the residual. Keeping q/k/v of a window on
// chip between the steps is the next step.

#include "attention.cuh"
#include "gemm.cuh"

using namespace fairm;

template <typename T>
static cudaError_t lewin_attn(const void* x, const float* lns, const float* lnb,
                              const void* wqkv, const float* bqkv,
                              const void* wp, const float* bp,
                              const float* bias, const float* mask,
                              const float* lam, const float* dps, void* xo,
                              void* qkv, void* out, int B, int H, int W, int C,
                              int h, int win, int groups, int res, float eps,
                              cudaStream_t st) {
  const int n = win * win;
  const int nW = (H / win) * (W / win);
  const long long M = (long long)B * H * W;
  const RowMap windows{1, H, W, win, B, 1};

  // LN1 + window partition -> xo [M, kpad(C)]
  launch_prep<T>(x, C, windows, M, lns, lnb, eps, xo, st);

  GemmArgs g1{};
  g1.A = xo;
  g1.Wt = wqkv;
  g1.lda = kpad(C);
  g1.bias = bqkv;
  g1.hw = (long long)H * W;
  g1.C = qkv;
  g1.cmap = identity_map();
  g1.M = M;
  g1.N = 3 * C;
  cudaError_t err = launch_gemm<T>(g1, st);
  if (err != cudaSuccess) return err;

  AttnArgs at{};  // its output reuses xo, dead after the qkv GEMM
  at.qkv = qkv;
  at.out = xo;
  at.bias = bias;
  at.mask = mask;
  at.lam = lam;
  at.n = n;
  at.n0 = n;
  at.d = C / h;
  at.C = C;
  at.h = h;
  at.ldo = kpad(C);
  at.nW = nW;
  at.imgs_per_bias = B / groups;
  err = launch_attn<T>(at, (long long)B * nW, st);
  if (err != cudaSuccess) return err;

  GemmArgs g2{};
  g2.A = xo;
  g2.Wt = wp;
  g2.lda = kpad(C);
  g2.bias = bp;
  g2.dps = dps;
  g2.hw = (long long)H * W;
  g2.res = res ? x : nullptr;
  g2.C = out;
  g2.cmap = windows;
  g2.M = M;
  g2.N = C;
  return launch_gemm<T>(g2, st);
}

extern "C" int fairm_lewin_attn(const void* x, const void* lns,
                                const void* lnb, const void* wqkv,
                                const void* bqkv, const void* wp,
                                const void* bp, const void* bias,
                                const void* mask, const void* lam,
                                const void* dps, void* xo, void* qkv,
                                void* out, int B, int H, int W, int C, int h,
                                int win, int groups, int res, int is_bf16,
                                float eps, void* stream) {
  auto f = [&](auto tag) {
    using T = decltype(tag);
    return lewin_attn<T>(x, (const float*)lns, (const float*)lnb, wqkv,
                         (const float*)bqkv, wp, (const float*)bp,
                         (const float*)bias, (const float*)mask,
                         (const float*)lam, (const float*)dps, xo, qkv, out, B,
                         H, W, C, h, win, groups, res, eps,
                         (cudaStream_t)stream);
  };
  cudaError_t err = is_bf16 ? f(bf16_t{}) : f(float{});
  if (err == cudaSuccess) err = cudaGetLastError();
  return (int)err;
}
