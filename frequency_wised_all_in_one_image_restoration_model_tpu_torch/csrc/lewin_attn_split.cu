// K12: the attention half of a LeWin block with its q / k / v projections
// as three [C, C] weight blocks.
//
// Replaces the Pallas kernel _attn_kernel_split (frequency_wised_all_in_one_
// image_restoration_model_tpu/ops/pallas/lewin_block.py, reached through
// fused_block_attention where _attn_weights_fit is false, fp32 at C = 896):
//   out = x + dps * proj(window_attention(LN1(x)))
// with the relative-position bias, the additive SW-MSA mask and the all_DC
// rank-1 gain lam; the caller applies the cyclic roll. The TPU kernel brings
// in one [C, C] block (q, k or v) per step of a sequential grid axis and
// fills a third of a qkv scratch, because the fp32 weights at C = 896 do not
// fit its VMEM at once; the core and the projection run at the last step.
//
// What bounds it on the H100: at the deep stages the qkv and proj products
// (8 M C^2 operations) on the CUDA cores in fp32; with few rows (M = 64 B at
// res 8, where one window is the whole image) the proj product has few
// output tiles over a long reduction.
// What the design does about it: LN1 and the window partition are one
// gather pass (gemm.cuh); the qkv product is one launch whose column tiles
// each lie in one of the three [C, C] blocks (C = 896 is 7 tiles of 128 and
// 14 of 64), q's block carrying the attention scale; the core keeps the
// logits on the SM (attention.cuh); the projection runs as kb parts over
// its k-tiles into fp32 partials, kb times K1's CTAs, and a fixed-order pass
// adds the parts, the bias, dps and the residual while it scatters the
// window rows back to image rows (split.cuh; no atomics). Keeping a window's
// q / k / v on the SM from the projection through the core is the next step.

#include "attention.cuh"
#include "gemm.cuh"
#include "split.cuh"

using namespace fairm;

template <typename T>
static cudaError_t lewin_attn_split(const void* x, const float* lns,
                                    const float* lnb, const void* wqkv,
                                    const float* bqkv, const void* wp,
                                    const float* bp, const float* bias,
                                    const float* mask, const float* lam,
                                    const float* dps, void* xo, void* qkv,
                                    float* parts, void* out, int B, int H,
                                    int W, int C, int h, int win, int res,
                                    int kb, float eps, cudaStream_t st) {
  const int n = win * win;
  const int nW = (H / win) * (W / win);
  const long long M = (long long)B * H * W;
  const RowMap windows{1, H, W, win, B, 1};

  // LN1 + window partition -> xo [M, kpad(C)]
  launch_prep<T>(x, C, windows, M, lns, lnb, eps, xo, st);

  // q | k | v: the three [C, C] blocks of wqkv [3C, kpad(C)]
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

  AttnArgs at{};  // its output reuses xo, dead after the qkv product
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
  at.imgs_per_bias = B;
  err = launch_attn<T>(at, (long long)B * nW, st);
  if (err != cudaSuccess) return err;

  // proj in kb parts, then bias, dps, scatter to image rows, residual
  err = launch_splitk<T>(xo, wp, kpad(C), M, C, kb, parts, st);
  if (err != cudaSuccess) return err;
  launch_split_reduce<T>(parts, kb, M, C, bp, dps, (long long)H * W,
                         res ? x : nullptr, out, windows, st);
  return cudaSuccess;
}

extern "C" int fairm_lewin_attn_split(
    const void* x, const void* lns, const void* lnb, const void* wqkv,
    const void* bqkv, const void* wp, const void* bp, const void* bias,
    const void* mask, const void* lam, const void* dps, void* xo, void* qkv,
    void* parts, void* out, int B, int H, int W, int C, int h, int win,
    int res, int kb, int is_bf16, float eps, void* stream) {
  auto f = [&](auto tag) {
    using T = decltype(tag);
    return lewin_attn_split<T>(
        x, (const float*)lns, (const float*)lnb, wqkv, (const float*)bqkv, wp,
        (const float*)bp, (const float*)bias, (const float*)mask,
        (const float*)lam, (const float*)dps, xo, qkv, (float*)parts, out, B,
        H, W, C, h, win, res, kb, eps, (cudaStream_t)stream);
  };
  cudaError_t err = is_bf16 ? f(bf16_t{}) : f(float{});
  if (err == cudaSuccess) err = cudaGetLastError();
  return (int)err;
}
