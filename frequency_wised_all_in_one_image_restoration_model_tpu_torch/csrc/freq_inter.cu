// K3: the cross-band (inter) half of the frequency-MSA encoder block.
//
// Replaces the Pallas kernel _freq_inter_kernel (frequency_wised_all_in_one_
// image_restoration_model_tpu/ops/pallas/lewin_block.py, reached through
// fused_freq_inter):
//   out[l*B + b] = res[l*B + b] + dps[l*B + b] * proj(grouped_attn(y))
// where each window's L band copies form one L*n = 192-token group, the
// bias [h, L*n, L*n] carries the L x L relative-position tables with the
// 'inter' band mask folded in, and the SW-MSA mask is tiled (L, L). No LN.
//
// What bounds it on the H100: the 192-token attention core, (L n)^2 d
// multiply-adds per window and head (on the tensor cores in bf16, the CUDA
// cores in fp32, where q/k/v of the group take 68 KB of shared memory:
// dynamic shared memory above the 48 KB default).
// What the design does about it: the band regroup of the JAX composite is
// one gather pass (RowMap mode 2) into a dense padded matrix that the qkv
// GEMM streams, and its inverse a scatter in the proj GEMM's epilogue,
// which also adds the residual and the per-folded-sample dps; the logits
// stay in shared memory.

#include "attention.cuh"
#include "gemm.cuh"

using namespace fairm;

template <typename T>
static cudaError_t freq_inter(const void* y, const void* res,
                              const void* wqkv, const float* bqkv,
                              const void* wp, const float* bp,
                              const float* bias, const float* mask,
                              const float* dps, void* zo, void* qkv, void* out,
                              int LB, int H, int W, int C, int h, int win,
                              int L, cudaStream_t st) {
  const int n = win * win;
  const int nW = (H / win) * (W / win);
  const int B = LB / L;
  const long long M = (long long)LB * H * W;
  const RowMap grouped{2, H, W, win, B, L};

  // band regroup (no LN) -> zo [M, kpad(C)]
  launch_prep<T>(y, C, grouped, M, nullptr, nullptr, 0.f, zo, st);

  GemmArgs g1{};
  g1.A = zo;
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

  AttnArgs at{};  // its output reuses zo, dead after the qkv GEMM
  at.qkv = qkv;
  at.out = zo;
  at.bias = bias;
  at.mask = mask;
  at.lam = nullptr;
  at.n = L * n;
  at.n0 = n;
  at.d = C / h;
  at.C = C;
  at.h = h;
  at.ldo = kpad(C);
  at.nW = nW;
  at.imgs_per_bias = B;  // one shared bias
  err = launch_attn<T>(at, (long long)B * nW, st);
  if (err != cudaSuccess) return err;

  GemmArgs g2{};
  g2.A = zo;
  g2.Wt = wp;
  g2.lda = kpad(C);
  g2.bias = bp;
  g2.dps = dps;
  g2.hw = (long long)H * W;
  g2.res = res;
  g2.C = out;
  g2.cmap = grouped;
  g2.M = M;
  g2.N = C;
  return launch_gemm<T>(g2, st);
}

extern "C" int fairm_freq_inter(const void* y, const void* res,
                                const void* wqkv, const void* bqkv,
                                const void* wp, const void* bp,
                                const void* bias, const void* mask,
                                const void* dps, void* zo, void* qkv,
                                void* out, int LB, int H, int W, int C, int h,
                                int win, int L, int is_bf16, void* stream) {
  auto f = [&](auto tag) {
    using T = decltype(tag);
    return freq_inter<T>(y, res, wqkv, (const float*)bqkv, wp,
                         (const float*)bp, (const float*)bias,
                         (const float*)mask, (const float*)dps, zo, qkv, out,
                         LB, H, W, C, h, win, L, (cudaStream_t)stream);
  };
  cudaError_t err = is_bf16 ? f(bf16_t{}) : f(float{});
  if (err == cudaSuccess) err = cudaGetLastError();
  return (int)err;
}
