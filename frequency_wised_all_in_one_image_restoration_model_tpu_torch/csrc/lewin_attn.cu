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
// What bounds it on the H100: at the shallow stages (C <= 224, most of the
// tokens) the bytes of the image in and out, once no [M, 3C] qkv or
// [M, kpad(C)] attention rows reach device memory; at the deep stages
// (C = 448, 896) the qkv and proj products.
// What the design does about it, chosen by the caller (``fused``: the
// launcher's attention_path, lewin_block.py):
// - bf16, kpad(C) <= 224, 8 x 8 windows: one launch of attn_fused.cuh's
//   window half, as the Pallas body keeps the half in VMEM: a block of 128
//   threads takes a window at a time (a grid of the blocks the card holds,
//   striding over the windows), its LN1 rows, q / k / v of a head group,
//   the attention rows of all heads and the streamed weight slices in
//   shared memory; nothing but the output reaches device memory.
// - otherwise four launches. One pass applies LN1 and the window partition
//   (a row gather) into a dense, padded matrix [M, kpad(C)]; the qkv GEMM
//   (in bf16 on gemm_wgmma.cuh's TMA / wgmma tile at these widths) writes
//   [M, 3C]; the attention core keeps the logits on the SM (bf16: both
//   products on the tensor cores); the proj GEMM's epilogue adds the bias,
//   scales by dps, scatters back to image rows and adds the residual.

#include "attn_fused.cuh"
#include "gemm.cuh"

using namespace fairm;

namespace {

// registers for the blocks shared memory holds an SM: four at the encoder's
// single 28-dim head (C = 28), two or three elsewhere (C = 224 ... 56)
template <int DP>
__global__ void __launch_bounds__(ANT, DP == 32 ? 4 : 3)
    fused_attn_kernel(const FusedAttnArgs a, long long windows, int nW) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  fused_attn_init<DP>(a, smem_raw);
  for (long long g = blockIdx.x; g < windows; g += gridDim.x)
    fused_attn_window<DP>(a, g, nW, smem_raw);
}

// a grid of the blocks the card holds at the layout's shared memory
template <int DP>
cudaError_t fused_attn_launch(const FusedAttnArgs& a, long long windows, int nW,
                              cudaStream_t st) {
  auto kernel = fused_attn_kernel<DP>;
  const size_t smem = fused_attn_layout(a.C, a.h, DP).bytes;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, ANT,
                                                      smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorLaunchOutOfResources;
  long long blocks = (long long)per_sm * sms;
  if (blocks > windows) blocks = windows;
  kernel<<<(unsigned)blocks, ANT, smem, st>>>(a, windows, nW);
  return cudaSuccess;
}

cudaError_t lewin_attn_fused(const void* x, const float* lns, const float* lnb,
                             const void* wqkv, const float* bqkv,
                             const void* wp, const float* bp,
                             const float* bias, const float* mask,
                             const float* lam, const float* dps, void* out,
                             int B, int H, int W, int C, int h, int win,
                             int groups, int res, float eps, cudaStream_t st) {
  const int dp = fused_attn_dp(C, h, win);
  if (!dp) return cudaErrorInvalidValue;
  FusedAttnArgs a{};
  a.x = static_cast<const bf16_t*>(x);
  a.lns = lns;
  a.lnb = lnb;
  a.eps = eps;
  a.wqkv = static_cast<const bf16_t*>(wqkv);
  a.bqkv = bqkv;
  a.wp = static_cast<const bf16_t*>(wp);
  a.bp = bp;
  a.bias = bias;
  a.mask = mask;
  a.lam = lam;
  a.dps = dps;
  a.res = res ? static_cast<const bf16_t*>(x) : nullptr;
  a.out = static_cast<bf16_t*>(out);
  a.map = RowMap{1, H, W, win, B, 1, 0};
  a.C = C;
  a.h = h;
  a.imgs_per_bias = B / groups;
  const int nW = (H / win) * (W / win);
  const long long windows = (long long)B * nW;
  return dp == 32 ? fused_attn_launch<32>(a, windows, nW, st)
                  : fused_attn_launch<64>(a, windows, nW, st);
}

}  // namespace

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
                                int fused, float eps, void* stream) {
  if (fused) {  // the caller's choice; a shape the fused half cannot take fails
    cudaError_t err = is_bf16
        ? lewin_attn_fused(x, (const float*)lns, (const float*)lnb, wqkv,
                           (const float*)bqkv, wp, (const float*)bp,
                           (const float*)bias, (const float*)mask,
                           (const float*)lam, (const float*)dps, out, B, H, W,
                           C, h, win, groups, res, eps, (cudaStream_t)stream)
        : cudaErrorInvalidValue;
    if (err == cudaSuccess) err = cudaGetLastError();
    return (int)err;
  }
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
