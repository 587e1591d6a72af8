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
// What bounds it on the H100: by the card's peaks the bytes of y and res in
// and out at the shallow stages (C = 28 ... 112, most of the tokens) and
// the 192-token attention core, (L n)^2 d multiply-adds per group and head,
// at the deep ones. In four passes the group's rows make round trips
// through device memory (the regrouped rows, qkv [M, 3C], the attention
// rows: about 15x the bytes of y at C = 28), the qkv product has K = 32
// and N = 84, and the core reads each head's whole 147 KB bias from L2 for
// every group.
//
// Two forms, chosen by the caller (lewin_block.py::freq_inter_path):
// - fused (bf16, L n = 192, head dims <= 32, kpad(C) <= 128: the encoder's
//   res 128 / 64 / 32 stages; given the per-pair tables the model holds,
//   not only the grouped bias made from them): one persistent kernel of
//   freq_group.cuh's band groups, a CTA of twelve warps a group at a time:
//   it gathers the group's 192 rows of y (the band regroup, RowMap mode 2)
//   into shared memory and runs group_half's inter half on them (q / k / v
//   a head on mma.sync from a cp.async weight ring, the 192-key core with
//   the bias formed from the head's per-pair tables, bit-equal to the
//   grouped bias; the projection + bp, x dps of the row's band image, +
//   the residual, written to the image rows). No regrouped, q / k / v or
//   attention row reaches device memory. Rounding points are the passes':
//   y, q / k / v and the attention rows in bf16, every product accumulated
//   in fp32.
// - passes (fp32, the deep stages C = 224 / 448, whose products the wgmma
//   tile runs, and a launch given only the grouped bias): the band regroup is one gather pass (RowMap mode 2)
//   into a dense padded matrix that the qkv GEMM streams, the core
//   (attention.cuh) keeps the logits in shared memory, and the inverse
//   regroup is a scatter in the proj GEMM's epilogue, which also adds the
//   residual and the per-folded-sample dps.

#include "attention.cuh"
#include "freq_group.cuh"
#include "gemm.cuh"

using namespace fairm;

namespace {

struct InterArgs {
  GroupHalf half;       // the weights, the per-pair tables, res and out
  const bf16_t* y;      // [L*B, H, W, C], rows through map
  const float* dps;     // [L*B] by band image, or null
  RowMap map;           // mode 2: group-major logical row -> physical row
  long long hw;         // pixels of an image
  int nW;
};

__global__ void __launch_bounds__(FI_NT, 1)
    inter_fused_kernel(const InterArgs a, long long groups) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  group_init(a.half.C, smem_raw);
  for (long long g = blockIdx.x; g < groups; g += gridDim.x) {
    __syncthreads();  // the last group's readers of the rows and the ring
    group_gather(a.y, a.map, g, a.half.C, a.dps, a.hw, smem_raw);
    group_half<false>(a.half, g, (int)(g % a.nW), smem_raw);
  }
}

cudaError_t inter_fused_launch(const InterArgs& a, long long groups,
                               cudaStream_t st) {
  auto kernel = inter_fused_kernel;
  const size_t smem = group_layout(a.half.C).bytes;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, FI_NT,
                                                      smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorLaunchOutOfResources;
  long long blocks = (long long)per_sm * sms;
  if (blocks > groups) blocks = groups;
  kernel<<<(unsigned)blocks, FI_NT, smem, st>>>(a, groups);
  return cudaSuccess;
}

cudaError_t freq_inter_fused(const void* y, const void* res, const void* wqkv,
                             const float* bqkv, const void* wp,
                             const float* bp, const float* pairs,
                             const float* mask,
                             const float* dps, void* out, int LB, int H,
                             int W, int C, int h, int win, int L,
                             cudaStream_t st) {
  if (!group_ok(C, h, win, L) || LB % L || !pairs)
    return cudaErrorInvalidValue;
  InterArgs a{};
  a.half.wqkv = static_cast<const bf16_t*>(wqkv);
  a.half.bqkv = bqkv;
  a.half.wp = static_cast<const bf16_t*>(wp);
  a.half.bp = bp;
  a.half.tables = pairs;
  a.half.mask = mask;
  a.half.res = static_cast<const bf16_t*>(res);
  a.half.out = static_cast<bf16_t*>(out);
  a.half.C = C;
  a.half.h = h;
  a.y = static_cast<const bf16_t*>(y);
  a.dps = dps;
  a.nW = (H / win) * (W / win);
  a.map = RowMap{2, H, W, win, LB / L, L, 0};
  a.hw = (long long)H * W;
  const long long groups = (long long)(LB / L) * a.nW;
  return inter_fused_launch(a, groups, st);
}

}  // namespace

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

// 1 if the fused form takes the shape (fairm_freq_inter with fused = 1),
// else 0
extern "C" int fairm_freq_inter_fused_ok(int C, int h, int win, int L) {
  return group_ok(C, h, win, L);
}

extern "C" int fairm_freq_inter(const void* y, const void* res,
                                const void* wqkv, const void* bqkv,
                                const void* wp, const void* bp,
                                const void* bias, const void* pairs,
                                const void* mask, const void* dps, void* zo,
                                void* qkv, void* out, int LB, int H, int W,
                                int C, int h, int win, int L, int is_bf16,
                                int fused, void* stream) {
  cudaError_t err;
  if (fused) {  // the caller's choice: bf16 with the per-pair tables, a
                // shape it cannot take fails
    err = is_bf16 ? freq_inter_fused(y, res, wqkv, (const float*)bqkv, wp,
                                     (const float*)bp, (const float*)pairs,
                                     (const float*)mask,
                                     (const float*)dps, out, LB, H, W, C, h,
                                     win, L, (cudaStream_t)stream)
                  : cudaErrorInvalidValue;
  } else {
    auto f = [&](auto tag) {
      using T = decltype(tag);
      return freq_inter<T>(y, res, wqkv, (const float*)bqkv, wp,
                           (const float*)bp, (const float*)bias,
                           (const float*)mask, (const float*)dps, zo, qkv,
                           out, LB, H, W, C, h, win, L, (cudaStream_t)stream);
    };
    err = is_bf16 ? f(bf16_t{}) : f(float{});
  }
  if (err == cudaSuccess) err = cudaGetLastError();
  return (int)err;
}
