// K13: the FFN half of a LeWin block (LeFF) as a sum over hidden blocks.
//
// Replaces the Pallas kernel _ffn_kernel_split (frequency_wised_all_in_one_
// image_restoration_model_tpu/ops/pallas/lewin_block.py, reached through
// fused_block_ffn where _ffn_choose_kb > 1, fp32 at C = 896):
//   out = x + dps * (sum_k gelu(dwconv3x3_k(gelu(LN2(x) W1[:, k] + b1[k]))
//                     + bd[k]) W2[k, :] + b2)
// over kb blocks k of the hidden dim, with tanh-GELU and zero padding at the
// image border. The hidden dim is exactly separable (the depthwise conv
// mixes no channels), so each block's partial product is its own; the TPU
// kernel sums them in an fp32 scratch over a sequential grid axis because
// the fp32 weights at C = 896 do not fit its VMEM at once.
//
// What bounds it on the H100: the two products (2 M C Hd operations each):
// in fp32 on the CUDA cores (67 TFLOP/s, TF32 off), in bf16 the weights'
// bytes at M = 256 (res 8, B = 4: 12.8 MB) and the tensor cores above. With
// few rows (M = 64 B at res 8) the products cannot fill 132 SMs by their
// output tiles, and fc2's reduction is long (Hd = 3584).
// What the design does about it: four passes. LN2; fc1 + b1 + GELU over
// every hidden block at once into fp32 (JAX keeps the hidden in fp32
// through the conv); the depthwise conv + bd + GELU (dwconv.cuh), rounded
// once for fc2; fc2 as kb parts, one per hidden block, each an fp32
// partial, and the fixed-order reduction that adds the parts, b2, dps and
// the residual (no atomics: a second launch gives equal bits), or one
// product with that epilogue where it fills the card alone (kb = 1). The
// products run on split.cuh's FMA core in fp32 (register tiles fed by
// float4 reads of cp.async double-buffered k-tiles) and on the TMA / wgmma
// tile in bf16 (gemm_wgmma.cuh; fc2's parts in one launch, a block a tile
// and hidden block). A form that kept a block's hidden rows on the SM (a
// block per image and hidden block, fc1, conv and fc2 in one launch, the
// fp32 partials reduced after) measured no faster in fp32 and slower in
// bf16 (PERF.md, PR 13) and was taken out.

#include "dwconv.cuh"
#include "gemm.cuh"
#include "split.cuh"

using namespace fairm;

template <typename T>
static cudaError_t lewin_ffn_split(const void* x, const float* lns,
                                   const float* lnb, const void* w1t,
                                   const float* b1, const float* wd,
                                   const float* bd, const void* w2t,
                                   const float* b2, const float* dps, void* xn,
                                   void* hid1, void* hid2, float* parts,
                                   void* out, int B, int H, int W, int C,
                                   int Hd, int kb, float eps,
                                   cudaStream_t st) {
  const long long M = (long long)B * H * W;

  // LN2 -> xn [M, kpad(C)]
  launch_prep<T>(x, C, identity_map(), M, lns, lnb, eps, xn, st);

  // linear1 + b1 + GELU over every hidden block at once (its columns are
  // the blocks' columns, and no sum crosses a block), kept in fp32
  GemmArgs g1{};
  g1.A = xn;
  g1.Wt = w1t;
  g1.lda = kpad(C);
  g1.bias = b1;
  g1.hw = (long long)H * W;
  g1.C = hid1;
  g1.cmap = identity_map();
  g1.M = M;
  g1.N = Hd;
  g1.act = 1;
  g1.c_f32 = 1;
  cudaError_t err;
  if constexpr (std::is_same<T, float>::value)
    err = launch_fma_gemm(g1, 1, st);
  else
    err = launch_gemm<T>(g1, st);
  if (err != cudaSuccess) return err;

  launch_dwconv<T>(static_cast<const float*>(hid1), wd, bd, hid2,
                   (long long)B * H, H, W, Hd, st);

  // linear2 + b2, x dps, + the residual: one product, or one fp32 part per
  // hidden block and the fixed-order reduction
  return split_product<T>(hid2, w2t, kpad(Hd), M, C, b2, dps, (long long)H * W,
                          x, out, identity_map(), kb, parts, st);
}

extern "C" int fairm_lewin_ffn_split(
    const void* x, const void* lns, const void* lnb, const void* w1t,
    const void* b1, const void* wd, const void* bd, const void* w2t,
    const void* b2, const void* dps, void* xn, void* hid1, void* hid2,
    void* parts, void* out, int B, int H, int W, int C, int Hd, int kb,
    int is_bf16, float eps, void* stream) {
  auto f = [&](auto tag) {
    using T = decltype(tag);
    return lewin_ffn_split<T>(
        x, (const float*)lns, (const float*)lnb, w1t, (const float*)b1,
        (const float*)wd, (const float*)bd, w2t, (const float*)b2,
        (const float*)dps, xn, hid1, hid2, (float*)parts, out, B, H, W, C, Hd,
        kb, eps, (cudaStream_t)stream);
  };
  cudaError_t err = is_bf16 ? f(bf16_t{}) : f(float{});
  if (err == cudaSuccess) err = cudaGetLastError();
  return (int)err;
}
