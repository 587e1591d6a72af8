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
// What bounds it on the H100: at the deep stages the two products (2 M C
// Hd operations each) on the CUDA cores in fp32; with few rows (M = 64 B at
// res 8) linear2 has few output tiles over a long reduction (Hd = 3584).
// What the design does about it: LN2, linear1 + b1 + GELU (into fp32) and
// the depthwise conv + bd + GELU are K2's passes (gemm.cuh, dwconv.cuh); linear2 runs as
// kb parts, grid (row tiles, column tiles, kb), each over its hidden block's
// k-tiles into an fp32 partial [M, C] (split.cuh), kb times K2's CTAs; a
// fixed-order pass adds the parts, b2, dps and the residual (no atomics: a
// second launch gives equal bits). The blocks are kpad(Hd) / kb columns
// (Hd / kb at the deep stages, where Hd / kb is a multiple of 32). The
// hidden slab of a block still makes two round trips through device
// memory, as in K2; keeping a row tile's slab (with its one-row halo) on
// the SM from linear1 to its rows of W2 is the next step.

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
                                   int Hd, int kb, float eps, cudaStream_t st) {
  const long long M = (long long)B * H * W;

  // LN2 -> xn [M, kpad(C)]
  launch_prep<T>(x, C, identity_map(), M, lns, lnb, eps, xn, st);

  // linear1 + b1 + GELU over every hidden block at once: its columns are
  // the blocks' columns, and no sum crosses a block
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
  g1.c_f32 = 1;  // the hidden stays fp32 until the conv's GELU, as in JAX
  cudaError_t err = launch_gemm<T>(g1, st);
  if (err != cudaSuccess) return err;

  launch_dwconv<T>(static_cast<const float*>(hid1), wd, bd, hid2,
                   (long long)B * H, H, W, Hd, st);

  // linear2, one fp32 partial per hidden block
  err = launch_splitk<T>(hid2, w2t, kpad(Hd), M, C, kb, parts, st);
  if (err != cudaSuccess) return err;
  launch_split_reduce<T>(parts, kb, M, C, b2, dps, (long long)H * W, x, out,
                         identity_map(), st);
  return cudaSuccess;
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
