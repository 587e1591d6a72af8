// K2: the FFN half of a LeWin block (LeFF).
//
// Replaces the Pallas kernel _ffn_kernel (frequency_wised_all_in_one_image_
// restoration_model_tpu/ops/pallas/lewin_block.py, reached through
// fused_block_ffn):
//   out = x + dps * (gelu(dwconv3x3(gelu(LN2(x) W1 + b1)) + bd) W2 + b2)
// with tanh-GELU and zero padding at the image border.
//
// What bounds it on the H100: the [M, 4C] hidden tensor. At the shallow
// stages the kernel is bound by its bytes (the hidden rows are written and
// read twice); at the deep stages (C = 448, 896) by the two products.
// What the design does about it: LN2 is one pass into a dense padded
// matrix, and b1 + GELU the first GEMM's epilogue; the depthwise conv, bd
// and GELU are one pass over the hidden rows; the second GEMM's epilogue
// adds b2, scales by dps and adds the residual. Both products run on the
// tensor cores in bf16 (cp.async pipeline, mma.sync).
// Folding the depthwise conv into the second GEMM's A loads, so the hidden
// rows cross device memory once, is the next step.

#include "dwconv.cuh"
#include "gemm.cuh"

using namespace fairm;

template <typename T>
static cudaError_t lewin_ffn(const void* x, const float* lns, const float* lnb,
                             const void* w1t, const float* b1, const float* wd,
                             const float* bd, const void* w2t, const float* b2,
                             const float* dps, void* xn, void* hid1,
                             void* hid2, void* out, int B, int H, int W, int C,
                             int Hd, float eps, cudaStream_t st) {
  const long long M = (long long)B * H * W;

  // LN2 -> xn [M, kpad(C)]
  launch_prep<T>(x, C, identity_map(), M, lns, lnb, eps, xn, st);

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
  cudaError_t err = launch_gemm<T>(g1, st);
  if (err != cudaSuccess) return err;

  launch_dwconv<T>(hid1, wd, bd, hid2, (long long)B * H, H, W, Hd, st);

  GemmArgs g2{};
  g2.A = hid2;
  g2.Wt = w2t;
  g2.lda = kpad(Hd);
  g2.bias = b2;
  g2.dps = dps;
  g2.hw = (long long)H * W;
  g2.res = x;
  g2.C = out;
  g2.cmap = identity_map();
  g2.M = M;
  g2.N = C;
  return launch_gemm<T>(g2, st);
}

extern "C" int fairm_lewin_ffn(const void* x, const void* lns, const void* lnb,
                               const void* w1t, const void* b1, const void* wd,
                               const void* bd, const void* w2t, const void* b2,
                               const void* dps, void* xn, void* hid1,
                               void* hid2, void* out, int B, int H, int W,
                               int C, int Hd, int is_bf16, float eps,
                               void* stream) {
  auto f = [&](auto tag) {
    using T = decltype(tag);
    return lewin_ffn<T>(x, (const float*)lns, (const float*)lnb, w1t,
                        (const float*)b1, (const float*)wd, (const float*)bd,
                        w2t, (const float*)b2, (const float*)dps, xn, hid1,
                        hid2, out, B, H, W, C, Hd, eps, (cudaStream_t)stream);
  };
  cudaError_t err = is_bf16 ? f(bf16_t{}) : f(float{});
  if (err == cudaSuccess) err = cudaGetLastError();
  return (int)err;
}
