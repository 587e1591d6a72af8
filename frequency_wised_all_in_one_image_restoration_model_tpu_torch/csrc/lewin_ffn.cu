// K2: the FFN half of a LeWin block (LeFF).
//
// Replaces the Pallas kernel _ffn_kernel (frequency_wised_all_in_one_image_
// restoration_model_tpu/ops/pallas/lewin_block.py, reached through
// fused_block_ffn):
//   out = x + dps * (gelu(dwconv3x3(gelu(LN2(x) W1 + b1)) + bd) W2 + b2)
// with tanh-GELU and zero padding at the image border.
//
// What bounds it on the H100: by the card's peaks, at the shallow stages
// (C <= 224, most of the tokens) the bytes of x in and out, once the
// [M, 4C] hidden tensor stays off device memory, and at the deep stages
// (C = 448, 896) the two products. In practice the fused kernel is bound by
// the work on each hidden element on the CUDA cores (two GELUs, 1.56 for
// the halo's first, and the nine taps) and by its barriers.
//
// bf16, C a multiple of 4 and kpad(C) <= 224 (every flagship stage up to
// C = 224): one fused kernel, as the Pallas body keeps its hidden rows in
// VMEM: ffn_fused.cuh's tile, a CTA of eight warps an 8 x 8 pixel tile,
// LN2 of the tile and its halo, the hidden in blocks of 32 columns through
// fc1, the conv and fc2 on the SM, the output written once. The halo costs
// fc1 1.56x its products; a CTA takes 35-106 KB of shared memory (C = 28
// ... 224) and 64-126 registers a thread, so that two to four share an SM
// and one's barriers hide behind another's work.
//
// Other widths and fp32 keep four passes (at C = 448 this kernel, one CTA
// an SM, took 1.5-4x their time on an H100, PERF.md section 6): LN2 into a
// dense padded matrix, fc1 with b1 + GELU as the GEMM's epilogue into
// [M, 4C] in fp32 (the fused kernel's and JAX's rounding points: the
// hidden is rounded once, after the conv), the depthwise conv + bd + GELU
// pass into fc2's operand in the model dtype, fc2 with b2, dps and the
// residual as its epilogue (both products on gemm.cuh's GEMM).

#include "dwconv.cuh"
#include "ffn_fused.cuh"
#include "gemm.cuh"

using namespace fairm;

namespace {

constexpr int FF_NT = 256;                // eight warps a tile

template <class S>
__global__ void __launch_bounds__(FF_NT, S::MINB) ffn_fused_kernel(const FfnArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  ffn_fused_tile<S, FF_NT>(a, blockIdx.x, blockIdx.y, smem, threadIdx.x,
                           [] { __syncthreads(); });
}

template <class S>
cudaError_t ffn_fused_launch(const FfnArgs& a, int B, cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(
      ffn_fused_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)S::BYTES);
  if (err != cudaSuccess) return err;
  const int tiles = ((a.H + FF_T - 1) / FF_T) * ((a.W + FF_T - 1) / FF_T);
  ffn_fused_kernel<S><<<dim3((unsigned)tiles, (unsigned)B), FF_NT, S::BYTES, st>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t lewin_ffn(const void* x, const float* lns, const float* lnb,
                      const void* w1t, const float* b1, const float* wd,
                      const float* bd, const void* w2t, const float* b2,
                      const float* dps, void* xn, void* hid1, void* hid2,
                      void* out, int B, int H, int W, int C, int Hd, float eps,
                      cudaStream_t st) {
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
  g1.c_f32 = 1;  // the hidden stays fp32 until the conv's GELU, as in JAX
  cudaError_t err = launch_gemm<T>(g1, st);
  if (err != cudaSuccess) return err;

  launch_dwconv<T>(static_cast<const float*>(hid1), wd, bd, hid2,
                   (long long)B * H, H, W, Hd, st);

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

}  // namespace

// 1 if fairm_lewin_ffn runs the fused kernel for C (it then takes no xn,
// hid1 or hid2), else 0
extern "C" int fairm_lewin_ffn_fused(int C, int is_bf16) {
  return ffn_fused_kp(C, is_bf16) > 0;
}

extern "C" int fairm_lewin_ffn(const void* x, const void* lns, const void* lnb,
                               const void* w1t, const void* b1, const void* wd,
                               const void* bd, const void* w2t, const void* b2,
                               const void* dps, void* xn, void* hid1,
                               void* hid2, void* out, int B, int H, int W,
                               int C, int Hd, int is_bf16, float eps,
                               void* stream) {
  cudaError_t err;
  if (const int kp = ffn_fused_kp(C, is_bf16)) {
    const FfnArgs a{static_cast<const bf16_t*>(x), (const float*)lns,
                    (const float*)lnb, static_cast<const bf16_t*>(w1t),
                    (const float*)b1, (const float*)wd, (const float*)bd,
                    static_cast<const bf16_t*>(w2t), (const float*)b2,
                    (const float*)dps, static_cast<bf16_t*>(out), H, W, C, Hd,
                    kpad(C), kpad(Hd), eps};
    const cudaStream_t st = (cudaStream_t)stream;
    // CTAs an SM asked of the compiler (registers): as many as fit without
    // spills, from an A/B of HB = 32 / 64 and 2-4 CTAs on an H100
    err = kp == 32    ? ffn_fused_launch<FfnShape<32, 4>>(a, B, st)
          : kp == 64  ? ffn_fused_launch<FfnShape<64, 4>>(a, B, st)
          : kp == 128 ? ffn_fused_launch<FfnShape<128, 3>>(a, B, st)
                      : ffn_fused_launch<FfnShape<224, 2>>(a, B, st);
  } else {
    auto f = [&](auto tag) {
      using T = decltype(tag);
      return lewin_ffn<T>(x, (const float*)lns, (const float*)lnb, w1t,
                          (const float*)b1, (const float*)wd, (const float*)bd,
                          w2t, (const float*)b2, (const float*)dps, xn, hid1,
                          hid2, out, B, H, W, C, Hd, eps, (cudaStream_t)stream);
    };
    err = is_bf16 ? f(bf16_t{}) : f(float{});
  }
  if (err == cudaSuccess) err = cudaGetLastError();
  return (int)err;
}
