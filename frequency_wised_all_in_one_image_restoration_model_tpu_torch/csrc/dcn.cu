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

#include "dcn.cuh"

using namespace fairm;

namespace {

template <typename T>
cudaError_t run(const ColArgs& c, const void* wt, const float* bias, void* out,
                int Cout, cudaStream_t st) {
  cudaError_t err = launch_cols<T>(c, st);
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
