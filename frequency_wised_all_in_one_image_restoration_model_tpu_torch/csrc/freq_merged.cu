// K5: one whole frequency-MSA LeWin block in one launch.
//
// Replaces the Pallas kernel _merged_freq_kernel (frequency_wised_all_in_one_
// image_restoration_model_tpu/ops/pallas/lewin_block.py, reached through
// fused_block_freq_merged):
//   y1  = proj_A(per-band window_attention(LN1(roll(x))))     (intra)
//   u   = x + dps1 * unroll(proj_B(grouped_attention(y1)))    (inter)
//   out = u + dps2 * LeFF(LN2(u))
// on the TRUE-layout band-major batch [L*B, H, W, C]: per-band bias tables
// [L, h, n, n] for the intra half, the grouped bias [h, L*n, L*n] with the
// band mask folded in for the inter half, the SW-MSA mask in both, dps by
// the folded sample l*B + b; y1 and u rounded to the model dtype, as the
// K1 -> K3 -> K2 chain stores them.
//
// What bounds it on the H100: the 192-token inter core and the [M, 4C]
// hidden rows, as in K3 and K2, plus a grid-wide barrier between phases.
// What the design does about it: merged.cuh. The band regroup and its
// inverse are row maps (a gather before the inter qkv product, a scatter in
// the last projection's epilogue), and the cyclic shift rides in them.

#include "merged.cuh"

using namespace fairm;

extern "C" int fairm_freq_merged(
    const void* x, const void* ln1s, const void* ln1b, const void* wqkvA,
    const void* bqkvA, const void* wpA, const void* bpA, const void* biasA,
    const void* wqkvB, const void* bqkvB, const void* wpB, const void* bpB,
    const void* biasB, const void* mask, const void* dps1, const void* ln2s,
    const void* ln2b, const void* w1, const void* b1, const void* wd,
    const void* bd, const void* w2, const void* b2, const void* dps2,
    void* scratch, void* out, void* stamps, long long scratch_elems, int LB, int H, int W,
    int C, int h, int win, int shift, int L, int Hd, int is_bf16, float eps,
    void* stream) {
  if (L < 1 || LB % L ||
      scratch_elems < (long long)LB * H * W *
                          merged_scratch_cols(C, Hd, true, false,
                                              is_bf16 ? 2 : 4))
    return (int)cudaErrorInvalidValue;
  MergedArgs p{};
  p.x = x;
  p.ln1s = (const float*)ln1s;
  p.ln1b = (const float*)ln1b;
  p.a1 = AttnWeights{wqkvA, (const float*)bqkvA, wpA, (const float*)bpA,
                     (const float*)biasA};
  p.a2 = AttnWeights{wqkvB, (const float*)bqkvB, wpB, (const float*)bpB,
                     (const float*)biasB};
  p.mask = (const float*)mask;
  p.lam = nullptr;
  p.dps1 = (const float*)dps1;
  p.ln2s = (const float*)ln2s;
  p.ln2b = (const float*)ln2b;
  p.w1 = w1;
  p.b1 = (const float*)b1;
  p.wd = (const float*)wd;
  p.bd = (const float*)bd;
  p.w2 = w2;
  p.b2 = (const float*)b2;
  p.dps2 = (const float*)dps2;
  p.scratch = scratch;
  p.out = out;
  p.stamps = (long long*)stamps;
  p.B = LB;
  p.H = H;
  p.W = W;
  p.C = C;
  p.h = h;
  p.win = win;
  p.shift = shift;
  p.L = L;
  p.Hd = Hd;
  p.eps = eps;
  cudaError_t err = is_bf16
                        ? launch_merged<bf16_t, true>(p, (cudaStream_t)stream)
                        : launch_merged<float, true>(p, (cudaStream_t)stream);
  if (err == cudaSuccess) err = cudaGetLastError();
  return (int)err;
}
