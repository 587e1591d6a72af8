// K4: one whole origin-MSA LeWin block in one launch.
//
// Replaces the Pallas kernel _merged_kernel (frequency_wised_all_in_one_image_
// restoration_model_tpu/ops/pallas/lewin_block.py, reached through
// fused_block_merged):
//   u   = x + dps1 * unroll(proj(window_attention(LN1(roll(x)))))
//   out = u + dps2 * LeFF(LN2(u))
// on the TRUE-layout image: relative-position bias, the additive SW-MSA mask
// by the window of the rolled image, the all_DC rank-1 gain lam; u rounded
// to the model dtype between the halves, as the K1 -> K2 chain stores it.
//
// What bounds it on the H100: what bounds K1 and K2 (bytes at the shallow
// stages, the products at the deep ones), plus one grid-wide barrier between
// phases, where the chain has a kernel boundary.
// What the design does about it: merged.cuh. The TPU kernel walks each image
// row tile by row tile and carries the attention output in on-chip scratch;
// on the card that walk would leave B blocks on 132 SMs, so the phases run
// grid-wide instead and the cyclic shift rides in the row maps. In bf16 the
// products run on the TMA / wgmma tile, and at kpad(C) <= 224 (``fused``,
// the caller's attention_path) the attention half is one phase that keeps
// its rows on the SM (attn_fused.cuh).

#include "merged.cuh"

using namespace fairm;

extern "C" int fairm_lewin_merged(
    const void* x, const void* ln1s, const void* ln1b, const void* wqkv,
    const void* bqkv, const void* wp, const void* bp, const void* bias,
    const void* mask, const void* lam, const void* dps1, const void* ln2s,
    const void* ln2b, const void* w1, const void* b1, const void* wd,
    const void* bd, const void* w2, const void* b2, const void* dps2,
    void* scratch, void* out, void* stamps, long long scratch_elems, int B, int H, int W,
    int C, int h, int win, int shift, int Hd, int is_bf16, int fused, float eps,
    void* stream) {
  if (scratch_elems <
      (long long)B * H * W * merged_scratch_cols(C, Hd, false, fused,
                                                is_bf16 ? 2 : 4))
    return (int)cudaErrorInvalidValue;
  MergedArgs p{};
  p.x = x;
  p.ln1s = (const float*)ln1s;
  p.ln1b = (const float*)ln1b;
  p.a1 = AttnWeights{wqkv, (const float*)bqkv, wp, (const float*)bp,
                     (const float*)bias};
  p.mask = (const float*)mask;
  p.lam = (const float*)lam;
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
  p.B = B;
  p.H = H;
  p.W = W;
  p.C = C;
  p.h = h;
  p.win = win;
  p.shift = shift;
  p.L = 1;
  p.Hd = Hd;
  p.fused = fused;
  p.eps = eps;
  cudaError_t err = is_bf16
                        ? launch_merged<bf16_t, false>(p, (cudaStream_t)stream)
                        : launch_merged<float, false>(p, (cudaStream_t)stream);
  if (err == cudaSuccess) err = cudaGetLastError();
  return (int)err;
}
