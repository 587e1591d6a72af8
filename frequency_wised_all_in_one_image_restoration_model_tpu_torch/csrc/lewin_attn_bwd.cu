// K6: backward of the attention half of a LeWin block and of the per-band
// intra attention of the frequency-MSA block (the backward of K1).
//
// Replaces the Pallas kernel _attn_bwd_kernel (frequency_wised_all_in_one_
// image_restoration_model_tpu/ops/pallas/lewin_block_bwd.py, reached through
// attn_block_bwd): given x and the gradient g of
//   out = [x +] proj(window_attention(LN1(x)))
// it recomputes the forward intermediates and returns dx and the gradients
// of the LayerNorm, the qkv and proj weights, the relative-position bias
// (per band for the intra attention) and the all_DC gain lam, in the order
// and with the rounding points of attention_bwd.cuh's note.
//
// What bounds it on the H100: eleven products per block, five over all the
// block's rows (the qkv recompute, gw Wp^T, out^T gw, xw^T dqkv, dqkv
// Wqkv^T) and six per window and head; at the main path's shapes (d = 28,
// 56, n = 64) the bytes of the row tensors between them.
// What the design does about it: attention_bwd.cuh's attn_bwd_run, which
// K8 shares: the four products over the rows other than the recompute on
// bwd_gemm.cuh (mma.sync in bf16, FMA in fp32), and in bf16 at n = 64,
// d <= 64 (d a multiple of 4) the per-window part on the tensor-core core
// of attention_core_bwd.cuh, so that no [G, h, n, n] tensor crosses device
// memory; fp32 and other shapes keep the CUDA-core attn_bwd_kernel. No
// float atomics: a second launch gives equal bits.

#include "attention_bwd.cuh"

using namespace fairm;

namespace {

AttnBwdProblem problem(const void* x, const void* g, const void* lns,
                       const void* lnb, const void* wqkv, const void* bqkv,
                       const void* wp, const void* wqkvn, const void* wpn,
                       const void* bias, const void* mask,
                       const void* lam, void* dx, void* dln, void* dwqkv,
                       void* dbqkv, void* dwp, void* dbp, void* dbias,
                       void* dlam, int B, int H, int W, int C, int h, int win,
                       int groups, int res, float eps) {
  AttnBwdProblem p{};
  p.x = x;
  p.g = g;
  p.lns = (const float*)lns;
  p.lnb = (const float*)lnb;
  p.wqkv = wqkv;
  p.bqkv = (const float*)bqkv;
  p.wp = wp;
  p.wqkvn = wqkvn;
  p.wpn = wpn;
  p.bias = (const float*)bias;
  p.mask = (const float*)mask;
  p.lam = (const float*)lam;
  p.dx = dx;
  p.dln = (float*)dln;
  p.dwqkv = (float*)dwqkv;
  p.dbqkv = (float*)dbqkv;
  p.dwp = (float*)dwp;
  p.dbp = (float*)dbp;
  p.dbias = (float*)dbias;
  p.dlam = (float*)dlam;
  p.images = B;
  p.H = H;
  p.W = W;
  p.C = C;
  p.h = h;
  p.win = win;
  p.L = 1;
  p.bias_groups = groups;
  p.res = res;
  p.eps = eps;
  return p;
}

}  // namespace

// bytes of workspace fairm_lewin_attn_bwd needs (-1 if the shape is refused)
extern "C" long long fairm_lewin_attn_bwd_ws(int B, int H, int W, int C, int h,
                                             int win, int groups, int is_bf16) {
  const AttnBwdProblem p =
      problem(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
              nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
              nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, B, H, W, C,
              h, win, groups, 0, 0.f);
  return is_bf16 ? attn_bwd_ws_bytes<bf16_t>(p) : attn_bwd_ws_bytes<float>(p);
}

// wqkv [3C, kpad(C)] and wp [C, kpad(C)]: the forward's operands (q
// unscaled); wqkvn [C, kpad(3C)] and wpn [C, kpad(C)]: Wqkv and Wp as they
// are, the B operands of dqkv Wqkv^T and gw Wp^T
extern "C" int fairm_lewin_attn_bwd(const void* x, const void* g,
                                    const void* lns, const void* lnb,
                                    const void* wqkv, const void* bqkv,
                                    const void* wp, const void* wqkvn,
                                    const void* wpn, const void* bias,
                                    const void* mask, const void* lam, void* ws,
                                    void* dx, void* dln, void* dwqkv,
                                    void* dbqkv, void* dwp, void* dbp,
                                    void* dbias, void* dlam, long long ws_bytes,
                                    int B, int H, int W, int C, int h, int win,
                                    int groups, int res, int is_bf16, float eps,
                                    void* stream) {
  const AttnBwdProblem p =
      problem(x, g, lns, lnb, wqkv, bqkv, wp, wqkvn, wpn, bias, mask, lam, dx,
              dln, dwqkv, dbqkv, dwp, dbp, dbias, dlam, B, H, W, C, h, win,
              groups, res, eps);
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = is_bf16 ? attn_bwd_run<bf16_t>(p, ws, ws_bytes, st)
                            : attn_bwd_run<float>(p, ws, ws_bytes, st);
  if (err == cudaSuccess) err = cudaGetLastError();
  return (int)err;
}
