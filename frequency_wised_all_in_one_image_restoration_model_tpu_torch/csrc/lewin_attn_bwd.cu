// K6: backward of the attention half of a LeWin block and of the per-band
// intra attention of the frequency-MSA block (the backward of K1).
//
// Replaces the Pallas kernel _attn_bwd_kernel (frequency_wised_all_in_one_
// image_restoration_model_tpu/ops/pallas/lewin_block_bwd.py, reached through
// attn_block_bwd): given x and the gradient g of
//   out = [x +] proj(window_attention(LN1(x)))
// it recomputes the forward intermediates and returns dx and the gradients
// of the LayerNorm, the qkv and proj weights, the relative-position bias
// (per band for the intra attention) and the all_DC gain lam.
//
// What bounds it on the H100: nine products per block against the forward's
// four, five of them on the CUDA cores here (bwd.cuh), and the per-window
// p / dl matrices that cross device memory once for the bias gradient.
// What the design does about it: see attention_bwd.cuh. The TPU kernel's
// sequential accumulation of the weight gradients becomes chunk partials and
// a fixed-order reduction, so the result does not change from run to run.

#include "attention_bwd.cuh"

using namespace fairm;

static AttnBwdProblem problem(const void* x, const void* g, const void* lns,
                              const void* lnb, const void* wqkv,
                              const void* bqkv, const void* wp,
                              const void* bias, const void* mask,
                              const void* lam, void* dx, void* dln,
                              void* dwqkv, void* dbqkv, void* dwp, void* dbp,
                              void* dbias, void* dlam, int B, int H, int W,
                              int C, int h, int win, int groups, int res,
                              float eps) {
  AttnBwdProblem p{};
  p.x = x;
  p.g = g;
  p.lns = (const float*)lns;
  p.lnb = (const float*)lnb;
  p.wqkv = wqkv;
  p.bqkv = (const float*)bqkv;
  p.wp = wp;
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

// bytes of workspace fairm_lewin_attn_bwd needs
extern "C" long long fairm_lewin_attn_bwd_ws(int B, int H, int W, int C, int h,
                                             int win, int is_bf16) {
  const AttnBwdProblem p =
      problem(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
              nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
              nullptr, nullptr, nullptr, nullptr, B, H, W, C, h, win, 1, 0, 0.f);
  return is_bf16 ? attn_bwd_ws_bytes<bf16_t>(p) : attn_bwd_ws_bytes<float>(p);
}

extern "C" int fairm_lewin_attn_bwd(const void* x, const void* g,
                                    const void* lns, const void* lnb,
                                    const void* wqkv, const void* bqkv,
                                    const void* wp, const void* bias,
                                    const void* mask, const void* lam, void* ws,
                                    void* dx, void* dln, void* dwqkv,
                                    void* dbqkv, void* dwp, void* dbp,
                                    void* dbias, void* dlam, long long ws_bytes,
                                    int B, int H, int W, int C, int h, int win,
                                    int groups, int res, int is_bf16, float eps,
                                    void* stream) {
  const AttnBwdProblem p =
      problem(x, g, lns, lnb, wqkv, bqkv, wp, bias, mask, lam, dx, dln, dwqkv,
              dbqkv, dwp, dbp, dbias, dlam, B, H, W, C, h, win, groups, res, eps);
  cudaError_t err = is_bf16
                        ? attn_bwd_run<bf16_t>(p, ws, ws_bytes, (cudaStream_t)stream)
                        : attn_bwd_run<float>(p, ws, ws_bytes, (cudaStream_t)stream);
  if (err == cudaSuccess) err = cudaGetLastError();
  return (int)err;
}
