// K8: backward of the cross-band (inter) half of the frequency-MSA encoder
// block (the backward of K3), without the residual: the caller passes the
// gradient straight through to ``res``.
//
// Replaces the Pallas kernel _freq_inter_bwd_kernel (frequency_wised_all_in_
// one_image_restoration_model_tpu/ops/pallas/lewin_block_bwd.py, reached
// through freq_inter_bwd): given y and the gradient g of
//   out[l*B + b] = res[l*B + b] + proj(grouped_attn(y))
// where each window's L band copies form one group of L*n = 192 tokens, it
// returns dy and the gradients of the qkv and proj weights and of the grouped
// bias [h, L*n, L*n], summed over every window of every image.
//
// What bounds it on the H100: the 192-token attention core, six products of
// (L n)^2 d multiply-adds per window and head on the CUDA cores, and the
// [windows, h, 192, 192] matrices of p and dl in device memory.
// What the design does about it: the band regroup is the forward's gather
// (RowMap mode 2) into a dense matrix, its inverse a scatter of dy; the core
// and the fixed-order reductions are those of K6 (attention_bwd.cuh).

#include "attention_bwd.cuh"

using namespace fairm;

static AttnBwdProblem problem(const void* y, const void* g, const void* wqkv,
                              const void* bqkv, const void* wp,
                              const void* bias, const void* mask, void* dy,
                              void* dwqkv, void* dbqkv, void* dwp, void* dbp,
                              void* dbias, int LB, int H, int W, int C, int h,
                              int win, int L) {
  AttnBwdProblem p{};
  p.x = y;
  p.g = g;
  p.wqkv = wqkv;
  p.bqkv = (const float*)bqkv;
  p.wp = wp;
  p.bias = (const float*)bias;
  p.mask = (const float*)mask;
  p.dx = dy;
  p.dwqkv = (float*)dwqkv;
  p.dbqkv = (float*)dbqkv;
  p.dwp = (float*)dwp;
  p.dbp = (float*)dbp;
  p.dbias = (float*)dbias;
  p.images = LB;
  p.H = H;
  p.W = W;
  p.C = C;
  p.h = h;
  p.win = win;
  p.L = L;
  p.bias_groups = 1;
  return p;
}

// bytes of workspace fairm_freq_inter_bwd needs
extern "C" long long fairm_freq_inter_bwd_ws(int LB, int H, int W, int C, int h,
                                             int win, int L, int is_bf16) {
  const AttnBwdProblem p =
      problem(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
              nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, LB, H, W, C,
              h, win, L);
  return is_bf16 ? attn_bwd_ws_bytes<bf16_t>(p) : attn_bwd_ws_bytes<float>(p);
}

extern "C" int fairm_freq_inter_bwd(const void* y, const void* g,
                                    const void* wqkv, const void* bqkv,
                                    const void* wp, const void* bias,
                                    const void* mask, void* ws, void* dy,
                                    void* dwqkv, void* dbqkv, void* dwp,
                                    void* dbp, void* dbias, long long ws_bytes,
                                    int LB, int H, int W, int C, int h, int win,
                                    int L, int is_bf16, void* stream) {
  const AttnBwdProblem p = problem(y, g, wqkv, bqkv, wp, bias, mask, dy, dwqkv,
                                   dbqkv, dwp, dbp, dbias, LB, H, W, C, h, win, L);
  cudaError_t err = is_bf16
                        ? attn_bwd_run<bf16_t>(p, ws, ws_bytes, (cudaStream_t)stream)
                        : attn_bwd_run<float>(p, ws, ws_bytes, (cudaStream_t)stream);
  if (err == cudaSuccess) err = cudaGetLastError();
  return (int)err;
}
