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
// What bounds it on the H100: at the encoder's shapes (d = 28, 192 tokens a
// group) the bytes of the row tensors between its eleven products, and the
// six per-group products of the 192-token attention core.
// What the design does about it: K6's plan (attention_bwd.cuh's
// attn_bwd_run). The band regroup is the forward's gather (RowMap mode 2),
// its inverse a scatter of dy (no LayerNorm, no residual); the qkv recompute
// runs on gemm.cuh's GEMM, dout = gw Wp^T, dWp, dWqkv and dxw on
// bwd_gemm.cuh's NT / TN GEMMs (weight gradients as fp32 chunk partials
// reduced in a fixed order). In bf16 the per-group part is the tensor-core
// core of attention_core_bwd.cuh at (192, 192, d <= 32): three 64-row query
// blocks, og = p v over all 192 keys, the 64 x 64 shift mask repeated over
// the 3 x 3 band pairs as it is read, so that no [G, h, 192, 192] tensor
// crosses device memory; fp32 keeps the CUDA-core attn_bwd_kernel with its
// p and dl in scratch. No float atomics: a second launch gives equal bits.

#include "attention_bwd.cuh"

using namespace fairm;

static AttnBwdProblem problem(const void* y, const void* g, const void* wqkv,
                              const void* bqkv, const void* wp,
                              const void* wqkvn, const void* wpn,
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
  p.wqkvn = wqkvn;
  p.wpn = wpn;
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

// bytes of workspace fairm_freq_inter_bwd needs (-1 if the shape is refused)
extern "C" long long fairm_freq_inter_bwd_ws(int LB, int H, int W, int C, int h,
                                             int win, int L, int is_bf16) {
  const AttnBwdProblem p =
      problem(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
              nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
              nullptr, LB, H, W, C, h, win, L);
  return is_bf16 ? attn_bwd_ws_bytes<bf16_t>(p) : attn_bwd_ws_bytes<float>(p);
}

// wqkv [3C, kpad(C)] and wp [C, kpad(C)]: the forward's operands (q
// unscaled); wqkvn [C, kpad(3C)] and wpn [C, kpad(C)]: Wqkv and Wp as they
// are, the B operands of dqkv Wqkv^T and gw Wp^T
extern "C" int fairm_freq_inter_bwd(const void* y, const void* g,
                                    const void* wqkv, const void* bqkv,
                                    const void* wp, const void* wqkvn,
                                    const void* wpn, const void* bias,
                                    const void* mask, void* ws, void* dy,
                                    void* dwqkv, void* dbqkv, void* dwp,
                                    void* dbp, void* dbias, long long ws_bytes,
                                    int LB, int H, int W, int C, int h, int win,
                                    int L, int is_bf16, void* stream) {
  const AttnBwdProblem p =
      problem(y, g, wqkv, bqkv, wp, wqkvn, wpn, bias, mask, dy, dwqkv, dbqkv,
              dwp, dbp, dbias, LB, H, W, C, h, win, L);
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = is_bf16 ? attn_bwd_run<bf16_t>(p, ws, ws_bytes, st)
                            : attn_bwd_run<float>(p, ws, ws_bytes, st);
  if (err == cudaSuccess) err = cudaGetLastError();
  return (int)err;
}
