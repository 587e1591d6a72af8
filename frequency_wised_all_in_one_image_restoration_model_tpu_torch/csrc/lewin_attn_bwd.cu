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
// What the design does about it:
//  - the four products over the rows other than the recompute run through
//    bwd_gemm.cuh, as K7's do: in bf16 the cp.async / ldmatrix / mma.sync
//    NT and TN GEMMs (the weight gradients as fp32 chunk partials reduced in
//    a fixed order), in fp32 its register-tiled FMA GEMM with float4 loads;
//    the recompute stays on gemm.cuh's mma.sync GEMM;
//  - in bf16 at n = 64, d <= 64 (d a multiple of 4), the per-window part is
//    the tensor-core core of attention_core_bwd.cuh: six products on
//    mma.sync, p and dl never leaving the SM, dbias and dlam as chunk and
//    window partials summed in a fixed order; no [G, h, n, n] tensor
//    crosses device memory;
//  - fp32 (full precision, no TF32) and other shapes keep attention_bwd.cuh's
//    CUDA-core attn_bwd_kernel (p and dl to scratch for the bias gradient).
// out and dqkv are stored with rows of a multiple of 8 elements (16 bytes)
// for the GEMMs; dqkv's pad columns are zeroed, because dqkv Wqkv^T sums
// over them. No float atomics: a second launch gives equal bits.

#include "attention_bwd.cuh"
#include "attention_core_bwd.cuh"
#include "bwd_gemm.cuh"

using namespace fairm;

namespace {

int round8(int x) { return (x + 7) / 8 * 8; }

// X[m, c0 .. ld) = 0 for the M rows: dqkv's pad columns, which dqkv Wqkv^T
// sums over (a 2-D memset of a few bytes a row is far slower)
template <typename T>
__global__ void zero_pad_kernel(T* X, long long ld, int c0, long long M) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int w = (int)(ld - c0);
  if (idx >= M * w) return;
  const long long m = idx / w;
  X[m * ld + c0 + (idx - m * w)] = from_f<T>(0.f);
}

template <typename T>
struct K6Buffers {
  T *xw, *qkv, *gw, *out, *dqkv;
  float *dout, *dxw, *P, *DL, *dlam_part, *part;
};

// the problem's sizes, and the core's arguments where it runs
struct K6 {
  AttnBwdProblem p;
  long long M, G;
  int C, h, d, n, nW, ld, ldo, ld3;
  bool core;
  CoreBwdArgs c;
};

template <typename T>
cudaError_t k6_setup(K6& k, const AttnBwdProblem& p) {
  k.p = p;
  k.C = p.C;
  k.h = p.h;
  k.d = p.C / p.h;
  k.n = p.win * p.win;
  k.nW = (p.H / p.win) * (p.W / p.win);
  k.M = (long long)p.images * p.H * p.W;
  k.G = k.M / k.n;
  k.ld = kpad(p.C);
  k.ldo = round8(p.C);
  k.ld3 = round8(3 * p.C);
  k.core = std::is_same<T, bf16_t>::value && core_covers(k.n, k.n, k.d, true);
  k.c = CoreBwdArgs{};
  if (!k.core) return cudaSuccess;
  k.c.W = k.G;
  k.c.h = k.h;
  k.c.d = k.d;
  k.c.nW = k.nW;
  k.c.groups = p.bias_groups;
  k.c.scale = 1.f / sqrtf((float)k.d);
  return core_dispatch<true>(k.n, k.n, k.d, [&](auto shape) {
    return core_chunking<decltype(shape)>(k.c, k.G / p.bias_groups);
  });
}

template <typename T>
K6Buffers<T> k6_buffers(Workspace& ws, const K6& k) {
  const long long M = k.M;
  K6Buffers<T> b{};
  b.xw = ws.take<T>(M * k.ld);
  b.qkv = ws.take<T>(M * 3 * k.C);
  b.gw = ws.take<T>(M * k.ld);
  b.out = ws.take<T>(M * k.ldo);
  b.dqkv = ws.take<T>(M * k.ld3);
  b.dout = ws.take<float>(M * k.C);
  b.dxw = ws.take<float>(M * k.C);
  if (!k.core) {
    b.P = ws.take<float>(k.G * k.h * k.n * k.n);
    b.DL = ws.take<float>(k.G * k.h * k.n * k.n);
  }
  b.dlam_part = ws.take<float>(k.G * k.h);
  // the largest of the weight gradients' chunk partials, the column sums',
  // the LayerNorm backward's and the core's dbias partials
  long long part = chunk_count(M) * (long long)k.C * 3 * k.C;
  part = max_ll(part, ln_bwd_blocks(M) * 2LL * k.C);
  if (k.core)
    part = max_ll(part, (long long)k.c.groups * k.c.chunks * k.h * k.n * k.n);
  b.part = ws.take<float>(part);
  return b;
}

template <typename T>
cudaError_t k6_run(const AttnBwdProblem& p, const void* wqkvn, const void* wpn,
                   void* ws_base, long long ws_bytes, cudaStream_t st) {
  K6 k;
  cudaError_t err = k6_setup<T>(k, p);
  if (err != cudaSuccess) return err;
  Workspace ws{static_cast<unsigned char*>(ws_base), 0};
  const K6Buffers<T> b = k6_buffers<T>(ws, k);
  if ((long long)ws.off > ws_bytes) return cudaErrorInvalidValue;
  const long long M = k.M, G = k.G;
  const int C = k.C, h = k.h, n = k.n, ld = k.ld;
  const RowMap map{1, p.H, p.W, p.win, p.images, 1, 0};

  // recompute: xw = gather(LN x), qkv = xw Wqkv + bqkv
  launch_prep<T>(p.x, C, map, M, p.lns, p.lnb, p.eps, b.xw, st);
  GemmArgs g1{};
  g1.A = b.xw;
  g1.Wt = p.wqkv;
  g1.lda = ld;
  g1.bias = p.bqkv;
  g1.hw = (long long)p.H * p.W;
  g1.C = b.qkv;
  g1.cmap = identity_map();
  g1.M = M;
  g1.N = 3 * C;
  if ((err = launch_gemm<T>(g1, st)) != cudaSuccess) return err;

  // gw = gather(g); dbp = sum gw; dout = gw Wp^T
  launch_prep<T>(p.g, C, map, M, nullptr, nullptr, 0.f, b.gw, st);
  column_sums<T>(b.gw, 0, ld, M, C, b.part, p.dbp, st);
  err = gemm_nt<T>(b.gw, ld, wpn, ld, b.dout, C, M, C, ld, nullptr, nullptr, 0, st);
  if (err != cudaSuccess) return err;

  // the per-window part: out, dqkv, dbias and the dlam partials
  if (k.ld3 > 3 * C) {
    const long long pads = M * (k.ld3 - 3 * C);
    zero_pad_kernel<T><<<(unsigned)((pads + 255) / 256), 256, 0, st>>>(
        b.dqkv, k.ld3, 3 * C, M);
  }
  if (k.core) {
    CoreBwdArgs c = k.c;
    const bf16_t* qkv = reinterpret_cast<const bf16_t*>(b.qkv);
    bf16_t* dqkv = reinterpret_cast<bf16_t*>(b.dqkv);
    c.q = qkv;
    c.k = qkv + C;
    c.v = qkv + 2 * C;
    c.g = b.dout;
    c.dq = dqkv;
    c.dk = dqkv + C;
    c.dv = dqkv + 2 * C;
    c.out = reinterpret_cast<bf16_t*>(b.out);
    c.vq = c.vkv = CoreView{(long long)n * 3 * C, k.d, 3 * C};
    c.vg = CoreView{(long long)n * C, k.d, C};
    c.vdq = c.vdkv = CoreView{(long long)n * k.ld3, k.d, k.ld3};
    c.vout = CoreView{(long long)n * k.ldo, k.d, k.ldo};
    c.bias = p.bias;
    c.mask = p.mask;
    c.lam = p.lam;
    c.part = b.part;
    c.dlam_part = b.dlam_part;
    err = core_dispatch<true>(n, n, k.d, [&](auto shape) {
      return core_launch<decltype(shape)>(c, p.dbias, st);
    });
    if (err != cudaSuccess) return err;
  } else {
    AttnBwdArgs at{};
    at.qkv = b.qkv;
    at.dout = b.dout;
    at.out = b.out;
    at.dqkv = b.dqkv;
    at.P = b.P;
    at.DL = b.DL;
    at.dlam_part = p.lam ? b.dlam_part : nullptr;
    at.bias = p.bias;
    at.mask = p.mask;
    at.lam = p.lam;
    at.n = n;
    at.n0 = n;
    at.d = k.d;
    at.C = C;
    at.ldo = k.ldo;
    at.ld3 = k.ld3;
    at.h = h;
    at.nW = k.nW;
    at.imgs_per_bias = p.images / p.bias_groups;
    at.scale = 1.f / sqrtf((float)k.d);
    const size_t smem = attn_bwd_smem_bytes(n, k.d, p.lam != nullptr);
    if (smem > 227 * 1024) return cudaErrorInvalidValue;  // window too large
    err = cudaFuncSetAttribute(attn_bwd_kernel<T, true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
    attn_bwd_kernel<T, true><<<dim3((unsigned)G, (unsigned)h), ABNT, smem, st>>>(at);
    launch_reduce(b.DL, p.dbias, p.bias_groups, G / p.bias_groups,
                  (long long)h * n * n, st);
  }
  if (p.lam) launch_reduce(b.dlam_part, p.dlam, p.images, k.nW, h, st);

  // dWp = out^T gw; dWqkv = xw^T dqkv; dbqkv = sum dqkv; dxw = dqkv Wqkv^T
  err = weight_grad_tn<T>(b.out, k.ldo, b.gw, ld, M, C, C, b.part, p.dwp, st);
  if (err != cudaSuccess) return err;
  err = weight_grad_tn<T>(b.xw, ld, b.dqkv, k.ld3, M, C, 3 * C, b.part, p.dwqkv, st);
  if (err != cudaSuccess) return err;
  column_sums<T>(b.dqkv, 0, k.ld3, M, 3 * C, b.part, p.dbqkv, st);
  err = gemm_nt<T>(b.dqkv, k.ld3, wqkvn, kpad(3 * C), b.dxw, C, M, C, k.ld3,
                   nullptr, nullptr, 0, st);
  if (err != cudaSuccess) return err;

  // dx = scatter(LN backward of dxw) [+ g]
  return launch_ln_bwd<T>(p.x, p.g, b.dxw, p.lns, map, M, C, p.eps, p.res, p.dx,
                          b.part, p.dln, st);
}

template <typename T>
long long k6_ws_bytes(const AttnBwdProblem& p) {
  K6 k;
  if (k6_setup<T>(k, p) != cudaSuccess) return -1;
  Workspace ws{nullptr, 0};
  k6_buffers<T>(ws, k);
  return (long long)ws.off + 256;
}

AttnBwdProblem problem(const void* x, const void* g, const void* lns,
                       const void* lnb, const void* wqkv, const void* bqkv,
                       const void* wp, const void* bias, const void* mask,
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
              nullptr, nullptr, nullptr, nullptr, B, H, W, C, h, win, groups, 0,
              0.f);
  return is_bf16 ? k6_ws_bytes<bf16_t>(p) : k6_ws_bytes<float>(p);
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
      problem(x, g, lns, lnb, wqkv, bqkv, wp, bias, mask, lam, dx, dln, dwqkv,
              dbqkv, dwp, dbp, dbias, dlam, B, H, W, C, h, win, groups, res, eps);
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = is_bf16 ? k6_run<bf16_t>(p, wqkvn, wpn, ws, ws_bytes, st)
                            : k6_run<float>(p, wqkvn, wpn, ws, ws_bytes, st);
  if (err == cudaSuccess) err = cudaGetLastError();
  return (int)err;
}
