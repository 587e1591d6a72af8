// K7: backward of the FFN half of a LeWin block (the backward of K2).
//
// Replaces the Pallas kernel _ffn_bwd_kernel (frequency_wised_all_in_one_
// image_restoration_model_tpu/ops/pallas/lewin_block_bwd.py, reached through
// ffn_block_bwd): given x and the gradient g of
//   out = x + gelu(dwconv3x3(gelu(LN2(x) W1 + b1)) + bd) W2 + b2
// it recomputes the forward intermediates and returns dx and the gradients
// of the LayerNorm, W1, b1, the depthwise taps, bd, W2 and b2:
//   xn  = LN2(x);  h1 = xn W1 + b1;  hc = dwconv(gelu(h1)) + bd;  a2 = gelu(hc)
//   db2 = sum g;  dhc = (g W2^T) gelu'(hc);  dW2 = a2^T g;  dbd = sum dhc
//   dwd[t] = sum gelu(h1)[shifted by tap t] dhc
//   dh1 = dwconv^T(dhc) gelu'(h1);  dW1 = xn^T dh1;  db1 = sum dh1
//   dx  = LN backward of (dh1 W1^T) + g
// with xn, a2, g, dh1 rounded to the compute type before each product and
// h1, hc, dhc, dh1 kept in fp32, as the Pallas body keeps them.
//
// What bounds it on the H100: the [M, 4C] hidden tensors, three of them in
// fp32 in device memory, and five products of M x C x 4C against the
// forward's two, on the CUDA cores here (bwd.cuh).
// What the design does about it: the Pallas body recomputes a halo of rows
// for the 3x3 conv inside each tile; with the hidden rows in device memory
// no halo is needed, the transposed conv reads its neighbours with zero
// padding. The weight gradients are chunk partials and a fixed-order
// reduction, so the result does not change from run to run.

#include "bwd.cuh"

using namespace fairm;

// hc = dwconv3x3(gelu(h1)) + bd in fp32, a2 = gelu(hc) in the compute type
template <typename T>
__global__ void conv_fwd_kernel(const float* h1, const float* wd,
                                const float* bd, float* hc, T* a2, long long M,
                                int H, int W, int Hd) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= M * Hd) return;
  const long long m = idx / Hd;
  const int ch = (int)(idx - m * Hd);
  const int x = (int)(m % W), y = (int)((m / W) % H);
  float acc = 0.f;
#pragma unroll
  for (int dy = 0; dy < 3; ++dy) {
    const int yy = y + dy - 1;
    if (yy < 0 || yy >= H) continue;
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) {
      const int xx = x + dx - 1;
      if (xx < 0 || xx >= W) continue;
      const long long mm = m + (long long)(dy - 1) * W + (dx - 1);
      acc = fmaf(wd[(dy * 3 + dx) * Hd + ch], gelu_tanh(h1[mm * Hd + ch]), acc);
    }
  }
  acc += bd[ch];
  hc[idx] = acc;
  a2[idx] = from_f<T>(gelu_tanh(acc));
}

// part[z, t, ch] = sum over the pixels m of chunk z of
// gelu(h1)[m shifted by tap t, ch] dhc[m, ch]. A block is 32 channels x 8
// pixel lanes: lane s takes the chunk's pixels s, s + 8, ..., and the eight
// lanes' sums are added in lane order.
constexpr int DWD_CH = 32, DWD_LANES = 8;

static __global__ void __launch_bounds__(DWD_CH * DWD_LANES) dwd_kernel(
    const float* h1, const float* dhc, long long M, int H, int W, int Hd,
    long long rc, float* part) {
  __shared__ float sums[DWD_LANES][9][DWD_CH];
  const int cl = threadIdx.x % DWD_CH, sub = threadIdx.x / DWD_CH;
  const int ch = blockIdx.x * DWD_CH + cl;
  const long long lo = (long long)blockIdx.y * rc;
  long long hi = lo + rc;
  if (hi > M) hi = M;
  float acc[9];
#pragma unroll
  for (int t = 0; t < 9; ++t) acc[t] = 0.f;
  if (ch < Hd) {
    for (long long m = lo + sub; m < hi; m += DWD_LANES) {
      const int x = (int)(m % W), y = (int)((m / W) % H);
      const float dv = dhc[m * Hd + ch];
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
        const int yy = y + dy - 1;
        if (yy < 0 || yy >= H) continue;
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          const int xx = x + dx - 1;
          if (xx < 0 || xx >= W) continue;
          const long long mm = m + (long long)(dy - 1) * W + (dx - 1);
          acc[dy * 3 + dx] =
              fmaf(gelu_tanh(h1[mm * Hd + ch]), dv, acc[dy * 3 + dx]);
        }
      }
    }
  }
#pragma unroll
  for (int t = 0; t < 9; ++t) sums[sub][t][cl] = acc[t];
  __syncthreads();
  for (int e = threadIdx.x; e < 9 * DWD_CH; e += DWD_CH * DWD_LANES) {
    const int t = e / DWD_CH, c = e % DWD_CH;
    if (blockIdx.x * DWD_CH + c >= Hd) continue;
    float v = 0.f;
    for (int s2 = 0; s2 < DWD_LANES; ++s2) v += sums[s2][t][c];
    part[((long long)blockIdx.y * 9 + t) * Hd + blockIdx.x * DWD_CH + c] = v;
  }
}

// dh1 = dwconv^T(dhc) gelu'(h1): the transposed depthwise pass, zero padding
static __global__ void conv_bwd_kernel(const float* h1, const float* dhc,
                                       const float* wd, float* dh1, long long M,
                                       int H, int W, int Hd) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= M * Hd) return;
  const long long m = idx / Hd;
  const int ch = (int)(idx - m * Hd);
  const int x = (int)(m % W), y = (int)((m / W) % H);
  float acc = 0.f;
#pragma unroll
  for (int dy = 0; dy < 3; ++dy) {
    const int yy = y - dy + 1;
    if (yy < 0 || yy >= H) continue;
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) {
      const int xx = x - dx + 1;
      if (xx < 0 || xx >= W) continue;
      const long long mm = m + (long long)(1 - dy) * W + (1 - dx);
      acc = fmaf(wd[(dy * 3 + dx) * Hd + ch], dhc[mm * Hd + ch], acc);
    }
  }
  dh1[idx] = acc * gelu_tanh_grad(h1[idx]);
}

template <typename T>
struct FfnBwdBuffers {
  T *xn, *a2;
  float *h1, *hc, *dhc, *dxn, *part;
};

static long long max_ll(long long a, long long b) { return a > b ? a : b; }

template <typename T>
static FfnBwdBuffers<T> ffn_bwd_buffers(Workspace& ws, long long M, int C, int Hd) {
  FfnBwdBuffers<T> b;
  b.xn = ws.take<T>(M * kpad(C));
  b.a2 = ws.take<T>(M * Hd);
  b.h1 = ws.take<float>(M * Hd);
  b.hc = ws.take<float>(M * Hd);  // then dh1
  b.dhc = ws.take<float>(M * Hd);
  b.dxn = ws.take<float>(M * C);
  long long part = chunk_count(M) * (long long)C * Hd;
  part = max_ll(part, chunk_count(M) * 9LL * Hd);
  part = max_ll(part, ln_bwd_blocks(M) * 2LL * C);
  b.part = ws.take<float>(part);
  return b;
}

template <typename T>
static cudaError_t lewin_ffn_bwd(const void* x, const void* g, const float* lns,
                                 const float* lnb, const void* w1t,
                                 const float* b1, const float* wd,
                                 const float* bd, const void* w2t, void* ws_base,
                                 long long ws_bytes, void* dx, float* dln,
                                 float* dw1, float* db1, float* dwd, float* dbd,
                                 float* dw2, float* db2, int B, int H, int W,
                                 int C, int Hd, float eps, cudaStream_t st) {
  const long long M = (long long)B * H * W;
  Workspace ws{static_cast<unsigned char*>(ws_base), 0};
  const FfnBwdBuffers<T> b = ffn_bwd_buffers<T>(ws, M, C, Hd);
  if ((long long)ws.off > ws_bytes) return cudaErrorInvalidValue;
  const int ldc = kpad(C), ldh = kpad(Hd);
  const unsigned eblocks = (unsigned)((M * Hd + 255) / 256);

  // recompute: xn = LN2(x), h1 = xn W1 + b1, hc, a2
  launch_prep<T>(x, C, identity_map(), M, lns, lnb, eps, b.xn, st);
  BGemmArgs g1{};
  g1.A = b.xn;
  g1.sam = ldc;
  g1.sak = 1;
  g1.B = w1t;  // [Hd, kpad(C)]: B(k = c, n = j) = w1t[j, c]
  g1.sbk = 1;
  g1.sbn = ldc;
  g1.C = b.h1;
  g1.M = M;
  g1.N = Hd;
  g1.K = C;
  g1.bias = b1;
  launch_bgemm<T>(g1, st);
  conv_fwd_kernel<T><<<eblocks, 256, 0, st>>>(b.h1, wd, bd, b.hc, b.a2, M, H, W, Hd);

  // db2 = sum g; dhc = (g W2^T) gelu'(hc); dW2 = a2^T g; dbd = sum dhc
  column_sums<T>(g, 0, C, M, C, b.part, db2, st);
  BGemmArgs g2{};
  g2.A = g;
  g2.sam = C;
  g2.sak = 1;
  g2.B = w2t;  // [C, kpad(Hd)]: B(k = c, n = j) = w2t[c, j]
  g2.sbk = ldh;
  g2.sbn = 1;
  g2.C = b.dhc;
  g2.M = M;
  g2.N = Hd;
  g2.K = C;
  g2.aux = b.hc;
  launch_bgemm<T>(g2, st);
  weight_grad<T>(b.a2, Hd, 0, g, C, 0, M, Hd, C, b.part, dw2, st);
  column_sums<T>(b.dhc, 1, Hd, M, Hd, b.part, dbd, st);

  // dwd
  {
    const long long rc = chunk_rows(M), S = chunk_count(M);
    const dim3 grid((unsigned)((Hd + DWD_CH - 1) / DWD_CH), (unsigned)S);
    dwd_kernel<<<grid, DWD_CH * DWD_LANES, 0, st>>>(b.h1, b.dhc, M, H, W, Hd,
                                                    rc, b.part);
    launch_reduce(b.part, dwd, 1, S, 9LL * Hd, st);
  }

  // dh1 (over hc, which is spent); dW1 = xn^T dh1; db1 = sum dh1
  float* dh1 = b.hc;
  conv_bwd_kernel<<<eblocks, 256, 0, st>>>(b.h1, b.dhc, wd, dh1, M, H, W, Hd);
  weight_grad<T>(b.xn, ldc, 0, dh1, Hd, 1, M, C, Hd, b.part, dw1, st);
  column_sums<T>(dh1, 1, Hd, M, Hd, b.part, db1, st);

  // dxn = dh1 W1^T; dx = LN backward of dxn + g
  BGemmArgs g3{};
  g3.A = dh1;
  g3.a_f32 = 1;
  g3.sam = Hd;
  g3.sak = 1;
  g3.B = w1t;  // B(k = j, n = c) = w1t[j, c]
  g3.sbk = ldc;
  g3.sbn = 1;
  g3.C = b.dxn;
  g3.M = M;
  g3.N = C;
  g3.K = Hd;
  launch_bgemm<T>(g3, st);
  return launch_ln_bwd<T>(x, g, b.dxn, lns, identity_map(), M, C, eps, 1, dx,
                          b.part, dln, st);
}

// bytes of workspace fairm_lewin_ffn_bwd needs
extern "C" long long fairm_lewin_ffn_bwd_ws(int B, int H, int W, int C, int Hd,
                                            int is_bf16) {
  Workspace ws{nullptr, 0};
  const long long M = (long long)B * H * W;
  if (is_bf16)
    ffn_bwd_buffers<bf16_t>(ws, M, C, Hd);
  else
    ffn_bwd_buffers<float>(ws, M, C, Hd);
  return (long long)ws.off + 256;
}

extern "C" int fairm_lewin_ffn_bwd(const void* x, const void* g, const void* lns,
                                   const void* lnb, const void* w1t,
                                   const void* b1, const void* wd,
                                   const void* bd, const void* w2t, void* ws,
                                   void* dx, void* dln, void* dw1, void* db1,
                                   void* dwd, void* dbd, void* dw2, void* db2,
                                   long long ws_bytes, int B, int H, int W,
                                   int C, int Hd, int is_bf16, float eps,
                                   void* stream) {
  auto f = [&](auto tag) {
    using T = decltype(tag);
    return lewin_ffn_bwd<T>(x, g, (const float*)lns, (const float*)lnb, w1t,
                            (const float*)b1, (const float*)wd,
                            (const float*)bd, w2t, ws, ws_bytes, dx,
                            (float*)dln, (float*)dw1, (float*)db1, (float*)dwd,
                            (float*)dbd, (float*)dw2, (float*)db2, B, H, W, C,
                            Hd, eps, (cudaStream_t)stream);
  };
  cudaError_t err = is_bf16 ? f(bf16_t{}) : f(float{});
  if (err == cudaSuccess) err = cudaGetLastError();
  return (int)err;
}
