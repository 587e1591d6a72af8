// Backward of the window attention blocks, shared by K6 (lewin_attn_bwd.cu:
// the LeWin attention half and the per-band intra attention) and K8
// (freq_inter_bwd.cu: the cross-band inter attention).
//
// For a block  out = [x +] proj(attn(qkv([LN] gather(x))))  and the gradient g
// of out, in the order of the Pallas bodies _attn_bwd_kernel and
// _freq_inter_bwd_kernel:
//   xw   = gather([LN] x)                 rows by window (or band-grouped)
//   qkv  = xw Wqkv + bqkv                 rounded to the compute type
//   gw   = gather(g);  dbp = sum gw;  dout = gw Wp^T
//   per group and head (attn_bwd_kernel):
//     p = softmax(scale q k^T + bias + mask), og = p v,
//     [all_DC: out = (1 + lam) og - lam/n sum v, dog = (1 + lam) dout,
//      dlam += sum dout (og - sum v / n), dv += -lam/n sum dout]
//     dp = dog v^T, dv = p^T dog, dl = p (dp - sum(dp p)),
//     dq = scale dl k, dk = scale dl^T q, and dl is kept for dbias
//   dWp = out^T gw;  dWqkv = xw^T dqkv;  dbqkv = sum dqkv;  dxw = dqkv Wqkv^T
//   dx  = scatter(LN backward of dxw) [+ g];  dbias = sum of dl over windows
// with p, dog, dl, dq, dk, dv, out rounded to the compute type before each
// product, as the Pallas bodies round them.
//
// The attention core runs on the CUDA cores in fp32 for both compute types
// (bf16 operands are exact in fp32, so the result is that of a bf16 product
// with fp32 accumulation). One block per (group, head): a row pass with one
// warp per query row (softmax, dp, dl, og, dq), which also writes p and dl of
// the group to scratch, then a column pass with one thread per (key, 8
// channels) for dk and dv. The sums over windows (dbias, dlam) are fixed-order
// reductions of per-window partials (bwd.cuh).

#pragma once

#include <math.h>

#include "bwd.cuh"

namespace fairm {

struct AttnBwdArgs {
  const void* qkv;     // [G * n, 3C] compute type: q | k | v, q unscaled
  const float* dout;   // [G * n, C]: the gradient of the attention rows
  void* out;           // [G * n, C] compute type: the attention rows again
  void* dqkv;          // [G * n, 3C] compute type
  float* P;            // [G, h, n, n]
  float* DL;           // [G, h, n, n]: the gradient of the logits
  float* dlam_part;    // [G, h], or null without lam
  const float* bias;   // [bias groups, h, n, n]
  const float* mask;   // [nW, n0, n0] additive, or null
  const float* lam;    // [B, h], or null
  int n, n0, d, C, h;
  int nW;              // group g is window g % nW of image g / nW
  int imgs_per_bias;
  float scale;         // d^-0.5
  int ldo, ld3;        // PADDED: row strides of out and dqkv (>= C, 3C)
};

constexpr int ABNT = 256;

// q, k, v, dog (and dout as it came, with lam) of the group, a row of p and
// of dl per warp, the column sums of v and dout, the warps' lam partials
inline size_t attn_bwd_smem_bytes(int n, int d, bool lam) {
  return sizeof(float) * ((size_t)(lam ? 5 : 4) * n * (d + 1) +
                          2 * (ABNT / 32) * (size_t)n + 2 * d + ABNT / 32);
}

// PADDED (K6): out and dqkv rows of ldo / ld3 elements; else (K8) C / 3C
template <typename T, bool PADDED>
__global__ void __launch_bounds__(ABNT) attn_bwd_kernel(const AttnBwdArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sm = reinterpret_cast<float*>(smem_raw);
  const int n = a.n, d = a.d, ld = d + 1;  // odd or even, rows spread over banks
  float* q = sm;
  float* k = q + n * ld;
  float* v = k + n * ld;
  float* dg = v + n * ld;    // dog rounded to the compute type
  float* dor = dg + n * ld;  // dout as it came: only with lam
  float* prow = dor + (a.lam ? n * ld : 0);
  float* dlrow = prow + (ABNT / 32) * n;
  float* vsum = dlrow + (ABNT / 32) * n;
  float* dosum = vsum + d;
  float* red = dosum + d;

  const long long g = blockIdx.x;
  const int hh = blockIdx.y;
  const long long b = g / a.nW;
  const int wi = (int)(g - b * a.nW);
  const float lam = a.lam ? a.lam[b * a.h + hh] : 0.f;

  const T* src = static_cast<const T*>(a.qkv) + g * n * 3LL * a.C + hh * d;
  const float* dsrc = a.dout + g * (long long)n * a.C + hh * d;
  for (int e = threadIdx.x; e < n * d; e += ABNT) {
    const int i = e / d, c = e - i * d;
    const T* row = src + (long long)i * 3 * a.C + c;
    q[i * ld + c] = to_f(row[0]);
    k[i * ld + c] = to_f(row[a.C]);
    v[i * ld + c] = to_f(row[2 * a.C]);
    const float dv_ = dsrc[(long long)i * a.C + c];
    if (a.lam) dor[i * ld + c] = dv_;
    dg[i * ld + c] = rt<T>((1.f + lam) * dv_);
  }
  __syncthreads();
  if (a.lam) {
    for (int c = threadIdx.x; c < d; c += ABNT) {
      float s = 0.f, t = 0.f;
      for (int j = 0; j < n; ++j) {
        s += v[j * ld + c];
        t += dor[j * ld + c];
      }
      vsum[c] = s;
      dosum[c] = t;
    }
    __syncthreads();
  }

  const float* bias =
      a.bias + ((b / a.imgs_per_bias) * a.h + hh) * (long long)n * n;
  const float* mask = a.mask ? a.mask + (long long)wi * a.n0 * a.n0 : nullptr;
  float* P = a.P + (g * a.h + hh) * (long long)n * n;
  float* DL = a.DL + (g * a.h + hh) * (long long)n * n;
  T* out;
  T* dq_out;
  if constexpr (PADDED) {
    out = static_cast<T*>(a.out) + g * (long long)n * a.ldo + hh * d;
    dq_out = static_cast<T*>(a.dqkv) + g * (long long)n * a.ld3 + hh * d;
  } else {
    out = static_cast<T*>(a.out) + g * (long long)n * a.C + hh * d;
    dq_out = static_cast<T*>(a.dqkv) + g * (long long)n * 3 * a.C + hh * d;
  }

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* p = prow + warp * n;
  float* dl = dlrow + warp * n;
  float clam = 0.f;
  for (int i = warp; i < n; i += ABNT / 32) {
    const float* qi = q + i * ld;
    const float* dgi = dg + i * ld;
    float mx = -INFINITY;
    for (int j = lane; j < n; j += 32) {
      const float* kj = k + j * ld;
      float s = 0.f;
      for (int c = 0; c < d; ++c) s = fmaf(qi[c], kj[c], s);
      s = s * a.scale + bias[i * n + j];
      if (mask) s += mask[(i % a.n0) * a.n0 + (j % a.n0)];
      p[j] = s;
      mx = fmaxf(mx, s);
    }
    mx = warp_max(mx);
    float sum = 0.f;
    for (int j = lane; j < n; j += 32) {
      const float e = expf(p[j] - mx);
      p[j] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    float delta = 0.f;
    for (int j = lane; j < n; j += 32) {
      const float pj = p[j] / sum;
      const float* vj = v + j * ld;
      float dp = 0.f;
      for (int c = 0; c < d; ++c) dp = fmaf(dgi[c], vj[c], dp);
      p[j] = pj;
      dl[j] = dp;
      delta += dp * pj;
    }
    delta = warp_sum(delta);
    for (int j = lane; j < n; j += 32) {
      const float pj = p[j];
      const float dlj = pj * (dl[j] - delta);
      P[i * n + j] = pj;
      DL[i * n + j] = dlj;
      p[j] = rt<T>(pj);
      dl[j] = rt<T>(dlj);
    }
    __syncwarp();
    for (int c = lane; c < d; c += 32) {
      float og = 0.f, dq = 0.f;
      for (int j = 0; j < n; ++j) {
        og = fmaf(p[j], v[j * ld + c], og);
        dq = fmaf(dl[j], k[j * ld + c], dq);
      }
      float o = og;
      if (a.lam) {
        o = (1.f + lam) * og - (lam / n) * vsum[c];
        clam += dor[i * ld + c] * (og - vsum[c] / n);
      }
      if constexpr (PADDED) {
        out[(long long)i * a.ldo + c] = from_f<T>(o);
        dq_out[(long long)i * a.ld3 + c] = from_f<T>(dq * a.scale);
      } else {
        out[(long long)i * a.C + c] = from_f<T>(o);
        dq_out[(long long)i * 3 * a.C + c] = from_f<T>(dq * a.scale);
      }
    }
    __syncwarp();
  }
  clam = warp_sum(clam);
  if (lane == 0) red[warp] = clam;
  // also orders this block's P and DL writes before the column pass
  __syncthreads();
  if (a.dlam_part && threadIdx.x == 0) {
    float s = 0.f;
    for (int w = 0; w < ABNT / 32; ++w) s += red[w];
    a.dlam_part[g * a.h + hh] = s;
  }

  // dk = scale dl^T q and dv = p^T dog: key j, channels c0 .. c0 + 7
  const int nch = (d + 7) / 8;
  T* dk_out = dq_out + a.C;
  T* dv_out = dq_out + 2 * a.C;
  for (int item = threadIdx.x; item < n * nch; item += ABNT) {
    const int j = item % n, c0 = (item / n) * 8;
    float av[8], ak[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) av[u] = ak[u] = 0.f;
    for (int i = 0; i < n; ++i) {
      const float pj = rt<T>(P[i * n + j]);
      const float dlj = rt<T>(DL[i * n + j]);
      const float* dgi = dg + i * ld + c0;
      const float* qi = q + i * ld + c0;
#pragma unroll
      for (int u = 0; u < 8; ++u)
        if (c0 + u < d) {
          av[u] = fmaf(pj, dgi[u], av[u]);
          ak[u] = fmaf(dlj, qi[u], ak[u]);
        }
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int c = c0 + u;
      if (c >= d) continue;
      float dv = av[u];
      if (a.lam) dv += (-lam / n) * dosum[c];
      if constexpr (PADDED) {
        dk_out[(long long)j * a.ld3 + c] = from_f<T>(ak[u] * a.scale);
        dv_out[(long long)j * a.ld3 + c] = from_f<T>(dv);
      } else {
        dk_out[(long long)j * 3 * a.C + c] = from_f<T>(ak[u] * a.scale);
        dv_out[(long long)j * 3 * a.C + c] = from_f<T>(dv);
      }
    }
  }
}

// dy[map(r), :] = dz[r, :] rounded to the compute type (K8: no LayerNorm)
template <typename T>
__global__ void scatter_rows_kernel(const float* dz, RowMap map, long long M,
                                    int C, T* dy) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= M * C) return;
  const long long r = idx / C;
  const int c = (int)(idx - r * C);
  dy[map_row(map, r) * C + c] = from_f<T>(dz[idx]);
}

struct AttnBwdProblem {
  const void* x;        // [images, H, W, C]: the block's input (K8: y)
  const void* g;        // gradient of the block's output, same layout
  const float *lns, *lnb;  // LayerNorm, or null (K8)
  const void* wqkv;     // [3C, kpad(C)], q unscaled
  const float* bqkv;    // [3C]
  const void* wp;       // [C, kpad(C)]: wp[j, c] = Wp[c, j]
  const float* bias;
  const float* mask;
  const float* lam;
  void* dx;             // [images, H, W, C]
  float* dln;           // [2, C]: dlns, dlnb (with LayerNorm)
  float* dwqkv;         // [C, 3C]
  float* dbqkv;         // [3C]
  float* dwp;           // [C, C]
  float* dbp;           // [C]
  float* dbias;         // [bias groups, h, n, n]
  float* dlam;          // [images, h], with lam
  int images, H, W, C, h, win;
  int L;                // 1, or the bands grouped into one window (K8)
  int bias_groups;
  int res;              // dx += g (the residual of the LeWin attention half)
  float eps;
};

template <typename T>
struct AttnBwdBuffers {
  T *xw, *qkv, *gw, *out, *dqkv;
  float *dout, *dxw, *P, *DL, *dlam_part, *part;
};

inline long long max_ll(long long a, long long b) { return a > b ? a : b; }

template <typename T>
inline AttnBwdBuffers<T> attn_bwd_buffers(Workspace& ws, const AttnBwdProblem& p) {
  const long long M = (long long)p.images * p.H * p.W;
  const int C = p.C, n = p.L * p.win * p.win;
  const long long G = M / n;
  AttnBwdBuffers<T> b;
  b.xw = ws.take<T>(M * kpad(C));
  b.qkv = ws.take<T>(M * 3 * C);
  b.gw = ws.take<T>(M * kpad(C));
  b.out = ws.take<T>(M * C);
  b.dqkv = ws.take<T>(M * 3 * C);
  b.dout = ws.take<float>(M * C);
  b.dxw = ws.take<float>(M * C);
  b.P = ws.take<float>(G * p.h * n * n);
  b.DL = ws.take<float>(G * p.h * n * n);
  b.dlam_part = ws.take<float>(G * p.h);
  // the chunk partials of the largest reduction
  long long part = chunk_count(M) * (long long)C * 3 * C;
  part = max_ll(part, ln_bwd_blocks(M) * 2LL * C);
  b.part = ws.take<float>(part);
  return b;
}

template <typename T>
inline cudaError_t attn_bwd_run(const AttnBwdProblem& p, void* ws_base,
                                long long ws_bytes, cudaStream_t st) {
  Workspace ws{static_cast<unsigned char*>(ws_base), 0};
  const AttnBwdBuffers<T> b = attn_bwd_buffers<T>(ws, p);
  if ((long long)ws.off > ws_bytes) return cudaErrorInvalidValue;

  const int C = p.C, h = p.h, d = C / h, n0 = p.win * p.win, n = p.L * n0;
  const int nW = (p.H / p.win) * (p.W / p.win);
  const int B = p.images / p.L;  // images per band copy (K8), else all
  const long long M = (long long)p.images * p.H * p.W;
  const long long G = M / n;
  const RowMap map = p.L > 1 ? RowMap{2, p.H, p.W, p.win, B, p.L, 0}
                             : RowMap{1, p.H, p.W, p.win, p.images, 1, 0};
  const int ld = kpad(C);

  // recompute: xw = gather([LN] x), qkv = xw Wqkv + bqkv
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
  cudaError_t err = launch_gemm<T>(g1, st);
  if (err != cudaSuccess) return err;

  // gw = gather(g); dbp = sum gw; dout = gw Wp^T
  launch_prep<T>(p.g, C, map, M, nullptr, nullptr, 0.f, b.gw, st);
  column_sums<T>(b.gw, 0, ld, M, C, b.part, p.dbp, st);
  BGemmArgs g2{};
  g2.A = b.gw;
  g2.sam = ld;
  g2.sak = 1;
  g2.B = p.wp;
  g2.sbk = ld;
  g2.sbn = 1;
  g2.C = b.dout;
  g2.M = M;
  g2.N = C;
  g2.K = C;
  launch_bgemm<T>(g2, st);

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
  at.n0 = n0;
  at.d = d;
  at.C = C;
  at.h = h;
  at.nW = nW;
  at.imgs_per_bias = (p.L > 1 ? B : p.images) / p.bias_groups;
  at.scale = 1.f / sqrtf((float)d);
  const size_t smem = attn_bwd_smem_bytes(n, d, p.lam != nullptr);
  if (smem > 227 * 1024) return cudaErrorInvalidValue;  // group too large
  err = cudaFuncSetAttribute(attn_bwd_kernel<T, false>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  attn_bwd_kernel<T, false><<<dim3((unsigned)G, (unsigned)h), ABNT, smem, st>>>(at);

  // dWp = out^T gw; dWqkv = xw^T dqkv; dbqkv = sum dqkv
  weight_grad<T>(b.out, C, 0, b.gw, ld, 0, M, C, C, b.part, p.dwp, st);
  weight_grad<T>(b.xw, ld, 0, b.dqkv, 3 * C, 0, M, C, 3 * C, b.part, p.dwqkv, st);
  column_sums<T>(b.dqkv, 0, 3 * C, M, 3 * C, b.part, p.dbqkv, st);

  // dxw = dqkv Wqkv^T
  BGemmArgs g3{};
  g3.A = b.dqkv;
  g3.sam = 3 * C;
  g3.sak = 1;
  g3.B = p.wqkv;
  g3.sbk = ld;
  g3.sbn = 1;
  g3.C = b.dxw;
  g3.M = M;
  g3.N = C;
  g3.K = 3 * C;
  launch_bgemm<T>(g3, st);

  if (p.lns) {
    err = launch_ln_bwd<T>(p.x, p.g, b.dxw, p.lns, map, M, C, p.eps, p.res,
                           p.dx, b.part, p.dln, st);
    if (err != cudaSuccess) return err;
  } else {
    scatter_rows_kernel<T><<<(unsigned)((M * C + 255) / 256), 256, 0, st>>>(
        b.dxw, map, M, C, static_cast<T*>(p.dx));
  }

  // the sums over windows, in window order
  launch_reduce(b.DL, p.dbias, p.bias_groups, G / p.bias_groups,
                (long long)h * n * n, st);
  if (p.lam) launch_reduce(b.dlam_part, p.dlam, p.images, nW, h, st);
  return cudaSuccess;
}

template <typename T>
inline long long attn_bwd_ws_bytes(const AttnBwdProblem& p) {
  Workspace ws{nullptr, 0};
  attn_bwd_buffers<T>(ws, p);
  return (long long)ws.off + 256;
}

}  // namespace fairm
