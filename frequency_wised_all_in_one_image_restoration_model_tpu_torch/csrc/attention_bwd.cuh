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
// attn_bwd_run is the whole backward for both kernels, on one plan:
//  - the row gathers (prep), and the qkv recompute on gemm.cuh's GEMM;
//  - the four other products over the rows on bwd_gemm.cuh: in bf16 its
//    cp.async / ldmatrix / mma.sync NT and TN GEMMs (the weight gradients
//    as fp32 chunk partials reduced in a fixed order), in fp32 its
//    register-tiled FMA GEMM;
//  - in bf16, where attention_core_bwd.cuh takes the group (n = 64, and
//    K8's 192-token band groups with the mask's 64 x 64 tile repeated), the
//    per-group part on that tensor-core core: p and dl never leave the SM,
//    dbias and dlam are chunk and window partials summed in a fixed order;
//  - fp32 (full precision, no TF32) and other shapes: attn_bwd_kernel below
//    on the CUDA cores, one block per (group, head): a row pass with one
//    warp per query row (softmax, dp, dl, og, dq), which also writes p and
//    dl of the group to scratch, then a column pass with one thread per
//    (key, 8 channels) for dk and dv; dbias and dlam are fixed-order
//    reductions of per-group partials (bwd.cuh).
// out and dqkv are stored with rows of a multiple of 8 elements (16 bytes)
// for the GEMMs; dqkv's pad columns are zeroed, because dqkv Wqkv^T sums
// over them. No float atomics: a second launch gives equal bits.

#pragma once

#include <math.h>

#include "attention_core_bwd.cuh"
#include "bwd_gemm.cuh"

namespace fairm {

struct AttnBwdArgs {
  const void* qkv;     // [G * n, 3C] compute type: q | k | v, q unscaled
  const float* dout;   // [G * n, C]: the gradient of the attention rows
  void* out;           // [G * n, ldo] compute type: the attention rows again
  void* dqkv;          // [G * n, ld3] compute type
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
  int ldo, ld3;        // row strides of out and dqkv (>= C, 3C)
};

constexpr int ABNT = 256;

// q, k, v, dog (and dout as it came, with lam) of the group, a row of p and
// of dl per warp, the column sums of v and dout, the warps' lam partials
inline size_t attn_bwd_smem_bytes(int n, int d, bool lam) {
  return sizeof(float) * ((size_t)(lam ? 5 : 4) * n * (d + 1) +
                          2 * (ABNT / 32) * (size_t)n + 2 * d + ABNT / 32);
}

template <typename T>
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
  T* out = static_cast<T*>(a.out) + g * (long long)n * a.ldo + hh * d;
  T* dq_out = static_cast<T*>(a.dqkv) + g * (long long)n * a.ld3 + hh * d;

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
      out[(long long)i * a.ldo + c] = from_f<T>(o);
      dq_out[(long long)i * a.ld3 + c] = from_f<T>(dq * a.scale);
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
      dk_out[(long long)j * a.ld3 + c] = from_f<T>(ak[u] * a.scale);
      dv_out[(long long)j * a.ld3 + c] = from_f<T>(dv);
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
  const void* wqkvn;    // [C, kpad(3C)]: Wqkv as it is (dqkv Wqkv^T)
  const void* wpn;      // [C, kpad(C)]: Wp as it is (gw Wp^T)
  const float* bias;    // [bias groups, h, n, n]
  const float* mask;    // [nW, n0, n0] (n0 = win^2), or null
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

inline int round8(int x) { return (x + 7) / 8 * 8; }
inline long long max_ll(long long a, long long b) { return a > b ? a : b; }

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
struct AttnBwdBuffers {
  T *xw, *qkv, *gw, *out, *dqkv;
  float *dout, *dxw, *P, *DL, *dlam_part, *part;
};

// the problem's sizes, and the core's arguments where it runs
struct AttnBwdPlan {
  AttnBwdProblem p;
  long long M, G;
  int C, h, d, n0, n, nW, ld, ldo, ld3;
  RowMap map;
  bool core;
  CoreBwdArgs c;
};

template <typename T>
inline cudaError_t attn_bwd_plan(AttnBwdPlan& k, const AttnBwdProblem& p) {
  k.p = p;
  k.C = p.C;
  k.h = p.h;
  k.d = p.C / p.h;
  k.n0 = p.win * p.win;
  k.n = p.L * k.n0;
  k.nW = (p.H / p.win) * (p.W / p.win);
  k.M = (long long)p.images * p.H * p.W;
  k.G = k.M / k.n;
  k.ld = kpad(p.C);
  k.ldo = round8(p.C);
  k.ld3 = round8(3 * p.C);
  // K8: group (b, window) holds the window's L band copies, image l * B + b
  k.map = p.L > 1 ? RowMap{2, p.H, p.W, p.win, p.images / p.L, p.L, 0}
                  : RowMap{1, p.H, p.W, p.win, p.images, 1, 0};
  // the core repeats a mask tile of 64 x 64 only; lam only at n = 64
  k.core = std::is_same<T, bf16_t>::value &&
           core_covers(k.n, k.n, k.d, true) &&
           (k.n == k.n0 || (k.n0 == 64 && !p.lam));
  k.c = CoreBwdArgs{};
  if (!k.core) return cudaSuccess;
  k.c.W = k.G;
  k.c.h = k.h;
  k.c.d = k.d;
  k.c.nW = k.nW;
  k.c.groups = p.bias_groups;
  k.c.mtile = k.n != k.n0;
  k.c.scale = 1.f / sqrtf((float)k.d);
  return core_dispatch<true>(k.n, k.n, k.d, [&](auto shape) {
    return core_chunking<decltype(shape)>(k.c, k.G / p.bias_groups);
  });
}

template <typename T>
inline AttnBwdBuffers<T> attn_bwd_buffers(Workspace& ws, const AttnBwdPlan& k) {
  const long long M = k.M;
  AttnBwdBuffers<T> b{};
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
inline cudaError_t attn_bwd_run(const AttnBwdProblem& p, void* ws_base,
                                long long ws_bytes, cudaStream_t st) {
  AttnBwdPlan k;
  cudaError_t err = attn_bwd_plan<T>(k, p);
  if (err != cudaSuccess) return err;
  Workspace ws{static_cast<unsigned char*>(ws_base), 0};
  const AttnBwdBuffers<T> b = attn_bwd_buffers<T>(ws, k);
  if ((long long)ws.off > ws_bytes) return cudaErrorInvalidValue;
  const long long M = k.M, G = k.G;
  const int C = k.C, h = k.h, n = k.n, ld = k.ld;

  // recompute: xw = gather([LN] x), qkv = xw Wqkv + bqkv
  launch_prep<T>(p.x, C, k.map, M, p.lns, p.lnb, p.eps, b.xw, st);
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
  launch_prep<T>(p.g, C, k.map, M, nullptr, nullptr, 0.f, b.gw, st);
  column_sums<T>(b.gw, 0, ld, M, C, b.part, p.dbp, st);
  err = gemm_nt<T>(b.gw, ld, p.wpn, ld, b.dout, C, M, C, ld, nullptr, nullptr, 0, st);
  if (err != cudaSuccess) return err;

  // the per-group part: out, dqkv, dbias and the dlam partials
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
    at.n0 = k.n0;
    at.d = k.d;
    at.C = C;
    at.ldo = k.ldo;
    at.ld3 = k.ld3;
    at.h = h;
    at.nW = k.nW;
    at.imgs_per_bias = p.images / p.L / p.bias_groups;
    at.scale = 1.f / sqrtf((float)k.d);
    const size_t smem = attn_bwd_smem_bytes(n, k.d, p.lam != nullptr);
    if (smem > 227 * 1024) return cudaErrorInvalidValue;  // group too large
    err = cudaFuncSetAttribute(attn_bwd_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
    attn_bwd_kernel<T><<<dim3((unsigned)G, (unsigned)h), ABNT, smem, st>>>(at);
    // the sums over groups, in group order
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
  err = gemm_nt<T>(b.dqkv, k.ld3, p.wqkvn, kpad(3 * C), b.dxw, C, M, C, k.ld3,
                   nullptr, nullptr, 0, st);
  if (err != cudaSuccess) return err;

  // dx = scatter(LN backward of dxw) [+ g]; K8: dy = scatter(dxw)
  if (p.lns)
    return launch_ln_bwd<T>(p.x, p.g, b.dxw, p.lns, k.map, M, C, p.eps, p.res,
                            p.dx, b.part, p.dln, st);
  scatter_rows_kernel<T><<<(unsigned)((M * C + 255) / 256), 256, 0, st>>>(
      b.dxw, k.map, M, C, static_cast<T*>(p.dx));
  return cudaSuccess;
}

// bytes of workspace attn_bwd_run needs (-1 if the shape is refused)
template <typename T>
inline long long attn_bwd_ws_bytes(const AttnBwdProblem& p) {
  AttnBwdPlan k;
  if (attn_bwd_plan<T>(k, p) != cudaSuccess) return -1;
  Workspace ws{nullptr, 0};
  attn_bwd_buffers<T>(ws, k);
  return (long long)ws.off + 256;
}

}  // namespace fairm
