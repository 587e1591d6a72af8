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
// What bounds it on the H100: five products of 2 M C 4C operations (the
// bound is the products' at bf16 and fp32 alike) and the [M, 4C] hidden
// tensors, which cross device memory between the products and the 3x3
// stencils: at bf16, B = 4, res 128 (M = 65536, Hd = 224) each fp32 one is
// 58.7 MB.
// What the design does about it:
//  - the five products run through bwd_gemm.cuh: in bf16 a 3-stage cp.async
//    pipeline of 16-byte copies, ldmatrix (.trans for the weight gradients'
//    k-major tiles) and mma.sync m16n8k16, tiles of 128 x 64 / 128; in fp32 a
//    register-tiled FMA GEMM with float4 loads. Their epilogues add b1,
//    multiply by gelu'(hc) and write fp32 rows or the weight gradients'
//    chunk partials, added later in a fixed order;
//  - the depthwise conv mixes no channels, so two slab passes walk down the
//    image rows of a (rows, columns, channels) slab with a 3-row window in
//    registers and vector loads, no per-element div / mod: the first makes a2
//    and gelu'(hc) from h1; the second makes dh1 from dhc and h1, and the
//    dwd, dbd and db1 partials of the slab, reduced in a fixed order in
//    shared memory and then across slabs;
//  - a2 and dh1 are stored in the compute type, because every consumer
//    rounds them to it (dh1's fp32 values feed only db1, inside the pass that
//    makes them); h1, gelu'(hc) and dhc stay fp32.
// The hidden tensors left, [M, Hd] each: h1 (fp32) written once, read twice;
// gelu'(hc) (fp32) written once, read once, its buffer then holding dhc
// (fp32), written once, read once; a2 and then dh1 (compute type) written
// once each, read once and twice. In bf16 that is 38 bytes an element
// (PERF.md gives the bytes at each shape). No float atomics: a second launch
// gives equal bits.

#include "bwd_gemm.cuh"

using namespace fairm;

namespace {

// a slab pass's CTA: image b, rows [yb R, yb R + R), columns [xb XT, xb XT +
// XT), channel vectors [cb CVB, cb CVB + CVB) of V channels; thread (xl,
// cvl) walks its column down the rows
struct Slab {
  int B, H, W, Hd, ldh, R, XT, CVB, nyb, nxb;
};

constexpr int SLAB_NT = 256;

Slab make_slab(int B, int H, int W, int Hd, int ldh) {
  Slab s{B, H, W, Hd, ldh, 16, 32, 0, 0, 0};
  while (s.XT > 1 && s.XT / 2 >= W) s.XT /= 2;  // the power of two >= W, <= 32
  s.CVB = SLAB_NT / s.XT;
  s.nyb = (H + s.R - 1) / s.R;
  s.nxb = (W + s.XT - 1) / s.XT;
  return s;
}

template <int V>
struct alignas(4 * V) F4 {
  float v[V];
};

template <int V>
__device__ __forceinline__ void load_f(float* d, const float* p) {
  const F4<V> q = *reinterpret_cast<const F4<V>*>(p);
#pragma unroll
  for (int i = 0; i < V; ++i) d[i] = q.v[i];
}

template <int V>
__device__ __forceinline__ void store_f(float* p, const float* v) {
  F4<V> q;
#pragma unroll
  for (int i = 0; i < V; ++i) q.v[i] = v[i];
  *reinterpret_cast<F4<V>*>(p) = q;
}

template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T v[V];
};

template <typename T, int V>
__device__ __forceinline__ void store_t(T* p, const float* v) {
  Pack<T, V> q;
#pragma unroll
  for (int i = 0; i < V; ++i) q.v[i] = from_f<T>(v[i]);
  *reinterpret_cast<Pack<T, V>*>(p) = q;
}

// pass 1: hc = dwconv(gelu(h1)) + bd; a2 = gelu(hc) in T (zero pad columns
// up to ldh); gp = gelu'(hc) in fp32
template <typename T, int V>
__global__ void __launch_bounds__(SLAB_NT, 2) slab_fwd_kernel(
    const float* h1, const float* wd, const float* bd, T* a2, float* gp,
    const Slab s) {
  const int cvl = threadIdx.x % s.CVB, xl = threadIdx.x / s.CVB;
  const int c = (blockIdx.x * s.CVB + cvl) * V;
  const int yb = blockIdx.y / s.nxb, xb = blockIdx.y - yb * s.nxb;
  const int x = xb * s.XT + xl, b = blockIdx.z;
  const int y0 = yb * s.R, y1 = min(y0 + s.R, s.H);
  if (x >= s.W || c >= s.ldh) return;
  const long long img = (long long)b * s.H * s.W;
  if (c >= s.Hd) {  // the operand's pad columns
    const float z[V] = {};
    for (int y = y0; y < y1; ++y)
      store_t<T, V>(a2 + (img + (long long)y * s.W + x) * s.ldh + c, z);
    return;
  }
  float w[9][V], bias[V];
#pragma unroll
  for (int t = 0; t < 9; ++t) load_f<V>(w[t], wd + t * s.Hd + c);
  load_f<V>(bias, bd + c);
  // win[r][d][i]: gelu(h1) at row y - 1 + r, column x - 1 + d; nxt: the raw
  // h1 of the row after, loaded while this row is computed
  float win[3][3][V], nxt[3][V];
  auto fetch = [&](float (*dst)[V], int yy) {  // zeros outside the image
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      const int xx = x + d - 1;
      if (yy >= 0 && yy < s.H && xx >= 0 && xx < s.W) {
        load_f<V>(dst[d], h1 + (img + (long long)yy * s.W + xx) * s.Hd + c);
      } else {
#pragma unroll
        for (int i = 0; i < V; ++i) dst[d][i] = 0.f;
      }
    }
  };
  auto take = [&](float (*dst)[V]) {  // gelu(0) = 0 keeps the zero padding
#pragma unroll
    for (int d = 0; d < 3; ++d)
#pragma unroll
      for (int i = 0; i < V; ++i) dst[d][i] = gelu_tanh(nxt[d][i]);
  };
  fetch(nxt, y0 - 1);
  take(win[0]);
  fetch(nxt, y0);
  take(win[1]);
  fetch(nxt, y0 + 1);
  for (int y = y0; y < y1; ++y) {
    take(win[2]);
    fetch(nxt, y + 2);
    float hc[V], a[V], gr[V];
#pragma unroll
    for (int i = 0; i < V; ++i) {
      float acc = 0.f;
#pragma unroll
      for (int r = 0; r < 3; ++r)
#pragma unroll
        for (int d = 0; d < 3; ++d) acc = fmaf(w[r * 3 + d][i], win[r][d][i], acc);
      hc[i] = acc + bias[i];
      a[i] = gelu_tanh(hc[i]);
      gr[i] = gelu_tanh_grad(hc[i]);
    }
    const long long p = img + (long long)y * s.W + x;
    store_t<T, V>(a2 + p * s.ldh + c, a);
    store_f<V>(gp + p * s.Hd + c, gr);
#pragma unroll
    for (int d = 0; d < 3; ++d)
#pragma unroll
      for (int i = 0; i < V; ++i) {
        win[0][d][i] = win[1][d][i];
        win[1][d][i] = win[2][d][i];
      }
  }
}

// pass 2, per centre pixel (y, x) with the dhc window dw[r][d] = dhc[y - 1 +
// r, x - 1 + d]:
//   dh1[y, x]   = gelu'(h1[y, x]) sum_t wd[t] dw[2 - t / 3][2 - t % 3]
//   dwd[t]     += gelu(h1[y, x]) dw[2 - t / 3][2 - t % 3]
//   dbd += dhc[y, x];  db1 += dh1[y, x]
// dh1 in T (zero pad columns); the slab's partials [11, Hd] (dwd, dbd, db1)
// summed over its columns in a fixed order into part[slab]
template <typename T, int V>
__global__ void __launch_bounds__(SLAB_NT, 2) slab_bwd_kernel(
    const float* h1, const float* dhc, const float* wd, T* dh1, float* part,
    const Slab s) {
  __shared__ float red[11][SLAB_NT * V];
  const int cvl = threadIdx.x % s.CVB, xl = threadIdx.x / s.CVB;
  const int c = (blockIdx.x * s.CVB + cvl) * V;
  const int yb = blockIdx.y / s.nxb, xb = blockIdx.y - yb * s.nxb;
  const int x = xb * s.XT + xl, b = blockIdx.z;
  const int y0 = yb * s.R, y1 = min(y0 + s.R, s.H);
  const long long img = (long long)b * s.H * s.W;
  float acc[11][V];
#pragma unroll
  for (int q = 0; q < 11; ++q)
#pragma unroll
    for (int i = 0; i < V; ++i) acc[q][i] = 0.f;

  if (x < s.W && c < s.Hd) {
    float w[9][V];
#pragma unroll
    for (int t = 0; t < 9; ++t) load_f<V>(w[t], wd + t * s.Hd + c);
    // dw: dhc rows y - 1 .. y + 1; nxt / hn: dhc of row y + 2 and h1 of row
    // y + 1, loaded while row y is computed
    float dw[3][3][V], nxt[3][V], hv[V], hn[V];
    auto fetch = [&](float (*dst)[V], int yy) {  // zeros outside the image
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        const int xx = x + d - 1;
        if (yy >= 0 && yy < s.H && xx >= 0 && xx < s.W) {
          load_f<V>(dst[d], dhc + (img + (long long)yy * s.W + xx) * s.Hd + c);
        } else {
#pragma unroll
          for (int i = 0; i < V; ++i) dst[d][i] = 0.f;
        }
      }
    };
    fetch(dw[0], y0 - 1);
    fetch(dw[1], y0);
    fetch(dw[2], y0 + 1);
    load_f<V>(hn, h1 + (img + (long long)y0 * s.W + x) * s.Hd + c);
    for (int y = y0; y < y1; ++y) {
      fetch(nxt, y + 2);
      const long long p = img + (long long)y * s.W + x;
#pragma unroll
      for (int i = 0; i < V; ++i) hv[i] = hn[i];
      if (y + 1 < y1) load_f<V>(hn, h1 + (p + s.W) * s.Hd + c);
      float out[V];
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const float a = gelu_tanh(hv[i]);
        float t1 = 0.f;
#pragma unroll
        for (int t = 0; t < 9; ++t) {
          const float d = dw[2 - t / 3][2 - t % 3][i];
          t1 = fmaf(w[t][i], d, t1);
          acc[t][i] = fmaf(a, d, acc[t][i]);
        }
        out[i] = t1 * gelu_tanh_grad(hv[i]);
        acc[9][i] += dw[1][1][i];
        acc[10][i] += out[i];
      }
      store_t<T, V>(dh1 + p * s.ldh + c, out);
#pragma unroll
      for (int d = 0; d < 3; ++d)
#pragma unroll
        for (int i = 0; i < V; ++i) {
          dw[0][d][i] = dw[1][d][i];
          dw[1][d][i] = dw[2][d][i];
          dw[2][d][i] = nxt[d][i];
        }
    }
  } else if (x < s.W && c < s.ldh) {  // the operand's pad columns
    const float z[V] = {};
    for (int y = y0; y < y1; ++y)
      store_t<T, V>(dh1 + (img + (long long)y * s.W + x) * s.ldh + c, z);
  }

  // the slab's sums over its columns xl = 0, 1, ... in order
#pragma unroll
  for (int q = 0; q < 11; ++q)
#pragma unroll
    for (int i = 0; i < V; ++i) red[q][threadIdx.x * V + i] = acc[q][i];
  __syncthreads();
  const int width = s.CVB * V;  // channels of the slab
  const long long slab = ((long long)b * s.nyb + yb) * s.nxb + xb;
  for (int e = threadIdx.x; e < 11 * width; e += SLAB_NT) {
    const int q = e / width, j = e - q * width;
    const int ch = blockIdx.x * width + j;
    if (ch >= s.Hd) continue;
    const int cv = j / V, i = j - cv * V;
    float v = 0.f;
    for (int xs = 0; xs < s.XT; ++xs) v += red[q][(xs * s.CVB + cv) * V + i];
    part[(slab * 11 + q) * s.Hd + ch] = v;
  }
}

template <typename T, int V>
void launch_slabs_fwd(const float* h1, const float* wd, const float* bd, T* a2,
                      float* gp, const Slab& s, cudaStream_t st) {
  const dim3 grid((unsigned)((s.ldh / V + s.CVB - 1) / s.CVB),
                  (unsigned)(s.nyb * s.nxb), (unsigned)s.B);
  slab_fwd_kernel<T, V><<<grid, SLAB_NT, 0, st>>>(h1, wd, bd, a2, gp, s);
}

template <typename T, int V>
void launch_slabs_bwd(const float* h1, const float* dhc, const float* wd, T* dh1,
                      float* part, const Slab& s, cudaStream_t st) {
  const dim3 grid((unsigned)((s.ldh / V + s.CVB - 1) / s.CVB),
                  (unsigned)(s.nyb * s.nxb), (unsigned)s.B);
  slab_bwd_kernel<T, V><<<grid, SLAB_NT, 0, st>>>(h1, dhc, wd, dh1, part, s);
}

template <typename T>
struct FfnBwdBuffers {
  T *xn, *gpad, *hid;        // [M, kpad(C)], [M, kpad(C)], a2 then dh1 [M, ldh]
  float *h1, *gp, *dxn, *red, *part;
};

long long max_ll(long long a, long long b) { return a > b ? a : b; }

template <typename T>
FfnBwdBuffers<T> ffn_bwd_buffers(Workspace& ws, int B, int H, int W, int C,
                                 int Hd) {
  const long long M = (long long)B * H * W;
  const Slab s = make_slab(B, H, W, Hd, kpad(Hd));
  FfnBwdBuffers<T> b;
  b.xn = ws.take<T>(M * kpad(C));
  b.gpad = ws.take<T>(M * kpad(C));
  b.hid = ws.take<T>(M * kpad(Hd));
  b.h1 = ws.take<float>(M * Hd);
  b.gp = ws.take<float>(M * Hd);  // gelu'(hc), then dhc
  b.dxn = ws.take<float>(M * C);
  b.red = ws.take<float>(11LL * Hd);
  long long part = chunk_count(M) * (long long)C * Hd;
  part = max_ll(part, (long long)s.B * s.nyb * s.nxb * 11LL * Hd);
  part = max_ll(part, ln_bwd_blocks(M) * 2LL * C);
  part = max_ll(part, chunk_count(M) * (long long)C);
  b.part = ws.take<float>(part);
  return b;
}

template <typename T>
cudaError_t lewin_ffn_bwd(const void* x, const void* g, const float* lns,
                          const float* lnb, const void* w1t, const void* w1n,
                          const float* b1, const float* wd, const float* bd,
                          const void* w2n, void* ws_base, long long ws_bytes,
                          void* dx, float* dln, float* dw1, float* db1,
                          float* dwd, float* dbd, float* dw2, float* db2, int B,
                          int H, int W, int C, int Hd, float eps,
                          cudaStream_t st) {
  const long long M = (long long)B * H * W;
  Workspace ws{static_cast<unsigned char*>(ws_base), 0};
  const FfnBwdBuffers<T> b = ffn_bwd_buffers<T>(ws, B, H, W, C, Hd);
  if ((long long)ws.off > ws_bytes) return cudaErrorInvalidValue;
  const int ldc = kpad(C), ldh = kpad(Hd);
  const bool vec = Hd % 4 == 0;
  const Slab s = make_slab(B, H, W, Hd, ldh);
  cudaError_t err;

  // xn = LN2(x) and g, as the products' operands [M, kpad(C)]
  launch_prep<T>(x, C, identity_map(), M, lns, lnb, eps, b.xn, st);
  launch_prep<T>(g, C, identity_map(), M, nullptr, nullptr, 0.f, b.gpad, st);

  // h1 = xn W1 + b1 (fp32); a2 and gelu'(hc)
  err = gemm_nt<T>(b.xn, ldc, w1t, ldc, b.h1, Hd, M, Hd, ldc, b1, nullptr, 0, st);
  if (err != cudaSuccess) return err;
  if (vec)
    launch_slabs_fwd<T, 4>(b.h1, wd, bd, b.hid, b.gp, s, st);
  else
    launch_slabs_fwd<T, 1>(b.h1, wd, bd, b.hid, b.gp, s, st);

  // dhc = (g W2^T) gelu'(hc), over gelu'(hc); dW2 = a2^T g; db2 = sum g
  err = gemm_nt<T>(b.gpad, ldc, w2n, ldc, b.gp, Hd, M, Hd, ldc, nullptr, b.gp,
                   Hd, st);
  if (err != cudaSuccess) return err;
  err = weight_grad_tn<T>(b.hid, ldh, b.gpad, ldc, M, Hd, C, b.part, dw2, st);
  if (err != cudaSuccess) return err;
  column_sums<T>(g, 0, C, M, C, b.part, db2, st);

  // dh1 (over a2, which is spent) and the dwd / dbd / db1 partials
  const float* dhc = b.gp;
  if (vec)  // two channels a thread: its windows and 11 sums fit two CTAs a SM
    launch_slabs_bwd<T, 2>(b.h1, dhc, wd, b.hid, b.part, s, st);
  else
    launch_slabs_bwd<T, 1>(b.h1, dhc, wd, b.hid, b.part, s, st);
  launch_reduce8(b.part, b.red, (long long)s.B * s.nyb * s.nxb, 11LL * Hd, st);
  err = cudaMemcpyAsync(dwd, b.red, sizeof(float) * 9 * Hd,
                        cudaMemcpyDeviceToDevice, st);
  if (err == cudaSuccess)
    err = cudaMemcpyAsync(dbd, b.red + 9 * Hd, sizeof(float) * Hd,
                          cudaMemcpyDeviceToDevice, st);
  if (err == cudaSuccess)
    err = cudaMemcpyAsync(db1, b.red + 10 * Hd, sizeof(float) * Hd,
                          cudaMemcpyDeviceToDevice, st);
  if (err != cudaSuccess) return err;

  // dW1 = xn^T dh1; dxn = dh1 W1^T; dx = LN backward of dxn + g
  err = weight_grad_tn<T>(b.xn, ldc, b.hid, ldh, M, C, Hd, b.part, dw1, st);
  if (err != cudaSuccess) return err;
  err = gemm_nt<T>(b.hid, ldh, w1n, ldh, b.dxn, C, M, C, ldh, nullptr, nullptr,
                   0, st);
  if (err != cudaSuccess) return err;
  return launch_ln_bwd<T>(x, g, b.dxn, lns, identity_map(), M, C, eps, 1, dx,
                          b.part, dln, st);
}

}  // namespace

// bytes of workspace fairm_lewin_ffn_bwd needs
extern "C" long long fairm_lewin_ffn_bwd_ws(int B, int H, int W, int C, int Hd,
                                            int is_bf16) {
  Workspace ws{nullptr, 0};
  if (is_bf16)
    ffn_bwd_buffers<bf16_t>(ws, B, H, W, C, Hd);
  else
    ffn_bwd_buffers<float>(ws, B, H, W, C, Hd);
  return (long long)ws.off + 256;
}

extern "C" int fairm_lewin_ffn_bwd(const void* x, const void* g, const void* lns,
                                   const void* lnb, const void* w1t,
                                   const void* w1n, const void* b1,
                                   const void* wd, const void* bd,
                                   const void* w2n, void* ws, void* dx,
                                   void* dln, void* dw1, void* db1, void* dwd,
                                   void* dbd, void* dw2, void* db2,
                                   long long ws_bytes, int B, int H, int W,
                                   int C, int Hd, int is_bf16, float eps,
                                   void* stream) {
  auto f = [&](auto tag) {
    using T = decltype(tag);
    return lewin_ffn_bwd<T>(x, g, (const float*)lns, (const float*)lnb, w1t,
                            w1n, (const float*)b1, (const float*)wd,
                            (const float*)bd, w2n, ws, ws_bytes, dx,
                            (float*)dln, (float*)dw1, (float*)db1, (float*)dwd,
                            (float*)dbd, (float*)dw2, (float*)db2, B, H, W, C,
                            Hd, eps, (cudaStream_t)stream);
  };
  cudaError_t err = is_bf16 ? f(bf16_t{}) : f(float{});
  if (err == cudaSuccess) err = cudaGetLastError();
  return (int)err;
}
