// K14: backward of the DCN K11 (modulated deformable convolution v2, stride 1,
// exact gather semantics, no clamp).
//
// The JAX package's backward is jax.vjp of the gather composite _exact_dcn
// (frequency_wised_all_in_one_image_restoration_model_tpu/ops/deform_conv.py),
// which XLA makes deterministic; the Pallas package has no DCN backward. This
// kernel takes the place of autograd of the port's plain gather, whose
// index-accumulate backward adds with float atomics. Given x, offset, mask,
// the weight and the output gradient g [B, Ho, Wo, Cout] it returns
//   dcol[p, t C + c] = sum_o g[p, o] W[t, c, o], rounded to x's type
//   dW[t C + c, o]   = sum_p col[p, t C + c] g[p, o]   (col = K11's columns)
//   db[o]            = sum_p g[p, o]
//   dmask[p, t]      = sum_c dcol[p, t, c] sample[p, t, c]
//   doffset[p, t]    = mask sum_c dcol (dsample / dfy)   if -1 <= yy <= H, else 0
//   doffset[p, K+t]  = mask sum_c dcol (dsample / dfx)   if -1 <= xx <= W, else 0
//   dx[q, c]         = sum over the samples s and corners i that read pixel q
//                      of w_i(s) mask(s) dcol[s, c], in fp32, rounded once
// with the derivative conventions of autograd on _bilinear_gather: the rim
// clip passes gradient at its bounds and none beyond them, floor none.
//
// What bounds it on the H100: the bytes of dcol [P, K C] in x's type, written
// once and read about five times (once for dmask / doffset, four times for
// dx: each sample feeds four pixels), and the three products of 2 P K C Cout
// operations each (dcol, dW, and K11's columns again). The scatter of dx has
// one writer per pixel only after the samples are grouped by pixel; with
// float atomics the sums would change from run to run.
// What the design does about it: dcol on the port's tensor-core GEMM
// (gemm.cuh; the FMA path in fp32); dmask and doffset by a group of lanes per
// sample, its sums reduced by shuffles in a fixed order; the samples bucketed
// by their base corner with a stable radix sort of integer keys per image
// (counts by integer atomics, which are exact), so that each bucket lists its
// samples in sample order; then each pixel gathers its four neighbouring
// buckets in a fixed order (corner 0 from its own bucket, corner 1 from the
// bucket left of it, corner 2 from the one above, corner 3 from the one above
// and left) and rounds once. The columns are written again by K11's pass into
// dcol's buffer; dW = cols^T g (bwd_gemm.cuh's TN product) and db are chunk
// partials added in a fixed order. No float atomics: a second launch gives
// equal bits.

#include "bwd_gemm.cuh"
#include "dcn.cuh"

using namespace fairm;

namespace {

// samples a block of the radix passes sorts; digits of 8 bits
constexpr int SORT_NT = 1024, RADIX_BITS = 8, RADIX = 1 << RADIX_BITS;

struct BwdArgs {
  ColArgs c;          // x, offset, mask, geometry (cols: dcol's buffer)
  const void* dcol;   // [P, K C] in T
  float* doff;        // [P, 2K]
  float* dmask;       // [P, K]
  int* keys;          // [P K]: the sample's bucket, or nb if it reads no pixel
  int* vals;          // [P K]: the sample's id
};

// lanes that share a sample or a pixel: its vectors, rounded up to a power of
// two, at most a warp
__host__ __device__ inline int group_lanes(int cv) {
  int g = 1;
  while (g < cv && g < 32) g <<= 1;
  return g;
}

// dmask, doffset and the bucket key of every sample s = pix K + t. A group of
// G lanes (a power of two) takes a sample, its lanes the sample's V-channel
// vectors; the group's sums are reduced by xor shuffles in a fixed order.
template <typename T, int V>
__global__ void __launch_bounds__(256) grad_sample_kernel(const BwdArgs a) {
  const ColArgs& c = a.c;
  const int K = c.kh * c.kw, cv = c.C / V, G = group_lanes(cv);
  const int lane = threadIdx.x & 31, sub = lane % G;
  const long long total = (long long)c.B * c.Ho * c.Wo * K;
  const long long s = ((blockIdx.x * (long long)blockDim.x + threadIdx.x) >> 5)
                          * (32 / G) + lane / G;
  const bool live = s < total;
  const long long ss = live ? s : 0;
  const long long pix = ss / K;
  const int t = (int)(ss - pix * K);
  const int hw = c.Ho * c.Wo;
  const long long b = pix / hw;
  const int rem = (int)(pix - b * hw);
  const int oy = rem / c.Wo, ox = rem - oy * c.Wo;
  const Footing f = footing(c, pix, oy, ox, t);
  const float fy = f.fy, fx = f.fx;
  const float w0 = (1.f - fy) * (1.f - fx), w1 = (1.f - fy) * fx,
              w2 = fy * (1.f - fx), w3 = fy * fx;
  const bool r0 = f.iy >= 0, r1 = f.iy + 1 < c.H, c0 = f.ix >= 0,
             c1 = f.ix + 1 < c.W;
  const T* xb = static_cast<const T*>(c.x) + b * c.H * (long long)c.W * c.C;
  const T* p00 = xb + ((long long)f.iy * c.W + f.ix) * c.C;
  const T* p10 = p00 + (long long)c.W * c.C;
  const T* drow = static_cast<const T*>(a.dcol) + ss * c.C;

  float dm = 0.f, dfy = 0.f, dfx = 0.f;
  if (live) {
    for (int e = sub; e < cv; e += G) {
      const int ch = e * V;
      float v[4][V];
#pragma unroll
      for (int i = 0; i < V; ++i) v[0][i] = v[1][i] = v[2][i] = v[3][i] = 0.f;
      auto get = [&](float* dst, const T* p) {
        const Pack<T, V> q = *reinterpret_cast<const Pack<T, V>*>(p + ch);
#pragma unroll
        for (int i = 0; i < V; ++i) dst[i] = to_f(q.v[i]);
      };
      if (r0 && c0) get(v[0], p00);
      if (r0 && c1) get(v[1], p00 + c.C);
      if (r1 && c0) get(v[2], p10);
      if (r1 && c1) get(v[3], p10 + c.C);
      const Pack<T, V> d = *reinterpret_cast<const Pack<T, V>*>(drow + ch);
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const float dv = to_f(d.v[i]);
        float smp = 0.f;  // the sample as cols_kernel sums it
        if (r0 && c0) smp += w0 * v[0][i];
        if (r0 && c1) smp += w1 * v[1][i];
        if (r1 && c0) smp += w2 * v[2][i];
        if (r1 && c1) smp += w3 * v[3][i];
        dm += dv * smp;
        dfy += dv * ((1.f - fx) * (v[2][i] - v[0][i]) + fx * (v[3][i] - v[1][i]));
        dfx += dv * ((1.f - fy) * (v[1][i] - v[0][i]) + fy * (v[3][i] - v[2][i]));
      }
    }
  }
  for (int o = G >> 1; o > 0; o >>= 1) {
    dm += __shfl_xor_sync(0xffffffffu, dm, o);
    dfy += __shfl_xor_sync(0xffffffffu, dfy, o);
    dfx += __shfl_xor_sync(0xffffffffu, dfx, o);
  }
  if (!live || sub != 0) return;
  const float m = c.mask[ss];
  a.dmask[ss] = dm;
  const bool gy = f.yy >= -1.f && f.yy <= (float)c.H;
  const bool gx = f.xx >= -1.f && f.xx <= (float)c.W;
  a.doff[pix * 2 * K + t] = gy ? m * dfy : 0.f;
  a.doff[pix * 2 * K + K + t] = gx ? m * dfx : 0.f;
  // a sample reads an image pixel with a weight other than 0 only inside the
  // open rim; the others go to bucket nb, which no pixel reads
  const int wp = c.W + 1, nb = (c.H + 1) * wp;
  const bool reads = f.yy > -1.f && f.yy < (float)c.H && f.xx > -1.f &&
                     f.xx < (float)c.W;
  a.keys[ss] = reads ? (f.iy + 1) * wp + (f.ix + 1) : nb;
  a.vals[ss] = (int)ss;
}

// ---- stable radix sort of (key, sample id) per image ------------------------
// pass: hist (the digit counts of each tile of SORT_NT samples), scan (each
// tile's start for each digit: the counts of the smaller digits in the image,
// then of the digit in the tiles before it), scatter (a sample's place: its
// tile's start for its digit plus the samples of that digit before it in the
// tile, from warp matches). Integer counts only, so the order is exact.

__global__ void __launch_bounds__(SORT_NT) radix_hist_kernel(
    const int* keys, long long n, int shift, int tiles, int* cnt) {
  __shared__ int h[RADIX];
  for (int i = threadIdx.x; i < RADIX; i += SORT_NT) h[i] = 0;
  __syncthreads();
  const long long i = (long long)blockIdx.x * SORT_NT + threadIdx.x;
  if (i < n) {
    const int k = keys[blockIdx.y * n + i];
    atomicAdd(&h[(k >> shift) & (RADIX - 1)], 1);  // an integer count
  }
  __syncthreads();
  int* out = cnt + ((long long)blockIdx.y * tiles + blockIdx.x) * RADIX;
  for (int d = threadIdx.x; d < RADIX; d += SORT_NT) out[d] = h[d];
}

// one block of RADIX threads per image, thread d for digit d
__global__ void __launch_bounds__(RADIX) radix_scan_kernel(int tiles, int* cnt) {
  __shared__ int tot[RADIX];
  const int d = threadIdx.x;
  int* c = cnt + (long long)blockIdx.x * tiles * RADIX;
  int sum = 0;
  for (int j = 0; j < tiles; ++j) sum += c[(long long)j * RADIX + d];
  tot[d] = sum;
  __syncthreads();
  int start = 0;
  for (int e = 0; e < d; ++e) start += tot[e];
  for (int j = 0; j < tiles; ++j) {
    const int v = c[(long long)j * RADIX + d];
    c[(long long)j * RADIX + d] = start;
    start += v;
  }
}

__global__ void __launch_bounds__(SORT_NT) radix_scatter_kernel(
    const int* keys, const int* vals, long long n, int shift, int tiles,
    const int* cnt, int* keys_out, int* vals_out) {
  __shared__ int wc[SORT_NT / 32][RADIX];  // samples of each digit per warp
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int i = threadIdx.x; i < (SORT_NT / 32) * RADIX; i += SORT_NT)
    (&wc[0][0])[i] = 0;
  __syncthreads();
  const long long i = (long long)blockIdx.x * SORT_NT + threadIdx.x;
  const long long base = (long long)blockIdx.y * n;
  const bool live = i < n;
  const int k = live ? keys[base + i] : 0;
  const int d = live ? (k >> shift) & (RADIX - 1) : RADIX;  // RADIX: no digit
  const unsigned peers = __match_any_sync(0xffffffffu, d);
  const int rank = __popc(peers & ((1u << lane) - 1u));
  if (live && rank == 0) wc[warp][d] = __popc(peers);
  __syncthreads();
  if (!live) return;
  int pos = cnt[((long long)blockIdx.y * tiles + blockIdx.x) * RADIX + d] + rank;
  for (int w = 0; w < warp; ++w) pos += wc[w][d];
  keys_out[base + pos] = k;
  vals_out[base + pos] = vals[base + i];
}

// start[b, k] = the first sorted place of bucket k (k = 0 .. nb), from the
// sorted keys: place i starts every bucket after the key before it up to its
// own (place n: up to nb)
__global__ void bucket_start_kernel(const int* keys, long long n, int nb,
                                    int* start) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i > n) return;
  const int* kb = keys + (long long)blockIdx.y * n;
  const int prev = i == 0 ? -1 : kb[i - 1];
  const int cur = i == n ? nb : min(kb[i], nb);
  int* sb = start + (long long)blockIdx.y * (nb + 1);
  for (int k = prev + 1; k <= cur; ++k) sb[k] = (int)i;
}

// dx[q, c]: a group of G lanes per image pixel q = (b, y, x) walks its four
// buckets in a fixed order and each bucket in sample order; the sum is fp32,
// rounded once to T
template <typename T, int V>
__global__ void __launch_bounds__(256) dx_gather_kernel(
    const BwdArgs a, const int* vals, const int* start, long long n, void* dx) {
  const ColArgs& c = a.c;
  const int K = c.kh * c.kw, cv = c.C / V, G = group_lanes(cv);
  const int lane = threadIdx.x & 31, sub = lane % G;
  const long long q = ((blockIdx.x * (long long)blockDim.x + threadIdx.x) >> 5)
                          * (32 / G) + lane / G;
  if (q >= (long long)c.B * c.H * c.W) return;
  const int hw = c.H * c.W;
  const long long b = q / hw;
  const int rem = (int)(q - b * hw);
  const int y = rem / c.W, x = rem - y * c.W;
  const int wp = c.W + 1, nb = (c.H + 1) * wp;
  const int* sb = start + b * (nb + 1);
  const int* vb = vals + b * n;
  const int bucket[4] = {(y + 1) * wp + x + 1, (y + 1) * wp + x, y * wp + x + 1,
                         y * wp + x};
  const int ohw = c.Ho * c.Wo;
  for (int e = sub; e < cv; e += G) {
    const int ch = e * V;
    float acc[V];
#pragma unroll
    for (int i = 0; i < V; ++i) acc[i] = 0.f;
#pragma unroll
    for (int corner = 0; corner < 4; ++corner) {
      const int lo = sb[bucket[corner]], hi = sb[bucket[corner] + 1];
      for (int j = lo; j < hi; ++j) {
        const long long s = vb[j];
        const long long pix = s / K;
        const int t = (int)(s - pix * K);
        const int prem = (int)(pix - b * ohw);
        const int oy = prem / c.Wo, ox = prem - oy * c.Wo;
        const Footing f = footing(c, pix, oy, ox, t);
        const float wy = corner < 2 ? 1.f - f.fy : f.fy;
        const float wx = (corner & 1) ? f.fx : 1.f - f.fx;
        const float coef = wy * wx * c.mask[s];
        const Pack<T, V> d = *reinterpret_cast<const Pack<T, V>*>(
            static_cast<const T*>(a.dcol) + s * c.C + ch);
#pragma unroll
        for (int i = 0; i < V; ++i) acc[i] += coef * to_f(d.v[i]);
      }
    }
    Pack<T, V> out;
#pragma unroll
    for (int i = 0; i < V; ++i) out.v[i] = from_f<T>(acc[i]);
    *reinterpret_cast<Pack<T, V>*>(static_cast<T*>(dx) + q * c.C + ch) = out;
  }
}

int radix_passes(int nb) {
  int bits = 0;
  while ((1 << bits) <= nb) ++bits;  // keys 0 .. nb
  return (bits + RADIX_BITS - 1) / RADIX_BITS;
}

struct DcnBwdBuffers {
  void* gpad;   // g as the GEMM's A operand [P, kpad(Cout)]
  void* dcol;   // dcol [P, K C], then the columns [P, kpad(K C)]
  int *keys0, *vals0, *keys1, *vals1;
  int* cnt;     // [B, tiles, RADIX]
  int* start;   // [B, nb + 1]
  float* part;  // the chunk partials of dW and db
};

DcnBwdBuffers dcn_bwd_buffers(Workspace& ws, int B, int H, int W, int C, int Ho,
                              int Wo, int Cout, int K, size_t tsize) {
  const long long P = (long long)B * Ho * Wo, n = (long long)Ho * Wo * K;
  const long long tiles = (n + SORT_NT - 1) / SORT_NT;
  const long long nb = (long long)(H + 1) * (W + 1);
  DcnBwdBuffers b;
  b.gpad = ws.take<unsigned char>(P * kpad(Cout) * (long long)tsize);
  b.dcol = ws.take<unsigned char>(P * kpad(K * C) * (long long)tsize);
  b.keys0 = ws.take<int>(P * K);
  b.vals0 = ws.take<int>(P * K);
  b.keys1 = ws.take<int>(P * K);
  b.vals1 = ws.take<int>(P * K);
  b.cnt = ws.take<int>(B * tiles * RADIX);
  b.start = ws.take<int>(B * (nb + 1));
  b.part = ws.take<float>(chunk_count(P) * (long long)K * C * Cout);
  return b;
}

template <typename T, int V>
cudaError_t sample_passes(const BwdArgs& a, const DcnBwdBuffers& w, void* dx,
                          cudaStream_t st) {
  const ColArgs& c = a.c;
  const int K = c.kh * c.kw;
  const int G = group_lanes(c.C / V);
  const long long total = (long long)c.B * c.Ho * c.Wo * K;
  const long long per_block = 8LL * (32 / G);  // 8 warps
  grad_sample_kernel<T, V><<<(unsigned)((total + per_block - 1) / per_block), 256,
                             0, st>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const long long n = (long long)c.Ho * c.Wo * K;
  const int tiles = (int)((n + SORT_NT - 1) / SORT_NT);
  const int nb = (c.H + 1) * (c.W + 1);
  const dim3 grid((unsigned)tiles, (unsigned)c.B);
  int *kin = w.keys0, *vin = w.vals0, *kout = w.keys1, *vout = w.vals1;
  for (int pass = 0; pass < radix_passes(nb); ++pass) {
    const int shift = pass * RADIX_BITS;
    radix_hist_kernel<<<grid, SORT_NT, 0, st>>>(kin, n, shift, tiles, w.cnt);
    radix_scan_kernel<<<(unsigned)c.B, RADIX, 0, st>>>(tiles, w.cnt);
    radix_scatter_kernel<<<grid, SORT_NT, 0, st>>>(kin, vin, n, shift, tiles,
                                                   w.cnt, kout, vout);
    int* tk = kin; kin = kout; kout = tk;
    int* tv = vin; vin = vout; vout = tv;
  }
  const dim3 sgrid((unsigned)((n + 1 + 255) / 256), (unsigned)c.B);
  bucket_start_kernel<<<sgrid, 256, 0, st>>>(kin, n, nb, w.start);
  const long long pixels = (long long)c.B * c.H * c.W;
  dx_gather_kernel<T, V><<<(unsigned)((pixels + per_block - 1) / per_block), 256,
                           0, st>>>(a, vin, w.start, n, dx);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dcn_bwd(const ColArgs& geo, const void* wkn, const void* g,
                    void* ws_base, long long ws_bytes, void* dx, float* doff,
                    float* dmask, float* dw, float* db, int Cout,
                    cudaStream_t st) {
  const int K = geo.kh * geo.kw, KC = K * geo.C;
  const long long P = (long long)geo.B * geo.Ho * geo.Wo;
  Workspace ws{static_cast<unsigned char*>(ws_base), 0};
  const DcnBwdBuffers w = dcn_bwd_buffers(ws, geo.B, geo.H, geo.W, geo.C, geo.Ho,
                                          geo.Wo, Cout, K, sizeof(T));
  if ((long long)ws.off > ws_bytes) return cudaErrorInvalidValue;

  // dcol = g W^T [P, K C] in T: g padded to the GEMM's k-tiles
  launch_prep<T>(g, Cout, identity_map(), P, nullptr, nullptr, 0.f, w.gpad, st);
  GemmArgs gm{};
  gm.A = w.gpad;
  gm.Wt = wkn;  // [K C, kpad(Cout)]: row t C + c = W[t, c, :]
  gm.lda = kpad(Cout);
  gm.hw = 1;
  gm.C = w.dcol;
  gm.cmap = identity_map();
  gm.M = P;
  gm.N = KC;
  cudaError_t err = launch_gemm<T>(gm, st);
  if (err != cudaSuccess) return err;

  // dmask, doffset, the buckets, dx
  BwdArgs a{geo, w.dcol, doff, dmask, w.keys0, w.vals0};
  constexpr int V = 16 / sizeof(T);
  err = dcn_vec_ok<T>(geo.C, geo.x) ? sample_passes<T, V>(a, w, dx, st)
                                    : sample_passes<T, 1>(a, w, dx, st);
  if (err != cudaSuccess) return err;

  // the columns again (over dcol, which is spent), then dW = cols^T g, db
  ColArgs cc = geo;
  cc.cols = w.dcol;
  cc.ldc = kpad(KC);
  err = launch_cols<T>(cc, st);
  if (err != cudaSuccess) return err;
  err = weight_grad_tn<T>(w.dcol, kpad(KC), w.gpad, kpad(Cout), P, KC, Cout,
                          w.part, dw, st);
  if (err != cudaSuccess) return err;
  if (db) column_sums<T>(g, 0, Cout, P, Cout, w.part, db, st);
  return cudaGetLastError();
}

}  // namespace

// bytes of workspace fairm_dcn_bwd needs
extern "C" long long fairm_dcn_bwd_ws(int B, int H, int W, int C, int Ho, int Wo,
                                      int Cout, int kh, int kw, int is_bf16) {
  Workspace ws{nullptr, 0};
  dcn_bwd_buffers(ws, B, H, W, C, Ho, Wo, Cout, kh * kw, is_bf16 ? 2 : 4);
  return (long long)ws.off + 256;
}

extern "C" int fairm_dcn_bwd(const void* x, const void* off, const void* mask,
                             const void* wkn, const void* g, void* ws, void* dx,
                             void* doff, void* dmask, void* dw, void* db,
                             long long ws_bytes, int B, int H, int W, int C,
                             int Ho, int Wo, int Cout, int kh, int kw, int pad,
                             int dil, int is_bf16, void* stream) {
  const ColArgs geo{x, (const float*)off, (const float*)mask, nullptr, B, H, W,
                    C, Ho, Wo, kh, kw, pad, dil, 0, -1.f};
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err =
      is_bf16 ? dcn_bwd<bf16_t>(geo, wkn, g, ws, ws_bytes, dx, (float*)doff,
                                (float*)dmask, (float*)dw, (float*)db, Cout, st)
              : dcn_bwd<float>(geo, wkn, g, ws, ws_bytes, dx, (float*)doff,
                               (float*)dmask, (float*)dw, (float*)db, Cout, st);
  if (err == cudaSuccess) err = cudaGetLastError();
  return (int)err;
}
