// K10: backward of the standalone window attention K9.
//
// Replaces the Pallas kernel _bwd_kernel of fused_window_attention
// (frequency_wised_all_in_one_image_restoration_model_tpu/ops/pallas/
// window_attention.py): given q [W, h, n, d], k / v [W, h, nk, d], bias
// [h, n, nk], mask [nW, n, nk] or null and the output gradient g [W, h, n,
// d], it recomputes the probabilities and returns
//   dv = p^T g,  dp = g v^T,  dl = p * (dp - rowsum(dp * p)),
//   dq = dl k * scale,  dk = dl^T q * scale,  dbias = sum over windows of dl,
// dq / dk / dv rounded to the inputs' type, dbias fp32 [h, n, nk].
//
// The TPU kernel accumulates dbias across its sequential grid into one
// revisited block. Blocks of a CUDA grid run in no order, so here the sum
// over windows is split into chunks of consecutive windows: each block owns
// one chunk and one head, adds its windows' dl in window order into its own
// partial, and a reduce pass sums the partials in chunk order. No float
// atomics: a second launch gives equal bits.
//
// What bounds it on the H100: the bytes (q, k, v, g read, dq, dk, dv
// written once) at the main path's shapes; five products of n nk d
// multiply-adds per window and head.
//
// bf16 at the main path's window shapes (n, nk) = (64, 64), (64, 192) with
// d <= 64 and (192, 192) with d <= 32 (d a multiple of 4): one launch of the
// tensor-core core of attention_core_bwd.cuh (the five products on mma.sync,
// p and dl kept in shared memory as bf16, dbias as fp32 chunk partials in a
// fixed order), then the chunk reduce. The products round p and dl to bf16,
// as a TPU's default-precision fp32 product does; the Pallas body keeps them
// in fp32 (the plain twin does too).
//
// fp32 (full precision, no TF32) and every other shape: the CUDA cores,
// every product in fp32 on operands taken to fp32 (as the Pallas body
// does), the probabilities and dl never leaving the SM. Pass 1, one block
// per (window, head) and one warp per query row, recomputes a row of p, dp
// and dl and writes dq and the row's statistics (max, sum, rowsum(dp * p));
// pass 2, one block per (chunk, head) and one warp per key, recomputes a
// column of p and dl from those statistics and writes dk, dv and the
// chunk's dbias column (the workspace slice is key-major, so a warp's lanes
// write adjacent words); pass 3 sums the chunks.

#include "attention_core_bwd.cuh"

using namespace fairm;

namespace {

constexpr int BNT = 128;
constexpr int BWARPS = BNT / 32;
// pass 2 runs about this many blocks: the chunks of windows times the heads
constexpr int TARGET_BLOCKS = 4 * 132;

struct BwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* g;
  const float* bias;  // [h, n, nk]
  const float* mask;  // [nW, n, nk] or null
  void* dq;
  void* dk;
  void* dv;
  float* dbias;       // [h, n, nk]
  float* rmax;        // [W, h, n] row statistics
  float* rsum;
  float* rdot;
  float* part;        // [chunks, h, nk, n]
  long long W;
  int h, n, nk, d, nW, per, chunks;
  float scale;
};

// windows per chunk and the number of chunks of pass 2
void chunking(long long W, int h, int* per, int* chunks) {
  long long c = (TARGET_BLOCKS + h - 1) / h;
  if (c > W) c = W;
  if (c < 1) c = 1;
  const long long p = (W + c - 1) / c;
  *per = (int)p;
  *chunks = (int)((W + p - 1) / p);
}

template <typename T>
__global__ void __launch_bounds__(BNT) rows_kernel(const BwdArgs a) {
  extern __shared__ __align__(16) float sm[];
  const int n = a.n, nk = a.nk, d = a.d;
  const long long w = blockIdx.x;
  const int hh = blockIdx.y;
  float* k = sm;                         // row stride d + 1
  float* v = k + nk * (d + 1);
  float* wbuf = v + nk * (d + 1);        // per warp: q row, g row, p, dl
  const long long wh = w * a.h + hh;
  const T* ks = static_cast<const T*>(a.k) + wh * nk * d;
  const T* vs = static_cast<const T*>(a.v) + wh * nk * d;
  for (int e = threadIdx.x; e < nk * d; e += BNT) {
    const int j = e / d, c = e - j * d;
    k[j * (d + 1) + c] = to_f(ks[e]);
    v[j * (d + 1) + c] = to_f(vs[e]);
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* qi = wbuf + warp * (2 * d + 2 * nk);
  float* gi = qi + d;
  float* p = gi + d;
  float* dl = p + nk;
  const float* bias = a.bias + (long long)hh * n * nk;
  const float* mask = a.mask ? a.mask + (w % a.nW) * n * (long long)nk : nullptr;
  const T* qs = static_cast<const T*>(a.q) + wh * n * d;
  const T* gs = static_cast<const T*>(a.g) + wh * n * d;
  T* dq = static_cast<T*>(a.dq) + wh * n * d;
  for (int i = warp; i < n; i += BWARPS) {
    for (int c = lane; c < d; c += 32) {
      qi[c] = to_f(qs[(long long)i * d + c]);
      gi[c] = to_f(gs[(long long)i * d + c]);
    }
    __syncwarp();
    float mx = -INFINITY;
    for (int j = lane; j < nk; j += 32) {
      const float* kj = k + j * (d + 1);
      float s = 0.f;
      for (int c = 0; c < d; ++c) s = fmaf(qi[c], kj[c], s);
      s = s * a.scale + bias[i * nk + j];
      if (mask) s += mask[i * nk + j];
      p[j] = s;
      mx = fmaxf(mx, s);
    }
    mx = warp_max(mx);
    float sum = 0.f;
    for (int j = lane; j < nk; j += 32) {
      const float e = expf(p[j] - mx);
      p[j] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    float dot = 0.f;
    for (int j = lane; j < nk; j += 32) {
      const float pj = p[j] / sum;
      const float* vj = v + j * (d + 1);
      float dp = 0.f;
      for (int c = 0; c < d; ++c) dp = fmaf(gi[c], vj[c], dp);
      p[j] = pj;
      dl[j] = dp;
      dot = fmaf(dp, pj, dot);
    }
    dot = warp_sum(dot);
    for (int j = lane; j < nk; j += 32) dl[j] = p[j] * (dl[j] - dot);
    __syncwarp();
    for (int c = lane; c < d; c += 32) {
      float acc = 0.f;
      for (int j = 0; j < nk; ++j) acc = fmaf(dl[j], k[j * (d + 1) + c], acc);
      dq[(long long)i * d + c] = from_f<T>(acc * a.scale);
    }
    if (lane == 0) {
      const long long r = wh * n + i;
      a.rmax[r] = mx;
      a.rsum[r] = sum;
      a.rdot[r] = dot;
    }
    __syncwarp();
  }
}

template <typename T>
__global__ void __launch_bounds__(BNT) cols_kernel(const BwdArgs a) {
  extern __shared__ __align__(16) float sm[];
  const int n = a.n, nk = a.nk, d = a.d;
  const int chunk = blockIdx.x, hh = blockIdx.y;
  float* q = sm;                         // row stride d + 1
  float* g = q + n * (d + 1);
  float* smax = g + n * (d + 1);
  float* ssum = smax + n;
  float* sdot = ssum + n;
  float* wbuf = sdot + n;                // per warp: k row, v row, p, dl
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* kj = wbuf + warp * (2 * d + 2 * n);
  float* vj = kj + d;
  float* pc = vj + d;
  float* dlc = pc + n;
  const float* bias = a.bias + (long long)hh * n * nk;
  float* part = a.part + ((long long)chunk * a.h + hh) * nk * n;
  const long long w0 = (long long)chunk * a.per;
  const long long w1 = w0 + a.per < a.W ? w0 + a.per : a.W;

  for (long long w = w0; w < w1; ++w) {
    const long long wh = w * a.h + hh;
    const T* qs = static_cast<const T*>(a.q) + wh * n * d;
    const T* gs = static_cast<const T*>(a.g) + wh * n * d;
    for (int e = threadIdx.x; e < n * d; e += BNT) {
      const int i = e / d, c = e - i * d;
      q[i * (d + 1) + c] = to_f(qs[e]);
      g[i * (d + 1) + c] = to_f(gs[e]);
    }
    for (int i = threadIdx.x; i < n; i += BNT) {
      smax[i] = a.rmax[wh * n + i];
      ssum[i] = a.rsum[wh * n + i];
      sdot[i] = a.rdot[wh * n + i];
    }
    __syncthreads();
    const float* mask = a.mask ? a.mask + (w % a.nW) * n * (long long)nk : nullptr;
    const T* ks = static_cast<const T*>(a.k) + wh * nk * d;
    const T* vs = static_cast<const T*>(a.v) + wh * nk * d;
    T* dk = static_cast<T*>(a.dk) + wh * nk * d;
    T* dv = static_cast<T*>(a.dv) + wh * nk * d;
    for (int j = warp; j < nk; j += BWARPS) {
      for (int c = lane; c < d; c += 32) {
        kj[c] = to_f(ks[(long long)j * d + c]);
        vj[c] = to_f(vs[(long long)j * d + c]);
      }
      __syncwarp();
      float* pj = part + (long long)j * n;
      for (int i = lane; i < n; i += 32) {
        const float* qi = q + i * (d + 1);
        const float* gi = g + i * (d + 1);
        float s = 0.f, dp = 0.f;
        for (int c = 0; c < d; ++c) {
          s = fmaf(qi[c], kj[c], s);
          dp = fmaf(gi[c], vj[c], dp);
        }
        s = s * a.scale + bias[i * nk + j];
        if (mask) s += mask[i * nk + j];
        const float p = expf(s - smax[i]) / ssum[i];
        const float dl = p * (dp - sdot[i]);
        pc[i] = p;
        dlc[i] = dl;
        pj[i] = (w == w0 ? 0.f : pj[i]) + dl;
      }
      __syncwarp();
      for (int c = lane; c < d; c += 32) {
        float accv = 0.f, acck = 0.f;
        for (int i = 0; i < n; ++i) {
          accv = fmaf(pc[i], g[i * (d + 1) + c], accv);
          acck = fmaf(dlc[i], q[i * (d + 1) + c], acck);
        }
        dv[(long long)j * d + c] = from_f<T>(accv);
        dk[(long long)j * d + c] = from_f<T>(acck * a.scale);
      }
      __syncwarp();
    }
    __syncthreads();
  }
}

// dbias[hh, i, j] = sum over chunks, in chunk order, of part[c, hh, j, i]
__global__ void reduce_cols_kernel(const BwdArgs a) {
  const long long per_head = (long long)a.n * a.nk;
  const long long total = per_head * a.h;
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x; e < total;
       e += (long long)gridDim.x * blockDim.x) {
    const int hh = (int)(e / per_head);
    const long long r = e - hh * per_head;   // j * n + i
    const int j = (int)(r / a.n), i = (int)(r - (long long)j * a.n);
    float s = 0.f;
    for (int c = 0; c < a.chunks; ++c) s += a.part[(long long)c * total + e];
    a.dbias[((long long)hh * a.n + i) * a.nk + j] = s;
  }
}

size_t rows_smem(int nk, int d) {
  return sizeof(float) * ((size_t)nk * (d + 1) * 2 + BWARPS * (2 * (size_t)d + 2 * nk));
}

size_t cols_smem(int n, int d) {
  return sizeof(float) *
         ((size_t)n * (d + 1) * 2 + 3 * (size_t)n + BWARPS * (2 * (size_t)d + 2 * n));
}

long long ws_floats(long long W, int h, int n, int nk, int chunks) {
  return 3 * W * h * n + (long long)chunks * h * n * nk;
}

template <typename T>
cudaError_t run(BwdArgs a, cudaStream_t st) {
  size_t smem = rows_smem(a.nk, a.d);
  cudaError_t err = cudaFuncSetAttribute(
      rows_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  rows_kernel<T><<<dim3((unsigned)a.W, (unsigned)a.h), BNT, smem, st>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  smem = cols_smem(a.n, a.d);
  err = cudaFuncSetAttribute(cols_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  cols_kernel<T><<<dim3((unsigned)a.chunks, (unsigned)a.h), BNT, smem, st>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const long long total = (long long)a.h * a.n * a.nk;
  const int blocks = (int)((total + 255) / 256 < 4096 ? (total + 255) / 256 : 4096);
  reduce_cols_kernel<<<blocks, 256, 0, st>>>(a);
  return cudaSuccess;
}

}  // namespace

// bytes of workspace fairm_window_attn_bwd needs
extern "C" long long fairm_window_attn_bwd_ws(int W, int h, int n, int nk) {
  int per, chunks;
  chunking(W, h, &per, &chunks);
  return (long long)sizeof(float) * ws_floats(W, h, n, nk, chunks);
}

extern "C" int fairm_window_attn_bwd(const void* q, const void* k, const void* v,
                                     const void* bias, const void* mask,
                                     const void* g, void* ws, void* dq, void* dk,
                                     void* dv, void* dbias, long long ws_bytes,
                                     int W, int h, int n, int nk, int d, int nW,
                                     float scale, int is_bf16, void* stream) {
  BwdArgs a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.g = g;
  a.bias = (const float*)bias;
  a.mask = (const float*)mask;
  a.dq = dq;
  a.dk = dk;
  a.dv = dv;
  a.dbias = (float*)dbias;
  a.W = W;
  a.h = h;
  a.n = n;
  a.nk = nk;
  a.d = d;
  a.nW = nW;
  a.scale = scale;
  chunking(W, h, &a.per, &a.chunks);
  if ((long long)sizeof(float) * ws_floats(W, h, n, nk, a.chunks) > ws_bytes)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (is_bf16 && core_covers(n, nk, d, false)) {
    // the tensor-core core; its chunk partials fit the workspace's, because
    // it cuts at most as many chunks
    CoreBwdArgs c{};
    c.q = static_cast<const bf16_t*>(q);
    c.k = static_cast<const bf16_t*>(k);
    c.v = static_cast<const bf16_t*>(v);
    c.g = g;
    c.dq = static_cast<bf16_t*>(dq);
    c.dk = static_cast<bf16_t*>(dk);
    c.dv = static_cast<bf16_t*>(dv);
    c.vq = CoreView{(long long)h * n * d, n * d, d};
    c.vkv = CoreView{(long long)h * nk * d, nk * d, d};
    c.vg = c.vdq = c.vq;
    c.vdkv = c.vkv;
    c.bias = a.bias;
    c.mask = a.mask;
    c.part = static_cast<float*>(ws);
    c.W = W;
    c.h = h;
    c.d = d;
    c.nW = nW;
    c.groups = 1;
    c.scale = scale;
    cudaError_t err = core_dispatch<false>(n, nk, d, [&](auto shape) {
      using S = decltype(shape);
      cudaError_t e = core_chunking<S>(c, a.chunks);
      return e == cudaSuccess ? core_launch<S>(c, a.dbias, st) : e;
    });
    if (err == cudaSuccess) err = cudaGetLastError();
    return (int)err;
  }
  float* f = static_cast<float*>(ws);
  const long long rows = (long long)W * h * n;
  a.rmax = f;
  a.rsum = f + rows;
  a.rdot = f + 2 * rows;
  a.part = f + 3 * rows;
  cudaError_t err = is_bf16 ? run<bf16_t>(a, st) : run<float>(a, st);
  if (err == cudaSuccess) err = cudaGetLastError();
  return (int)err;
}
