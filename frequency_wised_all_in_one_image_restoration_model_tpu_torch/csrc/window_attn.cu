// K9: standalone window attention, softmax(q k^T * scale + bias [+ mask]) v,
// the attention core of the unfused LeWin block (the decoder's injection
// methods, the learnable modulator, the encoder's need_kv blocks).
//
// Replaces the Pallas kernel _kernel of fused_window_attention
// (frequency_wised_all_in_one_image_restoration_model_tpu/ops/pallas/
// window_attention.py): for every window w and head, n query tokens, nk key
// tokens (nk = n, or a multiple of n: 192 encoder keys for the decoder's
// 64-token windows under attention_kv), head dim d; bias [h, n, bc] fp32
// with key j reading column j % bc (bc divides nk: the window's own table,
// tiled along the keys), mask [nW, mr, mc] fp32 or null with window w
// taking mask[w % nW] at (i % mr, j % mc) (the SW-MSA mask of one 64-token
// window, tiled over the bands and the keys). The rounding points are the
// Pallas body's: q.k accumulated in fp32, then the scale, the bias and the
// mask, in that order; a per-row-max softmax in fp32, the probabilities
// normalised and then rounded to v's type, p.v accumulated in fp32; out in
// q's type.
//
// In bf16 at the main path's shapes (fairm_window_attn_mma) the operands
// are read in place: q, k, v and out are each described by the strides of
// (window, head, band, token within the band), the head dim contiguous
// (ops/kernels/window_attention.py::descriptor), so the kernel reads the
// projections' [B', n, h d] outputs, or the encoder's band-major [L, B'/L,
// n, h d], and writes out in the layout the projection after it reads, with
// no copy on either side.
//
// The TPU kernel packs two 64-token windows into one 128-wide MXU tile and
// kills the cross-window logits with -1e9; here a window is a unit of work
// and no packing is needed.
//
// What bounds it on the H100: the bytes of q, k, v and out (the logits,
// 2 n nk d multiply-adds a window and head for each product, sit below the
// tensor cores' ridge at d = 28..56). What the design does about it, in
// bf16 for the main path's (n, nk) = (64, 64), (64, 192), (192, 192) with
// d <= 64: a CTA owns one head and walks a chunk of consecutive windows,
// sized so that one wave fills the card; it stages the bias in shared
// memory once, and each window's mask tile by cp.async with its v (not once
// a logit from L2). Walking the windows of one mask index instead, to stage
// each tile once, measured 1.5-2x slower (PERF.md section 6). Both products
// run on the tensor cores (mma.sync m16n8k16, fp32 accumulators, a warp per
// 16 query rows; at (64, 64) two windows side by side, one in a small
// launch; at (64, 192) two warps a slab, each half the keys, the softmax's
// max and sum and the two halves of p.v added through shared memory in a
// fixed order; the head dim zero-padded to 32 or 64). q, k, v come by
// cp.async in 16-byte (8-byte at d = 28) copies, the next window's q and k
// while this window's softmax and p.v run, its v while the next q.k runs.
// fp32 (no TF32) and every other shape take the CUDA cores
// (fairm_window_attn): one CTA a (window, head), a warp a query row, on
// contiguous operands and tiled tables, which the launcher joins; versions
// that read the operands in place, with the tables staged over a chunk of
// windows or read through L1, measured 10-30% slower (PERF.md section 6).

#include "gemm.cuh"

using namespace fairm;

namespace {

// one operand: the strides (elements) of (window, head, band, token), d
// contiguous; token i of the window is token i % nb of band i / nb
struct WinOperand {
  void* p;
  long long sw, sh, sb, st;
  int nb;
};

struct WinArgs {
  WinOperand q, k, v, o;
  const float* bias;  // [h, n, bc]
  const float* mask;  // [nW, mr, mc] or null
  int W, h, n, nk, d, nW, bc, mr, mc;
  float scale;
  int per;            // consecutive windows a CTA takes
};

__device__ __forceinline__ long long tok(const WinOperand& o, long long w,
                                         int hh, int i) {
  const int band = i / o.nb;
  return w * o.sw + hh * o.sh + band * o.sb + (long long)(i - band * o.nb) * o.st;
}

// ---- bf16 on the tensor cores ------------------------------------------------

template <int CB>
__device__ __forceinline__ void cp_async_n(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  if constexpr (CB == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(gmem));
}

// the shared-memory layout (byte offsets): q, k, v [rows][DP + 8] bf16;
// the bias [N][bc + 8] and the mask tile [mr][mc + 8] fp32 (rows 8 floats
// apart on the banks, so that a warp's float2 reads of four rows do not
// collide); the key parts' row maxima and sums
template <int N, int NK, int DP, int KS, int WP>
struct MmaShape {
  static constexpr int LDS = DP + 8;  // 16-byte row offsets spread over the banks
  static constexpr int NT = N / 16 * KS * WP * 32;
  static constexpr size_t QKV = sizeof(bf16_t) * (N + 2 * NK) * LDS;  // a window's
  static constexpr size_t RED = KS > 1 ? sizeof(float) * 2 * KS * N : 0;
  static_assert(KS == 1 || WP == 1, "key parts take one window at a time");
  static_assert(KS == 1 || sizeof(float) * N * DP <= sizeof(bf16_t) * NK * LDS,
                "a key part's p.v must fit v's buffer");
  static size_t bytes(int bc, int mr, int mc, bool masked) {
    return WP * QKV + RED + sizeof(float) * ((size_t)N * (bc + 8) +
                                             (masked ? WP * (size_t)mr * (mc + 8) : 0));
  }
};

// the rows of one operand of window w into shared memory (rows of LDS), by
// cp.async of CB bytes
template <int CB, int LDS>
__device__ __forceinline__ void load_rows(bf16_t* dst, const WinOperand& o,
                                          long long w, int hh, int rows, int d,
                                          int nthreads) {
  const int cpr = d * 2 / CB;
  const bf16_t* base = static_cast<const bf16_t*>(o.p);
  for (int e = threadIdx.x; e < rows * cpr; e += nthreads) {
    const int i = e / cpr, j = e - i * cpr;
    cp_async_n<CB>(dst + i * LDS + j * (CB / 2), base + tok(o, w, hh, i) + j * (CB / 2));
  }
}

// a table [rows][cols] (global, cols a multiple of 4, 16-byte aligned)
// into shared memory [rows][cols + 8] by cp.async
__device__ __forceinline__ void stage(float* dst, const float* src, int rows,
                                      int cols, int nthreads) {
  const int cv = cols / 4;
  for (int e = threadIdx.x; e < rows * cv; e += nthreads) {
    const int i = e / cv, j = (e - i * cv) * 4;
    cp_async16(dst + i * (cols + 8) + j, src + (long long)i * cols + j, true);
  }
}

// bf16, N queries, NK keys in KS parts, head dim d <= DP, CB-byte copies,
// with or without a mask, WP windows side by side: a warp per 16 query rows,
// key part and window; each step's q and k load while the last step's
// softmax and p.v run, its v and mask tiles while its own q.k runs. BW: the
// bias is one
// window's [N, 64], its columns wrap; MW: the mask is one window's [64,
// 64], its rows and columns wrap. Grid: (heads, chunks).
template <int N, int NK, int DP, int CB, int KS, int WP, bool MASKED, bool BW,
          bool MW>
__global__ void __launch_bounds__(N / 16 * KS * WP * 32, N == 192 ? 1 : (KS * WP == 1 ? 3 : 2))
    win_attn_mma_kernel(const WinArgs a) {
  using S = MmaShape<N, NK, DP, KS, WP>;
  constexpr int LDS = S::LDS, NTH = S::NT, SLABS = N / 16;
  constexpr int KB = NK / KS, NT = KB / 8;  // a warp's keys, its key tiles
  constexpr int QKV = (N + 2 * NK) * LDS;   // a window's elements
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16_t* qkv = reinterpret_cast<bf16_t*>(smem_raw);
  float* red = reinterpret_cast<float*>(smem_raw + WP * S::QKV);  // [2][KS][N]
  float* bias_s = reinterpret_cast<float*>(smem_raw + WP * S::QKV + S::RED);
  float* mask_s = bias_s + N * (a.bc + 8);  // [WP][mr][mc + 8]
  const int mtile = a.mr * (a.mc + 8);

  const int d = a.d, hh = blockIdx.x;
  const int f0 = blockIdx.y * a.per;
  const int f1 = min(f0 + a.per, a.W);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, t4 = lane & 3;
  const int slot = warp / (SLABS * KS), wl = warp % (SLABS * KS);
  const int r0 = (wl % SLABS) * 16, kb = wl / SLABS, k0 = kb * KB;
  bf16_t* q = qkv + slot * QKV;
  bf16_t* k = q + N * LDS;
  bf16_t* v = k + NK * LDS;

  // the head dim's zero pad (the copies never write it)
  const bf16_t z = from_f<bf16_t>(0.f);
  for (int e = threadIdx.x; e < WP * (N + 2 * NK) * (DP - d); e += NTH) {
    const int r = e / (DP - d);
    qkv[r * LDS + d + e - r * (DP - d)] = z;
  }
  auto qk_load = [&](int f) {
#pragma unroll
    for (int p = 0; p < WP; ++p) {
      if (f + p < f1) {
        const long long w = f + p;
        load_rows<CB, LDS>(qkv + p * QKV, a.q, w, hh, N, d, NTH);
        load_rows<CB, LDS>(qkv + p * QKV + N * LDS, a.k, w, hh, NK, d, NTH);
      }
    }
  };
  // a step's v and mask tiles (window w takes mask[w % nW])
  auto v_load = [&](int f) {
#pragma unroll
    for (int p = 0; p < WP; ++p)
      if (f + p < f1) {
        load_rows<CB, LDS>(qkv + p * QKV + (N + NK) * LDS, a.v, f + p, hh, NK,
                           d, NTH);
        if constexpr (MASKED)
          stage(mask_s + p * mtile, a.mask + (long long)((f + p) % a.nW) * a.mr * a.mc,
                a.mr, a.mc, NTH);
      }
  };
  stage(bias_s, a.bias + (long long)hh * N * a.bc, N, a.bc, NTH);
  if (f0 < f1) qk_load(f0);
  cp_async_commit();
  if (f0 < f1) v_load(f0);
  cp_async_commit();

  // this thread's two rows of the tables
  constexpr int BST = (BW ? 64 : NK) + 8, MST = (MW ? 64 : NK) + 8;
  const float* brow[2];
  const float* mrow[2];
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    const int i = r0 + gq + h2 * 8;
    brow[h2] = bias_s + i * BST + t4 * 2;
    mrow[h2] = mask_s + slot * mtile + (MW ? (i & 63) : i) * MST + t4 * 2;
  }
  bf16_t* out = static_cast<bf16_t*>(a.o.p);

  for (int f = f0; f < f1; f += WP) {
    const int fw = f + slot;  // this warp's window
    asm volatile("cp.async.wait_group 1;\n" ::);  // q, k (and the bias)
    __syncthreads();
    float s[NT][4];
    {
      uint32_t qf[DP / 16][4];
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk)
        ldmatrix_x4(qf[kk], q + (r0 + (lane & 15)) * LDS + kk * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
#pragma unroll
        for (int kk = 0; kk < DP / 16; ++kk) {
          uint32_t t[4];
          const int kr = k0 + np * 16 + (lane & 7) + ((lane >> 4) << 3);
          ldmatrix_x4(t, k + kr * LDS + kk * 16 + ((lane >> 3) & 1) * 8);
          const uint32_t b0[2] = {t[0], t[1]}, b1[2] = {t[2], t[3]};
          mma_bf16_16816(s[2 * np], qf[kk], b0);
          mma_bf16_16816(s[2 * np + 1], qf[kk], b1);
        }
      }
    }
    __syncthreads();  // q and k are read: the next step's may come
    if (f + WP < f1) qk_load(f + WP);
    cp_async_commit();
    asm volatile("cp.async.wait_group 1;\n" ::);  // v and the mask tiles
    __syncthreads();

    // scale, bias, mask (a float2 of each table a pair of columns); row
    // max of rows r0 + gq and r0 + gq + 8
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int jb = BW ? ((k0 + nt * 8) & 63) : k0 + nt * 8;
      const int jm = MW ? ((k0 + nt * 8) & 63) : k0 + nt * 8;
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        const float2 bb = *reinterpret_cast<const float2*>(brow[h2] + jb);
        float v0 = s[nt][2 * h2] * a.scale + bb.x;
        float v1 = s[nt][2 * h2 + 1] * a.scale + bb.y;
        if constexpr (MASKED) {
          const float2 mm = *reinterpret_cast<const float2*>(mrow[h2] + jm);
          v0 += mm.x;
          v1 += mm.y;
        }
        s[nt][2 * h2] = v0;
        s[nt][2 * h2 + 1] = v1;
        mx[h2] = fmaxf(mx[h2], fmaxf(v0, v1));
      }
    }
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      mx[h2] = fmaxf(mx[h2], __shfl_xor_sync(0xffffffffu, mx[h2], 1));
      mx[h2] = fmaxf(mx[h2], __shfl_xor_sync(0xffffffffu, mx[h2], 2));
    }
    if constexpr (KS > 1) {  // the row maxima over the key parts
      if (t4 == 0) {
        red[kb * N + r0 + gq] = mx[0];
        red[kb * N + r0 + gq + 8] = mx[1];
      }
      __syncthreads();
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        float m = red[r0 + gq + h2 * 8];
#pragma unroll
        for (int p = 1; p < KS; ++p) m = fmaxf(m, red[p * N + r0 + gq + h2 * 8]);
        mx[h2] = m;
      }
    }
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float ex = expf(s[nt][e] - mx[e >> 1]);
        s[nt][e] = ex;
        sum[e >> 1] += ex;
      }
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      sum[h2] += __shfl_xor_sync(0xffffffffu, sum[h2], 1);
      sum[h2] += __shfl_xor_sync(0xffffffffu, sum[h2], 2);
    }
    if constexpr (KS > 1) {  // the row sums over the key parts, in order
      if (t4 == 0) {
        red[(KS + kb) * N + r0 + gq] = sum[0];
        red[(KS + kb) * N + r0 + gq + 8] = sum[1];
      }
      __syncthreads();
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        float t = 0.f;
#pragma unroll
        for (int p = 0; p < KS; ++p) t += red[(KS + p) * N + r0 + gq + h2 * 8];
        sum[h2] = t;
      }
    }
    // O = P V with P normalised before its rounding to bf16, as the Pallas
    // body does; P's accumulator layout is the A-fragment layout of m16k16
    float o[DP / 8][4];
#pragma unroll
    for (int ct = 0; ct < DP / 8; ++ct)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[ct][e] = 0.f;
#pragma unroll
    for (int jt = 0; jt < KB / 16; ++jt) {
      uint32_t pf[4];
      pf[0] = pack_bf16(s[2 * jt][0] / sum[0], s[2 * jt][1] / sum[0]);
      pf[1] = pack_bf16(s[2 * jt][2] / sum[1], s[2 * jt][3] / sum[1]);
      pf[2] = pack_bf16(s[2 * jt + 1][0] / sum[0], s[2 * jt + 1][1] / sum[0]);
      pf[3] = pack_bf16(s[2 * jt + 1][2] / sum[1], s[2 * jt + 1][3] / sum[1]);
#pragma unroll
      for (int cp = 0; cp < DP / 16; ++cp) {
        uint32_t t[4];
        const int vr = k0 + jt * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
        ldmatrix_x4_trans(t, v + vr * LDS + cp * 16 + (lane >> 4) * 8);
        const uint32_t b0[2] = {t[0], t[1]}, b1[2] = {t[2], t[3]};
        mma_bf16_16816(o[2 * cp], pf, b0);
        mma_bf16_16816(o[2 * cp + 1], pf, b1);
      }
    }
    __syncthreads();  // v is read
    if constexpr (KS > 1) {
      // the key parts' p.v added to part 0's, parts KS - 1 ... 1 in turn,
      // through v's buffer as fp32 [N][DP]
      float* ov = reinterpret_cast<float*>(v);
#pragma unroll
      for (int p = KS - 1; p >= 1; --p) {
        if (kb == p) {
#pragma unroll
          for (int ct = 0; ct < DP / 8; ++ct)
#pragma unroll
            for (int h2 = 0; h2 < 2; ++h2)
              *reinterpret_cast<float2*>(ov + (r0 + gq + h2 * 8) * DP + ct * 8 +
                                         t4 * 2) =
                  make_float2(o[ct][2 * h2], o[ct][2 * h2 + 1]);
        }
        __syncthreads();
        if (kb == 0) {
#pragma unroll
          for (int ct = 0; ct < DP / 8; ++ct)
#pragma unroll
            for (int h2 = 0; h2 < 2; ++h2) {
              const float2 x = *reinterpret_cast<const float2*>(
                  ov + (r0 + gq + h2 * 8) * DP + ct * 8 + t4 * 2);
              o[ct][2 * h2] += x.x;
              o[ct][2 * h2 + 1] += x.y;
            }
        }
        __syncthreads();
      }
    }
    // the next step's v and mask tiles (v and the tiles are read)
    if (f + WP < f1) v_load(f + WP);
    cp_async_commit();
    if (kb == 0 && fw < f1) {
      const long long w = fw;
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        bf16_t* orow = out + tok(a.o, w, hh, r0 + gq + h2 * 8);
#pragma unroll
        for (int ct = 0; ct < DP / 8; ++ct) {
          const int c = ct * 8 + t4 * 2;
          if (c < d)
            *reinterpret_cast<uint32_t*>(orow + c) =
                pack_bf16(o[ct][2 * h2], o[ct][2 * h2 + 1]);
        }
      }
    }
  }
  cp_async_wait_all();
}

// ---- the CUDA cores: fp32, and bf16 off the tensor-core shapes ----------------

// contiguous q [W, h, n, d], k / v [W, h, nk, d], out [W, h, n, d]; the
// tables tiled to bias [h, n, nk], mask [nW, n, nk] or null
struct CoreArgs {
  const void* q;
  const void* k;
  const void* v;
  const float* bias;
  const float* mask;
  void* out;
  int h, n, nk, d, nW;
  float scale;
};

constexpr int WNT = 128;

inline size_t generic_smem(int n, int nk, int d) {
  return sizeof(float) *
         ((size_t)n * d + (size_t)nk * (d + 1) * 2 + (WNT / 32) * (size_t)nk);
}

// one warp per query row, fp32 in shared memory; a CTA a (window, head)
template <typename T>
__global__ void __launch_bounds__(WNT) win_attn_kernel(const CoreArgs a) {
  extern __shared__ __align__(16) float sm[];
  const int n = a.n, nk = a.nk, d = a.d;
  const long long w = blockIdx.x;
  const int hh = blockIdx.y;
  float* q = sm;
  float* k = q + n * d;                 // row stride d + 1: conflict-free
  float* v = k + nk * (d + 1);
  float* pbuf = v + nk * (d + 1);       // one row of probabilities per warp

  const long long wh = w * a.h + hh;
  const T* qs = static_cast<const T*>(a.q) + wh * n * d;
  const T* ks = static_cast<const T*>(a.k) + wh * nk * d;
  const T* vs = static_cast<const T*>(a.v) + wh * nk * d;
  for (int e = threadIdx.x; e < n * d; e += WNT) q[e] = to_f(qs[e]);
  for (int e = threadIdx.x; e < nk * d; e += WNT) {
    const int j = e / d, c = e - j * d;
    k[j * (d + 1) + c] = to_f(ks[e]);
    v[j * (d + 1) + c] = to_f(vs[e]);
  }
  __syncthreads();

  const float* bias = a.bias + (long long)hh * n * nk;
  const float* mask = a.mask ? a.mask + (w % a.nW) * n * (long long)nk : nullptr;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* p = pbuf + warp * nk;
  T* out = static_cast<T*>(a.out) + wh * n * d;
  for (int i = warp; i < n; i += WNT / 32) {
    const float* qi = q + i * d;
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
    for (int j = lane; j < nk; j += 32) p[j] = to_f(from_f<T>(p[j] / sum));
    __syncwarp();
    for (int c = lane; c < d; c += 32) {
      float o = 0.f;
      for (int j = 0; j < nk; ++j) o = fmaf(p[j], v[j * (d + 1) + c], o);
      out[(long long)i * d + c] = from_f<T>(o);
    }
    __syncwarp();
  }
}

// ---- the launch plan ------------------------------------------------------------

// the windows a CTA takes: one wave of CTAs at the occupancy the kernel
// reaches (K9's sums do not depend on the chunks)
template <typename F>
cudaError_t launch_plan(F kernel, WinArgs a, int threads, size_t smem,
                        cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) !=
      cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                           smem)) != cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  int chunks = (sms * per_sm + a.h - 1) / a.h;
  chunks = max(1, min(chunks, a.W));
  a.per = (a.W + chunks - 1) / chunks;
  chunks = (a.W + a.per - 1) / a.per;
  kernel<<<dim3((unsigned)a.h, (unsigned)chunks), threads, smem, st>>>(a);
  return cudaGetLastError();
}

// an operand's base and strides allow copies of cb bytes
inline bool operand_aligned(const WinOperand& o, int cb) {
  const int e = cb / 2;  // bf16 elements
  return reinterpret_cast<uintptr_t>(o.p) % cb == 0 && o.sw % e == 0 &&
         o.sh % e == 0 && o.sb % e == 0 && o.st % e == 0;
}

// the tensor-core kernel at (N, NK), where the operands allow CB-byte
// copies, the output 4-byte stores and the tables fit shared memory
template <int N, int NK, int DP, int CB, int KS, int WP, bool BW, bool MW>
cudaError_t launch_mma(const WinArgs& a, cudaStream_t st, bool* done) {
  using S = MmaShape<N, NK, DP, KS, WP>;
  const size_t smem = S::bytes(a.bc, a.mr, a.mc, a.mask != nullptr);
  *done = (a.d * 2) % CB == 0 && operand_aligned(a.q, CB) &&
          operand_aligned(a.k, CB) && operand_aligned(a.v, CB) &&
          operand_aligned(a.o, 4) && smem <= 227 * 1024;
  if (!*done) return cudaSuccess;
  if (a.mask)
    return launch_plan(win_attn_mma_kernel<N, NK, DP, CB, KS, WP, true, BW, MW>,
                       a, S::NT, smem, st);
  return launch_plan(win_attn_mma_kernel<N, NK, DP, CB, KS, WP, false, BW, MW>,
                     a, S::NT, smem, st);
}

// the tensor-core kernel at the main path's shapes, with the tables as the
// blocks hand them over (the window's [64, 64] bias and mask, the encoder's
// grouped bias) or tiled whole; anything else is refused (the launcher's
// window_path sends it to the CUDA cores)
cudaError_t launch_mma_route(const WinArgs& a, cudaStream_t st) {
  const bool win_mask = a.mr == 64 && a.mc == 64, d64 = a.d > 32 && a.d <= 64;
  // (64, 64): two windows side by side, one below 512 (window, head) pairs,
  // where a launch of pairs would not fill the card
  const bool small = (long long)a.W * a.h < 512;
  bool done = false;
  cudaError_t err = cudaSuccess;
  if (d64 && a.n == 64 && a.nk == 64 && a.bc == 64 && (!a.mask || win_mask))
    err = small ? launch_mma<64, 64, 64, 16, 1, 1, false, false>(a, st, &done)
                : launch_mma<64, 64, 64, 16, 1, 2, false, false>(a, st, &done);
  else if (d64 && a.n == 64 && a.nk == 192 && a.bc == 64 && (!a.mask || win_mask))
    err = launch_mma<64, 192, 64, 16, 2, 1, true, true>(a, st, &done);
  else if (d64 && a.n == 64 && a.nk == 192 && a.bc == 192 &&
           (!a.mask || (a.mr == 64 && a.mc == 192)))
    err = launch_mma<64, 192, 64, 16, 2, 1, false, false>(a, st, &done);
  else if (a.d <= 32 && a.n == 192 && a.nk == 192 && a.bc == 192 &&
           (!a.mask || win_mask))
    err = launch_mma<192, 192, 32, 8, 1, 1, false, true>(a, st, &done);
  if (err != cudaSuccess) return err;
  return done ? cudaSuccess : cudaErrorInvalidValue;
}

template <typename T>
cudaError_t launch_cores(const CoreArgs& a, long long W, cudaStream_t st) {
  const size_t smem = generic_smem(a.n, a.nk, a.d);
  const cudaError_t err = cudaFuncSetAttribute(
      win_attn_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  win_attn_kernel<T><<<dim3((unsigned)W, (unsigned)a.h), WNT, smem, st>>>(a);
  return cudaGetLastError();
}

}  // namespace

// bf16 on the tensor cores, operands in place. desc: for q, k, v and out in
// turn, the strides (elements) of window, head, band and token, then the
// tokens of a band (long long [20])
extern "C" int fairm_window_attn_mma(const void* q, const void* k, const void* v,
                                     void* out, const void* bias,
                                     const void* mask, const void* desc,
                                     long long W, int h, int n, int nk, int d,
                                     int nW, int bc, int mr, int mc, float scale,
                                     void* stream) {
  if (W >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  const long long* s = static_cast<const long long*>(desc);
  auto operand = [&](const void* p, int i) {
    const long long* x = s + 5 * i;
    return WinOperand{const_cast<void*>(p), x[0], x[1], x[2], x[3], (int)x[4]};
  };
  WinArgs a{};
  a.q = operand(q, 0);
  a.k = operand(k, 1);
  a.v = operand(v, 2);
  a.o = operand(out, 3);
  a.bias = static_cast<const float*>(bias);
  a.mask = static_cast<const float*>(mask);
  a.W = (int)W;
  a.h = h;
  a.n = n;
  a.nk = nk;
  a.d = d;
  a.nW = nW;
  a.bc = bc;
  a.mr = mask ? mr : 1;
  a.mc = mask ? mc : 1;
  a.scale = scale;
  cudaError_t err = launch_mma_route(a, (cudaStream_t)stream);
  if (err == cudaSuccess) err = cudaGetLastError();
  return (int)err;
}

// the CUDA cores: contiguous operands, the tables tiled (CoreArgs)
extern "C" int fairm_window_attn(const void* q, const void* k, const void* v,
                                 const void* bias, const void* mask, void* out,
                                 int W, int h, int n, int nk, int d, int nW,
                                 float scale, int is_bf16, void* stream) {
  const CoreArgs a{q, k, v, (const float*)bias, (const float*)mask, out,
                   h, n, nk, d, nW, scale};
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = is_bf16 ? launch_cores<bf16_t>(a, W, st)
                            : launch_cores<float>(a, W, st);
  if (err == cudaSuccess) err = cudaGetLastError();
  return (int)err;
}
