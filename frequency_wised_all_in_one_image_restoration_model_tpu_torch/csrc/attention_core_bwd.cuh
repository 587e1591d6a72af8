// The tensor-core core of the window-attention backward in bf16, shared by
// K10 (window_attn_bwd.cu), K6 (lewin_attn_bwd.cu) and K8 (freq_inter_bwd.cu).
//
// Replaces, on the card, the per-window part of the Pallas kernels
// window_attention.py::_bwd_kernel (K10), lewin_block_bwd.py::
// _attn_bwd_kernel (K6) and lewin_block_bwd.py::_freq_inter_bwd_kernel (K8)
// (frequency_wised_all_in_one_image_restoration_model_tpu/ops/pallas/): for
// every window w and head hh, with q [n, d] and k, v [nk, d] of the window
// (K8: a group of the L = 3 band copies of a window, n = nk = 192), g the
// gradient of its output,
//   p  = softmax(scale q k^T + bias + mask)   (per-row max, fp32)
//   dp = g v^T,  dl = p (dp - rowsum(dp p)),  dv = p^T g,
//   dq = scale dl k,  dk = scale dl^T q,  dbias = sum over windows of dl
// and, for the blocks of K6 and K8 (BLK), og = p v and the all_DC terms
// (K6 at n = 64 only; K8's encoder has no lam):
//   out = (1 + lam) og - lam / n sum v,  g = dog = (1 + lam) dout,
//   dlam += sum dout (og - sum v / n),  dv += -lam / n sum dout.
// The mask is [nW, n, nk], or (mtile, K8) [nW, 64, 64] tiled over the
// logits: logit (i, j) of window w takes mask[w % nW][i % 64][j % 64].
// Rounding points: p and dl are rounded to bf16 before the products that
// take them (K6's twin rounds them there; K10's twin keeps them in fp32,
// which a bf16 product of them replaces by one bf16 rounding), dl and the
// row sums stay fp32 for dbias and dl itself, dq / dk / dv / out are rounded
// once from their fp32 accumulators.
//
// What bounds it on the H100: at the main path's shapes the bytes (q, k, v,
// g read, dq, dk, dv written: at d = 56 the five products' 2 n nk d
// multiply-adds are about 36 operations a byte, below the tensor cores'
// ridge of ~295). What the design does about it:
//  - one CTA of four warps owns one head and a chunk of consecutive windows
//    of one bias group and walks them in window order; k and v (all nk
//    keys) and 64 rows of q and g are staged in shared memory by cp.async,
//    the head dim zero-padded to DP = 32 or 64; the next window's k / v
//    loads are issued while the current one's columns are computed, its q /
//    g loads before the next row pass; at nk = 64 each thread keeps the bias
//    and the window's mask of its logits in registers;
//  - each warp owns 16 query rows: the logits, the softmax, dp, dl, og and
//    dq run on mma.sync m16n8k16 with fp32 accumulators, the accumulator
//    layout of p and dl reused as the A fragments of p v and dl k, so dq
//    is written once and complete (the CTA holds every key);
//  - p and dl go to shared memory as bf16 (64 x nk each) and never leave
//    the SM; dv = p^T g and dk = dl^T q take them through ldmatrix .trans,
//    each warp owning 16-key tiles;
//  - dbias without float atomics: the CTA adds each window's fp32 dl into a
//    64 x nk fp32 tile in shared memory, every thread the same fragment
//    elements every time, in window order; one partial per chunk is
//    written, and a reduce pass adds the chunks in chunk order (equal bits
//    on a second launch);
//  - n = 192 (the encoder's need_kv windows of K10 and K8's band groups,
//    d <= 32 only): the 192 x 192
//    fp32 dbias sum does not fit beside the rest, so the window loop holds
//    three 64-row query blocks; each block's 64 x 192 slice of the chunk's
//    partial is loaded into the tile (cp.async, overlapping the previous
//    block's column pass), added to and written back, in a fixed order by
//    one CTA (it stays in L2); dk / dv add the three blocks' fp32 products
//    in shared memory and are rounded once.
// The grid is one wave (the occupancy of the instance times the SMs), the
// chunks cut evenly over it.

#pragma once

#include "bwd_gemm.cuh"

namespace fairm {

__device__ __forceinline__ void cp_async8(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(gmem));
}

// row r of window w, head hh of an operand: base + w * w + hh * h + r * r
struct CoreView {
  long long w;
  int h, r;
};

struct CoreBwdArgs {
  const bf16_t* q;
  const bf16_t* k;
  const bf16_t* v;
  const void* g;       // bf16 (K10), or the fp32 dout of K6 / K8
  bf16_t* dq;
  bf16_t* dk;
  bf16_t* dv;
  bf16_t* out;         // K6 / K8: the attention rows, rounded
  CoreView vq, vkv, vg, vdq, vdkv, vout;
  const float* bias;   // [groups, h, n, nk]
  const float* mask;   // [nW, n, nk] (mtile: [nW, 64, 64]), window w taking
                       // mask[w % nW], or null
  const float* lam;    // K6: [W / nW, h], or null
  float* part;         // [groups, chunks, h, n, nk]: dbias chunk partials
  float* dlam_part;    // K6 with lam: [W, h]
  long long W;         // windows, groups x windows per group
  int h, d, nW, groups, per, chunks;
  int mtile;           // 1: the mask's 64 x 64 tile repeats over the logits
  float scale;
};

constexpr int CORE_NT = 128;

// shared-memory layout of one instance (byte offsets)
template <int N_, int NK_, int DP_, bool BLK_>
struct CoreShape {
  static constexpr int N = N_, NK = NK_, DP = DP_;
  static constexpr bool BLK = BLK_;
  static constexpr int QB = N / 64;        // 64-row query blocks a window
  static constexpr int LD = DP + 8;        // bf16 rows of q, g, k, v
  static constexpr int LDP = NK + 8;       // bf16 rows of p, dl
  static constexpr int LDA = NK + 8;       // fp32 rows of the dbias tile
  static constexpr int LDK = DP + 8;       // fp32 rows of dk / dv (QB > 1)
  static constexpr size_t OQ = 0;
  static constexpr size_t OG = OQ + 2 * 64 * LD;
  static constexpr size_t OK = OG + 2 * 64 * LD;
  static constexpr size_t OV = OK + 2 * NK * LD;
  static constexpr size_t OP = OV + 2 * NK * LD;
  static constexpr size_t ODL = OP + 2 * 64 * LDP;
  static constexpr size_t OA = ODL + 2 * 64 * LDP;
  static constexpr size_t OKV = OA + 4 * 64 * LDA;
  static constexpr size_t OX = OKV + (QB > 1 ? 4 * 2 * NK * LDK : 0);
  static constexpr size_t BYTES = OX + 4 * (2 * DP + 8);
};

template <class S>
__global__ void __launch_bounds__(CORE_NT) core_bwd_kernel(const CoreBwdArgs a) {
  constexpr int N = S::N, NK = S::NK, DP = S::DP, QB = S::QB;
  constexpr int LD = S::LD, LDP = S::LDP, LDA = S::LDA, LDK = S::LDK;
  constexpr int NT = NK / 8;                  // 8-key tiles of a logit row
  constexpr bool KEEP = NK <= 64;             // dp kept, else recomputed
  extern __shared__ __align__(16) unsigned char smem[];
  bf16_t* sq = reinterpret_cast<bf16_t*>(smem + S::OQ);
  bf16_t* sg = reinterpret_cast<bf16_t*>(smem + S::OG);
  bf16_t* sk = reinterpret_cast<bf16_t*>(smem + S::OK);
  bf16_t* sv = reinterpret_cast<bf16_t*>(smem + S::OV);
  bf16_t* sp = reinterpret_cast<bf16_t*>(smem + S::OP);
  bf16_t* sdl = reinterpret_cast<bf16_t*>(smem + S::ODL);
  float* tile = reinterpret_cast<float*>(smem + S::OA);
  float* kvacc = reinterpret_cast<float*>(smem + S::OKV);  // dk, then dv
  float* vsum = reinterpret_cast<float*>(smem + S::OX);    // BLK: sum v
  float* dosum = vsum + DP;                                // BLK: sum dout
  float* red = dosum + DP;                                 // BLK: 4 warps

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, t4 = lane & 3;     // accumulator row / column pair
  const int lq = lane >> 3, li = lane & 7;     // ldmatrix: matrix, its row
  const int hh = blockIdx.y, z = blockIdx.z;
  const long long Wg = a.W / a.groups;
  // the CTA's windows: t0 .. t1 - 1 of its bias group, in window order
  const long long t0 = (long long)blockIdx.x * a.per;
  const long long t1 = t0 + a.per < Wg ? t0 + a.per : Wg;
  auto win = [&](long long t) { return z * Wg + t; };
  const int d = a.d, d4 = d / 4;
  const float scale = a.scale;
  float* part = a.part + (((long long)z * a.chunks + blockIdx.x) * a.h + hh) *
                             (long long)N * NK;
  const float* bias = a.bias + ((long long)z * a.h + hh) * (long long)N * NK;

  // the head dim's pad columns of q, g, k, v (adjacent, rows of LD) are zero
  for (int e = tid; e < (128 + 2 * NK) * (DP - d); e += CORE_NT)
    sq[(e / (DP - d)) * LD + d + e % (DP - d)] = __float2bfloat16(0.f);
  for (int e = tid; e < 64 * LDA; e += CORE_NT) tile[e] = 0.f;

  auto load_kv = [&](long long w) {
    const bf16_t* kw = a.k + w * a.vkv.w + (long long)hh * a.vkv.h;
    const bf16_t* vw = a.v + w * a.vkv.w + (long long)hh * a.vkv.h;
    for (int e = tid; e < NK * d4; e += CORE_NT) {
      const int j = e / d4, c = (e - j * d4) * 4;
      cp_async8(sk + j * LD + c, kw + (long long)j * a.vkv.r + c);
      cp_async8(sv + j * LD + c, vw + (long long)j * a.vkv.r + c);
    }
  };
  // q and g of query block qb (K6's g: store_dout)
  auto load_qg = [&](long long w, int qb) {
    const bf16_t* qw = a.q + w * a.vq.w + (long long)hh * a.vq.h;
    for (int e = tid; e < 64 * d4; e += CORE_NT) {
      const int i = e / d4, c = (e - i * d4) * 4;
      cp_async8(sq + i * LD + c, qw + (long long)(qb * 64 + i) * a.vq.r + c);
    }
    if constexpr (!S::BLK) {
      const bf16_t* gw = static_cast<const bf16_t*>(a.g) + w * a.vg.w +
                         (long long)hh * a.vg.h;
      for (int e = tid; e < 64 * d4; e += CORE_NT) {
        const int i = e / d4, c = (e - i * d4) * 4;
        cp_async8(sg + i * LD + c, gw + (long long)(qb * 64 + i) * a.vg.r + c);
      }
    }
  };
  // BLK: g = (1 + lam) dout rounded, from fp32 dout rows qb * 64 .. + 63 of
  // the window (through registers), and with lam (n = 64 only) the column
  // sums of dout (from a copy in the p / dl tiles, which are free between
  // the column pass and the next row pass)
  float* scratch = reinterpret_cast<float*>(smem + S::OP);  // [64][DP] fp32
  auto store_dout = [&](long long w, int qb) {
    const float lam = a.lam ? a.lam[(w / a.nW) * a.h + hh] : 0.f;
    const float* gw = static_cast<const float*>(a.g) + w * a.vg.w +
                      (long long)hh * a.vg.h + (long long)qb * 64 * a.vg.r;
    for (int e = tid; e < 64 * d4; e += CORE_NT) {
      const int i = e / d4, c = (e - i * d4) * 4;
      const float4 t = *reinterpret_cast<const float4*>(gw + (long long)i * a.vg.r + c);
      uint2 u;
      u.x = pack_bf16((1.f + lam) * t.x, (1.f + lam) * t.y);
      u.y = pack_bf16((1.f + lam) * t.z, (1.f + lam) * t.w);
      *reinterpret_cast<uint2*>(sg + i * LD + c) = u;
      if (a.lam) *reinterpret_cast<float4*>(scratch + i * DP + c) = t;
    }
    if (a.lam) {
      __syncthreads();
      for (int c = tid; c < d; c += CORE_NT) {
        float sd = 0.f;
#pragma unroll 8
        for (int i = 0; i < 64; ++i) sd += scratch[i * DP + c];
        dosum[c] = sd;
      }
    }
  };
  // the dbias slice of query block qb: zeros for the chunk's first window,
  // else the running sum from the chunk's partial (n = 192 only)
  auto load_tile = [&](long long t, int qb) {
    if (t == t0) {
      for (int e = tid; e < 64 * LDA; e += CORE_NT) tile[e] = 0.f;
      return;
    }
    for (int e = tid; e < 64 * (NK / 4); e += CORE_NT) {
      const int r = e / (NK / 4), c = (e - r * (NK / 4)) * 4;
      cp_async16(tile + r * LDA + c, part + (long long)(qb * 64 + r) * NK + c, true);
    }
  };

  load_kv(win(t0));
  load_qg(win(t0), 0);
  cp_async_commit();
  if constexpr (S::BLK) store_dout(win(t0), 0);

  // nk = 64: the bias (fixed for the CTA) and the mask of the thread's
  // logits held in registers, the mask fetched as a window starts (its
  // loads overlap the logits' products)
  constexpr bool REGS = NK <= 64 && QB == 1;
  float bz[REGS ? NT : 1][4], mz[REGS ? NT : 1][4];
  long long mres = -1;  // the mask mz holds
  const int r0 = warp * 16;
  auto fetch_bm = [&](const float* t, float (&r)[REGS ? NT : 1][4]) {
#pragma unroll
    for (int nt = 0; nt < (REGS ? NT : 1); ++nt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const float2 v = __ldg(reinterpret_cast<const float2*>(
            t + (r0 + gq + hf * 8) * NK + nt * 8 + t4 * 2));
        r[nt][2 * hf] = v.x;
        r[nt][2 * hf + 1] = v.y;
      }
  };
  if (REGS) fetch_bm(bias, bz);
  for (long long t = t0; t < t1; ++t) {
    const long long w = win(t);
    const float* mask =
        a.mask ? a.mask + (w % a.nW) * (a.mtile ? 64LL * 64 : (long long)N * NK)
               : nullptr;
    const float lam = S::BLK && a.lam ? a.lam[(w / a.nW) * a.h + hh] : 0.f;
    if (REGS && mask && w % a.nW != mres) {
      fetch_bm(mask, mz);
      mres = w % a.nW;
    }
    for (int qb = 0; qb < QB; ++qb) {
      cp_async_wait_all();
      __syncthreads();
      if constexpr (S::BLK) {
        if (a.lam) {  // sum v over the window's rows, in order
          for (int c = tid; c < d; c += CORE_NT) {
            float sv_ = 0.f;
#pragma unroll 8
            for (int j = 0; j < NK; ++j) sv_ += __bfloat162float(sv[j * LD + c]);
            vsum[c] = sv_;
          }
          __syncthreads();
        }
      }

      // ---- row pass: warp's rows qb * 64 + r0 .. + 16 ----------------------
      const int il = r0 + gq;          // local row of elements 0, 1 (+8: 2, 3)
      const int ig = qb * 64 + il;     // row in the window
      float s[NT][4];
      {
        uint32_t qf[DP / 16][4];
#pragma unroll
        for (int kk = 0; kk < DP / 16; ++kk)
          ldmatrix_x4(qf[kk], sq + (r0 + (lane & 15)) * LD + kk * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
#pragma unroll
          for (int kk = 0; kk < DP / 16; ++kk) {
            uint32_t t[4];
            ldmatrix_x4(t, sk + (np * 16 + li + ((lane >> 4) << 3)) * LD + kk * 16 +
                               ((lane >> 3) & 1) * 8);
            const uint32_t b0[2] = {t[0], t[1]}, b1[2] = {t[2], t[3]};
            mma_bf16_16816(s[2 * np], qf[kk], b0);
            mma_bf16_16816(s[2 * np + 1], qf[kk], b1);
          }
        }
      }
      // scale, bias, mask; per-row max softmax in fp32
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const long long o = (long long)(ig + hf * 8) * NK + nt * 8 + t4 * 2;
          const float2 b =
              REGS ? make_float2(bz[REGS ? nt : 0][2 * hf], bz[REGS ? nt : 0][2 * hf + 1])
                   : __ldg(reinterpret_cast<const float2*>(bias + o));
          float v0 = s[nt][2 * hf] * scale + b.x, v1 = s[nt][2 * hf + 1] * scale + b.y;
          if (mask) {
            const long long om =
                a.mtile ? (((ig + hf * 8) & 63) * 64 + ((nt * 8 + t4 * 2) & 63)) : o;
            const float2 m =
                REGS ? make_float2(mz[REGS ? nt : 0][2 * hf], mz[REGS ? nt : 0][2 * hf + 1])
                     : __ldg(reinterpret_cast<const float2*>(mask + om));
            v0 += m.x;
            v1 += m.y;
          }
          s[nt][2 * hf] = v0;
          s[nt][2 * hf + 1] = v1;
          mx[hf] = fmaxf(mx[hf], fmaxf(v0, v1));
        }
      float sum[2] = {0.f, 0.f};
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        mx[hf] = fmaxf(mx[hf], __shfl_xor_sync(0xffffffffu, mx[hf], 1));
        mx[hf] = fmaxf(mx[hf], __shfl_xor_sync(0xffffffffu, mx[hf], 2));
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float ex = expf(s[nt][e] - mx[e >> 1]);
          s[nt][e] = ex;
          sum[e >> 1] += ex;
        }
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        sum[hf] += __shfl_xor_sync(0xffffffffu, sum[hf], 1);
        sum[hf] += __shfl_xor_sync(0xffffffffu, sum[hf], 2);
      }
      // p, and p rounded to bf16 into shared memory for dv = p^T g
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] = s[nt][e] / sum[e >> 1];
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
          *reinterpret_cast<uint32_t*>(sp + (il + hf * 8) * LDP + nt * 8 + t4 * 2) =
              pack_bf16(s[nt][2 * hf], s[nt][2 * hf + 1]);
      }

      if constexpr (S::BLK) {  // og = p v; out; the dlam partial
        float og[DP / 8][4];
#pragma unroll
        for (int ct = 0; ct < DP / 8; ++ct)
#pragma unroll
          for (int e = 0; e < 4; ++e) og[ct][e] = 0.f;
#pragma unroll
        for (int j = 0; j < NK / 16; ++j) {
          uint32_t pf[4];
          pf[0] = pack_bf16(s[2 * j][0], s[2 * j][1]);
          pf[1] = pack_bf16(s[2 * j][2], s[2 * j][3]);
          pf[2] = pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]);
          pf[3] = pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3]);
#pragma unroll
          for (int cp = 0; cp < DP / 16; ++cp) {
            uint32_t t[4];
            ldmatrix_x4_trans(t, sv + (j * 16 + li + (lq & 1) * 8) * LD + cp * 16 +
                                     (lq >> 1) * 8);
            const uint32_t b0[2] = {t[0], t[1]}, b1[2] = {t[2], t[3]};
            mma_bf16_16816(og[2 * cp], pf, b0);
            mma_bf16_16816(og[2 * cp + 1], pf, b1);
          }
        }
        const float* gw = static_cast<const float*>(a.g) + w * a.vg.w +
                          (long long)hh * a.vg.h;
        bf16_t* ow = a.out + w * a.vout.w + (long long)hh * a.vout.h;
        float clam = 0.f;
        const float inv_n = 1.f / N;
#pragma unroll
        for (int ct = 0; ct < DP / 8; ++ct) {
          const int c = ct * 8 + t4 * 2;
          if (c >= d) continue;
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const int i = ig + hf * 8;
            float o0 = og[ct][2 * hf], o1 = og[ct][2 * hf + 1];
            if (a.lam) {
              const float2 dd =
                  *reinterpret_cast<const float2*>(gw + (long long)i * a.vg.r + c);
              clam += dd.x * (o0 - vsum[c] / N);
              clam += dd.y * (o1 - vsum[c + 1] / N);
              o0 = (1.f + lam) * o0 - (lam * inv_n) * vsum[c];
              o1 = (1.f + lam) * o1 - (lam * inv_n) * vsum[c + 1];
            }
            *reinterpret_cast<uint32_t*>(ow + (long long)i * a.vout.r + c) =
                pack_bf16(o0, o1);
          }
        }
        if (a.lam) {
          clam = warp_sum(clam);
          if (lane == 0) red[warp] = clam;
        }
      }

      // dp = g v^T, its row sums with p, dl = p (dp - rowsum)
      {
        uint32_t gf[DP / 16][4];
#pragma unroll
        for (int kk = 0; kk < DP / 16; ++kk)
          ldmatrix_x4(gf[kk], sg + (r0 + (lane & 15)) * LD + kk * 16 + (lane >> 4) * 8);
        auto dp_pair = [&](int np, float (&a0)[4], float (&a1)[4]) {
#pragma unroll
          for (int e = 0; e < 4; ++e) a0[e] = a1[e] = 0.f;
#pragma unroll
          for (int kk = 0; kk < DP / 16; ++kk) {
            uint32_t t[4];
            ldmatrix_x4(t, sv + (np * 16 + li + ((lane >> 4) << 3)) * LD + kk * 16 +
                               ((lane >> 3) & 1) * 8);
            const uint32_t b0[2] = {t[0], t[1]}, b1[2] = {t[2], t[3]};
            mma_bf16_16816(a0, gf[kk], b0);
            mma_bf16_16816(a1, gf[kk], b1);
          }
        };
        float dpk[KEEP ? NT : 2][4];
        float dot[2] = {0.f, 0.f};
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          float a0[4], a1[4];
          dp_pair(np, a0, a1);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            dot[e >> 1] = fmaf(a0[e], s[2 * np][e], dot[e >> 1]);
            dot[e >> 1] = fmaf(a1[e], s[2 * np + 1][e], dot[e >> 1]);
            if (KEEP) {
              dpk[KEEP ? 2 * np : 0][e] = a0[e];
              dpk[KEEP ? 2 * np + 1 : 1][e] = a1[e];
            }
          }
        }
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          dot[hf] += __shfl_xor_sync(0xffffffffu, dot[hf], 1);
          dot[hf] += __shfl_xor_sync(0xffffffffu, dot[hf], 2);
        }
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          float a0[4], a1[4];
          if (KEEP) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              a0[e] = dpk[KEEP ? 2 * np : 0][e];
              a1[e] = dpk[KEEP ? 2 * np + 1 : 1][e];
            }
          } else {
            dp_pair(np, a0, a1);
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            s[2 * np][e] = s[2 * np][e] * (a0[e] - dot[e >> 1]);
            s[2 * np + 1][e] = s[2 * np + 1][e] * (a1[e] - dot[e >> 1]);
          }
        }
      }
      // dl: into the dbias tile (fp32) and, rounded, into shared memory
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int o = (il + hf * 8) * LDA + nt * 8 + t4 * 2;
          float2 t = *reinterpret_cast<float2*>(tile + o);
          t.x += s[nt][2 * hf];
          t.y += s[nt][2 * hf + 1];
          *reinterpret_cast<float2*>(tile + o) = t;
          *reinterpret_cast<uint32_t*>(sdl + (il + hf * 8) * LDP + nt * 8 + t4 * 2) =
              pack_bf16(s[nt][2 * hf], s[nt][2 * hf + 1]);
        }
      {  // dq = scale dl k, complete
        float acc[DP / 8][4];
#pragma unroll
        for (int ct = 0; ct < DP / 8; ++ct)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[ct][e] = 0.f;
#pragma unroll
        for (int j = 0; j < NK / 16; ++j) {
          uint32_t pf[4];
          pf[0] = pack_bf16(s[2 * j][0], s[2 * j][1]);
          pf[1] = pack_bf16(s[2 * j][2], s[2 * j][3]);
          pf[2] = pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]);
          pf[3] = pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3]);
#pragma unroll
          for (int cp = 0; cp < DP / 16; ++cp) {
            uint32_t t[4];
            ldmatrix_x4_trans(t, sk + (j * 16 + li + (lq & 1) * 8) * LD + cp * 16 +
                                     (lq >> 1) * 8);
            const uint32_t b0[2] = {t[0], t[1]}, b1[2] = {t[2], t[3]};
            mma_bf16_16816(acc[2 * cp], pf, b0);
            mma_bf16_16816(acc[2 * cp + 1], pf, b1);
          }
        }
        bf16_t* dqw = a.dq + w * a.vdq.w + (long long)hh * a.vdq.h;
#pragma unroll
        for (int ct = 0; ct < DP / 8; ++ct) {
          const int c = ct * 8 + t4 * 2;
          if (c >= d) continue;
#pragma unroll
          for (int hf = 0; hf < 2; ++hf)
            *reinterpret_cast<uint32_t*>(dqw + (long long)(ig + hf * 8) * a.vdq.r + c) =
                pack_bf16(acc[ct][2 * hf] * scale, acc[ct][2 * hf + 1] * scale);
        }
      }
      __syncthreads();  // p, dl and the tile are complete; k, v are read out

      if constexpr (S::BLK) {
        if (a.lam && tid == 0)
          a.dlam_part[w * a.h + hh] = ((red[0] + red[1]) + red[2]) + red[3];
      }
      if (QB > 1) {  // the block's running dbias slice back to the partial
        for (int e = tid; e < 64 * (NK / 4); e += CORE_NT) {
          const int r = e / (NK / 4), c = (e - r * (NK / 4)) * 4;
          *reinterpret_cast<float4*>(part + (long long)(qb * 64 + r) * NK + c) =
              *reinterpret_cast<const float4*>(tile + r * LDA + c);
        }
      }
      if (qb == QB - 1 && t + 1 < t1) load_kv(win(t + 1));
      cp_async_commit();

      // ---- column pass: dv = p^T g, dk = scale dl^T q, 16-key tiles -------
      for (int kt = warp; kt < NK / 16; kt += CORE_NT / 32) {
        float av[DP / 8][4], ak[DP / 8][4];
#pragma unroll
        for (int ct = 0; ct < DP / 8; ++ct)
#pragma unroll
          for (int e = 0; e < 4; ++e) av[ct][e] = ak[ct][e] = 0.f;
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
          uint32_t ap[4], al[4];
          const int ao = (ks * 16 + (lq >> 1) * 8 + li) * LDP + kt * 16 + (lq & 1) * 8;
          ldmatrix_x4_trans(ap, sp + ao);
          ldmatrix_x4_trans(al, sdl + ao);
#pragma unroll
          for (int cp = 0; cp < DP / 16; ++cp) {
            const int bo = (ks * 16 + (lq & 1) * 8 + li) * LD + cp * 16 + (lq >> 1) * 8;
            uint32_t t[4];
            ldmatrix_x4_trans(t, sg + bo);
            const uint32_t g0[2] = {t[0], t[1]}, g1[2] = {t[2], t[3]};
            mma_bf16_16816(av[2 * cp], ap, g0);
            mma_bf16_16816(av[2 * cp + 1], ap, g1);
            ldmatrix_x4_trans(t, sq + bo);
            const uint32_t q0[2] = {t[0], t[1]}, q1[2] = {t[2], t[3]};
            mma_bf16_16816(ak[2 * cp], al, q0);
            mma_bf16_16816(ak[2 * cp + 1], al, q1);
          }
        }
        bf16_t* dkw = a.dk + w * a.vdkv.w + (long long)hh * a.vdkv.h;
        bf16_t* dvw = a.dv + w * a.vdkv.w + (long long)hh * a.vdkv.h;
#pragma unroll
        for (int ct = 0; ct < DP / 8; ++ct) {
          const int c = ct * 8 + t4 * 2;
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const int j = kt * 16 + gq + hf * 8;
            float k0 = ak[ct][2 * hf], k1 = ak[ct][2 * hf + 1];
            float v0 = av[ct][2 * hf], v1 = av[ct][2 * hf + 1];
            if (QB > 1) {  // this block's products into the window's sums
              float* pk = kvacc + j * LDK + c;
              float* pv = kvacc + NK * LDK + j * LDK + c;
              if (qb > 0) {
                k0 += pk[0];
                k1 += pk[1];
                v0 += pv[0];
                v1 += pv[1];
              }
              if (qb < QB - 1) {
                pk[0] = k0;
                pk[1] = k1;
                pv[0] = v0;
                pv[1] = v1;
                continue;
              }
            }
            if (c >= d) continue;
            if constexpr (S::BLK) {
              if (a.lam) {
                v0 += (-lam / N) * dosum[c];
                v1 += (-lam / N) * dosum[c + 1];
              }
            }
            *reinterpret_cast<uint32_t*>(dkw + (long long)j * a.vdkv.r + c) =
                pack_bf16(k0 * scale, k1 * scale);
            *reinterpret_cast<uint32_t*>(dvw + (long long)j * a.vdkv.r + c) =
                pack_bf16(v0, v1);
          }
        }
      }
      __syncthreads();  // q, g, p, dl (and the tile's write-back) are read out

      // the next query block's (or window's) q / g and dbias slice
      const long long tn = qb + 1 < QB ? t : t + 1;
      const int qn = qb + 1 < QB ? qb + 1 : 0;
      if (tn < t1) {
        load_qg(win(tn), qn);
        if (QB > 1) load_tile(tn, qn);
      }
      cp_async_commit();
      if constexpr (S::BLK) {
        if (tn < t1) store_dout(win(tn), qn);
      }
    }
  }

  if (QB == 1) {  // the chunk's dbias partial (the loop ended on a barrier)
    for (int e = tid; e < 64 * (NK / 4); e += CORE_NT) {
      const int r = e / (NK / 4), c = (e - r * (NK / 4)) * 4;
      *reinterpret_cast<float4*>(part + (long long)r * NK + c) =
          *reinterpret_cast<const float4*>(tile + r * LDA + c);
    }
  }
}

// 1 if the core takes (n, nk, d) (bf16; the blocks of K6 and K8: n = nk =
// 64 or 192, lam only at 64)
inline bool core_covers(int n, int nk, int d, bool blk) {
  if (d % 4 || d < 4 || d > 64) return false;
  if (n == 64 && nk == 64) return true;
  if (n == 192 && nk == 192 && d <= 32) return true;
  return !blk && n == 64 && nk == 192;
}

// f(CoreShape<...>{}) for the instance of (n, nk, d); core_covers first
template <bool BLK, class F>
inline cudaError_t core_dispatch(int n, int nk, int d, F&& f) {
  const bool p32 = d <= 32;
  if (n == 64 && nk == 64)
    return p32 ? f(CoreShape<64, 64, 32, BLK>{}) : f(CoreShape<64, 64, 64, BLK>{});
  if (n == 192 && nk == 192 && p32) return f(CoreShape<192, 192, 32, BLK>{});
  if constexpr (!BLK) {
    if (n == 64 && nk == 192)
      return p32 ? f(CoreShape<64, 192, 32, false>{})
                 : f(CoreShape<64, 192, 64, false>{});
  }
  return cudaErrorInvalidValue;
}

// CTAs of one wave of an instance: its occupancy times the SMs (0 on error)
template <class S>
inline int core_wave() {
  static const int wave = [] {
    if (cudaFuncSetAttribute(core_bwd_kernel<S>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)S::BYTES) != cudaSuccess)
      return 0;
    int occ = 0, dev = 0, sms = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &occ, core_bwd_kernel<S>, CORE_NT, S::BYTES) != cudaSuccess ||
        cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      return 0;
    return (occ > 0 ? occ : 1) * sms;
  }();
  return wave;
}

// chunks of windows per bias group: one wave of CTAs over (chunks, h,
// groups), at most ``cap`` chunks; sets a.per and a.chunks
template <class S>
inline cudaError_t core_chunking(CoreBwdArgs& a, long long cap) {
  const int wave = core_wave<S>();
  if (!wave) return cudaErrorInvalidValue;
  const long long Wg = a.W / a.groups;
  const long long units = (long long)a.h * a.groups;
  long long c = (wave + units - 1) / units;
  if (c > cap) c = cap;
  if (c > Wg) c = Wg;
  if (c < 1) c = 1;
  const long long per = (Wg + c - 1) / c;
  a.per = (int)per;
  a.chunks = (int)((Wg + per - 1) / per);
  return cudaSuccess;
}

// the core's launch (a.per / a.chunks from core_chunking), then dbias[z] =
// sum of the chunk partials in chunk order
template <class S>
inline cudaError_t core_launch(const CoreBwdArgs& a, float* dbias, cudaStream_t st) {
  if (S::BLK && S::QB > 1 && a.lam) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(core_bwd_kernel<S>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)S::BYTES);
  if (err != cudaSuccess) return err;
  core_bwd_kernel<S><<<dim3((unsigned)a.chunks, (unsigned)a.h, (unsigned)a.groups),
                       CORE_NT, S::BYTES, st>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const long long per_group = (long long)a.h * S::N * S::NK;
  for (int z = 0; z < a.groups; ++z)
    launch_reduce8(a.part + z * a.chunks * per_group, dbias + z * per_group,
                   a.chunks, per_group, st);
  return cudaGetLastError();
}

}  // namespace fairm
