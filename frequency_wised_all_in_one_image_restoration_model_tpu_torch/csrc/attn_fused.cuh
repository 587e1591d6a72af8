// The attention half of a LeWin block on the SM, one 64-token window at a
// time (bf16, kpad(C) <= 224, head dims d <= 64):
//   out[rows] = [res +] dps * proj(window_attention(LN1(x[rows])))
// for the window's 64 rows of a RowMap (the window partition, with the
// SW-MSA shift where the caller folds the roll in). K1 (lewin_attn.cu)
// launches it over every window; the merged kernel K4 (merged.cuh) runs it
// as its first phase.
//
// A block of 128 threads (four warps, 16 rows each):
//  1. gathers the window's 64 rows of x into shared memory (cp.async, 8
//     bytes a copy, all in flight at once) and LayerNorms them in place
//     (fp32 statistics, rounded to bf16 as the model's dtype);
//  2. for each group of up to 64 / DP heads (DP: the head dims d
//     zero-padded to 32 or 64), forms q, k and v ([64, 64] each, the
//     group's heads side by side; [64, 32] for a single head of DP = 32) on
//     mma.sync against the group's rows of Wqkv, streamed from L2 in steps
//     of 32 columns through a ring of FA_STAGES cp.async buffers; + bqkv,
//     rounded to bf16;
//  3. runs each head's attention on the tensor cores (attention.cuh's
//     attn_mma_core: bias, the SW-MSA mask, the all_DC gain) into the
//     window's attention rows, all heads side by side in shared memory;
//  4. projects them through Wp, 64 output columns at a time, from the same
//     ring; + bp, x dps[image], + the residual, written to the image rows.
// No row of the half reaches device memory but the output. Rounding points
// are the four-pass chain's: LN1(x), q / k / v and the attention rows in
// bf16, every product accumulated in fp32.

#pragma once

#include "attention.cuh"

namespace fairm {

struct FusedAttnArgs {
  const bf16_t* x;      // LN1's input, rows through map
  const float *lns, *lnb;
  float eps;
  const bf16_t* wqkv;   // [3C, kpad(C)], the d^-0.5 scale in q
  const float* bqkv;    // [3C]
  const bf16_t* wp;     // [C, kpad(C)]
  const float* bp;      // [C]
  const float* bias;    // [groups, h, 64, 64]
  const float* mask;    // [nW, 64, 64] additive, or null
  const float* lam;     // [B, h] all_DC gain, or null
  const float* dps;     // [B] DropPath scale, or null
  const bf16_t* res;    // the residual in out's layout, or null
  bf16_t* out;          // rows through map
  RowMap map;           // window-major logical row -> physical row
  int C, h, imgs_per_bias;
};

constexpr int FA_N = 64;        // tokens of a window
constexpr int FA_KC = 32;       // weight columns a step
constexpr int FA_STAGES = 5;    // the ring of weight steps
constexpr int FA_WROWS = 64;    // weight rows a step
constexpr int FA_LDW = FA_KC + 8;

constexpr int FA_QW = 64;        // the widest q / k / v tile: a head group

// the columns of the q / k / v tiles for h heads of dims padded to dp: a
// group of 64 / dp heads side by side, or one head of 32
__host__ __device__ inline int fused_attn_qw(int h, int dp) {
  return h * dp >= FA_QW ? FA_QW : dp;
}

// the shared-memory layout (byte offsets) for rows of kpad(C) columns and
// h heads of dims padded to dp; +8 elements a row keep ldmatrix's rows on
// distinct banks
struct FusedAttnLayout {
  int ldx, ldq;                  // row strides (elements): LN1 / attention, q / k / v
  size_t ox, oo, oq, ow, os, orow, bytes;
};

__host__ __device__ inline FusedAttnLayout fused_attn_layout(int C, int h,
                                                             int dp) {
  FusedAttnLayout L;
  L.ldx = kpad(C) + 8;
  L.ldq = fused_attn_qw(h, dp) + 8;
  L.ox = 0;                                            // [64][ldx] LN1 rows
  L.oo = L.ox + 2 * FA_N * L.ldx;                      // [64][ldx] attention rows
  L.oq = L.oo + 2 * FA_N * L.ldx;                      // q, k, v [64][ldq]
  L.ow = L.oq + 2 * 3 * FA_N * L.ldq;                  // [STAGES][64][LDW]
  L.os = L.ow + 2 * FA_STAGES * FA_WROWS * FA_LDW;     // vsum [64] fp32
  L.orow = L.os + 4 * FA_QW;                           // [64] physical rows
  L.bytes = L.orow + 8 * FA_N;
  return L;
}

__device__ __forceinline__ void cp_async8(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(gmem));
}

// LayerNorm in place of ``rows`` bf16 rows of C columns (C a multiple of
// 4, at most 256) and row stride ld, a warp a row (warp of nwarps), the
// row's vectors in registers: fp32 statistics, rounded to bf16. K1's and
// K4's window half and K5's band groups run it.
__device__ __forceinline__ void ln_rows(bf16_t* xs, int ld, int rows, int C,
                                        const float* lns, const float* lnb,
                                        float eps, int warp, int nwarps) {
  const int lane = threadIdx.x & 31, c4 = C / 4;
  for (int t = warp; t < rows; t += nwarps) {
    Vec4<bf16_t>* row = reinterpret_cast<Vec4<bf16_t>*>(xs + t * ld);
    float v[2][4];
    float s = 0.f;
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int c = lane + 32 * u;
      const bool ok = c < c4;
      Vec4<bf16_t> e;
      if (ok) e = row[c];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        v[u][i] = ok ? to_f(e.v[i]) : 0.f;
        s += v[u][i];
      }
    }
    const float mu = warp_sum(s) / C;
    float var = 0.f;
#pragma unroll
    for (int u = 0; u < 2; ++u)
      if (lane + 32 * u < c4)
#pragma unroll
        for (int i = 0; i < 4; ++i) var += (v[u][i] - mu) * (v[u][i] - mu);
    const float rs = rsqrtf(warp_sum(var) / C + eps);
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int c = lane + 32 * u;
      if (c >= c4) continue;
      Vec4<bf16_t> e;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        e.v[i] = from_f<bf16_t>((v[u][i] - mu) * rs * lns[4 * c + i] +
                                lnb[4 * c + i]);
      row[c] = e;
    }
  }
}

// the zero pad columns of the LN1 and attention rows, once per block
template <int DP>
__device__ __forceinline__ void fused_attn_init(const FusedAttnArgs& a,
                                                unsigned char* sm) {
  const FusedAttnLayout L = fused_attn_layout(a.C, a.h, DP);
  bf16_t* xs = reinterpret_cast<bf16_t*>(sm + L.ox);
  bf16_t* os = reinterpret_cast<bf16_t*>(sm + L.oo);
  const int pad = L.ldx - a.C;
  for (int e = threadIdx.x; e < FA_N * pad; e += ANT) {
    const int r = e / pad, c = a.C + e % pad;
    xs[r * L.ldx + c] = from_f<bf16_t>(0.f);
    os[r * L.ldx + c] = from_f<bf16_t>(0.f);
  }
}

// the attention of head group grp (hg heads side by side in the q / k / v
// tiles of row stride LDQ) into the attention rows os
template <int DP, int LDQ>
__device__ __forceinline__ void fused_attn_heads(
    const FusedAttnArgs& a, const bf16_t* q, const bf16_t* k, const bf16_t* v,
    float* vsum, bf16_t* os, int ldx, int grp, int hg, long long b, int wi,
    int warp) {
  const int h = a.h, d = a.C / a.h;
  if (a.lam) {
    attn_vsum<FA_N, LDQ>(v, hg * DP, vsum);
    __syncthreads();
  }
  for (int j = 0; j < hg; ++j) {
    const int hh = grp * hg + j;
    if (hh >= h) break;
    const float* bias =
        a.bias + ((b / a.imgs_per_bias) * h + hh) * (long long)FA_N * FA_N;
    const float* mask = a.mask ? a.mask + (long long)wi * FA_N * FA_N : nullptr;
    attn_mma_core<FA_N, DP, LDQ>(q + j * DP, k + j * DP, v + j * DP,
                                 vsum + j * DP, bias, mask, FA_N, d,
                                 a.lam ? a.lam + b * h + hh : nullptr,
                                 os + hh * d, ldx, warp);
  }
}

// window g (of the logical rows g * 64 ...); ends with a barrier
template <int DP>
__device__ __forceinline__ void fused_attn_window(const FusedAttnArgs& a,
                                                  long long g, int nW,
                                                  unsigned char* sm) {
  const FusedAttnLayout L = fused_attn_layout(a.C, a.h, DP);
  const int LDX = L.ldx, LDQ = L.ldq;
  bf16_t* xs = reinterpret_cast<bf16_t*>(sm + L.ox);
  bf16_t* os = reinterpret_cast<bf16_t*>(sm + L.oo);
  bf16_t* qkv_s = reinterpret_cast<bf16_t*>(sm + L.oq);
  bf16_t* ws = reinterpret_cast<bf16_t*>(sm + L.ow);
  float* vsum = reinterpret_cast<float*>(sm + L.os);
  long long* s_row = reinterpret_cast<long long*>(sm + L.orow);

  const int C = a.C, h = a.h, d = C / h, kp = kpad(C);
  const int qw = fused_attn_qw(h, DP);           // q / k / v columns
  const int HG = qw / DP;                        // heads a group
  const int KS = kp / FA_KC;                     // steps of a weight slice
  const int NG = (h + HG - 1) / HG;              // head groups
  const int NC = (C + FA_WROWS - 1) / FA_WROWS;  // proj column chunks
  const int steps = (3 * NG + NC) * KS;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, t4 = lane & 3;
  const long long b = g / nW;
  const int wi = (int)(g - b * nW);

  // weight step i into ring stage st: 64 rows x 32 columns; a qkv slice's
  // row r is row r % DP of head group * HG + r / DP of its part, zero past
  // d and past the heads; a projection slice's rows past C are zero
  auto load_step = [&](int st, int i) {
    bf16_t* dst = ws + st * FA_WROWS * FA_LDW;
    const int kc = i % KS, slice = i / KS;
    const bool qkv = slice < 3 * NG;
    const bf16_t* W = qkv ? a.wqkv : a.wp;
    const int rows = qkv ? qw : FA_WROWS;
    for (int c = tid; c < rows * (FA_KC / 8); c += ANT) {
      const int r = c >> 2, j = (c & 3) * 8;
      int row;
      bool ok;
      if (qkv) {
        const int head = (slice / 3) * HG + r / DP, rr = r % DP;
        ok = head < h && rr < d;
        row = (slice % 3) * C + head * d + rr;
      } else {
        row = (slice - 3 * NG) * FA_WROWS + r;
        ok = row < C;
      }
      cp_async16(dst + r * FA_LDW + j,
                 W + (long long)(ok ? row : 0) * kp + kc * FA_KC + j, ok);
    }
  };

  __syncthreads();  // the last window's readers of s_row, xs and the ring
  // the window's rows, 8 bytes a copy, then the first weight steps
  const int c4 = C / 4;
  for (int e = tid; e < FA_N * c4; e += ANT) {
    const int t = e / c4, c = e - t * c4;
    const long long pc = map_row(a.map, g * FA_N + t);
    if (c == 0) s_row[t] = pc;
    cp_async8(xs + t * LDX + 4 * c, a.x + pc * C + 4 * c);
  }
  cp_async_commit();
#pragma unroll
  for (int s = 0; s < FA_STAGES - 1; ++s) {
    if (s < steps) load_step(s, s);
    cp_async_commit();
  }
  asm volatile("cp.async.wait_group %0;\n" ::"n"(FA_STAGES - 1));
  __syncthreads();

  ln_rows(xs, LDX, FA_N, C, a.lns, a.lnb, a.eps, warp, ANT / 32);

  const float scale = a.dps ? a.dps[b] : 1.f;
  float acc[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;

  for (int i = 0; i < steps; ++i) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(FA_STAGES - 2));
    __syncthreads();
    const int nxt = i + FA_STAGES - 1;
    if (nxt < steps) load_step(nxt % FA_STAGES, nxt);
    cp_async_commit();

    const bf16_t* wst = ws + (i % FA_STAGES) * FA_WROWS * FA_LDW;
    const int kc = i % KS, slice = i / KS;
    const bool qkv_step = slice < 3 * NG;
    const bf16_t* A = qkv_step ? xs : os;
    const int ncols = qkv_step ? qw : FA_WROWS;
#pragma unroll
    for (int kk = 0; kk < FA_KC; kk += 16) {
      uint32_t af[4];
      ldmatrix_x4(af, A + (warp * 16 + (lane & 15)) * LDX + kc * FA_KC + kk +
                          (lane >> 4) * 8);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        if (np * 16 >= ncols) break;
        uint32_t t[4];
        const int nr = np * 16 + (lane & 7) + ((lane >> 4) << 3);
        ldmatrix_x4(t, wst + nr * FA_LDW + kk + ((lane >> 3) & 1) * 8);
        const uint32_t b0[2] = {t[0], t[1]}, b1[2] = {t[2], t[3]};
        mma_bf16_16816(acc[2 * np], af, b0);
        mma_bf16_16816(acc[2 * np + 1], af, b1);
      }
    }
    if (kc != KS - 1) continue;

    if (qkv_step) {
      // + bqkv, rounded to bf16, into q, k or v of this head group
      const int part = slice % 3, grp = slice / 3;
      bf16_t* dst = qkv_s + part * FA_N * LDQ;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = warp * 16 + gq + (e >= 2 ? 8 : 0);
          const int c = nt * 8 + t4 * 2 + (e & 1);
          const int head = grp * HG + c / DP, cc = c % DP;
          const bool ok = c < qw && head < h && cc < d;
          if (c < qw)
            dst[r * LDQ + c] = from_f<bf16_t>(
                ok ? acc[nt][e] + a.bqkv[part * C + head * d + cc] : 0.f);
          acc[nt][e] = 0.f;
        }
      if (part == 2) {
        // each head's attention over the whole window
        const bf16_t* q = qkv_s;
        const bf16_t* k = q + FA_N * LDQ;
        const bf16_t* v = k + FA_N * LDQ;
        __syncthreads();
        // the tiles' row stride: one head's (DP + 8) or a group's
        if (qw == DP)
          fused_attn_heads<DP, DP + 8>(a, q, k, v, vsum, os, LDX, grp, 1, b,
                                       wi, warp);
        else
          fused_attn_heads<DP, FA_QW + 8>(a, q, k, v, vsum, os, LDX, grp,
                                          FA_QW / DP, b, wi, warp);
      }
    } else {
      // + bp, x dps, + residual, to the image rows
      const int col0 = (slice - 3 * NG) * FA_WROWS;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {
          const int r = warp * 16 + gq + 8 * h2;
          const int col = col0 + nt * 8 + t4 * 2;
          if (col < C) {
            const long long off = s_row[r] * C + col;
            float v0 = (acc[nt][2 * h2] + a.bp[col]) * scale;
            float v1 = (acc[nt][2 * h2 + 1] + a.bp[col + 1]) * scale;
            if (a.res) {
              const __nv_bfloat162 rv =
                  *reinterpret_cast<const __nv_bfloat162*>(a.res + off);
              v0 += __low2float(rv);
              v1 += __high2float(rv);
            }
            *reinterpret_cast<__nv_bfloat162*>(a.out + off) =
                __floats2bfloat162_rn(v0, v1);
          }
          acc[nt][2 * h2] = acc[nt][2 * h2 + 1] = 0.f;
        }
    }
  }
  cp_async_wait_all();
  __syncthreads();
}

// the head dims' padding DP of the fused half for width C, h heads and
// win x win windows, or 0 where it does not apply (other windows, wider
// rows); bf16 only
__host__ __device__ inline int fused_attn_dp(int C, int h, int win) {
  if (win != 8 || h <= 0 || C % h || C % 4 || kpad(C) > 224) return 0;
  const int d = C / h;
  return d <= 32 ? 32 : d <= 64 ? 64 : 0;
}

}  // namespace fairm
