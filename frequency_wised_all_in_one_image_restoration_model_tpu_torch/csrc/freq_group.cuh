// A band group of the frequency-MSA block on the SM: the 192 rows of one
// window position in all L = 3 bands (bf16, head dims <= 32, kpad(C) <=
// 128), in a CTA of twelve warps, 16 of the rows a warp. K3's fused form
// (freq_inter.cu) runs the inter half on it; K5's band-group form
// (freq_merged.cu) runs the intra half and then the inter half on the same
// rows, with the rows never leaving shared memory between them.
//
// group_gather copies the group's rows from an image through a RowMap
// (mode 2: the band regroup, with the SW-MSA shift where the caller folds
// the roll in), 8 bytes a copy, all in flight at once.
//
// group_half<INTRA> runs one attention half on the rows:
//  1. for each head, q, k and v ([192, 32] each, the head dim zero-padded)
//     on mma.sync against the head's rows of Wqkv, streamed from L2 in steps
//     of 32 columns through a ring of FI_STAGES cp.async buffers; + bqkv,
//     rounded to bf16;
//  2. the head's attention on the tensor cores:
//     - INTRA (K1's per-band window attention): each band's 64-token window
//       on four warps, attention.cuh's attn_mma_core with that band's bias
//       table read from L2 and the SW-MSA mask, as K1 runs it;
//     - inter (K3's): the whole row of 192 logits in registers, its bias
//       formed in shared memory from the head's L x L per-pair tables
//       ([L*L, 225] fp32, 8 KB) at the token pair's relative position plus
//       the band mask, the same fp32 add that assembles the grouped bias,
//       so every value is bit-equal to it; the SW-MSA mask added after;
//  3. the attention rows through Wp, 64 output columns at a time, from the
//     same ring; + bp, and then
//     - INTRA: rounded to bf16 (y1, no residual) into the group's rows in
//       place (the LN1 rows are dead by then), and to device memory through
//       ymap when the caller asks for y1;
//     - inter: x dps of the row's band image, + the residual, written to
//       the image rows.
// Rounding points are the chain's: LN1(x), q / k / v, the attention rows
// and y1 in bf16, every product accumulated in fp32 in the same k order.

#pragma once

#include "attention.cuh"
#include "attn_fused.cuh"
#include "gemm.cuh"

namespace fairm {

constexpr int FI_N = 192;              // tokens of a group: 3 bands x 8 x 8
constexpr int FI_WIN = 64;             // tokens of a window
constexpr int FI_L = 3;                // bands
constexpr int FI_WARPS = FI_N / 16;    // a warp per 16 rows
constexpr int FI_NT = 32 * FI_WARPS;
constexpr int FI_DP = 32;              // head dims zero-padded
constexpr int FI_LDQ = FI_DP + 8;      // q / k / v row stride
constexpr int FI_KC = 32;              // weight columns a step
constexpr int FI_STAGES = 4;           // the ring of weight steps
constexpr int FI_WROWS = 64;           // weight rows a projection step
constexpr int FI_LDW = FI_KC + 8;
constexpr int FI_TAB = 225;            // (2 win - 1)^2 relative positions
constexpr int FI_TABS = FI_L * FI_L * FI_TAB;

// one attention half of a group
struct GroupHalf {
  const bf16_t* wqkv;   // [3C, kpad(C)], the d^-0.5 scale in q
  const float* bqkv;    // [3C]
  const bf16_t* wp;     // [C, kpad(C)]
  const float* bp;      // [C]
  const float* tables;  // INTRA: the per-band bias [L, h, 64, 64]; inter:
                        // the per-pair tables [L*L, 225, h]
  const float* mask;    // [nW, 64, 64] additive, or null
  const float *lns, *lnb;  // INTRA: LN1 of the rows first, or null
  float eps;
  const bf16_t* res;    // inter: the residual, the output's layout
  bf16_t* out;          // inter: the output rows (group_gather's rows);
                        // INTRA: y1 through ymap too, or null
  RowMap ymap;          // INTRA: group-major logical row -> y1's row
  int C, h;
};

// byte offsets of the shared-memory layout for rows of kpad(C) columns
struct GroupLayout {
  int ldx;
  size_t ox, oo, oq, ow, ot, orow, osc, bytes;
};

__host__ __device__ inline GroupLayout group_layout(int C) {
  GroupLayout L;
  L.ldx = kpad(C) + 8;
  L.ox = 0;                                           // [192][ldx] rows
  L.oo = L.ox + 2 * FI_N * L.ldx;                     // [192][ldx] attention rows
  L.oq = L.oo + 2 * FI_N * L.ldx;                     // q, k, v [192][LDQ]
  L.ow = L.oq + 2 * 3 * FI_N * FI_LDQ;                // [STAGES][64][LDW]
  L.ot = L.ow + 2 * FI_STAGES * FI_WROWS * FI_LDW;    // [L*L][225] fp32
  L.orow = L.ot + (4 * FI_TABS + 15) / 16 * 16;       // [192] physical rows
  L.osc = L.orow + 8 * FI_N;                          // [192] dps of the row
  L.bytes = L.osc + 4 * FI_N;
  return L;
}

// bf16 groups of 3 x 64 tokens with head dims <= 32 and rows of at most 128
// columns, C a multiple of 4 (8-byte row copies)
__host__ __device__ inline bool group_ok(int C, int h, int win, int L) {
  return win == 8 && L == FI_L && h > 0 && C % h == 0 && C % 4 == 0 &&
         C / h <= FI_DP && kpad(C) <= 128;
}

// the zero pad columns of the rows and the attention rows, once per block
__device__ __forceinline__ void group_init(int C, unsigned char* sm) {
  const GroupLayout Lo = group_layout(C);
  bf16_t* xs = reinterpret_cast<bf16_t*>(sm + Lo.ox);
  bf16_t* os = reinterpret_cast<bf16_t*>(sm + Lo.oo);
  const int pad = Lo.ldx - C;
  for (int e = threadIdx.x; e < FI_N * pad; e += FI_NT) {
    const int r = e / pad, c = C + e % pad;
    xs[r * Lo.ldx + c] = from_f<bf16_t>(0.f);
    os[r * Lo.ldx + c] = from_f<bf16_t>(0.f);
  }
}

// group g's rows of src [images, H, W, C] through map (logical rows
// g * 192 ...) into the rows, their physical rows and dps of their image
// (hw pixels an image); one cp.async group, committed
__device__ __forceinline__ void group_gather(const bf16_t* src,
                                             const RowMap& map, long long g,
                                             int C, const float* dps,
                                             long long hw, unsigned char* sm) {
  const GroupLayout Lo = group_layout(C);
  bf16_t* xs = reinterpret_cast<bf16_t*>(sm + Lo.ox);
  long long* s_row = reinterpret_cast<long long*>(sm + Lo.orow);
  float* s_sc = reinterpret_cast<float*>(sm + Lo.osc);
  const int c4 = C / 4;
  for (int e = threadIdx.x; e < FI_N * c4; e += FI_NT) {
    const int t = e / c4, c = e - t * c4;
    const long long pc = map_row(map, g * FI_N + t);
    if (c == 0) {
      s_row[t] = pc;
      s_sc[t] = dps ? dps[pc / hw] : 1.f;
    }
    cp_async8(xs + t * Lo.ldx + 4 * c, src + pc * C + 4 * c);
  }
  cp_async_commit();
}

// Head hh's attention over the group (q / k / v [192][LDQ] in shared
// memory, head dims past d zero), into columns hh * d ... of the attention
// rows os: warp w takes query rows 16 w ... 16 w + 15.
__device__ __forceinline__ void inter_core(const float* mask_w, int C, int h,
                                           const bf16_t* q, const bf16_t* k,
                                           const bf16_t* v, const float* tab,
                                           int hh, bf16_t* os, int ldx,
                                           int warp) {
  constexpr int NT = FI_N / 8;  // key tiles of 8 tokens
  const int lane = threadIdx.x & 31, gq = lane >> 2, t4 = lane & 3;
  const int d = C / h, r0 = warp * 16;
  uint32_t qf[FI_DP / 16][4];
#pragma unroll
  for (int kk = 0; kk < FI_DP / 16; ++kk)
    ldmatrix_x4(qf[kk], q + (r0 + (lane & 15)) * FI_LDQ + kk * 16 + (lane >> 4) * 8);

  float s[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
  for (int np = 0; np < NT / 2; ++np) {
#pragma unroll
    for (int kk = 0; kk < FI_DP / 16; ++kk) {
      uint32_t t[4];
      const int kr = np * 16 + (lane & 7) + ((lane >> 4) << 3);
      ldmatrix_x4(t, k + kr * FI_LDQ + kk * 16 + ((lane >> 3) & 1) * 8);
      const uint32_t b0[2] = {t[0], t[1]}, b1[2] = {t[2], t[3]};
      mma_bf16_16816(s[2 * np], qf[kk], b0);
      mma_bf16_16816(s[2 * np + 1], qf[kk], b1);
    }
  }

  // + bias (the per-pair table at the pair's relative position + the band
  // mask, as the grouped bias adds them), + the SW-MSA mask; row max
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = r0 + gq + (e >= 2 ? 8 : 0), j = nt * 8 + t4 * 2 + (e & 1);
      const int ti = i % FI_WIN, tj = j % FI_WIN;
      const int l = i / FI_WIN, m = j / FI_WIN;
      const int r = ((ti >> 3) - (tj >> 3) + 7) * 15 + (ti & 7) - (tj & 7) + 7;
      float val = s[nt][e] + (tab[(l * FI_L + m) * FI_TAB + r] +
                              (l == m ? -100.f : 0.f));
      if (mask_w) val += mask_w[ti * FI_WIN + tj];
      s[nt][e] = val;
      mx[e >> 1] = fmaxf(mx[e >> 1], val);
    }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    mx[h2] = fmaxf(mx[h2], __shfl_xor_sync(0xffffffffu, mx[h2], 1));
    mx[h2] = fmaxf(mx[h2], __shfl_xor_sync(0xffffffffu, mx[h2], 2));
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
  for (int h2 = 0; h2 < 2; ++h2) {
    sum[h2] += __shfl_xor_sync(0xffffffffu, sum[h2], 1);
    sum[h2] += __shfl_xor_sync(0xffffffffu, sum[h2], 2);
  }

  // O = P V, P rounded to bf16 as the A operand
  float o[FI_DP / 8][4];
#pragma unroll
  for (int ct = 0; ct < FI_DP / 8; ++ct)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[ct][e] = 0.f;
#pragma unroll
  for (int j = 0; j < FI_N / 16; ++j) {
    uint32_t pf[4];
    pf[0] = pack_bf16(s[2 * j][0], s[2 * j][1]);
    pf[1] = pack_bf16(s[2 * j][2], s[2 * j][3]);
    pf[2] = pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]);
    pf[3] = pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3]);
#pragma unroll
    for (int cp = 0; cp < FI_DP / 16; ++cp) {
      uint32_t t[4];
      const int vr = j * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
      ldmatrix_x4_trans(t, v + vr * FI_LDQ + cp * 16 + (lane >> 4) * 8);
      const uint32_t b0[2] = {t[0], t[1]}, b1[2] = {t[2], t[3]};
      mma_bf16_16816(o[2 * cp], pf, b0);
      mma_bf16_16816(o[2 * cp + 1], pf, b1);
    }
  }
#pragma unroll
  for (int ct = 0; ct < FI_DP / 8; ++ct)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = r0 + gq + (e >= 2 ? 8 : 0), c = ct * 8 + t4 * 2 + (e & 1);
      if (c < d) os[i * ldx + hh * d + c] = from_f<bf16_t>(o[ct][e] / sum[e >> 1]);
    }
}

// One attention half of group g (window wi of its images) on the group's
// rows, which group_gather has committed or an earlier half left in place;
// ends with no copy in flight and a barrier
template <bool INTRA>
__device__ __forceinline__ void group_half(const GroupHalf& a, long long g,
                                           int wi, unsigned char* sm) {
  const GroupLayout Lo = group_layout(a.C);
  const int LDX = Lo.ldx;
  bf16_t* xs = reinterpret_cast<bf16_t*>(sm + Lo.ox);
  bf16_t* os = reinterpret_cast<bf16_t*>(sm + Lo.oo);
  bf16_t* qkv_s = reinterpret_cast<bf16_t*>(sm + Lo.oq);
  bf16_t* ws = reinterpret_cast<bf16_t*>(sm + Lo.ow);
  float* tab = reinterpret_cast<float*>(sm + Lo.ot);
  const long long* s_row = reinterpret_cast<const long long*>(sm + Lo.orow);
  const float* s_sc = reinterpret_cast<const float*>(sm + Lo.osc);

  const int C = a.C, h = a.h, d = C / h, kp = kpad(C);
  const int KS = kp / FI_KC;                     // steps of a weight slice
  const int NC = (C + FI_WROWS - 1) / FI_WROWS;  // projection column chunks
  const int steps = (3 * h + NC) * KS;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, t4 = lane & 3;
  const float* mask_w =
      a.mask ? a.mask + (long long)wi * FI_WIN * FI_WIN : nullptr;

  // weight step i into ring stage st, 32 columns: a q / k / v slice's 32
  // rows are its head's rows of Wqkv (zero past d), a projection slice's 64
  // rows those of Wp (zero past C)
  auto load_step = [&](int st, int i) {
    bf16_t* dst = ws + st * FI_WROWS * FI_LDW;
    const int kc = i % KS, slice = i / KS;
    const bool qkv = slice < 3 * h;
    const bf16_t* Wm = qkv ? a.wqkv : a.wp;
    const int rows = qkv ? FI_DP : FI_WROWS;
    for (int c = tid; c < rows * (FI_KC / 8); c += FI_NT) {
      const int r = c >> 2, j = (c & 3) * 8;
      int row;
      bool ok;
      if (qkv) {
        ok = r < d;
        row = (slice % 3) * C + (slice / 3) * d + r;
      } else {
        row = (slice - 3 * h) * FI_WROWS + r;
        ok = row < C;
      }
      cp_async16(dst + r * FI_LDW + j,
                 Wm + (long long)(ok ? row : 0) * kp + kc * FI_KC + j, ok);
    }
  };

#pragma unroll
  for (int s = 0; s < FI_STAGES - 1; ++s) {
    if (s < steps) load_step(s, s);
    cp_async_commit();
  }
  if (a.lns) {
    // LN1 of the gathered rows (the oldest copies) before the first step
    asm volatile("cp.async.wait_group %0;\n" ::"n"(FI_STAGES - 1));
    __syncthreads();
    ln_rows(xs, LDX, FI_N, C, a.lns, a.lnb, a.eps, warp, FI_WARPS);
  }

  float acc[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;

  for (int i = 0; i < steps; ++i) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(FI_STAGES - 2));
    __syncthreads();
    const int nxt = i + FI_STAGES - 1;
    if (nxt < steps) load_step(nxt % FI_STAGES, nxt);
    cp_async_commit();

    const bf16_t* wst = ws + (i % FI_STAGES) * FI_WROWS * FI_LDW;
    const int kc = i % KS, slice = i / KS;
    const bool qkv_step = slice < 3 * h;
    const bf16_t* A = qkv_step ? xs : os;
    const int ncols = qkv_step ? FI_DP : FI_WROWS;
    if (!INTRA && qkv_step && slice % 3 == 0 && kc == 0) {
      // the head's per-pair tables, read by its core after the v slice
      for (int e = tid; e < FI_TABS; e += FI_NT)
        tab[e] = a.tables[(long long)e * h + slice / 3];
    }
#pragma unroll
    for (int kk = 0; kk < FI_KC; kk += 16) {
      uint32_t af[4];
      ldmatrix_x4(af, A + (warp * 16 + (lane & 15)) * LDX + kc * FI_KC + kk +
                          (lane >> 4) * 8);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        if (np * 16 >= ncols) break;
        uint32_t t[4];
        const int nr = np * 16 + (lane & 7) + ((lane >> 4) << 3);
        ldmatrix_x4(t, wst + nr * FI_LDW + kk + ((lane >> 3) & 1) * 8);
        const uint32_t b0[2] = {t[0], t[1]}, b1[2] = {t[2], t[3]};
        mma_bf16_16816(acc[2 * np], af, b0);
        mma_bf16_16816(acc[2 * np + 1], af, b1);
      }
    }
    if (kc != KS - 1) continue;

    if (qkv_step) {
      // + bqkv, rounded to bf16, into q, k or v of this head
      const int part = slice % 3, hh = slice / 3;
      bf16_t* dst = qkv_s + part * FI_N * FI_LDQ;
#pragma unroll
      for (int nt = 0; nt < FI_DP / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = warp * 16 + gq + (e >= 2 ? 8 : 0);
          const int c = nt * 8 + t4 * 2 + (e & 1);
          dst[r * FI_LDQ + c] = from_f<bf16_t>(
              c < d ? acc[nt][e] + a.bqkv[part * C + hh * d + c] : 0.f);
          acc[nt][e] = 0.f;
        }
      if (part == 2) {
        __syncthreads();  // q, k, v (and the tables) of the head
        const bf16_t* q = qkv_s;
        const bf16_t* k = q + FI_N * FI_LDQ;
        const bf16_t* v = k + FI_N * FI_LDQ;
        if constexpr (INTRA) {
          // band warp / 4's window: its 64 rows, its bias table
          const int band = warp >> 2, o = band * FI_WIN;
          attn_mma_core<FI_WIN, FI_DP, FI_LDQ>(
              q + o * FI_LDQ, k + o * FI_LDQ, v + o * FI_LDQ, nullptr,
              a.tables + ((long long)band * h + hh) * FI_WIN * FI_WIN, mask_w,
              FI_WIN, d, nullptr, os + o * LDX + hh * d, LDX, warp & 3);
        } else {
          inter_core(mask_w, C, h, q, k, v, tab, hh, os, LDX, warp);
        }
      }
    } else {
      const int col0 = (slice - 3 * h) * FI_WROWS;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {
          const int r = warp * 16 + gq + 8 * h2;
          const int col = col0 + nt * 8 + t4 * 2;
          if (col < C) {
            if constexpr (INTRA) {
              // + bp, rounded to bf16: y1 in place of the LN1 rows
              const __nv_bfloat162 y = __floats2bfloat162_rn(
                  acc[nt][2 * h2] + a.bp[col], acc[nt][2 * h2 + 1] + a.bp[col + 1]);
              *reinterpret_cast<__nv_bfloat162*>(xs + r * LDX + col) = y;
              if (a.out)
                *reinterpret_cast<__nv_bfloat162*>(
                    a.out + map_row(a.ymap, g * FI_N + r) * C + col) = y;
            } else {
              // + bp, x dps, + residual, to the image rows; the scale and
              // the residual round apart, as K3's passes (gemm.cuh's
              // epilogue) round them, so both forms of K3 and K5 agree
              const long long off = s_row[r] * C + col;
              const float sc = s_sc[r];
              const __nv_bfloat162 rv =
                  *reinterpret_cast<const __nv_bfloat162*>(a.res + off);
              const float v0 = __fadd_rn(
                  __fmul_rn(acc[nt][2 * h2] + a.bp[col], sc), __low2float(rv));
              const float v1 =
                  __fadd_rn(__fmul_rn(acc[nt][2 * h2 + 1] + a.bp[col + 1], sc),
                            __high2float(rv));
              *reinterpret_cast<__nv_bfloat162*>(a.out + off) =
                  __floats2bfloat162_rn(v0, v1);
            }
          }
          acc[nt][2 * h2] = acc[nt][2 * h2 + 1] = 0.f;
        }
    }
  }
  cp_async_wait_all();
  __syncthreads();
}

}  // namespace fairm
