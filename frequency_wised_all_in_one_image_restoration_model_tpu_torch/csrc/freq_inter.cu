// K3: the cross-band (inter) half of the frequency-MSA encoder block.
//
// Replaces the Pallas kernel _freq_inter_kernel (frequency_wised_all_in_one_
// image_restoration_model_tpu/ops/pallas/lewin_block.py, reached through
// fused_freq_inter):
//   out[l*B + b] = res[l*B + b] + dps[l*B + b] * proj(grouped_attn(y))
// where each window's L band copies form one L*n = 192-token group, the
// bias [h, L*n, L*n] carries the L x L relative-position tables with the
// 'inter' band mask folded in, and the SW-MSA mask is tiled (L, L). No LN.
//
// What bounds it on the H100: by the card's peaks the bytes of y and res in
// and out at the shallow stages (C = 28 ... 112, most of the tokens) and
// the 192-token attention core, (L n)^2 d multiply-adds per group and head,
// at the deep ones. In four passes the group's rows make round trips
// through device memory (the regrouped rows, qkv [M, 3C], the attention
// rows: about 15x the bytes of y at C = 28), the qkv product has K = 32
// and N = 84, and the core reads each head's whole 147 KB bias from L2 for
// every group.
//
// Two forms, chosen by the caller (lewin_block.py::freq_inter_path):
// - fused (bf16, L n = 192, head dims <= 32, kpad(C) <= 128: the encoder's
//   res 128 / 64 / 32 stages; given the per-pair tables the model holds,
//   not only the grouped bias made from them): one persistent kernel, a CTA of twelve warps
//   a group at a time, 16 of its rows a warp:
//    1. gathers the group's 192 rows of y (the band regroup, RowMap mode 2)
//       into shared memory (cp.async, 8 bytes a copy, all in flight);
//    2. for each head, forms q, k and v ([192, 32] each, the head dim 28
//       zero-padded) on mma.sync against the head's rows of Wqkv, streamed
//       from L2 in steps of 32 columns through a ring of FI_STAGES cp.async
//       buffers; + bqkv, rounded to bf16;
//    3. runs the head's attention on the tensor cores: logits and P V on
//       mma.sync, the whole row of 192 logits in registers, its bias formed
//       in shared memory from the head's L x L per-pair tables ([L*L, 225]
//       fp32, 8 KB) at the token pair's relative position plus the band
//       mask, the same fp32 add that assembles the grouped bias, so every
//       value is bit-equal to it; the SW-MSA mask added after;
//    4. projects the attention rows through Wp, 64 output columns at a
//       time, from the same ring; + bp, x dps of the row's band image, +
//       the residual, written to the image rows.
//   No regrouped, q / k / v or attention row reaches device memory.
//   Rounding points are the passes': y, q / k / v and the attention rows in
//   bf16, every product accumulated in fp32.
// - passes (fp32, the deep stages C = 224 / 448, whose products the wgmma
//   tile runs, and a launch given only the grouped bias): the band regroup is one gather pass (RowMap mode 2)
//   into a dense padded matrix that the qkv GEMM streams, the core
//   (attention.cuh) keeps the logits in shared memory, and the inverse
//   regroup is a scatter in the proj GEMM's epilogue, which also adds the
//   residual and the per-folded-sample dps.

#include "attention.cuh"
#include "attn_fused.cuh"
#include "gemm.cuh"

using namespace fairm;

namespace {

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

struct InterArgs {
  const bf16_t* y;      // [L*B, H, W, C], rows through map
  const bf16_t* res;    // the residual, y's layout
  const bf16_t* wqkv;   // [3C, kpad(C)], the d^-0.5 scale in q
  const float* bqkv;    // [3C]
  const bf16_t* wp;     // [C, kpad(C)]
  const float* bp;      // [C]
  const float* pairs;   // [L*L, 225, h] per-pair relative-position tables
  const float* mask;    // [nW, 64, 64] additive, or null
  const float* dps;     // [L*B] by band image, or null
  bf16_t* out;          // y's layout
  RowMap map;           // mode 2: group-major logical row -> physical row
  long long hw;         // pixels of an image
  int C, h, nW;
};

// byte offsets of the shared-memory layout for rows of kpad(C) columns
struct InterLayout {
  int ldx;
  size_t ox, oo, oq, ow, ot, orow, osc, bytes;
};

__host__ __device__ inline InterLayout inter_layout(int C) {
  InterLayout L;
  L.ldx = kpad(C) + 8;
  L.ox = 0;                                           // [192][ldx] y rows
  L.oo = L.ox + 2 * FI_N * L.ldx;                     // [192][ldx] attention rows
  L.oq = L.oo + 2 * FI_N * L.ldx;                     // q, k, v [192][LDQ]
  L.ow = L.oq + 2 * 3 * FI_N * FI_LDQ;                // [STAGES][64][LDW]
  L.ot = L.ow + 2 * FI_STAGES * FI_WROWS * FI_LDW;    // [L*L][225] fp32
  L.orow = L.ot + (4 * FI_TABS + 15) / 16 * 16;       // [192] physical rows
  L.osc = L.orow + 8 * FI_N;                          // [192] dps of the row
  L.bytes = L.osc + 4 * FI_N;
  return L;
}

// the fused form takes bf16 groups of 3 x 64 tokens with head dims <= 32
// and rows of at most 128 columns, C a multiple of 4 (8-byte row copies)
__host__ __device__ inline bool inter_fused_ok(int C, int h, int win, int L) {
  return win == 8 && L == FI_L && h > 0 && C % h == 0 && C % 4 == 0 &&
         C / h <= FI_DP && kpad(C) <= 128;
}

// Head hh's attention over the group (q / k / v [192][LDQ] in shared
// memory, head dims past d zero), into columns hh * d ... of the attention
// rows os: warp w takes query rows 16 w ... 16 w + 15.
__device__ __forceinline__ void inter_core(const InterArgs& a,
                                           const bf16_t* q, const bf16_t* k,
                                           const bf16_t* v, const float* tab,
                                           int hh, int wi, bf16_t* os,
                                           int ldx, int warp) {
  constexpr int NT = FI_N / 8;  // key tiles of 8 tokens
  const int lane = threadIdx.x & 31, gq = lane >> 2, t4 = lane & 3;
  const int d = a.C / a.h, r0 = warp * 16;
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
  const float* mask = a.mask ? a.mask + (long long)wi * FI_WIN * FI_WIN : nullptr;
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
      if (mask) val += mask[ti * FI_WIN + tj];
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

// group g (logical rows g * 192 ...); ends with a barrier
__device__ __forceinline__ void inter_group(const InterArgs& a, long long g,
                                            unsigned char* sm) {
  const InterLayout Lo = inter_layout(a.C);
  const int LDX = Lo.ldx;
  bf16_t* xs = reinterpret_cast<bf16_t*>(sm + Lo.ox);
  bf16_t* os = reinterpret_cast<bf16_t*>(sm + Lo.oo);
  bf16_t* qkv_s = reinterpret_cast<bf16_t*>(sm + Lo.oq);
  bf16_t* ws = reinterpret_cast<bf16_t*>(sm + Lo.ow);
  float* tab = reinterpret_cast<float*>(sm + Lo.ot);
  long long* s_row = reinterpret_cast<long long*>(sm + Lo.orow);
  float* s_sc = reinterpret_cast<float*>(sm + Lo.osc);

  const int C = a.C, h = a.h, d = C / h, kp = kpad(C);
  const int KS = kp / FI_KC;                     // steps of a weight slice
  const int NC = (C + FI_WROWS - 1) / FI_WROWS;  // projection column chunks
  const int steps = (3 * h + NC) * KS;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, t4 = lane & 3;
  const int wi = (int)(g % a.nW);

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

  __syncthreads();  // the last group's readers of s_row, xs and the ring
  // the group's rows, 8 bytes a copy, then the first weight steps
  const int c4 = C / 4;
  for (int e = tid; e < FI_N * c4; e += FI_NT) {
    const int t = e / c4, c = e - t * c4;
    const long long pc = map_row(a.map, g * FI_N + t);
    if (c == 0) {
      s_row[t] = pc;
      s_sc[t] = a.dps ? a.dps[pc / a.hw] : 1.f;
    }
    cp_async8(xs + t * LDX + 4 * c, a.y + pc * C + 4 * c);
  }
  cp_async_commit();
#pragma unroll
  for (int s = 0; s < FI_STAGES - 1; ++s) {
    if (s < steps) load_step(s, s);
    cp_async_commit();
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
    if (qkv_step && slice % 3 == 0 && kc == 0) {
      // the head's per-pair tables, read by its core after the v slice
      for (int e = tid; e < FI_TABS; e += FI_NT)
        tab[e] = a.pairs[(long long)e * h + slice / 3];
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
        __syncthreads();  // q, k, v and the tables of the head
        const bf16_t* q = qkv_s;
        inter_core(a, q, q + FI_N * FI_LDQ, q + 2 * FI_N * FI_LDQ,
                           tab, hh, wi, os, LDX, warp);
      }
    } else {
      // + bp, x dps, + residual, to the image rows
      const int col0 = (slice - 3 * h) * FI_WROWS;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {
          const int r = warp * 16 + gq + 8 * h2;
          const int col = col0 + nt * 8 + t4 * 2;
          if (col < C) {
            const long long off = s_row[r] * C + col;
            const float sc = s_sc[r];
            const __nv_bfloat162 rv =
                *reinterpret_cast<const __nv_bfloat162*>(a.res + off);
            const float v0 = (acc[nt][2 * h2] + a.bp[col]) * sc + __low2float(rv);
            const float v1 =
                (acc[nt][2 * h2 + 1] + a.bp[col + 1]) * sc + __high2float(rv);
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

__global__ void __launch_bounds__(FI_NT, 1)
    inter_fused_kernel(const InterArgs a, long long groups) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const InterLayout Lo = inter_layout(a.C);
  // the zero pad columns of the y and attention rows, once per block
  bf16_t* xs = reinterpret_cast<bf16_t*>(smem_raw + Lo.ox);
  bf16_t* os = reinterpret_cast<bf16_t*>(smem_raw + Lo.oo);
  const int pad = Lo.ldx - a.C;
  for (int e = threadIdx.x; e < FI_N * pad; e += FI_NT) {
    const int r = e / pad, c = a.C + e % pad;
    xs[r * Lo.ldx + c] = from_f<bf16_t>(0.f);
    os[r * Lo.ldx + c] = from_f<bf16_t>(0.f);
  }
  for (long long g = blockIdx.x; g < groups; g += gridDim.x)
    inter_group(a, g, smem_raw);
}

cudaError_t inter_fused_launch(const InterArgs& a, long long groups,
                               cudaStream_t st) {
  auto kernel = inter_fused_kernel;
  const size_t smem = inter_layout(a.C).bytes;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, FI_NT,
                                                      smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorLaunchOutOfResources;
  long long blocks = (long long)per_sm * sms;
  if (blocks > groups) blocks = groups;
  kernel<<<(unsigned)blocks, FI_NT, smem, st>>>(a, groups);
  return cudaSuccess;
}

cudaError_t freq_inter_fused(const void* y, const void* res, const void* wqkv,
                             const float* bqkv, const void* wp,
                             const float* bp, const float* pairs,
                             const float* mask,
                             const float* dps, void* out, int LB, int H,
                             int W, int C, int h, int win, int L,
                             cudaStream_t st) {
  if (!inter_fused_ok(C, h, win, L) || LB % L || !pairs)
    return cudaErrorInvalidValue;
  InterArgs a{};
  a.y = static_cast<const bf16_t*>(y);
  a.res = static_cast<const bf16_t*>(res);
  a.wqkv = static_cast<const bf16_t*>(wqkv);
  a.bqkv = bqkv;
  a.wp = static_cast<const bf16_t*>(wp);
  a.bp = bp;
  a.pairs = pairs;
  a.mask = mask;
  a.dps = dps;
  a.out = static_cast<bf16_t*>(out);
  a.nW = (H / win) * (W / win);
  a.map = RowMap{2, H, W, win, LB / L, L, 0};
  a.hw = (long long)H * W;
  a.C = C;
  a.h = h;
  const long long groups = (long long)(LB / L) * a.nW;
  return inter_fused_launch(a, groups, st);
}

}  // namespace

template <typename T>
static cudaError_t freq_inter(const void* y, const void* res,
                              const void* wqkv, const float* bqkv,
                              const void* wp, const float* bp,
                              const float* bias, const float* mask,
                              const float* dps, void* zo, void* qkv, void* out,
                              int LB, int H, int W, int C, int h, int win,
                              int L, cudaStream_t st) {
  const int n = win * win;
  const int nW = (H / win) * (W / win);
  const int B = LB / L;
  const long long M = (long long)LB * H * W;
  const RowMap grouped{2, H, W, win, B, L};

  // band regroup (no LN) -> zo [M, kpad(C)]
  launch_prep<T>(y, C, grouped, M, nullptr, nullptr, 0.f, zo, st);

  GemmArgs g1{};
  g1.A = zo;
  g1.Wt = wqkv;
  g1.lda = kpad(C);
  g1.bias = bqkv;
  g1.hw = (long long)H * W;
  g1.C = qkv;
  g1.cmap = identity_map();
  g1.M = M;
  g1.N = 3 * C;
  cudaError_t err = launch_gemm<T>(g1, st);
  if (err != cudaSuccess) return err;

  AttnArgs at{};  // its output reuses zo, dead after the qkv GEMM
  at.qkv = qkv;
  at.out = zo;
  at.bias = bias;
  at.mask = mask;
  at.lam = nullptr;
  at.n = L * n;
  at.n0 = n;
  at.d = C / h;
  at.C = C;
  at.h = h;
  at.ldo = kpad(C);
  at.nW = nW;
  at.imgs_per_bias = B;  // one shared bias
  err = launch_attn<T>(at, (long long)B * nW, st);
  if (err != cudaSuccess) return err;

  GemmArgs g2{};
  g2.A = zo;
  g2.Wt = wp;
  g2.lda = kpad(C);
  g2.bias = bp;
  g2.dps = dps;
  g2.hw = (long long)H * W;
  g2.res = res;
  g2.C = out;
  g2.cmap = grouped;
  g2.M = M;
  g2.N = C;
  return launch_gemm<T>(g2, st);
}

// 1 if the fused form takes the shape (fairm_freq_inter with fused = 1),
// else 0
extern "C" int fairm_freq_inter_fused_ok(int C, int h, int win, int L) {
  return inter_fused_ok(C, h, win, L);
}

extern "C" int fairm_freq_inter(const void* y, const void* res,
                                const void* wqkv, const void* bqkv,
                                const void* wp, const void* bp,
                                const void* bias, const void* pairs,
                                const void* mask, const void* dps, void* zo,
                                void* qkv, void* out, int LB, int H, int W,
                                int C, int h, int win, int L, int is_bf16,
                                int fused, void* stream) {
  cudaError_t err;
  if (fused) {  // the caller's choice: bf16 with the per-pair tables, a
                // shape it cannot take fails
    err = is_bf16 ? freq_inter_fused(y, res, wqkv, (const float*)bqkv, wp,
                                     (const float*)bp, (const float*)pairs,
                                     (const float*)mask,
                                     (const float*)dps, out, LB, H, W, C, h,
                                     win, L, (cudaStream_t)stream)
                  : cudaErrorInvalidValue;
  } else {
    auto f = [&](auto tag) {
      using T = decltype(tag);
      return freq_inter<T>(y, res, wqkv, (const float*)bqkv, wp,
                           (const float*)bp, (const float*)bias,
                           (const float*)mask, (const float*)dps, zo, qkv,
                           out, LB, H, W, C, h, win, L, (cudaStream_t)stream);
    };
    err = is_bf16 ? f(bf16_t{}) : f(float{});
  }
  if (err == cudaSuccess) err = cudaGetLastError();
  return (int)err;
}
