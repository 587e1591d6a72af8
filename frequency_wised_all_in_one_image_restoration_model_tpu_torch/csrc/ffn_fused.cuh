// The LeFF on the SM, one 8 x 8 pixel tile at a time (bf16, C a multiple of
// 4, kpad(C) <= 224):
//   out = x + dps * (gelu(dwconv3x3(gelu(LN2(x) W1 + b1)) + bd) W2 + b2)
// K2 (lewin_ffn.cu) launches it as one tile a CTA of eight warps; the
// merged frequency block K5 (freq_merged.cu) runs it after its grid
// barrier, three tiles at a time in a CTA of twelve warps, each tile on
// four warps with a named barrier of its own.
//
// NT threads own one tile and keep LN2 of the tile and its one-pixel halo
// (10 x 10 pixels, bf16, zero outside the image) in shared memory (x loaded
// 8 bytes a thread, all loads in flight at once, then normalised in place);
// they walk the hidden dimension in blocks of HB = 32:
//  - fc1 of the 100 halo pixels against the block of W1 on mma.sync
//    (m16n8k16, fp32 accumulators), + b1, GELU, zero outside the image (the
//    conv's zero padding; halos never reach into the next image of the
//    batch), into an fp32 tile in shared memory;
//  - the depthwise 3 x 3 on the CUDA cores in fp32, + bd, GELU, rounded
//    once to bf16 as fc2's A operand;
//  - fc2 against the block's rows of W2 on mma.sync into fp32 output
//    registers that live across the blocks.
// One cp.async buffer for each weight slice: W1's next slice loads during
// the conv and fc2, W2's during fc1 and the conv. The epilogue adds b2,
// scales by dps[image], adds the residual and writes the output once: the
// hidden rows never reach device memory. Rounding points are JAX's: LN2(x)
// in bf16, the hidden in fp32 until it is fc2's operand. How the NT threads
// share the work does not change any element's sum: fc1 and fc2 add their
// k steps of 16 in one order for every NT, the conv its nine taps.

#pragma once

#include "gemm.cuh"

namespace fairm {

constexpr int FF_T = 8;                   // output tile side
constexpr int FF_HS = FF_T + 2;           // halo tile side
constexpr int FF_HP = FF_HS * FF_HS;      // 100 halo pixels
constexpr int FF_HM = 112;                // halo rows padded to 7 m16 tiles
constexpr int FF_P = FF_T * FF_T;         // 64 output pixels

constexpr int FF_HB = 32;                 // hidden columns a step

// the shared-memory layout of one tile for KP = kpad(C) rounded up to 32,
// 64, 128 or 224 (byte offsets; +8 elements a row keep ldmatrix's rows, and
// the fp32 tile's rows, on distinct banks), and MINB CTAs an SM for K2
template <int KP_, int MINB_>
struct FfnShape {
  static constexpr int KP = KP_, HB = FF_HB, MINB = MINB_;
  static constexpr int LDX = KP + 8;                     // bf16
  static constexpr int LDA = HB + 8;                     // bf16
  static constexpr int LDH = HB + 8;                     // fp32
  static constexpr size_t OX = 0;                        // [112][LDX] LN2(x)
  static constexpr size_t OW1 = OX + 2 * FF_HM * LDX;    // [HB][LDX] W1 slice
  static constexpr size_t OW2 = OW1 + 2 * HB * LDX;      // [KP][LDA] W2 slice
  static constexpr size_t OH = OW2 + 2 * KP * LDA;       // [100][LDH] hidden
  static constexpr size_t OA = OH + 4 * FF_HP * LDH;     // [64][LDA] fc2's A
  static constexpr size_t BYTES = OA + 2 * FF_P * LDA;
};

struct FfnArgs {
  const bf16_t* x;      // [B, H, W, C]
  const float *lns, *lnb;
  const bf16_t* w1;     // [Hd, kc]: W1^T, k zero-padded to kc = kpad(C)
  const float* b1;      // [Hd]
  const float* wd;      // [3, 3, Hd]
  const float* bd;      // [Hd]
  const bf16_t* w2;     // [C, ldw2]: W2^T, k zero-padded to ldw2 = kpad(Hd)
  const float* b2;      // [C]
  const float* dps;     // [B], or null
  bf16_t* out;          // [B, H, W, C]
  int H, W, C, Hd, kc, ldw2;
  float eps;
};

// the fused tile's KP for C, or 0 where it does not apply
__host__ __device__ inline int ffn_fused_kp(int C, int is_bf16) {
  if (!is_bf16 || C % 4) return 0;
  const int k = kpad(C);
  return k <= 32 ? 32 : k <= 64 ? 64 : k <= 128 ? 128 : k <= 224 ? 224 : 0;
}

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// LayerNorm of one row of C <= KP bf16 values by a warp, lane l holding
// columns l, l + 32, ...: fp32 statistics in two passes, each sum over
// the lanes by warp_sum, rounded to bf16 into dst[0, C), zeros into
// dst[C, pad). K2's fused tile normalises its rows with it, and so do the
// merged kernels' LN2 phases where the chain's K2 runs that tile
// (merged.cuh), so that both sum a row in one order.
template <int KP>
__device__ __forceinline__ void ln_row_lanes(const bf16_t* src, bf16_t* dst,
                                             int C, int pad, const float* lns,
                                             const float* lnb, float eps) {
  const int lane = threadIdx.x & 31;
  float v[KP / 32];
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < KP / 32; ++i) {
    const int c = lane + 32 * i;
    v[i] = c < C ? __bfloat162float(src[c]) : 0.f;
    s += v[i];
  }
  const float mu = warp_sum(s) / C;
  float q = 0.f;
#pragma unroll
  for (int i = 0; i < KP / 32; ++i) {
    const float dv = lane + 32 * i < C ? v[i] - mu : 0.f;
    q += dv * dv;
  }
  const float rs = rsqrtf(warp_sum(q) / C + eps);
#pragma unroll
  for (int i = 0; i < KP / 32; ++i) {
    const int c = lane + 32 * i;
    if (c < C)
      dst[c] = __float2bfloat16((v[i] - mu) * rs * lns[c] + lnb[c]);
    else if (c < pad)
      dst[c] = __float2bfloat16(0.f);
  }
}

// Tile ``tile`` (row-major over the image's 8 x 8 tiles) of image ``img``
// by the NT threads tid = 0 ... NT - 1 (NT a multiple of 128), whose
// barrier is sync(); smem holds S::BYTES. Threads that leave the tile may
// start on the next one at once: their first writes (W1's first slice, the
// halo rows) touch nothing the tile's last step (fc2) reads.
template <class S, int NT, class Sync>
__device__ __forceinline__ void ffn_fused_tile(const FfnArgs& a, int tile,
                                               long long img,
                                               unsigned char* smem, int tid,
                                               Sync sync) {
  constexpr int KP = S::KP, HB = S::HB, LDX = S::LDX, LDA = S::LDA;
  constexpr int LDH = S::LDH;
  // fc1: NQ groups of 16 hidden columns, MS sets of the 7 m-tiles, MI
  // m-tiles a warp; the conv: RPG output rows a thread; fc2: NCH parts of
  // the KP output columns, NW n8-tiles a warp
  constexpr int NQ = HB / 16, MS = NT / 32 / NQ, MI = (7 + MS - 1) / MS;
  constexpr int RPG = FF_T * HB / NT;
  constexpr int NCH = NT / 128, KW = KP / NCH, NW = KW / 8;
  bf16_t* sx = reinterpret_cast<bf16_t*>(smem + S::OX);
  bf16_t* sw1 = reinterpret_cast<bf16_t*>(smem + S::OW1);
  bf16_t* sw2 = reinterpret_cast<bf16_t*>(smem + S::OW2);
  float* sh = reinterpret_cast<float*>(smem + S::OH);
  bf16_t* sa = reinterpret_cast<bf16_t*>(smem + S::OA);

  const int warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, t4 = lane & 3, li = lane & 7;
  const int H = a.H, W = a.W, C = a.C, Hd = a.Hd;
  const int tiles_x = (W + FF_T - 1) / FF_T;
  const int y0 = (tile / tiles_x) * FF_T, x0 = (tile % tiles_x) * FF_T;
  const bf16_t* x = a.x + img * H * W * C;
  const int nhb = (Hd + HB - 1) / HB;
  // halo pixel r (of 10 x 10) inside the image
  auto inside = [&](int r) {
    const int y = y0 - 1 + r / FF_HS, xx = x0 - 1 + r % FF_HS;
    return r < FF_HP && y >= 0 && y < H && xx >= 0 && xx < W;
  };
  // W1 rows hb * HB .. + HB - 1 (zero past Hd); the matching HB columns of
  // W2's rows (zero past C, and past kpad(Hd) where the operand ends)
  auto load_w1 = [&](int hb) {
    for (int e = tid; e < HB * (KP / 8); e += NT) {
      const int r = e / (KP / 8), c = (e - r * (KP / 8)) * 8;
      const int j = hb * HB + r;
      const bool ok = j < Hd && c < a.kc;
      cp_async16(sw1 + r * LDX + c, a.w1 + (ok ? (long long)j * a.kc + c : 0), ok);
    }
  };
  auto load_w2 = [&](int hb) {
    for (int e = tid; e < KP * (HB / 8); e += NT) {
      const int r = e / (HB / 8), c = (e - r * (HB / 8)) * 8;
      const int j = hb * HB + c;
      const bool ok = r < C && j < a.ldw2;
      cp_async16(sw2 + r * LDA + c, a.w2 + (ok ? (long long)r * a.ldw2 + j : 0), ok);
    }
  };
  load_w1(0);
  cp_async_commit();

  // the halo tile's x into sx, 8 bytes a load, every load of the tile in
  // flight together (zero outside the image, past C and in the pad rows) ...
  for (int e = tid; e < FF_HM * (KP / 4); e += NT) {
    const int r = e / (KP / 4), c = (e - r * (KP / 4)) * 4;
    uint2 v = make_uint2(0u, 0u);
    if (c < C && inside(r)) {
      const int y = y0 - 1 + r / FF_HS, xx = x0 - 1 + r % FF_HS;
      v = *reinterpret_cast<const uint2*>(x + ((long long)y * W + xx) * C + c);
    }
    *reinterpret_cast<uint2*>(sx + r * LDX + c) = v;
  }
  sync();
  // ... then LN2 in place: a warp a pixel (the row is zero past C)
  for (int r = warp; r < FF_HP; r += NT / 32) {
    if (!inside(r)) continue;
    bf16_t* row = sx + r * LDX;
    ln_row_lanes<KP>(row, row, C, C, a.lns, a.lnb, a.eps);
  }

  const int nq = warp % NQ, mset = warp / NQ;   // fc1
  const int mq = warp & 3, ch = warp >> 2;      // fc2: rows mq * 16, cols ch * KW
  // which of the thread's fc1 rows (i, hf) hold a halo pixel inside the image
  unsigned rows_in = 0;
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
      if (inside((mset + MS * i) * 16 + gq + hf * 8)) rows_in |= 1u << (2 * i + hf);
  float acc[NW][4];
#pragma unroll
  for (int nt = 0; nt < NW; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;

  for (int hb = 0; hb < nhb; ++hb) {
    cp_async_wait_all();
    sync();  // W1's slice is in, LN2 done; fc2 of hb - 1 done
    load_w2(hb);
    cp_async_commit();

    {  // fc1 + b1 + GELU -> the fp32 hidden tile, zero outside the image
      float c1[MI][2][4];
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) c1[i][0][e] = c1[i][1][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KP / 16; ++kk) {
        uint32_t t[4];
        ldmatrix_x4(t, sw1 + (nq * 16 + li + ((lane >> 4) << 3)) * LDX + kk * 16 +
                           ((lane >> 3) & 1) * 8);
        const uint32_t b0[2] = {t[0], t[1]}, b1[2] = {t[2], t[3]};
#pragma unroll
        for (int i = 0; i < MI; ++i) {
          const int mt = mset + MS * i;
          if (mt < FF_HM / 16) {
            uint32_t af[4];
            ldmatrix_x4(af, sx + (mt * 16 + (lane & 15)) * LDX + kk * 16 + (lane >> 4) * 8);
            mma_bf16_16816(c1[i][0], af, b0);
            mma_bf16_16816(c1[i][1], af, b1);
          }
        }
      }
      float bias[2][2];  // b1 of the thread's four columns (zero past Hd)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int jg = hb * HB + nq * 16 + nt * 8 + t4 * 2 + u;
          bias[nt][u] = jg < Hd ? a.b1[jg] : 0.f;
        }
#pragma unroll
      for (int i = 0; i < MI; ++i) {
        const int mt = mset + MS * i;
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int r = mt * 16 + gq + hf * 8;
          if (mt >= FF_HM / 16 || r >= FF_HP) continue;
          const bool in = rows_in >> (2 * i + hf) & 1u;
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) {
            float2 v = make_float2(0.f, 0.f);
            if (in) {
              v.x = gelu_tanh(c1[i][nt][2 * hf] + bias[nt][0]);
              v.y = gelu_tanh(c1[i][nt][2 * hf + 1] + bias[nt][1]);
            }
            *reinterpret_cast<float2*>(sh + r * LDH + nq * 16 + nt * 8 + t4 * 2) = v;
          }
        }
      }
    }
    sync();  // the hidden tile is complete; W1's slice is read out
    if (hb + 1 < nhb) load_w1(hb + 1);
    cp_async_commit();

    {  // the depthwise 3 x 3 + bd + GELU -> fc2's bf16 operand: a thread a
       // channel and RPG output rows, walking the RPG + 2 halo rows it needs
      const int j = tid % HB, py = (tid / HB) * RPG;
      const int jg = hb * HB + j;
      float w[9], bdv = 0.f;
#pragma unroll
      for (int t = 0; t < 9; ++t) w[t] = jg < Hd ? a.wd[t * Hd + jg] : 0.f;
      if (jg < Hd) bdv = a.bd[jg];
      float c0[RPG + 2], c1[RPG + 2];
#pragma unroll
      for (int hx = 0; hx < FF_HS; ++hx) {
        float c2[RPG + 2];
#pragma unroll
        for (int u = 0; u < RPG + 2; ++u) c2[u] = sh[((py + u) * FF_HS + hx) * LDH + j];
        if (hx >= 2) {
#pragma unroll
          for (int o = 0; o < RPG; ++o) {
            float s = 0.f;
#pragma unroll
            for (int dy = 0; dy < 3; ++dy) {
              s = fmaf(c0[o + dy], w[dy * 3], s);
              s = fmaf(c1[o + dy], w[dy * 3 + 1], s);
              s = fmaf(c2[o + dy], w[dy * 3 + 2], s);
            }
            sa[((py + o) * FF_T + hx - 2) * LDA + j] = __float2bfloat16(gelu_tanh(s + bdv));
          }
        }
#pragma unroll
        for (int u = 0; u < RPG + 2; ++u) {
          c0[u] = c1[u];
          c1[u] = c2[u];
        }
      }
    }
    cp_async_wait_one();  // W2's slice (W1's next may still be in flight)
    sync();               // fc2's operand is complete

    // fc2: acc += gelu(conv) [64 x HB] x the block's W2 slice
#pragma unroll
    for (int kk = 0; kk < HB / 16; ++kk) {
      uint32_t af[4];
      ldmatrix_x4(af, sa + (mq * 16 + (lane & 15)) * LDA + kk * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int np = 0; np < KW / 16; ++np) {
        uint32_t t[4];
        ldmatrix_x4(t, sw2 + (ch * KW + np * 16 + li + ((lane >> 4) << 3)) * LDA +
                           kk * 16 + ((lane >> 3) & 1) * 8);
        const uint32_t b0[2] = {t[0], t[1]}, b1[2] = {t[2], t[3]};
        mma_bf16_16816(acc[2 * np], af, b0);
        mma_bf16_16816(acc[2 * np + 1], af, b1);
      }
    }
  }

  // + b2, x dps[image], + x, one bf16 pair a store. The scale and the
  // residual round apart, as gemm.cuh's epilogue rounds them (scale 1
  // without dps): left to the compiler, the multiply fuses with the add
  // into an fma in some kernels that run this tile and not in others
  const float scale = a.dps ? a.dps[img] : 1.f;
#pragma unroll
  for (int nt = 0; nt < NW; ++nt) {
    const int c = ch * KW + nt * 8 + t4 * 2;
    if (c >= C) continue;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int p = mq * 16 + gq + hf * 8;
      const int y = y0 + p / FF_T, xx = x0 + p % FF_T;
      if (y >= H || xx >= W) continue;
      const long long off = ((img * H + y) * W + xx) * C + c;
      const __nv_bfloat162 r = *reinterpret_cast<const __nv_bfloat162*>(a.x + off);
      const float v0 = __fadd_rn(__fmul_rn(acc[nt][2 * hf] + a.b2[c], scale),
                                 __bfloat162float(r.x));
      const float v1 = __fadd_rn(
          __fmul_rn(acc[nt][2 * hf + 1] + a.b2[c + 1], scale),
          __bfloat162float(r.y));
      *reinterpret_cast<uint32_t*>(a.out + off) = pack_bf16(v0, v1);
    }
  }
}

}  // namespace fairm
