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
// What bounds it on the H100: the bytes of dcol [P, K C] in x's type (75.5
// MB at DGRN's B = 4, res 128, C = 64), the two products of 2 P K C Cout
// operations each (dcol and dW), and the gather of the samples' corners
// (four C-vectors a sample, mostly from L2). The scatter of dx has one
// writer per pixel only after the samples are grouped by pixel; with float
// atomics the sums would change from run to run.
//
// Two routes, chosen here by shape (dcn_bwd_fused_ok):
//
// The fused route (bf16, C and Cout multiples of 16, at most 64: DGRN's
// DCNLayer). One kernel a (tap t, chunk of 128-pixel tiles), eight warps: the
// CTA keeps W_t [C, Cout] in shared memory, and for each tile of its chunk
// takes g's rows by cp.async (double-buffered), forms dcol_t = g W_t^T on the
// tensor cores (mma.sync m16n8k16, fp32 accumulators, rounded to bf16 into
// shared memory), then two threads a pixel compute the footing once
// (dcn.cuh::footing), read the four corners from x, and in one pass over
// dcol_t's row reduce dcol . sample, dcol . dsample/dfy and dcol . dsample/dfx
// in a fixed order (each thread its channels in order, then the pair), write
// dmask, doffset, the bucket key and the four corner weights times the
// modulation (for dx), write dcol_t's row to device memory once (for dx only),
// and leave the modulated column (the column pass's sum, rounded once) in
// place of dcol_t in shared memory; then dW_t += cols^T g on the tensor cores,
// accumulated in registers over the chunk, written once as the chunk's
// partial. No column matrix and no second read of dcol: dcol crosses device
// memory twice (one write, the reads of dx).
//
// The passes (fp32, no TF32; bf16 at other widths, the deformable LeFF's C =
// 112 ... 896 and C = 3): dcol on the port's GEMM (gemm.cuh), dmask / doffset
// / keys by a group of lanes a sample reading dcol back (grad_sample_kernel),
// the columns again by K11's pass into dcol's buffer and dW = cols^T g
// (bwd_gemm.cuh's TN product).
//
// Both then group the samples by their base corner with a stable radix sort
// of integer keys per image (counts by integer atomics, which are exact), so
// that each bucket lists its samples in sample order, and form dx by bucket
// sums: each bucket's four sums of (corner weight x modulation) dcol over
// its samples in order, each pixel's dx the sum of its four neighbouring
// buckets' in a fixed order, rounded once (dx_bucket_kernel). dW and db are
// chunk partials added in a fixed order. No float atomics: a second launch
// gives equal bits.

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
  float4* coef;       // [P K]: the four corners' weights times the modulation
};

// lanes that share a sample or a pixel: its vectors, rounded up to a power of
// two, at most a warp
__host__ __device__ inline int group_lanes(int cv) {
  int g = 1;
  while (g < cv && g < 32) g <<= 1;
  return g;
}

// what one sample s = pix K + t contributes through its footing: its
// dmask, doffset, bucket key, id and corner weights (the lane that owns the
// sample writes them; dm, dfy, dfx are its sums over the channels)
__device__ __forceinline__ void write_sample(const BwdArgs& a, const Footing& f,
                                             long long pix, int t, float m,
                                             float dm, float dfy, float dfx) {
  const ColArgs& c = a.c;
  const int K = c.kh * c.kw;
  const long long ss = pix * K + t;
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
  const float fy = f.fy, fx = f.fx;
  a.coef[ss] = make_float4((1.f - fy) * (1.f - fx) * m, (1.f - fy) * fx * m,
                           fy * (1.f - fx) * m, fy * fx * m);
}

// one V-channel vector of a sample: the four corners (zero outside the
// image), the dcol values d, and the sums dm += d sample, dfy += d
// dsample/dfy, dfx += d dsample/dfx; returns the samples (the column pass's
// sum, corners 00, 01, 10, 11 in order) in smp
template <typename T, int V>
__device__ __forceinline__ void sample_vector(const Footing& f, bool r0, bool r1,
                                              bool c0, bool c1, const T* p00,
                                              const T* p10, int C, int ch,
                                              const float* d, float* smp,
                                              float& dm, float& dfy, float& dfx) {
  const float fy = f.fy, fx = f.fx;
  const float w0 = (1.f - fy) * (1.f - fx), w1 = (1.f - fy) * fx,
              w2 = fy * (1.f - fx), w3 = fy * fx;
  float v[4][V];
#pragma unroll
  for (int i = 0; i < V; ++i) v[0][i] = v[1][i] = v[2][i] = v[3][i] = 0.f;
  auto get = [&](float* dst, const T* p) {
    const Pack<T, V> q = *reinterpret_cast<const Pack<T, V>*>(p + ch);
#pragma unroll
    for (int i = 0; i < V; ++i) dst[i] = to_f(q.v[i]);
  };
  if (r0 && c0) get(v[0], p00);
  if (r0 && c1) get(v[1], p00 + C);
  if (r1 && c0) get(v[2], p10);
  if (r1 && c1) get(v[3], p10 + C);
#pragma unroll
  for (int i = 0; i < V; ++i) {
    float s = 0.f;  // the sample as cols_kernel sums it
    if (r0 && c0) s += w0 * v[0][i];
    if (r0 && c1) s += w1 * v[1][i];
    if (r1 && c0) s += w2 * v[2][i];
    if (r1 && c1) s += w3 * v[3][i];
    smp[i] = s;
    dm += d[i] * s;
    dfy += d[i] * ((1.f - fx) * (v[2][i] - v[0][i]) + fx * (v[3][i] - v[1][i]));
    dfx += d[i] * ((1.f - fy) * (v[1][i] - v[0][i]) + fy * (v[3][i] - v[2][i]));
  }
}

// ---- the passes: dmask, doffset and the keys from dcol in device memory -----

// A group of G lanes (a power of two) takes a sample s = pix K + t, its lanes
// the sample's V-channel vectors; the group's sums are reduced by xor
// shuffles in a fixed order.
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
  const bool r0 = f.iy >= 0, r1 = f.iy + 1 < c.H, c0 = f.ix >= 0,
             c1 = f.ix + 1 < c.W;
  const T* xb = static_cast<const T*>(c.x) + b * c.H * (long long)c.W * c.C;
  const T* p00 = xb + ((long long)f.iy * c.W + f.ix) * c.C;
  const T* p10 = p00 + (long long)c.W * c.C;
  const T* drow = static_cast<const T*>(a.dcol) + ss * c.C;

  float dm = 0.f, dfy = 0.f, dfx = 0.f;
  if (live) {
    for (int e = sub; e < cv; e += G) {
      const Pack<T, V> dp = *reinterpret_cast<const Pack<T, V>*>(drow + e * V);
      float d[V], smp[V];
#pragma unroll
      for (int i = 0; i < V; ++i) d[i] = to_f(dp.v[i]);
      sample_vector<T, V>(f, r0, r1, c0, c1, p00, p10, c.C, e * V, d, smp, dm,
                          dfy, dfx);
    }
  }
  for (int o = G >> 1; o > 0; o >>= 1) {
    dm += __shfl_xor_sync(0xffffffffu, dm, o);
    dfy += __shfl_xor_sync(0xffffffffu, dfy, o);
    dfx += __shfl_xor_sync(0xffffffffu, dfx, o);
  }
  if (!live || sub != 0) return;
  write_sample(a, f, pix, t, om_at(c, c.mask, ss), dm, dfy, dfx);
}

// ---- the fused route ----------------------------------------------------------

// the fused route: C, Cout <= FB_C; a tile of FB_M pixels, eight warps (a
// sixteen-row slab of the tile each), two threads a pixel in the sample
// pass. Shared memory (byte offsets): two g tiles [FB_M][FB_LD], W_t
// [FB_C][FB_LD], the dcol / cols tile [FB_M][FB_LD] (+8: ldmatrix's rows on
// distinct banks)
constexpr int FB_C = 64, FB_M = 128, FB_NW = 8, FB_NT = FB_NW * 32;
constexpr int FB_TPP = FB_NT / FB_M, FB_LD = FB_C + 8;
constexpr size_t FB_G = sizeof(bf16_t) * FB_M * FB_LD;
constexpr size_t FB_OW = 2 * FB_G, FB_OD = FB_OW + sizeof(bf16_t) * FB_C * FB_LD;
constexpr size_t FB_BYTES = FB_OD + FB_G;
constexpr int FB_UNITS = (FB_C / 16) * (FB_C / 16) / FB_NW;  // dW's 16 x 16 units a warp
constexpr int FB_CTAS = 264;  // CTAs a launch aims at (two an SM)

// the number of chunks of the P pixels' tiles for K taps, and the tiles of a
// chunk: a function of the shapes alone, so that dW's partials (and their
// bits) do not depend on the card
inline void fused_plan(long long P, int K, long long* chunks, long long* per) {
  const long long tiles = (P + FB_M - 1) / FB_M;
  long long z = (FB_CTAS + K - 1) / K;
  if (z > tiles) z = tiles;
  if (z < 1) z = 1;
  *per = (tiles + z - 1) / z;
  *chunks = (tiles + *per - 1) / *per;
}

__global__ void __launch_bounds__(FB_NT, 2)
    dcn_bwd_fused_kernel(const BwdArgs a, const bf16_t* wkn, int ldw,
                         const bf16_t* g, int Cout, long long per,
                         float* part, bf16_t* dcol) {
  constexpr int LD = FB_LD, NT = FB_NT, TPP = FB_TPP, CM = FB_C;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16_t* Gs = reinterpret_cast<bf16_t*>(smem_raw);
  bf16_t* Ws = reinterpret_cast<bf16_t*>(smem_raw + FB_OW);
  bf16_t* Ds = reinterpret_cast<bf16_t*>(smem_raw + FB_OD);
  const ColArgs& c = a.c;
  const int K = c.kh * c.kw, C = c.C, t = blockIdx.y;
  const long long z = blockIdx.x;
  const long long P = (long long)c.B * c.Ho * c.Wo;
  const long long tiles = (P + FB_M - 1) / FB_M;
  const long long tile0 = z * per;
  const long long tile1 = tile0 + per < tiles ? tile0 + per : tiles;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, t4 = lane & 3, q = lane >> 3, qi = lane & 7;
  const int slab = warp;  // rows 16 slab ...
  const int ov = Cout / 8;  // 16-byte chunks of a g row

  // W_t: rows t C + j of the operand [K C, ldw], columns < Cout
  for (int e = tid; e < C * ov; e += NT) {
    const int i = e / ov, j = (e - i * ov) * 8;
    cp_async16(Ws + i * LD + j, wkn + ((long long)t * C + i) * ldw + j, true);
  }
  auto load_g = [&](long long tile, int buf) {
    const long long p0 = tile * FB_M;
    bf16_t* gs = Gs + buf * FB_M * LD;
    for (int e = tid; e < FB_M * ov; e += NT) {
      const int i = e / ov, j = (e - i * ov) * 8;
      const bool ok = p0 + i < P;
      cp_async16(gs + i * LD + j, g + (ok ? (p0 + i) * Cout + j : 0), ok);
    }
  };
  if (tile0 < tile1) load_g(tile0, 0);
  cp_async_commit();

  // dW_t's 16 x 16 units (C / 16 x Cout / 16 of them), unit u = warp + NW j
  const int units = (C / 16) * (Cout / 16);
  float acc2[FB_UNITS][2][4];
#pragma unroll
  for (int j = 0; j < FB_UNITS; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc2[j][h][e] = 0.f;

  // the sample pass: TPP threads a pixel, each every TPP-th 8-channel vector
  const int sp = tid / TPP, sub = tid % TPP, nv = C / 8;
  const int hw = c.Ho * c.Wo;

  for (long long tile = tile0, it = 0; tile < tile1; ++tile, ++it) {
    const int buf = (int)(it & 1);
    cp_async_wait_all();
    __syncthreads();  // g's tile (and W_t) landed; the last tile is spent
    if (tile + 1 < tile1) load_g(tile + 1, buf ^ 1);
    cp_async_commit();
    const bf16_t* gs = Gs + buf * FB_M * LD;

    // dcol_t [FB_M, C] = g W_t^T: warp w rows 16 w ..., every column
    {
      constexpr int NL = CM / 16;
      float acc[2 * NL][4];
#pragma unroll
      for (int n = 0; n < 2 * NL; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
      for (int kk = 0; kk < Cout; kk += 16) {
        uint32_t af[4];
        ldmatrix_x4(af, gs + (slab * 16 + (lane & 15)) * LD + kk + (lane >> 4) * 8);
#pragma unroll
        for (int l = 0; l < NL; ++l) {
          const int np = l;
          if (np * 16 < C) {
            uint32_t tt[4];
            ldmatrix_x4(tt, Ws + (np * 16 + qi + ((lane >> 4) << 3)) * LD + kk +
                                ((lane >> 3) & 1) * 8);
            const uint32_t b0[2] = {tt[0], tt[1]}, b1[2] = {tt[2], tt[3]};
            mma_bf16_16816(acc[2 * l], af, b0);
            mma_bf16_16816(acc[2 * l + 1], af, b1);
          }
        }
      }
#pragma unroll
      for (int l = 0; l < NL; ++l) {
        const int np = l;
        if (np * 16 < C) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            bf16_t* d = Ds + (slab * 16 + gq) * LD + np * 16 + h * 8 + t4 * 2;
            *reinterpret_cast<uint32_t*>(d) =
                pack_bf16(acc[2 * l + h][0], acc[2 * l + h][1]);
            *reinterpret_cast<uint32_t*>(d + 8 * LD) =
                pack_bf16(acc[2 * l + h][2], acc[2 * l + h][3]);
          }
        }
      }
    }
    __syncthreads();

    // the samples of tap t: dmask, doffset, key, weights; dcol_t's row to
    // device memory; the column's values over dcol_t in shared memory. The
    // vectors' corner reads are issued together (the loop unrolled).
    {
      const long long pix = tile * FB_M + sp;
      const bool live = pix < P;
      const long long pp = live ? pix : 0;
      const long long b = pp / hw;
      const int rem = (int)(pp - b * hw);
      const int oy = rem / c.Wo, ox = rem - oy * c.Wo;
      const Footing f = footing(c, pp, oy, ox, t);
      const float m = om_at(c, c.mask, pp * K + t);
      const bool r0 = f.iy >= 0, r1 = f.iy + 1 < c.H, c0 = f.ix >= 0,
                 c1 = f.ix + 1 < c.W;
      const bf16_t* xb = static_cast<const bf16_t*>(c.x) + b * c.H * (long long)c.W * C;
      const bf16_t* p00 = xb + ((long long)f.iy * c.W + f.ix) * C;
      const bf16_t* p10 = p00 + (long long)c.W * C;
      bf16_t* drow = dcol + (pp * K + t) * C;
      float dm = 0.f, dfy = 0.f, dfx = 0.f;
#pragma unroll
      for (int u = 0; u < CM / 8 / TPP; ++u) {
        const int e = sub + u * TPP;
        if (e < nv) {
          Pack<bf16_t, 8>* ds = reinterpret_cast<Pack<bf16_t, 8>*>(Ds + sp * LD + e * 8);
          const Pack<bf16_t, 8> dp = *ds;
          Pack<bf16_t, 8> col;
          if (live) {
            *reinterpret_cast<Pack<bf16_t, 8>*>(drow + e * 8) = dp;
            float d[8], smp[8];
#pragma unroll
            for (int i = 0; i < 8; ++i) d[i] = to_f(dp.v[i]);
            sample_vector<bf16_t, 8>(f, r0, r1, c0, c1, p00, p10, C, e * 8, d,
                                     smp, dm, dfy, dfx);
#pragma unroll
            for (int i = 0; i < 8; ++i) col.v[i] = from_f<bf16_t>(smp[i] * m);
          } else {
#pragma unroll
            for (int i = 0; i < 8; ++i) col.v[i] = from_f<bf16_t>(0.f);
          }
          *ds = col;
        }
      }
#pragma unroll
      for (int o = TPP >> 1; o > 0; o >>= 1) {
        dm += __shfl_xor_sync(0xffffffffu, dm, o);
        dfy += __shfl_xor_sync(0xffffffffu, dfy, o);
        dfx += __shfl_xor_sync(0xffffffffu, dfx, o);
      }
      if (live && sub == 0) write_sample(a, f, pp, t, m, dm, dfy, dfx);
    }
    __syncthreads();

    // dW_t [C, Cout] += cols^T g over the tile's pixels (dead rows: zero
    // columns and zero g)
#pragma unroll 2
    for (int kk = 0; kk < FB_M; kk += 16) {
#pragma unroll
      for (int j = 0; j < FB_UNITS; ++j) {
        const int u = warp + FB_NW * j;
        if (u < units) {
          const int mi = u / (Cout / 16), ni = u - mi * (Cout / 16);
          uint32_t af[4], tt[4];
          // matrices (m lo, k lo), (m hi, k lo), (m lo, k hi), (m hi, k hi)
          ldmatrix_x4_trans(af, Ds + (kk + (q >> 1) * 8 + qi) * LD + mi * 16 +
                                    (q & 1) * 8);
          // matrices (n lo, k lo), (n lo, k hi), (n hi, k lo), (n hi, k hi)
          ldmatrix_x4_trans(tt, gs + (kk + (q & 1) * 8 + qi) * LD + ni * 16 +
                                    (q >> 1) * 8);
          const uint32_t b0[2] = {tt[0], tt[1]}, b1[2] = {tt[2], tt[3]};
          mma_bf16_16816(acc2[j][0], af, b0);
          mma_bf16_16816(acc2[j][1], af, b1);
        }
      }
    }
  }
  cp_async_wait_all();

  // the chunk's partial of dW rows t C ...: part[z, t C + row, col]
  float* pz = part + (z * K + t) * (long long)C * Cout;
#pragma unroll
  for (int j = 0; j < FB_UNITS; ++j) {
    const int u = warp + FB_NW * j;
    if (u < units) {
      const int mi = u / (Cout / 16), ni = u - mi * (Cout / 16);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int col = ni * 16 + h * 8 + t4 * 2;
        const int row = mi * 16 + gq;
        *reinterpret_cast<float2*>(pz + (long long)row * Cout + col) =
            make_float2(acc2[j][h][0], acc2[j][h][1]);
        *reinterpret_cast<float2*>(pz + (long long)(row + 8) * Cout + col) =
            make_float2(acc2[j][h][2], acc2[j][h][3]);
      }
    }
  }
}

// the fused route takes bf16 at C, Cout multiples of 16 up to FB_C (DGRN's
// 64), with x and g 16-byte aligned. An instance for C, Cout <= 128 (sixteen
// warps, two a slab) measured slower than the passes at the deformable
// LeFF's C = 112 (PERF.md section 6), so those widths take the passes.
inline bool dcn_bwd_fused_ok(int C, int Cout, int is_bf16, const void* x,
                             const void* g) {
  return is_bf16 && C % 16 == 0 && Cout % 16 == 0 && C <= FB_C && Cout <= FB_C &&
         (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(g)) % 16 == 0;
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

// dx by bucket sums. Bucket k = (by, bx) of an image holds the samples whose
// base corner is (by - 1, bx - 1); its four sums S_i[k] = sum over its
// samples, in sample order, of (corner i's weight x the modulation) dcol[s]
// (fp32) feed pixel (y, x) as dx = ((S_0[y+1, x+1] + S_1[y+1, x]) +
// S_2[y, x+1]) + S_3[y, x], rounded once: the plain twin's index_add over
// the corner matrix and its four shifted adds, in the same order. A CTA
// takes a DX_T x DX_T tile of pixels and DX_CB channels: it forms the sums of
// the (DX_T + 1)^2 = 64 buckets the tile reads into shared memory (a group
// of lanes a bucket, each bucket's dcol rows read once; the halo buckets
// also by the neighbouring tiles, with equal bits), then writes the tile's
// dx.
constexpr int DX_T = 7, DX_CB = 32, DX_NT = 256;
constexpr int DX_BK = (DX_T + 1) * (DX_T + 1);

template <typename T, int V>
__global__ void __launch_bounds__(DX_NT) dx_bucket_kernel(
    const BwdArgs a, const int* vals, const int* start, long long n, void* dx) {
  __shared__ __align__(16) float S[DX_BK][4][DX_CB];
  const ColArgs& c = a.c;
  constexpr int LPB = V == 1 ? 32 : DX_CB / V;  // lanes a bucket
  const int tiles_x = (c.W + DX_T - 1) / DX_T, tiles_y = (c.H + DX_T - 1) / DX_T;
  const int tx = blockIdx.x % tiles_x, ty = (blockIdx.x / tiles_x) % tiles_y;
  const long long b = blockIdx.x / tiles_x / tiles_y;
  const int y0 = ty * DX_T, x0 = tx * DX_T, c0 = blockIdx.y * DX_CB;
  const int cw = min(DX_CB, c.C - c0);  // channels of this block
  const int wp = c.W + 1, nb = (c.H + 1) * wp;
  const int* sb = start + b * (nb + 1);
  const int* vb = vals + b * n;
  const float4* coef = a.coef;
  const T* dcol = static_cast<const T*>(a.dcol);
  const int tid = threadIdx.x, lane = tid % LPB;

  for (int bi = tid / LPB; bi < DX_BK; bi += DX_NT / LPB) {
    const int by = y0 + bi / (DX_T + 1), bx = x0 + bi % (DX_T + 1);
    float acc[4][V];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int v = 0; v < V; ++v) acc[i][v] = 0.f;
    const int ch = lane * V;
    if (by <= c.H && bx <= c.W) {
      const int k = by * wp + bx;
      const int lo = sb[k], hi = sb[k + 1];
      // four samples a step: lanes 0..3 of the group read their ids, then
      // every lane reads the four weights and dcol rows at once
      const int g0 = (threadIdx.x & 31) - lane;  // the group's first lane
      const unsigned gmask = (LPB == 32 ? 0xffffffffu : ((1u << LPB) - 1u) << g0);
      for (int j0 = lo; j0 < hi; j0 += 4) {
        const int mine = lane < 4 && j0 + lane < hi ? vb[j0 + lane] : -1;
        long long ids[4];
        float4 w[4];
        Pack<T, V> d[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          ids[u] = __shfl_sync(gmask, mine, g0 + u);
          if (ids[u] >= 0 && ch < cw) {
            w[u] = coef[ids[u]];
            d[u] = *reinterpret_cast<const Pack<T, V>*>(dcol + ids[u] * c.C + c0 + ch);
          }
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          if (ids[u] < 0 || ch >= cw) continue;
#pragma unroll
          for (int v = 0; v < V; ++v) {
            const float dv = to_f(d[u].v[v]);
            acc[0][v] += w[u].x * dv;
            acc[1][v] += w[u].y * dv;
            acc[2][v] += w[u].z * dv;
            acc[3][v] += w[u].w * dv;
          }
        }
      }
    }
    if (ch < DX_CB) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int v = 0; v < V; ++v) S[bi][i][ch + v] = acc[i][v];
    }
  }
  __syncthreads();
  for (int e = tid; e < DX_T * DX_T * cw; e += DX_NT) {
    const int p = e / cw, ch = e - p * cw;
    const int py = p / DX_T, px = p % DX_T;
    const int y = y0 + py, x = x0 + px;
    if (y >= c.H || x >= c.W) continue;
    const int k = py * (DX_T + 1) + px;  // bucket (y, x) in the tile's grid
    const float v = ((S[k + DX_T + 2][0][ch] + S[k + DX_T + 1][1][ch]) +
                     S[k + 1][2][ch]) + S[k][3][ch];
    static_cast<T*>(dx)[((b * c.H + y) * (long long)c.W + x) * c.C + c0 + ch] =
        from_f<T>(v);
  }
}

int radix_passes(int nb) {
  int bits = 0;
  while ((1 << bits) <= nb) ++bits;  // keys 0 .. nb
  return (bits + RADIX_BITS - 1) / RADIX_BITS;
}

struct DcnBwdBuffers {
  void* gpad;   // the passes: g as the GEMM's A operand [P, kpad(Cout)]
  void* dcol;   // dcol [P, K C] (the passes: then the columns [P, kpad(K C)])
  int *keys0, *vals0, *keys1, *vals1;
  int* cnt;     // [B, tiles, RADIX]
  int* start;   // [B, nb + 1]
  float4* coef; // [P K]
  float* part;  // the chunk partials of dW and db
};

DcnBwdBuffers dcn_bwd_buffers(Workspace& ws, int B, int H, int W, int C, int Ho,
                              int Wo, int Cout, int K, size_t tsize, bool fused) {
  const long long P = (long long)B * Ho * Wo, n = (long long)Ho * Wo * K;
  const long long tiles = (n + SORT_NT - 1) / SORT_NT;
  const long long nb = (long long)(H + 1) * (W + 1);
  DcnBwdBuffers b;
  long long chunks = chunk_count(P), per = 0;
  if (fused) fused_plan(P, K, &chunks, &per);
  b.gpad = fused ? nullptr : ws.take<unsigned char>(P * kpad(Cout) * (long long)tsize);
  b.dcol = ws.take<unsigned char>(P * (fused ? K * C : kpad(K * C)) * (long long)tsize);
  b.keys0 = ws.take<int>(P * K);
  b.vals0 = ws.take<int>(P * K);
  b.keys1 = ws.take<int>(P * K);
  b.vals1 = ws.take<int>(P * K);
  b.cnt = ws.take<int>(B * tiles * RADIX);
  b.start = ws.take<int>(B * (nb + 1));
  b.coef = ws.take<float4>(P * K);
  long long part = chunks * (long long)K * C * Cout;
  if (chunk_count(P) * (long long)Cout > part) part = chunk_count(P) * (long long)Cout;
  b.part = ws.take<float>(part);
  return b;
}

// the stable radix sort of the keys, the buckets' starts, dx
template <typename T, int V>
cudaError_t group_passes(const BwdArgs& a, const DcnBwdBuffers& w, void* dx,
                         cudaStream_t st) {
  const ColArgs& c = a.c;
  const long long n = (long long)c.Ho * c.Wo * c.kh * c.kw;
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
  const long long dx_tiles = (long long)c.B * ((c.H + DX_T - 1) / DX_T) *
                             ((c.W + DX_T - 1) / DX_T);
  dx_bucket_kernel<T, V><<<dim3((unsigned)dx_tiles,
                                (unsigned)((c.C + DX_CB - 1) / DX_CB)),
                           DX_NT, 0, st>>>(a, vin, w.start, n, dx);
  return cudaGetLastError();
}

template <typename T>
cudaError_t group_and_gather(const BwdArgs& a, const DcnBwdBuffers& w, void* dx,
                             cudaStream_t st) {
  constexpr int V = 16 / sizeof(T);
  return dcn_vec_ok<T>(a.c.C, a.c.x) ? group_passes<T, V>(a, w, dx, st)
                                     : group_passes<T, 1>(a, w, dx, st);
}

cudaError_t fused_launch(const BwdArgs& a, const void* wkn, int ldw,
                         const void* g, int Cout, const DcnBwdBuffers& w,
                         cudaStream_t st) {
  const cudaError_t err = cudaFuncSetAttribute(
      dcn_bwd_fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)FB_BYTES);
  if (err != cudaSuccess) return err;
  const ColArgs& c = a.c;
  const int K = c.kh * c.kw;
  const long long P = (long long)c.B * c.Ho * c.Wo;
  long long chunks, per;
  fused_plan(P, K, &chunks, &per);
  dcn_bwd_fused_kernel<<<dim3((unsigned)chunks, (unsigned)K), FB_NT, FB_BYTES,
                         st>>>(
      a, static_cast<const bf16_t*>(wkn), ldw, static_cast<const bf16_t*>(g),
      Cout, per, w.part, static_cast<bf16_t*>(w.dcol));
  return cudaGetLastError();
}

template <typename T>
cudaError_t dcn_bwd(const ColArgs& geo, const void* wkn, const void* g,
                    void* ws_base, long long ws_bytes, void* dx, float* doff,
                    float* dmask, float* dw, float* db, int Cout,
                    cudaStream_t st) {
  const int K = geo.kh * geo.kw, KC = K * geo.C;
  const long long P = (long long)geo.B * geo.Ho * geo.Wo;
  const bool fused = dcn_bwd_fused_ok(geo.C, Cout, sizeof(T) == 2, geo.x, g);
  Workspace ws{static_cast<unsigned char*>(ws_base), 0};
  const DcnBwdBuffers w = dcn_bwd_buffers(ws, geo.B, geo.H, geo.W, geo.C, geo.Ho,
                                          geo.Wo, Cout, K, sizeof(T), fused);
  if ((long long)ws.off > ws_bytes) return cudaErrorInvalidValue;
  BwdArgs a{geo, w.dcol, doff, dmask, w.keys0, w.vals0, w.coef};
  cudaError_t err;

  if (fused) {
    if constexpr (std::is_same<T, bf16_t>::value) {
      // dcol, dmask, doffset, the keys and weights, dW's chunk partials
      err = fused_launch(a, wkn, kpad(Cout), g, Cout, w, st);
      if (err != cudaSuccess) return err;
      long long chunks, per;
      fused_plan(P, K, &chunks, &per);
      launch_reduce8(w.part, dw, chunks, (long long)KC * Cout, st);
      err = group_and_gather<T>(a, w, dx, st);
      if (err != cudaSuccess) return err;
    }
  } else {
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
    err = launch_gemm<T>(gm, st);
    if (err != cudaSuccess) return err;

    // dmask, doffset, the keys and weights, then the buckets and dx
    constexpr int V = 16 / sizeof(T);
    const int G = group_lanes(dcn_vec_ok<T>(geo.C, geo.x) ? geo.C / V : geo.C);
    const long long total = P * K, per_block = 8LL * (32 / G);
    const unsigned blocks = (unsigned)((total + per_block - 1) / per_block);
    if (dcn_vec_ok<T>(geo.C, geo.x))
      grad_sample_kernel<T, V><<<blocks, 256, 0, st>>>(a);
    else
      grad_sample_kernel<T, 1><<<blocks, 256, 0, st>>>(a);
    err = group_and_gather<T>(a, w, dx, st);
    if (err != cudaSuccess) return err;

    // the columns again (over dcol, which is spent), then dW = cols^T g
    ColArgs cc = geo;
    cc.cols = w.dcol;
    cc.ldc = kpad(KC);
    err = launch_cols<T>(cc, st);
    if (err != cudaSuccess) return err;
    err = weight_grad_tn<T>(w.dcol, kpad(KC), w.gpad, kpad(Cout), P, KC, Cout,
                            w.part, dw, st);
    if (err != cudaSuccess) return err;
  }
  if (db) column_sums<T>(g, 0, Cout, P, Cout, w.part, db, st);
  return cudaGetLastError();
}

}  // namespace

// bytes of workspace fairm_dcn_bwd needs (by either route: the route also
// depends on the operands' alignment)
extern "C" long long fairm_dcn_bwd_ws(int B, int H, int W, int C, int Ho, int Wo,
                                      int Cout, int kh, int kw, int is_bf16) {
  size_t most = 0;
  for (const bool fused : {false, true}) {
    if (fused && !dcn_bwd_fused_ok(C, Cout, is_bf16, nullptr, nullptr)) continue;
    Workspace ws{nullptr, 0};
    dcn_bwd_buffers(ws, B, H, W, C, Ho, Wo, Cout, kh * kw, is_bf16 ? 2 : 4,
                    fused);
    if (ws.off > most) most = ws.off;
  }
  return (long long)most + 256;
}

extern "C" int fairm_dcn_bwd(const void* x, const void* off, const void* mask,
                             const void* wkn, const void* g, void* ws, void* dx,
                             void* doff, void* dmask, void* dw, void* db,
                             long long ws_bytes, int B, int H, int W, int C,
                             int Ho, int Wo, int Cout, int kh, int kw, int pad,
                             int dil, int is_bf16, int bf16_om, void* stream) {
  const ColArgs geo{x, (const float*)off, (const float*)mask, nullptr, B, H, W,
                    C, Ho, Wo, kh, kw, pad, dil, 0, -1.f, bf16_om};
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err =
      is_bf16 ? dcn_bwd<bf16_t>(geo, wkn, g, ws, ws_bytes, dx, (float*)doff,
                                (float*)dmask, (float*)dw, (float*)db, Cout, st)
              : dcn_bwd<float>(geo, wkn, g, ws, ws_bytes, dx, (float*)doff,
                               (float*)dmask, (float*)dw, (float*)db, Cout, st);
  if (err == cudaSuccess) err = cudaGetLastError();
  return (int)err;
}
