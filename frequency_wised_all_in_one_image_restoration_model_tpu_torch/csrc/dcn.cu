// K11: modulated deformable convolution v2 (stride 1), the LeFF's DCN of the
// decoder's deform_conv injection and DGRN's DCN.
//
// Replaces the Pallas kernel _kernel of dcn_shift_kernel
// (frequency_wised_all_in_one_image_restoration_model_tpu/ops/pallas/dcn.py)
// with the semantics of the JAX package's default, the exact gather
// composite _exact_dcn (ops/deform_conv.py): x [B, H, W, C] (NHWC), offset
// [B, Ho, Wo, 2K] (all K dy, then all K dx), mask [B, Ho, Wo, K] (already
// sigmoided), the weight as the GEMM operand Wt [Cout, kpad(K C)] (row o,
// column t C + c = weight[t / kw, t % kw, c, o]), bias [Cout] fp32 or null;
// out [B, Ho, Wo, Cout]. The sample of tap t at output pixel (y, x) is the
// bilinear sample of the zero-padded image at (y - pad + (t / kw) dil + dy,
// x - pad + (t % kw) dil + dx), with _bilinear_gather's rim rule: the
// coordinates clipped to [-1, H] and the base corner to H - 1, every corner
// outside the image reading zero. A clamp >= 0 first clamps every offset to
// [-clamp, clamp]: the semantics of the TPU kernel, which clamps to a radius
// R so that it can replace the gather by a static shift-sum (a workaround
// for Mosaic's gather limits that costs about six times the arithmetic).
//
// What bounds it on the H100: the contraction, 2 B Ho Wo K C Cout
// operations (118 GFLOP per block at B = 32, 128^2, C = 112); the gather
// reads each input pixel about 4 K times, mostly from L2. A column matrix
// [B Ho Wo, kpad(K C)] staged through device memory between a gather pass
// and a GEMM costs about 12x the kernel's bytes (604 MB at DGRN's B = 32,
// C = 64).
//
// Two routes, which the caller chooses by width (ops/deform_conv.py::
// dcn_path, from the A/B on an H100 in PERF.md section 6): the column route
// (the column pass of dcn.cuh into a column matrix in x's type, then the
// GEMM of gemm.cuh: wgmma in bf16 where K >= 192 and N > 64, FMA in fp32),
// and in bf16 the implicit GEMM, which stages no column matrix.
//
// The implicit GEMM: a CTA of sixteen warps owns 8 x 16 output pixels of one image x
// BN output channels (BN = 64 for Cout <= 64, else 128; a warp 32 x BN / 4
// of it on mma.sync m16n8k16 with fp32 accumulators). It computes the footing
// of each of its pixels' K samples once (dcn.cuh::footing: the base corner,
// which corners lie inside the image, the four bilinear weights, the
// modulation) into shared memory, with the bounding box of the corners they
// read. The contraction runs channel block by channel block (32 channels),
// tap by tap within a block, one k-tile a (block, tap): where the box holds
// at most IG_PATCH pixels, the block's patch of x (the box x 32 channels)
// comes into shared memory by cp.async, one block ahead, and every tap of
// the block reads its four corners from there (x read once a block, not
// 4 K times); otherwise the corners come from x through L1. Each k-tile's A
// tile is the column pass's sum (fp32, corners 00, 01, 10, 11, times the
// modulation, rounded once to bf16), built into one of two A tiles while
// the other feeds the products; the weight tiles come by cp.async through a
// ring of IG_SB stages. The bias goes in the epilogue, staged through
// shared memory so that the output is written in whole rows. Single
// channels (C % 8 != 0) walk the columns t C + c in k-tiles of 32, their
// corners read from x.
//
// Measured on an H100 (PERF.md section 6): at DGRN's C = 64 (and C = 3) a
// little faster than the column route, at the deformable LeFF's widths
// (C = 112 ... 896) 1.5-4x slower, so those keep the column route. Its
// products alone (the A build
// left out) take about the parent's whole time at res 128, C = 112 (mma.sync
// at some 100 TFLOP/s against the wgmma tile's 290), and the A build about
// as much again, the two serialised in the same warps; sixteen warps a CTA
// rather than eight took 10-14% off. Variants tried on the card (a ring of
// cp.async corner stages, producer and consumer warps, 64- and 128-channel
// k-tiles of one tap, chunks ordered channel block first, the corners from
// x in registers) were slower. wgmma from the A tiles, with producer warps
// building them, is the next step.

#include "dcn.cuh"

using namespace fairm;

namespace {

constexpr int IG_TH = 8, IG_TW = 16;    // a CTA's output pixels: 8 x 16 of an image
constexpr int IG_BM = IG_TH * IG_TW;    // 128
constexpr int IG_BK = 32;               // channels of a k-tile (of one tap)
constexpr int IG_LDS = IG_BK + 8;       // A / B tile row stride (elements)
constexpr int IG_WN = 4;                // warps across the output channels
constexpr int IG_NT = 512;              // 4 x IG_WN warps of 32 x BN / IG_WN
constexpr int IG_TAPS = 9;              // the most taps the footing table holds
constexpr int IG_PATCH = 768;           // pixels a patch buffer holds
constexpr int IG_PST = IG_BK + 8;       // a patch pixel's stride: 32 channels + 8,
                                        // so that neighbouring pixels' reads
                                        // fall on distinct banks
constexpr int IG_SB = 4;                // the ring of weight tiles

// where sample (pixel, tap) of a CTA reads: its base corner (image
// coordinates), which corners lie inside the image (bits 00, 01, 10, 11),
// their weights and the modulation
struct alignas(16) IgFoot {
  int iy, ix;
  int ok;
  float m;
  float w[4];
};

// the shared-memory layout (byte offsets): two x patches, two A tiles, a
// ring of IG_SB weight tiles, the footings, the patch's bounds
template <int BN>
struct IgShape {
  static constexpr size_t PT = sizeof(bf16_t) * IG_PATCH * IG_PST;
  static constexpr size_t AT = sizeof(bf16_t) * IG_BM * IG_LDS;
  static constexpr size_t BT = sizeof(bf16_t) * BN * IG_LDS;
  static constexpr size_t OA = 2 * PT;
  static constexpr size_t OB = OA + 2 * AT;
  static constexpr size_t OFOOT = OB + IG_SB * BT;
  static constexpr size_t OBOX = OFOOT + sizeof(IgFoot) * IG_BM * IG_TAPS;
  static constexpr size_t BYTES = OBOX + 4 * sizeof(int);
};

// V channels a chunk: 8 (16 bytes) where C % 8 == 0 and x is aligned, else 1
template <int BN, int V>
__global__ void __launch_bounds__(IG_NT, 1)
    dcn_igemm_kernel(const ColArgs c, const bf16_t* wt, const float* bias,
                     bf16_t* out, int Cout) {
  using S = IgShape<BN>;
  constexpr int NI = BN / IG_WN / 8;          // n8 tiles a warp
  constexpr int CH = IG_BM * (IG_BK / V) / IG_NT;  // A chunks a thread
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16_t* Ps = reinterpret_cast<bf16_t*>(smem_raw);
  bf16_t* As = reinterpret_cast<bf16_t*>(smem_raw + S::OA);
  bf16_t* Bs = reinterpret_cast<bf16_t*>(smem_raw + S::OB);
  IgFoot* foot = reinterpret_cast<IgFoot*>(smem_raw + S::OFOOT);
  int* box = reinterpret_cast<int*>(smem_raw + S::OBOX);  // y0, y1, x0, x1

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int K = c.kh * c.kw, C = c.C, ldw = c.ldc;
  // 16-byte chunks: k-tile kt is tap kt % K of channel block kt / K (32
  // channels); single channels: k-tile kt is columns kt 32 ... of t C + c
  const int nb = (C + IG_BK - 1) / IG_BK;     // channel blocks
  const int KT = V == 8 ? nb * K : ldw / IG_BK;
  const int tiles_x = (c.Wo + IG_TW - 1) / IG_TW;
  const int tiles_y = (c.Ho + IG_TH - 1) / IG_TH;
  const int tx = blockIdx.x % tiles_x;
  const int ty = (blockIdx.x / tiles_x) % tiles_y;
  const long long b = blockIdx.x / tiles_x / tiles_y;
  const int n0 = blockIdx.y * BN;
  const bf16_t* x = static_cast<const bf16_t*>(c.x);
  const bf16_t* xb = x + b * c.H * (long long)c.W * C;

  if (tid == 0) {
    box[0] = box[2] = 0x7fffffff;
    box[1] = box[3] = -0x7fffffff;
  }
  __syncthreads();
  // the footings of the tile's samples and the bounds of the corners they
  // read
  int y0 = 0x7fffffff, y1 = -0x7fffffff, x0 = 0x7fffffff, x1 = -0x7fffffff;
  for (int e = tid; e < IG_BM * K; e += IG_NT) {
    const int i = e / K, t = e - i * K;
    const int oy = ty * IG_TH + i / IG_TW, ox = tx * IG_TW + i % IG_TW;
    IgFoot F{};
    if (oy < c.Ho && ox < c.Wo) {
      const long long pix = (b * c.Ho + oy) * c.Wo + ox;
      const Footing f = footing(c, pix, oy, ox, t);
      const bool r0 = f.iy >= 0, r1 = f.iy + 1 < c.H;
      const bool c0 = f.ix >= 0, c1 = f.ix + 1 < c.W;
      F.iy = f.iy;
      F.ix = f.ix;
      F.ok = (r0 && c0) | (r0 && c1) << 1 | (r1 && c0) << 2 | (r1 && c1) << 3;
      F.w[0] = (1.f - f.fy) * (1.f - f.fx);
      F.w[1] = (1.f - f.fy) * f.fx;
      F.w[2] = f.fy * (1.f - f.fx);
      F.w[3] = f.fy * f.fx;
      F.m = c.mask[pix * K + t];
      if (F.ok) {
        y0 = min(y0, r0 ? f.iy : f.iy + 1);
        y1 = max(y1, r1 ? f.iy + 1 : f.iy);
        x0 = min(x0, c0 ? f.ix : f.ix + 1);
        x1 = max(x1, c1 ? f.ix + 1 : f.ix);
      }
    }
    foot[i * IG_TAPS + t] = F;
  }
  atomicMin(&box[0], y0);
  atomicMax(&box[1], y1);
  atomicMin(&box[2], x0);
  atomicMax(&box[3], x1);
  __syncthreads();
  const int py0 = box[0], px0 = box[2];
  const int ph = box[1] - py0 + 1, pw = box[3] - px0 + 1;
  // the corners come from a patch of x in shared memory, a channel block at
  // a time, where the tile's samples land close enough together
  const bool patch = V == 8 && K >= IG_SB && ph > 0 && pw > 0 &&
                     (long long)ph * pw <= IG_PATCH;

  // channel block cb of the patch into buffer p (cp.async, 16 bytes a copy)
  auto load_patch = [&](int cb, int p) {
    bf16_t* ps = Ps + p * IG_PATCH * IG_PST;
    const int cbw = min(IG_BK, C - cb * IG_BK), cv = cbw / 8;
    const int n = ph * pw * cv;
    for (int q = tid; q < n; q += IG_NT) {
      const int px = q / cv, j = q - px * cv;
      const int yy = py0 + px / pw, xx = px0 + px % pw;
      cp_async16(ps + px * IG_PST + j * 8,
                 xb + ((long long)yy * c.W + xx) * C + cb * IG_BK + j * 8, true);
    }
  };
  // the weight tile of k-tile kt: Wt's columns t C + cb 32 ... (zero past
  // the block's channels), or kt 32 ... (single channels)
  auto load_b = [&](int kt, bf16_t* bs) {
    if constexpr (V == 8) {
      const int cb = kt / K, t = kt - cb * K;
      const int cbw = min(IG_BK, C - cb * IG_BK);
      const long long k0 = (long long)t * C + cb * IG_BK;
      for (int q = tid; q < BN * 4; q += IG_NT) {
        const int i = q >> 2, j = (q & 3) * 8;
        const int nn = n0 + i;
        const bool ok = nn < Cout && j < cbw;
        cp_async16(bs + i * IG_LDS + j,
                   wt + (ok ? nn * (long long)ldw + k0 + j : 0), ok);
      }
    } else {
      for (int q = tid; q < BN * IG_BK; q += IG_NT) {
        const int i = q / IG_BK, j = q % IG_BK;
        const int nn = n0 + i;
        bs[i * IG_LDS + j] = nn < Cout ? wt[nn * (long long)ldw + kt * IG_BK + j]
                                       : from_f<bf16_t>(0.f);
      }
    }
  };
  // the A tile of k-tile kt: each sample the column pass's sum (fp32, the
  // corners in order, then the modulation, rounded once to bf16), its
  // corners from the patch or from x
  auto build_a = [&](int kt, bf16_t* as) {
    const int cb = kt / K;
    const bf16_t* ps = Ps + (cb & 1) * IG_PATCH * IG_PST;
#pragma unroll
    for (int j = 0; j < CH; ++j) {
      const int q = tid + j * IG_NT;
      const int row = q / (IG_BK / V), col = (q % (IG_BK / V)) * V;
      int t, ch;  // the chunk's tap and its first channel
      bool in;
      if constexpr (V == 8) {
        t = kt - cb * K;
        ch = cb * IG_BK + col;
        in = ch < C;
      } else {
        const int k = kt * IG_BK + col;
        t = k / C;
        ch = k - t * C;
        in = t < K;
      }
      const IgFoot F = foot[row * IG_TAPS + (in ? t : 0)];  // two 16-byte reads
      const IgFoot* f = &F;
      Pack<bf16_t, V> v;
#pragma unroll
      for (int u = 0; u < V; ++u) v.v[u] = from_f<bf16_t>(0.f);
      if (in && f->ok) {
        float s[V];
#pragma unroll
        for (int u = 0; u < V; ++u) s[u] = 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (f->ok >> i & 1) {
            const int yy = f->iy + (i >> 1), xx = f->ix + (i & 1);
            const Pack<bf16_t, V> cr = *reinterpret_cast<const Pack<bf16_t, V>*>(
                patch ? ps + ((yy - py0) * pw + (xx - px0)) * IG_PST + col
                      : xb + ((long long)yy * c.W + xx) * C + ch);
            const float w = f->w[i];
#pragma unroll
            for (int u = 0; u < V; ++u) s[u] += w * to_f(cr.v[u]);
          }
#pragma unroll
        for (int u = 0; u < V; ++u) v.v[u] = from_f<bf16_t>(s[u] * f->m);
      }
      *reinterpret_cast<Pack<bf16_t, V>*>(as + row * IG_LDS + col) = v;
    }
  };

  float acc[2][NI][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  // cp.async groups: the prologue's IG_SB - 1 (the first weight tiles, the
  // first two blocks' patches); then one an iteration kt, with the weight
  // tile kt + IG_SB - 1 and, at a block's first tap, the patch of the block
  // after next, so that the wait for all but the newest IG_SB - 2 groups
  // finds k-tile kt's weights landed, and a patch lands K >= IG_SB taps
  // before its block's first A tile is built
#pragma unroll
  for (int s = 0; s < IG_SB - 1; ++s) {
    if (patch && s < 2 && s < nb) load_patch(s, s);
    if (s < KT) load_b(s, Bs + s * BN * IG_LDS);
    cp_async_commit();
  }
  cp_async_wait_all();
  __syncthreads();
  build_a(0, As);

  const int wm = warp / IG_WN, wn = warp % IG_WN;
  for (int kt = 0; kt < KT; ++kt) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(IG_SB - 2));
    __syncthreads();  // A and B of k-tile kt; the stages of kt - 1 are free
    const int cur = kt & 1, nxt = cur ^ 1;
    const int nk = kt + IG_SB - 1;
    if (nk < KT) load_b(nk, Bs + (nk % IG_SB) * BN * IG_LDS);
    const int cb = kt / K;
    if (patch && kt == cb * K && cb >= 1 && cb + 1 < nb)
      load_patch(cb + 1, (cb + 1) & 1);
    cp_async_commit();
    const bf16_t* as = As + cur * IG_BM * IG_LDS;
    const bf16_t* bs = Bs + (kt % IG_SB) * BN * IG_LDS;
#pragma unroll
    for (int kk = 0; kk < IG_BK; kk += 16) {
      uint32_t af[2][4], bfr[NI][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int r = wm * 32 + mi * 16 + (lane & 15);
        ldmatrix_x4(af[mi], as + r * IG_LDS + kk + (lane >> 4) * 8);
      }
#pragma unroll
      for (int np = 0; np < NI / 2; ++np) {
        const int nr = wn * (BN / IG_WN) + np * 16 + (lane & 7) + ((lane >> 4) << 3);
        uint32_t tt[4];
        ldmatrix_x4(tt, bs + nr * IG_LDS + kk + ((lane >> 3) & 1) * 8);
        bfr[np * 2][0] = tt[0];
        bfr[np * 2][1] = tt[1];
        bfr[np * 2 + 1][0] = tt[2];
        bfr[np * 2 + 1][1] = tt[3];
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < NI; ++ni) mma_bf16_16816(acc[mi][ni], af[mi], bfr[ni]);
    }
    if (kt + 1 < KT) build_a(kt + 1, As + nxt * IG_BM * IG_LDS);
  }
  cp_async_wait_all();

  // the epilogue: the fp32 accumulators through shared memory (over the
  // patches, all read), then four adjacent columns a thread: + bias,
  // rounded to bf16, whole rows
  constexpr int LDC = BN + 8;
  static_assert(sizeof(float) * IG_BM * LDC <= S::OA, "the C tile must fit");
  float* Cs = reinterpret_cast<float*>(smem_raw);
  const int gq = lane >> 2, t4 = lane & 3;
  __syncthreads();
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int e = 0; e < 4; e += 2)
        *reinterpret_cast<float2*>(
            Cs + (wm * 32 + mi * 16 + gq + (e >= 2 ? 8 : 0)) * LDC +
            wn * (BN / IG_WN) + ni * 8 + t4 * 2) =
            make_float2(acc[mi][ni][e], acc[mi][ni][e + 1]);
  __syncthreads();
  GemmArgs g{};
  g.bias = bias;
  g.hw = 1;
  g.C = out;
  g.N = Cout;
  const bool vec = gemm_vec<bf16_t>(g);
  for (int idx = tid; idx < IG_BM * (BN / 4); idx += IG_NT) {
    const int lr = idx / (BN / 4), cv = idx % (BN / 4);
    const int oy = ty * IG_TH + lr / IG_TW, ox = tx * IG_TW + lr % IG_TW;
    const int col = n0 + cv * 4;
    if (oy >= c.Ho || ox >= c.Wo || col >= Cout) continue;
    gemm_store4<bf16_t>(g, (b * c.Ho + oy) * c.Wo + ox, 1.f, col,
                        *reinterpret_cast<const float4*>(Cs + lr * LDC + cv * 4),
                        vec);
  }
}

template <int BN, int V>
cudaError_t igemm_launch(const ColArgs& c, const void* wt, const float* bias,
                         void* out, int Cout, cudaStream_t st) {
  using S = IgShape<BN>;
  auto kernel = dcn_igemm_kernel<BN, V>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)S::BYTES);
  if (err != cudaSuccess) return err;
  const long long tiles = (long long)c.B * ((c.Ho + IG_TH - 1) / IG_TH) *
                          ((c.Wo + IG_TW - 1) / IG_TW);
  const dim3 grid((unsigned)tiles, (unsigned)((Cout + BN - 1) / BN));
  kernel<<<grid, IG_NT, S::BYTES, st>>>(c, static_cast<const bf16_t*>(wt),
                                        bias, static_cast<bf16_t*>(out), Cout);
  return cudaGetLastError();
}

cudaError_t dcn_implicit(const ColArgs& c, const void* wt, const float* bias,
                         void* out, int Cout, cudaStream_t st) {
  if (c.kh * c.kw > IG_TAPS) return cudaErrorInvalidValue;
  const bool vec = dcn_vec_ok<bf16_t>(c.C, c.x);
  if (Cout <= 64)
    return vec ? igemm_launch<64, 8>(c, wt, bias, out, Cout, st)
               : igemm_launch<64, 1>(c, wt, bias, out, Cout, st);
  return vec ? igemm_launch<128, 8>(c, wt, bias, out, Cout, st)
             : igemm_launch<128, 1>(c, wt, bias, out, Cout, st);
}

// the column route: the column pass into cols, then the GEMM (bf16 with
// K >= 192 and N > 64 on the wgmma tile of gemm.cuh, else mma.sync; fp32 FMA)
template <typename T>
cudaError_t dcn_columns(const ColArgs& c, const void* wt, const float* bias,
                        void* out, int Cout, cudaStream_t st) {
  cudaError_t err = launch_cols<T>(c, st);
  if (err != cudaSuccess) return err;
  GemmArgs g{};
  g.A = c.cols;
  g.Wt = wt;
  g.lda = c.ldc;
  g.bias = bias;
  g.hw = 1;
  g.C = out;
  g.cmap = identity_map();
  g.M = (long long)c.B * c.Ho * c.Wo;
  g.N = Cout;
  return launch_gemm<T>(g, st);
}

}  // namespace

// cols: [B Ho Wo, kpad(K C)] in x's type for the column route; null for the
// implicit GEMM (bf16 only)
extern "C" int fairm_dcn(const void* x, const void* off, const void* mask,
                         const void* wt, const void* bias, void* cols, void* out,
                         int B, int H, int W, int C, int Ho, int Wo, int Cout,
                         int kh, int kw, int pad, int dil, float clamp,
                         int is_bf16, void* stream) {
  const ColArgs c{x, (const float*)off, (const float*)mask, cols, B, H, W, C,
                  Ho, Wo, kh, kw, pad, dil, kpad(kh * kw * C), clamp};
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err;
  if (!cols)
    err = is_bf16 ? dcn_implicit(c, wt, (const float*)bias, out, Cout, st)
                  : cudaErrorInvalidValue;
  else if (is_bf16)
    err = dcn_columns<bf16_t>(c, wt, (const float*)bias, out, Cout, st);
  else
    err = dcn_columns<float>(c, wt, (const float*)bias, out, Cout, st);
  if (err == cudaSuccess) err = cudaGetLastError();
  return (int)err;
}
