// K12: the attention half of a LeWin block with its q / k / v projections
// as three [C, C] weight blocks.
//
// Replaces the Pallas kernel _attn_kernel_split (frequency_wised_all_in_one_
// image_restoration_model_tpu/ops/pallas/lewin_block.py, reached through
// fused_block_attention where _attn_weights_fit is false, fp32 at C = 896):
//   out = x + dps * proj(window_attention(LN1(x)))
// with the relative-position bias, the additive SW-MSA mask and the all_DC
// rank-1 gain lam. The TPU kernel brings in one [C, C] block (q, k or v)
// per step of a sequential grid axis and fills a third of a qkv scratch,
// because the fp32 weights at C = 896 do not fit its VMEM at once; the core
// and the projection run at the last step. With ``shift`` the image is in
// its true layout and the SW-MSA roll by -shift is read and written through
// the row map (gemm.cuh's RowMap), so the caller rolls nothing.
//
// What bounds it on the H100: the qkv and proj products (8 M C^2
// operations): in fp32 on the CUDA cores (67 TFLOP/s, TF32 off), in bf16
// the weights' bytes at M = 256 (res 8, B = 4: 6.4 MB) and the tensor cores
// above. The launches are few rows (M = 64 B at res 8, where one window is
// the whole image) over long reductions, so filling 132 SMs is the problem.
// What the design does about it (``fused``, 8 x 8 windows and head dims up
// to 64: every C = 896 stage):
//  1. one pass applies LN1 and the window partition (a row gather through
//     the shifted map) into xo [M, kpad(C)];
//  2. one launch of a block per (window, head) forms the head's q | k | v
//     over the whole reduction and keeps them on the SM for the core: bf16
//     on wgmma (one warpgroup, m64n64 for each of q, k and v, the window's
//     and the three 64-row weight slices' k-tiles by TMA through a ring of
//     three stages), the core on the tensor cores (attention.cuh's
//     attn_mma_core); fp32 on split.cuh's FMA core (64 x 192 outputs over
//     256 threads, cp.async double-buffered k-tiles), then the logits, the
//     row-max softmax and P V as register-tiled products in shared memory.
//     q / k / v are rounded to the compute dtype after + bqkv, the attention
//     rows after the normalisation and lam, as the Pallas kernel and the
//     plain twin round them. The qkv rows never reach device memory; the
//     attention rows do once ([M, kpad(C)], C / 3 of qkv's bytes);
//  3. the projection (split.cuh's split_product): one product whose
//     epilogue adds bp, scales by dps, scatters the window rows back to
//     image rows and adds the residual, or kb fp32 parts of its reduction
//     and a fixed-order reduction where one product leaves SMs idle.
// Other shapes (windows other than 8 x 8, head dims over 64: the split
// route's shallow stages) take four passes: the gather, the qkv product,
// attention.cuh's core, the projection as above.

#include "attention.cuh"
#include "gemm.cuh"
#include "split.cuh"

using namespace fairm;

namespace {

struct QkvCoreArgs {
  const float* bqkv;  // [3C], the attention scale in q
  const float* bias;  // [h, 64, 64]
  const float* mask;  // [nW, 64, 64] additive, or null
  const float* lam;   // [B, h] all_DC gain, or null
  void* ao;           // [M, ldo] attention rows, window-major
  int C, h, d, nW, ldo;
};

// ---- bf16: wgmma --------------------------------------------------------------

// ``steps`` k-steps over a ring of S stages (step k in stage k % S, phase
// (k / S) & 1 of its full barrier): thread 0 issues a step's TMA loads
// (issue(stage, step, bar)) S steps ahead; every thread waits for the
// step's stage, runs compute(stage, step) (which waits for its own wgmma),
// and the block's barrier releases the stage. Ends with a barrier.
template <int S, typename Issue, typename Compute>
__device__ __forceinline__ void ring_steps(uint64_t* full, int steps,
                                           Issue issue, Compute compute) {
  if (threadIdx.x == 0)
    for (int k = 0; k < S && k < steps; ++k) issue(k, k, &full[k]);
  for (int k = 0; k < steps; ++k) {
    const int s = k % S;
    mbar_wait(&full[s], (k / S) & 1);
    compute(s, k);
    __syncthreads();
    if (threadIdx.x == 0 && k + S < steps) issue(s, k + S, &full[s]);
  }
}

constexpr int QB_STAGES = 3;
constexpr int QB_SLICE = 64 * WG_BK * 2;      // a 64-row k-tile: 8 KB
constexpr int QB_STAGE = 4 * QB_SLICE;        // the window's, then q's, k's, v's
constexpr int QB_LDS = 64 + 8;                // q / k / v rows in shared memory

constexpr size_t qkv_core_bf16_smem() {
  return 1024 + QB_STAGES * QB_STAGE + QB_STAGES * sizeof(uint64_t) +
         64 * sizeof(float);
}

// block (window g = blockIdx.x, head hh = blockIdx.y), one warpgroup
__global__ void __launch_bounds__(ANT)
    qkv_core_bf16(const __grid_constant__ CUtensorMap tx,
                  const __grid_constant__ CUtensorMap tw, const QkvCoreArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* sm = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + QB_STAGES * QB_STAGE);
  float* vsum = reinterpret_cast<float*>(full + QB_STAGES);
  const long long g = blockIdx.x;
  const int hh = blockIdx.y;
  const int C = a.C, d = a.d, tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  if (tid == 0) {
    for (int s = 0; s < QB_STAGES; ++s) mbar_init(&full[s], 1);
    mbar_init_fence();
  }
  __syncthreads();

  // q | k | v of the head over the window's 64 rows: the k-tile of a head
  // part is the 64 weight rows from the head's first (rows past d are the
  // next head's, or zeros past 3C, and are dropped below)
  float acc[3][32];
#pragma unroll
  for (int p = 0; p < 3; ++p)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[p][i] = 0.f;
  ring_steps<QB_STAGES>(
      full, (a.ldo + WG_BK - 1) / WG_BK,
      [&](int s, int kt, uint64_t* bar) {
        unsigned char* st = sm + s * QB_STAGE;
        mbar_expect_tx(bar, QB_STAGE);
        tma_load(st, &tx, bar, kt * WG_BK, (int)(g * 64));
        for (int p = 0; p < 3; ++p)
          tma_load(st + (p + 1) * QB_SLICE, &tw, bar, kt * WG_BK,
                   p * C + hh * d);
      },
      [&](int s, int) {
        const unsigned char* st = sm + s * QB_STAGE;
        const uint64_t da = wgmma_desc(st);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < WG_BK / 16; ++kk)
#pragma unroll
          for (int p = 0; p < 3; ++p)
            wgmma_m64n64(acc[p], da + 2 * kk,
                         wgmma_desc(st + (p + 1) * QB_SLICE) + 2 * kk);
        wgmma_commit();
        wgmma_wait<0>();
      });

  // + bqkv, rounded to bf16, into q, k, v [64][QB_LDS] over the ring; the
  // head dims past d zero (attn_mma_core's padding)
  bf16_t* q = reinterpret_cast<bf16_t*>(sm);
#pragma unroll
  for (int p = 0; p < 3; ++p) {
    bf16_t* dst = q + p * 64 * QB_LDS;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = 16 * warp + (lane >> 2) + 8 * (e >> 1);
        const int col = 8 * j + 2 * (lane & 3) + (e & 1);
        const float v =
            col < d ? acc[p][4 * j + e] + a.bqkv[p * C + hh * d + col] : 0.f;
        dst[row * QB_LDS + col] = from_f<bf16_t>(v);
      }
  }
  __syncthreads();
  const bf16_t* k = q + 64 * QB_LDS;
  const bf16_t* v = k + 64 * QB_LDS;
  const long long b = g / a.nW;
  const int wi = (int)(g - b * a.nW);
  if (a.lam) {
    attn_vsum<64, QB_LDS>(v, d, vsum);
    __syncthreads();
  }
  bf16_t* out = static_cast<bf16_t*>(a.ao) + g * 64 * (long long)a.ldo + hh * d;
  attn_mma_core<64, 64, QB_LDS>(
      q, k, v, vsum, a.bias + (long long)hh * 64 * 64,
      a.mask ? a.mask + (long long)wi * 64 * 64 : nullptr, 64, d,
      a.lam ? a.lam + b * a.h + hh : nullptr, out, a.ldo, warp);
  if (hh == 0) {  // the zero pad of the projection's A operand
    const int pad = a.ldo - C;
    bf16_t* rows = static_cast<bf16_t*>(a.ao) + g * 64 * (long long)a.ldo;
    for (int e = tid; e < 64 * pad; e += ANT)
      rows[(long long)(e / pad) * a.ldo + C + e % pad] = from_f<bf16_t>(0.f);
  }
}

// ---- fp32: the FMA core -------------------------------------------------------

constexpr int QF_STAGES = 2;
constexpr int QF_LD = 64 + 4;   // q / k / v / P rows in fp32 (dims padded to 64)
constexpr int QF_RING = (int)fma_ring_floats<4, 12, 16, QF_STAGES>();
static_assert(4 * 64 * QF_LD <= QF_RING, "q, k, v and P must fit the ring");

constexpr size_t qkv_core_f32_smem() {
  return sizeof(float) * (QF_RING + 2 * 64);
}

// block (window g = blockIdx.x, head hh = blockIdx.y) of 256 threads
__global__ void __launch_bounds__(FNT)
    qkv_core_f32(const float* xo, const float* wqkv, const QkvCoreArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* ring = reinterpret_cast<float*>(smem_raw);
  float* vsum = ring + QF_RING;
  float* rsum = vsum + 64;
  const long long g = blockIdx.x;
  const int hh = blockIdx.y;
  const int C = a.C, d = a.d, ld = a.ldo;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int warp = tid >> 5, lane = tid & 31;

  // q | k | v: output slot s of the 192 is column s % 64 of part s / 64
  float acc[4][12];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 12; ++j) acc[i][j] = 0.f;
  fma_mainloop<4, 12, 16, QF_STAGES>(
      acc, [&](int r) -> const float* { return xo + (g * 64 + r) * ld; },
      [&](int c) -> const float* {
        const int p = c >> 6, cc = c & 63;
        return cc < d ? wqkv + (long long)(p * C + hh * d + cc) * ld : nullptr;
      },
      0, ld / FK, ring, xo);

  float* q = ring;
  float* k = q + 64 * QF_LD;
  float* v = k + 64 * QF_LD;
  float* P = v + 64 * QF_LD;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 12; ++j) {
      const int slot = tx + 16 * j, p = slot >> 6, cc = slot & 63;
      q[p * 64 * QF_LD + (ty + 16 * i) * QF_LD + cc] =
          cc < d ? acc[i][j] + a.bqkv[p * C + hh * d + cc] : 0.f;
    }
  __syncthreads();

  // logits: rows ty + 16 i, keys tx + 16 j, over the 64 (padded) dims
  const long long b = g / a.nW;
  const int wi = (int)(g - b * a.nW);
  const float* bias = a.bias + (long long)hh * 64 * 64;
  const float* mask = a.mask ? a.mask + (long long)wi * 64 * 64 : nullptr;
  {
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < 64; c += 4) {
      float4 qa[4], kb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qa[i] = *reinterpret_cast<const float4*>(q + (ty + 16 * i) * QF_LD + c);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kb[j] = *reinterpret_cast<const float4*>(k + (tx + 16 * j) * QF_LD + c);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qa[i].x, kb[j].x, s[i][j]);
          s[i][j] = fmaf(qa[i].y, kb[j].y, s[i][j]);
          s[i][j] = fmaf(qa[i].z, kb[j].z, s[i][j]);
          s[i][j] = fmaf(qa[i].w, kb[j].w, s[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = ty + 16 * i, key = tx + 16 * j;
        float val = s[i][j] + bias[r * 64 + key];
        if (mask) val += mask[r * 64 + key];
        P[r * QF_LD + key] = val;
      }
  }
  if (a.lam && tid < d) {
    float sv = 0.f;
    for (int j = 0; j < 64; ++j) sv += v[j * QF_LD + tid];
    vsum[tid] = sv;
  }
  __syncthreads();

  // row-max softmax, a warp a row: P holds exp(s - max), rsum the sum
  for (int r = warp; r < 64; r += FNT / 32) {
    const float s0 = P[r * QF_LD + lane], s1 = P[r * QF_LD + lane + 32];
    const float mx = warp_max(fmaxf(s0, s1));
    const float e0 = expf(s0 - mx), e1 = expf(s1 - mx);
    P[r * QF_LD + lane] = e0;
    P[r * QF_LD + lane + 32] = e1;
    const float sum = warp_sum(e0 + e1);
    if (lane == 0) rsum[r] = sum;
  }
  __syncthreads();

  // o = P V / sum, then the all_DC gain: rows ty + 16 i, dims tx + 16 j
  float o[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) o[i][j] = 0.f;
#pragma unroll 2
  for (int key = 0; key < 64; key += 4) {
    float4 pa[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      pa[i] = *reinterpret_cast<const float4*>(P + (ty + 16 * i) * QF_LD + key);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      float vb[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) vb[j] = v[(key + kk) * QF_LD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float pv = kk == 0 ? pa[i].x : kk == 1 ? pa[i].y : kk == 2 ? pa[i].z : pa[i].w;
#pragma unroll
        for (int j = 0; j < 4; ++j) o[i][j] = fmaf(pv, vb[j], o[i][j]);
      }
    }
  }
  const float lm = a.lam ? a.lam[b * a.h + hh] : 0.f;
  float* out = static_cast<float*>(a.ao) + g * 64 * (long long)ld + hh * d;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = ty + 16 * i, c = tx + 16 * j;
      if (c >= d) continue;
      float val = o[i][j] / rsum[r];
      if (a.lam) val = (1.f + lm) * val - (lm / 64) * vsum[c];
      out[(long long)r * ld + c] = val;
    }
  if (hh == 0) {  // the zero pad of the projection's A operand
    const int pad = ld - C;
    float* rows = static_cast<float*>(a.ao) + g * 64 * (long long)ld;
    for (int e = tid; e < 64 * pad; e += FNT)
      rows[(long long)(e / pad) * ld + C + e % pad] = 0.f;
  }
}

template <typename T>
cudaError_t qkv_core(const void* xo, const void* wqkv, const QkvCoreArgs& q,
                     long long windows, cudaStream_t st) {
  const dim3 grid((unsigned)windows, (unsigned)q.h);
  if constexpr (std::is_same<T, float>::value) {
    const size_t smem = qkv_core_f32_smem();
    cudaError_t err = cudaFuncSetAttribute(
        qkv_core_f32, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    qkv_core_f32<<<grid, FNT, smem, st>>>(static_cast<const float*>(xo),
                                         static_cast<const float*>(wqkv), q);
  } else {
    CUtensorMap tx, tw;
    cudaError_t err = tensor_map(&tx, xo, windows * 64, q.ldo, q.ldo, 64);
    if (err != cudaSuccess) return err;
    if ((err = tensor_map(&tw, wqkv, 3LL * q.C, q.ldo, q.ldo, 64)) != cudaSuccess)
      return err;
    const size_t smem = qkv_core_bf16_smem();
    err = cudaFuncSetAttribute(
        qkv_core_bf16, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    qkv_core_bf16<<<grid, ANT, smem, st>>>(tx, tw, q);
  }
  return cudaSuccess;
}

}  // namespace


template <typename T>
static cudaError_t lewin_attn_split(const void* x, const float* lns,
                                    const float* lnb, const void* wqkv,
                                    const float* bqkv, const void* wp,
                                    const float* bp, const float* bias,
                                    const float* mask, const float* lam,
                                    const float* dps, void* xo, void* qkv,
                                    void* ao, float* parts, void* out, int B,
                                    int H, int W, int C, int h, int win,
                                    int shift, int kb, int fused, float eps,
                                    cudaStream_t st) {
  const int n = win * win;
  const int nW = (H / win) * (W / win);
  const long long M = (long long)B * H * W;
  const RowMap windows{1, H, W, win, B, 1, shift};
  // the fused form takes 8 x 8 windows and head dims up to 64
  if (fused && (win != 8 || h <= 0 || C % h || C / h > 64))
    return cudaErrorInvalidValue;

  // LN1 + window partition (the roll folded in) -> xo [M, kpad(C)]
  launch_prep<T>(x, C, windows, M, lns, lnb, eps, xo, st);

  cudaError_t err;
  const void* rows = xo;  // the passes' attention rows reuse xo
  if (fused) {
    const QkvCoreArgs q{bqkv, bias, mask, lam, ao, C, h, C / h, nW, kpad(C)};
    if ((err = qkv_core<T>(xo, wqkv, q, (long long)B * nW, st)) != cudaSuccess)
      return err;
    rows = ao;
  } else {
    GemmArgs g1{};
    g1.A = xo;
    g1.Wt = wqkv;
    g1.lda = kpad(C);
    g1.bias = bqkv;
    g1.hw = (long long)H * W;
    g1.C = qkv;
    g1.cmap = identity_map();
    g1.M = M;
    g1.N = 3 * C;
    if constexpr (std::is_same<T, float>::value)
      err = launch_fma_gemm(g1, 1, st);
    else
      err = launch_gemm<T>(g1, st);
    if (err != cudaSuccess) return err;
    AttnArgs at{};
    at.qkv = qkv;
    at.out = xo;
    at.bias = bias;
    at.mask = mask;
    at.lam = lam;
    at.n = n;
    at.n0 = n;
    at.d = C / h;
    at.C = C;
    at.h = h;
    at.ldo = kpad(C);
    at.nW = nW;
    at.imgs_per_bias = B;
    if ((err = launch_attn<T>(at, (long long)B * nW, st)) != cudaSuccess)
      return err;
  }
  // proj + bp, x dps, scattered to image rows, + the residual
  return split_product<T>(rows, wp, kpad(C), M, C, bp, dps, (long long)H * W,
                          x, out, windows, kb, parts, st);
}

extern "C" int fairm_lewin_attn_split(
    const void* x, const void* lns, const void* lnb, const void* wqkv,
    const void* bqkv, const void* wp, const void* bp, const void* bias,
    const void* mask, const void* lam, const void* dps, void* xo, void* qkv,
    void* ao, void* parts, void* out, int B, int H, int W, int C, int h,
    int win, int shift, int kb, int is_bf16, int fused, float eps,
    void* stream) {
  auto f = [&](auto tag) {
    using T = decltype(tag);
    return lewin_attn_split<T>(
        x, (const float*)lns, (const float*)lnb, wqkv, (const float*)bqkv, wp,
        (const float*)bp, (const float*)bias, (const float*)mask,
        (const float*)lam, (const float*)dps, xo, qkv, ao, (float*)parts, out,
        B, H, W, C, h, win, shift, kb, fused, eps, (cudaStream_t)stream);
  };
  cudaError_t err = is_bf16 ? f(bf16_t{}) : f(float{});
  if (err == cudaSuccess) err = cudaGetLastError();
  return (int)err;
}
