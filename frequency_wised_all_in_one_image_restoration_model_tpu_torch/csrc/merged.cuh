// The merged LeWin blocks: K4 (lewin_merged.cu, origin MSA) and K5
// (freq_merged.cu, frequency MSA). One whole block, attention half and FFN
// half, on the TRUE-layout image in ONE launch:
//   u   = x + dps1 * unroll(attn(LN1(roll(x))))   rounded to the model dtype
//   out = u + dps2 * LeFF(LN2(u))
// with attn = proj(window_attention(.)) for the origin block and
// attn = inter(intra(.)) (per-band windows, then each window's L band copies
// as one group) for the frequency block. (K5 in bf16 at the encoder's res
// 128 / 64 / 32 stages takes its band-group form instead, freq_merged.cu.)
//
// Design: one persistent cooperative kernel. The depthwise 3x3 conv of the
// FFN half needs a row and a column of u from neighbouring windows, so a
// tile's FFN depends on attention output that the tile did not compute. The
// kernel therefore walks the block phase by phase over the whole batch, every
// phase a loop of the co-resident blocks over that phase's units of work
// (the device functions of gemm.cuh, attention.cuh, dwconv.cuh, the same
// code K1-K3 launch one kernel per phase for), with a grid-wide barrier
// between phases. The intermediates live in a scratch buffer in device
// memory. The SW-MSA cyclic shift is folded into the row maps: the LN1
// gather reads the rolled image from the true one, the last projection's
// scatter writes u back to true pixels. There is no roll pass, and one
// launch per block.
//
// The origin block (K4) in bf16 runs its GEMM phases on gemm_wgmma.cuh's
// one-warpgroup tile (TMA into a ring of MERGED_WG_STAGES stages, wgmma),
// its mbarriers in a slot of shared memory that no phase touches. Where the
// fused attention half applies (fused_attn_dp, kpad(C) <= 224), its four
// attention phases are one: attn_fused.cuh's window half, LN1 through the
// projection with the rows on the SM, so the scratch holds no LN1 / qkv /
// attention rows (LN2's rows go to the second hidden buffer, dead until the
// conv writes it).

#pragma once

#include <cooperative_groups.h>

#include "attn_fused.cuh"
#include "attention.cuh"
#include "dwconv.cuh"
#include "ffn_fused.cuh"
#include "gemm.cuh"

namespace fairm {

namespace cg = cooperative_groups;

constexpr int MNT = 128;  // threads per block, as every phase's unit expects
// blocks per SM the compiler holds the registers to. The byte-bound phases
// want warps; the conv's sliding window takes about 170 registers, the
// fp32 FMA tile keeps 64 accumulators per thread and spills below 168, so
// both dtypes take 3; with the fused attention half (bf16) shared memory
// holds two blocks an SM, which may then take all the registers.
template <typename T, bool FUSED>
constexpr int merged_min_blocks() {
  return FUSED ? 2 : 3;
}
constexpr int MERGED_STAMPS = 16;
// the bf16 origin block's GEMM ring (gemm_wgmma_tile64): two stages; four
// took 96 KB, halved the blocks an SM and slowed the byte-bound phases more
// than the products gained (res 32, C = 448, B = 32: 1.86 against 1.26 ms
// on an H100)
constexpr int MERGED_WG_STAGES = 2;
// shared memory ahead of every phase's: 1024-byte alignment for TMA's
// swizzled boxes, then the slot of the GEMM ring's mbarriers
constexpr size_t MERGED_SMEM_HEAD = 2048;

struct AttnWeights {
  const void* wqkv;    // [3C, kpad(C)], the d^-0.5 scale in q
  const float* bqkv;   // [3C]
  const void* wp;      // [C, kpad(C)]
  const float* bp;     // [C]
  const float* bias;   // [h, n, n], [L, h, n, n] or [h, L*n, L*n]
};

struct MergedArgs {
  const void* x;       // [B, H, W, C], true layout; B = L * images for K5
  const float *ln1s, *ln1b;
  AttnWeights a1;      // the origin attention, or the per-band intra one
  AttnWeights a2;      // K5: the cross-band inter attention
  const float* mask;   // [nW, n, n] by the window of the rolled image, or null
  const float* lam;    // K4: [B, h] all_DC gain, or null
  const float* dps1;   // [B] or null
  const float *ln2s, *ln2b;
  const void* w1;      // [Hd, kpad(C)]
  const float* b1;
  const float* wd;     // [3, 3, Hd]
  const float* bd;
  const void* w2;      // [C, kpad(Hd)]
  const float* b2;
  const float* dps2;   // [B] or null
  void* scratch;       // B*H*W * merged_scratch_cols() elements of the model dtype
  void* out;           // [B, H, W, C]
  long long* stamps;   // null, or MERGED_STAMPS slots: the device clock (ns)
                       // at the kernel's start and after every phase
  int B, H, W, C, h, win, shift, L, Hd;
  int fused;           // K4: the attention half as one phase (attn_fused.cuh)
  float eps;
  // K4 in bf16: the GEMM phases' operands, A (box 128 rows) and B (64)
  CUtensorMap t_rows;  // LN1 / attention rows, or (fused) LN2's rows
  CUtensorMap t_hid;   // hid2
  CUtensorMap t_wqkv, t_wp, t_w1, t_w2;
};

// the scratch buffer, in elements of the model dtype (tsize bytes): xo
// [M, kpad(C)], qkv [M, 3C], y1 [M, C] (K5 only), u [M, C], hid1 [M, Hd]
// in fp32 (the LeFF's hidden, JAX's rounding points: rounded once, after the
// conv), hid2 [M, kpad(Hd)]; with the fused attention half u, hid1 and hid2
// only
__host__ __device__ inline long long merged_scratch_cols(int C, int Hd, bool freq,
                                                         bool fused, int tsize) {
  const long long ffn = (long long)C + Hd * (4 / tsize) + kpad(Hd);
  return fused ? ffn : (long long)kpad(C) + 3 * C + (freq ? C : 0) + ffn;
}

template <typename T>
__device__ __forceinline__ void gemm_tile(const GemmArgs& a, long long bx, int by,
                                          unsigned char* smem) {
  if constexpr (std::is_same<T, float>::value)
    gemm_fma_tile(a, bx, by, smem);
  else
    gemm_mma_tile<64>(a, bx, by, smem);
}

// C[cmap(r), :] = epilogue(A[r, :] @ Wt^T) over the whole grid, 128 x 64
// tiles; neighbouring blocks share an A tile. WG: on the TMA / wgmma tile,
// A and Wt also as the tensor maps ta, tb.
template <typename T, bool WG>
__device__ __forceinline__ void gemm_phase(const void* A, const void* Wt, int K,
                                           const float* bias, const float* dps,
                                           long long hw, const void* res,
                                           void* C, RowMap cmap, long long M,
                                           int N, int act, unsigned char* smem,
                                           const CUtensorMap* ta,
                                           const CUtensorMap* tb,
                                           WgPipe& pipe, int c_f32 = 0) {
  GemmArgs a{};
  a.A = A;
  a.Wt = Wt;
  a.lda = kpad(K);
  a.bias = bias;
  a.dps = dps;
  a.hw = hw;
  a.res = res;
  a.C = C;
  a.cmap = cmap;
  a.M = M;
  a.N = N;
  a.act = act;
  a.c_f32 = c_f32;
  const long long tm = (M + 127) / 128;
  const int tn = (N + 63) / 64;
  for (long long t = blockIdx.x; t < tm * tn; t += gridDim.x) {
    if constexpr (WG)
      gemm_wgmma_tile64<MERGED_WG_STAGES>(a, ta, tb, t / tn, (int)(t % tn),
                                          smem, pipe);
    else
      gemm_tile<T>(a, t / tn, (int)(t % tn), smem);
  }
}

template <typename T>
__device__ __forceinline__ void prep_phase(const void* src, int K, RowMap amap,
                                           long long M, const float* ln_g,
                                           const float* ln_b, float eps,
                                           void* dst) {
  const int wpb = MNT / 32;
  prep_rows<T>(static_cast<const T*>(src), K, amap, M, ln_g, ln_b, eps,
               static_cast<T*>(dst), kpad(K),
               (long long)blockIdx.x * wpb + (threadIdx.x >> 5),
               (long long)gridDim.x * wpb);
}

// LN2 of the M rows of u (C columns) into rows of kpad(C) columns, a warp a
// row, in the order of K2's fused tile (ln_row_lanes, KP = ffn_fused_kp(C))
template <int KP>
__device__ __forceinline__ void ln_lanes_phase(const bf16_t* src, int C,
                                               long long M, const float* ln_g,
                                               const float* ln_b, float eps,
                                               bf16_t* dst) {
  const long long warps = (long long)gridDim.x * (MNT / 32);
  for (long long r = (long long)blockIdx.x * (MNT / 32) + (threadIdx.x >> 5);
       r < M; r += warps)
    ln_row_lanes<KP>(src + r * C, dst + r * kpad(C), C, kpad(C), ln_g, ln_b,
                     eps);
}

// LN2 of u into rows2, summing each row in the order of the K2 the chain
// runs at this width: K2's fused tile in bf16 where it applies
// (ffn_fused_kp), else its passes' prep_rows
template <typename T>
__device__ __forceinline__ void ln2_phase(const T* u, int C, long long M,
                                          const float* ln_g, const float* ln_b,
                                          float eps, T* rows2) {
  if constexpr (std::is_same<T, bf16_t>::value) {
    switch (ffn_fused_kp(C, 1)) {
      case 32: ln_lanes_phase<32>(u, C, M, ln_g, ln_b, eps, rows2); return;
      case 64: ln_lanes_phase<64>(u, C, M, ln_g, ln_b, eps, rows2); return;
      case 128: ln_lanes_phase<128>(u, C, M, ln_g, ln_b, eps, rows2); return;
      case 224: ln_lanes_phase<224>(u, C, M, ln_g, ln_b, eps, rows2); return;
      default: break;
    }
  }
  prep_phase<T>(u, C, identity_map(), M, ln_g, ln_b, eps, rows2);
}

// DP > 0: the tensor-core core for N tokens and head dims <= DP (bf16);
// DP = 0: the CUDA-core core
template <typename T, int N, int DP>
__device__ __forceinline__ void attn_phase(const AttnArgs& at, long long groups,
                                           unsigned char* smem) {
  for (long long t = blockIdx.x; t < groups * at.h; t += gridDim.x) {
    const long long g = t / at.h;
    const int hh = (int)(t - g * at.h);
    if constexpr (DP > 0)
      attn_mma_tile<N, DP>(at, g, hh, smem);
    else
      attn_tile<T>(at, g, hh, reinterpret_cast<float*>(smem));
  }
}

// the grid-wide barrier that ends phase ``i`` (0: the kernel's start); one
// thread notes the time in stamps[i] when the caller asked for the phases'
// times (stamps not null)
__device__ __forceinline__ void end_phase(cg::grid_group& grid,
                                          long long* stamps, int i) {
  if (i > 0) grid.sync();
  if (stamps && blockIdx.x == 0 && threadIdx.x == 0) {
    long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    stamps[i] = t;
  }
}

__device__ __forceinline__ void end_phase(cg::grid_group& grid,
                                          const MergedArgs& p, int i) {
  end_phase(grid, p.stamps, i);
}

// DP: the attention core (attn_phase); FUSED: the attention half as one
// phase of attn_fused.cuh's window half (K4, bf16)
template <typename T, int DP, bool FREQ, bool FUSED>
__global__ void __launch_bounds__(MNT, merged_min_blocks<T, FUSED>())
    merged_kernel(const __grid_constant__ MergedArgs p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // the GEMM ring's mbarriers, then every phase's shared memory (1024-byte
  // aligned for TMA's swizzled boxes)
  constexpr bool WG = std::is_same<T, bf16_t>::value && !FREQ;
  unsigned char* head = align1024(smem_raw);
  unsigned char* smem = head + 1024;
  WgPipe pipe{reinterpret_cast<uint64_t*>(head), 0};
  if constexpr (WG) {
    if (threadIdx.x == 0) {
      for (int s = 0; s < MERGED_WG_STAGES; ++s) mbar_init(&pipe.full[s], 1);
      mbar_init_fence();
    }
    __syncthreads();
  }
  cg::grid_group grid = cg::this_grid();
  int phase = 0;
  end_phase(grid, p, phase++);

  const int C = p.C, Hd = p.Hd, n = p.win * p.win;
  const int nW = (p.H / p.win) * (p.W / p.win);
  const long long hw = (long long)p.H * p.W;
  const long long M = p.B * hw;
  const int imgs = p.B / p.L;  // images per band
  T* xo = static_cast<T*>(p.scratch);
  T* qkv = xo + (FUSED ? 0 : M * kpad(C));
  T* y1 = qkv + (FUSED ? 0 : M * 3 * C);
  T* u = y1 + (FREQ ? M * C : 0);
  float* hid1 = reinterpret_cast<float*>(u + M * C);
  T* hid2 = reinterpret_cast<T*>(hid1 + M * Hd);
  T* rows2 = FUSED ? hid2 : xo;  // LN2's rows

  const RowMap rolled{1, p.H, p.W, p.win, p.B, 1, p.shift};

  if constexpr (FUSED) {
    // LN1 through the projection, window by window, scattered to the true
    // pixels, + x -> u
    FusedAttnArgs fa{};
    fa.x = static_cast<const bf16_t*>(p.x);
    fa.lns = p.ln1s;
    fa.lnb = p.ln1b;
    fa.eps = p.eps;
    fa.wqkv = static_cast<const bf16_t*>(p.a1.wqkv);
    fa.bqkv = p.a1.bqkv;
    fa.wp = static_cast<const bf16_t*>(p.a1.wp);
    fa.bp = p.a1.bp;
    fa.bias = p.a1.bias;
    fa.mask = p.mask;
    fa.lam = p.lam;
    fa.dps = p.dps1;
    fa.res = static_cast<const bf16_t*>(p.x);
    fa.out = reinterpret_cast<bf16_t*>(u);
    fa.map = rolled;
    fa.C = C;
    fa.h = p.h;
    fa.imgs_per_bias = p.B;
    fused_attn_init<DP>(fa, smem);
    for (long long g = blockIdx.x; g < (long long)p.B * nW; g += gridDim.x)
      fused_attn_window<DP>(fa, g, nW, smem);
    end_phase(grid, p, phase++);
  } else {
    // LN1 + window partition of the rolled image -> xo
    prep_phase<T>(p.x, C, rolled, M, p.ln1s, p.ln1b, p.eps, xo);
    end_phase(grid, p, phase++);
    gemm_phase<T, WG>(xo, p.a1.wqkv, C, p.a1.bqkv, nullptr, hw, nullptr, qkv,
                      identity_map(), M, 3 * C, 0, smem, &p.t_rows, &p.t_wqkv,
                      pipe);
    end_phase(grid, p, phase++);

    AttnArgs at;
    at.qkv = qkv;
    at.out = xo;
    at.bias = p.a1.bias;
    at.mask = p.mask;
    at.lam = FREQ ? nullptr : p.lam;
    at.n = n;
    at.n0 = n;
    at.d = C / p.h;
    at.C = C;
    at.h = p.h;
    at.ldo = kpad(C);
    at.nW = nW;
    at.imgs_per_bias = FREQ ? imgs : p.B;
    attn_phase<T, 64, DP>(at, (long long)p.B * nW, smem);
    end_phase(grid, p, phase++);

    if constexpr (FREQ) {
      // intra projection -> y1 (rolled layout, rounded to the model dtype,
      // no residual), regrouped by band -> xo, then the inter attention
      gemm_phase<T, WG>(xo, p.a1.wp, C, p.a1.bp, nullptr, hw, nullptr, y1,
                        RowMap{1, p.H, p.W, p.win, p.B, 1, 0}, M, C, 0, smem,
                        nullptr, nullptr, pipe);
      end_phase(grid, p, phase++);
      prep_phase<T>(y1, C, RowMap{2, p.H, p.W, p.win, imgs, p.L, 0}, M,
                    nullptr, nullptr, 0.f, xo);
      end_phase(grid, p, phase++);
      gemm_phase<T, WG>(xo, p.a2.wqkv, C, p.a2.bqkv, nullptr, hw, nullptr, qkv,
                        identity_map(), M, 3 * C, 0, smem, nullptr, nullptr,
                        pipe);
      end_phase(grid, p, phase++);
      at.bias = p.a2.bias;
      at.n = p.L * n;
      at.imgs_per_bias = imgs;  // one shared bias
      attn_phase<T, 192, DP>(at, (long long)imgs * nW, smem);
      end_phase(grid, p, phase++);
      // inter projection, scattered to the true pixels, + x
      gemm_phase<T, WG>(xo, p.a2.wp, C, p.a2.bp, p.dps1, hw, p.x, u,
                        RowMap{2, p.H, p.W, p.win, imgs, p.L, p.shift}, M, C,
                        0, smem, nullptr, nullptr, pipe);
    } else {
      // projection, scattered to the true pixels, + x
      gemm_phase<T, WG>(xo, p.a1.wp, C, p.a1.bp, p.dps1, hw, p.x, u, rolled,
                        M, C, 0, smem, &p.t_rows, &p.t_wp, pipe);
    }
    end_phase(grid, p, phase++);
  }

  // the FFN half on u, true layout
  ln2_phase<T>(u, C, M, p.ln2s, p.ln2b, p.eps, rows2);
  end_phase(grid, p, phase++);
  gemm_phase<T, WG>(rows2, p.w1, C, p.b1, nullptr, hw, nullptr, hid1,
                    identity_map(), M, Hd, 1, smem, &p.t_rows, &p.t_w1, pipe,
                    1);
  end_phase(grid, p, phase++);
  dwconv_gelu_any<float, T>(hid1, p.wd, p.bd, hid2,
                     (long long)blockIdx.x * MNT + threadIdx.x,
                     (long long)gridDim.x * MNT, (long long)p.B * p.H, p.H,
                     p.W, Hd, kpad(Hd));
  end_phase(grid, p, phase++);
  gemm_phase<T, WG>(hid2, p.w2, Hd, p.b2, p.dps2, hw, u, p.out, identity_map(),
                    M, C, 0, smem, &p.t_hid, &p.t_w2, pipe);
  end_phase(grid, p, phase++);
}

template <typename T, int DP, bool FREQ, bool FUSED>
inline cudaError_t launch_merged_as(const MergedArgs& p, size_t smem,
                                    long long units, cudaStream_t st) {
  auto kernel = merged_kernel<T, DP, FREQ, FUSED>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  // every block must be resident for the grid barrier: the grid is what
  // the card holds at this kernel's registers and shared memory
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, MNT, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorLaunchOutOfResources;
  long long blocks = (long long)per_sm * sms;
  if (blocks > units) blocks = units;
  MergedArgs args = p;
  void* params[] = {&args};
  return cudaLaunchCooperativeKernel((void*)kernel, dim3((unsigned)blocks),
                                     dim3(MNT), params, smem, st);
}

inline size_t max_sz(size_t a, size_t b) { return a > b ? a : b; }

// K4 in bf16: the tensor maps of its GEMM phases' operands, from the
// scratch layout of merged_kernel
inline cudaError_t merged_tensor_maps(MergedArgs& p) {
  const long long M = (long long)p.B * p.H * p.W;
  const int C = p.C, Hd = p.Hd, kc = kpad(C), kh = kpad(Hd);
  const bf16_t* xo = static_cast<const bf16_t*>(p.scratch);
  const bf16_t* hid2 =
      xo + M * merged_scratch_cols(C, Hd, false, p.fused, 2) - M * kh;
  cudaError_t err;
  if ((err = tensor_map(&p.t_rows, p.fused ? hid2 : xo, M, kc, kc, WG_BM)) ||
      (err = tensor_map(&p.t_hid, hid2, M, kh, kh, WG_BM)) ||
      (err = tensor_map(&p.t_wqkv, p.a1.wqkv, 3 * C, kc, kc, WG64_BN)) ||
      (err = tensor_map(&p.t_wp, p.a1.wp, C, kc, kc, WG64_BN)) ||
      (err = tensor_map(&p.t_w1, p.w1, Hd, kc, kc, WG64_BN)) ||
      (err = tensor_map(&p.t_w2, p.w2, C, kh, kh, WG64_BN)))
    return err;
  return cudaSuccess;
}

// Picks the attention core by what the launch can observe (as launch_attn
// does for K1 / K3), sizes the shared memory for the largest phase and the
// grid for the largest phase's units. ``p.fused`` is the caller's choice
// (K4, bf16, where fused_attn_dp applies; anything else fails).
template <typename T, bool FREQ>
inline cudaError_t launch_merged(MergedArgs& p, cudaStream_t st) {
  constexpr bool BF = std::is_same<T, bf16_t>::value;
  constexpr bool WG = BF && !FREQ;
  const int n = p.win * p.win, d = p.C / p.h;
  const long long M = (long long)p.B * p.H * p.W;
  const int nW = (p.H / p.win) * (p.W / p.win);
  int dp = 0;
  if (BF && n == 64 && d <= 64 && (!FREQ || p.L == 3)) dp = d <= 32 ? 32 : 64;
  if (p.fused) {
    dp = fused_attn_dp(p.C, p.h, p.win);
    if (!BF || FREQ || !dp) return cudaErrorInvalidValue;
  }

  size_t smem = WG ? wg64_smem_bytes<MERGED_WG_STAGES>()
                   : BF ? mma_smem_bytes<64>() : FMA_SMEM;
  if (p.fused) {
    smem = max_sz(smem, fused_attn_layout(p.C, p.h, dp).bytes);
  } else if (dp == 32) {
    smem = max_sz(smem, attn_mma_smem_bytes<64, 32>());
    if (FREQ) smem = max_sz(smem, attn_mma_smem_bytes<192, 32>());
  } else if (dp == 64) {
    smem = max_sz(smem, attn_mma_smem_bytes<64, 64>());
    if (FREQ) smem = max_sz(smem, attn_mma_smem_bytes<192, 64>());
  } else {
    smem = max_sz(smem, attn_smem_bytes(FREQ ? p.L * n : n, d));
  }
  smem += MERGED_SMEM_HEAD;

  if constexpr (WG) {
    const cudaError_t err = merged_tensor_maps(p);
    if (err != cudaSuccess) return err;
  }

  const long long tm = (M + 127) / 128;
  long long units = (M + MNT / 32 - 1) / (MNT / 32);          // prep rows
  const long long g3 = tm * ((3 * p.C + 63) / 64);           // qkv tiles
  const long long g1 = tm * ((p.Hd + 63) / 64);              // fc1 tiles
  const long long at = (long long)p.B * nW * p.h;            // attention
  if (g3 > units) units = g3;
  if (g1 > units) units = g1;
  if (at > units) units = at;

  if constexpr (BF) {
    if constexpr (!FREQ) {
      if (p.fused && dp == 32) return launch_merged_as<T, 32, FREQ, true>(p, smem, units, st);
      if (p.fused) return launch_merged_as<T, 64, FREQ, true>(p, smem, units, st);
    }
    if (dp == 32) return launch_merged_as<T, 32, FREQ, false>(p, smem, units, st);
    if (dp == 64) return launch_merged_as<T, 64, FREQ, false>(p, smem, units, st);
  }
  return launch_merged_as<T, 0, FREQ, false>(p, smem, units, st);
}

}  // namespace fairm
