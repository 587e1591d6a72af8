// Products of the block backward kernels on Hopper: a pipelined GEMM with
// fp32 output for both operand layouts a backward needs, in both compute
// types. K6, K7 and K8 run every product but the qkv recompute through it,
// K14 its weight gradient.
//
//   NT:  C[m, n] = sum_k A[m, k] B[n, k]       (A x W^T: A and W k-contiguous)
//   TN:  C[z][m, n] = sum_{k in chunk z} A[k, m] B[k, n]
//                                              (A^T B: the weight gradients,
//                                               k = rows, one chunk partial
//                                               per grid z, reduced later in
//                                               a fixed order)
// Epilogue in fp32: + bias[n], x aux[m, n] (gelu'(hc) of the FFN backward),
// stored as fp32. Operands are stored in the compute type with rows of a
// multiple of 8 elements (16 bytes) and 16-byte aligned; the columns past
// the data must be finite (zeros where they enter a sum, as the k columns of
// an NT product do).
//
// bf16: tiles of 128 x BN (BN = 64 or 128) x 32, 3-stage cp.async pipeline
// of 16-byte copies, ldmatrix fragments (.trans where the tile is k-major in
// shared memory: the A of TN and the B of TN), mma.sync m16n8k16 with fp32
// accumulators, warps of 64 x 32, the epilogue staged through shared memory
// so that C is written in whole rows of 16-byte stores. fp32: full-precision FMA (no TF32), tiles
// of 128 x 64 x 16 in shared memory k-major, float4 loads staged through
// registers while the previous tile is used, 8 x 4 outputs per thread.

#pragma once

#include "bwd.cuh"

namespace fairm {

struct MGemmArgs {
  const void* A;
  long long lda;       // NT: A [M, lda], k < K; TN: A [rows, lda], m < lda
  const void* B;
  long long ldb;       // NT: B [N, ldb]; TN: B [rows, ldb]
  float* C;            // [chunks, M, ldc] (one chunk for NT)
  long long ldc;
  long long M;
  int N;
  long long K;         // NT: the k columns (a multiple of 32); TN: the rows
  long long kc;        // TN: rows per chunk (grid z); NT: K
  const float* bias;   // + bias[n], or null
  const float* aux;    // x aux[m * ldaux + n], or null
  long long ldaux;
};

__device__ __forceinline__ void mg_store(const MGemmArgs& a, float* C,
                                         long long m, int n, float v0,
                                         float v1) {
  if (m >= a.M || n >= a.N) return;
  const bool two = n + 1 < a.N;
  if (a.bias) {
    v0 += a.bias[n];
    if (two) v1 += a.bias[n + 1];
  }
  if (a.aux) {
    const float* x = a.aux + m * a.ldaux + n;
    v0 *= x[0];
    if (two) v1 *= x[1];
  }
  float* c = C + m * a.ldc + n;
  if (two && ((reinterpret_cast<uintptr_t>(c) & 7) == 0)) {
    *reinterpret_cast<float2*>(c) = make_float2(v0, v1);
  } else {
    c[0] = v0;
    if (two) c[1] = v1;
  }
}

// four adjacent columns n .. n + 3 (n % 4 == 0) of row m; ``vec``: C (and
// aux) rows of a multiple of four elements, 16-byte aligned
__device__ __forceinline__ void mg_store4(const MGemmArgs& a, float* C,
                                          long long m, int n, float4 v,
                                          bool vec) {
  if (m >= a.M || n >= a.N) return;
  if (!vec || n + 4 > a.N) {
    mg_store(a, C, m, n, v.x, v.y);
    if (n + 2 < a.N) mg_store(a, C, m, n + 2, v.z, v.w);
    return;
  }
  if (a.bias) {
    const float4 b = *reinterpret_cast<const float4*>(a.bias + n);
    v.x += b.x; v.y += b.y; v.z += b.z; v.w += b.w;
  }
  if (a.aux) {
    const float4 x = *reinterpret_cast<const float4*>(a.aux + m * a.ldaux + n);
    v.x *= x.x; v.y *= x.y; v.z *= x.z; v.w *= x.w;
  }
  *reinterpret_cast<float4*>(C + m * a.ldc + n) = v;
}

// ---- bf16: cp.async + ldmatrix + mma.sync ----------------------------------

constexpr int MG_BM = 128, MG_BK = 32, MG_STAGES = 3;

// shared-memory elements of one stage's tile: rows x (width + 8), the +8
// keeping ldmatrix's eight row addresses on distinct banks
template <bool KM, int ROWS>
__host__ __device__ constexpr int mg_tile_elems() {
  return KM ? MG_BK * (ROWS + 8) : ROWS * (MG_BK + 8);
}

template <int BN, bool A_KM, bool B_KM>
__host__ __device__ constexpr size_t mg_smem_bytes() {
  return sizeof(bf16_t) * MG_STAGES *
         (mg_tile_elems<A_KM, MG_BM>() + mg_tile_elems<B_KM, BN>());
}

// one stage: the ROWS x 32 tile of an operand whose rows (NT) or k (TN)
// start at r0 / k0. KM: the operand is [k][rows] in memory and in shared
// memory, else [rows][k].
template <bool KM, int ROWS, int NT>
__device__ __forceinline__ void mg_load(bf16_t* s, const bf16_t* g, long long ld,
                                        long long r0, long long rlim,
                                        long long k0, long long klim) {
  if (KM) {  // 32 k-rows of ROWS / 8 chunks of 16 bytes
    constexpr int CH = ROWS / 8;
    for (int c = threadIdx.x; c < MG_BK * CH; c += NT) {
      const int kk = c / CH, j = (c - kk * CH) * 8;
      const long long k = k0 + kk, r = r0 + j;
      const bool ok = k < klim && r < rlim;
      cp_async16(s + kk * (ROWS + 8) + j, g + (ok ? k * ld + r : 0), ok);
    }
  } else {  // ROWS rows of 4 chunks of 16 bytes
    for (int c = threadIdx.x; c < ROWS * 4; c += NT) {
      const int i = c >> 2, j = (c & 3) * 8;
      const long long r = r0 + i, k = k0 + j;
      const bool ok = r < rlim && k < klim;
      cp_async16(s + i * (MG_BK + 8) + j, g + (ok ? r * ld + k : 0), ok);
    }
  }
}

template <int BN, bool A_KM, bool B_KM>
__global__ void __launch_bounds__(BN * 2) mg_mma_kernel(const MGemmArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int NT = BN * 2, WARPS_N = BN / 32;
  constexpr int AE = mg_tile_elems<A_KM, MG_BM>(), BE = mg_tile_elems<B_KM, BN>();
  bf16_t* As = reinterpret_cast<bf16_t*>(smem_raw);
  bf16_t* Bs = As + MG_STAGES * AE;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long long m0 = (long long)blockIdx.x * MG_BM;
  const int n0 = blockIdx.y * BN;
  const bf16_t* A = static_cast<const bf16_t*>(a.A);
  const bf16_t* B = static_cast<const bf16_t*>(a.B);
  const long long k_lo = (long long)blockIdx.z * a.kc;
  const long long k_hi = k_lo + a.kc < a.K ? k_lo + a.kc : a.K;
  const int KT = (int)((k_hi - k_lo + MG_BK - 1) / MG_BK);
  // the operands' extent along m / n: NT rows, TN columns (the zero-filled
  // pad past them reaches only outputs that are not stored)
  const long long mlim = A_KM ? a.lda : a.M;
  const long long nlim = B_KM ? a.ldb : a.N;

  auto load = [&](int stage, int kt) {
    const long long k0 = k_lo + (long long)kt * MG_BK;
    mg_load<A_KM, MG_BM, NT>(As + stage * AE, A, a.lda, m0, mlim, k0, k_hi);
    mg_load<B_KM, BN, NT>(Bs + stage * BE, B, a.ldb, n0, nlim, k0, k_hi);
  };

#pragma unroll
  for (int s = 0; s < MG_STAGES - 1; ++s) {
    if (s < KT) load(s, s);
    asm volatile("cp.async.commit_group;\n" ::);
  }
  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const int q = lane >> 3, qi = lane & 7;  // ldmatrix: matrix q, its row qi
  for (int kt = 0; kt < KT; ++kt) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(MG_STAGES - 2));
    __syncthreads();
    const int next = kt + MG_STAGES - 1;
    if (next < KT) load(next % MG_STAGES, next);
    asm volatile("cp.async.commit_group;\n" ::);

    const bf16_t* as = As + (kt % MG_STAGES) * AE;
    const bf16_t* bs = Bs + (kt % MG_STAGES) * BE;
#pragma unroll
    for (int kk = 0; kk < MG_BK; kk += 16) {
      uint32_t af[4][4], bfr[4][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        const int mb = wm * 64 + mi * 16;
        if (A_KM)  // matrices (m lo, k lo), (m hi, k lo), (m lo, k hi), (m hi, k hi)
          ldmatrix_x4_trans(af[mi], as + (kk + (q >> 1) * 8 + qi) * (MG_BM + 8) +
                                        mb + (q & 1) * 8);
        else
          ldmatrix_x4(af[mi], as + (mb + (lane & 15)) * (MG_BK + 8) + kk +
                                  (lane >> 4) * 8);
      }
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        // matrices (n lo, k lo), (n lo, k hi), (n hi, k lo), (n hi, k hi)
        const int nb = wn * 32 + np * 16;
        uint32_t t[4];
        if (B_KM)
          ldmatrix_x4_trans(t, bs + (kk + (q & 1) * 8 + qi) * (BN + 8) + nb +
                                   (q >> 1) * 8);
        else
          ldmatrix_x4(t, bs + (nb + qi + ((lane >> 4) << 3)) * (MG_BK + 8) + kk +
                             ((lane >> 3) & 1) * 8);
        bfr[np * 2][0] = t[0];
        bfr[np * 2][1] = t[1];
        bfr[np * 2 + 1][0] = t[2];
        bfr[np * 2 + 1][1] = t[3];
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_bf16_16816(acc[mi][ni], af[mi], bfr[ni]);
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::);

  // Epilogue through shared memory, over the operand stages: RP rows of
  // accumulators at a time go to an fp32 tile, then each thread stores four
  // adjacent columns of a row, so that a warp writes whole rows of C
  constexpr int RP = BN == 64 ? MG_BM : MG_BM / 2, LDT = BN + 8;
  static_assert(sizeof(float) * RP * LDT <= mg_smem_bytes<BN, A_KM, B_KM>(),
                "the C tile must fit the operand stages");
  float* Ct = reinterpret_cast<float*>(smem_raw);
  float* C = a.C + (long long)blockIdx.z * a.M * a.ldc;
  const bool vec = a.ldc % 4 == 0 && (!a.aux || a.ldaux % 4 == 0) &&
                   (reinterpret_cast<uintptr_t>(C) | reinterpret_cast<uintptr_t>(a.aux)) % 16 == 0;
  const int g = lane >> 2, t4 = lane & 3, rbase = (wm * 64) % RP;
#pragma unroll
  for (int pass = 0; pass < MG_BM / RP; ++pass) {
    __syncthreads();  // the stages (or the last pass's tile) are read out
    if (RP == MG_BM || wm == pass) {
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            *reinterpret_cast<float2*>(
                Ct + (rbase + mi * 16 + g + h * 8) * LDT + wn * 32 + ni * 8 +
                t4 * 2) = make_float2(acc[mi][ni][2 * h], acc[mi][ni][2 * h + 1]);
    }
    __syncthreads();
    for (int idx = tid; idx < RP * (BN / 4); idx += NT) {
      const int r = idx / (BN / 4), cv = idx % (BN / 4);
      mg_store4(a, C, m0 + pass * RP + r, n0 + cv * 4,
                *reinterpret_cast<const float4*>(Ct + r * LDT + cv * 4), vec);
    }
  }
}

// ---- fp32: register-tiled FMA ---------------------------------------------

constexpr int MF_BM = 128, MF_BN = 64, MF_BK = 16, MF_NT = 256;

// the 128 x 16 (A) or 64 x 16 (B) tile's float4s, F per thread, k-major in
// shared memory [16][ROWS + 4]
template <bool KM, int ROWS>
struct MfTile {
  static constexpr int F = ROWS * MF_BK / 4 / MF_NT;
  float4 v[F];

  __device__ __forceinline__ void fetch(const float* g, long long ld,
                                        long long r0, long long rlim,
                                        long long k0, long long klim) {
#pragma unroll
    for (int f = 0; f < F; ++f) {
      const int c = threadIdx.x + f * MF_NT;
      long long r, k;
      if (KM) {  // float4 along the rows: [k][rows]
        k = k0 + c / (ROWS / 4);
        r = r0 + (c % (ROWS / 4)) * 4;
      } else {  // float4 along k: [rows][k]
        r = r0 + c / (MF_BK / 4);
        k = k0 + (c % (MF_BK / 4)) * 4;
      }
      v[f] = (r < rlim && k < klim)
                 ? *reinterpret_cast<const float4*>(g + (KM ? k * ld + r : r * ld + k))
                 : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }

  __device__ __forceinline__ void store(float* s) const {
#pragma unroll
    for (int f = 0; f < F; ++f) {
      const int c = threadIdx.x + f * MF_NT;
      if (KM) {
        const int kk = c / (ROWS / 4), rr = (c % (ROWS / 4)) * 4;
        *reinterpret_cast<float4*>(s + kk * (ROWS + 4) + rr) = v[f];
      } else {
        const int rr = c / (MF_BK / 4), kk = (c % (MF_BK / 4)) * 4;
        s[(kk + 0) * (ROWS + 4) + rr] = v[f].x;
        s[(kk + 1) * (ROWS + 4) + rr] = v[f].y;
        s[(kk + 2) * (ROWS + 4) + rr] = v[f].z;
        s[(kk + 3) * (ROWS + 4) + rr] = v[f].w;
      }
    }
  }
};

template <bool A_KM, bool B_KM>
__global__ void __launch_bounds__(MF_NT) mg_fma_kernel(const MGemmArgs a) {
  __shared__ __align__(16) float As[MF_BK * (MF_BM + 4)];
  __shared__ __align__(16) float Bs[MF_BK * (MF_BN + 4)];
  const int tid = threadIdx.x, tm = tid & 15, tn = tid >> 4;
  const long long m0 = (long long)blockIdx.x * MF_BM;
  const int n0 = blockIdx.y * MF_BN;
  const float* A = static_cast<const float*>(a.A);
  const float* B = static_cast<const float*>(a.B);
  const long long k_lo = (long long)blockIdx.z * a.kc;
  const long long k_hi = k_lo + a.kc < a.K ? k_lo + a.kc : a.K;
  const long long mlim = A_KM ? a.lda : a.M;
  const long long nlim = B_KM ? a.ldb : a.N;

  // thread (tm, tn): rows tm * 4 + i and 64 + tm * 4 + i, columns tn * 4 + j
  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  MfTile<A_KM, MF_BM> ta;
  MfTile<B_KM, MF_BN> tb;
  ta.fetch(A, a.lda, m0, mlim, k_lo, k_hi);
  tb.fetch(B, a.ldb, n0, nlim, k_lo, k_hi);
  for (long long k0 = k_lo; k0 < k_hi; k0 += MF_BK) {
    __syncthreads();  // the last tile is read out
    ta.store(As);
    tb.store(Bs);
    __syncthreads();
    if (k0 + MF_BK < k_hi) {  // the next tile's loads overlap this one's FMAs
      ta.fetch(A, a.lda, m0, mlim, k0 + MF_BK, k_hi);
      tb.fetch(B, a.ldb, n0, nlim, k0 + MF_BK, k_hi);
    }
#pragma unroll
    for (int k = 0; k < MF_BK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(As + k * (MF_BM + 4) + tm * 4);
      const float4 a1 =
          *reinterpret_cast<const float4*>(As + k * (MF_BM + 4) + 64 + tm * 4);
      const float4 b = *reinterpret_cast<const float4*>(Bs + k * (MF_BN + 4) + tn * 4);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }

  float* C = a.C + (long long)blockIdx.z * a.M * a.ldc;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const long long m = m0 + (i < 4 ? 0 : 64) + tm * 4 + (i & 3);
#pragma unroll
    for (int j = 0; j < 4; j += 2)
      mg_store(a, C, m, n0 + tn * 4 + j, acc[i][j], acc[i][j + 1]);
  }
}

// ---- the chunk partials' sum ----------------------------------------------

// out[n] = sum_s in[s, n] in a fixed order: eight lanes a column, lane j adding
// s = j, j + 8, ... in turn, then the eight sums in lane order. Coalesced
// over n, and eight times the parallelism of one thread a column where the
// partials are many and the columns few.
constexpr int RED_COLS = 32, RED_LANES = 8;

static __global__ void __launch_bounds__(RED_COLS * RED_LANES) reduce8_kernel(
    const float* in, float* out, long long S, long long N) {
  __shared__ float part[RED_LANES][RED_COLS];
  const int c = threadIdx.x % RED_COLS, j = threadIdx.x / RED_COLS;
  const long long n = (long long)blockIdx.x * RED_COLS + c;
  float acc = 0.f;
  if (n < N)
    for (long long s = j; s < S; s += RED_LANES) acc += in[s * N + n];
  part[j][c] = acc;
  __syncthreads();
  if (j == 0 && n < N) {
    float v = 0.f;
#pragma unroll
    for (int l = 0; l < RED_LANES; ++l) v += part[l][c];
    out[n] = v;
  }
}

// a few partials a column (S < 32) go to bwd.cuh's one thread a column
inline void launch_reduce8(const float* in, float* out, long long S, long long N,
                           cudaStream_t st) {
  if (S < 32) {
    launch_reduce(in, out, 1, S, N, st);
    return;
  }
  reduce8_kernel<<<(unsigned)((N + RED_COLS - 1) / RED_COLS),
                   RED_COLS * RED_LANES, 0, st>>>(in, out, S, N);
}

// ---- launchers --------------------------------------------------------------

template <typename T, bool A_KM, bool B_KM>
inline cudaError_t mg_launch(const MGemmArgs& a, long long chunks,
                             cudaStream_t st) {
  if constexpr (std::is_same<T, float>::value) {
    const dim3 grid((unsigned)((a.M + MF_BM - 1) / MF_BM),
                    (unsigned)((a.N + MF_BN - 1) / MF_BN), (unsigned)chunks);
    mg_fma_kernel<A_KM, B_KM><<<grid, MF_NT, 0, st>>>(a);
    return cudaGetLastError();
  } else {
    auto run = [&](auto kernel, int bn, size_t smem) {
      cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return err;
      const dim3 grid((unsigned)((a.M + MG_BM - 1) / MG_BM),
                      (unsigned)((a.N + bn - 1) / bn), (unsigned)chunks);
      kernel<<<grid, bn * 2, smem, st>>>(a);
      return cudaGetLastError();
    };
    if (a.N <= 64)
      return run(mg_mma_kernel<64, A_KM, B_KM>, 64,
                 mg_smem_bytes<64, A_KM, B_KM>());
    return run(mg_mma_kernel<128, A_KM, B_KM>, 128,
               mg_smem_bytes<128, A_KM, B_KM>());
  }
}

// C [M, N] (ld ldc) = A [M, K] B[N, K]^T (+ bias, x aux); K a multiple of 32
template <typename T>
inline cudaError_t gemm_nt(const void* A, long long lda, const void* B,
                           long long ldb, float* C, long long ldc, long long M,
                           int N, long long K, const float* bias,
                           const float* aux, long long ldaux, cudaStream_t st) {
  MGemmArgs a{A, lda, B, ldb, C, ldc, M, N, K, K, bias, aux, ldaux};
  return mg_launch<T, false, false>(a, 1, st);
}

// out [Mw, N] = A^T B over ``rows``: A [rows, lda] (Mw <= lda), B [rows, ldb]
// (N <= ldb); chunk partials [chunks, Mw, N] in ``part``, then the
// fixed-order reduction
template <typename T>
inline cudaError_t weight_grad_tn(const void* A, long long lda, const void* B,
                                  long long ldb, long long rows, int Mw, int N,
                                  float* part, float* out, cudaStream_t st) {
  MGemmArgs a{A, lda, B, ldb, part, N, Mw, N, rows, chunk_rows(rows),
              nullptr, nullptr, 0};
  const long long S = chunk_count(rows);
  cudaError_t err = mg_launch<T, true, true>(a, S, st);
  if (err != cudaSuccess) return err;
  launch_reduce8(part, out, S, (long long)Mw * N, st);
  return cudaGetLastError();
}

}  // namespace fairm
