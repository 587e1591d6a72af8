// The depthwise 3x3 conv + bd + GELU pass of the LeFF (K2, K13, and the
// merged blocks K4 / K5), over the hidden rows after GELU(fc1): zero padding
// at the image border. The hidden rows come in fp32 (JAX keeps them in fp32
// from fc1 through the conv) and leave in the model dtype, fc2's operand,
// rounded once.

#pragma once

#include "gemm.cuh"

namespace fairm {

constexpr int DW_NT = 128;
constexpr int DW_SEG = 32;  // pixels of a row one item walks

// V consecutive channels moved as one 16-byte (or element-sized) access
template <typename T, int V>
struct alignas(sizeof(T) * V) Vec {
  T v[V];
};

// the 16-byte form of the input rows when they allow it
template <typename TI>
__host__ __device__ inline int dwconv_vec(int Hd) {
  constexpr int V = 16 / sizeof(TI);
  return Hd % V == 0 ? V : 1;
}

__host__ __device__ inline int dwconv_segs(int W) {
  return (W + DW_SEG - 1) / DW_SEG;
}

// items of work over ``rows`` = B * H image rows
__host__ __device__ inline long long dwconv_items(long long rows, int W, int ldo,
                                                  int v) {
  return rows * dwconv_segs(W) * (ldo / v);
}

// hid [B*H*W, Hd] (TI) -> out [B*H*W, ldo] (TO; ldo = kpad(Hd), pad columns
// zero). One item of work is V channels (one 16-byte access of the input
// when Hd % V == 0) over
// a run of up to DW_SEG pixels of one image row: the thread keeps the 9 x V
// taps and the 3 x 3 window of inputs in registers and walks the run, three
// loads a pixel, issued a pixel ahead. Items are numbered channel vector
// first, so neighbouring lanes read neighbouring channels of one pixel and
// no lane idles whatever Hd is; a thread takes items first, first + stride,
// ...
template <typename TI, typename TO, int V>
__device__ __forceinline__ void dwconv_gelu_items(const TI* in, const float* wd,
                                                  const float* bd, TO* out,
                                                  long long first,
                                                  long long stride,
                                                  long long rows, int H, int W,
                                                  int Hd, int ldo) {
  const int nvec = ldo / V, nseg = dwconv_segs(W);
  const long long total = rows * nseg * nvec;
  for (long long item = first; item < total; item += stride) {
    const int cv = (int)(item % nvec);
    const long long t = item / nvec;
    const int sg = (int)(t % nseg);
    const long long rb = t / nseg;
    const int y = (int)(rb % H);
    const long long row0 = rb * W;  // pixel (b, y, 0)
    const int x0 = sg * DW_SEG;
    const int x1 = min(W, x0 + DW_SEG);
    const int c0 = cv * V;
    Vec<TO, V> res;
    if (c0 >= Hd) {
#pragma unroll
      for (int i = 0; i < V; ++i) res.v[i] = from_f<TO>(0.f);
      for (int x = x0; x < x1; ++x)
        reinterpret_cast<Vec<TO, V>*>(out + (row0 + x) * ldo)[cv] = res;
      continue;
    }
    float w[9][V], b[V];
#pragma unroll
    for (int t9 = 0; t9 < 9; ++t9)
#pragma unroll
      for (int i = 0; i < V; ++i) w[t9][i] = wd[t9 * Hd + c0 + i];
#pragma unroll
    for (int i = 0; i < V; ++i) b[i] = bd[c0 + i];
    // the 3 x 3 window slides along the run: three columns of it in
    // registers, the column after next loaded a pixel ahead; a tap outside
    // the image adds nothing (the order of the sums is the taps' order)
    auto column = [&](int xx, Vec<TI, V>* col) {
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
        const int yy = y + dy - 1;
        if (xx >= 0 && xx < W && yy >= 0 && yy < H)
          col[dy] = *reinterpret_cast<const Vec<TI, V>*>(
              in + (row0 + (long long)(dy - 1) * W + xx) * Hd + c0);
      }
    };
    Vec<TI, V> win[4][3];  // [column x - 1 + dx][dy]; [3]: the next one
    column(x0 - 1, win[0]);
    column(x0, win[1]);
    column(x0 + 1, win[2]);
    for (int x = x0; x < x1; ++x) {
      column(x + 2, win[3]);
      float acc[V];
#pragma unroll
      for (int i = 0; i < V; ++i) acc[i] = 0.f;
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
        const int yy = y + dy - 1;
        if (yy < 0 || yy >= H) continue;
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          const int xx = x + dx - 1;
          if (xx < 0 || xx >= W) continue;
#pragma unroll
          for (int i = 0; i < V; ++i)
            acc[i] = fmaf(to_f(win[dx][dy].v[i]), w[dy * 3 + dx][i], acc[i]);
        }
      }
#pragma unroll
      for (int i = 0; i < V; ++i) res.v[i] = from_f<TO>(gelu_tanh(acc[i] + b[i]));
      reinterpret_cast<Vec<TO, V>*>(out + (row0 + x) * ldo)[cv] = res;
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
        win[0][dy] = win[1][dy];
        win[1][dy] = win[2][dy];
        win[2][dy] = win[3][dy];
      }
    }
  }
}

template <typename TI, typename TO>
__device__ __forceinline__ void dwconv_gelu_any(const TI* in, const float* wd,
                                                const float* bd, TO* out,
                                                long long first,
                                                long long stride,
                                                long long rows, int H, int W,
                                                int Hd, int ldo) {
  constexpr int V = 16 / sizeof(TI);
  if (dwconv_vec<TI>(Hd) == V)
    dwconv_gelu_items<TI, TO, V>(in, wd, bd, out, first, stride, rows, H, W,
                                 Hd, ldo);
  else
    dwconv_gelu_items<TI, TO, 1>(in, wd, bd, out, first, stride, rows, H, W,
                                 Hd, ldo);
}

template <typename TI, typename TO>
__global__ void __launch_bounds__(DW_NT, 3) dwconv_gelu_kernel(
    const TI* in, const float* wd, const float* bd, TO* out, long long rows,
    int H, int W, int Hd, int ldo) {
  dwconv_gelu_any<TI, TO>(in, wd, bd, out,
                          (long long)blockIdx.x * DW_NT + threadIdx.x,
                          (long long)gridDim.x * DW_NT, rows, H, W, Hd, ldo);
}

// the hidden rows in fp32, the conv's output in T
template <typename T>
inline void launch_dwconv(const float* in, const float* wd, const float* bd,
                          void* out, long long rows, int H, int W, int Hd,
                          cudaStream_t st) {
  const int ldo = kpad(Hd);
  const long long items = dwconv_items(rows, W, ldo, dwconv_vec<float>(Hd));
  dwconv_gelu_kernel<float, T>
      <<<(unsigned)((items + DW_NT - 1) / DW_NT), DW_NT, 0, st>>>(
          in, wd, bd, static_cast<T*>(out), rows, H, W, Hd, ldo);
}

}  // namespace fairm
