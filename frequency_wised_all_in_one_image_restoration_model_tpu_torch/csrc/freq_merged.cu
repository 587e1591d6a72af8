// K5: one whole frequency-MSA LeWin block in one launch.
//
// Replaces the Pallas kernel _merged_freq_kernel (frequency_wised_all_in_one_
// image_restoration_model_tpu/ops/pallas/lewin_block.py, reached through
// fused_block_freq_merged):
//   y1  = proj_A(per-band window_attention(LN1(roll(x))))     (intra)
//   u   = x + dps1 * unroll(proj_B(grouped_attention(y1)))    (inter)
//   out = u + dps2 * LeFF(LN2(u))
// on the TRUE-layout band-major batch [L*B, H, W, C]: per-band bias tables
// [L, h, n, n] for the intra half, the grouped bias [h, L*n, L*n] with the
// band mask folded in (or the per-pair tables it is made from) for the
// inter half, the SW-MSA mask in both, dps by the folded sample l*B + b;
// y1 and u rounded to the model dtype, as the K1 -> K3 -> K2 chain stores
// them.
//
// What bounds it on the H100: by the card's peaks the products (the two
// attention halves' q / k / v, logits, P V and projections, fc1, fc2); in
// practice the per-window latency of the attention halves (barriers between
// 32-column weight steps, 64- and 192-token cores on few rows) and the
// LeFF's work on each hidden element on the CUDA cores (two GELUs, the nine
// taps), as in K1, K3 and K2.
//
// Two forms, chosen by the caller (lewin_block.py::freq_merged_path):
// - band groups (bf16, L = 3 bands of 8 x 8 windows, C a multiple of 4,
//   kpad(C) <= 128, head dims <= 32: the encoder's res 128 / 64 / 32
//   stages): one cooperative launch of CTAs of twelve warps, built from the
//   chain's own fused bodies, with one grid barrier:
//    A. a CTA takes one window position in all three bands at a time, the
//       192-row group of freq_group.cuh: it gathers the group's rows of x
//       through the band regroup with the roll folded in (RowMap mode 2,
//       shift), LayerNorms them (attn_fused.cuh's ln_rows, K1's), runs the
//       intra half (K1's arithmetic: q / k / v a head from a weight ring
//       that serves the three bands' 192 rows at once, each band's window
//       core on four warps, the projection), keeps y1 in shared memory in
//       place of the LN1 rows, runs the inter half on it (K3's fused
//       arithmetic, the bias from the per-pair tables) and writes u to the
//       true pixels;
//    B. after the grid barrier (the LeFF's 3 x 3 conv reads u of
//       neighbouring windows), the LeFF on 8 x 8 pixel tiles with their
//       halo (ffn_fused.cuh, K2's tile): three tiles at a time, four warps
//       each with a named barrier of its own, so that one tile's barriers
//       hide behind the others' work.
//   No y1 (unless the caller asks for it, for the backward), q / k / v,
//   attention or hidden row reaches device memory: the scratch holds u.
//   Each stage runs the same device code as the chain, so the output is
//   the chain's bit for bit.
// - phases (fp32, the deep stages, other widths): merged.cuh's persistent
//   kernel, phase by phase over the whole batch with a grid barrier
//   between phases, the intermediates in a scratch buffer; the band
//   regroup and its inverse are row maps (a gather before the inter qkv
//   product, a scatter in the last projection's epilogue), and the cyclic
//   shift rides in them.

#include "ffn_fused.cuh"
#include "freq_group.cuh"
#include "merged.cuh"

using namespace fairm;

namespace {

// LeFF tiles at a time, four warps each (two warps a tile, six tiles, were
// no faster at C = 28 on an H100: PERF.md section 6)
constexpr int FG_TILES = FI_NT / 128;

struct FreqGroupArgs {
  GroupHalf intra;      // LN1, the intra half; out: y1 (rolled layout) or null
  GroupHalf inter;      // the inter half, res = x, out = u (true layout)
  const bf16_t* x;      // [L*B, H, W, C], rows through map
  const float* dps1;    // [L*B], or null
  RowMap map;           // mode 2 with the shift: the group's true pixels
  long long hw, groups, images;
  int nW, tiles;        // windows and 8 x 8 LeFF tiles of an image
  FfnArgs ffn;          // x = u, out
  long long* stamps;    // null, or the device clock at the start, after the
                        // band groups and after the LeFF
};

template <int KP>
__global__ void __launch_bounds__(FI_NT, 1)
    freq_group_kernel(const __grid_constant__ FreqGroupArgs p) {
  using S = FfnShape<KP, 1>;
  extern __shared__ __align__(16) unsigned char smem[];
  cg::grid_group grid = cg::this_grid();
  end_phase(grid, p.stamps, 0);

  group_init(p.intra.C, smem);
  for (long long g = blockIdx.x; g < p.groups; g += gridDim.x) {
    __syncthreads();  // the last group's readers of the rows and the ring
    group_gather(p.x, p.map, g, p.intra.C, p.dps1, p.hw, smem);
    const int wi = (int)(g % p.nW);
    group_half<true>(p.intra, g, wi, smem);
    group_half<false>(p.inter, g, wi, smem);
  }
  end_phase(grid, p.stamps, 1);

  const int part = threadIdx.x / 128;
  for (long long t = (long long)blockIdx.x * FG_TILES + part;
       t < p.images * p.tiles; t += (long long)gridDim.x * FG_TILES)
    ffn_fused_tile<S, 128>(p.ffn, (int)(t % p.tiles), t / p.tiles,
                           smem + part * S::BYTES, threadIdx.x % 128, [part] {
                             asm volatile("bar.sync %0, 128;\n" ::"r"(part + 1));
                           });
  end_phase(grid, p.stamps, 2);
}

template <int KP>
cudaError_t freq_group_launch(const FreqGroupArgs& p, cudaStream_t st) {
  auto kernel = freq_group_kernel<KP>;
  const size_t smem =
      max_sz(group_layout(p.intra.C).bytes, FG_TILES * FfnShape<KP, 1>::BYTES);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  // every CTA must be resident for the grid barrier
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, FI_NT,
                                                      smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorLaunchOutOfResources;
  long long units = (p.images * p.tiles + FG_TILES - 1) / FG_TILES;
  if (p.groups > units) units = p.groups;
  long long blocks = (long long)per_sm * sms;
  if (blocks > units) blocks = units;
  FreqGroupArgs args = p;
  void* params[] = {&args};
  return cudaLaunchCooperativeKernel((void*)kernel, dim3((unsigned)blocks),
                                     dim3(FI_NT), params, smem, st);
}

cudaError_t freq_group(const void* x, const float* ln1s, const float* ln1b,
                       const AttnWeights& a1, const AttnWeights& a2,
                       const float* pairs, const float* mask,
                       const float* dps1, const float* ln2s, const float* ln2b,
                       const void* w1, const float* b1, const float* wd,
                       const float* bd, const void* w2, const float* b2,
                       const float* dps2, void* u, void* y1, void* out,
                       long long* stamps, int LB, int H, int W, int C, int h,
                       int win, int shift, int L, int Hd, float eps,
                       cudaStream_t st) {
  const int kp = ffn_fused_kp(C, 1);
  if (!group_ok(C, h, win, L) || LB % L || !pairs || kp > 128)
    return cudaErrorInvalidValue;
  const int imgs = LB / L;
  FreqGroupArgs p{};
  p.intra.wqkv = static_cast<const bf16_t*>(a1.wqkv);
  p.intra.bqkv = a1.bqkv;
  p.intra.wp = static_cast<const bf16_t*>(a1.wp);
  p.intra.bp = a1.bp;
  p.intra.tables = a1.bias;
  p.intra.mask = mask;
  p.intra.lns = ln1s;
  p.intra.lnb = ln1b;
  p.intra.eps = eps;
  p.intra.out = static_cast<bf16_t*>(y1);
  p.intra.ymap = RowMap{2, H, W, win, imgs, L, 0};
  p.intra.C = C;
  p.intra.h = h;
  p.inter.wqkv = static_cast<const bf16_t*>(a2.wqkv);
  p.inter.bqkv = a2.bqkv;
  p.inter.wp = static_cast<const bf16_t*>(a2.wp);
  p.inter.bp = a2.bp;
  p.inter.tables = pairs;
  p.inter.mask = mask;
  p.inter.res = static_cast<const bf16_t*>(x);
  p.inter.out = static_cast<bf16_t*>(u);
  p.inter.C = C;
  p.inter.h = h;
  p.x = static_cast<const bf16_t*>(x);
  p.dps1 = dps1;
  p.map = RowMap{2, H, W, win, imgs, L, shift};
  p.hw = (long long)H * W;
  p.nW = (H / win) * (W / win);
  p.groups = (long long)imgs * p.nW;
  p.images = LB;
  p.tiles = ((H + FF_T - 1) / FF_T) * ((W + FF_T - 1) / FF_T);
  p.ffn = FfnArgs{static_cast<const bf16_t*>(u), ln2s, ln2b,
                  static_cast<const bf16_t*>(w1), b1, wd, bd,
                  static_cast<const bf16_t*>(w2), b2, dps2,
                  static_cast<bf16_t*>(out), H, W, C, Hd, kpad(C), kpad(Hd),
                  eps};
  p.stamps = stamps;
  return kp == 32   ? freq_group_launch<32>(p, st)
         : kp == 64 ? freq_group_launch<64>(p, st)
                    : freq_group_launch<128>(p, st);
}

}  // namespace

extern "C" int fairm_freq_merged(
    const void* x, const void* ln1s, const void* ln1b, const void* wqkvA,
    const void* bqkvA, const void* wpA, const void* bpA, const void* biasA,
    const void* wqkvB, const void* bqkvB, const void* wpB, const void* bpB,
    const void* biasB, const void* pairsB, const void* mask, const void* dps1,
    const void* ln2s, const void* ln2b, const void* w1, const void* b1,
    const void* wd, const void* bd, const void* w2, const void* b2,
    const void* dps2, void* scratch, void* y1, void* out, void* stamps,
    long long scratch_elems, int LB, int H, int W, int C, int h, int win,
    int shift, int L, int Hd, int is_bf16, int group, float eps,
    void* stream) {
  const AttnWeights a1{wqkvA, (const float*)bqkvA, wpA, (const float*)bpA,
                       (const float*)biasA};
  const AttnWeights a2{wqkvB, (const float*)bqkvB, wpB, (const float*)bpB,
                       (const float*)biasB};
  const long long M = (long long)LB * H * W;
  cudaError_t err;
  if (group) {  // the caller's choice: a shape the form cannot take fails
    err = is_bf16 && scratch_elems >= M * C
              ? freq_group(x, (const float*)ln1s, (const float*)ln1b, a1, a2,
                           (const float*)pairsB, (const float*)mask,
                           (const float*)dps1, (const float*)ln2s,
                           (const float*)ln2b, w1, (const float*)b1,
                           (const float*)wd, (const float*)bd, w2,
                           (const float*)b2, (const float*)dps2, scratch, y1,
                           out, (long long*)stamps, LB, H, W, C, h, win, shift,
                           L, Hd, eps, (cudaStream_t)stream)
              : cudaErrorInvalidValue;
  } else {
    if (L < 1 || LB % L || y1 ||
        scratch_elems < M * merged_scratch_cols(C, Hd, true, false,
                                                is_bf16 ? 2 : 4))
      return (int)cudaErrorInvalidValue;
    MergedArgs p{};
    p.x = x;
    p.ln1s = (const float*)ln1s;
    p.ln1b = (const float*)ln1b;
    p.a1 = a1;
    p.a2 = a2;
    p.mask = (const float*)mask;
    p.lam = nullptr;
    p.dps1 = (const float*)dps1;
    p.ln2s = (const float*)ln2s;
    p.ln2b = (const float*)ln2b;
    p.w1 = w1;
    p.b1 = (const float*)b1;
    p.wd = (const float*)wd;
    p.bd = (const float*)bd;
    p.w2 = w2;
    p.b2 = (const float*)b2;
    p.dps2 = (const float*)dps2;
    p.scratch = scratch;
    p.out = out;
    p.stamps = (long long*)stamps;
    p.B = LB;
    p.H = H;
    p.W = W;
    p.C = C;
    p.h = h;
    p.win = win;
    p.shift = shift;
    p.L = L;
    p.Hd = Hd;
    p.eps = eps;
    err = is_bf16 ? launch_merged<bf16_t, true>(p, (cudaStream_t)stream)
                  : launch_merged<float, true>(p, (cudaStream_t)stream);
  }
  if (err == cudaSuccess) err = cudaGetLastError();
  return (int)err;
}
