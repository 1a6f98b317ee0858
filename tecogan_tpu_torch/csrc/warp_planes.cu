// Bilinear backward warp of channel-major planes (K1), for Hopper (sm_90a).
//
// Replaces the TPU kernel tecogan_tpu/ops/warp_pallas.py::_warp_planes
// (kernel body _warp_kernel). It computes the same function: output pixel
// (b, ch, i, j) samples plane (b, ch) at
//     (clip(i + fy, 0, H-1), clip(j + fx, 0, W-1))
// with the coordinate clamped first and floored after (grid_sample border
// padding, align_corners=True). Coordinates, tap weights and the
// accumulation are fp32; the result is written once in the planes' dtype.
//
// Band mode (the TPU kernel's tiles_per_band, used by row-folded
// multi-stream inference): the H rows are H / band streams of band rows,
// the first band_valid of each valid. Row i samples at
// clip(i mod band + fy, 0, band_valid-1) within its own band, so no stream
// reads its neighbour's rows. band = 0 is the plain mode, bit for bit.
//
// Bound: bytes. At bf16 each pixel moves 2 flow values, 3 plane values in
// (each read once) and 3 out: 10.98 MB for the (1, 3, 536, 1280) frame
// (3.28 us at 3.35 TB/s) and 44.6 MB for 4 folded streams (13.3 us).
//
// Design. The TPU kernel enumerates displacement ranges over 32x128 tiles
// with slab rolls because the TPU has no per-lane gather; Hopper gathers
// natively. The first port ran one thread per pixel; its SASS shows why it
// was slow: ptxas kept the hoisted 64-bit tap pointers live and issued the
// tap loads a pair at a time, each pair waiting on its use, a chain of
// dependent L2 round trips per channel, three channels in turn. Now:
// - the grid is (column tiles, row tiles, images) of the tiles in
//   warp_common.cuh: a warp takes 32 neighbouring columns of one row, each
//   lane kTileSteps pixels 32 columns apart, decoded from blockIdx and
//   threadIdx with no division (band mode: one 32-bit remainder per thread
//   for its block's first row, then a subtraction, so a block may straddle
//   two bands);
// - each flow load and store of a warp covers 32 neighbouring elements, and
//   its tap loads fall on the cache lines around its 32 sample points;
// - the channel count of every inference path (3) is a template
//   parameter, so a thread issues all 12 x kTileSteps tap loads before it
//   uses one (other counts loop over the channels);
// - tap offsets are 32-bit within an image (the wrapper checks
//   c*H*W < 2^31) and flow offsets 32-bit within a row, from 64-bit row
//   bases set once per thread; a column past W reads column W-1 and stores
//   nothing, so no branch guards a load.
// What is left (PERF.md, section 6): with a zero flow, whose taps are as
// coalesced as a copy, the kernel still takes about twice a streaming
// add's time over the same output: the per-pixel work of twelve scalar
// gathers with fp32 arithmetic that rounds like the plain version, or the
// flow-then-taps chain of two L2 round trips per warp (not yet told
// apart). No shared memory, and no size gate: the second taps
// min(y0+1, H-1) and min(x0+1, W-1) stay in bounds.
//
// The arithmetic (warp_common.cuh) rounds exactly like the plain PyTorch
// version (ops/warp_cuda.py::warp_planes_reference).

#include "warp_common.cuh"

namespace {

using namespace tecogan;

// kTileSteps pixels of one row in C channels (C = 0: c channels, one at a
// time); each pixel's four taps lie at o00, o00 + dx, o00 + dy and
// o00 + dy + dx of its channel plane.
template <typename TI, typename TF, int C>
__global__ void __launch_bounds__(32 * kTileRows)
    warp_planes_kernel(const TI* __restrict__ planes,
                       const TF* __restrict__ flow, TI* __restrict__ out,
                       int c, int H, int W, int band, int band_valid,
                       Strides4 fs) {
  const int i = blockIdx.y * kTileRows + threadIdx.y;
  if (i >= H) return;
  const int b = blockIdx.z;
  // band mode: row i lies in the band that starts at row i - row, and
  // samples that band's first band_valid rows only
  int row = i, rows = H;
  if (band) {
    row = (int)((unsigned)(blockIdx.y * kTileRows) % (unsigned)band) +
          threadIdx.y;
    while (row >= band) row -= band;
    rows = band_valid;
  }
  const int plane = H * W;
  const int64_t image = (int64_t)b * c * plane;
  const TI* src = planes + image;
  TI* dst = out + image + i * W;
  // the flow row in 64 bits once; offsets within it are 32-bit
  const TF* f = flow + b * fs.s0 + i * fs.s1;
  const int fj = (int)fs.s2, fk = (int)fs.s3;
  const int j0 = blockIdx.x * (32 * kTileSteps) + threadIdx.x;

  // a column past W reads column W-1's flow, gets an in-bounds stencil and
  // stores nothing (no branch around the loads)
  float fx[kTileSteps], fy[kTileSteps];
#pragma unroll
  for (int k = 0; k < kTileSteps; ++k) {
    const int o = min(j0 + 32 * k, W - 1) * fj;
    fx[k] = load_f32(f + o);
    fy[k] = load_f32(f + (o + fk));
  }
  int o00[kTileSteps], dx[kTileSteps], dy[kTileSteps];
  float w00[kTileSteps], w01[kTileSteps], w10[kTileSteps], w11[kTileSteps];
#pragma unroll
  for (int k = 0; k < kTileSteps; ++k) {
    const Taps t = taps_of(fx[k], fy[k], row, j0 + 32 * k, rows, W);
    const float wy0 = __fsub_rn(1.0f, t.wy);
    const float wx0 = __fsub_rn(1.0f, t.wx);
    w00[k] = __fmul_rn(wx0, wy0);
    w01[k] = __fmul_rn(t.wx, wy0);
    w10[k] = __fmul_rn(wx0, t.wy);
    w11[k] = __fmul_rn(t.wx, t.wy);
    o00[k] = (i - row + t.y0) * W + t.x0;
    dx[k] = t.x1 - t.x0;
    dy[k] = (t.y1 - t.y0) * W;
  }
  // top + bottom, stored where the column exists
  auto finish = [&](TI* d, int k, const float* v) {
    const float top = __fadd_rn(__fmul_rn(w00[k], v[0]),
                                __fmul_rn(w01[k], v[1]));
    const float bot = __fadd_rn(__fmul_rn(w10[k], v[2]),
                                __fmul_rn(w11[k], v[3]));
    const int j = j0 + 32 * k;
    if (j < W) store_f32(d + j, __fadd_rn(top, bot));
  };
  // G channels at a time, every tap load of a group in flight before the
  // first is used: all C of them when the count is fixed, else one.
  // Offsets within the image are 32-bit (c*H*W < 2^31).
  constexpr int G = C > 0 ? C : 1;
  for (int ch0 = 0; ch0 < (C > 0 ? C : c); ch0 += G) {
    float v[G][kTileSteps][4];
#pragma unroll
    for (int g = 0; g < G; ++g) {
#pragma unroll
      for (int k = 0; k < kTileSteps; ++k) {
        const int o = (ch0 + g) * plane + o00[k];
        v[g][k][0] = load_f32(src + o);
        v[g][k][1] = load_f32(src + (o + dx[k]));
        v[g][k][2] = load_f32(src + (o + dy[k]));
        v[g][k][3] = load_f32(src + (o + dy[k] + dx[k]));
      }
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
#pragma unroll
      for (int k = 0; k < kTileSteps; ++k) {
        finish(dst + (ch0 + g) * plane, k, v[g][k]);
      }
    }
  }
}

template <typename TI, typename TF, int C>
int launch_kernel(const int64_t* a) {
  const int n = (int)a[3], c = (int)a[4], H = (int)a[5], W = (int)a[6];
  constexpr int kTileW = 32 * kTileSteps;
  const dim3 grid((W + kTileW - 1) / kTileW, (H + kTileRows - 1) / kTileRows,
                  n);
  warp_planes_kernel<TI, TF, C><<<grid, dim3(32, kTileRows), 0,
                                  arg_ptr<CUstream_st>(a, 13)>>>(
      arg_ptr<const TI>(a, 0), arg_ptr<const TF>(a, 1), arg_ptr<TI>(a, 2), c,
      H, W, (int)a[7], (int)a[8], strides_from(a + 9));
  return (int)cudaGetLastError();
}

// RGB planes (every inference path) take the kernel with the channels
// unrolled; any other count loops over them
template <typename TI, typename TF>
int launch(const int64_t* a) {
  if (a[3] * a[4] * a[5] * a[6] == 0) return 0;
  return a[4] == 3 ? launch_kernel<TI, TF, 3>(a) : launch_kernel<TI, TF, 0>(a);
}

}  // namespace

// Plain C entry points, one per (planes dtype, flow dtype), each taking
// one int64 array: (planes, flow, out, n, c, H, W, band, band_valid, the
// flow's element strides in (n, H, W, 2) order, stream). Flow strides are
// in elements, so an (n, H, W, 2) tensor and the (n, H, W, 2) view of an
// NCHW (n, 2, H, W) tensor both work without a copy. Planes and out are
// contiguous (n, c, H, W). band = 0 warps each plane as one image; band > 0
// (H a multiple of band) as H / band independent bands of band rows, each
// clamped to its first band_valid rows. The wrapper checks the grid limits
// and the 32-bit offsets. Returns cudaGetLastError() after the launch.
#define TECOGAN_WARP_ENTRY(NAME, TI, TF) \
  extern "C" int NAME(const int64_t* args) { return launch<TI, TF>(args); }

TECOGAN_WARP_ENTRY(tecogan_warp_planes_f32_f32, float, float)
TECOGAN_WARP_ENTRY(tecogan_warp_planes_f32_bf16, float, __nv_bfloat16)
TECOGAN_WARP_ENTRY(tecogan_warp_planes_bf16_f32, __nv_bfloat16, float)
TECOGAN_WARP_ENTRY(tecogan_warp_planes_bf16_bf16, __nv_bfloat16, __nv_bfloat16)
