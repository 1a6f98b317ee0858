// The bilinear backward warps K1 (channel-major planes) and K2 (an image
// addressed by element strides), for Hopper (sm_90a).
//
// K1 replaces the TPU kernel tecogan_tpu/ops/warp_pallas.py::_warp_planes
// (kernel body _warp_kernel), the inference warp; K2 replaces
// ::backward_warp_rgb_flat (kernel body _warp_kernel_rgb), the warp on the
// channel-interleaved NHWC layout and the forward of every training warp.
// Both compute the same function: output pixel (b, ch, i, j) samples image
// (b, ch) at
//     (clip(i + fy, 0, H-1), clip(j + fx, 0, W-1))
// with the coordinate clamped first and floored after (grid_sample border
// padding, align_corners=True). Coordinates, tap weights and the
// accumulation are fp32; the result is written once in the image's dtype.
//
// K1 reads and writes contiguous (n, c, H, W) planes. K2 reads the image
// and writes the output through (n, c, H, W) element strides, so an NCHW
// tensor (the HR carry) and a channels_last one (the warping loss's view of
// NHWC frames, the TPU kernel's own layout) both work without a copy. One
// kernel body serves both (the template flag kStrided); K1's dense strides
// are compile-time constants there, so its code is what it was.
//
// Band mode (the TPU kernel's tiles_per_band, used by row-folded
// multi-stream inference; K1 only): the H rows are H / band streams of band
// rows, the first band_valid of each valid. Row i samples at
// clip(i mod band + fy, 0, band_valid-1) within its own band, so no stream
// reads its neighbour's rows. band = 0 is the plain mode, bit for bit.
//
// Window mode (K1 only; row-sharded inference, the JAX package's
// tecogan_tpu/ops/warp.py::backward_warp_window, which is plain jnp there):
// the planes are a slab of hx rows holding global rows [x_y0, x_y0 + hx)
// of an h_glob-row image, and the output's ho rows (the flow's) are global
// rows [out_y0, out_y0 + ho). Row i samples at
// clip(out_y0 + i + fy, 0, h_glob-1): coordinate, floor and weights in
// global rows, as the plain mode computes them, and only the integer tap
// rows are translated by -x_y0 into the slab and clipped to it (translating
// the float first would perturb its fraction by an ulp). It is the template
// flag kWindow of the same body, so the plain and band modes compile as
// before; out_y0 = x_y0 = 0, h_glob = hx = ho is the plain mode bit for bit.
// Its bytes are the plain mode's for the output's rows (the slab's extra
// rows are not all read).
//
// Zero-padding mode (BasicVSR++'s flow_warp: grid_sample with
// padding_mode="zeros", align_corners=True): pixel (i, j) samples at
// (i + fy, j + fx) with no clamp, and a tap outside the image reads 0
// (warp_common.cuh, zero_taps). It is the template flag kZero of the same
// body on K2's strides, so a channels_last feature map needs no copy; the
// other instantiations compile as before. It replaces no TPU kernel: the
// JAX package has no BasicVSR++.
//
// Bound: bytes. At bf16 each pixel moves 2 flow values, 3 image values in
// (each read once) and 3 out: 10.98 MB for K1's (1, 3, 536, 1280) frame
// (3.28 us at 3.35 TB/s), 44.6 MB for 4 folded streams (13.3 us), and
// 0.52 MB for K2's training warp (2, 3, 128, 128) (0.157 us), where the
// launch and one chain of dependent loads are the floor.
//
// Design. The TPU kernels enumerate displacement ranges over 32x128 tiles
// with slab rolls (K2 with the flow repeated on c lanes a pixel) because
// the TPU has no per-lane gather; Hopper gathers natively. The first ports
// ran one thread per pixel over a runtime channel loop, with a 64-bit
// division decode; their SASS showed ptxas keeping the 64-bit tap pointers
// live and issuing the tap loads a pair at a time, each pair waiting on its
// use, a chain of dependent L2 round trips per channel. Now:
// - the grid is (column tiles, row tiles, images) of the tiles in
//   warp_common.cuh: a warp takes 32 neighbouring columns of one row, each
//   lane kTileSteps pixels 32 columns apart, decoded from blockIdx and
//   threadIdx with no division (band mode: one 32-bit remainder per thread
//   for its block's first row, then a subtraction, so a block may straddle
//   two bands);
// - each flow load and output store of a warp covers 32 neighbouring
//   pixels, and its tap loads fall on the cache lines around its 32 sample
//   points (channels_last: a tap's three channels are neighbours, issued
//   together);
// - the channel count of every path (3) is a template parameter, so a
//   thread issues all 12 x kTileSteps tap loads before it uses one (other
//   counts loop over the channels);
// - tap and output offsets are 32-bit within an image (the wrappers check
//   the largest) from 64-bit image bases, and flow offsets 32-bit within a
//   row from a 64-bit row base; a column past W reads column W-1 and stores
//   nothing, so no branch guards a load.
// What is left (PERF.md, section 6): with a zero flow, whose taps are as
// coalesced as a copy, K1 still takes about twice a streaming add's time
// over the same output: the per-pixel work of twelve scalar gathers with
// fp32 arithmetic that rounds like the plain version, or the flow-then-taps
// chain of two L2 round trips per warp (not yet told apart). No shared
// memory, and no size gate: the second taps min(y0+1, H-1) and
// min(x0+1, W-1) stay in bounds.
//
// The arithmetic (warp_common.cuh) rounds exactly like the plain PyTorch
// version (ops/warp_cuda.py::warp_planes_reference).

#include "warp_common.cuh"

namespace {

using namespace tecogan;

// kTileSteps pixels of one row in C channels (C = 0: c channels, one at a
// time); each pixel's four taps lie at o00, o00 + dx, o00 + dy and
// o00 + dy + dx of its channel. kStrided: the image and the output are
// addressed through xs and os (K2); else they are contiguous (K1).
// Window mode's geometry (kWindow): the slab's rows, the first output
// row's and the slab's first row's global indices, the image's rows.
struct Window {
  int hx, out_y0, x_y0, h_glob;
};

template <typename TI, typename TF, int C, bool kStrided, bool kWindow,
          bool kZero = false>
__global__ void __launch_bounds__(32 * kTileRows)
    warp_planes_kernel(const TI* __restrict__ planes,
                       const TF* __restrict__ flow, TI* __restrict__ out,
                       int c, int H, int W, int band, int band_valid,
                       Strides4 fs, Strides4 xs, Strides4 os, Window win) {
  const int i = blockIdx.y * kTileRows + threadIdx.y;
  if (i >= H) return;
  const int b = blockIdx.z;
  // band mode: row i lies in the band that starts at row i - row, and
  // samples that band's first band_valid rows only; window mode: row i is
  // global row out_y0 + i of an h_glob-row image
  int row = i, rows = H;
  if (band) {
    row = (int)((unsigned)(blockIdx.y * kTileRows) % (unsigned)band) +
          threadIdx.y;
    while (row >= band) row -= band;
    rows = band_valid;
  }
  if constexpr (kWindow) {
    row = win.out_y0 + i;
    rows = win.h_glob;
  }
  // element strides within an image, 32-bit (the wrappers check the
  // largest offset), and the images' 64-bit bases; in window mode the
  // input planes have the slab's hx rows, the output's the flow's H
  const int plane = H * W;
  const int in_plane = kWindow ? win.hx * W : plane;
  const int x1 = kStrided ? (int)xs.s1 : in_plane;
  const int x2 = kStrided ? (int)xs.s2 : W;
  const int x3 = kStrided ? (int)xs.s3 : 1;
  const int o1 = kStrided ? (int)os.s1 : plane;
  const int o2 = kStrided ? (int)os.s2 : W;
  const int o3 = kStrided ? (int)os.s3 : 1;
  const int64_t dense = (int64_t)b * c * plane;
  const TI* src =
      planes + (kStrided ? b * xs.s0 : (int64_t)b * c * in_plane);
  TI* dst = out + (kStrided ? b * os.s0 : dense) + i * o2;
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
    if constexpr (kZero) {
      // zero padding (plain mode only): no clamp, a tap outside weighs 0
      const ZeroTaps z =
          zero_taps(__fadd_rn((float)row, fy[k]),
                    __fadd_rn((float)(j0 + 32 * k), fx[k]), rows, W);
      w00[k] = z.w00;
      w01[k] = z.w01;
      w10[k] = z.w10;
      w11[k] = z.w11;
      o00[k] = z.y0 * x2 + z.x0 * x3;
      dy[k] = (z.y1 - z.y0) * x2;
      dx[k] = (z.x1 - z.x0) * x3;
      continue;
    }
    const Taps t = taps_of(fx[k], fy[k], row, j0 + 32 * k, rows, W);
    const float wy0 = __fsub_rn(1.0f, t.wy);
    const float wx0 = __fsub_rn(1.0f, t.wx);
    w00[k] = __fmul_rn(wx0, wy0);
    w01[k] = __fmul_rn(t.wx, wy0);
    w10[k] = __fmul_rn(wx0, t.wy);
    w11[k] = __fmul_rn(t.wx, t.wy);
    if constexpr (kWindow) {
      // the clamped global tap rows, translated into the slab
      const int y0 = min(max(t.y0 - win.x_y0, 0), win.hx - 1);
      const int y1 = min(max(t.y1 - win.x_y0, 0), win.hx - 1);
      o00[k] = y0 * x2 + t.x0 * x3;
      dy[k] = (y1 - y0) * x2;
    } else {
      o00[k] = (i - row + t.y0) * x2 + t.x0 * x3;
      dy[k] = (t.y1 - t.y0) * x2;
    }
    dx[k] = (t.x1 - t.x0) * x3;
  }
  // top + bottom, stored where the column exists
  auto finish = [&](TI* d, int k, const float* v) {
    const float top = __fadd_rn(__fmul_rn(w00[k], v[0]),
                                __fmul_rn(w01[k], v[1]));
    const float bot = __fadd_rn(__fmul_rn(w10[k], v[2]),
                                __fmul_rn(w11[k], v[3]));
    const int j = j0 + 32 * k;
    if (j < W) store_f32(d + j * o3, __fadd_rn(top, bot));
  };
  // G channels at a time, every tap load of a group in flight before the
  // first is used: all C of them when the count is fixed, else one
  constexpr int G = C > 0 ? C : 1;
  for (int ch0 = 0; ch0 < (C > 0 ? C : c); ch0 += G) {
    float v[G][kTileSteps][4];
#pragma unroll
    for (int k = 0; k < kTileSteps; ++k) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int o = o00[k] + (q & 1 ? dx[k] : 0) + (q & 2 ? dy[k] : 0);
#pragma unroll
        for (int g = 0; g < G; ++g) {
          v[g][k][q] = load_f32(src + ((ch0 + g) * x1 + o));
        }
      }
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
#pragma unroll
      for (int k = 0; k < kTileSteps; ++k) {
        finish(dst + (ch0 + g) * o1, k, v[g][k]);
      }
    }
  }
}

template <typename TI, typename TF, int C, bool kStrided, bool kWindow,
          bool kZero>
int run(const int64_t* a, int band, int band_valid, Strides4 fs, Strides4 xs,
        Strides4 os, Window win, cudaStream_t stream) {
  const int n = (int)a[3], c = (int)a[4], H = (int)a[5], W = (int)a[6];
  constexpr int kTileW = 32 * kTileSteps;
  const dim3 grid((W + kTileW - 1) / kTileW, (H + kTileRows - 1) / kTileRows,
                  n);
  warp_planes_kernel<TI, TF, C, kStrided, kWindow, kZero>
      <<<grid, dim3(32, kTileRows), 0, stream>>>(
          arg_ptr<const TI>(a, 0), arg_ptr<const TF>(a, 1), arg_ptr<TI>(a, 2),
          c, H, W, band, band_valid, fs, xs, os, win);
  return (int)cudaGetLastError();
}

// RGB (every path) takes the kernel with the channels unrolled; any other
// count loops over them
template <typename TI, typename TF, bool kStrided, bool kWindow = false,
          bool kZero = false>
int run_any_c(const int64_t* a, int band, int band_valid, Strides4 fs,
              Strides4 xs, Strides4 os, cudaStream_t stream,
              Window win = Window{}) {
  if (a[3] * a[4] * a[5] * a[6] == 0) return 0;
  return a[4] == 3
             ? run<TI, TF, 3, kStrided, kWindow, kZero>(
                   a, band, band_valid, fs, xs, os, win, stream)
             : run<TI, TF, 0, kStrided, kWindow, kZero>(
                   a, band, band_valid, fs, xs, os, win, stream);
}

// K1: (planes, flow, out, n, c, H, W, band, band_valid, flow strides,
// stream)
template <typename TI, typename TF>
int launch_planes(const int64_t* a) {
  return run_any_c<TI, TF, false>(a, (int)a[7], (int)a[8],
                                  strides_from(a + 9), Strides4{},
                                  Strides4{}, arg_ptr<CUstream_st>(a, 13));
}

// K1's window mode: (planes, flow, out, n, c, ho, W, hx, out_y0, x_y0,
// h_glob, flow strides, stream)
template <typename TI, typename TF>
int launch_window(const int64_t* a) {
  const Window win{(int)a[7], (int)a[8], (int)a[9], (int)a[10]};
  return run_any_c<TI, TF, false, true>(a, 0, 0, strides_from(a + 11),
                                        Strides4{}, Strides4{},
                                        arg_ptr<CUstream_st>(a, 15), win);
}

// K2: (x, flow, out, n, c, H, W, the image's, the output's and the flow's
// strides, stream)
template <typename TI, typename TF>
int launch_rgb(const int64_t* a) {
  const Strides4 xs = strides_from(a + 7), os = strides_from(a + 11),
                 fs = strides_from(a + 15);
  return run_any_c<TI, TF, true>(a, 0, 0, fs, xs, os,
                                 arg_ptr<CUstream_st>(a, 19));
}

// K1's zero padding on a channels_last image of c = 8 k channels, the
// layout of BasicVSR++'s feature maps: one thread per pixel and 8
// neighbouring channels, the channel groups of a pixel on neighbouring
// threads, so each tap is one 16-byte load and the output one 16-byte
// store, a warp's stores covering 512 (bf16) neighbouring bytes. K1's row
// tiles (kZero above) put a warp's lanes on 32 columns and loop over the
// channels one at a time, which on this layout issues a 2-byte load per
// lane 2 c bytes apart for every channel and tap: 40x its bound at
// (4, 64, 180, 320). The stencil and the sums are K1's (zero_taps, the
// same order), so both are the one plain version bit for bit.
constexpr int kNhwcBlock = 256;

template <typename TI>
__global__ void __launch_bounds__(kNhwcBlock)
    warp_zero_nhwc_kernel(const TI* __restrict__ x,
                          const float* __restrict__ flow, TI* __restrict__ out,
                          int n, int c, int H, int W, Strides4 xs,
                          Strides4 os, Strides4 fs) {
  const int groups = c / 8;
  const int t = blockIdx.x * kNhwcBlock + threadIdx.x;
  if (t >= n * H * W * groups) return;
  const int g = t % groups;
  const int p = t / groups;
  const int j = p % W;
  const int q = p / W;
  const int i = q % H;
  const int b = q / H;
  const float* f = flow + b * fs.s0 + i * fs.s1 + j * fs.s2;
  const ZeroTaps z = zero_taps(__fadd_rn((float)i, f[fs.s3]),
                               __fadd_rn((float)j, f[0]), H, W);
  const TI* xb = x + b * xs.s0 + 8 * g;
  float v[4][8];
  load8(xb + (z.y0 * xs.s2 + z.x0 * xs.s3), v[0]);
  load8(xb + (z.y0 * xs.s2 + z.x1 * xs.s3), v[1]);
  load8(xb + (z.y1 * xs.s2 + z.x0 * xs.s3), v[2]);
  load8(xb + (z.y1 * xs.s2 + z.x1 * xs.s3), v[3]);
  float r[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const float top = __fadd_rn(__fmul_rn(z.w00, v[0][k]),
                                __fmul_rn(z.w01, v[1][k]));
    const float bot = __fadd_rn(__fmul_rn(z.w10, v[2][k]),
                                __fmul_rn(z.w11, v[3][k]));
    r[k] = __fadd_rn(top, bot);
  }
  store8(out + b * os.s0 + i * os.s2 + j * os.s3 + 8 * g, r);
}

// K1 with zero padding, on K2's strides: (x, flow, out, n, c, H, W, the
// image's, the output's and the flow's strides, stream)
template <typename TI, typename TF>
int launch_zero(const int64_t* a) {
  const Strides4 xs = strides_from(a + 7), os = strides_from(a + 11),
                 fs = strides_from(a + 15);
  return run_any_c<TI, TF, true, false, true>(a, 0, 0, fs, xs, os,
                                              arg_ptr<CUstream_st>(a, 19));
}

// K1's zero padding on channels_last vectors: K2's arguments, the image
// and the output channels_last with c, their strides and their addresses
// multiples of 8 elements (16 bytes), the flow fp32
template <typename TI>
int launch_zero_nhwc(const int64_t* a) {
  const int n = (int)a[3], c = (int)a[4], H = (int)a[5], W = (int)a[6];
  const int total = n * H * W * (c / 8);
  if (total == 0) return 0;
  warp_zero_nhwc_kernel<TI>
      <<<(total + kNhwcBlock - 1) / kNhwcBlock, kNhwcBlock, 0,
         arg_ptr<CUstream_st>(a, 19)>>>(
          arg_ptr<const TI>(a, 0), arg_ptr<const float>(a, 1),
          arg_ptr<TI>(a, 2), n, c, H, W, strides_from(a + 7),
          strides_from(a + 11), strides_from(a + 15));
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points, one per (image dtype, flow dtype) and kernel, each
// taking one int64 array. K1, tecogan_warp_planes_*: (planes, flow, out, n,
// c, H, W, band, band_valid, the flow's element strides in (n, H, W, 2)
// order, stream); planes and out are contiguous (n, c, H, W); band = 0
// warps each plane as one image, band > 0 (H a multiple of band) as H / band
// independent bands of band rows, each clamped to its first band_valid
// rows. K1's window mode, tecogan_warp_window_*: (planes, flow, out, n, c,
// ho, W, hx, out_y0, x_y0, h_glob, the flow's element strides, stream);
// planes (n, c, hx, W) and out (n, c, ho, W) are contiguous. K2,
// tecogan_warp_rgb_*: (x, flow, out, n, c, H, W, 12 element
// strides: the image's and the output's in (n, c, H, W) order, then the
// flow's in (n, H, W, 2) order, stream). Flow strides are in elements, so an
// (n, H, W, 2) tensor and the (n, H, W, 2) view of an NCHW (n, 2, H, W)
// tensor both work without a copy. The wrappers check the grid limits and
// the 32-bit offsets. K1 with zero padding, tecogan_warp_zero_*: K2's
// arguments; out-of-image taps read 0 (BasicVSR++'s feature and flow
// warps); tecogan_warp_zero_nhwc_*: the same on channels_last vectors of 8
// channels. Each returns cudaGetLastError() after the launch.
#define TECOGAN_WARP_ENTRY(NAME, TI, TF) \
  extern "C" int NAME(const int64_t* args) { \
    return launch_planes<TI, TF>(args);      \
  }
#define TECOGAN_WARP_WINDOW_ENTRY(NAME, TI, TF) \
  extern "C" int NAME(const int64_t* args) {  \
    return launch_window<TI, TF>(args);       \
  }
#define TECOGAN_WARP_RGB_ENTRY(NAME, TI, TF) \
  extern "C" int NAME(const int64_t* args) { return launch_rgb<TI, TF>(args); }
#define TECOGAN_WARP_ZERO_ENTRY(NAME, TI, TF) \
  extern "C" int NAME(const int64_t* args) { return launch_zero<TI, TF>(args); }

TECOGAN_WARP_ENTRY(tecogan_warp_planes_f32_f32, float, float)
TECOGAN_WARP_ENTRY(tecogan_warp_planes_f32_bf16, float, __nv_bfloat16)
TECOGAN_WARP_ENTRY(tecogan_warp_planes_bf16_f32, __nv_bfloat16, float)
TECOGAN_WARP_ENTRY(tecogan_warp_planes_bf16_bf16, __nv_bfloat16, __nv_bfloat16)
TECOGAN_WARP_WINDOW_ENTRY(tecogan_warp_window_f32_f32, float, float)
TECOGAN_WARP_WINDOW_ENTRY(tecogan_warp_window_f32_bf16, float, __nv_bfloat16)
TECOGAN_WARP_WINDOW_ENTRY(tecogan_warp_window_bf16_f32, __nv_bfloat16, float)
TECOGAN_WARP_WINDOW_ENTRY(tecogan_warp_window_bf16_bf16, __nv_bfloat16,
                          __nv_bfloat16)
TECOGAN_WARP_RGB_ENTRY(tecogan_warp_rgb_f32_f32, float, float)
TECOGAN_WARP_RGB_ENTRY(tecogan_warp_rgb_f32_bf16, float, __nv_bfloat16)
TECOGAN_WARP_RGB_ENTRY(tecogan_warp_rgb_bf16_f32, __nv_bfloat16, float)
TECOGAN_WARP_RGB_ENTRY(tecogan_warp_rgb_bf16_bf16, __nv_bfloat16,
                       __nv_bfloat16)
TECOGAN_WARP_ZERO_ENTRY(tecogan_warp_zero_f32_f32, float, float)
TECOGAN_WARP_ZERO_ENTRY(tecogan_warp_zero_bf16_f32, __nv_bfloat16, float)
extern "C" int tecogan_warp_zero_nhwc_f32(const int64_t* args) {
  return launch_zero_nhwc<float>(args);
}
extern "C" int tecogan_warp_zero_nhwc_bf16(const int64_t* args) {
  return launch_zero_nhwc<__nv_bfloat16>(args);
}
