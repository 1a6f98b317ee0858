// Bilinear backward warp of phase planes (K5), for Hopper (sm_90a).
//
// Replaces the TPU kernel
// tecogan_tpu/ops/warp_pallas.py::backward_warp_packed_planes (kernel body
// _warp_kernel_phases). The planes hold an HR image of H = s*h rows and
// W = s*w columns split into s*s phases: plane q = py*s + px holds the HR
// pixels (s*i + py, s*j + px). Output (b, ch, q, i, j) samples the HR
// image at the absolute coordinates (sy, sx)[b, q, i, j]:
//     syc = clip(sy, s*i - s*46, s*i + s*46), likewise x with s*j
//     (the TPU kernel's halo bound, a safety net: FRNet's tanh-bounded flows
//     stay well inside it);
//     y0 = floor(syc), wy = syc - y0, likewise x;
//     taps (y0, x0), (y0, x0+1), (y0+1, x0), (y0+1, x0+1), where HR row Y
//     is plane row Y div s of phase row Y mod s, and a tap outside the HR
//     image reads 0 (the TPU kernel's zero halo);
//     out = ((w00*v00 + w01*v01) + w10*v10) + w11*v11 with w = w_y * w_x,
//     the TPU kernel's order of accumulation (not K1's top + bottom).
// Coordinates, weights and sums are fp32, with the round-to-nearest
// intrinsics so nothing fuses into an FMA: the plain PyTorch version
// (ops/warp_phases.py::warp_phases_reference) rounds the same. The result
// is written once in the planes' dtype.
//
// Bound: bytes. At bf16 planes, per output element 2 B in and 2 B out, plus
// 8 B of f32 coordinates per output pixel shared by the c channels: 13.72
// MB for a 4x 134x320 frame, 4.10 us at 3.35 TB/s.
//
// Design. The TPU kernel shares one displacement enumeration and its slab
// loads across all s*s output phases of a tile, because the TPU has no
// per-lane gather; Hopper gathers natively. The first port ran one thread
// per output (b, q, i, j), decoded with four 64-bit div/mod pairs, with
// neighbouring threads on neighbouring j of one phase (so a warp's taps lay
// s HR columns apart) and a division by the runtime scale per tap. Now:
// - the scale is a template parameter (2 or 4): a tap's plane row and
//   phase are a shift and a mask;
// - the grid is (column tiles, row tiles, n*s) of the tiles in
//   warp_common.cuh: blockIdx.z gives the image and the output phase row
//   py, a warp takes one output row i, and no index is divided;
// - within a warp the px phase runs fastest: lane l takes px = l mod s and
//   j = l div s (plus 32/s per step), i.e. HR column s*j + px, so a warp
//   covers 32 neighbouring HR columns of one HR row, and its taps fall on
//   the cache lines around those 32 sample points (contiguous in the
//   phase-plane view of an HR frame); its coordinate loads and output
//   stores are s runs of 32/s neighbouring elements;
// - the channel count of the packed16 path (3) is a template parameter, so
//   a thread issues all 12 x kTileSteps tap loads before it uses one;
// - tap offsets are 32-bit within an image and coordinate offsets 32-bit
//   within a row (the wrapper checks both), from 64-bit bases set once per
//   thread; a column past w reads column w-1 and stores nothing, and a tap
//   outside the HR image is a predicate, so no branch guards a load.
// What is left (PERF.md, section 6): at its pixels' own coordinates (a
// copy's access pattern) the kernel still takes about three times a
// streaming add's time over the same output: the per-pixel work, or the
// coordinates-then-taps chain of two L2 round trips (not yet told apart).
// The planes are read through six element strides, logically
// (n, py, px, c, i, j): the JAX package's (n, s*s, c, h, w) tensor (whose
// phases lie in separate planes: slower, still right) and the phase-plane
// view of an NCHW HR frame both work without a copy. No shared memory.
// The output is contiguous (n, s*s, c, h, w), i.e. conv_in's
// space_to_depth order.

#include "warp_common.cuh"

namespace {

using namespace tecogan;

// the TPU kernel's halo: displacements up to s * (48 - 2) HR pixels
constexpr int kHaloBound = 46;

// Element strides of planes viewed as (n, py, px, c, i, j); those within
// an image fit in 32 bits.
struct PlaneStrides {
  int64_t b;
  int py, px, c, i, j;
};

// The parts of an HR tap's offset within one (b, ch) plane set: row Y lies
// in plane row Y div S of phase row Y mod S, likewise column X.
template <int S>
__device__ __forceinline__ int row_offset(int Y, const PlaneStrides& ps) {
  constexpr int L = S == 4 ? 2 : 1;
  return (Y >> L) * ps.i + (Y & (S - 1)) * ps.py;
}
template <int S>
__device__ __forceinline__ int col_offset(int X, const PlaneStrides& ps) {
  constexpr int L = S == 4 ? 2 : 1;
  return (X >> L) * ps.j + (X & (S - 1)) * ps.px;
}

template <typename TI>
__device__ __forceinline__ float tap_value(const TI* p, int off) {
  return off < 0 ? 0.0f : load_f32(p + off);
}

// Scale S (2 or 4); C channels (C = 0: c channels, one at a time).
template <typename TI, int S, int C>
__global__ void __launch_bounds__(32 * kTileRows)
    warp_phases_kernel(const TI* __restrict__ planes,
                       const float* __restrict__ sy,
                       const float* __restrict__ sx, TI* __restrict__ out,
                       int c, int h, int w, PlaneStrides ps, Strides4 ys,
                       Strides4 xs) {
  static_assert(S == 2 || S == 4, "K5 is built for scales 2 and 4");
  constexpr int L = S == 4 ? 2 : 1;
  constexpr int kJ = 32 / S;  // output columns of one phase per warp step
  const int i = blockIdx.y * kTileRows + threadIdx.y;
  if (i >= h) return;
  const int b = blockIdx.z >> L;
  const int px = threadIdx.x & (S - 1);
  const int q = (blockIdx.z & (S - 1)) * S + px;
  const int j0 = blockIdx.x * (kJ * kTileSteps) + (threadIdx.x >> L);

  // the coordinate rows in 64 bits once; offsets within them are 32-bit
  const float* yrow = sy + b * ys.s0 + q * ys.s1 + i * ys.s2;
  const float* xrow = sx + b * xs.s0 + q * xs.s1 + i * xs.s2;
  const int yj = (int)ys.s3, xj = (int)xs.s3;
  // a column past w reads column w-1's coordinates and stores nothing (no
  // branch around the loads)
  float yc[kTileSteps], xc[kTileSteps];
#pragma unroll
  for (int k = 0; k < kTileSteps; ++k) {
    const int j = min(j0 + kJ * k, w - 1);
    yc[k] = yrow[j * yj];
    xc[k] = xrow[j * xj];
  }
  const float row = (float)(S * i);
  const float bound = (float)(S * kHaloBound);
  const int H = S * h, W = S * w;
  int o[kTileSteps][4];
  float wt[kTileSteps][4];
#pragma unroll
  for (int k = 0; k < kTileSteps; ++k) {
    const float col = (float)(S * (j0 + kJ * k));
    const float syc = fminf(fmaxf(yc[k], __fsub_rn(row, bound)),
                            __fadd_rn(row, bound));
    const float sxc = fminf(fmaxf(xc[k], __fsub_rn(col, bound)),
                            __fadd_rn(col, bound));
    const float y0f = floorf(syc);
    const float x0f = floorf(sxc);
    const float wy = __fsub_rn(syc, y0f);
    const float wx = __fsub_rn(sxc, x0f);
    const float wy0 = __fsub_rn(1.0f, wy);
    const float wx0 = __fsub_rn(1.0f, wx);
    wt[k][0] = __fmul_rn(wy0, wx0);
    wt[k][1] = __fmul_rn(wy0, wx);
    wt[k][2] = __fmul_rn(wy, wx0);
    wt[k][3] = __fmul_rn(wy, wx);
    // each tap's offset, or -1 where it lies outside the HR image
    const int y0 = (int)y0f, x0 = (int)x0f;
    const bool in_y0 = (unsigned)y0 < (unsigned)H;
    const bool in_y1 = (unsigned)(y0 + 1) < (unsigned)H;
    const bool in_x0 = (unsigned)x0 < (unsigned)W;
    const bool in_x1 = (unsigned)(x0 + 1) < (unsigned)W;
    const int r0 = row_offset<S>(y0, ps), r1 = row_offset<S>(y0 + 1, ps);
    const int c0 = col_offset<S>(x0, ps), c1 = col_offset<S>(x0 + 1, ps);
    o[k][0] = in_y0 && in_x0 ? r0 + c0 : -1;
    o[k][1] = in_y0 && in_x1 ? r0 + c1 : -1;
    o[k][2] = in_y1 && in_x0 ? r1 + c0 : -1;
    o[k][3] = in_y1 && in_x1 ? r1 + c1 : -1;
  }

  const TI* src = planes + b * ps.b;
  const int64_t plane = (int64_t)h * w;
  // output (b, q, ch, i, j); b * s*s + q = blockIdx.z * s + px
  TI* dst = out + ((int64_t)(blockIdx.z * S + px) * c * h + i) * w;
  // the TPU kernel's order, stored where the column exists
  auto finish = [&](TI* d, int k, const float* v) {
    float acc = __fmul_rn(wt[k][0], v[0]);
    acc = __fadd_rn(acc, __fmul_rn(wt[k][1], v[1]));
    acc = __fadd_rn(acc, __fmul_rn(wt[k][2], v[2]));
    acc = __fadd_rn(acc, __fmul_rn(wt[k][3], v[3]));
    if (j0 + kJ * k < w) store_f32(d + j0 + kJ * k, acc);
  };
  // G channels at a time, every tap load of a group in flight before the
  // first is used: all C of them when the count is fixed, else one
  constexpr int G = C > 0 ? C : 1;
  for (int ch0 = 0; ch0 < (C > 0 ? C : c); ch0 += G) {
    float v[G][kTileSteps][4];
#pragma unroll
    for (int g = 0; g < G; ++g) {
#pragma unroll
      for (int k = 0; k < kTileSteps; ++k) {
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          v[g][k][t] = tap_value(src + (ch0 + g) * ps.c, o[k][t]);
        }
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

template <typename TI, int S, int C>
int launch_kernel(const int64_t* a) {
  const int n = (int)a[4], c = (int)a[6], h = (int)a[7], w = (int)a[8];
  constexpr int kTileW = 32 / S * kTileSteps;
  const dim3 grid((w + kTileW - 1) / kTileW, (h + kTileRows - 1) / kTileRows,
                  n * S);
  warp_phases_kernel<TI, S, C><<<grid, dim3(32, kTileRows), 0,
                                 arg_ptr<CUstream_st>(a, 23)>>>(
      arg_ptr<const TI>(a, 0), arg_ptr<const float>(a, 1),
      arg_ptr<const float>(a, 2), arg_ptr<TI>(a, 3), c, h, w,
      PlaneStrides{a[9], (int)a[10], (int)a[11], (int)a[12], (int)a[13],
                   (int)a[14]},
      strides_from(a + 15), strides_from(a + 19));
  return (int)cudaGetLastError();
}

// RGB planes (the packed16 path) take the kernel with the channels
// unrolled; any other count loops over them
template <typename TI, int S>
int launch_scale(const int64_t* a) {
  return a[6] == 3 ? launch_kernel<TI, S, 3>(a) : launch_kernel<TI, S, 0>(a);
}

template <typename TI>
int launch(const int64_t* a) {
  if (a[4] * a[6] * a[7] * a[8] == 0) return 0;
  switch (a[5]) {
    case 2:
      return launch_scale<TI, 2>(a);
    case 4:
      return launch_scale<TI, 4>(a);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry points, one per planes dtype; the coordinates are always
// f32. Each takes one int64 array: (planes, sy, sx, out, n, s, c, h, w,
// 14 element strides: planes as (n, py, px, c, i, j), then sy and sx as
// (n, q, i, j), stream). s is 2 or 4. out is contiguous (n, s*s, c, h, w).
// The wrapper checks the grid limits and the 32-bit offsets. Returns
// cudaGetLastError() after the launch.
#define TECOGAN_PHASES_ENTRY(NAME, TI) \
  extern "C" int NAME(const int64_t* args) { return launch<TI>(args); }

TECOGAN_PHASES_ENTRY(tecogan_warp_phases_f32, float)
TECOGAN_PHASES_ENTRY(tecogan_warp_phases_bf16, __nv_bfloat16)
