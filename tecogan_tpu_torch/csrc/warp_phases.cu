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
// Design. The TPU kernel shares one displacement enumeration and its slab
// loads across all s*s output phases of a tile, because the TPU has no
// per-lane gather. Hopper gathers natively: one thread per output
// (b, q, i, j) computes its stencil once and loops over the channels.
// Neighbouring threads take neighbouring j of one phase, so the coordinate
// reads and the output writes coalesce, and their taps fall on neighbouring
// plane columns. The planes are read through six element strides, logically
// (n, py, px, c, i, j): the JAX package's (n, s*s, c, h, w) tensor and the
// phase-plane view of an NCHW HR frame both work without a copy. The output
// is contiguous (n, s*s, c, h, w), i.e. conv_in's space_to_depth order.
//
// Bound. Bytes: at bf16 planes, per output element 2 B in and 2 B out, plus
// 8 B of f32 coordinates per output pixel shared by the c channels; about
// 13.7 MB for a 4x 134x320 frame, a few microseconds at HBM bandwidth.

#include "warp_common.cuh"

namespace {

using namespace tecogan;

// the TPU kernel's halo: displacements up to s * (48 - 2) HR pixels
constexpr int kHaloBound = 46;

// Element strides of planes viewed as (n, py, px, c, i, j).
struct PlaneStrides {
  int64_t b, py, px, c, i, j;
};

// The offset of HR pixel (Y, X) within one (b, ch) plane set, or -1 where
// the pixel lies outside the H x W image.
__device__ __forceinline__ int64_t tap_offset(int Y, int X, int s, int H,
                                              int W, const PlaneStrides& ps) {
  if (Y < 0 || Y >= H || X < 0 || X >= W) return -1;
  return (int64_t)(Y / s) * ps.i + (int64_t)(Y % s) * ps.py +
         (int64_t)(X / s) * ps.j + (int64_t)(X % s) * ps.px;
}

template <typename TI>
__device__ __forceinline__ float tap_value(const TI* p, int64_t off) {
  return off < 0 ? 0.0f : load_f32(p + off);
}

template <typename TI>
__global__ void warp_phases_kernel(const TI* __restrict__ planes,
                                   const float* __restrict__ sy,
                                   const float* __restrict__ sx,
                                   TI* __restrict__ out, int n, int s, int c,
                                   int h, int w, PlaneStrides ps, Strides4 ys,
                                   Strides4 xs) {
  const int nq = s * s;
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (int64_t)n * nq * h * w) return;
  const int j = (int)(idx % w);
  int64_t r = idx / w;
  const int i = (int)(r % h);
  r /= h;
  const int q = (int)(r % nq);
  const int b = (int)(r / nq);

  const float ycoord = sy[b * ys.s0 + q * ys.s1 + i * ys.s2 + j * ys.s3];
  const float xcoord = sx[b * xs.s0 + q * xs.s1 + i * xs.s2 + j * xs.s3];
  const float row = (float)(s * i);
  const float col = (float)(s * j);
  const float bound = (float)(s * kHaloBound);
  const float syc = fminf(fmaxf(ycoord, __fsub_rn(row, bound)),
                          __fadd_rn(row, bound));
  const float sxc = fminf(fmaxf(xcoord, __fsub_rn(col, bound)),
                          __fadd_rn(col, bound));
  const float y0f = floorf(syc);
  const float x0f = floorf(sxc);
  const float wy = __fsub_rn(syc, y0f);
  const float wx = __fsub_rn(sxc, x0f);
  const float wy0 = __fsub_rn(1.0f, wy);
  const float wx0 = __fsub_rn(1.0f, wx);
  const float w00 = __fmul_rn(wy0, wx0);
  const float w01 = __fmul_rn(wy0, wx);
  const float w10 = __fmul_rn(wy, wx0);
  const float w11 = __fmul_rn(wy, wx);

  const int H = s * h, W = s * w;
  const int y0 = (int)y0f, x0 = (int)x0f;
  const int64_t o00 = tap_offset(y0, x0, s, H, W, ps);
  const int64_t o01 = tap_offset(y0, x0 + 1, s, H, W, ps);
  const int64_t o10 = tap_offset(y0 + 1, x0, s, H, W, ps);
  const int64_t o11 = tap_offset(y0 + 1, x0 + 1, s, H, W, ps);

  const TI* src = planes + b * ps.b;
  const int64_t plane = (int64_t)h * w;
  TI* dst = out + ((int64_t)b * nq + q) * c * plane + (int64_t)i * w + j;
  for (int ch = 0; ch < c; ++ch) {
    const TI* p = src + ch * ps.c;
    float acc = __fmul_rn(w00, tap_value(p, o00));
    acc = __fadd_rn(acc, __fmul_rn(w01, tap_value(p, o01)));
    acc = __fadd_rn(acc, __fmul_rn(w10, tap_value(p, o10)));
    acc = __fadd_rn(acc, __fmul_rn(w11, tap_value(p, o11)));
    store_f32(dst + ch * plane, acc);
  }
}

template <typename TI>
int launch(const void* planes, const void* sy, const void* sx, void* out,
           int n, int s, int c, int h, int w, const int64_t* st,
           void* stream) {
  const int64_t total = (int64_t)n * s * s * h * w;
  if (total == 0) return 0;
  const unsigned int blocks = (unsigned int)((total + kThreads - 1) / kThreads);
  warp_phases_kernel<TI><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const TI*)planes, (const float*)sy, (const float*)sx, (TI*)out, n, s,
      c, h, w, PlaneStrides{st[0], st[1], st[2], st[3], st[4], st[5]},
      strides_from(st + 6), strides_from(st + 10));
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points, one per planes dtype; the coordinates are always
// f32. `strides` holds 14 element strides: planes as (n, py, px, c, i, j),
// then sy and sx as (n, q, i, j). out is contiguous (n, s*s, c, h, w).
// Returns cudaGetLastError() after the launch.
#define TECOGAN_PHASES_ENTRY(NAME, TI)                                        \
  extern "C" int NAME(const void* planes, const void* sy, const void* sx,    \
                      void* out, int n, int s, int c, int h, int w,          \
                      const int64_t* strides, void* stream) {                \
    return launch<TI>(planes, sy, sx, out, n, s, c, h, w, strides, stream);   \
  }

TECOGAN_PHASES_ENTRY(tecogan_warp_phases_f32, float)
TECOGAN_PHASES_ENTRY(tecogan_warp_phases_bf16, __nv_bfloat16)
