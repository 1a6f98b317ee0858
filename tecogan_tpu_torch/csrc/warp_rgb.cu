// K2: bilinear backward warp of an image addressed by element strides, the
// forward of every training warp, for Hopper (sm_90a).
//
// Replaces the TPU kernel tecogan_tpu/ops/warp_pallas.py::
// backward_warp_rgb_flat (kernel body _warp_kernel_rgb), the warp on the
// channel-interleaved NHWC layout. It computes K1's function (see
// warp_common.cuh): fp32 coordinates, weights and accumulation, the output
// written once in the image's dtype.
//
// Design. The TPU kernel interleaves the flow on c lanes per pixel and
// enumerates displacements over 128-lane blocks because the TPU has no
// per-lane gather. Here one thread per output pixel computes the stencil
// once and loops over the channels. The image and the output are read and
// written through (n, c, H, W) element strides, so an NCHW-contiguous
// tensor and a channels_last (NHWC-memory, the TPU kernel's own layout)
// tensor both work without a copy; the flow is read through strides too.
//
// Bound: bytes. At the training HR warp (2, 3, 128, 128) bf16 it moves
// about 0.5 MB, well under a microsecond of HBM time, so the launch
// dominates.

#include "warp_common.cuh"

namespace {

using namespace tecogan;

template <typename TI, typename TF>
__global__ void warp_rgb_kernel(const TI* __restrict__ x,
                                const TF* __restrict__ flow,
                                TI* __restrict__ out, int n, int c, int H,
                                int W, Strides4 xs, Strides4 os, Strides4 fs) {
  int b, i, j;
  if (!pixel_of(n, H, W, b, i, j)) return;
  const Taps t = taps_at(flow, fs, b, i, j, H, W);
  const float wy0 = __fsub_rn(1.0f, t.wy);
  const float wx0 = __fsub_rn(1.0f, t.wx);
  const float w00 = __fmul_rn(wx0, wy0);
  const float w01 = __fmul_rn(t.wx, wy0);
  const float w10 = __fmul_rn(wx0, t.wy);
  const float w11 = __fmul_rn(t.wx, t.wy);
  const int64_t o00 = t.y0 * xs.s2 + t.x0 * xs.s3;
  const int64_t o01 = t.y0 * xs.s2 + t.x1 * xs.s3;
  const int64_t o10 = t.y1 * xs.s2 + t.x0 * xs.s3;
  const int64_t o11 = t.y1 * xs.s2 + t.x1 * xs.s3;

  const TI* src = x + b * xs.s0;
  TI* dst = out + b * os.s0 + i * os.s2 + j * os.s3;
  for (int ch = 0; ch < c; ++ch) {
    const TI* p = src + ch * xs.s1;
    const float top = __fadd_rn(__fmul_rn(w00, load_f32(p + o00)),
                                __fmul_rn(w01, load_f32(p + o01)));
    const float bot = __fadd_rn(__fmul_rn(w10, load_f32(p + o10)),
                                __fmul_rn(w11, load_f32(p + o11)));
    store_f32(dst + ch * os.s1, __fadd_rn(top, bot));
  }
}

template <typename TI, typename TF>
int launch(const int64_t* a) {
  const int n = (int)a[3], c = (int)a[4], H = (int)a[5], W = (int)a[6];
  if ((int64_t)n * H * W == 0) return 0;
  warp_rgb_kernel<TI, TF><<<blocks_for(n, H, W), kThreads, 0,
                            arg_ptr<CUstream_st>(a, 19)>>>(
      arg_ptr<const TI>(a, 0), arg_ptr<const TF>(a, 1), arg_ptr<TI>(a, 2), n,
      c, H, W, strides_from(a + 7), strides_from(a + 11),
      strides_from(a + 15));
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points, one per (image dtype, flow dtype), each taking
// one int64 array: (x, flow, out, n, c, H, W, 12 element strides: the
// image's and the output's in (n, c, H, W) order, then the flow's in
// (n, H, W, 2) order, stream). Returns cudaGetLastError() after the launch.
#define TECOGAN_WARP_RGB_ENTRY(NAME, TI, TF) \
  extern "C" int NAME(const int64_t* args) { return launch<TI, TF>(args); }

TECOGAN_WARP_RGB_ENTRY(tecogan_warp_rgb_f32_f32, float, float)
TECOGAN_WARP_RGB_ENTRY(tecogan_warp_rgb_f32_bf16, float, __nv_bfloat16)
TECOGAN_WARP_RGB_ENTRY(tecogan_warp_rgb_bf16_f32, __nv_bfloat16, float)
TECOGAN_WARP_RGB_ENTRY(tecogan_warp_rgb_bf16_bf16, __nv_bfloat16,
                       __nv_bfloat16)
