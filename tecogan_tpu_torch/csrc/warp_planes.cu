// Bilinear backward warp of channel-major planes, for Hopper (sm_90a).
//
// Replaces the TPU kernel tecogan_tpu/ops/warp_pallas.py::_warp_planes
// (kernel body _warp_kernel). It computes the same function: output pixel
// (b, ch, i, j) samples plane (b, ch) at
//     (clip(i + fy, 0, H-1), clip(j + fx, 0, W-1))
// with the coordinate clamped first and floored after (grid_sample border
// padding, align_corners=True). Coordinates, tap weights and the
// accumulation are fp32; the result is written once in the planes' dtype.
//
// Design. The TPU kernel enumerates displacement ranges over 32x128 tiles
// with slab rolls because the TPU has no per-lane gather. Hopper gathers
// natively, so this is a plain gather: one thread per output pixel
// (b, i, j) computes its coordinates and weights once and loops over the c
// channels, reading the four taps of each. The second taps min(y0+1, H-1)
// and min(x0+1, W-1) stay in bounds, so no padding is needed and there is
// no size limit (the TPU kernel's VMEM gate has no counterpart here).
//
// Bound. The kernel moves bytes, not FLOPs: at bf16 about 16 B per pixel
// (3 planes in, 2 flow values, 3 planes out), a few MB per 536x1280 frame,
// i.e. microseconds at HBM bandwidth; at the 134x320 LR protocol the launch
// itself is a large share. Fusing the space_to_depth of the output into
// this kernel, or capturing the frame loop in a CUDA graph, is later work.
//
// The arithmetic (warp_common.cuh) rounds exactly like the plain PyTorch
// version (ops/warp_cuda.py::warp_planes_reference).

#include "warp_common.cuh"

namespace {

using namespace tecogan;

template <typename TI, typename TF>
__global__ void warp_planes_kernel(const TI* __restrict__ planes,
                                   const TF* __restrict__ flow,
                                   TI* __restrict__ out, int n, int c, int H,
                                   int W, Strides4 fs) {
  int b, i, j;
  if (!pixel_of(n, H, W, b, i, j)) return;
  const Taps t = taps_at(flow, fs, b, i, j, H, W);
  const float wy0 = __fsub_rn(1.0f, t.wy);
  const float wx0 = __fsub_rn(1.0f, t.wx);
  const float w00 = __fmul_rn(wx0, wy0);
  const float w01 = __fmul_rn(t.wx, wy0);
  const float w10 = __fmul_rn(wx0, t.wy);
  const float w11 = __fmul_rn(t.wx, t.wy);
  const int64_t o00 = (int64_t)t.y0 * W + t.x0;
  const int64_t o01 = (int64_t)t.y0 * W + t.x1;
  const int64_t o10 = (int64_t)t.y1 * W + t.x0;
  const int64_t o11 = (int64_t)t.y1 * W + t.x1;

  const int64_t plane = (int64_t)H * W;
  const TI* src = planes + (int64_t)b * c * plane;
  TI* dst = out + (int64_t)b * c * plane + (int64_t)i * W + j;
  for (int ch = 0; ch < c; ++ch) {
    const TI* p = src + ch * plane;
    const float top = __fadd_rn(__fmul_rn(w00, load_f32(p + o00)),
                                __fmul_rn(w01, load_f32(p + o01)));
    const float bot = __fadd_rn(__fmul_rn(w10, load_f32(p + o10)),
                                __fmul_rn(w11, load_f32(p + o11)));
    store_f32(dst + ch * plane, __fadd_rn(top, bot));
  }
}

template <typename TI, typename TF>
int launch(const void* planes, const void* flow, void* out, int n, int c,
           int H, int W, int64_t fs_n, int64_t fs_h, int64_t fs_w,
           int64_t fs_k, void* stream) {
  if ((int64_t)n * H * W == 0) return 0;
  warp_planes_kernel<TI, TF><<<blocks_for(n, H, W), kThreads, 0,
                               (cudaStream_t)stream>>>(
      (const TI*)planes, (const TF*)flow, (TI*)out, n, c, H, W,
      Strides4{fs_n, fs_h, fs_w, fs_k});
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points, one per (planes dtype, flow dtype). Flow strides
// are in elements, so an (n, H, W, 2) tensor and the (n, H, W, 2) view of
// an NCHW (n, 2, H, W) tensor both work without a copy. Planes and out are
// contiguous (n, c, H, W). Returns cudaGetLastError() after the launch.
#define TECOGAN_WARP_ENTRY(NAME, TI, TF)                                      \
  extern "C" int NAME(const void* planes, const void* flow, void* out, int n, \
                      int c, int H, int W, int64_t fs_n, int64_t fs_h,        \
                      int64_t fs_w, int64_t fs_k, void* stream) {             \
    return launch<TI, TF>(planes, flow, out, n, c, H, W, fs_n, fs_h, fs_w,    \
                          fs_k, stream);                                      \
  }

TECOGAN_WARP_ENTRY(tecogan_warp_planes_f32_f32, float, float)
TECOGAN_WARP_ENTRY(tecogan_warp_planes_f32_bf16, float, __nv_bfloat16)
TECOGAN_WARP_ENTRY(tecogan_warp_planes_bf16_f32, __nv_bfloat16, float)
TECOGAN_WARP_ENTRY(tecogan_warp_planes_bf16_bf16, __nv_bfloat16, __nv_bfloat16)
