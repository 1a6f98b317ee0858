// K3 and K4: the adjoints of the bilinear backward warp (K2), the backward
// of every training warp, for Hopper (sm_90a).
//
// Replace the TPU kernels tecogan_tpu/ops/warp_vjp.py::_dimage (body
// _dimage_kernel) and ::_dflow (body _dflow_kernel). Both use K2's stencil
// (warp_common.cuh): fp32 coordinates clamped then floored, second taps
// clamped to H-1 / W-1.
//
// K3, the adjoint with respect to the image. The TPU kernel avoids a
// scatter (the TPU cannot vectorise one) by enumerating displacements and
// accumulating shifted cotangents into a whole-image VMEM block. Hopper
// scatters with atomics, so here one thread per output pixel computes the
// stencil once and, for each channel, atomicAdds g * w into the four
// source taps of an fp32 image. Where taps coincide at the border their
// contributions add up. The atomic order changes the fp32 sum from run to
// run (the TPU path is deterministic); the bound is the atomics' traffic.
//
// K4, the adjoint with respect to the flow. The TPU kernel gathers the four
// tap values with the forward's slab enumeration; here one thread per
// pixel reads them directly and applies warp_vjp.py's formula
//     dfx = g * m_x * ((1-wy)(A01-A00) + wy(A11-A10))
//     dfy = g * m_y * ((1-wx)(A10-A00) + wx(A11-A01))
// with m_x = (j + fx >= 0), m_y = (i + fy >= 0): below 0 the clamped
// coordinate does not move with the flow; at the upper clamp the taps
// coincide and the difference vanishes by itself. The sum over channels
// happens in the thread (the TPU kernel leaves it to XLA), so the output
// is written once, fp32 (n, H, W, 2) in the order dfx, dfy. Deterministic.
// Bound: bytes (two images and the flow read, 8 B per pixel written).

#include "warp_common.cuh"

namespace {

using namespace tecogan;

template <typename TG, typename TF>
__global__ void warp_dimage_kernel(const TG* __restrict__ g,
                                   const TF* __restrict__ flow,
                                   float* __restrict__ out, int n, int c,
                                   int H, int W, Strides4 gs, Strides4 os,
                                   Strides4 fs) {
  int b, i, j;
  if (!pixel_of(n, H, W, b, i, j)) return;
  const Taps t = taps_at(flow, fs, b, i, j, H, W);
  const float wy0 = __fsub_rn(1.0f, t.wy);
  const float wx0 = __fsub_rn(1.0f, t.wx);
  const int64_t o00 = t.y0 * os.s2 + t.x0 * os.s3;
  const int64_t o01 = t.y0 * os.s2 + t.x1 * os.s3;
  const int64_t o10 = t.y1 * os.s2 + t.x0 * os.s3;
  const int64_t o11 = t.y1 * os.s2 + t.x1 * os.s3;

  const TG* gp = g + b * gs.s0 + i * gs.s2 + j * gs.s3;
  float* dst = out + b * os.s0;
  for (int ch = 0; ch < c; ++ch) {
    const float gv = load_f32(gp + ch * gs.s1);
    // (g * w_y) * w_x, the TPU kernel's order
    const float gy0 = __fmul_rn(gv, wy0);
    const float gy1 = __fmul_rn(gv, t.wy);
    float* d = dst + ch * os.s1;
    atomicAdd(d + o00, __fmul_rn(gy0, wx0));
    atomicAdd(d + o01, __fmul_rn(gy0, t.wx));
    atomicAdd(d + o10, __fmul_rn(gy1, wx0));
    atomicAdd(d + o11, __fmul_rn(gy1, t.wx));
  }
}

template <typename TX, typename TF>
__global__ void warp_dflow_kernel(const TX* __restrict__ g,
                                  const TX* __restrict__ x,
                                  const TF* __restrict__ flow,
                                  float* __restrict__ out, int n, int c,
                                  int H, int W, Strides4 gs, Strides4 xs,
                                  Strides4 fs) {
  int b, i, j;
  if (!pixel_of(n, H, W, b, i, j)) return;
  const Taps t = taps_at(flow, fs, b, i, j, H, W);
  const float wy0 = __fsub_rn(1.0f, t.wy);
  const float wx0 = __fsub_rn(1.0f, t.wx);
  const float m_x = __fadd_rn((float)j, t.fx) >= 0.0f ? 1.0f : 0.0f;
  const float m_y = __fadd_rn((float)i, t.fy) >= 0.0f ? 1.0f : 0.0f;
  const int64_t o00 = t.y0 * xs.s2 + t.x0 * xs.s3;
  const int64_t o01 = t.y0 * xs.s2 + t.x1 * xs.s3;
  const int64_t o10 = t.y1 * xs.s2 + t.x0 * xs.s3;
  const int64_t o11 = t.y1 * xs.s2 + t.x1 * xs.s3;

  const TX* gp = g + b * gs.s0 + i * gs.s2 + j * gs.s3;
  const TX* src = x + b * xs.s0;
  float dfx = 0.0f;
  float dfy = 0.0f;
  for (int ch = 0; ch < c; ++ch) {
    const TX* p = src + ch * xs.s1;
    const float a00 = load_f32(p + o00);
    const float a01 = load_f32(p + o01);
    const float a10 = load_f32(p + o10);
    const float a11 = load_f32(p + o11);
    const float gv = load_f32(gp + ch * gs.s1);
    const float tx = __fadd_rn(__fmul_rn(wy0, __fsub_rn(a01, a00)),
                               __fmul_rn(t.wy, __fsub_rn(a11, a10)));
    const float ty = __fadd_rn(__fmul_rn(wx0, __fsub_rn(a10, a00)),
                               __fmul_rn(t.wx, __fsub_rn(a11, a01)));
    dfx = __fadd_rn(dfx, __fmul_rn(__fmul_rn(gv, m_x), tx));
    dfy = __fadd_rn(dfy, __fmul_rn(__fmul_rn(gv, m_y), ty));
  }
  float* o = out + (((int64_t)b * H + i) * W + j) * 2;
  o[0] = dfx;
  o[1] = dfy;
}

template <typename TG, typename TF>
int launch_dimage(const void* g, const void* flow, void* out, int n, int c,
                  int H, int W, const int64_t* strides, void* stream) {
  if ((int64_t)n * H * W == 0) return 0;
  warp_dimage_kernel<TG, TF><<<blocks_for(n, H, W), kThreads, 0,
                               (cudaStream_t)stream>>>(
      (const TG*)g, (const TF*)flow, (float*)out, n, c, H, W,
      strides_from(strides), strides_from(strides + 4),
      strides_from(strides + 8));
  return (int)cudaGetLastError();
}

template <typename TX, typename TF>
int launch_dflow(const void* g, const void* x, const void* flow, void* out,
                 int n, int c, int H, int W, const int64_t* strides,
                 void* stream) {
  if ((int64_t)n * H * W == 0) return 0;
  warp_dflow_kernel<TX, TF><<<blocks_for(n, H, W), kThreads, 0,
                              (cudaStream_t)stream>>>(
      (const TX*)g, (const TX*)x, (const TF*)flow, (float*)out, n, c, H, W,
      strides_from(strides), strides_from(strides + 4),
      strides_from(strides + 8));
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points, one per (image/cotangent dtype, flow dtype).
// `strides` is a host array of 12 element strides. K3: g's and the fp32
// output's in (n, c, H, W) order, then the flow's in (n, H, W, 2) order;
// the output must be zeroed by the caller. K4: g's and x's in (n, c, H, W)
// order, then the flow's; the output is a contiguous fp32 (n, H, W, 2).
// Each returns cudaGetLastError() after the launch.
#define TECOGAN_DIMAGE_ENTRY(NAME, TG, TF)                                   \
  extern "C" int NAME(const void* g, const void* flow, void* out, int n,     \
                      int c, int H, int W, const int64_t* strides,           \
                      void* stream) {                                        \
    return launch_dimage<TG, TF>(g, flow, out, n, c, H, W, strides, stream); \
  }
#define TECOGAN_DFLOW_ENTRY(NAME, TX, TF)                                    \
  extern "C" int NAME(const void* g, const void* x, const void* flow,        \
                      void* out, int n, int c, int H, int W,                 \
                      const int64_t* strides, void* stream) {                \
    return launch_dflow<TX, TF>(g, x, flow, out, n, c, H, W, strides,        \
                                stream);                                     \
  }

TECOGAN_DIMAGE_ENTRY(tecogan_warp_dimage_f32_f32, float, float)
TECOGAN_DIMAGE_ENTRY(tecogan_warp_dimage_f32_bf16, float, __nv_bfloat16)
TECOGAN_DIMAGE_ENTRY(tecogan_warp_dimage_bf16_f32, __nv_bfloat16, float)
TECOGAN_DIMAGE_ENTRY(tecogan_warp_dimage_bf16_bf16, __nv_bfloat16,
                     __nv_bfloat16)
TECOGAN_DFLOW_ENTRY(tecogan_warp_dflow_f32_f32, float, float)
TECOGAN_DFLOW_ENTRY(tecogan_warp_dflow_f32_bf16, float, __nv_bfloat16)
TECOGAN_DFLOW_ENTRY(tecogan_warp_dflow_bf16_f32, __nv_bfloat16, float)
TECOGAN_DFLOW_ENTRY(tecogan_warp_dflow_bf16_bf16, __nv_bfloat16,
                    __nv_bfloat16)
