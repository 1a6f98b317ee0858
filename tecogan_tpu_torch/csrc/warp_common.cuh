// Shared arithmetic of the bilinear backward warps (K1-K4), for Hopper.
//
// Every warp samples pixel (i, j) at (clip(i + fy, 0, H-1),
// clip(j + fx, 0, W-1)): the coordinate is clamped first and floored after
// (grid_sample border padding, align_corners=True), the second taps are
// min(y0+1, H-1) / min(x0+1, W-1), and all coordinate and weight
// arithmetic is fp32. Sums and products use the round-to-nearest
// intrinsics so nothing is contracted into an FMA: the kernels then round
// exactly like their plain PyTorch versions, which do the same operations
// in the same order.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tecogan {

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);  // round to nearest even
}
// two neighbouring elements in one store; p aligned to the pair's size
__device__ __forceinline__ void store_f32x2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store_f32x2(__nv_bfloat16* p, float a,
                                            float b) {
  // each rounded to nearest even, a at p[0]
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// Element strides of a logically (n, c, H, W) tensor, or of an (n, H, W, 2)
// flow in the order (n, h, w, k).
struct Strides4 {
  int64_t s0, s1, s2, s3;
};

__host__ __forceinline__ Strides4 strides_from(const int64_t* s) {
  return Strides4{s[0], s[1], s[2], s[3]};
}

// The bilinear stencil of one output pixel.
struct Taps {
  int y0, x0, y1, x1;
  float wy, wx;  // fractional parts of the clamped coordinates
  float fx, fy;  // the flow, read as fp32
};

// The stencil of pixel (i, j) of an H x W clamp box displaced by (fx, fy).
__device__ __forceinline__ Taps taps_of(float fx, float fy, int i, int j,
                                        int H, int W) {
  Taps t;
  t.fx = fx;
  t.fy = fy;
  const float syc =
      fminf(fmaxf(__fadd_rn((float)i, t.fy), 0.0f), (float)(H - 1));
  const float sxc =
      fminf(fmaxf(__fadd_rn((float)j, t.fx), 0.0f), (float)(W - 1));
  const float y0f = floorf(syc);
  const float x0f = floorf(sxc);
  t.wy = __fsub_rn(syc, y0f);
  t.wx = __fsub_rn(sxc, x0f);
  t.y0 = (int)y0f;
  t.x0 = (int)x0f;
  t.y1 = min(t.y0 + 1, H - 1);
  t.x1 = min(t.x0 + 1, W - 1);
  return t;
}

// The stencil of a sample point (sy, sx) of an H x W image with zero
// padding (grid_sample's padding_mode="zeros" with align_corners=True, and
// mmcv's modulated deformable sampling): the coordinate is floored with no
// clamp, and a tap outside the image weighs 0. The four weights are the
// products (1-wx)(1-wy), wx(1-wy), (1-wx)wy, wx*wy in that order, as K1's;
// the tap indices are clamped into the image, so every load stays in
// bounds and a clamped tap only ever meets a zero weight. Taken by K1's
// zero-padding instantiation and by the DCN's column gather (dcn.cu).
struct ZeroTaps {
  int y0, x0, y1, x1;
  float w00, w01, w10, w11;
};

__device__ __forceinline__ ZeroTaps zero_taps(float sy, float sx, int H,
                                              int W) {
  const float y0f = floorf(sy);
  const float x0f = floorf(sx);
  const float wy = __fsub_rn(sy, y0f);
  const float wx = __fsub_rn(sx, x0f);
  const float wy0 = __fsub_rn(1.0f, wy);
  const float wx0 = __fsub_rn(1.0f, wx);
  // whether the first and the second tap row (column) lie in the image
  const bool ry0 = y0f >= 0.0f && y0f <= (float)(H - 1);
  const bool ry1 = y0f >= -1.0f && y0f <= (float)(H - 2);
  const bool rx0 = x0f >= 0.0f && x0f <= (float)(W - 1);
  const bool rx1 = x0f >= -1.0f && x0f <= (float)(W - 2);
  ZeroTaps t;
  t.w00 = (ry0 && rx0) ? __fmul_rn(wx0, wy0) : 0.0f;
  t.w01 = (ry0 && rx1) ? __fmul_rn(wx, wy0) : 0.0f;
  t.w10 = (ry1 && rx0) ? __fmul_rn(wx0, wy) : 0.0f;
  t.w11 = (ry1 && rx1) ? __fmul_rn(wx, wy) : 0.0f;
  // clamped as floats first, so that a far coordinate converts safely
  const int y0 = (int)fminf(fmaxf(y0f, -1.0f), (float)H);
  const int x0 = (int)fminf(fmaxf(x0f, -1.0f), (float)W);
  t.y0 = min(max(y0, 0), H - 1);
  t.y1 = min(max(y0 + 1, 0), H - 1);
  t.x0 = min(max(x0, 0), W - 1);
  t.x1 = min(max(x0 + 1, 0), W - 1);
  return t;
}

// 8 neighbouring values from one or two vector loads, and 8 values to 8
// neighbouring elements (p aligned to 16 bytes; each value rounded to
// nearest even at bf16): the channel vectors of K1's channels_last zero
// padding and of the DCN's column gather.
__device__ __forceinline__ void load8(const float* p, float* v) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* v) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float2 f = __bfloat1622float2(h[q]);
    v[2 * q] = f.x;
    v[2 * q + 1] = f.y;
  }
}
__device__ __forceinline__ void store8(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(v[4], v[5], v[6], v[7]);
}
__device__ __forceinline__ void store8(__nv_bfloat16* p, const float* v) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    h[q] = __floats2bfloat162_rn(v[2 * q], v[2 * q + 1]);
  }
  *reinterpret_cast<uint4*>(p) = u;
}

// The row tiles of the gathers K1, K2, K4 and K5: a block of kTileRows
// warps, one output row each; lane l of a warp takes the kTileSteps pixels
// 32 output columns apart at tile column l, 32 + l, ..., so each warp-wide
// load or store covers 32 neighbouring columns. The grid is (column tiles,
// row tiles, images), and a thread decodes its pixels from blockIdx and
// threadIdx without a division. ops/warp_cuda.py::tile_plan mirrors it. The
// scatter K3 takes the same tiles with one pixel a lane.
constexpr int kTileRows = 4;
constexpr int kTileSteps = 2;

// The arguments of every C entry point arrive packed in one int64 array
// (one ctypes conversion per call instead of one per argument).
template <typename T>
__host__ __forceinline__ T* arg_ptr(const int64_t* a, int k) {
  return reinterpret_cast<T*>(static_cast<intptr_t>(a[k]));
}

}  // namespace tecogan
