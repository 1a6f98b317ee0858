// The column gather of the modulated deformable convolution (DCNv2) in
// BasicVSR++'s second-order deformable alignment, for Hopper (sm_90a).
//
// It replaces no TPU kernel: the JAX package has no BasicVSR++. mmcv's
// modulated_deform_conv2d (3x3, padding 1, stride 1, dilation 1, G
// deformable groups) is, per output pixel (b, i, j), the sum over input
// channels c and taps k = 3 ky + kx of
//     weight[o, c, ky, kx] * mask[b, g k, i, j] *
//     x[b, c] sampled at (i - 1 + ky + dy, j - 1 + kx + dx)
// with g = c / (C / G), zero padding and bilinear taps (warp_common.cuh,
// zero_taps). BasicVSR++ computes the offsets and the mask from
// conv_offset's raw 27 G channels and the two flows it aligns along:
//     dy = mag * tanh(raw[2 (g 9 + k)]) + flow_g[1]
//     dx = mag * tanh(raw[2 (g 9 + k) + 1]) + flow_g[0]
//     mask = sigmoid(raw[18 G + g 9 + k])
// where flow_g is the first flow for the first G/2 groups (the carried
// feature) and the second for the rest (the feature two frames back): the
// flows' flip(1) and repeat in mmagic's SecondOrderDeformableAlignment.
// That epilogue is fused here, so the offsets and the mask are never
// written: they are computed in fp32 from raw's dtype and the fp32 flows.
//
// The kernel writes the columns col[(b, i, j), k C + c], each value
// sampled in fp32 and multiplied by its mask, in the features' dtype; the
// wrapper (ops/dcn.py) multiplies them by the weight as one cuBLAS product,
// (pixels, 9 C) x (9 C, O), whose output is the channels_last feature map
// with no copy. The column order (tap, then channel) is the channels_last
// weight's own order, so the weight needs no copy either.
//
// Bound: bytes. At bf16 a pixel of BasicVSR++ reads 128 feature and 432
// raw channels and 4 fp32 flow values and writes 64 channels: 1264 B, 72.8
// MB a 180x320 frame (21.7 us at 3.35 TB/s); the product's 2 * 1152 * 64
// FLOPs a pixel take 8.6 us at 989 TFLOP/s. The columns' round trip
// through memory (2304 B a pixel written and read again) is this design's
// cost over that bound; an implicit GEMM that keeps them on chip is the
// next step.
//
// Design: one thread per (pixel, tap, group), the group fastest, so the 8
// channels of a group are one 16-byte store at bf16 and a warp's stores
// cover 512 neighbouring bytes of the columns. Each thread reads its three
// raw channels and its flow, computes its sample point and four tap
// weights once, and gathers its group's 8 channels at each corner: one
// 16-byte load per corner where the channels are contiguous
// (channels_last, kVec), else 8 strided loads. Indices are 32-bit (the
// wrapper checks the count); sums and products use the round-to-nearest
// intrinsics so nothing is contracted, in the plain version's order
// (ops/dcn.py::dcn_columns_reference). tanhf and expf are CUDA's, so the
// plain version matches within a few ulps, not bit for bit.

#include <cstring>

#include "warp_common.cuh"

namespace {

using namespace tecogan;

constexpr int kTaps = 9;    // the 3x3 kernel's taps
constexpr int kGroupC = 8;  // channels of one deformable group
constexpr int kBlock = 256;

struct Geometry {
  int n, C, H, W, G;
  float mag;  // max_residue_magnitude
};

template <typename TX, bool kVec>
__global__ void __launch_bounds__(kBlock)
    dcn_columns_kernel(const TX* __restrict__ x, const TX* __restrict__ raw,
                       const float* __restrict__ f1,
                       const float* __restrict__ f2, TX* __restrict__ col,
                       Geometry geo, Strides4 xs, Strides4 rs, Strides4 f1s,
                       Strides4 f2s) {
  const int G = geo.G;
  const int t = blockIdx.x * kBlock + threadIdx.x;
  if (t >= geo.n * geo.H * geo.W * kTaps * G) return;
  const int g = t % G;
  const int r = t / G;
  const int k = r % kTaps;
  const int p = r / kTaps;  // the pixel (b, i, j)
  const int j = p % geo.W;
  const int q = p / geo.W;
  const int i = q % geo.H;
  const int b = q / geo.H;

  // the fused epilogue of conv_offset: offsets and mask in fp32
  const int gk = g * kTaps + k;
  const TX* rp = raw + b * rs.s0 + i * rs.s2 + j * rs.s3;
  const float oy = load_f32(rp + (2 * gk) * rs.s1);
  const float ox = load_f32(rp + (2 * gk + 1) * rs.s1);
  const float om = load_f32(rp + (2 * kTaps * G + gk) * rs.s1);
  const bool first = g < G / 2;
  const Strides4 fs = first ? f1s : f2s;
  const float* fp = (first ? f1 : f2) + b * fs.s0 + i * fs.s2 + j * fs.s3;
  const float fx = fp[0];
  const float fy = fp[fs.s1];
  const float dy = __fadd_rn(__fmul_rn(geo.mag, tanhf(oy)), fy);
  const float dx = __fadd_rn(__fmul_rn(geo.mag, tanhf(ox)), fx);
  const float m = __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-om)));
  const int ky = k / 3;
  const int kx = k - 3 * ky;
  const ZeroTaps z = zero_taps(__fadd_rn((float)(i - 1 + ky), dy),
                               __fadd_rn((float)(j - 1 + kx), dx), geo.H,
                               geo.W);

  const TX* xb = x + b * xs.s0 + (g * kGroupC) * xs.s1;
  const int64_t o[4] = {z.y0 * xs.s2 + z.x0 * xs.s3,
                        z.y0 * xs.s2 + z.x1 * xs.s3,
                        z.y1 * xs.s2 + z.x0 * xs.s3,
                        z.y1 * xs.s2 + z.x1 * xs.s3};
  float v[4][kGroupC];
  if constexpr (kVec) {
#pragma unroll
    for (int c4 = 0; c4 < 4; ++c4) load8(xb + o[c4], v[c4]);
  } else {
#pragma unroll
    for (int c4 = 0; c4 < 4; ++c4) {
#pragma unroll
      for (int c = 0; c < kGroupC; ++c) {
        v[c4][c] = load_f32(xb + (c * xs.s1 + o[c4]));
      }
    }
  }
  TX* dst = col + (int64_t)p * (kTaps * geo.C) + k * geo.C + g * kGroupC;
  float out[kGroupC];
#pragma unroll
  for (int c = 0; c < kGroupC; ++c) {
    const float top = __fadd_rn(__fmul_rn(z.w00, v[0][c]),
                                __fmul_rn(z.w01, v[1][c]));
    const float bot = __fadd_rn(__fmul_rn(z.w10, v[2][c]),
                                __fmul_rn(z.w11, v[3][c]));
    out[c] = __fmul_rn(__fadd_rn(top, bot), m);
  }
  store8(dst, out);
}

// (x, raw, flow1, flow2, col, n, C, H, W, G, the magnitude's fp32 bits,
// vec, x's, raw's, flow1's and flow2's element strides in (n, c, H, W)
// order, stream)
template <typename TX>
int launch_columns(const int64_t* a) {
  Geometry geo{(int)a[5], (int)a[6], (int)a[7], (int)a[8], (int)a[9], 0.0f};
  const uint32_t bits = (uint32_t)a[10];
  std::memcpy(&geo.mag, &bits, sizeof(float));
  const int total = geo.n * geo.H * geo.W * kTaps * geo.G;
  if (total == 0) return 0;
  const Strides4 xs = strides_from(a + 12), rs = strides_from(a + 16),
                 f1s = strides_from(a + 20), f2s = strides_from(a + 24);
  const dim3 grid((total + kBlock - 1) / kBlock);
  cudaStream_t stream = arg_ptr<CUstream_st>(a, 28);
  if (a[11]) {
    dcn_columns_kernel<TX, true><<<grid, kBlock, 0, stream>>>(
        arg_ptr<const TX>(a, 0), arg_ptr<const TX>(a, 1),
        arg_ptr<const float>(a, 2), arg_ptr<const float>(a, 3),
        arg_ptr<TX>(a, 4), geo, xs, rs, f1s, f2s);
  } else {
    dcn_columns_kernel<TX, false><<<grid, kBlock, 0, stream>>>(
        arg_ptr<const TX>(a, 0), arg_ptr<const TX>(a, 1),
        arg_ptr<const float>(a, 2), arg_ptr<const float>(a, 3),
        arg_ptr<TX>(a, 4), geo, xs, rs, f1s, f2s);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points, one per feature dtype (raw in the features' dtype,
// the flows fp32), each taking one int64 array (see launch_columns); col
// is contiguous (n H W, 9 C). Each returns cudaGetLastError() after the
// launch.
extern "C" int tecogan_dcn_columns_f32(const int64_t* args) {
  return launch_columns<float>(args);
}
extern "C" int tecogan_dcn_columns_bf16(const int64_t* args) {
  return launch_columns<__nv_bfloat16>(args);
}
