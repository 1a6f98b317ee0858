// The epilogue of a bf16 inference convolution, for Hopper (sm_90a): the
// bias, the activation and a residual in one pass over the convolution's
// output.
//
// It replaces no TPU kernel: on the TPU XLA fuses a convolution's bias,
// activation and residual into the convolution itself. On the card PyTorch
// runs cuDNN without the bias and then adds it in a pass of its own
// (output.add_(bias.view(1, C, 1, 1))), which on a channels_last output is
// a broadcast TensorIterator cannot vectorise; the ReLU or LeakyReLU and the
// residual add are one more pass each. This kernel is those passes in one:
// for the bias-free bf16 output y (n, C, H, W) of a convolution, the bias b
// (C,), an activation and an optional residual r of y's shape,
//     t = bf16(float(y) + float(b))
//     a = bf16(act(float(t)))       (ReLU: exact; LeakyReLU: t > 0 ? t :
//                                     t * slope in fp32, one rounding)
//     out = bf16(float(a) + float(r))
// rounded where PyTorch's unfused chain rounds (its bf16 ops compute in
// fp32 and round each result), so the output is bit-identical to that
// chain's and to the plain version (ops/conv_epilogue.py).
//
// Bound: bytes. y is read once, r once where there is one, the bias once
// per thread from the cache, and out written once: 4 or 6 bytes a value at
// 3.35 TB/s. There is no arithmetic to speak of, so the design is about
// moving those bytes in wide, coalesced transactions:
// - the vector path (C a multiple of 8, y, r and out dense channels_last,
//   16-byte aligned): one thread per 8 channels of a pixel, one 16-byte
//   load of y, of r and of the bias's 8 values and one 16-byte store, the
//   channel groups fastest, so a warp covers 512 neighbouring bytes;
// - the scalar path (any other width or layout: a flow head's 2 channels,
//   conv_out's 3, whose residual and output are contiguous NCHW): one
//   thread per pixel looping over the channels through element strides,
//   so a warp's 32 pixels are neighbours in every plane of an NCHW tensor.
// Sums and products use the round-to-nearest intrinsics so nothing is
// contracted into an FMA.

#include <cstring>

#include "warp_common.cuh"

namespace {

using namespace tecogan;

constexpr int kBlock = 256;
constexpr int kVec = 8;  // channels of one 16-byte vector at bf16

enum Act { kNone = 0, kRelu = 1, kLeaky = 2 };

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// The epilogue of one value: y and b as read, r the residual (ignored
// without kRes). Returns the fp32 value whose bf16 rounding is stored.
template <int kAct, bool kRes>
__device__ __forceinline__ float epilogue(float y, float b, float r,
                                          float slope) {
  float v = round_bf16(__fadd_rn(y, b));
  if constexpr (kAct == kRelu) {
    v = isnan(v) ? v : fmaxf(v, 0.0f);  // PyTorch's clamp_min(v, 0)
  } else if constexpr (kAct == kLeaky) {
    v = v > 0.0f ? v : round_bf16(__fmul_rn(v, slope));
  }
  if constexpr (kRes) v = __fadd_rn(v, r);
  return v;
}

struct Geometry {
  int n, C, H, W;
  float slope;
};

template <int kAct, bool kRes>
__global__ void __launch_bounds__(kBlock)
    epilogue_vec_kernel(const __nv_bfloat16* __restrict__ y,
                        const __nv_bfloat16* __restrict__ bias,
                        const __nv_bfloat16* __restrict__ res,
                        __nv_bfloat16* __restrict__ out, Geometry geo,
                        int vectors) {
  const int t = blockIdx.x * kBlock + threadIdx.x;
  if (t >= vectors) return;
  const int groups = geo.C / kVec;
  const int64_t off = (int64_t)t * kVec;  // dense NHWC: pixel, then channel
  const int c0 = (t % groups) * kVec;
  float v[kVec], b[kVec], r[kVec];
  load8(y + off, v);
  load8(bias + c0, b);
  if constexpr (kRes) load8(res + off, r);
#pragma unroll
  for (int c = 0; c < kVec; ++c) {
    v[c] = epilogue<kAct, kRes>(v[c], b[c], kRes ? r[c] : 0.0f, geo.slope);
  }
  store8(out + off, v);
}

template <int kAct, bool kRes>
__global__ void __launch_bounds__(kBlock)
    epilogue_scalar_kernel(const __nv_bfloat16* __restrict__ y,
                           const __nv_bfloat16* __restrict__ bias,
                           const __nv_bfloat16* __restrict__ res,
                           __nv_bfloat16* __restrict__ out, Geometry geo,
                           Strides4 ys, Strides4 rs, Strides4 os) {
  const int p = blockIdx.x * kBlock + threadIdx.x;  // the pixel (n, i, j)
  if (p >= geo.n * geo.H * geo.W) return;
  const int j = p % geo.W;
  const int q = p / geo.W;
  const int i = q % geo.H;
  const int b = q / geo.H;
  const __nv_bfloat16* yp = y + b * ys.s0 + i * ys.s2 + j * ys.s3;
  const __nv_bfloat16* rp = res + (kRes ? b * rs.s0 + i * rs.s2 + j * rs.s3
                                        : 0);
  __nv_bfloat16* op = out + b * os.s0 + i * os.s2 + j * os.s3;
  for (int c = 0; c < geo.C; ++c) {
    const float r = kRes ? load_f32(rp + c * rs.s1) : 0.0f;
    store_f32(op + c * os.s1,
              epilogue<kAct, kRes>(load_f32(yp + c * ys.s1),
                                   load_f32(bias + c), r, geo.slope));
  }
}

template <int kAct, bool kRes>
void launch_one(const int64_t* a, const Geometry& geo, cudaStream_t stream) {
  const auto* y = arg_ptr<const __nv_bfloat16>(a, 0);
  const auto* bias = arg_ptr<const __nv_bfloat16>(a, 1);
  const auto* res = arg_ptr<const __nv_bfloat16>(a, 2);
  auto* out = arg_ptr<__nv_bfloat16>(a, 3);
  if (a[11]) {
    const int vectors = geo.n * geo.H * geo.W * (geo.C / kVec);
    epilogue_vec_kernel<kAct, kRes>
        <<<(vectors + kBlock - 1) / kBlock, kBlock, 0, stream>>>(
            y, bias, res, out, geo, vectors);
  } else {
    const int pixels = geo.n * geo.H * geo.W;
    epilogue_scalar_kernel<kAct, kRes>
        <<<(pixels + kBlock - 1) / kBlock, kBlock, 0, stream>>>(
            y, bias, res, out, geo, strides_from(a + 12),
            strides_from(a + 16), strides_from(a + 20));
  }
}

template <int kAct>
void launch_act(const int64_t* a, const Geometry& geo, cudaStream_t stream) {
  if (a[10]) {
    launch_one<kAct, true>(a, geo, stream);
  } else {
    launch_one<kAct, false>(a, geo, stream);
  }
}

}  // namespace

// (y, bias, residual or 0, out, n, C, H, W, act (0 none, 1 ReLU, 2
// LeakyReLU), the slope's fp32 bits, whether there is a residual, vec, y's,
// the residual's and out's element strides in (n, c, H, W) order, stream);
// all bf16. Returns cudaGetLastError() after the launch.
extern "C" int tecogan_conv_epilogue_bf16(const int64_t* a) {
  Geometry geo{(int)a[4], (int)a[5], (int)a[6], (int)a[7], 0.0f};
  const uint32_t bits = (uint32_t)a[9];
  std::memcpy(&geo.slope, &bits, sizeof(float));
  if ((int64_t)geo.n * geo.H * geo.W * geo.C == 0) return 0;
  cudaStream_t stream = arg_ptr<CUstream_st>(a, 24);
  switch (a[8]) {
    case kRelu:
      launch_act<kRelu>(a, geo, stream);
      break;
    case kLeaky:
      launch_act<kLeaky>(a, geo, stream);
      break;
    default:
      launch_act<kNone>(a, geo, stream);
  }
  return (int)cudaGetLastError();
}
