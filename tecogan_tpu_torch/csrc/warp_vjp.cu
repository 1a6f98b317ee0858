// K3 and K4: the adjoints of the bilinear backward warp (K2), the backward
// of every training warp, for Hopper (sm_90a).
//
// Replace the TPU kernels tecogan_tpu/ops/warp_vjp.py::_dimage (body
// _dimage_kernel) and ::_dflow (body _dflow_kernel). Both use K2's stencil
// (warp_common.cuh): fp32 coordinates clamped then floored, second taps
// clamped to H-1 / W-1.
//
// K3, the adjoint with respect to the image:
//     dx[b, ch, s] = sum over output pixels p of (g[b, ch, p] * w_y) * w_x
// over the four taps s of p (fp32 products, round to nearest, no FMA).
// The TPU kernel avoids a scatter (the TPU cannot vectorise one) by
// enumerating displacements into a whole-image VMEM block, a sequential
// and so deterministic sum. Hopper scatters with atomics, whose order
// changes from run to run; here they add exact integers, so the order no
// longer matters:
// - fixed point: one power-of-two scale a call, 2^k with
//     k = 62 - e(M) - ceil(log2(H * W)),
//   where M = max |g| over the call and e(M) its frexp exponent
//   (M < 2^e(M)). Every output pixel's four weights sum to 1, so every
//   source sum is below M * H * W <= 2^62 after scaling: no int64 sum can
//   overflow. Each fp32 product is scaled exactly (in double), rounded to
//   int64 half to even and added with a 64-bit integer atomicAdd (two's
//   complement). At the end each sum goes (double) sum * 2^-k -> fp32 ->
//   the image's dtype, each step rounding to nearest. Error: at most
//   2^-(k+1) a product (below 2^-60 * M * H * W), then the conversions, so
//   the fp32 result is the correctly rounded sum of the fp32 products to
//   within that; bit-identical run to run, and to the plain version
//   (ops/warp_vjp.py::warp_dimage_reference) on any device;
// - a non-finite g (the bits of max |g| >= 0x7f800000, inf or NaN) takes
//   an fp32 branch for that call: fp32 atomics into the same scratch, so
//   the non-finite outputs are the fp32 plain version's (a tap whose
//   weight is 0 gets 0 * inf = NaN in both), the finite ones may differ
//   in rounding;
// - one cooperative launch (cudaLaunchCooperativeKernel, the grid capped at
//   the blocks that fit on the card at once, grid-stride loops) in three
//   phases split by grid barriers: (1) zero the int64 scratch and reduce
//   max |g| (each block writes its maximum to a slot of its own; unsigned
//   max over the bits of |g| is exact and order-free, non-negative floats
//   order as integers); (2) every block reads the slots for k, then
//   scatters; (3) convert, writing the output once in the image's dtype.
//   No fill and no cast beside it, and it allocates nothing: the wrapper
//   passes the scratch (one int64 per output element and one slot per
//   block) from torch.empty;
// - the tiles are K1/K2's rows (warp_common.cuh) with one pixel a lane:
//   blocks of kTileRows warps, each warp on 32 neighbouring pixels of one
//   row, walked by grid-stride loops over (column tiles, row tiles, images)
//   with no division; the RGB channel count a template parameter (other
//   counts loop); 32-bit offsets from one image base (the wrapper checks
//   the largest). When the grid holds every tile (the training shapes), a
//   thread reads its flow and cotangent before the first barrier and keeps
//   them for the scatter; else it reads them again;
// - fewer atomics: in each tap row, a lane whose left tap is its left
//   neighbour's right tap (a smooth flow, the paths' case) adds the
//   neighbour's integer term to its own, and the neighbour skips its atomic;
//   integer addition, so the same sums.
// Measured (PERF.md, section 6): the two barriers cost about 1.5 us,
// the launch, fill, max and convert about 3.9 us, and the scatter the rest.
// Bound: bytes (g and the flow read, the output written once; 0.52 MB and
// 0.157 us at the training warp (2, 3, 128, 128) bf16 on the H100's
// 3.35 TB/s), far below the launch and the two grid barriers.
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

#include <cooperative_groups.h>

#include <algorithm>

#include "warp_common.cuh"

namespace {

using namespace tecogan;
namespace cg = cooperative_groups;

// K3's blocks: kTileRows warps, each on 32 neighbouring pixels of one row
constexpr int kBlock = 32 * kTileRows;
// elements a thread converts with its loads in flight together
constexpr int kUnroll = 4;
constexpr int kMaxDevices = 64;
constexpr unsigned kFull = 0xffffffffu;

// Call fn(b, i, j) for this thread's pixel in every 32 x kTileRows tile its
// block takes: grid-stride loops over (column tiles, row tiles, images), no
// division. A warp's lanes stay together (a row past H skips the warp).
template <typename Fn>
__device__ __forceinline__ void for_each_tile(int n, int H, int W, Fn fn) {
  const int tiles_x = (W + 31) / 32;
  const int tiles_y = (H + kTileRows - 1) / kTileRows;
  for (int b = blockIdx.z; b < n; b += gridDim.z) {
    for (int ty = blockIdx.y; ty < tiles_y; ty += gridDim.y) {
      const int i = ty * kTileRows + threadIdx.y;
      if (i >= H) continue;
      for (int tx = blockIdx.x; tx < tiles_x; tx += gridDim.x) {
        fn(b, i, tx * 32 + threadIdx.x);
      }
    }
  }
}

// The maximum of v over the block; every thread gets it.
__device__ __forceinline__ unsigned block_max(unsigned v, unsigned* red) {
  v = __reduce_max_sync(kFull, v);
  if (threadIdx.x == 0) red[threadIdx.y] = v;
  __syncthreads();
  unsigned m = red[0];
#pragma unroll
  for (int w = 1; w < kTileRows; ++w) m = max(m, red[w]);
  __syncthreads();  // red is reused
  return m;
}

// One thread's output pixel (b, i, j) of K3, G channels from ch0: what it
// reads (the flow and the cotangent; a column past W reads column W-1 and
// adds nothing), and its scatter.
template <int G, typename TG, typename TF>
struct Pixel {
  float fx, fy, gv[G];

  __device__ __forceinline__ void load(const TG* __restrict__ g,
                                       const TF* __restrict__ flow,
                                       const Strides4& gs, const Strides4& fs,
                                       int b, int i, int j, int W, int ch0) {
    const int jc = min(j, W - 1);
    const TF* f = flow + b * fs.s0 + i * fs.s1;
    fx = load_f32(f + jc * (int)fs.s2);
    fy = load_f32(f + (jc * (int)fs.s2 + (int)fs.s3));
    const TG* gp = g + b * gs.s0;
    const int o = i * (int)gs.s2 + jc * (int)gs.s3;
#pragma unroll
    for (int q = 0; q < G; ++q) {
      gv[q] = load_f32(gp + ((ch0 + q) * (int)gs.s1 + o));
    }
  }

  // the largest bits of |g| (unsigned order is float order for |g|)
  __device__ __forceinline__ unsigned max_bits() const {
    unsigned m = 0;
#pragma unroll
    for (int q = 0; q < G; ++q) {
      m = max(m, __float_as_uint(gv[q]) & 0x7fffffffu);
    }
    return m;
  }

  // Add (g * w_y) * w_x into the four taps: kFixed, as integers at scale
  // 2^k (``scale``), where a lane whose left tap is its left neighbour's
  // right tap adds the neighbour's term to its own (integer addition, so
  // the sum is the same); else fp32 atomics into the scratch viewed as
  // floats. Every lane of the warp calls it (shuffles).
  template <bool kFixed>
  __device__ __forceinline__ void add(long long* __restrict__ sums,
                                      const Strides4& os, int b, int i, int j,
                                      int H, int W, int ch0,
                                      double scale) const {
    const bool live = j < W;
    const Taps t = taps_of(fx, fy, i, min(j, W - 1), H, W);
    const float wy0 = __fsub_rn(1.0f, t.wy);
    const float wx0 = __fsub_rn(1.0f, t.wx);
    const int o2 = (int)os.s2, o3 = (int)os.s3;
    // taps: top left, top right, bottom left, bottom right
    const int o[4] = {t.y0 * o2 + t.x0 * o3, t.y0 * o2 + t.x1 * o3,
                      t.y1 * o2 + t.x0 * o3, t.y1 * o2 + t.x1 * o3};
    // in each tap row, take the left neighbour's right term where it lies
    // on this lane's left tap; the neighbour then gives it up
    bool take[2] = {false, false}, give[2] = {false, false};
    if (kFixed) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int right = __shfl_up_sync(kFull, o[2 * r + 1], 1);
        take[r] = live && threadIdx.x > 0 && right == o[2 * r];
        give[r] = __shfl_down_sync(kFull, take[r], 1) && threadIdx.x < 31;
      }
    }
    const int64_t image = b * os.s0;
#pragma unroll
    for (int q = 0; q < G; ++q) {
      // (g * w_y) * w_x, the TPU kernel's order
      const float gy0 = __fmul_rn(gv[q], wy0);
      const float gy1 = __fmul_rn(gv[q], t.wy);
      const float p[4] = {__fmul_rn(gy0, wx0), __fmul_rn(gy0, t.wx),
                          __fmul_rn(gy1, wx0), __fmul_rn(gy1, t.wx)};
      const int64_t base = image + (ch0 + q) * (int)os.s1;
      if (kFixed) {
        long long v[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          // exact: a power-of-two scaling of an fp32 value in double
          v[r] = live ? __double2ll_rn((double)p[r] * scale) : 0;
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const long long right = __shfl_up_sync(kFull, v[2 * r + 1], 1);
          if (take[r]) v[2 * r] += right;
        }
        unsigned long long* s =
            reinterpret_cast<unsigned long long*>(sums) + base;
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          if (live && !(r & 1 && give[r >> 1])) {
            atomicAdd(s + o[r], (unsigned long long)v[r]);
          }
        }
      } else if (live) {
        float* s = reinterpret_cast<float*>(sums) + base;
#pragma unroll
        for (int r = 0; r < 4; ++r) atomicAdd(s + o[r], p[r]);
      }
    }
  }
};

// K3 in one cooperative launch. sums holds n*c*H*W int64 words laid out by
// the output's strides (dense), then one 32-bit slot per block.
template <typename TG, typename TF, typename TO, int C>
__global__ void __launch_bounds__(kBlock)
    warp_dimage_kernel(const TG* __restrict__ g, const TF* __restrict__ flow,
                       TO* __restrict__ out, long long* __restrict__ sums,
                       int n, int c, int H, int W, Strides4 gs, Strides4 os,
                       Strides4 fs) {
  constexpr int G = C > 0 ? C : 1;
  __shared__ unsigned red[kTileRows];
  cg::grid_group grid = cg::this_grid();
  const int64_t numel = (int64_t)n * c * H * W;
  unsigned* slots = reinterpret_cast<unsigned*>(sums + numel);
  const int nblocks = gridDim.x * gridDim.y * gridDim.z;
  const int block = (blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x +
                    blockIdx.x;
  const int tid = threadIdx.y * 32 + threadIdx.x;
  const int64_t first = (int64_t)block * kBlock + tid;
  const int64_t step = (int64_t)nblocks * kBlock;
  // one tile a block (the RGB kernel at the training shapes): its reads
  // are made before the first barrier and kept for the scatter
  const int i1 = blockIdx.y * kTileRows + threadIdx.y;
  const int j1 = blockIdx.x * 32 + threadIdx.x;
  const bool one_pass = C > 0 && gridDim.x * 32 >= W &&
                        gridDim.y * kTileRows >= H && gridDim.z >= n;
  const bool mine = one_pass && i1 < H && blockIdx.x * 32 < W;

  // phase 1: zero the sums; this block's max over the bits of |g|
  for (int64_t e = first; e < numel; e += step) sums[e] = 0;
  unsigned m = 0;
  Pixel<G, TG, TF> px;
  if (one_pass) {
    if (mine) {
      px.load(g, flow, gs, fs, blockIdx.z, i1, j1, W, 0);
      m = px.max_bits();
    }
  } else {
    for_each_tile(n, H, W, [&](int b, int i, int j) {
      for (int ch0 = 0; ch0 < (C > 0 ? C : c); ch0 += G) {
        Pixel<G, TG, TF> p;
        p.load(g, flow, gs, fs, b, i, j, W, ch0);
        m = max(m, p.max_bits());
      }
    });
  }
  m = block_max(m, red);
  if (tid == 0) slots[block] = m;
  grid.sync();

  // phase 2: the call's max |g| and scale, then the scatter
  m = 0;
  for (int s = tid; s < nblocks; s += kBlock) m = max(m, slots[s]);
  m = block_max(m, red);
  const bool fixed = m < 0x7f800000u;
  // frexp's exponent of M from its bits (normal, subnormal, 0 -> 0)
  const int e_m = m >= 0x00800000u ? (int)(m >> 23) - 126
                  : m              ? (32 - __clz(m)) - 149
                                   : 0;
  const int e_hw = 32 - __clz(H * W - 1);  // ceil(log2(H * W))
  const int k = 62 - e_m - e_hw;
  const double scale = ldexp(1.0, k);
  auto scatter = [&](const Pixel<G, TG, TF>& p, int b, int i, int j,
                     int ch0) {
    if (fixed) {
      p.template add<true>(sums, os, b, i, j, H, W, ch0, scale);
    } else {
      p.template add<false>(sums, os, b, i, j, H, W, ch0, scale);
    }
  };
  if (one_pass) {
    if (mine) scatter(px, blockIdx.z, i1, j1, 0);
  } else {
    for_each_tile(n, H, W, [&](int b, int i, int j) {
      for (int ch0 = 0; ch0 < (C > 0 ? C : c); ch0 += G) {
        Pixel<G, TG, TF> p;
        p.load(g, flow, gs, fs, b, i, j, W, ch0);
        scatter(p, b, i, j, ch0);
      }
    });
  }
  grid.sync();

  // phase 3: (double) sum * 2^-k -> fp32 -> the output's dtype
  if (fixed) {
    const double inv = ldexp(1.0, -k);
    for (int64_t e0 = first; e0 < numel; e0 += kUnroll * step) {
      long long v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        v[u] = e0 + u * step < numel ? sums[e0 + u * step] : 0;
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (e0 + u * step < numel) {
          store_f32(out + (e0 + u * step),
                    __double2float_rn(__ll2double_rn(v[u]) * inv));
        }
      }
    }
  } else {
    const float* fsums = reinterpret_cast<const float*>(sums);
    for (int64_t e = first; e < numel; e += step) store_f32(out + e, fsums[e]);
  }
}

template <typename TG, typename TF, typename TO, int C>
int run_dimage(const TG* g, const TF* flow, TO* out, long long* sums, int n,
               int c, int H, int W, int slots, Strides4 gs, Strides4 os,
               Strides4 fs, cudaStream_t stream) {
  auto kernel = warp_dimage_kernel<TG, TF, TO, C>;
  // the blocks that fit on the device at once, from the occupancy query,
  // cached per instantiation and device
  static int resident[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (!resident[dev]) {
    int per_sm = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kBlock, 0);
    if (err == cudaSuccess) {
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    }
    if (err != cudaSuccess) return (int)err;
    resident[dev] = per_sm * sms;
  }
  const int cap = min(resident[dev], slots);
  if (cap < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  // (column tiles, row tiles, images), capped in that order of priority;
  // more row blocks where the tiles are fewer than the blocks that convert
  // kUnroll elements a thread; ops/warp_cuda.py::stride_grid mirrors it
  const int64_t numel = (int64_t)n * c * H * W;
  const int64_t convert = (numel + kUnroll * kBlock - 1) / (kUnroll * kBlock);
  dim3 grid;
  grid.x = min((W + 31) / 32, cap);
  grid.z = min(n, cap / (int)grid.x);
  const int xz = (int)(grid.x * grid.z);
  grid.y = (int)std::min<int64_t>(
      std::max<int64_t>((H + kTileRows - 1) / kTileRows,
                        (convert + xz - 1) / xz),
      cap / xz);
  void* args[] = {&g, &flow, &out, &sums, &n, &c, &H, &W, &gs, &os, &fs};
  return (int)cudaLaunchCooperativeKernel((const void*)kernel, grid,
                                          dim3(32, kTileRows), args, 0,
                                          stream);
}

// K3: (g, flow, out, scratch, n, c, H, W, slots, g's, the output's and the
// flow's strides, stream)
template <typename TG, typename TF, typename TO>
int launch_dimage(const int64_t* a) {
  const int n = (int)a[4], c = (int)a[5], H = (int)a[6], W = (int)a[7];
  if ((int64_t)n * c * H * W == 0) return 0;
  const Strides4 gs = strides_from(a + 9), os = strides_from(a + 13),
                 fs = strides_from(a + 17);
  cudaStream_t stream = arg_ptr<CUstream_st>(a, 21);
  const TG* g = arg_ptr<const TG>(a, 0);
  const TF* flow = arg_ptr<const TF>(a, 1);
  TO* out = arg_ptr<TO>(a, 2);
  long long* sums = arg_ptr<long long>(a, 3);
  const int slots = (int)a[8];
  return c == 3 ? run_dimage<TG, TF, TO, 3>(g, flow, out, sums, n, c, H, W,
                                            slots, gs, os, fs, stream)
                : run_dimage<TG, TF, TO, 0>(g, flow, out, sums, n, c, H, W,
                                            slots, gs, os, fs, stream);
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

template <typename TX, typename TF>
int launch_dflow(const int64_t* a) {
  const int n = (int)a[4], c = (int)a[5], H = (int)a[6], W = (int)a[7];
  if ((int64_t)n * H * W == 0) return 0;
  warp_dflow_kernel<TX, TF><<<blocks_for(n, H, W), kThreads, 0,
                              arg_ptr<CUstream_st>(a, 20)>>>(
      arg_ptr<const TX>(a, 0), arg_ptr<const TX>(a, 1),
      arg_ptr<const TF>(a, 2), arg_ptr<float>(a, 3), n, c, H, W,
      strides_from(a + 8), strides_from(a + 12), strides_from(a + 16));
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points, each taking one int64 array and returning the
// launch's CUDA error code. K3, one per (cotangent dtype, flow dtype,
// output dtype): (g, flow, out, scratch, n, c, H, W, slots, 12 element
// strides: g's and the output's in (n, c, H, W) order, then the flow's in
// (n, H, W, 2) order, stream); the output is dense (any order of its
// dimensions), the scratch int64 of n*c*H*W + slots words, and slots at
// least the blocks of the launch (the card's SMs times 2048 / kBlock
// always suffice). K4, one per (image/cotangent dtype, flow dtype): (g, x,
// flow, out, n, c, H, W, g's, x's and the flow's strides, stream); the
// output is a contiguous fp32 (n, H, W, 2).
#define TECOGAN_DIMAGE_ENTRY(NAME, TG, TF, TO) \
  extern "C" int NAME(const int64_t* args) {  \
    return launch_dimage<TG, TF, TO>(args);    \
  }
#define TECOGAN_DFLOW_ENTRY(NAME, TX, TF)     \
  extern "C" int NAME(const int64_t* args) { \
    return launch_dflow<TX, TF>(args);       \
  }

using bf16 = __nv_bfloat16;
TECOGAN_DIMAGE_ENTRY(tecogan_warp_dimage_f32_f32_f32, float, float, float)
TECOGAN_DIMAGE_ENTRY(tecogan_warp_dimage_f32_f32_bf16, float, float, bf16)
TECOGAN_DIMAGE_ENTRY(tecogan_warp_dimage_f32_bf16_f32, float, bf16, float)
TECOGAN_DIMAGE_ENTRY(tecogan_warp_dimage_f32_bf16_bf16, float, bf16, bf16)
TECOGAN_DIMAGE_ENTRY(tecogan_warp_dimage_bf16_f32_f32, bf16, float, float)
TECOGAN_DIMAGE_ENTRY(tecogan_warp_dimage_bf16_f32_bf16, bf16, float, bf16)
TECOGAN_DIMAGE_ENTRY(tecogan_warp_dimage_bf16_bf16_f32, bf16, bf16, float)
TECOGAN_DIMAGE_ENTRY(tecogan_warp_dimage_bf16_bf16_bf16, bf16, bf16, bf16)
TECOGAN_DFLOW_ENTRY(tecogan_warp_dflow_f32_f32, float, float)
TECOGAN_DFLOW_ENTRY(tecogan_warp_dflow_f32_bf16, float, bf16)
TECOGAN_DFLOW_ENTRY(tecogan_warp_dflow_bf16_f32, bf16, float)
TECOGAN_DFLOW_ENTRY(tecogan_warp_dflow_bf16_bf16, bf16, bf16)
