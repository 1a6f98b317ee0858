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
// tap values with the forward's slab enumeration and leaves the sum over
// channels to XLA; here a thread reads a pixel's taps directly and applies
// warp_vjp.py's formula
//     dfx = g * m_x * ((1-wy)(A01-A00) + wy(A11-A10))
//     dfy = g * m_y * ((1-wx)(A10-A00) + wx(A11-A01))
// with m_x = (j + fx >= 0), m_y = (i + fy >= 0): below 0 the clamped
// coordinate does not move with the flow; at the upper clamp the taps
// coincide and the difference vanishes by itself. The channels are added in
// order from +0.0 (fp32, no FMA), as the plain version
// (ops/warp_vjp.py::warp_dflow_reference) adds them, so the two agree bit for
// bit, and the output, a dense (n, H, W, 2) in the order dfx, dfy, is
// written once, in the flow's dtype (one pair store a pixel). Deterministic.
// Two forms:
// - inside K3's cooperative launch (the template flag kFlow), whenever both
//   adjoints are wanted: the launch also reads the image x and writes the
//   flow adjoint. When the grid holds every tile, a lane computes it from
//   the flow and g it already holds, before the first barrier, which waits
//   for the slowest block anyway; else phase 1's loop over the tiles, which
//   reads the flow and g, does it. A non-finite g changes only K3's branch:
//   the flow adjoint stays a plain gather. K3's fixed cost (launch, fill,
//   max, barriers, convert) is then paid once for both adjoints;
// - alone, when only the flow needs a gradient (the warping loss warps
//   data), on K1/K2's row tiles: a warp per output row, kTileSteps pixels a
//   lane, no division, the RGB channel count a template parameter (other
//   counts loop), 32-bit offsets from one image base (the wrapper checks
//   the largest); every tap and cotangent load of a lane is issued before
//   the first is used.
// Bound: bytes (g and x read, the flow read and its adjoint written; 0.66 MB
// and 0.196 us at (2, 3, 128, 128) bf16; fused with K3, 0.85 MB and
// 0.254 us), so at the training shapes the launch is the floor.

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

// K4's stencil of one pixel: its taps' offsets within a channel of x (top
// left, top right, bottom left, bottom right), their fractional weights,
// and the masks m_x, m_y (1 where the unclamped coordinate is >= 0).
struct FlowStencil {
  int o[4];
  float wy, wx, mx, my;
};

__device__ __forceinline__ FlowStencil flow_stencil(float fx, float fy,
                                                    int i, int j, int H,
                                                    int W, int x2, int x3) {
  const Taps t = taps_of(fx, fy, i, j, H, W);
  FlowStencil s;
  s.o[0] = t.y0 * x2 + t.x0 * x3;
  s.o[1] = t.y0 * x2 + t.x1 * x3;
  s.o[2] = t.y1 * x2 + t.x0 * x3;
  s.o[3] = t.y1 * x2 + t.x1 * x3;
  s.wy = t.wy;
  s.wx = t.wx;
  s.mx = __fadd_rn((float)j, fx) >= 0.0f ? 1.0f : 0.0f;
  s.my = __fadd_rn((float)i, fy) >= 0.0f ? 1.0f : 0.0f;
  return s;
}

// One pixel's four taps in the G channels of x from ch0: all loaded
// before the first is used, then added into its flow adjoint.
template <int G>
struct FlowTaps {
  float a[G][4];

  template <typename TX>
  __device__ __forceinline__ void load(const TX* __restrict__ src,
                                       const FlowStencil& s, int x1,
                                       int ch0) {
#pragma unroll
    for (int q = 0; q < G; ++q) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        a[q][r] = load_f32(src + ((ch0 + q) * x1 + s.o[r]));
      }
    }
  }

  // add (g * m) * (tap differences) of each channel, in channel order
  __device__ __forceinline__ void add(const FlowStencil& s, const float* gv,
                                      float& dfx, float& dfy) const {
    const float wy0 = __fsub_rn(1.0f, s.wy);
    const float wx0 = __fsub_rn(1.0f, s.wx);
#pragma unroll
    for (int q = 0; q < G; ++q) {
      const float tx =
          __fadd_rn(__fmul_rn(wy0, __fsub_rn(a[q][1], a[q][0])),
                    __fmul_rn(s.wy, __fsub_rn(a[q][3], a[q][2])));
      const float ty =
          __fadd_rn(__fmul_rn(wx0, __fsub_rn(a[q][2], a[q][0])),
                    __fmul_rn(s.wx, __fsub_rn(a[q][3], a[q][1])));
      dfx = __fadd_rn(dfx, __fmul_rn(__fmul_rn(gv[q], s.mx), tx));
      dfy = __fadd_rn(dfy, __fmul_rn(__fmul_rn(gv[q], s.my), ty));
    }
  }
};

// K3 in one cooperative launch, with K4 when kFlow: the body of both
// kernels below. sums holds n*c*H*W int64 words laid out by the output's
// strides (dense), then one 32-bit slot per block. kFlow: the image x
// (strides xs, the output's dtype) is read and the flow adjoint written to
// dflow, a dense (n, H, W, 2) in the flow's dtype; else x and dflow are
// unused.
template <typename TG, typename TF, typename TO, int C, bool kFlow>
__device__ __forceinline__ void dimage_body(
    const TG* __restrict__ g, const TF* __restrict__ flow,
    TO* __restrict__ out, long long* __restrict__ sums,
    const TO* __restrict__ x, TF* __restrict__ dflow, int n, int c, int H,
    int W, const Strides4& gs, const Strides4& os, const Strides4& fs,
    const Strides4& xs) {
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
  // K4 (kFlow): pixel (b, i, j)'s stencil from the flow p holds, its terms
  // for the channels of p (from ch0) from x's taps, and its store
  auto stencil = [&](const Pixel<G, TG, TF>& p, int i, int j) {
    return flow_stencil(p.fx, p.fy, i, min(j, W - 1), H, W, (int)xs.s2,
                        (int)xs.s3);
  };
  auto flow_terms = [&](const Pixel<G, TG, TF>& p, const FlowStencil& st,
                        int b, int ch0, float& dfx, float& dfy) {
    FlowTaps<G> a;
    a.load(x + b * xs.s0, st, (int)xs.s1, ch0);
    a.add(st, p.gv, dfx, dfy);
  };
  auto store_dflow = [&](int b, int i, int j, float dfx, float dfy) {
    if (j < W) {
      store_f32x2(dflow + (((int64_t)b * H + i) * W + j) * 2, dfx, dfy);
    }
  };

  // phase 1: zero the sums; this block's max over the bits of |g|; K4
  for (int64_t e = first; e < numel; e += step) sums[e] = 0;
  unsigned m = 0;
  Pixel<G, TG, TF> px;
  if (one_pass) {
    if (mine) {
      px.load(g, flow, gs, fs, blockIdx.z, i1, j1, W, 0);
      m = px.max_bits();
      if (kFlow) {
        float dfx = 0.0f, dfy = 0.0f;
        flow_terms(px, stencil(px, i1, j1), blockIdx.z, 0, dfx, dfy);
        store_dflow(blockIdx.z, i1, j1, dfx, dfy);
      }
    }
  } else {
    for_each_tile(n, H, W, [&](int b, int i, int j) {
      float dfx = 0.0f, dfy = 0.0f;
      FlowStencil st{};
      for (int ch0 = 0; ch0 < (C > 0 ? C : c); ch0 += G) {
        Pixel<G, TG, TF> p;
        p.load(g, flow, gs, fs, b, i, j, W, ch0);
        m = max(m, p.max_bits());
        if (kFlow) {
          if (ch0 == 0) st = stencil(p, i, j);
          flow_terms(p, st, b, ch0, dfx, dfy);
        }
      }
      if (kFlow) store_dflow(b, i, j, dfx, dfy);
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

// K3 alone
template <typename TG, typename TF, typename TO, int C>
__global__ void __launch_bounds__(kBlock)
    warp_dimage_kernel(const TG* __restrict__ g, const TF* __restrict__ flow,
                       TO* __restrict__ out, long long* __restrict__ sums,
                       int n, int c, int H, int W, Strides4 gs, Strides4 os,
                       Strides4 fs) {
  dimage_body<TG, TF, TO, C, false>(g, flow, out, sums, nullptr, nullptr, n,
                                    c, H, W, gs, os, fs, Strides4{});
}

// K3 and K4 in one launch, the image, the cotangent and the image adjoint
// in one dtype. No __launch_bounds__: with K3's, ptxas held the RGB
// instantiations to 64 registers and spilled; without, its limit for
// blocks of up to 1024 threads is the same 64, and it allocates them
// without a spill (CUDA 12.8; chip_smoke.py prints the build's report).
template <typename TX, typename TF, int C>
__global__ void warp_dimage_dflow_kernel(
    const TX* __restrict__ g, const TF* __restrict__ flow,
    TX* __restrict__ out, long long* __restrict__ sums,
    const TX* __restrict__ x, TF* __restrict__ dflow, int n, int c, int H,
    int W, Strides4 gs, Strides4 os, Strides4 fs, Strides4 xs) {
  dimage_body<TX, TF, TX, C, true>(g, flow, out, sums, x, dflow, n, c, H, W,
                                   gs, os, fs, xs);
}

// The kernel of K3 alone, or of K3 with K4 (kFlow)
template <typename TG, typename TF, typename TO, int C, bool kFlow>
constexpr auto dimage_kernel() {
  if constexpr (kFlow) {
    return warp_dimage_dflow_kernel<TG, TF, C>;
  } else {
    return warp_dimage_kernel<TG, TF, TO, C>;
  }
}

// The blocks of dimage_kernel<TG, TF, TO, C, kFlow> that fit on the
// current device at once, from the occupancy query, cached per
// instantiation and device: the cap of its cooperative grid.
template <typename TG, typename TF, typename TO, int C, bool kFlow>
int resident_blocks(int* blocks) {
  static int resident[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (!resident[dev]) {
    int per_sm = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, dimage_kernel<TG, TF, TO, C, kFlow>(), kBlock, 0);
    if (err == cudaSuccess) {
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    }
    if (err != cudaSuccess) return (int)err;
    resident[dev] = per_sm * sms;
  }
  *blocks = resident[dev];
  return 0;
}

// A launch of K3 as its launcher unpacked it (x, dflow and xs only with the
// flow adjoint)
template <typename TG, typename TF, typename TO>
struct DimageCall {
  const TG* g;
  const TF* flow;
  TO* out;
  long long* sums;
  const TO* x;
  TF* dflow;
  int n, c, H, W, slots;
  Strides4 gs, os, fs, xs;
  cudaStream_t stream;
};

template <typename TG, typename TF, typename TO, int C, bool kFlow>
int run_dimage(DimageCall<TG, TF, TO> k) {
  int resident = 0;
  const int err = resident_blocks<TG, TF, TO, C, kFlow>(&resident);
  if (err) return err;
  const int cap = min(resident, k.slots);
  if (cap < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  // (column tiles, row tiles, images), capped in that order of priority;
  // more row blocks where the tiles are fewer than the blocks that convert
  // kUnroll elements a thread; ops/warp_cuda.py::stride_grid mirrors it
  const int64_t numel = (int64_t)k.n * k.c * k.H * k.W;
  const int64_t convert = (numel + kUnroll * kBlock - 1) / (kUnroll * kBlock);
  dim3 grid;
  grid.x = min((k.W + 31) / 32, cap);
  grid.z = min(k.n, cap / (int)grid.x);
  const int xz = (int)(grid.x * grid.z);
  grid.y = (int)std::min<int64_t>(
      std::max<int64_t>((k.H + kTileRows - 1) / kTileRows,
                        (convert + xz - 1) / xz),
      cap / xz);
  void* k3[] = {&k.g, &k.flow, &k.out, &k.sums, &k.n,  &k.c,
                &k.H, &k.W,    &k.gs,  &k.os,   &k.fs};
  void* fused[] = {&k.g, &k.flow, &k.out, &k.sums, &k.x,  &k.dflow, &k.n,
                   &k.c, &k.H,    &k.W,   &k.gs,   &k.os, &k.fs,    &k.xs};
  return (int)cudaLaunchCooperativeKernel(
      (const void*)dimage_kernel<TG, TF, TO, C, kFlow>(), grid,
      dim3(32, kTileRows), kFlow ? fused : k3, 0, k.stream);
}

// RGB (every path) takes the kernel with the channels unrolled; any other
// count loops over them. With the flow adjoint an image of no channels
// still writes it (zeros).
template <bool kFlow, typename TG, typename TF, typename TO>
int run_dimage_any_c(const DimageCall<TG, TF, TO>& k) {
  if ((int64_t)k.n * (kFlow ? 1 : k.c) * k.H * k.W == 0) return 0;
  return k.c == 3 ? run_dimage<TG, TF, TO, 3, kFlow>(k)
                  : run_dimage<TG, TF, TO, 0, kFlow>(k);
}

// K3: (g, flow, out, scratch, n, c, H, W, slots, g's, the output's and the
// flow's strides, stream)
template <typename TG, typename TF, typename TO>
int launch_dimage(const int64_t* a) {
  DimageCall<TG, TF, TO> k{};
  k.g = arg_ptr<const TG>(a, 0);
  k.flow = arg_ptr<const TF>(a, 1);
  k.out = arg_ptr<TO>(a, 2);
  k.sums = arg_ptr<long long>(a, 3);
  k.n = (int)a[4], k.c = (int)a[5], k.H = (int)a[6], k.W = (int)a[7];
  k.slots = (int)a[8];
  k.gs = strides_from(a + 9);
  k.os = strides_from(a + 13);
  k.fs = strides_from(a + 17);
  k.stream = arg_ptr<CUstream_st>(a, 21);
  return run_dimage_any_c<false>(k);
}

// K3 and K4 in one launch: K3's arguments with x and the flow adjoint
// after the scratch, and x's strides after the flow's: (g, flow, dx,
// scratch, x, dflow, n, c, H, W, slots, g's, dx's, the flow's and x's
// strides, stream)
template <typename TX, typename TF>
int launch_dimage_dflow(const int64_t* a) {
  DimageCall<TX, TF, TX> k{};
  k.g = arg_ptr<const TX>(a, 0);
  k.flow = arg_ptr<const TF>(a, 1);
  k.out = arg_ptr<TX>(a, 2);
  k.sums = arg_ptr<long long>(a, 3);
  k.x = arg_ptr<const TX>(a, 4);
  k.dflow = arg_ptr<TF>(a, 5);
  k.n = (int)a[6], k.c = (int)a[7], k.H = (int)a[8], k.W = (int)a[9];
  k.slots = (int)a[10];
  k.gs = strides_from(a + 11);
  k.os = strides_from(a + 15);
  k.fs = strides_from(a + 19);
  k.xs = strides_from(a + 23);
  k.stream = arg_ptr<CUstream_st>(a, 27);
  return run_dimage_any_c<true>(k);
}

// The co-resident blocks of K3's launch, or of the fused one (kFlow), for
// c channels: (c, the address of an int64 that receives them)
template <typename TG, typename TF, typename TO, bool kFlow>
int query_resident(const int64_t* a) {
  int blocks = 0;
  const int err = a[0] == 3
                      ? resident_blocks<TG, TF, TO, 3, kFlow>(&blocks)
                      : resident_blocks<TG, TF, TO, 0, kFlow>(&blocks);
  *arg_ptr<int64_t>(a, 1) = blocks;
  return err;
}

// K4 alone: kTileSteps pixels of one row in C channels (C = 0: c
// channels, one at a time), on K2's row tiles.
template <typename TX, typename TF, int C>
__global__ void __launch_bounds__(32 * kTileRows)
    warp_dflow_kernel(const TX* __restrict__ g, const TX* __restrict__ x,
                      const TF* __restrict__ flow, TF* __restrict__ out,
                      int c, int H, int W, Strides4 gs, Strides4 xs,
                      Strides4 fs) {
  const int i = blockIdx.y * kTileRows + threadIdx.y;
  if (i >= H) return;
  const int b = blockIdx.z;
  // the images' bases and the flow row in 64 bits; offsets within them
  // 32-bit (the wrapper checks the largest)
  const TX* src = x + b * xs.s0;
  const TX* gp = g + b * gs.s0;
  const TF* f = flow + b * fs.s0 + i * fs.s1;
  const int x1 = (int)xs.s1, x2 = (int)xs.s2, x3 = (int)xs.s3;
  const int g1 = (int)gs.s1, g2 = i * (int)gs.s2, g3 = (int)gs.s3;
  const int fj = (int)fs.s2, fk = (int)fs.s3;
  const int j0 = blockIdx.x * (32 * kTileSteps) + threadIdx.x;

  // a column past W reads column W-1 and stores nothing
  int jc[kTileSteps];
  float fx[kTileSteps], fy[kTileSteps];
#pragma unroll
  for (int k = 0; k < kTileSteps; ++k) {
    jc[k] = min(j0 + 32 * k, W - 1);
    fx[k] = load_f32(f + jc[k] * fj);
    fy[k] = load_f32(f + (jc[k] * fj + fk));
  }
  FlowStencil st[kTileSteps];
  float dfx[kTileSteps], dfy[kTileSteps];
#pragma unroll
  for (int k = 0; k < kTileSteps; ++k) {
    st[k] = flow_stencil(fx[k], fy[k], i, jc[k], H, W, x2, x3);
    dfx[k] = 0.0f;
    dfy[k] = 0.0f;
  }
  // G channels at a time, every tap and cotangent load of a group in
  // flight before the first is used: all C of them when the count is
  // fixed, else one
  constexpr int G = C > 0 ? C : 1;
  for (int ch0 = 0; ch0 < (C > 0 ? C : c); ch0 += G) {
    FlowTaps<G> a[kTileSteps];
    float gv[kTileSteps][G];
#pragma unroll
    for (int k = 0; k < kTileSteps; ++k) {
      a[k].load(src, st[k], x1, ch0);
#pragma unroll
      for (int q = 0; q < G; ++q) {
        gv[k][q] = load_f32(gp + ((ch0 + q) * g1 + g2 + jc[k] * g3));
      }
    }
#pragma unroll
    for (int k = 0; k < kTileSteps; ++k) {
      a[k].add(st[k], gv[k], dfx[k], dfy[k]);
    }
  }
  TF* dst = out + ((int64_t)b * H + i) * W * 2;
#pragma unroll
  for (int k = 0; k < kTileSteps; ++k) {
    const int j = j0 + 32 * k;
    if (j < W) store_f32x2(dst + 2 * j, dfx[k], dfy[k]);
  }
}

// K4 alone: (g, x, flow, out, n, c, H, W, g's, x's and the flow's strides,
// stream)
template <typename TX, typename TF>
int launch_dflow(const int64_t* a) {
  const int n = (int)a[4], c = (int)a[5], H = (int)a[6], W = (int)a[7];
  if ((int64_t)n * H * W == 0) return 0;
  constexpr int kTileW = 32 * kTileSteps;
  const dim3 grid((W + kTileW - 1) / kTileW, (H + kTileRows - 1) / kTileRows,
                  n);
  auto kernel = c == 3 ? warp_dflow_kernel<TX, TF, 3>
                       : warp_dflow_kernel<TX, TF, 0>;
  kernel<<<grid, dim3(32, kTileRows), 0, arg_ptr<CUstream_st>(a, 20)>>>(
      arg_ptr<const TX>(a, 0), arg_ptr<const TX>(a, 1),
      arg_ptr<const TF>(a, 2), arg_ptr<TF>(a, 3), c, H, W,
      strides_from(a + 8), strides_from(a + 12), strides_from(a + 16));
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points, each taking one int64 array and returning a CUDA
// error code. K3, one per (cotangent dtype, flow dtype, output dtype):
// (g, flow, out, scratch, n, c, H, W, slots, 12 element strides: g's and
// the output's in (n, c, H, W) order, then the flow's in (n, H, W, 2)
// order, stream); the output is dense (any order of its dimensions), the
// scratch int64 of n*c*H*W + slots words, and slots at least the blocks of
// the launch (the card's SMs times 2048 / kBlock always suffice). K3 and
// K4 in one launch, one per (image/cotangent dtype, flow dtype), the image
// adjoint dx in the image's dtype: (g, flow, dx, scratch, x, dflow, n, c,
// H, W, slots, 16 element strides: g's, dx's, the flow's and x's, stream).
// K4 alone, one per (image/cotangent dtype, flow dtype): (g, x, flow, out,
// n, c, H, W, g's, x's and the flow's strides, stream). The flow adjoint
// (dflow, out) is a dense (n, H, W, 2) in the flow's dtype, aligned to its
// element pairs (as torch.empty allocates it). Each launch entry point
// NAME of K3 and of the fused launch has a companion NAME_resident: (c,
// the address of an int64) receives the blocks the launch can hold at
// once on the current device, the cap of its grid.
#define TECOGAN_DIMAGE_ENTRY(NAME, TG, TF, TO)           \
  extern "C" int NAME(const int64_t* args) {             \
    return launch_dimage<TG, TF, TO>(args);              \
  }                                                      \
  extern "C" int NAME##_resident(const int64_t* args) {  \
    return query_resident<TG, TF, TO, false>(args);      \
  }
#define TECOGAN_DIMAGE_DFLOW_ENTRY(NAME, TX, TF)         \
  extern "C" int NAME(const int64_t* args) {             \
    return launch_dimage_dflow<TX, TF>(args);            \
  }                                                      \
  extern "C" int NAME##_resident(const int64_t* args) {  \
    return query_resident<TX, TF, TX, true>(args);       \
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
TECOGAN_DIMAGE_DFLOW_ENTRY(tecogan_warp_dimage_dflow_f32_f32, float, float)
TECOGAN_DIMAGE_DFLOW_ENTRY(tecogan_warp_dimage_dflow_f32_bf16, float, bf16)
TECOGAN_DIMAGE_DFLOW_ENTRY(tecogan_warp_dimage_dflow_bf16_f32, bf16, float)
TECOGAN_DIMAGE_DFLOW_ENTRY(tecogan_warp_dimage_dflow_bf16_bf16, bf16, bf16)
TECOGAN_DFLOW_ENTRY(tecogan_warp_dflow_f32_f32, float, float)
TECOGAN_DFLOW_ENTRY(tecogan_warp_dflow_f32_bf16, float, bf16)
TECOGAN_DFLOW_ENTRY(tecogan_warp_dflow_bf16_f32, bf16, float)
TECOGAN_DFLOW_ENTRY(tecogan_warp_dflow_bf16_bf16, bf16, bf16)
