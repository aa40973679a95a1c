// 2x2, stride-2 average pool of channels_last activations, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package's CLIP tower pools with flax's
// nn.avg_pool (hulc2_tpu/models/clip_resnet.py:27), which XLA compiles. It was
// added for the port's frozen CLIP RN50 trunk (hulc2_torch/models/clip_resnet.py),
// whose seven pools a frame ran in ATen's avg_pool2d_out_cuda_frame_nhwc at
// about an eighth of the memory rate, a quarter of the static_clip train step.
// Computes, for an (N, H, W, C) input (NCHW in channels_last memory), i < H/2,
// j < W/2 (floor) and every c:
//
//   out[n, i, j, c] = ((((0 + x[n, 2i, 2j, c]) + x[n, 2i, 2j+1, c]) + x[n, 2i+1, 2j, c])
//                      + x[n, 2i+1, 2j+1, c]) * 0.25
//
// summed in fp32 in ATen's order (from a zero, which turns a -0 sum into +0 as
// ATen's does) and rounded once to the output type, so it equals
// F.avg_pool2d(x, 2) bit for bit: ATen divides by 4, which gives the same
// float as the multiply by 0.25.
//
// Bound: bytes. Per output element it reads four elements, writes one and does
// four flops, under one flop a byte. The trunk's seven pools at 224x224 move
// 7.28 MB a frame in bf16: 14.9 GB for the 2,048 frames of a train step,
// 4.45 ms at 3.35 TB/s.
//
// Design:
// - A work item is one output pixel and one 16-byte group of its channels (8
//   bf16 or 4 fp32). Its four inputs are four 16-byte loads, two from row 2i
//   and two from row 2i+1. Items run channel group fastest, so a warp's loads
//   cover whole 128-byte lines of consecutive pixels: the line of pixel 2j
//   and the line of pixel 2j+1, read by the same warp in two instructions.
//   The output is one 16-byte store, and output items are consecutive.
// - To stream at 3.35 TB/s through ~0.6 us of DRAM latency the card needs some
//   2 MB of reads in flight. A thread loads kUnroll items (kUnroll x 64 bytes)
//   before it sums any of them, in a grid-stride loop over a grid of as many
//   blocks as the card holds at once.
// - Loads carry the streaming hint (ld.global.cs): nothing reads the input
//   again, so it should not push the output out of L2.
// - Offsets are 64-bit: the stem's input is 3.3 GB at 2,048 frames.
// - No shared memory, no tensor cores.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;  // items a thread loads before it sums any
constexpr int kMaxDevices = 64;

// n / d for 0 <= n < 2^31 by a high multiply, an add and a shift (the
// round-up method of Granlund and Montgomery, as ATen's IntDivider): a 64-bit
// division is tens of integer instructions, and an item needs three of them.
// The wrapper refuses problems of 2^31 items or more (32 GiB of output).
struct Divider {
  int64_t d;
  uint32_t magic, shift;
};

Divider make_divider(int64_t d) {
  uint32_t shift = 0;
  while (shift < 32 && (int64_t{1} << shift) < d) ++shift;
  const uint64_t magic = ((uint64_t{1} << 32) * ((uint64_t{1} << shift) - d)) / d + 1;
  return {d, static_cast<uint32_t>(magic), shift};
}

__device__ __forceinline__ int64_t divide(int64_t n, const Divider& v) {
  const uint32_t m = static_cast<uint32_t>(n);
  return (__umulhi(m, v.magic) + m) >> v.shift;
}

struct Geometry {  // in 16-byte groups
  int64_t items;   // N * Ho * Wo * groups
  int64_t row;     // one input row: W * groups
  int64_t odd_rows;  // H - 2 Ho: the last input row of a frame of odd height is not read
  Divider groups;  // 16-byte groups of one pixel's channels
  Divider wo, ho;
};

// The first of an item's four input groups: (n, 2i, 2j, g).
__device__ __forceinline__ int64_t source(int64_t item, const Geometry& g) {
  const int64_t pixel = divide(item, g.groups);
  const int64_t gi = item - pixel * g.groups.d;
  const int64_t q = divide(pixel, g.wo);  // n * Ho + i
  const int64_t j = pixel - q * g.wo.d;
  const int64_t in_row = 2 * q + divide(q, g.ho) * g.odd_rows;  // n * H + 2i
  return in_row * g.row + 2 * j * g.groups.d + gi;
}

// ATen's sum: a zero, then the four inputs in order, each addition rounded.
__device__ __forceinline__ float pool4(float a, float b, float c, float d) {
  return __fmul_rn(__fadd_rn(__fadd_rn(__fadd_rn(__fadd_rn(0.0f, a), b), c), d), 0.25f);
}

__device__ __forceinline__ float bf16_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

// Two bf16 channels of each of the four inputs (one 32-bit word each), pooled.
__device__ __forceinline__ uint32_t pool_bf16x2(uint32_t a, uint32_t b, uint32_t c, uint32_t d) {
  const __nv_bfloat162 r = __floats2bfloat162_rn(
      pool4(bf16_lo(a), bf16_lo(b), bf16_lo(c), bf16_lo(d)),
      pool4(bf16_hi(a), bf16_hi(b), bf16_hi(c), bf16_hi(d)));
  return *reinterpret_cast<const uint32_t*>(&r);
}

__device__ __forceinline__ uint4 pool_group(const uint4 (&v)[4], bool bf16) {
  uint4 r;
  if (bf16) {
    r.x = pool_bf16x2(v[0].x, v[1].x, v[2].x, v[3].x);
    r.y = pool_bf16x2(v[0].y, v[1].y, v[2].y, v[3].y);
    r.z = pool_bf16x2(v[0].z, v[1].z, v[2].z, v[3].z);
    r.w = pool_bf16x2(v[0].w, v[1].w, v[2].w, v[3].w);
  } else {
#define POOL_FP32(f)                                                                        \
  r.f = __float_as_uint(pool4(__uint_as_float(v[0].f), __uint_as_float(v[1].f),             \
                              __uint_as_float(v[2].f), __uint_as_float(v[3].f)))
    POOL_FP32(x);
    POOL_FP32(y);
    POOL_FP32(z);
    POOL_FP32(w);
#undef POOL_FP32
  }
  return r;
}

template <bool kBf16>
__global__ void __launch_bounds__(kThreads)
    avg_pool2x2_kernel(const uint4* __restrict__ in, uint4* __restrict__ out, Geometry g) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t first = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       first < g.items; first += stride * kUnroll) {
    uint4 v[kUnroll][4];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t item = first + u * stride;
      if (item < g.items) {
        const uint4* p = in + source(item, g);
        v[u][0] = __ldcs(p);
        v[u][1] = __ldcs(p + g.groups.d);
        v[u][2] = __ldcs(p + g.row);
        v[u][3] = __ldcs(p + g.row + g.groups.d);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t item = first + u * stride;
      if (item < g.items) out[item] = pool_group(v[u], kBf16);
    }
  }
}

// Blocks of the kernel the device holds at once, found once per device and variant.
template <bool kBf16>
cudaError_t resident_blocks(int* blocks) {
  static int cache[kMaxDevices] = {0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && cache[dev] > 0) {
    *blocks = cache[dev];
    return cudaSuccess;
  }
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, avg_pool2x2_kernel<kBf16>,
                                                      kThreads, 0);
  if (err != cudaSuccess) return err;
  *blocks = sms * (per_sm > 0 ? per_sm : 1);
  if (dev < kMaxDevices) cache[dev] = *blocks;
  return cudaSuccess;
}

template <bool kBf16>
cudaError_t launch(const void* in, void* out, const Geometry& g, cudaStream_t stream) {
  int resident = 0;
  cudaError_t err = resident_blocks<kBf16>(&resident);
  if (err != cudaSuccess) return err;
  const int64_t needed = (g.items + int64_t{kThreads} * kUnroll - 1) / (int64_t{kThreads} * kUnroll);
  const int blocks = static_cast<int>(needed < resident ? needed : resident);
  avg_pool2x2_kernel<kBf16><<<blocks, kThreads, 0, stream>>>(
      static_cast<const uint4*>(in), static_cast<uint4*>(out), g);
  return cudaGetLastError();
}

}  // namespace

// in: (n, h, w, c) elements of bf16 (is_bf16) or fp32, 16-byte aligned, with
// c x the element size a multiple of 16 bytes, fewer than 2^31 16-byte groups
// of output; out: (n, h/2, w/2, c), the same. The wrapper
// (hulc2_torch/ops/pool.py) checks all of it. Returns the launch's cudaError_t.
extern "C" int avg_pool2x2_launch(const void* in, void* out, int is_bf16, int n, int h, int w,
                                  int c, void* stream) {
  const int64_t elem = is_bf16 ? 2 : 4;
  const int64_t groups = c * elem / 16, ho = h / 2, wo = w / 2;
  Geometry g;
  g.items = static_cast<int64_t>(n) * ho * wo * groups;
  if (g.items == 0) return cudaSuccess;
  g.row = static_cast<int64_t>(w) * groups;
  g.odd_rows = h - 2 * ho;
  g.groups = make_divider(groups);
  g.wo = make_divider(wo);
  g.ho = make_divider(ho);
  auto s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch<true>(in, out, g, s) : launch<false>(in, out, g, s);
}
