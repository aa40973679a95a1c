// Fused DrQ RandomShift crop + uint8 -> float scale/normalize, for Hopper (sm_90a).
//
// Replaces the TPU kernel hulc2_tpu/ops/pallas_shift.py:52
// random_shift_normalize_pallas (kernel body _kernel at :32, pallas_call at :102).
// Computes, per frame n with integer offset (oy, ox) in [0, 2*pad]^2:
//
//   out[n, i, j, c] = img[n, clamp(oy + i - pad, 0, H-1), clamp(ox + j - pad, 0, W-1), c]
//                     * scale[c] + shift[c]
//
// with scale = 1 / (255 std) and shift = -mean / std. That is the edge-padded crop
// of hulc2_tpu/ops/preprocess.py:85-103 (shift_from_offsets) followed by
// scale_and_normalize (:25-34), without materialising the padded image.
//
// Bound on this card: memory. Per launch the function reads N*H*W*C bytes and
// writes N*H*W*C output elements (2 bytes each in bf16); it does 2 flops per
// element. On the flagship train step (N = 2048 frames):
//   rgb_static  2048x96x96x3, pad 4: ~170 MB moved, ~51 us at 3.35 TB/s;
//   rgb_gripper 2048x64x64x3, pad 3: ~75 MB moved,  ~23 us.
// Design: one block per output row (n, i). The block reads its frame's offsets
// once, then its threads walk the W*C contiguous output elements of that row, so
// the stores are fully coalesced and the reads hit one clamped source row,
// contiguous apart from the clamped edge columns. No shared memory, no padded
// buffer, no chunking. The multiply and the add are rounded separately
// (__fmul_rn, __fadd_rn) so the result equals PyTorch's `x * scale + shift`
// bit for bit in fp32 and after the round-to-nearest-even cast to bf16.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int C = 3;  // RGB, the only layout on the main path

struct Affine {
  float scale[C];
  float shift[C];
};

__device__ __forceinline__ void store(float* out, long idx, float v) { out[idx] = v; }

__device__ __forceinline__ void store(__nv_bfloat16* out, long idx, float v) {
  out[idx] = __float2bfloat16_rn(v);
}

template <typename OutT>
__global__ void shift_normalize_kernel(const uint8_t* __restrict__ in,
                                       const int32_t* __restrict__ offsets,
                                       OutT* __restrict__ out, int h, int w, int pad,
                                       Affine affine) {
  const long row = blockIdx.x;  // n * h + i
  const int n = static_cast<int>(row / h);
  const int i = static_cast<int>(row - static_cast<long>(n) * h);
  const int oy = offsets[2 * n];
  const int ox = offsets[2 * n + 1];
  const int src_i = min(max(oy + i - pad, 0), h - 1);
  const uint8_t* src_row = in + (static_cast<long>(n) * h + src_i) * w * C;
  const long dst_row = row * w * C;
  const int row_len = w * C;
  for (int t = threadIdx.x; t < row_len; t += blockDim.x) {
    const int j = t / C;
    const int c = t - j * C;
    const int src_j = min(max(ox + j - pad, 0), w - 1);
    const float x = static_cast<float>(src_row[src_j * C + c]);
    store(out, dst_row + t, __fadd_rn(__fmul_rn(x, affine.scale[c]), affine.shift[c]));
  }
}

template <typename OutT>
cudaError_t launch(const uint8_t* in, const int32_t* offsets, OutT* out, int n, int h, int w,
                   int pad, const Affine& affine, cudaStream_t stream) {
  const int row_len = w * C;
  int threads = ((row_len + 31) / 32) * 32;
  if (threads > 256) threads = 256;
  const long blocks = static_cast<long>(n) * h;
  shift_normalize_kernel<OutT><<<static_cast<unsigned>(blocks), threads, 0, stream>>>(
      in, offsets, out, h, w, pad, affine);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point, bound with ctypes, for (n, h, w, 3) uint8 frames. `scale`
// and `shift` are host arrays of 3 floats. Returns the cudaError_t of the launch
// (0 on success); the kernel runs on `stream` and nothing here synchronises.
extern "C" int shift_normalize_launch(const void* in, const void* offsets, void* out,
                                      int out_is_bf16, int n, int h, int w, int pad,
                                      const float* scale, const float* shift, void* stream) {
  if (n <= 0 || h <= 0 || w <= 0 || pad < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Affine affine;
  for (int k = 0; k < C; ++k) {
    affine.scale[k] = scale[k];
    affine.shift[k] = shift[k];
  }
  const auto* src = static_cast<const uint8_t*>(in);
  const auto* offs = static_cast<const int32_t*>(offsets);
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (out_is_bf16) {
    err = launch(src, offs, static_cast<__nv_bfloat16*>(out), n, h, w, pad, affine, s);
  } else {
    err = launch(src, offs, static_cast<float*>(out), n, h, w, pad, affine, s);
  }
  return static_cast<int>(err);
}
