// Fused DrQ RandomShift crop + uint8 -> float scale/normalize, for Hopper (sm_90a).
//
// Replaces the TPU kernel hulc2_tpu/ops/pallas_shift.py:52
// random_shift_normalize_pallas (kernel body _kernel at :32, pallas_call at :102).
// Computes, per frame n with integer offset (oy, ox), normally in [0, 2*pad]^2:
//
//   out[n, i, j, c] = img[n, clamp(oy + i - pad, 0, H-1), clamp(ox + j - pad, 0, W-1), c]
//                     * scale[c] + shift[c]
//
// with scale = 1 / (255 std) and shift = -mean / std: the edge-padded crop of
// hulc2_tpu/ops/preprocess.py:85-103 followed by scale_and_normalize (:25-34),
// without materialising the padded image. The multiply and the add are rounded
// separately (__fmul_rn, __fadd_rn), then rounded to nearest even for bf16, so
// the result equals PyTorch's `(x * scale + shift).to(dtype)` bit for bit.
//
// Bound: memory. Per element it reads 1 byte, writes 2 (bf16) or 4 (fp32) and
// does 2 flops. On the flagship train step (N = 2048 frames, bf16 out):
//   rgb_static  2048x96x96x3, pad 4: 170 MB moved, 0.051 ms at 3.35 TB/s;
//   rgb_gripper 2048x64x64x3, pad 3:  75 MB moved, 0.023 ms.
// To stream at 3.35 TB/s through ~0.6 us of DRAM latency the card needs about
// 2 MB of reads in flight (Little's law), some 15 KB per SM. The first version
// of this kernel ran one block per output row and loaded one byte per thread:
// at most 2,048 resident threads x 1 byte = 2 KB in flight per SM, about a
// seventh of that, and it ran at about a seventh of the bound.
//
// Design:
// - A block owns a tile: one frame and a band of `band_rows` output rows. For
//   a fixed row offset those rows read a contiguous run of at most band_rows
//   source rows; the wrapper sizes bands so that run is about 32 KB (a whole
//   96x96 or 64x64 frame). Thread 0 stages the run into shared memory with
//   one TMA bulk copy (cp.async.bulk, completion on an mbarrier). Five blocks
//   are resident per SM, so up to ~140 KB of reads are in flight per SM.
// - Source rows of 252 or 450 bytes are not 16-byte aligned, and a bulk copy
//   needs 16-byte addresses and sizes: the copy takes the aligned interior of
//   the run and the threads copy its head and tail (under 16 bytes each), so
//   nothing outside the frame's rows is read.
// - Each thread produces 8 consecutive output elements per pass and writes
//   them with one 16-byte store (bf16) or two (fp32). Groups of 8 are aligned
//   on the flat output index, not on rows, so every store is aligned at any
//   width; a group that straddles a band edge or the end of the tensor is
//   written element by element, each element by the tile that owns it.
// - 384 threads x 8 elements is a multiple of 3, so a thread's channel pattern
//   is fixed for the tile: the clamped column becomes a clamp of the source
//   byte to [ch, row_bytes - 3 + ch], with no divide. Where a whole warp's
//   groups lie in one row with no clamped column it reads 8 consecutive bytes
//   as three 32-bit words; the path is chosen per warp, because a warp whose
//   lanes split between paths runs both, and at 96x96 nearly every warp holds
//   a row's clamped edge. Bytes become floats through a byte permute into the
//   mantissa of 2^23, not the quarter-rate int-to-float converter.
// - No tensor cores: 2 flops per byte. No padded buffer.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int C = 3;           // RGB, the only layout on the main path
constexpr int kThreads = 384;
constexpr int kVec = 8;  // output elements per thread and pass
static_assert(kThreads * kVec % C == 0, "a thread's channels must repeat from pass to pass");

struct Affine {
  float scale[C];
  float shift[C];
};

struct Geometry {  // from the wrapper, hulc2_torch/ops/preprocess.py:shift_tiling
  int h, w, pad, band_rows, bands;
};

// A tile as its block sees it: output rows [i0, i0 + rows) of `frame`, whose
// source rows r0..r1 are the device bytes [lo, hi).
struct Tile {
  int frame, i0, rows, dy, dx, r0, r1;
  uintptr_t lo, hi;
};

// The part of [lo, hi) that one bulk copy moves, 16-byte aligned at both ends,
// and the `edges` bytes around it that the threads copy: `head` below it, the
// rest above. With no aligned 16 bytes inside, the threads copy everything.
struct Split {
  uintptr_t bulk_lo, bulk_hi;
  int head, edges;
};

__device__ __forceinline__ int clamp_index(int x, int n) { return min(max(x, 0), n - 1); }

// Row or column offset minus pad, clamped to [-n, n]: the clamped source index
// is the same, and the int arithmetic below cannot overflow.
__device__ __forceinline__ int shift_of(int32_t offset, int pad, int n) {
  return static_cast<int>(min(max(static_cast<long long>(offset) - pad, -static_cast<long long>(n)),
                              static_cast<long long>(n)));
}

__device__ __forceinline__ Tile tile_of(int t, const Geometry& g, const uint8_t* in,
                                        const int32_t* offsets) {
  Tile tile;
  tile.frame = t / g.bands;
  tile.i0 = (t - tile.frame * g.bands) * g.band_rows;
  tile.rows = min(g.band_rows, g.h - tile.i0);
  tile.dy = shift_of(offsets[2 * tile.frame], g.pad, g.h);  // source row = clamp(i + dy)
  tile.dx = shift_of(offsets[2 * tile.frame + 1], g.pad, g.w);  // source column = clamp(j + dx)
  tile.r0 = clamp_index(tile.i0 + tile.dy, g.h);
  tile.r1 = clamp_index(tile.i0 + tile.rows - 1 + tile.dy, g.h);
  const long long frame_row = static_cast<long long>(tile.frame) * g.h;
  tile.lo = reinterpret_cast<uintptr_t>(in + (frame_row + tile.r0) * (g.w * C));
  tile.hi = reinterpret_cast<uintptr_t>(in + (frame_row + tile.r1 + 1) * (g.w * C));
  return tile;
}

__device__ __forceinline__ Split split_of(const Tile& t) {
  Split s;
  s.bulk_lo = (t.lo + 15) & ~uintptr_t{15};
  s.bulk_hi = t.hi & ~uintptr_t{15};
  if (s.bulk_hi <= s.bulk_lo) s.bulk_lo = s.bulk_hi = t.hi;
  s.head = static_cast<int>(s.bulk_lo - t.lo);
  s.edges = s.head + static_cast<int>(t.hi - s.bulk_hi);
  return s;
}

// Device address of edge byte k < s.edges, and its place in the stage.
__device__ __forceinline__ uintptr_t edge_addr(const Tile& t, const Split& s, int k) {
  return k < s.head ? t.lo + k : s.bulk_hi + (k - s.head);
}

__device__ __forceinline__ int stage_pos(const Tile& t, uintptr_t a) {
  return static_cast<int>(a - (t.lo & ~uintptr_t{15}));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Thread 0 only: start the bulk copy of the tile's interior into `stage`,
// completing on `bar`; a plain arrival when there is none.
__device__ __forceinline__ void issue_bulk(uint8_t* stage, uint64_t* bar, const Tile& t,
                                           const Split& s) {
  const uint32_t bytes = static_cast<uint32_t>(s.bulk_hi - s.bulk_lo);
  if (bytes == 0) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
    return;
  }
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               ::"r"(smem_u32(bar)), "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(smem_u32(stage + stage_pos(t, s.bulk_lo))), "l"(s.bulk_lo), "r"(bytes),
      "r"(smem_u32(bar))
      : "memory");
}

// Wait until `bar` completes its first phase. A copy that never lands traps
// (the launch then reports an error) instead of spinning forever.
__device__ __forceinline__ void wait_first_phase(uint64_t* bar) {
  const long long t0 = clock64();
  for (uint32_t done = 0; !done;) {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done) : "r"(smem_u32(bar)) : "memory");
    if (!done && clock64() - t0 > (1ll << 35)) __trap();
  }
}

// x in [0, 255] as a float, exactly, without the quarter-rate int-to-float
// converter: the byte becomes the low mantissa bits of 2^23 (one byte permute),
// and 2^23 is subtracted. `sel` picks the byte of `word`.
__device__ __forceinline__ float byte_to_float(uint32_t word, uint32_t sel) {
  return __fsub_rn(__uint_as_float(__byte_perm(word, 0x4B000000u, 0x7540u | sel)), 8388608.0f);
}

__device__ __forceinline__ float affine1(float x, float scale, float shift) {
  return __fadd_rn(__fmul_rn(x, scale), shift);
}

__device__ __forceinline__ void store1(float* dst, float v) { *dst = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* dst, float v) { *dst = __float2bfloat16_rn(v); }

__device__ __forceinline__ void store8(float* dst, const float (&v)[kVec]) {
  reinterpret_cast<float4*>(dst)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(dst)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);  // round to nearest even, each half
  return *reinterpret_cast<const uint32_t*>(&p);
}

__device__ __forceinline__ void store8(__nv_bfloat16* dst, const float (&v)[kVec]) {
  *reinterpret_cast<uint4*>(dst) = make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]),
                                              pack_bf16(v[4], v[5]), pack_bf16(v[6], v[7]));
}

// The tile's output from its stage, where stage[(lo & 15) + (r - r0) * row_bytes + b]
// is source byte b of row r.
template <typename OutT>
__device__ __forceinline__ void emit(const uint8_t* stage, const Tile& t, const Geometry& g,
                                     OutT* __restrict__ out, const Affine& affine) {
  constexpr int kStep = kThreads * kVec;  // elements between a thread's passes
  const int row_bytes = g.w * C;
  const int tile = t.rows * row_bytes;  // output elements of the tile
  const int slack = static_cast<int>(t.lo & 15);
  const long long e0 = (static_cast<long long>(t.frame) * g.h + t.i0) * row_bytes;
  const long long g_begin = e0 / kVec;
  const long long g_end = (e0 + tile + kVec - 1) / kVec;
  // Element k of each of this thread's groups has channel ch = (c0 + k) % 3, and
  // a source byte in [ch, row_bytes - 3 + ch] of its row: clamping the
  // unclamped byte position to that range is the column clamp.
  const int c0 = static_cast<int>((g_begin + threadIdx.x) * kVec % C);
  float sc[C], sh[C];
  int lo[C], hi[C];
#pragma unroll
  for (int m = 0; m < C; ++m) {
    const int ch = (c0 + m) % C;
    sc[m] = ch == 0 ? affine.scale[0] : (ch == 1 ? affine.scale[1] : affine.scale[2]);
    sh[m] = ch == 0 ? affine.shift[0] : (ch == 1 ? affine.shift[1] : affine.shift[2]);
    lo[m] = ch;
    hi[m] = row_bytes - C + ch;
  }
  // d: the thread's group start in the tile (< 0 before it); (il, tc): its row
  // and byte in the row, floor-divided once and then stepped without a divide
  int d = static_cast<int>((g_begin + threadIdx.x) * kVec - e0);
  int il = (d >= 0 ? d : d - row_bytes + 1) / row_bytes;
  int tc = d - il * row_bytes;
  const int step_rows = kStep / row_bytes;
  const int step_cols = kStep - step_rows * row_bytes;
  const uint32_t* words = reinterpret_cast<const uint32_t*>(stage);
  for (long long grp = g_begin + threadIdx.x; grp < g_end; grp += kThreads) {
    const bool whole = d >= 0 && d + kVec <= tile;
    const bool one_row = whole && tc + kVec <= row_bytes;
    const int sx = tc + C * t.dx;  // unclamped source byte of the first element
    const int row = slack + (min(max(t.i0 + il + t.dy, t.r0), t.r1) - t.r0) * row_bytes;
    float v[kVec];
    // the path is chosen per warp, so lanes of one warp never run two of them
    const unsigned lanes = __activemask();
    if (__all_sync(lanes, one_row && sx >= 0 && sx + kVec <= row_bytes)) {
      // no clamped column: 8 consecutive staged bytes, from three words
      const int o = row + sx;
      const uint32_t w0 = words[o >> 2], w1 = words[(o >> 2) + 1], w2 = words[(o >> 2) + 2];
      const uint32_t lo4 = __funnelshift_r(w0, w1, 8 * (o & 3));
      const uint32_t hi4 = __funnelshift_r(w1, w2, 8 * (o & 3));
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        v[k] = affine1(byte_to_float(k < 4 ? lo4 : hi4, k & 3), sc[k % C], sh[k % C]);
      }
    } else if (__all_sync(lanes, one_row)) {
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        const int o = row + min(max(sx + k, lo[k % C]), hi[k % C]);
        v[k] = affine1(byte_to_float(stage[o], 0), sc[k % C], sh[k % C]);
      }
    } else {
      // groups that cross a row or the tile's edge; elements outside the tile
      // are computed from a clamped position and not stored
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        int ik = il, tk = tc + k;
        while (tk >= row_bytes) {
          tk -= row_bytes;
          ++ik;
        }
        const int r = min(max(t.i0 + ik + t.dy, t.r0), t.r1);
        const int o = slack + (r - t.r0) * row_bytes + min(max(tk + C * t.dx, lo[k % C]), hi[k % C]);
        v[k] = affine1(byte_to_float(stage[o], 0), sc[k % C], sh[k % C]);
      }
    }
    OutT* dst = out + grp * kVec;
    if (whole) {
      store8(dst, v);
    } else {
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        if (d + k >= 0 && d + k < tile) store1(dst + k, v[k]);
      }
    }
    d += kStep;
    il += step_rows;
    tc += step_cols;
    if (tc >= row_bytes) {
      tc -= row_bytes;
      ++il;
    }
  }
}

template <typename OutT>
__global__ void __launch_bounds__(kThreads)
    shift_normalize_kernel(const uint8_t* __restrict__ in, const int32_t* __restrict__ offsets,
                           OutT* __restrict__ out, Geometry g, Affine affine) {
  extern __shared__ __align__(128) uint8_t stage[];
  __shared__ uint64_t full;
  const int tid = threadIdx.x;
  const Tile t = tile_of(blockIdx.x, g, in, offsets);
  const Split s = split_of(t);
  if (tid == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_u32(&full)) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) issue_bulk(stage, &full, t, s);
  if (tid < s.edges) {
    const uintptr_t a = edge_addr(t, s, tid);
    stage[stage_pos(t, a)] = *reinterpret_cast<const uint8_t*>(a);
  }
  __syncthreads();
  wait_first_phase(&full);
  emit(stage, t, g, out, affine);
}

template <typename OutT>
cudaError_t launch(const uint8_t* in, const int32_t* offsets, OutT* out, const Geometry& g,
                   int blocks, int stage_bytes, const Affine& affine, cudaStream_t stream) {
  if (stage_bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        shift_normalize_kernel<OutT>, cudaFuncAttributeMaxDynamicSharedMemorySize, stage_bytes);
    if (err != cudaSuccess) return err;
  }
  shift_normalize_kernel<OutT><<<blocks, kThreads, stage_bytes, stream>>>(in, offsets, out, g, affine);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point, bound with ctypes, for (n, h, w, 3) uint8 frames.
// `band_rows` and `stage_bytes` are the wrapper's tiling
// (hulc2_torch/ops/preprocess.py:shift_tiling). `scale` and `shift` are host
// arrays of 3 floats. Returns the cudaError_t of the launch (0 on success);
// the kernel runs on `stream` and nothing here synchronises.
extern "C" int shift_normalize_launch(const void* in, const void* offsets, void* out,
                                      int out_is_bf16, int n, int h, int w, int pad,
                                      int band_rows, int stage_bytes, const float* scale,
                                      const float* shift, void* stream) {
  if (n <= 0 || h <= 0 || w <= 0 || pad < 0 || band_rows <= 0 || stage_bytes <= 0 ||
      stage_bytes % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int bands = (h + band_rows - 1) / band_rows;
  const long long blocks = static_cast<long long>(n) * bands;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  const Geometry g{h, w, pad, band_rows, bands};
  Affine affine;
  for (int k = 0; k < C; ++k) {
    affine.scale[k] = scale[k];
    affine.shift[k] = shift[k];
  }
  const auto* src = static_cast<const uint8_t*>(in);
  const auto* offs = static_cast<const int32_t*>(offsets);
  auto s = static_cast<cudaStream_t>(stream);
  const int grid = static_cast<int>(blocks);
  const cudaError_t err =
      out_is_bf16 ? launch(src, offs, static_cast<__nv_bfloat16*>(out), g, grid, stage_bytes, affine, s)
                  : launch(src, offs, static_cast<float*>(out), g, grid, stage_bytes, affine, s);
  return static_cast<int>(err);
}
