// Kernels E and F: the bit-exact dense Lr x Lc fixed-point 2-D FIR over a
// padded frame, output frame for input frame.
//
// Kernel E replaces warmup_fir_filter_tpu/kernels/fir2d_mxu.py::
// _fir2d_fullrow_kernel (:173; entry fir2d_fixed_frame :415) on the plain
// frame, any Lr and Lc <= 257.  Kernel F replaces _fir2d_oframe_kernel
// (:571; entry fir2d_fixed_frame_overlap :864) on the overlapped frame,
// 1 < Lc <= 97.  As there, each output is
//     acc = bias + sum_p (sum_k digit_p[k] * x~[R + Lr/2 - kr_p][n + Lc/2 - k]) << e_p
// over the kept (tap-row x signed base-256 digit) planes, x~ = x ^ 0x80 as
// int8, wrapping mod 2^32, then the shared epilogue (wft_fixed.cuh); pad
// rows, pad tiles and the columns outside the image are written as 0, and
// on the overlapped frame the boundary lanes take the neighbour tiles'
// values as the TPU kernel patches them, so the output frame is the TPU
// kernel's byte for byte (wft_fir2d.cuh).
//
// Both run each plane's band product on the int8 tensor cores (mma.sync
// m16n8k32, s8 x s8 -> s32; wft_fir2d.cuh::eframe_warp, oframe_warp) over
// one design: a persistent CTA of 4 warps walks work items of 32 frame rows
// of one tile; it stages the source rows of 8 tap rows at a time in 16-byte
// asynchronous copies (cp.async, byte by byte for a frame that is not
// 16-byte aligned) that land while the previous item or chunk multiplies,
// keeps the planes' shifted digit copies in shared memory (built once when
// all planes' tap rows fit one chunk), and writes the item's output through
// a shared tile in 16-byte stores where the output is aligned.  F stages
// the tile's own 128 columns, K7's aligned band, and writes its boundary
// patch three ways (oframe_write).  E stages the columns every lane reads,
// [lo - left, lo + 128 + center) of tiles c - 1 .. c + 1 in aligned chunks,
// and multiplies each n8 tile of lanes by one band of Lc + 7 columns: K6's
// main band and two side bands, which exist for the TPU's 128-wide unit,
// become one k range, since the integer sums do not depend on their order.
//
// What bounds them on an H100: 2 bytes of device memory an output, against
// planes x (Lc + 7) / 32 k32 chunks of MMA work an n8 tile of 16 rows.  At
// Lc <= 97 the bytes bound them; issue around the few MMAs of a plane, the
// latency between a CTA's barriers and, in F, the byte-wise stores of the
// boundary patch hold them several times above that.  At Lc 98-257, where
// fir2d_fixed_auto sends a filter to E, the MMAs and their shared-memory
// operands take over (about 6 planes x 5-9 chunks an n8 tile): each k32
// chunk's A fragment is loaded once for every n8 tile whose band it meets,
// and each MMA loads two B words.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

#include "wft_fir2d.cuh"

namespace {

bool frame_ok(long long hp, long long wp, bool taps_ok, int taps_r,
              int planes, int t0, int core_h, int core_w, int frac_bits,
              int acc_bits) {
  return hp >= 1 && wp >= 2 * wft::kLane && wp % wft::kLane == 0 && taps_ok &&
         taps_r >= 1 && planes >= 0 && t0 >= 1 && core_h >= 0 &&
         core_w >= 0 && frac_bits >= 1 && frac_bits <= 31 && acc_bits >= 1 &&
         acc_bits <= 32 && wp / wft::kLane <= INT_MAX;
}

struct FrameParams {
  wft::Fir2dGeometry g;
  long long items;
  int planes;
  uint32_t bias;
  int needs_wrap, frac_bits, acc_bits;
  int aligned;      // the frame is 16-byte aligned: stage with cp.async
  int out_aligned;  // the output is 16-byte aligned: write 16-byte chunks
};

// The shared memory of a CTA: two staging buffers, the output tile and the
// digit copies of one chunk's planes.
size_t frame_shared_bytes(bool plain, int taps_c, int planes) {
  const wft::EframeShape es = wft::eframe_shape(taps_c);
  const size_t buf = plain ? wft::kOframeStageRows * es.row_bytes
                           : wft::kOframeBufBytes;
  const int copy_words = plain ? es.copy_words : wft::kOframeCopyWords;
  const int chunk_planes =
      planes < wft::kOframeMaxChunkPlanes ? planes : wft::kOframeMaxChunkPlanes;
  return 2 * buf + wft::kOframeTileBytes +
         16 * static_cast<size_t>(chunk_planes) * copy_words;
}

// Kernel E (Plain) or F, one CTA: items blockIdx.x, blockIdx.x + gridDim.x,
// ..., each in chunks of planes whose source rows land while the previous
// chunk multiplies.
template <bool Plain>
__device__ __forceinline__ void frame_cta(const uint8_t* __restrict__ x,
                                          uint8_t* __restrict__ y,
                                          const int8_t* __restrict__ digits,
                                          const int* __restrict__ table,
                                          FrameParams p, uint8_t* smem) {
  const wft::Fir2dGeometry g = p.g;
  const long long items = p.items;
  const int planes = p.planes;
  const uint32_t bias = p.bias;
  const bool aligned = p.aligned != 0;
  const bool vec = p.out_aligned != 0;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int center = g.taps_c / 2;
  const int left = g.taps_c - 1 - center;
  const wft::EframeShape es = wft::eframe_shape(g.taps_c);
  const int buf_bytes =
      Plain ? wft::kOframeStageRows * es.row_bytes : wft::kOframeBufBytes;
  const int copy_words = Plain ? es.copy_words : wft::kOframeCopyWords;
  const int plane_words = 4 * copy_words;
  uint8_t* tile = smem + 2 * buf_bytes;
  uint32_t* dcopies = reinterpret_cast<uint32_t*>(tile + wft::kOframeTileBytes);
  const auto build = [&](int p0, int p1) {
    for (int i = tid; i < (p1 - p0) * plane_words; i += wft::kOframeThreads) {
      dcopies[i] = wft::oframe_copy_word(digits, g.taps_c, p0 + i / plane_words,
                                         i % plane_words, copy_words);
    }
  };
  // All planes in one chunk: their digit copies are built once.
  const bool single =
      planes > 0 && wft::oframe_chunk_end(table, planes, 0) == planes;
  if (single) build(0, planes);
  const auto computes = [&](const wft::OframeItem& it) {
    return !it.zero && planes > 0;
  };
  const auto stage = [&](long long item, int p0, uint8_t* buf) {
    const wft::OframeItem it = wft::oframe_item(g, item);
    if (!computes(it)) return;
    const int k0 = table[wft::kFir2dPlaneFields * p0];
    if constexpr (Plain) {
      wft::eframe_stage(buf, x, g, es, it.c, it.r0, k0, aligned, tid,
                        wft::kOframeThreads);
    } else {
      wft::oframe_stage(buf, x, g, it.c, it.r0, k0, aligned, tid,
                        wft::kOframeThreads);
    }
  };
  const bool wrap = p.needs_wrap != 0;
  const int frac_bits = p.frac_bits;
  const int acc_bits = p.acc_bits;
  const auto epilogue = [=](uint32_t a) {
    return wft::fixed_epilogue(a, wrap, frac_bits, acc_bits);
  };
  uint32_t acc[wft::kOframeNTiles][wft::kLaneSlots][4];
  const auto clear = [&]() {
#pragma unroll
    for (int n = 0; n < wft::kOframeNTiles; ++n) {
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[n][0][j] = bias;
    }
  };
  clear();
  long long item = blockIdx.x;
  int p0 = 0;
  if (item < items) stage(item, 0, smem);
  wft::async_commit();
  for (int k = 0; item < items; ++k) {
    const wft::OframeItem it = wft::oframe_item(g, item);
    const int p1 =
        computes(it) ? wft::oframe_chunk_end(table, planes, p0) : planes;
    long long next = item;
    int next_p0 = p1;
    if (p1 >= planes) {
      next = item + gridDim.x;
      next_p0 = 0;
    }
    // The next chunk's rows land while this one multiplies.
    if (next < items) stage(next, next_p0, smem + ((k + 1) & 1) * buf_bytes);
    wft::async_commit();
    wft::async_wait<1>();
    if (!single && computes(it)) build(p0, p1);
    __syncthreads();
    if (computes(it)) {
      const uint8_t* buf = smem + (k & 1) * buf_bytes;
      const int k0 = table[wft::kFir2dPlaneFields * p0];
      if constexpr (Plain) {
        wft::eframe_warp(buf, es, dcopies, single ? 0 : p0, table, p0, p1, k0,
                         g.taps_c, warp, acc);
      } else {
        wft::oframe_warp(buf, dcopies, single ? 0 : p0, table, p0, p1, k0,
                         left, center, warp, acc);
      }
    }
    if (p1 >= planes) {
      wft::oframe_tile(g, it, warp, acc, epilogue, tile);
      __syncthreads();
      if constexpr (Plain) {
        wft::eframe_write(g, it, tile, vec, y, tid, wft::kOframeThreads);
      } else {
        wft::oframe_write(g, it, tile, vec, y, tid, wft::kOframeThreads);
      }
      clear();
    }
    __syncthreads();  // the buffer, the copies and the tile are read before reuse
    item = next;
    p0 = next_p0;
  }
}

__global__ void __launch_bounds__(wft::kOframeThreads)
fir2d_kernel(const uint8_t* __restrict__ x, uint8_t* __restrict__ y,
             const int8_t* __restrict__ digits, const int* __restrict__ table,
             FrameParams p) {
  extern __shared__ __align__(16) uint8_t smem[];
  frame_cta<true>(x, y, digits, table, p, smem);
}

__global__ void __launch_bounds__(wft::kOframeThreads)
fir2d_oframe_kernel(const uint8_t* __restrict__ x, uint8_t* __restrict__ y,
                    const int8_t* __restrict__ digits,
                    const int* __restrict__ table, FrameParams p) {
  extern __shared__ __align__(16) uint8_t smem[];
  frame_cta<false>(x, y, digits, table, p, smem);
}

int launch(bool plain, const void* x, void* y, long long hp, long long wp,
           const void* digits, const void* table, int planes, int taps_r,
           int taps_c, int t0, int core_h, int core_w, uint32_t bias,
           int needs_wrap, int frac_bits, int acc_bits, void* stream) {
  const bool taps_ok =
      plain ? taps_c >= 1 && taps_c <= wft::kFir2dMaxTapsC
            : taps_c > 1 && taps_c - 1 <= wft::kFir2dMaxOverlap;
  if (!frame_ok(hp, wp, taps_ok, taps_r, planes, t0, core_h, core_w,
                frac_bits, acc_bits)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  FrameParams p;
  p.g = wft::Fir2dGeometry{hp, wp, t0, core_h, core_w, taps_r, taps_c};
  const long long row_blocks = (hp + wft::kOframeRows - 1) / wft::kOframeRows;
  p.items = row_blocks * (wp / wft::kLane);
  p.planes = planes;
  p.bias = bias;
  p.needs_wrap = needs_wrap;
  p.frac_bits = frac_bits;
  p.acc_bits = acc_bits;
  p.aligned = reinterpret_cast<uintptr_t>(x) % 16 == 0;
  p.out_aligned = reinterpret_cast<uintptr_t>(y) % 16 == 0;
  const auto kernel = plain ? fir2d_kernel : fir2d_oframe_kernel;
  const size_t shared_bytes = frame_shared_bytes(plain, taps_c, planes);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(shared_bytes));
  // A persistent grid: as many CTAs as are resident at once.
  int device = 0;
  int sms = 0;
  int per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel, wft::kOframeThreads, shared_bytes);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long resident =
      static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  const unsigned grid =
      static_cast<unsigned>(p.items < resident ? p.items : resident);
  kernel<<<grid, wft::kOframeThreads, shared_bytes,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(x), static_cast<uint8_t*>(y),
      static_cast<const int8_t*>(digits), static_cast<const int*>(table), p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// digits: planes rows of taps_c int8 on the device; table: planes x (tap
// row, exponent) int32 on the device, in tap-row order.
extern "C" int wft_fir2d_frame(const void* x, void* y, long long hp,
                               long long wp, const void* digits,
                               const void* table, int planes, int taps_r,
                               int taps_c, int t0, int core_h, int core_w,
                               uint32_t bias, int needs_wrap, int frac_bits,
                               int acc_bits, void* stream) {
  return launch(true, x, y, hp, wp, digits, table, planes, taps_r, taps_c, t0,
                core_h, core_w, bias, needs_wrap, frac_bits, acc_bits, stream);
}

extern "C" int wft_fir2d_oframe(const void* x, void* y, long long hp,
                                long long wp, const void* digits,
                                const void* table, int planes, int taps_r,
                                int taps_c, int t0, int core_h, int core_w,
                                uint32_t bias, int needs_wrap, int frac_bits,
                                int acc_bits, void* stream) {
  return launch(false, x, y, hp, wp, digits, table, planes, taps_r, taps_c, t0,
                core_h, core_w, bias, needs_wrap, frac_bits, acc_bits, stream);
}
