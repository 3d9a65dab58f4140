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
// Kernel E: no band matrices.  A thread owns one lane of 16 rows and walks
// the plane's Lc digits over a window staged in shared memory (16 + 15 rows
// of the three tiles around its tile), so a tall filter streams through 16
// tap rows at a time and any Lr fits.  The per-plane sums are exact in
// int32 (|s| < 2^23).  It is bound by instruction issue, about two
// instructions (a shared byte load and an integer multiply-add) per tap per
// plane per output against 2 bytes of device memory.
//
// Kernel F does what the TPU kernel does on the int8 tensor cores
// (mma.sync m16n8k32, s8 x s8 -> s32; wft_fir2d.cuh::oframe_warp): each
// plane's raw tile accumulator is one aligned band product of the tile's
// own 128 columns, and the boundary patch becomes a three-way write of the
// raw values (oframe_tile, oframe_write).  A CTA of 4 warps walks work
// items of 32 frame rows of one tile; it stages only the tile's 128 columns
// of the 39 source rows of 8 tap rows at a time, in 16-byte asynchronous
// copies (cp.async) that land while the previous item or chunk multiplies,
// keeps the planes' shifted digit copies in shared memory, built once when
// all planes' tap rows fit one chunk, and writes the output in 16-byte
// stores.  What bounds it on an H100: 2 bytes of device memory an output
// against about 6 planes x 1.5 k32 chunks of MMA work; what holds it is
// instruction issue (the guards and folds around the few MMAs of a plane)
// and the latency between a CTA's barriers.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

#include "wft_fir2d.cuh"

namespace {

constexpr int kMaxGridY = 65535;

__global__ void __launch_bounds__(wft::kLane)
fir2d_kernel(const uint8_t* __restrict__ x, uint8_t* __restrict__ y,
             wft::Fir2dGeometry g, const int8_t* __restrict__ digits,
             const int* __restrict__ table, int planes, uint32_t bias,
             int needs_wrap, int frac_bits, int acc_bits) {
  __shared__ uint8_t xs[wft::kFir2dWinRows * wft::kFir2dWinCols];
  const long long c = blockIdx.x;
  const int i = threadIdx.x;
  for (long long r0 = static_cast<long long>(blockIdx.y) * wft::kFir2dRows;
       r0 < g.hp; r0 += static_cast<long long>(gridDim.y) * wft::kFir2dRows) {
    if (wft::fir2d_cta_is_zero(g, c, r0)) {
      wft::fir2d_store_zero(g, y, c, r0, i);
      continue;
    }
    const wft::Fir2dLane s = wft::fir2d_lane(g, c, i);
    uint32_t acc[wft::kFir2dRows];
#pragma unroll
    for (int r = 0; r < wft::kFir2dRows; ++r) acc[r] = bias;
    for (int p = 0; p < planes;) {
      const int k0 = table[wft::kFir2dPlaneFields * p];
      __syncthreads();  // the previous chunk's window is consumed
      for (int u = 0; u < wft::kFir2dWinRows; ++u) {
        const uint8_t* row = wft::fir2d_window_row(x, g, c, r0, k0, u);
        for (int v = i; v < wft::kFir2dWinCols; v += wft::kLane) {
          xs[u * wft::kFir2dWinCols + v] = row ? row[v] : 0;
        }
      }
      __syncthreads();
      p = wft::fir2d_int_planes(xs, s, digits, table, planes, p, k0, g.taps_c,
                                acc);
    }
    wft::fir2d_int_store(g, s, acc, needs_wrap != 0, frac_bits, acc_bits, y,
                         c, r0, i);
  }
}

bool frame_ok(long long hp, long long wp, bool taps_ok, int taps_r,
              int planes, int t0, int core_h, int core_w, int frac_bits,
              int acc_bits) {
  return hp >= 1 && wp >= 2 * wft::kLane && wp % wft::kLane == 0 && taps_ok &&
         taps_r >= 1 && planes >= 0 && t0 >= 1 && core_h >= 0 &&
         core_w >= 0 && frac_bits >= 1 && frac_bits <= 31 && acc_bits >= 1 &&
         acc_bits <= 32 && wp / wft::kLane <= INT_MAX;
}

struct OframeParams {
  wft::Fir2dGeometry g;
  long long items;
  int planes;
  uint32_t bias;
  int needs_wrap, frac_bits, acc_bits;
  int aligned;      // the frame is 16-byte aligned: stage with cp.async
  int out_aligned;  // the output is 16-byte aligned: write 16-byte chunks
};

__global__ void __launch_bounds__(wft::kOframeThreads)
fir2d_oframe_kernel(const uint8_t* __restrict__ x, uint8_t* __restrict__ y,
                    const int8_t* __restrict__ digits,
                    const int* __restrict__ table, OframeParams p) {
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* tile = smem + 2 * wft::kOframeBufBytes;
  uint32_t* dcopies = reinterpret_cast<uint32_t*>(tile + wft::kOframeTileBytes);
  // Locals, not references to the parameters, which would copy them to
  // local memory.
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
  // All planes in one chunk: their digit copies are built once.
  const bool single =
      planes > 0 && wft::oframe_chunk_end(table, planes, 0) == planes;
  if (single) {
    for (int i = tid; i < planes * wft::kOframePlaneWords;
         i += wft::kOframeThreads) {
      dcopies[i] = wft::oframe_copy_word(digits, g.taps_c,
                                         i / wft::kOframePlaneWords,
                                         i % wft::kOframePlaneWords);
    }
  }
  const auto computes = [&](const wft::OframeItem& it) {
    return !it.zero && planes > 0;
  };
  const auto stage = [&](long long item, int p0, uint8_t* buf) {
    const wft::OframeItem it = wft::oframe_item(g, item);
    if (computes(it)) {
      wft::oframe_stage(buf, x, g, it.c, it.r0,
                        table[wft::kFir2dPlaneFields * p0], aligned, tid,
                        wft::kOframeThreads);
    }
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
    if (next < items) {
      stage(next, next_p0, smem + ((k + 1) & 1) * wft::kOframeBufBytes);
    }
    wft::async_commit();
    wft::async_wait<1>();
    if (!single && computes(it)) {
      for (int i = tid; i < (p1 - p0) * wft::kOframePlaneWords;
           i += wft::kOframeThreads) {
        dcopies[i] = wft::oframe_copy_word(digits, g.taps_c,
                                           p0 + i / wft::kOframePlaneWords,
                                           i % wft::kOframePlaneWords);
      }
    }
    __syncthreads();
    if (computes(it)) {
      wft::oframe_warp(smem + (k & 1) * wft::kOframeBufBytes, dcopies,
                       single ? 0 : p0, table, p0, p1,
                       table[wft::kFir2dPlaneFields * p0], left, center, warp,
                       acc);
    }
    if (p1 >= planes) {
      wft::oframe_tile(g, it, warp, acc, p.needs_wrap != 0, p.frac_bits,
                       p.acc_bits, tile);
      __syncthreads();
      wft::oframe_write(g, it, tile, vec, y, tid, wft::kOframeThreads);
      clear();
    }
    __syncthreads();  // the buffer, the copies and the tile are read before reuse
    item = next;
    p0 = next_p0;
  }
}

int launch_frame(const void* x, void* y, long long hp, long long wp,
                 const void* digits, const void* table, int planes,
                 int taps_r, int taps_c, int t0, int core_h, int core_w,
                 uint32_t bias, int needs_wrap, int frac_bits, int acc_bits,
                 void* stream) {
  if (!frame_ok(hp, wp, taps_c >= 1 && taps_c <= wft::kFir2dMaxTapsC, taps_r,
                planes, t0, core_h, core_w, frac_bits, acc_bits)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const wft::Fir2dGeometry g{hp, wp, t0, core_h, core_w, taps_r, taps_c, 0};
  const long long row_blocks = (hp + wft::kFir2dRows - 1) / wft::kFir2dRows;
  const dim3 grid(static_cast<unsigned>(wp / wft::kLane),
                  static_cast<unsigned>(row_blocks < kMaxGridY ? row_blocks
                                                               : kMaxGridY));
  fir2d_kernel<<<grid, wft::kLane, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(x), static_cast<uint8_t*>(y), g,
      static_cast<const int8_t*>(digits), static_cast<const int*>(table),
      planes, bias, needs_wrap, frac_bits, acc_bits);
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
  return launch_frame(x, y, hp, wp, digits, table, planes, taps_r, taps_c, t0,
                      core_h, core_w, bias, needs_wrap, frac_bits, acc_bits,
                      stream);
}

extern "C" int wft_fir2d_oframe(const void* x, void* y, long long hp,
                                long long wp, const void* digits,
                                const void* table, int planes, int taps_r,
                                int taps_c, int t0, int core_h, int core_w,
                                uint32_t bias, int needs_wrap, int frac_bits,
                                int acc_bits, void* stream) {
  if (!frame_ok(hp, wp,
                taps_c > 1 && taps_c - 1 <= wft::kFir2dMaxOverlap, taps_r,
                planes, t0, core_h, core_w, frac_bits, acc_bits)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  OframeParams p;
  p.g = wft::Fir2dGeometry{hp, wp, t0, core_h, core_w, taps_r, taps_c, 1};
  const long long row_blocks = (hp + wft::kOframeRows - 1) / wft::kOframeRows;
  p.items = row_blocks * (wp / wft::kLane);
  p.planes = planes;
  p.bias = bias;
  p.needs_wrap = needs_wrap;
  p.frac_bits = frac_bits;
  p.acc_bits = acc_bits;
  p.aligned = reinterpret_cast<uintptr_t>(x) % 16 == 0;
  p.out_aligned = reinterpret_cast<uintptr_t>(y) % 16 == 0;
  const int chunk_planes =
      planes < wft::kOframeMaxChunkPlanes ? planes : wft::kOframeMaxChunkPlanes;
  const size_t shared_bytes =
      2 * static_cast<size_t>(wft::kOframeBufBytes) + wft::kOframeTileBytes +
      4 * static_cast<size_t>(chunk_planes) * wft::kOframePlaneWords;
  cudaError_t err = cudaFuncSetAttribute(
      fir2d_oframe_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
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
        &per_sm, fir2d_oframe_kernel, wft::kOframeThreads, shared_bytes);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long resident =
      static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  const unsigned grid =
      static_cast<unsigned>(p.items < resident ? p.items : resident);
  fir2d_oframe_kernel<<<grid, wft::kOframeThreads, shared_bytes,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(x), static_cast<uint8_t*>(y),
      static_cast<const int8_t*>(digits), static_cast<const int*>(table), p);
  return static_cast<int>(cudaGetLastError());
}
