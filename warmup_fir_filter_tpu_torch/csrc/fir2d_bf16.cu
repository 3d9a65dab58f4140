// Kernel G: the 2-D FIR over an overlapped frame with bf16 taps and f32
// sums, output frame for input frame.
//
// Replaces warmup_fir_filter_tpu/kernels/fir2d_mxu.py::
// _fir2d_oframe_bf16_kernel (:1000; entry fir2d_frame_overlap_bf16 :1137).
// As there, each tap row's quantized taps ride as bf16 values (rounded to
// nearest even on the host), the samples as bf16 without rebias, each row
// gives one f32 band product per tile, the rows are added in order and the
// float epilogue floor(acc * 2^-fb + 0.5), clipped to [0, 255], replaces
// the integer one; the boundary lanes and the masks are K7's
// (wft_fir2d.cuh::oframe_write).  Every product is exact in f32, so where
// bf16_2d_exact() holds (all sums below 2^24) the output is bit-exact
// against the golden; elsewhere the order of the sums, which differs from
// the TPU's matrix unit and from the plain version's matmul, may move an
// output by one.
//
// The design is kernel F's (fir2d_frame.cu) on the bf16 tensor cores: each
// tap row's band product of the tile's own 128 columns on mma.sync
// m16n8k16 (bf16 x bf16 -> f32; wft_fir2d.cuh::bf16_warp) in its own f32
// fragment, a persistent CTA of 4 warps on 32-row items, the source rows of
// 8 tap rows staged by 16-byte cp.async (byte by byte for a frame that is
// not 16-byte aligned) into one buffer while the previous chunk multiplies,
// widened once to bf16 into a second (bf16_widen: an A word is then one
// shared load), two shifted bf16 copies of each row's reversed taps, and
// the output through a shared tile, written three ways for K7's patch in
// 16-byte stores where the output is aligned.  What bounds it on an H100:
// 2 bytes of device memory an output; the bf16 products (a 5 x 5 filter is
// 5 rows x 1-2 k16 chunks an n8 tile of 16 rows) come to under a tenth of
// that at the dense bf16 rate.  Issue around the MMAs, the latency between
// the CTA's barriers and the byte-wise stores of the boundary patch hold it
// several times above the bytes, as they hold F.

#include <climits>
#include <cmath>
#include <cstdint>

#include <cuda_runtime.h>

#include "wft_fir2d.cuh"

namespace {

struct Bf16Params {
  wft::Fir2dGeometry g;
  long long items;
  int rows;
  float scale;      // 2^-frac_bits
  int aligned;      // the frame is 16-byte aligned: stage with cp.async
  int out_aligned;  // the output is 16-byte aligned: write 16-byte chunks
};

__global__ void __launch_bounds__(wft::kOframeThreads)
fir2d_bf16_kernel(const uint8_t* __restrict__ x, uint8_t* __restrict__ y,
                  const float* __restrict__ w, const int* __restrict__ table,
                  Bf16Params p) {
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* raw = smem;
  uint8_t* wide = raw + wft::kOframeBufBytes;
  uint8_t* tile = wide + wft::kBf16BufBytes;
  uint32_t* wcopies = reinterpret_cast<uint32_t*>(tile + wft::kOframeTileBytes);
  // Locals, not references to the parameters, which would copy them to
  // local memory.
  const wft::Fir2dGeometry g = p.g;
  const long long items = p.items;
  const int rows = p.rows;
  const float scale = p.scale;
  const bool aligned = p.aligned != 0;
  const bool vec = p.out_aligned != 0;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int center = g.taps_c / 2;
  const int left = g.taps_c - 1 - center;
  const auto build = [&](int p0, int p1) {
    for (int i = tid; i < (p1 - p0) * wft::kBf16RowWords;
         i += wft::kOframeThreads) {
      wcopies[i] = wft::bf16_copy_word(w, g.taps_c, p0 + i / wft::kBf16RowWords,
                                       i % wft::kBf16RowWords);
    }
  };
  // All tap rows in one chunk: their copies are built once.
  const bool single =
      rows > 0 && wft::oframe_chunk_end<1>(table, rows, 0) == rows;
  if (single) build(0, rows);
  const auto computes = [&](const wft::OframeItem& it) {
    return !it.zero && rows > 0;
  };
  const auto stage = [&](long long item, int p0) {
    const wft::OframeItem it = wft::oframe_item(g, item);
    if (computes(it)) {
      wft::oframe_stage(raw, x, g, it.c, it.r0, table[p0], aligned, tid,
                        wft::kOframeThreads);
    }
  };
  const auto epilogue = [=](float a) { return wft::bf16_epilogue(a, scale); };
  float acc[wft::kOframeNTiles][wft::kLaneSlots][4];
  const auto clear = [&]() {
#pragma unroll
    for (int n = 0; n < wft::kOframeNTiles; ++n) {
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[n][0][j] = 0.0f;
    }
  };
  clear();
  long long item = blockIdx.x;
  int p0 = 0;
  if (item < items) stage(item, 0);
  wft::async_commit();
  while (item < items) {
    const wft::OframeItem it = wft::oframe_item(g, item);
    const int p1 = computes(it) ? wft::oframe_chunk_end<1>(table, rows, p0)
                                : rows;
    long long next = item;
    int next_p0 = p1;
    if (p1 >= rows) {
      next = item + gridDim.x;
      next_p0 = 0;
    }
    // The chunk's rows have landed; the last chunk's products, copies and
    // tile are read.
    wft::async_wait<0>();
    __syncthreads();
    if (computes(it)) {
      wft::bf16_widen(raw, wide, tid, wft::kOframeThreads);
      if (!single) build(p0, p1);
    }
    __syncthreads();
    // The next chunk's rows land while this one multiplies.
    if (next < items) stage(next, next_p0);
    wft::async_commit();
    if (computes(it)) {
      wft::bf16_warp(wide, wcopies, single ? 0 : p0, table, p0, p1, table[p0],
                     left, center, warp, acc);
    }
    if (p1 >= rows) {
      wft::oframe_tile(g, it, warp, acc, epilogue, tile);
      __syncthreads();
      wft::oframe_write(g, it, tile, vec, y, tid, wft::kOframeThreads);
      clear();
    }
    item = next;
    p0 = next_p0;
  }
}

}  // namespace

// w: rows x taps_c f32 (bf16-exact) on the device; table: the tap row of
// each, int32 on the device, in tap-row order.
extern "C" int wft_fir2d_bf16(const void* x, void* y, long long hp,
                              long long wp, const void* w, const void* table,
                              int rows, int taps_r, int taps_c, int t0,
                              int core_h, int core_w, int frac_bits,
                              void* stream) {
  if (hp < 1 || wp < 2 * wft::kLane || wp % wft::kLane || taps_r < 1 ||
      taps_c < 2 || taps_c - 1 > wft::kFir2dMaxOverlap || rows < 0 || t0 < 1 ||
      core_h < 0 || core_w < 0 || frac_bits < 0 || frac_bits > 126 ||
      wp / wft::kLane > INT_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Bf16Params p;
  p.g = wft::Fir2dGeometry{hp, wp, t0, core_h, core_w, taps_r, taps_c};
  const long long row_blocks = (hp + wft::kOframeRows - 1) / wft::kOframeRows;
  p.items = row_blocks * (wp / wft::kLane);
  p.rows = rows;
  p.scale = ldexpf(1.0f, -frac_bits);
  p.aligned = reinterpret_cast<uintptr_t>(x) % 16 == 0;
  p.out_aligned = reinterpret_cast<uintptr_t>(y) % 16 == 0;
  const int chunk_rows = rows < wft::kOframeChunk ? rows : wft::kOframeChunk;
  const size_t shared_bytes =
      wft::kOframeBufBytes + wft::kBf16BufBytes + wft::kOframeTileBytes +
      4 * static_cast<size_t>(chunk_rows) * wft::kBf16RowWords;
  cudaError_t err = cudaFuncSetAttribute(
      fir2d_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
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
        &per_sm, fir2d_bf16_kernel, wft::kOframeThreads, shared_bytes);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long resident =
      static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  const unsigned grid =
      static_cast<unsigned>(p.items < resident ? p.items : resident);
  fir2d_bf16_kernel<<<grid, wft::kOframeThreads, shared_bytes,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(x), static_cast<uint8_t*>(y),
      static_cast<const float*>(w), static_cast<const int*>(table), p);
  return static_cast<int>(cudaGetLastError());
}
