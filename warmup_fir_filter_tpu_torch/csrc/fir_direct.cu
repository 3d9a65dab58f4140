// Kernel B: bit-exact same-mode Q-format FIR over (B, N) uint8 rows in
// direct form, for any number of taps.
//
// Replaces warmup_fir_filter_tpu/kernels/fir_pallas.py::_fir_fixed_kernel
// (:62): widen to 32 bits, L shifted multiply-adds that wrap mod 2^32, then
// the wrap / round / saturate epilogue (ops/fir1d.py:68-87).  What the
// kernel computes is that accumulator mod 2^32, by one of two routes
// chosen by tap count, each the core of another kernel of the port.  The
// host pads nothing: both routes mask the row edges themselves.
//
// Up to 32 taps (the CLI's --backend direct at 3 and 5 taps): kernel A's
// short-tap core (wft_band.cuh).  It is the direct form itself: the raw u8
// samples times the int32 taps in uint32 from bias - 128 sum(h), which is
// the rounding bias on the no-wrap path and 0 otherwise, then the shared
// epilogue.  Bound on an H100: 2 bytes of device memory a sample, 0.095 ms
// at 19,456 x 8,192, which this core reaches within 1.6x (one 128-bit load
// and store a thread for 16 outputs, the taps kernel parameters).  The
// first form staged a tile of every row and every tap in shared memory and
// paid a byte load and a 32-bit multiply-add a tap: 9.9x its bound at 5
// taps, 160 ms at 4,097 taps.
//
// Beyond (the only route past kernel C's 4,096 taps): kernel C's int8 band
// products on mma.sync m16n8k32 (wft_window.cuh), over chunks of the
// reversed taps.  The operations bound it: 2 x nonzero taps x samples at
// the int8 peak against 2 bytes a sample.  A CTA's eight warps take eight
// 512-column items; for each chunk they fold its planes' exact s32 sums
// into uint32 accumulators held in registers across the chunks, then the
// epilogue writes the items.  The CTA walks (items, chunk) steps: the next
// step's digit copies (built on the host in the shared layout) and each
// warp's next window land by cp.async into the second of two buffers while
// this step multiplies.  Each plane is trimmed to its nonzero quads within
// each chunk, so a long low-pass's high-byte plane costs its main lobe
// only.  Chunk length (kernels/fir_direct.py::pick_chunks): shared memory
// holds two chunks' copies (16 bytes a tap of a plane's trimmed range) and
// sixteen windows (512 + chunk + about 40 bytes each); the host takes the
// longest chunk (at most 4,096 taps) that leaves two CTAs an SM: on an H100
// 4,096-tap chunks beat 2,048-tap and equal-length ones at 4,097 and 8,193
// taps, though the last chunk holds one tap (PERF.md §6).  The items
// walk the chunks innermost, so no partial sum leaves the registers.

#include <array>
#include <climits>
#include <cstdint>
#include <utility>

#include <cuda_runtime.h>

#include "wft_band.cuh"
#include "wft_resident.cuh"
#include "wft_window.cuh"

namespace {

// ------------------------------------------------------- short-tap route

template <int L>
__global__ void __launch_bounds__(wft::kShortThreads)
fir_direct_short_kernel(const uint8_t* __restrict__ x,
                        uint8_t* __restrict__ y, long long total,
                        long long n, long long chunks, wft::BandShort p) {
  wft::short_thread<L>(x, y, total, n, chunks, p, blockIdx.x,
                       static_cast<int>(threadIdx.x));
}

using ShortKernel = void (*)(const uint8_t*, uint8_t*, long long, long long,
                             long long, wft::BandShort);

template <int... Is>
std::array<ShortKernel, sizeof...(Is)> short_kernels(
    std::integer_sequence<int, Is...>) {
  return {&fir_direct_short_kernel<wft::kShortInstances[Is]>...};
}

int launch_short(const uint8_t* x, uint8_t* y, long long rows, long long n,
                 int taps, const int32_t* h, uint32_t bias, int needs_wrap,
                 int frac_bits, int acc_bits, cudaStream_t stream) {
  static const std::array<ShortKernel, wft::kShortInstanceCount> kernels =
      short_kernels(
          std::make_integer_sequence<int, wft::kShortInstanceCount>{});
  if (reinterpret_cast<uintptr_t>(y) % 16 != 0) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  const int instance = wft::short_instance(taps);
  const wft::BandShort p = wft::band_short_params(
      taps, wft::kShortInstances[instance], h, bias, needs_wrap, frac_bits,
      acc_bits);
  const long long total = rows * n;
  const long long chunks = (total + wft::kShortChunk - 1) / wft::kShortChunk;
  const long long blocks =
      (chunks + wft::kShortCtaChunks - 1) / wft::kShortCtaChunks;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  kernels[instance]<<<static_cast<unsigned>(blocks), wft::kShortThreads, 0,
                      stream>>>(x, y, total, n, chunks, p);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------------ tap-chunk route

struct ChunkParams {
  int planes;
  int chunks;
  int left;       // taps - 1 - taps / 2
  uint32_t bias;  // 128 * sum(h) (+ 2^(frac_bits-1) when !needs_wrap), mod 2^32
  int needs_wrap;
  int frac_bits;
  int acc_bits;
  long long col_tiles;
  long long items;  // rows * col_tiles
  int copy_bytes;   // one copies buffer: the largest chunk's
  int buf_bytes;    // one window buffer: the largest chunk's
};

// CTA b of gridDim.x walks the item sets b, b + gridDim.x, ... (set s is
// items 8 s .. 8 s + 7, one a warp), each over chunks 0 .. chunks - 1: step
// k is chunk k mod chunks.  The chunk records of steps k, k + 1 and k + 2
// rotate through three shared slots: thread 0 writes step k + 2's after
// the barrier that ends step k - 1, whose record was in that slot.
__global__ void __launch_bounds__(wft::kWindowThreads)
fir_direct_chunks_kernel(const uint8_t* __restrict__ x,
                         uint8_t* __restrict__ y, long long n,
                         const uint32_t* __restrict__ copies,
                         const int* __restrict__ table, ChunkParams p) {
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ wft::DirectChunk ring[3];
  // Locals, not references to the parameters, which would copy them to
  // local memory.
  const int planes = p.planes;
  const int chunks = p.chunks;
  const int left = p.left;
  const size_t copy_bytes = p.copy_bytes;
  const int buf_bytes = p.buf_bytes;
  const long long col_tiles = p.col_tiles;
  const long long items = p.items;
  const int t = threadIdx.x;
  const int warp = t >> 5;
  const int lane = t & 31;
  uint8_t* bufs =
      smem + 2 * copy_bytes + 2 * warp * static_cast<size_t>(buf_bytes);
  const long long sets = (items + wft::kWindowWarps - 1) / wft::kWindowWarps;
  if (t == 0) {
    ring[0] = wft::direct_chunk(table, planes, 0);
    ring[1] = wft::direct_chunk(table, planes, 1 % chunks);
  }
  __syncthreads();
  // Stage step (set, chunk record ch) into buffers `slot`; returns the
  // warp's window offset.
  const auto stage = [&](long long set, int slot, const wft::DirectChunk& ch) {
    wft::direct_stage_copies(
        reinterpret_cast<uint32_t*>(smem + slot * copy_bytes), copies, ch, t,
        wft::kWindowThreads);
    const long long item = set * wft::kWindowWarps + warp;
    if (item >= items) return 0;
    return wft::window_stage(bufs + slot * buf_bytes, x, n, item / col_tiles,
                             item % col_tiles * wft::kWindowCols,
                             left - ch.q0, ch.lay, lane);
  };
  long long set = blockIdx.x;
  int chunk = 0;
  int off = stage(set, 0, ring[0]);
  wft::async_commit();
  wft::WindowAcc acc;
  for (long long k = 0;; ++k) {
    long long next_set = set;
    int next_chunk = chunk + 1;
    if (next_chunk == chunks) {
      next_chunk = 0;
      next_set += gridDim.x;
    }
    const bool more = next_set < sets;
    int next_off = 0;
    if (more) next_off = stage(next_set, (k + 1) & 1, ring[(k + 1) % 3]);
    wft::async_commit();
    wft::async_wait<1>();
    __syncthreads();  // this step's copies and windows are staged
    if (t == 0) {
      ring[(k + 2) % 3] =
          wft::direct_chunk(table, planes, (chunk + 2) % chunks);
    }
    const long long item = set * wft::kWindowWarps + warp;
    if (item < items) {
      if (chunk == 0) wft::window_start(acc, p.bias);
      wft::window_accumulate(
          bufs + (k & 1) * buf_bytes, off,
          reinterpret_cast<const uint32_t*>(smem + (k & 1) * copy_bytes),
          ring[k % 3].lay, acc);
      if (chunk == chunks - 1) {
        wft::window_epilogue(acc, p.needs_wrap != 0, p.frac_bits, p.acc_bits,
                             y, item / col_tiles, n,
                             item % col_tiles * wft::kWindowCols);
      }
    }
    __syncthreads();  // buffers k & 1 are read before step k + 2 restages them
    if (!more) break;
    set = next_set;
    chunk = next_chunk;
    off = next_off;
  }
}

int launch_chunks(const uint8_t* x, uint8_t* y, long long rows, long long n,
                  int taps, uint32_t bias, int needs_wrap, int frac_bits,
                  int acc_bits, const uint32_t* copies, int copy_words,
                  const int* table_device, const int* table, int chunks,
                  int planes, cudaStream_t stream) {
  static wft::ResidentCache cache;
  if (chunks < 1 || planes < 1 || planes > wft::kWindowMaxPlanes ||
      copy_words < 4) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  ChunkParams p;
  p.planes = planes;
  p.chunks = chunks;
  p.left = taps - 1 - taps / 2;
  p.bias = bias;
  p.needs_wrap = needs_wrap;
  p.frac_bits = frac_bits;
  p.acc_bits = acc_bits;
  p.copy_bytes = 0;
  p.buf_bytes = 0;
  for (int c = 0; c < chunks; ++c) {
    const int* row = table + c * wft::chunk_fields(planes);
    const int q0 = row[wft::kChunkQ0];
    const int quads_in_chunk = (taps - q0 + 3) / 4;
    // Every word a chunk reads lies inside its taps and the copy words.
    if (q0 < 0 || q0 >= taps || row[wft::kChunkCopyAt] < 0 ||
        row[wft::kChunkCopyAt] % 4 != 0) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    for (int b = 0; b < planes; ++b) {
      const int* plane = row + wft::kChunkPlanes + b * wft::kPlaneFields;
      if (plane[wft::kPlaneQuad0] < 0 || plane[wft::kPlaneQuads] < 0 ||
          plane[wft::kPlaneQuad0] + plane[wft::kPlaneQuads] > quads_in_chunk ||
          plane[wft::kPlaneQuads] > wft::kWindowMaxTaps / 4) {
        return static_cast<int>(cudaErrorInvalidValue);
      }
    }
    const wft::DirectChunk ch = wft::direct_chunk(table, planes, c);
    if (ch.copy_at + static_cast<long long>(ch.lay.copy_words) > copy_words) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    p.copy_bytes = 4 * ch.lay.copy_words > p.copy_bytes ? 4 * ch.lay.copy_words
                                                        : p.copy_bytes;
    p.buf_bytes = ch.lay.buf_bytes > p.buf_bytes ? ch.lay.buf_bytes
                                                 : p.buf_bytes;
  }
  p.col_tiles = (n + wft::kWindowCols - 1) / wft::kWindowCols;
  if (p.col_tiles > LLONG_MAX / rows) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  p.items = rows * p.col_tiles;
  const size_t shared_bytes =
      2 * static_cast<size_t>(p.copy_bytes) +
      2 * wft::kWindowWarps * static_cast<size_t>(p.buf_bytes);
  long long resident = 0;
  const cudaError_t err = wft::resident_ctas(
      fir_direct_chunks_kernel, wft::kWindowThreads, shared_bytes, cache,
      &resident);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long sets = (p.items + wft::kWindowWarps - 1) / wft::kWindowWarps;
  const long long ctas = sets < resident ? sets : resident;
  fir_direct_chunks_kernel<<<static_cast<unsigned>(ctas > 0 ? ctas : 1),
                             wft::kWindowThreads, shared_bytes, stream>>>(
      x, y, n, copies, table_device, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, y (rows, n) u8: device pointers.  Up to wft::kShortMaxTaps taps the
// short route reads h_fixed (taps int32, host); beyond, the chunk route
// reads copies (copy_words device words) and the chunk table (chunks rows
// of wft::chunk_fields(planes) ints) both on the device and, for the
// launch's shapes and checks, on the host.  The output must be 16-byte
// aligned on the short route.
extern "C" int wft_fir_direct(const void* x, void* y, long long rows,
                              long long n, int taps, const void* h_fixed,
                              uint32_t bias, int needs_wrap, int frac_bits,
                              int acc_bits, const void* copies,
                              int copy_words, const void* table_device,
                              const void* table, int chunks, int planes,
                              void* stream) {
  if (rows < 1 || n < 1 || taps < 1 || frac_bits < 1 || frac_bits > 31 ||
      acc_bits < 1 || acc_bits > 32) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (taps <= wft::kShortMaxTaps) {
    return launch_short(static_cast<const uint8_t*>(x),
                        static_cast<uint8_t*>(y), rows, n, taps,
                        static_cast<const int32_t*>(h_fixed), bias,
                        needs_wrap, frac_bits, acc_bits, s);
  }
  return launch_chunks(static_cast<const uint8_t*>(x),
                       static_cast<uint8_t*>(y), rows, n, taps, bias,
                       needs_wrap, frac_bits, acc_bits,
                       static_cast<const uint32_t*>(copies), copy_words,
                       static_cast<const int*>(table_device),
                       static_cast<const int*>(table), chunks, planes, s);
}

extern "C" const char* wft_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
