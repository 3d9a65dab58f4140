"""Kernel B's encodings, plain version and cores against the JAX K4 kernel.

Kernel B (``csrc/fir_direct.cu``) computes K4's int32 accumulator mod 2^32
by two routes: up to 32 taps kernel A's short-tap core, beyond it kernel
C's int8 band-MMA warp core over chunks of the reversed taps.  These tests
hold ``fir_direct_plain`` (the routes' encodings in exact float64 products)
against ``fir1d_fixed_rows_pallas`` run in interpret mode, the independent
``fir1d_fixed_rows_torch`` and the golden; the host-built digit copies
against kernel C's own ``window_copy_word``; and both routes' cores
(``csrc/wft_band.cuh``, ``csrc/wft_window.cuh``, built with g++ and run
over every CTA, warp and lane, ``mma.sync`` emulated from its PTX fragment
layout) against the golden and ``fir1d_fixed_rows_torch``, the chunk route
with a chunk length set small (64 taps) so that short filters walk many
chunks.  The CUDA kernel itself is held to its plain version, to kernels A
and C and to the golden on the card by ``chip_smoke.py``.

Tolerance: every comparison is ``np.array_equal`` (tolerance 0).
"""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from warmup_fir_filter_tpu.kernels.fir_pallas import fir1d_fixed_rows_pallas
from warmup_fir_filter_tpu.models.golden import fir1d_fixed_golden_rows
from warmup_fir_filter_tpu.ops.qformat import QFormat as JaxQFormat
from warmup_fir_filter_tpu.ops.resample import design_lowpass
from warmup_fir_filter_tpu_torch import _build
from warmup_fir_filter_tpu_torch.kernels import fir_direct as direct
from warmup_fir_filter_tpu_torch.kernels.fir_window import kernel_digit_words
from warmup_fir_filter_tpu_torch.ops.fir1d import fir1d_fixed_rows_torch
from warmup_fir_filter_tpu_torch.ops.qformat import QFormat

#: chip_smoke.py's FORMATS: the default, wrapping accumulators (acc_bits
#: 16-28), one to five digit planes.
FORMATS = [QFormat(8, 4, 32), QFormat(8, 7, 16), QFormat(16, 12, 32),
           QFormat(16, 12, 20), QFormat(16, 8, 24), QFormat(32, 24, 32),
           QFormat(32, 12, 28)]


def _taps(rng, qf: QFormat, num_taps: int, scale: float = 1.0) -> np.ndarray:
    span = min(qf.max_coeff_real, 8.0)
    return np.clip(rng.uniform(-span, span, size=num_taps) * scale,
                   max(qf.min_coeff_real, -8.0), span)


def _plain(x: np.ndarray, h, qf: QFormat, chunk_taps=None):
    fir = direct.FixedFirDirect(h, qf, chunk_taps=chunk_taps)
    return direct.fir_direct_plain(torch.from_numpy(x), fir).numpy()


@pytest.mark.parametrize("num_taps", [5, 33, 300, 4097])
def test_plain_matches_jax_pallas(rng, num_taps):
    """K4 in interpret mode (4,097 taps unroll into one long XLA program:
    about a minute), the independent int32 path and the golden."""
    qf = QFormat(16, 12, 24)
    h = _taps(rng, qf, num_taps, scale=1.0 if num_taps < 100 else 1 / 64)
    x = rng.integers(0, 256, size=(2, 333), dtype=np.uint8)
    want = np.asarray(fir1d_fixed_rows_pallas(x, h, JaxQFormat(16, 12, 24),
                                              block_rows=8, interpret=True))
    got = _plain(x, h, qf)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        fir1d_fixed_rows_torch(torch.from_numpy(x), h, qf).numpy(), want)
    np.testing.assert_array_equal(got, fir1d_fixed_golden_rows(x, h, qf))


@pytest.mark.parametrize("qf", FORMATS, ids=str)
def test_plain_routes_golden(rng, qf):
    """Both routes at every format, chunk lengths from 64 to 4,096, ragged
    widths and widths shorter than the filter."""
    for num_taps, chunk, width in ((1, 64, 9), (5, 64, 300), (32, 64, 31),
                                   (33, 64, 300), (300, 64, 127),
                                   (1001, 64, 1000), (1001, 4096, 40),
                                   (4097, 2048, 700)):
        h = _taps(rng, qf, num_taps, scale=1.0 if num_taps < 100 else 1 / 64)
        x = rng.integers(0, 256, size=(2, width), dtype=np.uint8)
        np.testing.assert_array_equal(
            _plain(x, h, qf, chunk), fir1d_fixed_golden_rows(x, h, qf),
            err_msg=f"L={num_taps} chunk={chunk} N={width} {qf}")


def test_chunk_table_trims_each_plane(rng):
    """A 1,001-tap low-pass in chunks of 64: every chunk keeps the planes
    and exponents of the whole filter, the high-byte plane is nonzero in
    the main lobe's chunks only, and each plane's quads lie in its chunk."""
    qf = QFormat()
    fir = direct.FixedFirDirect(design_lowpass(1001, 0.25), qf,
                                chunk_taps=64)
    table = fir.chunk_table.numpy()
    planes = len(fir.exponents)
    assert planes == 2 and table.shape == (16, 2 + 4 * planes)
    assert [int(q0) for q0 in table[:, 1]] == [q for q, _ in fir.chunks()]
    fields = table[:, 2:].reshape(16, planes, 4)
    assert (fields[:, :, 0] == np.asarray(fir.exponents)).all()
    high = fields[:, 1, 2]
    assert 0 < np.count_nonzero(high) < 8
    assert (fields[:, :, 1] + fields[:, :, 2] <= 16).all()
    assert (np.diff(table[:, 0]) % 4 == 0).all()
    assert fir.copies.numel() >= table[-1, 0]


@pytest.mark.parametrize("num_taps,chunks", [(33, 1), (4096, 1), (4097, 2),
                                             (8193, 3), (20000, 5)])
def test_pick_chunks_longest_within_two_ctas(num_taps, chunks):
    """A two-plane low-pass takes 4,096-tap chunks (a CTA leaves two an
    SM); a filter of five planes takes shorter ones that still fit."""
    h = design_lowpass(num_taps, 0.25)
    fir = direct.FixedFirDirect(h)
    assert len(fir.exponents) == 2
    assert fir.chunk_taps == 4096
    assert fir.chunk_table.shape[0] == chunks == len(fir.chunks())
    table = fir.chunk_table.numpy()
    assert direct.chunk_shared_bytes(table) <= direct.SHARED_TARGET
    wide = direct.FixedFirDirect(h, QFormat(32, 30, 32))
    assert len(wide.exponents) >= 4
    assert wide.chunk_taps in direct.CHUNK_LADDER
    assert direct.chunk_shared_bytes(wide.chunk_table.numpy()) <= \
        direct.SHARED_TARGET
    if num_taps > 4096:
        assert wide.chunk_taps < 4096


def test_short_filters_keep_no_chunks():
    fir = direct.FixedFirDirect([0.25, 0.5, 0.25])
    assert fir.short and fir.chunk_table.shape[0] == 1
    assert fir.copies.numel() == 4
    assert not direct.FixedFirDirect(np.ones(33) / 33).short


def test_chunk_length_validated():
    for chunk in (0, 6, 4100):
        with pytest.raises(ValueError, match="chunk_taps"):
            direct.FixedFirDirect(np.ones(40) / 40, chunk_taps=chunk)


def test_wide_accumulator_refused():
    with pytest.raises(ValueError, match="acc_bits"):
        direct.FixedFirDirect([0.5, 0.5], QFormat(32, 12, 40))


def test_module_buffers_move_with_the_module():
    fir = direct.FixedFirDirect(design_lowpass(300, 0.2))
    assert set(fir.state_dict()) == {"h_fixed", "bias", "needs_wrap",
                                     "digits", "copies", "chunk_table"}
    moved = fir.to("meta")
    assert moved.copies.device.type == "meta"
    assert moved.chunk_table.device.type == "meta"


def test_cpu_tensor_runs_the_plain_version(rng):
    h = design_lowpass(40, 0.2)
    x = torch.from_numpy(rng.integers(0, 256, size=(3, 200), dtype=np.uint8))
    before = direct.fir_direct.launches
    got = direct.fir_direct(x, h)
    assert direct.fir_direct.launches == before
    np.testing.assert_array_equal(got.numpy(),
                                  fir1d_fixed_golden_rows(x.numpy(), h))


_HARNESS = r"""
#include <array>
#include <cstdint>
#include <utility>
#include <vector>

#include "wft_band.cuh"
#include "wft_window.cuh"

namespace {

template <int L>
void short_ctas(const uint8_t* x, uint8_t* y, long long total, long long n,
                const wft::BandShort& p) {
  const long long chunks = (total + wft::kShortChunk - 1) / wft::kShortChunk;
  const long long ctas =
      (chunks + wft::kShortCtaChunks - 1) / wft::kShortCtaChunks;
  for (long long b = 0; b < ctas; ++b)
    for (int t = 0; t < wft::kShortThreads; ++t)
      wft::short_thread<L>(x, y, total, n, chunks, p, b, t);
}

using Short = void (*)(const uint8_t*, uint8_t*, long long, long long,
                       const wft::BandShort&);

template <int... Is>
std::array<Short, sizeof...(Is)> short_table(
    std::integer_sequence<int, Is...>) {
  return {&short_ctas<wft::kShortInstances[Is]>...};
}

}  // namespace

// fir_direct.cu's short route: launch_short's parameters, every thread of
// every CTA.
extern "C" void direct_short_host(const uint8_t* x, uint8_t* y,
                                  long long rows, long long n, int taps,
                                  const int32_t* h, uint32_t bias, int wrap,
                                  int frac_bits, int acc_bits) {
  static const auto table = short_table(
      std::make_integer_sequence<int, wft::kShortInstanceCount>{});
  const int i = wft::short_instance(taps);
  table[i](x, y, rows * n, n,
           wft::band_short_params(taps, wft::kShortInstances[i], h, bias,
                                  wrap, frac_bits, acc_bits));
}

// fir_direct.cu's chunk route: `ctas` CTAs, each walking its item sets over
// the chunks as the kernel's CTAs do, with its two copy buffers, each warp's
// two window buffers and the ring of three chunk records; a warp's lanes as
// one unit.  Returns the item sets.
extern "C" long long direct_chunks_host(
    const uint8_t* x, uint8_t* y, long long rows, long long n, int taps,
    uint32_t bias, int wrap, int frac_bits, int acc_bits,
    const uint32_t* copies, const int* table, int chunks, int planes,
    int ctas) {
  constexpr int kWarps = wft::kWindowWarps;
  int copy_bytes = 0, buf_bytes = 0;
  for (int c = 0; c < chunks; ++c) {
    const wft::DirectChunk ch = wft::direct_chunk(table, planes, c);
    if (4 * ch.lay.copy_words > copy_bytes) copy_bytes = 4 * ch.lay.copy_words;
    if (ch.lay.buf_bytes > buf_bytes) buf_bytes = ch.lay.buf_bytes;
  }
  const long long col_tiles = (n + wft::kWindowCols - 1) / wft::kWindowCols;
  const long long items = rows * col_tiles;
  const long long sets = (items + kWarps - 1) / kWarps;
  const int left = taps - 1 - taps / 2;
  std::vector<uint32_t> words((2 * copy_bytes + 2 * kWarps * buf_bytes) / 4 + 4);
  uint8_t* smem = reinterpret_cast<uint8_t*>(words.data());
  std::vector<uint32_t> acc_words(kWarps * sizeof(wft::WindowAcc) / 4);
  auto* acc = reinterpret_cast<wft::WindowAcc*>(acc_words.data());
  const auto buf = [&](int warp, int slot) {
    return smem + 2 * copy_bytes + (2 * warp + slot) * buf_bytes;
  };
  for (long long b = 0; b < ctas && b < sets; ++b) {
    wft::DirectChunk ring[3];
    ring[0] = wft::direct_chunk(table, planes, 0);
    ring[1] = wft::direct_chunk(table, planes, 1 % chunks);
    const auto stage = [&](long long set, int slot, const wft::DirectChunk& ch,
                           int* offs) {
      for (int t = 0; t < wft::kWindowThreads; ++t) {
        wft::direct_stage_copies(
            reinterpret_cast<uint32_t*>(smem + slot * copy_bytes), copies, ch,
            t, wft::kWindowThreads);
      }
      for (int w = 0; w < kWarps; ++w) {
        const long long item = set * kWarps + w;
        offs[w] = 0;
        if (item >= items) continue;
        for (int lane = 0; lane < wft::kWarp; ++lane) {
          offs[w] = wft::window_stage(buf(w, slot), x, n, item / col_tiles,
                                      item % col_tiles * wft::kWindowCols,
                                      left - ch.q0, ch.lay, lane);
        }
      }
    };
    long long set = b;
    int chunk = 0;
    int off[kWarps], next_off[kWarps];
    stage(set, 0, ring[0], off);
    for (long long k = 0;; ++k) {
      long long next_set = set;
      int next_chunk = chunk + 1;
      if (next_chunk == chunks) {
        next_chunk = 0;
        next_set += ctas;
      }
      const bool more = next_set < sets;
      if (more) stage(next_set, (k + 1) & 1, ring[(k + 1) % 3], next_off);
      ring[(k + 2) % 3] = wft::direct_chunk(table, planes, (chunk + 2) % chunks);
      for (int w = 0; w < kWarps; ++w) {
        const long long item = set * kWarps + w;
        if (item >= items) continue;
        if (chunk == 0) wft::window_start(acc[w], bias);
        wft::window_accumulate(
            buf(w, k & 1), off[w],
            reinterpret_cast<const uint32_t*>(smem + (k & 1) * copy_bytes),
            ring[k % 3].lay, acc[w]);
        if (chunk == chunks - 1) {
          wft::window_epilogue(acc[w], wrap != 0, frac_bits, acc_bits, y,
                               item / col_tiles, n,
                               item % col_tiles * wft::kWindowCols);
        }
      }
      if (!more) break;
      set = next_set;
      chunk = next_chunk;
      for (int w = 0; w < kWarps; ++w) off[w] = next_off[w];
    }
  }
  return sets;
}

// The chunk route's shared memory, as launch_chunks sizes it: two copy
// buffers and two windows a warp, each the largest chunk's.
extern "C" long long chunk_shared_host(const int* table, int chunks,
                                       int planes) {
  int copy_bytes = 0, buf_bytes = 0;
  for (int c = 0; c < chunks; ++c) {
    const wft::DirectChunk ch = wft::direct_chunk(table, planes, c);
    if (4 * ch.lay.copy_words > copy_bytes) copy_bytes = 4 * ch.lay.copy_words;
    if (ch.lay.buf_bytes > buf_bytes) buf_bytes = ch.lay.buf_bytes;
  }
  return 2LL * copy_bytes + 2LL * wft::kWindowWarps * buf_bytes;
}

// Kernel C's shifted digit copies of packed digit words and a plane table
// (fir_window.kernel_digit_words): its window_copy_word over the layout.
extern "C" int copy_words_host(const uint32_t* digits, const int* table,
                               int planes, uint32_t* out) {
  const wft::WindowLayout lay = wft::window_layout(table, planes);
  for (int i = 0; i < lay.copy_words; ++i) {
    out[i] = wft::window_copy_word(digits, lay, i);
  }
  return lay.copy_words;
}
"""


@pytest.fixture(scope="module")
def cores(tmp_path_factory):
    """Kernel B's routes (``csrc/wft_band.cuh``, ``csrc/wft_window.cuh``)
    built with g++."""
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed")
    work = tmp_path_factory.mktemp("fir_direct")
    (work / "harness.cpp").write_text(_HARNESS)
    subprocess.run(["g++", "-std=c++17", "-O2", "-shared", "-fPIC",
                    "-I", str(_build.CSRC_DIR), "-o", str(work / "lib.so"),
                    str(work / "harness.cpp")], check=True, timeout=240)
    lib = ctypes.CDLL(str(work / "lib.so"))
    vp, ll, i32, u32 = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                        ctypes.c_uint32)
    lib.direct_short_host.argtypes = [vp, vp, ll, ll, i32, vp, u32, i32, i32,
                                      i32]
    lib.direct_chunks_host.argtypes = [vp, vp, ll, ll, i32, u32, i32, i32,
                                       i32, vp, vp, i32, i32, i32]
    lib.direct_chunks_host.restype = ll
    lib.copy_words_host.argtypes = [vp, vp, i32, vp]
    lib.chunk_shared_host.argtypes = [vp, i32, i32]
    lib.chunk_shared_host.restype = ll

    def run(x: np.ndarray, fir: direct.FixedFirDirect,
            ctas: int = 2) -> np.ndarray:
        """Kernel B's route for ``fir`` on ``x`` (C-contiguous, at any byte
        offset); the output starts as 0xAB (16-byte aligned), so an
        unwritten byte shows."""
        assert x.flags.c_contiguous
        rows, n = x.shape
        store = np.full(x.size + 32, 0xAB, np.uint8)
        y = store[(-store.ctypes.data) % 16:][: x.size]
        qf = fir.qformat
        if fir.short:
            taps = np.ascontiguousarray(fir.h_fixed.numpy())
            lib.direct_short_host(x.ctypes.data, y.ctypes.data, rows, n,
                                  fir.num_taps, taps.ctypes.data,
                                  fir.bias_value & 0xFFFFFFFF, int(fir.wrap),
                                  qf.frac_bits, qf.acc_bits)
        else:
            copies = np.ascontiguousarray(fir.copies.numpy())
            table = np.ascontiguousarray(fir.chunk_table.numpy())
            lib.direct_chunks_host(
                x.ctypes.data, y.ctypes.data, rows, n, fir.num_taps,
                fir.bias_value & 0xFFFFFFFF, int(fir.wrap), qf.frac_bits,
                qf.acc_bits, copies.ctypes.data, table.ctypes.data,
                table.shape[0], len(fir.exponents), ctas)
        return y.reshape(rows, n).copy()

    run.copy_words = lib.copy_words_host
    run.shared_bytes = lib.chunk_shared_host
    return run


@pytest.mark.parametrize("qf", FORMATS + [QFormat(16, 12, 16)], ids=str)
@pytest.mark.parametrize("num_taps", [300, 1001])
def test_chunk_core_many_chunks(cores, rng, qf, num_taps):
    """The chunk route in chunks of 64 taps (5 and 16 chunks), on 9 rows
    of 1,500 (27 items, so each of two CTAs walks two item sets), against
    the independent int32 path and the golden; wrapping and no-wrap
    accumulators, one to five planes."""
    h = _taps(rng, qf, num_taps, scale=1 / 64)
    fir = direct.FixedFirDirect(h, qf, chunk_taps=64)
    x = rng.integers(0, 256, size=(9, 1500), dtype=np.uint8)
    got = cores(x, fir)
    np.testing.assert_array_equal(
        got, fir1d_fixed_rows_torch(torch.from_numpy(x), h, qf).numpy(),
        err_msg=f"L={num_taps} {qf}")
    np.testing.assert_array_equal(got, fir1d_fixed_golden_rows(x, h, qf))


@pytest.mark.parametrize("chunk", [32, 64, 128, 2048])
def test_chunk_core_lowpass(cores, rng, chunk):
    """The low-pass of ``bench_taps.py`` (trimmed high-byte plane, chunks
    whose planes are all zero at the ends) at several chunk lengths, rows
    of widths around the 512-column item, one CTA walking every set."""
    h = design_lowpass(1001, 0.25)
    fir = direct.FixedFirDirect(h, QFormat(), chunk_taps=chunk)
    for rows, width in ((1, 1), (3, 511), (2, 513), (17, 700)):
        x = rng.integers(0, 256, size=(rows, width), dtype=np.uint8)
        np.testing.assert_array_equal(
            cores(x, fir, ctas=1), fir1d_fixed_golden_rows(x, h),
            err_msg=f"chunk={chunk} {rows}x{width}")


def test_chunk_core_4097_taps(cores, rng):
    """Past kernel C's 4,096 taps with the chunks ``pick_chunks`` takes:
    one narrow row, chunks of 4,096 taps and of one."""
    qf = QFormat(16, 12, 24)
    h = _taps(rng, qf, 4097, scale=1 / 256)
    fir = direct.FixedFirDirect(h, qf)
    assert fir.chunk_table.shape[0] == 2
    x = rng.integers(0, 256, size=(1, 700), dtype=np.uint8)
    got = cores(x, fir)
    np.testing.assert_array_equal(
        got, fir1d_fixed_rows_torch(torch.from_numpy(x), h, qf).numpy())
    np.testing.assert_array_equal(got, fir1d_fixed_golden_rows(x, h, qf))


@pytest.mark.parametrize("offset", [1, 3, 7, 15])
def test_chunk_core_misaligned_input(cores, rng, offset):
    """Rows at every alignment: the staging copies whole 16-byte chunks
    only inside a row, from each chunk's own window start."""
    big = rng.integers(0, 256, size=4 * 1001 + 16, dtype=np.uint8)
    x = big[offset : offset + 4 * 1001].reshape(4, 1001)
    h = design_lowpass(300, 0.2)
    fir = direct.FixedFirDirect(h, QFormat(), chunk_taps=96)
    np.testing.assert_array_equal(cores(x, fir),
                                  fir1d_fixed_golden_rows(x.copy(), h))


@pytest.mark.parametrize("qf", FORMATS, ids=str)
def test_short_core(cores, rng, qf):
    """The short route at every instance's tap counts up to 32, B's bias
    (the rounding bias or 0) and wrapping formats, ragged widths."""
    for num_taps in (1, 2, 3, 5, 8, 9, 13, 24, 32):
        h = _taps(rng, qf, num_taps)
        fir = direct.FixedFirDirect(h, qf)
        for rows, width in ((3, 1), (5, 17), (2, 333)):
            x = rng.integers(0, 256, size=(rows, width), dtype=np.uint8)
            np.testing.assert_array_equal(
                cores(x, fir), fir1d_fixed_golden_rows(x, h, qf),
                err_msg=f"L={num_taps} {rows}x{width} {qf}")


@pytest.mark.parametrize("num_taps,chunk", [(33, 64), (300, 64), (1001, 128),
                                            (4097, 2048)])
def test_host_copies_equal_kernel_c_copies(cores, rng, num_taps, chunk):
    """Each chunk's copy words, built in numpy, equal kernel C's
    ``window_copy_word`` over the chunk's own digits and plane table."""
    qf = QFormat(32, 12, 32)
    fir = direct.FixedFirDirect(_taps(rng, qf, num_taps, scale=1 / 64), qf,
                                chunk_taps=chunk)
    digits = fir.digits.numpy()
    copies = fir.copies.numpy().view(np.uint32)
    table = fir.chunk_table.numpy()
    for row, (q0, length) in zip(table, fir.chunks()):
        part = digits[:, num_taps - q0 - length : num_taps - q0]
        words, c_table = kernel_digit_words(part, fir.exponents)
        words = np.ascontiguousarray(words).view(np.uint32)
        c_table = np.asarray(c_table, np.int32)
        np.testing.assert_array_equal(c_table.reshape(-1, 4)[:, :3],
                                      row[2:].reshape(-1, 4)[:, :3])
        out = np.zeros(copies.size + 64, np.uint32)
        count = cores.copy_words(words.ctypes.data, c_table.ctypes.data,
                                 len(fir.exponents), out.ctypes.data)
        np.testing.assert_array_equal(out[:count],
                                      copies[row[0] : row[0] + count])


@pytest.mark.parametrize("qf", [QFormat(), QFormat(32, 30, 32)], ids=str)
@pytest.mark.parametrize("num_taps", [33, 1001, 4097, 8193])
def test_host_shared_bytes_equal_the_launch(cores, qf, num_taps):
    """``chunk_shared_bytes``, which ``pick_chunks`` sizes the chunks by,
    equals the shared memory the launch computes from the same table."""
    fir = direct.FixedFirDirect(design_lowpass(num_taps, 0.25), qf)
    table = np.ascontiguousarray(fir.chunk_table.numpy())
    assert direct.chunk_shared_bytes(table) == cores.shared_bytes(
        table.ctypes.data, table.shape[0], len(fir.exponents))
