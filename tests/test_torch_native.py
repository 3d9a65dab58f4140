"""The port's binding to the native C++ tools against the JAX package's.

``tests/test_native_tools.py``'s cases run against
``warmup_fir_filter_tpu_torch.native``: the fixed oracle equal to the port's
golden, the JAX golden and the JAX binding (``np.array_equal``), the
causal stream, the bit-compare and the radix-2 FFT at that file's
tolerances.  The port builds its own library with the host compiler into
its build directory, once per session (a module fixture); the file skips
only when there is no C++ compiler.
"""

import numpy as np
import pytest
import torch

from warmup_fir_filter_tpu import native as jax_native
from warmup_fir_filter_tpu.models.golden import (
    fir1d_fixed_golden_rows as jax_golden_rows,
)
from warmup_fir_filter_tpu.ops.qformat import QFormat as JaxQFormat
from warmup_fir_filter_tpu_torch import _build, native
from warmup_fir_filter_tpu_torch.models.filters import FILTER_BANKS
from warmup_fir_filter_tpu_torch.models.golden import (
    fir1d_fixed_golden_rows,
    fir1d_ideal_golden_rows,
)
from warmup_fir_filter_tpu_torch.ops.qformat import QFormat


@pytest.fixture(scope="module", autouse=True)
def library():
    """The port's tools library, built here once if it is not up to date."""
    if not native.native_available():
        pytest.skip("no C++ compiler on PATH to build the native tools")
    return native.load_native()


@pytest.fixture
def jax_binding():
    """The JAX package's binding, whose library ``tests/conftest.py``
    builds with cmake."""
    if not jax_native.native_available():
        pytest.skip("the JAX package's native library is not built "
                    "(no cmake)")
    return jax_native


class TestBuild:
    def test_library_builds_into_the_ports_build_directory(self, library):
        path = _build.build_tools()
        assert path == _build.DEFAULT_BUILD_DIR / "libwft_tools.so"
        assert path.parent.name == "warmup_fir_filter_tpu_torch"
        assert "release" not in path.parts
        assert library._name == str(path)
        stamp = path.with_name("libwft_tools.so.sha256")
        assert stamp.read_text().strip() == _build.tools_digest()
        assert _build.tools_built()

    def test_one_compiler_call_over_the_cmake_sources(self, monkeypatch,
                                                      tmp_path):
        fake = tmp_path / "bin" / "c++"
        fake.parent.mkdir()
        fake.write_text(
            "#!/bin/sh\n"
            'echo "$@" >> "$(dirname "$0")/calls.log"\n'
            'while [ $# -gt 0 ]; do [ "$1" = "-o" ] && out="$2"; shift; done\n'
            'echo built > "$out"\n')
        fake.chmod(0o755)
        monkeypatch.setenv("CXX", str(fake))
        library = _build.build_tools(tmp_path / "build")
        calls = (tmp_path / "bin" / "calls.log").read_text().splitlines()
        assert len(calls) == 1
        for flag in ("-O2", "-std=c++17", "-fPIC", "-shared"):
            assert flag in calls[0].split()
        for name in ("wft_complex.cpp", "wft_fir.cpp", "wft_capi.cpp"):
            assert str(_build.TOOLS_SRC_DIR / name) in calls[0]
        assert sorted(p.name for p in library.parent.iterdir()) == [
            "libwft_tools.so", "libwft_tools.so.sha256"]
        assert _build.build_tools(tmp_path / "build") == library  # up to date
        assert len((tmp_path / "bin" / "calls.log").read_text()
                   .splitlines()) == 1

    def test_raises_without_a_compiler(self, monkeypatch, tmp_path):
        monkeypatch.delenv("CXX", raising=False)
        monkeypatch.setenv("PATH", str(tmp_path))
        with pytest.raises(_build.BuildError, match="no C\\+\\+ compiler"):
            _build.find_cxx()
        with pytest.raises(_build.BuildError, match="no C\\+\\+ compiler"):
            _build.build_tools(tmp_path / "build")
        assert not (tmp_path / "build").exists()

    def test_digest_follows_sources(self, monkeypatch, tmp_path):
        for src in _build.TOOLS_SRC_DIR.iterdir():
            (tmp_path / src.name).write_bytes(src.read_bytes())
        monkeypatch.setattr(_build, "TOOLS_SRC_DIR", tmp_path)
        first = _build.tools_digest()
        (tmp_path / "wft_fir.h").write_text("// changed\n")
        assert _build.tools_digest() != first


class TestNativeFixedGolden:
    @pytest.mark.parametrize("tap", [3, 5])
    def test_bit_exact_vs_goldens(self, rng, tap, jax_binding):
        h = np.asarray(FILTER_BANKS[tap]["sharpen"])
        x = rng.integers(0, 256, size=(5, 137), dtype=np.uint8)
        got = native.fir1d_fixed_rows_native(x, h)
        np.testing.assert_array_equal(got, fir1d_fixed_golden_rows(x, h))
        np.testing.assert_array_equal(got, jax_golden_rows(x, h))
        np.testing.assert_array_equal(
            got, jax_binding.fir1d_fixed_rows_native(x, h))

    @pytest.mark.parametrize("acc_bits", [12, 16, 24, 32])
    def test_wraparound_formats(self, rng, acc_bits, jax_binding):
        qf = QFormat(acc_bits=acc_bits)
        h = np.array([7.5, -8.0, qf.max_coeff_real])
        x = rng.integers(0, 256, size=(3, 90), dtype=np.uint8)
        got = native.fir1d_fixed_rows_native(x, h, qf)
        np.testing.assert_array_equal(got, fir1d_fixed_golden_rows(x, h, qf))
        np.testing.assert_array_equal(
            got, jax_golden_rows(x, h, JaxQFormat(acc_bits=acc_bits)))
        np.testing.assert_array_equal(got, jax_binding.fir1d_fixed_rows_native(
            x, h, JaxQFormat(acc_bits=acc_bits)))

    def test_takes_a_tensor(self, rng):
        h = np.asarray(FILTER_BANKS[5]["sharpen"])
        x = rng.integers(0, 256, size=(2, 40), dtype=np.uint8)
        np.testing.assert_array_equal(
            native.fir1d_fixed_rows_native(torch.from_numpy(x), h),
            native.fir1d_fixed_rows_native(x, h))

    def test_rejects_one_dimensional_rows(self):
        with pytest.raises(ValueError, match="rows"):
            native.fir1d_fixed_rows_native(np.zeros(8, np.uint8), [1.0])


class TestNativeStream:
    def test_causal_delay_line(self):
        stream = native.NativeFirStream([0.5, 0.25])
        out = stream.process([8.0, 4.0, 2.0])
        np.testing.assert_allclose(out, [4.0, 4.0, 2.0])
        stream.reset()
        np.testing.assert_allclose(stream.process([8.0]), [4.0])
        stream.close()

    def test_matches_python_streaming_up_to_center_delay(self, rng):
        h = np.asarray(FILTER_BANKS[5]["simple_lp"])
        x = rng.integers(0, 256, size=60).astype(np.float64)
        stream = native.NativeFirStream(h)
        causal = stream.process(x)
        same_mode = fir1d_ideal_golden_rows(
            x[None, :].astype(np.uint8), h
        )[0]
        center = 2
        np.testing.assert_allclose(causal[center:], same_mode[: 60 - center])
        stream.close()

    def test_equals_the_jax_binding_across_calls(self, rng, jax_binding):
        h = rng.normal(size=9)
        chunks = [rng.normal(size=n) for n in (1, 17, 64)]
        port, ref = native.NativeFirStream(h), jax_binding.NativeFirStream(h)
        for chunk in chunks:
            np.testing.assert_array_equal(port.process(torch.from_numpy(chunk)),
                                          ref.process(chunk))
        port.close()
        ref.close()

    def test_closed_stream_refuses_work(self):
        stream = native.NativeFirStream([1.0])
        stream.close()
        stream.close()  # a second close is a no-op
        with pytest.raises(ValueError, match="closed"):
            stream.process([1.0])


class TestBitCompare:
    def test_identical_buffers(self, rng):
        a = rng.integers(0, 256, size=1000, dtype=np.uint8)
        result = native.bit_compare_u8(a, a.copy())
        assert result["bit_exact"]
        assert result["num_mismatches"] == 0
        assert result["rmse"] == 0.0

    def test_known_differences(self):
        a = np.array([0, 100, 200], np.uint8)
        b = np.array([0, 90, 255], np.uint8)
        result = native.bit_compare_u8(a, b)
        assert result["num_mismatches"] == 2
        assert result["max_abs_err"] == 55
        assert result["mae"] == pytest.approx((10 + 55) / 3)

    def test_equals_the_jax_binding(self, rng, jax_binding):
        a = rng.integers(0, 256, size=(7, 300), dtype=np.uint8)
        b = a.copy()
        b[rng.random(a.shape) < 0.05] ^= 3
        assert native.bit_compare_u8(torch.from_numpy(a), b) == \
            jax_binding.bit_compare_u8(a, b)

    def test_size_mismatch_rejected(self):
        with pytest.raises(ValueError, match="Size mismatch"):
            native.bit_compare_u8(np.zeros(3, np.uint8),
                                  np.zeros(4, np.uint8))


class TestNativeFFT:
    def test_matches_numpy_fft(self, rng):
        n = 256
        re = rng.normal(size=n)
        im = rng.normal(size=n)
        out_re, out_im = native.fft_radix2_native(re, im)
        expected = np.fft.fft(re + 1j * im)
        np.testing.assert_allclose(out_re, expected.real, atol=1e-9)
        np.testing.assert_allclose(out_im, expected.imag, atol=1e-9)

    def test_inverse_roundtrip(self, rng):
        n = 128
        re = rng.normal(size=n)
        im = rng.normal(size=n)
        fr, fi = native.fft_radix2_native(re, im)
        br, bi = native.fft_radix2_native(fr, fi, inverse=True)
        np.testing.assert_allclose(br, re, atol=1e-10)
        np.testing.assert_allclose(bi, im, atol=1e-10)

    def test_equals_the_jax_binding_and_leaves_inputs(self, rng, jax_binding):
        re = rng.normal(size=64).astype(np.float32)
        im = rng.normal(size=64).astype(np.float32)
        keep = re.copy(), im.copy()
        for inverse in (False, True):
            got = native.fft_radix2_native(torch.from_numpy(re), im, inverse)
            want = jax_binding.fft_radix2_native(re, im, inverse)
            np.testing.assert_array_equal(got[0], want[0])
            np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_array_equal(re, keep[0])
        np.testing.assert_array_equal(im, keep[1])

    def test_non_pow2_rejected(self):
        with pytest.raises(ValueError, match="power of two"):
            native.fft_radix2_native(np.zeros(12), np.zeros(12))
