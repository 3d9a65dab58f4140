// Fixed-point epilogue shared by the FIR kernels.
//
// The golden contract (warmup_fir_filter_tpu/ops/fir1d.py:68-87, and the
// epilogue of warmup_fir_filter_tpu/kernels/fir_mxu.py:295-307): wrap the
// accumulator to acc_bits and sign-extend, round half up by the bias-add /
// arithmetic-shift decomposition, saturate to uint8.
//
// Signed overflow and shifting a negative value left are undefined in C++,
// so the accumulator is a uint32_t (it wraps mod 2^32 as the reference's
// int32 does) and only the arithmetic right shifts run on int32_t.
//
// The header also compiles as plain C++, so the CPU tests build this exact
// code with a host compiler and hold it against the golden.
#pragma once

#include <cstdint>

#if defined(__CUDACC__)
#define WFT_INLINE __host__ __device__ __forceinline__
#else
#define WFT_INLINE inline
#endif

// Full unrolling keeps the per-row accumulator arrays in registers.
#if defined(__CUDACC__)
#define WFT_UNROLL _Pragma("unroll")
#else
#define WFT_UNROLL
#endif

namespace wft {

// Requires 1 <= frac_bits <= 31 and 1 <= acc_bits <= 32 (the wrappers check).
WFT_INLINE uint8_t fixed_epilogue(uint32_t acc, bool wrap, int frac_bits,
                                  int acc_bits) {
  int32_t final_value;
  if (wrap) {
    int32_t v;
    if (acc_bits < 32) {
      const int s = 32 - acc_bits;
      v = static_cast<int32_t>(acc << s) >> s;
    } else {
      v = static_cast<int32_t>(acc);
    }
    const uint32_t low = static_cast<uint32_t>(v) & ((1u << frac_bits) - 1u);
    const int32_t carry =
        static_cast<int32_t>((low + (1u << (frac_bits - 1))) >> frac_bits);
    final_value = (v >> frac_bits) + carry;
  } else {
    // Provably no wrap: the rounding bias was folded into the accumulator's
    // starting constant on the host (fir_mxu.py:587-597).
    final_value = static_cast<int32_t>(acc) >> frac_bits;
  }
  return static_cast<uint8_t>(final_value < 0     ? 0
                              : final_value > 255 ? 255
                                                  : final_value);
}

}  // namespace wft
