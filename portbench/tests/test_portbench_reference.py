"""The frozen reference against hand-computed Q4.12 results, the stream's
checksums, TF32 rounding and the float64 FIR."""

import numpy as np
import pytest
import torch

from portbench import reference


def test_quantize_taps_rounds_ties_to_even_and_clips():
    # 1.5/4096 and 2.5/4096 tie: rint gives 2 and 2; 9.0 clips to 32767.
    taps = reference.quantize_taps([1.5 / 4096, 2.5 / 4096, -0.5, 9.0, -9.0],
                                   16, 12)
    assert taps.tolist() == [2, 2, -2048, 32767, -32768]


def test_one_tap_rounds_half_up_and_saturates():
    # h = 0.5 (2048): x = 1 -> (2048 + 2048) >> 12 = 1 (0.5 rounds up);
    # x = 3 -> (6144 + 2048) >> 12 = 2 (1.5 -> 2); x = 255 -> 128.
    # h = -0.5: x = 1 -> 0 (-0.5 rounds up to 0); x = 3 -> -1 -> 0.
    x = torch.tensor([[1, 3, 255]], dtype=torch.uint8)
    up = reference.fir_fixed_rows(x, np.array([2048]), 12, 32)
    down = reference.fir_fixed_rows(x, np.array([-2048]), 12, 32)
    assert up.tolist() == [[1, 2, 128]]
    assert down.tolist() == [[0, 0, 0]]
    # h = 7.999 (32764): 255 * 32764 / 4096 = 2039.7 saturates to 255.
    big = reference.fir_fixed_rows(x, np.array([32764]), 12, 32)
    assert big.tolist() == [[8, 24, 255]]


def test_sharpen5_by_hand():
    # Sharpen taps in Q4.12: [-256, -1024, 6656, -1024, -256]; same mode,
    # y[n] = sum_k h[k] x[n + 2 - k], zeros outside the row.
    taps = reference.quantize_taps(
        [-1 / 16, -4 / 16, 26 / 16, -4 / 16, -1 / 16], 16, 12)
    x = torch.tensor([[10, 200, 30, 0, 255, 255]], dtype=torch.uint8)
    # n=0: -1024*200 + 6656*10 - 256*30 = -148,480 -> <0 -> 0
    # n=1: -256*0 -1024*30 + 6656*200 - 1024*10 = 1,290,240
    #      (+2048) >> 12 = 315 -> 255
    # n=2: -256*255 - 1024*0 + 6656*30 - 1024*200 - 256*10 = -71,680 -> 0
    # n=3: -256*255 - 1024*255 + 6656*0 - 1024*30 - 256*200 = -408,320 -> 0
    # n=4: -1024*255 + 6656*255 - 1024*0 - 256*30 = 1,428,480 -> 349 -> 255
    # n=5: 6656*255 - 1024*255 - 256*0 = 1,436,160 -> 351 -> 255
    assert reference.fir_fixed_rows(x, taps, 12, 32).tolist() == [
        [0, 255, 0, 0, 255, 255]]
    # A gentle row: n=2 of [100]*5 is (6656-2560)*100 = 409,600 -> 100.
    flat = torch.full((1, 5), 100, dtype=torch.uint8)
    # n=0: (6656-1024-256)*100 = 537,600 (+2048)>>12 = 131
    # n=1: (6656-2*1024-256)*100 = 435,200 -> 106.75 -> 106
    assert reference.fir_fixed_rows(flat, taps, 12, 32).tolist() == [
        [131, 106, 100, 106, 131]]


def test_accumulator_wraps_at_acc_bits():
    # h = 4.0 (16384), x = 2: acc 32768 wraps to -32768 in 16 bits:
    # (-32768 + 2048) >> 12 = -8 -> 0; in 32 bits it is 8.
    x = torch.tensor([[2]], dtype=torch.uint8)
    assert reference.fir_fixed_rows(x, np.array([16384]), 12, 16).tolist() \
        == [[0]]
    assert reference.fir_fixed_rows(x, np.array([16384]), 12, 32).tolist() \
        == [[8]]
    # x = 5: 81,920 mod 65,536 = 16,384 -> (16,384 + 2048) >> 12 = 4.
    x = torch.tensor([[5]], dtype=torch.uint8)
    assert reference.fir_fixed_rows(x, np.array([16384]), 12, 16).tolist() \
        == [[4]]


def test_rows_reference_in_blocks_equals_one_pass(monkeypatch):
    gen = torch.Generator().manual_seed(3)
    x = torch.randint(0, 256, (10, 300), dtype=torch.uint8, generator=gen)
    taps = reference.quantize_taps(np.linspace(-1, 1, 9), 16, 12)
    whole = reference.fir_fixed_rows(x, taps, 12, 32)
    monkeypatch.setattr(reference, "ROW_BLOCK", 3)
    assert torch.equal(reference.fir_fixed_rows(x, taps, 12, 32), whole)


def test_block_checksums_by_hand():
    y = torch.tensor([[1, 2, 3], [4, 5, 255]], dtype=torch.uint8)
    # column sums 5, 7, 258; w = 1, 2, 3
    w_weyl = [(w * reference.WEYL) % 2**32 for w in (1, 2, 3)]
    want = [5 + 7 + 258, 5 + 14 + 774,
            (5 * w_weyl[0] + 7 * w_weyl[1] + 258 * w_weyl[2]) % 2**32]
    assert reference.block_checksums(y).tolist() == want


def test_stream_blocks_stitch_to_the_whole_stream():
    gen = torch.Generator().manual_seed(5)
    s = torch.randint(0, 256, (2, 40), dtype=torch.uint8, generator=gen)
    taps = reference.quantize_taps([-1 / 16, -4 / 16, 26 / 16, -4 / 16,
                                    -1 / 16], 16, 12)
    blocks = [s[:, i : i + 10] for i in range(0, 40, 10)]
    got = torch.cat([reference.stream_block(blocks[b - 1] if b else None,
                                            blocks[b], taps, 12, 32)
                     for b in range(4)], dim=1)
    # emitted[t] = y_global[t - center]: the whole stream's same-mode FIR
    # over the zero-prepended stream, delayed by center = 2.
    padded = torch.nn.functional.pad(s, (4, 0))
    want = reference.fixed_prehaloed(padded, taps, 12, 32)
    assert torch.equal(got, want)


def test_round_tf32_keeps_ten_mantissa_bits_ties_to_even():
    x = torch.tensor([1.0, 1 + 2**-11, 1 + 3 * 2**-11, -(1 + 3 * 2**-11),
                      255.0, 0.1], dtype=torch.float32)
    got = reference.round_tf32(x).tolist()
    assert got[:5] == [1.0, 1.0, 1 + 2**-9, -(1 + 2**-9), 255.0]
    assert got[5] == pytest.approx(0.1, rel=2**-11)
    assert got[5] != float(np.float32(0.1))


def test_f64_fir_equals_numpy_convolve():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((3, 50))
    h = rng.standard_normal(7)
    ext = torch.nn.functional.pad(torch.from_numpy(x), (3, 3))
    got = reference.fir_f32_rows_f64(ext, h).numpy()
    want = np.stack([np.convolve(row, h, mode="same") for row in x])
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    tf32 = reference.fir_rows_tf32(ext.float(), h).double().numpy()
    err = np.abs(tf32 - want).max() / np.abs(want).max()
    assert 1e-6 < err < 1e-2
