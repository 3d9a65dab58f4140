"""The stream cell's check: block checksums, the carried state and one
resume against the reference.

- ``wrong_block_sums``: of a sample of the window's blocks drawn from the
  seed (the first and the last among them), and of the blocks a fresh
  stream resumed from the last saved file filtered, the blocks whose three
  checksums differ from the reference's.  The reference filters each block
  from the block source alone: the block and its predecessor's last
  ``L-1`` samples.
- ``wrong_carry``: the values of the stream's final delay line that differ
  from the last ``L-1`` samples of its last block, plus 1 if its sample
  count is off.
- ``wrong_resume``: the resumed blocks whose checksums differ from those
  the uninterrupted stream returned for the same blocks.

Every limit is 0: the configuration states a bit-exact result."""

import numpy as np
import torch

from portbench.reference import quantize_taps, stream_block_checksums


def check(evidence: dict) -> tuple[dict, int]:
    """``(compared, failed calls)``."""
    config = evidence["config"]
    taps = quantize_taps(config["taps"], config["coeff_bits"],
                         config["frac_bits"])
    block_fn = evidence["block_fn"]
    sums = evidence["sums"]  # block index -> (3,) program checksums
    per_call = evidence["blocks_per_call"]

    def reference(b: int) -> np.ndarray:
        prev = block_fn(b - 1) if b > 0 else None
        return stream_block_checksums(prev, block_fn(b), taps,
                                      config["frac_bits"], config["acc_bits"])

    wrong_blocks = set()
    resume = evidence["resume"]
    checked = sorted(set(evidence["sampled"]))
    for b in checked:
        if not np.array_equal(reference(b), sums[b].astype(np.uint64)):
            wrong_blocks.add(b)
    wrong_resumed = 0
    wrong_resume = 0
    for j, b in enumerate(range(resume["start"], resume["start"] + per_call)):
        got = resume["sums"][j].astype(np.uint64)
        if not np.array_equal(reference(b), got):
            wrong_resumed += 1
        if b in sums and not np.array_equal(sums[b].astype(np.uint64), got):
            wrong_resume += 1

    carry, seen = evidence["final_state"]
    last = evidence["next_block"] - 1
    k = len(taps) - 1
    last_block = block_fn(last)
    want = last_block[:, last_block.shape[1] - k :].to(
        torch.int32).cpu().numpy()
    wrong_carry = int(np.count_nonzero(np.asarray(carry) != want))
    wrong_carry += int(seen != evidence["next_block"] * evidence["width"])

    compared = {
        "wrong_block_sums": {"value": len(wrong_blocks) + wrong_resumed,
                             "limit": 0},
        "wrong_carry": {"value": wrong_carry, "limit": 0},
        "wrong_resume": {"value": wrong_resume, "limit": 0},
    }
    failed = len({b // per_call for b in wrong_blocks})
    return compared, failed
