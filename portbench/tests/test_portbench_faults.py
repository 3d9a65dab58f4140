"""A dry run with the timed path broken underneath comes out not correct,
once for each fault a cell can have; its control comes out not correct;
and a sound dry run comes out correct.  The harness's look for a card is
skipped (``--dry-cpu``): the cells run on the port's plain versions."""

import time

import pytest

from portbench import harness


def outcome(name, control=False, rank_module=None):
    cell = harness.load_cell(name, seeds=[2**33 + 5], seconds=0.3,
                             trace=False, dry=True, control=control,
                             started=time.time())
    if rank_module:
        cell.rank_module = rank_module
    driver = harness.load_module("drivers", cell.traffic["driver"])
    return driver.run_cell(cell)[0]


@pytest.fixture
def rows_entry(monkeypatch):
    from warmup_fir_filter_tpu_torch.kernels import dispatch

    original = dispatch.fir1d_fixed_rows_auto

    def patch(change):
        def broken(x, h, qformat):
            y = original(x, h, qformat)
            change(y)
            return y

        monkeypatch.setattr(dispatch, "fir1d_fixed_rows_auto", broken)

    return patch


@pytest.mark.parametrize("name", ["sharpen5.rows", "lowpass63.rows",
                                  "sharpen5.stream", "os63.sharded4"])
def test_sound_dry_run_is_correct(name):
    result = outcome(name)
    assert result.correct, result.compared
    assert result.attempted > 0 and result.failed == 0


@pytest.mark.parametrize("name", ["sharpen5.rows", "lowpass63.rows",
                                  "sharpen5.stream", "os63.sharded4"])
def test_control_is_not_correct(name):
    result = outcome(name, control=True)
    assert not result.correct, result.compared


@pytest.mark.parametrize("name", ["sharpen5.rows", "lowpass63.rows"])
def test_rows_half_the_batch_left_out(name, rows_entry):
    def drop_half(y):
        y[y.shape[0] // 2 :] = 0

    rows_entry(drop_half)
    result = outcome(name)
    assert not result.correct
    assert result.failed > 0


@pytest.mark.parametrize("name", ["sharpen5.rows", "lowpass63.rows"])
def test_rows_answer_altered(name, rows_entry):
    def flip(y):
        y[1, 7] ^= 1

    rows_entry(flip)
    result = outcome(name)
    assert not result.correct
    assert result.compared["wrong_samples"]["value"] >= 1


def test_stream_state_returned_unchanged(monkeypatch):
    from warmup_fir_filter_tpu_torch.ops import streaming

    monkeypatch.setattr(streaming, "_carry_after",
                        lambda x, carry, num_taps: carry)
    result = outcome("sharpen5.stream")
    assert not result.correct
    assert result.compared["wrong_carry"]["value"] > 0


def test_stream_half_the_batch_left_out(monkeypatch):
    from warmup_fir_filter_tpu_torch.ops import streaming

    step = streaming._stream_step

    def half(x, carry, *args):
        y, new_carry = step(x, carry, *args)
        y[y.shape[0] // 2 :] = 0
        return y, new_carry

    monkeypatch.setattr(streaming, "_stream_step", half)
    result = outcome("sharpen5.stream")
    assert not result.correct
    assert result.compared["wrong_block_sums"]["value"] > 0


def test_stream_answer_altered(monkeypatch):
    from warmup_fir_filter_tpu_torch.ops import streaming

    sums = streaming._column_sums

    def altered(y, dim):
        out = sums(y, dim)
        out[0] += 1
        return out

    monkeypatch.setattr(streaming, "_column_sums", altered)
    result = outcome("sharpen5.stream")
    assert not result.correct


@pytest.mark.parametrize("fault", ["no_exchange", "altered"])
def test_sharded_faults(fault, monkeypatch):
    monkeypatch.setenv("FAULT", fault)
    result = outcome("os63.sharded4",
                     rank_module="portbench.tests.fault_rank")
    assert not result.correct, result.compared


def test_readings_report_each_seed_and_the_extremes(capsys):
    import json

    from portbench import readings

    assert readings.main(["--workload", "sharpen5.rows", "--seconds", "0.2",
                          "--seeds", "4", "5", "--dry-cpu", "--control"]) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [x["seed"] for x in lines[:2]] == [4, 5]
    assert not any(x["correct"] for x in lines[:2])
    assert lines[2]["smallest"]["wrong_samples"] > 0
