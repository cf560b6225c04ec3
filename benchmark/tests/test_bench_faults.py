"""A run with its timed path broken underneath comes out not correct: the
harness's look for a card is skipped and the rest of a run is driven on
the CPU at small widths, the program's kernels by their plain versions.

Faults the bulk cells can have: a choice or an answer altered
where it is produced (one phoneme's duration; a stretch of a waveform),
and half of the batch left out (half the sentences' waveforms never
vocoded)."""

import contextlib
import time

import pytest
import torch

from benchmark.core import harness
from benchmark.tests import micro


@contextlib.contextmanager
def patch(obj, name, make):
    old = getattr(obj, name)
    setattr(obj, name, make(old))
    try:
        yield
    finally:
        setattr(obj, name, old)


def duration_plus_one():
    from tts_king_torch.models import fs2

    def make(round_durations):
        def altered(log_d, control):
            d = round_durations(log_d, control).clone()
            d[:, 0] += 1.0
            return d
        return altered
    return patch(fs2, "round_durations", make)


def waveform_altered():
    from tts_king_torch import pipeline

    def make(wav_to_int16):
        def altered(wav, scale):
            out = wav_to_int16(wav, scale).clone()
            n = out.shape[-1] // 4
            out[..., n:2 * n] = -out[..., n:2 * n]
            return out
        return altered
    return patch(pipeline, "wav_to_int16", make)


def half_the_batch_left_out():
    from tts_king_torch.pipeline import Vocoder

    def make(vocode_int16):
        def half(self, mel, frames=None):
            out = vocode_int16(self, mel, frames).clone()
            out[out.shape[0] // 2:] = 0
            return out
        return half
    return patch(Vocoder, "vocode_int16", make)


FAULTS = {"sound": contextlib.nullcontext,
          "duration_plus_one": duration_plus_one,
          "waveform_altered": waveform_altered,
          "half_the_batch_left_out": half_the_batch_left_out}


CELLS = micro.cells()


@pytest.mark.parametrize("workload", sorted(CELLS))
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_makes_the_run_incorrect(tmp_path, workload, fault):
    with FAULTS[fault]():
        res = harness.run_cell(workload, 2 ** 31 + 77, 0.5, False,
                               torch.device("cpu"), time.time(),
                               config_file=micro.config_file(
                                   tmp_path, CELLS[workload]),
                               traffic_overrides=micro.TRAFFIC)
    assert res["correct"] == (fault == "sound"), res["checks"]
    assert list(res)[-1] == "checks"
    assert res["attempted"] > 0
