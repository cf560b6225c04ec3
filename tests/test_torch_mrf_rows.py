"""Per-item rows into the MRF stages on the CPU: the rows a delivered sample
depends on (Generator.forward's frames, the generator's receptive field),
the stage's contract with rows (mrf_stage_plain, the route the CPU runs),
the bf16 kernel's grid with rows (mrf.grid_tiles, which the tiles_run and
tiles_total counters add up) and Vocoder.generate's plumbing.

The kernel itself is held to the same contract on the card by chip_smoke.py
(row 2: with rows against without, bit for bit on the rows kept, and the
blocks that ran counted on the card against tiles_run).
"""

import numpy as np
import pytest
import torch

import chip_smoke as cs
from tts_king_torch.config import TTSConfig, VocoderModelConfig
from tts_king_torch.models import hifigan
from tts_king_torch.ops.kernels import mrf

KS = (3, 7, 11)
DIL = (1, 3, 5)


@pytest.fixture(autouse=True)
def one_thread():
    """One CPU thread: the CPU's convolutions round alike from one call to
    the next only at a fixed split of their work over threads, and the
    tests compare two passes bit for bit."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _stage(C, dtype, seed):
    rng = np.random.RandomState(seed)
    ws = [[torch.from_numpy((rng.randn(C, C, k) / np.sqrt(C * k))
                            .astype(np.float32)).to(dtype)
           for _ in range(2 * len(DIL))] for k in KS]
    bs = [[torch.from_numpy(0.05 * rng.randn(C).astype(np.float32)).to(dtype)
           for _ in range(2 * len(DIL))] for _ in KS]
    return mrf.MrfStageWeights(KS, DIL, ws, bs)


# (a) the receptive-field rule


def _generator(seed):
    """A narrow HiFi-GAN with V1's rates, upsampler kernels, MRF kernels and
    dilations (so its receptive field is V1's), every stage fused."""
    cfg = VocoderModelConfig(upsample_initial_channel=32)
    gen = hifigan.Generator(cfg)
    rng = np.random.RandomState(seed)
    gen.load_state_dict({
        k: torch.from_numpy((0.3 * rng.randn(*v.shape)).astype(np.float32))
        for k, v in gen.state_dict().items()})
    return gen.eval()


def _nan_past_rows(monkeypatch):
    """Make every MRF stage's rows past its rows NaN: whatever reads them
    becomes NaN."""
    real = hifigan.mrf_stage

    def stage(x, packed, rows=None):
        y = real(x, packed, rows)
        if rows is not None:
            y = y.clone()
            for b, r in enumerate(rows):
                y[b, r:] = float("nan")
        return y
    monkeypatch.setattr(hifigan, "mrf_stage", stage)


@pytest.mark.parametrize("frames", [[48, 1, 17, 30], [12, 12, 12],
                                    [48, 48], [1, 47]])
def test_delivered_samples_depend_on_the_rows_kept(monkeypatch, frames):
    """Rows past each stage's rows replaced by NaN: the delivered samples
    [0, frames[b] * hop) are the full pass's, bit for bit, and finite. With
    no margin past the real frames, NaN reaches them: the rule's margin is
    what keeps them."""
    gen = _generator(0)
    T_mel, hop = 48, int(np.prod(gen.config.upsample_rates))
    mel = torch.from_numpy(np.random.RandomState(1).randn(
        len(frames), T_mel, 80).astype(np.float32))
    with torch.no_grad():
        full = gen(mel)
        _nan_past_rows(monkeypatch)
        got = gen(mel, frames)
    assert got.shape == full.shape == (len(frames), T_mel * hop)
    for b, f in enumerate(frames):
        n = f * hop
        assert torch.isfinite(got[b, :n]).all()
        assert torch.equal(got[b, :n], full[b, :n])
    if min(frames) < T_mel:
        monkeypatch.setattr(hifigan.Generator, "receptive_field",
                            staticmethod(lambda config: 0))
        with torch.no_grad():
            cut = gen(mel, frames)
        assert any(not torch.isfinite(cut[b, :f * hop]).all()
                   for b, f in enumerate(frames) if f < T_mel)


def test_frames_none_and_full_frames_run_as_today(monkeypatch):
    gen = _generator(2)
    mel = torch.from_numpy(np.random.RandomState(3).randn(3, 20, 80)
                           .astype(np.float32))
    seen = []
    real = hifigan.mrf_stage
    monkeypatch.setattr(hifigan, "mrf_stage", lambda x, st, rows=None: (
        seen.append(rows), real(x, st, rows))[1])
    with torch.no_grad():
        today = gen(mel)
        assert seen == [None] * 4
        full = gen(mel, np.full(3, 20))
    assert torch.equal(today, full)
    rates = np.cumprod(gen.config.upsample_rates)
    assert seen[4:] == [[20 * r] * 3 for r in rates]


def test_generator_needs_host_frames():
    """frames on a device (meta here: the CPU has no CUDA device, and the
    check refuses any tensor off the host) would need a sync to read."""
    gen = _generator(4)
    mel = torch.zeros(2, 8, 80)
    with pytest.raises(ValueError, match="host integers"):
        gen(mel, torch.tensor([8, 4], device="meta"))
    with pytest.raises(ValueError, match="for a batch of 2"):
        gen(mel, [8, 4, 2])
    with pytest.raises(ValueError, match="for a batch of 2"):
        gen(mel, [8, -1])
    with torch.no_grad():
        a = gen(mel, torch.tensor([8, 4]))
        b = gen(mel, [8, 4])
    assert torch.equal(a, b)


def test_needed_rows_follow_the_receptive_field():
    cfg = VocoderModelConfig()
    assert hifigan.Generator.receptive_field(cfg) == 17   # V1, PERF.md
    assert hifigan.needed_rows(cfg, [0, 10, 1000], 64, 64000) == [
        17 * 64, 27 * 64, 64000]


# (b) the stage's contract with rows


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows", [[300, 1, 0, 137], [300, 300, 300, 300],
                                  [999, 5, 300, 64]])
def test_plain_stage_keeps_its_rows_and_zeroes_the_rest(dtype, rows):
    C, T = 16, 300
    stage = _stage(C, dtype, 6)
    x = torch.from_numpy(np.random.RandomState(7).randn(4, C, T)
                         .astype(np.float32)).to(dtype).transpose(1, 2)
    full = mrf.mrf_stage_plain(x, stage)
    assert torch.equal(mrf.mrf_stage_plain(x, stage, None), full)
    assert torch.equal(mrf.mrf_stage(x, stage), full)
    got = mrf.mrf_stage_plain(x, stage, rows)
    assert torch.equal(mrf.mrf_stage(x, stage, rows), got)
    for b, r in enumerate(rows):
        r = min(r, T)
        assert torch.equal(got[b, :r], full[b, :r])
        assert not got[b, r:].any()


def test_stage_rows_are_host_integers_one_per_item():
    stage = _stage(16, torch.float32, 8)
    x = torch.zeros(2, 40, 16)
    for bad in ([40], [40, 40, 40], [-1, 40]):
        with pytest.raises(ValueError):
            mrf.mrf_stage(x, stage, bad)
    with pytest.raises(ValueError, match="host integers"):
        mrf.mrf_stage(x, stage, torch.tensor([4, 4], device="meta"))
    assert torch.equal(mrf.mrf_stage(x, stage, torch.tensor([40, 3])),
                       mrf.mrf_stage(x, stage, [40, 3]))


# (c) the kernel's grid with rows


@pytest.mark.parametrize("C,rate", [(128, 64), (64, 128), (32, 256)])
def test_grid_tiles_at_bulk_lengths(C, rate):
    """chip_smoke.BULK_FRAMES (32 sentences, 5 frames a phoneme, mel bucket
    1000) at V1's fused stages: the kernel runs 53-56% of its grid, and all
    of it without rows. Each count is the grid's own rule: tile j of item b
    runs when j * tt < rows[b]."""
    T = 1000 * rate
    plan = mrf.tile_plan(T, C, torch.bfloat16, KS, DIL)
    rows = hifigan.needed_rows(VocoderModelConfig(), cs.BULK_FRAMES, rate, T)
    run, total = mrf.grid_tiles(plan, len(rows), T, rows)
    n = -(-T // plan.tt)
    assert total == plan.blocks(len(rows), T) == len(rows) * n
    assert run == sum(j * plan.tt < r for r in rows for j in range(n))
    assert 0.53 <= run / total <= 0.56
    assert mrf.grid_tiles(plan, len(rows), T) == (total, total)
    assert mrf.grid_tiles(plan, 3, T, [T, 0, 1]) == (n + 1, 3 * n)


# (d) Vocoder.generate passes the frames on


def _vocoder(kind):
    from tts_king_torch.pipeline import Vocoder

    cfg = TTSConfig()
    cfg.model.vocoder_model = kind
    cfg.vocoder = VocoderModelConfig(upsample_rates=[4, 4],
                                     upsample_kernel_sizes=[8, 8],
                                     upsample_initial_channel=32)
    return Vocoder(cfg, device="cpu")


@pytest.mark.parametrize("kind", ["HiFi-GAN", "MelGAN"])
def test_vocoder_generate_passes_frames_to_its_model(monkeypatch, kind):
    """Sample lengths reach the model as frames, rounded up; MelGAN takes
    them and computes every sample, as without."""
    voc = _vocoder(kind)
    hop = 16
    mel = torch.from_numpy(np.random.RandomState(9).randn(3, 30, 80)
                           .astype(np.float32))
    lengths = np.array([30 * hop, 7 * hop + 1, 1])
    calls = []
    real = voc.model.forward
    monkeypatch.setattr(voc.model, "forward",
                        lambda *a: calls.append(a[1:]) or real(*a))
    wavs = voc.generate(mel, lengths)
    whole = voc.generate(mel)
    assert [[int(f) for f in a[0]] for a in calls[:1]] == [[30, 8, 1]]
    assert calls[1:] == [(None,)]
    for w, full, n in zip(wavs, whole, lengths):
        assert len(w) == n
        np.testing.assert_array_equal(w, full[:n])
