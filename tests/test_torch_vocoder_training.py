"""The port's HiFi-GAN training on the CPU: the GAN step against the JAX
step of golden_gan_step.npz (and two faults it catches: one power
iteration too few, weight decay masked on g and the biases), the mel loss's
backward in exact f32, learning over a few steps, the bf16 step against the
f32 one, the AdamW schedule against optax, MelDataset against the JAX one,
train_vocoder and its CLI (tests/test_vocoder_loop.py mirrored), the
vocoder family train_vocoder refuses, and the
default device."""

import json
import os

import numpy as np
import pytest
import torch
from scipy.io import wavfile

from chip_smoke import (GAN_ADAM_B1, compare_gan_step, gan_golden,
                        gan_golden_batch, gan_state_dicts, gan_trainer,
                        replay_gan_step_golden)
from tests.test_vocoder_training import _tiny_cfg

DISC = dict(disc_p_channels=(4, 8, 8, 8, 8), msd_width=32)


def _port_cfg(jax_cfg):
    import dataclasses

    from tts_king_torch.config import VocoderModelConfig

    return VocoderModelConfig(**dataclasses.asdict(jax_cfg))


@pytest.fixture(scope="module")
def golden():
    return gan_golden()


def test_gan_step_replays_golden():
    """One GAN step from the golden's variables through the port's
    VocoderTrainer (f32): losses rtol 1e-5, params atol 1e-3 * lr, the
    Adam moments of both optimizers rtol 1e-4 (atol 1e-5 of their top),
    the spectral buffers after the three power iterations rtol 1e-4, the
    counts and the eval step's mel L1 (chip_smoke.compare_gan_step)."""
    losses, errs = replay_gan_step_golden(device="cpu")
    print(json.dumps({"losses": losses, "errs": errs}))


def _masked_decay(trainer):
    """A generator optimizer that leaves g and the biases out of the
    weight decay: after each update, add the decay term back."""
    opt = trainer.gen_opt
    apply = opt.apply

    def masked(model, grads, state):
        lr = opt.lr(state.count)
        keep = {n: p.detach().clone() for n, p in model.named_parameters()
                if n.endswith((".g", ".bias"))}
        apply(model, grads, state)
        with torch.no_grad():
            for n, p in model.named_parameters():
                if n in keep:
                    p.add_(keep[n], alpha=lr * opt.weight_decay)

    opt.apply = masked


@pytest.mark.parametrize("fault", ["one_iteration_short", "decay_masked"])
def test_golden_catches_faults(golden, fault, monkeypatch):
    """The golden step's bounds see each of two faults a port could make:
    the generator's half pair-batched (the MSD's first scale power-iterates
    twice a step instead of three times: u and v miss), and the weight
    decay masked on g and the biases (they miss by ~lr * 0.01 * |g|)."""
    from tts_king_torch.models.hifigan import MultiScaleDiscriminator

    meta, z, trees = golden
    trainer = gan_trainer(meta)
    if fault == "one_iteration_short":
        forward = MultiScaleDiscriminator.forward
        monkeypatch.setattr(
            MultiScaleDiscriminator, "forward",
            lambda self, y, y_hat, update_sn=False, pair_batched=None:
            forward(self, y, y_hat, update_sn, pair_batched=True))
    else:
        _masked_decay(trainer)
    state = trainer.state_from(*gan_state_dicts(trees))
    losses = trainer.make_train_step()(state, gan_golden_batch(z))
    with pytest.raises(AssertionError):
        compare_gan_step(state, losses, z, trees,
                         meta["vocoder"]["learning_rate"])


def test_mel_loss_backward_is_exact_f32(monkeypatch):
    """The mel projection's backward product runs in exact f32 whatever
    the process sets (torch.set_float32_matmul_precision("medium"), TF32
    on a card), and its gradient matches a float64 one."""
    from tts_king_torch.ops import stft

    seen = []
    matmul = torch.matmul

    def spy(*a, **kw):
        seen.append(torch.get_float32_matmul_precision())
        return matmul(*a, **kw)

    old = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("medium")
    try:
        y = torch.from_numpy(np.random.RandomState(0).randn(
            2, 1024).astype(np.float32)).requires_grad_(True)
        monkeypatch.setattr(torch, "matmul", spy)
        mel = stft.hifigan_mel(y, 256, 16, 22050, 64, 256)
        assert seen == ["highest"]
        (g,) = torch.autograd.grad(mel.sum(), y)
        monkeypatch.setattr(torch, "matmul", matmul)
        assert seen == ["highest", "highest"]
    finally:
        torch.set_float32_matmul_precision(old)
    y64 = y.detach().double().requires_grad_(True)
    mag = stft.stft_magnitude(y64, 256, 64, 256, center_pad="hifigan",
                              mag_eps=1e-9)
    basis = stft._mel_basis(22050, 256, 16, 0.0, 8000.0, "cpu").double()
    ref = torch.log(torch.clamp(mag @ basis.t(), min=1e-5)).sum()
    (g64,) = torch.autograd.grad(ref, y64)
    np.testing.assert_allclose(g.numpy(), g64.numpy(), rtol=1e-3,
                               atol=1e-4 * float(g64.abs().max()))


def test_gan_steps_learn(golden):
    """Four steps on the golden's batch lower the mel L1 (as
    test_gan_step_runs_and_learns); every loss stays finite."""
    meta, z, trees = golden
    trainer = gan_trainer(meta)
    state = trainer.state_from(*gan_state_dicts(trees))
    step = trainer.make_train_step()
    batch = gan_golden_batch(z)
    first = None
    for i in range(4):
        losses = step(state, batch)
        assert all(np.isfinite(float(v)) for v in losses), i
        first = float(losses.mel_l1) if first is None else first
    assert state.step == 4 and state.gen_opt.count == 4
    assert float(losses.mel_l1) < first


def test_bf16_step_tracks_f32(golden):
    """compute_dtype=bf16 from the same variables: every loss within 5% of
    the f32 step's (of max(|loss|, 1)), f32 master params and buffers (as
    test_gan_step_bf16_compute_matches_f32)."""
    meta, z, trees = golden
    out = {}
    for name, dtype in (("f32", None), ("bf16", torch.bfloat16)):
        trainer = gan_trainer(meta, compute_dtype=dtype)
        state = trainer.state_from(*gan_state_dicts(trees))
        out[name] = (state, trainer.make_train_step()(state,
                                                      gan_golden_batch(z)))
    for field in out["f32"][1]._fields:
        a = float(getattr(out["f32"][1], field))
        b = float(getattr(out["bf16"][1], field))
        assert np.isfinite(b), field
        assert abs(a - b) <= 0.05 * max(abs(a), 1.0), (field, a, b)
    state = out["bf16"][0]
    assert all(t.dtype == torch.float32 for t in state.gen.state_dict()
               .values())
    assert all(t.dtype == torch.float32 for t in state.disc.state_dict()
               .values())


def test_adamw_schedule_matches_optax():
    """Optimizer.adamw under the per-epoch exponential decay against
    optax.adamw(exponential_decay(staircase=True)) over steps that cross
    an epoch: params and moments rtol 1e-6, the decay on every leaf."""
    import jax
    import jax.numpy as jnp
    import optax

    from tts_king_torch.train.schedule import exponential_decay
    from tts_king_torch.train.state import Optimizer
    from tts_king_torch.weights import flax_to_torch

    lr = optax.exponential_decay(2e-4, transition_steps=2, decay_rate=0.5,
                                 staircase=True)
    for count in range(7):
        np.testing.assert_allclose(exponential_decay(2e-4, 2, 0.5)(count),
                                   float(lr(count)), rtol=1e-7)
    rng = np.random.RandomState(0)
    params = {"conv": {"v": rng.randn(3, 2, 4).astype(np.float32),
                       "g": np.ones(4, np.float32),
                       "bias": rng.randn(4).astype(np.float32)}}
    tx = optax.adamw(lr, b1=0.8, b2=0.99, eps=1e-3, weight_decay=0.01)
    jp = jax.tree.map(jnp.asarray, params)
    st = tx.init(jp)
    model = torch.nn.Module()
    model.conv = torch.nn.Module()
    for k, v in flax_to_torch({"params": params}).items():
        model.conv.register_parameter(k.split(".")[1],
                                      torch.nn.Parameter(v.clone()))
    opt = Optimizer.adamw(exponential_decay(2e-4, 2, 0.5), 0.8, 0.99, 1e-3)
    ost = opt.init(model)
    for i in range(5):
        grads = jax.tree.map(lambda p: jnp.asarray(
            rng.randn(*p.shape).astype(np.float32)), jp)
        upd, st = tx.update(grads, st, jp)
        jp = optax.apply_updates(jp, upd)
        opt.apply(model, {k: v for k, v in flax_to_torch(
            {"params": jax.tree.map(np.asarray, grads)}).items()}, ost)
    want = flax_to_torch({"params": jax.tree.map(np.asarray, jp)})
    for k, v in model.named_parameters():
        np.testing.assert_allclose(v.detach().numpy(), want[k].numpy(),
                                   rtol=1e-6, atol=1e-9, err_msg=k)
    mu = flax_to_torch({"params": jax.tree.map(np.asarray, st[0].mu)})
    for k, v in ost.mu.items():
        np.testing.assert_allclose(v.numpy(), mu[k].numpy(), rtol=1e-6,
                                   atol=1e-9)
    assert ost.count == int(st[0].count) == 5
    assert GAN_ADAM_B1 == 0.8


# ----------------------------------------------------------------- data


def _write_wavs(tmp_path, lengths, sr=22050, prefix="w"):
    paths = []
    for i, n in enumerate(lengths):
        t = np.arange(n) / sr
        w = 0.4 * np.sin(2 * np.pi * (100 + 20 * i) * t) * 30000
        p = tmp_path / f"{prefix}{i}.wav"
        wavfile.write(str(p), sr, w.astype(np.int16))
        paths.append(str(p))
    return paths


def _assert_mels_close(got, want):
    """Log-mels in the linear domain, as tests/test_torch_features.py holds
    them: rtol MEL_RTOL plus MEL_FRAME_ATOL of the frame's largest bin."""
    from chip_smoke import MEL_FRAME_ATOL, MEL_RTOL

    lin_g, lin_w = np.exp(got), np.exp(np.asarray(want))
    bound = MEL_RTOL * lin_w + MEL_FRAME_ATOL * lin_w.max(-1, keepdims=True)
    assert (np.abs(lin_g - lin_w) <= bound).all()


def _numpy(batch):
    return {k: v.numpy() for k, v in batch.items()}


@pytest.mark.parametrize("fmax_loss", [None, 11025.0])
def test_mel_dataset_matches_jax(tmp_path, fmax_loss):
    """The same wavs through both MelDatasets: the same crops bit for bit
    (file shuffle, batch order, per-item crop RNG, zero-padded short
    clips), mels close in the linear domain, the input mel a separate
    transform when fmax_loss differs."""
    import dataclasses

    from tts_king_torch.data.mel_dataset import MelDataset
    from tts_king_tpu.data.mel_dataset import MelDataset as JaxMelDataset

    cfg = dataclasses.replace(_tiny_cfg(), mel_fmax_loss=fmax_loss)
    rng = np.random.RandomState(7)
    paths = _write_wavs(tmp_path, [300 + int(rng.randint(0, 900))
                                   for _ in range(8)])
    got = [_numpy(b) for b in MelDataset(paths, _port_cfg(cfg), seed=5,
                                         device="cpu").batches(4, seed=9)]
    want = list(JaxMelDataset(paths, cfg, seed=5).batches(4, seed=9))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["wav"], w["wav"])
        _assert_mels_close(g["mel"], w["mel"])
        _assert_mels_close(g["mel_loss"], w["mel_loss"])
        assert (fmax_loss is None) == np.array_equal(g["mel"], g["mel_loss"])


def test_mel_dataset_sharded_batches_bit_match(tmp_path):
    """shard=(rank, n) blocks concatenate to the unsharded batch exactly;
    a batch that does not divide raises (as the JAX test)."""
    from tts_king_torch.data.mel_dataset import MelDataset

    cfg = _port_cfg(_tiny_cfg())
    rng = np.random.RandomState(7)
    paths = _write_wavs(tmp_path, [900 + int(rng.randint(0, 600))
                                   for _ in range(8)], prefix="m")
    full = list(MelDataset(paths, cfg, seed=5, device="cpu").batches(4, 9))
    sh = [list(MelDataset(paths, cfg, seed=5, device="cpu").batches(
        4, seed=9, shard=(r, 2))) for r in (0, 1)]
    assert len(full) == len(sh[0]) == len(sh[1]) == 2
    for f, a, b in zip(full, *sh):
        for k in ("mel", "wav", "mel_loss"):
            assert a[k].shape[0] == b[k].shape[0] == 2
            assert torch.equal(torch.cat([a[k], b[k]]), f[k])
    with pytest.raises(ValueError, match="not divisible"):
        next(MelDataset(paths, cfg, seed=5, device="cpu").batches(
            4, seed=9, shard=(0, 3)))


def test_mel_dataset_fine_tuning_matches_jax(tmp_path):
    """fine_tuning=True against the JAX MelDataset: base mels of
    (frames, mels) and (mels, frames), longer and shorter than a segment,
    with wavs shorter than the mel's span: the same aligned crops, the
    same zero pads, bit for bit; the loss mels close."""
    from tts_king_torch.data.mel_dataset import MelDataset
    from tts_king_tpu.data.mel_dataset import MelDataset as JaxMelDataset

    cfg = _tiny_cfg()
    frames = cfg.segment_size // cfg.hop_size
    mel_dir = tmp_path / "mels"
    mel_dir.mkdir()
    rng = np.random.RandomState(3)
    n_frames = [frames + 9, frames - 5, frames + 2, 3 * frames]
    paths = _write_wavs(tmp_path, [n * cfg.hop_size - 40 * (i % 2)
                                   for i, n in enumerate(n_frames)])
    for i, (p, n) in enumerate(zip(paths, n_frames)):
        m = rng.randn(n, cfg.num_mels).astype(np.float32)
        name = os.path.splitext(os.path.basename(p))[0]
        np.save(mel_dir / f"{name}.npy", m.T if i == 3 else m)
    kw = dict(fine_tuning=True, base_mels_path=str(mel_dir), seed=2)
    got = [_numpy(b) for b in MelDataset(paths, _port_cfg(cfg), device="cpu",
                                         **kw).batches(2, seed=4)]
    want = list(JaxMelDataset(paths, cfg, **kw).batches(2, seed=4))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g["mel"].shape == (2, frames, cfg.num_mels)
        np.testing.assert_array_equal(g["mel"], w["mel"])
        np.testing.assert_array_equal(g["wav"], w["wav"])
        _assert_mels_close(g["mel_loss"], w["mel_loss"])


# ----------------------------------------------------------------- the loop


def _loop_env(tmp_path):
    from tts_king_torch.config import TrainConfig, TTSConfig

    vc = _port_cfg(_tiny_cfg())
    vc.batch_size = 2
    cfg = TTSConfig(vocoder=vc,
                    train=TrainConfig(ckpt_path=str(tmp_path / "ckpt"),
                                      result_path=str(tmp_path / "res")))
    wavs = _write_wavs(tmp_path, [2000 + 500 * i for i in range(4)])
    return cfg, wavs


def test_train_vocoder_loop_checkpoint_and_resume(tmp_path):
    """tests/test_vocoder_loop.py on the port (CPU): the errors (a parallel
    run outside a process group; fewer training wavs than a batch), 2
    steps with validation on a cycled val split, a checkpoint whose folded
    params drive the inference Generator and whose GAN state
    resumes (weights, spectral buffers, Adam counts and moments), the
    metrics' phases; then a resume for one more step."""
    from tts_king_torch.models.hifigan import Generator
    from tts_king_torch.train.checkpoint import restore_vocoder_state
    from tts_king_torch.train.vocoder_loop import train_vocoder

    cfg, wavs = _loop_env(tmp_path)
    vc = cfg.vocoder
    with pytest.raises(ValueError, match="process group"):
        train_vocoder(cfg, wavs, max_steps=2, distributed=True, device="cpu",
                      **DISC)
    with pytest.raises(ValueError, match="training wavs"):
        train_vocoder(cfg, wavs[:1], max_steps=2, device="cpu", **DISC)
    state = train_vocoder(cfg, wavs[1:], val_paths=wavs[:1], max_steps=2,
                          log_every=1, save_every=2, device="cpu", **DISC)
    assert state.step == 2

    ckpt_dir = os.path.join(cfg.train.ckpt_path, "vocoder")
    payload = restore_vocoder_state(ckpt_dir)
    assert int(payload["step"]) == 2
    gan = payload["gan_state"]
    assert gan["step"] == 2
    assert gan["gen_opt"]["count"] == gan["disc_opt"]["count"] == 2
    for k, v in state.disc.state_dict().items():
        assert torch.equal(gan["disc"][k], v), k
    assert "msd.disc_s0.convs_0.u" in gan["disc"]
    gen = Generator(vc, mrf_backend="fused")
    gen.load_state_dict(payload["params"])
    with torch.no_grad():
        wav = gen(torch.zeros(1, 8, vc.num_mels))
    assert wav.shape == (1, 8 * 16)

    metrics = os.path.join(cfg.train.result_path,
                           "multi_vocoder.metrics.jsonl")
    lines = [json.loads(ln) for ln in open(metrics)]
    assert [r["phase"] for r in lines] == ["vocoder", "vocoder",
                                           "vocoder_val", "vocoder_val"]
    assert all(np.isfinite(r[n]) for r in lines[:2]
               for n in ("disc", "gen", "mel_l1", "fm", "adv"))
    assert "val_mel_l1" in lines[-1]

    resumed = train_vocoder(cfg, wavs[1:], max_steps=3, restore_step=2,
                            device="cpu", **DISC)
    assert resumed.step == 3
    assert resumed.gen_opt.count == resumed.disc_opt.count == 3
    assert int(restore_vocoder_state(ckpt_dir)["step"]) == 3


def test_train_vocoder_emergency_checkpoint(tmp_path, monkeypatch):
    """A step that fails leaves a checkpoint of the last completed step and
    re-raises the original error."""
    from tts_king_torch.train import vocoder as vocoder_mod
    from tts_king_torch.train.checkpoint import restore_vocoder_state
    from tts_king_torch.train.vocoder_loop import train_vocoder

    make = vocoder_mod.VocoderTrainer.make_train_step

    def failing(self, mesh=None):
        step = make(self, mesh)

        def run(state, batch):
            if state.step == 1:
                raise RuntimeError("boom")
            return step(state, batch)

        return run

    monkeypatch.setattr(vocoder_mod.VocoderTrainer, "make_train_step",
                        failing)
    cfg, wavs = _loop_env(tmp_path)
    with pytest.raises(RuntimeError, match="boom"):
        train_vocoder(cfg, wavs, max_steps=3, device="cpu", **DISC)
    payload = restore_vocoder_state(os.path.join(cfg.train.ckpt_path,
                                                 "vocoder"))
    assert payload["step"] == payload["gan_state"]["step"] == 1


def test_train_vocoder_refuses_a_family_it_cannot_train(tmp_path,
                                                       monkeypatch):
    """vocoder_model BigVGAN is refused, naming the family, before any
    weights or directories are made; MelGAN trains HiFi-GAN's Generator, as
    the JAX package does, and gets as far as its weights."""
    from tts_king_torch.train import vocoder as vocoder_mod
    from tts_king_torch.train.vocoder_loop import train_vocoder

    class Made(Exception):
        pass

    def init_state(self, seed):
        raise Made

    monkeypatch.setattr(vocoder_mod.VocoderTrainer, "init_state", init_state)
    cfg, wavs = _loop_env(tmp_path)
    cfg.model.vocoder_model = "BigVGAN"
    with pytest.raises(ValueError, match="'BigVGAN'"):
        train_vocoder(cfg, wavs, max_steps=1, device="cpu", **DISC)
    assert not os.path.exists(cfg.train.ckpt_path)
    cfg.model.vocoder_model = "MelGAN"
    with pytest.raises(Made):
        train_vocoder(cfg, wavs, max_steps=1, device="cpu", **DISC)


def test_vocoder_cli(tmp_path, monkeypatch):
    """python -m tts_king_torch.train.vocoder_loop: every wav under
    --wavs-dir, sorted, the first --val-frac (at least one) for validation,
    the flags passed on; --distributed without a coordinator or torchrun's
    environment raises; an empty directory exits."""
    from tts_king_torch.train import vocoder_loop

    calls = []
    monkeypatch.setattr(vocoder_loop, "train_vocoder",
                        lambda cfg, wavs, **kw: calls.append((wavs, kw)) or
                        type("S", (), {"step": 0})())
    _write_wavs(tmp_path, [100] * 5)
    assert vocoder_loop.main(["--wavs-dir", str(tmp_path), "--steps", "3",
                              "--restore-step", "2", "--device", "cpu"]) == 0
    wavs, kw = calls[0]
    assert [os.path.basename(w) for w in kw["val_paths"]] == ["w0.wav"]
    assert len(wavs) == 4 and kw["max_steps"] == 3
    assert kw["restore_step"] == 2 and kw["device"] == "cpu"
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    for flag in (["--distributed"], ["--distributed", "--coordinator",
                                     "localhost:1"]):
        with pytest.raises(ValueError, match="torchrun"):
            vocoder_loop.main(["--wavs-dir", str(tmp_path), "--device",
                               "cpu"] + flag)
    empty = tmp_path / "empty"
    empty.mkdir()
    with pytest.raises(SystemExit):
        vocoder_loop.main(["--wavs-dir", str(empty)])


def test_default_device_raises_without_cuda(tmp_path):
    """VocoderTrainer, train_vocoder and MelDataset run on the card unless
    the caller asks for the CPU: without one they raise."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from tts_king_torch.data.mel_dataset import MelDataset
    from tts_king_torch.train.vocoder import VocoderTrainer
    from tts_king_torch.train.vocoder_loop import train_vocoder

    cfg, wavs = _loop_env(tmp_path)
    for make in (lambda: VocoderTrainer(cfg.vocoder),
                 lambda: train_vocoder(cfg, wavs),
                 lambda: MelDataset(wavs, cfg.vocoder)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()
