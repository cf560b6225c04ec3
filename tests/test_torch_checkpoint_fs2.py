"""The port's FastSpeech2 ``.pth.tar`` converter against the JAX package's.

An upstream-named state dict is made from the keys that
tts_king_tpu/checkpoint.convert_fs2_state reads, with the shapes of a seeded
JAX FastSpeech2's variables (in torch's layouts) and seeded values. Both
converters take it; the port's tensors must equal the JAX ones carried
across by the port's weight bridge exactly, and a ``.pth.tar`` written with
a split speaker embedding must give the JAX AcousticModel's mel through the
port's AcousticModel. Nothing is read from a reference tree or downloaded.
"""

import dataclasses

import numpy as np
import pytest
import torch

N_SPEAKERS = 3


def _configs(tmp_path=None, use_cwt=False):
    """The JAX micro config at two FFT blocks a side, and the port's copy."""
    from tts_king_torch import config as port_config
    from tts_king_tpu.config import micro_config

    cfg = micro_config()
    cfg.model.transformer.encoder_layer = 2
    cfg.model.transformer.decoder_layer = 2
    cfg.model.use_cwt = use_cwt
    if tmp_path is not None:
        cfg.acoustic.weights_path = str(tmp_path / "model.pth.tar")
    port = port_config._build(port_config.TTSConfig,
                              dataclasses.asdict(cfg)).validate()
    return cfg, port


class _Recorder(dict):
    """Every key is present; reading one returns a (1, 1, 1) array holding
    the key's number, so each converted leaf names the key it came from."""

    def __init__(self):
        super().__init__()
        self.keys_read = []

    def __contains__(self, key):
        return True

    def __getitem__(self, key):
        if key not in self.keys_read:
            self.keys_read.append(key)
        return np.full((1, 1, 1), self.keys_read.index(key), np.float32)


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if hasattr(v, "items"):
            yield from _flat(v, prefix + (str(k),))
        else:
            yield prefix + (str(k),), np.asarray(v)


def _torch_layout(path, shape):
    """An upstream tensor's shape from its flax leaf's: a Dense kernel
    (in, out) is a Linear weight (out, in), a conv kernel (k, in, out) a
    Conv1d weight (out, in, k); other leaves keep their shape."""
    if path[-1] == "kernel":
        return tuple(reversed(shape))
    return tuple(shape)


def _upstream_state(use_cwt):
    """{upstream key: seeded float32 array} for the JAX micro model (with
    2 + 2 FFT blocks and N_SPEAKERS speakers)."""
    from tts_king_tpu.checkpoint import convert_fs2_state
    from tts_king_tpu.pipeline import AcousticModel

    cfg, _ = _configs(use_cwt=use_cwt)
    tc = cfg.model.transformer
    variables = AcousticModel(cfg, n_speakers=N_SPEAKERS).variables
    shapes = {(coll,) + p: a.shape for coll in variables
              for p, a in _flat(variables[coll])}
    rec = _Recorder()
    traced = convert_fs2_state(rec, tc.encoder_layer, tc.decoder_layer,
                               use_cwt)
    rng = np.random.RandomState(0)
    state = {}
    for coll in traced:
        for path, leaf in _flat(traced[coll]):
            if (coll,) + path not in shapes:
                continue   # read by the converter, absent from this model
            key = rec.keys_read[int(leaf.reshape(-1)[0])]
            a = rng.standard_normal(_torch_layout(
                path, shapes[(coll,) + path])).astype(np.float32)
            if key.endswith("running_var"):
                a = 1.0 + np.abs(a)
            state[key] = 0.3 * a if not key.endswith("running_var") else a
    # every leaf of the model has an upstream key
    assert len(state) == len(shapes)
    # a duration head of bias log(1 + 5) and a tenth of its random weight:
    # about five frames a phoneme, so the mel has frames to compare
    head = "variance_adaptor.duration_predictor.linear_layer"
    state[head + ".weight"] *= 0.1
    state[head + ".bias"][:] = np.log(6.0)
    return state


@pytest.fixture(scope="module")
def upstream_state():
    return _upstream_state(use_cwt=False)


def test_fs2_converter_equals_the_jax_converter(upstream_state):
    from tts_king_torch.checkpoint import convert_fs2_state
    from tts_king_torch.weights import flax_to_torch
    from tts_king_tpu.checkpoint import convert_fs2_state as jax_convert

    _, port_cfg = _configs()
    tc = port_cfg.model.transformer
    want = flax_to_torch(jax_convert(upstream_state, tc.encoder_layer,
                                     tc.decoder_layer))
    got = convert_fs2_state(
        {k: torch.from_numpy(v) for k, v in upstream_state.items()},
        tc.encoder_layer, tc.decoder_layer)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype == torch.float32, k
        assert torch.equal(got[k], want[k]), k
    # the port's FastSpeech2 takes exactly these keys
    from tts_king_torch.models.fs2 import build_fastspeech2

    with torch.device("meta"):
        model = build_fastspeech2(port_cfg.model, {
            "pitch": [-3.0, 9.5], "energy": [-1.5, 6.1]}, N_SPEAKERS)
    own = {k for k in model.state_dict()
           if not k.endswith("num_batches_tracked")}
    assert own == set(got)


def _write_pth_tar(state, path):
    """The reference trainer's layout (train.py:212-227): the model without
    speaker_emb, the embedding beside it."""
    sd = {k: torch.from_numpy(v) for k, v in state.items()}
    emb = sd.pop("speaker_emb.weight")
    torch.save({"model": sd, "embedding": emb, "optimizer": {}}, path)


def test_acoustic_model_loads_a_pth_tar_as_the_jax_one(upstream_state,
                                                       tmp_path):
    from tts_king_torch.pipeline import AcousticModel
    from tts_king_tpu.pipeline import AcousticModel as JaxAcousticModel

    cfg, port_cfg = _configs(tmp_path)
    _write_pth_tar(upstream_state, cfg.acoustic.weights_path)
    jam = JaxAcousticModel(cfg, n_speakers=N_SPEAKERS)
    pam = AcousticModel(port_cfg, n_speakers=N_SPEAKERS, device="cpu")
    sd = pam.model.state_dict()
    assert torch.equal(sd["speaker_emb.weight"],
                       torch.from_numpy(upstream_state["speaker_emb.weight"]))
    phonemes = np.random.RandomState(1).randint(1, 100, (2, 9))
    want = jam.generate(phonemes, speaker_name=[0, 2])
    got = pam.generate(phonemes, speaker_name=[0, 2])
    np.testing.assert_array_equal(got["mel_lens"].numpy(),
                                  np.asarray(want["mel_lens"]))
    n = int(np.asarray(want["mel_lens"]).max())
    assert n > 0
    # tests/test_torch_pipeline.py's bound on the port's mel against the
    # JAX TTSKing's (test_golden_e2e_speak_matches_jax): MAE < 1e-3
    mae = float(np.mean(np.abs(got["postnet_mel"][:, :n].numpy()
                               - np.asarray(want["postnet_mel"])[:, :n])))
    assert mae < 1e-3, mae


def test_cwt_checkpoint_names_the_missing_branch(tmp_path):
    """A .pth.tar of a CWT model (use_cwt=True), which raised before the
    CWT branch was ported: the port's converter gives exactly the JAX
    converter's tree, CWT heads (net.0 conv, net.2 LayerNorm, linear)
    included, which the port's CWT FastSpeech2 takes whole; through
    AcousticModel its mel matches the JAX AcousticModel's."""
    from tts_king_torch.checkpoint import convert_fs2_state
    from tts_king_torch.models.fs2 import build_fastspeech2
    from tts_king_torch.pipeline import AcousticModel
    from tts_king_torch.weights import flax_to_torch
    from tts_king_tpu.checkpoint import convert_fs2_state as jax_convert
    from tts_king_tpu.pipeline import AcousticModel as JaxAcousticModel

    state = _upstream_state(use_cwt=True)
    cfg, port_cfg = _configs(tmp_path, use_cwt=True)
    tc = port_cfg.model.transformer
    want = flax_to_torch(jax_convert(state, tc.encoder_layer,
                                     tc.decoder_layer, use_cwt=True))
    got = convert_fs2_state({k: torch.from_numpy(v) for k, v in state.items()},
                            tc.encoder_layer, tc.decoder_layer, use_cwt=True)
    assert sorted(got) == sorted(want)
    assert any(k.startswith("variance_adaptor.pitch_mean.flat_one.norm")
               for k in got)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    with torch.device("meta"):
        model = build_fastspeech2(port_cfg.model, {
            "pitch": [-3.0, 9.5], "energy": [-1.5, 6.1]}, N_SPEAKERS)
    assert {k for k in model.state_dict()
            if not k.endswith("num_batches_tracked")} == set(got)
    _write_pth_tar(state, cfg.acoustic.weights_path)
    jam = JaxAcousticModel(cfg, n_speakers=N_SPEAKERS)
    pam = AcousticModel(port_cfg, n_speakers=N_SPEAKERS, device="cpu")
    phonemes = np.random.RandomState(1).randint(1, 100, (3, 9))
    want_out = jam.generate(phonemes, speaker_name=[0, 2, 1])
    got_out = pam.generate(phonemes, speaker_name=[0, 2, 1])
    np.testing.assert_array_equal(got_out["mel_lens"].numpy(),
                                  np.asarray(want_out["mel_lens"]))
    n = int(np.asarray(want_out["mel_lens"]).max())
    assert n > 0
    np.testing.assert_allclose(got_out["pitch_mean"].numpy(),
                               np.asarray(want_out["pitch_mean"]), rtol=1e-4,
                               atol=1e-4)
    mae = float(np.mean(np.abs(got_out["postnet_mel"][:, :n].numpy()
                               - np.asarray(want_out["postnet_mel"])[:, :n])))
    assert mae < 1e-3, mae
