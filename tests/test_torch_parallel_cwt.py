"""A CWT FastSpeech2 over a dp mesh at inference, on the CPU, against the
JAX AcousticModel(mesh=) on JAX's virtual CPU devices (tests/conftest.py).

JAX runs one global program over the mesh: the batch is padded to a
multiple of dp with zero rows, and those rows join the CWT pitch's batch
standardization (tts_king_tpu/ops/cwt.py). The port computes the same
function: over gloo ranks the variance adaptor's sums run across the
ranks' rows; on a single-process mesh the padded batch runs whole on the
model's device. Batches that need pad rows: 6 over dp = 4, 5 over dp = 2.
Durations and lengths equal; mels at the dp inference tests' bounds
(rtol 1e-4, atol 1e-5, tests/test_torch_parallel_inference.py). The
control: the same rows on one device without the pad rows give other
durations or mels."""

import dataclasses

import numpy as np
import pytest

import chip_smoke as cs
from tts_king_torch.parallel import launch

TIMEOUT_S = 240
N_SPEAKERS = 4


def _port_config(jax_cfg):
    from tts_king_torch import config as port_config

    return port_config._build(port_config.TTSConfig,
                              dataclasses.asdict(jax_cfg)).validate()


@pytest.fixture(scope="module")
def cwt_models():
    """The JAX CWT AcousticModel on one device and on meshes of dp = 4 and
    dp = 2, its variables as numpy, and a batch of 6 ragged utterances."""
    import jax
    import jax.numpy as jnp

    from tts_king_tpu.config import micro_config
    from tts_king_tpu.parallel.mesh import build_mesh
    from tts_king_tpu.pipeline import AcousticModel as JaxAcoustic

    cfg = micro_config()
    cfg.model = dataclasses.replace(cfg.model, use_cwt=True)
    am = JaxAcoustic(cfg, n_speakers=N_SPEAKERS)
    # the std head at 1 (kernel 0, bias 1), so the standardized pitch moves
    # the pitch embedding's bins: at the initial weights the ReLU head
    # gives a std of 0 and a pitch of the mean whatever the batch
    head = am.variables["params"]["variance_adaptor"]["pitch_std"]["linear"]
    head["kernel"] = jnp.zeros_like(head["kernel"])
    head["bias"] = jnp.ones_like(head["bias"])
    meshes = {dp: JaxAcoustic(cfg, n_speakers=N_SPEAKERS,
                              variables=am.variables,
                              mesh=build_mesh(dp=dp, tp=1,
                                              devices=jax.devices()[:dp]))
              for dp in (4, 2)}
    rng = np.random.RandomState(5)
    phonemes = rng.randint(64, 200, size=(6, 9))
    phonemes[2, 6:] = 0
    src_lens = np.array([9, 9, 6, 9, 9, 9], np.int32)
    return {"cfg": cfg, "one": am, "mesh": meshes,
            "variables": jax.tree.map(np.asarray, am.variables),
            "phonemes": phonemes, "src_lens": src_lens,
            "speakers": list(rng.randint(0, N_SPEAKERS, size=(6,)))}


def _assert_matches(got, ref):
    for key in ("duration_rounded", "mel_lens"):
        np.testing.assert_array_equal(np.asarray(got[key]),
                                      np.asarray(ref[key]), err_msg=key)
    np.testing.assert_allclose(np.asarray(got["postnet_mel"]),
                               np.asarray(ref["postnet_mel"]), rtol=1e-4,
                               atol=1e-5)


def _numpy(out):
    return {k: v.float().numpy() if hasattr(v, "numpy") else v
            for k, v in out.items()}


@pytest.mark.parametrize("dp,n", [(4, 6), (2, 5)])
def test_cwt_on_a_single_process_mesh_matches_jax(cwt_models, dp, n):
    """AcousticModel and TTSKing over a mesh of dp CPU replicas: JAX's
    mesh program, pad rows included; one device without them differs."""
    from tts_king_torch.parallel.mesh import build_mesh
    from tts_king_torch.pipeline import AcousticModel, TTSKing

    m = cwt_models
    cfg = _port_config(m["cfg"])
    kw = dict(speaker_name=m["speakers"][:n], src_lens=m["src_lens"][:n])
    ref = m["mesh"][dp].generate(m["phonemes"][:n], **kw)
    mesh = build_mesh(dp=dp, devices=["cpu"] * dp)
    am = AcousticModel(cfg, variables=m["variables"], n_speakers=N_SPEAKERS,
                       device="cpu", mesh=mesh)
    got = _numpy(am.generate(m["phonemes"][:n], **kw))
    assert got["postnet_mel"].shape[0] == n
    _assert_matches(got, ref)
    king = TTSKing(cfg, device="cpu", n_speakers=N_SPEAKERS, mesh=mesh,
                   acoustic_variables=m["variables"])
    _assert_matches(_numpy(king.tts.generate(m["phonemes"][:n], **kw)), ref)
    # the control: the unpadded batch standardizes over other rows
    alone = m["one"].generate(m["phonemes"][:n], **kw)
    assert not np.allclose(np.asarray(alone["postnet_mel"]),
                           got["postnet_mel"], rtol=1e-4, atol=1e-5)


def test_cwt_over_gloo_ranks_matches_jax(cwt_models):
    """AcousticModel over 2 gloo ranks (each runs its rows of 5 padded to
    6; the CWT sums run over both): every rank returns JAX's dp = 2
    program's lengths and mels."""
    m = cwt_models
    spec = {"cfg": _port_config(m["cfg"]), "n_speakers": N_SPEAKERS,
            "variables": m["variables"], "phonemes": m["phonemes"][:5],
            "speakers": m["speakers"][:5]}
    ref = m["mesh"][2].generate(m["phonemes"][:5],
                                speaker_name=m["speakers"][:5])
    ranks = launch.run(cs.dp_generate, 2, (spec,), timeout_s=TIMEOUT_S)
    for got in ranks:
        np.testing.assert_array_equal(got["mel_lens"],
                                      np.asarray(ref["mel_lens"]))
        np.testing.assert_allclose(got["postnet_mel"],
                                   np.asarray(ref["postnet_mel"]),
                                   rtol=1e-4, atol=1e-5)
