"""The port's data-parallel inference, time-sharded vocoding and dp server
on the CPU, against the JAX package on its 8 virtual CPU devices
(tests/conftest.py):

  * AcousticModel over a single-process mesh of 4 CPU replicas, and over
    4 gloo ranks, against the JAX AcousticModel on build_mesh(dp=4) and on
    one device, the ragged 6-over-4 batch included
    (tests/test_dp_inference.py's checks);
  * vocoder_time_sharded over 2 and 4 gloo ranks and over a
    single-process mesh against JAX's on 4 devices (HiFi-GAN and MelGAN,
    tests/test_time_parallel.py's tolerances), the too-short error, and
    Vocoder.generate_long against Vocoder.generate;
  * SynthesisServer over a dp mesh of 4 CPU replicas: wavs bitwise equal
    to the single-device server's (tests/test_serve.py:81-113).

Each multi-process run goes through tts_king_torch.parallel.launch, which
kills its ranks after a timeout."""

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


def _cpu_mesh(n):
    from tts_king_torch.parallel.mesh import build_mesh

    return build_mesh(dp=n, devices=["cpu"] * n)


@pytest.fixture(scope="module")
def jax_acoustic():
    """The JAX AcousticModel on one device and on build_mesh(dp=4), 4
    speakers, and a batch of 8."""
    from tts_king_tpu.config import micro_config
    from tts_king_tpu.parallel.mesh import build_mesh
    from tts_king_tpu.pipeline import AcousticModel as JaxAcoustic

    cfg = micro_config()
    am = JaxAcoustic(cfg, n_speakers=N_SPEAKERS)
    am_dp = JaxAcoustic(cfg, n_speakers=N_SPEAKERS, variables=am.variables,
                        mesh=build_mesh(dp=4, tp=1))
    rng = np.random.RandomState(0)
    return (cfg, am, am_dp, rng.randint(64, 200, size=(8, 7)),
            list(rng.randint(0, N_SPEAKERS, size=(8,))))


def test_dp_inference_matches_jax(jax_acoustic):
    import jax

    from tts_king_torch.pipeline import AcousticModel

    cfg, am, am_dp, phonemes, speakers = jax_acoustic
    variables = jax.tree.map(np.asarray, am.variables)
    port = AcousticModel(_port_config(cfg), variables=variables,
                         n_speakers=N_SPEAKERS, device="cpu",
                         mesh=_cpu_mesh(4))
    one = AcousticModel(_port_config(cfg), variables=variables,
                        n_speakers=N_SPEAKERS, device="cpu")

    for n in (8, 6):   # 6 over dp = 4: padded to 8, trimmed on return
        got = port.generate(phonemes[:n], speaker_name=speakers[:n])
        assert got["postnet_mel"].shape[0] == n
        mel = got["postnet_mel"].numpy()
        for ref in (am.generate(phonemes[:n], speaker_name=speakers[:n]),
                    am_dp.generate(phonemes[:n], speaker_name=speakers[:n]),
                    {k: v.numpy() if hasattr(v, "numpy") else v for k, v in
                     one.generate(phonemes[:n],
                                  speaker_name=speakers[:n]).items()}):
            np.testing.assert_array_equal(got["mel_lens"].numpy(),
                                          np.asarray(ref["mel_lens"]))
            np.testing.assert_allclose(mel, np.asarray(ref["postnet_mel"]),
                                       rtol=1e-4, atol=1e-5)


def test_dp_inference_over_processes(jax_acoustic, sharded):
    """AcousticModel over a mesh of 4 gloo ranks: each rank runs its rows
    (6 padded to 8) and gathers the batch; every rank returns the JAX
    dp-mesh's lengths and mels."""
    _, _, am_dp, phonemes, speakers = jax_acoustic
    ref = am_dp.generate(phonemes[:6], speaker_name=speakers[:6])
    for got in sharded["dp_generate"]:
        np.testing.assert_array_equal(got["mel_lens"],
                                      np.asarray(ref["mel_lens"]))
        np.testing.assert_allclose(got["postnet_mel"],
                                   np.asarray(ref["postnet_mel"]),
                                   rtol=1e-4, atol=1e-5)


def _small_voc_config():
    from tts_king_tpu.config import VocoderModelConfig

    # tests/test_time_parallel.py's: two upsample stages, both resblock
    # kernel sets
    return VocoderModelConfig(upsample_rates=[4, 4],
                              upsample_kernel_sizes=[8, 8],
                              upsample_initial_channel=32,
                              resblock_kernel_sizes=[3, 7],
                              resblock_dilation_sizes=[[1, 3], [1, 3]])


MELGAN = {"ngf": 8, "n_residual_layers": 2, "ratios": (4, 4)}


@pytest.fixture(scope="module")
def sharded(jax_acoustic):
    """One long mel through JAX's vocoder_time_sharded on 4 devices (the
    generator jitted, as Vocoder.generate_long passes it) and the full pass
    (HiFi-GAN: 400 frames, MelGAN: 328, neither a multiple of 4 or of 8),
    and through the port: 4 gloo ranks (both generators and
    Vocoder.generate_long, and AcousticModel over the 4 ranks on
    jax_acoustic's ragged 6), 2 gloo ranks, a single-process mesh of 4."""
    import jax
    import jax.numpy as jnp

    from tts_king_tpu.config import TTSConfig
    from tts_king_tpu.models.hifigan import Generator
    from tts_king_tpu.models.melgan import MelGANGenerator
    from tts_king_tpu.ops.streaming import generator_receptive_field
    from tts_king_tpu.ops.time_parallel import vocoder_time_sharded
    from tts_king_tpu.parallel.mesh import build_mesh

    vcfg = _small_voc_config()
    cfg = dataclasses.replace(TTSConfig(), vocoder=vcfg)
    halo = generator_receptive_field(vcfg)
    mesh = build_mesh(dp=4, tp=1, devices=jax.devices()[:4])
    out = {"halo": halo, "up": 16}

    voc = Generator(vcfg)
    mel = np.random.RandomState(0).randn(1, 400, 80).astype(np.float32)
    hv = voc.init(jax.random.PRNGKey(0), jnp.asarray(mel[:, :16]))
    out["hifigan"] = {
        "full": np.asarray(voc.apply(hv, jnp.asarray(mel)))[0],
        "jax": np.asarray(vocoder_time_sharded(
            jax.jit(voc.apply), hv, jnp.asarray(mel), mesh,
            halo_frames=halo, upsample=16))[0]}
    mg = MelGANGenerator(ngf=8, n_residual_layers=2, ratios=(4, 4))
    mmel = np.random.RandomState(2).randn(1, 328, 80).astype(np.float32)
    mv = mg.init(jax.random.PRNGKey(0), jnp.asarray(mmel[:, :16]))
    out["melgan"] = {
        "full": np.asarray(mg.apply(mv, jnp.asarray(mmel)))[0],
        "jax": np.asarray(vocoder_time_sharded(
            jax.jit(mg.apply), mv, jnp.asarray(mmel), mesh,
            halo_frames=16, upsample=16))[0]}

    pcfg = _port_config(cfg)
    hv, mv = jax.tree.map(np.asarray, hv), jax.tree.map(np.asarray, mv)
    lmel = np.random.RandomState(1).randn(1, 320, 80).astype(np.float32)
    hifigan = {"cfg": pcfg, "variables": hv, "mel": mel, "what": "float"}
    melgan = {"cfg": pcfg, "variables": mv, "mel": mmel, "what": "float",
              "melgan": MELGAN, "halo": 16}
    long = {"cfg": pcfg, "variables": hv, "mel": lmel, "what": "int16"}
    acfg, am, _, phonemes, speakers = jax_acoustic
    dp = {"cfg": _port_config(acfg), "n_speakers": N_SPEAKERS,
          "variables": jax.tree.map(np.asarray, am.variables),
          "phonemes": phonemes[:6], "speakers": speakers[:6]}
    tasks = [("time_sharded_vocode:hifigan", hifigan),
             ("time_sharded_vocode:melgan", melgan),
             ("time_sharded_vocode:long", long), ("dp_generate", dp)]
    four = launch.run(cs.parallel_tasks, 4, (tasks,), timeout_s=TIMEOUT_S)
    out["dp_generate"] = [r["dp_generate"] for r in four]
    two = launch.run(cs.time_sharded_vocode, 2, (hifigan,),
                     timeout_s=TIMEOUT_S)
    out["hifigan"]["port4"] = four[0]["time_sharded_vocode:hifigan"]["wav"]
    out["hifigan"]["port2"] = two[0]["wav"]
    out["hifigan"]["local4"] = cs.time_sharded_vocode(
        0, dict(hifigan, devices=["cpu"] * 4))["wav"]
    out["melgan"]["port4"] = four[0]["time_sharded_vocode:melgan"]["wav"]
    out["long"] = {"ranks": [r["time_sharded_vocode:long"]["wav"]
                             for r in four],
                   "mel": lmel, "cfg": pcfg, "variables": hv}
    return out


@pytest.mark.parametrize("run", ["port4", "port2", "local4"])
def test_time_sharded_matches_jax_and_full_pass(sharded, run):
    """tests/test_time_parallel.py:24's contract: the interior at 1e-5 of
    the full pass, the first and last halo frames within 0.2; and the
    port's result at 1e-5 of JAX's vocoder_time_sharded everywhere."""
    r = sharded["hifigan"]
    wav, full = r[run], r["full"]
    assert wav.shape == full.shape == (400 * sharded["up"],)
    edge = sharded["halo"] * sharded["up"]
    np.testing.assert_allclose(wav[edge:-edge], full[edge:-edge],
                               rtol=1e-5, atol=1e-5)
    assert float(np.max(np.abs(wav[:edge] - full[:edge]))) < 0.2
    assert float(np.max(np.abs(wav[-edge:] - full[-edge:]))) < 0.2
    if run != "port2":   # JAX's split is 4 ways
        np.testing.assert_allclose(wav, r["jax"], rtol=1e-5, atol=1e-5)


def test_time_sharded_melgan_matches_full_pass(sharded):
    """tests/test_time_parallel.py:109: MelGAN's ~10-frame receptive field
    under a halo of 16, interior at 1e-5 of the full pass; JAX's split
    everywhere."""
    r = sharded["melgan"]
    assert r["port4"].shape == r["full"].shape == (328 * 16,)
    edge = 16 * 16
    np.testing.assert_allclose(r["port4"][edge:-edge], r["full"][edge:-edge],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(r["port4"], r["jax"], rtol=1e-5, atol=1e-5)


def test_pipeline_generate_long(sharded):
    """tests/test_time_parallel.py:78: Vocoder.generate_long on 4 ranks,
    int16 of the right length on every rank, within 1 LSB of
    Vocoder.generate inside the halo frames."""
    from tts_king_torch.pipeline import Vocoder

    r = sharded["long"]
    full = Vocoder(r["cfg"], variables=r["variables"],
                   device="cpu").generate(r["mel"])[0]
    edge = sharded["halo"] * sharded["up"]
    for wav in r["ranks"]:
        assert wav.dtype == np.int16 and wav.shape == (320 * 16,)
        np.testing.assert_array_equal(wav, r["ranks"][0])
        assert np.max(np.abs(wav[edge:-edge].astype(np.int32)
                             - full[edge:-edge].astype(np.int32))) <= 1


def test_time_sharded_too_short_raises():
    """40 frames over 8 ways is 5 a slice, under a halo of 24."""
    import torch

    from tts_king_torch.ops.time_parallel import vocoder_time_sharded

    with pytest.raises(ValueError, match="too short"):
        vocoder_time_sharded(lambda m: m, torch.zeros(1, 40, 80),
                             _cpu_mesh(8), halo_frames=24, upsample=16)


def test_server_over_dp_mesh():
    """tests/test_serve.py:81-113 on the port: a server over a dp mesh of 4
    CPU replicas gives the single-device server's wavs bit for bit (same
    weights, 3 speakers, the duration head's bias at 1.5, the same 5
    requests), and the same stream."""
    import jax

    from tts_king_torch.pipeline import TTSKing
    from tts_king_torch.serve import SynthesisServer
    from tts_king_tpu.config import micro_config
    from tts_king_tpu.pipeline import AcousticModel as JaxAcoustic
    from tts_king_tpu.pipeline import Vocoder as JaxVocoder

    cfg = micro_config()
    fs2 = jax.tree.map(np.array, JaxAcoustic(cfg, n_speakers=3).variables)
    fs2["params"]["variance_adaptor"]["duration_predictor"]["linear_layer"][
        "bias"][:] = 1.5
    voc = jax.tree.map(np.asarray, JaxVocoder(cfg).variables)

    def run(mesh):
        k = TTSKing(_port_config(cfg), device="cpu", mesh=mesh, n_speakers=3,
                    acoustic_variables=fs2, vocoder_variables=voc)
        server = SynthesisServer(k, max_batch=4, max_wait_ms=20)
        try:
            rng = np.random.RandomState(7)
            futures = [server.submit(phonemes=rng.randint(64, 200, size=(6,)),
                                     speaker=i % 3) for i in range(5)]
            wavs = [f.result(timeout=180) for f in futures]
            stream = list(server.stream(phonemes=np.arange(64, 90),
                                        chunk_frames=16))
            return wavs, np.concatenate(stream)
        finally:
            server.close()

    (wavs_mesh, stream_mesh), (wavs_one, stream_one) = (
        run(_cpu_mesh(4)), run(None))
    assert len(wavs_mesh) == len(wavs_one) == 5
    for a, b in zip(wavs_mesh, wavs_one):
        assert len(a) > 0
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(stream_mesh, stream_one)
