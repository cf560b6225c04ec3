"""The port's mesh (tts_king_torch/parallel) against the JAX package's
parallel/mesh.py, and its collectives on gloo processes on the CPU:

  * rank r's (dp, tp) position is where JAX's build_mesh(dp, tp) puts
    device r; build_mesh's errors and its stderr note are JAX's;
  * the FastSpeech2 and HiFi-GAN tensor-parallel rules pick the parameters
    fs2_param_specs / hifigan_param_specs pick on the JAX trees (names
    through weights.py) and split the same dims, in the torch layout;
  * shard_state_dict's tp blocks and shard_batch's row blocks;
    FS2Dataset(shard=...)'s row blocks of the global batches;
  * on 4 gloo ranks at dp 2 x tp 2: the positions, a store barrier used
    twice under one name, all_reduce and all_gather over each axis, and
    the gradients of copy_to, reduce_from and sum_over."""

import dataclasses

import numpy as np
import pytest
import torch

import chip_smoke as cs
from tts_king_torch.parallel import launch
from tts_king_torch.parallel.mesh import (FS2_TP_RULES, HIFIGAN_TP_RULES,
                                          build_mesh, fs2_param_specs,
                                          hifigan_param_specs,
                                          rank_position, shard_batch,
                                          shard_state_dict, spec_for)

MESHES = [(8, 1), (4, 2), (2, 4), (1, 8), (2, 2)]


@pytest.mark.parametrize("dp,tp", MESHES)
def test_rank_positions_match_jax(dp, tp):
    import jax

    from tts_king_tpu.parallel.mesh import build_mesh as jax_mesh

    ids = np.vectorize(lambda d: d.id)(jax_mesh(dp, tp).devices)
    order = [d.id for d in jax.devices()]
    for r in range(dp * tp):
        assert rank_position(r, tp) == tuple(
            int(i) for i in np.argwhere(ids == order[r])[0])
    mesh = build_mesh(dp, tp, devices=["cpu"] * 8)
    assert mesh.shape == {"dp": dp, "tp": tp} and mesh.local


@pytest.mark.parametrize("dp,tp", [(-1, 3), (4, 4), (3, 3), (2, 2), (-1, 2)])
def test_build_mesh_errors_and_note_match_jax(dp, tp, capfd):
    import jax

    from tts_king_tpu.parallel.mesh import build_mesh as jax_mesh

    def outcome(fn):
        try:
            m = fn()
            return ("ok", dict(m.shape), capfd.readouterr().err)
        except ValueError as e:
            return ("error", str(e), capfd.readouterr().err)

    want = outcome(lambda: jax_mesh(dp, tp, devices=jax.devices()))
    got = outcome(lambda: build_mesh(dp, tp, devices=["cpu"] * 8))
    assert got == want


def _flax_marks(tree, specs):
    """Each leaf as its index along the split dim (zeros if replicated)."""
    from jax.sharding import PartitionSpec as P

    def mark(a, spec):   # a: the leaf's shape and dtype
        dims = [i for i, s in enumerate(tuple(spec)) if s is not None]
        if not dims:
            return np.zeros(a.shape, np.float32)
        return np.indices(a.shape)[dims[0]].astype(np.float32) + 1

    import jax

    return jax.tree.map(mark, tree, specs,
                        is_leaf=lambda x: isinstance(x, P))


def _torch_split_dims(sd):
    """The dim each marked tensor varies along (None: all zeros)."""
    out = {}
    for k, v in sd.items():
        v = v.numpy()
        if not v.any():
            out[k] = None
            continue
        dims = [d for d in range(v.ndim)
                if (np.diff(v, axis=d) != 0).any()]
        assert len(dims) == 1, (k, dims)
        out[k] = dims[0]
    return out


def _check_rules(params, jax_specs_fn, port_specs_fn):
    from tts_king_torch.weights import flax_to_torch

    marked = flax_to_torch({"params": _flax_marks(
        params, jax_specs_fn(params))})
    want = _torch_split_dims(marked)
    got = port_specs_fn(list(marked))
    assert got == want
    assert any(d is not None for d in got.values())
    return got


def test_fs2_tp_rules_match_jax():
    import jax
    import jax.numpy as jnp

    from tests.test_torch_train import TINY_MODEL, _jax_model
    from tts_king_tpu.parallel.mesh import fs2_param_specs as jax_specs

    model = _jax_model({**TINY_MODEL, "use_cwt": True})
    params = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.zeros((1,), jnp.int32),
        jnp.zeros((1, 8), jnp.int32), jnp.ones((1,), jnp.int32),
        train=False))["params"]
    got = _check_rules(params, jax_specs, fs2_param_specs)
    # each FFT block: w_q/k/v and their biases, fc's weight, w_1 and its
    # bias, w_2's weight
    assert sum(d is not None for d in got.values()) == 2 * (6 + 1 + 3)


@pytest.mark.parametrize("weight_norm", [False, True])
def test_hifigan_tp_rules_match_jax(weight_norm):
    import jax
    import jax.numpy as jnp

    from tts_king_tpu.config import VocoderModelConfig
    from tts_king_tpu.models.hifigan import Generator
    from tts_king_tpu.parallel.mesh import hifigan_param_specs as jax_specs

    cfg = VocoderModelConfig(upsample_rates=[4, 4],
                             upsample_kernel_sizes=[8, 8],
                             upsample_initial_channel=32,
                             resblock_kernel_sizes=[3, 7],
                             resblock_dilation_sizes=[[1, 3], [1, 3]])
    gen = Generator(cfg, weight_norm=weight_norm)
    params = jax.eval_shape(lambda: gen.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8, 80))))["params"]
    _check_rules(params, jax_specs, hifigan_param_specs)


def test_shard_round_trip_and_rows():
    """shard_state_dict slices each rule's dim into tp blocks whose
    concatenation is the full tensor; shard_batch gives each dp index its
    contiguous rows (the leading accumulation axis kept)."""
    from tts_king_torch.parallel.comm import Axis
    from tts_king_torch.parallel.mesh import Mesh

    sd = {"encoder.layer_0.slf_attn.w_qs.weight": torch.randn(8, 4),
          "encoder.layer_0.slf_attn.fc.weight": torch.randn(4, 8),
          "encoder.layer_0.slf_attn.fc.bias": torch.randn(4)}
    parts = [shard_state_dict(sd, Mesh(1, 2, rank=i,
                                       tp_axis=Axis(None, 2, i)))
             for i in range(2)]
    for k, v in sd.items():
        dim = spec_for(k, FS2_TP_RULES)
        if dim is None:
            assert all(torch.equal(p[k], v) for p in parts)
        else:
            assert torch.equal(torch.cat([p[k] for p in parts], dim), v)
    assert spec_for("ups_1.v", HIFIGAN_TP_RULES) == 0
    batch = {"texts": torch.arange(2 * 6).view(2, 6)}
    rows = [shard_batch(batch, Mesh(3, 1, rank=i, dp_axis=Axis(None, 3, i)),
                        extra_leading_axis=True)["texts"] for i in range(3)]
    assert torch.equal(torch.cat(rows, 1), batch["texts"])


def test_collectives_on_gloo_ranks():
    """4 ranks at dp 2 x tp 2 (chip_smoke.collectives_check), over each
    mesh axis and over the whole group."""
    ranks = launch.run(cs.collectives_check, 4, ({"tp": 2},), timeout_s=120)
    x = [np.arange(3, dtype=np.float32) + r for r in range(4)]
    for r, out in enumerate(ranks):
        i, j = rank_position(r, 2)
        assert out["position"] == (i, j)
        assert out["grouped"] == {"dp": True, "tp": True, "world": True}
        for name, peers in (("dp", [j, 2 + j]), ("tp", [2 * i, 2 * i + 1]),
                            ("world", [0, 1, 2, 3])):
            total = sum(x[p] for p in peers)
            np.testing.assert_array_equal(out[f"all_reduce_{name}"], total)
            np.testing.assert_array_equal(out[f"all_gather_{name}"],
                                          np.stack([x[p] for p in peers]))
            # rank p's loss is sum(f(x_p) * (p + 1))
            weight = sum(p + 1 for p in peers)
            y, g = out[f"copy_to_{name}"]
            np.testing.assert_array_equal(y, x[r])
            np.testing.assert_array_equal(g, np.full(3, weight, np.float32))
            y, g = out[f"reduce_from_{name}"]
            np.testing.assert_array_equal(y, total)
            np.testing.assert_array_equal(g, np.full(3, r + 1, np.float32))
            y, g = out[f"sum_over_{name}"]
            np.testing.assert_array_equal(y, total)
            np.testing.assert_array_equal(g, np.full(3, weight, np.float32))


def test_axis_of_size_one_runs_no_collective():
    """2 ranks at dp 1 x tp 2, as chip_smoke's parallel_path runs them: the
    dp axis of size 1 carries no group, so its helpers are the identity
    and no collective runs over it, while tp and the world reduce
    (chip_smoke.check_collectives)."""
    ranks = launch.run(cs.parallel_tasks, 2, (
        [("collectives_check", {"tp": 2})],), timeout_s=120)
    for r in ranks:
        assert r["collectives_check"]["grouped"] == {
            "dp": False, "tp": True, "world": True}
    cs.check_collectives(ranks, 2, "cpu")


def test_dataset_shards_concatenate_to_the_global_batch(tmp_path):
    """FS2Dataset(shard=(i, 2)) yields each rank's row block of the same
    global superbatches and eval batches (JAX's data/dataset.py:298-360),
    and the sharded eval batches drop the ragged tail."""
    from tests.test_torch_train import _write_corpus
    from tts_king_torch.config import (OptimizerConfig, PreprocessConfig,
                                       TrainConfig)
    from tts_king_torch.data.dataset import FS2Dataset
    from tts_king_tpu.config import OptimizerConfig as JOpt
    from tts_king_tpu.config import PreprocessConfig as JPre
    from tts_king_tpu.config import TrainConfig as JTrain
    from tts_king_tpu.data.dataset import FS2Dataset as JaxDataset

    root = _write_corpus(tmp_path, n_train=18, n_val=3)
    tc = TrainConfig(optimizer=OptimizerConfig(batch_size=4, grad_acc_step=2),
                     max_masks_per_sentence=0.2)
    pp = PreprocessConfig(preprocessed_path=root)
    one = FS2Dataset("train.txt", pp, tc, max_mel_len=64)
    shards = [FS2Dataset("train.txt", pp, tc, max_mel_len=64, shard=(i, 2))
              for i in range(2)]
    jax_shard = JaxDataset("train.txt", JPre(preprocessed_path=root),
                           JTrain(optimizer=JOpt(batch_size=4,
                                                 grad_acc_step=2),
                                  max_masks_per_sentence=0.2),
                           max_mel_len=64, use_native_loader=False,
                           shard=(1, 2))
    whole = list(one.epoch_superbatches(seed=7))
    parts = [list(s.epoch_superbatches(seed=7)) for s in shards]
    ref = list(jax_shard.epoch_superbatches(seed=7))
    assert len(whole) == len(parts[0]) == len(parts[1]) == len(ref) == 2
    for w, a, b, j in zip(whole, *parts, ref):
        for k in w:
            np.testing.assert_array_equal(np.concatenate([a[k], b[k]], 1),
                                          w[k], err_msg=k)
            np.testing.assert_array_equal(b[k], j[k], err_msg=k)
    val = FS2Dataset("train.txt", pp, dataclasses.replace(
        tc, optimizer=OptimizerConfig(batch_size=4)), drop_last=False,
        shard=(0, 2))
    assert [b["texts"].shape[0] for b in val.batches()] == [2] * 4


@pytest.mark.parametrize("device,cards,noted", [
    ("cuda:0", 4, True), ("cuda:0", 1, False), ("cpu", 4, False)])
def test_one_process_on_many_cards_is_noted(monkeypatch, capsys, device,
                                            cards, noted):
    """One process of train() (mesh.dp -1) or train_vocoder(use_mesh=True)
    on a host of several cards trains on one of them, where JAX's
    single-process mesh would use them all: it says so on stderr, naming
    the multi-process launch; use_mesh=False asks for one card and is
    not noted."""
    from tts_king_torch.config import TTSConfig
    from tts_king_torch.train.loop import build_train_mesh
    from tts_king_torch.train.vocoder_loop import _vocoder_mesh

    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    cfg = TTSConfig()
    assert build_train_mesh(cfg, device) is None
    assert _vocoder_mesh(cfg.vocoder, True, False, device) is None
    assert _vocoder_mesh(cfg.vocoder, False, False, device) is None
    err = capsys.readouterr().err
    assert err.count("[mesh] note:") == (2 if noted else 0)
    if noted:
        assert "train()" in err and "train_vocoder()" in err
        assert "--distributed" in err and f"one of {cards} cards" in err
