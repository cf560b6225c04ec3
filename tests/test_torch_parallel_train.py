"""The port's data- and tensor-parallel training on gloo processes on the
CPU, held to one process and to the JAX package's single-device step:

  * the FastSpeech2 step at dp=2, tp=2 (one head a rank) and dp2 x tp2
    against JAX's make_train_step from the same weights and superbatch
    (loss rtol 1e-4, params, Adam moments and BatchNorm stats at
    chip_smoke.compare_train_step's tolerances; tests/test_train.py:163-189
    runs JAX's at dp4 x tp2);
  * dropout on: dp=2 equals one process at the same seed (the global
    batch's masks); the CWT model at dp=2 equals one process (its pitch
    standardizes over the global batch);
  * the guard: a step that averages each rank's own masked means (DDP's
    reduction) must miss the single-device loss;
  * train() on 2 ranks for 4 steps plus a resume equals one process, and
    its dp=2 checkpoint resumes in one process; train_vocoder on 2 ranks
    equals one process.

Each multi-process run goes through tts_king_torch.parallel.launch, which
kills its ranks after a timeout; every rank runs one torch thread."""

import dataclasses
import json
import os
import shutil

import numpy as np
import pytest

import chip_smoke as cs
from tests.test_torch_train import (TINY_MODEL, TINY_OPT, _write_corpus,
                                    jax_train, seeded_variables,
                                    synthetic_superbatch)
from tts_king_torch.parallel import launch

TIMEOUT_S = 240
LR0 = 0.03125   # the Noam rate at count 0 (d 16, warm-up 4)
# the loops' parameters after 5 steps: compare_train_step's 1e-3 of the
# learning rate (the loops' Adam eps is 1e-3, as its optimizer's)
PARAM_ATOL = 1e-3 * LR0


def _spec(**kw):
    return {"model_cfg": TINY_MODEL, "opt_cfg": TINY_OPT, "seed": 0,
            "dropout": False, "stats": cs.TRAIN_STATS,
            "n_speakers": cs.TRAIN_N_SPEAKERS, "dp": None, "tp": 1, **kw}


def _step_specs():
    """The specs of the step tasks: one superbatch (acc 2 x B 4, ragged
    phoneme counts), the tiny model (dropout off, on), the CWT model."""
    variables = seeded_variables(TINY_MODEL, seed=3)
    cwt_model = {**TINY_MODEL, "use_cwt": True}
    sb = [synthetic_superbatch(2, 4, 8, 16, seed=5)]
    base = _spec(variables=variables, superbatches=sb)
    cwt = _spec(model_cfg=cwt_model, variables=seeded_variables(
        cwt_model, seed=4), superbatches=sb)
    return base, dict(base, dropout=True), cwt


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """Every 2-rank run of this file in one launch: the port's step at
    dp=2, tp=2, dp=2 with dropout, the CWT model at dp=2 and the guard;
    train() on a dp=2 config for 4 steps and a resume to 5; train_vocoder
    with distributed=True for 2 steps."""
    from tests.test_torch_vocoder_training import (DISC, _loop_env,
                                                   _write_wavs)

    tmp = tmp_path_factory.mktemp("two_ranks")
    base, drop, cwt = _step_specs()
    root = _write_corpus(tmp / "corpus", n_train=24, n_val=4)
    dp2 = _parallel_loop_config(root, tmp / "dp2", dp=2)
    vcfg, _ = _loop_env(tmp)
    vcfg.vocoder.batch_size = 4
    (tmp / "wavs").mkdir()
    voc = {"cfg": vcfg, "steps": 2, "first": True, "disc": DISC,
           "device": "cpu", "wavs": _write_wavs(
               tmp / "wavs", [2000 + 300 * i for i in range(10)])}
    tasks = [("fs2_parallel_steps:dp", dict(base, dp=2)),
             ("fs2_parallel_steps:tp", dict(base, dp=1, tp=2)),
             ("fs2_parallel_steps:drop", dict(drop, dp=2)),
             ("fs2_parallel_steps:cwt", dict(cwt, dp=2)),
             ("fs2_parallel_steps:naive", dict(base, dp=2, naive=True)),
             ("train_loop_runs", {"cfg": dp2, "runs": LOOP_RUNS}),
             ("vocoder_loop_run", dict(voc, distributed=True)),
             ("vocoder_loop_run:fault", dict(
                 voc, distributed=True, steps=1, first=False, fault="gen",
                 cfg=_voc_cfg(vcfg, tmp / "voc_fault")))]
    ranks = launch.run(cs.parallel_tasks, 2, (tasks,), timeout_s=TIMEOUT_S)
    return {"ranks": ranks, "root": root, "dp2": dp2, "voc": voc,
            "tmp": tmp}


@pytest.fixture(scope="module")
def steps(two_ranks):
    """The 2-rank steps beside JAX's step and one process of the port
    (dropout on; the CWT model) on the same superbatch."""
    base, drop, cwt = _step_specs()
    return {"jax": jax_train(TINY_MODEL, TINY_OPT, base["variables"],
                             base["superbatches"])[0],
            "one_drop": cs.fs2_parallel_steps(0, drop),
            "one_cwt": cs.fs2_parallel_steps(0, cwt),
            "base": base, "ranks": two_ranks["ranks"]}


def _losses_agree(ranks, name):
    """Every rank reports the same global losses."""
    for r in ranks[1:]:
        assert r[name]["losses_each"] == ranks[0][name]["losses_each"]


@pytest.mark.parametrize("mesh", ["dp2", "tp2", "dp2xtp2"])
def test_parallel_train_step_matches_jax(steps, mesh):
    if mesh == "dp2xtp2":
        ranks = [{"run": r} for r in launch.run(
            cs.fs2_parallel_steps, 4, (dict(steps["base"], dp=2, tp=2),),
            timeout_s=TIMEOUT_S)]
        name = "run"
    else:
        ranks, name = steps["ranks"], "fs2_parallel_steps:" + mesh[:2]
    _losses_agree(ranks, name)
    cs.compare_train_step(ranks[0][name], steps["jax"], LR0,
                          loss_rtol=1e-4)


def test_dp_dropout_equals_one_process(steps):
    """With dropout on, each rank draws the global batch's masks from the
    step's generator and keeps its rows: dp=2 is the one-process step."""
    name = "fs2_parallel_steps:drop"
    _losses_agree(steps["ranks"], name)
    got = steps["ranks"][0][name]
    cs.compare_train_step(got, cs.port_step_as_want(steps["one_drop"]), LR0,
                          loss_rtol=1e-4)
    # the masks bite: the loss is not the dropout-free one
    assert abs(got["losses"]["total"]
               - float(steps["jax"]["losses"]["total"])) > 1e-3


def test_dp_cwt_model_equals_one_process(steps):
    """The CWT pitch is standardized over the batch axis: at dp=2 over the
    global batch (all-reduced sums), so the step is one process's."""
    name = "fs2_parallel_steps:cwt"
    _losses_agree(steps["ranks"], name)
    got = steps["ranks"][0][name]
    assert got["losses"]["pitch_mean"] > 0
    cs.compare_train_step(got, cs.port_step_as_want(steps["one_cwt"]), LR0,
                          loss_rtol=1e-4)


def test_per_rank_masked_means_miss_the_global_loss(steps):
    """The guard on the global-batch semantics: averaging each rank's own
    masked means (as DDP averages gradients) weighs a rank's valid phonemes
    by its own count, and misses the single-device loss on this ragged
    batch, while the mel terms (full-tensor means) still agree."""
    got = steps["ranks"][0]["fs2_parallel_steps:naive"]["losses"]
    want = {k: float(v) for k, v in steps["jax"]["losses"].items()}
    np.testing.assert_allclose(got["mel"], want["mel"], rtol=1e-4)
    for k in ("total", "pitch", "energy", "duration"):
        assert abs(got[k] - want[k]) > 1e-4 * abs(want[k]), k
    with pytest.raises(AssertionError):
        cs.compare_train_step(steps["ranks"][0]["fs2_parallel_steps:naive"],
                              steps["jax"], LR0, loss_rtol=1e-4)


def _parallel_loop_config(root, ckpt, dp):
    from tts_king_torch import config as pcfg
    from tts_king_torch.config import (MeshConfig, OptimizerConfig,
                                       PreprocessConfig, StepConfig,
                                       TrainConfig, TTSConfig)

    return TTSConfig(
        preprocess=PreprocessConfig(preprocessed_path=root),
        model=pcfg._build(pcfg.ModelConfig, TINY_MODEL),
        mesh=MeshConfig(dp=dp),
        train=TrainConfig(
            ckpt_path=str(ckpt), result_path=str(ckpt) + "_result",
            optimizer=OptimizerConfig(batch_size=4, grad_acc_step=2,
                                      warm_up_step=4, eps=1e-3),
            step=StepConfig(total_step=100, log_step=1, val_step=4,
                            save_step=4),
            objective_val_utts=2))


def _records(cfg):
    with open(os.path.join(cfg.train.result_path,
                           f"{cfg.exp_name}.metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


LOOP_RUNS = [(0, 4), (4, 5)]


@pytest.fixture(scope="module")
def loops(two_ranks):
    """train() for 4 steps and a resume to 5 on 2 ranks and in one process;
    then one process resuming the dp=2 run's step-4 checkpoint."""
    from tts_king_torch.train.loop import train

    tmp, root = two_ranks["tmp"], two_ranks["root"]
    one = _parallel_loop_config(root, tmp / "one", dp=-1)
    for restore, n in LOOP_RUNS:
        one.acoustic.restore_step = restore
        state = train(one, max_steps=n, device="cpu")
    # the dp=2 run's step-4 checkpoint, copied: the resume writes step 5
    shutil.copytree(tmp / "dp2" / "step_00000004",
                    tmp / "resumed" / "step_00000004")
    resumed = _parallel_loop_config(root, tmp / "resumed", dp=-1)
    resumed.acoustic.restore_step = 4
    from_dp2 = train(resumed, max_steps=5, device="cpu")
    return {"dp2": two_ranks["dp2"], "one": one, "state": state,
            "from_dp2": from_dp2,
            "ranks": [r["train_loop_runs"] for r in two_ranks["ranks"]]}


def test_train_loop_on_two_ranks_equals_one_process(loops):
    """The train, val and objective records of rank 0 (the only writer)
    equal one process's, and the step-5 checkpoints hold the same state."""
    from tts_king_torch.train.checkpoint import restore_train_state

    assert [r["step"] for r in loops["ranks"][0]["runs"]] == [4, 5]
    got, want = loops["ranks"][0]["records"], _records(loops["one"])
    assert [r["phase"] for r in got] == [r["phase"] for r in want]
    for a, b in zip(got, want):
        for k in ("total", "mel", "duration", "mcd"):
            if k in b:
                np.testing.assert_allclose(a[k], b[k], rtol=1e-4,
                                           err_msg=f"{b['phase']} {k}")
    a = restore_train_state(loops["dp2"].train.ckpt_path, 5)
    b = restore_train_state(loops["one"].train.ckpt_path, 5)
    for k, v in b["model"].items():
        np.testing.assert_allclose(a["model"][k].numpy(), v.numpy(),
                                   rtol=1e-4, atol=PARAM_ATOL, err_msg=k)
    assert a["opt_state"]["count"] == b["opt_state"]["count"] == 5


def test_dp2_checkpoint_resumes_in_one_process(loops):
    """The dp=2 run's step-4 checkpoint (the single-process format) resumes
    in one process to the one-process run's step 5."""
    got = loops["from_dp2"].model.state_dict()
    for k, v in loops["state"].model.state_dict().items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=1e-4,
                                   atol=PARAM_ATOL, err_msg=k)


def _voc_cfg(cfg, path):
    return dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, ckpt_path=str(path), result_path=str(path) + "_result"))


@pytest.fixture(scope="module")
def voc_one(two_ranks):
    """train_vocoder in one process, twice, as the 2-rank run: one step,
    then a resume to 2."""
    voc, tmp = two_ranks["voc"], two_ranks["tmp"]
    return [cs.vocoder_loop_run(0, dict(voc, cfg=_voc_cfg(
        voc["cfg"], tmp / f"voc_one{i}"))) for i in range(2)]


def test_train_vocoder_on_two_ranks_equals_one_process(two_ranks, voc_one):
    """train_vocoder with distributed=True on 2 ranks (2 rows each) for one
    step and a resume to 2: the gradients of the generator and both
    discriminators averaged over dp, so both ranks' nets are equal, the
    generator and both discriminators after the first step and the
    generator after the second are one process's, and so are the logged
    losses."""
    ranks = [r["vocoder_loop_run"] for r in two_ranks["ranks"]]
    want = voc_one[0]
    assert ranks[0]["step"] == ranks[1]["step"] == want["step"] == 2
    assert ranks[0]["digests"] == ranks[1]["digests"]
    for net, params in want["first"].items():
        for k, v in params.items():
            np.testing.assert_allclose(ranks[0]["first"][net][k], v,
                                       rtol=1e-4, atol=1e-6,
                                       err_msg=f"{net} {k}")
    for k, v in want["gen"].items():
        np.testing.assert_allclose(ranks[0]["gen"][k], v, rtol=1e-4,
                                   atol=1e-6, err_msg=k)
    got = [r for r in ranks[0]["records"] if r["phase"] == "vocoder"]
    ref = [r for r in want["records"] if r["phase"] == "vocoder"]
    assert len(got) == len(ref) == 2
    for a, b in zip(got, ref):
        for k in ("disc", "gen", "mel_l1"):
            np.testing.assert_allclose(a[k], b[k], rtol=1e-4, err_msg=k)


def test_train_vocoder_dp_check_catches_unaveraged_gradients(two_ranks,
                                                            voc_one):
    """chip_smoke.vocoder_dp_check, the card's check of train_vocoder on 2
    ranks, passes the 2-rank run and catches the planted fault: a
    generator whose gradients are not averaged over dp parts the ranks
    and moves by more than PAR_VOC_STEP_REL of one process's step."""
    got = cs.vocoder_dp_check(two_ranks["ranks"], voc_one,
                              two_ranks["voc"])
    assert got["ranks_equal"] and not got["fault_ranks_equal"]
    assert max(got["step1_rel_to_step"].values()) <= cs.PAR_VOC_STEP_REL
    assert got["step1_rel_fault_gen"] > cs.PAR_VOC_STEP_REL
    fault = two_ranks["ranks"][0]["vocoder_loop_run:fault"]["first"]["gen"]
    assert not all(np.allclose(fault[k], v, rtol=1e-4, atol=1e-6)
                   for k, v in voc_one[0]["first"]["gen"].items())


def test_cli_distributed_on_two_processes(loops, tmp_path):
    """python -m tts_king_torch.train cfg.yaml --distributed --coordinator
    127.0.0.1:PORT --num-processes 2 --process-id i, one command a process
    (gloo on the CPU): both exit 0, rank 0 writes the checkpoint, and its
    train losses are the 2-rank launch's."""
    import subprocess
    import sys

    import yaml

    cfg = dataclasses.replace(loops["dp2"], train=dataclasses.replace(
        loops["dp2"].train, ckpt_path=str(tmp_path / "ckpt"),
        result_path=str(tmp_path / "result")))
    path = tmp_path / "cfg.yaml"
    with open(path, "w") as f:
        yaml.safe_dump(json.loads(json.dumps(dataclasses.asdict(cfg))), f)
    port = launch.free_port()
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen(
        [sys.executable, "-m", "tts_king_torch.train", str(path), "--steps",
         "2", "--device", "cpu", "--no-vocoder", "--distributed",
         "--coordinator", f"127.0.0.1:{port}", "--num-processes", "2",
         "--process-id", str(i)], cwd=cs.REPO, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for i in range(2)]
    try:
        outs = [p.communicate(timeout=TIMEOUT_S) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-2000:]
    assert os.listdir(cfg.train.ckpt_path) == ["step_00000002"]
    got = [r["total"] for r in _records(cfg) if r["phase"] == "train"]
    want = [r["total"] for r in loops["ranks"][0]["records"]
            if r["phase"] == "train"][:2]
    np.testing.assert_allclose(got, want, rtol=1e-6)
