"""The port's training entry point's run-level features against the JAX package.

Resume from the ``state{i}`` extended checkpoint, the wall-clock deadline,
``--indices`` and the ``yestr`` warm start, on the CPU with a small 5-D
stand-in (``tests/torch_tiny_model.py``) in place of MMVit4. The port is held
against itself as ``tests/test_resume.py`` holds the JAX package (a resumed
run equals an uninterrupted one bit for bit), ``RunLogs.open_resumed``
against JAX's byte for byte, and a whole resumed run against JAX's
``run_experiment`` from the same weights.
"""

from __future__ import annotations

import json
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import corrifnet_tpu.data.crossval as jax_cv
import corrifnet_tpu_torch.data.crossval as port_cv
from corrifnet_tpu.utils.logfiles import RunLogs as JaxRunLogs
from corrifnet_tpu_torch.config import ExperimentConfig
from corrifnet_tpu_torch.data import write_permutation
from corrifnet_tpu_torch.run import main as run_main
from corrifnet_tpu_torch.run.main import run_experiment
from corrifnet_tpu_torch.train import Checkpointer, init_state
from corrifnet_tpu_torch.utils.logfiles import RunLogs
from torch_threads import torch_threads  # noqa: F401 (autouse fixture)
from torch_tiny_model import jax_params, port_state_dict, registered  # noqa: F401

LOG_FILES = ("trainFile.txt", "trainaccFile.txt", "trainepochFile.txt", "valFile.txt",
             "valaccFile.txt", "testFile.txt", "testaccFile.txt", "lrFile.txt")
# the slice against JAX: f32 convolutions and Adam in another order of sums
# over 4 epochs; measured worst 2.8e-6 relative (torch 2.13 CPU, jax 0.9 CPU)
JAX_RTOL = 1e-4


@pytest.fixture
def splits(tmp_path):
    """randInd24.txt in tmp_path, where both packages' cross_val look."""
    write_permutation(24, tmp_path, seed=0)
    old = jax_cv._SPLITS_DIR, port_cv._SPLITS_DIR
    jax_cv._SPLITS_DIR = port_cv._SPLITS_DIR = tmp_path
    yield tmp_path
    jax_cv._SPLITS_DIR, port_cv._SPLITS_DIR = old


def _cfg(n_epochs, **extra):
    # 24 patches, fold 1 of 4: 17 training (5 steps of 4, the last padded),
    # 1 validation, 6 test
    return ExperimentConfig(**{
        "train_set_size": 24, "fno": 1, "fsiz": 4, "mini_batch_size": 4,
        "n_epochs": n_epochs, "learn_rate": 1e-3, "modeltype": "TinySeg5D", "lim": 224,
        "synthetic_seed": 0, "dtype": "float32", "extended_checkpoints": True, **extra})


def _run(cfg, root=None, **kwargs):
    return run_experiment(cfg, run_root=root or ".", index=0, device="cpu", **kwargs)


def _partial_epoch(run_dir, epoch):
    """What a kill in the middle of ``epoch`` leaves: its train lines and
    its lrFile header, no validation."""
    for name, junk in [("trainFile.txt", "0.123\n"), ("trainaccFile.txt", "0.456\n"),
                       ("trainepochFile.txt", f"{epoch}\n"),
                       ("lrFile.txt", f"Epoch: {epoch} LR: [0.001]\n{{}}\n")]:
        with open(Path(run_dir) / name, "a") as f:
            f.write(junk)


def _final(run_dir):
    return torch.load(Path(run_dir) / "Finaliremmodel0", weights_only=True)


@pytest.mark.parametrize("completed", [1, 2, 3])
def test_open_resumed_matches_jax(tmp_path, completed):
    """Logs of 3 whole epochs and part of a fourth, cut back by both
    packages' ``open_resumed`` and appended to: the same bytes."""
    lines = {"trainFile.txt": 4, "trainaccFile.txt": 4, "trainepochFile.txt": 4,
             "valFile.txt": 3, "valaccFile.txt": 3, "testFile.txt": 1,
             "testaccFile.txt": 1}
    lr = "".join(f"Epoch: {e} LR: [0.001]\n{{'last_epoch': {e + 1}}}\nTraining loss:0.7\n"
                 f"Training accuracy:0.1\nValidation loss:0.8\nValidation accuracy:0.2\n"
                 for e in range(3)) + "deadline reached after epoch 2\nEpoch: 3 LR: [0.001]\n"
    dirs = [tmp_path / "jax", tmp_path / "port"]
    for d in dirs:
        d.mkdir()
        for name, n in lines.items():
            (d / name).write_text("".join(f"0.{k}{n}\n" for k in range(n)))
        (d / "lrFile.txt").write_text(lr)
    for opener, d in ((JaxRunLogs.open_resumed, dirs[0]), (RunLogs.open_resumed, dirs[1])):
        logs = opener(d, completed)
        logs.train.write("9.0\n")
        logs.lr.write(f"Epoch: {completed} LR: [0.001]\n")
        logs.close()
    for name in LOG_FILES:
        assert (dirs[0] / name).read_bytes() == (dirs[1] / name).read_bytes(), name
    assert len((dirs[1] / "trainFile.txt").read_text().split()) == completed + 1


def test_resume_matches_uninterrupted(splits, registered):
    """2 epochs, a kill in the third, resumed to 4: the same final weights,
    history, test metrics and log files, bit for bit, as 4 epochs in one go."""
    res_a = _run(_cfg(4), splits / "a")
    res_b = _run(_cfg(2), splits / "b")
    run_b = res_b["run_dir"]
    _partial_epoch(run_b, 2)
    res_b2 = _run(_cfg(4), resume_dir=run_b)
    assert res_b2["run_dir"] == run_b and res_b2["train_steps"] == res_a["train_steps"] == 20

    fa, fb = _final(res_a["run_dir"]), _final(run_b)
    assert sorted(fa) == sorted(fb)
    assert all(torch.equal(fa[k], fb[k]) for k in fa)
    assert res_b2["test_jaccard"] == res_a["test_jaccard"]
    assert res_b2["test_loss"] == res_a["test_loss"]
    for k in ("train_loss", "train_jac", "val_loss", "val_jac"):
        assert res_b2["history"][k] == res_a["history"][k], k
        assert len(res_b2["history"][k]) == 4
    for name in LOG_FILES:
        a = (Path(res_a["run_dir"]) / name).read_text()
        assert a == (Path(run_b) / name).read_text(), name
    assert [p.name for p in Path(run_b).glob("state0*")] == ["state0@20"]


def test_resume_requires_extended_checkpoint(splits, registered):
    res = _run(_cfg(1, extended_checkpoints=False), splits / "plain")
    assert not list(Path(res["run_dir"]).glob("state0*"))
    with pytest.raises(FileNotFoundError, match="extended_checkpoints"):
        _run(_cfg(2), resume_dir=res["run_dir"])


def test_deadline_stops_at_epoch_boundary_and_still_tests(splits, registered):
    """A deadline already past stops after one epoch, still tests and leaves
    a run that resumes to the whole protocol."""
    res = _run(_cfg(3), splits / "d", deadline_s=1e-3)
    run_dir = Path(res["run_dir"])
    assert len(res["history"]["train_loss"]) == len(res["history"]["val_jac"]) == 1
    assert (run_dir / "testaccFile.txt").read_text().strip()
    assert (run_dir / "fpsfile.txt").exists()
    assert [p.name for p in run_dir.glob("state0@*")] == ["state0@5"]
    lr = (run_dir / "lrFile.txt").read_text()
    assert "deadline reached after epoch 0 (1/3 epochs)" in lr

    res2 = _run(_cfg(3), resume_dir=run_dir)
    assert len(res2["history"]["train_loss"]) == 3
    assert (run_dir / "trainepochFile.txt").read_text().split() == ["0", "1", "2"]
    lr = (run_dir / "lrFile.txt").read_text()
    assert all(lr.count(f"Epoch: {e} LR:") == 1 for e in range(3))


def _adam_state(seed):
    from torch_tiny_model import TinySeg5D

    model = TinySeg5D().reset_parameters(torch.Generator().manual_seed(seed))
    state = init_state(model, "Adam")
    model(torch.ones(1, 3, 3, 8, 8)).sum().backward()
    state.optimizer.step()
    state.step = 1
    return state


def test_save_state_crash_safe_generations(tmp_path):
    """``state0@{step}`` generations: an older one and a stale temporary are
    removed only after the new file is in place; the restore gives back the
    weights, Adam's moments and its per-parameter step (a CPU f32 scalar,
    as Adam makes it) and the step."""
    ck = Checkpointer(tmp_path)
    first = _adam_state(0)
    assert ck.save_state("state0", first).name == "state0@1"
    (tmp_path / "state0@1.123.tmp").write_bytes(b"partial")
    later = _adam_state(1)
    later.step = 6
    assert ck.save_state("state0", later).name == "state0@6"
    assert sorted(p.name for p in tmp_path.glob("state0*")) == ["state0@6"]
    assert ck.exists("state0") and not ck.exists("state1")

    restored = ck.restore_state("state0", _adam_state(2))
    assert restored.step == 6
    for a, b in zip(restored.model.state_dict().values(), later.model.state_dict().values()):
        assert torch.equal(a, b)
    got, want = restored.optimizer.state_dict(), later.optimizer.state_dict()
    for i, s in want["state"].items():
        for key, value in s.items():
            assert torch.equal(got["state"][i][key], value), key
            assert got["state"][i][key].dtype == value.dtype
            assert got["state"][i][key].device == value.device
    assert want["state"][0]["step"].dtype == torch.float32


def test_restore_state_accepts_legacy_plain_name(tmp_path):
    """A run checkpointed as a plain ``state0`` still resumes, and the next
    save retires that file."""
    state = _adam_state(3)
    state.step = 4
    torch.save(state.state_dict(), tmp_path / "state0")
    ck = Checkpointer(tmp_path)
    assert ck.exists("state0")
    assert ck.restore_state("state0", _adam_state(4)).step == 4
    ck.save_state("state0", state)
    assert sorted(p.name for p in tmp_path.glob("state0*")) == ["state0@4"]


def test_indices_with_a_template_give_two_run_dirs(splits, registered, monkeypatch):
    """``--indices 0,1`` with ``{i}`` in ``--config``: one run per index,
    each from its own config file, returned by index; ``--resume`` refuses
    to be combined with it."""
    monkeypatch.chdir(splits)
    for i in (0, 1):
        (splits / f"cfg{i}.json").write_text(json.dumps(
            {**_cfg(1).__dict__, "learn_rate": 1e-3 * (i + 1)}))
    r = run_main.main(["--config", "cfg{i}.json", "--indices", "0,1", "--run-root",
                       "runs", "--device", "cpu"])
    assert sorted(r) == [0, 1]
    assert [Path(r[i]["run_dir"]).name.endswith(f"_model{i}") for i in (0, 1)] == [True] * 2
    assert (Path(r[1]["run_dir"]) / "lrFile.txt").read_text().startswith("Epoch: 0 LR: [0.002]")
    with pytest.raises(SystemExit):
        run_main.main(["--config", "cfg{i}.json", "--indices", "0,1", "--resume", "x"])


class _Started(Exception):
    pass


def _weights_at_first_step(cfg, root, monkeypatch):
    """The model's state_dict when ``run_experiment`` hands it to
    ``train_model`` (the run stops there)."""
    def stop(state, **kwargs):
        raise _Started({k: v.clone() for k, v in state.model.state_dict().items()})

    monkeypatch.setattr(run_main, "train_model", stop)
    with pytest.raises(_Started) as started:
        _run(cfg, root)
    return started.value.args[0]


@pytest.mark.parametrize("kind", ["pt", "npz"])
def test_yestr_loads_transfer_checkpoint(splits, registered, monkeypatch, kind):
    """``transfertype='yestr'`` loads ``transfer_checkpoint`` (strictly)
    before the first step: a port checkpoint of the stand-in, or a
    flattened JAX variable tree of MMVit4 (the ``.npz`` of
    ``run.evaluate --weights``). With no checkpoint named the model stays as
    built, as in the JAX package."""
    from corrifnet_tpu.models.torch_import import mmvit4_variables_from_state_dict
    from corrifnet_tpu_torch.models import create_model
    from corrifnet_tpu_torch.models.jax_import import flatten_variables

    if kind == "pt":
        want = create_model("TinySeg5D", seed=7).state_dict()
        path = splits / "warm.pt"
        torch.save(want, path)
        cfg = _cfg(1, transfertype="yestr", transfer_checkpoint=str(path))
        built = _weights_at_first_step(_cfg(1, transfertype="yestr"), splits, monkeypatch)
        assert all(torch.equal(built[k], v)
                   for k, v in create_model("TinySeg5D", seed=0).state_dict().items())
    else:
        want = create_model("MMVit4", seed=3).state_dict()
        variables = mmvit4_variables_from_state_dict(want, pack_stage1=True)
        path = splits / "warm.npz"
        np.savez(path, **flatten_variables(
            {c: variables[c] for c in ("params", "batch_stats")}))
        cfg = _cfg(1, modeltype="MMVit4", transfertype="yestr",
                   transfer_checkpoint=str(path))
    got = _weights_at_first_step(cfg, splits, monkeypatch)
    assert sorted(got) == sorted(want)
    assert all(torch.equal(got[k], want[k]) for k in want)


_NUMBER = re.compile(r"[-+]?(?:\d+\.\d*|\.\d+|\d+)(?:[eE][-+]?\d+)?")


def test_resumed_run_matches_jax_run_experiment(splits, registered):
    """The slice as a whole: JAX's ``run_experiment`` with its
    ``TinySeg5D`` and the port's with the same stand-in, both warm-started
    (``yestr``) from one set of weights, f32, 2 epochs then resumed to 4.
    Every per-epoch loss and Jaccard and the test's within ``JAX_RTOL``
    relative (measured worst 2.8e-6), and the log files line for line the
    same apart from their numbers."""
    from corrifnet_tpu.config import ExperimentConfig as JaxConfig
    from corrifnet_tpu.models import registry as jax_registry
    from corrifnet_tpu.run.main import run_experiment as jax_run
    from corrifnet_tpu.train import Checkpointer as JaxCheckpointer
    from corrifnet_tpu_torch.models import create_model
    from test_resume import TinySeg5D as JaxTinySeg5D

    weights = create_model("TinySeg5D", seed=5).state_dict()
    torch.save(weights, splits / "warm.pt")
    jax_ck = JaxCheckpointer(str(splits / "jaxwarm"))
    jax_ck.save("warm", jax_params(weights), {})
    jax_ck.close()
    assert all(torch.equal(a, weights[k])
               for k, a in port_state_dict(jax_params(weights)).items())

    def port_cfg(n):
        return _cfg(n, transfertype="yestr", transfer_checkpoint=str(splits / "warm.pt"))

    def jax_cfg(n):
        return JaxConfig(**{**port_cfg(n).__dict__,
                            "transfer_checkpoint": str(splits / "jaxwarm" / "warm")})

    port = _run(port_cfg(2), splits / "port")
    port = _run(port_cfg(4), resume_dir=port["run_dir"])
    jax_registry._REGISTRY["TinySeg5D"] = jax_registry.ModelSpec(
        "TinySeg5D", JaxTinySeg5D, "5d", "test stand-in", True)
    try:
        jx = jax_run(jax_cfg(2), run_root=splits / "jax", index=0)
        jx = jax_run(jax_cfg(4), index=0, resume_dir=jx["run_dir"])
    finally:
        jax_registry._REGISTRY.pop("TinySeg5D", None)

    worst = 0.0
    for k in ("train_loss", "train_jac", "val_loss", "val_jac"):
        got, want = np.asarray(port["history"][k]), np.asarray(jx["history"][k])
        assert got.shape == want.shape == (4,), k
        worst = max(worst, float(np.max(np.abs(got - want) / np.abs(want))))
    for k in ("test_loss", "test_jaccard"):
        worst = max(worst, abs(port[k] - jx[k]) / abs(jx[k]))
    assert worst <= JAX_RTOL, worst
    for name in LOG_FILES:
        got = (Path(port["run_dir"]) / name).read_text().splitlines()
        want = (Path(jx["run_dir"]) / name).read_text().splitlines()
        assert [_NUMBER.sub("#", ln) for ln in got] == [_NUMBER.sub("#", ln) for ln in want], name
