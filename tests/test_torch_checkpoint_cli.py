"""The port's checkpoint import and run-directory evaluation, on the CPU.

* ``run.import_checkpoint`` writes a reference-layout ``.pt`` (or a JAX
  ``.npz``) into a run directory as the port's ``Finaliremmodel0``, equal to
  what ``run.evaluate.load_weights`` reads, and refuses an unknown model,
  wrong keys or shapes, and another model's weights, naming them;
* ``run.evaluate --run-dir`` gives the JAX package's ``evaluate_run`` on the
  same weights over 15 synthetic patches (means and stds within 1e-5): the
  5-D stand-in ``TinySeg5D`` (``tests/torch_tiny_model.py``, registered in
  both packages) with ``--segplot-dir`` writing JAX's PNG names with pixels
  within one u8 level, and ENet, the 4-D path, writing none;
* ``--manifest`` and ``--index`` pick the runs and checkpoints, a JAX
  run's orbax directory is refused naming the export script, and
  ``--weights`` with ``--run-dir`` is refused.
"""

from __future__ import annotations

import json
import os

import matplotlib.pyplot as plt
import numpy as np
import pytest
import torch

from corrifnet_tpu.models import registry as jax_registry
from corrifnet_tpu.models import torch_import as ti
from corrifnet_tpu_torch.data import write_permutation
from corrifnet_tpu_torch.models import create_model
from corrifnet_tpu_torch.run import evaluate
from corrifnet_tpu_torch.run.import_checkpoint import main as import_main
from torch_threads import torch_threads  # noqa: F401 (autouse fixture)
from torch_tiny_model import jax_params, registered  # noqa: F401
from torch_zoo_cli import weights_files

N = 15  # fold 2 of 5: 3 test patches, one batch of 8
METRIC_ATOL = 1e-5
METRICS = ("jaccard_mean", "jaccard_std", "f1_mean", "f1_std", "n_images")


@pytest.fixture
def run_inputs(tmp_path, monkeypatch):
    """randInd15.txt in the working directory and a config writer."""
    monkeypatch.chdir(tmp_path)
    write_permutation(N, ".", seed=0)

    def config(modeltype, name="cfg.json"):
        (tmp_path / name).write_text(json.dumps(
            {"train_set_size": N, "fno": 2, "fsiz": 5, "modeltype": modeltype,
             "synthetic_seed": 0, "dtype": "float32"}))
        return str(tmp_path / name)

    return config


@pytest.fixture
def jax_tiny(monkeypatch):
    """The JAX twin of ``TinySeg5D`` in the JAX package's registry."""
    from test_resume import TinySeg5D as JaxTinySeg5D

    monkeypatch.setitem(jax_registry._REGISTRY, "TinySeg5D", jax_registry.ModelSpec(
        "TinySeg5D", JaxTinySeg5D, "5d", "test stand-in", True))


def _jax_run(run_dir, params, batch_stats, name="Finaliremmodel0"):
    from corrifnet_tpu.train import Checkpointer

    ck = Checkpointer(str(run_dir))
    try:
        ck.save(name, params, batch_stats)
    finally:
        ck.close()


def _tiny_weights(tmp_path, seed):
    sd = create_model("TinySeg5D", seed=seed).state_dict()
    torch.save(sd, tmp_path / f"tiny{seed}.pt")
    return sd, tmp_path / f"tiny{seed}.pt"


def _restored(run_dir, name="Finaliremmodel0"):
    return torch.load(os.path.join(run_dir, name), weights_only=True)


def _same_state_dict(got, want):
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k


def test_import_writes_what_load_weights_reads(tmp_path, capsys):
    """A reference ENet ``.pt`` (``num_batches_tracked`` beside every
    BatchNorm) and the JAX ``.npz`` of the same weights each become the
    port's ``state_dict`` in the run directory, bit for bit."""
    model, npz, pt = weights_files(tmp_path, "ENet", ti.enet_variables_from_state_dict)
    for source, name in ((pt, "Finaliremmodel0"), (npz, "Finaliremmodel1")):
        assert import_main(["ENet", str(source), str(tmp_path / "run"), "--name", name]) == 0
        written = _restored(tmp_path / "run", name)
        _same_state_dict(written, evaluate.load_weights(source, "ENet"))
        _same_state_dict(written, dict(model.state_dict()))
        create_model("ENet").load_state_dict(written, strict=True)
    assert "imported" in capsys.readouterr().out
    assert sorted(os.listdir(tmp_path / "run")) == ["Finaliremmodel0", "Finaliremmodel1"]


def _wrong_shapes(tmp_path):
    sd = dict(create_model("ENet", seed=1).state_dict())
    sd["initial_block.main_branch.weight"] = torch.zeros(2, 2)
    sd.pop("transposed_conv.weight")
    sd["extra.weight"] = torch.zeros(1)
    torch.save(sd, tmp_path / "bad.pt")
    return tmp_path / "bad.pt"


@pytest.mark.parametrize("case", ["unknown_model", "wrong_shapes", "another_model"])
def test_import_refusals_name_the_fault(tmp_path, case):
    if case == "unknown_model":
        pt = tmp_path / "any.pt"
        torch.save(dict(create_model("ENet").state_dict()), pt)
        with pytest.raises(KeyError, match=r"'NoSuchNet'.*available: \[.*'ENet'.*'MMVit4'"):
            import_main(["NoSuchNet", str(pt), str(tmp_path / "run")])
    elif case == "wrong_shapes":
        with pytest.raises(ValueError) as err:
            import_main(["ENet", str(_wrong_shapes(tmp_path)), str(tmp_path / "run")])
        text = str(err.value)
        assert "does not match ENet's state_dict" in text
        assert "missing: transposed_conv.weight" in text
        assert "unexpected: extra.weight" in text
        assert "shape-mismatch: initial_block.main_branch.weight (2, 2), want (" in text
    else:
        _, _, pt = weights_files(tmp_path, "ENet", ti.enet_variables_from_state_dict)
        with pytest.raises(ValueError, match="ENet weights, not UNetV2"):
            import_main(["UNetV2", str(pt), str(tmp_path / "run")])
    assert not (tmp_path / "run" / "Finaliremmodel0").exists()


def _decoded(path):
    return np.round(plt.imread(path) * 255).astype(np.int32)


def _hold_to_jax(port, jax):
    for key in METRICS:
        assert abs(port[key] - jax[key]) <= METRIC_ATOL, (key, port[key], jax[key])


def test_run_dir_evaluation_of_tiny_model_matches_jax(tmp_path, run_inputs, registered,  # noqa: F811
                                                      jax_tiny, capsys):
    from corrifnet_tpu.config import load_config as jax_load_config
    from corrifnet_tpu.run.evaluate import evaluate_run as jax_evaluate_run

    cfg = run_inputs("TinySeg5D")
    sd, pt = _tiny_weights(tmp_path, 3)
    _jax_run(tmp_path / "jax_run", jax_params(sd), {})
    import_main(["TinySeg5D", str(pt), str(tmp_path / "port_run")])
    want = jax_evaluate_run(str(tmp_path / "jax_run"), jax_load_config(cfg),
                            segplot_dir=str(tmp_path / "jax_png"))
    got = evaluate.main(["--config", cfg, "--run-dir", str(tmp_path / "port_run"),
                         "--segplot-dir", str(tmp_path / "port_png"), "--device", "cpu"])
    assert list(got) == ["run"] and got["run"]["n_images"] == 3
    _hold_to_jax(got["run"], want)
    r = got["run"]
    assert (f"run: jaccard {r['jaccard_mean']:.5f}±{r['jaccard_std']:.5f} "
            f"f1 {r['f1_mean']:.5f}±{r['f1_std']:.5f} (n=3)") in capsys.readouterr().out
    names = sorted(os.listdir(tmp_path / "jax_png"))
    assert len(names) == 6 and sorted(os.listdir(tmp_path / "port_png")) == names
    for name in names:
        a, b = _decoded(tmp_path / "port_png" / name), _decoded(tmp_path / "jax_png" / name)
        assert a.shape == b.shape == (224, 224, 4)
        assert np.abs(a - b).max() <= 1, name


def test_run_dir_evaluation_of_enet_matches_jax(tmp_path, run_inputs):
    """The 4-D path: modality 0, as JAX evaluates it, and no PNGs."""
    from corrifnet_tpu.config import load_config as jax_load_config
    from corrifnet_tpu.run.evaluate import evaluate_run as jax_evaluate_run

    cfg = run_inputs("ENet")
    model, _, pt = weights_files(tmp_path, "ENet", ti.enet_variables_from_state_dict)
    variables = ti.enet_variables_from_state_dict(dict(model.state_dict()))
    _jax_run(tmp_path / "jax_run", variables["params"], variables["batch_stats"])
    import_main(["ENet", str(pt), str(tmp_path / "port_run")])
    want = jax_evaluate_run(str(tmp_path / "jax_run"), jax_load_config(cfg),
                            segplot_dir=str(tmp_path / "jax_png"))
    got = evaluate.main(["--config", cfg, "--run-dir", str(tmp_path / "port_run"),
                         "--segplot-dir", str(tmp_path / "port_png"), "--device", "cpu"])
    _hold_to_jax(got["run"], want)
    assert not (tmp_path / "jax_png").exists() and not (tmp_path / "port_png").exists()


def test_manifest_and_index_pick_runs(tmp_path, run_inputs, registered, capsys):  # noqa: F811
    """Two runs by a manifest, and ``--index 1``, each equal to the
    ``--weights`` evaluation of its file."""
    cfg = run_inputs("TinySeg5D")
    _, pt0 = _tiny_weights(tmp_path, 0)
    _, pt1 = _tiny_weights(tmp_path, 1)
    import_main(["TinySeg5D", str(pt0), str(tmp_path / "a")])
    import_main(["TinySeg5D", str(pt1), str(tmp_path / "a"), "--name", "Finaliremmodel1"])
    import_main(["TinySeg5D", str(pt1), str(tmp_path / "b")])
    (tmp_path / "runs.txt").write_text(f"first\n{tmp_path / 'a'}\n\nsecond\n{tmp_path / 'b'}\n")
    single = [evaluate.main(["--config", cfg, "--weights", str(pt), "--device", "cpu"])
              for pt in (pt0, pt1)]
    assert single[0]["jaccard_mean"] != single[1]["jaccard_mean"]
    runs = evaluate.main(["--config", cfg, "--manifest", str(tmp_path / "runs.txt"),
                          "--device", "cpu"])
    by_index = evaluate.main(["--config", cfg, "--run-dir", str(tmp_path / "a"), "--index", "1",
                              "--device", "cpu"])
    assert list(runs) == ["first", "second"]
    for got, want in ((runs["first"], single[0]), (runs["second"], single[1]),
                      (by_index["run"], single[1])):
        assert {k: got[k] for k in METRICS} == {k: want[k] for k in METRICS}
    out = capsys.readouterr().out
    assert out.count("first: jaccard ") == 1 and out.count("second: jaccard ") == 1


def test_orbax_run_is_refused_naming_the_export_script(tmp_path, run_inputs, registered):  # noqa: F811
    cfg = run_inputs("TinySeg5D")
    sd, _ = _tiny_weights(tmp_path, 0)
    _jax_run(tmp_path / "jax_run", jax_params(sd), {})
    with pytest.raises(ValueError, match="orbax checkpoint.*scripts/export_jax_checkpoint.py"):
        evaluate.main(["--config", cfg, "--run-dir", str(tmp_path / "jax_run"),
                       "--device", "cpu"])
    with pytest.raises(FileNotFoundError, match="no checkpoint Finaliremmodel2"):
        evaluate.main(["--config", cfg, "--run-dir", str(tmp_path / "jax_run"), "--index", "2",
                       "--device", "cpu"])


@pytest.mark.parametrize("flags,message", [
    (["--weights", "w.pt", "--run-dir", "run"], "--weights cannot be given with"),
    (["--weights", "w.pt", "--manifest", "runs.txt"], "--weights cannot be given with"),
    (["--run-dir", "run", "--manifest", "runs.txt"], "not both"),
    (["--segplot-dir", "png"], "need --run-dir or --manifest"),
    (["--index", "1"], "need --run-dir or --manifest"),
])
def test_conflicting_flags_are_refused(tmp_path, capsys, flags, message):
    with pytest.raises(SystemExit) as err:
        evaluate.main(["--config", str(tmp_path / "absent.json"), *flags, "--device", "cpu"])
    assert err.value.code == 2 and message in capsys.readouterr().err
