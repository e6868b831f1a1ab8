"""MMVit4's config levers at the port's two entry points, on the CPU.

``depth_mode``, ``fuse_expand_bn``, ``decoder_remat`` and ``decoder_chunk``
are honoured by the port as by the JAX package's entry points
(``corrifnet_tpu/run/main.py:48-67``, ``corrifnet_tpu/run/evaluate.py:98``):
``run.main`` passes each to ``models.create_model`` (which names on one line
an option the model does not take), and ``run.evaluate`` builds the model
without them, as JAX's ``evaluate_run`` does, printing one line that says
so. ``check_entry_points_take`` holds both entry points to that for one
model and one field, stopping each run where it builds the model.
"""

from __future__ import annotations

import json

import pytest

# a value off the default for each lever
LEVERS = {"depth_mode": "pruned", "fuse_expand_bn": True, "decoder_chunk": 2,
          "decoder_remat": True}


class Built(Exception):
    """Raised in place of building the model: (name, keyword arguments)."""


def check_entry_points_take(modeltype, field, value, tmp_path, monkeypatch, capsys,
                            entries=("main", "evaluate")):
    from corrifnet_tpu_torch import data
    from corrifnet_tpu_torch.run import evaluate, main

    def create(name, **kwargs):
        raise Built(name, kwargs)

    monkeypatch.setattr(main, "create_model", create)
    monkeypatch.setattr(evaluate, "create_model", create)
    monkeypatch.chdir(tmp_path)
    data.write_permutation(15, ".", seed=0)
    (tmp_path / "cfg.json").write_text(json.dumps(
        {"train_set_size": 15, "synthetic_seed": 0, "modeltype": modeltype, field: value}))
    capsys.readouterr()
    if "main" in entries:
        with pytest.raises(Built) as built:
            main.main(["--config", "cfg.json", "--device", "cpu"])
        assert built.value.args[0] == modeltype and built.value.args[1][field] == value
    if "evaluate" in entries:
        with pytest.raises(Built) as built:
            evaluate.main(["--config", "cfg.json", "--device", "cpu"])
        assert built.value.args[0] == modeltype and field not in built.value.args[1]
        assert f"{field}={value!r} not used by run.evaluate" in capsys.readouterr().out
