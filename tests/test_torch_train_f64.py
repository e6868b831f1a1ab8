"""The whole MMVit4 train step of the port against the JAX package in
float64, on the CPU.

``tests/torch_step_f64.py`` runs both sides in a process of its own (it
switches JAX to x64 and both libraries' f32 casts to f64); this file holds
its measurements to their bounds. It is a file of its own, apart from
``test_torch_train.py``, because the subprocess takes about 3 minutes: a
test run that gives each file to one worker then runs the two side by side.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
from torch_threads import THREADS, torch_threads  # noqa: F401 (autouse fixture)


@pytest.fixture(scope="module")
def f64_step():
    """What ``tests/torch_step_f64.py`` measures: the same two train steps in
    float64 on both sides, in a process of its own (it switches JAX to x64
    and both libraries' f32 casts to f64). About 3 minutes and 15 GiB."""
    script = Path(__file__).with_name("torch_step_f64.py")
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "OMP_NUM_THREADS": str(THREADS),
           "PYTHONPATH": os.pathsep.join(
               [str(script.parent.parent), os.environ.get("PYTHONPATH", "")])}
    res = subprocess.run([sys.executable, str(script)], capture_output=True,
                         text=True, env=env, timeout=1200, check=False)
    assert res.returncode == 0, res.stderr[-4000:]
    measured = json.loads(res.stdout.strip().splitlines()[-1])["B=1"]
    print("train step against JAX in f64:", measured)
    return measured


@pytest.mark.parametrize("what,bound", [
    ("loss_diff_1", 1e-12), ("loss_diff_2", 1e-10), ("grad_rel_worst", 1e-8),
    ("grad_abs_where_jax_is_zero", 0.0), ("param_rel_worst", 1e-6),
    ("move_rel_worst", 1e-4), ("stats_rel_worst", 1e-8)])
def test_train_step_matches_jax_in_f64(f64_step, what, bound):
    """The whole MMVit4 train step of test_train_step_matches_jax at B=1
    (64x64, dropout 0, BatchNorm on batch statistics, two Adam steps), with
    both sides computing in float64, where the network's amplification of
    rounding leaves nothing to hide a wrong term of a backward:

    * first and second loss within 1e-12 and 1e-10 (measured 4e-16, 3e-14);
    * every one of the 645 gradient tensors within 1e-8 of JAX's largest
      entry of that tensor (measured 5e-12), and exactly 0 where JAX's
      tensor is 0;
    * every parameter tensor after two Adam steps within 1e-6 of its largest
      entry (measured 3e-8), and every entry within 1e-4 of the largest
      move two steps can make, 2 lr (measured 7e-7: Adam divides by
      sqrt(v) + 1e-8, which magnifies differences of entries near 1e-8);
    * every BatchNorm running mean and variance within 1e-8 of its tensor's
      largest entry (measured 1e-11)."""
    assert f64_step["grad_tensors"] == 645
    assert 0.5 <= f64_step["loss_1"] <= 1.0
    assert f64_step[what] <= bound, f64_step
