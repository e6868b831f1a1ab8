"""Run log files (reference: F2_MAIN.py:179-203, F4_TRAIN.py:48-81,205-208).

Counterpart of ``corrifnet_tpu/utils/logfiles.py``. The reference writes
seven text files per run with one float per line per epoch (train, val and
test loss and accuracy, and the epoch index) plus a verbose ``lrFile``. The
formats are kept line-compatible, so curve plotting and log parsing work on
either package's output. Reopening the logs of an interrupted run comes with
resume (see ROADMAP.md).
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import TextIO

__all__ = ["RunLogs"]


@dataclasses.dataclass
class RunLogs:
    """The per-run log files, opened in the run directory."""

    lr: TextIO
    train: TextIO
    trainacc: TextIO
    trainepoch: TextIO
    val: TextIO
    valacc: TextIO
    test: TextIO
    testacc: TextIO

    @classmethod
    def open(cls, run_dir) -> "RunLogs":
        d = Path(run_dir)
        d.mkdir(parents=True, exist_ok=True)
        return cls(
            lr=open(d / "lrFile.txt", "w"),
            train=open(d / "trainFile.txt", "w"),
            trainacc=open(d / "trainaccFile.txt", "w"),
            trainepoch=open(d / "trainepochFile.txt", "w"),
            val=open(d / "valFile.txt", "w"),
            valacc=open(d / "valaccFile.txt", "w"),
            test=open(d / "testFile.txt", "w"),
            testacc=open(d / "testaccFile.txt", "w"),
        )

    def flush(self):
        for f in self._files():
            f.flush()

    def close(self):
        for f in self._files():
            f.close()

    def _files(self):
        return (
            self.lr, self.train, self.trainacc, self.trainepoch,
            self.val, self.valacc, self.test, self.testacc,
        )
