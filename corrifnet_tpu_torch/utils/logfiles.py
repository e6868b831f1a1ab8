"""Run log files (reference: F2_MAIN.py:179-203, F4_TRAIN.py:48-81,205-208).

Counterpart of ``corrifnet_tpu/utils/logfiles.py``. The reference writes
seven text files per run with one float per line per epoch (train, val and
test loss and accuracy, and the epoch index) plus a verbose ``lrFile``. The
formats are kept line-compatible, so curve plotting and log parsing work on
either package's output. ``open_resumed`` reopens the logs of an interrupted
run for ``run.main --resume``.
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
    def open(cls, run_dir, append: bool = False) -> "RunLogs":
        d = Path(run_dir)
        d.mkdir(parents=True, exist_ok=True)
        mode = "a" if append else "w"
        return cls(
            lr=open(d / "lrFile.txt", mode),
            train=open(d / "trainFile.txt", mode),
            trainacc=open(d / "trainaccFile.txt", mode),
            trainepoch=open(d / "trainepochFile.txt", mode),
            val=open(d / "valFile.txt", mode),
            valacc=open(d / "valaccFile.txt", mode),
            test=open(d / "testFile.txt", mode),
            testacc=open(d / "testaccFile.txt", mode),
        )

    @classmethod
    def open_resumed(cls, run_dir, completed_epochs: int) -> "RunLogs":
        """Reopen a run's log files to continue after ``completed_epochs``.

        An interrupted process may have written part of an epoch past the
        last ``state{i}`` checkpoint (the train lines come before it, the
        validation lines after), so every per-epoch file is cut back to
        ``completed_epochs`` entries and the resumed run appends to it. The
        one-line-per-epoch files are cut by line count, ``lrFile.txt`` at
        the header of epoch ``completed_epochs``; the test files are
        emptied (the test runs after training)."""
        d = Path(run_dir)
        for name in ("trainFile.txt", "trainaccFile.txt",
                     "trainepochFile.txt", "valFile.txt", "valaccFile.txt"):
            p = d / name
            lines = p.read_text().splitlines(keepends=True) if p.exists() else []
            p.write_text("".join(lines[:completed_epochs]))
        lr = d / "lrFile.txt"
        if lr.exists():
            kept, marker = [], f"Epoch: {completed_epochs} LR:"
            for ln in lr.read_text().splitlines(keepends=True):
                if ln.startswith(marker):
                    break
                kept.append(ln)
            lr.write_text("".join(kept))
        for name in ("testFile.txt", "testaccFile.txt"):
            (d / name).write_text("")
        return cls.open(d, append=True)

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
