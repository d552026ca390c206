"""Checkpoint manager: retention, auto-resume, step bookkeeping.

Counterpart of ``repro.checkpointing.manager``, with the same directory
names (``step_00000100``), so either package resumes from the other's.
"""
from __future__ import annotations

import os
import re
import shutil

from . import checkpoint

_STEP_RE = re.compile(r"^step_(\d+)$")


class CheckpointManager:
    def __init__(self, directory: str, *, keep: int = 3,
                 async_save: bool = True):
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._saver = checkpoint.AsyncSaver() if async_save else None

    # -- discovery ----------------------------------------------------------
    def steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.directory):
            m = _STEP_RE.match(name)
            if m and os.path.exists(
                    os.path.join(self.directory, name, "manifest.json")):
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> int | None:
        s = self.steps()
        return s[-1] if s else None

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:08d}")

    # -- save/restore -------------------------------------------------------
    def save(self, step: int, tree):
        path = self._path(step)
        if self._saver is not None:
            self._saver.submit(tree, path)
        else:
            checkpoint.save(tree, path)
        self._gc(step)

    def restore(self, tree_like, step: int | None = None):
        self.wait()
        step = self.latest_step() if step is None else step
        if step is None:
            return None, None
        return checkpoint.restore(tree_like, self._path(step)), step

    def wait(self):
        if self._saver is not None:
            self._saver.wait()

    def _gc(self, newest: int):
        for s in self.steps()[:-self.keep]:
            if s != newest:
                shutil.rmtree(self._path(s), ignore_errors=True)
