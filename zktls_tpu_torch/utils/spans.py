"""Named host spans on the torch profiler's clock, and the stage clock of a
prove.

`span(name)` opens a profiler range while `torch.profiler` records and
costs one check of the profiler's state otherwise.  The range is a
`RecordScope::FUNCTION` one (`_RecordFunctionFast`), which the profiler
keeps on the host's timeline only: `torch.profiler.record_function` opens a
user-scope range, which Kineto also copies onto the device's timeline over
the kernels launched inside it, where it would count as device activity.

`Stages` is the stage clock of the provers' `timings=` dicts, used as a
`with` block: each stage adds its seconds to the dict (every CUDA device
given synchronised first, and only when there is a dict) and runs inside
its own span, `zktls.stage:<label>`, so a prove's stage spans follow one
another without overlap, and none outlives its block.

Every span name starts with `zktls.`; spans nest strictly (the last opened
is the first closed).  The names, and the benchmark metric that reads
each, are listed in PERF.md §3.
"""

from __future__ import annotations

import contextlib
import time

import torch
from torch.autograd import profiler as _profiler

__all__ = ["span", "Stages"]


def _open(name: str):
    """An entered profiler range named `name`, or None when the profiler
    is off."""
    if not _profiler._is_profiler_enabled:
        return None
    rf = torch._C._profiler._RecordFunctionFast(name)
    rf.__enter__()
    return rf


_NULL = contextlib.nullcontext()


def span(name: str):
    """`with span("zktls.<what>"):` — a host range on the profiler's
    timeline while it records, nothing but one check otherwise."""
    if _profiler._is_profiler_enabled:
        return torch._C._profiler._RecordFunctionFast(name)
    return _NULL


class Stages:
    """One prove's stages, in order: `with Stages(timings, "first") as
    stages:` starts the first, `stages.next("label")` ends the running
    stage and starts the next one, and leaving the block ends the last.

    Ending a stage adds its seconds to `timings[<its label>]` (after
    synchronising every CUDA device in `devices`) when `timings` is a
    dict, and closes its span; with no dict and the profiler off it does
    nothing beyond one check.  A stage left by an exception only closes
    its span: it adds no seconds, and no device is synchronised."""

    def __init__(self, timings: dict | None, first: str, devices=()):
        self.timings = timings
        self.devices = [d for d in devices if d.type == "cuda"]
        self._label = first
        self._t = time.perf_counter() if timings is not None else 0.0
        self._rf = _open(f"zktls.stage:{first}")

    def _close(self, timed: bool) -> None:
        if timed and self.timings is not None:
            for d in self.devices:
                torch.cuda.synchronize(d)
            now = time.perf_counter()
            self.timings[self._label] = (
                self.timings.get(self._label, 0.0) + now - self._t)
            self._t = now
        if self._rf is not None:
            self._rf.__exit__(None, None, None)
            self._rf = None

    def next(self, label: str) -> None:
        """End the running stage and start `label`."""
        self._close(True)
        self._label = label
        self._rf = _open(f"zktls.stage:{label}")

    def __enter__(self) -> "Stages":
        return self

    def __exit__(self, exc_type, *_) -> None:
        self._close(exc_type is None)
