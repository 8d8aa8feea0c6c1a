"""Reduce a `torch.profiler` trace of the window to what the per-layer
metrics and the result's `breakdown` read.

The harness marks every prove with a `bench.prove` span; the traced
window runs from the first span's start to the last span's end.  Device
activities (kernels, copies, sets) are clipped to the window; their union
is the time the card was busy (the port runs on one stream, so they do not
overlap, but the union does not count on it).  Each prove's stages are laid
out from its span's start by the seconds its `timings` dict received, in
the order the program wrote them, so an idle gap can be put down to the
stage it fell in and to the innermost host operation then open.
"""

from __future__ import annotations

from dataclasses import dataclass, field

PROVE_SPAN = "bench.prove"

#: device activity kinds, by a substring of the name (first match); what
#: matches none is a torch elementwise kernel (frozen copy of the port's
#: profile_prove.KINDS)
KINDS = (("k1", "poseidon2_"), ("copy", "Memcpy"), ("copy", "Memset"),
         ("int8_gemm", "gemm"), ("gather_scatter", "index"),
         ("cat", "CatArray"), ("reduce", "reduce_kernel"))

#: the kernels of K1's three entry points (csrc/poseidon2.cu)
K1_KERNELS = ("poseidon2_permute_kernel", "poseidon2_hash_rows_kernel",
              "poseidon2_merkle_kernel")


def kind(name: str) -> str:
    return next((k for k, sub in KINDS if sub in name), "elementwise")


def _ns(e, what: str) -> int:
    f = getattr(e, f"{what}_ns", None)
    return int(f()) if f is not None else int(getattr(e, f"{what}_us")() * 1e3)


@dataclass
class Trace:
    """The window's device activities and host operations, in ns of the
    profiler's clock."""

    device: list = field(default_factory=list)   # (start, end, name)
    host: list = field(default_factory=list)     # (start, end, name)
    proves: list = field(default_factory=list)   # (start, end)
    timings: list = field(default_factory=list)  # one dict per prove

    @classmethod
    def from_profile(cls, prof, timings: list) -> "Trace":
        import torch

        cuda = torch.autograd.DeviceType.CUDA
        t = cls(timings=list(timings))
        for e in prof.profiler.kineto_results.events():
            start = _ns(e, "start")
            end = start + _ns(e, "duration")
            name = e.name()
            if name.startswith("bench."):
                # the span, and its copy on the device's timeline
                if e.device_type() != cuda and name == PROVE_SPAN:
                    t.proves.append((start, end))
            elif e.device_type() == cuda:
                t.device.append((start, end, name))
            else:
                t.host.append((start, end, name))
        t.proves.sort()
        if t.proves:
            lo, hi = t.proves[0][0], t.proves[-1][1]
            t.device = sorted((max(s, lo), min(e, hi), n)
                              for s, e, n in t.device if e > lo and s < hi)
        return t

    @property
    def window_ns(self) -> int:
        return self.proves[-1][1] - self.proves[0][0] if self.proves else 0

    def merged(self) -> list[tuple[int, int]]:
        out: list[list[int]] = []
        for s, e, _ in self.device:
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return [(s, e) for s, e in out]

    def busy_ns(self) -> int:
        return sum(e - s for s, e in self.merged())

    def device_ns(self, keep) -> int:
        """Summed device time of the activities whose name `keep` takes."""
        return sum(e - s for s, e, n in self.device if keep(n))

    def top_ops(self, k: int = 10) -> list:
        by: dict[str, int] = {}
        for s, e, n in self.device:
            by[n] = by.get(n, 0) + e - s
        top = sorted(by.items(), key=lambda kv: -kv[1])[:k]
        return [[n[:120], ns / 1e9] for n, ns in top]

    def stage_at(self, t: int) -> str:
        """The stage of the prove running at t, by its timings."""
        for (s, e), tim in zip(self.proves, self.timings):
            if s <= t < e:
                at = s
                for name, sec in tim.items():
                    at += int(sec * 1e9)
                    if t < at:
                        return name
                return "after_stages"
        return "between_proves"

    def host_at(self, t: int) -> str:
        """The innermost host operation open at t ("python" if none)."""
        best = None
        for s, e, n in self.host:
            if s <= t < e and (best is None or s > best[0]):
                best = (s, n)
        return best[1] if best else "python"

    def idle_gaps(self, k: int = 10) -> list:
        """The k longest stretches of the window with no device activity,
        each named by its stage and the host operation open in its
        middle."""
        if not self.proves:
            return []
        lo, hi = self.proves[0][0], self.proves[-1][1]
        gaps, at = [], lo
        for s, e in self.merged():
            if s > at:
                gaps.append((s - at, at))
            at = max(at, e)
        if hi > at:
            gaps.append((hi - at, at))
        gaps.sort(reverse=True)
        out = []
        for length, start in gaps[:k]:
            mid = start + length // 2
            out.append([f"{self.stage_at(mid)}/{self.host_at(mid)}"[:120],
                        length / 1e9])
        return out
