"""Per-call execution statistics.

reference: ExecutionSummary + ScopedExecutionTimer (execution_summary.h:89),
which accumulate cumulative call counts and seconds per call-site name
("Evaluator::Residual", "Evaluator::Jacobian", "LinearSolver::Solve") and
surface them through Evaluator::Statistics() into Summary::FullReport.
An entry may also count bytes: what a host factorization brought over
from the card (SPARSE_NORMAL_CHOLESKY, SPARSE_SCHUR, SUBSET).
"""

from __future__ import annotations

import time
from contextlib import contextmanager


class ExecutionSummary:
    """Cumulative (calls, seconds, bytes) per call-site name."""

    def __init__(self):
        self._stats = {}  # name -> [calls, seconds, bytes]

    def record(self, name: str, seconds: float, calls: int = 1, nbytes: int = 0) -> None:
        ent = self._stats.setdefault(name, [0, 0.0, 0])
        ent[0] += calls
        ent[1] += seconds
        ent[2] += nbytes

    @contextmanager
    def scoped(self, name: str):
        """Times the with-block and records one call. Put the device sync
        (a scalar fetch) inside the block for honest timings."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.record(name, time.perf_counter() - t0)

    def calls(self, name: str) -> int:
        return self._stats.get(name, [0, 0.0, 0])[0]

    def seconds(self, name: str) -> float:
        return self._stats.get(name, [0, 0.0, 0])[1]

    def nbytes(self, name: str) -> int:
        return self._stats.get(name, [0, 0.0, 0])[2]

    def names(self):
        return sorted(self._stats)

    def report_lines(self):
        """Formatted block for Summary.full_report()."""
        if not self._stats:
            return []
        lines = [
            "Per-call statistics          calls      total s      mean ms        bytes",
        ]
        for name in self.names():
            calls, secs, nbytes = self._stats[name]
            mean_ms = secs / calls * 1000.0 if calls else 0.0
            lines.append(
                f"  {name:<26s}{calls:>6d} {secs:>12.6f} {mean_ms:>12.3f} {nbytes:>12d}"
            )
        return lines


class NullExecutionSummary:
    """Records nothing: the sink of a minimizer run outside `solve`, and of a
    step function before a solve points it at its summary."""

    def record(self, name, seconds, calls=1, nbytes=0):
        pass
