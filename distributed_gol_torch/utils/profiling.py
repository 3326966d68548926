"""Tracing/profiling hooks — the port's analog of the reference's trace harness.

Counterpart of ``distributed_gol_tpu/utils/profiling.py``.  The reference
wraps a run in Go's ``runtime/trace`` producing ``trace.out`` for ``go
tool trace`` (``trace_test.go:12-29``).  The port's equivalent is
``torch.profiler``: a trace captures the host's operator timeline and,
on the card, every kernel launch and copy (CUPTI), with the controller's
``gol.*`` ranges (``obs/spans.py``) above them, written as a Chrome trace
(``trace.json``) that Perfetto or ``chrome://tracing`` opens.

Usage::

    from distributed_gol_torch.utils.profiling import trace
    with trace("/tmp/gol-trace"):
        gol.run(params, events)
    # open /tmp/gol-trace/trace.json in Perfetto

or from the CLI: ``python -m distributed_gol_torch --trace /tmp/gol-trace``.

Degrades to a no-op (with a warning) when the build has no profiler, so
tracing never takes a run down.
"""

from __future__ import annotations

import contextlib
import warnings
from pathlib import Path

#: The file a trace writes into its directory.
TRACE_FILE = "trace.json"

_UNRESOLVED = object()
_PROFILER = _UNRESOLVED  # the torch.profiler module, or None


def profiler():
    """The one resolution/caching home for ``torch.profiler``: returns
    the module, or None on a build without it — resolved once, cached,
    zero per-call import cost afterwards.  :func:`trace` degrades through
    this single seam, so profiler-less behaviour has one tested path."""
    global _PROFILER
    if _PROFILER is _UNRESOLVED:
        try:
            import torch.profiler

            _PROFILER = torch.profiler
        except Exception:  # a stripped build: every consumer degrades
            _PROFILER = None
    return _PROFILER


def _reset_profiler_cache() -> None:
    """Testing hook: force the next :func:`profiler` call to re-resolve."""
    global _PROFILER
    _PROFILER = _UNRESOLVED


@contextlib.contextmanager
def trace(log_dir: str | Path):
    """Context manager writing a ``torch.profiler`` trace of the body to
    ``log_dir/trace.json`` (host operators, and the card's kernels and
    copies where there is a CUDA GPU)."""
    try:
        mod = profiler()
        if mod is None:
            raise RuntimeError("no torch.profiler in this build")
        import torch

        activities = [mod.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(mod.ProfilerActivity.CUDA)
        prof = mod.profile(activities=activities)
    except Exception as e:  # a stripped build or an unsupported backend
        # A scoped warning, not a bare stderr print: under pytest an
        # uncaptured project warning fails loudly, while library users can
        # filter it like any other warning.
        warnings.warn(
            f"profiler unavailable ({e}); run continues untraced",
            RuntimeWarning,
            stacklevel=3,
        )
        yield
        return
    with prof:
        yield
    Path(log_dir).mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(Path(log_dir) / TRACE_FILE))


def has_trace_output(log_dir: str | Path) -> bool:
    """Whether ``log_dir`` contains the port's profiler output (for
    tests/tooling)."""
    root = Path(log_dir)
    return root.is_dir() and any(root.rglob(TRACE_FILE))
