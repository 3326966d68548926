"""Annotated trace spans: name the dispatch, not the kernel.

Each controller-level operation (dispatch issue and resolve, checkpoint
fetch, cycle probe, park) is wrapped in a ``torch.profiler.record_function``
range named ``gol.<operation>`` with its labels (turn, superstep, tier), so
a ``torch.profiler`` capture reads "gol.resolve turn=4096 k=512" above the
kernels that dispatch launched.  The same call sites feed the
request-scoped host span store (``obs.tracing``) whenever a trace is
active on the calling context.  With no profiler running the range is
near free, and with no active trace the host half is the shared
``nullcontext``.
"""

from __future__ import annotations

import torch

from distributed_gol_torch.obs import tracing


class _Pair:
    """Enter/exit two context managers as one (profiler range + host
    span)."""

    __slots__ = ("_a", "_b")

    def __init__(self, a, b):
        self._a = a
        self._b = b

    def __enter__(self):
        self._a.__enter__()
        self._b.__enter__()
        return self

    def __exit__(self, *exc):
        try:
            self._b.__exit__(*exc)
        finally:
            self._a.__exit__(*exc)
        return False


def _range_name(name: str, labels: dict) -> str:
    if not labels:
        return name
    return name + " " + " ".join(f"{k}={v}" for k, v in labels.items())


def span(name: str, **labels):
    """A profiler range for one host-side operation; ``labels`` ride in the
    range name and, when a request trace is active, as host-span labels."""
    dev = torch.profiler.record_function(_range_name(name, labels))
    host = tracing.span(name, **labels)
    if host is tracing.NULL_CM:
        return dev
    return _Pair(dev, host)


def step_span(name: str, step: int, **labels):
    """Like :func:`span`, with the dispatch's step number as a label."""
    return span(name, step=step, **labels)
