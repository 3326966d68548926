"""Run telemetry: the metrics registry (``metrics``), profiler ranges and
host spans around every dispatch (``spans``, ``tracing``), and the crash
flight recorder (``flight``).  Everything degrades to a no-op:
``Params.metrics=False`` swaps in null instruments and
``Params.flight_recorder_depth=0`` disables the ring."""
