"""Run telemetry: the metrics registry (``metrics``), profiler ranges and
host spans around every dispatch (``spans``, ``tracing``), and the crash
flight recorder (``flight``).  Everything degrades to a no-op:
``Params.metrics=False`` swaps in null instruments and
``Params.flight_recorder_depth=0`` disables the ring.

Above the process: the fleet collector (``fleet``: ``FleetCollector``,
``CollectorServer``, ``node_name``), which scrapes many pods, brokers and
relays.  Its names load on first use, since ``fleet`` reaches the serving
tier, which imports the engine, which imports this package."""

_FLEET_NAMES = ("FLEET_FLIGHT_SCHEMA", "FLEET_SLO_SCHEMA", "CollectorServer",
                "FleetCollector", "node_name")


def __getattr__(name):
    if name in _FLEET_NAMES:
        from distributed_gol_torch.obs import fleet

        return getattr(fleet, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
