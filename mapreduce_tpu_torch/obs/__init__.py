"""Observability of the port, the JAX package's planes: phase spans on the
profiler timeline (:mod:`.spans`), the metrics registry (:mod:`.registry`),
the JSONL run ledger (:mod:`.ledger`), the flight recorder
(:mod:`.flight`), the ``Telemetry`` handle over them (:mod:`.telemetry`)
and the timeline reconstructed from a ledger (:mod:`.timeline`)."""
