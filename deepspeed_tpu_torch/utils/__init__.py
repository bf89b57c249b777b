"""Process-wide utilities (telemetry counters, the comms logger, the
fragment accessors of partitioned state)."""
