"""Process-wide utilities (telemetry counters)."""
