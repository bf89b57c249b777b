"""Experiment monitoring backends (``monitor.MonitorMaster``)."""
