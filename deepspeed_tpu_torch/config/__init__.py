"""Configuration (the ds_config schema the port runs)."""
