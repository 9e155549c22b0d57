"""Host utilities of the port: its own copies of what it uses from
longreadmapper_tpu/utils (config, log, rng)."""
