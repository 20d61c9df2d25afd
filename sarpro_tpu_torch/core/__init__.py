"""Device programs of the port (port of sarpro_tpu/core)."""
