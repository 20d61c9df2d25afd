"""Host I/O glue of the port: SAFE loading onto the device and the JPEG writer."""
