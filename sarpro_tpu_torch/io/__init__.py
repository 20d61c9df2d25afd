"""Host I/O glue of the port: SAFE loading onto the device, the warp's host
plan and decimated read, and the JPEG writer."""
