"""The port's GUI (port of sarpro_tpu/gui), `sarpro-gui-torch` — web
equivalent of the reference's egui desktop app (reference: src/gui/,
src/bin/gui.rs), with its jobs on the card.

The reference ships a native eframe/egui window; a GPU host is typically a
headless VM, so the equivalent surface here is a self-contained local web UI
(stdlib http.server, zero extra dependencies): same state model, controls
for every processing enum, single/batch modes, a background processing
thread with completion signalling, a live log panel with level filtering and
.sarpolog export, preset save/load in the reference's commented-JSON
.sarpro format, a CLI command generator, and host CPU/RAM footer stats.
"""
from .server import main, make_server  # noqa: F401
