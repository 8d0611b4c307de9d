"""Bench-side modules of the port (the counterpart of the repo's ``benches/``)."""
