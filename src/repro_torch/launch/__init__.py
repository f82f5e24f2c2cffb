"""Launch-side modules of the port: the serving frontend and telemetry."""
