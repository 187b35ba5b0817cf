"""Scripts of the port: evaluation, log playback and procedural data."""
