"""The 95th percentile of the per-call latencies of the run's measured
window (each ``__call__`` timed on the host from submission until its
pose, scale and latent are on the host), over all calls."""
import statistics


def read(sl):
    lat = sl.window_ms
    if len(lat) < 20:
        return None
    return statistics.quantiles(lat, n=100)[94]
