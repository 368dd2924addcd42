"""The 95th percentile of every request's time in the window: a request
(draw, priority write-back, inserts) timed by CUDA events recorded on
the stream just before and just after it."""

import statistics


def read(obs):
    lat = obs.latencies_ms
    if not lat:
        return None
    if len(lat) == 1:
        return lat[0]
    return statistics.quantiles(lat, n=20, method="inclusive")[18]
