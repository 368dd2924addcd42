"""The median host time to issue one request of the replay memory's cell
(host clock around the cell driver's call, in the traced window): the
sharded draw's per-shard Python loop and whatever blocks it."""

import statistics


def read(obs):
    if obs.trace is None or not obs.host_issue_s:
        return None
    return 1e3 * statistics.median(obs.host_issue_s)
