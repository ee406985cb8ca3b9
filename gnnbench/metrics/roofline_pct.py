"""The least time of one forward or step (``work/<family>.py``'s ops, each
at the larger of its FLOPs over the peak and its bytes over the memory's
peak) over the device's busy time per forward or step, in percent.  The
count depends on the inputs' sizes alone, so it reads the same work
whatever implements it; above 100 it is a counting error and raises."""


def read(record):
    t = record["trace"]
    if not t or t["busy_s"] <= 0:
        return None
    share = 100.0 * record["work"]["least_s"] / (t["busy_s"] / t["units"])
    if share > 100.0:
        raise ValueError(f"roofline share {share} > 100%: the work is "
                         "counted too high or the busy time misses work")
    return share
