"""The whole forward's or step's share of the chip's peak: the FLOPs of
``work/<family>.py`` over the wall time per forward or step of the
untraced window, over the peak of the configuration's dtype, in
percent.  Above 100 it is a counting error and raises."""


def read(record):
    if record["units"] <= 0:
        return None
    w = record["work"]
    share = 100.0 * w["flops"] / (record["wall_s"] / record["units"]) \
        / w["peak_flops"]
    if share > 100.0:
        raise ValueError(f"mfu {share} > 100%: the FLOPs are counted too "
                         "high or the window misses work")
    return share
