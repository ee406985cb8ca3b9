"""K17's share of its roofline: the least time of the ``attn{i}`` ops of
``work/gatv2.py`` (each at the larger of its FLOPs over the peak and its
bytes over the memory's peak) over K17's device time per forward
(``gatv2_ms``), in percent.  ``run.py`` hands readers only the totals of
the work, so the op list is ``work/gatv2.py``'s of its last count, used
only where its totals are the record's; None otherwise, or where the
trace holds no K17.  Above 100 it is a counting error and raises."""

from gnnbench import peaks, spec
from gnnbench.work import gatv2, totals


def read(record):
    ms = spec.reader("gatv2_ms")(record)
    ops = gatv2.LAST_FORWARD_OPS
    if ms is None or not ops:
        return None
    work = record["work"]
    if totals(ops) != {"flops": work["flops"], "bytes": work["bytes"]}:
        return None
    least = sum(max(o.flops / work["peak_flops"],
                    o.bytes / peaks.HBM_BYTES_PER_S)
                for o in ops if o.name.startswith("attn"))
    share = 100.0 * least / (ms / 1e3)
    if share > 100.0:
        raise ValueError(f"gatv2 roofline share {share} > 100%: the work "
                         "is counted too high or K17's time misses work")
    return share
