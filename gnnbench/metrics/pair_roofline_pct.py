"""K13's share of its roofline: the least time of the ``pair{i}`` ops of
``work/pna.py`` (each at the larger of its FLOPs over the peak and its
bytes over the memory's peak) over K13's device time per forward
(``pair_ms``), in percent.  ``run.py`` hands readers only the totals of
the work, so the op list is ``work/pna.py``'s of its last count, used only
where its totals are the record's; None otherwise, or where the trace
holds no K13.  Above 100 it is a counting error and raises."""

from gnnbench import peaks, spec
from gnnbench.work import pna, totals


def read(record):
    ms = spec.reader("pair_ms")(record)
    ops = pna.LAST_FORWARD_OPS
    if ms is None or not ops:
        return None
    work = record["work"]
    if totals(ops) != {"flops": work["flops"], "bytes": work["bytes"]}:
        return None
    least = sum(max(o.flops / work["peak_flops"],
                    o.bytes / peaks.HBM_BYTES_PER_S)
                for o in ops if o.name.startswith("pair"))
    share = 100.0 * least / (ms / 1e3)
    if share > 100.0:
        raise ValueError(f"pair roofline share {share} > 100%: the work is "
                         "counted too high or K13's time misses work")
    return share
