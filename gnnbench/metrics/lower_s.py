"""Seconds of the lowering: ``Model.make_apply`` on the hybrid schedules
(``compiler/fusion.lower_schedule``: the density splits, tilings and, for
training, the transposed graph and its twins), by the harness's clock."""


def read(record):
    return record["timers"].get("lower_s")
