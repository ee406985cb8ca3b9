"""Seconds of the optimizer's construction in set-up (training): the
port's ``train.adamw_init`` span (``models/train.adamw``); part of the
warm-up that ``setup_s`` holds."""
from gnnbench import spans


def read(record):
    return spans.seconds(spans.recorded(record, "setup",
                                        "train.adamw_init"))
