"""Schedule autotuning on the card (``search.autotune``); the genetic
tuner of the JAX package (``tune/genetic.py``) is not ported yet
(ROADMAP.md Queue 1 item 10)."""
from .search import (TILE_PALETTE, Measurement, Memo, TuneResult,  # noqa: F401
                     autotune)
