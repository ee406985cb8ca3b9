"""Schedule tuning on the card: the enumerative ``search.autotune`` and
the genetic ``genetic.GeneticTuner``, both measuring candidates with CUDA
events (``utils/benchmark.time_layer_device``)."""
from .genetic import GeneticTuner, Genome  # noqa: F401
from .search import (TILE_PALETTE, Measurement, Memo, TuneResult,  # noqa: F401
                     autotune)
