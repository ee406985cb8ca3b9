"""GTA on PyTorch and CUDA: the graph tensor accelerator for general GNNs,
ported from the JAX/TPU package ``gta_graph_tensor_acclelrator_for_general_gnn_tpu``
to one NVIDIA H100.

The same four-primitive message-passing IR, model zoo builders, schedules
and host-side graph preprocessing; plain PyTorch for the per-op path, and
hand-written CUDA kernels for Hopper (``csrc/``) in place of the TPU's
Pallas kernels.  This slice runs the serving forward of GCN and GAT on the
hybrid density-split path.  The package imports torch and numpy, never jax.
"""

from . import ir
from .graph import (GraphTensor, HostGraph, TiledGraph, build_host_graph,
                    reorder_nodes, tile_graph)
from .models.builders import NETWORKS, build_op_graph
from .models.zoo import Model, build_model
from .compiler.lower import init_params, lower, params_from_numpy
from .compiler.schedule import Schedule, TileConfig, default_schedule
from .compiler.fusion import lower_schedule
from .data.datasets import DATASET_STATS, Dataset, load_dataset

__version__ = "0.1.0"
