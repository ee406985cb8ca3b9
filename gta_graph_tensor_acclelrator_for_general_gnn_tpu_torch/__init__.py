"""GTA on PyTorch and CUDA: the graph tensor accelerator for general GNNs,
ported from the JAX/TPU package ``gta_graph_tensor_acclelrator_for_general_gnn_tpu``
to one NVIDIA H100.

The same four-primitive message-passing IR, model zoo builders, schedules
and host-side graph preprocessing; plain PyTorch for the per-op path, and
hand-written CUDA kernels for Hopper (``csrc/``) in place of the TPU's
Pallas kernels.  GCN and GAT run on the hybrid density-split path, served
forward and trained full-batch (``models/train.py``), with the backward on
the kernels over the transposed graph's split.  The package imports torch
and numpy, never jax.
"""

from . import ir, ir_io
from .graph import (GraphTensor, HostGraph, MultiTiledGraph, TiledGraph,
                    build_graph, build_host_graph, cluster_labels,
                    nnz_histogram, reorder_nodes, tile_graph,
                    tile_graph_classes)
from .models.builders import NETWORKS, build_op_graph
from .ops.dense import auto_hybrid
from .models.zoo import Model, build_model
from .compiler.lower import init_params, lower, params_from_numpy
from .compiler.schedule import Schedule, TileConfig, default_schedule
from .compiler.fusion import lower_schedule
from .data.datasets import DATASET_STATS, Dataset, load_dataset

__version__ = "0.1.0"
