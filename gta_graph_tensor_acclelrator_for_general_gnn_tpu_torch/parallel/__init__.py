"""Multi-device execution over ``torch.distributed`` (counterpart of the
JAX package's ``parallel/``): the halo partition, the per-rank sharded
forward and train step with K1 and K3 on each rank's local edges, the
hierarchical 2-D plan, quantized exchanges, multi-node start-up, the
scaling prediction, overlap read from profiler traces, and a launcher
for a world of ranks on one machine."""
from .partition import (PartitionedGraph, community_partition_order,
                        partition_graph, pad_nodes)
from .scaling import overlap_fraction, predicted_scaling
from .multihost import init_multihost, train_multihost
from .mesh2d import (CHIP_AXIS, HOST_AXIS, Mesh2D, PartitionedGraph2D,
                     make_mesh2d, partition_graph_2d, remote_table_2d)
from .dist import (
    AXIS,
    remote_table,
    lower_shard,
    make_dist_apply,
    make_sharded_train_step,
    shard_part,
    shard_rows,
    shard_tiles,
    shard_tiling,
)
from .launch import launch
