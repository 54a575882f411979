"""Distributed execution over ``torch.distributed``.

Port of ``slslam_tpu/parallel``: line-sharded distributed bundle
adjustment (collective bytes per LM iteration independent of the map size)
and edge-sharded distributed pose-graph optimization, one process per
rank, with ``dist.all_reduce`` on a process group as the communication
backend (NCCL when every rank has a card of its own, gloo otherwise:
``multihost.py``).  Every collective goes through ``comm.all_reduce_sum``,
which counts calls, bytes and seconds (``comm_counts``).
"""

from .comm import (all_gather_shards, all_reduce_sum,  # noqa: F401
                   comm_counts, reset_comm_counts)
from .dist_ba import (dist_local_ba_lines,  # noqa: F401
                      make_mesh, partition_by_line)
from .dist_pgo import dist_pose_graph_opt  # noqa: F401
from .multihost import (initialize_multihost, is_primary,  # noqa: F401
                        run_local_ranks)
