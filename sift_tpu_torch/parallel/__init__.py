"""Multi-device layer over torch.distributed (twin of sift_tpu/parallel).

One process per rank, in one torch.distributed world: gloo on the CPU,
NCCL when each rank owns a card. Each shard_map program of sift_tpu is
an SPMD function here: every rank calls it with the same arguments and
gets the same result. Data-parallel frame batches for the front end,
query- and train-sharded matching, observation- and point-sharded
Schur-complement bundle adjustment, one frame tiled by rows with a halo
exchange, and elastic, checkpointed BA that shrinks on failure.
"""

from sift_tpu_torch.parallel.mesh import (Mesh, default_mesh, init_process,
                                          make_mesh, run_spmd)
from sift_tpu_torch.parallel.frames import batched_detect_and_compute
from sift_tpu_torch.parallel.match import (sharded_match_ratio,
                                           sharded_match_ratio_train_sharded)
from sift_tpu_torch.parallel.ba import (bundle_adjust_sharded,
                                        bundle_adjust_point_sharded)
from sift_tpu_torch.parallel.spatial import detect_and_compute_tiled
from sift_tpu_torch.parallel.elastic import supervise_ba

__all__ = ["Mesh", "make_mesh", "default_mesh", "init_process", "run_spmd",
           "batched_detect_and_compute",
           "sharded_match_ratio", "sharded_match_ratio_train_sharded",
           "bundle_adjust_sharded", "bundle_adjust_point_sharded",
           "detect_and_compute_tiled", "supervise_ba"]
