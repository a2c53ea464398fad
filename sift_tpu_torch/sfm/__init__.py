"""Incremental SfM back end: bundle adjustment, PnP, pose graphs, loop
closure and the end-to-end mapping pipeline (twin of sift_tpu/sfm/).

Static-shape masked observation tables, batched small-block linear
algebra and a matrix-free Schur-complement bundle adjuster, on the
device the caller names (default CUDA); NumPy bookkeeping on the host.
Also the partitioned pose graph over torch.distributed ranks, rotation
averaging and npz checkpoints.
"""

from sift_tpu_torch.sfm.ba import BAProblem, bundle_adjust, reproj_rmse
from sift_tpu_torch.sfm.incremental import Reconstruction, reconstruct
from sift_tpu_torch.sfm.posegraph import PoseGraph, optimize_pose_graph
from sift_tpu_torch.sfm.posegraph_dist import optimize_pose_graph_partitioned
from sift_tpu_torch.sfm.loopclosure import LoopClosure, find_loop_closures
from sift_tpu_torch.sfm.rotation_avg import average_rotations
from sift_tpu_torch.sfm.export import save_ply, save_reconstruction
from sift_tpu_torch.sfm.mapping import (MappingResult, mapping_ate,
                                        render_corner_sequence, run_mapping)

__all__ = ["BAProblem", "bundle_adjust", "reproj_rmse",
           "Reconstruction", "reconstruct",
           "PoseGraph", "optimize_pose_graph",
           "optimize_pose_graph_partitioned",
           "LoopClosure", "find_loop_closures",
           "average_rotations", "save_ply", "save_reconstruction",
           "MappingResult", "mapping_ate", "render_corner_sequence",
           "run_mapping"]
