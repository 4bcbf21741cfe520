"""navtech_radar_slam_tpu — a radar SLAM framework in JAX.

A from-scratch JAX/XLA re-design of the capabilities of
gisbi-kim/navtech-radar-slam (reference mounted at /root/reference):

  polar Navtech radar scans (MulRan "polar oxford form")
    -> cen2019 feature extraction              (ops.cen2019; whole-scan fused ops)
    -> constellation-descriptor matching       (ops.features; one correlation matmul)
    -> ORORA-style outlier-robust registration (ops.registration; GNC rotation +
                                                decoupled robust translation)
    -> keyframing + ScanContext descriptors    (ops.scancontext; batched bank search)
    -> submap ICP loop verification            (ops.icp; brute-force NN)
    -> robust pose-graph optimization          (models.posegraph; GN/LM + CG)
    -> trajectory + aggregated map output      (models.slam)

Unlike the reference (two ROS nodes, five threads, mutexes, KD-trees), every
compute stage here is a jitted, statically-shaped JAX function; loop-candidate
search is a batched matrix correlation over the whole descriptor bank; the
descriptor bank and pose graph shard over a `jax.sharding.Mesh` for multi-device /
multi-host operation (parallel/).

Reference parity citations use the form `<file>:<lines>` and refer to files
under /root/reference.
"""

__version__ = "0.1.0"

from navtech_radar_slam_tpu.config import SlamConfig  # noqa: F401
