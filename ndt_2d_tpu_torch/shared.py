"""The JAX package's jax-free modules, used by the port as they are.

Configuration, the host pose graph, bag I/O, scan projection, the synthetic
simulator and the metrics are plain numpy in the reference package and
import no ``jax``; the port shares them instead of copying them.  Every
port module takes them from here, so the boundary is one import list
(``tests/test_torch_slice.py`` checks that it stays jax-free).
"""

from ndt_2d_tpu.config import (  # noqa: F401
    MapperConfig, ParticleFilterConfig, ScanMatcherConfig, SolverConfig)
from ndt_2d_tpu.graph import pose_graph  # noqa: F401
from ndt_2d_tpu.io import serialization  # noqa: F401
from ndt_2d_tpu.io.bag import ScanBag, load_bag, record_synthetic, save_bag  # noqa: F401
from ndt_2d_tpu.mapping import laser  # noqa: F401
from ndt_2d_tpu.utils import metrics, sim  # noqa: F401
from ndt_2d_tpu.utils.memory import trim_host_heap  # noqa: F401
from ndt_2d_tpu.utils.profiling import SessionStats  # noqa: F401
from ndt_2d_tpu.utils.sim import LaserScanMsg  # noqa: F401
