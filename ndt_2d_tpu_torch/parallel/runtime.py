"""Mesh-sharded steps of the mapper runtime that are not a matcher entry.

Port of ``ndt_2d_tpu/parallel/runtime.py``.  The sharding
(``parallel/mesh.py``): candidate angles over ``space``
(``parallel/matcher.py``), confirmation rows over ``batch`` with each
row's angles over ``space``, pose-graph constraints over ``batch``
(``parallel/solver.py``), occupancy rays over every rank.  The reference's
matching programs are the port's matcher entries with their ``mesh``
argument set (``matching/matcher.py``), equal to the single-device results
bitwise: ``match_scan_rolling_multichip`` (runtime.py:43) is
``match_scan_rolling``, ``mapping_step_async_multichip`` (:66)
``mapping_step_async``, ``match_scan_global_multichip`` (:101)
``match_scan_with_score``, ``confirm_rows_multichip`` (:288; :154 with one
query) ``match_scan_batch_multi`` and
``confirm_rows_coarse_fine_multichip`` (:335; :207)
``match_scan_batch_multi_coarse_fine``; ``solve_graph_multichip``
(:398) is ``graph.solver.solve_graph`` with its ``mesh``.  Here: the
occupancy ray-march.
"""

from __future__ import annotations

import torch

from ndt_2d_tpu_torch.kernels import raymarch
from ndt_2d_tpu_torch.parallel import distributed


def raymarch_counts_multichip(mesh, starts, ends, beam_mask, origin,
                              resolution: float, width: int, height: int,
                              num_samples: int):
    """The occupancy ray-march with the rays sharded over every rank of
    the mesh (runtime.py:448): each rank marches its contiguous block (K5)
    and the int32 hit and empty images are summed exactly over the ranks,
    so the counts equal the single-device ones bitwise.  The rays are
    padded with masked ones to a multiple of the rank count."""
    n, R = mesh.size(), starts.shape[0]
    m = -(-R // n)
    pad = n * m - R
    if pad:
        starts, ends = (torch.cat([x, x.new_zeros(pad, 2)])
                        for x in (starts, ends))
        beam_mask = torch.cat([beam_mask, beam_mask.new_zeros(pad)])
    block = slice(mesh.get_rank() * m, (mesh.get_rank() + 1) * m)
    hit, empty = raymarch.raymarch_counts(
        starts[block].contiguous(), ends[block].contiguous(),
        beam_mask[block].contiguous(), origin, resolution, width, height,
        num_samples)
    both = distributed.sum_int(torch.stack([hit, empty]))
    return both[0], both[1]
