"""State carried between the JAX package and the port.

The JAX side is taken as numpy (what ``jax.device_get`` returns): an
``NDTGrid`` (single, or the stacked overlapping grids whose fields, the
cell size included, lead with a [4] axis) or ``MatchResult`` named tuple of
arrays, a ``RollingWindow`` named tuple, the [C, 32] packed patch table
(or the overlapping grids' [4, C, 32] tables), the pose-graph solver's inputs
(``graph/solver.py::solve``'s arrays) or its ``SolveResult``, and a particle
filter's state (``filter_to_port`` / ``filter_to_numpy``).
``*_to_port`` builds the port's tensors on ``device``; ``*_to_numpy``
returns a dict of numpy arrays under the JAX field names, so
``JaxType(**d)`` (or ``solve(config, **d)``) rebuilds the JAX value.
The configuration dataclasses and the pose ``Graph`` are plain
numpy-and-Python objects that each package keeps a copy of
(``ndt_2d_tpu_torch/config.py``, ``graph/pose_graph.py``); maps pass
between the packages through the npz files of ``io/serialization.py``.
"""

from __future__ import annotations

import numpy as np
import torch

from ndt_2d_tpu_torch.graph.solver import SolveResult
from ndt_2d_tpu_torch.kernels.candidate_scores import MatchResult
from ndt_2d_tpu_torch.matching.matcher import RollingWindow
from ndt_2d_tpu_torch.ndt.grid import NDTGrid

_GRID_FIELDS = ("origin", "mean", "information", "count", "covariance")
_WINDOW_FIELDS = ("poses", "points", "point_mask", "mask")
_MATCH_FIELDS = ("score", "correction", "covariance")
# A particle filter's state: the cloud, its weights and active count, the
# statistics of its last update and the recovery EWMAs.
FILTER_FIELDS = ("particles", "weights", "n_active", "mean", "cov",
                 "w_slow", "w_fast")
# solve()'s array arguments and their dtypes.
_SOLVE_INPUTS = {"poses": torch.float32, "begin": torch.int32,
                 "end": torch.int32, "transform": torch.float32,
                 "information": torch.float32, "constraint_mask": torch.bool,
                 "node_mask": torch.bool, "robust_mask": torch.bool}


def _t(x, device) -> torch.Tensor:
    return torch.as_tensor(np.array(x, copy=True), device=device)


def grid_to_port(grid, device=None) -> NDTGrid:
    return NDTGrid(cell_size=float(np.asarray(grid.cell_size).reshape(-1)[0]),
                   **{f: _t(getattr(grid, f), device) for f in _GRID_FIELDS})


def grid_to_numpy(grid: NDTGrid) -> dict:
    """Under the JAX field names; a stacked grid's cell size gets the
    grid axis as JAX's ``vmap``-built one has it."""
    d = {f: getattr(grid, f).cpu().numpy() for f in _GRID_FIELDS}
    d["cell_size"] = np.full(d["origin"].shape[:-1], grid.cell_size,
                             np.float32)
    return d


def window_to_port(window, device=None) -> RollingWindow:
    return RollingWindow(**{f: _t(getattr(window, f), device)
                            for f in _WINDOW_FIELDS})


def window_to_numpy(window: RollingWindow) -> dict:
    return {f: getattr(window, f).cpu().numpy() for f in _WINDOW_FIELDS}


def match_to_port(result, device=None) -> MatchResult:
    return MatchResult(*[_t(getattr(result, f), device)
                         for f in _MATCH_FIELDS])


def match_to_numpy(result: MatchResult) -> dict:
    return {f: getattr(result, f).cpu().numpy() for f in _MATCH_FIELDS}


def table_to_port(table, device=None) -> torch.Tensor:
    return _t(table, device)


def table_to_numpy(table: torch.Tensor) -> np.ndarray:
    return table.cpu().numpy()


def solve_inputs_to_port(device=None, **arrays) -> dict:
    """solve()'s arrays (poses, begin, end, transform, information,
    constraint_mask, node_mask and optionally robust_mask) as tensors of
    the port's dtypes, keyed for ``solver.solve(config, **d)``."""
    return {k: _t(v, device).to(_SOLVE_INPUTS[k])
            for k, v in arrays.items() if v is not None}


def solve_inputs_to_numpy(inputs: dict) -> dict:
    return {k: v.cpu().numpy() for k, v in inputs.items()}


def solve_result_to_port(result, device=None) -> SolveResult:
    return SolveResult(*[_t(getattr(result, f), device)
                         for f in SolveResult._fields])


def solve_result_to_numpy(result: SolveResult) -> dict:
    return {f: getattr(result, f).cpu().numpy() for f in SolveResult._fields}


def filter_to_numpy(pf) -> dict:
    """A port ``ParticleFilter``'s state under FILTER_FIELDS; the JAX
    filter takes it back as ``particles``, ``weights``, ``n_active``,
    ``_mean``, ``_cov``, ``w_slow`` and ``w_fast``."""
    return {"particles": pf.particles.cpu().numpy(),
            "weights": pf.weights.cpu().numpy(),
            "n_active": int(pf.n_active),
            "mean": np.asarray(pf.get_mean(), np.float32),
            "cov": np.asarray(pf.get_covariance(), np.float32),
            "w_slow": np.float32(pf.w_slow),
            "w_fast": np.float32(pf.w_fast)}


def filter_to_port(state: dict, pf) -> None:
    """Set a port ``ParticleFilter``'s state from numpy values under
    FILTER_FIELDS (a JAX filter's ``particles``, ``weights``,
    ``n_active``, ``get_mean()``, ``get_covariance()``, ``w_slow`` and
    ``w_fast``), on the filter's device."""
    dev = pf.device
    pf.particles = _t(np.asarray(state["particles"], np.float32), dev)
    pf.weights = _t(np.asarray(state["weights"], np.float32), dev)
    pf.n_active = int(state["n_active"])
    pf._mean = np.asarray(state["mean"], np.float64)
    pf._cov = np.asarray(state["cov"], np.float64)
    pf.w_state = torch.tensor([float(state["w_slow"]),
                               float(state["w_fast"])], dtype=torch.float32,
                              device=dev)
