"""Matcher registry: string-keyed construction of scan matchers (the
reference's pluginlib indirection).  Port of
``ndt_2d_tpu/matching/registry.py``: ``ndt``, its pluginlib alias,
``ndt_newton`` and ``correlative``."""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict

from ndt_2d_tpu_torch.matching.correlative import CorrelativeScanMatcher
from ndt_2d_tpu_torch.matching.matcher import NDTScanMatcher
from ndt_2d_tpu_torch.config import ScanMatcherConfig

_REGISTRY: Dict[str, Callable[..., object]] = {}


def register(name: str, factory) -> None:
    _REGISTRY[name] = factory


def create(name: str, config: ScanMatcherConfig, range_max: float,
           device=None):
    try:
        factory = _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown scan_matcher_type {name!r}; known: {sorted(_REGISTRY)}")
    return factory(config, range_max, device=device)


register("ndt", NDTScanMatcher)
# Alias matching the reference's pluginlib class path for config parity.
register("ndt_2d::ScanMatcherNDT", NDTScanMatcher)


def _ndt_newton(config: ScanMatcherConfig, range_max: float, device=None):
    """NDT matcher with the Newton sub-lattice polish on (10 iterations
    unless the config already sets refine_iterations)."""
    if config.refine_iterations == 0:
        config = dataclasses.replace(config, refine_iterations=10)
    return NDTScanMatcher(config, range_max, device=device)


register("ndt_newton", _ndt_newton)
register("correlative", CorrelativeScanMatcher)
