"""AMCL-style particle filter with KLD-adaptive resampling, on the port's
kernels.

Port of ``ndt_2d_tpu/filter/particle_filter.py``.  A scan update
(``pf_step``) is the motion sample, the measurement of every particle and
the KLD resample with its statistics: K9's motion launch, one K3 launch
over all particles (``matcher.score_points_batch``) and K9's resample
chain, with no host sync between them; the host reads n_active, the mean
and the covariance once per scan.  ``pf_step_recovery`` adds the AMCL
w_slow/w_fast EWMAs and the free-space injection inside the same chain.

Random numbers come from a ``torch.Generator`` on the filter's device,
seeded from ``seed``; each step draws its ``Draws`` in a fixed order and
hands them to the kernels as tensors, so a replay can hand the same draws
to the twins.
``jax.random`` and torch give different numbers from one seed, so a
session agrees with the JAX filter statistically; fed JAX's own draws,
these functions agree with JAX's (tests/test_torch_particle.py).

Deviation from the reference, kept from the JAX package: updateStatistics
is computed fresh each time (particle_filter.cpp:216 accumulates cov(2,2)
across calls).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ndt_2d_tpu_torch.core.pose import normalize_angle_exact
from ndt_2d_tpu_torch.device import get_device
from ndt_2d_tpu_torch.filter import motion_model
from ndt_2d_tpu_torch.kernels import particle_filter as k9
from ndt_2d_tpu_torch.matching import matcher as matcher_mod
from ndt_2d_tpu_torch.config import ParticleFilterConfig


class Draws(NamedTuple):
    """The random numbers of one filter step."""

    motion: torch.Tensor                         # [M, 3] standard normals
    resample: torch.Tensor                       # [M] uniforms in [0, 1)
    inject_sel: Optional[torch.Tensor] = None    # [M] uniforms in [0, 1)
    inject_idx: Optional[torch.Tensor] = None    # [M] int32 in [0, F)
    inject_jitter: Optional[torch.Tensor] = None  # [M, 2] in [-0.5, 0.5)
    inject_theta: Optional[torch.Tensor] = None   # [M] in [-pi, pi)


class StepResult(NamedTuple):
    """A filter step's outputs, on the device."""

    particles: torch.Tensor   # [M, 3]
    weights: torch.Tensor     # [M] normalized
    n: torch.Tensor           # [1] int32 n_active
    stats: torch.Tensor       # [13]: n, mean [3], cov [3, 3] row-major
    w_state: Optional[torch.Tensor] = None  # [2] (w_slow, w_fast)

    @property
    def mean(self):
        return self.stats[1:4]

    @property
    def cov(self):
        return self.stats[4:].reshape(3, 3)


_PI = float(np.float32(np.pi))


def _uniform(gen, shape, lo: float, hi: float, device):
    """Uniforms in [lo, hi) as the reference scales them: u * (hi - lo) +
    lo in float32."""
    u = torch.rand(shape, generator=gen, device=device)
    return u * float(np.float32(hi) - np.float32(lo)) + lo


def draw_step(gen, m: int, device, free_count: int = 0) -> Draws:
    """One step's draws from ``gen``: motion normals, resample uniforms
    and, with a free-space pool of ``free_count`` cells, the injection's."""
    motion = torch.randn(m, 3, generator=gen, device=device)
    resample = torch.rand(m, generator=gen, device=device)
    if not free_count:
        return Draws(motion, resample)
    sel = torch.rand(m, generator=gen, device=device)
    idx = torch.randint(0, free_count, (m,), generator=gen, device=device,
                        dtype=torch.int32)
    jitter = _uniform(gen, (m, 2), -0.5, 0.5, device)
    theta = _uniform(gen, (m,), -_PI, _PI, device)
    return Draws(motion, resample, sel, idx, jitter, theta)


def _n_tensor(n, device) -> torch.Tensor:
    """n_active as the kernels take it: an int32 tensor [1]."""
    if isinstance(n, torch.Tensor):
        return n.reshape(1).to(device=device, dtype=torch.int32)
    return torch.tensor([int(n)], dtype=torch.int32, device=device)


def update_statistics(particles, weights, n):
    """Normalize weights over the first n particles; weighted mean
    (circular for theta) and covariance (particle_filter.cpp:163-218).
    Returns (weights [M], mean [3], cov [3, 3])."""
    r = k9.statistics(particles, weights, _n_tensor(n, weights.device))
    return r.normalized, r.stats[1:4], r.stats[4:].reshape(3, 3)


def kld_resample(uniforms, particles, weights, n, kld_err: float,
                 kld_z: float, bin_sizes, min_particles: int):
    """KLD-adaptive resampling (particle_filter.cpp:91-137) with the
    draw's uniforms [M]; returns (particles, raw weights, n_active [1])."""
    r = k9.resample(weights, _n_tensor(n, weights.device), uniforms,
                    particles, bin_sizes, kld_err, kld_z, min_particles)
    return r.particles, r.weights, r.n


def inject_free_space(particles, weights, n, free_xy, free_cell: float,
                      p_inject, sel, idx, jitter, theta):
    """Replace each of the first n particles with probability ``p_inject``
    (sel < p_inject) by free cell ``idx`` (int32) jittered within its
    cell, at heading ``theta``, with the active mean weight.  Returns
    (particles, weights)."""
    dev = weights.device
    inj = k9.Injection(free_xy, float(free_cell), sel, idx, jitter, theta)
    p = torch.as_tensor(p_inject, dtype=torch.float32, device=dev).reshape(1)
    r = k9.statistics(particles, weights, _n_tensor(n, dev), inj, p)
    return r.particles, r.weights


def _motion_and_measure(draws: Draws, particles, control, mcfg, grid,
                        points, point_mask, num_points, alphas):
    p = motion_model.sample(particles, draws.motion, control[0], control[1],
                            control[2], alphas[0], alphas[1], alphas[2],
                            alphas[3])
    scores = matcher_mod.score_points_batch(mcfg, grid, points, point_mask,
                                            num_points, p)
    return p, scores


def pf_step(draws: Draws, particles, n, control, mcfg, grid, points,
            point_mask, num_points: int, alphas, kld_err: float, kld_z: float,
            bin_sizes, min_particles: int) -> StepResult:
    """One scan update: motion sample + measurement of every particle + KLD
    resample + statistics (the laserCallback PF branch,
    ndt_mapper.cpp:471-476), with the host-side ``control`` [3] and
    ``alphas`` [4].  ``n`` is the active count (int or int32 [1]); the
    kernels derive the mask from it on the device."""
    p, scores = _motion_and_measure(draws, particles, control, mcfg, grid,
                                    points, point_mask, num_points, alphas)
    r = k9.resample(scores, _n_tensor(n, scores.device), draws.resample, p,
                    bin_sizes, kld_err, kld_z, min_particles)
    return StepResult(r.particles, r.normalized, r.n, r.stats)


def pf_step_recovery(draws: Draws, particles, n, control, mcfg, grid, points,
                     point_mask, num_points: int, alphas, kld_err: float,
                     kld_z: float, bin_sizes, min_particles: int, free_xy,
                     free_cell: float, w_state, alpha_slow: float,
                     alpha_fast: float) -> StepResult:
    """pf_step + AMCL w_slow/w_fast recovery (Probabilistic Robotics table
    8.3): the EWMAs of the mean likelihood of the active particles set
    p_inject = max(0, 1 - w_fast / w_slow), and each resampled particle is
    replaced with that probability by a uniform draw over the free space.
    ``w_state`` [2] (w_slow, w_fast; 0 = unset) comes back updated in
    ``StepResult.w_state``."""
    p, scores = _motion_and_measure(draws, particles, control, mcfg, grid,
                                    points, point_mask, num_points, alphas)
    inj = k9.Injection(free_xy, float(free_cell), draws.inject_sel,
                       draws.inject_idx, draws.inject_jitter,
                       draws.inject_theta)
    rec = k9.Recovery(w_state, float(alpha_slow), float(alpha_fast), True,
                      inj)
    r = k9.resample(scores, _n_tensor(n, scores.device), draws.resample, p,
                    bin_sizes, kld_err, kld_z, min_particles, rec)
    return StepResult(r.particles, r.normalized, r.n, r.stats, r.w_state)


class ParticleFilter:
    """Host-side stateful filter with the reference class surface (init /
    update / measure / resample / getMean / getCovariance,
    include/ndt_2d/particle_filter.hpp:45-115) and the fused ``step``."""

    def __init__(self, config: ParticleFilterConfig, seed: int = 0,
                 device=None):
        self.config = config
        self.device = get_device(device)
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(int(seed))
        m = config.max_particles
        self.particles = torch.zeros(m, 3, device=self.device)
        self.weights = torch.full((m,), 1.0 / config.min_particles,
                                  device=self.device)
        self.n_active = config.min_particles
        # AMCL recovery: the free-space pool and (w_slow, w_fast), chained
        # on the device; 0 = unset (the first measurement seeds both).
        self.free_xy = None
        self.free_cell = 0.0
        self.w_state = torch.zeros(2, device=self.device)
        self._refresh_statistics()

    # ------------------------------------------------------------------
    def _n(self) -> torch.Tensor:
        return _n_tensor(self.n_active, self.device)

    def _take(self, particles, weights, stats) -> None:
        """Adopt a step's state; one device->host read of its statistics
        (n_active, mean, covariance)."""
        self.particles, self.weights = particles, weights
        host = stats.cpu().numpy().astype(np.float64)
        self.n_active = int(host[0])
        self._mean = host[1:4]
        self._cov = host[4:].reshape(3, 3)

    def _refresh_statistics(self) -> None:
        r = k9.statistics(self.particles, self.weights, self._n())
        self._take(r.particles, r.normalized, r.stats)

    @property
    def w_slow(self) -> float:
        return float(self.w_state[0])

    @property
    def w_fast(self) -> float:
        return float(self.w_state[1])

    # ------------------------------------------------------------------
    def init(self, x, y, theta, sigma_x, sigma_y, sigma_theta) -> None:
        """Gaussian-seed the particle cloud (particle_filter.cpp:53-69)."""
        m = self.config.max_particles
        noise = torch.randn(m, 3, generator=self.gen, device=self.device)
        mean = torch.tensor([x, y, theta], dtype=torch.float32,
                            device=self.device)
        sig = torch.tensor([sigma_x, sigma_y, sigma_theta],
                           dtype=torch.float32, device=self.device)
        p = mean + noise * sig
        self.particles = torch.cat([p[:, :2], normalize_angle_exact(p[:, 2:])],
                                   1)
        self.weights = torch.full((m,), 1.0 / self.n_active,
                                  device=self.device)
        self.w_state = torch.zeros(2, device=self.device)
        self._refresh_statistics()

    def init_global(self, free_xy, cell_size: float) -> None:
        """Global-localization seeding: uniform over free space x uniform
        heading (AMCL's global_localization service; the reference has no
        equivalent).  free_xy: [N, 2] free-cell centers; each draw is
        jittered within its cell of ``cell_size``."""
        m = self.config.max_particles
        free = torch.as_tensor(np.asarray(free_xy, np.float32),
                               device=self.device)
        idx = torch.randint(0, free.shape[0], (m,), generator=self.gen,
                            device=self.device)
        jit = _uniform(self.gen, (m, 2), -0.5, 0.5, self.device)
        th = _uniform(self.gen, (m, 1), -_PI, _PI, self.device)
        self.particles = torch.cat([free[idx] + jit * float(cell_size), th],
                                   1)
        self.n_active = m
        self.weights = torch.full((m,), 1.0 / m, device=self.device)
        self.w_state = torch.zeros(2, device=self.device)
        # The free-space pool doubles as the recovery injection pool.
        self.set_free_space(free, cell_size)
        self._refresh_statistics()

    def set_free_space(self, free_xy, cell_size: float) -> None:
        """The free-space pool of the recovery injection; recovery is on
        when both config.recovery_alpha_* are > 0 and a pool is set."""
        self.free_xy = torch.as_tensor(np.asarray(
            free_xy.cpu() if isinstance(free_xy, torch.Tensor) else free_xy,
            np.float32), device=self.device)
        self.free_cell = float(cell_size)

    @property
    def recovery_enabled(self) -> bool:
        c = self.config
        return (c.recovery_alpha_slow > 0.0 and c.recovery_alpha_fast > 0.0
                and self.free_xy is not None and len(self.free_xy) > 0)

    def _alphas(self) -> tuple:
        c = self.config
        return c.odom_alpha1, c.odom_alpha2, c.odom_alpha3, c.odom_alpha4

    def _bin_sizes(self) -> tuple:
        c = self.config
        return c.kld_bin_x, c.kld_bin_y, c.kld_bin_theta

    def _draws(self) -> Draws:
        free = len(self.free_xy) if self.recovery_enabled else 0
        return draw_step(self.gen, self.config.max_particles, self.device,
                         free)

    # ------------------------------------------------------------------
    def update(self, dx, dy, dth) -> None:
        """Motion update (particle_filter.cpp:71-76)."""
        noise = torch.randn(self.config.max_particles, 3, generator=self.gen,
                            device=self.device)
        self.particles = motion_model.sample(self.particles, noise, dx, dy,
                                             dth, *self._alphas())
        self._refresh_statistics()

    def measure(self, matcher, points, point_mask, num_points) -> None:
        """Measurement update: weight_i = scorePoints(scan, particle_i)
        (particle_filter.cpp:78-89), the raw (negative) NDT score; with
        recovery armed the EWMAs update here from the raw scores, on K9 in
        the order of the fused step's."""
        pts, msk = self._scan(points, point_mask)
        scores = matcher_mod.score_points_batch(
            matcher.config, matcher.grid, pts, msk, int(num_points),
            self.particles)
        if self.recovery_enabled:
            c = self.config
            self.w_state = k9.ewma(scores, self._n(), self.w_state,
                                   c.recovery_alpha_slow,
                                   c.recovery_alpha_fast)
        self.weights = scores
        self._refresh_statistics()

    def resample(self, kld_err=None, kld_z=None) -> None:
        """KLD resample (with the recovery injection when armed) and the
        statistics, in one K9 call."""
        c = self.config
        kld_err = c.kld_err if kld_err is None else kld_err
        kld_z = c.kld_z if kld_z is None else kld_z
        d = self._draws()
        rec = None
        if self.recovery_enabled:
            rec = k9.Recovery(
                self.w_state, c.recovery_alpha_slow, c.recovery_alpha_fast,
                False, k9.Injection(self.free_xy, self.free_cell,
                                    d.inject_sel, d.inject_idx,
                                    d.inject_jitter, d.inject_theta))
        r = k9.resample(self.weights, self._n(), d.resample, self.particles,
                        self._bin_sizes(), float(np.float32(kld_err)),
                        float(np.float32(kld_z)), c.min_particles, rec)
        self._take(r.particles, r.normalized, r.stats)

    def _scan(self, points, point_mask):
        return (torch.as_tensor(np.asarray(points, np.float32),
                                device=self.device),
                torch.as_tensor(np.asarray(point_mask, bool),
                                device=self.device))

    def step(self, matcher, control, points, point_mask, num_points):
        """Fused per-scan update (pf_step, or pf_step_recovery when armed):
        no host sync inside, one read of (n_active, mean, cov) at the end.
        Returns the mean pose."""
        if matcher.grid is None:
            raise ValueError("the particle filter needs a map to measure "
                             "against")
        c = self.config
        pts, msk = self._scan(points, point_mask)
        control = [float(np.float32(v)) for v in np.asarray(control)]
        args = (self._draws(), self.particles, self._n(), control,
                matcher.config, matcher.grid, pts, msk, int(num_points),
                self._alphas(), float(np.float32(c.kld_err)),
                float(np.float32(c.kld_z)), self._bin_sizes(), c.min_particles)
        if self.recovery_enabled:
            r = pf_step_recovery(*args, self.free_xy, self.free_cell,
                                 self.w_state, c.recovery_alpha_slow,
                                 c.recovery_alpha_fast)
            self.w_state = r.w_state
        else:
            r = pf_step(*args)
        self._take(r.particles, r.weights, r.stats)
        return self.get_mean()

    # ------------------------------------------------------------------
    def get_mean(self) -> np.ndarray:
        return np.asarray(self._mean)

    def get_covariance(self) -> np.ndarray:
        return np.asarray(self._cov)

    def cloud(self) -> np.ndarray:
        """Active particles as numpy (the particlecloud PoseArray analog,
        particle_filter.cpp:149-161)."""
        return self.particles[:self.n_active].cpu().numpy()

