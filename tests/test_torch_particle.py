"""The port's particle filter (K9's and K3-batch's twins) against
ndt_2d_tpu's.

jax.random and torch draw different numbers from one seed, so every
comparison feeds the port the draws JAX makes from its fixed keys, split
as ``pf_step`` and ``inject_free_space`` split them.  The JAX functions run
op by op (``jax.disable_jit``): under jit XLA:CPU contracts a*b+c into
FMAs, which the port (one rounding per operation) does not.

Tolerances.  Motion sample: rtol 1e-6.  Resampling: the same drawn
indices, first-occurrence marks and n_active (the port's CDF adds in the
kernel's order, JAX's in XLA's; at these fixtures no draw falls between
the two).  Statistics: mean rtol 1e-6 (atol 1e-6 for near-zero heading);
weights rtol 1e-6; covariance within 1e-6 x (1 + max |mean_xy|)^2, since
corr - mean mean^T cancels the leading digits of sums that the two
libraries add in different orders.  K3 over poses: each row equals the
single-pose score bitwise.  Against JAX, scores within 1e-6 and step
weights rtol 1e-5 at the poses whose heading has the same float32 cos and
sin in both libraries (at the others one ulp of rotation moves a beam
within a stiff NDT cell, which changes its term by up to ~1e-4 relative).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ndt_2d_tpu.config import ParticleFilterConfig, ScanMatcherConfig
from ndt_2d_tpu.filter import motion_model as jax_motion
from ndt_2d_tpu.filter import particle_filter as jax_pf
from ndt_2d_tpu.matching import matcher as jax_matcher
from ndt_2d_tpu.matching import registry as jax_registry
from ndt_2d_tpu.utils import sim
from ndt_2d_tpu_torch import convert
from ndt_2d_tpu_torch.filter import motion_model
from ndt_2d_tpu_torch.filter import particle_filter as pf
from ndt_2d_tpu_torch.kernels import particle_filter as k9
from ndt_2d_tpu_torch.matching import matcher

torch.set_num_threads(2)

BINS = np.asarray([0.5, 0.5, 0.2671], np.float32)
CFG = ParticleFilterConfig(min_particles=50, max_particles=200)
MCFG = ScanMatcherConfig(grid_cells_x=128, grid_cells_y=128)


def T(x):
    return torch.from_numpy(np.array(x))


def cloud(seed, m, center=(5.0, 4.0, 0.3), sigma=(0.3, 0.3, 0.2)):
    rng = np.random.default_rng(seed)
    return rng.normal(center, sigma, (m, 3)).astype(np.float32)


def jax_uniform(key, m):
    return np.asarray(jax.random.uniform(key, (m,), jnp.float32))


def same_trig(theta):
    """[M] bool: float32 cos and sin of these headings agree bitwise in
    the two libraries."""
    th = np.array(theta, np.float32)
    t = torch.from_numpy(th)
    return ((np.asarray(jnp.cos(th)) == torch.cos(t).numpy())
            & (np.asarray(jnp.sin(th)) == torch.sin(t).numpy()))


def assert_weights_close(w, jw, theta):
    ok = same_trig(theta)
    assert ok.mean() > 0.5
    np.testing.assert_allclose(np.asarray(w)[ok], np.asarray(jw)[ok],
                               rtol=1e-5, atol=1e-9)
    np.testing.assert_allclose(np.asarray(w), np.asarray(jw), rtol=1e-3,
                               atol=1e-9)


def assert_stats_close(mean, cov, jmean, jcov):
    jmean, jcov = np.asarray(jmean), np.asarray(jcov)
    np.testing.assert_allclose(np.asarray(mean), jmean, rtol=1e-6,
                               atol=1e-6)
    scale = (1.0 + np.abs(jmean[:2]).max()) ** 2
    np.testing.assert_allclose(np.asarray(cov), jcov, rtol=0,
                               atol=1e-6 * scale)


# --- motion model ------------------------------------------------------------
@pytest.mark.parametrize("motion", [(0.1, 0.02, 0.05), (-0.3, 0.0, 0.0),
                                    (0.0, 0.0, 1.2), (0.005, 0.001, -0.01),
                                    (0.0, 0.0, 0.0)])
def test_motion_sample_matches_jax(motion):
    parts = cloud(0, 300, sigma=(0.5, 0.5, 2.0))
    key = jax.random.PRNGKey(3)
    noise = np.asarray(jax.random.normal(key, (300, 3), jnp.float32))
    alphas = (0.2, 0.1, 0.05, 0.3)
    with jax.disable_jit():
        want = jax_motion.sample(key, jnp.asarray(parts), *motion, *alphas)
    got = motion_model.sample(T(parts), T(noise), *motion, *alphas)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-7)


@pytest.mark.parametrize("motion,theta0,alphas,expect", [
    ((1.0, 0.0, 0.0), 0.0, 0.02, (1.0, 0.0, 0.0)),
    ((0.0, 1.0, np.pi / 2), 0.0, 0.02, (0.0, 1.0, np.pi / 2)),
    ((-1.0, 0.0, 0.0), 0.0, 0.01, (-1.0, 0.0, 0.0)),
    ((0.5, 0.5, 0.0), 0.0, 0.01, (0.5, 0.5, 0.0)),
])
def test_motion_ensembles(motion, theta0, alphas, expect):
    """tests/test_particle.py::TestMotionModel on the port: the ensemble
    mean lands on the motion, noise is applied, and driving backwards does
    not blow the noise up (motion_model.cpp:53-57)."""
    gen = torch.Generator().manual_seed(42)
    poses = torch.zeros(500, 3)
    poses[:, 2] = theta0
    out = motion_model.sample(poses, torch.randn(500, 3, generator=gen),
                              *motion, *(alphas,) * 4).numpy()
    np.testing.assert_allclose(out.mean(0), expect, atol=0.15)
    assert out[:, 0].std() > 0.001
    assert out[:, 0].std() < 0.3


# --- KLD resampling ----------------------------------------------------------
def _weights(kind, m, rng):
    if kind == "zero_total":
        return np.zeros(m, np.float32)
    if kind == "positive":
        return rng.random(m).astype(np.float32)
    return -rng.random(m).astype(np.float32)  # raw NDT scores


@pytest.mark.parametrize("kind,n,sigma", [
    ("negative", 200, (0.3, 0.3, 0.2)),
    ("negative", 137, (1.5, 1.5, 1.0)),
    ("zero_total", 160, (0.4, 0.4, 0.3)),
    ("positive", 200, (0.05, 0.05, 0.02)),
    ("negative", 200, (1e-4, 1e-4, 1e-4)),     # k == 1: fills to M
])
def test_kld_resample_matches_jax(kind, n, sigma):
    m = 200
    rng = np.random.default_rng(7)
    parts = cloud(1, m, center=(2.2, -1.3, 0.1), sigma=sigma)
    w = _weights(kind, m, rng)
    mask = np.arange(m) < n
    key = jax.random.PRNGKey(5)
    with jax.disable_jit():
        jp, jw, jn = jax_pf.kld_resample(
            key, jnp.asarray(parts), jnp.asarray(w), jnp.asarray(mask),
            jnp.float32(0.01), jnp.float32(2.3), jnp.asarray(BINS), 50, m)
        p = jax_pf.normalize_weights(jnp.asarray(w), jnp.asarray(mask))
        jidx = np.asarray(jax.random.choice(key, m, shape=(m,), p=p))
        keys = np.trunc(np.asarray(jp) / BINS).astype(np.int32)
    r = k9.resample(T(w), torch.tensor([n], dtype=torch.int32),
                    T(jax_uniform(key, m)), T(parts), BINS, 0.01, 2.3, 50)
    # The CDFs add in different orders; every draw lands on the same side
    # of every boundary, so the indices agree.
    cdf = k9._cdf(k9._normalized(T(w), T(mask), n)).numpy()
    np.testing.assert_allclose(cdf, np.asarray(jnp.cumsum(p)), rtol=2e-6,
                               atol=1e-7)
    np.testing.assert_array_equal(r.idx.numpy(), jidx)
    assert int(r.n[0]) == int(jn)
    np.testing.assert_array_equal(r.particles.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(r.weights.numpy(), np.asarray(jw))
    seen, first = set(), []
    for row in map(tuple, keys):
        first.append(row not in seen)
        seen.add(row)
    np.testing.assert_array_equal(r.marks.numpy(), first)
    if sigma[0] < 1e-3:
        assert int(r.n[0]) == m
    # The port's public function returns the same sample.
    sp, sw, sn = pf.kld_resample(T(jax_uniform(key, m)), T(parts), T(w), n,
                                 0.01, 2.3, BINS, 50)
    assert torch.equal(sp, r.particles) and int(sn[0]) == int(jn)
    # The jitted reference reaches the same count.
    jit_n = jax_pf.kld_resample(
        key, jnp.asarray(parts), jnp.asarray(w), jnp.asarray(mask),
        jnp.float32(0.01), jnp.float32(2.3), jnp.asarray(BINS), 50, m)[2]
    assert int(jit_n) == int(jn)


def test_kld_bins_count_duplicates_once():
    """tests/test_particle.py::TestKldBinCounting: 4 draws in 2 bins give
    k(m) = 1, 1, 2, 2, and truncation runs toward zero (kd_tree.hpp:99)."""
    parts = torch.tensor([[0.1, 0.1, 0.0], [0.2, 0.2, 0.0], [1.1, 1.1, 0.0],
                          [1.2, 1.2, 0.0]])
    keys = torch.trunc(parts / T(BINS)).to(torch.int32)
    first = k9.first_occurrence(keys)
    np.testing.assert_array_equal(torch.cumsum(first.int(), 0).numpy(),
                                  [1, 1, 2, 2])
    neg = torch.tensor([[0.4, 0.0, 0.0], [-0.4, 0.0, 0.0]])
    keys = torch.trunc(neg / T(BINS)).to(torch.int32)
    assert torch.equal(keys[0], keys[1])
    assert k9.first_occurrence(keys).tolist() == [True, False]


@pytest.mark.parametrize("w_state", [(0.0, 0.0), (0.4, 0.2)])
def test_ewma_matches_recovery_resample_and_jax(w_state):
    """measure()'s EWMAs (K9 ``ewma``) are the recovery resample's bit for
    bit, and the JAX filter's measure() formula within rtol 1e-6 (the sums
    add in different orders)."""
    m, n, a_slow, a_fast = 300, 211, 0.001, 0.1
    rng = np.random.default_rng(9)
    w = -rng.random(m).astype(np.float32)
    ws = torch.tensor(w_state, dtype=torch.float32)
    n_t = torch.tensor([n], dtype=torch.int32)
    got = k9.ewma(T(w), n_t, ws, a_slow, a_fast)
    inj = k9.Injection(torch.zeros(4, 2), 0.05, torch.ones(m),
                       torch.zeros(m, dtype=torch.int32), torch.zeros(m, 2),
                       torch.zeros(m))
    r = k9.resample(T(w), n_t, T(rng.random(m).astype(np.float32)),
                    T(cloud(2, m)), BINS, 0.01, 2.3, 50,
                    k9.Recovery(ws, a_slow, a_fast, True, inj))
    assert torch.equal(got, r.w_state)
    mask = jnp.arange(m) < n
    w_avg = jnp.sum(jnp.where(mask, -jnp.asarray(w), 0.0)) / jnp.float32(n)
    js, jf = jnp.float32(w_state[0]), jnp.float32(w_state[1])
    want = [jnp.where(js == 0.0, w_avg, js + a_slow * (w_avg - js)),
            jnp.where(jf == 0.0, w_avg, jf + a_fast * (w_avg - jf))]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_first_occurrence_matches_all_pairs(seed):
    """tests/test_particle.py::TestSortedDedupEquivalence on the twin: the
    sorted first-occurrence marks equal the quadratic definition, and the
    stopping count equals the loop's."""
    rng = np.random.default_rng(seed)
    m = 512
    keys = torch.from_numpy(rng.integers(-4, 4, (m, 3)).astype(np.int32))
    got = k9.first_occurrence(keys).numpy()
    same = (keys[:, None, :] == keys[None, :, :]).all(-1).numpy()
    expect = ~np.tril(same, k=-1).any(axis=1)
    np.testing.assert_array_equal(got, expect)
    k = np.cumsum(expect)
    kf = k.astype(float)
    a = (kf - 1.0) / (2.0 * 0.01)
    b = 2.0 / (9.0 * np.maximum(kf - 1.0, 1.0))
    c = 1.0 - b + np.sqrt(b) * 2.3
    mx = np.where(k > 1, np.floor(a * c * c * c).astype(int), m)
    done = (np.arange(1, m + 1) >= 50) & (np.arange(1, m + 1) >= mx)
    want = int(np.argmax(done) + 1) if done.any() else m
    assert k9.kld_count(torch.from_numpy(got), 0.01, 2.3, 50) == want


def test_negative_weights_rank():
    """tests/test_particle.py::TestNegativeWeightResampling: raw negative
    NDT responses rank correctly (more negative = better)."""
    n = 400
    parts = torch.cat([torch.zeros(n // 2, 3), torch.full((n // 2, 3), 5.0)])
    w = torch.cat([torch.full((n // 2,), -0.5), torch.full((n // 2,), -0.01)])
    u = torch.rand(n, generator=torch.Generator().manual_seed(0))
    p, _, _ = pf.kld_resample(u, parts, w, n, 0.01, 2.3, BINS, 50)
    assert float((p[:, 0] < 1.0).float().mean()) > 0.9


# --- statistics and injection -----------------------------------------------
@pytest.mark.parametrize("kind,n", [("negative", 200), ("negative", 90),
                                    ("zero_total", 150),
                                    ("positive", 200)])
def test_update_statistics_matches_jax(kind, n):
    m = 200
    rng = np.random.default_rng(11)
    parts = cloud(2, m, center=(3.0, -2.0, 3.0), sigma=(0.4, 0.2, 0.3))
    parts[:, 2] = parts[:, 2] - 2 * np.pi * (parts[:, 2] > np.pi)  # +-pi
    w = _weights(kind, m, rng)
    with jax.disable_jit():
        jw, jm, jc = jax_pf.update_statistics(
            jnp.asarray(parts), jnp.asarray(w), jnp.arange(m) < n)
    wn, mean, cov = pf.update_statistics(T(parts), T(w), n)
    np.testing.assert_allclose(wn.numpy(), np.asarray(jw), rtol=1e-6,
                               atol=1e-9)
    assert_stats_close(mean, cov, jm, jc)
    assert abs(abs(float(mean[2])) - np.pi) < 0.2  # circular mean near pi


def inject_draws(k_sel, k_idx, k_jit, k_th, m, F):
    """inject_free_space's draws from its four keys, as numpy."""
    return (jax_uniform(k_sel, m),
            np.asarray(jax.random.randint(k_idx, (m,), 0, F)),
            np.asarray(jax.random.uniform(k_jit, (m, 2), jnp.float32, -0.5,
                                          0.5)),
            np.asarray(jax.random.uniform(k_th, (m, 1), jnp.float32, -np.pi,
                                          np.pi))[:, 0])


def test_inject_free_space_matches_jax():
    m, n = 256, 200
    parts = cloud(3, m)
    w = -np.random.default_rng(4).random(m).astype(np.float32)
    free = np.random.default_rng(5).uniform(0, 10, (300, 2)).astype(
        np.float32)
    key = jax.random.PRNGKey(9)
    k_sel, k_idx, k_jit, k_th = jax.random.split(key, 4)
    with jax.disable_jit():  # as inject_free_space scales them below
        draws = inject_draws(k_sel, k_idx, k_jit, k_th, m, 300)
    for p_inject in (0.0, 0.3, 1.0):
        with jax.disable_jit():
            jp, jw = jax_pf.inject_free_space(
                key, jnp.asarray(parts), jnp.asarray(w), jnp.int32(n),
                jnp.asarray(free), jnp.float32(0.05),
                jnp.float32(p_inject), m)
        op, ow = pf.inject_free_space(T(parts), T(w), n, T(free), 0.05,
                                      p_inject, *[T(d) for d in draws])
        np.testing.assert_array_equal(op.numpy(), np.asarray(jp))
        np.testing.assert_allclose(ow.numpy(), np.asarray(jw), rtol=1e-6)
        moved = (op.numpy() != parts).any(1)
        assert not moved[n:].any()
        if p_inject == 0.0:
            assert not moved.any()


# --- the fused step ---------------------------------------------------------
def box_matcher():
    """The JAX matcher over a 4-scan box-world map, and a query scan."""
    world = np.concatenate([sim.make_box_world(10.0, 8.0),
                            np.asarray([[[3.0, 0.0], [3.0, 3.0]]])], axis=0)
    m = jax_registry.create("ndt", MCFG, 12.0)
    poses = np.asarray([[x, y, 0.0] for x in (3.0, 7.0) for y in (3.0, 5.0)],
                       np.float32)
    pts, msk = zip(*[sim.project_scan(sim.scan_at_pose(
        world, p, n_beams=240, range_max=12.0, noise=0.005,
        rng=np.random.default_rng(i)), 512) for i, p in enumerate(poses)])
    m.add_scans(poses, np.stack(pts), np.stack(msk))
    q, qm = sim.project_scan(sim.scan_at_pose(
        world, np.asarray([5.0, 4.0, 0.1]), n_beams=240, range_max=12.0,
        noise=0.005, rng=np.random.default_rng(11)), 512)
    return m, q, qm


def step_args(m, q, qm, parts, n):
    grid = convert.grid_to_port(jax.device_get(m.grid), "cpu")
    return (T(parts), n, (0.05, 0.01, 0.02), MCFG, grid, T(q), T(qm),
            int(qm.sum()), (0.05,) * 4, 0.01, 2.3, BINS, 50)


def test_score_points_batch_rows_equal_single_pose():
    m, q, qm = box_matcher()
    grid = convert.grid_to_port(jax.device_get(m.grid), "cpu")
    poses = cloud(6, 64, center=(5.0, 4.0, 0.1), sigma=(0.02, 0.02, 0.01))
    n = int(qm.sum())
    batch = matcher.score_points_batch(MCFG, grid, T(q), T(qm), n, T(poses))
    for i in range(len(poses)):
        one = matcher.score_points_at_pose(MCFG, grid, T(q), T(qm), n,
                                           T(poses[i]))
        assert torch.equal(batch[i], one), i
    with jax.disable_jit():
        want = np.asarray(jax_matcher.score_points_batch(
            MCFG, m.grid, jnp.asarray(q), jnp.asarray(qm), jnp.int32(n),
            jnp.asarray(poses)))
    ok = same_trig(poses[:, 2])
    assert ok.mean() > 0.5
    np.testing.assert_allclose(batch.numpy()[ok], want[ok], rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(batch.numpy(), want, rtol=1e-3, atol=1e-6)
    assert float(batch.min()) < -0.05


def test_match_scan_with_score_matches_jax():
    m, q, qm = box_matcher()
    grid = convert.grid_to_port(jax.device_get(m.grid), "cpu")
    table = convert.table_to_port(jax.device_get(m.packed_table), "cpu")
    pose = np.asarray([5.02, 3.99, 0.1], np.float32)
    n = int(qm.sum())
    unc, score, corr, cov = matcher.match_scan_with_score(
        MCFG, grid, T(q), T(qm), n, T(pose), table)
    with jax.disable_jit():
        ju, js, jc, jv = jax_matcher.match_scan_with_score(
            MCFG, m.grid, jnp.asarray(q), jnp.asarray(qm), jnp.int32(n),
            jnp.asarray(pose), m.packed_table)
    assert float(unc) == pytest.approx(float(ju), abs=1e-6)
    assert float(score) == pytest.approx(float(js), rel=1e-5, abs=1e-5)
    np.testing.assert_array_equal(corr.numpy(), np.asarray(jc))
    d = np.sqrt(np.abs(np.diag(np.asarray(jv))))
    assert np.all(np.abs(cov.numpy() - np.asarray(jv))
                  <= 1e-4 * np.outer(d, d))
    assert float(score) < float(unc) < 0


def jax_step_draws(key, m):
    k1, k2 = jax.random.split(key)
    return k1, k2, pf.Draws(
        T(np.asarray(jax.random.normal(k1, (m, 3), jnp.float32))),
        T(jax_uniform(k2, m)))


@pytest.mark.parametrize("n", [256, 180])
def test_pf_step_matches_jax(n):
    m_, q, qm = box_matcher()
    mp = 256
    parts = cloud(8, mp, center=(5.0, 4.0, 0.1), sigma=(0.3, 0.3, 0.1))
    k1, k2, draws = jax_step_draws(jax.random.PRNGKey(3), mp)
    args = step_args(m_, q, qm, parts, n)
    out = pf.pf_step(draws, *args)
    with jax.disable_jit():
        jp, jw, jn, jm, jc = jax_pf.pf_step(
            k1, k2, jnp.asarray(parts), jnp.arange(mp) < n,
            jnp.asarray([0.05, 0.01, 0.02], jnp.float32), MCFG, m_.grid,
            jnp.asarray(q), jnp.asarray(qm), jnp.int32(int(qm.sum())),
            jnp.full(4, 0.05, jnp.float32), jnp.float32(0.01),
            jnp.float32(2.3), jnp.asarray(BINS), 50, mp)
    assert int(out.n[0]) == int(jn)
    np.testing.assert_array_equal(out.particles.numpy(), np.asarray(jp))
    assert_weights_close(out.weights.numpy(), jw, np.asarray(jp)[:, 2])
    assert_stats_close(out.mean, out.cov, jm, jc)
    assert abs(float(out.mean[0]) - 5.0) < 0.3


def recovery_inputs(m):
    key = jax.random.PRNGKey(9)
    k1, k2, k3 = jax.random.split(key, 3)
    k_sel, k_idx, k_jit, k_th = jax.random.split(k3, 4)
    free = np.stack(np.meshgrid(np.arange(0.5, 9.6, 0.5),
                                np.arange(0.5, 7.6, 0.5)), -1).reshape(-1, 2)
    free = free.astype(np.float32)
    with jax.disable_jit():
        inj = inject_draws(k_sel, k_idx, k_jit, k_th, m, len(free))
    draws = pf.Draws(
        T(np.asarray(jax.random.normal(k1, (m, 3), jnp.float32))),
        T(jax_uniform(k2, m)), *[T(d) for d in inj])
    return (k1, k2, k3), free, draws


@pytest.mark.parametrize("w_state", [(0.0, 0.0), (0.6, 0.2), (0.3, 0.5)])
def test_pf_step_recovery_matches_jax(w_state):
    m_, q, qm = box_matcher()
    mp = 256
    parts = cloud(9, mp, center=(5.0, 4.0, 0.1), sigma=(0.05, 0.05, 0.02))
    keys, free, draws = recovery_inputs(mp)
    args = step_args(m_, q, qm, parts, mp)
    out = pf.pf_step_recovery(draws, *args, T(free), 0.5,
                              torch.tensor(w_state), 0.1, 0.5)
    with jax.disable_jit():
        jp, jw, jn, jm, jc, ws, wf = jax_pf.pf_step_recovery(
            *keys, jnp.asarray(parts), jnp.ones(mp, bool),
            jnp.asarray([0.05, 0.01, 0.02], jnp.float32), MCFG, m_.grid,
            jnp.asarray(q), jnp.asarray(qm), jnp.int32(int(qm.sum())),
            jnp.full(4, 0.05, jnp.float32), jnp.float32(0.01),
            jnp.float32(2.3), jnp.asarray(BINS), 50, mp,
            jnp.asarray(free), jnp.float32(0.5), jnp.float32(w_state[0]),
            jnp.float32(w_state[1]), jnp.float32(0.1), jnp.float32(0.5))
    assert int(out.n[0]) == int(jn)
    np.testing.assert_allclose(out.w_state.numpy(), [float(ws), float(wf)],
                               rtol=1e-6)
    np.testing.assert_array_equal(out.particles.numpy(), np.asarray(jp))
    assert_weights_close(out.weights.numpy(), jw, np.asarray(jp)[:, 2])
    assert_stats_close(out.mean, out.cov, jm, jc)
    injected = np.hypot(*(out.particles.numpy()[:int(jn), :2]
                          - [5.0, 4.0]).T) > 1.0
    p_inject = max(0.0, 1.0 - float(wf) / float(ws))
    if p_inject == 0.0:
        assert not injected.any()
    else:  # a free cell within 1 m of the cloud is rare
        assert abs(injected.mean() - p_inject) < 0.15


def test_zero_injection_equals_pf_step():
    """tests/test_particle.py::test_zero_injection_bitwise_equals_pf_step:
    with w_fast >= w_slow the recovery step is pf_step bit for bit."""
    m_, q, qm = box_matcher()
    mp = 256
    parts = cloud(10, mp, center=(5.0, 4.0, 0.1))
    _, free, draws = recovery_inputs(mp)
    args = step_args(m_, q, qm, parts, mp)
    base = pf.pf_step(pf.Draws(draws.motion, draws.resample), *args)
    rec = pf.pf_step_recovery(draws, *args, T(free), 0.5,
                              torch.tensor([1.0, 1.0]), 0.0, 0.0)
    for a, b in zip(base[:4], rec[:4]):
        assert torch.equal(a, b)


def test_injection_fraction_matches_probability():
    """tests/test_particle.py::test_injection_fraction_matches_probability
    on the port's draws: w_fast / w_slow = 0.05 with frozen EWMAs
    replaces ~95% of the cloud."""
    m_, q, qm = box_matcher()
    mp = 2048
    parts = cloud(12, mp, center=(5.0, 4.0, 0.1), sigma=(0.05, 0.05, 0.02))
    gen = torch.Generator().manual_seed(2)
    free = np.stack(np.meshgrid(np.arange(0.5, 9.6, 0.5),
                                np.arange(0.5, 7.6, 0.5)), -1).reshape(-1, 2)
    draws = pf.draw_step(gen, mp, torch.device("cpu"), len(free))
    args = step_args(m_, q, qm, parts, mp)[:-1] + (200,)
    out = pf.pf_step_recovery(draws, *args, T(free.astype(np.float32)), 0.5,
                              torch.tensor([1.0, 0.05]), 0.0, 0.0)
    n = int(out.n[0])
    far = np.hypot(*(out.particles.numpy()[:n, :2] - [5.0, 4.0]).T) > 1.0
    assert 0.85 < far.mean() < 1.0
    assert float(out.w_state[0]) == 1.0
    assert abs(float(out.w_state[1]) - 0.05) < 1e-6


# --- the filter class -------------------------------------------------------
def _filter(seed=0, **kw):
    return pf.ParticleFilter(dataclasses.replace(CFG, **kw), seed=seed,
                             device="cpu")


def test_filter_init_statistics_and_circular_mean():
    """tests/test_particle.py::TestStatistics on the port's filter."""
    f = _filter()
    f.init(1.0, 2.0, 0.5, 0.2, 0.1, 0.05)
    np.testing.assert_allclose(f.get_mean(), [1.0, 2.0, 0.5], atol=0.08)
    cov = f.get_covariance()
    assert abs(cov[0, 0] - 0.04) < 0.02 and abs(cov[1, 1] - 0.01) < 0.008
    f.init(0.0, 0.0, np.pi, 0.01, 0.01, 0.1)
    assert abs(abs(f.get_mean()[2]) - np.pi) < 0.1
    wn, _, _ = pf.update_statistics(torch.zeros(4, 3),
                                    torch.tensor([-0.2, -0.4, -0.1, -0.3]), 4)
    assert float(wn.sum()) == pytest.approx(1.0, abs=1e-6)
    assert float(wn[1]) > float(wn[2])


def test_filter_resample_counts_and_mean():
    """tests/test_particle.py::TestResample on the port's filter: one bin
    fills to max_particles, a spread cloud needs more than the minimum,
    the mean is kept and all-on-one weights collapse the cloud."""
    f = _filter()
    f.init(0.0, 0.0, 0.0, 1e-4, 1e-4, 1e-4)
    f.resample()
    assert f.n_active == CFG.max_particles
    f = _filter()
    f.init(0.0, 0.0, 0.0, 3.0, 3.0, 1.0)
    f.resample()
    assert f.n_active > CFG.min_particles
    f = _filter()
    f.init(2.0, -1.0, 0.3, 0.3, 0.3, 0.1)
    before = f.get_mean()
    f.resample()
    np.testing.assert_allclose(before, f.get_mean(), atol=0.15)
    f = _filter()
    f.init(0.0, 0.0, 0.0, 1.0, 1.0, 0.5)
    f.weights = torch.zeros(CFG.max_particles)
    f.weights[0] = 1.0
    f.resample()
    c = f.cloud()
    assert np.allclose(c, c[0], atol=1e-6)


def test_filter_measure_pulls_toward_truth_and_granular_injects():
    """tests/test_particle.py::TestMeasurement and test_granular_path_
    injects on the port: measure + resample pulls the cloud to the true
    pose; with collapsed w_fast the granular resample injects."""
    m_, q, qm = box_matcher()
    port_m = matcher.NDTScanMatcher(MCFG, 12.0, device="cpu")
    port_m.grid = convert.grid_to_port(jax.device_get(m_.grid), "cpu")
    f = _filter(min_particles=200, max_particles=512)
    f.init(5.0, 4.0, 0.1, 0.5, 0.5, 0.2)
    f.measure(port_m, q, qm, int(qm.sum()))
    f.resample()
    assert abs(f.get_mean()[0] - 5.0) < 0.3
    assert abs(f.get_mean()[1] - 4.0) < 0.3
    free = np.stack(np.meshgrid(np.arange(0.5, 9.6, 0.5),
                                np.arange(0.5, 7.6, 0.5)), -1).reshape(-1, 2)
    g = _filter(seed=4, min_particles=200, max_particles=512,
                recovery_alpha_slow=1e-4, recovery_alpha_fast=1e-4)
    g.init(5.0, 4.0, 0.1, 0.05, 0.05, 0.02)
    g.set_free_space(free, 0.5)
    g.w_state = torch.tensor([1.0, 0.05])
    g.update(0.0, 0.0, 0.0)
    g.measure(port_m, q, qm, int(qm.sum()))
    g.resample()
    c = g.cloud()
    assert (np.hypot(c[:, 0] - 5.0, c[:, 1] - 4.0) > 1.0).mean() > 0.5


def test_filter_state_round_trip():
    jf = jax_pf.ParticleFilter(CFG, seed=1)
    jf.init(1.0, 2.0, 0.3, 0.2, 0.2, 0.1)
    state = {"particles": np.asarray(jf.particles),
             "weights": np.asarray(jf.weights), "n_active": jf.n_active,
             "mean": jf.get_mean(), "cov": jf.get_covariance(),
             "w_slow": np.float32(0.4), "w_fast": np.float32(0.2)}
    f = _filter()
    convert.filter_to_port(state, f)
    back = convert.filter_to_numpy(f)
    assert set(back) == set(convert.FILTER_FIELDS)
    for k in convert.FILTER_FIELDS:
        np.testing.assert_array_equal(np.asarray(back[k]),
                                      np.asarray(state[k], np.asarray(
                                          back[k]).dtype))
    # The JAX filter takes the port's state back and resamples from it.
    jf.particles = jnp.asarray(back["particles"])
    jf.weights = jnp.asarray(back["weights"])
    jf.n_active = back["n_active"]
    jf.resample()
    assert jf.n_active >= CFG.min_particles
