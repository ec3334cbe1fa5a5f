"""K4's PCG normal system (``kernels/normal_blocks.py::pcg_normal_system``,
``PcgPlan``, ``preconditioner``) on the CPU, where the wrappers run the
twins.

The CUDA launch runs only on the card, where ``chip_smoke.py`` holds it
bitwise against ``pcg_normal_system_twin`` on the 50,000-node district.
Here, on seeded graphs (random SPD information, masked constraints, a
padded node with no live constraint, a fixed node):

* the fused twin's Baa, Bab, Bbb and D are ``normal_blocks_twin``'s, bit
  for bit, for each robust loss, and b is -g fm;
* its pinv is ``matching.newton.solve3`` of the unit vectors against the
  damped block (JAX's expressions), bit for bit, and within 9 cond(dd)
  eps_f32 of the block's largest entry of op-by-op JAX's
  ``jnp.linalg.inv`` of the same block (two float32 inverses, the 3 x 3
  LU and LAPACK's, part by about the block's condition number in ulps;
  measured here up to 0.7 of cond eps);
* a NaN pose gives NaN where it reaches and raises nothing;
* the solver's one-device PCG iteration is one ``pcg_normal_system`` call
  (through ``PcgPlan``) and no library inverse; a one-rank mesh's (the
  identity as the combine) forms its preconditioner with
  ``k4.preconditioner`` after the combine, bitwise the fused one, and its
  solve is bitwise one device's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ndt_2d_tpu_torch.config import SolverConfig
from ndt_2d_tpu_torch.graph import solver
from ndt_2d_tpu_torch.kernels import normal_blocks as k4
from ndt_2d_tpu_torch.matching.newton import solve3

torch.set_num_threads(2)

LOSSES = ("none", "huber", "geman_mcclure")


def random_graph(n=40, c=70, seed=0, masked=5):
    """A seeded graph of n nodes (the last one padding: no constraint
    reaches it) and c constraints (chain, then random closures; ``masked``
    of them masked, every third closure robust), SPD information of
    several scales, noisy poses."""
    rng = np.random.default_rng(seed)
    live = n - 1
    begin = np.concatenate([np.arange(live - 1),
                            rng.integers(0, live, c - (live - 1))])
    end = np.concatenate([np.arange(1, live),
                          rng.integers(0, live, c - (live - 1))])
    end = np.where(end == begin, (end + 1) % live, end)
    poses = np.zeros((n, 3), np.float32)
    poses[:live] = np.stack([np.arange(live) * 1.0, rng.normal(0, 0.5, live),
                             rng.uniform(-np.pi, np.pi, live)], -1)
    d = poses[end, :2] - poses[begin, :2]
    cs, sn = np.cos(poses[begin, 2]), np.sin(poses[begin, 2])
    transform = np.stack([cs * d[:, 0] + sn * d[:, 1],
                          -sn * d[:, 0] + cs * d[:, 1],
                          poses[end, 2] - poses[begin, 2]], -1)
    transform = transform + rng.normal(0, 0.05, transform.shape)
    m = rng.normal(0, 1, (c, 3, 3))
    info = (m @ m.transpose(0, 2, 1) + np.eye(3) * 0.5) \
        * 10.0 ** rng.integers(0, 3, (c, 1, 1))
    cmask = np.ones(c, bool)
    cmask[rng.choice(c, masked, replace=False)] = False
    robust = np.zeros(c, bool)
    robust[live - 1::3] = True
    poses[:live] += rng.normal(0, [0.1, 0.1, 0.02], (live, 3)).astype(
        np.float32)
    return dict(poses=torch.from_numpy(poses),
                begin=torch.from_numpy(begin.astype(np.int32)),
                end=torch.from_numpy(end.astype(np.int32)),
                transform=torch.from_numpy(transform.astype(np.float32)),
                information=torch.from_numpy(info.astype(np.float32)),
                constraint_mask=torch.from_numpy(cmask),
                robust_mask=torch.from_numpy(robust),
                node_mask=torch.from_numpy(np.arange(n) < live))


def system_args(t, loss, lam, fixed=0):
    n = t["poses"].shape[0]
    inc = k4.incidence(t["begin"], t["end"], t["constraint_mask"], n)
    fm = (t["node_mask"] & (torch.arange(n) != fixed)).float()
    args = (t["poses"], t["begin"], t["end"], t["transform"],
            t["information"], t["constraint_mask"], t["robust_mask"], loss,
            1.0, inc)
    return args, torch.tensor(lam, dtype=torch.float32), fm


def damped(diag, lam, fm):
    """JAX's damped block (solver.py:197-199) in torch, op by op."""
    eye = torch.eye(3)
    dd = diag + lam * (diag * eye) + 1e-8 * eye
    return dd + (1.0 - fm)[:, None, None] * eye


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("loss", LOSSES)
def test_fused_twin_is_normal_blocks_then_the_preconditioner(loss, seed):
    t = random_graph(seed=seed)
    args, lam, fm = system_args(t, loss, 1e-3)
    baa, bab, bbb, d, pinv, b = k4.pcg_normal_system_twin(*args, lam, fm)
    ref = k4.normal_blocks_twin(*args)
    for got, want in zip((baa, bab, bbb, d), ref[:3] + ref[6:]):
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    g = ref[5]
    assert torch.equal(b, -g * fm[:, None])
    # The wrapper on CPU tensors is the twin.
    again = k4.pcg_normal_system(*args, lam, fm)
    for x, y in zip(again, (baa, bab, bbb, d, pinv, b)):
        assert torch.equal(x, y)


@pytest.mark.parametrize("lam", [1e-12, 1e-3, 1e4])
def test_pinv_is_solve3_of_the_unit_vectors(lam):
    t = random_graph(seed=2)
    args, lam_t, fm = system_args(t, "huber", lam)
    _, _, _, d, pinv, _ = k4.pcg_normal_system_twin(*args, lam_t, fm)
    dd = damped(d, lam_t, fm)
    rows = [[dd[:, i, j] for j in range(3)] for i in range(3)]
    n = dd.shape[0]
    for j in range(3):
        unit = [torch.full((n,), float(i == j)) for i in range(3)]
        col = solve3(rows, unit)
        for i in range(3):
            assert torch.equal(pinv[:, i, j].view(torch.int32),
                               col[i].view(torch.int32))


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("lam", [1e-6, 1e-3, 10.0])
def test_pinv_matches_op_by_op_jax_inverse(seed, lam):
    t = random_graph(seed=seed)
    args, lam_t, fm = system_args(t, "geman_mcclure", lam)
    _, _, _, d, pinv, _ = k4.pcg_normal_system_twin(*args, lam_t, fm)
    with jax.disable_jit():
        diag = jnp.asarray(d.numpy())
        eye = jnp.eye(3, dtype=jnp.float32)
        dd = diag + jnp.float32(lam) * (diag * eye) + 1e-8 * eye
        ref = np.asarray(jnp.linalg.inv(
            dd + (1.0 - jnp.asarray(fm.numpy())[:, None, None]) * eye))
    # Two float32 inverses of one block part by about its condition number
    # times float32's epsilon, relative to its largest entry (3 x 3 LU and
    # LAPACK's getrf + getri: a bound of 3 n = 9 times that).
    cond = np.linalg.cond(np.asarray(dd, np.float64) + (
        1.0 - fm.numpy()[:, None, None]) * np.eye(3))
    tol = 9.0 * cond * np.finfo(np.float32).eps
    ours = pinv.numpy()
    scale = np.abs(ref).max(axis=(1, 2))
    assert np.all(np.abs(ours - ref).max(axis=(1, 2)) <= tol * scale)


def test_fixed_node_empty_node_and_nan_pose():
    t = random_graph(seed=4)
    n = t["poses"].shape[0]
    args, lam, fm = system_args(t, "none", 1e-3, fixed=5)
    _, _, _, d, pinv, b = k4.pcg_normal_system_twin(*args, lam, fm)
    # The padded node: no live constraint, D = 0, so dd = 1e-8 I + I (not
    # free) and pinv its exact inverse; b = -0 fm = 0.
    assert not bool(d[n - 1].any())
    one = torch.tensor(1.0, dtype=torch.float32) + 1e-8
    assert torch.equal(pinv[n - 1], torch.eye(3) / one)
    assert not bool(b[n - 1].any())
    # The fixed node: the identity added, b zero.
    dd = damped(d, lam, fm)
    assert torch.equal(dd[5], d[5] + lam * (d[5] * torch.eye(3))
                       + 1e-8 * torch.eye(3) + torch.eye(3))
    assert not bool(b[5].any())
    assert bool(torch.isfinite(pinv).all())
    # A NaN pose: NaN in the residuals of its constraints (so in g at both
    # ends) and in the Jacobians' dx, dy (so in D at their begin nodes);
    # pinv is NaN exactly where D is, b where g is, the rest unchanged, and
    # nothing raises (torch.linalg.inv would raise on a block it found
    # singular).
    poses = t["poses"].clone()
    poses[7, 0] = float("nan")
    bad = (poses,) + args[1:]
    _, _, _, d2, pinv2, b2 = k4.pcg_normal_system_twin(*bad, lam, fm)
    g2 = k4.normal_blocks_twin(*bad)[5]
    d_nan = torch.isnan(d2).any(dim=(1, 2))
    assert bool(d_nan.any())
    assert torch.equal(torch.isnan(pinv2).any(dim=(1, 2)), d_nan)
    # (b = -g fm is NaN at a fixed node too: NaN times 0, as in JAX.)
    g_nan = torch.isnan(g2).any(dim=1)
    assert torch.equal(torch.isnan(b2).any(dim=1), g_nan)
    keep = ~(d_nan | torch.isnan(g2).any(dim=1))
    assert torch.equal(pinv2[keep], pinv[keep])
    assert torch.equal(b2[keep], b[keep])
    pinv3, _ = k4.preconditioner(g2, d2, lam, fm)
    assert torch.equal(pinv3.isnan(), pinv2.isnan())


@pytest.mark.parametrize("loss", LOSSES)
def test_standalone_preconditioner_is_the_fused_one(loss):
    t = random_graph(seed=5)
    args, lam, fm = system_args(t, loss, 0.1)
    _, _, _, d, pinv, b = k4.pcg_normal_system_twin(*args, lam, fm)
    g = k4.normal_blocks_twin(*args)[5]
    for fn in (k4.preconditioner, k4.preconditioner_twin):
        p2, b2 = fn(g, d, lam, fm)
        assert torch.equal(p2, pinv) and torch.equal(b2, b)
    p3, b3 = solver._preconditioner(g, d, lam, fm.bool())
    assert torch.equal(p3, pinv) and torch.equal(b3, b)


def test_plan_is_the_wrapper_and_checks_its_tensors():
    t = random_graph(seed=6)
    args, lam, fm = system_args(t, "huber", 1e-2)
    state = k4.lm_state(t["poses"], 1e-2, torch.tensor(1.0),
                        t["begin"].shape[0])
    terms = args[1:9]
    inc = args[9]
    for twin in (False, True):
        plan = k4.PcgPlan(state, *terms, inc, fm, twin)
        got = plan.system()
        want = k4.pcg_normal_system(state.poses, *terms, inc, state.lam, fm)
        for x, y in zip(got, want):
            assert torch.equal(x, y)
    with pytest.raises((TypeError, ValueError)):
        k4.PcgPlan(state, t["begin"].long(), *terms[1:], inc, fm)
    with pytest.raises((TypeError, ValueError)):
        k4.PcgPlan(state, *terms, inc, fm.double())
    wide = k4.incidence(t["begin"], t["end"], t["constraint_mask"],
                        t["poses"].shape[0] + 1)
    with pytest.raises(ValueError):
        k4.PcgPlan(state, *terms, wide, fm)


class Calls:
    """Counts K4's calls in a solve (its wrappers and the plan's system)
    and refuses a library inverse."""

    NAMES = ("normal_blocks", "pcg_normal_system", "preconditioner",
             "pcg_solve", "mesh_cg", "lm_step")

    def __init__(self, monkeypatch):
        self.calls = {}
        self.seen = {}
        for name in self.NAMES:
            monkeypatch.setattr(k4, name, self.wrap(name, getattr(k4, name)))

        def refuse(*a, **k):
            raise AssertionError("a library inverse in the LM loop")
        monkeypatch.setattr(torch.linalg, "inv", refuse)

    def wrap(self, name, real):
        def call(*args, **kwargs):
            self.calls[name] = self.calls.get(name, 0) + 1
            out = real(*args, **kwargs)
            self.seen.setdefault(name, []).append((args, out))
            return out
        return call


@pytest.mark.parametrize("loss", LOSSES)
def test_one_device_pcg_iteration_is_one_fused_call(monkeypatch, loss):
    t = random_graph(seed=7)
    cfg = SolverConfig(robust_loss=loss)
    calls = Calls(monkeypatch)
    res = solver.solve(cfg, **t, use_dense=False)
    it = int(res.iterations)
    assert it >= 2 and bool(res.success)
    assert calls.calls == {"pcg_normal_system": it, "pcg_solve": it,
                           "lm_step": it}


@pytest.mark.parametrize("loss", ["none", "geman_mcclure"])
def test_one_rank_mesh_preconditions_after_the_combine(monkeypatch, loss):
    t = random_graph(seed=8)
    cfg = SolverConfig(robust_loss=loss)
    one = Calls(monkeypatch)
    single = solver.solve(cfg, **t, use_dense=False)
    fused = [out[4:] for _, out in one.seen["pcg_normal_system"]]
    mesh_calls = Calls(monkeypatch)
    monkeypatch.setattr(solver, "_constraint_shard",
                        lambda mesh, arrays: (list(arrays), lambda x: x))
    mesh = solver.solve(cfg, **t, use_dense=False, mesh=object())
    it = int(mesh.iterations)
    assert mesh_calls.calls == {"normal_blocks": it, "preconditioner": it,
                                "mesh_cg": it, "lm_step": it}
    assert it == int(single.iterations)
    for (_, got), want in zip(mesh_calls.seen["preconditioner"], fused):
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert torch.equal(mesh.poses, single.poses)
