"""Plain-PyTorch reference of the pose-graph solve: Levenberg-Marquardt on
the robust least-squares cost of SE(2) relative-pose constraints.

The semantics are the configuration's ``solver`` (the mirror of the
upstream Ceres settings): the residual of a constraint (a -> b, measured
t) is R(-theta_a) (p_b - p_a) - t_xy and the wrapped angle difference
minus t_theta; its squared Mahalanobis norm s2 = r^T Lambda r is summed
as it is, or, on the switchable constraints, through the configured
robust loss (Huber: s2 up to delta^2, then delta (2 s - delta);
Geman-McClure: s2 / (1 + s2 / delta^2)), whose IRLS weights scale the
normal equations.  The first pose is held fixed.  Each iteration solves
the damped normal equations (H + lam diag(H)) dx = -g: by a dense
Cholesky factorization while three times the padded node count (a power
of two, at least 64) is within ``dense_size_limit``, else by block-Jacobi
preconditioned conjugate gradients from dx = 0 (the preconditioner the
inverse of each node's damped 3 x 3 diagonal block plus 1e-8 I), which
stops before a step once the residual's norm is within ``cg_tolerance``
or after ``cg_max_iterations`` steps.  A step is accepted when the cost
falls; lam scales by ``lm_lambda_down`` or ``lm_lambda_up`` (kept in
[1e-12, 1e8]); the solve stops after three iterations in a row that
accepted nothing or improved the cost by no more than ``tolerance`` of
it, or after ``max_iterations``.

Every multiplication goes through a ``Precision``: float64 is the
reference; ``tf32`` rounds both operands of each product to TF32's 10-bit
mantissa and adds in float32, the control that stands for a solve
computed one precision below the float32 the configuration states.

The comparison that decides ``correct`` is ``node_step`` at the
program's optimum (``solve_step``).  Nothing here imports the program:
the reference works from the inputs the benchmark hands both sides.
"""

from __future__ import annotations

import math

import numpy as np
import torch


class Precision:
    """The arithmetic of one reference run: its dtype and its product."""

    def __init__(self, name: str):
        if name not in ("f64", "tf32"):
            raise ValueError(f"unknown precision {name!r}")
        self.name = name
        self.dtype = torch.float64 if name == "f64" else torch.float32

    def round(self, x: torch.Tensor) -> torch.Tensor:
        """x as the operand of a product: TF32 keeps 10 mantissa bits
        (round to nearest, ties away), the others keep x."""
        if self.name != "tf32":
            return x
        bits = x.contiguous().view(torch.int32)
        bits = (bits + 0x1000) & ~0x1FFF
        return bits.view(torch.float32)

    def mul(self, a, b):
        return self.round(a) * self.round(b)

    def mm(self, a, b):
        """[..., 3, 3] @ [..., 3, 3] (or [..., 3, 1])."""
        return (self.round(a)[..., :, :, None]
                * self.round(b)[..., None, :, :]).sum(-2)


def wrap(a: torch.Tensor) -> torch.Tensor:
    """Angles to [-pi, pi)."""
    return a - 2.0 * math.pi * torch.floor((a + math.pi) / (2.0 * math.pi))


def residuals(P: Precision, x, begin, end, transform):
    """(r [C, 3], Ja, Jb [C, 3, 3])."""
    pa, pb = x[begin], x[end]
    dx, dy = pb[:, 0] - pa[:, 0], pb[:, 1] - pa[:, 1]
    c, s = torch.cos(pa[:, 2]), torch.sin(pa[:, 2])
    r = torch.stack([P.mul(c, dx) + P.mul(s, dy) - transform[:, 0],
                     -P.mul(s, dx) + P.mul(c, dy) - transform[:, 1],
                     wrap(pb[:, 2] - pa[:, 2] - transform[:, 2])], -1)
    zero, one = torch.zeros_like(c), torch.ones_like(c)
    ja = torch.stack([
        torch.stack([-c, -s, -P.mul(s, dx) + P.mul(c, dy)], -1),
        torch.stack([s, -c, -P.mul(c, dx) - P.mul(s, dy)], -1),
        torch.stack([zero, zero, -one], -1)], -2)
    jb = torch.stack([torch.stack([c, s, zero], -1),
                      torch.stack([-s, c, zero], -1),
                      torch.stack([zero, zero, one], -1)], -2)
    return r, ja, jb


def _s2(P: Precision, r, information):
    lr = P.mm(information, r[..., None])[..., 0]
    return (P.mul(r, lr)).sum(-1)


def _rho_and_weight(P: Precision, s2, robust, loss: str, delta: float):
    """Per-constraint cost rho(s2) and IRLS weight."""
    one = torch.ones_like(s2)
    if loss == "none":
        return s2, one
    d = torch.tensor(delta, dtype=s2.dtype, device=s2.device)
    if loss == "huber":
        s = torch.sqrt(torch.clamp(s2, min=1e-20))
        rho = torch.where(s > d, P.mul(d, 2.0 * s - d), s2)
        w = torch.where(s > d, d / s, one)
    elif loss == "geman_mcclure":
        t = one + s2 / P.mul(d, d)
        rho = s2 / t
        w = one / P.mul(t, t)
    else:
        raise ValueError(f"unknown robust loss {loss!r}")
    return torch.where(robust, rho, s2), torch.where(robust, w, one)


class Problem:
    """One pose graph, its tensors in a precision's dtype on a device."""

    def __init__(self, begin, end, transform, information, robust, loss,
                 delta, P: Precision, device):
        as_t = (lambda a, dt: torch.as_tensor(a).to(device=device,
                                                     dtype=dt))
        self.P = P
        self.begin = as_t(begin, torch.int64)
        self.end = as_t(end, torch.int64)
        self.transform = as_t(transform, P.dtype)
        self.information = as_t(information, P.dtype)
        self.robust = as_t(robust, torch.bool)
        self.loss, self.delta = loss, float(delta)
        self.device = device

    def cost(self, x) -> torch.Tensor:
        """The robust cost (0-d, in the working dtype)."""
        r = residuals(self.P, x, self.begin, self.end, self.transform)[0]
        s2 = _s2(self.P, r, self.information)
        rho, _ = _rho_and_weight(self.P, s2, self.robust, self.loss,
                                 self.delta)
        return rho.sum()

    def blocks(self, x):
        """Per constraint (Baa, Bab, Bbb [C, 3, 3]) of the weighted normal
        equations, and per node the gradient g [N, 3] and the block
        diagonal D [N, 3, 3]."""
        P, n = self.P, x.shape[0]
        r, ja, jb = residuals(P, x, self.begin, self.end, self.transform)
        s2 = _s2(P, r, self.information)
        _, w = _rho_and_weight(P, s2, self.robust, self.loss, self.delta)
        lw = self.information * w[:, None, None]
        lja, ljb = P.mm(lw, ja), P.mm(lw, jb)
        lr = P.mm(lw, r[..., None])[..., 0]
        jat, jbt = ja.transpose(1, 2), jb.transpose(1, 2)
        baa, bab, bbb = P.mm(jat, lja), P.mm(jat, ljb), P.mm(jbt, ljb)
        g = torch.zeros(n, 3, dtype=x.dtype, device=x.device)
        g.index_add_(0, self.begin, P.mm(jat, lr[..., None])[..., 0])
        g.index_add_(0, self.end, P.mm(jbt, lr[..., None])[..., 0])
        d = torch.zeros(n, 3, 3, dtype=x.dtype, device=x.device)
        d.index_add_(0, self.begin, baa)
        d.index_add_(0, self.end, bbb)
        return baa, bab, bbb, g, d

    def _dense(self, x, lam: float, free):
        n = x.shape[0]
        baa, bab, bbb, g, _ = self.blocks(x)
        h = torch.zeros(3 * n, 3 * n, dtype=x.dtype, device=x.device)
        k = torch.arange(3, device=x.device)
        nodes = (self.begin, self.end)
        for (i, j), b in {(0, 0): baa, (0, 1): bab,
                          (1, 0): bab.transpose(1, 2), (1, 1): bbb}.items():
            rows = (3 * nodes[i])[:, None, None] + k[None, :, None]
            cols = (3 * nodes[j])[:, None, None] + k[None, None, :]
            h.index_put_((rows.expand_as(b), cols.expand_as(b)), b,
                         accumulate=True)
        h.diagonal().add_(lam * torch.diagonal(h) + lam * 1e-12)
        f = (~free).repeat_interleave(3)
        h[f, :] = 0.0
        h[:, f] = 0.0
        h[f, f] = 1.0
        rhs = torch.where(f, torch.zeros_like(g.reshape(-1)), -g.reshape(-1))
        chol, info = torch.linalg.cholesky_ex(h)
        if int(info) != 0:
            return None
        return torch.cholesky_solve(rhs[:, None], chol).reshape(n, 3)

    def _pcg(self, x, lam: float, free, settings: dict):
        P = self.P
        baa, bab, bbb, g, d = self.blocks(x)
        fm = free.to(x.dtype)[:, None]
        eye = torch.eye(3, dtype=x.dtype, device=x.device)
        dd = d + lam * (d * eye) + 1e-8 * eye
        dd = torch.where(free[:, None, None], dd, eye)
        pinv = torch.linalg.inv(dd)
        dlam = lam * torch.diagonal(d, dim1=-2, dim2=-1)
        a, b = self.begin, self.end

        def matvec(v):
            v = v * fm
            va, vb = v[a], v[b]
            ya = (P.mm(baa, va[..., None])[..., 0]
                  + P.mm(bab, vb[..., None])[..., 0])
            yb = (P.mm(bab.transpose(1, 2), va[..., None])[..., 0]
                  + P.mm(bbb, vb[..., None])[..., 0])
            out = torch.zeros_like(v).index_add_(0, a, ya).index_add_(0, b, yb)
            return (out + P.mul(dlam, v)) * fm

        def prec(r):
            return P.mm(pinv, r[..., None])[..., 0] * fm

        def dot(u, v):
            return P.mul(u, v).sum()

        rhs = -g * fm
        dx = torch.zeros_like(rhs)
        r = rhs - matvec(dx)
        z = prec(r)
        p = z
        rz, rr = dot(r, z), dot(r, r)
        tol = float(settings["cg_tolerance"])
        for _ in range(int(settings["cg_max_iterations"])):
            if not float(torch.sqrt(rr)) > tol:
                break
            ap = matvec(p)
            alpha = rz / torch.clamp(dot(p, ap), min=1e-30)
            dx = dx + alpha * p
            r = r - alpha * ap
            z = prec(r)
            rz_new, rr = dot(r, z), dot(r, r)
            p = z + (rz_new / torch.clamp(rz, min=1e-30)) * p
            rz = rz_new
        return dx

    def step(self, x, lam: float, fixed: int, settings: dict):
        """The damped step from x by the configured linear solve, or None
        where a dense system is not positive definite."""
        n = x.shape[0]
        free = torch.ones(n, dtype=torch.bool, device=x.device)
        free[fixed] = False
        padded = max(64, 1 << (n - 1).bit_length())
        if 3 * padded <= int(settings["dense_size_limit"]):
            return self._dense(x, lam, free)
        return self._pcg(x, lam, free, settings)


def solve(problem: Problem, x0, settings: dict, fixed: int = 0):
    """Levenberg-Marquardt from x0 [N, 3] under ``settings`` (the
    configuration's solver object).  Returns (x, cost, iterations)."""
    x = torch.as_tensor(x0).to(device=problem.device,
                                dtype=problem.P.dtype).clone()
    lam = float(settings["lm_lambda_init"])
    down = float(settings["lm_lambda_down"])
    up = float(settings["lm_lambda_up"])
    tol = float(settings["tolerance"])
    cost = float(problem.cost(x))
    stall, it = 0, 0
    while it < int(settings["max_iterations"]) and stall < 3:
        dx = problem.step(x, lam, fixed, settings)
        new_cost = math.inf if dx is None else float(problem.cost(x + dx))
        accept = new_cost < cost
        improved = abs(cost - new_cost) > tol * (cost + 1e-12)
        lam = min(max(lam * (down if accept else up), 1e-12), 1e8)
        stall = 0 if (accept and improved) else stall + 1
        if accept:
            x = x + dx
            cost = new_cost
        it += 1
    return x, cost, it


def node_step(record: dict, answer, solver: dict, device) -> float:
    """The largest Gauss-Newton step one node would take alone toward the
    optimum (D_i^-1 g_i: its block of the gradient over its diagonal
    block, every other pose held), over the free nodes and the three
    components (metres, radians), at the poses ``answer`` [N, 3], in
    float64 on the configured cost.  0 at the optimum; a slow, global bend
    of the graph, which a float32 solve cannot resolve, moves it little,
    and every pose a solve leaves off balance with its neighbours moves
    it."""
    prob = Problem(record["begin"], record["end"], record["transform"],
                   record["information"], record["switchable"],
                   solver["robust_loss"], solver["huber_delta"],
                   Precision("f64"), device)
    x = torch.as_tensor(np.asarray(answer, np.float64)).to(device)
    _, _, _, g, d = prob.blocks(x)
    free = torch.ones(len(x), dtype=torch.bool, device=device)
    free[int(record.get("fixed", 0))] = False
    if not bool(free.any()):
        return 0.0
    step = torch.linalg.solve(d[free], g[free][..., None])[..., 0]
    value = float(step.abs().max())
    return value if math.isfinite(value) else math.inf


def solve_step(record: dict, solver: dict, device,
               control: bool = False) -> float:
    """``node_step`` of a recorded solve's optimum; with ``control`` of
    the TF32 reference's optimum from the same inputs."""
    if control:
        prob = Problem(record["begin"], record["end"], record["transform"],
                       record["information"], record["switchable"],
                       solver["robust_loss"], solver["huber_delta"],
                       Precision("tf32"), device)
        answer = solve(prob, record["poses_in"], solver,
                       record.get("fixed", 0))[0].double().cpu().numpy()
    else:
        answer = record["poses_out"]
    return node_step(record, answer, solver, device)
