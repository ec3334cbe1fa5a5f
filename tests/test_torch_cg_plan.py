"""The mesh's CG loop on the H100 (``kernels/normal_blocks.py``:
``fixed_dots``, ``pcg_matvec``, ``CgPlan``, ``mesh_cg``).  The kernels run
only on the card, where ``chip_smoke.py`` holds each launch bitwise against
the twins; here numpy float32 models of their designs are held bitwise
(``view(np.int32)``) against the twins:

* the dots' ordinary launch: 64 blocks, each a group of 32 lanes adding its
  rows in index order from +0, finishing in any order; the last block to
  take a ticket folds the 2048 lanes in the halving tree.  Against
  ``fixed_dot_twin`` at 300, 2048, 6149 and 150,000 elements.
* variant (A): Ap damped element by element from the combined partial,
  then p . Ap and alpha;
  variant (B): x, r, z element by element (each element forming its node's
  whole r from the previous buffer), then r . z, r . r, beta and the stop
  flag.  Against ``pcg_loop``'s eager expressions.
* the matvec's pair walk: a thread a node over its (constraint, other
  node) lists, plain and with the direction formed in its loader, against
  ``pcg_matvec_twin`` on a chain, a hub, a 400-node serpentine, masked
  constraints, fixed nodes, empty lists and one rank's half of the
  constraints.

Then ``mesh_cg`` and the plan on the CPU (the plan's launches run the
twins into its buffers) with an identity and a two-shard combine, bitwise
``pcg_loop`` and the mesh branch as ``_pcg_solve`` ran it before the plan;
the plan's checks and ctypes layouts; the loop's dispatch (three launches,
the combine and one read a step, no other tensor operation); and the
incidence tables the twins read, built only when they read them.

Tolerance: none (bitwise), except where the two-shard loop is compared
with one device's, whose partial sums add in another order (1e-4 of the
largest step).
"""

import ctypes

import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

from ndt_2d_tpu_torch.graph import solver
from ndt_2d_tpu_torch.kernels import normal_blocks as k4
from ndt_2d_tpu_torch.kernels import shard_combine

torch.set_num_threads(2)

F = np.float32
L = k4.DOT_LANES
GROUPS = L // 32  # the launch's blocks


def bits(x):
    return np.ascontiguousarray(np.asarray(x, F)).view(np.int32)


def same(model, twin) -> bool:
    """The same float32 bits, element for element in index order."""
    return np.array_equal(bits(model).reshape(-1),
                          bits(twin.detach().numpy()).reshape(-1))


def max_keep_nan(a, b):
    return a if a != a else (a if a > b else b)


def model_dots(xs, ys, seed=0):
    """The dots' launch: a block a group of 32 lanes (finishing in a
    shuffled order), lane l adding the products l, l + L, ... from +0; the
    last block folds each dot's lanes in the halving tree."""
    rng = np.random.default_rng(seed)
    lanes = [np.zeros(L, F) for _ in xs]
    for grp in rng.permutation(GROUPS):
        for d, (x, y) in enumerate(zip(xs, ys)):
            prod = (x.reshape(-1).astype(F) * y.reshape(-1).astype(F))
            rows = max(1, -(-prod.size // L))
            prod = np.pad(prod, (0, rows * L - prod.size)).reshape(rows, L)
            acc = np.zeros(32, F)
            for r in range(rows):
                acc = (acc + prod[r, 32 * grp:32 * grp + 32]).astype(F)
            lanes[d][32 * grp:32 * grp + 32] = acc
    out = []
    for acc in lanes:
        h = L // 2
        while h:
            acc = (acc[:h] + acc[h:2 * h]).astype(F)
            h //= 2
        out.append(acc[0])
    return out


def sample(n, seed):
    """Values over six decades with exact zeros of both signs."""
    rng = np.random.default_rng(seed)
    x = (rng.normal(0, 1, n) * 10.0 ** rng.integers(-3, 4, n)).astype(F)
    y = rng.normal(0, 1, n).astype(F)
    x[::97] = 0.0
    y[5::89] = -0.0
    return x, y


@pytest.mark.parametrize("n", [300, L, 6149, 150_000])
def test_dots_last_block_fold_is_the_twin(n):
    x, y = sample(n, n)
    (ours,) = model_dots([x], [y], seed=n)
    assert same(ours, k4.fixed_dot_twin(torch.from_numpy(x),
                                        torch.from_numpy(y)))


def test_two_dots_in_one_launch():
    x, y = sample(6149, 1)
    rz, rr = model_dots([x, x], [y, x], seed=3)
    t = torch.from_numpy
    twin = k4.fixed_dots_twin((t(x), t(y)), (t(x), t(x)))
    assert same(rz, twin[0]) and same(rr, twin[1])


# --- Graphs --------------------------------------------------------------


def build(n, pairs, seed, masked=(), fixed=(0,)):
    """The blocks of one LM step over constraints ``pairs`` of n nodes:
    (begin, end, baa, bab, bbb, g, diag, lam, fm, cmask)."""
    rng = np.random.default_rng(seed)
    C = len(pairs)
    begin = torch.tensor([a for a, _ in pairs], dtype=torch.int32)
    end = torch.tensor([b for _, b in pairs], dtype=torch.int32)
    poses = torch.from_numpy(np.c_[rng.normal(0, 3, (n, 2)),
                                   rng.uniform(-3, 3, n)].astype(F))
    transform = torch.from_numpy(np.c_[rng.normal(0, 1, (C, 2)),
                                       rng.uniform(-1, 1, C)].astype(F))
    a = rng.normal(0, 1, (C, 3, 3))
    info = torch.from_numpy((a @ a.transpose(0, 2, 1)
                             + 3 * np.eye(3)).astype(F))
    cmask = torch.ones(C, dtype=torch.bool)
    cmask[list(masked)] = False
    inc = k4.incidence(begin, end, cmask, n)
    baa, bab, bbb, _, _, g, diag = k4.normal_blocks_twin(
        poses, begin, end, transform, info, cmask,
        torch.zeros(C, dtype=torch.bool), "none", 1.0, inc)
    fm = torch.ones(n)
    fm[list(fixed)] = 0.0
    return begin, end, baa, bab, bbb, g, diag, torch.tensor(1e-3), fm, cmask


def serpentine(n=400, seed=0):
    side = int(np.sqrt(n))
    rng = np.random.default_rng(seed)
    pairs = [(k, k + 1) for k in range(n - 1)]
    pairs += [(k + side, k) for k in range(n - side) if rng.random() < 0.1]
    return pairs


GRAPHS = {
    "chain": lambda: build(16, [(k, k + 1) for k in range(15)], 1),
    "hub": lambda: build(40, [(0, k) for k in range(1, 40)]
                         + [(k, 0) for k in range(5, 40, 7)], 2),
    "serpentine-400": lambda: build(400, serpentine(), 3),
    "masked": lambda: build(24, [(k, k + 1) for k in range(23)]
                            + [(3, 17), (9, 2), (3, 17)], 4,
                            masked=(1, 5, 24)),
    "fixed nodes": lambda: build(24, [(k, k + 1) for k in range(23)]
                                 + [(0, 12), (12, 20)], 5,
                                 fixed=(0, 7, 8, 23)),
    "empty lists": lambda: build(30, [(k, k + 1) for k in range(19)]
                                 + [(2, 2), (4, 11)], 6),
}


def halves(pairs):
    return pairs[:len(pairs) // 2], pairs[len(pairs) // 2:]


GRAPHS["one rank's half"] = lambda: build(400, halves(serpentine())[0], 3)


# --- The matvec's pair walk ----------------------------------------------


def bx(B, x):
    return ((B[:, 0] * x[0] + B[:, 1] * x[1]) + B[:, 2] * x[2]).astype(F)


def btx(B, x):
    return ((B[0, :] * x[0] + B[1, :] * x[1]) + B[2, :] * x[2]).astype(F)


def model_matvec(inc, baa, bab, bbb, diag, lam, fm, v, z=None, beta=None):
    """A thread a node over its (constraint, other node) pair lists; with
    z, v the previous direction: each read of a node's v is z + beta p,
    and the node writes its own.  Returns (y, p or None)."""
    baa, bab, bbb, diag, fm = (t.numpy() for t in (baa, bab, bbb, diag, fm))
    v = v.numpy()
    if z is not None:
        v = (z.numpy() + F(beta) * v).astype(F)
    N = fm.shape[0]
    bp, ep = inc.b_ptr.numpy(), inc.e_ptr.numpy()
    bq, eq = inc.b_pair.numpy(), inc.e_pair.numpy()
    y = np.zeros((N, 3), F)
    for n in range(N):
        vn = (v[n] * fm[n]).astype(F)
        sa = np.zeros(3, F)
        for k, o in bq[bp[n]:bp[n + 1]]:
            vo = (v[o] * fm[o]).astype(F)
            sa = (sa + (bx(baa[k], vn) + bx(bab[k], vo))).astype(F)
        sb = np.zeros(3, F)
        for k, o in eq[ep[n]:ep[n + 1]]:
            vo = (v[o] * fm[o]).astype(F)
            sb = (sb + (btx(bab[k], vo) + bx(bbb[k], vn))).astype(F)
        di = (np.diagonal(diag[n]) * vn).astype(F)
        y[n] = (((sa + sb) + F(lam) * di) * fm[n]).astype(F)
    return y, (v if z is not None else None)


@pytest.mark.parametrize("graph", list(GRAPHS))
def test_matvec_pair_walk_is_the_twin(graph):
    begin, end, baa, bab, bbb, _, diag, lam, fm, cmask = GRAPHS[graph]()
    N = fm.shape[0]
    inc = k4.incidence(begin, end, cmask, N)
    rng = np.random.default_rng(7)
    p, z = (torch.from_numpy(rng.normal(0, 1, (N, 3)).astype(F))
            for _ in range(2))
    beta = torch.tensor(0.37)
    zero = torch.zeros(())
    for l in (lam, zero):  # one device's damped product, a rank's partial
        mv = (begin, end, baa, bab, bbb, diag, l, fm)
        y, _ = model_matvec(inc, baa, bab, bbb, diag, l, fm, p)
        assert same(y, k4.pcg_matvec_twin(*mv, p, inc))
        assert same(y, k4.pcg_matvec(*mv, p, inc))
        y, pn = model_matvec(inc, baa, bab, bbb, diag, l, fm, p, z, beta)
        direction = z + beta * p  # pcg_loop's update
        assert same(pn, direction)
        assert same(y, k4.pcg_matvec_twin(*mv, direction, inc))


def test_pairs_are_each_entrys_constraint_and_other_node():
    begin, end, *_, cmask = GRAPHS["masked"]()
    inc = k4.incidence(begin, end, cmask, 24)
    assert torch.equal(inc.b_pair[:, 0], inc.b_idx)
    assert torch.equal(inc.b_pair[:, 1], end[inc.b_idx.long()])
    assert torch.equal(inc.e_pair[:, 1], begin[inc.e_idx.long()])
    assert inc.b_pair.dtype == torch.int32 and inc.b_pair.is_contiguous()


# --- The two dot variants ------------------------------------------------


def model_damp(part, p, diag, lam, fm, rz):
    """Variant (A) element by element (element e of node e // 3)."""
    part, p = part.numpy().reshape(-1), p.numpy().reshape(-1)
    n = np.arange(part.size) // 3
    f = fm.numpy()[n]
    d = diag.numpy().reshape(-1, 9)[n, 4 * (np.arange(part.size) % 3)]
    ap = ((part + F(lam) * (d * (p * f))) * f).astype(F)
    (pap,) = model_dots([p], [ap])
    return ap, pap, F(rz) / max_keep_nan(pap, F(1e-30))


def model_update(r_in, ap, alpha, x, p, pinv, fm, rz, tol, first):
    """Variant (B) element by element: element e forms its node's whole r
    from r_in (the twin's previous r; b on the first launch), then its z."""
    r_in, ap, x, p = (t.numpy() for t in (r_in, ap, x, p))
    pinv, fm = pinv.numpy(), fm.numpy()
    N = fm.shape[0]
    rn = (r_in - ap if first else r_in - F(alpha) * ap).astype(F)
    e = np.arange(3 * N)
    n, c = e // 3, e % 3
    m = pinv[n, c]  # row c of node n's block
    z = ((((m[:, 0] * rn[n, 0] + m[:, 1] * rn[n, 1]) + m[:, 2] * rn[n, 2]))
         * fm[n]).astype(F)
    r = rn.reshape(-1)
    if not first:
        x = (x + F(alpha) * p).astype(F)
    rz_new, rr = model_dots([r, r], [z, r])
    beta = None if first else rz_new / max_keep_nan(F(rz), F(1e-30))
    return x, r, z, rz_new, rr, beta, np.sqrt(rr) > F(tol)


def step_inputs(graph="serpentine-400"):
    begin, end, baa, bab, bbb, g, diag, lam, fm, cmask = GRAPHS[graph]()
    pinv, b = solver._preconditioner(g, diag, lam, fm.bool())
    inc = k4.incidence(begin, end, cmask, fm.shape[0])
    return begin, end, baa, bab, bbb, diag, lam, fm, pinv, b, inc


@pytest.mark.parametrize("graph", ["serpentine-400", "fixed nodes"])
def test_variant_a_is_the_loops_damping_and_alpha(graph):
    begin, end, baa, bab, bbb, diag, lam, fm, pinv, b, inc = step_inputs(
        graph)
    rng = np.random.default_rng(9)
    part, p = (torch.from_numpy(rng.normal(0, 1, b.shape).astype(F))
               for _ in range(2))
    rz = torch.tensor(2.5)
    ap, pap, alpha = k4.cg_damp_twin(part, p, diag, lam, fm, rz)
    mp, mpap, malpha = model_damp(part, p, diag, lam, fm, rz)
    assert same(mp, ap) and same(mpap, pap) and same(malpha, alpha)
    # _pcg_solve's mesh branch before the plan.
    dii = torch.diagonal(diag, dim1=-2, dim2=-1)
    loop = (part + lam * (dii * (p * fm[:, None]))) * fm[:, None]
    assert same(mp.reshape(-1, 3), loop)
    tiny = torch.tensor(1e-30)
    assert same(malpha, rz / torch.maximum(k4.fixed_dots_twin((p, ap))[0],
                                           tiny))


@pytest.mark.parametrize("first", [True, False], ids=["start", "step"])
def test_variant_b_is_the_loops_update(first):
    begin, end, baa, bab, bbb, diag, lam, fm, pinv, b, inc = step_inputs()
    rng = np.random.default_rng(11)
    r, ap, x, p = (torch.from_numpy(rng.normal(0, 1, b.shape).astype(F))
                   for _ in range(4))
    alpha, rz = torch.tensor(0.21), torch.tensor(3.0)
    twin = k4.cg_update_twin(b if first else r, ap, alpha, x, p, pinv, fm,
                             rz, 1e-6, first)
    model = model_update(b if first else r, ap, alpha, x, p, pinv, fm, rz,
                         1e-6, first)
    for m, t in zip(model[:5], twin[:5]):
        assert same(m, t.reshape(-1) if m.ndim == 1 else t)
    assert (model[5] is None) == first and (first or same(model[5], twin[5]))
    assert bool(model[6]) == bool(twin[6])
    # pcg_loop's expressions.
    rr = r - alpha * ap if not first else b - ap
    zz = k4._mv(pinv, rr) * fm[:, None]
    assert same(model[2], zz.reshape(-1)) and same(model[1], rr.reshape(-1))


# --- The loop ------------------------------------------------------------


def parent_mesh_branch(args, combine):
    """``_pcg_solve``'s mesh branch as it ran before the plan: the host loop
    over the rank's undamped ``pcg_matvec``, the combine, the damping, and
    ``fixed_dots``."""
    begin, end, baa, bab, bbb, diag, lam, fm, pinv, b, mi, tol, inc = args
    zero = torch.tensor(0.0)
    dii = torch.diagonal(diag, dim1=-2, dim2=-1)

    def matvec(v):
        part = k4.pcg_matvec(begin, end, baa, bab, bbb, diag, zero, fm, v,
                             inc)
        return (combine(part) + lam * (dii * (v * fm[:, None]))) \
            * fm[:, None]
    return k4.pcg_loop(matvec, k4.fixed_dots, pinv, fm, b, mi, tol)


def loop_args(graph, max_iter=60, tol=1e-6):
    begin, end, baa, bab, bbb, diag, lam, fm, pinv, b, inc = step_inputs(
        graph)
    return (begin, end, baa, bab, bbb, diag, lam, fm, pinv, b, max_iter, tol,
            inc)


def plan_of(args):
    begin, end, baa, bab, bbb, diag, lam, fm, pinv, b, mi, tol, inc = args
    return k4.CgPlan(begin, end, baa, bab, bbb, diag, lam, fm, pinv, b, inc,
                     tol)


@pytest.mark.parametrize("graph", ["chain", "serpentine-400", "fixed nodes"])
def test_plan_is_the_loop_with_an_identity_combine(graph):
    args = loop_args(graph)

    def combine(part):
        return part
    x, it = k4.mesh_cg(*args, combine=combine)
    px, pit = plan_of(args).run(combine, args[10])
    assert it == pit and same(px.numpy(), x)
    ox, oit = parent_mesh_branch(args, combine)
    assert oit == it and same(ox.numpy(), x)
    # One device's loop on the same system: pcg_solve's twin.
    sx, sit = k4.pcg_solve_twin(*args)
    assert torch.equal(x, sx) and it == int(sit)


def test_plan_is_the_loop_with_a_two_shard_combine(monkeypatch):
    """Rank 0 of two: its half of the serpentine's constraints, the other
    rank's partial formed from the same product's v and added in rank
    order (``rank_sum``)."""
    pairs = serpentine()
    n, c = 400, len(pairs) // 2
    whole = build(n, pairs, 3)
    g, diag, lam, fm = whole[5], whole[6], whole[7], whole[8]
    pinv, b = solver._preconditioner(g, diag, lam, fm.bool())
    # Each rank's constraints and their blocks, cut from the whole graph's.
    mine, theirs = ([t[cut] for t in whole[:5]] + [whole[9][cut]]
                    for cut in (slice(0, c), slice(c, None)))
    incs = [k4.incidence(s[0], s[1], s[5], n) for s in (mine, theirs)]
    real = k4.pcg_matvec_twin
    seen = []

    def recording(begin, end, baa, bab, bbb, diag_, lam_, fm_, v, inc):
        if inc is incs[0]:
            seen.append(v.clone())
        return real(begin, end, baa, bab, bbb, diag_, lam_, fm_, v, inc)
    monkeypatch.setattr(k4, "pcg_matvec_twin", recording)

    def combine(part):
        other = real(*theirs[:5], diag, torch.tensor(0.0), fm, seen[-1],
                     incs[1])
        return shard_combine.rank_sum(torch.stack([part, other]))
    args = (*mine[:5], diag, lam, fm, pinv, b, 80, 1e-6, incs[0])
    x, it = k4.mesh_cg(*args, combine=combine)
    px, pit = plan_of(args).run(combine, 80)
    ox, oit = parent_mesh_branch(args, combine)
    assert it == pit == oit and same(px.numpy(), x) and same(ox.numpy(), x)
    # The same system as one device's, to the rounding of the split sums.
    full = k4.incidence(whole[0], whole[1], whole[9], n)
    sx, _ = k4.pcg_solve_twin(*whole[:5], diag, lam, fm, pinv, b, 80, 1e-6,
                              full)
    assert float((x - sx).abs().max()) <= 1e-4 * float(sx.abs().max())


def test_solver_mesh_branch_runs_mesh_cg_once_an_lm_iteration(monkeypatch):
    args = loop_args("chain")
    begin, end, baa, bab, bbb, diag, lam, fm, pinv, b, mi, tol, inc = args
    calls = []
    real = k4.mesh_cg

    def counting(*a, **kw):
        calls.append(a[13])  # the combine
        return real(*a, **kw)
    monkeypatch.setattr(k4, "mesh_cg", counting)
    x = solver._pcg_solve(begin, end, baa, bab, bbb, diag, lam, fm, pinv,
                          b, mi, tol, inc, False, combine=lambda part: part)
    assert len(calls) == 1 and same(x.numpy(), real(
        *args, combine=lambda part: part)[0])


class Ops(TorchFunctionMode):
    """Records the tensor functions called outside the plan's launches and
    the combine."""

    def __init__(self):
        super().__init__()
        self.outside, self.depth = [], 0

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if self.depth == 0:
            self.outside.append(getattr(func, "__name__", str(func)))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("max_iter,tol,steps,reads", [(6, 0.0, 6, 6),
                                                      (6, 1e30, 0, 1)],
                         ids=["capped", "stopped by the flag"])
def test_a_step_is_three_launches_the_combine_and_one_read(max_iter, tol,
                                                           steps, reads):
    """A phase is the matvec, the combine and the two dot variants; the
    stop flag is read before each further step (none when the cap ends
    the loop), and nothing else touches a tensor."""
    args = loop_args("chain", max_iter, tol)
    plan = plan_of(args)
    events = []
    mode = Ops()

    def inside(name, fn):
        def call(*a, **kw):
            events.append(name)
            mode.depth += 1
            try:
                return fn(*a, **kw)
            finally:
                mode.depth -= 1
        return call
    for name in ("matvec", "damp", "update"):
        setattr(plan, name, inside(name, getattr(plan, name)))
    combine = inside("combine", lambda part: part)
    with mode:
        x, it = plan.run(combine, max_iter)
    assert it == steps
    assert events == ["matvec", "combine", "damp", "update"] * (it + 1)
    assert mode.outside == ["__bool__"] * reads


# --- The plan's checks and layouts ---------------------------------------


def bad(field):
    args = list(loop_args("chain"))
    names = ("begin", "end", "baa", "bab", "bbb", "diag", "lam", "fm", "pinv",
             "b")
    i = names.index(field)
    t = args[i]
    args[i] = (t.long() if t.dtype == torch.int32 else
               t.reshape(-1) if t.dim() > 1 else t.double() if t.dim() == 0
               else t[:-1])
    return args


@pytest.mark.parametrize("field", ["begin", "baa", "diag", "lam", "fm",
                                   "pinv", "b"])
def test_plan_refuses_a_wrong_tensor(field):
    with pytest.raises((TypeError, ValueError)):
        plan_of(bad(field))


def test_plan_refuses_an_incidence_over_other_nodes():
    args = list(loop_args("chain"))
    args[12] = k4.incidence(args[0], args[1], torch.ones(15, dtype=bool), 17)
    with pytest.raises(ValueError):
        plan_of(args)


def test_plan_structures_are_laid_out_as_c():
    """The ctypes mirrors' sizes and offsets on an LP64 target, as the C
    structures lay them out (the card checks them against
    ``ndt2d_cg_plan_sizes``)."""
    assert ctypes.sizeof(k4._Lanes) == 24
    assert ctypes.sizeof(k4._CgMatvec) == 15 * 8 + 8
    assert k4._CgDamp.l.offset == 24 + 7 * 8
    assert ctypes.sizeof(k4._CgDamp) == 24 + 7 * 8 + 8
    assert k4._CgUpdate.tol.offset == 24 + 11 * 8
    assert ctypes.sizeof(k4._CgUpdate) == 24 + 11 * 8 + 16


def test_incidence_builds_the_twin_tables_on_first_read():
    begin, end, *_, cmask = GRAPHS["masked"]()
    inc = k4.incidence(begin, end, cmask, 24)
    assert not inc._tables
    mat, ok = inc.b_mat, inc.b_ok
    assert set(inc._tables) == {"b"} and inc.b_mat is mat
    # Slot d of node n holds its d-th live constraint.
    for n in range(24):
        lo, hi = int(inc.b_ptr[n]), int(inc.b_ptr[n + 1])
        assert mat[n][ok[n]].tolist() == inc.b_idx[lo:hi].tolist()
        assert int(ok[n].sum()) == hi - lo
    assert inc.e_ok.shape[0] == 24 and set(inc._tables) == {"b", "e"}
