"""The rank grid's named axes and the differentiable collectives of
``parallel/comm.py``, on one spawned gloo world of 4 CPU ranks.

Each collective runs on the 4-rank ``seq`` axis of a 1 x 4 grid and on the
2-rank ``model`` axis of a 2 x 2 grid (``Mesh.regrid``).  Every rank feeds it
its own seeded input and takes a loss with weights of its own; the forward
and the input's gradient are held to the same function computed in one
process on the inputs of every rank (stacked), with the losses summed over
the ranks, or, where the convention says the loss is replicated over the
axis (``reduce_out``, ``all_gather``), counted once.  fp32; the tolerance is
1e-6 (the one-process function sums in another order).

The ranks import this module, which imports neither jax nor the JAX package.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from ddl25spring_tpu_torch.parallel import comm  # noqa: E402
from ddl25spring_tpu_torch.parallel.launch import spawn  # noqa: E402
from ddl25spring_tpu_torch.utils.mesh import RankGrid, init_mesh  # noqa: E402

WORLD = 4
SHAPE = (2, 3, 8)    # every input; all_to_all splits dim 2 (8) over 2 or 4 ranks
ATOL = 1e-6
OPS = ("ring_pass", "all_to_all", "copy_in", "reduce_out", "all_gather", "shift")


def _x(i: int) -> torch.Tensor:
    return torch.from_numpy(np.random.default_rng(100 + i).standard_normal(SHAPE)).float()


def _w(i: int, shape) -> torch.Tensor:
    return torch.from_numpy(np.random.default_rng(200 + i).standard_normal(shape)).float()


def _ring_used(i: int, n: int) -> torch.Tensor:
    """Index ``i`` uses slots ``t <= i`` of a ring pass, as the flash ring's
    index ``i`` does: index 0 uses only its own block."""
    return (torch.arange(n) <= i).float()


def _run(op: str, axis, x, rep):
    """``(output, loss)`` of ``op`` on this rank's ``x`` (``rep``: the input
    of index 0, which ``copy_in`` and ``all_gather``'s callers replicate)."""
    n, i = axis.size, axis.index
    if op == "ring_pass":
        out, = comm.ring_pass(axis, x)
        return out, (_w(i, out.shape) * out * _ring_used(i, n)[:, None, None, None]).sum()
    if op == "all_to_all":
        out = comm.all_to_all(x, axis, split=2, concat=1)
        return out, (_w(i, out.shape) * out).sum()
    if op == "copy_in":
        out = comm.copy_in(rep, axis)
        return out, (_w(i, out.shape) * out).sum()
    if op == "reduce_out":
        out = comm.reduce_out(x, axis)
        return out, (_w(0, out.shape) * out).sum()
    out = comm.all_gather(x, axis)
    return out, (_w(0, out.shape) * out).sum()


def _one_process(op: str, n: int):
    """The same function over the stacked inputs of the ``n`` ranks of an
    axis: each index's output, and each index's input gradient."""
    xs = torch.stack([_x(i) for i in range(n)]).requires_grad_()
    if op == "ring_pass":
        outs = [torch.stack([xs[(i - t) % n] for t in range(n)]) for i in range(n)]
        loss = sum((_w(i, o.shape) * o * _ring_used(i, n)[:, None, None, None]).sum()
                   for i, o in enumerate(outs))
    elif op == "all_to_all":
        parts = [x.chunk(n, dim=2) for x in xs]
        outs = [torch.cat([parts[j][i] for j in range(n)], dim=1) for i in range(n)]
        loss = sum((_w(i, o.shape) * o).sum() for i, o in enumerate(outs))
    elif op == "copy_in":
        outs = [xs[0]] * n
        loss = sum((_w(i, o.shape) * o).sum() for i, o in enumerate(outs))
    elif op == "reduce_out":
        outs = [xs.sum(0)] * n
        loss = (_w(0, outs[0].shape) * outs[0]).sum()   # replicated: once
    else:
        outs = [xs] * n
        loss = (_w(0, xs.shape) * xs).sum()
    loss.backward()
    # copy_in's callers all use index 0's input: each gets its whole gradient
    grads = [xs.grad[0] if op == "copy_in" else xs.grad[i] for i in range(n)]
    return [o.detach() for o in outs], grads


def collectives_rank(rdv):
    """Every op on both axes: the output, the gradient of this rank's input
    and, for ``shift``, what each step received."""
    out = {}
    with init_mesh(rdv, 1, seq=WORLD, device="cpu") as mesh:
        for name, m in (("seq", mesh), ("model", mesh.regrid(2, model=2))):
            axis = m.axis(name)
            for op in OPS:
                x = _x(axis.index).requires_grad_()
                rep = _x(0).requires_grad_()
                if op == "shift":
                    got = {step: axis.shift([x.detach()], step=step)[0] for step in (1, -1)}
                    out[name, op] = (axis.index, got, None)
                    continue
                y, loss = _run(op, axis, x, rep)
                loss.backward()
                grad = rep.grad if op == "copy_in" else x.grad
                out[name, op] = (axis.index, y.detach(), grad)
        out["data"] = mesh.regrid(2, seq=2).axis("data").ranks
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return spawn(collectives_rank, WORLD, timeout=120,
                 tmpdir=str(tmp_path_factory.mktemp("rdv")))


@pytest.mark.parametrize("axis_name", ["seq", "model"])
@pytest.mark.parametrize("op", [op for op in OPS if op != "shift"])
def test_collective_matches_one_process(world, axis_name, op):
    n = WORLD if axis_name == "seq" else 2
    want_out, want_grad = _one_process(op, n)
    for r in world:
        i, out, grad = r[axis_name, op]
        np.testing.assert_allclose(out, want_out[i], atol=ATOL, err_msg=f"{op} forward")
        np.testing.assert_allclose(grad, want_grad[i], atol=ATOL, err_msg=f"{op} gradient")


@pytest.mark.parametrize("axis_name", ["seq", "model"])
def test_shift_sends_to_the_next_index(world, axis_name):
    n = WORLD if axis_name == "seq" else 2
    for r in world:
        i, got, _ = r[axis_name, "shift"]
        for step in (1, -1):
            assert torch.equal(got[step], _x((i - step) % n))


def test_grid_axes_order_ranks_with_data_outermost(world):
    grid = RankGrid(2, 2, "seq")
    assert [grid.coords(r) for r in range(4)] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    assert grid.axis_ranks(1) == [2, 3] and grid.dp_ranks(1) == [1, 3]
    assert [r["data"] for r in world] == [(0, 2), (1, 3), (0, 2), (1, 3)]
    assert RankGrid(2, 2, "expert").axis_ranks(0) == [0, 1]
    with pytest.raises(ValueError, match="none of"):
        RankGrid(2, 2, "tensor")
