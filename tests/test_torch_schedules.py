"""The port's pipeline schedules as action lists, in one process and without
torch: every valid layout with ``S <= 4`` stages, ``V <= 3`` chunks per rank
and ``M <= 8`` microbatches runs each ``(chunk, microbatch)`` forward once
and before its backward on every rank, holds no more in flight than the
schedule's bound, and completes in the discrete-event model of rendezvous
transport, where the naive order of blocking sends deadlocks."""

import itertools

import pytest

from ddl25spring_tpu_torch.parallel import schedule as sc


def _layouts():
    out = []
    for name, S, V, M in itertools.product(sc.SCHEDULES, range(1, 5), range(1, 4),
                                           range(1, 9)):
        try:
            sc.check_layout(name, S, V, M)
        except ValueError:
            continue
        out.append((name, S, V, M))
    return out


LAYOUTS = _layouts()


def _plans(name, S, V, M, **kw):
    return [sc.comm_plan(name, S, V, M, s, **kw) for s in range(S)]


def test_layouts_cover_every_schedule():
    assert len(LAYOUTS) == 176
    assert {x[0] for x in LAYOUTS} == set(sc.SCHEDULES)


@pytest.mark.parametrize("name", sc.SCHEDULES)
def test_every_forward_once_and_before_its_backward(name):
    for _, S, V, M in (x for x in LAYOUTS if x[0] == name):
        for s in range(S):
            acts = sc.actions(name, S, V, M, s)
            want = {(v, m) for v in range(V) for m in range(M)}
            fwd = [(v, m) for k, v, m in acts if k == "F"]
            bwd = [(v, m) for k, v, m in acts if k == "B"]
            assert sorted(fwd) == sorted(want) and sorted(bwd) == sorted(want)
            for v, m in want:
                assert acts.index(("F", v, m)) < acts.index(("B", v, m))


@pytest.mark.parametrize("name", sc.SCHEDULES)
def test_in_flight_bound(name):
    for _, S, V, M in (x for x in LAYOUTS if x[0] == name):
        for s in range(S):
            got = sc.in_flight(sc.actions(name, S, V, M, s))
            if name == "gpipe":
                want = M
            elif name == "interleaved":
                want = M * V  # every chunk-microbatch of the forward stream
            elif name in ("1f1b", "1f1b-stash"):
                want = min(M, S - s)
            else:
                want = min(sc.warmup(name, S, V, M, s) + 1, M * V)
            assert got == want, (name, S, V, M, s)


def test_schedule_orders_match_the_reference_docstrings():
    # 1F1B, S = 3, M = 4: stage 0 warms up with two forwards
    assert sc.actions("1f1b", 3, 1, 4, 0) == [
        ("F", 0, 0), ("F", 0, 1), ("F", 0, 2), ("B", 0, 0), ("F", 0, 3), ("B", 0, 1),
        ("B", 0, 2), ("B", 0, 3)]
    assert sc.actions("1f1b", 3, 1, 4, 2)[:4] == [("F", 0, 0), ("B", 0, 0), ("F", 0, 1),
                                                  ("B", 0, 1)]
    assert sc.actions("gpipe", 2, 1, 2, 1) == [("F", 0, 0), ("F", 0, 1), ("B", 0, 1),
                                               ("B", 0, 0)]
    # Megatron's slot grouping (the JAX _slot_map): chunk 0 for a group of S
    # microbatches, then chunk 1 for the same group
    assert [sc.slot(k, 2, 2) for k in range(8)] == [
        (0, 0), (0, 1), (1, 0), (1, 1), (0, 2), (0, 3), (1, 2), (1, 3)]
    acts = sc.actions("interleaved", 2, 2, 2, 0)
    assert acts == [("F", 0, 0), ("F", 0, 1), ("F", 1, 0), ("F", 1, 1),
                    ("B", 1, 1), ("B", 1, 0), ("B", 0, 1), ("B", 0, 0)]
    # interleaved 1F1B: the backward stream takes the slots on reversed chunks
    assert sc.warmup("interleaved-1f1b", 3, 2, 3, 2) == 3
    assert sc.actions("interleaved-1f1b", 3, 2, 3, 2) == [
        ("F", 0, 0), ("F", 0, 1), ("F", 0, 2), ("F", 1, 0), ("B", 1, 0), ("F", 1, 1),
        ("B", 1, 1), ("F", 1, 2), ("B", 1, 2), ("B", 0, 0), ("B", 0, 1), ("B", 0, 2)]


def test_tags_are_unique_and_invert():
    S, V, M = 3, 2, 6
    tags = {sc.tag(d, g, m, S, V, M) for d in "FB" for g in range(S * V) for m in range(M)}
    assert len(tags) == 2 * S * V * M
    for d, g, m in itertools.product("FB", range(S * V), range(M)):
        assert sc.untag(sc.tag(d, g, m, S, V, M), S, V, M) == (d, g, m)


def test_ring_wraps_between_chunks():
    # the last stage's chunk 0 feeds stage 0's chunk 1, and its gradient
    # comes back the same way
    S, V, M = 3, 2, 3
    recv, send = sc.action_ops(("F", 0, 1), S, V, M, 2)
    assert (send.peer, recv.peer) == (0, 1)
    recv, _ = sc.action_ops(("F", 1, 1), S, V, M, 0)
    assert recv.peer == 2 and recv.tag == send.tag
    recv, send = sc.action_ops(("B", 1, 1), S, V, M, 0)
    assert send.peer == 2 and recv.peer == 1
    assert sc.action_ops(("F", 0, 0), S, V, M, 0)[0] is None  # injects
    assert sc.action_ops(("B", 1, 0), S, V, M, 2)[0] is None  # seeds the loss


@pytest.mark.parametrize("name", sc.SCHEDULES)
def test_every_layout_completes(name):
    for _, S, V, M in (x for x in LAYOUTS if x[0] == name):
        done, at = sc.simulate(_plans(name, S, V, M))
        assert done, (name, S, V, M, at)
        sc.check_deadlock_free(name, S, V, M)
        done, _ = sc.simulate(_plans(name, S, V, M, forward_only=True))
        assert done


def test_messages_arrive_in_the_order_they_are_sent():
    # each directed pair of stages sends its tags in the order the receiver
    # posts them, so a transport that matches in posting order (NCCL) pairs
    # them as tags would
    for name, S, V, M in LAYOUTS:
        sent, got = {}, {}
        for s, plan in enumerate(_plans(name, S, V, M)):
            for ops, _ in plan:
                for op in ops:
                    if op.kind == "send":
                        sent.setdefault((s, op.peer), []).append(op.tag)
                    else:
                        got.setdefault((op.peer, s), []).append(op.tag)
        assert sent == got, (name, S, V, M)


def _naive(name, S, V, M):
    """The naive order: each action's receive, then its compute, then its
    send, each a blocking operation of its own."""
    plans = []
    for s in range(S):
        plan = []
        for a in sc.actions(name, S, V, M, s):
            recv, send = sc.action_ops(a, S, V, M, s)
            plan += ([([recv], [])] if recv else []) + [([], [a])]
            plan += [([send], [])] if send else []
        plans.append(plan)
    return plans


def test_the_naive_order_deadlocks():
    # blocking send, then blocking receive: in 1F1B's steady state stage s
    # sends an activation down while stage s + 1 sends a gradient up
    for S, M in itertools.product(range(2, 5), range(2, 9)):
        done, at = sc.simulate(_naive("1f1b", S, 1, M))
        assert not done
    # GPipe never has two neighbours sending to each other at once
    assert sc.simulate(_naive("gpipe", 3, 1, 4))[0]


def test_two_neighbours_both_sending_first_deadlock():
    a, b = sc.Op("send", 1, 0), sc.Op("recv", 1, 1)
    c, d = sc.Op("send", 0, 1), sc.Op("recv", 0, 0)
    assert not sc.simulate([[([a], []), ([b], [])], [([c], []), ([d], [])]])[0]
    # the same operations as one exchange each complete
    assert sc.simulate([[([a, b], [])], [([c, d], [])]])[0]


def test_fusing_the_interleaved_steady_state_is_what_keeps_it_live():
    # one exchange per action is enough for plain 1F1B, not for interleaved
    # 1F1B with more than one group of microbatches
    S, V, M = 2, 2, 4
    per_action = []
    for s in range(S):
        plan, pending = [], []
        for a in sc.actions("interleaved-1f1b", S, V, M, s):
            recv, send = sc.action_ops(a, S, V, M, s)
            plan.append((pending + ([recv] if recv else []), [a]))
            pending = [send] if send else []
        per_action.append(plan + [(pending, [])])
    assert not sc.simulate(per_action)[0]
    assert sc.simulate(_plans("interleaved-1f1b", S, V, M))[0]
    with pytest.raises(RuntimeError, match="deadlocks"):
        _check_with(per_action)


def _check_with(plans):
    from unittest import mock

    with mock.patch.object(sc, "comm_plan", lambda name, S, V, M, s: plans[s]):
        sc.check_deadlock_free("interleaved-1f1b", 2, 2, 4)


def test_guards_raise_as_in_jax():
    with pytest.raises(ValueError, match="unknown schedule"):
        sc.check_layout("zigzag", 3, 1, 3)
    with pytest.raises(ValueError, match="needs schedule='interleaved'"):
        sc.check_layout("1f1b", 3, 2, 3)
    with pytest.raises(ValueError, match="num_chunks >= 2"):
        sc.check_layout("interleaved-1f1b", 3, 1, 3)
    with pytest.raises(ValueError, match="divisible"):
        sc.check_layout("interleaved", 2, 2, 3)
    sc.check_layout("interleaved", 1, 1, 3)  # V = 1 reduces to GPipe's order
    assert sc.actions("interleaved", 3, 1, 3, 1) == sc.actions("gpipe", 3, 1, 3, 1)
