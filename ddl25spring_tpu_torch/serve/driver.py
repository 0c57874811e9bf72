"""The ``bench --serve`` driver: traffic -> engine -> telemetry, the
counterpart of the JAX package's ``serve/driver.py`` (its default path).

One call (:func:`run_serve_bench`) produces the whole serving record:

1. **ramp phase** — the seeded open-loop trace (:mod:`.traffic`) drives a
   continuous-batching engine on the WALL clock, every program captured
   before the clock starts: TTFT p50/p95, per-token latency, queue depth,
   admission counters and page-pool peak occupancy (``telemetry.serve``).
2. **continuous-vs-static A/B** — the SAME trace through two fresh engines
   on the VIRTUAL clock (every program call advances ``tick_s``): both run
   to drain, the fixed budget is the midpoint of the two drain times, and
   "tokens delivered by the budget" is read off each timeline.
3. **cached-vs-cold prefix A/B** — likewise with the radix prefix cache on
   and off; the cached arm must emit the identical tokens.
4. **artifacts** — ``serve.json`` in the obs dir (read by
   ``tools/serve_report.py``) and one ``record: "serve"`` line appended to
   the perf ledger, keyed by host fingerprint + workload key with the git
   sha as the trend variable, so ``serve_report --check`` gates trends.

Engine knobs resolve from ``DDL25_SERVE_*`` env over serving-sized (or
smoke-sized) defaults.  The served model is the port's seeded
:class:`~ddl25spring_tpu_torch.models.llama.Llama` (seed 0).

``DDL25_SERVE_SPEC=1`` adds the spec-on-vs-off A/B (:func:`spec_ab_compare`);
an armed ``DDL25_CHAOS`` of ``traffic_spike`` / ``capacity_change`` /
``device_loss`` adds the elastic replica run (:func:`elastic_serve_run`).

Waiting for other slices: the TP A/B (``tp_ab_compare``) comes with A9b-3
and raises ``NotImplementedError`` when asked for; the goodput doc and its
ledger row (and the elastic cell's ``goodput``), and the ``mem`` record,
come with A11b.
"""

from __future__ import annotations

import gc
import json
import os
import platform
import time
from typing import Any

# the CI smoke must be reproducible, so every knob that shapes the workload
# lands in the record's key
SMOKE_TRAFFIC = {"duration_s": 2.0, "rate_rps": 6.0, "profile": "ramp", "seed": 0}
SERVE_BASENAME = "serve.json"


def engine_knobs(smoke: bool = False) -> dict[str, Any]:
    """Pool geometry + admission-control knobs: ``DDL25_SERVE_*`` env over
    (smoke-sized or serving-sized) defaults.  ``DDL25_SERVE_TP`` > 1 and
    ``DDL25_SERVE_WEIGHT_STREAM=1`` wait for A9b-3 and raise."""
    from ddl25spring_tpu_torch.models.decode import not_yet
    from ddl25spring_tpu_torch.utils.config import env_int

    d = (
        dict(page_len=4, n_pages=16, max_slots=2, prefill_batch=2,
             max_prompt_len=8, max_queue=32, token_budget=0)
        if smoke else
        dict(page_len=16, n_pages=64, max_slots=4, prefill_batch=2,
             max_prompt_len=32, max_queue=64, token_budget=0)
    )
    if env_int("DDL25_SERVE_TP", 1) > 1:
        raise not_yet("TP serving (DDL25_SERVE_TP > 1)")
    if env_int("DDL25_SERVE_WEIGHT_STREAM", 0):
        raise not_yet("the weight-streaming decode (DDL25_SERVE_WEIGHT_STREAM=1)")
    eos = env_int("DDL25_SERVE_EOS", -1)
    return {
        "page_len": env_int("DDL25_SERVE_PAGE_LEN", d["page_len"]),
        "n_pages": env_int("DDL25_SERVE_N_PAGES", d["n_pages"]),
        "max_slots": env_int("DDL25_SERVE_SLOTS", d["max_slots"]),
        "prefill_batch": env_int("DDL25_SERVE_PREFILL_BATCH", d["prefill_batch"]),
        "max_prompt_len": env_int("DDL25_SERVE_MAX_PROMPT", d["max_prompt_len"]),
        "max_queue": env_int("DDL25_SERVE_MAX_QUEUE", d["max_queue"]),
        # 0 = unlimited (the knob is backpressure, not a requirement)
        "token_budget": env_int("DDL25_SERVE_TOKEN_BUDGET", d["token_budget"]) or None,
        "eos_id": None if eos < 0 else eos,
        # the radix prefix cache: on by default (a workload with no repeated
        # prefixes never hits, and the cold path is identical); 0 disables
        "prefix_cache": bool(env_int("DDL25_SERVE_PREFIX", 1)),
        # speculative decoding: off by default; DDL25_SERVE_SPEC=1 turns on
        # the early-exit drafter with DDL25_SERVE_SPEC_K drafts a round and
        # DDL25_SERVE_DRAFT_LAYERS drafter blocks (greedy only)
        "spec_k": env_int("DDL25_SERVE_SPEC_K", 2) if env_int("DDL25_SERVE_SPEC", 0) else 0,
        "draft_layers": env_int("DDL25_SERVE_DRAFT_LAYERS", 1),
    }


def serve_model(model: str):
    """The model the bench serves: ``tiny`` (the smoke / test config, fp32
    so the paged-vs-dense pin is bitwise), ``tiny-deep`` (the same tiny dims
    at 6 layers) or ``ref`` (the reference LLaMA constants, bf16)."""
    from ddl25spring_tpu_torch.utils.config import LlamaConfig

    if model == "tiny":
        return LlamaConfig(vocab_size=64, dmodel=16, num_heads=2, n_layers=2,
                           ctx_size=32, dtype="float32")
    if model == "tiny-deep":
        return LlamaConfig(vocab_size=64, dmodel=16, num_heads=2, n_layers=6,
                           ctx_size=32, dtype="float32")
    if model == "ref":
        return LlamaConfig()
    raise ValueError(f"model={model!r} is not 'tiny', 'tiny-deep' or 'ref'")


def _build_engine(params, cfg, knobs: dict[str, Any], **over):
    from ddl25spring_tpu_torch.serve.engine import ServeEngine

    kw = dict(knobs)
    kw.update(over)
    return ServeEngine(params, cfg, **kw)


def ab_tick_s(trace, max_slots: int) -> float:
    """The A/B's virtual tick length, sized so decode capacity (``max_slots
    / tick_s`` tokens/s) sits at ~75% of the trace's mean token demand: the
    engine saturates, a queue forms, and the two admission policies differ
    where continuous batching exists to differ."""
    if not trace:
        return 5e-3
    duration = max(r["t"] for r in trace) or 1.0
    demand = sum(r["max_new"] for r in trace) / duration  # tokens/s
    if demand <= 0:
        return 5e-3
    return min(max(max_slots / (0.75 * demand), 1e-4), 1.0)


def _arm(m: dict[str, Any]) -> dict[str, Any]:
    return {k: m[k] for k in ("ticks", "prefills", "generated_tokens", "completed",
                              "rejected")} | {"drain_wall_s": m["wall_s"]}


def ab_compare(params, cfg, trace, knobs: dict[str, Any], *, tick_s: float | None = None,
               max_steps: int = 20_000, temperature: float = 0.0,
               sentinel: bool | None = None) -> dict[str, Any]:
    """Continuous vs static admission on the identical trace, virtual clock:
    run both to drain, fix the budget at the midpoint of the two drain
    walls, read tokens-delivered-by-budget off each timeline.  Both engines
    get ``prefill_batch=max_slots``, so the delta counts exactly the ticks
    static admission left freed slots idle."""
    if tick_s is None:
        tick_s = ab_tick_s(trace, knobs["max_slots"])
    out: dict[str, Any] = {}
    engines = {}
    for adm in ("continuous", "static"):
        e = _build_engine(params, cfg, knobs, admission=adm, clock="virtual",
                          tick_s=tick_s, temperature=temperature, sentinel=sentinel,
                          prefill_batch=knobs["max_slots"], trace_label=None)
        m = e.run(trace, max_steps=max_steps)
        engines[adm] = e
        out[adm] = _arm(m)
    budget = round((out["continuous"]["drain_wall_s"] + out["static"]["drain_wall_s"]) / 2, 6)
    cont = engines["continuous"].tokens_at(budget)
    stat = engines["static"].tokens_at(budget)
    out.update(
        budget_s=budget, tick_s=tick_s,
        continuous_tokens_at_budget=cont, static_tokens_at_budget=stat,
        advantage_tokens=cont - stat,
        advantage_frac=round((cont - stat) / stat, 4) if stat else None,
    )
    return out


def prefix_ab_compare(params, cfg, trace, knobs: dict[str, Any], *,
                      tick_s: float | None = None, max_steps: int = 20_000,
                      temperature: float = 0.0,
                      sentinel: bool | None = None) -> dict[str, Any]:
    """Radix-prefix-cache A/B: the identical trace through a CACHED engine
    and a COLD one, both continuous on the virtual clock at ``prefill_batch
    = max_slots``; prefill is charged for the positions it ran, so the
    advantage is deterministic.  ``tokens_match``: every request both arms
    completed carries the identical tokens."""
    if tick_s is None:
        tick_s = ab_tick_s(trace, knobs["max_slots"])
    out: dict[str, Any] = {}
    engines = {}
    for arm, cache_on in (("cached", True), ("cold", False)):
        e = _build_engine(params, cfg, knobs, admission="continuous", clock="virtual",
                          tick_s=tick_s, temperature=temperature, sentinel=sentinel,
                          prefill_batch=knobs["max_slots"], prefix_cache=cache_on,
                          trace_label=None)
        m = e.run(trace, max_steps=max_steps)
        engines[arm] = e
        out[arm] = {
            **_arm(m),
            "tokens_per_sec_per_chip": m["tokens_per_sec_per_chip"],
            **({
                "prefix_hit_rate": m["prefix_hit_rate"],
                "prefill_tokens_saved": m["prefill_tokens_saved"],
                "prefill_flops_saved": m["prefill_flops_saved"],
            } if cache_on else {}),
        }
    budget = round((out["cached"]["drain_wall_s"] + out["cold"]["drain_wall_s"]) / 2, 6)
    cached = engines["cached"].tokens_at(budget)
    cold = engines["cold"].tokens_at(budget)
    streams = {arm: {r.rid: list(r.tokens) for r in e.done} for arm, e in engines.items()}
    common = set(streams["cached"]) & set(streams["cold"])
    out.update(
        budget_s=budget, tick_s=tick_s,
        cached_tokens_at_budget=cached, cold_tokens_at_budget=cold,
        advantage_tokens=cached - cold,
        advantage_frac=round((cached - cold) / cold, 4) if cold else None,
        tokens_match=all(streams["cached"][rid] == streams["cold"][rid] for rid in common),
        compared_requests=len(common),
    )
    return out


def spec_ab_compare(params, cfg, trace, knobs: dict[str, Any], *,
                    tick_s: float | None = None, max_steps: int = 20_000,
                    sentinel: bool | None = None) -> dict[str, Any]:
    """Speculative-decoding A/B: the identical trace through a SPEC engine
    (``knobs['spec_k']`` drafts a round, one verify pass) and a sequential
    one, both continuous on the virtual clock at ``prefill_batch =
    max_slots``, so the only difference is what each committed token costs
    in target passes.  The virtual clock prices a verify pass as one tick
    and each drafter step (and the drafter's prefill) at its FLOP ratio.
    ``tokens_match``: every request both arms completed carries the identical
    tokens (greedy speculation emits the target's own stream)."""
    if not knobs.get("spec_k"):
        raise ValueError("spec_ab_compare needs knobs['spec_k'] > 0")
    if tick_s is None:
        tick_s = ab_tick_s(trace, knobs["max_slots"])
    out: dict[str, Any] = {}
    engines = {}
    for arm, k in (("spec", knobs["spec_k"]), ("nospec", 0)):
        e = _build_engine(params, cfg, knobs, admission="continuous", clock="virtual",
                          tick_s=tick_s, temperature=0.0, sentinel=sentinel,
                          prefill_batch=knobs["max_slots"], spec_k=k, trace_label=None)
        m = e.run(trace, max_steps=max_steps)
        engines[arm] = e
        out[arm] = {
            "drain_wall_s": m["wall_s"],
            **{key: m[key] for key in ("ticks", "prefills", "generated_tokens", "completed",
                                       "rejected", "tokens_per_sec_per_chip")},
            **({key: m[key] for key in ("acceptance_rate", "draft_tokens_accepted",
                                        "draft_tokens_rejected", "spec")} if k else {}),
        }
    budget = round((out["spec"]["drain_wall_s"] + out["nospec"]["drain_wall_s"]) / 2, 6)
    spec_toks = engines["spec"].tokens_at(budget)
    nospec_toks = engines["nospec"].tokens_at(budget)
    streams = {arm: {r.rid: list(r.tokens) for r in e.done} for arm, e in engines.items()}
    common = set(streams["spec"]) & set(streams["nospec"])
    out.update(
        budget_s=budget, tick_s=tick_s,
        spec_tokens_at_budget=spec_toks, nospec_tokens_at_budget=nospec_toks,
        advantage_tokens=spec_toks - nospec_toks,
        advantage_frac=(round((spec_toks - nospec_toks) / nospec_toks, 4)
                        if nospec_toks else None),
        tokens_match=all(streams["spec"][rid] == streams["nospec"][rid] for rid in common),
        compared_requests=len(common),
    )
    return out


def elastic_serve_run(params, cfg, trace, knobs: dict[str, Any], *, chaos,
                      tick_s: float | None = None, replicas: int = 2, max_replicas: int = 4,
                      max_iters: int = 20_000, temperature: float = 0.0,
                      sentinel: bool | None = None,
                      keep_requests: bool = False) -> dict[str, Any]:
    """Replica scale-up/down under live traffic with page-pool handoff.

    A replica set of continuous engines runs the seeded trace in lockstep
    on ONE virtual clock (each iteration steps every replica, then
    advances ``tick_s``).  Arrivals route to the shortest non-draining
    queue.  Armed chaos (``chaos.take`` at exact iteration indices) drives:

    - ``traffic_spike@k[:B]``: B extra arrivals (the trace's first B,
      re-stamped to now) land at once; the queue-depth autoscaler answers
      with a scale-up once the backlog passes 2x the slot count;
    - ``capacity_change@k[:N]``: the set resizes to N replicas;
    - ``device_loss@k``: one replica stops admitting, its queue re-submits
      to the survivors (:meth:`~ddl25spring_tpu_torch.serve.engine.
      ServeEngine.begin_drain`), its live slots decode to completion, and
      only then does it leave, its device memory with it
      (:meth:`~ddl25spring_tpu_torch.serve.engine.ServeEngine.retire`).

    Every event is a ``kind="reshape"`` flight record
    (:func:`~ddl25spring_tpu_torch.ft.elastic.record_reshape`) and an entry
    of the returned cell, which also splits TTFT into reshape windows and
    steady state (what ``serve_report --check-reshape`` gates).  With
    memscope on, each retired replica's ``mem_steps`` entry holds the
    allocator's live bytes before and after its retirement (null on the
    CPU, which keeps no such count)."""
    from ddl25spring_tpu_torch.ft import elastic
    from ddl25spring_tpu_torch.obs import memscope
    from ddl25spring_tpu_torch.obs.timeline import timeline
    from ddl25spring_tpu_torch.serve.engine import Request, _pct

    if tick_s is None:
        tick_s = ab_tick_s(trace, knobs["max_slots"])
    elastic_kinds = ("traffic_spike", "capacity_change", "device_loss")
    mem_steps: list[dict] = []
    # replica ids are monotone and never reused: list positions shift when a
    # drained replica leaves, and the timeline tracks need a stable id
    next_replica = [0]

    def build():
        e = _build_engine(params, cfg, knobs, admission="continuous", clock="virtual",
                          tick_s=tick_s, temperature=temperature, sentinel=sentinel,
                          prefill_batch=knobs["max_slots"], trace_label="elastic")
        e.replica_id = next_replica[0]
        next_replica[0] += 1
        return e

    reps = [build() for _ in range(replicas)]
    retired: list = []
    draining: list[tuple[Any, dict]] = []
    arrivals = sorted(trace, key=lambda r: r["t"])
    events: list[dict] = []
    rid = 0
    t = 0.0
    i = it = 0
    submitted = 0
    spike_backlog: list[dict] = []

    def route(req: Request, force: bool = False) -> None:
        """Shortest-queue routing.  ``force`` is the handoff: a request a
        draining replica already accepted is seated in the shortest survivor
        queue even past its door bound (no second, counted trip through
        ``submit``): the zero-drop contract outranks the bound."""
        live = [e for e in reps if not e.draining]
        target = min(live, key=lambda e: (len(e.queue), reps.index(e)))
        if force:
            target.queue.append(req)
        else:
            target.submit(req)

    def mk(a: dict, arrival_t: float) -> Request:
        nonlocal rid, submitted
        r = Request(rid=rid, prompt=list(map(int, a["prompt"])),
                    max_new_tokens=int(a["max_new"]), arrival_t=arrival_t)
        rid += 1
        submitted += 1
        return r

    def scale_up(n_new: int, reason: str) -> None:
        t0 = time.perf_counter()
        old = len(reps)
        for _ in range(n_new):
            reps.append(build())
        ev = elastic.record_reshape(scope="serve", reason=reason, old=old, new=len(reps),
                                    wall_s=time.perf_counter() - t0, steps_lost=0,
                                    t=round(t, 6))
        ev["t_end"] = round(t, 6)  # a fresh replica serves at once
        timeline.emit("reshape_end", reason=reason, t=ev["t"], t_end=ev["t_end"],
                      old=ev["old"], new=ev["new"], vt=t, engine="elastic")
        events.append(ev)

    def scale_down(n_drop: int, reason: str) -> None:
        t0 = time.perf_counter()
        old = len(reps)
        victims = [e for e in reversed(reps) if not e.draining][:n_drop]
        requeued = 0
        for v in victims:
            for req in v.begin_drain():
                route(req, force=True)
                requeued += 1
                timeline.emit("serve_drain_handoff", rid=req.rid, from_replica=v.replica_id,
                              vt=t, engine="elastic")
        ev = elastic.record_reshape(scope="serve", reason=reason, old=old,
                                    new=old - len(victims), wall_s=time.perf_counter() - t0,
                                    steps_lost=0, t=round(t, 6), requeued=requeued)
        events.append(ev)
        draining.extend((v, ev) for v in victims)

    def retire(v, ev) -> None:
        """A drained replica leaves, its pools and captured programs with it;
        with memscope on, the allocator's live bytes around the drop."""
        if not memscope.enabled():
            v.retire()
            return
        before = memscope.live_total_bytes(v.device)
        pool_bytes = v._pool_bytes()
        leak = v.mem_leak_check()
        v.retire()
        gc.collect()  # a cycle must not hold a dropped tensor past the reading
        after = memscope.live_total_bytes(v.device)
        mem_steps.append({
            "scope": "serve", "reason": ev["reason"], "t": ev["t_end"],
            "replica": v.replica_id, "pool_bytes": pool_bytes,
            "live_bytes_before": before, "live_bytes_after": after,
            "step_down_bytes": None if before is None else before - after,
            **({} if before is not None else {"step_down_absent": memscope.LIVE_BYTES_ABSENT}),
            "leak_ok": leak["ok"], "leaked_pages": leak["leaked_pages"],
        })

    while True:
        # arrivals whose time has come (and any spike burst)
        while i < len(arrivals) and arrivals[i]["t"] <= t:
            route(mk(arrivals[i], arrivals[i]["t"]))
            i += 1
        for a in spike_backlog:
            route(mk(a, t))
        spike_backlog = []

        # chaos at this iteration, journaled before it is acted on
        for f in chaos.take(it, kinds=elastic_kinds):
            if f.kind == "traffic_spike":
                burst = f.arg or max(4, len(arrivals) // 8)
                spike_backlog.extend([dict(a) for a in arrivals[:burst]]
                                     or [{"prompt": [1, 2], "max_new": 4}] * burst)
            elif f.kind == "capacity_change":
                target = f.arg or 1
                live = sum(1 for e in reps if not e.draining)
                grow = max(0, min(target, max_replicas) - live)
                if grow:
                    scale_up(grow, "capacity_change")
                elif target < live:
                    scale_down(live - target, "capacity_change")
            elif f.kind == "device_loss":
                if sum(1 for e in reps if not e.draining) > 1:
                    scale_down(1, "device_loss")

        # the queue-depth autoscaler: one replica per decision, with a
        # settling cooldown so a burst scales once
        backlog = sum(len(e.queue) for e in reps if not e.draining)
        live_n = sum(1 for e in reps if not e.draining)
        if (backlog > 2 * knobs["max_slots"] and live_n < max_replicas
                and (not events or t - events[-1]["t"] > 10 * tick_s)):
            scale_up(1, "traffic_spike_scale_up")

        # one lockstep tick: every replica on the SAME clock
        ran = False
        for e in list(reps):
            e._vtime = t
            ran = e.step() or ran
        for v, ev in list(draining):
            if v.drained:
                ev["t_end"] = round(t, 6)
                ev["drained_slots"] = v.max_slots
                timeline.emit("reshape_end", reason=ev["reason"], t=ev["t"],
                              t_end=ev["t_end"], old=ev["old"], new=ev["new"], vt=t,
                              engine="elastic")
                reps.remove(v)
                retired.append(v)
                draining.remove((v, ev))
                retire(v, ev)
        t += tick_s
        it += 1
        done_feeding = i >= len(arrivals) and not spike_backlog
        idle = not ran and all(not e.queue and all(s is None for s in e.slots) for e in reps)
        if (done_feeding and idle and not draining) or it >= max_iters:
            break

    # ---- the reshape cell: windows, drops, percentiles
    pad = 5 * tick_s  # settling margin after a drain completes
    windows = [(ev["t"], ev.get("t_end", ev["t"]) + pad) for ev in events]

    def in_window(x: float) -> bool:
        return any(a <= x <= b for a, b in windows)

    every = [*reps, *retired]
    all_done = [r for e in every for r in e.done]
    ttft = [(r.first_token_t - r.arrival_t, in_window(r.first_token_t)) for r in all_done
            if r.first_token_t is not None]
    ttft_window = [x for x, w in ttft if w]
    ttft_steady = [x for x, w in ttft if not w]
    admitted = sum(e.admitted for e in every)
    completed = sum(e.completed for e in every)
    return {
        "events": events,
        "tick_s": tick_s,
        "iters": it,
        "wall_virtual_s": round(t, 6),
        "replicas_start": replicas,
        "replicas_end": len(reps),
        "max_replicas": max_replicas,
        "submitted": submitted,
        "admitted": admitted,
        "completed": completed,
        "rejected": sum(sum(e.rejected.values()) for e in every),
        # accepted-then-lost across every handoff: the zero --check-reshape pins
        "dropped_requests": admitted - completed,
        "generated_tokens": sum(e.generated_tokens for e in every),
        "ttft_s_p50_steady": _pct(ttft_steady, 50),
        "ttft_s_p95_steady": _pct(ttft_steady, 95),
        "ttft_s_p50_reshape": _pct(ttft_window, 50),
        "ttft_s_p95_reshape": _pct(ttft_window, 95),
        "reshape_window_requests": len(ttft_window),
        "steady_requests": len(ttft_steady),
        **({"mem_steps": mem_steps} if mem_steps else {}),
        # a test hook (the token-exactness pins), never serialized
        **({"_requests": all_done} if keep_requests else {}),
    }


def host_fingerprint(device) -> str:
    """Identity of the measuring machine and device — part of the ledger
    key, so one host's trend never gates another's."""
    import torch

    dev = torch.device(device)
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    return f"{platform.node()}/{os.cpu_count()}cpu/{kind}"


def append_ledger(record: dict[str, Any], path: str) -> str:
    """Append one record to the JSONL ledger (created on first use)."""
    parent = os.path.dirname(path)
    if parent:
        os.makedirs(parent, exist_ok=True)
    with open(path, "a") as f:
        f.write(json.dumps(record, default=str) + "\n")
    return path


def run_serve_bench(
    *,
    smoke: bool = False,
    model: str | None = None,
    obs_dir: str | None = None,
    duration_s: float | None = None,
    rate_rps: float | None = None,
    profile: str | None = None,
    seed: int | None = None,
    budget_s: float | None = None,
    ledger_path: str | None = None,
    temperature: float = 0.0,
    sentinel: bool | None = None,
    skip_ab: bool = False,
    skip_prefix_ab: bool = False,
    skip_spec_ab: bool = False,
    serve_tp: int | None = None,
    device=None,
) -> dict[str, Any]:
    """The whole serving bench on ``device`` (default the card); returns the
    record (``serve_cell`` makes the BENCH line's ``telemetry.serve``).
    ``budget_s`` bounds the wall-clock ramp phase (None = run to drain).
    The chaos journal of the elastic run lives in ``obs_dir``."""
    import torch

    from ddl25spring_tpu_torch.ft.chaos import ChaosInjector
    from ddl25spring_tpu_torch.models.decode import not_yet
    from ddl25spring_tpu_torch.models.llama import Llama
    from ddl25spring_tpu_torch.obs import sentinels, spans
    from ddl25spring_tpu_torch.obs.logger import git_sha
    from ddl25spring_tpu_torch.obs.recorder import flight
    from ddl25spring_tpu_torch.serve.traffic import TrafficSpec, synth_trace
    from ddl25spring_tpu_torch.utils.config import env_int
    from ddl25spring_tpu_torch.utils.device import resolve_device

    if serve_tp is not None and serve_tp > 1:
        raise not_yet("TP serving (--serve-tp > 1)")
    dev = resolve_device(device)
    t_start = time.perf_counter()
    model = model or ("tiny" if smoke else "ref")
    cfg = serve_model(model)
    knobs = engine_knobs(smoke=smoke)
    traffic_defaults = SMOKE_TRAFFIC if smoke else {
        "duration_s": 30.0, "rate_rps": 8.0, "profile": "ramp", "seed": 0,
    }
    profile = profile or traffic_defaults["profile"]
    # per-request max_new jitter on the shared profile (the spec A/B's
    # variable lengths); zeroed elsewhere, where it changes nothing
    jitter = env_int("DDL25_SERVE_JITTER", 0) if profile == "shared" else 0
    spec = TrafficSpec(
        seed=traffic_defaults["seed"] if seed is None else seed,
        duration_s=traffic_defaults["duration_s"] if duration_s is None else duration_s,
        rate_rps=traffic_defaults["rate_rps"] if rate_rps is None else rate_rps,
        profile=profile, vocab_size=cfg.vocab_size, max_new_jitter=jitter,
    )
    trace = synth_trace(spec)
    flight.annotate(serve_model=model, serve_profile=spec.profile,
                    serve_seed=spec.seed, serve_requests=len(trace))

    params = Llama(cfg, device=dev, generator=torch.Generator().manual_seed(0))
    params.requires_grad_(False)

    # --- ramp phase: wall clock, the measured serving numbers ------------
    eng = _build_engine(params, cfg, knobs, clock="wall", temperature=temperature,
                        sentinel=sentinel, trace_label="ramp")
    # capture OFF the clock: TTFT measures serving, not the captures
    with spans.span("serve.warmup", cat="serve"):
        eng.warmup()
    with spans.span("serve.ramp", cat="serve", requests=len(trace)):
        ramp = eng.run(trace, budget_s=budget_s, max_steps=50_000)
    leak = (eng.mem_leak_check() if eng.drained
            else {"ok": True, "leaked_pages": 0, "leaks": [],
                  "skipped": "ramp not drained"})

    # --- continuous-vs-static A/B: virtual clock, deterministic ---------
    ab = None
    if not skip_ab:
        with spans.span("serve.ab", cat="serve"):
            ab = ab_compare(params, cfg, trace, knobs, temperature=temperature,
                            sentinel=sentinel)

    # --- cached-vs-cold prefix A/B: virtual clock, deterministic --------
    prefix_ab = None
    if not skip_prefix_ab and knobs.get("prefix_cache"):
        with spans.span("serve.prefix_ab", cat="serve"):
            prefix_ab = prefix_ab_compare(params, cfg, trace, knobs,
                                          temperature=temperature, sentinel=sentinel)

    # --- spec-on-vs-off A/B: virtual clock, deterministic ---------------
    spec_ab = None
    if not skip_spec_ab and knobs.get("spec_k"):
        with spans.span("serve.spec_ab", cat="serve"):
            spec_ab = spec_ab_compare(params, cfg, trace, knobs, sentinel=sentinel)

    # --- elastic replica reshaping: armed chaos only --------------------
    # DDL25_CHAOS=traffic_spike@k / capacity_change@k:N / device_loss@k on
    # the elastic run's virtual clock; the reshape cell is what
    # --check-reshape gates.  Spec engines are left out, as in JAX.
    reshape = None
    chaos = ChaosInjector.from_env(state_dir=obs_dir)
    elastic_armed = (chaos.pending("traffic_spike") + chaos.pending("capacity_change")
                     + chaos.pending("device_loss"))
    if elastic_armed and not knobs.get("spec_k"):
        with spans.span("serve.elastic", cat="serve"):
            reshape = elastic_serve_run(params, cfg, trace, knobs, chaos=chaos,
                                        temperature=temperature, sentinel=sentinel)
    elif elastic_armed:
        import warnings

        warnings.warn("elastic serve reshaping skipped: speculative engines "
                      "(DDL25_SERVE_SPEC=1) are not covered yet", stacklevel=2)

    record: dict[str, Any] = {
        "record": "serve",
        "ts": time.time(),
        "git_sha": git_sha(),
        "host": host_fingerprint(dev),
        "key": {
            "model": model,
            "profile": spec.profile,
            "seed": spec.seed,
            "rate_rps": spec.rate_rps,
            "duration_s": spec.duration_s,
            "page_len": knobs["page_len"],
            "n_pages": knobs["n_pages"],
            "max_slots": knobs["max_slots"],
            # sentinel guards price into every program call, so on/off rows
            # are different measurements — keyed apart
            "sentinels": bool(sentinels.resolve(sentinel)[0]),
            "prefix_cache": bool(knobs.get("prefix_cache")),
            # spec, jitter and elastic enter the key only when on, so older
            # rows' keys do not shift
            **({"spec": True, "spec_k": knobs["spec_k"], "draft_layers": knobs["draft_layers"]}
               if knobs.get("spec_k") else {}),
            **({"max_new_jitter": jitter} if jitter else {}),
            **({"elastic": True} if reshape is not None else {}),
            **({
                "shared_prefixes": spec.shared_prefixes,
                "shared_prefix_len": spec.shared_prefix_len,
                "shared_suffix_len": spec.shared_suffix_len,
            } if spec.profile == "shared" else {}),
        },
        "requests": len(trace),
        "ramp": ramp,
        "pool_leak": leak,
        **({"ab": ab} if ab is not None else {}),
        **({"prefix_ab": prefix_ab} if prefix_ab is not None else {}),
        **({"spec_ab": spec_ab} if spec_ab is not None else {}),
        **({"reshape": reshape} if reshape is not None else {}),
        # bounded raw samples for serve_report's histograms
        "ttft_s": [round(x, 6) for x in eng.ttft_s[:512]],
        "tick_wall_s": [round(x, 6) for x in eng.tick_wall_s[:512]],
        "bench_wall_s": round(time.perf_counter() - t_start, 3),
        "device": str(dev),
    }

    if obs_dir:
        os.makedirs(obs_dir, exist_ok=True)
        path = os.path.join(obs_dir, SERVE_BASENAME)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(record, f, indent=1, default=str)
        os.replace(tmp, path)
        record["serve_json"] = path
    if ledger_path is not None:
        try:
            record["ledger"] = append_ledger(ledger_record(record), ledger_path)
        except OSError as e:  # a read-only FS must not kill the line
            record["ledger_error"] = str(e)
    return record


def ledger_record(record: dict[str, Any]) -> dict[str, Any]:
    """The trend row ``serve_report --check`` gates: the summary numbers
    only (never the raw sample lists)."""
    ramp = record["ramp"]
    out = {
        "record": "serve",
        "ts": record["ts"],
        "git_sha": record["git_sha"],
        "host": record["host"],
        "key": record["key"],
        **{k: ramp.get(k) for k in (
            "tokens_per_sec", "tokens_per_sec_per_chip", "ttft_s_p50", "ttft_s_p95",
            "ttft_decomp", "tok_latency_s_p50", "tok_latency_s_p95", "admitted",
            "rejected", "completed", "page_pool_peak_occupancy", "prefix_hit_rate",
            "prefill_tokens_saved", "prefill_flops_saved", "acceptance_rate",
            "draft_tokens_accepted", "draft_tokens_rejected", "tp", "weight_stream",
            "pool_bytes_per_chip", "param_bytes_per_chip")},
    }
    ab = record.get("ab")
    if ab:
        out["ab"] = _ab_cell(ab)
    pab = record.get("prefix_ab")
    if pab:
        out["prefix_ab"] = _prefix_ab_cell(pab)
    sab = record.get("spec_ab")
    if sab:
        out["spec_ab"] = _spec_ab_cell(sab)
    rsh = record.get("reshape")
    if rsh:
        out["reshape"] = _reshape_cell(rsh)
    return out


def _ab_cell(ab: dict[str, Any]) -> dict[str, Any]:
    return {k: ab.get(k) for k in (
        "budget_s", "continuous_tokens_at_budget", "static_tokens_at_budget",
        "advantage_tokens", "advantage_frac")}


def _prefix_ab_cell(pab: dict[str, Any]) -> dict[str, Any]:
    """The prefix A/B summary both the ledger row and telemetry.serve carry
    — what ``serve_report --check-prefix-ab`` gates."""
    cached = pab.get("cached") or {}
    cold = pab.get("cold") or {}
    return {
        **{k: pab.get(k) for k in (
            "budget_s", "cached_tokens_at_budget", "cold_tokens_at_budget",
            "advantage_tokens", "advantage_frac", "tokens_match", "compared_requests")},
        "cached_tokens_per_sec_per_chip": cached.get("tokens_per_sec_per_chip"),
        "cold_tokens_per_sec_per_chip": cold.get("tokens_per_sec_per_chip"),
        "prefix_hit_rate": cached.get("prefix_hit_rate"),
        "prefill_tokens_saved": cached.get("prefill_tokens_saved"),
        "prefill_flops_saved": cached.get("prefill_flops_saved"),
    }


def _spec_ab_cell(sab: dict[str, Any]) -> dict[str, Any]:
    """The speculative A/B summary both the ledger row and telemetry.serve
    carry -- what ``serve_report --check-spec-ab`` gates."""
    spec_arm = sab.get("spec") or {}
    nospec_arm = sab.get("nospec") or {}
    return {
        **{k: sab.get(k) for k in (
            "budget_s", "spec_tokens_at_budget", "nospec_tokens_at_budget",
            "advantage_tokens", "advantage_frac", "tokens_match", "compared_requests")},
        "spec_tokens_per_sec_per_chip": spec_arm.get("tokens_per_sec_per_chip"),
        "nospec_tokens_per_sec_per_chip": nospec_arm.get("tokens_per_sec_per_chip"),
        "acceptance_rate": spec_arm.get("acceptance_rate"),
        "draft_tokens_accepted": spec_arm.get("draft_tokens_accepted"),
        "draft_tokens_rejected": spec_arm.get("draft_tokens_rejected"),
    }


def _reshape_cell(rsh: dict[str, Any]) -> dict[str, Any]:
    """The elastic-reshape summary both the ledger row and telemetry.serve
    carry -- what ``serve_report --check-reshape`` gates; events keep their
    identity facts only (the whole dicts live in serve.json)."""
    return {
        "events": [{k: ev.get(k) for k in ("reason", "old", "new", "t", "t_end", "requeued",
                                           "wall_s")}
                   for ev in rsh.get("events") or []],
        **{k: rsh.get(k) for k in (
            "replicas_start", "replicas_end", "dropped_requests", "admitted", "completed",
            "rejected", "ttft_s_p95_steady", "ttft_s_p95_reshape", "reshape_window_requests",
            "steady_requests")},
    }


def serve_cell(record: dict[str, Any]) -> dict[str, Any]:
    """The ``telemetry.serve`` BENCH cell — every contract key (tokens/sec/
    chip, TTFT + per-token p50/p95, admission counters, pool occupancy) plus
    the A/B verdicts."""
    ramp = record["ramp"]
    cell = {
        **{k: ramp.get(k) for k in (
            "tokens_per_sec_per_chip", "ttft_s_p50", "ttft_s_p95", "ttft_decomp",
            "tok_latency_s_p50", "tok_latency_s_p95", "admitted", "rejected",
            "rejected_by_reason", "completed", "generated_tokens", "queue_depth_max",
            "page_pool_peak_pages", "page_pool_peak_occupancy", "pool_ok_failures",
            "n_chips", "prefix_hit_rate", "prefill_tokens_saved", "prefill_flops_saved",
            "prefix", "acceptance_rate", "draft_tokens_accepted", "draft_tokens_rejected",
            "spec", "tp", "weight_stream", "pool_bytes_per_chip", "param_bytes_per_chip")},
        "requests": record.get("requests"),
        "key": record.get("key"),
        "pool_leak": record.get("pool_leak"),
    }
    if record.get("ab"):
        cell["ab"] = _ab_cell(record["ab"])
    if record.get("prefix_ab"):
        cell["prefix_ab"] = _prefix_ab_cell(record["prefix_ab"])
    if record.get("spec_ab"):
        cell["spec_ab"] = _spec_ab_cell(record["spec_ab"])
    if record.get("reshape"):
        cell["reshape"] = _reshape_cell(record["reshape"])
    for k in ("ledger", "ledger_error", "serve_json"):
        if record.get(k):
            cell[k] = record[k]
    return cell
