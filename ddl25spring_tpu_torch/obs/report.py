"""Fold a telemetry run directory into a summary: the port's counterpart of
the JAX package's ``obs/report.py``, importable so ``bench`` embeds the same
summary in its JSON line, and a CLI in place of ``tools/obs_report.py``
(which imports the JAX package).

A run directory holds what the port's drivers wrote:

    run_dir/metrics.jsonl   header + per-step records (MetricsLogger)
    run_dir/counters.json   scalar/series/static counters
    run_dir/trace.json      Chrome-trace host spans
    run_dir/timeline.jsonl  the typed run timeline
    run_dir/flight.json     the flight recorder's dump
    run_dir/perf.json       the measured perf record (obs/perfscope.py)
    run_dir/mem.json        the memory record (obs/memscope.py)
    run_dir/goodput.json    the goodput decomposition (obs/goodput.py)
    run_dir/serve.json      a ``bench --serve`` record (serve/driver.py)
    run_dir/ckpt/manifest.json  the autosave manifest (ft/)

The summary derives steps/sec p50/p95 from the per-step ``wall_s``
distribution (p50, not the mean: one GC pause must not skew a bench line),
MFU from the header's FLOPs and chip peak, and the GPipe bubble fraction
from the header's (S, M).  The compile-analytics section of the JAX report
(``compile_report.json``) has no counterpart until ROADMAP A12, and the
report says so.

CLI, with ``tools/obs_report.py``'s flags and exit codes::

    python -m ddl25spring_tpu_torch.obs.report RUN_DIR [--json]
        [--check-health [--slo-floor FRACTION]]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Any

import numpy as np

from ddl25spring_tpu_torch.obs.counters import gpipe_bubble_fraction
from ddl25spring_tpu_torch.obs.logger import read_jsonl

#: the artifact a ``bench --serve`` run drops in its obs dir
SERVE_BASENAME = "serve.json"

#: what stands in the report for the JAX package's compile analytics
COMPILE_REPORT_ABSENT = ("not in the port yet: it reads compiled XLA programs "
                         "(ROADMAP A12)")


def _pct(xs: list[float], q: float) -> float:
    return float(np.percentile(np.asarray(xs, dtype=np.float64), q))


def _phase_summary(steps: list[dict], header: dict) -> dict[str, Any]:
    # scan-fused dispatches log one record per CALL covering k train steps
    # (wall_s and samples are per-dispatch); normalize everything to
    # per-train-step so fused and unfused phases report the same units
    k = max((int(r.get("fused_steps") or 1) for r in steps), default=1)
    wall = [float(r["wall_s"]) / k for r in steps if r.get("wall_s")]
    out: dict[str, Any] = {"steps": len(steps) * k}
    if k > 1:
        out["fused_steps"] = k
        out["dispatches"] = len(steps)
    if not wall:
        return out
    p50, p95 = _pct(wall, 50), _pct(wall, 95)
    out.update(
        step_s_p50=p50,
        step_s_p95=p95,
        step_s_min=min(wall),
        step_s_mean=sum(wall) / len(wall),
        steps_per_sec_p50=1.0 / p50 if p50 > 0 else None,
        steps_per_sec_p95=1.0 / p95 if p95 > 0 else None,
    )
    samples = [float(r["samples"]) / k for r in steps if r.get("samples")]
    if samples and p50 > 0:
        per_step = samples[0]
        n_chips = int(header.get("n_chips") or 1)
        out["samples_per_sec_p50"] = per_step / p50
        out["samples_per_sec_per_chip_p50"] = per_step / p50 / n_chips
    tokens = [float(r["tokens"]) / k for r in steps if r.get("tokens")]
    if tokens and p50 > 0:
        out["tokens_per_sec_p50"] = tokens[0] / p50
    losses = [float(r["loss"]) for r in steps if r.get("loss") is not None]
    if losses:
        out["loss_last"] = losses[-1]

    # MFU from the header's compiled-FLOPs count at this phase's p50
    flops = header.get("flops_per_step")
    if flops and p50 > 0:
        n_chips = int(header.get("n_chips") or 1)
        achieved = float(flops) / p50 / n_chips
        out["achieved_tflops_per_chip"] = achieved / 1e12
        peak = header.get("peak_flops_per_chip")
        out["mfu"] = (achieved / float(peak)) if peak else None
    return out


def summarize_run(run_dir: str) -> dict[str, Any]:
    """Summarize one run directory.  Raises FileNotFoundError when there
    is nothing at all to report on — but a dir holding only serve.json /
    flight.json (a ``bench.py --serve`` run writes no metrics.jsonl:
    its per-token records live in serve.json) still summarizes."""
    from ddl25spring_tpu_torch.obs.recorder import FLIGHT_BASENAME

    metrics_path = os.path.join(run_dir, "metrics.jsonl")
    try:
        records = read_jsonl(metrics_path)
    except FileNotFoundError:
        if not any(
            os.path.exists(os.path.join(run_dir, f))
            for f in (SERVE_BASENAME, FLIGHT_BASENAME)
        ):
            raise
        records = []
    # a run may append late header records for facts only known at the
    # end (compiled flops, measured link bandwidth): merge them in order
    header: dict[str, Any] = {}
    for r in records:
        if r.get("record") == "header":
            header.update({k: v for k, v in r.items() if v is not None})
    steps = [r for r in records if r.get("record") == "step"]

    phases: dict[str, list[dict]] = {}
    for r in steps:
        phases.setdefault(r.get("label", "run"), []).append(r)

    out: dict[str, Any] = {
        "run_dir": run_dir,
        "header": header,
        "phases": {k: _phase_summary(v, header) for k, v in phases.items()},
    }

    # GPipe bubble: analytic from the recorded schedule shape; measured
    # tick cadence alongside when the pipeline's tick counters fired
    S = header.get("num_stages")
    M = header.get("num_microbatches")
    cpath = os.path.join(run_dir, "counters.json")
    counters = None
    if os.path.exists(cpath):
        with open(cpath) as f:
            counters = json.load(f)
        statics = counters.get("static", {})
        # the instrumented pipeline records its own (S, M); use them when
        # the driver's header didn't carry the schedule shape
        S = S or statics.get("pipeline.num_stages")
        M = M or statics.get("pipeline.num_microbatches")
    if S and M:
        out["bubble_fraction"] = gpipe_bubble_fraction(S, M)
        out.setdefault("num_stages", S)
        out.setdefault("num_microbatches", M)
    if counters is not None:
        out["counters"] = counters
        ticks = counters.get("series", {}).get("pipeline.tick")
        if ticks and len(ticks) >= 3:
            # the callback fires once per mesh shard, so every tick index
            # arrives D times nearly simultaneously, and the index resets
            # to 0 on each new scan invocation (next step / bwd recompute).
            # Keep only the first arrival of each index and measure
            # consecutive-index transitions within one scan pass — the
            # raw diff's intra-tick gaps would swamp the median on D >= 3.
            dts = []
            prev_i = prev_t = None
            for i, t in ticks:
                if prev_i is not None and i == prev_i:
                    continue  # another shard's arrival for the same tick
                if prev_i is not None and i == prev_i + 1 and t > prev_t:
                    dts.append(t - prev_t)
                prev_i, prev_t = i, t
            if dts:
                out["tick_interval_s_p50"] = float(np.percentile(dts, 50))

    # the unified run timeline, when the run configured one
    # (obs/timeline.py): event counts by kind, the
    # slowest requests with their TTFT decomposition, and which
    # requests rode through each elastic reshape window (membership by
    # virtual clock — comparable across deterministic A/B runs)
    from ddl25spring_tpu_torch.obs.timeline import TIMELINE_BASENAME, read_timeline

    tlpath = os.path.join(run_dir, TIMELINE_BASENAME)
    if os.path.exists(tlpath):
        try:
            _, tl_events = read_timeline(run_dir)
            tl_counts: dict[str, int] = {}
            for e in tl_events:
                k = e.get("kind", "?")
                tl_counts[k] = tl_counts.get(k, 0) + 1
            firsts = [
                e for e in tl_events
                if e.get("kind") == "serve_first_token"
                and isinstance(e.get("ttft_s"), (int, float))
            ]
            slowest = [
                {
                    k: e.get(k)
                    for k in ("rid", "engine", "replica", "ttft_s",
                              "queue_wait_s", "prefill_s",
                              "first_decode_s", "vt_s")
                }
                for e in sorted(
                    firsts, key=lambda e: -e["ttft_s"])[:5]
            ]
            windows = []
            for end in tl_events:
                if end.get("kind") != "reshape_end":
                    continue
                t0, t1 = end.get("t"), end.get("t_end")
                members = sorted({
                    e["rid"] for e in tl_events
                    if "rid" in e
                    and e.get("engine") == end.get("engine")
                    and isinstance(e.get("vt_s"), (int, float))
                    and t0 is not None and t1 is not None
                    and t0 <= e["vt_s"] <= t1
                })
                windows.append({
                    "reason": end.get("reason"),
                    "t": t0,
                    "t_end": t1,
                    "old": end.get("old"),
                    "new": end.get("new"),
                    "requests": members,
                })
            out["timeline"] = {
                "events": len(tl_events),
                "counts": tl_counts,
                "slowest_requests": slowest,
                "reshape_windows": windows,
            }
        except (ValueError, json.JSONDecodeError, OSError) as e:
            # a torn line (killed mid-write) must not cost the rest
            out["timeline"] = {
                "error": f"unreadable {TIMELINE_BASENAME}: {e}"
            }

    tpath = os.path.join(run_dir, "trace.json")
    if os.path.exists(tpath):
        with open(tpath) as f:
            trace = json.load(f)
        evs = [
            e for e in trace.get("traceEvents", []) if e.get("ph") == "X"
        ]
        out["span_counts"] = {
            n: sum(1 for e in evs if e["name"] == n)
            for n in sorted({e["name"] for e in evs})
        }

    # runtime health, when a flight recorder dumped into this run dir
    # (obs/recorder.py): sentinel violations, the last
    # step records, and — for stall dumps — the host thread stacks
    from ddl25spring_tpu_torch.obs.recorder import FLIGHT_BASENAME

    fpath = os.path.join(run_dir, FLIGHT_BASENAME)
    if os.path.exists(fpath):
        try:
            with open(fpath) as f:
                fl = json.load(f)
            out["health"] = {
                "reason": fl.get("reason"),
                "recorded": fl.get("recorded"),
                "violations": fl.get("violations", 0),
                "last_violation": fl.get("last_violation"),
                "stall": fl.get("stall"),
                "thread_stacks": sorted(fl.get("thread_stacks", {})),
                "meta": fl.get("meta", {}),
                "last_records": (fl.get("records") or [])[-5:],
                "exception": fl.get("exception"),
            }
            # recovery facts (the ft/ layer): the flight meta carries
            # the durable-checkpoint annotations and the per-kind
            # counters carry save/restore traffic — enough to answer
            # "what survived" from the dump alone
            meta = fl.get("meta") or {}
            counts = fl.get("counts") or {}
            recovery = {
                k: meta[k]
                for k in (
                    "ckpt_dir",
                    "ckpt_last_durable_step",
                    "resumed_from_step",
                    "steps_replayed",
                )
                if meta.get(k) is not None
            }
            for kind, label in (
                ("save", "saves"),
                ("save_skipped", "saves_skipped"),
                ("restore", "restores"),
                ("chaos", "chaos_faults"),
                # elastic in-run reshapes (ft/elastic.py): RECOVERY
                # events, not violations — the health gate reports
                # them informationally and never fails on them
                ("reshape", "reshapes"),
            ):
                if counts.get(kind):
                    recovery[label] = counts[kind]
            if counts.get("reshape"):
                reshape_recs = [
                    r for r in fl.get("records") or []
                    if r.get("kind") == "reshape"
                ]
                if reshape_recs:
                    recovery["last_reshape"] = reshape_recs[-1]
            if recovery:
                out["recovery"] = recovery
        except (json.JSONDecodeError, OSError) as e:
            # a truncated dump must not cost the measured metrics
            out["health"] = {
                "error": f"unreadable {FLIGHT_BASENAME}: {e}"
            }

    # the autosave manifest (run_dir/ckpt by bench convention, or
    # wherever the flight meta points): the checkpoint layer's own
    # account of the last durable step — readable even when the crash
    # never managed a flight dump (ft.manifest is stdlib-only: the
    # post-mortem must work even where orbax itself is what broke)
    from ddl25spring_tpu_torch.ft.manifest import read_manifest

    # the flight meta's recorded ckpt_dir is authoritative (a custom
    # --ckpt-dir run must not be shadowed by a stale manifest sitting
    # at the default location); the run_dir/ckpt convention is the
    # fallback for dumps that never got annotated
    rec_dir = (out.get("recovery") or {}).get("ckpt_dir")
    ckpt_dirs = ([rec_dir] if rec_dir else []) + [
        os.path.join(run_dir, "ckpt")
    ]
    for cd in ckpt_dirs:
        man = read_manifest(cd)
        if man is not None:
            rec = out.setdefault("recovery", {})
            rec["manifest"] = {
                k: man.get(k)
                for k in ("last_durable_step", "last_requested_step",
                          "save_every", "saves", "save_skipped")
            }
            rec.setdefault("ckpt_dir", cd)
            break

    # measured perf record, when a bench/perfscope run dropped one here
    # (obs/perfscope.py): step-wall decomposition into
    # compute vs exposed comms, measured MFU against the calibrated
    # chip peak, and the projection error vs the compile-time roofline
    from ddl25spring_tpu_torch.obs.perfscope import PERF_BASENAME

    ppath = os.path.join(run_dir, PERF_BASENAME)
    if os.path.exists(ppath):
        try:
            with open(ppath) as f:
                out["perf"] = json.load(f)
        except (json.JSONDecodeError, OSError) as e:
            out["perf"] = {"error": f"unreadable {PERF_BASENAME}: {e}"}

    # serving record, when a `bench.py --serve` run dropped one here
    # (serve/driver.py): admission counters, TTFT /
    # per-token latency percentiles, page-pool occupancy, and the
    # continuous-vs-static A/B — the Serving section below
    spath = os.path.join(run_dir, SERVE_BASENAME)
    if os.path.exists(spath):
        try:
            with open(spath) as f:
                sdoc = json.load(f)
            out["serve"] = {
                "key": sdoc.get("key"),
                "requests": sdoc.get("requests"),
                "ramp": sdoc.get("ramp"),
                "ab": sdoc.get("ab"),
                "prefix_ab": sdoc.get("prefix_ab"),
                "spec_ab": sdoc.get("spec_ab"),
                "tp_ab": sdoc.get("tp_ab"),
                "reshape": sdoc.get("reshape"),
                "git_sha": sdoc.get("git_sha"),
            }
        except (json.JSONDecodeError, OSError) as e:
            out["serve"] = {"error": f"unreadable {SERVE_BASENAME}: {e}"}

    # runtime memory record, when a memscope-wired run dropped one here
    # (obs/memscope.py): live-bytes/RSS high-water vs
    # the accounted budget, pool telemetry, leak + growth verdicts —
    # the Memory section below, gated by tools/mem_report.py --check
    from ddl25spring_tpu_torch.obs.memscope import MEM_BASENAME

    mpath = os.path.join(run_dir, MEM_BASENAME)
    if os.path.exists(mpath):
        try:
            with open(mpath) as f:
                out["mem"] = json.load(f)
        except (json.JSONDecodeError, OSError) as e:
            out["mem"] = {"error": f"unreadable {MEM_BASENAME}: {e}"}

    # goodput decomposition, when a graft-goodput run/lineage dropped
    # one here (obs/goodput.py): the badput taxonomy,
    # the sum-to-wall contract, and — for serve scopes — SLO attainment
    # and availability; trend/gate with tools/goodput_report.py
    from ddl25spring_tpu_torch.obs.goodput import (
        GOODPUT_BASENAME,
        read_run_goodput,
    )

    if os.path.exists(os.path.join(run_dir, GOODPUT_BASENAME)):
        gp = read_run_goodput(run_dir)
        out["goodput"] = (
            gp if isinstance(gp, dict) and gp.get("record") == "goodput"
            else {"error": f"unreadable {GOODPUT_BASENAME}"}
        )

    return out


def format_report(summary: dict[str, Any]) -> str:
    """Render the summary as the aligned table the CLI prints."""
    h = summary.get("header", {})
    lines = [f"run: {summary['run_dir']}"]
    meta_bits = []
    for k in ("layout", "topology", "git_sha", "torch_version"):
        if h.get(k):
            v = h[k]
            meta_bits.append(f"{k}={str(v)[:12] if k == 'git_sha' else v}")
    if h.get("mesh"):
        meta_bits.append(f"mesh={h['mesh']}")
    if h.get("device"):
        d = h["device"]
        meta_bits.append(f"device={d.get('kind') or d.get('platform')}")
    if meta_bits:
        lines.append("  " + "  ".join(meta_bits))
    lines.append("")

    def fmt(v, unit="", nd=2):
        if v is None:
            return "n/a"
        return f"{v:.{nd}f}{unit}"

    cols = (
        f"{'phase':<24}{'steps':>6}{'step p50':>12}{'step p95':>12}"
        f"{'steps/s p50':>13}{'samp/s/chip':>13}{'MFU':>8}"
    )
    lines.append(cols)
    lines.append("-" * len(cols))
    for name, ph in summary.get("phases", {}).items():
        lines.append(
            f"{name:<24}{ph.get('steps', 0):>6}"
            f"{fmt(ph.get('step_s_p50'), ' s', 4):>12}"
            f"{fmt(ph.get('step_s_p95'), ' s', 4):>12}"
            f"{fmt(ph.get('steps_per_sec_p50'), '', 2):>13}"
            f"{fmt(ph.get('samples_per_sec_per_chip_p50'), '', 1):>13}"
            f"{fmt(ph.get('mfu'), '', 4):>8}"
        )
    lines.append("")

    bf = summary.get("bubble_fraction")
    S = summary.get("num_stages") or h.get("num_stages")
    M = summary.get("num_microbatches") or h.get("num_microbatches")
    if bf is not None:
        lines.append(
            f"pipeline bubble fraction: {bf:.4f} "
            f"(GPipe (S-1)/(M+S-1) at S={S}, M={M})"
        )
    else:
        lines.append("pipeline bubble fraction: 0.0000 (no pipeline axis)")
    if summary.get("tick_interval_s_p50") is not None:
        lines.append(
            f"measured tick interval p50: "
            f"{summary['tick_interval_s_p50'] * 1e3:.2f} ms"
        )
    if h.get("h2d_mib_per_s"):
        lines.append(f"host->device link: {h['h2d_mib_per_s']:.1f} MiB/s")

    for name, ph in summary.get("phases", {}).items():
        if ph.get("achieved_tflops_per_chip") is not None:
            lines.append(
                f"achieved TFLOP/s/chip ({name}): "
                f"{ph['achieved_tflops_per_chip']:.2f}"
                + (
                    ""
                    if ph.get("mfu") is not None
                    else "  (no chip peak in the run header — not even "
                         "the calibrated cpu-host one; MFU n/a)"
                )
            )
            break

    p = summary.get("perf")
    if p:
        lines.append("")
        lines.append(
            "performance (perf.json — measured, not projected; "
            "see tools/perf_report.py for the cross-run trend):"
        )
        if p.get("error"):
            lines.append(f"  {p['error']}")
        else:
            def pms(key):
                v = p.get(key)
                return f"{v * 1e3:.3f} ms" if v is not None else "n/a"

            lines.append(
                f"  step p50 {pms('step_s_p50')}  p95 {pms('step_s_p95')}"
                f"  compute-only {pms('compute_s_p50')}"
                f"  exposed comms {pms('exposed_comms_s')}"
            )
            peak = p.get("peak_flops_per_chip")
            mm = p.get("measured_mfu")
            pm = p.get("projected_mfu")
            pe = p.get("projection_err")
            lines.append(
                "  measured MFU "
                + (f"{mm:.4f}" if mm is not None else "n/a")
                + (f" (chip {p.get('chip')}, peak "
                   f"{peak / 1e12:.2f} TFLOP/s {p.get('peak_source')})"
                   if peak else "")
                + (f"  projected {pm:.4f}"
                   f" [{p.get('projected_bound')}-bound]"
                   if pm is not None else "")
                + (f"  err {pe * 100:+.1f}%" if pe is not None else "")
            )
            eff = p.get("overlap_eff")
            n_sites = len(p.get("micro") or [])
            lines.append(
                "  overlap efficiency "
                + (f"{eff:.3f}" if eff is not None
                   else "n/a (no costed collectives)")
                + f"  (micro comms total {pms('micro_total_s')}"
                + f" over {n_sites} inventory site(s))"
            )

    sv = summary.get("serve")
    if sv:
        lines.append("")
        lines.append(
            "serving (serve.json — bench.py --serve; trend/gate with "
            "tools/serve_report.py):"
        )
        if sv.get("error"):
            lines.append(f"  {sv['error']}")
        else:
            ramp = sv.get("ramp") or {}
            key = sv.get("key") or {}
            if key:
                lines.append(
                    "  " + "  ".join(f"{k}={key[k]}" for k in sorted(key))
                )

            def sms(v):
                return f"{v * 1e3:.2f} ms" if isinstance(
                    v, (int, float)) else "n/a"

            lines.append(
                f"  requests {sv.get('requests')}  admitted "
                f"{ramp.get('admitted')}  rejected {ramp.get('rejected')}"
                f" {ramp.get('rejected_by_reason') or {}}  completed "
                f"{ramp.get('completed')}"
            )
            tps = ramp.get("tokens_per_sec_per_chip")
            lines.append(
                "  tokens/sec/chip "
                + (f"{tps:.2f}" if isinstance(tps, (int, float)) else "n/a")
                + f"  TTFT p50 {sms(ramp.get('ttft_s_p50'))} p95 "
                f"{sms(ramp.get('ttft_s_p95'))}"
                f"  per-token p50 {sms(ramp.get('tok_latency_s_p50'))} "
                f"p95 {sms(ramp.get('tok_latency_s_p95'))}"
            )
            dec = ramp.get("ttft_decomp")
            if dec and dec.get("requests"):
                lines.append(
                    f"  TTFT decomposition ({dec.get('clock')} clock, "
                    f"{dec['requests']} req): queue-wait p50 "
                    f"{sms(dec.get('queue_wait_s_p50'))} p95 "
                    f"{sms(dec.get('queue_wait_s_p95'))}  prefill p50 "
                    f"{sms(dec.get('prefill_s_p50'))} p95 "
                    f"{sms(dec.get('prefill_s_p95'))}  first-decode "
                    f"p50 {sms(dec.get('first_decode_s_p50'))} p95 "
                    f"{sms(dec.get('first_decode_s_p95'))}"
                )
            occ = ramp.get("page_pool_peak_occupancy")
            # occupancy in PER-CHIP bytes, not just global page counts:
            # under tp the page count is unchanged (pages are a global
            # logical resource) while each chip holds 1/tp of every
            # page's head dim — counts alone would read as if sharding
            # shrank nothing
            pool_pc = ramp.get("pool_bytes_per_chip")
            lines.append(
                f"  page pool peak {ramp.get('page_pool_peak_pages')}"
                f"/{ramp.get('page_pool_pages')} pages"
                + (f" ({occ * 100:.1f}%)" if isinstance(
                    occ, (int, float)) else "")
                + (f"  {pool_pc / 1024:.1f} KiB/chip" if isinstance(
                    pool_pc, (int, float)) else "")
                + f"  queue depth max {ramp.get('queue_depth_max')}"
                + f"  pool-ok failures {ramp.get('pool_ok_failures')}"
            )
            tp = ramp.get("tp")
            if isinstance(tp, int) and tp > 1:
                param_pc = ramp.get("param_bytes_per_chip")
                lines.append(
                    f"  tp {tp}"
                    + (" (weight streaming)" if ramp.get("weight_stream")
                       else "")
                    + (f"  params {param_pc / 1024:.1f} KiB/chip"
                       if isinstance(param_pc, (int, float)) else "")
                )
            prefix = ramp.get("prefix") or {}
            if prefix.get("enabled"):
                hit = ramp.get("prefix_hit_rate")
                lines.append(
                    "  prefix cache hit rate "
                    + (f"{hit * 100:.1f}%" if isinstance(
                        hit, (int, float)) else "n/a")
                    + f"  prefill saved {ramp.get('prefill_tokens_saved')}"
                    f" tokens / {ramp.get('prefill_flops_saved')} FLOPs"
                    f"  cached pages {prefix.get('cached_pages')}"
                    f"  evictions {prefix.get('evictions')}"
                )
            ab = sv.get("ab")
            if ab:
                lines.append(
                    "  A/B continuous "
                    f"{ab.get('continuous_tokens_at_budget')} vs static "
                    f"{ab.get('static_tokens_at_budget')} tokens at "
                    f"budget {ab.get('budget_s')} s  (advantage "
                    f"{ab.get('advantage_tokens')})"
                )
            pab = sv.get("prefix_ab")
            if pab:
                lines.append(
                    "  prefix A/B cached "
                    f"{pab.get('cached_tokens_at_budget')} vs cold "
                    f"{pab.get('cold_tokens_at_budget')} tokens at "
                    f"budget {pab.get('budget_s')} s  (advantage "
                    f"{pab.get('advantage_tokens')}, tokens match "
                    f"{pab.get('tokens_match')})"
                )
            spec = ramp.get("spec") or {}
            if spec.get("enabled"):
                acc = ramp.get("acceptance_rate")
                lines.append(
                    f"  speculative decode k={spec.get('k')} drafter "
                    f"{spec.get('draft_layers')}L: acceptance "
                    + (f"{acc * 100:.1f}%" if isinstance(
                        acc, (int, float)) else "n/a")
                    + f" ({ramp.get('draft_tokens_accepted')} acc / "
                    f"{ramp.get('draft_tokens_rejected')} rej)  "
                    f"rounds {spec.get('rounds')}  draft steps "
                    f"{spec.get('draft_steps')}  verify steps "
                    f"{spec.get('verify_steps')}"
                )
            sab = sv.get("spec_ab")
            if sab:
                lines.append(
                    "  spec A/B spec "
                    f"{sab.get('spec_tokens_at_budget')} vs non-spec "
                    f"{sab.get('nospec_tokens_at_budget')} tokens at "
                    f"budget {sab.get('budget_s')} s  (advantage "
                    f"{sab.get('advantage_tokens')}, tokens match "
                    f"{sab.get('tokens_match')})"
                )
            tab = sv.get("tp_ab")
            if tab:
                # ledger cells flatten the arms; the raw serve.json
                # record nests them under sharded/dense — accept both
                shard_b = tab.get("tp_mem_budget_bytes_per_chip")
                if shard_b is None:
                    shard_b = (tab.get("sharded") or {}).get(
                        "mem_budget_bytes_per_chip")
                dense_b = tab.get("dense_mem_budget_bytes_per_chip")
                if dense_b is None:
                    dense_b = (tab.get("dense") or {}).get(
                        "mem_budget_bytes_per_chip")
                lines.append(
                    f"  tp A/B (tp={tab.get('tp')}) sharded "
                    f"{tab.get('tp_tokens_at_budget')} vs dense "
                    f"{tab.get('dense_tokens_at_budget')} tokens at "
                    f"budget {tab.get('budget_s')} s  (tokens match "
                    f"{tab.get('tokens_match')}, per-chip "
                    + (f"{shard_b / 1024:.1f}" if isinstance(
                        shard_b, (int, float)) else "n/a")
                    + " vs "
                    + (f"{dense_b / 1024:.1f} KiB" if isinstance(
                        dense_b, (int, float)) else "n/a")
                    + f", shrunk {tab.get('budget_shrunk')})"
                )
            rsh = sv.get("reshape")
            if rsh:
                evs = rsh.get("events") or []
                p95r = rsh.get("ttft_s_p95_reshape")
                p95s = rsh.get("ttft_s_p95_steady")
                lines.append(
                    f"  elastic reshape: {len(evs)} event(s) "
                    + " ".join(
                        f"[{e.get('reason')} {e.get('old')}->"
                        f"{e.get('new')}]" for e in evs
                    )
                    + f"  dropped {rsh.get('dropped_requests')}"
                    + f"  TTFT p95 window {sms(p95r)} vs steady "
                    f"{sms(p95s)}"
                )

    mem = summary.get("mem")
    if mem:
        lines.append("")
        lines.append(
            "memory (mem.json — graft-mem runtime observatory; gate "
            "with tools/mem_report.py --check):"
        )
        if mem.get("error"):
            lines.append(f"  {mem['error']}")
        else:
            def mib(v):
                return (
                    f"{v / (1 << 20):.1f} MiB"
                    if isinstance(v, (int, float)) else "n/a"
                )

            scope = mem.get("memscope") or {}
            lines.append(
                f"  live bytes peak {mib(scope.get('live_bytes_peak'))}"
                f"  host RSS peak {mib(scope.get('rss_bytes_peak'))}"
                f"  samples {scope.get('samples')}"
            )
            b = mem.get("budget") or {}
            if b.get("available"):
                lines.append(
                    f"  budget ({b.get('source')}) "
                    f"{mib(b.get('budget_bytes'))}  measured/budget "
                    f"{b.get('ratio')}  within band "
                    f"(tol {b.get('tolerance')}): {b.get('within_band')}"
                )
            pool = mem.get("pool")
            if pool:
                lines.append(
                    f"  kv pool {pool.get('used_pages')}"
                    f"/{pool.get('n_pages')} pages used "
                    f"(cache-held {pool.get('cache_held_pages')}, "
                    f"table-held {pool.get('table_held_pages')})  "
                    f"fragmentation {pool.get('fragmentation')}"
                )
            lines.append(
                f"  leaked pages {mem.get('leaked_pages', 0)}  "
                f"growth violations {mem.get('growth_violations', 0)}"
                + (
                    f"  reshape step-downs "
                    f"{len(mem.get('reshape_steps') or [])}"
                    if mem.get("reshape_steps") is not None else ""
                )
            )

    gp = summary.get("goodput")
    if gp:
        lines.append("")
        lines.append(
            "goodput (goodput.json — graft-goodput lineage "
            "decomposition; trend/gate with tools/goodput_report.py):"
        )
        if gp.get("error"):
            lines.append(f"  {gp['error']}")
        else:
            total = gp.get("total_wall_s")
            fu = gp.get("fraction_useful")
            lines.append(
                f"  scope {gp.get('scope')}  lineage "
                f"{gp.get('lineage_id')}  attempts "
                f"{gp.get('attempts') or gp.get('attempt') or 1}  "
                f"chips {gp.get('chips')}  wall "
                + (f"{total:.3f} s" if isinstance(total, (int, float))
                   else "n/a")
            )
            seconds = gp.get("seconds") or {}
            if seconds and isinstance(total, (int, float)) and total > 0:
                for bucket, secs in sorted(
                        seconds.items(), key=lambda kv: -kv[1]):
                    if not secs:
                        continue
                    lines.append(
                        f"  {bucket:<18} {secs:>9.3f} s "
                        f"({secs / total * 100:5.1f}%)"
                    )
            sc = gp.get("sum_check") or {}
            lines.append(
                "  fraction useful "
                + (f"{fu:.4f}" if isinstance(fu, (int, float))
                   else "n/a")
                + f"  replayed steps {gp.get('replayed_steps_count', 0)}"
                + f"  sum-to-wall ok: {sc.get('ok')}"
            )
            if gp.get("scope") == "serve":
                att = gp.get("slo_attainment")
                avail = gp.get("availability")
                gtps = gp.get("goodput_tokens_per_sec_per_chip")
                slo = gp.get("slo") or {}
                lines.append(
                    "  SLO attainment "
                    + (f"{att * 100:.1f}%" if isinstance(
                        att, (int, float)) else "n/a")
                    + (f" (TTFT<={slo.get('ttft_ms')}ms, "
                       f"tok<={slo.get('tok_ms')}ms, "
                       f"{slo.get('clock')} clock)" if slo else "")
                    + "  availability "
                    + (f"{avail * 100:.1f}%" if isinstance(
                        avail, (int, float)) else "n/a")
                    + "  goodput tok/s/chip "
                    + (f"{gtps:.2f}" if isinstance(
                        gtps, (int, float)) else "n/a")
                )

    c = summary.get("counters", {})
    statics = c.get("static", {})
    scalars = c.get("scalars", {})
    if statics or scalars:
        lines.append("")
        lines.append("counters:")
        for k, v in sorted(statics.items()):
            lines.append(f"  {k:<40} {v}")
        for k, s in sorted(scalars.items()):
            lines.append(
                f"  {k:<40} count={int(s['count'])} mean={s['mean']:.6g} "
                f"last={s.get('last', float('nan')):.6g}"
            )
    if summary.get("span_counts"):
        lines.append("")
        lines.append("host spans (trace.json — load in Perfetto):")
        for n, cnt in summary["span_counts"].items():
            lines.append(f"  {n:<40} x{cnt}")

    tl = summary.get("timeline")
    if tl:
        lines.append("")
        lines.append(
            "timeline (timeline.jsonl — merge with "
            "tools/trace_export.py):"
        )
        if tl.get("error"):
            lines.append(f"  {tl['error']}")
        else:
            lines.append(
                f"  {tl.get('events', 0)} event(s): "
                + "  ".join(
                    f"{k}x{v}" for k, v in sorted(
                        (tl.get("counts") or {}).items())
                )
            )

            def tms(v):
                return f"{v * 1e3:.2f} ms" if isinstance(
                    v, (int, float)) else "n/a"

            if tl.get("slowest_requests"):
                lines.append("  slowest requests (TTFT = queue-wait + "
                             "prefill + first-decode):")
                for r in tl["slowest_requests"]:
                    lines.append(
                        f"    rid={r.get('rid')} "
                        f"[{r.get('engine')}:r{r.get('replica')}] "
                        f"TTFT {tms(r.get('ttft_s'))} = "
                        f"queue {tms(r.get('queue_wait_s'))} + "
                        f"prefill {tms(r.get('prefill_s'))} + "
                        f"first-decode {tms(r.get('first_decode_s'))}"
                    )
            for w in tl.get("reshape_windows") or []:
                reqs = w.get("requests") or []
                lines.append(
                    f"  reshape window [{w.get('reason')} "
                    f"{w.get('old')}->{w.get('new')}] vt "
                    f"{w.get('t')}..{w.get('t_end')} s: "
                    f"{len(reqs)} request(s) in flight "
                    f"{reqs[:10]}{'...' if len(reqs) > 10 else ''}"
                )

    h = summary.get("health")
    if h:
        lines.append("")
        lines.append("health (flight.json — the crash-surviving ring):")
        if h.get("error"):
            lines.append(f"  {h['error']}")
        else:
            lines.append(
                f"  dump reason: {h.get('reason')}  records: "
                f"{h.get('recorded')}  sentinel violations: "
                f"{h.get('violations', 0)}"
            )
            lv = h.get("last_violation")
            if lv:
                lines.append(
                    f"  last violation: strategy={lv.get('strategy')} "
                    f"step={lv.get('step')} "
                    f"metric={lv.get('violating_metric')} "
                    f"leaves={lv.get('nonfinite_leaves', [])}"
                )
            st = h.get("stall")
            if st:
                lines.append(
                    f"  STALL: watchdog={st.get('watchdog')} idle "
                    f"{st.get('idle_s')}s past deadline "
                    f"{st.get('deadline_s')}s — "
                    f"{len(h.get('thread_stacks', []))} host thread "
                    "stacks in the dump"
                )
            if h.get("exception"):
                lines.append(f"  died on: {h['exception']}")
            for r in h.get("last_records", []):
                bits = "  ".join(
                    f"{k}={r[k]}"
                    for k in ("strategy", "step", "loss", "grad_norm",
                              "wall_s", "violating_metric")
                    if k in r
                )
                lines.append(f"  [{r.get('kind', 'step')}] {bits}")

    rec = summary.get("recovery")
    if rec:
        lines.append("")
        lines.append("recovery (ft/ autosave + flight meta — what survived):")
        man = rec.get("manifest") or {}
        durable = rec.get("ckpt_last_durable_step",
                          man.get("last_durable_step"))
        bits = [f"last durable step: {durable}"]
        if rec.get("ckpt_dir"):
            bits.append(f"ckpt: {rec['ckpt_dir']}")
        lines.append("  " + "  ".join(bits))
        if rec.get("resumed_from_step") is not None:
            replay = rec.get("steps_replayed")
            lines.append(
                f"  resumed from step {rec['resumed_from_step']}"
                + (f"  ({replay} step(s) replayed)"
                   if replay is not None else "")
            )
        if rec.get("reshapes"):
            last = rec.get("last_reshape") or {}
            lines.append(
                f"  elastic reshapes: {rec['reshapes']} (recovery "
                "events, not violations)"
                + (
                    f"  last: {last.get('old')} -> {last.get('new')} "
                    f"({last.get('reason')}, "
                    f"{last.get('steps_lost')} step(s) lost, "
                    f"{last.get('wall_s')} s)"
                    if last else ""
                )
            )
        counts_bits = [
            f"{k}={rec[k]}"
            for k in ("saves", "saves_skipped", "restores", "chaos_faults")
            if rec.get(k) is not None
        ]
        if man.get("save_skipped"):
            counts_bits.append(
                f"manifest save_skipped={man['save_skipped']} "
                "(poisoned-checkpoint gate)"
            )
        if counts_bits:
            lines.append("  " + "  ".join(counts_bits))

    lines.append("")
    lines.append(f"compile analytics: {COMPILE_REPORT_ABSENT}")
    return "\n".join(lines)


EXIT_CODES = """\
exit codes:
  0  report printed; with --check-health, the run is healthy
  2  no telemetry at run_dir (missing metrics.jsonl / artifacts)
  3  --check-health: sentinel violation(s), stall, or flight error
  4  --check-health: memory violation -- mem.json records leaked KV pages,
     windowed monotone live-bytes growth, or a budget-band breach (see
     tools/mem_report.py for the full gate)
  5  --check-health: goodput/SLO violation -- goodput.json's buckets break
     their sum-to-wall contract, or (with --slo-floor) a serve-scope
     record's SLO attainment sits below the floor (see
     tools/goodput_report.py for the cross-run trend gate)
"""


def check_health(summary: dict[str, Any], run_dir: str, slo_floor: float | None) -> int:
    """The ``--check-health`` verdict of one summary, its problems on
    stderr: 3 health, 4 memory, 5 goodput, else 0."""
    h = summary.get("health") or {}
    reshapes = (summary.get("recovery") or {}).get("reshapes")
    if reshapes:  # an elastic reshape is recovery, not damage
        print(f"note: {reshapes} elastic reshape(s) recorded for {run_dir} -- recovery "
              "events, not violations", file=sys.stderr)
    problems = []
    if h.get("violations"):
        problems.append(f"{h['violations']} sentinel violation(s)")
    if h.get("stall"):
        problems.append(f"stall (watchdog {h['stall'].get('watchdog')})")
    if h.get("error"):
        problems.append(h["error"])
    if problems:
        print(f"health check FAILED for {run_dir}: " + "; ".join(problems), file=sys.stderr)
        return 3
    mem = summary.get("mem") or {}
    mem_problems = []
    if not mem.get("error"):
        if mem.get("leaked_pages"):
            mem_problems.append(f"{mem['leaked_pages']} leaked KV page(s)")
        if mem.get("growth_violations"):
            mem_problems.append(f"{mem['growth_violations']} live-bytes growth violation(s)")
        b = mem.get("budget") or {}
        if b.get("available") and b.get("within_band") is False:
            mem_problems.append(f"budget band breach (measured/budget {b.get('ratio')}, tol "
                                f"{b.get('tolerance')})")
    if mem_problems:
        print(f"memory check FAILED for {run_dir}: " + "; ".join(mem_problems),
              file=sys.stderr)
        return 4
    gp = summary.get("goodput") or {}
    gp_problems = []
    if gp and not gp.get("error"):
        sc = gp.get("sum_check") or {}
        if sc.get("ok") is False:
            gp_problems.append(
                f"decomposition breaks the sum-to-wall contract (attributed "
                f"{sc.get('attributed_s')} s vs wall {sc.get('total_wall_s')} s, tol "
                f"{sc.get('tolerance')})")
        att = gp.get("slo_attainment")
        if (slo_floor is not None and gp.get("scope") == "serve"
                and (not isinstance(att, (int, float)) or att < slo_floor)):
            gp_problems.append(f"SLO attainment {att} below floor {slo_floor}")
    if gp_problems:
        print(f"goodput check FAILED for {run_dir}: " + "; ".join(gp_problems),
              file=sys.stderr)
        return 5
    print(f"health check ok for {run_dir}", file=sys.stderr)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, epilog=EXIT_CODES,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("run_dir", help="directory holding metrics.jsonl (+ counters.json / "
                                    "trace.json / the other artifacts)")
    ap.add_argument("--json", action="store_true", help="print the raw summary dict as JSON")
    ap.add_argument("--check-health", action="store_true",
                    help="exit non-zero when the run's flight.json records sentinel "
                         "violations or a stall, mem.json a memory violation, or "
                         "goodput.json a broken decomposition")
    ap.add_argument("--slo-floor", type=float, default=None, metavar="FRACTION",
                    help="with --check-health: also fail (exit 5) when a serve-scope "
                         "goodput.json reports SLO attainment below this fraction (0..1)")
    args = ap.parse_args(argv)
    try:
        summary = summarize_run(args.run_dir)
    except FileNotFoundError as e:
        print(f"no telemetry at {args.run_dir}: {e}", file=sys.stderr)
        return 2
    if args.json:
        print(json.dumps(summary, indent=1, default=str))
    else:
        print(format_report(summary))
    if args.check_health:
        return check_health(summary, args.run_dir, args.slo_floor)
    return 0


if __name__ == "__main__":
    sys.exit(main())
