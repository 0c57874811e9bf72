"""The port's source-level analyses: twins of ``tests/test_hlo_lint.py``'s
source-rule, waiver and severity tests (:621-962; S102 is reserved) and of
``tests/test_host_safety.py``'s S201-S205 fire and near-miss pairs (:110-311),
each on the port's idiom and paths, with the JAX pass run on the same source
where the rule is the same; S204 on a seeded drift in the port's own
``ServeEngine``; and the port's tree linting clean."""

from __future__ import annotations

import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from ddl25spring_tpu.analysis import host_safety as jax_host_safety
from ddl25spring_tpu_torch.analysis import host_safety, source_lint
from ddl25spring_tpu_torch.analysis.rules import (
    Finding,
    severity_rank,
    summarize,
    worst_severity,
)
from ddl25spring_tpu_torch.analysis.waivers import (
    apply_waivers,
    check_waivers,
    load_waivers,
)

ROOT = Path(__file__).resolve().parents[1]
OBS = "ddl25spring_tpu_torch/obs/fake.py"


def _key(fs):
    return [(f.rule, f.severity, f.op) for f in fs]


def lint(src: str, relpath: str = OBS, mirrors=host_safety.MIRRORS, jax_path=None):
    """The port's S201-S205 on ``src``; with ``jax_path``, also JAX's pass on
    the same source under that path, which must find the same."""
    src = textwrap.dedent(src)
    got = host_safety.lint_source(src, relpath, mirrors=mirrors)
    if jax_path is not None:
        ref = jax_host_safety.lint_source(
            src, jax_path, mirrors=tuple(dict(m, path=jax_path) for m in mirrors))
        assert _key(got) == _key(ref)
    return got


# --------------------------------------------------------------- S101-S103

S101_SRC = """\
import os

def bucket_default():
    return os.environ.get("DDL25_BUCKET_BYTES", "0") not in ("", "0")

def cuda_home():
    return os.getenv("CUDA_HOME")

TRACE_FLAG = os.environ.get("AT_IMPORT_IS_FINE")
"""


def test_s101_env_read_in_traced_module_function():
    fs = source_lint.lint_source(S101_SRC, "ddl25spring_tpu_torch/parallel/bucketing.py")
    assert [(f.rule, f.op) for f in fs] == [("S101", "bucket_default"), ("S101", "cuda_home")]
    assert "env_flag" in fs[0].fix_hint
    for path in ("ddl25spring_tpu_torch/serve/engine.py", "ddl25spring_tpu_torch/obs/memscope.py",
                 "ddl25spring_tpu_torch/ft/autosave.py"):
        assert len(source_lint.lint_source(S101_SRC, path)) == 2
    # outside the scope (data loaders, entry points) env reads are the boundary
    for path in ("ddl25spring_tpu_torch/data/cifar10.py", "ddl25spring_tpu_torch/bench.py",
                 "ddl25spring_tpu_torch/obs/recorder.py"):
        assert source_lint.lint_source(S101_SRC, path) == []


def test_s102_is_reserved_with_no_torch_counterpart():
    """JAX's S102 flags a jit without a donation decision; torch updates in
    place, so the port reserves the id and never emits it."""
    src = "import jax\n\ndef make_step(fn):\n    return jax.jit(fn)\n"
    assert "S102" in source_lint.RESERVED
    assert source_lint.lint_source(src, "ddl25spring_tpu_torch/parallel/dp.py") == []


S103_SRC = """\
import numpy as np
import torch

SIZES = np.arange(4)  # module level: static metadata, fine

def plain_helper(x):
    return np.prod(x.shape)  # not captured: fine

def capture(graph, x, stream):
    scale = np.sqrt(x.shape[-1])  # before the capture: fine
    with torch.cuda.graph(graph, stream=stream):
        def inner(y):
            return np.sum(y)  # nested in the capture: fires
        y = x * float(np.mean([1.0, 2.0]))  # captured: fires
        z = torch.sum(x) * scale  # torch inside the capture: fine
    return y, z, inner
"""


def test_s103_numpy_inside_a_captured_graph():
    fs = [f for f in source_lint.lint_source(S103_SRC, "ddl25spring_tpu_torch/anywhere.py")
          if f.rule == "S103"]
    assert len(fs) == 2 and {f.severity for f in fs} == {"error"}
    assert any("np.sum" in f.message for f in fs) and any("np.mean" in f.message for f in fs)
    assert {f.op for f in fs} == {"capture", "capture.inner"}


def test_s103_near_miss_numpy_outside_the_capture_stays_quiet():
    src = S103_SRC.replace("with torch.cuda.graph(graph, stream=stream):",
                           "with torch.no_grad():")
    assert [f for f in source_lint.lint_source(src, "ddl25spring_tpu_torch/anywhere.py")
            if f.rule == "S103"] == []


def test_unparsable_file_is_a_finding():
    (f,) = source_lint.lint_source("def broken(:\n", "ddl25spring_tpu_torch/x.py")
    assert f.rule == "S000" and f.severity == "error"


# ------------------------------------------------------ waivers + summary


def test_waiver_file_roundtrip(tmp_path):
    p = tmp_path / "waivers.toml"
    p.write_text('# test waivers\n[[waiver]]\nrule = "S101"\n'
                 'path = "ddl25spring_tpu_torch/ops/*.py"\nsymbol = "nvcc"\n'
                 'reason = "locates the compiler only"\n')
    ws = load_waivers(str(p))
    assert len(ws) == 1 and ws[0].rule == "S101"
    covered = Finding(rule="S101", severity="warn", message="m", op="nvcc",
                      source="ddl25spring_tpu_torch/ops/_build.py:35")
    other = Finding(rule="S101", severity="warn", message="m", op="nvcc",
                    source="ddl25spring_tpu_torch/parallel/dp.py:9")
    absolute = Finding(rule="S101", severity="warn", message="m", op="nvcc",
                       source="/x/ddl25spring_tpu_torch/ops/_build.py:35")
    apply_waivers([covered, other, absolute], ws)
    assert covered.waived and covered.waived_reason and absolute.waived
    assert not other.waived


def test_waiver_without_reason_is_rejected(tmp_path):
    """W000: a waiver with no reason (or an unknown key) is itself a finding,
    and the loader refuses the file."""
    p = tmp_path / "w.toml"
    p.write_text('[[waiver]]\nrule = "S101"\n')
    (w,) = check_waivers(str(p))
    assert w.rule == "W000" and "reason" in w.message
    with pytest.raises(ValueError, match="reason"):
        load_waivers(str(p))
    p.write_text('[[waiver]]\nrule = "S101"\nreason = "r"\ntypo = "x"\n')
    with pytest.raises(ValueError, match="unknown keys"):
        load_waivers(str(p))
    out = subprocess.run([sys.executable, "-m", "ddl25spring_tpu_torch.analysis", "--check",
                          "--waivers", str(p)], cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 1 and "W000" in out.stderr


def test_repo_waiver_file_loads_and_every_entry_has_reason():
    ws = load_waivers()
    assert ws and all(w.reason for w in ws) and check_waivers() == []
    assert all(w.path.startswith("ddl25spring_tpu_torch/") for w in ws)


def test_severity_order_and_summary():
    assert severity_rank("error") > severity_rank("warn") > severity_rank("info") > \
        severity_rank(None)
    assert worst_severity(["info", "error", "warn"]) == "error"
    fs = [Finding(rule="S101", severity="warn", message="a"),
          Finding(rule="S103", severity="error", message="b", waived=True,
                  waived_reason="ok")]
    assert summarize(fs) == {"findings": 2, "unwaived": 1, "waived": 1, "worst": "warn",
                             "by_rule": {"S101": 1, "S103": 1}}


# ------------------------------------------------- S201-S205 (host safety)

S201_BAD = """
    import threading

    class StallWatch:
        def __init__(self):
            self.fired = False
            self._thread = threading.Thread(target=self._monitor, daemon=True)

        def beat(self):
            self.fired = False

        def _monitor(self):
            self.fired = True
"""


def test_s201_unlocked_cross_context_write_fires():
    (f,) = lint(S201_BAD, jax_path="ddl25spring_tpu/obs/fake.py")
    assert f.rule == "S201" and f.op == "StallWatch.fired"
    assert "thread:StallWatch._monitor" in f.message and "main" in f.message


def test_s201_near_miss_shared_lock_stays_quiet():
    src = S201_BAD.replace("self.fired = False\n            self._thread",
                           "self.fired = False\n            self._state_lock = "
                           "threading.Lock()\n            self._thread")
    src = src.replace("        def beat(self):\n            self.fired = False",
                      "        def beat(self):\n            with self._state_lock:\n"
                      "                self.fired = False")
    src = src.replace("        def _monitor(self):\n            self.fired = True",
                      "        def _monitor(self):\n            with self._state_lock:\n"
                      "                self.fired = True")
    assert lint(src, jax_path="ddl25spring_tpu/obs/fake.py") == []


def test_s201_init_writes_are_exempt():
    src = """
        import threading

        class Checkpointer:
            def __init__(self):
                self._error = None
                self._thread = threading.Thread(target=self._write_async, daemon=True)

            def _write_async(self):
                self._error = RuntimeError("disk full")
    """
    assert lint(src, "ddl25spring_tpu_torch/utils/checkpoint.py") == []


S202_BAD = """
    import threading

    class Timeline:
        def __init__(self):
            self._lock = threading.Lock()
            self._flush_lock = threading.Lock()

        def emit(self):
            with self._lock:
                with self._flush_lock:
                    self.n = 1

        def flush(self):
            with self._flush_lock:
                with self._lock:
                    self.n = 2
"""


def test_s202_opposite_nesting_orders_fire():
    (f,) = lint(S202_BAD, jax_path="ddl25spring_tpu/obs/fake.py")
    assert f.rule == "S202" and "Timeline._lock" in f.op and "Timeline._flush_lock" in f.op


def test_s202_near_miss_consistent_order_stays_quiet():
    src = S202_BAD.replace("""            with self._flush_lock:
                with self._lock:
                    self.n = 2""", """            with self._lock:
                with self._flush_lock:
                    self.n = 2""")
    assert lint(src, jax_path="ddl25spring_tpu/obs/fake.py") == []


S203_BAD = """
    import signal
    import threading

    class FlightRecorder:
        def __init__(self):
            self._lock = threading.Lock()

        def install(self):
            signal.signal(signal.SIGTERM, self._on_term)

        def _on_term(self, signum, frame):
            self.dump()

        def dump(self):
            with self._lock:
                self.count = 1
"""


def test_s203_nonreentrant_lock_on_signal_path_fires():
    (f,) = lint(S203_BAD, jax_path="ddl25spring_tpu/obs/fake.py")
    assert f.rule == "S203" and f.op == "FlightRecorder.dump"
    assert "signal:FlightRecorder._on_term" in f.message


def test_s203_near_miss_rlock_stays_quiet():
    assert lint(S203_BAD.replace("threading.Lock()", "threading.RLock()"),
                jax_path="ddl25spring_tpu/obs/fake.py") == []


_S204_MIRRORS = ({"path": "ddl25spring_tpu_torch/serve/fake_engine.py", "cls": "FakeEngine",
                  "device_state": ("pool",), "device_ops": ("_release", "_tick"),
                  "host_mirrors": ("_release_mask",)},)

S204_BAD = """
    class FakeEngine:
        def flush(self, mask):
            self.pool, = self._release(self.params, self.pool, mask)
"""


def test_s204_unmirrored_device_mutation_fires():
    """The port's tuple target (``self.pool, = self._release(...)``) is a
    write of ``self.pool`` like JAX's plain one."""
    (f,) = lint(S204_BAD, "ddl25spring_tpu_torch/serve/fake_engine.py", mirrors=_S204_MIRRORS,
                jax_path="ddl25spring_tpu/serve/fake_engine.py")
    assert f.rule == "S204" and f.op == "FakeEngine.flush"
    assert "self.pool" in f.message and "_release" in f.message


def test_s204_near_miss_same_method_mirror_write_stays_quiet():
    src = """
        class FakeEngine:
            def flush(self, mask):
                self.pool, = self._release(self.params, self.pool, mask)
                self._release_mask[0] = False

            def tick(self, toks):
                self.pool, new_tok, ok = self._tick(self.params, self.pool, toks)
                self._release_mask = [False]
    """
    assert lint(src, "ddl25spring_tpu_torch/serve/fake_engine.py", mirrors=_S204_MIRRORS) == []


def test_s204_mirror_written_only_by_a_helper_still_fires():
    """JAX's rule is per method: a tick that leaves the mirror to a helper it
    calls is flagged all the same (such a site takes a reasoned waiver)."""
    src = """
        class FakeEngine:
            def tick(self, toks):
                self.pool, new_tok, ok = self._tick(self.params, self.pool, toks)
                self._track()

            def _track(self):
                self._release_mask.clear()
    """
    (f,) = lint(src, "ddl25spring_tpu_torch/serve/fake_engine.py", mirrors=_S204_MIRRORS,
                jax_path="ddl25spring_tpu/serve/fake_engine.py")
    assert f.rule == "S204" and f.op == "FakeEngine.tick"


def test_s204_fires_on_a_seeded_drift_in_the_port_engine():
    """The real contract on the real ``ServeEngine``: the engine's own source
    raises S204 only at the decode tick, which ``waivers.toml`` covers with
    its reason, and a method seeded into the class that replaces the pool
    through a device program (a tuple target, the port's idiom) without
    touching a host mirror is one more S204, which no waiver covers."""
    path = "ddl25spring_tpu_torch/serve/engine.py"
    src = (ROOT / path).read_text()
    own = apply_waivers([f for f in host_safety.lint_source(src, path) if f.rule == "S204"],
                        load_waivers())
    assert [(f.op, f.waived) for f in own] == [("ServeEngine._run_decode_tick", True)]
    anchor = "    def _flush_releases(self) -> None:\n"
    assert anchor in src
    seeded = src.replace(anchor, (
        "    def _seeded_drift(self, toks):\n"
        "        self.pool, new_tok, ok = self._tick(self.params, self.pool, toks,\n"
        "                                            self._noise(self.max_slots))\n"
        "        return new_tok, ok\n\n" + anchor), 1)
    (f,) = [f for f in apply_waivers(host_safety.lint_source(seeded, path), load_waivers())
            if f.rule == "S204" and not f.waived]
    assert f.op == "ServeEngine._seeded_drift" and "_tick" in f.message


S205_BAD = """
    import atexit

    class AutoSaver:
        def install(self):
            atexit.register(self.close)

        def close(self):
            self.worker.join()
"""


def test_s205_unbounded_join_on_shutdown_path_fires():
    (f,) = lint(S205_BAD, "ddl25spring_tpu_torch/ft/fake.py",
                jax_path="ddl25spring_tpu/ft/fake.py")
    assert f.rule == "S205" and f.severity == "warn" and f.op == "AutoSaver.close"
    assert "atexit:AutoSaver.close" in f.message


def test_s205_near_miss_bounded_join_stays_quiet():
    assert lint(S205_BAD.replace(".join()", ".join(timeout=2.0)"),
                "ddl25spring_tpu_torch/ft/fake.py", jax_path="ddl25spring_tpu/ft/fake.py") == []


# ------------------------------------------------ the port's tree (gate)


def test_port_tree_lints_clean_with_reasoned_waivers():
    """Source and host-safety passes over the port's tree: no unwaived
    finding, every waiver reasoned, and the inventory sees the machinery
    the port owns (the recorder's reentrant lock, the checkpoint writer's
    lock, threads, signals, atexit, one mirror contract)."""
    ws = load_waivers()
    src = apply_waivers(source_lint.lint_repo(str(ROOT)), ws)
    assert [f.key() for f in src if not f.waived] == []
    inv, host = host_safety.lint_repo(str(ROOT))
    host = apply_waivers(host, ws)
    assert [f.key() for f in host if not f.waived] == []
    s = inv.summary()
    assert s["files"] >= 30 and s["functions"] >= 300
    assert s["locks"]["ddl25spring_tpu_torch/obs/recorder.py::FlightRecorder._lock"] == "RLock"
    assert s["locks"]["ddl25spring_tpu_torch/utils/checkpoint.py::Checkpointer._lock"] == \
        "RLock"
    e = s["entry_points"]
    assert e.get("thread", 0) >= 1 and e.get("signal", 0) >= 1 and e.get("atexit", 0) >= 1
    assert s["mirror_contracts"] == 1


def test_lint_cli_check_exits_zero_on_the_port_tree():
    out = subprocess.run([sys.executable, "-m", "ddl25spring_tpu_torch.analysis", "--check",
                          "--host-safety", "--format", "json"], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "lint OK" in out.stderr
    import json

    doc = json.loads(out.stdout)
    assert doc["record"] == "torch_lint" and doc["source"] and \
        all(f["waived"] for f in doc["source"] + doc["host_safety"]["findings"])
