"""The port's fault-tolerance layer (``ddl25spring_tpu_torch/ft``): chaos
injection, the DCP checkpointer's contract, the sentinel-gated autosave,
auto-resume, the demo's kill-and-resume; the twins of ``tests/test_ft.py``
(its bench cases wait for the port's retry driver, its cross-mesh case is
in ``test_torch_elastic.py``), held to the JAX package where both can run
the same inputs:

- the autosave gate's decisions and the manifest's fields equal JAX's over
  one sequence of losses and sentinel violations;
- ``reshard_leaf``/``reshard_state`` equal JAX's arrays exactly;
- the demo killed by ``DDL25_CHAOS=kill@6`` and relaunched lands BITWISE on
  the uninterrupted run's parameters; SIGTERM drains the in-flight save.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from ddl25spring_tpu_torch.ft import (  # noqa: E402
    AutoSaver,
    ChaosInjector,
    DeviceLossError,
    Fault,
    latest_durable_step,
    parse_chaos,
    read_manifest,
    reshard_leaf,
    reshard_state,
    resume_bundle,
    write_manifest,
)
from ddl25spring_tpu_torch.ft.chaos import fired_basename  # noqa: E402
from ddl25spring_tpu_torch.obs import flight, sentinels  # noqa: E402
from ddl25spring_tpu_torch.utils.checkpoint import Checkpointer  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ------------------------------------------------------------ chaos spec


def test_parse_chaos_grammar():
    assert parse_chaos(None) == ()
    assert parse_chaos("") == ()
    assert parse_chaos("sigterm@12") == (Fault("sigterm", 12),)
    assert parse_chaos("kill@7, nan_grad@5") == (Fault("kill", 7), Fault("nan_grad", 5))
    assert parse_chaos("traffic_spike@8:16,capacity_change@5:4") == (
        Fault("traffic_spike", 8, 16), Fault("capacity_change", 5, 4))
    for bad in ("boom@3", "sigterm", "sigterm@", "sigterm@x", "sigterm@-1",
                "sigterm@5:2", "capacity_change@5:0"):
        with pytest.raises(ValueError):
            parse_chaos(bad)


def test_chaos_poison_device_loss_and_one_shot_journal(tmp_path):
    ci = ChaosInjector(parse_chaos("nan_grad@2,device_loss@3"), state_dir=tmp_path)
    batch = (torch.ones((4, 3)), torch.arange(4))
    x1, _ = ci.poison_batch(batch, 1)
    assert not torch.isnan(x1).any()  # wrong step: untouched
    x2, y2 = ci.poison_batch(batch, 2)
    assert torch.isnan(x2).all()
    assert torch.equal(y2, torch.arange(4))  # an integer leaf stays
    ci.on_step(1)
    with pytest.raises(DeviceLossError, match="device unreachable"):
        ci.on_step(3)
    # one-shot across relaunches: a new injector on the same journal fires
    # neither fault again
    ci2 = ChaosInjector(parse_chaos("nan_grad@2,device_loss@3"), state_dir=tmp_path)
    ci2.on_step(3)
    x3, _ = ci2.poison_batch(batch, 2)
    assert not torch.isnan(x3).any()
    # an integer-only batch (LLaMA's tokens) cannot carry the poison:
    # skipped, still armed
    ci3 = ChaosInjector(parse_chaos("nan_grad@0"), state_dir=tmp_path / "b")
    (out,) = ci3.poison_batch((torch.arange(4),), 0)
    assert torch.equal(out, torch.arange(4))
    assert ci3.pending("nan_grad")


def test_chaos_journal_tolerates_torn_line(tmp_path):
    (tmp_path / "chaos_fired.jsonl").write_text('{"fault": "sigterm@5"}\n{"fault": "ki')
    ci = ChaosInjector(parse_chaos("sigterm@5,kill@7"), state_dir=tmp_path)
    assert [f.key for f in ci.pending()] == ["kill@7"]


def test_each_rank_journals_into_a_file_of_its_own(tmp_path):
    """One process alone keeps JAX's ``chaos_fired.jsonl``; rank ``r`` of
    several writes ``chaos_fired.rank<r>.jsonl``, and reads only its own."""
    assert fired_basename(None) == "chaos_fired.jsonl"
    ChaosInjector(parse_chaos("device_loss@1"), state_dir=tmp_path, rank=1).take(
        1, kinds=("device_loss",))
    assert sorted(os.listdir(tmp_path)) == ["chaos_fired.rank1.jsonl"]
    assert not ChaosInjector(parse_chaos("device_loss@1"), tmp_path, rank=1).pending()
    assert ChaosInjector(parse_chaos("device_loss@1"), tmp_path, rank=0).pending()
    assert ChaosInjector(parse_chaos("device_loss@1"), tmp_path).pending()


# ---------------------------------------------------- manifest + durability


def test_manifest_atomicity_and_tmp_dirs_invisible(tmp_path):
    d = tmp_path / "ck"
    write_manifest(d, {"last_durable_step": 3})
    assert read_manifest(d)["last_durable_step"] == 3
    (d / "manifest.json.tmp.999.1").write_text('{"last_durable')
    assert read_manifest(d)["last_durable_step"] == 3
    (d / "manifest.json").write_text('{"last_durable')
    assert read_manifest(d) is None
    # commit by rename: only digit-named dirs are durable steps
    (d / "3").mkdir()
    (d / "7.tmp-dcp").mkdir()
    assert latest_durable_step(d) == 3
    assert latest_durable_step(tmp_path / "nope") is None
    ck = Checkpointer(tmp_path / "ck2", async_save=False)
    ck.save(0, {"w": torch.arange(2.0)})
    (tmp_path / "ck2" / "9.tmp-dcp").mkdir()
    assert ck.latest_step() == 0
    assert latest_durable_step(tmp_path / "ck2") == 0
    assert torch.equal(ck.restore(0)["w"], torch.arange(2.0))
    ck.close()


def test_checkpointer_wait_timeout_bounds_a_wedged_barrier(tmp_path, monkeypatch):
    import time

    ck = Checkpointer(tmp_path / "c", async_save=True)
    ck.save(0, {"w": torch.arange(4.0)})
    assert ck.wait_until_finished(timeout_s=120.0) is True
    # a wedged save thread must not outlive the watchdog
    monkeypatch.setattr(ck, "_wait", lambda: time.sleep(30))
    assert ck.wait_until_finished(timeout_s=0.2) is False
    assert ck.close(timeout_s=0.2) is False

    def _boom():
        raise OSError("disk full")

    monkeypatch.setattr(ck, "_wait", _boom)
    assert ck.wait_until_finished(timeout_s=5.0) is False


def test_failed_async_save_raises_at_the_next_barrier(tmp_path, monkeypatch):
    """A save that fails in the background is never reported durable: the
    bounded barrier says False and the next save raises it."""
    ck = Checkpointer(tmp_path / "c", async_save=True)
    monkeypatch.setattr(ck, "_write", lambda step, flat: (_ for _ in ()).throw(OSError("full")))
    ck.save(0, {"w": torch.arange(4.0)})
    with pytest.raises(OSError, match="full"):
        ck.save(1, {"w": torch.arange(4.0)})
    assert latest_durable_step(tmp_path / "c") is None


def test_close_without_save_preserves_prior_manifest(tmp_path):
    a = AutoSaver(tmp_path / "ck", save_every=1, async_save=False)
    a.save(0, resume_bundle({"w": torch.ones((4, 2))}, {}, data_cursor=1))
    a.close()
    man = read_manifest(tmp_path / "ck")
    assert man["leaf_shapes"] is not None
    saves_before = man["saves"]
    b = AutoSaver(tmp_path / "ck", save_every=1)
    b.close()  # the second preemption: shutdown hook, zero new saves
    man2 = read_manifest(tmp_path / "ck")
    assert man2["leaf_shapes"] == man["leaf_shapes"]
    assert man2["saves"] == saves_before
    assert man2["last_requested_step"] == 0
    assert man2["last_durable_step"] == 0


def test_flight_shutdown_hooks_run_before_dump(tmp_path):
    from ddl25spring_tpu_torch.obs.recorder import FlightRecorder

    fr = FlightRecorder()
    fr.configure(run_dir=str(tmp_path))
    calls = []
    name = fr.register_shutdown(lambda: calls.append("hook"))
    fr.record(kind="step", step=0)
    fr._atexit_dump()
    assert calls == ["hook"]
    assert (tmp_path / "flight.json").exists()
    fr.unregister_shutdown(name)
    fr._atexit_dump()
    assert calls == ["hook"]


def test_restore_or_init_fresh_start(tmp_path):
    saver = AutoSaver(tmp_path / "ck", save_every=2)
    init = resume_bundle({"w": torch.ones((2, 2))}, {"m": torch.zeros((2, 2))},
                         data_cursor=0, rng_seed=1)
    state, start = saver.restore_or_init(init)
    assert start == 0
    assert state is init
    saver.close()


def test_device_dataset_cursor_roundtrip():
    """The data cursor a resume bundle carries replays the same batch."""
    from ddl25spring_tpu_torch.benchmarks import DeviceDataset

    ds = DeviceDataset(16, n_train=64, device=torch.device("cpu"))
    ds.feed()
    ds.feed()
    c = ds.cursor
    x1, _ = ds.feed()
    ds.cursor = c  # the restore path: replay from the checkpointed cursor
    x2, _ = ds.feed()
    assert torch.equal(x1, x2)
    assert ds.cursor == c + 1


# ----------------------------------------------------- sentinel-gated save

# (loss, violations recorded during the step) per step
GATE_SEQ = [(1.0, 0), (0.9, 0), (float("nan"), 0), (0.8, 1), (0.7, 0), (float("inf"), 1),
            (0.6, 2), (0.5, 0), (0.4, 0)]


def _drive_gate(saver_cls, bundle, state_of, tmp, monkeypatch, module, save_every, sync):
    """Run ``GATE_SEQ`` through one package's AutoSaver; violations come
    from a stubbed ``violation_count``."""
    count = [0]
    monkeypatch.setattr(module, "violation_count", lambda: count[0])
    saver = saver_cls(tmp, save_every=save_every, async_save=not sync, max_to_keep=20)
    decisions = []
    for i, (loss, v) in enumerate(GATE_SEQ):
        count[0] += v
        decisions.append(saver.maybe_save(i, bundle(state_of(i), {}, data_cursor=i + 1),
                                          loss=loss))
    saver.close()
    man = read_manifest(tmp)
    man.pop("written_at_unix")
    return decisions, man, saver.saves, saver.skipped


@pytest.mark.parametrize("save_every,sync", [(1, True), (2, False)])
def test_gate_decisions_and_manifest_equal_jax(tmp_path, monkeypatch, save_every, sync):
    """The same losses and violations give JAX's save decisions, counters and
    manifest fields (sync and async saves)."""
    import jax.numpy as jnp

    from ddl25spring_tpu.ft import autosave as jautosave
    from ddl25spring_tpu.obs import sentinels as jsentinels

    port = _drive_gate(AutoSaver, resume_bundle,
                       lambda i: {"w": torch.full((3, 2), float(i))}, tmp_path / "port",
                       monkeypatch, sentinels, save_every, sync)
    ref = _drive_gate(jautosave.AutoSaver, jautosave.resume_bundle,
                      lambda i: {"w": jnp.full((3, 2), float(i))}, tmp_path / "jax",
                      monkeypatch, jsentinels, save_every, sync)
    assert port == ref
    assert port[1]["save_skipped"] >= 2


def test_sentinel_flagged_step_is_never_persisted(tmp_path):
    """The poisoned-checkpoint gate: step 2's batch is NaN-poisoned, the
    guard flags it (skip keeps the parameters), and that step is never
    written while every clean neighbour is."""
    from ddl25spring_tpu_torch.parallel.dp import make_train_step

    class Lin(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.w = torch.nn.Parameter(torch.full((8, 4), 0.5))

    def loss_fn(model, batch):
        x, y = batch
        return ((x @ model.w - y) ** 2).mean()

    sentinels.reset()
    skipped_before = flight.counts().get("save_skipped", 0)
    model = Lin()
    opt = torch.optim.SGD(model.parameters(), lr=0.1)
    with sentinels.scoped(True, policy="skip"):
        step = make_train_step(model, loss_fn, opt, sentinel=True)
    saver = AutoSaver(tmp_path / "ck", save_every=1, max_to_keep=10, async_save=False)
    x, y = torch.ones((8, 8)), torch.ones((8, 4))
    for i in range(6):
        xb = x.clone()
        if i == 2:
            xb[0, 0] = float("nan")
        loss = step((xb, y))
        saver.maybe_save(i, resume_bundle({"w": model.w.detach()}, {}, data_cursor=i + 1),
                         loss=loss if i != 2 else None)
    saver.close()
    steps = Checkpointer(tmp_path / "ck").steps()
    assert 2 not in steps and {0, 1, 3, 4, 5} <= set(steps)
    assert torch.isfinite(model.w).all()
    assert flight.counts().get("save_skipped", 0) >= skipped_before + 1
    man = read_manifest(tmp_path / "ck")
    assert man["save_skipped"] == 1 and man["last_durable_step"] == 5
    sentinels.reset()


# -------------------------------------------------- kill-and-resume (demo)


def _demo_argv(tmp_path, ckpt, name, sync=True, steps=8):
    return ["--device", "cpu", "--devices", "1", "--steps", str(steps), "--save-every", "2",
            "--ckpt-dir", str(tmp_path / ckpt), "--run-dir", str(tmp_path / f"run_{name}"),
            "--out", str(tmp_path / f"{name}.npz")] + (["--sync-saves"] if sync else [])


def _demo(tmp_path, ckpt, name, chaos=None, sync=True):
    """The demo in a process of its own (chaos kills it)."""
    env = {k: v for k, v in os.environ.items() if k not in ("DDL25_CHAOS", "DDL25_SENTINELS")}
    if chaos:
        env["DDL25_CHAOS"] = chaos
    return subprocess.Popen([sys.executable, "-m", "ddl25spring_tpu_torch.ft.demo",
                             *_demo_argv(tmp_path, ckpt, name, sync)],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=REPO,
                            env=env)


def _demo_here(tmp_path, ckpt, name, capsys, monkeypatch):
    """The demo in this process (no chaos armed); the flight recorder's
    handlers it installs are taken down after."""
    from ddl25spring_tpu_torch.ft import demo

    monkeypatch.delenv("DDL25_CHAOS", raising=False)
    try:
        assert demo.main(_demo_argv(tmp_path, ckpt, name)) == 0
    finally:
        flight.uninstall()
        flight.configure(run_dir=None)
    return capsys.readouterr().out, tmp_path / f"{name}.npz"


def _wait(proc):
    out, err = proc.communicate(timeout=300)
    return proc.returncode, out, err


def test_demo_kill_and_resume_and_sigterm_drain(tmp_path, capsys, monkeypatch):
    """The headline pins: chaos SIGKILLs a run after step 6 of 8; the
    relaunch restores step 5's checkpoint (parameters, Adam state, data
    cursor, seed), replays 6..7 and lands BITWISE on the uninterrupted run.
    With ASYNC saves, SIGTERM at step 5 arrives while step 3's save may be in
    flight: the flight recorder's shutdown chain drains it (exit 143, the
    manifest and the dump name step 3 durable).  The killed runs have
    processes of their own; the others run here meanwhile."""
    killed = _demo(tmp_path, "ck", "killed", chaos="kill@6")
    term = _demo(tmp_path, "ck_term", "sigterm", chaos="sigterm@5", sync=False)
    _, ref_out = _demo_here(tmp_path, "ck_ref", "ref", capsys, monkeypatch)
    rc, out, err = _wait(killed)
    assert rc in (-9, 137), (rc, err[-2000:])
    assert latest_durable_step(tmp_path / "ck") == 5   # sync saves at 1, 3, 5
    out, res_out = _demo_here(tmp_path, "ck", "resumed", capsys, monkeypatch)
    assert "FT-DEMO start=6" in out, out
    rc, out, err = _wait(term)
    assert rc in (143, -15), (rc, err[-2000:])
    man = read_manifest(tmp_path / "ck_term")
    assert man["last_durable_step"] == 3
    assert latest_durable_step(tmp_path / "ck_term") == 3
    fl = json.loads((tmp_path / "run_sigterm" / "flight.json").read_text())
    assert fl["reason"] == "sigterm"
    assert fl["meta"]["ckpt_last_durable_step"] == 3
    assert fl["counts"].get("chaos") == 1
    a, b = np.load(ref_out), np.load(res_out)
    assert sorted(a.files) == sorted(b.files) == ["['w1']", "['w2']"]
    for k in a.files:
        assert np.array_equal(a[k], b[k]), k


# ------------------------------------------------------- cross-mesh refit


def test_reshard_refit_and_truncation_guard():
    """JAX's cases, each against JAX's own output: exact."""
    import jax.numpy as jnp

    from ddl25spring_tpu.ft import reshard as jreshard

    true = np.arange(1, 38, dtype=np.float32)
    saved = np.zeros(40, np.float32)
    saved[:37] = true
    saved = saved.reshape(8, 5)
    out = reshard_leaf(saved, np.zeros((4, 10), np.float32), "w")
    assert np.array_equal(out, np.asarray(jreshard.reshard_leaf(saved, jnp.zeros((4, 10)))))
    flat = out.reshape(-1)
    assert np.array_equal(flat[:37], true) and flat[37:].sum() == 0
    back = reshard_leaf(out, np.zeros((8, 5), np.float32), "w")
    assert np.array_equal(back, saved)
    stacked = np.stack([saved, 2 * saved])
    out3 = reshard_leaf(stacked, torch.zeros((2, 4, 10)), "blocks")
    assert np.array_equal(out3.numpy(), np.asarray(
        jreshard.reshard_leaf(stacked, jnp.zeros((2, 4, 10)), "blocks")))
    with pytest.raises(ValueError, match="nonzero"):
        reshard_leaf(saved, np.zeros((2, 10), np.float32), "w")
    with pytest.raises(ValueError, match="cannot reshard"):
        reshard_leaf(saved, np.zeros((40,), np.float32), "w")
    out_t = reshard_state({"a": saved, "c": np.int64(5)},
                          {"a": np.zeros((4, 10), np.float32), "c": np.int64(0)})
    assert int(out_t["c"]) == 5
    assert out_t["a"].shape == (4, 10)


def test_importing_the_manifest_leaves_the_checkpoint_library_out():
    """``ft.manifest`` is what a retry driver's parent and a post-mortem read:
    importing it (and ``ft``) loads neither DCP nor the autosave layer."""
    probe = ("import sys, ddl25spring_tpu_torch.ft.manifest as m, ddl25spring_tpu_torch.ft as ft;"
             "m.latest_durable_step('.'); ft.read_manifest('.');"
             "print(sorted(x for x in sys.modules if x.startswith('torch.distributed.checkpoint')"
             " or x.endswith(('ft.autosave', 'utils.checkpoint'))))")
    out = subprocess.run([sys.executable, "-c", probe], cwd=REPO, capture_output=True, text=True,
                         timeout=120, check=True)
    assert out.stdout.strip() == "[]"
