"""The port's checkpoint storage (``utils/checkpoint.py``, on
``torch.distributed.checkpoint``) and the LLaMA lab's ``--ckpt-dir`` /
``--ckpt-every``: the twins of ``tests/test_checkpoint_tracing.py`` (its
ZeRO case is in ``test_torch_elastic.py``'s world, its step timer in
``test_torch_obs.py``).

The key pin is kill-and-resume equivalence: a run that checkpoints, "dies",
restores and continues lands bitwise on the state of a run that never died,
in one process and on the lab's 2 x 3 DP x PP world (six gloo ranks, a
narrow fp32 LLaMA), where each stage's keys carry the stage and the DP
replicas' identical tensors are written once.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_torch_thread  # noqa: E402,F401

from ddl25spring_tpu_torch.lab import dp_pp  # noqa: E402
from ddl25spring_tpu_torch.models import llama  # noqa: E402
from ddl25spring_tpu_torch.ops.losses import causal_lm_loss  # noqa: E402
from ddl25spring_tpu_torch.parallel.dp import make_train_step  # noqa: E402
from ddl25spring_tpu_torch.parallel.launch import spawn  # noqa: E402
from ddl25spring_tpu_torch.utils import checkpoint as ck  # noqa: E402
from ddl25spring_tpu_torch.utils import pytree  # noqa: E402
from ddl25spring_tpu_torch.utils.config import LlamaConfig  # noqa: E402

NARROW = LlamaConfig(vocab_size=64, dmodel=16, num_heads=2, n_layers=3, ctx_size=16,
                     dtype="float32")
TOKENS = [np.random.default_rng(20 + i).integers(0, 64, (6, 16)).astype(np.int64)
          for i in range(6)]


def _lm_loss(model, tokens):
    return causal_lm_loss(model(tokens), tokens)


def _one_process(seed=0):
    model = llama.Llama(NARROW, device="cpu", generator=torch.Generator().manual_seed(seed))
    opt = torch.optim.Adam(model.parameters(), lr=1e-2)
    return model, opt, make_train_step(model, _lm_loss, opt)


def _bits(tensors):
    return [t.detach().contiguous().view(torch.int32).clone() for t in tensors]


def _same(a, b) -> bool:
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


def test_kill_and_resume_equivalence(tmp_path):
    """6 steps uninterrupted against 3, an async save, a "crash", a restore
    into a fresh model and optimizer through the freshly built template
    (``restore_or_init``), 3 more: bitwise, parameters and Adam state."""
    model, opt, step = _one_process()
    for t in TOKENS:
        step(torch.from_numpy(t))
    model2, opt2, step2 = _one_process()
    named = list(model2.named_parameters())
    ckpt = ck.Checkpointer(tmp_path / "ckpt")
    for t in TOKENS[:3]:
        step2(torch.from_numpy(t))
    ckpt.save(2, {"params": {n: p.detach() for n, p in named},
                  "opt_state": ck.optimizer_state(opt2, named)})
    ckpt.close()   # saves are async; the barrier stands in for process exit

    model3, opt3, step3 = _one_process()
    named3 = list(model3.named_parameters())
    init = {"params": {n: p.detach() for n, p in named3},
            "opt_state": ck.optimizer_template(opt3, named3)}
    restored, next_step = ck.Checkpointer(tmp_path / "ckpt").restore_or_init(init)
    assert next_step == 3
    with torch.no_grad():
        for n, p in named3:
            p.copy_(restored["params"][n])
    ck.load_optimizer_state(opt3, named3, restored["opt_state"])
    # Adam without capturable keeps its step counter on the host
    assert all(st["step"].device.type == "cpu" and float(st["step"]) == 3
               for st in opt3.state.values())
    for t in TOKENS[3:]:
        step3(torch.from_numpy(t))
    assert _same(_bits(model3.parameters()), _bits(model.parameters()))
    for p, q in zip(model3.parameters(), model.parameters()):
        assert torch.equal(p.view(torch.int32), q.view(torch.int32))
        for k in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(opt3.state[p][k], opt.state[q][k])


def test_restore_or_init_fresh_start(tmp_path):
    state, next_step = ck.Checkpointer(tmp_path / "empty").restore_or_init({"w": torch.ones(2)})
    assert next_step == 0
    assert torch.equal(state["w"], torch.ones(2))


def test_max_to_keep_prunes(tmp_path):
    ckpt = ck.Checkpointer(tmp_path / "ckpt", max_to_keep=2)
    for s in range(4):
        ckpt.save(s, {"w": torch.arange(4.0) + s})
    assert ckpt.steps() == [2, 3]   # 0 and 1 pruned
    assert ckpt.latest_step() == 3
    assert torch.equal(ckpt.restore(3)["w"], torch.arange(4.0) + 3)


def test_async_save_holds_the_state_at_the_call(tmp_path):
    """The state is copied before ``save`` returns: a later in-place update
    does not reach the checkpoint.  A step saved again is replaced; a
    template of another shape refuses; leaves keep their forms."""
    w = torch.arange(6.0).reshape(2, 3)
    ckpt = ck.Checkpointer(tmp_path / "c")
    ckpt.save(0, {"w": w, "n": np.asarray(7, np.int64), "s": 0.5, "tree": [w[0], (w[1],)]})
    w.add_(100.0)
    got = ckpt.restore(0, template={"w": torch.zeros(2, 3, dtype=torch.float64),
                                    "n": np.asarray(0, np.int64), "s": 0.0,
                                    "tree": [torch.zeros(3), (torch.zeros(3),)]})
    assert torch.equal(got["w"], torch.arange(6.0, dtype=torch.float64).reshape(2, 3))
    assert isinstance(got["n"], np.ndarray) and int(got["n"]) == 7 and got["s"] == 0.5
    assert torch.equal(got["tree"][1][0], torch.arange(3.0, 6.0))
    ckpt.save(0, {"w": w, "n": np.asarray(8, np.int64), "s": 0.5, "tree": [w[0], (w[1],)]})
    assert int(ckpt.restore(0)["n"]) == 8 and ckpt.steps() == [0]
    with pytest.raises(ValueError, match="shape"):
        ckpt.restore(0, template={"w": torch.zeros(3, 2), "n": np.asarray(0), "s": 0.0,
                                  "tree": [torch.zeros(3), (torch.zeros(3),)]})
    with pytest.raises(FileNotFoundError):
        ck.Checkpointer(tmp_path / "none").restore()


def test_optimizer_template_is_a_fresh_adams_state():
    """The template of a fresh optimizer holds the state torch makes at its
    first step before the update: ``step`` 0 on the host, zero moments, so
    loading it changes nothing; probing it moves no parameter."""
    model, opt, _ = _one_process()
    before = _bits(model.parameters())
    t = ck.optimizer_template(opt, model.named_parameters())
    assert not opt.state
    assert _same(_bits(model.parameters()), before)
    (name, p), = list(model.named_parameters())[:1]
    assert set(t[name]) == {"step", "exp_avg", "exp_avg_sq"}
    assert t[name]["step"].device.type == "cpu" and float(t[name]["step"]) == 0
    assert t[name]["exp_avg"].shape == p.shape and not t[name]["exp_avg"].any()


# ------------------------------------------------------ the lab's resume


def _job(ckpt_dir, iters):
    return dp_pp.Job(NARROW, data=2, stages=3, microbatches=3, batch=6, iters=iters,
                     lr=1e-2, device="cpu", batches=TOKENS, log=False, ckpt_dir=str(ckpt_dir),
                     ckpt_every=2)


def _last_stage(ranks):
    return next(r for r in ranks if r["coords"] == (0, 2))


def test_lab_resume_is_bitwise(tmp_path):
    """``lab.dp_pp --workload llama --ckpt-dir`` on the 2 x 3 world: 4 steps
    uninterrupted (saves after steps 1 and 3) against 2 steps and a relaunch
    of 2 more, which resumes from step 1 with the data skipped: the losses
    and step 3's checkpoint, stage by stage, parameters and Adam state
    (``exp_avg``, ``exp_avg_sq``, ``step``), are bitwise."""
    rdv = str(tmp_path)
    a = spawn(dp_pp.run_rank, 6, _job(tmp_path / "A", 4), timeout=180, tmpdir=rdv)
    b1 = spawn(dp_pp.run_rank, 6, _job(tmp_path / "B", 2), timeout=180, tmpdir=rdv)
    b2 = spawn(dp_pp.run_rank, 6, _job(tmp_path / "B", 2), timeout=180, tmpdir=rdv)
    assert {r["start"] for r in b2} == {2} and {r["start"] for r in a} == {0}
    assert _last_stage(a)["losses"] == _last_stage(b1)["losses"] + _last_stage(b2)["losses"]
    assert ck.Checkpointer(tmp_path / "A").steps() == [1, 3]
    want = pytree.flatten_with_path(ck.Checkpointer(tmp_path / "A").restore(3))
    got = pytree.flatten_with_path(ck.Checkpointer(tmp_path / "B").restore(3))
    assert [p for p, _ in got] == [p for p, _ in want]
    assert {p[0] for p, _ in want} == {"stage0", "stage1", "stage2"}
    assert {p[-1] for p, _ in want if p[1] == "opt_state"} == {"exp_avg", "exp_avg_sq", "step"}
    for (path, x), (_, y) in zip(got, want):
        assert x.dtype == y.dtype and torch.equal(x, y), path
    # the DP replicas of a stage wrote their shared tensors once
    files = sorted(p.name for p in (tmp_path / "A" / "3").iterdir())
    assert ".metadata" in files


def _jax_lab():
    path = Path(__file__).resolve().parents[1] / "lab" / "s01_b2_dp_pp.py"
    spec = importlib.util.spec_from_file_location("jax_lab_s01_b2_dp_pp_ckpt", path)
    lab = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(lab)
    return lab


def test_lab_checkpoint_flags_and_refusals(monkeypatch):
    """The flags keep the JAX lab's defaults; ResNet takes no checkpoint (as
    in JAX), and a cadence that is not a multiple of the steps per dispatch
    refuses before any rank starts."""
    want = vars(_jax_lab().parse_args(["--workload", "llama", "--ckpt-dir", "d"]))
    got = vars(dp_pp.parse_args(["--workload", "llama", "--ckpt-dir", "d"]))
    assert {k: got[k] for k in ("ckpt_dir", "ckpt_every")} == \
        {k: want[k] for k in ("ckpt_dir", "ckpt_every")} == {"ckpt_dir": "d", "ckpt_every": 100}
    monkeypatch.setattr(dp_pp, "spawn", lambda *a, **k: pytest.fail("a rank started"))
    with pytest.raises(ValueError, match="llama workload only"):
        dp_pp.main(["--workload", "resnet", "--device", "cpu", "--ckpt-dir", "d"])
    with pytest.raises(ValueError, match="not a multiple"):
        dp_pp.main(["--workload", "llama", "--device", "cpu", "--scan-steps", "2",
                    "--ckpt-dir", "d", "--ckpt-every", "3"])
