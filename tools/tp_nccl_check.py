"""TP serving over NCCL, one rank per card (a host with 2 or more cards):
the ``tp=2`` engine of the tiny model, resident and streamed, through the
smoke trace on the wall clock (rank 0's reading broadcast each scheduler
iteration), every rank's streams equal; then ``bench --serve --serve-model
ref --serve-tp 2`` resident and with ``DDL25_SERVE_WEIGHT_STREAM=1`` and
``serve_report --check-tp`` on each row.  Prints ``NCCL TP OK`` and exits
0 when both ranks ran on NCCL and every request completed.

    python tools/tp_nccl_check.py                          # on the cards
    NCCL_TP_DEVICE=cpu python tools/tp_nccl_check.py       # a rehearsal over gloo

Run from the repository root."""
import os
import sys
import tempfile

import torch

DEV = os.environ.get("NCCL_TP_DEVICE", "cuda")  # "cpu": a rehearsal over gloo


def rank(rdv):
    from ddl25spring_tpu_torch.models.llama import Llama
    from ddl25spring_tpu_torch.serve import driver
    from ddl25spring_tpu_torch.serve.engine import ServeEngine
    from ddl25spring_tpu_torch.serve.traffic import TrafficSpec, synth_trace
    from ddl25spring_tpu_torch.utils.mesh import init_mesh

    out = {}
    with init_mesh(rdv, 1, model=2, device=DEV) as mesh:
        cfg = driver.serve_model("tiny")
        model = Llama(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
        trace = synth_trace(TrafficSpec(**driver.SMOKE_TRAFFIC, vocab_size=cfg.vocab_size))
        out["backend"], out["device"] = mesh.backend, str(mesh.device)
        for ws in (False, True):
            eng = ServeEngine(model.requires_grad_(False), cfg,
                              **{**driver.engine_knobs(smoke=True), "tp": 2, "weight_stream": ws},
                              mesh=mesh, graphs=False, clock="wall", trace_label=None)
            eng.warmup()
            m = eng.run(trace, max_steps=5_000)
            out[ws] = (m["completed"], m["admitted"], sorted((r.rid, r.tokens) for r in eng.done))
    return out


def main():
    from ddl25spring_tpu_torch import bench
    from ddl25spring_tpu_torch.parallel.launch import spawn
    from tools import serve_report

    print("cards", torch.cuda.device_count(), flush=True)
    ranks = spawn(rank, 2, timeout=300)
    ok = True
    for r in ranks:
        print("rank backend", r["backend"], r["device"], "resident completed/admitted",
              r[False][:2], "streamed", r[True][:2], flush=True)
        ok &= r["backend"] == "nccl" and r[False][0] == r[False][1] > 0
        ok &= r[False][2] == r[True][2] == ranks[0][False][2]
    with tempfile.TemporaryDirectory() as tmp:
        for mode, env in (("resident", {}), ("streamed", {"DDL25_SERVE_WEIGHT_STREAM": "1"})):
            os.environ.update(env)
            led, obs = os.path.join(tmp, mode + ".jsonl"), os.path.join(tmp, mode)
            rec = bench.main(["--serve", "--serve-model", "ref", "--serve-tp", "2", "--device",
                              DEV, "--serve-duration", "1.0", "--no-serve-ab",
                              "--no-serve-prefix-ab", "--perf-ledger", led, "--obs-dir", obs])
            for k in env:
                os.environ.pop(k)
            cell = rec["telemetry"]["serve"]
            gate = serve_report.main([obs, "--ledger", led, "--check-tp"])
            print(f"bench {mode}: completed {cell['completed']}/{cell['admitted']}, "
                  f"tokens/s {cell['tokens_per_sec_per_chip']}, tp_ab {cell['tp_ab']}, "
                  f"check-tp exit {gate}", flush=True)
            ok &= cell["completed"] == cell["admitted"] > 0
    print("NCCL TP OK" if ok else "NCCL TP FAILED", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.path.insert(0, os.getcwd())
    sys.exit(main())
