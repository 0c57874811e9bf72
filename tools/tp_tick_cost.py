"""The full-width bf16 TP decode tick (4 slots decoding, 2 ranks of a
``1 x 2`` model mesh on ``cuda:0`` over gloo) of the checkout in the
working directory: a resident and a streamed (ZeRO-3 rows) engine on each
rank, each's persistent bytes after warmup, peak (``max_memory_allocated``)
over 16 timed ticks, median wall and device busy (torch.profiler, 4
ticks).  Prints one JSON line.

    PYTHONPATH=. python tools/tp_tick_cost.py

To compare two commits on one card, unpack the other one into a
git-ignored directory (``git archive <commit> | tar -x -C runs/other``) and
run this file from each root in turn in one session (A, B, B, A), with
``PYTHONPATH`` set to that root: the engine is imported from there.
Needs a card."""
import json
import os
import statistics
import sys
import time

import torch

TICKS, PROFILED = 16, 4


def rank(rdv):
    from torch.profiler import ProfilerActivity, profile

    from ddl25spring_tpu_torch.models.llama import Llama
    from ddl25spring_tpu_torch.serve import driver
    from ddl25spring_tpu_torch.serve.engine import ServeEngine
    from ddl25spring_tpu_torch.utils.config import LlamaConfig
    from ddl25spring_tpu_torch.utils.mesh import init_mesh

    cfg = LlamaConfig()
    model = Llama(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    model.requires_grad_(False)
    g = torch.Generator().manual_seed(1)
    prompts = [torch.randint(1, cfg.vocab_size, (16,), generator=g).tolist() for _ in range(4)]
    out = {}
    with init_mesh(rdv, 1, model=2, device="cuda") as mesh:
        dev = mesh.device
        for name, ws in (("resident", False), ("streamed", True)):
            knobs = {**driver.engine_knobs(), "max_prompt_len": 16, "prefill_batch": 4,
                     "tp": 2, "weight_stream": ws}
            torch.cuda.synchronize(dev)
            before = torch.cuda.memory_allocated(dev)
            eng = ServeEngine(model, cfg, **knobs, mesh=mesh, graphs=False, clock="wall",
                              trace_label=None)
            eng.warmup()
            torch.cuda.synchronize(dev)
            held = torch.cuda.memory_allocated(dev) - before
            for p in prompts:
                eng.submit(eng.make_request(p, 200))
            while eng.queue:
                eng.step()
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            walls = []
            for _ in range(TICKS):
                t0 = time.perf_counter()
                eng.step()
                walls.append(time.perf_counter() - t0)
            torch.cuda.synchronize(dev)
            peak = torch.cuda.max_memory_allocated(dev) - before
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for _ in range(PROFILED):
                    eng.step()
                torch.cuda.synchronize(dev)
            busy = sum(e.self_device_time_total for e in prof.key_averages()
                       if e.device_type == torch.autograd.DeviceType.CUDA
                       and not e.is_user_annotation) / 1e3 / PROFILED
            out[name] = {"held": held, "peak": peak, "bill": eng.mem_budget_bytes(),
                         "median_ms": statistics.median(walls[TICKS // 4:]) * 1e3,
                         "busy_ms": busy, "tokens": list(eng.slots[0].tokens)}
            del eng
    return out


def main():
    from ddl25spring_tpu_torch.parallel.launch import spawn

    ranks = spawn(rank, 2, timeout=300)
    print(json.dumps({"checkout": os.path.basename(os.getcwd()), "ranks": [
        {k: {kk: vv for kk, vv in v.items() if kk != "tokens"} for k, v in r.items()}
        for r in ranks],
        "streamed_equals_resident": all(r["streamed"]["tokens"] == r["resident"]["tokens"]
                                        for r in ranks)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, os.getcwd())
    sys.exit(main())
