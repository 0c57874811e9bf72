"""What ``torch.cuda.memory_allocated`` holds around a full-width serve
engine, the numbers the serving memory band is built from: the cuBLAS
workspace a stream's first product makes (and cuBLASLt's, from a linear
with a bias), then three full-width bf16 serving benches in one process
(ramp, shared, ramp; 3 s of traffic, no A/B arms), each with the bytes
allocated before its weights, before and after its engine's warm-up, the
warm-up's captured static tensors, the engine's bill, and the band of its
``mem`` record.  Prints one line per measurement.

    PYTHONPATH=. python tools/serve_mem_probe.py

Needs a card."""
import json
import subprocess
import sys
import time

import torch


def allocated() -> int:
    torch.cuda.synchronize()
    return torch.cuda.memory_allocated(0)


def workspaces(dev) -> None:
    a = torch.randn(256, 256, device=dev, dtype=torch.bfloat16)
    before = allocated()
    b = a @ a
    print("first product on the current stream: +", allocated() - before - b.nbytes, "B",
          flush=True)
    w = torch.randn(64, 256, device=dev, dtype=torch.bfloat16)
    bias = torch.randn(64, device=dev, dtype=torch.bfloat16)
    before = allocated()
    y = torch.nn.functional.linear(a, w, bias)
    print("first linear with a bias (cuBLASLt): +", allocated() - before - y.nbytes, "B",
          flush=True)
    for i in range(3):
        stream = torch.cuda.Stream(dev)
        before = allocated()
        with torch.cuda.stream(stream):
            z = a @ a
            y2 = torch.nn.functional.linear(a, w, bias)
        print(f"both on new pool stream {i}: +", allocated() - before - z.nbytes - y2.nbytes,
              "B", flush=True)


def benches(dev) -> None:
    from ddl25spring_tpu_torch.models import llama
    from ddl25spring_tpu_torch.obs import state
    from ddl25spring_tpu_torch.serve import driver, engine

    state.enable(True)
    marks: dict = {}
    warmup, init = engine.ServeEngine.warmup, llama.Llama.__init__

    def timed_warmup(self):
        marks["before_warmup"] = allocated()
        warmup(self)
        marks["after_warmup"] = allocated()
        progs = [self._tick, self._release, *self._prefill_programs.values()]
        marks["graph_static_bytes"] = sum(
            t.untyped_storage().nbytes() for p in progs
            for t in [*(p.static or []), *(p.outs or [])] if isinstance(t, torch.Tensor))
        marks["bill"] = self.mem_budget_bytes(per_chip=True)

    def marked_init(self, *a, **k):
        marks.setdefault("before_params", allocated())
        init(self, *a, **k)

    engine.ServeEngine.warmup, llama.Llama.__init__ = timed_warmup, marked_init
    for profile in ("ramp", "shared", "ramp"):
        marks.clear()
        t0 = time.perf_counter()
        rec = driver.run_serve_bench(model="ref", duration_s=3.0, profile=profile,
                                     skip_ab=True, skip_prefix_ab=True, device=dev)
        mem = rec["mem"]
        print(profile, f"{time.perf_counter() - t0:.1f} s", json.dumps(marks), "peak",
              mem["memscope"]["live_bytes_peak"], "band", json.dumps(mem["budget"]),
              "after", allocated(), flush=True)


if __name__ == "__main__":
    print(sys.version, torch.__version__, torch.version.cuda, flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    workspaces(torch.device("cuda", 0))
    benches(torch.device("cuda", 0))
