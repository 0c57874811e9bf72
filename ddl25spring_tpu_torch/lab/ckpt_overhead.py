"""The 2 x 3 LLaMA lab's step with async checkpoints, synchronous ones, async
ones under a 0.1 ms GIL switch interval, and none, in turns on one card.

Each variant runs 12 steps of ``lab.dp_pp``'s full-width bf16 ``gpipe`` job
with ``--ckpt-every 2`` (none: no checkpoint) and prints one JSON line: the
slowest rank's step times, their median over steps 1..11, the loop's wall
after the first step with the saves' blocking time, and each save's blocking
wall.  The sync variant builds every ``Checkpointer`` with
``async_save=False`` inside the ranks.  Run from the repository root on the
card: ``python -m ddl25spring_tpu_torch.lab.ckpt_overhead``.
"""
import json
import statistics
import sys
import tempfile
import time

from ddl25spring_tpu_torch.lab import dp_pp
from ddl25spring_tpu_torch.parallel.launch import spawn
from ddl25spring_tpu_torch.utils.config import DpPpConfig


def rank(rdv, job, variant):
    """One rank of ``job`` under ``variant``'s checkpoint setting."""
    from ddl25spring_tpu_torch.utils import checkpoint as ck
    if variant == "switch":
        sys.setswitchinterval(1e-4)
    if variant == "sync":
        orig = ck.Checkpointer.__init__

        def init(self, *a, **k):
            k["async_save"] = False
            orig(self, *a, **k)
        ck.Checkpointer.__init__ = init
    return dp_pp.run_rank(rdv, job)


def main():
    from ddl25spring_tpu_torch.ops import _build
    _build.build(_build.CSRC / "flash_attention.cu", _build.CSRC / "flash_attention_sm90.cu")
    args = dp_pp.parse_args(["--workload", "llama", "--iters", "12"])
    base, _ = dp_pp.llama_job(args, DpPpConfig())
    for variant in ("none", "async", "switch", "sync", "async", "switch", "none", "sync"):
        d = tempfile.mkdtemp()
        job = base.__class__(**{**base.__dict__, "ckpt_dir": "" if variant == "none" else d,
                                "ckpt_every": 2, "log": False})
        t0 = time.perf_counter()
        ranks = spawn(rank, 6, job, variant, timeout=600)
        wall = time.perf_counter() - t0
        steps = [max(r["step_s"][i] for r in ranks) * 1e3 for i in range(len(ranks[0]["step_s"]))]
        saves = [s * 1e3 for r in ranks for s in r["ckpt_s"]]
        loop = sum(steps[1:]) + (max(sum(r["ckpt_s"]) for r in ranks) * 1e3)
        print(json.dumps({"variant": variant, "median_step_ms": round(statistics.median(steps[1:]), 3),
                          "steps_ms": [round(x, 1) for x in steps], "loop_ms_after_first": round(loop, 1),
                          "save_block_ms_median": round(statistics.median(saves), 3) if saves else None,
                          "save_block_ms_max": round(max(saves), 3) if saves else None,
                          "spawn_wall_s": round(wall, 1)}), flush=True)


if __name__ == "__main__":
    main()
