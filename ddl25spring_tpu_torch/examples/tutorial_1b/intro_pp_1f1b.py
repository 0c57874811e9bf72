"""Tutorial 1b, PP: the 1F1B single-batch pipeline, on PyTorch.  The
counterpart of ``examples/tutorial_1b/intro_pp_1f1b.py``.

The reference (``lab/tutorial_1b/PP/1F1B/intro_PP_1F1B.py:27-95``) chains
three processes: rank 0 embeds and sends, rank 1 receives, applies its
layers and sends, rank 2 applies its layers and takes the loss and the
backward, the boundary gradients flowing back with ``send(inp.grad)`` and
``out.backward(recv)``.  Here the same three ranks run
:func:`~ddl25spring_tpu_torch.parallel.pipeline.make_pipeline_train_step`
with ``schedule="1f1b"`` on one microbatch (``--microbatches`` raises it to
the steady state of 1F1B; ``--schedule`` picks another schedule to compare):
the full-width LLaMA, batch 3, Adam 8e-4, bf16 with the flash kernels on
CUDA.

Run: ``python -m ddl25spring_tpu_torch.examples.tutorial_1b.intro_pp_1f1b
[--iters 20] [--microbatches 1] [--device cpu]``
"""

from __future__ import annotations

import argparse

from ddl25spring_tpu_torch.lab import dp_pp
from ddl25spring_tpu_torch.parallel.launch import spawn
from ddl25spring_tpu_torch.parallel.pipeline import SCHEDULES
from ddl25spring_tpu_torch.utils.config import LlamaConfig
from ddl25spring_tpu_torch.utils.device import resolve_device

STAGES = 3


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--batch", type=int, default=3)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--lr", type=float, default=8e-4)
    ap.add_argument("--microbatches", type=int, default=1,
                    help="1 = the reference's single-batch chain")
    ap.add_argument("--schedule", choices=[s for s in SCHEDULES if "interleaved" not in s],
                    default="1f1b")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    cfg = LlamaConfig(ctx_size=args.seq_len,
                      dtype="bfloat16" if device.type == "cuda" else "float32")
    job = dp_pp.Job(cfg, 1, STAGES, args.microbatches, batch=args.batch, iters=args.iters,
                    lr=args.lr, seed=args.seed, device=device.type, schedule=args.schedule)
    print(f"{args.schedule} pipeline: {STAGES} stages, M={args.microbatches} (reference: "
          f"3 ranks, single batch), device={device.type}", flush=True)
    ranks = spawn(dp_pp.run_rank, STAGES, job)
    return {"losses": ranks[-1]["losses"], "ranks": ranks}


if __name__ == "__main__":
    main()
