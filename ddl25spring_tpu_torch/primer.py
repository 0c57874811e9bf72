"""Tutorial 1b primer on PyTorch: centralized LLaMA training on one card.

``next(iter_ds) -> model(x) -> causal_lm_loss -> backward -> Adam.step``, the
loop of ``lab/tutorial_1b/primer/intro.py:23-33``, at the workload constants
(vocab 4096, dmodel 288, 6 heads, 6 layers, ctx 256; byte-tokenizer ids fit the
vocab).  On CUDA it computes in bf16 over float32 parameters with attention
through the flash-attention kernels (``--no-flash``: dense attention); on the
CPU (``--device cpu``) it computes in float32 and the kernels' plain versions
stand in.

Run: ``python -m ddl25spring_tpu_torch.primer [--iters 20] [--device cuda]``
"""

from __future__ import annotations

import argparse
import time

import torch

from ddl25spring_tpu_torch.data.tinystories import TinyStories
from ddl25spring_tpu_torch.data.tokenizer import get_tokenizer
from ddl25spring_tpu_torch.models.llama import Llama
from ddl25spring_tpu_torch.ops.losses import causal_lm_loss
from ddl25spring_tpu_torch.parallel.dp import make_train_step
from ddl25spring_tpu_torch.utils.config import LlamaConfig
from ddl25spring_tpu_torch.utils.device import resolve_device


def main(argv=None) -> dict:
    """Train and print the loss of every iteration.  Returns ``{"losses":
    [...], "step_s": [...]}``: each step's loss and its host wall time, from
    the dispatch to the loss read back (which waits for the device)."""
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--batch", type=int, default=3)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--lr", type=float, default=8e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--no-flash", action="store_true",
                    help="dense attention instead of the flash kernels")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    tok = get_tokenizer()
    cfg = LlamaConfig(
        vocab_size=4096, dmodel=288, num_heads=6, n_layers=6,
        ctx_size=args.seq_len,
        dtype="bfloat16" if device.type == "cuda" else "float32",
        use_flash=not args.no_flash,
    )
    model = Llama(cfg, device=device,
                  generator=torch.Generator().manual_seed(args.seed))
    # capturable: the step count lives on the card, so the step can be one
    # CUDA graph (parallel/pipeline.fuse_train_steps); the CPU has no such mode
    opt = torch.optim.Adam(model.parameters(), lr=args.lr,
                           capturable=device.type == "cuda")

    def loss_fn(m, tokens):
        return causal_lm_loss(m(tokens), tokens)

    step = make_train_step(model, loss_fn, opt)
    ds = iter(TinyStories(tok, batch_size=args.batch, seq_l=args.seq_len,
                          seed=args.seed))
    losses, step_s = [], []
    for it in range(args.iters):
        tokens = torch.from_numpy(next(ds)).to(device=device, dtype=torch.long)
        t0 = time.perf_counter()
        loss = float(step(tokens))
        step_s.append(time.perf_counter() - t0)
        losses.append(loss)
        print(f"iter {it:3d}  loss {loss:.4f}  step {step_s[-1] * 1e3:.2f} ms",
              flush=True)
    return {"losses": losses, "step_s": step_s}


if __name__ == "__main__":
    main()
