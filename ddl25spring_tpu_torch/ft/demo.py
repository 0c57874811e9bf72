"""Minimal deterministic resumable training loop: the fault-tolerance test
vehicle (the counterpart of the JAX package's ``ft/demo.py``).

A tiny DP tanh-MLP regression whose whole trajectory is a pure function of
``(rng_seed, step)``: the batch consumed at step ``i`` comes from a
``torch.Generator`` seeded by ``(seed, cursor)``, and the cursor is part of
the checkpointed resume bundle.  That makes the package's central claim
checkable from outside::

    python -m ddl25spring_tpu_torch.ft.demo --steps 8 --out ref.npz ...
    DDL25_CHAOS=kill@6 python -m ddl25spring_tpu_torch.ft.demo ...  # dies -9
    python -m ddl25spring_tpu_torch.ft.demo ...                      # resumes
    # ref.npz == the resumed run's npz, BITWISE

If the data cursor or the seed failed to round-trip through the checkpoint,
the resumed run would consume other batches and its parameters would
differ.

It runs the full production path: the flight recorder installed (SIGTERM
drains the checkpoint through its shutdown hooks), chaos armed from
``DDL25_CHAOS`` (the one-shot journal in the checkpoint directory), the
sentinel-gated autosave, auto-resume from the latest durable step, and
``FT-DEMO`` marker lines.  ``--devices N`` trains on N gloo ranks
(``make_dp_train_step``), one process each; one rank trains in this
process.  A rank that chaos kills takes this process with it the same way
(SIGKILL: exit -9; SIGTERM: 143), so a caller sees what it would see of a
single killed process.  On the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import os
import re
import signal
import sys

D_IN, D_H, D_OUT = 16, 32, 4


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--save-every", type=int, default=2)
    ap.add_argument("--ckpt-dir", required=True)
    ap.add_argument("--run-dir", default=None,
                    help="flight.json dump dir (default: DDL25_FLIGHT_DIR)")
    ap.add_argument("--out", default=None, help="write the final parameters as .npz here")
    ap.add_argument("--devices", type=int, default=2,
                    help="DP ranks, one gloo process each (1: this process alone)")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--sync-saves", action="store_true",
                    help="synchronous checkpointing: every save durable before the next "
                         "step (deterministic tests)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--timeout", type=float, default=300.0,
                    help="seconds before spawned ranks are killed")
    return ap.parse_args(argv)


def data_at(seed: int, cursor: int, batch: int):
    """The deterministic input stream: batch ``cursor`` is a pure function of
    the checkpointed seed and cursor (host tensors)."""
    import torch

    g = torch.Generator().manual_seed(seed * 1_000_003 + cursor)
    return torch.randn(batch, D_IN, generator=g), torch.randn(batch, D_OUT, generator=g)


def _mlp(seed: int, device):
    import torch
    from torch import nn

    class TanhMlp(nn.Module):
        def __init__(self):
            super().__init__()
            g = torch.Generator().manual_seed(seed)
            self.w1 = nn.Parameter((torch.randn(D_IN, D_H, generator=g) * 0.1).to(device))
            self.w2 = nn.Parameter((torch.randn(D_H, D_OUT, generator=g) * 0.1).to(device))

    return TanhMlp()


def _loss(model, batch):
    import torch

    x, y = batch
    return ((torch.tanh(x @ model.w1) @ model.w2 - y) ** 2).mean()


def train(rdv, args) -> dict | None:
    """One rank's run (``rdv`` None: this process alone).  Returns the final
    parameters as numpy on rank 0."""
    import numpy as np
    import torch

    from ddl25spring_tpu_torch.ft import AutoSaver, ChaosInjector, resume_bundle
    from ddl25spring_tpu_torch.obs import flight
    from ddl25spring_tpu_torch.parallel.dp import make_dp_train_step, make_train_step
    from ddl25spring_tpu_torch.utils import checkpoint as ck
    from ddl25spring_tpu_torch.utils import pytree
    from ddl25spring_tpu_torch.utils.device import resolve_device
    from ddl25spring_tpu_torch.utils.mesh import init_mesh

    mesh = init_mesh(rdv, args.devices, stages=1, device=args.device) if rdv else None
    try:
        dev = mesh.device if mesh else resolve_device(args.device)
        flight.configure(run_dir=args.run_dir)
        flight.install()  # SIGTERM/excepthook/atexit: checkpoint barrier + dump
        flight.annotate(driver="ft-demo", steps=args.steps, seed=args.seed)
        model = _mlp(args.seed, dev)
        opt = torch.optim.Adam(model.parameters(), lr=1e-2)
        step = (make_dp_train_step(model, _loss, opt, mesh) if mesh
                else make_train_step(model, _loss, opt))
        named = list(model.named_parameters())
        saver = AutoSaver(args.ckpt_dir, save_every=args.save_every, max_to_keep=10,
                          async_save=not args.sync_saves,
                          meta={"driver": "ft-demo", "steps": args.steps})
        chaos = ChaosInjector.from_env(state_dir=args.ckpt_dir)

        def bundle(cursor, seed, opt_state):
            return resume_bundle({n: p.detach() for n, p in named}, opt_state,
                                 data_cursor=cursor, rng_seed=seed)

        state, start = saver.restore_or_init(
            bundle(0, args.seed, ck.optimizer_template(opt, named)))
        if start:
            with torch.no_grad():
                for n, p in named:
                    p.copy_(state["params"][n])
            ck.load_optimizer_state(opt, named, state["opt_state"])
        cursor = int(state["data_cursor"])
        # the RESTORED seed is authoritative from here on: re-persisting
        # args.seed would desync a second resume's data stream when the
        # relaunch was (mis)launched with another --seed
        rng_seed = int(state["rng_seed"])
        rank = mesh.rank if mesh else 0
        if rank == 0:
            print(f"FT-DEMO start={start} cursor={cursor} "
                  f"durable={saver.ckpt.latest_step()}", flush=True)
        loss = None
        for i in range(start, args.steps):
            x, y = chaos.poison_batch(data_at(rng_seed, cursor, args.batch), i)
            loss = step((x.to(dev), y.to(dev)))
            cursor += 1
            flight.record(kind="step", strategy="ft-demo", step=i, loss=float(loss))
            chaos.on_step(i)  # kill-type faults: AFTER the step, BEFORE the save
            saver.maybe_save(i, bundle(cursor, rng_seed, ck.optimizer_state(opt, named)),
                             loss=loss)
        saver.close()
        if rank == 0:
            print(f"FT-DEMO done steps={args.steps} "
                  f"loss={None if loss is None else float(loss)}", flush=True)
            return {pytree.keystr((n,)): p.detach().cpu().numpy() for n, p in named}
        return None
    finally:
        if mesh is not None:
            mesh.close()


def _die_like(err: Exception) -> None:
    """Exit as the first rank that chaos killed did: SIGKILL yourself for a
    rank killed by SIGKILL, exit 143 for one that SIGTERM ended."""
    codes = [int(c) for c in re.findall(r"exited with code (-?\d+)", str(err))]
    if -signal.SIGKILL in codes:
        os.kill(os.getpid(), signal.SIGKILL)
    if 128 + signal.SIGTERM in codes or -signal.SIGTERM in codes:
        sys.stderr.write(str(err)[-2000:] + "\n")
        sys.stderr.flush()
        os._exit(128 + signal.SIGTERM)


def main(argv=None) -> int:
    args = parse_args(argv)
    import numpy as np

    if args.devices > 1:
        from ddl25spring_tpu_torch.parallel.launch import spawn

        try:
            params = spawn(train, args.devices, args, timeout=args.timeout)[0]
        except RuntimeError as e:
            _die_like(e)
            raise
    else:
        params = train(None, args)
    if args.out:
        np.savez(args.out, **params)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
