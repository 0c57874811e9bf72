"""Where a spawned world's start-up time goes: ``parallel.launch.spawn``
worlds of 6 (twice: the first starts the fork server), 6 with the port's
pipeline modules imported, 6 building the full-width LLaMA, and 2; each
rank's fork latency, CUDA context, first product, gloo rendezvous (and the
import or the model), the slowest rank's of each printed with the world's
wall.

    PYTHONPATH=. python tools/spawn_cost.py

Needs a card."""
import time

import torch


def rank(rdv, t_parent, what):
    t0 = time.time()
    out = {"fork": t0 - t_parent}
    if what == "imports":
        import ddl25spring_tpu_torch.lab.dp_pp  # noqa: F401
        import ddl25spring_tpu_torch.models.llama  # noqa: F401
        import ddl25spring_tpu_torch.parallel.pipeline  # noqa: F401
        out["imports"] = time.time() - t0
    t = time.time()
    torch.cuda.set_device(0)
    torch.zeros(1, device="cuda")
    out["cuda_init"] = time.time() - t
    t = time.time()
    a = torch.randn(64, 64, device="cuda")
    (a @ a).sum().item()
    out["first_mm"] = time.time() - t
    t = time.time()
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=rdv.init_method, rank=rdv.rank,
                            world_size=rdv.world)
    dist.barrier()
    out["gloo_init"] = time.time() - t
    if what == "llama":
        from ddl25spring_tpu_torch.models.llama import Llama
        from ddl25spring_tpu_torch.utils.config import LlamaConfig

        t = time.time()
        m = Llama(LlamaConfig(dtype="bfloat16", use_flash=True), device="cpu",
                  generator=torch.Generator().manual_seed(0))
        out["llama_cpu"] = time.time() - t
        t = time.time()
        m.to("cuda")
        torch.cuda.synchronize()
        out["to_cuda"] = time.time() - t
    dist.destroy_process_group()
    out["total"] = time.time() - t_parent
    return out


if __name__ == "__main__":
    from ddl25spring_tpu_torch.parallel.launch import spawn

    for world, what in ((6, "bare"), (6, "bare"), (6, "imports"), (6, "llama"), (2, "bare")):
        t0 = time.time()
        outs = spawn(rank, world, t0, what, timeout=300)
        print(f"world {world} {what}: wall {time.time() - t0:.2f} s; slowest rank " +
              ", ".join(f"{k} {max(o[k] for o in outs):.2f}" for k in outs[0]), flush=True)
