"""Homework B1 on PyTorch: the microbatch pipeline, one process per stage.

The counterpart of ``lab/s01_b1_microbatches.py``: the LLaMA workload in 3
stages, batch 3 in 3 microbatches, Adam 8e-4 (``utils/config.py``
``PipelineConfig``), 200 steps, one pipeline and no DP, under any of the
five schedules (``--schedule``, ``--chunks``).  It is
:mod:`~ddl25spring_tpu_torch.lab.dp_pp` with ``--workload llama`` and a
data axis of 1, and takes its options, ``--batch``, ``--microbatches``,
``--lr`` and ``--iters`` among them, plus the JAX lab's ``--stages`` (0:
the reference's 3; here stages are processes, not devices, so no device
count picks them).  ``--scan-steps`` follows
``lab/s01_b1_microbatches.py:147-160``: the three ranks share the card over
gloo, so on the card the default resolves to 1 and an explicit K > 1 raises
(:func:`~ddl25spring_tpu_torch.lab.dp_pp.llama_scan_steps`); on the CPU K
steps run as a loop.

Run: ``python -m ddl25spring_tpu_torch.lab.microbatches [--iters 200] [--device cuda]
[--schedule 1f1b] [--stages 3]``
"""

from __future__ import annotations

import argparse
import sys

from ddl25spring_tpu_torch.lab import dp_pp
from ddl25spring_tpu_torch.utils.config import DpPpConfig, PipelineConfig


def main(argv=None) -> dict:
    # B1 is LLaMA's, whatever lab.dp_pp's default workload; an explicit
    # --workload comes after this one and wins, and anything but llama raises
    stages = argparse.ArgumentParser(add_help=False)
    stages.add_argument("--stages", type=int, default=0)
    known, rest = stages.parse_known_args(sys.argv[1:] if argv is None else argv)
    argv = ["--workload", "llama", *rest]
    if dp_pp.parse_args(argv).workload != "llama":
        raise ValueError("lab.microbatches runs homework B1's LLaMA workload only; the "
                         "ResNet step runs through lab.dp_pp --workload resnet")
    p = PipelineConfig()
    return dp_pp.main(argv, DpPpConfig(data=1, num_stages=known.stages or p.num_stages,
                                       num_microbatches=p.num_microbatches,
                                       per_replica_batch=p.batch_size,
                                       learning_rate=p.learning_rate))


if __name__ == "__main__":
    main()
