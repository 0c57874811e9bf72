"""PyTorch/CUDA port of ``ddl25spring_tpu`` for NVIDIA Hopper (H100).

The JAX package beside it is the reference; this package mirrors its module
paths (``utils/config.py``, ``models/llama.py``, ``ops/flash_attention.py``,
...) so each piece has an obvious counterpart.  It imports torch and numpy,
never jax and never the JAX package.

What is ported so far is the single-card LLaMA training path
(:mod:`ddl25spring_tpu_torch.primer`): TinyStories -> LLaMA forward ->
causal-LM loss -> backward -> Adam, with attention through the hand-written
sm_90a flash-attention kernels in ``ops/csrc/``; and its distributed forms,
one process per rank on ``torch.distributed``: data parallelism
(:mod:`~ddl25spring_tpu_torch.parallel.dp`, its all-reduce optionally issued
from the backward), the pipeline and the 2 x 3 DP x PP step under the five
schedules of the JAX package
(:mod:`~ddl25spring_tpu_torch.parallel.schedule`,
:mod:`~ddl25spring_tpu_torch.parallel.pipeline`,
:mod:`~ddl25spring_tpu_torch.lab.dp_pp`), microbatch gradient
accumulation; and the ResNet-18/CIFAR-10
benchmark step (:mod:`~ddl25spring_tpu_torch.benchmarks`,
:mod:`~ddl25spring_tpu_torch.models.resnet`,
:mod:`~ddl25spring_tpu_torch.parallel.het_pipeline`), pure DP or the
heterogeneous DP x PP pipeline, on cuDNN; and the federated-learning layer
(:mod:`~ddl25spring_tpu_torch.fl`): FedSGD and FedAvg on MNIST with the
clients vmapped by ``torch.func``, the split-NN VFL and the tabular VAE with
TSTR on the heart-disease table, and the bench entry that times a FedAvg
round (:mod:`~ddl25spring_tpu_torch.bench`).  Entry points run on CUDA unless
the caller passes ``device="cpu"``; on the CPU each kernel's plain PyTorch
version runs in its place.
"""
