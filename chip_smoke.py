#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``ddl25spring_tpu_torch``) on one NVIDIA H100.

Phases, in order; any failure exits non-zero and prints no result:

1. card: ``nvidia-smi`` name and power limit, torch and CUDA versions;
2. build: ``nvcc`` compiles ``ops/csrc/flash_attention.cu`` (scalar kernels),
   ``ops/csrc/flash_attention_sm90.cu`` (bf16 tensor-core kernels) and
   ``ops/csrc/flash_attention_tf32x3.cu`` (the fp32 forward, dq and dk/dv on
   the tensor cores, 3xTF32) for sm_90a from the checkout, in parallel, while
   phase 9 (e), phase 22 (a)-(c) and phase 23 (a), (c) start beside them,
   and 23 (b) once they are built (none of them times anything of the
   card); they run on through phase 3, the model check and phase 7, and end
   before the primer (phase 5), which runs after phase 7 with the card to
   itself; phases 4 and 6, which time the card, run after it; the build
   time and the ``ptxas`` registers and spills of every instantiation are
   printed;
3. kernels: the forward, dq and dk/dv kernels against their plain PyTorch
   versions on the same inputs, on the card, at the LLaMA path's shape
   ``[3, 256, 6, 48]`` (bf16 and fp32), causal and not, ragged L=200 at hd
   64, 48 and 40, L=17, hd 32 and 128, the tensor-core kernels at every
   instruction width (hd 16, 80, 96, 112), hd 36 (bf16 on the scalar
   variant), non-square non-causal, odd lengths with BH = 2; the fp32
   ``tf32x3`` forward, dq and dk/dv at hd 16-128 (20: padded to 32), L
   17/66/130/200/256, causal and not, Lk != Lq, each twice and bitwise equal
   (o and lse too), and fp32 at hd 18 and misaligned on the scalar variant;
   each case checks which variant each kernel ran.  Plus both autograd Functions (``with_lse`` with
   a nonzero lse cotangent) on the card against the same Functions on the
   CPU, where the plain versions run;
4. timing at the LLaMA path's shape (bf16, causal): each kernel's device time
   per call (torch.profiler kernel events), beside the CUDA-event time of 200
   back-to-back Python calls (``wall_ms``, host-paced), the scalar kernel's
   device time on the same inputs (launched directly, past the dispatch), its plain version, its bound and
   ``scaled_dot_product_attention`` forward and backward, timed both ways;
5. the slice: ``primer.main`` trains the full-width LLaMA (bf16, flash
   kernels, batch 3, ctx 256) for 24 steps; every loss finite, the loss falls,
   each kernel launched 6 times per step, every launch on the tensor-core
   variant, its median step time with the card to itself; before it,
   after phase 3, full-width fp32 logits through the kernels against dense
   attention (the model check, beside phases 9 (e), 22 and 23);
6. profile: device time by kernel, device busy and idle share of the train
   step, with the flash kernels and with dense attention;
7. DP x PP on the card: six rank processes on ``cuda:0`` (2 pipelines x 3
   stages, 3 microbatches, 3 rows per replica; gloo through pinned host
   buffers, since NCCL refuses two ranks on one device), spawned after phase
   2 built the kernels, run after the model check (beside phases 9 (e), 22
   and 23: the slice's printed step time is no measurement; phase 10 (b)
   times the same 2 x 3 DP x PP LLaMA's gpipe step alone):
   (a) fp32, full width, flash kernels: one step's loss and gradients against
       a single-process step on the batch of 6 from the same weights (loss
       rtol 1e-5; gradients atol 2e-4 + rtol 2e-3), then 2 Adam steps (losses
       rtol 1e-4); every rank's forward, dq and dk/dv launches as many
       times, all on ``tf32x3`` (the fp32 path's kernels);
   (b) the slice, ``lab.dp_pp.main``: bf16, flash kernels, 24 steps; losses
       finite and falling, the first within 1 of ln(vocab) (the lab's
       vocabulary is its tokenizer's: 259 bytes), every rank on CUDA
       with each kernel launched 6 times per step, all on the tensor cores;
       the median step time, tokens/s, each stage's ``recv`` wait, the DP
       all-reduce seconds and the bytes staged through the host per step;
   (c) the NCCL path: ``make_dp_train_step`` over ``min(device_count, 2)``
       ranks on cards of their own, fp32, 2 steps against a single-process
       step (losses rtol 1e-4).
   The backend of every run is printed;
8. the ResNet-18/CIFAR-10 slice on the card (cuDNN convolutions, no
   hand-written kernel on its path), each sub-phase timed:
   (a) fp32 exactness: full-width ``ResNet18(norm="group")``, batch 8, one
       SGD step on CUDA (channels_last, TF32 off) and on the CPU from the
       same weights, and a float64 step on the CPU beside them: loss and
       logits within 1e-4 of max |ref|; each gradient leaf within 2e-2 of
       its own max |ref| and each leaf's update within 2e-2 of its largest
       update (a relu input at fp32 rounding of zero may branch differently
       on the two devices); every relu input that takes the other branch
       than in float64 lies within 1e-4 of that relu's max |input|, and
       their count is printed, on the card and on the CPU;
   (b) the headline one step per dispatch, ``lab.dp_pp.main --workload
       resnet --input hbm`` (phase 11 (b) runs the default, 16 steps per
       CUDA graph): layout "dp", one rank, batch 1024, bf16 over float32 parameters, the 50 000-image
       synthetic train split on the card, SGD lr 0.002 (see ``RESNET_LR``),
       3 warm-up and 30 timed steps through ``benchmarks.timed_run`` (cuDNN
       autotuning on); every loss finite, the first within 1 of ln(10), the
       last 5 below the first 5, parameters and data on CUDA, no flash
       kernel launched, eagerly or into a graph; the median step,
       samples/s, FLOPs per step within 10 % of 3.41e12, TFLOP/s and MFU
       (peak 989.4e12) and ``report_line``'s JSON;
   (c) where the step's time goes: torch.profiler over 10 warm steps, host
       wall against device busy, the idle share, the top kernels, and
       convolution, normalisation, elementwise and SGD as shares of busy;
   (d) the heterogeneous pipeline: 2 x 2 ranks sharing ``cuda:0`` over gloo
       (M = 2, full width): an fp32 step (TF32 off, cuDNN deterministic)
       against one process running the same stages on the same 16 rows,
       chunk by chunk (loss rtol 1e-5, gradients atol 2e-4 + rtol 2e-3, as
       phase 7 (a)), then ``lab.dp_pp.main --workload resnet --pp --ranks 4``,
       bf16, batch 64, 10 timed steps: losses finite and falling, every rank
       on CUDA, per-stage recv wait, send and all-reduce seconds, and the
       bytes staged per step equal to the count from the boundary and
       gradient shapes;
9. federated learning on the card (no hand-written kernel on this path:
   the convolutions and products go to cuDNN and cuBLAS), each sub-phase
   timed:
   (a) fp32 exactness: one FedAvg round (N=10, C=0.1, B=100, E=1, on the
       first 10,000 synthetic MNIST rows: 10 batches per client) and one
       FedSGD round (B=-1) of the full-width ``MnistCnn`` on CUDA (TF32 off,
       cuDNN deterministic) and on the CPU from the same weights, both
       drawing masks and orders from CPU generators with the same seeds:
       each parameter leaf within ``FL_LEAF_BAND`` of its max |CPU| (a relu
       or max-pool tie at fp32 rounding may branch the other way); the worst
       leaf is printed;
   (b) the headline, ``bench.fedavg_secondary()``: the golden config on the
       full 60,000 rows, one warm-up and 10 timed rounds: mean and median ms
       per round; the same for FedSGD rounds (B=-1, a 6,000-row full batch
       per client); test accuracy after the rounds at least 0.9 (synthetic
       MNIST saturates), the global weights on CUDA, no flash kernel
       launched, eagerly or into a graph;
   (c) the homework-A1 oracle on the card with dropout on:
       ``FedSgdGradientServer`` against ``FedAvgServer(B=-1, E=1)``, N=4,
       C=0.5, 1,000 rows, 2 rounds, CUDA generators: weights within atol
       1e-5 + rtol 1e-4, test accuracy within 2e-4 per round;
   (d) where a FedAvg round's time goes: host wall over 3 warm rounds
       against device busy under torch.profiler over 1 more, the idle share,
       the top kernels;
   (e) (run during phases 2, 3 and 7, in a process of its own)
       split-NN VFL and the VAE/TSTR on
       ``data/heart.csv`` at the example's
       defaults (4 parties, 300 epochs, batch 64; VAE 150 epochs): the VFL
       test accuracy and TSTR's real and synthetic accuracies within
       ``FL_ACC_BANDS``.

10. the schedules on the card (``parallel/pipeline.py``: ``gpipe``,
    ``1f1b``, ``1f1b-stash``, ``interleaved`` and ``interleaved-1f1b``, 2
    chunks per rank when interleaved), grad accumulation and DP overlap,
    each sub-phase timed; the LLaMA is the labs' (its vocabulary the
    tokenizer's, 259 bytes).  Its worlds, and those of 11 (e), 12, 13 (b)
    and (c), 14, 15 and 17 (d), run first, one after the other, in ONE
    spawned world of 8 ranks (``chain_phase``: each job the world's first
    ranks, meeting in a store of its own), so nine worlds share one
    start-up; the card runs one of them at a time, and each phase checks
    its world's results in its place:
    (a) fp32, full width, flash kernels: one Adam step of every schedule on
        a 1 x 3 grid (batch 3, M 3; the first 3 ranks of the 2 x 3 world,
        ``Mesh.sub``) and on the 2 x 3 world (3 rows per replica) against
        GPipe's on the same weights and tokens (loss rtol
        1e-5, gradients and updated parameters atol 2e-4 + rtol 2e-3, as
        phase 7 (a)); ``1f1b`` against ``1f1b-stash`` as a max abs
        difference;
    (b) bf16, 2 x 3, 3 one-row microbatches, ``SCHED_STEPS`` steps of each schedule: the
        flash launches of every rank per step exactly (fwd twice the layers
        on the rank times M under ``1f1b`` and ``interleaved-1f1b``, which
        recompute the forward, once under the others; dq and dk/dv once),
        every launch on ``wgmma``; the median step (the slowest rank's,
        steps 4 on) and per stage the recv wait, send, DP all-reduce and
        bytes staged;
    (c) bf16, 1 x 3, M = 12 one-row microbatches: each rank's activation peak
        in the second step (``max_memory_allocated`` during it less
        ``memory_allocated`` before it) and the executor's largest stash under
        ``gpipe``, ``1f1b``, ``1f1b-stash`` and ``interleaved-1f1b``; stage
        0 holds 12 under ``gpipe`` and 3 under both 1F1Bs, and its peak
        under ``1f1b-stash`` is below half of ``gpipe``'s;
    (d) ``make_grad_accum_step`` over ResNet-18 (GroupNorm): fp32, 64 rows in
        4 microbatches against one 64-row step (each gradient and update
        leaf within 2e-2 of its max, as phase 8 (a)); bf16 at batch 1024 in
        4 microbatches, its median step beside the batch-1024 step's;
    (e) DP ``overlap=True`` against the sync per-tensor step, 2 gloo ranks
        on the card, fp32, full-width LLaMA, 2 steps: within 1e-7, the
        difference printed, and where each bucket was issued in the backward;
    (f) the kernels' device time at the schedules' per-microbatch shape
        ``[6, 256, 48]`` bf16 and the fp32 kernels' (``tf32x3``) at
        ``[18, 256, 48]`` causal and non-causal and ``[6, 256, 48]`` causal,
        each beside SDPA's forward and backward; in fp32 also the scalar
        forward, dq and dk/dv on the same inputs, each kernel's plain
        version, both bounds (CUDA-core fp32 at 67 TFLOP/s; three TF32
        products at 495), the forward against SDPA fp32's forward and the
        pair against its backward, each as a ratio.

11. fused dispatch: K train steps as one CUDA graph
    (``parallel/pipeline.fuse_train_steps``) and the FedAvg client axis
    over ranks, each sub-phase timed:
    (a) in a process of its own: full-width LLaMA (bf16, flash, batch 3,
        Adam 8e-4 ``capturable=True``), ``fuse_train_steps(step, 16)``
        against 16 eager steps from the same weights and tokens (losses
        within 1e-2 of max |eager|, parameters within 16 x lr; bitwise or
        not printed); the graph's node census (``CUDAGraph.debug_dump``)
        holds exactly 96 nodes of each of ``flash_fwd_wgmma``,
        ``flash_dq_wgmma`` and ``flash_dkv_wgmma``, the ``CAPTURED``
        counters agree, the eager counters count only the warm-up steps and
        do not move during replays;
    (b) the same process: host wall per step, unfused and fused (median of
        windows of 16, in turns), device busy and idle from torch.profiler
        over one more window of each, ``max_memory_allocated``; then ResNet
        ``lab.dp_pp --workload resnet`` with ``--input hbm-scan`` (K = 16,
        the input field ``hbm-resident-shuffle-scan16``) and ``--input
        hbm``: samples/s, median step, MFU, peak memory;
    (c) ResNet fp32 (TF32 off, cuDNN deterministic): window 0 of epoch 0
        selects the 16 batches of 16 ``feed()`` calls, bitwise; one fused
        window of 16 steps at 64 rows against 16 eager steps (losses 1e-4,
        each leaf's update within 2e-2 of its largest, phase 8 (a)'s band);
    (d) ResNet grad accumulation (1024 = 4 x 256, bf16) fused K = 4 against
        4 eager steps (each leaf within 2e-2 of its max), and both median
        steps;
    (e) the FedAvg round's client axis over 2 gloo ranks on the card (fp32,
        TF32 off; ``MnistCnn``, 4 non-IID clients, B=100, E=1) against the
        one-process form of the same arithmetic (each rank's block trained
        apart, the sums added), within 1e-6, and against the one-process
        round over the 4 clients, within 1e-5 (its convolutions run at
        twice the batch, and cuDNN picks algorithms by shape);
    (f) ``lab.microbatches --scan-steps 4`` and ``lab.dp_pp --workload
        resnet --pp --ranks 4 --input hbm-scan`` raise ``ValueError``: their
        ranks share the card through host buffers, which a graph cannot
        hold.

12. sequence and tensor parallelism on the card (``parallel/sp.py``,
    ``parallel/tp.py``): one world of 4 ranks on ``cuda:0`` over gloo,
    spawned after phase 2 built the kernels, taking each layout in turn
    (``Mesh.regrid``); full width, 3 rows per replica, flash kernels:
    (a) fp32: one Adam step of the flash ring on 1 x 4 (seq = 4, three
        hops), Ulysses on 2 x 2 (data x seq) and TP with the vocab-sharded
        embedding and loss on 2 x 2 (data x model), each against the
        single-process step on the same batch from the same weights (loss
        rtol 1e-5; gradients atol 2e-4 + rtol 2e-3, as phase 7 (a); a TP
        replica's slices joined first);
    (b) bf16, the flash ring, Ulysses and TP on 2 x 2, 10 Adam steps at 8e-4
        on TinyStories batches each: losses finite and falling, the first
        within 1 of ln(4096), every rank on CUDA, each kernel launched per
        rank per step 6 times (Ulysses, TP) or 6 (1 + s) (the ring's index s,
        which skips the blocks it cannot see), all on the tensor cores (the
        counts set to 0 just before each run and read just after); the bytes
        staged through the host per rank per step equal to the count from
        the shapes (``sp_tp_staged_bytes``); the median step (slowest rank)
        and each rank's exchange seconds;
    (c) the kernels at this slice's shapes, ``[18, 128, 48]`` causal and
        non-causal (the ring's own and received blocks) and ``[9, 256, 48]``
        causal (Ulysses and TP over 3 heads), bf16: each kernel against its
        plain version on the same inputs, on the tensor cores, and the
        autograd Functions (``flash_attention_with_lse`` with a nonzero lse
        cotangent, and ``flash_attention``) on the card against the CPU's
        plain path, in the bf16 band below; then, in phase 10 (f)'s process,
        each kernel's device time beside its bound and SDPA's forward and
        backward.

13. switch-MoE LLaMA and expert parallelism on the card (``parallel/ep.py``;
    ``MOE``: ``LlamaConfig()`` with 4 experts, capacity factor 1.25, aux
    weight 0.01, the flash kernels), each sub-phase timed:
    (a) one process, bf16, 3 rows x 256, Adam 8e-4, ``MOE_STEPS`` steps each
        of top-1, top-2 and the dense ``LlamaConfig(use_flash=True)``, each
        ``MOE_LAYERS`` deep (cut from 6): losses finite and falling, the
        first within 1 of ln(4096) + w aux; each kernel launched exactly
        once per layer and step, all on ``wgmma``; kept/assigned
        slots per layer; the median step, device busy and idle share over 5
        profiled steps and the busy shares of attention, the dispatch/combine
        products and the expert GEMMs (``moe_profile``); then one fp32 step
        (TF32 off) of top-1 and of top-2 on the card against the CPU port
        from the same weights: loss rtol 1e-5, gradients atol 2e-4 + rtol
        2e-3, the tokens whose ordered expert choices differ counted and
        printed, each allowed only at a near-tie (neighbouring probs within
        ``FLIP_GAP``);
    (b) four ranks on ``cuda:0`` over gloo, the MoE LLaMA ``MOE_LAYERS``
        deep, one layout after another
        (``Mesh.regrid``): the EP x DP 2 x 2 layer (top-2, 3072 tokens,
        fp32, at capacity 0.5, where every bucket fills, and at 1.0, where
        some overflow and some do not) against ``moe_ffn`` on each shard's
        tokens in one process (outputs within 1e-5, kept counts equal); MoE LLaMA on 2 x 2 TP, 2 x 2 SP ring and 2 x 2 SP Ulysses,
        one fp32 Adam step each against the single-process oracle (each data
        row's loss, the SP shards' MoE dispatched per shard, ``moe_oracle``)
        in phase 12 (a)'s bands; then 10 bf16 steps of each: losses falling,
        launches exact, the median step (slowest rank), exchange seconds and
        the bytes staged per rank per step against ``moe_staged_bytes``;
    (c) MoE LLaMA through the pipeline on 2 x 3 (six ranks, M = 3, one row
        per microbatch): one fp32 step of each of the five schedules
        (``interleaved*`` with 2 chunks) against the serial oracle, the mean
        over the ``M D`` microbatches of ``causal_lm_loss + w aux`` (loss
        rtol 1e-5, gradients atol 2e-4 + rtol 2e-3), then 5 bf16 gpipe
        steps, losses falling and the median step.

14. the pipeline compositions on the card (``make_pipeline_train_step`` with
    ``ep_axis=``, ``tp_axis=``, ``seq_axis=``; ``pipe_phase``), full width,
    the flash kernels, ranks on ``cuda:0`` over gloo, one world of 8 (run
    in phase 10's chain): its first 6 ranks a grid of their own for (a)
    (``Mesh.sub``), all 8 regridded into (b)-(d):
    (a) EP x DP x PP on the reference's 2 x 3, MoE (2 experts per rank and
        stage), M 3, 3 rows per replica, all five schedules (the interleaved
        ones with 2 chunks of one layer);
    (b) DP x PP x TP, 2 x 2 x 2, M 2, 2 rows per replica, dense and MoE (2
        experts per model index), ``gpipe``, ``1f1b`` and
        ``interleaved-1f1b`` with 3 chunks;
    (c) DP x PP x SP, 2 x 2 x 2, 128 positions per shard: the flash ring and
        Ulysses (3 heads per shard) under ``gpipe`` and ``1f1b``, MoE under
        the ring's ``gpipe``;
    (d) PP x SP x TP, 2 x 2 x 2, the flash ring under ``gpipe`` and ``1f1b``;
        Ulysses raises there (3 local heads over seq 2), before any rank.
    Each run: one fp32 step (TF32 off) against one process on the card from
    the same weights (``pipe_oracle``: ``llama_forward``; MoE the mean over
    the microbatch groups of ``causal_lm_loss + w aux``, dispatched per seq
    shard under SP), loss and gradients within ``GRAD_BAND`` (1e-5), routing
    flips counted; then ``PIPE_STEPS`` bf16 Adam steps at 8e-4 on
    TinyStories: losses falling, flash launches per rank per step exact
    (``pipe_launches``) and all ``wgmma``, the staged bytes per rank per step
    equal to ``pipe_staged_bytes``, the median step (slowest rank) and the
    all-reduce seconds.  (e): the kernels at the new per-rank shapes
    (``PIPE_KERNEL_CASES``) against their plain versions and the autograd
    Functions against the CPU, then, in phase 10 (f)'s process, their device
    times beside their bounds and SDPA's.

15. ZeRO stages 1, 2 and 3 and the partition-rule engine on the card
    (``parallel/zero.py``, ``parallel/rules.py``; ``zero_phase``): one world
    of 4 ranks on ``cuda:0`` over gloo (run in phase 10's chain), regridded
    to 2 x 2 (two DP lines of 2) for the n = 2 runs:
    (a) ZeRO-3 over the driver entry's workload, the ResNet-18 GroupNorm
        with SGD momentum 0.9: one fp32 step (lr 0.1, TF32 off, 8 rows per
        rank) against one process on the card (each rank's rows forward and
        backward apart, the gradients' sum over them / 4, one step), loss
        and parameters within ``GRAD_BAND``; then 10 bf16 steps at lr 0.002,
        256 rows per rank: losses falling, the bytes staged per rank per
        step equal to ``zero_staged_bytes`` (JAX's wire count printed
        beside), the persistent bytes per rank (the allocator's requested
        bytes after a step less after the run is freed: rows, gradients,
        momentum) equal to the state's exactly and 1/4 of a DP rank's (+ the
        padding), measured the same way over 3 DP steps; both median steps;
    (b) ZeRO-1 and ZeRO-2, sync and overlap: one fp32 step each against
        (a)'s one process, within ``GRAD_BAND``;
    (c) LLaMA ZeRO-3 (``LlamaConfig(use_flash=True)``), ``prefetch`` True and
        False, at n = 4 and n = 2: one fp32 Adam step against one process
        (loss, and the row gradients unsharded) within ``GRAD_BAND``; then
        ``PIPE_STEPS`` bf16 Adam steps at 8e-4 on TinyStories: losses
        falling, flash launches per rank per step exact (6/6/6, the forward 12 under
        remat) and all ``wgmma``, staged bytes exact, persistent bytes
        (rows, gradients, Adam m and v) equal to the state's, the median
        step (slowest rank), gather + reduce-scatter and all-reduce seconds;
        a DP rank's persistent bytes and step over 3 bf16 steps;
    (d) switch-MoE LLaMA (``MOE``) under ZeRO-3 with 2 microbatches of one
        row: the fp32 step against one process dispatching the same row
        groups (loss, gradients within ``GRAD_BAND``, routing flips 0),
        ``PIPE_STEPS`` bf16 steps falling, launches exact;
    (e) ``RulePartitioner`` with the ``dp`` and ``zero3`` tables on the tiny
        MLP: ``PIPE_STEPS`` Adam steps bitwise equal to the bespoke builders'
        on every rank, the loss falling.

16. the observability slice on the card (``obs/``, the builders'
    ``sentinel=`` and ``instrument=``; ``obs_phase``), full-width
    ``LlamaConfig(use_flash=True)``, bf16, batch 3, Adam 8e-4, the loss times a
    factor the batch carries on the card (1.0, or NaN on the poisoned step):
    (a) in a process of its own: ``OBS_STEPS`` eager steps of the one-process
        step with ``sentinel=True``, policy ``skip`` (plain Adam, whose step
        counter lives on the host), step ``OBS_POISON`` poisoned: one
        violation record naming it, 11 step records with finite loss, grad
        norm and update ratio; parameters and Adam state bitwise unchanged
        across it; the 11 clean losses and the final parameters bitwise an
        unguarded run's that leaves the poisoned batch out; 6/6/6 flash
        launches a step on ``wgmma``; the guard's own kernels per step
        (torch.profiler, guarded less unguarded); the run logged into a run
        directory (spans, metrics, counters, flight, timeline);
    (b) the same inside ``fuse_train_steps`` (k = ``FUSE_K``, capturable
        Adam), window step ``OBS_WINDOW_POISON`` poisoned: 16 records in step
        order with one violation; the clean losses, parameters and Adam state
        bitwise 15 eager unguarded steps'; the graph's flash nodes 96 each on
        ``wgmma``; its node count beside an unguarded graph's;
    (c) the median step per window of 16, eager and fused, guarded and
        unguarded, in turns (written down, not gated);
    (d) ``halt`` in a child process: ``SentinelViolation`` at most one step
        after the poisoned one, a ``flight.json`` naming the step and the
        metric, a non-zero exit;
    (e) the 2 x 3 DP x PP LLaMA on ``cuda:0`` over gloo, ``gpipe``,
        ``PIPE_STEPS`` steps, ``instrument=True``, ``sentinel=True``,
        ``skip``, one rank's loss NaN on one step: one violation, recorded on
        rank 0 only; every rank's parameters and Adam state bitwise unchanged
        by it; the statics ``pipeline.num_stages`` 3, ``num_microbatches`` 3
        and the GPipe bubble; a ``pipeline.tick`` series on every rank;
        6/6/6 launches per rank per step on ``wgmma``;
    (f) ``lab.dp_pp --workload llama --trace-dir``: the reporting rank's
        ``trace.json`` holds the ``dp_pp.step`` spans and the three flash
        kernels;
    (g) (a)'s run directory holds ``trace.json``, ``metrics.jsonl``,
        ``counters.json``, ``flight.json`` and ``timeline.jsonl``, and
        ``tools/trace_export.py <dir> --check`` exits 0.

17. fault tolerance on the card (``ft/``, ``utils/checkpoint.py`` on
    ``torch.distributed.checkpoint``, ``lab.dp_pp --ckpt-dir``; ``ft_phase``):
    (a) the main path checkpointed: ``lab.dp_pp --workload llama`` (2 x 3,
        ``gpipe``, M 3, full width, bf16, flash; six ranks on ``cuda:0`` over
        gloo) run A, ``FT_ITERS`` steps with ``--ckpt-every 2``, and run B,
        ``FT_HALF`` steps twice into one directory, the second resuming
        from step ``FT_HALF - 1``: the losses and B's step-5 checkpoint,
        stage by stage, parameters and Adam state (``exp_avg``,
        ``exp_avg_sq``, ``step``), bitwise A's; every rank 6/6/6 ``wgmma``
        launches a step (the counts set to 0 in each rank before its run);
    (b) beside B, run C (A's flags) in a process group of its own, SIGKILLed
        once ``latest_durable_step`` reads ``FT_KILL_AFTER``: every committed
        step has its metadata and no staging directory counts; the relaunch
        for the ``FT_ITERS - (d + 1)`` steps left from durable step ``d``
        ends bitwise on A's last checkpoint;
    (c) in a process of its own: phase 16 (a)'s guarded step (policy
        ``skip``, plain Adam) with ``AutoSaver(save_every=1,
        async_save=False)``, step ``FT_GATE_POISON``'s loss NaN: one
        ``save_skipped`` record (``sentinel_violation``), the manifest's
        ``save_skipped`` 1, that step never on disk, and ``restore_or_init``
        of the last durable step bitwise the live parameters and Adam state;
    (d) 4 ranks on ``cuda:0``: ``make_zero3_llama_train_step`` at full width,
        ``FT_ZERO_LAYERS`` deep (cut from 6), in fp32 (the fp32 flash
        kernels, Adam 8e-4, eps 1e-6), 2 steps at
        n = 4, a live reshape to n = 2 (``Mesh.regrid``,
        ``elastic.reshape_state`` onto ``zero_resume_template(abstract=True)``),
        2 steps; and 2 -> 4 likewise: both within atol 2e-5 + rtol 2e-5 (the
        JAX test's) of 4 uninterrupted steps at n = 2; a ``reshape`` flight
        record ``{"data": 4} -> {"data": 2}``, steps lost 0; the
        ``AutoSaver`` checkpoint of n = 4 (``leaf_shapes`` ``[4, k]`` /
        ``[L, 4, k]``) restored by ``restore_or_init`` on n = 2 bitwise the
        live reshape's state; one launch per layer and step of each kernel,
        all on ``tf32x3``;
    (e) written down, not gated: the lab's median step with ``--ckpt-every
        2`` and without (one more unchecked run), each async save's blocking
        wall, a warm single-process restore of the 2 x 3 checkpoint, the
        reshape walls, a synchronous save and the cross-mesh restore.

18. decode and the serving engine on the card (``models/decode.py``,
    ``serve/``, ``bench --serve``; ``serve_phase``), each sub-phase timed;
    no flash kernel is on this path (0 launches, eagerly or into a graph,
    checked over the whole phase):
    (a) fp32 (TF32 off), the tiny model and ``LlamaConfig(dtype="float32")``
        (full width), each the seeded ``Llama``: the seeded smoke trace
        through the smoke-knob engine on the virtual clock, on the card with
        every program a CUDA graph, on the card eagerly and on the CPU, the
        host/device page mirror asserted after every step
        (``check_serve_mirror``): the three token streams identical, the
        token timeline the CPU's, the final pool bitwise graphed == eager
        (the trash page aside), no leak; then a request admitted mid-flight
        beside one crossing two page boundaries, each token for token the
        dense ``generate`` on the card; the smallest top-2 logit gap of the
        CPU streams is printed;
    (b) ``bench.main(["--serve", "--serve-model", "ref", ...])`` in this
        process (``LlamaConfig()``, bf16, the serving knobs, sentinels on with
        policy ``log``): the ramp at 8 rps, seed 0, cut to ``SERVE_RAMP_S``
        seconds of arrivals, and the shared profile cut to ``SERVE_SHARED_S``
        at ``DDL25_SERVE_PAGE_LEN=4`` (its 6 + 2-token prompts are shorter
        than a 16-token page, so no page can match at the serving page
        length, in JAX as here): every arrival admitted or rejected with one
        of the five reasons, every admitted request completed, no page left
        at drain, no pool backstop, no sentinel violation, continuous ahead
        of static at the fixed budget; on ``shared`` a prefix hit rate above
        0 and equal tokens cached and cold; tokens/s, TTFT p50/p95 and the
        per-token latency are printed; ``telemetry.mem`` on, with 0 leaked
        pages, 0 growth violations and the ramp's live peak inside the band
        of ``mem_budget_bytes(per_chip=False)``; ``telemetry.goodput``'s SLO
        attainment and goodput tokens/s per card printed; ``mem_report --run
        --check`` and ``goodput_report --check`` exit 0;
    (c) the full-width bf16 decode tick at the serving knobs with 4 slots
        decoding, graphed and eager, ``SERVE_TICKS`` ticks each in two turns:
        the median tick, and over ``SERVE_PROFILED`` more under
        torch.profiler the device busy time and idle share, the kernels and
        the host's launch and copy calls a tick; both engines decode the
        same tokens;
19. speculative decoding and elastic serving on the card (no flash kernel on
    either path: 0 launches over the phase, eager or captured), each
    sub-phase timed:
    (a) fp32 (TF32 off), ``tiny-deep`` and the full-width config with
        ``spec_k`` = ``SPEC_K`` on the smoke trace and the virtual clock,
        graphed and eager on the card and on the CPU: the spec streams equal
        each other, a non-spec engine's and dense ``generate`` on the card;
        the accept counts and token timeline equal the CPU's; some full
        accept took the (k+1)-step draft (tiny-deep, and at full width with
        a full-depth drafter: the seeded full-width weights give the 1-layer
        drafter next to no agreement); both pools bitwise graphed == eager,
        the drafter's empty and neither leaking at drain, the mirror
        asserted every step;
    (b) ``DDL25_SERVE_SPEC=1 bench.main(["--serve", "--serve-model", "ref",
        ...])`` (bf16, sentinels on, the ramp cut as in 18 (b)): the spec
        ramp drains clean and the spec A/B's streams are equal (its
        acceptance and advantage printed); the same bench on ``tiny-deep``
        (the smoke knobs) with drafts accepted and ``serve_report
        --check-spec-ab`` passing on its row; then the graphed spec round
        against the graphed decode tick at 4 slots, full width: median
        wall, device busy and tokens a slot per step;
    (c) ``elastic_serve_run`` at full width (bf16) on the ramp trace under
        each of ``ELASTIC_CHAOS`` (memscope on): zero dropped requests, every
        completed stream the non-elastic engine's, each retired replica's
        allocator step-down above 0 bytes (printed beside its pool's bytes)
        and ``check_reshape`` clean; then ``DDL25_CHAOS=device_loss@20
        bench --serve`` and ``serve_report --check-reshape`` on its row;
20. TP-sharded serving and the ZeRO-3 weight-streaming decode on the card
    (``ServeEngine(tp=2)``, ``weight_stream=True``, ``bench --serve
    --serve-tp``; ``tp_phase``): worlds of ``TP_N`` ranks on ``cuda:0`` over
    gloo, the TP engines eager (ranks that share a card are not graphed); no
    flash kernel on the path (0 launches over the phase, on every rank):
    (a) fp32 (TF32 off), the tiny model and the full width, resident and
        streamed, and tiny-deep with ``spec_k`` = ``SPEC_K``: the seeded smoke
        trace on the virtual clock through the TP engines on the card,
        against single-card engines graphed and eager on the card and on the
        CPU: every stream and token timeline
        equal, the accept counts too, each rank's pool within
        ``TP_POOL_BAND`` of its heads of the single-card pool, no leak; the
        tick's logits after a prefill streamed == resident bitwise, and the
        largest |TP - single-card| logit printed;
    (b) ``bench.main(["--serve", "--serve-model", "ref", "--serve-tp", "2",
        ...])`` (bf16, the ramp cut to ``TP_BENCH_S``), resident and, cut
        to ``TP_STREAMED_S``, with ``DDL25_SERVE_WEIGHT_STREAM=1``: every
        request completed, no page
        left, the per-rank bill below the single card's, and ``serve_report
        --check-tp`` on its row; where bf16 streams differ (two rounded
        partial sums are not one product), the first request and position
        that differ and the dense top-2 gap there are printed, and the gate
        must pass on an fp32 tiny-deep row instead; rank 0's ``mem`` record
        keyed by the mesh ``{"replicas": 1, "tp": 2}``, inside its band (its
        own ``mem_budget_bytes(per_chip=True)`` plus the dense copy the A/B
        keeps) and through ``mem_report --run --check``; the run's report
        renders the TP lines of its ``serve.json``;
    (c) the full-width bf16 tick at the serving knobs, 4 slots decoding,
        resident TP, streamed TP and (rank 0) the single-card eager tick:
        median wall over ``TP_TICKS`` ticks, device busy over
        ``TP_PROFILED`` under torch.profiler, all-reduce and all-gather
        seconds and the bytes staged through the host a tick (held exactly
        to the arithmetic), persistent bytes against ``mem_budget_bytes()``,
        the peak over the timed ticks (streamed held to the resident peak
        plus the layers in flight), and where the TP stream leaves the
        single-card one.
21. the rest of observability on the card (``bench_obs_phase``; no flash
    kernel on the path: 0 launches over the phase):
    ``bench.main(["--device", "cuda", "--obs-dir", D, "--perf-reps", "8",
    "--rounds", "2", "--perf-ledger", L, "--attempts", "1"])`` at full width
    (ResNet-18, batch 1024, bf16, 16 steps a CUDA graph), through the retry
    driver (one child): the line's four secondaries in the JAX bench's order
    (``hbm-resident-shuffle`` one step per dispatch, ``native-stream-uint8``
    really streaming through pinned buffers, ``fixed-device-batch``, FedAvg)
    and ``h2d_mib_per_s`` > 0; the perf record of the per-batch
    step names the card with its data-sheet peak, its FLOPs within 10 % of
    3.41e12, ``measured_mfu`` = flops / (p50 x 989.4e12), printed beside the
    headline's MFU, exposed comms >= 0; the memory cell from the allocator,
    inside the first sample's band, 0 growth violations; the flight dump
    names the largest live tensors on the card; the goodput doc adds up
    (fraction useful printed); ``summarize_run``/``format_report`` render
    the run; ``tools/perf_report.py --check``, ``tools/mem_report.py --run
    --check`` and ``--ledger --check``, ``tools/goodput_report.py --check``
    and ``--run`` exit 0 unedited.
22. the bench's retry driver and resilient run on the card
    (``resilient_phase``; full width, ResNet-18 bf16, the train split cut to
    8,192 rows by ``DDL25_BENCH_NTRAIN``): (a) ``DDL25_CHAOS=sigterm@3
    python -m ddl25spring_tpu_torch.bench --scan-steps 1 --steps 6
    --no-fedavg --perf-reps 0 --per-chip-batch 256`` through the
    retry parent, which must make no CUDA context: attempt 1 dies with 143
    (``preempted``), attempt 2 resumes from the durable step; one lineage id
    on the line, every retry record, ``flight.json`` and the timeline
    header; ``sum_check.ok``; ``replayed_steps_count == steps_replayed ==``
    the lost steps; ``tools/goodput_report.py --check`` exits 0; (b)
    ``DDL25_CHAOS=device_loss@2 ... --elastic --steps 6 --per-chip-batch
    256`` (as the retry driver's child, ``DDL25_BENCH_CHILD=1``): 2 ranks
    on cuda:0 reshape 2 -> 1 with 0 steps lost; (c) the bench with
    ``CUDA_VISIBLE_DEVICES=`` and ``--attempts 1``: the ``accelerator
    unreachable`` line, ``health.reason`` ``device_unreachable``, no step
    trained.  (a)-(c) run beside the kernels' build, phase 3, the model
    check and phase 7 ((a) once ``stream_inputs`` has made its secondary's
    files; none times anything of the card, and none overlaps the primer's
    timed steps; the lines print after phase 21), so their walls include
    that load.
23. the tokenizers, the ``describe()`` registry and the lint gate on the
    card (``tokenizer_run``, ``golden_quick``, ``registry_run``,
    ``lint_gate``): (a) the SentencePiece model ``data/tinystories.model``
    (vocab 512) and a BPE trained in the process (512 merges asked on the
    synthetic TinyStories text) each feed ``TinyStories`` into the
    full-width LLaMA sized by the tokenizer (dmodel 288, 6 heads, 6 layers,
    ctx 256, bf16, flash kernels) for 3 Adam steps: losses finite, the first
    within 1 of ln(vocab), each kernel launched 6 times a step, all on
    ``wgmma``; the native BPE encoder (``native/libddl25_bpe.so``) ran and
    equals the Python loop on the corpus; ``golden_tables --quick`` on the
    card, in phase 9 (e)'s process after its runs, prints its header; (b) one spawned world
    of 4 ranks on ``cuda:0`` over gloo runs the 16 training strategies'
    ``describe()`` one step each (the ``(1, 2)`` ones on 2 ranks of it):
    every collective signature holds on every rank, and each step's
    ``max_memory_allocated`` above what the rank held before it is under its
    budget; (c) ``python -m ddl25spring_tpu_torch.analysis --check
    --host-safety`` exits 0.  (a) runs in a process of its own beside the
    build, phase 3, the model check and phase 7 (its steps wait for the
    kernels), (c) beside the build, (b) from the end of the build; none
    times anything of the card, and their lines print after phase 22's.

Tolerances (|kernel - plain| <= atol + rtol * |plain|):
  fp32: atol 1e-4, rtol 0 (summation order only);
  bf16: atol 2e-2, rtol 1e-2 against the plain version on the same bf16
        inputs (it computes in fp32 and rounds p and ds to bf16 where the
        kernels do; the kernel rounds each output once to bf16).

In the kernels line, ``ms`` and ``device_ms`` are the device time per call,
``library_ms`` and ``library_device_ms`` SDPA forward's; ``wall_ms`` and
``library_wall_ms`` the host-paced CUDA-event times; ``scalar_device_ms`` the
scalar kernel's device time on the same inputs; ``launches_per_fused_window``
the kernel's nodes in phase 11 (a)'s graph of 16 steps;
``launches_sp_tp_per_rank`` each rank's launches over phase 12 (b)'s run of
each layout; ``launches_moe_per_step`` the kernel's launches per step of
phase 13 (a)'s top-1 and top-2 MoE steps; ``max_abs_err_sp_tp`` the largest
error of phase 12 (c)'s checks; ``launches_pipeline_compositions_per_rank``
each rank's launches per step in each run of phase 14,
``max_abs_err_pipeline_compositions`` the largest error of phase 14 (e), and
``launches_zero_per_rank`` each rank's launches per step in phase 15 (c)'s
LLaMA runs and (d)'s MoE run; ``launches_obs_guarded_per_step`` phase 16
(a)'s launches per guarded step, ``launches_obs_guarded_per_fused_window``
the kernel's nodes in (b)'s guarded graph of 16 steps, and
``launches_obs_dp_pp_per_rank_per_step`` each rank's launches per step in
(e); ``launches_ft_lab_per_rank_per_step`` each rank's launches per step in
phase 17 (a)'s run A, ``launches_ft_zero3_per_rank_per_step`` each rank's
per step in each run of phase 17 (d), ``launches_serve_per_tick`` the
kernel's launches (eager and captured) over phase 18 per decode tick run (0),
and ``launches_tp_serve`` its launches over phase 20 on every rank (0);
``launches_tokenizer_per_step`` its launches in phase 23 (a)'s last step, by
tokenizer (6 each: one a layer).
The rows ``flash_fwd_tf32x3``, ``flash_dq_tf32x3`` and ``flash_dkv_tf32x3``
are the fp32 path's: ``launches`` its launches over phase 7 (a)'s six ranks,
``max_abs_err`` phase 3's at ``[18, 256, 48]`` fp32 causal, the times phase 10
(f)'s at that shape (``library_ms`` SDPA fp32's forward for the forward, null
for dq and dk/dv: no one call computes either alone; ``sdpa_bwd_ms`` SDPA
fp32's backward), ``bound_ms`` on the tensor cores.

The second-to-last line is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.

Run from the repository root: ``python3 chip_smoke.py``
"""

import concurrent.futures
import itertools
import json
import math
from collections import defaultdict
import re
import statistics
import subprocess
import sys
import time

import torch

MAIN_SHAPE = (3, 256, 6, 48)     # [B, L, H, hd] of the primer's attention
STEPS = 24
DP, PP, MICRO, ROWS = 2, 3, 3, 3  # phase 7: pipelines, stages, microbatches, rows per replica
SPAWN_TIMEOUT = 300
RESNET_ITERS = 30               # phase 8 (b): timed steps at batch 1024
# phase 8 trains at lr 0.002, not the lab's default 0.1 (the reference's): at
# 0.1 with momentum 0.9 the loss jumps from ~2.6 to 13-15 at the second step
# and stays there, in the JAX package's step as in the port's (batch 16 and
# 64 on the CPU); at 0.002 both fall.  The step's time does not depend on it.
RESNET_LR = "0.002"
RESNET_FLOPS = 3.41e12          # one batch-1024 train step: ~3.33 GFLOP per image
HET_ROWS = 16                   # phase 8 (d) fp32 check: 2 replicas x 2 microbatches x 4
TOL = {torch.float32: (1e-4, 0.0), torch.bfloat16: (2e-2, 1e-2)}
FL_ROUNDS = 10                  # phase 9 (b): timed rounds, after one warm-up round
# phase 9 (a): |card - CPU| per leaf, of its max |CPU|.  The first chip run
# held 1e-3 with a worst leaf of 2.11e-4 (FedSGD, Conv_1.bias; FedAvg
# 1.36e-4, Conv_0.bias), deterministic cuDNN on both sides; tightened to 5e-4
FL_LEAF_BAND = 5e-4
# phase 9 (e): accuracy bands around the port's own CPU runs of
# ``examples.vfl_and_generative_fl --device cpu`` at seeds 42, 0, 1 and 7 (VFL
# 0.956-1.0, TSTR real 0.878-0.912, synthetic 0.780-0.854; PERF.md): the
# card draws its dropout masks and VAE noise from CUDA generators, another
# stream than the CPU's, so its run is one more draw from that spread
FL_ACC_BANDS = {"vfl_acc": (0.93, 1.0), "tstr_real": (0.85, 0.95),
                "tstr_synthetic": (0.72, 0.92)}

# H100 SXM data-sheet peaks (dense): the bound of a kernel is the larger of
# its bytes over the memory rate and its operations over the rate of its type
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
TF32_OPS = 495e12               # the tf32x3 variant: three TF32 products per product

CSRC = "ddl25spring_tpu_torch/ops/csrc/"
SOURCE = {"wgmma": CSRC + "flash_attention_sm90.cu", "scalar": CSRC + "flash_attention.cu",
          "tf32x3": CSRC + "flash_attention_tf32x3.cu"}
REPLACES = {
    "fwd": "ddl25spring_tpu/ops/flash_attention.py:76",   # _fwd_kernel
    "dq": "ddl25spring_tpu/ops/flash_attention.py:165",   # _dq_kernel
    "dkv": "ddl25spring_tpu/ops/flash_attention.py:213",  # _dkv_kernel
}


class PhaseError(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise PhaseError(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    check(out, "nvidia-smi printed no card")
    return out


def kernel_name(mangled: str) -> str:
    """``flash_fwd_kernel<bf16,64>`` / ``flash_dq_wgmma<48>`` /
    ``flash_dq_tf32x3<48>`` from a mangled name (the scalar kernels are
    templated on dtype and padded hd, the tensor-core ones on hd rounded up
    to 16)."""
    k = re.search(r"(flash_(?:fwd|dq|dkv)_kernel)I(13__nv_bfloat16|f)Li(\d+)E", mangled)
    if k:
        return f"{k.group(1)}<{'f32' if k.group(2) == 'f' else 'bf16'},{k.group(3)}>"
    k = re.search(r"(flash_(?:fwd|dq|dkv)_(?:wgmma|tf32x3))ILi(\d+)E", mangled)
    return f"{k.group(1)}<{k.group(2)}>" if k else mangled


def print_ptxas(log: str):
    """One line per kernel instantiation: registers, spills, shared memory."""
    name, seen = None, {}
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = kernel_name(m.group(1))
        elif name and ("spill" in line or "registers" in line):
            seen.setdefault(name, []).append(line.split(":", 1)[-1].strip())
    for name, parts in seen.items():
        print(f"  {name}: {'; '.join(parts)}")


def excess(a, ref, tol):
    """max(|a - ref| - rtol |ref|) - atol with ``tol = (atol, rtol)``, over
    tensors, arrays or lists: <= 0 within tolerance."""
    atol, rtol = tol
    a, ref = torch.as_tensor(a).float(), torch.as_tensor(ref).float()
    return ((a - ref).abs() - rtol * ref.abs()).max().item() - atol


def max_err(a, ref):
    return (a.float() - ref.float()).abs().max().item()


def randn(gen, *shape, dtype, dev):
    return torch.randn(*shape, generator=gen).to(device=dev, dtype=dtype)


def want_variant(name, dtype, hd):
    """The variant the dispatch rule names for kernel ``name`` on aligned
    operands (the same for the three kernels): bf16 on wgmma at hd a multiple
    of 8, fp32 on tf32x3 at hd a multiple of 4, the rest on scalar."""
    if dtype == torch.bfloat16:
        return "wgmma" if hd % 8 == 0 else "scalar"
    return "tf32x3" if hd % 4 == 0 else "scalar"


def kernel_case(fa, gen, dev, BH, Lq, Lk, hd, dtype, causal):
    """Each kernel against its plain version on the same inputs (the plain
    versions compute in fp32 and round p and ds where the kernels do); checks
    that each kernel ran the variant the dispatch rule names, and that the
    tf32x3 kernels give the same bits on a second call.  Returns the max abs
    errors ``{"fwd", "dq", "dkv"}``."""
    q = randn(gen, BH, Lq, hd, dtype=dtype, dev=dev)
    k = randn(gen, BH, Lk, hd, dtype=dtype, dev=dev)
    v = randn(gen, BH, Lk, hd, dtype=dtype, dev=dev)
    do = randn(gen, BH, Lq, hd, dtype=dtype, dev=dev)
    want = {n: want_variant(n, dtype, hd) for n in ("fwd", "dq", "dkv")}
    before = {n: dict(c) for n, c in fa.LAUNCHES_BY_VARIANT.items()}
    o, lse = fa.flash_fwd(q, k, v, causal)
    o_ref, lse_ref = fa.flash_fwd_reference(q, k, v, causal)
    delta = (do.float() * o_ref.float()).sum(-1)
    dq = fa.flash_dq(q, k, v, lse_ref, do, delta, causal)
    dk, dv = fa.flash_dkv(q, k, v, lse_ref, do, delta, causal)
    dq_ref, dk_ref, dv_ref = fa.flash_bwd_reference(q, k, v, lse_ref, do, delta, causal)
    torch.cuda.synchronize()
    tag = (f"[{BH},{Lq},{Lk},{hd}] {str(dtype)[6:]} causal={causal} "
           f"{'/'.join(dict.fromkeys(want.values()))}")
    for name in ("fwd", "dq", "dkv"):
        ran = {v_: n - before[name][v_] for v_, n in fa.LAUNCHES_BY_VARIANT[name].items()}
        check(ran[want[name]] == 1 and sum(ran.values()) == 1, f"{tag}: {name} ran {ran}")
    if want["dq"] == "tf32x3":
        again = (*fa.flash_fwd(q, k, v, causal),
                 fa.flash_dq(q, k, v, lse_ref, do, delta, causal),
                 *fa.flash_dkv(q, k, v, lse_ref, do, delta, causal))
        check(all(torch.equal(a, b) for a, b in zip(again, (o, lse, dq, dk, dv))),
              f"{tag}: a second call of the tf32x3 kernels gave other bits")
    pairs = {"o": (o, o_ref), "lse": (lse, lse_ref), "dq": (dq, dq_ref),
             "dk": (dk, dk_ref), "dv": (dv, dv_ref)}
    errs = {}
    for name, (a, ref) in pairs.items():
        check(torch.isfinite(a).all().item(), f"{tag}: {name} not finite")
        # lse is float32 in both versions, whatever the inputs
        e = excess(a, ref, TOL[torch.float32 if name == "lse" else dtype])
        check(e <= 0, f"{tag}: {name} off its plain version by {e:.3g} past tolerance")
        errs[name] = max_err(a, ref)
    print(f"  kernels {tag}: " + " ".join(f"{n}={e:.2e}" for n, e in errs.items())
          + (" (bitwise on a second call)" if want["dq"] == "tf32x3" else ""))
    return {"fwd": max(errs["o"], errs["lse"]), "dq": errs["dq"],
            "dkv": max(errs["dk"], errs["dv"])}


def misaligned_fp32_case(fa, gen, dev):
    """fp32 views 4 bytes past 16-byte alignment cannot be ``cp.async``
    sources: the dispatch sends the forward, dq and dk/dv to the scalar
    kernels, which are right (fp32 tolerance)."""
    BH, L, hd, n = 2, 66, 48, 2 * 66 * 48
    q, k, v, do = (randn(gen, n + 4, dtype=torch.float32, dev=dev)[1:n + 1].view(BH, L, hd)
                   for _ in range(4))
    o_ref, lse_ref = fa.flash_fwd_reference(q, k, v, True)
    delta = (do * o_ref).sum(-1)
    before = {n_: dict(c) for n_, c in fa.LAUNCHES_BY_VARIANT.items()}
    got = (*fa.flash_fwd(q, k, v, True), fa.flash_dq(q, k, v, lse_ref, do, delta, True),
           *fa.flash_dkv(q, k, v, lse_ref, do, delta, True))
    refs = (o_ref, lse_ref, *fa.flash_bwd_reference(q, k, v, lse_ref, do, delta, True))
    torch.cuda.synchronize()
    for name in ("fwd", "dq", "dkv"):
        ran = {v_: c - before[name][v_] for v_, c in fa.LAUNCHES_BY_VARIANT[name].items()}
        check(ran["scalar"] == 1 and sum(ran.values()) == 1,
              f"misaligned fp32: {name} ran {ran}, not the scalar variant")
    names = ("o", "lse", "dq", "dk", "dv")
    for name, a, ref in zip(names, got, refs):
        e = excess(a, ref, TOL[torch.float32])
        check(e <= 0, f"misaligned fp32: {name} off its plain version by {e:.3g}")
    print(f"  kernels [{BH},{L},{L},{hd}] float32 misaligned by 4 bytes: forward, dq, dk/dv on "
          "scalar, " + " ".join(f"{n_}={max_err(a, r):.2e}" for n_, a, r in zip(names, got, refs)))


def autograd_case(fa, gen, dev, shape, dtype, causal, with_lse):
    """The autograd Function on the card (kernels) against the same Function on
    the CPU (plain versions), outputs and input gradients."""
    B, L, H, hd = shape
    base = [torch.randn(*shape, generator=gen).to(dtype) for _ in range(3)]
    t_o = torch.randn(*shape, generator=gen).to(dtype)
    t_l = torch.randn(B, H, L, generator=gen)

    def run(device):
        q, k, v = (x.to(device).requires_grad_() for x in base)
        if with_lse:
            o, lse = fa.flash_attention_with_lse(q, k, v, causal=causal)
            loss = (o.float() * t_o.to(device).float()).sum() + (
                torch.tanh(lse) * t_l.to(device)).sum()
            outs = [o, lse]
        else:
            o = fa.flash_attention(q, k, v, causal=causal)
            loss = (o.float() * t_o.to(device).float()).sum()
            outs = [o]
        grads = torch.autograd.grad(loss, (q, k, v))
        return [x.detach().cpu() for x in (*outs, *grads)]

    got, ref = run(dev), run("cpu")
    names = ["o", "lse", "dq", "dk", "dv"] if with_lse else ["o", "dq", "dk", "dv"]
    tag = f"autograd {'with_lse ' if with_lse else ''}{list(shape)} {str(dtype)[6:]} causal={causal}"
    for name, a, r in zip(names, got, ref):
        e = excess(a, r, TOL[torch.float32 if name == "lse" else dtype])
        check(e <= 0, f"{tag}: {name} off the CPU plain path by {e:.3g} past tolerance")
    print(f"  {tag}: " + " ".join(f"{n}={max_err(a, r):.2e}" for n, a, r in zip(names, got, ref)))


def cuda_ms(fn, iters, warmup=3):
    """CUDA events around ``iters`` back-to-back Python calls of ``fn``, per
    call: the host-paced rate, which is the device time only while the device
    is slower than the host's dispatch."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def kernel_events(fn, calls):
    """The kernel rows of a torch.profiler trace of ``calls`` calls of ``fn``
    (a CPU op's entry, and a device-side user annotation such as
    Optimizer.step, repeat the device time of the kernels they enclose, so
    they are left out)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and not e.is_user_annotation]


def device_ms(fn, iters=50, warmup=3, tries=3):
    """Device time per call of ``fn``: the self device time of every kernel
    it launched over ``iters`` calls, divided by ``iters``.  Host dispatch
    gaps between the kernels are not counted.  The profiler has dropped
    kernel records on the H100 (one run recorded 1 of 50 launches), so the
    count of kernel records must be a whole multiple of ``iters``; a trace
    that fails that is taken again, up to ``tries`` times."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        events = kernel_events(fn, iters)
        n = sum(e.count for e in events)
        if n > 0 and n % iters == 0:
            return sum(e.self_device_time_total for e in events) / 1e3 / iters
        print(f"  profiler recorded {n} kernels for {iters} calls; tracing again")
    raise PhaseError(f"profiler kept dropping kernel records ({n} for {iters} calls)")


def bound(nbytes, ops, dtype, variant=None):
    """The least ms the card could take: bytes over the memory rate against
    operations over the peak of their type; the tf32x3 variant does each
    product as three TF32 products on the tensor cores."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = 3 * ops / TF32_OPS if variant == "tf32x3" else ops / PEAK_OPS[dtype]
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def time_kernels(fa, gen, dev):
    """Times at the LLaMA path's shape (bf16, causal): kernel, plain version,
    library call, bound."""
    B, L, H, hd = MAIN_SHAPE
    BH, dtype, causal = B * H, torch.bfloat16, True
    q, k, v, do = (randn(gen, BH, L, hd, dtype=dtype, dev=dev) for _ in range(4))
    o, lse = fa.flash_fwd(q, k, v, causal)
    delta = (do.float() * o.float()).sum(-1)

    el = q.element_size()
    act = BH * L * hd * el                # one [BH, L, hd] operand
    rows = BH * L * 4                     # one [BH, L] float32 vector
    pairs = BH * L * (L + 1) // 2         # causal (query, key) pairs that attend
    work = {  # (bytes: each input read once, each output written once; operations)
        "fwd": (4 * act + rows, 4 * hd * pairs),
        "dq": (5 * act + 2 * rows, 6 * hd * pairs),
        "dkv": (6 * act + 2 * rows, 8 * hd * pairs),
    }
    kern = {  # the variant the dispatch rule picks at this shape
        "fwd": lambda: fa.flash_fwd(q, k, v, causal),
        "dq": lambda: fa.flash_dq(q, k, v, lse, do, delta, causal),
        "dkv": lambda: fa.flash_dkv(q, k, v, lse, do, delta, causal),
    }
    # the first slice's scalar kernels on the same inputs in the same run,
    # launched past the dispatch rule (which sends these inputs to wgmma)
    o_s, lse_s, dq_s, dk_s, dv_s = (torch.empty_like(t) for t in (q, lse, q, k, v))
    scalar = {
        "fwd": lambda: fa._launch("fwd", "scalar", q, k, v, o_s, lse_s,
                                  q3=q, Lk=L, causal=causal),
        "dq": lambda: fa._launch("dq", "scalar", q, k, v, do, lse, delta, dq_s,
                                 q3=q, Lk=L, causal=causal),
        "dkv": lambda: fa._launch("dkv", "scalar", q, k, v, do, lse, delta, dk_s, dv_s,
                                  q3=q, Lk=L, causal=causal),
    }
    plain = {
        "fwd": lambda: fa.flash_fwd_reference(q, k, v, causal),
        "dq": lambda: fa.flash_dq_reference(q, k, v, lse, do, delta, causal),
        "dkv": lambda: fa.flash_dkv_reference(q, k, v, lse, do, delta, causal),
    }
    q4, k4, v4 = (x.view(B, H, L, hd) for x in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    # no single library call computes dq alone or dk/dv alone; SDPA's backward
    # computes all three and is printed beside the kernel pair
    qg, kg, vg = (x.detach().clone().requires_grad_() for x in (q4, k4, v4))
    o4 = sdpa(qg, kg, vg, is_causal=True)
    do4 = do.view(B, H, L, hd)
    library = {
        "sdpa fwd": lambda: sdpa(q4, k4, v4, is_causal=True),
        "sdpa bwd": lambda: torch.autograd.grad(o4, (qg, kg, vg), do4, retain_graph=True),
    }
    lib_t = {}
    for name, fn in library.items():
        lib_t[name] = (device_ms(fn), cuda_ms(fn, 200))
        print(f"  {name}: device {lib_t[name][0]:.5f} ms, wall {lib_t[name][1]:.5f} ms")

    rows_out = {}
    for name in ("fwd", "dq", "dkv"):
        b_ms, b_by = bound(*work[name], dtype)
        lib_dev, lib_wall = lib_t["sdpa fwd"] if name == "fwd" else (None, None)
        variant = fa._variant(name, (q, k, v))
        dev_ms = device_ms(kern[name])
        scalar_ms = device_ms(scalar[name])
        rows_out[name] = {
            "variant": variant,
            "ms": dev_ms, "device_ms": dev_ms, "wall_ms": cuda_ms(kern[name], 200),
            "scalar_device_ms": scalar_ms,
            "plain_ms": cuda_ms(plain[name], 20),
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": lib_dev, "library_device_ms": lib_dev,
            "library_wall_ms": lib_wall,
        }
        r = rows_out[name]
        print(f"  {name} ({variant}): device {dev_ms:.5f} ms, wall {r['wall_ms']:.5f} ms, "
              f"scalar variant device {scalar_ms:.5f} ms ({scalar_ms / dev_ms:.1f}x), "
              f"plain {r['plain_ms']:.4f} ms, "
              f"library device {lib_dev} ms, bound {b_ms:.6f} ms ({b_by}; "
              f"{work[name][0]} B, {work[name][1]} ops)")
    pair = rows_out["dq"]["device_ms"] + rows_out["dkv"]["device_ms"]
    print(f"  sdpa backward (dq+dk+dv, one autograd call): device {lib_t['sdpa bwd'][0]:.5f} ms; "
          f"kernel pair dq+dkv: device {pair:.5f} ms")
    return rows_out


def profile_steps(dev, use_flash, steps=10):
    """Device time by kernel over ``steps`` full-width bf16 train steps (after
    warm-up), beside the host wall time of the same steps; returns the busy
    and wall milliseconds per step."""
    from ddl25spring_tpu_torch.models.llama import Llama
    from ddl25spring_tpu_torch.ops.losses import causal_lm_loss
    from ddl25spring_tpu_torch.parallel.dp import make_train_step
    from ddl25spring_tpu_torch.utils.config import LlamaConfig

    cfg = LlamaConfig(dtype="bfloat16", use_flash=use_flash)
    model = Llama(cfg, device=dev, generator=torch.Generator().manual_seed(0))
    step = make_train_step(model, lambda m, t: causal_lm_loss(m(t), t),
                           torch.optim.Adam(model.parameters(), lr=8e-4))
    tokens = torch.randint(0, cfg.vocab_size, (3, cfg.ctx_size),
                           generator=torch.Generator().manual_seed(3)).to(dev)
    for _ in range(5):
        step(tokens)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        step(tokens)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / steps

    events = kernel_events(lambda: step(tokens), steps)
    rows = sorted(((e.self_device_time_total / steps, e.count // steps, e.key)
                   for e in events), reverse=True)
    busy_ms = sum(us for us, _, _ in rows) / 1e3
    check(busy_ms > 0, "profiler recorded no device time")
    flash_n = {e.key: e.count for e in events if "flash_" in e.key}
    check(len(flash_n) == (3 if use_flash else 0)
          and all(n == 6 * steps for n in flash_n.values()),
          f"the trace holds flash kernel records {flash_n}, not 6 of each per step")
    flash_ms = sum(us for us, _, key in rows if "flash_" in key) / 1e3
    tag = "flash kernels" if use_flash else "dense attention"
    print(f"  {tag}: host wall {wall_ms:.3f} ms/step (unprofiled), device busy "
          f"{busy_ms:.3f} ms/step in {sum(n for _, n, _ in rows)} kernels, idle share "
          f"{1 - busy_ms / wall_ms:.3f}, flash kernels {flash_ms:.3f} ms/step")
    for us, n, key in rows[:12]:
        print(f"    {us / 1e3:8.4f} ms/step  x{n:<4d} {key[:90]}")
    return busy_ms, wall_ms


def model_check(dev):
    """Full-width fp32 logits through the flash kernels against dense attention."""
    from ddl25spring_tpu_torch.models.llama import Llama, llama_forward
    from ddl25spring_tpu_torch.utils.config import LlamaConfig, replace

    cfg = LlamaConfig(dtype="float32", use_flash=True)
    model = Llama(cfg, device=dev, generator=torch.Generator().manual_seed(1))
    tokens = torch.randint(0, cfg.vocab_size, (3, cfg.ctx_size),
                           generator=torch.Generator().manual_seed(2)).to(dev)
    with torch.no_grad():
        flash = llama_forward(model, tokens, cfg)
        dense = llama_forward(model, tokens, replace(cfg, use_flash=False))
    err = max_err(flash, dense)
    check(tuple(flash.shape) == (3, cfg.ctx_size, cfg.vocab_size), f"logits {flash.shape}")
    check(torch.isfinite(flash).all().item(), "flash logits not finite")
    check(err <= 1e-3, f"fp32 logits: flash kernels vs dense differ by {err:.3g} > 1e-3")
    print(f"  full-width fp32 logits, flash kernels vs dense: max abs err {err:.2e}")


def _single_process(cfg, dev, seed, batches):
    """The single-device Adam step on the card over ``batches``, from
    ``Llama(seed)``'s weights: the losses and the first step's gradients."""
    from ddl25spring_tpu_torch.models.llama import Llama, export_grads
    from ddl25spring_tpu_torch.ops.losses import causal_lm_loss
    from ddl25spring_tpu_torch.parallel.dp import make_train_step

    model = Llama(cfg, device=dev, generator=torch.Generator().manual_seed(seed))
    step = make_train_step(model, lambda m, t: causal_lm_loss(m(t), t),
                           torch.optim.Adam(model.parameters(), lr=8e-4))
    losses, grads = [], []
    for b in batches:
        losses.append(float(step(torch.from_numpy(b).long().to(dev))))
        grads.append(export_grads(model))
    return losses, grads[0]


def _token_batches(cfg, rows, n, seed):
    gen = torch.Generator().manual_seed(seed)
    return [torch.randint(0, cfg.vocab_size, (rows, cfg.ctx_size), generator=gen).numpy()
            for _ in range(n)]


def dp_pp_exactness(dev):
    """Phase 7 (a): the 6-rank fp32 step against the single-process step."""
    from ddl25spring_tpu_torch.lab import dp_pp
    from ddl25spring_tpu_torch.models.llama import merge_stage_exports
    from ddl25spring_tpu_torch.parallel.bucketing import flatten
    from ddl25spring_tpu_torch.parallel.launch import spawn
    from ddl25spring_tpu_torch.utils.config import LlamaConfig

    cfg = LlamaConfig(dtype="float32", use_flash=True)
    batches = _token_batches(cfg, DP * ROWS, 3, seed=11)
    job = dp_pp.Job(cfg, DP, PP, MICRO, batch=DP * ROWS, iters=3, seed=7, device=dev.type,
                    batches=batches, export=True, log=False)
    t0 = time.perf_counter()
    ranks = spawn(dp_pp.run_rank, DP * PP, job, timeout=SPAWN_TIMEOUT)
    print(f"  (a) {DP * PP} ranks, backend {sorted({r['backend'] for r in ranks})}, devices "
          f"{sorted({r['device'] for r in ranks})}, {time.perf_counter() - t0:.1f} s")
    want_losses, want_grads = _single_process(cfg, dev, 7, batches)
    last = [r for r in ranks if r["coords"][1] == PP - 1]
    check(all(r["losses"] == last[0]["losses"] for r in last), "the replicas' losses differ")
    got = last[0]["losses"]
    e0 = excess(got[0], want_losses[0], (0.0, 1e-5))
    check(e0 <= 0, f"fp32 DPxPP first loss {got[0]} vs single process {want_losses[0]}")
    e_later = excess(got[1:], want_losses[1:], (0.0, 1e-4))
    check(e_later <= 0, f"fp32 DPxPP Adam losses {got[1:]} vs single process {want_losses[1:]}")
    merged = merge_stage_exports([r["grads"] for r in ranks if r["coords"][0] == 0])
    err = 0.0
    for (path, a), (_, b) in zip(flatten(merged), flatten(want_grads)):
        e = excess(a, b, (2e-4, 2e-3))
        check(e <= 0, f"fp32 DPxPP grad {path} off the single-process grad by {e:.3g} "
                      "past tolerance")
        err = max(err, max_err(torch.from_numpy(a), torch.from_numpy(b)))
    print(f"  (a) fp32 losses {[round(x, 6) for x in got]} vs single process "
          f"{[round(x, 6) for x in want_losses]}; grads max abs err {err:.2e}")
    # the fp32 path's kernels: each rank counts from 0 over its run
    for r in ranks:
        n, by = r["launches"]["fwd"], r["launches_by_variant"]
        check(n > 0 and r["launches"] == {"fwd": n, "dq": n, "dkv": n}
              and all(by[k]["tf32x3"] == n for k in ("fwd", "dq", "dkv")),
              f"(a) rank {r['rank']}: fp32 launches by variant {by}, not the forward, dq "
              "and dk/dv as often, all on tf32x3")
    launches = {k: sum(r["launches"][k] for r in ranks) for k in ("fwd", "dq", "dkv")}
    print(f"  (a) flash launches over the {len(ranks)} ranks {launches}: all on tf32x3")
    return launches


def dp_pp_slice(dev):
    """Phase 7 (b): ``lab.dp_pp.main``, bf16, 24 steps, and its time split."""
    from ddl25spring_tpu_torch.lab import dp_pp

    run = dp_pp.main(["--workload", "llama", "--iters", str(STEPS), "--seed", "0",
                      "--device", dev.type, "--timeout", str(SPAWN_TIMEOUT)])
    ranks, losses = run["ranks"], run["losses"]
    check(len(losses) == STEPS and all(math.isfinite(x) for x in losses),
          f"DPxPP losses not all finite: {losses}")
    vocab = lab_vocab()  # the lab sizes its embedding by the tokenizer
    check(abs(losses[0] - math.log(vocab)) < 1.0,
          f"DPxPP first loss {losses[0]:.3f} far from ln(vocab) {math.log(vocab):.3f}")
    first, last = statistics.mean(losses[:5]), statistics.mean(losses[-5:])
    check(last < first, f"DPxPP loss did not fall: first-5 mean {first:.4f}, last-5 {last:.4f}")
    for r in ranks:
        check(r["device"].startswith("cuda"), f"rank {r['rank']} ran on {r['device']}")
        want = {name: 6 * STEPS for name in ("fwd", "dq", "dkv")}
        check(r["launches"] == want, f"rank {r['rank']} launches {r['launches']} != {want}")
        for name in want:
            check(r["launches_by_variant"][name]["wgmma"] == 6 * STEPS,
                  f"rank {r['rank']} {name} by variant {r['launches_by_variant'][name]}")
    steady = run["step_s"][4:]
    step_ms = statistics.median(steady) * 1e3
    print(f"  (b) backend {sorted({r['backend'] for r in ranks})}, devices "
          f"{sorted({r['device'] for r in ranks})}; loss {first:.4f} (first 5) -> "
          f"{last:.4f} (last 5); every rank launched each kernel {6 * STEPS} times, "
          "all on wgmma")
    tokens = DP * ROWS * MAIN_SHAPE[1]
    print(f"  (b) step time median {step_ms:.3f} ms (steps 4..{STEPS - 1}, host clock, "
          f"min {min(steady) * 1e3:.3f} ms), {tokens / (step_ms / 1e3):.1f} tokens/s")
    for s in range(PP):
        mine = [r for r in ranks if r["coords"][1] == s]
        per = {k: statistics.median(c[k] for r in mine for c in r["comm"][4:])
               for k in ("recv_wait_s", "send_s", "allreduce_s", "bytes_staged")}
        print(f"  (b) stage {s}: recv wait {per['recv_wait_s'] * 1e3:.3f} ms/step, send "
              f"{per['send_s'] * 1e3:.3f} ms/step, DP all-reduce {per['allreduce_s'] * 1e3:.3f} "
              f"ms/step, staged {int(per['bytes_staged'])} B/step per rank (medians, steps "
              f"4..{STEPS - 1}, both replicas)")
    staged = sum(c["bytes_staged"] for r in ranks for c in r["comm"][4:]) / len(steady)
    print(f"  (b) bytes staged through the host, all ranks: {staged:.0f} B/step")


def nccl_dp_rank(rdv, cfg, batches, seed, device):
    """One rank of phase 7 (c): DP-only ``make_dp_train_step`` on its own card."""
    from ddl25spring_tpu_torch.models.llama import Llama
    from ddl25spring_tpu_torch.ops.losses import causal_lm_loss
    from ddl25spring_tpu_torch.parallel.dp import make_dp_train_step
    from ddl25spring_tpu_torch.utils.mesh import init_mesh

    with init_mesh(rdv, data=rdv.world, stages=1, device=device) as mesh:
        model = Llama(cfg, device=mesh.device, generator=torch.Generator().manual_seed(seed))
        step = make_dp_train_step(model, lambda m, t: causal_lm_loss(m(t), t),
                                  torch.optim.Adam(model.parameters(), lr=8e-4), mesh)
        mesh.comm.take_stats()
        losses = [float(step(torch.from_numpy(b).long())) for b in batches]
        return {"backend": mesh.backend, "device": str(mesh.device), "losses": losses,
                **mesh.comm.take_stats()}


def nccl_dp(dev):
    """Phase 7 (c): the bucketed all-reduce on NCCL, against one process."""
    from ddl25spring_tpu_torch.parallel.launch import spawn
    from ddl25spring_tpu_torch.utils.config import LlamaConfig

    n = min(torch.cuda.device_count(), 2)
    cfg = LlamaConfig(dtype="float32", use_flash=True)
    batches = _token_batches(cfg, ROWS * n, 2, seed=13)
    t0 = time.perf_counter()
    ranks = spawn(nccl_dp_rank, n, cfg, batches, 5, dev.type, timeout=SPAWN_TIMEOUT)
    spawned_s = time.perf_counter() - t0
    want, _ = _single_process(cfg, dev, 5, batches)
    for r in ranks:
        check(r["backend"] == "nccl", f"DP over {n} cards ran on {r['backend']}")
        e = excess(r["losses"], want, (0.0, 1e-4))
        check(e <= 0, f"NCCL DP losses {r['losses']} vs single process {want}")
    print(f"  (c) {n} rank(s), backend {ranks[0]['backend']}, devices "
          f"{[r['device'] for r in ranks]}; losses {ranks[0]['losses']} vs single process "
          f"{want}; all-reduce {ranks[0]['allreduce_s'] * 1e3:.3f} ms over 2 steps, "
          f"staged {ranks[0]['bytes_staged']} B; {spawned_s:.1f} s")


# fp32 checks: TF32 off for cuDNN and cuBLAS, cuDNN's deterministic
# algorithms, no autotuning (so equal shapes take equal algorithms in every
# process)
FP32_EXACT = dict(cudnn_tf32=False, matmul_tf32=False, cudnn_deterministic=True,
                  cudnn_benchmark=False)


def _cifar_rows(n):
    """The first ``n`` rows of the synthetic CIFAR-10 split, uint8 NHWC, on the
    CPU."""
    from ddl25spring_tpu_torch.data.cifar10 import load_cifar10_u8

    d = load_cifar10_u8(n_train=64)
    return torch.from_numpy(d["x"][:n]), torch.from_numpy(d["y"][:n])


def _within(tag, a, ref, rel, slack=1e-7):
    """|a - ref| <= rel * max |ref| + ``slack`` (default: a float32 ulp of
    slack for a zero leaf); returns the max abs error."""
    a, ref = torch.as_tensor(a).float(), torch.as_tensor(ref).float()
    err = (a - ref).abs().max().item()
    check(err <= rel * ref.abs().max().item() + slack,
          f"{tag}: max abs err {err:.3g} > {rel} x max |ref| {ref.abs().max().item():.3g}")
    return err


class ReluInputs(torch.overrides.TorchFunctionMode):
    """Inside the block: every ``F.relu`` input, in call order, as float64 on
    the CPU."""

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func is torch.nn.functional.relu:
            self.seen.append(args[0].detach().double().cpu())
        return func(*args, **(kwargs or {}))


def relu_flips(got, f64):
    """The relu inputs of ``got`` on the other side of zero from float64's:
    ``(count, relus with one, worst |float64 input| / that relu's max)``."""
    n, where, worst = 0, 0, 0.0
    for a, b in zip(got, f64):
        flip = (a > 0) != (b > 0)
        if flip.any():
            n, where = n + int(flip.sum()), where + 1
            worst = max(worst, (b[flip].abs().max() / b.abs().max()).item())
    return n, where, worst


def resnet_exactness(dev):
    """Phase 8 (a): one full-width fp32 SGD step on the card against the CPU,
    beside a float64 step on the CPU.  Loss and logits within 1e-4 of max
    |ref|; each gradient leaf within 2e-2 of its own max |ref|, and each
    leaf's update (new weight - old) within 2e-2 of its largest update.
    The forward agrees to ~1e-6; the backward can differ by more, because a
    relu input within fp32 rounding of zero can take the other branch on
    the other device, which moves that element's contribution to the
    gradients of every layer below it.  The relu inputs are recorded on
    every run: the flips against float64 are counted, and each must lie
    within 1e-4 of its relu's max |input| (a flip far from zero is a bug).
    """
    from ddl25spring_tpu_torch.benchmarks import _nchw
    from ddl25spring_tpu_torch.models.resnet import ResNet18, export_grads, export_params
    from ddl25spring_tpu_torch.ops.losses import cross_entropy_logits
    from ddl25spring_tpu_torch.parallel.bucketing import flatten
    from ddl25spring_tpu_torch.utils.device import backend_flags

    x_u8, y = _cifar_rows(8)

    def run(device, dtype=torch.float32):
        m = ResNet18(norm="group", dtype=dtype, generator=torch.Generator().manual_seed(11))
        m = m.to(device, dtype, memory_format=torch.channels_last if device.type == "cuda"
                 else torch.preserve_format)
        before = export_params(m)
        opt = torch.optim.SGD(m.parameters(), lr=0.1, momentum=0.9)
        with ReluInputs() as relus:
            logits = m(_nchw(x_u8.to(device), dtype))
        loss = cross_entropy_logits(logits, y.to(device))
        loss.backward()
        opt.step()
        after = flatten(export_params(m))
        update = [(p, w - w0, abs(w).max()) for (p, w), (_, w0) in zip(after, flatten(before))]
        return (loss.item(), logits.detach().cpu(), flatten(export_grads(m)), update,
                relus.seen)

    with backend_flags(**FP32_EXACT):
        got, want = run(dev), run(torch.device("cpu"))
        f64 = run(torch.device("cpu"), torch.float64)
    e_loss = _within("(a) fp32 loss", got[0], want[0], 1e-4)
    e_logits = _within("(a) fp32 logits", got[1], want[1], 1e-4)
    for (path, a), (_, b) in zip(got[2], want[2]):
        _within(f"(a) fp32 gradient {path}", a, b, 2e-2)
    for (path, a, _), (_, b, w_max) in zip(got[3], want[3]):
        # the new weights are rounded to float32: one ulp of the leaf's largest
        _within(f"(a) fp32 update {path}", a, b, 2e-2, slack=2.0**-23 * w_max)
    worst = {what: max((abs(r[1] - w[1]).max() / abs(w[1]).max(), r[0])
                       for r, w in zip(got[i], want[i]))
             for i, what in ((2, "gradient"), (3, "update"))}
    print(f"  (a) fp32 one SGD step, card vs CPU: loss {got[0]:.6f} vs {want[0]:.6f} (err "
          f"{e_loss:.2e}), logits max abs err {e_logits:.2e}; worst gradient leaf "
          f"{worst['gradient'][1]} {worst['gradient'][0]:.2e} and worst update "
          f"{worst['update'][1]} {worst['update'][0]:.2e}, each of its leaf's max |CPU|")
    for name, r in (("card", got), ("CPU", want)):
        rel = ((r[1].double() - f64[1]).abs().max() / f64[1].abs().max()).item()
        g_rel, g_path = max((abs(a - b).max() / abs(b).max(), p)
                            for (p, a), (_, b) in zip(r[2], f64[2]))
        n, where, far = relu_flips(r[4], f64[4])
        check(far <= 1e-4, f"(a) a relu input on the {name} took the other branch than "
                           f"float64 at {far:.2e} of its relu's max |input|")
        print(f"  (a) fp32 {name} vs float64 (CPU): logits {rel:.2e} of max |ref|; worst "
              f"gradient leaf {g_path} {g_rel:.2e} of its max |ref|; relu inputs on the other "
              f"branch: {n} in {where} of {len(f64[4])} relus, the farthest from zero at "
              f"{far:.2e} of its relu's max |input|")


def resnet_headline(dev):
    """Phase 8 (b): ``lab.dp_pp.main --workload resnet``, one rank, batch 1024."""
    from ddl25spring_tpu_torch.lab import dp_pp
    from ddl25spring_tpu_torch.ops import flash_attention as fa

    fa.reset_launches()
    run = dp_pp.main(["--workload", "resnet", "--input", "hbm", "--iters", str(RESNET_ITERS),
                      "--seed", "0", "--lr", RESNET_LR, "--device", dev.type])
    check(not any(fa.LAUNCHES.values()) and not any(n for c in fa.CAPTURED.values()
                                                    for n in c.values()),
          f"the ResNet path launched flash kernels: {fa.LAUNCHES}, captured {fa.CAPTURED}")
    (r,) = run["ranks"]
    losses = r["losses"]
    check(len(losses) == dp_pp.WARMUP + RESNET_ITERS and all(math.isfinite(x) for x in losses),
          f"resnet losses not all finite: {losses}")
    check(abs(losses[0] - math.log(10)) < 1.0,
          f"resnet first loss {losses[0]:.3f} far from ln(10) {math.log(10):.3f}")
    first, last = statistics.mean(losses[:5]), statistics.mean(losses[-5:])
    check(last < first, f"resnet loss did not fall: first-5 mean {first:.4f}, last-5 {last:.4f}")
    check(r["params_device"] == [str(dev)], f"parameters on {r['params_device']}")
    check(r["data_device"] == str(dev), f"DeviceDataset.x on {r['data_device']}")
    check(abs(run["flops"] / RESNET_FLOPS - 1) < 0.1,
          f"FLOPs per step {run['flops']:.4g} not within 10 % of {RESNET_FLOPS:.4g}")
    step_ms = statistics.median(r["step_s"]) * 1e3
    print(f"  (b) loss {first:.4f} (first 5) -> {last:.4f} (last 5); parameters and data on "
          f"{r['data_device']}; flash kernel launches {dict(fa.LAUNCHES)}")
    print(f"  (b) {RESNET_ITERS} timed steps in {r['dt']:.4f} s: median step {step_ms:.3f} ms "
          f"(CUDA events between steps; min {min(r['step_s']) * 1e3:.3f}, max "
          f"{max(r['step_s']) * 1e3:.3f}), {run['samples_per_s_per_chip']:.1f} samples/s per "
          f"card; {run['flops']:.6g} FLOP per step ({run['flops'] / RESNET_FLOPS:.4f} of "
          f"3.41e12), {run['tflops']:.2f} TFLOP/s, MFU {run['mfu']:.4f}")
    return run


KERNEL_KINDS = (  # (kind, substrings of the kernel name), first match wins
    ("copies (layout changes, dtype casts)", ("copy", "Copy", "nchwToNhwc", "nhwcToNchw")),
    ("convolution (cuDNN) and GEMM", ("xmma", "conv", "cudnn", "implicit", "wgrad", "dgrad",
                                      "fprop", "cutlass", "gemm", "nvjet", "sm90_")),
    ("normalisation", ("GroupNorm", "group_norm", "Moments", "ComputeFusedParams",
                       "ComputeInternalGradients", "GammaBeta", "batch_norm", "BatchNorm")),
    ("SGD (multi_tensor_apply)", ("multi_tensor_apply",)),
    ("elementwise and reductions", ("elementwise", "reduce", "Reduce", "pad", "cat")),
)


def kernel_kind(name: str) -> str:
    return next((kind for kind, keys in KERNEL_KINDS if any(k in name for k in keys)), "other")


def resnet_profile(dev, steps=10):
    """Phase 8 (c): device time by kernel over ``steps`` warm bf16 steps."""
    from ddl25spring_tpu_torch.benchmarks import DeviceDataset, build_resnet_step
    from ddl25spring_tpu_torch.lab.dp_pp import RUN_FLAGS
    from ddl25spring_tpu_torch.utils.device import backend_flags

    with backend_flags(**RUN_FLAGS):
        step, _, _, _ = build_resnet_step(None, 1, 1024, device=dev)
        ds = DeviceDataset(1024, device=dev)
        for _ in range(5):
            step(ds.feed())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            step(ds.feed())
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
        events = kernel_events(lambda: step(ds.feed()), steps)
    rows = sorted(((e.self_device_time_total / steps, e.count / steps, e.key) for e in events),
                  reverse=True)
    busy_ms = sum(us for us, _, _ in rows) / 1e3
    check(busy_ms > 0, "profiler recorded no device time")
    print(f"  (c) host wall {wall_ms:.3f} ms/step (unprofiled), device busy {busy_ms:.3f} "
          f"ms/step in {sum(n for _, n, _ in rows):.0f} kernels, idle share "
          f"{1 - busy_ms / wall_ms:.3f}")
    kinds: dict = {}
    for us, _, key in rows:
        kinds[kernel_kind(key)] = kinds.get(kernel_kind(key), 0.0) + us / 1e3
    print("  (c) shares of busy: " + ", ".join(
        f"{k} {ms:.3f} ms ({ms / busy_ms:.3f})" for k, ms in
        sorted(kinds.items(), key=lambda kv: -kv[1])))
    for us, n, key in rows[:15]:
        print(f"    {us / 1e3:8.4f} ms/step  x{n:<5.1f} [{kernel_kind(key)}] {key[:100]}")
    return busy_ms, wall_ms


def het_exact_rank(rdv, x_u8, y, seed, device):
    """One rank of phase 8 (d)'s fp32 check: one step of the 2 x 2 pipeline
    on ``device``; the loss (last stage) and the stage's gradients."""
    from ddl25spring_tpu_torch.benchmarks import build_resnet_step
    from ddl25spring_tpu_torch.models.resnet import export_grads
    from ddl25spring_tpu_torch.utils.device import backend_flags
    from ddl25spring_tpu_torch.utils.mesh import init_mesh

    with backend_flags(**FP32_EXACT), init_mesh(rdv, data=2, stages=2, device=device) as mesh:
        step, module, _, _ = build_resnet_step(mesh, 2, HET_ROWS, dtype=torch.float32, seed=seed)
        loss = step((x_u8.to(mesh.device), y.to(mesh.device)))
        return {"coords": mesh.coords, "backend": mesh.backend, "device": str(mesh.device),
                "loss": None if loss is None else loss.item(), "grads": export_grads(module)}


def het_exactness(dev):
    """Phase 8 (d), fp32: the 4-rank pipeline step against one process that
    runs the same stages on the same rows, chunk by chunk: each replica's
    rows of each microbatch through stage 0, the hop's contiguous copy,
    stage 1, its loss over ``M * D``, gradients summed.  Equal shapes take
    equal cuDNN algorithms in both, so the forward is the same arithmetic
    and the step is held to phase 7 (a)'s band: loss rtol 1e-5, gradients
    2e-4 + 2e-3 |ref| (the order of the gradient sums differs)."""
    from ddl25spring_tpu_torch.benchmarks import _nchw
    from ddl25spring_tpu_torch.models.resnet import export_grads, make_resnet_stages
    from ddl25spring_tpu_torch.ops.losses import cross_entropy_logits
    from ddl25spring_tpu_torch.parallel.bucketing import flatten
    from ddl25spring_tpu_torch.parallel.launch import spawn
    from ddl25spring_tpu_torch.utils.device import backend_flags

    x_u8, y = _cifar_rows(HET_ROWS)
    ranks = spawn(het_exact_rank, 4, x_u8, y, 21, dev.type, timeout=SPAWN_TIMEOUT)
    fmt = torch.channels_last if dev.type == "cuda" else torch.preserve_format
    D = M = 2
    mb = HET_ROWS // (M * D)
    with backend_flags(**FP32_EXACT):
        stages = [st.to(dev, memory_format=fmt) for st in make_resnet_stages(2, seed=21)]
        xs = x_u8.to(dev).reshape(M, D * mb, 32, 32, 3)
        ys = y.to(dev).reshape(M, D * mb)
        total = 0.0
        for d in range(D):
            for m in range(M):
                rows = slice(d * mb, (d + 1) * mb)
                h = stages[0](_nchw(xs[m, rows], torch.float32)).contiguous()
                loss = cross_entropy_logits(stages[1](h), ys[m, rows]) / (M * D)
                loss.backward()
                total += loss.item()
    want = [export_grads(st) for st in stages]
    err = 0.0
    for r in ranks:
        d, s = r["coords"]
        check(r["device"].startswith(dev.type), f"rank {r['coords']} ran on {r['device']}")
        if s == 1:
            e = excess(r["loss"], total, (0.0, 1e-5))
            check(e <= 0, f"fp32 het pipeline loss {r['loss']} vs one process {total}")
        for (path, a), (_, b) in zip(flatten(r["grads"]), flatten(want[s])):
            e = excess(a, b, (2e-4, 2e-3))
            check(e <= 0, f"fp32 het pipeline stage {s} grad {path} off by {e:.3g} past "
                          "tolerance")
            err = max(err, max_err(torch.from_numpy(a), torch.from_numpy(b)))
    got = [r["loss"] for r in ranks if r["coords"][1] == 1]
    print(f"  (d) fp32 2 x 2 ranks, backend {sorted({r['backend'] for r in ranks})}: losses "
          f"{got} vs one process {total:.6f}; gradients max abs err {err:.2e}")


def het_staged_bytes(r, M, D, S, batch) -> int:
    """The bytes rank ``r`` stages through the host per step, from the shapes:
    each hop it takes part in moves a ``[mb, *boundary]`` bf16 tensor through
    a host buffer M times forward and M times backward; the DP all-reduce
    moves every float32 gradient there and back, and the last stage's loss."""
    s = r["coords"][1]
    mb = batch // (M * D)
    hop = [mb * math.prod(r["boundary_shapes"][h]) * 2 for h in range(S - 1)]
    mine = ([hop[s - 1]] if s > 0 else []) + ([hop[s]] if s < S - 1 else [])
    total = sum(2 * M * b for b in mine)
    if D > 1:
        total += 2 * 4 * r["n_params"] + (2 * 4 if s == S - 1 else 0)
    return total


def het_slice(dev, iters=10, batch=64):
    """Phase 8 (d), bf16: ``lab.dp_pp.main --workload resnet --pp --ranks 4``."""
    from ddl25spring_tpu_torch.lab import dp_pp

    run = dp_pp.main(["--workload", "resnet", "--pp", "--ranks", "4", "--batch", str(batch),
                      "--iters", str(iters), "--lr", RESNET_LR, "--device", dev.type,
                      "--timeout", str(SPAWN_TIMEOUT)])
    ranks = run["ranks"]
    losses = next(r for r in ranks if r["coords"] == (0, 1))["losses"]
    check(len(losses) == dp_pp.WARMUP + iters and all(math.isfinite(x) for x in losses),
          f"het pipeline losses not all finite: {losses}")
    first, last = statistics.mean(losses[:5]), statistics.mean(losses[-5:])
    check(last < first, f"het pipeline loss did not fall: first-5 {first:.4f}, last-5 {last:.4f}")
    total = 0
    for r in ranks:
        check(r["device"].startswith("cuda") and r["params_device"] == [r["device"]],
              f"rank {r['coords']} on {r['device']}, parameters on {r['params_device']}")
        want = het_staged_bytes(r, 2, 2, 2, batch)
        check(r["comm"]["bytes_staged"] == iters * want,
              f"rank {r['coords']} staged {r['comm']['bytes_staged']} B over {iters} steps, "
              f"the shapes give {iters * want}")
        total += want
    print(f"  (d) bf16 2 x 2, batch {batch}: backend {sorted({r['backend'] for r in ranks})}, "
          f"devices {sorted({r['device'] for r in ranks})}; loss {first:.4f} (first 5) -> "
          f"{last:.4f} (last 5); boundary {ranks[0]['boundary_shapes']}")
    for s in range(2):
        mine = [r for r in ranks if r["coords"][1] == s]
        per = {k: statistics.mean(r["comm"][k] for r in mine) / iters
               for k in ("recv_wait_s", "send_s", "allreduce_s")}
        print(f"  (d) stage {s}: recv wait {per['recv_wait_s'] * 1e3:.3f} ms/step, send "
              f"{per['send_s'] * 1e3:.3f} ms/step, DP all-reduce {per['allreduce_s'] * 1e3:.3f} "
              f"ms/step (means over the timed steps, both replicas); staged "
              f"{mine[0]['comm']['bytes_staged'] // iters} B/step per rank = the shapes' count; "
              f"{mine[0]['n_params']} parameters")
    log = next(r for r in ranks if r["coords"] == (0, 1))
    print(f"  (d) step median {statistics.median(log['step_s']) * 1e3:.3f} ms (last stage of "
          f"pipeline 0), {run['samples_per_s_per_chip']:.1f} samples/s per card; staged "
          f"{total} B/step over the four ranks")


def resnet_phase(dev):
    """Phase 8, each sub-phase timed."""
    for name, fn in (("(a)", resnet_exactness), ("(b)", resnet_headline),
                     ("(c)", resnet_profile), ("(d) fp32", het_exactness),
                     ("(d) bf16", het_slice)):
        t0 = time.perf_counter()
        fn(dev)
        print(f"  {name} took {time.perf_counter() - t0:.1f} s", flush=True)


def _fl_servers(cls, data, devices, **kw):
    """One ``cls`` server per device on ``data`` at the tutorial_1a config
    (``bench.FEDAVG``: N=10, C=0.1, B=100, E=1, lr 0.01, seed 10), ``kw``
    over it."""
    from ddl25spring_tpu_torch.bench import FEDAVG

    return [cls(data=data, device=d, **{**FEDAVG, **kw}) for d in devices]


def fl_exactness(dev):
    """Phase 9 (a): one FedAvg and one FedSGD round on the card against the
    CPU, from the same weights and the same CPU generators."""
    from ddl25spring_tpu_torch.data.mnist import load_mnist
    from ddl25spring_tpu_torch.fl import FedAvgServer, FedSgdGradientServer
    from ddl25spring_tpu_torch.utils.device import backend_flags

    data = load_mnist(n_train=10_000, n_test=100)
    with backend_flags(**FP32_EXACT):
        for cls, b in ((FedAvgServer, 100), (FedSgdGradientServer, -1)):
            card, cpu = _fl_servers(cls, data, (dev, "cpu"), batch_size=b,
                                    generator_device="cpu")
            check(all(torch.equal(a.cpu(), w) for a, w in zip(card.params.values(),
                                                               cpu.params.values())),
                  f"(a) {cls.__name__}: the servers start from different weights")
            for srv in (card, cpu):
                srv.round(0)
            worst, leaf = 0.0, None
            for (name, a), w in zip(card.params.items(), cpu.params.values()):
                rel = ((a.cpu() - w).abs().max() / w.abs().max()).item()
                check(rel <= FL_LEAF_BAND, f"(a) {cls.__name__} leaf {name}: card vs CPU "
                                           f"{rel:.3g} of its max |CPU| > {FL_LEAF_BAND}")
                if rel >= worst:
                    worst, leaf = rel, name
            print(f"  (a) fp32 {cls.__name__} round, B={b}, {int(card.counts[0])} rows per "
                  f"client: worst leaf {leaf} at {worst:.2e} of its max |CPU| (band "
                  f"{FL_LEAF_BAND}); test accuracy {card.test_accuracy():.4f} card, "
                  f"{cpu.test_accuracy():.4f} CPU")


def fl_headline(dev):
    """Phase 9 (b): ``bench.fedavg_secondary`` at the golden config, and the
    same timing of FedSGD rounds."""
    from ddl25spring_tpu_torch import bench
    from ddl25spring_tpu_torch.benchmarks import timed_run
    from ddl25spring_tpu_torch.data.mnist import load_mnist
    from ddl25spring_tpu_torch.fl import FedSgdGradientServer
    from ddl25spring_tpu_torch.ops import flash_attention as fa

    fa.reset_launches()
    line = bench.fedavg_secondary(FL_ROUNDS, dev)
    check(line["test_accuracy"] >= 0.9,
          f"(b) FedAvg test accuracy {line['test_accuracy']} after {FL_ROUNDS + 1} rounds < 0.9")
    check(line["params_device"] == [str(dev)], f"(b) FedAvg weights on {line['params_device']}")
    print(f"  (b) FedAvg (N=10, C=0.1, B=100, E=1, {line['n_train']} rows): "
          f"{line['value']} ms/round mean over {FL_ROUNDS} timed rounds, median "
          f"{line['median_ms']} ms (CUDA events between rounds); test accuracy "
          f"{line['test_accuracy']:.4f}; weights on {line['params_device']}")
    print(f"  (b) {json.dumps(line)}")
    data = load_mnist(n_train=line["n_train"], n_test=10_000)  # fedavg_secondary's, cached
    (server,) = _fl_servers(FedSgdGradientServer, data, (dev,), batch_size=-1)
    dt, _, round_s = timed_run(server.round, itertools.count().__next__, FL_ROUNDS, 1,
                               device=dev)
    acc = server.test_accuracy()
    check(all(p.device == dev for p in server.params.values()), "(b) FedSGD weights off the card")
    check(not any(fa.LAUNCHES.values()) and not any(n for c in fa.CAPTURED.values()
                                                    for n in c.values()),
          f"(b) the FL path launched flash kernels: {fa.LAUNCHES}, captured {fa.CAPTURED}")
    print(f"  (b) FedSGD (B=-1, {int(server.counts[0])}-row full batch per client): "
          f"{dt / FL_ROUNDS * 1e3:.3f} ms/round mean, median "
          f"{statistics.median(round_s) * 1e3:.3f} ms; test accuracy "
          f"{acc:.4f}; flash kernel launches on the FL path {dict(fa.LAUNCHES)}")
    return line


def fl_a1_oracle(dev):
    """Phase 9 (c): homework A1 on the card with dropout on."""
    from ddl25spring_tpu_torch.data.mnist import load_mnist
    from ddl25spring_tpu_torch.fl import FedAvgServer, FedSgdGradientServer

    data = load_mnist(n_train=1000, n_test=500)
    common = dict(nr_clients=4, client_fraction=0.5, lr=0.01, seed=10, data=data,
                  batch_size=-1, nr_local_epochs=1, device=dev)
    grad_server, weight_server = FedSgdGradientServer(**common), FedAvgServer(**common)
    deltas = []
    for r in range(2):
        grad_server.round(r)
        weight_server.round(r)
        ga, wa = grad_server.test_accuracy(), weight_server.test_accuracy()
        check(abs(ga - wa) <= 2e-4, f"(c) round {r}: FedSGD accuracy {ga} vs FedAvg {wa}")
        deltas.append((ga, wa))
    err = 0.0
    for (name, a), b in zip(grad_server.params.items(), weight_server.params.values()):
        e = excess(a, b, (1e-5, 1e-4))
        check(e <= 0, f"(c) A1 leaf {name}: FedSGD vs FedAvg off by {e:.3g} past tolerance")
        err = max(err, max_err(a, b))
    print(f"  (c) A1 with dropout on, N=4, C=0.5, 1000 rows, CUDA generators: accuracies "
          f"(FedSGD, FedAvg) per round {deltas}; weights max abs err {err:.2e}")


def fl_profile(dev, timed=3, traced=1):
    """Phase 9 (d): host wall over ``timed`` warm FedAvg rounds, device time
    by kernel over ``traced`` more under torch.profiler."""
    from ddl25spring_tpu_torch.data.mnist import load_mnist
    from ddl25spring_tpu_torch.fl import FedAvgServer

    (server,) = _fl_servers(FedAvgServer, load_mnist(n_train=60_000, n_test=10_000), (dev,))
    r = iter(range(10_000))
    server.round(next(r))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(timed):
        server.round(next(r))
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / timed
    events = kernel_events(lambda: server.round(next(r)), traced)
    rows = sorted(((e.self_device_time_total / traced, e.count / traced, e.key)
                   for e in events), reverse=True)
    busy_ms = sum(us for us, _, _ in rows) / 1e3
    check(busy_ms > 0, "(d) profiler recorded no device time")
    steps = -(-int(server.counts.max()) // 100)
    print(f"  (d) FedAvg round: host wall {wall_ms:.3f} ms (unprofiled, {timed} rounds), device "
          f"busy {busy_ms:.3f} ms in {sum(n for _, n, _ in rows):.0f} kernels ({traced} rounds "
          f"traced), idle share {1 - busy_ms / wall_ms:.3f}; {steps} SGD steps per round, "
          f"{wall_ms / steps:.3f} ms of host wall per step")
    for us, n, key in rows[:12]:
        print(f"    {us / 1e3:8.4f} ms/round  x{n:<6.1f} {key[:100]}")
    return busy_ms, wall_ms


def fl_vertical_generative(dev):
    """Phase 9 (e): ``examples.vfl_and_generative_fl`` at its defaults."""
    from ddl25spring_tpu_torch.examples import vfl_and_generative_fl

    run = vfl_and_generative_fl.main(["--device", dev.type])
    check(run["provenance"] == "real", f"(e) heart data is {run['provenance']}, not heart.csv")
    for key, (lo, hi) in FL_ACC_BANDS.items():
        check(lo <= run[key] <= hi, f"(e) {key} {run[key]:.4f} outside [{lo}, {hi}]")
    check(all(math.isfinite(x) for x in run["vfl_losses"] + run["vae_losses"]),
          "(e) a VFL or VAE loss is not finite")
    print(f"  (e) VFL test accuracy {run['vfl_acc']:.4f}, TSTR real {run['tstr_real']:.4f}, "
          f"synthetic {run['tstr_synthetic']:.4f} (bands {FL_ACC_BANDS}); VFL loss "
          f"{run['vfl_losses'][0]:.4f} -> {run['vfl_losses'][-1]:.4f}, VAE loss "
          f"{run['vae_losses'][0]:.2f} -> {run['vae_losses'][-1]:.2f}")


# phase 9 (e) in a process of its own: beside the build and phase 3 its
# small Python-bound training loops would share this process's interpreter
# lock with phase 3's checks
_FL_VERTICAL = r"""
import sys, torch
import chip_smoke
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
try:
    chip_smoke.fl_vertical_generative(torch.device("cuda", 0))
    chip_smoke.golden_quick(torch.device("cuda", 0))
except chip_smoke.PhaseError as e:
    print(f"FAILED: {e}", flush=True)
    sys.exit(1)
"""


def fl_vertical_generative_proc() -> str:
    """Phase 9 (e) (:func:`fl_vertical_generative`), then phase 23 (a)'s
    :func:`golden_quick`, in a child process; returns what it printed, and
    fails as the child did."""
    import os

    r = subprocess.run([sys.executable, "-c", _FL_VERTICAL], capture_output=True, text=True,
                       timeout=900, cwd=os.path.dirname(os.path.abspath(__file__)))
    check(r.returncode == 0, f"(e) exit {r.returncode}: {r.stdout[-3000:]} {r.stderr[-3000:]}")
    return r.stdout


def fl_phase(dev, vertical=True):
    """Phase 9, each sub-phase timed; ``vertical=False`` leaves out (e),
    which :func:`main` runs beside the build."""
    subs = [("(a)", fl_exactness), ("(b)", fl_headline), ("(c)", fl_a1_oracle),
            ("(d)", fl_profile)] + ([("(e)", fl_vertical_generative)] if vertical else [])
    for name, fn in subs:
        t0 = time.perf_counter()
        fn(dev)
        print(f"  {name} took {time.perf_counter() - t0:.1f} s", flush=True)


# ------------------------------------------- phases 10-17: one world of 8

CHAIN_WORLD = 8                 # ranks of the world that hosts phases 10-17's worlds
CHAIN_TIMEOUT = 1200            # seconds for all of them


def chain_rank(rdv, jobs):
    """One rank of the world that hosts phases 10-17's worlds one after the
    other.  For each ``(name, fn, n, args)`` of ``jobs`` the world's first
    ``n`` ranks run ``fn(rdv_j, *args)`` as a world of ``n`` of their own,
    which meets in a store of its own beside the spawn's; the other ranks go
    on to the next job and wait for its peers there.  One start-up (the
    process, its CUDA context, the kernels' modules, cuBLAS's handles) serves
    them all, and each job frees what it cached before the next.  Returns
    ``{name: result}`` of the jobs this rank ran."""
    import dataclasses
    import gc

    out = {}
    for j, (name, fn, n, args) in enumerate(jobs):
        if rdv.rank >= n:
            continue
        sub = dataclasses.replace(rdv, world=n, local_world=n,
                                  init_method=f"{rdv.init_method}-{j}")
        out[name] = fn(sub, *args)
        gc.collect()
        if torch.cuda.is_initialized():
            torch.cuda.empty_cache()
    return out


def own_world(fn, n, args):
    """``fn``'s world of ``n`` ranks spawned on its own, the kernels built
    first: a phase run alone, outside :func:`chain_phase`."""
    from ddl25spring_tpu_torch.ops import _build
    from ddl25spring_tpu_torch.parallel.launch import spawn

    _build.build(_build.CSRC / "flash_attention.cu", _build.CSRC / "flash_attention_sm90.cu",
                 _build.CSRC / "flash_attention_tf32x3.cu")
    return spawn(fn, n, *args, timeout=SPAWN_TIMEOUT)


def chain_phase(dev, zdir) -> dict:
    """The worlds of phases 10 (a)-(c) and (e), 11 (e), 12, 13 (b) and (c), 14,
    15 and 17 (d), each as its phase builds it, run in turn in ONE spawned
    world of :data:`CHAIN_WORLD` ranks (:func:`chain_rank`) instead of nine:
    the card runs one of them at a time, as before, and each phase checks
    its world's results in its place.  17 (d) checkpoints into ``zdir``.
    Returns each world's ranks' results by name (rank order) and the inputs
    under ``"inputs"``."""
    from ddl25spring_tpu_torch.parallel.launch import spawn

    moe_b, moe_c = moe_inputs(dev)
    jobs = [("10 (a)-(c)", schedules_rank, DP * PP, schedules_inputs(dev)),
            ("10 (e)", dp_overlap_rank, 2, dp_overlap_inputs(dev)),
            ("11 (e)", fedavg_axis_rank, 2, (dev.type,)),
            ("12", sp_tp_rank, 4, sp_tp_inputs(dev)),
            ("13 (b)", moe_world_rank, 4, moe_b),
            ("13 (c)", moe_pipe_rank, MOE_PIPE[0] * MOE_PIPE[1], moe_c),
            ("14", pipe_comp_rank, 8, pipe_inputs(dev)),
            ("15", zero_rank, ZERO_N, zero_inputs(dev)),
            ("17 (d)", ft_zero_rank, FT_ZERO_N, ft_zero_inputs(zdir, dev.type))]
    t0 = time.perf_counter()
    ranks = spawn(chain_rank, CHAIN_WORLD, jobs, timeout=CHAIN_TIMEOUT)
    print(f"  one world of {CHAIN_WORLD} ranks ran phases 10-17's {len(jobs)} worlds in turn "
          f"({', '.join(f'{name}: {n} ranks' for name, _, n, _ in jobs)}) in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    worlds = {name: [r[name] for r in ranks[:n]] for name, _, n, _ in jobs}
    worlds["inputs"] = {name: args for name, _, _, args in jobs}
    return worlds


# ---------------------------------------------------------------- phase 10

SCHED = ("gpipe", "1f1b", "1f1b-stash", "interleaved", "interleaved-1f1b")
CHUNKS = 2                      # phase 10: chunks per rank under the interleaved schedules
SCHED_STEPS = 8                 # phase 10 (b): steps per schedule, the median over 4..7
MEM_MICRO = 12                  # phase 10 (c): microbatches of one row each, 1 x 3
ACCUM_MICRO = 4                 # phase 10 (d): ResNet batch 1024 in 4 microbatches
ACCUM_ITERS = 10                # phase 10 (d): timed steps of each ResNet step


def _chunks_of(schedule):
    return CHUNKS if schedule.startswith("interleaved") else 1


def schedules_rank(rdv, data, runs, device, sub_runs=()):
    """One rank of a ``data x 3`` world that runs each of ``runs`` in turn
    from the same weights (``Llama(7)``'s), after ``sub_runs`` on the
    world's first 3 ranks as a 1 x 3 grid of their own (``Mesh.sub``; their
    results under ``"sub"``, which the other ranks leave out).  A run is a
    dict with ``schedule``,
    ``dtype``, ``M``, ``rows`` (the global batch), ``steps`` and ``key``.
    Per run: the losses (last stage), each step's host seconds and comm
    counts, the flash launches by kernel and variant over the steps, the
    executor's largest stash per step, each step's activation peak (the
    most bytes allocated during the step less those allocated just before
    it), and the stage's gradients and parameters after the first step."""
    from ddl25spring_tpu_torch.models.llama import Llama, export_params
    from ddl25spring_tpu_torch.utils.config import LlamaConfig
    from ddl25spring_tpu_torch.utils.mesh import init_mesh

    out = {}
    with init_mesh(rdv, data=data, stages=PP, device=device) as world:
        # the labs' model: the embedding sized by the tokenizer
        vocab = lab_vocab()
        params = export_params(Llama(LlamaConfig(vocab_size=vocab), device="cpu",
                                     generator=torch.Generator().manual_seed(7)))
        sub = world.sub(1, PP) if sub_runs else None
        if sub is not None:
            out["sub"] = {**_schedule_results(sub, params, vocab, sub_runs),
                          "coords": sub.coords, "backend": sub.backend,
                          "device": str(sub.device)}
        out.update(_schedule_results(world, params, vocab, runs))
        out["coords"] = world.coords
        out["backend"], out["device"] = world.backend, str(world.device)
    return out


def _schedule_results(mesh, params, vocab, runs) -> dict:
    """:func:`schedules_rank`'s runs on ``mesh``, by key."""
    from ddl25spring_tpu_torch.models.llama import export_grads, export_params
    from ddl25spring_tpu_torch.ops import flash_attention as fa
    from ddl25spring_tpu_torch.parallel.pipeline import (
        make_pipeline_train_step,
        shard_staged_params,
    )
    from ddl25spring_tpu_torch.utils.config import LlamaConfig

    out = {}
    for run in runs:
        cfg = LlamaConfig(vocab_size=vocab, dtype=run["dtype"], use_flash=True)
        V = _chunks_of(run["schedule"])
        stage = shard_staged_params(params, cfg, mesh, V)
        step = make_pipeline_train_step(stage, cfg,
                                        torch.optim.Adam(stage.parameters(), lr=8e-4),
                                        mesh, run["M"], run["schedule"], V)
        batches = _token_batches(cfg, run["rows"], run["steps"], seed=17)
        r = {"losses": [], "step_s": [], "comm": [], "stash": [], "peak": []}
        fa.reset_launches()
        mesh.comm.take_stats()
        cuda = mesh.device.type == "cuda"
        for i, b in enumerate(batches):
            tokens = torch.from_numpy(b).long()
            if cuda:
                torch.cuda.synchronize(mesh.device)
                before = torch.cuda.memory_allocated(mesh.device)
                torch.cuda.reset_peak_memory_stats(mesh.device)
            t0 = time.perf_counter()
            loss = step(tokens)
            if cuda:
                torch.cuda.synchronize(mesh.device)
            r["step_s"].append(time.perf_counter() - t0)
            r["peak"].append(torch.cuda.max_memory_allocated(mesh.device) - before
                             if cuda else 0)
            r["comm"].append(mesh.comm.take_stats())
            r["stash"].append(step.stats["stash_max"])
            if loss is not None:
                r["losses"].append(float(loss))
            if i == 0:
                r["grads"], r["updated"] = export_grads(stage), export_params(stage)
        r["launches"] = dict(fa.LAUNCHES)
        r["by_variant"] = {n: dict(c) for n, c in fa.LAUNCHES_BY_VARIANT.items()}
        out[run["key"]] = r
        del step, stage
    return out


def _schedule_runs(key, dtype, M, rows, steps, schedules=SCHED):
    return [{"key": (key, s), "schedule": s, "dtype": dtype, "M": M, "rows": rows,
             "steps": steps} for s in schedules]


def _pipeline0(ranks):
    return sorted((r for r in ranks if r["coords"][0] == 0), key=lambda r: r["coords"][1])


def schedules_exactness(tag, ranks):
    """Phase 10 (a): each schedule's first fp32 step against GPipe's on the
    same weights and tokens: loss rtol 1e-5, every gradient leaf and every
    updated leaf within phase 7 (a)'s band (atol 2e-4 + rtol 2e-3); 1f1b
    against 1f1b-stash as a max abs difference."""
    from ddl25spring_tpu_torch.models.llama import merge_stage_exports
    from ddl25spring_tpu_torch.parallel.bucketing import flatten

    pipe = _pipeline0(ranks)

    def merged(s, key):
        return flatten(merge_stage_exports([r[("a", s)][key] for r in pipe], _chunks_of(s)))

    want_loss = pipe[-1][("a", "gpipe")]["losses"][0]
    for s in SCHED[1:]:
        loss = pipe[-1][("a", s)]["losses"][0]
        check(excess(loss, want_loss, (0.0, 1e-5)) <= 0,
              f"(a) {tag} fp32 {s} loss {loss} vs gpipe {want_loss}")
        err = {}
        for key in ("grads", "updated"):
            err[key] = 0.0
            for (path, a), (_, b) in zip(merged(s, key), merged("gpipe", key)):
                e = excess(a, b, (2e-4, 2e-3))
                check(e <= 0, f"(a) {tag} fp32 {s} {key} {path} off gpipe's by {e:.3g} past "
                              "tolerance")
                err[key] = max(err[key], max_err(torch.from_numpy(a), torch.from_numpy(b)))
        print(f"  (a) {tag} fp32 {s}: loss {loss:.7f} vs gpipe {want_loss:.7f}; gradients "
              f"max abs err {err['grads']:.2e}, updated parameters {err['updated']:.2e}")
    diff = abs(pipe[-1][("a", "1f1b")]["losses"][0] - pipe[-1][("a", "1f1b-stash")]["losses"][0])
    for key in ("grads", "updated"):
        for (path, a), (_, b) in zip(merged("1f1b", key), merged("1f1b-stash", key)):
            diff = max(diff, float(abs(a - b).max()))
    print(f"  (a) {tag} 1f1b vs 1f1b-stash: max abs difference {diff:.3g} over the loss, "
          "every gradient and every updated parameter "
          f"({'bitwise equal' if diff == 0 else 'the recompute differs in the last bits'})")
    for r in ranks:
        check(r["device"].startswith("cuda"), f"rank {r['coords']} ran on {r['device']}")


def schedules_launches_and_times(ranks):
    """Phase 10 (b): bf16, 2 x 3, 3 one-row microbatches: the flash launches
    of every rank per step, exactly (twice the forward under the remat
    schedules), all on wgmma; the median step and its split."""
    layers = 6 // PP
    out = {}
    for s in SCHED:
        per = {"fwd": (2 if s in ("1f1b", "interleaved-1f1b") else 1) * layers * MICRO,
               "dq": layers * MICRO, "dkv": layers * MICRO}
        for r in ranks:
            got = r[("b", s)]
            want = {n: c * SCHED_STEPS for n, c in per.items()}
            check(got["launches"] == want, f"(b) {s} rank {r['coords']} launches "
                                           f"{got['launches']} != {want}")
            for n in want:
                check(got["by_variant"][n]["wgmma"] == want[n],
                      f"(b) {s} rank {r['coords']} {n} by variant {got['by_variant'][n]}")
        log = next(r for r in ranks if r["coords"] == (0, PP - 1))[("b", s)]
        check(len(log["losses"]) == SCHED_STEPS
              and all(math.isfinite(x) for x in log["losses"]), f"(b) {s} losses {log['losses']}")
        steady = [max(r[("b", s)]["step_s"][i] for r in ranks)
                  for i in range(4, SCHED_STEPS)]  # the slowest rank's
        split = {}
        for k in ("recv_wait_s", "send_s", "allreduce_s", "bytes_staged"):
            split[k] = [statistics.median(c[k] for r in ranks if r["coords"][1] == st
                                          for c in r[("b", s)]["comm"][4:]) for st in range(PP)]
        out[s] = {"step_ms": statistics.median(steady) * 1e3, "launches": per, **split}
        print(f"  (b) {s}: median step {out[s]['step_ms']:.3f} ms (slowest rank, steps "
              f"4..{SCHED_STEPS - 1}, host clock; min {min(steady) * 1e3:.3f}, max "
              f"{max(steady) * 1e3:.3f}); per rank per step fwd {per['fwd']}, dq {per['dq']}, "
              f"dkv {per['dkv']}, all wgmma; loss {log['losses'][0]:.4f} -> "
              f"{log['losses'][-1]:.4f}")
        print(f"      per stage (medians): recv wait "
              f"{[round(x * 1e3, 3) for x in split['recv_wait_s']]} ms, send "
              f"{[round(x * 1e3, 3) for x in split['send_s']]} ms, DP all-reduce "
              f"{[round(x * 1e3, 3) for x in split['allreduce_s']]} ms, staged "
              f"{[int(x) for x in split['bytes_staged']]} B")
    return out


def schedules_memory(ranks):
    """Phase 10 (c): bf16, 1 x 3, 12 one-row microbatches: each rank's
    activation peak in the second step and the executor's largest stash;
    stage 0 holds M under gpipe and min(M, S) under both 1F1Bs, and its peak
    under 1f1b-stash is below half of gpipe's."""
    pipe = _pipeline0(ranks)
    mem = ("gpipe", "1f1b", "1f1b-stash", "interleaved-1f1b")
    for s in mem:
        peaks = [r[("c", s)]["peak"][-1] / 2**20 for r in pipe]
        stash = [r[("c", s)]["stash"][-1] for r in pipe]
        print(f"  (c) {s}: activation peak per stage {[round(x, 2) for x in peaks]} MiB; "
              f"largest stash {stash} (microbatch-chunks in flight)")
    s0 = {s: pipe[0][("c", s)] for s in mem}
    check(s0["gpipe"]["stash"][-1] == MEM_MICRO, f"(c) gpipe stage 0 stash {s0['gpipe']['stash']}")
    for s in ("1f1b", "1f1b-stash"):
        check(s0[s]["stash"][-1] == min(MEM_MICRO, PP), f"(c) {s} stage 0 stash {s0[s]['stash']}")
    ratio = s0["1f1b-stash"]["peak"][-1] / s0["gpipe"]["peak"][-1]
    check(ratio < 0.5, f"(c) stage 0's 1f1b-stash peak is {ratio:.3f} of gpipe's, not below 0.5")
    print(f"  (c) stage 0: 1f1b-stash peak / gpipe peak = {ratio:.4f}; 1f1b / gpipe = "
          f"{s0['1f1b']['peak'][-1] / s0['gpipe']['peak'][-1]:.4f}")


def schedules_inputs(dev) -> tuple:
    """Phase 10 (a)-(c)'s world of 2 x 3 (:func:`schedules_rank`): every
    schedule's runs in turn, the 1 x 3 runs first on its first 3 ranks
    (``Mesh.sub``)."""
    return (DP, _schedule_runs("a", "float32", MICRO, DP * ROWS, 1)
            + _schedule_runs("b", "bfloat16", MICRO, DP * ROWS, SCHED_STEPS),
            dev.type,
            _schedule_runs("a", "float32", MICRO, MICRO, 1)
            + _schedule_runs("c", "bfloat16", MEM_MICRO, MEM_MICRO, 2,
                             ("gpipe", "1f1b", "1f1b-stash", "interleaved-1f1b")))


def schedules_worlds(dev, two):
    """Phase 10 (a)-(c)'s checks on the 2 x 3 world's results (the chain's
    first world, :func:`chain_phase`)."""
    one = [r["sub"] for r in two[:PP]]
    print(f"  the 2 x 3 world, the 1 x 3 runs on its first 3 ranks: backend "
          f"{two[0]['backend']}")
    schedules_exactness("1 x 3", one)
    schedules_exactness("2 x 3", two)
    timing = schedules_launches_and_times(two)
    schedules_memory(one)
    return timing


def grad_accum_resnet(dev):
    """Phase 10 (d): ``make_grad_accum_step`` over ResNet-18 (GroupNorm), the
    single-process microbatch accumulation of BASELINE's first config.  fp32
    on 64 rows in 4 microbatches against one full-batch step from the same
    weights: each gradient leaf and each leaf's update within phase 8 (a)'s
    2e-2 of its own max; then bf16 at batch 1024 in 4 microbatches, its
    median step beside the batch-1024 step's, both timed here."""
    from ddl25spring_tpu_torch.benchmarks import DeviceDataset, _nchw, build_resnet_step, timed_run
    from ddl25spring_tpu_torch.models.resnet import ResNet18, export_grads, export_params
    from ddl25spring_tpu_torch.ops.losses import cross_entropy_logits
    from ddl25spring_tpu_torch.parallel.bucketing import flatten
    from ddl25spring_tpu_torch.parallel.dp import make_train_step
    from ddl25spring_tpu_torch.parallel.pipeline import make_grad_accum_step
    from ddl25spring_tpu_torch.utils.device import backend_flags
    from ddl25spring_tpu_torch.utils.prng import seeded_generator

    gens = [seeded_generator(0, 0, m) for m in range(ACCUM_MICRO)]

    def model(dtype):
        return ResNet18(norm="group", dtype=dtype, generator=torch.Generator().manual_seed(13)
                        ).to(dev, memory_format=torch.channels_last)

    def loss_fn(dtype):
        return lambda m, raw, *gen: cross_entropy_logits(m(_nchw(raw[0], dtype)), raw[1])

    x_u8, y = (t.to(dev) for t in _cifar_rows(64))
    with backend_flags(**FP32_EXACT):
        out = []
        for accum in (True, False):
            m = model(torch.float32)
            before = export_params(m)
            opt = torch.optim.SGD(m.parameters(), lr=0.1, momentum=0.9)
            if accum:
                loss = make_grad_accum_step(m, loss_fn(torch.float32), opt, ACCUM_MICRO)(
                    (x_u8, y), gens)
            else:
                loss = make_train_step(m, loss_fn(torch.float32), opt)((x_u8, y))
            after = flatten(export_params(m))
            out.append((float(loss), flatten(export_grads(m)),
                        [(p, w - w0) for (p, w), (_, w0) in zip(after, flatten(before))]))
    (la, ga, ua), (lf, gf, uf) = out
    check(excess(la, lf, (0.0, 1e-5)) <= 0, f"(d) accumulated loss {la} vs full batch {lf}")
    worst = 0.0
    for (path, a), (_, b) in zip(ga + ua, gf + uf):
        worst = max(worst, _within(f"(d) grad-accum {path}", a, b, 2e-2)
                    / max(float(abs(b).max()), 1e-30))
    print(f"  (d) fp32, 64 rows in {ACCUM_MICRO} microbatches vs one 64-row step: loss "
          f"{la:.6f} vs {lf:.6f}; worst gradient or update leaf {worst:.2e} of its max")

    from ddl25spring_tpu_torch.lab.dp_pp import RUN_FLAGS

    times = {}
    with backend_flags(**RUN_FLAGS):
        ds = DeviceDataset(1024, n_train=1024, device=dev)
        m = model(torch.bfloat16)
        opt = torch.optim.SGD(m.parameters(), lr=float(RESNET_LR), momentum=0.9)
        accum = make_grad_accum_step(m, loss_fn(torch.bfloat16), opt, ACCUM_MICRO)
        step, _, _, _ = build_resnet_step(None, 1, 1024, lr=float(RESNET_LR), device=dev)
        for name, fn in (("accumulated (4 x 256)", lambda raw: accum(raw, gens)),
                         ("batch 1024", step)):
            _, losses, step_s = timed_run(fn, lambda: ds.fixed, ACCUM_ITERS, 3, device=dev)
            check(all(math.isfinite(float(x)) for x in losses), f"(d) {name} losses {losses}")
            times[name] = statistics.median(step_s) * 1e3
            print(f"  (d) bf16 ResNet-18 {name}: median step {times[name]:.3f} ms over "
                  f"{ACCUM_ITERS} timed steps (CUDA events between steps)")
    return times


def dp_overlap_rank(rdv, cfg, batches, device):
    """One rank of phase 10 (e): 2 Adam steps of the sync per-tensor DP step
    and of the overlapped one, from ``Llama(9)``'s weights."""
    from ddl25spring_tpu_torch.models.llama import Llama, export_params
    from ddl25spring_tpu_torch.ops.losses import causal_lm_loss
    from ddl25spring_tpu_torch.parallel.dp import make_dp_train_step
    from ddl25spring_tpu_torch.utils.mesh import init_mesh

    out = {}
    with init_mesh(rdv, data=2, stages=1, device=device) as mesh:
        for name, kw in (("sync", {"bucket_bytes": None}), ("overlap", {"overlap": True})):
            model = Llama(cfg, device=mesh.device, generator=torch.Generator().manual_seed(9))
            step = make_dp_train_step(model, lambda m, t: causal_lm_loss(m(t), t),
                                      torch.optim.Adam(model.parameters(), lr=8e-4), mesh, **kw)
            mesh.comm.take_stats()
            losses = [float(step(torch.from_numpy(b).long())) for b in batches]
            out[name] = {"losses": losses, "params": export_params(model),
                         "log": list(step.log), **mesh.comm.take_stats()}
        out["backend"], out["device"] = mesh.backend, str(mesh.device)
    return out


def dp_overlap_inputs(dev) -> tuple:
    """Phase 10 (e)'s world of 2 (:func:`dp_overlap_rank`)."""
    from ddl25spring_tpu_torch.utils.config import LlamaConfig

    cfg = LlamaConfig(dtype="float32", use_flash=True)
    return cfg, _token_batches(cfg, 2 * ROWS, 2, seed=19), dev.type


def dp_overlap(dev, ranks):
    """Phase 10 (e): DP ``overlap=True`` against the sync per-tensor step, 2
    gloo ranks on the card, fp32, full-width LLaMA, after 2 steps."""
    from ddl25spring_tpu_torch.parallel.bucketing import flatten

    diff = 0.0
    for r in ranks:
        check(r["device"].startswith("cuda"), f"(e) rank on {r['device']}")
        check(r["overlap"]["losses"] == r["sync"]["losses"] or
              excess(r["overlap"]["losses"], r["sync"]["losses"], (1e-7, 0.0)) <= 0,
              f"(e) losses {r['overlap']['losses']} vs sync {r['sync']['losses']}")
        for (path, a), (_, b) in zip(flatten(r["overlap"]["params"]),
                                     flatten(r["sync"]["params"])):
            d = float(abs(a - b).max())
            check(d <= 1e-7, f"(e) overlap {path} off the sync step by {d:.3g}")
            diff = max(diff, d)
    log = ranks[0]["overlap"]["log"]
    grads = [i for kind, i in log if kind == "grad"]
    where = [(b, sum(1 for e in log[:log.index(("issue", b))] if e[0] == "grad"))
             for kind, b in log if kind == "issue"]
    print(f"  (e) backend {ranks[0]['backend']}: overlap vs sync per-tensor after 2 steps, max "
          f"abs difference {diff:.3g} ({'bitwise' if diff == 0 else 'within 1e-7'}); losses "
          f"{ranks[0]['overlap']['losses']}")
    print(f"  (e) buckets issued (bucket, leaf gradients complete before it, of {len(grads)}): "
          f"{where}; all-reduce {ranks[0]['overlap']['allreduce_s'] * 1e3:.3f} ms over 2 "
          f"steps (sync {ranks[0]['sync']['allreduce_s'] * 1e3:.3f} ms)")


def kernel_times_at(rdv, cases, tag):
    """Device time per call of the three kernels on bf16 or fp32 inputs at
    each case ``(B, H, L, dtype, causal)`` (folded ``[B H, L, 48]``), each
    beside its bound and SDPA's forward and backward on the same inputs and
    causality; in fp32 also the scalar forward, dq and dk/dv launched past
    the dispatch rule, each kernel's plain version (CUDA events over 20
    calls), the bound on the CUDA cores beside the variant's, and the
    forward and the backward pair each against SDPA's as a ratio.  Run in a process
    of its own (phases 10 (f), 12 (c)), because a process that has already
    held several profiler sessions (phases 4, 6, 8 (c), 9 (d)) was seen to
    record 35 of 50 launches in every retry.  Returns the times and the
    lines to print."""
    from ddl25spring_tpu_torch.ops import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    lines = []
    gen = torch.Generator().manual_seed(5)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    out = {}
    for B, H, L, dtype, causal in cases:
        BH, hd = B * H, 48
        q, k, v, do = (randn(gen, BH, L, hd, dtype=dtype, dev=dev) for _ in range(4))
        o, lse = fa.flash_fwd(q, k, v, causal)
        delta = (do.float() * o.float()).sum(-1)
        q4, k4, v4, do4 = (x.view(B, H, L, hd) for x in (q, k, v, do))
        qg, kg, vg = (x.detach().clone().requires_grad_() for x in (q4, k4, v4))
        o4 = sdpa(qg, kg, vg, is_causal=causal)
        calls = {
            "fwd": lambda: fa.flash_fwd(q, k, v, causal),
            "dq": lambda: fa.flash_dq(q, k, v, lse, do, delta, causal),
            "dkv": lambda: fa.flash_dkv(q, k, v, lse, do, delta, causal),
            "sdpa fwd": lambda: sdpa(q4, k4, v4, is_causal=causal),
            "sdpa bwd": lambda: torch.autograd.grad(o4, (qg, kg, vg), do4, retain_graph=True)}
        variants = {n: fa._variant(n, (q, k, v)) for n in ("fwd", "dq", "dkv")}
        plain_ms = {}
        if dtype == torch.float32:
            dq_s, dk_s, dv_s, o_s = (torch.empty_like(q) for _ in range(4))
            lse_s = torch.empty_like(lse)
            calls["scalar fwd"] = lambda: fa._launch("fwd", "scalar", q, k, v, o_s, lse_s,
                                                     q3=q, Lk=L, causal=causal)
            calls["scalar dq"] = lambda: fa._launch("dq", "scalar", q, k, v, do, lse, delta,
                                                    dq_s, q3=q, Lk=L, causal=causal)
            calls["scalar dkv"] = lambda: fa._launch("dkv", "scalar", q, k, v, do, lse, delta,
                                                     dk_s, dv_s, q3=q, Lk=L, causal=causal)
            plain_ms = {n: cuda_ms(fn, 20) for n, fn in (
                ("fwd", lambda: fa.flash_fwd_reference(q, k, v, causal)),
                ("dq", lambda: fa.flash_dq_reference(q, k, v, lse, do, delta, causal)),
                ("dkv", lambda: fa.flash_dkv_reference(q, k, v, lse, do, delta, causal)))}
        row = {n: device_ms(fn) for n, fn in calls.items()}
        act, rows = BH * L * hd * q.element_size(), BH * L * 4
        # the (query, key) pairs that attend
        pairs = BH * L * (L + 1) // 2 if causal else BH * L * L
        work = {"fwd": (4 * act + rows, 4 * hd * pairs), "dq": (5 * act + 2 * rows, 6 * hd * pairs),
                "dkv": (6 * act + 2 * rows, 8 * hd * pairs)}
        bounds = {n: bound(*w, dtype, variants[n]) for n, w in work.items()}
        cores = {n: bound(*w, dtype) for n, w in work.items() if variants[n] == "tf32x3"}
        key = f"[{BH}, {L}, {hd}] {str(dtype)[6:]} {'causal' if causal else 'non-causal'}"
        out[key] = {"ms": row, "variants": variants, "plain_ms": plain_ms,
                    "bound_ms": {n: b[0] for n, b in bounds.items()},
                    "bound_by": {n: b[1] for n, b in bounds.items()},
                    "bound_ms_cuda_cores": {n: b[0] for n, b in cores.items()}}

        def about(n):
            if n not in variants:
                return ""
            extra = (f"; on the CUDA cores {cores[n][0]:.6f} by {cores[n][1]}" if n in cores
                     else "")
            plain = f"; plain {plain_ms[n]:.4f}" if n in plain_ms else ""
            return (f" ({variants[n]}; bound {bounds[n][0]:.6f} by {bounds[n][1]}{extra}"
                    f"{plain})")

        lines.append(f"  {tag} {key}, device ms per call: "
                     + ", ".join(f"{n} {t:.5f}{about(n)}" for n, t in row.items()))
        if "scalar dq" in row:
            lines.append(f"  {tag} {key}: forward ({variants['fwd']}) {row['fwd']:.5f} ms "
                         f"against SDPA forward {row['sdpa fwd']:.5f} "
                         f"({row['fwd'] / row['sdpa fwd']:.2f}x) and the scalar forward "
                         f"{row['scalar fwd']:.5f}")
            pair = row["dq"] + row["dkv"]
            lines.append(f"  {tag} {key}: dq + dk/dv ({variants['dq']}) {pair:.5f} ms against "
                         f"SDPA backward {row['sdpa bwd']:.5f} ({pair / row['sdpa bwd']:.2f}x) "
                         f"and the scalar pair {row['scalar dq'] + row['scalar dkv']:.5f}")
    return out, lines


def kernel_times_sets(rdv, sets):
    """:func:`kernel_times_at` for each ``(cases, tag)`` of ``sets``, in one
    new process: phase 10 (f)'s, 12 (c)'s and 14 (e)'s."""
    return [kernel_times_at(rdv, cases, tag) for cases, tag in sets]


def slice_kernel_times(dev):
    """Phase 10 (f): :func:`kernel_times_at` the schedules' per-microbatch
    shape ``[6, 256, 48]`` bf16 causal, phase 4's ``[18, 256, 48]`` in fp32
    causal and not, and ``[6, 256, 48]`` fp32 causal (phase 7 (a)'s
    microbatch); in the same new process, phase 12 (c)'s and 14 (e)'s cases.
    Returns each set's ``(times, lines)`` by tag; prints (f)'s."""
    from ddl25spring_tpu_torch.parallel.launch import spawn

    cases = [(1, 6, 256, torch.bfloat16, True), (3, 6, 256, torch.float32, True),
             (3, 6, 256, torch.float32, False), (1, 6, 256, torch.float32, True)]
    sets = [(cases, "(f)"),
            ([(B, H, L, torch.bfloat16, c) for B, H, L, c in SPTP_KERNEL_CASES], "12 (c)"),
            ([(B, H, L, torch.bfloat16, c) for B, H, L, c in PIPE_KERNEL_CASES], "14 (e)")]
    (res,) = spawn(kernel_times_sets, 1, sets, timeout=SPAWN_TIMEOUT)
    out = {tag: r for (_, tag), r in zip(sets, res)}
    for line in out["(f)"][1]:
        print(line)
    return out


def schedules_phase(dev, worlds=None):
    """Phase 10, each sub-phase timed, its worlds' results from
    :func:`chain_phase` (None: spawned here, the phase run alone); returns
    the kernel times of (f), 12 (c) and 14 (e) by tag."""
    if worlds is None:
        worlds = {"10 (a)-(c)": own_world(schedules_rank, DP * PP, schedules_inputs(dev)),
                  "10 (e)": own_world(dp_overlap_rank, 2, dp_overlap_inputs(dev))}
    for name, fn in (("(a)-(c)", lambda d: schedules_worlds(d, worlds["10 (a)-(c)"])),
                     ("(d)", grad_accum_resnet),
                     ("(e)", lambda d: dp_overlap(d, worlds["10 (e)"])),
                     ("(f)", slice_kernel_times)):
        t0 = time.perf_counter()
        out = fn(dev)
        print(f"  {name} took {time.perf_counter() - t0:.1f} s", flush=True)
    return out


# ---------------------------------------------------------------- phase 11

FUSE_K = 16                     # phase 11 (a), (b): LLaMA steps per window
FUSE_WINDOWS = 5                # phase 11 (b): timed windows per block
SCAN_BATCH = 64                 # phase 11 (c): fp32 rows per step, 16 batches an epoch
FL_AXIS_BAND = 1e-6             # phase 11 (e): sharded round vs one process, absolute
CENSUS = ("flash_fwd_wgmma", "flash_dq_wgmma", "flash_dkv_wgmma",
          "flash_fwd_kernel", "flash_dq_kernel", "flash_dkv_kernel")


def graph_census(dot: str) -> tuple[dict, int]:
    """Kernel nodes of a ``CUDAGraph.debug_dump`` by the flash kernel they
    launch, and the number of nodes: each node's definition starts a line
    with its quoted name and ``[`` (an edge line has ``->`` after the name)."""
    starts = [m.start() for m in re.finditer(r'^\s*"[^"]+"\s*\[', dot, re.M)]
    blocks = [dot[a:b] for a, b in zip(starts, starts[1:] + [len(dot)])]
    return {name: sum(name in b for b in blocks) for name in CENSUS}, len(blocks)


def _max_diff(a, b) -> float:
    return max((x.float() - y.float()).abs().max().item() for x, y in zip(a, b))


def _window_ms(fn, k, n):
    """Host wall per step of ``n`` windows of ``k`` steps, each window started
    and ended with the card idle."""
    out = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3 / k)
    return out


def fused_llama(rdv):
    """Phase 11 (a) and (b) for LLaMA, in a process of its own (fresh
    profiler state, as 10 (f)): ``LlamaConfig()`` bf16 flash, batch 3, Adam
    8e-4 ``capturable=True``.  (a) ``fuse_train_steps(step, 16)`` against 16
    eager steps from the same weights and tokens; the graph's node census;
    the captured and eager launch counters.  (b) host wall per step, median
    of 5 windows of 16, unfused and fused in turns (u, f, f, u), each
    beside its device busy time from torch.profiler over one more window,
    and the ``max_memory_allocated`` of 16 eager steps and of the fused
    program's build.  Returns the numbers and the lines to print."""
    import os
    import tempfile

    from ddl25spring_tpu_torch.models.llama import Llama
    from ddl25spring_tpu_torch.ops import flash_attention as fa
    from ddl25spring_tpu_torch.ops.losses import causal_lm_loss
    from ddl25spring_tpu_torch.parallel.dp import make_train_step
    from ddl25spring_tpu_torch.parallel.pipeline import WARMUP_STEPS, fuse_train_steps
    from ddl25spring_tpu_torch.utils.config import LlamaConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev, K, lr = torch.device("cuda", 0), FUSE_K, 8e-4
    cfg = LlamaConfig(dtype="bfloat16", use_flash=True)
    window = torch.randint(0, cfg.vocab_size, (K, MAIN_SHAPE[0], cfg.ctx_size),
                           generator=torch.Generator().manual_seed(7)).to(dev)

    def build():
        model = Llama(cfg, device=dev, generator=torch.Generator().manual_seed(0))
        opt = torch.optim.Adam(model.parameters(), lr=lr, capturable=True)
        return model, opt, make_train_step(model, lambda m, t: causal_lm_loss(m(t), t), opt)

    lines, out = [], {}
    m_seq, _, step = build()
    torch.cuda.reset_peak_memory_stats(dev)
    seq = torch.stack([step(window[i]) for i in range(K)])
    torch.cuda.synchronize()
    peak_eager = torch.cuda.max_memory_allocated(dev)
    m_f, opt_f, step_f = build()
    fa.reset_launches()
    torch.cuda.reset_peak_memory_stats(dev)
    with tempfile.TemporaryDirectory() as tmp:
        dump = os.path.join(tmp, "graph.dot")
        multi = fuse_train_steps(step_f, K, module=m_f, optimizer=opt_f, device=dev,
                                 dump_graph=dump)
        t0 = time.perf_counter()
        fused = multi(window)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        check(os.path.exists(dump), f"(a) CUDAGraph.debug_dump wrote no {dump}")
        with open(dump) as f:
            census, n_nodes = graph_census(f.read())
    peak_fused = torch.cuda.max_memory_allocated(dev)
    eager = dict(fa.LAUNCHES)
    captured = {n: dict(c) for n, c in fa.CAPTURED.items()}
    per_window = 6 * K
    check(eager == {n: 6 * WARMUP_STEPS for n in eager},
          f"(a) eager launches {eager}: the warm-up's {WARMUP_STEPS} steps should be the only ones")
    check(all(c == {"wgmma": per_window, "tf32x3": 0, "scalar": 0} for c in captured.values()),
          f"(a) captured launches {captured}, not {per_window} of each on wgmma")
    want_census = {n: per_window if n.endswith("wgmma") else 0 for n in CENSUS}
    check(census == want_census, f"(a) the graph's {n_nodes} nodes hold flash kernels "
                                 f"{census}, not {want_census}")
    loss_err = (fused - seq).abs().max().item()
    param_err = _max_diff(m_f.parameters(), m_seq.parameters())
    bitwise = torch.equal(fused, seq) and all(
        torch.equal(a, b) for a, b in zip(m_f.parameters(), m_seq.parameters()))
    check(torch.isfinite(fused).all().item() and loss_err <= 1e-2 * seq.abs().max().item(),
          f"(a) fused losses {fused.tolist()} vs eager {seq.tolist()}")
    check(param_err <= K * lr, f"(a) fused parameters off by {param_err:.3g} > {K * lr}")
    same = "bitwise equal" if bitwise else "NOT bitwise"
    lines.append(f"  (a) LLaMA bf16, {K} steps: fused vs eager {same} (losses max abs diff "
                 f"{loss_err:.3g}, parameters {param_err:.3g}); losses "
                 f"{seq[0].item():.4f} -> {seq[-1].item():.4f}")
    lines.append(f"  (a) graph: {n_nodes} nodes, flash kernel nodes {census}; captured "
                 f"launches {captured}; eager launches {eager} (the {WARMUP_STEPS} warm-up "
                 f"steps); built and replayed in {build_s:.2f} s")
    # (b): u, f, f, u blocks of windows; then one profiled window of each
    unfused = lambda: [step(window[i]) for i in range(K)]  # noqa: E731
    fused_fn = lambda: multi(window)  # noqa: E731
    blocks = [("unfused", _window_ms(unfused, K, FUSE_WINDOWS)),
              ("fused", _window_ms(fused_fn, K, FUSE_WINDOWS)),
              ("fused", _window_ms(fused_fn, K, FUSE_WINDOWS)),
              ("unfused", _window_ms(unfused, K, FUSE_WINDOWS))]
    fa.reset_launches()
    _window_ms(fused_fn, K, 2)
    check(not any(fa.LAUNCHES.values()), f"(b) replays moved the eager counters: {fa.LAUNCHES}")
    for name, fn in (("unfused", unfused), ("fused", fused_fn)):
        wall = statistics.median(t for n, ts in blocks if n == name for t in ts)
        events = kernel_events(fn, 1)
        busy = sum(e.self_device_time_total for e in events) / 1e3 / K
        flash = sum(e.count for e in events if "flash_" in e.key)
        out[name] = {"wall_ms": wall, "busy_ms": busy,
                     "blocks_ms": [statistics.median(ts) for n, ts in blocks if n == name]}
        idle = f"{1 - busy / wall:.3f}" if busy > 0 else "not measured (no kernel records)"
        lines.append(f"  (b) LLaMA {name}: host wall {wall:.3f} ms/step (median of "
                     f"{2 * FUSE_WINDOWS} windows of {K}; block medians "
                     f"{', '.join(f'{t:.3f}' for t in out[name]['blocks_ms'])}), device busy "
                     f"{busy:.3f} ms/step ({flash} flash kernel records a window), idle {idle}")
    out.update(peak_eager=peak_eager, peak_fused=peak_fused, census=census, bitwise=bitwise)
    lines.append(f"  (b) max_memory_allocated: 16 eager steps {peak_eager / 2**20:.1f} MiB, the "
                 f"fused program's warm-up, capture and first replay {peak_fused / 2**20:.1f} MiB "
                 "(two models resident in both)")
    return out, lines


def resnet_scan_headline(dev):
    """Phase 11 (b), ResNet: ``lab.dp_pp --workload resnet`` with ``--input
    hbm-scan`` (K = 16 at batch 1024), then ``--input hbm``, each 30 asked
    steps at phase 8 (b)'s settings; samples/s, median step, MFU, peak
    memory, and the report line's input field."""
    from ddl25spring_tpu_torch.lab import dp_pp
    from ddl25spring_tpu_torch.ops import flash_attention as fa

    runs = {}
    fa.reset_launches()
    for mode in ("hbm-scan", "hbm"):
        run = dp_pp.main(["--workload", "resnet", "--input", mode, "--iters",
                          str(RESNET_ITERS), "--seed", "0", "--lr", RESNET_LR, "--device",
                          dev.type])
        (r,) = run["ranks"]
        K = FUSE_K if mode == "hbm-scan" else 1
        timed = max(2, RESNET_ITERS // K) * K if K > 1 else RESNET_ITERS
        warm = dp_pp.WARMUP - 1
        check(len(r["losses"]) == 1 + warm * K + timed
              and all(math.isfinite(x) for x in r["losses"]),
              f"(b) {mode}: {len(r['losses'])} losses, not all finite or not 1 + {warm} x {K} "
              f"+ {timed}")
        want = "hbm-resident-shuffle" + (f"-scan{K}" if K > 1 else "")
        check(r["input"] == want and json.loads(run["line"])["input"] == want,
              f"(b) {mode}: input {r['input']}, want {want}")
        check(not any(fa.LAUNCHES.values()) and not any(n for c in fa.CAPTURED.values()
                                                        for n in c.values()),
              f"(b) {mode}: flash kernels {fa.LAUNCHES}, captured {fa.CAPTURED}")
        runs[mode] = run
        print(f"  (b) ResNet-18 bf16 batch 1024, --input {mode} ({want}): median step "
              f"{statistics.median(r['step_s']) * 1e3:.3f} ms over {timed} timed steps, "
              f"{run['samples_per_s_per_chip']:.1f} samples/s, MFU {run['mfu']:.4f}, "
              f"max_memory_allocated {r['peak_bytes'] / 2**30:.3f} GiB")
    return runs


def resnet_scan_exactness(dev):
    """Phase 11 (c): window 0 of epoch 0 selects, bitwise, the 16 batches
    that 16 ``feed()`` calls of a fresh dataset select; one fused fp32
    window (TF32 off, cuDNN deterministic) against 16 eager steps from the
    same weights: losses within 1e-4 of max |eager| and each leaf's update
    within 2e-2 of its largest, phase 8 (a)'s band."""
    from ddl25spring_tpu_torch.benchmarks import (
        DeviceDataset,
        build_resnet_scan_step,
        build_resnet_step,
    )
    from ddl25spring_tpu_torch.models.resnet import export_params
    from ddl25spring_tpu_torch.parallel.bucketing import flatten
    from ddl25spring_tpu_torch.utils.device import backend_flags

    K, B, lr = FUSE_K, SCAN_BATCH, float(RESNET_LR)

    def fresh():
        ds = DeviceDataset(B, n_train=B * K, device=dev)
        ds.cursor = 0
        return ds

    with backend_flags(**FP32_EXACT):
        feeds = fresh()
        want = [feeds.feed() for _ in range(K)]
        ds = fresh()
        offsets = ds.scan_window(K)
        for i in range(K):
            got = ds.gather(offsets[i])
            check(all(torch.equal(a, b) for a, b in zip(got, want[i])),
                  f"(c) window 0, batch {i} differs from feed()'s")
        ds = fresh()
        multi, _, module, _, _ = build_resnet_scan_step(
            None, 1, B, lr, torch.float32, scan_steps=K, dataset=ds, device=dev, seed=5)
        before = flatten(export_params(module))
        fused = multi(ds.scan_window(K))
        step, ref, _, _ = build_resnet_step(None, 1, B, lr, torch.float32, device=dev, seed=5)
        feeds = fresh()
        seq = torch.stack([step(feeds.feed()) for _ in range(K)])
        got, eager = flatten(export_params(module)), flatten(export_params(ref))
    _within("(c) fp32 fused losses", fused.cpu(), seq.cpu(), 1e-4)
    worst, bitwise = 0.0, torch.equal(fused, seq)
    for (path, a), (_, b), (_, w0) in zip(got, eager, before):
        bitwise = bitwise and (a == b).all()
        upd = b - w0
        err = _within(f"(c) fp32 fused update {path}", a - w0, upd, 2e-2,
                      slack=2.0**-23 * abs(b).max())
        worst = max(worst, err / max(float(abs(upd).max()), 1e-30))
    print(f"  (c) window 0 of epoch 0 = 16 feed() batches, bitwise; fp32 one fused window vs "
          f"16 eager steps ({B} rows each): {'bitwise equal' if bitwise else 'NOT bitwise'}, "
          f"losses max abs diff {(fused - seq).abs().max().item():.3g}, worst leaf update "
          f"{worst:.2e} of its largest")


def grad_accum_fused(dev):
    """Phase 11 (d): ``make_grad_accum_step`` (batch 1024 in 4 microbatches
    of 256, bf16, cuDNN autotuned) fused K = 4 against 4 eager steps from
    the same weights on the same batches (each leaf within 2e-2 of its max,
    phase 8 (a)'s band; bitwise or not printed), then the median step of
    each, 10 eager steps against 3 windows."""
    from ddl25spring_tpu_torch.benchmarks import DeviceDataset, _nchw, timed_run
    from ddl25spring_tpu_torch.lab.dp_pp import RUN_FLAGS
    from ddl25spring_tpu_torch.models.resnet import ResNet18
    from ddl25spring_tpu_torch.ops.losses import cross_entropy_logits
    from ddl25spring_tpu_torch.parallel.pipeline import fuse_train_steps, make_grad_accum_step
    from ddl25spring_tpu_torch.utils.device import backend_flags
    from ddl25spring_tpu_torch.utils.prng import seeded_generator

    K, dtype = 4, torch.bfloat16
    gens = [seeded_generator(0, 0, m) for m in range(ACCUM_MICRO)]

    def build():
        m = ResNet18(norm="group", dtype=dtype, generator=torch.Generator().manual_seed(13)
                     ).to(dev, memory_format=torch.channels_last)
        opt = torch.optim.SGD(m.parameters(), lr=float(RESNET_LR), momentum=0.9)
        accum = make_grad_accum_step(
            m, lambda mm, raw, *g: cross_entropy_logits(mm(_nchw(raw[0], dtype)), raw[1]),
            opt, ACCUM_MICRO)
        return m, opt, lambda raw: accum(raw, gens)

    with backend_flags(**RUN_FLAGS):
        ds = DeviceDataset(1024, n_train=1024 * K, device=dev)
        ds.cursor = 0
        batches = [ds.feed() for _ in range(K)]
        window = tuple(torch.stack(t) for t in zip(*batches))
        m_seq, _, step = build()
        seq = torch.stack([step(b) for b in batches])
        m_f, opt_f, step_f = build()
        multi = fuse_train_steps(step_f, K, module=m_f, optimizer=opt_f, device=dev)
        fused = multi(window)
        torch.cuda.synchronize()
        bitwise = torch.equal(fused, seq)
        for (name, a), b in zip(m_f.named_parameters(), m_seq.parameters()):
            bitwise = bitwise and torch.equal(a, b)
            _within(f"(d) fused grad-accum {name}", a, b, 2e-2)
        param_err = _max_diff(m_f.parameters(), m_seq.parameters())
        cycle = itertools.cycle(batches).__next__
        _, _, eager_s = timed_run(step, cycle, ACCUM_ITERS, 2, device=dev)
        _, _, fused_s = timed_run(multi, lambda: window, 3, 1, device=dev, k=K)
    check(all(math.isfinite(x) for x in fused.tolist()), f"(d) fused losses {fused.tolist()}")
    times = {"eager": statistics.median(eager_s) * 1e3, "fused": statistics.median(fused_s) * 1e3}
    print(f"  (d) ResNet-18 grad accumulation (1024 = 4 x 256, bf16), fused K = {K} vs 4 eager "
          f"steps: {'bitwise equal' if bitwise else 'NOT bitwise'} (losses max abs diff "
          f"{(fused - seq).abs().max().item():.3g}, parameters {param_err:.3g}); median step "
          f"eager {times['eager']:.3f} ms ({ACCUM_ITERS} steps), fused {times['fused']:.3f} ms "
          "(3 windows, CUDA events between windows)")
    return times


def fedavg_axis_rank(rdv, device):
    """One rank of phase 11 (e): the tutorial_1a ``MnistCnn`` FedAvg round
    over 4 non-IID clients (2,003 synthetic rows, B=100, E=1, lr 0.01,
    dropout masks and orders from CPU generators), its client axis over the
    2-rank gloo world; then, on this rank alone, from the same draws, the
    one-process round over the 4 clients and the one-process form of the
    sharded arithmetic (each rank's block of 2 clients trained apart, the
    weighted sums added, then divided), which runs the card's kernels at
    the sharded round's shapes.  Returns the differences."""
    from ddl25spring_tpu_torch.data.mnist import load_mnist
    from ddl25spring_tpu_torch.fl.horizontal import (
        ClientDraws,
        FedAvgServer,
        local_epochs,
        make_fedavg_round,
    )
    from ddl25spring_tpu_torch.utils.device import backend_flags
    from ddl25spring_tpu_torch.utils.mesh import init_mesh
    from ddl25spring_tpu_torch.utils.prng import client_round_generator

    with backend_flags(**FP32_EXACT), init_mesh(rdv, data=2, stages=1, device=device) as mesh:
        server = FedAvgServer(nr_clients=4, client_fraction=1.0, batch_size=100,
                              nr_local_epochs=1, lr=0.01, iid=False, seed=10,
                              data=load_mnist(n_train=2003, n_test=100), device=mesh.device,
                              generator_device="cpu")
        params, cx, cy, counts = server.params, server.cx, server.cy, server.counts_dev

        def draws():
            gens = [client_round_generator(10, 0, i, "cpu") for i in range(4)]
            d = ClientDraws(server.model, gens, server.counts, server.cx.shape[1], 100,
                            mesh.device)
            memo = {}
            return (lambda e: memo.setdefault(("o", e), d.orders(e)),
                    lambda e, i: memo.setdefault(("m", e, i), d.masks(e, i)))

        sharded = make_fedavg_round(server.model, 0.01, 100, 1, comm=mesh.comm)(
            params, cx, cy, counts, *draws())
        one = make_fedavg_round(server.model, 0.01, 100, 1)(params, cx, cy, counts, *draws())
        orders, masks = draws()
        sums = {n: 0.0 for n in params}
        for b in (slice(0, 2), slice(2, 4)):
            with torch.no_grad():
                client = local_epochs(server.model, params, cx[b], cy[b], counts[b],
                                      lambda e, b=b: orders(e)[b],
                                      lambda e, i, b=b: tuple(m[b] for m in masks(e, i)),
                                      lr=0.01, batch_size=100, nr_epochs=1)
            sums = {n: sums[n] + torch.tensordot(counts[b], t, dims=1) for n, t in client.items()}
        blocks = {n: t / counts.sum() for n, t in sums.items()}
        return {"rank": mesh.rank, "backend": mesh.backend, "device": str(mesh.device),
                "err_blocks": _max_diff(sharded.values(), blocks.values()),
                "err_one": _max_diff(sharded.values(), one.values()),
                "one_vs_blocks": _max_diff(one.values(), blocks.values()),
                "moved": _max_diff(one.values(), params.values()),
                "counts": server.counts.tolist()}


def fedavg_client_axis(dev, ranks):
    """Phase 11 (e): :func:`fedavg_axis_rank` on two ranks sharing the card.
    The sharded round against the one-process form of its own arithmetic
    within 1e-6 (only where the two blocks' sums meet differs), and against
    the one-process round over the 4 clients within 1e-5, the FedAvg band
    against JAX: that round runs its convolutions at twice the batch, and
    cuDNN picks its algorithms by shape (the difference of the two
    one-process forms is printed).  ``ranks``: the world of 2's results
    (:func:`chain_phase`)."""
    for r in ranks:
        check(r["device"].startswith(dev.type) and r["backend"] == "gloo",
              f"(e) rank {r['rank']} on {r['device']} over {r['backend']}")
        check(r["moved"] > 0 and r["err_blocks"] <= FL_AXIS_BAND,
              f"(e) rank {r['rank']}: sharded round vs its one-process form "
              f"{r['err_blocks']:.3g} > {FL_AXIS_BAND} (the round moved the weights by "
              f"{r['moved']:.3g})")
        check(r["err_one"] <= 1e-5, f"(e) rank {r['rank']}: sharded round vs the 4-client "
                                    f"one-process round {r['err_one']:.3g} > 1e-5")
    worst = {k: max(r[k] for r in ranks) for k in ("err_blocks", "err_one", "one_vs_blocks")}
    print(f"  (e) FedAvg client axis over 2 gloo ranks on {ranks[0]['device']}, clients of "
          f"{ranks[0]['counts']} rows: sharded vs its one-process form {worst['err_blocks']:.3g} "
          f"(band {FL_AXIS_BAND}), vs the 4-client one-process round {worst['err_one']:.3g} "
          f"(band 1e-5); the two one-process forms differ by {worst['one_vs_blocks']:.3g}; "
          f"the round moved the weights by up to {ranks[0]['moved']:.3g}")


def fused_refusals(dev):
    """Phase 11 (f): the labs refuse to graph ranks that share the card over
    gloo, before any rank starts."""
    from ddl25spring_tpu_torch.lab import dp_pp, microbatches

    for name, argv, run in (
        ("lab.microbatches --scan-steps 4", ["--scan-steps", "4"], microbatches.main),
        ("lab.dp_pp --workload resnet --pp --ranks 4 --input hbm-scan",
         ["--workload", "resnet", "--pp", "--ranks", "4", "--input", "hbm-scan"], dp_pp.main),
    ):
        try:
            run([*argv, "--device", dev.type])
        except ValueError as e:
            check("host copy" in str(e), f"(f) {name} raised {e}")
            print(f"  (f) {name}: ValueError: {e}")
        else:
            check(False, f"(f) {name} ran instead of raising")


def fused_phase(dev, worlds=None):
    """Phase 11, each sub-phase timed, (e)'s world from :func:`chain_phase`
    (None: spawned here); returns the LLaMA numbers."""
    if worlds is None:
        worlds = {"11 (e)": own_world(fedavg_axis_rank, 2, (dev.type,))}
    from ddl25spring_tpu_torch.parallel.launch import spawn

    t0 = time.perf_counter()
    (llama, lines), = spawn(fused_llama, 1, timeout=SPAWN_TIMEOUT)
    for line in lines:
        print(line)
    print(f"  (a)-(b) LLaMA took {time.perf_counter() - t0:.1f} s", flush=True)
    for name, fn in (("(b) ResNet", resnet_scan_headline), ("(c)", resnet_scan_exactness),
                     ("(d)", grad_accum_fused),
                     ("(e)", lambda d: fedavg_client_axis(d, worlds["11 (e)"])),
                     ("(f)", fused_refusals)):
        t0 = time.perf_counter()
        fn(dev)
        print(f"  {name} took {time.perf_counter() - t0:.1f} s", flush=True)
    return llama


# ---------------------------------------------------------------- phase 12

SPTP_ROWS = 3                   # phase 12: rows per replica, as phases 5 and 7
SPTP_STEPS = 10                 # phase 12 (b): bf16 Adam steps per layout
# name -> (data, second axis, its size, SP mode); (a) in fp32, (b) in bf16
SPTP_EXACT = {"ring 1x4": (1, "seq", 4, "ring"), "ulysses 2x2": (2, "seq", 2, "ulysses"),
              "tp 2x2": (2, "model", 2, None)}
SPTP_SLICE = {"ring": (2, "seq", 2, "ring"), "ulysses": (2, "seq", 2, "ulysses"),
              "tp": (2, "model", 2, None)}
# phase 12 (c): (B, H, L, causal) of the kernels' calls in (b), folded to
# [B H, L, 48]: the ring's own and received blocks, Ulysses and TP over 3 heads
SPTP_KERNEL_CASES = [(3, 6, 128, True), (3, 6, 128, False), (3, 3, 256, True)]


def _sptp_step(layout, world, cfg, seed):
    """The model and train step of ``layout`` on a regrid of ``world``:
    ``LlamaConfig``'s weights from ``seed`` (a TP rank keeps its slices),
    Adam 8e-4, the rows of the data axis."""
    from ddl25spring_tpu_torch.models.llama import Llama, export_params
    from ddl25spring_tpu_torch.parallel import sp, tp

    data, axis, size, mode = layout
    mesh = world.regrid(data, **{axis: size})
    model = Llama(cfg, device=mesh.device, generator=torch.Generator().manual_seed(seed))
    if axis == "model":
        tp.load_tp_params(model, tp.shard_tp_params(export_params(model), size,
                                                    mesh.axis("model").index))
        opt = torch.optim.Adam(model.parameters(), lr=8e-4)
        return mesh, model, tp.make_tp_train_step(model, cfg, opt, mesh, data_axis="data")
    opt = torch.optim.Adam(model.parameters(), lr=8e-4)
    return mesh, model, sp.make_sp_train_step(model, cfg, opt, mesh, data_axis="data", mode=mode)


def sp_tp_rank(rdv, exact_tokens, slice_batches, device):
    """One rank of phase 12's world of 4 ranks on the card (gloo through
    pinned host buffers), which takes each layout in turn
    (``Mesh.regrid``): (a) one fp32 step of each of ``SPTP_EXACT``, its loss
    and synced gradients (a TP rank's are its slices); (b) ``SPTP_STEPS``
    bf16 steps of each of ``SPTP_SLICE``: losses, host time per step to the
    card's idle, comm counts per step, the flash launches of the run (the
    counts set to 0 just before it and read just after) and the rank's
    parameter count."""
    from ddl25spring_tpu_torch.models.llama import export_grads
    from ddl25spring_tpu_torch.ops import flash_attention as fa
    from ddl25spring_tpu_torch.utils.config import LlamaConfig
    from ddl25spring_tpu_torch.utils.device import backend_flags
    from ddl25spring_tpu_torch.utils.mesh import init_mesh

    out = {"exact": {}, "slice": {}}
    with init_mesh(rdv, 1, seq=4, device=device) as world:
        cfg32 = LlamaConfig(dtype="float32", use_flash=True)
        with backend_flags(**FP32_EXACT):
            for name, layout in SPTP_EXACT.items():
                mesh, model, step = _sptp_step(layout, world, cfg32, 7)
                tokens = torch.from_numpy(exact_tokens[:layout[0] * SPTP_ROWS]).long()
                loss = float(step(tokens))
                out["exact"][name] = {"coords": mesh.coords, "loss": loss,
                                      "grads": export_grads(model)}
        cfg = LlamaConfig(dtype="bfloat16", use_flash=True)
        for name, layout in SPTP_SLICE.items():
            mesh, model, step = _sptp_step(layout, world, cfg, 0)
            r = {"coords": mesh.coords, "device": str(mesh.device), "backend": mesh.backend,
                 "n_params": sum(p.numel() for p in model.parameters()), "losses": [],
                 "step_s": [], "comm": []}
            world.comm.take_stats()
            fa.reset_launches()
            for b in slice_batches:
                t0 = time.perf_counter()
                loss = step(torch.from_numpy(b).long())
                if mesh.device.type == "cuda":
                    torch.cuda.synchronize(mesh.device)
                r["step_s"].append(time.perf_counter() - t0)
                r["comm"].append(world.comm.take_stats())
                r["losses"].append(float(loss))
            r["launches"] = dict(fa.LAUNCHES)
            r["by_variant"] = {n: dict(c) for n, c in fa.LAUNCHES_BY_VARIANT.items()}
            out["slice"][name] = r
    return out


def sp_tp_launches(name, index, layers=6):
    """Flash launches of each kernel per rank per step: index ``s`` of the
    flash ring skips the blocks it cannot see, so runs ``1 + s`` forwards
    (and as many dq and dk/dv) per layer; Ulysses and TP run one."""
    return layers * (1 + index if name == "ring" else 1)


def sp_tp_staged_bytes(name, n_params, n=2, rows=SPTP_ROWS, L=256, D=288, layers=6):
    """Bytes one rank stages through the host per bf16 step of 2 x ``n``
    (every staged tensor counts twice, to the host and back): the fp32
    gradients and the loss averaged, plus, SP: the one-token target hop
    (int64) and per layer, forward and backward, the ring's ``n - 1`` hops
    of k and v, or Ulysses' all-to-alls of q/k/v and of the output (each
    ``[rows, L/n, D]`` bf16); TP: per layer two all-reduces forward
    (``reduce_out``) and two backward (``copy_in``) of ``[rows, L, D]`` bf16,
    one more each for the vocab-sharded embedding and head, and the loss's
    all-gather of ``[rows, L-1]`` fp32 log-sum-exps and sum of picks."""
    common = 2 * 4 * n_params + 2 * 4
    if name == "tp":
        act, lse = rows * L * D * 2, rows * (L - 1) * 4
        return common + (4 * layers + 2) * 2 * act + (1 + n) * lse + 2 * lse
    blk = rows * (L // n) * D * 2
    per_layer = 2 * (n - 1) * 2 * 2 * blk if name == "ring" else 2 * (3 + 1) * 2 * blk
    return common + 2 * 8 * rows + layers * per_layer


def sp_tp_exactness(ranks, dev):
    """Phase 12 (a): each fp32 layout against the single-process step on its
    batch from the same weights: loss rtol 1e-5, gradients atol 2e-4 + rtol
    2e-3 (phase 7 (a)'s bands); a TP replica's slices joined first."""
    from ddl25spring_tpu_torch.parallel import tp
    from ddl25spring_tpu_torch.parallel.bucketing import flatten
    from ddl25spring_tpu_torch.utils.config import LlamaConfig

    cfg = LlamaConfig(dtype="float32", use_flash=True)
    tokens = _token_batches(cfg, 2 * SPTP_ROWS, 1, seed=17)[0]
    for name, (data, axis, size, _) in SPTP_EXACT.items():
        want_losses, want_grads = _single_process(cfg, dev, 7, [tokens[:data * SPTP_ROWS]])
        got = [r["exact"][name] for r in ranks]
        for r in got:
            check(excess(r["loss"], want_losses[0], (0.0, 1e-5)) <= 0,
                  f"(a) {name}: loss {r['loss']} vs single process {want_losses[0]}")
        replica0 = [r for r in got if r["coords"][0] == 0]
        grads = (tp.merge_tp_params([r["grads"] for r in replica0]) if axis == "model"
                 else replica0[0]["grads"])
        err = 0.0
        for (path, a), (_, b) in zip(flatten(grads), flatten(want_grads)):
            e = excess(a, b, (2e-4, 2e-3))
            check(e <= 0, f"(a) {name}: grad {path} off the single process by {e:.3g} "
                          "past tolerance")
            err = max(err, max_err(torch.from_numpy(a), torch.from_numpy(b)))
        print(f"  (a) fp32 {name} ({data} x {size} {axis}): loss {got[0]['loss']:.6f} vs "
              f"single process {want_losses[0]:.6f}; grads max abs err {err:.2e}")


def sp_tp_slices(ranks):
    """Phase 12 (b): the bf16 layouts' losses, launches, staged bytes, step
    time and exchange seconds."""
    out = {}
    for name in SPTP_SLICE:
        runs = [r["slice"][name] for r in ranks]
        losses = runs[0]["losses"]
        check(all(r["losses"] == losses for r in runs), f"(b) {name}: the ranks' losses differ")
        check(len(losses) == SPTP_STEPS and all(math.isfinite(x) for x in losses),
              f"(b) {name}: losses not all finite: {losses}")
        check(abs(losses[0] - math.log(4096)) < 1.0,
              f"(b) {name}: first loss {losses[0]:.3f} far from ln(vocab) {math.log(4096):.3f}")
        first, last = statistics.mean(losses[:3]), statistics.mean(losses[-3:])
        check(last < first,
              f"(b) {name}: loss did not fall: first 3 {first:.4f}, last 3 {last:.4f}")
        out[name] = []
        for r in runs:
            check(r["device"].startswith("cuda"),
                  f"(b) {name}: rank {r['coords']} on {r['device']}")
            n = sp_tp_launches(name, r["coords"][1]) * SPTP_STEPS
            want = {k: n for k in ("fwd", "dq", "dkv")}
            check(r["launches"] == want, f"(b) {name}: rank {r['coords']} launches "
                                         f"{r['launches']} != {want}")
            for k in want:
                check(r["by_variant"][k]["wgmma"] == n,
                      f"(b) {name}: rank {r['coords']} {k} by variant {r['by_variant'][k]}")
            staged = {c["bytes_staged"] for c in r["comm"]}
            expect = sp_tp_staged_bytes(name, r["n_params"])
            check(staged == {expect}, f"(b) {name}: rank {r['coords']} staged {staged} B per "
                                      f"step, the shapes give {expect}")
            out[name].append(r["launches"])
        steady = [max(r["step_s"][i] for r in runs) for i in range(1, SPTP_STEPS)]
        step_ms = statistics.median(steady) * 1e3
        print(f"  (b) {name}: backend {runs[0]['backend']}, devices "
              f"{sorted({r['device'] for r in runs})}; loss {first:.4f} (first 3) -> "
              f"{last:.4f} (last 3); flash launches per rank per step "
              f"{[sp_tp_launches(name, r['coords'][1]) for r in runs]} each kernel, all wgmma; "
              f"staged per rank per step "
              f"{[sorted({c['bytes_staged'] for c in r['comm']}) for r in runs]} B, the shapes "
              f"give {[sp_tp_staged_bytes(name, r['n_params']) for r in runs]}")
        exch = {k: [statistics.median(c[k] for c in r["comm"][1:]) * 1e3 for r in runs]
                for k in ("send_s", "recv_wait_s", "allreduce_s", "collective_s")}
        print(f"  (b) {name}: step median {step_ms:.3f} ms (slowest rank, steps "
              f"1..{SPTP_STEPS - 1}, host clock), "
              f"{2 * SPTP_ROWS * 256 / (step_ms / 1e3):.1f} tokens/s; exchange ms per "
              "step per rank (median): " + "; ".join(
                  f"{k} {[round(x, 3) for x in v]}" for k, v in exch.items()))
    return out


def sp_tp_kernel_checks(dev):
    """Phase 12 (c): each bf16 kernel against its plain version at
    ``SPTP_KERNEL_CASES``, on the ``wgmma`` variant (:func:`kernel_case`), and
    the autograd Functions on the card against the CPU's plain path at the
    same shapes (:func:`autograd_case`), ``flash_attention_with_lse`` with a
    nonzero lse cotangent as the ring's merge gives it and
    ``flash_attention`` as Ulysses and TP call it; the bf16 band throughout.
    Returns the kernels' max abs errors over the cases."""
    from ddl25spring_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator().manual_seed(12)
    errs = {"fwd": 0.0, "dq": 0.0, "dkv": 0.0}
    for B, H, L, causal in SPTP_KERNEL_CASES:
        e = kernel_case(fa, gen, dev, B * H, L, L, 48, torch.bfloat16, causal)
        errs = {n: max(errs[n], e[n]) for n in errs}
        for with_lse in (True, False):
            autograd_case(fa, gen, dev, (B, L, H, 48), torch.bfloat16, causal, with_lse)
    return errs


def sp_tp_inputs(dev) -> tuple:
    """Phase 12's world of 4 (:func:`sp_tp_rank`)."""
    import numpy as np

    from ddl25spring_tpu_torch.data.tinystories import TinyStories
    from ddl25spring_tpu_torch.data.tokenizer import get_tokenizer
    from ddl25spring_tpu_torch.utils.config import LlamaConfig

    exact = _token_batches(LlamaConfig(), 2 * SPTP_ROWS, 1, seed=17)[0]
    ds = iter(TinyStories(get_tokenizer(), batch_size=2 * SPTP_ROWS, seq_l=256, seed=0))
    batches = [np.asarray(next(ds)) for _ in range(SPTP_STEPS)]
    return exact, batches, dev.type


def sp_tp_phase(dev, ranks=None, kernel_times=None):
    """Phase 12: sequence and tensor parallelism on the card, each sub-phase
    timed, the world of 4's results from :func:`chain_phase` and (c)'s
    kernel times from phase 10 (f)'s process (None: each made here, the
    phase run alone); returns each layout's flash launches per rank over
    the run."""
    if ranks is None:
        ranks = own_world(sp_tp_rank, 4, sp_tp_inputs(dev))
    if kernel_times is None:
        (kernel_times,) = own_world(kernel_times_at, 1, (
            [(B, H, L, torch.bfloat16, c) for B, H, L, c in SPTP_KERNEL_CASES], "12 (c)"))
    print(f"  4 ranks, backend {sorted({r['slice']['tp']['backend'] for r in ranks})}")
    t0 = time.perf_counter()
    sp_tp_exactness(ranks, dev)
    launches = sp_tp_slices(ranks)
    print(f"  (a)-(b) checks took {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    errs = sp_tp_kernel_checks(dev)
    times, lines = kernel_times
    for line in lines:
        print(line)
    print(f"  (c) took {time.perf_counter() - t0:.1f} s", flush=True)
    return {"launches": launches, "times": times, "max_abs_err": errs}


# ---------------------------------------------------------------- phase 13

MOE_STEPS = 5                   # (a): bf16 Adam steps per routing
MOE_LAYERS = 2                  # (a), (b): the MoE (and dense) LLaMA's depth; (c) keeps 6
MOE_PROFILED = 5                # (a): steps under torch.profiler
MOE_EP_TOKENS = 4 * 768         # (b): the EP x DP layer, 768 tokens per shard
MOE_EP_CFS = (0.5, 1.0)         # (b): its capacity factors: every bucket fills at 0.5;
                                # at 1.0 some overflow and others do not, so the
                                # kept counts depend on the routing
MOE_PIPE = (2, 3, 3)            # (c): data, stages, microbatches (one row each)
MOE_PIPE_STEPS = 5              # (c): bf16 gpipe steps
FLIP_GAP = 1e-5                 # a routing flip is a near-tie below this top-two gap


def moe_cfg(dtype="bfloat16", top_k=1, n_layers=6):
    """Phase 13's configuration: ``LlamaConfig()`` at full width with 4
    experts, the flash kernels and the config's own capacity factor (1.25)
    and aux weight (0.01); ``n_layers`` deep (13 (a) and (b) run
    ``MOE_LAYERS``)."""
    from ddl25spring_tpu_torch.utils.config import LlamaConfig

    return LlamaConfig(dtype=dtype, use_flash=True, n_experts=4, moe_top_k=top_k,
                       n_layers=n_layers)


def _moe_loss(model, tokens, cfg, moe_fn=None):
    """``causal_lm_loss + w aux`` and ``aux`` (``moe_fn`` to every block)."""
    from ddl25spring_tpu_torch.models.llama import llama_forward_with_aux
    from ddl25spring_tpu_torch.ops.losses import causal_lm_loss

    kw = {} if moe_fn is None else {"moe_fn": moe_fn}
    logits, aux = llama_forward_with_aux(model, tokens, cfg, **kw)
    loss = causal_lm_loss(logits, tokens)
    return (loss + cfg.moe_aux_weight * aux if cfg.n_experts else loss), aux


def _moe_step(model, cfg):
    """The single-process Adam step (8e-4) on ``_moe_loss``: ``(loss, aux)``."""
    opt = torch.optim.Adam(model.parameters(), lr=8e-4)

    def step(tokens):
        opt.zero_grad(set_to_none=True)
        loss, aux = _moe_loss(model, tokens, cfg)
        loss.backward()
        opt.step()
        return loss.detach(), torch.as_tensor(aux).detach()

    return step


def _routing_recorder(cfg, log):
    """A ``moe_fn`` that runs ``moe_ffn`` at the config's capacity and top-k
    and logs, per call, the float32 router logits and the kept counts."""
    from ddl25spring_tpu_torch.parallel import ep

    def moe_fn(mp, flat):
        y, aux, st = ep.moe_ffn(mp, flat, cfg.capacity_factor, return_stats=True,
                                top_k=cfg.moe_top_k)
        log.append({"logits": ep.router_logits(mp["router"], flat).detach(),
                    "kept": float(st["kept"].sum()), "assigned": st["assigned"]})
        return y, aux

    return moe_fn


def moe_profile(dev, step, tokens, slots):
    """Device busy per step over ``MOE_PROFILED`` steps (torch.profiler, with
    shapes), and its shares: attention (the flash kernels), the dispatch
    and combine products (an ``mm`` with a dim of ``slots = E C``, forward
    and backward) and the expert GEMMs (``bmm``, batched over the experts)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        for _ in range(MOE_PROFILED):
            step(tokens)
        torch.cuda.synchronize()
    avgs = prof.key_averages(group_by_input_shape=True)
    kernels = [e for e in avgs
               if e.device_type == torch.autograd.DeviceType.CUDA and not e.is_user_annotation]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3 / MOE_PROFILED
    check(busy > 0, "(a) the profiler recorded no device time")
    share = {"attention": sum(e.self_device_time_total for e in kernels if "flash_" in e.key),
             "dispatch/combine": 0.0, "experts": 0.0}
    for e in avgs:
        if e.device_type != torch.autograd.DeviceType.CPU or e.key not in ("aten::mm", "aten::bmm"):
            continue
        dims = {d for shape in (e.input_shapes or []) for d in shape}
        if e.key == "aten::bmm":
            share["experts"] += e.self_device_time_total
        elif slots in dims:
            share["dispatch/combine"] += e.self_device_time_total
    return busy, {k: v / 1e3 / MOE_PROFILED / busy for k, v in share.items()}


def _moe_flips(card_logs, host_logs, top_k):
    """Tokens whose ordered expert choices (first, second, ...) differ
    between the card's and the CPU's router logits, over every layer, and at
    each the CPU's smallest gap between neighbouring probs among its top
    ``k + 1``: a near-tie is what may flip."""
    flips, gaps = 0, []
    for c, h in zip(card_logs, host_logs):
        pc, ph = torch.softmax(c["logits"].cpu(), -1), torch.softmax(h["logits"], -1)
        diff = (pc.topk(top_k, -1).indices != ph.topk(top_k, -1).indices).any(-1)
        flips += int(diff.sum())
        top = ph.topk(top_k + 1, -1).values
        gaps += (top[:, :-1] - top[:, 1:]).min(-1).values[diff].tolist()
    return flips, gaps


def moe_single(dev):
    """Phase 13 (a): MoE LLaMA in one process, top-1 and top-2."""
    import numpy as np

    from ddl25spring_tpu_torch.data.tinystories import TinyStories
    from ddl25spring_tpu_torch.data.tokenizer import get_tokenizer
    from ddl25spring_tpu_torch.models.llama import Llama, export_grads
    from ddl25spring_tpu_torch.ops import flash_attention as fa
    from ddl25spring_tpu_torch.parallel import ep
    from ddl25spring_tpu_torch.parallel.bucketing import flatten
    from ddl25spring_tpu_torch.utils.config import LlamaConfig
    from ddl25spring_tpu_torch.utils.device import backend_flags

    ds = iter(TinyStories(get_tokenizer(), batch_size=SPTP_ROWS, seq_l=256, seed=0))
    batches = [torch.from_numpy(np.asarray(next(ds))).long().to(dev) for _ in range(MOE_STEPS)]
    T = SPTP_ROWS * 256
    out = {"launches": {}}
    for name, cfg in (("top1", moe_cfg(top_k=1, n_layers=MOE_LAYERS)),
                      ("top2", moe_cfg(top_k=2, n_layers=MOE_LAYERS)),
                      ("dense", LlamaConfig(use_flash=True, n_layers=MOE_LAYERS))):
        model = Llama(cfg, device=dev, generator=torch.Generator().manual_seed(0))
        step = _moe_step(model, cfg)
        losses, auxes, step_s = [], [], []
        fa.reset_launches()
        for b in batches:
            t0 = time.perf_counter()
            loss, aux = step(b)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
            losses.append(float(loss))
            auxes.append(float(aux))
        launches = dict(fa.LAUNCHES)
        by_variant = {n: dict(c) for n, c in fa.LAUNCHES_BY_VARIANT.items()}
        check(all(math.isfinite(x) for x in losses), f"(a) {name}: losses {losses}")
        start = math.log(cfg.vocab_size) + cfg.moe_aux_weight * auxes[0]
        check(abs(losses[0] - start) < 1.0,
              f"(a) {name}: first loss {losses[0]:.3f} far from ln(vocab) + w aux {start:.3f}")
        first, last = statistics.mean(losses[:3]), statistics.mean(losses[-3:])
        check(last < first, f"(a) {name}: loss did not fall: {first:.4f} -> {last:.4f}")
        want = {k: cfg.n_layers * MOE_STEPS for k in ("fwd", "dq", "dkv")}
        check(launches == want, f"(a) {name}: launches {launches} != {want}")
        for k in want:
            check(by_variant[k]["wgmma"] == cfg.n_layers * MOE_STEPS,
                  f"(a) {name}: {k} launches by variant {by_variant[k]}")
        out["launches"][name] = {k: v // MOE_STEPS for k, v in launches.items()}
        step_ms = statistics.median(step_s[1:]) * 1e3
        slots = ep.capacity(T, cfg.capacity_factor, cfg.moe_top_k, 4) * 4
        busy, shares = moe_profile(dev, step, batches[-1], slots)
        line = (f"  (a) {name}: loss {first:.4f} (first 3) -> {last:.4f} (last 3), first "
                f"{losses[0]:.4f} vs ln(4096) + w aux {start:.4f}; flash launches per step "
                f"{out['launches'][name]}, all wgmma; step median {step_ms:.3f} ms (host clock "
                f"to the card's idle, steps 1..{MOE_STEPS - 1}), busy {busy:.3f} ms, idle share "
                f"{1 - busy / step_ms:.3f}; busy shares " + ", ".join(
                    f"{k} {v:.3f}" for k, v in shares.items()))
        out[name] = {"step_ms": step_ms, "busy_ms": busy, "shares": shares}
        if cfg.n_experts:
            log = []
            with torch.no_grad():
                _moe_loss(model, batches[-1], cfg, _routing_recorder(cfg, log))
            line += "; kept/assigned per layer (last batch) " + " ".join(
                f"{int(r['kept'])}/{int(r['assigned'])}" for r in log)
        print(line, flush=True)
        del model, step

    # fp32, TF32 off: the card against the CPU port from the same weights
    tokens = torch.from_numpy(_token_batches(moe_cfg(), SPTP_ROWS, 1, seed=21)[0]).long()
    for top_k in (1, 2):
        cfg = moe_cfg("float32", top_k, MOE_LAYERS)
        got = {}
        for key, where in (("card", dev), ("host", torch.device("cpu"))):
            model = Llama(cfg, device=where, generator=torch.Generator().manual_seed(7))
            with backend_flags(**FP32_EXACT):
                loss, _ = _moe_loss(model, tokens.to(where), cfg)
                loss.backward()
                log = []
                with torch.no_grad():
                    _moe_loss(model, tokens.to(where), cfg, _routing_recorder(cfg, log))
            got[key] = (loss.item(), export_grads(model), log)
        flips, gaps = _moe_flips(got["card"][2], got["host"][2], top_k)
        print(f"  (a) fp32 top-{top_k}: routing flips card vs CPU {flips} of "
              f"{T * cfg.n_layers} token choices; top-two gaps at them {gaps}")
        check(all(g < FLIP_GAP for g in gaps),
              f"(a) fp32 top-{top_k}: a routing flip at a prob gap of {max(gaps or [0]):.3g} "
              f">= {FLIP_GAP}, not a near-tie")
        check(excess(got["card"][0], got["host"][0], (0.0, 1e-5)) <= 0,
              f"(a) fp32 top-{top_k}: loss {got['card'][0]} vs CPU {got['host'][0]}")
        err = 0.0
        for (path, a), (_, b) in zip(flatten(got["card"][1]), flatten(got["host"][1])):
            e = excess(a, b, (2e-4, 2e-3))
            check(e <= 0, f"(a) fp32 top-{top_k}: grad {path} off the CPU by {e:.3g}")
            err = max(err, max_err(torch.from_numpy(a), torch.from_numpy(b)))
        print(f"  (a) fp32 top-{top_k}: loss {got['card'][0]:.7f} card vs {got['host'][0]:.7f} "
              f"CPU; grads max abs err {err:.2e}")
    return out


def _moe_composite_fn(cfg, L, shards):
    """The per-shard-dispatch ``moe_fn`` of the single-process oracle: a
    block's ``[B L, D]`` tokens dispatched in ``shards`` groups of positions
    (``[B, L/shards]`` each, an SP rank's local tokens), the aux their mean."""
    from ddl25spring_tpu_torch.parallel import ep

    def moe_fn(mp, flat):
        B, Ll = flat.shape[0] // L, L // shards
        parts = flat.view(B, shards, Ll, -1)
        ys, auxes = zip(*(ep.moe_ffn(mp, parts[:, s].reshape(B * Ll, -1), cfg.capacity_factor,
                                     top_k=cfg.moe_top_k) for s in range(shards)))
        y = torch.stack([v.view(B, Ll, -1) for v in ys], 1).reshape(B * L, -1)
        return y, sum(auxes) / shards

    return moe_fn


def moe_oracle(cfg, dev, seed, tokens, data, shards):
    """The single-process fp32 loss and gradients a 2 x 2 MoE step must give:
    the mean over the ``data`` row blocks of ``causal_lm_loss + w aux``, each
    block's MoE dispatched per seq shard (``shards`` groups)."""
    from ddl25spring_tpu_torch.models.llama import Llama, export_grads

    model = Llama(cfg, device=dev, generator=torch.Generator().manual_seed(seed))
    tokens = tokens.to(dev)
    fn = _moe_composite_fn(cfg, tokens.shape[1], shards)
    total = sum(_moe_loss(model, rows, cfg, fn)[0] for rows in tokens.chunk(data)) / data
    total.backward()
    return total.item(), export_grads(model)


def _ep_inputs(dev):
    from ddl25spring_tpu_torch.parallel import ep

    gen = torch.Generator().manual_seed(31)
    p = ep.init_moe_params(gen, 288, 1152, 4, dev)
    return p, torch.randn(MOE_EP_TOKENS, 288, generator=gen).to(dev)


def moe_world_rank(rdv, exact_tokens, slice_batches, device):
    """One rank of phase 13 (b)'s world of 4 on the card: the EP x DP layer
    (2 x 2, top-2, capacities ``MOE_EP_CFS``, fp32); one fp32 MoE step of TP, the ring and
    Ulysses on 2 x 2; ``SPTP_STEPS`` bf16 MoE steps of each (as
    :func:`sp_tp_rank`)."""
    from ddl25spring_tpu_torch.models.llama import export_grads
    from ddl25spring_tpu_torch.ops import flash_attention as fa
    from ddl25spring_tpu_torch.parallel import ep
    from ddl25spring_tpu_torch.utils.device import backend_flags
    from ddl25spring_tpu_torch.utils.mesh import init_mesh

    out = {"exact": {}, "slice": {}}
    with init_mesh(rdv, 1, seq=4, device=device) as world:
        with backend_flags(**FP32_EXACT):
            mesh = world.regrid(2, expert=2)
            axis = mesh.axis("expert")
            p, x = _ep_inputs(mesh.device)
            out["ep"] = {}
            for cf in MOE_EP_CFS:
                f = ep.make_ep_moe_fn(mesh, capacity_factor=cf, return_stats=True,
                                      data_axis="data", top_k=2)
                with torch.no_grad():
                    y, aux, stats = f(ep.shard_moe_params(p, 2, axis.index, mesh.device), x)
                out["ep"][cf] = {"y": y.cpu() if rdv.rank == 0 else None, "aux": float(aux),
                                 "kept": stats["kept"].cpu(), "assigned": stats["assigned"]}
            for name, layout in SPTP_SLICE.items():
                mesh, model, step = _sptp_step(layout, world,
                                               moe_cfg("float32", n_layers=MOE_LAYERS), 7)
                tokens = torch.from_numpy(exact_tokens[:layout[0] * SPTP_ROWS]).long()
                out["exact"][name] = {"coords": mesh.coords, "loss": float(step(tokens)),
                                      "grads": export_grads(model)}
        for name, layout in SPTP_SLICE.items():
            mesh, model, step = _sptp_step(layout, world, moe_cfg(n_layers=MOE_LAYERS), 0)
            r = {"coords": mesh.coords, "device": str(mesh.device), "backend": mesh.backend,
                 "n_params": sum(p.numel() for p in model.parameters()), "losses": [],
                 "step_s": [], "comm": []}
            world.comm.take_stats()
            fa.reset_launches()
            for b in slice_batches:
                t0 = time.perf_counter()
                loss = step(torch.from_numpy(b).long())
                if mesh.device.type == "cuda":
                    torch.cuda.synchronize(mesh.device)
                r["step_s"].append(time.perf_counter() - t0)
                r["comm"].append(world.comm.take_stats())
                r["losses"].append(float(loss))
            r["launches"] = dict(fa.LAUNCHES)
            r["by_variant"] = {n: dict(c) for n, c in fa.LAUNCHES_BY_VARIANT.items()}
            out["slice"][name] = r
    return out


def moe_staged_bytes(name, n_params, top_k=1, rows=SPTP_ROWS, L=256, layers=MOE_LAYERS):
    """Bytes a MoE rank stages per bf16 step of 2 x 2: SP's as the dense
    count (each rank dispatches its own tokens, with no collective); TP's
    dense count plus, per layer in the backward, the gates' ``copy_in``
    (``[rows L, top_k]`` fp32); the MoE input's ``copy_in`` and output's
    ``reduce_out`` take the places of the dense FFN's."""
    extra = layers * 2 * rows * L * top_k * 4 if name == "tp" else 0
    return sp_tp_staged_bytes(name, n_params, layers=layers) + extra


def moe_world_checks(ranks, dev):
    """Phase 13 (b): the EP layer against ``moe_ffn`` per shard group, the fp32
    steps against their single-process oracles, the bf16 runs."""
    from ddl25spring_tpu_torch.parallel import ep, tp
    from ddl25spring_tpu_torch.parallel.bucketing import flatten

    p, x = _ep_inputs(dev)
    for cf in MOE_EP_CFS:
        ys, kept = [], torch.zeros(4)
        with torch.no_grad():
            for shard in x.chunk(4):
                y, _, st = ep.moe_ffn(p, shard, cf, return_stats=True, top_k=2)
                ys.append(y)
                kept += st["kept"].cpu()
        got = ranks[0]["ep"][cf]
        err = max_err(got["y"], torch.cat(ys).cpu())
        check(err <= 1e-5, f"(b) EP x DP layer, capacity {cf}: output off moe_ffn per shard "
                           f"group by {err:.3g}")
        for r in ranks:
            check(torch.equal(r["ep"][cf]["kept"], kept),
                  f"(b) EP x DP layer, capacity {cf}: kept {r['ep'][cf]['kept'].tolist()} "
                  f"vs {kept.tolist()}")
        dropped = got["assigned"] - float(kept.sum())
        check(dropped > 0, f"(b) EP x DP layer: capacity {cf} dropped nothing")
        full = 4 * ep.capacity(MOE_EP_TOKENS // 4, cf, 2, 4)
        check(cf != MOE_EP_CFS[-1] or bool((kept < full).any()),
              f"(b) EP x DP layer: every bucket filled at capacity {cf}, so the kept "
              "counts cannot tell routings apart")
        print(f"  (b) EP x DP 2 x 2 layer, top-2, capacity {cf}, {MOE_EP_TOKENS} tokens: "
              f"max abs err {err:.2e} vs moe_ffn per shard group; kept {kept.tolist()} of "
              f"{full} per expert (= the oracle's on every rank), {int(dropped)} of "
              f"{int(got['assigned'])} slots dropped; aux {got['aux']:.5f}")

    cfg = moe_cfg("float32", n_layers=MOE_LAYERS)
    tokens = torch.from_numpy(_token_batches(cfg, 2 * SPTP_ROWS, 1, seed=17)[0]).long()
    for name, (data, axis, size, mode) in SPTP_SLICE.items():
        want_loss, want_grads = moe_oracle(cfg, dev, 7, tokens[:data * SPTP_ROWS], data,
                                           1 if axis == "model" else size)
        res = [r["exact"][name] for r in ranks]
        for r in res:
            check(excess(r["loss"], want_loss, (0.0, 1e-5)) <= 0,
                  f"(b) fp32 {name}: loss {r['loss']} vs oracle {want_loss}")
        replica0 = [r for r in res if r["coords"][0] == 0]
        grads = (tp.merge_tp_params([r["grads"] for r in replica0]) if axis == "model"
                 else replica0[0]["grads"])
        err = 0.0
        for (path, a), (_, b) in zip(flatten(grads), flatten(want_grads)):
            e = excess(a, b, (2e-4, 2e-3))
            check(e <= 0, f"(b) fp32 {name}: grad {path} off the oracle by {e:.3g}")
            err = max(err, max_err(torch.from_numpy(a), torch.from_numpy(b)))
        print(f"  (b) fp32 MoE {name} 2 x 2: loss {res[0]['loss']:.6f} vs single-process "
              f"oracle {want_loss:.6f}; grads max abs err {err:.2e}")

    out = {}
    for name in SPTP_SLICE:
        runs = [r["slice"][name] for r in ranks]
        losses = runs[0]["losses"]
        check(all(r["losses"] == losses for r in runs), f"(b) {name}: the ranks' losses differ")
        check(all(math.isfinite(v) for v in losses), f"(b) {name}: losses {losses}")
        first, last = statistics.mean(losses[:3]), statistics.mean(losses[-3:])
        check(last < first, f"(b) {name}: loss did not fall: {first:.4f} -> {last:.4f}")
        staged, expect = [], []
        for r in runs:
            n = sp_tp_launches(name, r["coords"][1], MOE_LAYERS) * SPTP_STEPS
            check(r["launches"] == {k: n for k in ("fwd", "dq", "dkv")},
                  f"(b) {name}: rank {r['coords']} launches {r['launches']}")
            check(all(r["by_variant"][k]["wgmma"] == n for k in ("fwd", "dq", "dkv")),
                  f"(b) {name}: rank {r['coords']} launches by variant {r['by_variant']}")
            staged.append(sorted({c["bytes_staged"] for c in r["comm"]}))
            expect.append(moe_staged_bytes(name, r["n_params"]))
            check(staged[-1] == [expect[-1]], f"(b) {name}: rank {r['coords']} staged "
                                              f"{staged[-1]} B per step, the shapes give "
                                              f"{expect[-1]}")
        steady = [max(r["step_s"][i] for r in runs) for i in range(1, SPTP_STEPS)]
        step_ms = statistics.median(steady) * 1e3
        exch = {k: [round(statistics.median(c[k] for c in r["comm"][1:]) * 1e3, 3)
                    for r in runs] for k in ("send_s", "recv_wait_s", "allreduce_s",
                                             "collective_s")}
        out[name] = step_ms
        print(f"  (b) bf16 MoE {name} 2 x 2: loss {first:.4f} (first 3) -> {last:.4f} "
              f"(last 3); step median {step_ms:.3f} ms (slowest rank, steps "
              f"1..{SPTP_STEPS - 1}, host clock); staged per rank per step {staged} B, the "
              f"shapes give {expect}; exchange ms per step per rank (median): "
              + "; ".join(f"{k} {v}" for k, v in exch.items()))
    return out


def moe_pipe_rank(rdv, exact_tokens, batches, device):
    """One rank of phase 13 (c)'s 2 x 3 world: one fp32 step of every
    schedule (its stage's gradients, the loss on the last stage), then
    ``MOE_PIPE_STEPS`` bf16 gpipe steps."""
    from ddl25spring_tpu_torch.models.llama import Llama, export_grads, export_params
    from ddl25spring_tpu_torch.parallel.pipeline import (
        make_pipeline_train_step,
        shard_staged_params,
    )
    from ddl25spring_tpu_torch.utils.device import backend_flags
    from ddl25spring_tpu_torch.utils.mesh import init_mesh

    D, S, M = MOE_PIPE
    out = {"exact": {}}
    # the weights are float32 whatever the compute dtype: one draw serves both
    params = export_params(Llama(moe_cfg(), device="cpu",
                                 generator=torch.Generator().manual_seed(7)))
    with init_mesh(rdv, D, stages=S, device=device) as mesh:
        for dtype in ("float32", "bfloat16"):
            cfg = moe_cfg(dtype)
            for schedule in (SCHED if dtype == "float32" else ("gpipe",)):
                V = _chunks_of(schedule)
                stage = shard_staged_params(params, cfg, mesh, num_chunks=V)
                step = make_pipeline_train_step(
                    stage, cfg, torch.optim.Adam(stage.parameters(), lr=8e-4), mesh, M,
                    schedule, num_chunks=V)
                if dtype == "float32":
                    with backend_flags(**FP32_EXACT):
                        loss = step(torch.from_numpy(exact_tokens).long())
                    out["exact"][schedule] = (None if loss is None else float(loss),
                                              export_grads(stage))
                    continue
                losses, step_s = [], []
                for b in batches:
                    t0 = time.perf_counter()
                    loss = step(torch.from_numpy(b).long())
                    if mesh.device.type == "cuda":
                        torch.cuda.synchronize(mesh.device)
                    step_s.append(time.perf_counter() - t0)
                    losses.append(None if loss is None else float(loss))
                out["slice"] = {"losses": losses, "step_s": step_s}
        out["coords"] = mesh.coords
    return out


def moe_pipe_checks(ranks, dev, exact_tokens):
    """Phase 13 (c): every schedule's fp32 step against the serial oracle (the
    mean over the ``M D`` one-row microbatches of ``causal_lm_loss + w
    aux``), then the bf16 gpipe run."""
    from ddl25spring_tpu_torch.models.llama import Llama, export_grads, merge_stage_exports
    from ddl25spring_tpu_torch.parallel.bucketing import flatten

    D, S, M = MOE_PIPE
    cfg = moe_cfg("float32")
    model = Llama(cfg, device=dev, generator=torch.Generator().manual_seed(7))
    tokens = torch.from_numpy(exact_tokens).long().to(dev)
    groups = tokens.view(M * D, -1, tokens.shape[1])
    total = sum(_moe_loss(model, g, cfg)[0] for g in groups) / (M * D)
    total.backward()
    want_loss, want_grads = total.item(), export_grads(model)
    last = [r for r in ranks if r["coords"][1] == S - 1]
    replica0 = sorted((r for r in ranks if r["coords"][0] == 0), key=lambda r: r["coords"][1])
    for schedule in SCHED:
        losses = [r["exact"][schedule][0] for r in last]
        check(all(v == losses[0] for v in losses), f"(c) {schedule}: the replicas' losses differ")
        check(excess(losses[0], want_loss, (0.0, 1e-5)) <= 0,
              f"(c) fp32 {schedule}: loss {losses[0]} vs serial {want_loss}")
        grads = merge_stage_exports([r["exact"][schedule][1] for r in replica0],
                                    num_chunks=_chunks_of(schedule))
        err = 0.0
        for (path, a), (_, b) in zip(flatten(grads), flatten(want_grads)):
            e = excess(a, b, (2e-4, 2e-3))
            check(e <= 0, f"(c) fp32 {schedule}: grad {path} off the serial oracle by {e:.3g}")
            err = max(err, max_err(torch.from_numpy(a), torch.from_numpy(b)))
        print(f"  (c) fp32 MoE {schedule} 2 x 3: loss {losses[0]:.6f} vs serial {want_loss:.6f}; "
              f"grads max abs err {err:.2e}")
    losses = [r["slice"]["losses"] for r in last][0]
    check(all(v is not None and math.isfinite(v) for v in losses), f"(c) bf16 losses {losses}")
    check(losses[-1] < losses[0], f"(c) bf16 gpipe: loss did not fall: {losses}")
    steady = [max(r["slice"]["step_s"][i] for r in ranks) for i in range(1, MOE_PIPE_STEPS)]
    step_ms = statistics.median(steady) * 1e3
    print(f"  (c) bf16 MoE gpipe 2 x 3: losses {[round(v, 4) for v in losses]}; step median "
          f"{step_ms:.3f} ms (slowest rank, steps 1..{MOE_PIPE_STEPS - 1}, host clock)")
    return step_ms


def moe_inputs(dev) -> tuple[tuple, tuple]:
    """Phase 13 (b)'s world of 4 (:func:`moe_world_rank`) and (c)'s of 2 x 3
    (:func:`moe_pipe_rank`)."""
    import numpy as np

    from ddl25spring_tpu_torch.data.tinystories import TinyStories
    from ddl25spring_tpu_torch.data.tokenizer import get_tokenizer

    exact = _token_batches(moe_cfg(), 2 * SPTP_ROWS, 1, seed=17)[0]
    ds = iter(TinyStories(get_tokenizer(), batch_size=2 * SPTP_ROWS, seq_l=256, seed=0))
    batches = [np.asarray(next(ds)) for _ in range(SPTP_STEPS)]
    D, S, M = MOE_PIPE
    pipe_exact = _token_batches(moe_cfg(), D * M, 1, seed=19)[0]
    pipe_batches = [np.asarray(next(ds))[:D * M] for _ in range(MOE_PIPE_STEPS)]
    return (exact, batches, dev.type), (pipe_exact, pipe_batches, dev.type)


def moe_phase(dev, worlds=None):
    """Phase 13: switch-MoE LLaMA and expert parallelism on the card, each
    sub-phase timed, (b)'s and (c)'s worlds from :func:`chain_phase` (None:
    spawned here, after (a)); returns (a)'s flash launches per step."""
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    single = moe_single(dev)
    print(f"  (a) took {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    if worlds is None:
        b, c = moe_inputs(dev)
        worlds = {"13 (b)": own_world(moe_world_rank, 4, b),
                  "13 (c)": own_world(moe_pipe_rank, MOE_PIPE[0] * MOE_PIPE[1], c),
                  "inputs": {"13 (c)": c}}
    ranks = worlds["13 (b)"]
    print(f"  (b) 4 ranks, backend {sorted({r['slice']['tp']['backend'] for r in ranks})}")
    world = moe_world_checks(ranks, dev)
    print(f"  (b) took {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    exact = worlds["inputs"]["13 (c)"][0]
    pipe = moe_pipe_checks(worlds["13 (c)"], dev, exact)
    print(f"  (c) took {time.perf_counter() - t0:.1f} s", flush=True)
    print(f"  phase 13 took {time.perf_counter() - t_phase:.1f} s (its worlds ran in phase "
          "10)")
    return {"launches": single["launches"], "single": single, "world": world, "pipe": pipe}


# ---------------------------------------------------------------- phase 14

PIPE_STEPS = 4                  # bf16 Adam steps per layout and schedule (phases 14, 15)
GRAD_BAND = 1e-5                # fp32: |pipeline - one process|, loss (relative) and grads
# run -> world, grid (data, stages, seq, model), model kind, schedule, chunks per
# rank, the composition's axes, microbatches, rows per replica
PIPE_RUNS = {}
for _s in SCHED:
    PIPE_RUNS[f"(a) ep {_s}"] = dict(world=6, grid=(2, 3, None, None), kind="moe", schedule=_s,
                                     V=2 if _s in ("interleaved", "interleaved-1f1b") else 1,
                                     axes={"ep_axis": "data"}, M=3, rows=3)
for _kind in ("dense", "moe"):
    for _s in ("gpipe", "1f1b", "interleaved-1f1b"):
        PIPE_RUNS[f"(b) tp {_kind} {_s}"] = dict(
            world=8, grid=(2, 2, None, 2), kind=_kind, schedule=_s,
            V=3 if _s == "interleaved-1f1b" else 1, axes={"tp_axis": "model"}, M=2, rows=2)
for _mode, _s, _kind in (("ring", "gpipe", "dense"), ("ring", "1f1b", "dense"),
                         ("ulysses", "gpipe", "dense"), ("ulysses", "1f1b", "dense"),
                         ("ring", "gpipe", "moe")):
    PIPE_RUNS[f"(c) sp {_mode} {_kind} {_s}"] = dict(
        world=8, grid=(2, 2, 2, None), kind=_kind, schedule=_s, V=1,
        axes={"seq_axis": "seq", "sp_mode": _mode}, M=2, rows=2)
for _s in ("gpipe", "1f1b"):
    PIPE_RUNS[f"(d) sp-tp ring dense {_s}"] = dict(
        world=8, grid=(1, 2, 2, 2), kind="dense", schedule=_s, V=1,
        axes={"seq_axis": "seq", "tp_axis": "model", "sp_mode": "ring"}, M=2, rows=2)
# (B, H, L, causal) of the kernels' new calls, folded to [B H, L, 48]: TP's 3
# local heads and Ulysses' 3 heads over the whole length; the SP ring's own and
# received blocks of 128 positions, over 6 heads and, under TP, 3
PIPE_KERNEL_CASES = [(1, 3, 256, True), (1, 6, 128, True), (1, 6, 128, False),
                     (1, 3, 128, True), (1, 3, 128, False)]


def pipe_cfg(kind, dtype):
    """Phase 14's configurations: ``LlamaConfig(use_flash=True)`` at full
    width, and with ``kind == "moe"`` phase 13's ``MOE`` (4 experts, capacity
    1.25)."""
    from ddl25spring_tpu_torch.utils.config import LlamaConfig

    if kind == "moe":
        return moe_cfg(dtype)
    return LlamaConfig(dtype=dtype, use_flash=True)


def _pipe_grid(g):
    from ddl25spring_tpu_torch.utils.mesh import _grid

    data, stages, seq, model = g
    return _grid(data, stages, seq, model, None, data * stages * (seq or 1) * (model or 1))


class RouterLog:
    """While active, every router's float32 logits, by global layer (the
    routers' parameters name them): ``ep.router_logits`` wrapped, which
    ``moe_ffn``, ``ep_moe_local`` and the TP-MoE layer all call."""

    def __init__(self, layer_of: dict):
        self.layer_of, self.logs = layer_of, {}

    def __enter__(self):
        from ddl25spring_tpu_torch.parallel import ep

        self.orig = ep.router_logits

        def log(router, x):
            out = self.orig(router, x)
            self.logs.setdefault(self.layer_of[id(router)], []).append(out.detach().cpu())
            return out

        ep.router_logits = log
        return self

    def __exit__(self, *exc):
        from ddl25spring_tpu_torch.parallel import ep

        ep.router_logits = self.orig


def _stage_layers(stage, S, s) -> dict:
    """``id(router) -> global layer`` of a pipeline rank's MoE blocks."""
    from ddl25spring_tpu_torch.models.llama import LlamaChunkedStage

    chunks = stage.chunks if isinstance(stage, LlamaChunkedStage) else [stage]
    out = {}
    for v, c in enumerate(chunks):
        g = v * S + s
        for j, b in enumerate(c.blocks):
            out[id(b.moe.router)] = g * len(c.blocks) + j
    return out


def pipe_comp_rank(rdv, exact, batches, device):
    """One rank of phase 14's world of 8: every run of ``PIPE_RUNS``, the
    8-rank grids regrids of the first, the 6-rank grid (EP x DP x PP) the
    world's first 6 ranks (``Mesh.sub``; ranks 6 and 7 sit those runs out).
    Per run: one fp32 step (the
    loss, the stage's gradients where the merge needs them, the routers'
    logits), then ``PIPE_STEPS`` bf16 Adam steps (losses, host seconds per
    step to the card's idle, comm counts, the flash launches of the run: the
    counts set to 0 just before it and read just after)."""
    from ddl25spring_tpu_torch.models.llama import Llama, export_grads, export_params
    from ddl25spring_tpu_torch.ops import flash_attention as fa
    from ddl25spring_tpu_torch.parallel import ep
    from ddl25spring_tpu_torch.parallel.pipeline import (
        make_pipeline_train_step,
        shard_staged_params,
    )
    from ddl25spring_tpu_torch.utils.device import backend_flags
    from ddl25spring_tpu_torch.utils.mesh import init_mesh

    runs = PIPE_RUNS
    params = {k: export_params(Llama(pipe_cfg(k, "float32"), device="cpu",
                                     generator=torch.Generator().manual_seed(7)))
              for k in {r["kind"] for r in runs.values()}}
    grids = list(dict.fromkeys(r["grid"] for r in runs.values() if r["world"] == 8))
    data, stages, seq, model = grids[0]
    out = {}
    with init_mesh(rdv, data, stages, device=device, seq=seq, model=model) as world:
        meshes = {grids[0]: world}
        for g in grids[1:]:
            meshes[g] = world.regrid(g[0], g[1], seq=g[2], model=g[3])
        for g in dict.fromkeys(r["grid"] for r in runs.values() if r["world"] < 8):
            meshes[g] = world.sub(g[0], g[1], seq=g[2], model=g[3])
        for name, run in runs.items():
            mesh = meshes[run["grid"]]
            if mesh is None:
                continue  # a run of the 6-rank grid, which leaves this rank out
            names = mesh.grid.names
            c = dict(zip(names, mesh.coords))
            keep = c.get("seq", 0) == 0 and ("ep_axis" in run["axes"] or c["data"] == 0)
            r = {"coords": c, "device": str(mesh.device), "backend": mesh.backend}
            for dtype in ("float32", "bfloat16"):
                cfg = pipe_cfg(run["kind"], dtype)
                stage = shard_staged_params(params[run["kind"]], cfg, mesh, run["V"],
                                            ep_axis=run["axes"].get("ep_axis"),
                                            tp_axis=run["axes"].get("tp_axis"))
                step = make_pipeline_train_step(
                    stage, cfg, torch.optim.Adam(stage.parameters(), lr=8e-4), mesh,
                    run["M"], run["schedule"], run["V"], **run["axes"])
                rows = mesh.grid.data * run["rows"]
                if dtype == "float32":
                    layers = (_stage_layers(stage, mesh.grid.size, c["stage"])
                              if cfg.n_experts else {})
                    with backend_flags(**FP32_EXACT), RouterLog(layers) as log:
                        loss = step(torch.from_numpy(exact[:rows]).long())
                    r["exact"] = {"loss": None if loss is None else float(loss),
                                  "grads": export_grads(stage) if keep else None,
                                  "logits": log.logs}
                    continue
                # EP's expert stacks: left out of the DP average
                experts = sum(p.numel() for b in stage.blocks
                              for k, p in b.moe.named_parameters()
                              if k in ep.EXPERT_KEYS) if "ep_axis" in run["axes"] else 0
                r.update(n_params=sum(p.numel() for p in stage.parameters()),
                         n_experts_local=experts, losses=[], step_s=[], comm=[])
                world.comm.take_stats()
                fa.reset_launches()
                for b in batches:
                    t0 = time.perf_counter()
                    loss = step(torch.from_numpy(b[:rows]).long())
                    if mesh.device.type == "cuda":
                        torch.cuda.synchronize(mesh.device)
                    r["step_s"].append(time.perf_counter() - t0)
                    r["comm"].append(world.comm.take_stats())
                    r["losses"].append(None if loss is None else float(loss))
                r["launches"] = dict(fa.LAUNCHES)
                r["by_variant"] = {n: dict(v) for n, v in fa.LAUNCHES_BY_VARIANT.items()}
            out[name] = r
    return out


def pipe_launches(run, c) -> dict:
    """Flash launches of each kernel per rank per step: one per layer and
    microbatch (the flash ring's index ``i`` runs ``1 + i``), the forward
    twice under the remat schedules (the forward, then its recompute in the
    backward)."""
    S = run["grid"][1]
    k = 1 + c["seq"] if run["axes"].get("sp_mode") == "ring" else 1
    n = 6 // S * run["M"] * k
    return {"fwd": n * (2 if run["schedule"] in ("1f1b", "interleaved-1f1b") else 1),
            "dq": n, "dkv": n}


def pipe_staged_bytes(run, cfg, c, n_params, n_experts_local, L=256) -> int:
    """Bytes one rank stages through the host per bf16 step (every staged
    tensor counts once on its way to the host and once back), from the
    shapes, activations in the compute dtype (bf16 here): the pipeline's
    hops, activations forward and their gradients
    back (``[mb, L/n, D]``; a rank with the first chunk receives none
    for it, with the last sends none); the fp32 gradients averaged over
    ``data`` (and summed over ``seq``), the expert stacks under EP left out;
    the scalar loss terms (a MoE chunk's aux summed over the stages, the SP
    shares over ``seq``, the mean over ``data``); the last stage's one-token
    target hop under SP (int64, the global batch's rows); and per layer and
    microbatch, each forward pass (two under the remat schedules) and the
    backward: TP's two all-reduces of ``[mb, L/n, D]`` bf16 forward and two
    backward (MoE: plus the gates' ``[T, 1]`` fp32), the flash ring's ``n -
    1`` hops of k and v (``[mb, L/n, H/T, hd]`` bf16) each way, Ulysses'
    all-to-alls of q/k/v and of the output, EP's two all-to-alls of the
    ``[E, C, D]`` buckets each way."""
    from ddl25spring_tpu_torch.parallel import ep

    D, S, n, T = run["grid"][0], run["grid"][1], run["grid"][2] or 1, run["grid"][3] or 1
    M, V, mb, Dm = run["M"], run["V"], 1, cfg.dmodel
    assert run["rows"] == M * mb
    e = torch.finfo(getattr(torch, cfg.dtype)).bits // 8  # the compute dtype's bytes
    s, last = c["stage"], c["stage"] == S - 1
    Ll = L // n
    passes = 2 if run["schedule"] in ("1f1b", "interleaved-1f1b") else 1
    act = mb * Ll * Dm * e
    total = 2 * M * (2 * V - (s == 0) - last) * act
    if D * n > 1:
        total += 2 * 4 * (n_params - n_experts_local)
    total += 2 * 4 * ((cfg.n_experts > 0) + last * ((n > 1) + (D > 1)))
    if last and n > 1:
        total += 2 * 8 * D * run["rows"]
    per = 0
    if T > 1:
        per += (passes + 1) * 2 * 2 * act
        if cfg.n_experts:
            per += 2 * mb * Ll * cfg.moe_top_k * 4
    mode = run["axes"].get("sp_mode")
    blk = mb * Ll * (Dm // T) * e
    if mode == "ring" and n > 1:
        per += (passes + 1) * 4 * (n - 1) * blk
    elif mode == "ulysses":
        per += (passes + 1) * 8 * blk
    if "ep_axis" in run["axes"]:
        C = ep.capacity(mb * L, cfg.capacity_factor, cfg.moe_top_k, cfg.n_experts)
        per += (passes + 1) * 2 * 2 * cfg.n_experts * C * Dm * e
    return total + cfg.n_layers // S * M * per


def pipe_oracle(run, dev, tokens):
    """The fp32 loss, gradients and routers' logits (by layer) of one process
    on the card from the same weights: ``llama_forward`` + causal-LM loss
    over the batch (dense), else the mean over the ``M D`` microbatch groups
    of ``causal_lm_loss + w aux``, each group's MoE dispatched per seq shard
    under SP (``_moe_composite_fn``)."""
    from ddl25spring_tpu_torch.models.llama import Llama, export_grads
    from ddl25spring_tpu_torch.ops.losses import causal_lm_loss
    from ddl25spring_tpu_torch.utils.device import backend_flags

    cfg = pipe_cfg(run["kind"], "float32")
    model = Llama(cfg, device=dev, generator=torch.Generator().manual_seed(7))
    tokens = torch.from_numpy(tokens).long().to(dev)
    layers = {id(b.moe.router): i for i, b in enumerate(model.blocks)} if cfg.n_experts else {}
    with backend_flags(**FP32_EXACT), RouterLog(layers) as log:
        if not cfg.n_experts:
            total = causal_lm_loss(model(tokens), tokens)
        else:
            n = run["grid"][2] or 1
            fn = _moe_composite_fn(cfg, tokens.shape[1], n) if n > 1 else None
            groups = tokens.view(run["M"] * run["grid"][0], -1, tokens.shape[1])
            total = sum(_moe_loss(model, g, cfg, fn)[0] for g in groups) / len(groups)
        total.backward()
    return total.item(), export_grads(model), log.logs


def _pipe_flips(rank_logs, oracle_logs, top_k=1):
    """Routing flips: for every distinct router call of the pipeline (the
    remat schedules call each twice), the tokens whose ordered top-k choice
    differs from the one-process call on the same tokens (the nearest of
    the layer's calls)."""
    flips, calls = 0, 0
    for layer, logs in rank_logs.items():
        seen = []
        for p in logs:
            if any(p.shape == q.shape and torch.equal(p, q) for q in seen):
                continue
            seen.append(p)
            cands = [q for q in oracle_logs[layer] if q.shape == p.shape]
            q = min(cands, key=lambda q: float((q - p).abs().max()))
            flips += int((p.topk(top_k, -1).indices != q.topk(top_k, -1).indices).any(-1).sum())
            calls += 1
    return flips, calls


def _merge_pipe_grads(run, ranks):
    """The full gradient tree of a run from its ranks' stage exports: the
    model indices' TP slices joined, or under EP the replicas' experts, then
    the stages (the seq shards' gradients are already summed, the replicas'
    averaged)."""
    import numpy as np

    from ddl25spring_tpu_torch.models.llama import merge_stage_exports
    from ddl25spring_tpu_torch.parallel import ep, tp

    by = {tuple(r["coords"].values()): r["exact"]["grads"] for r in ranks}
    grid = _pipe_grid(run["grid"])
    stages = []
    for s in range(grid.size):
        def at(**idx):
            c = [idx.get(n, 0) for n in grid.names]
            c[1] = s
            return by[tuple(c)]

        if "tp_axis" in run["axes"]:
            stages.append(tp.merge_tp_params([at(model=t) for t in range(grid.shape[-1])],
                                             shard_vocab=False))
        elif "ep_axis" in run["axes"]:
            shards = [at(data=d) for d in range(grid.data)]
            moe = dict(shards[0]["blocks"]["moe"])
            for k in ep.EXPERT_KEYS:
                moe[k] = np.concatenate([x["blocks"]["moe"][k] for x in shards], 1)
            stages.append(dict(shards[0], blocks=dict(shards[0]["blocks"], moe=moe)))
        else:
            stages.append(at())
    return merge_stage_exports(stages, num_chunks=run["V"])


def pipe_checks(ranks, dev, exact):
    """Each run of a world: (1) its fp32 step against :func:`pipe_oracle`,
    loss and gradients within ``GRAD_BAND``, routing flips counted; (2) the
    bf16 run: losses finite, the same on every last-stage rank and falling,
    launches exact and all ``wgmma``, the staged bytes the shapes give, the
    median step (slowest rank) and the all-reduce seconds.  Returns each
    run's launches per rank per step and its median step."""
    from ddl25spring_tpu_torch.parallel.bucketing import flatten

    out = {}
    for name in ranks[0]:
        run, rs = PIPE_RUNS[name], [r[name] for r in ranks]
        cfg = pipe_cfg(run["kind"], "bfloat16")
        rows = run["grid"][0] * run["rows"]
        want_loss, want_grads, want_logs = pipe_oracle(run, dev, exact[:rows])
        losses = [r["exact"]["loss"] for r in rs if r["exact"]["loss"] is not None]
        check(len(losses) == len(rs) // run["grid"][1] and
              all(excess(v, want_loss, (0.0, GRAD_BAND)) <= 0 for v in losses),
              f"{name}: fp32 losses {losses} vs one process {want_loss}")
        grads = _merge_pipe_grads(run, [r for r in rs if r["exact"]["grads"] is not None])
        err = 0.0
        for (path, a), (_, b) in zip(flatten(grads), flatten(want_grads), strict=True):
            e = float(abs(torch.from_numpy(a) - torch.from_numpy(b)).max())
            check(e <= GRAD_BAND, f"{name}: fp32 grad {path} off one process by {e:.3g}")
            err = max(err, e)
        flips = calls = 0
        for r in rs:
            if r["coords"].get("model", 0) == 0 and r["exact"]["logits"]:
                f, k = _pipe_flips(r["exact"]["logits"], want_logs)
                flips, calls = flips + f, calls + k
        bf = [r["losses"] for r in rs if r["losses"][0] is not None]
        check(all(x == bf[0] for x in bf), f"{name}: the last stages' bf16 losses differ")
        bf = bf[0]
        check(all(math.isfinite(x) for x in bf) and abs(bf[0] - math.log(4096)) < 1.0,
              f"{name}: bf16 losses {bf}")
        first, last_ = statistics.mean(bf[:3]), statistics.mean(bf[-3:])
        check(last_ < first, f"{name}: bf16 loss did not fall: {bf}")
        per_rank = []
        for r in rs:
            check(r["device"].startswith("cuda"), f"{name}: rank {r['coords']} on {r['device']}")
            want = {k: v * PIPE_STEPS for k, v in pipe_launches(run, r["coords"]).items()}
            check(r["launches"] == want,
                  f"{name}: rank {r['coords']} launches {r['launches']} != {want}")
            for k in want:
                check(r["by_variant"][k].get("wgmma", 0) == want[k] and
                      r["by_variant"][k].get("scalar", 0) == 0,
                      f"{name}: rank {r['coords']} {k} by variant {r['by_variant'][k]}")
            staged = {x["bytes_staged"] for x in r["comm"]}
            expect = pipe_staged_bytes(run, cfg, r["coords"], r["n_params"],
                                       r["n_experts_local"])
            check(staged == {expect}, f"{name}: rank {r['coords']} staged {staged} B per step, "
                                      f"the shapes give {expect}")
            per_rank.append(pipe_launches(run, r["coords"]))
        steady = [max(r["step_s"][i] for r in rs) for i in range(1, PIPE_STEPS)]
        step_ms = statistics.median(steady) * 1e3
        ar = [round(statistics.median(x["allreduce_s"] for x in r["comm"][1:]) * 1e3, 3)
              for r in rs]
        staged = sorted({x["bytes_staged"] for r in rs for x in r["comm"]})
        print(f"  {name}: fp32 loss {losses[0]:.6f} vs one process {want_loss:.6f}, grads max "
              f"abs err {err:.2e}, routing flips {flips} over {calls} router calls; bf16 "
              f"loss {first:.4f} (first 3) -> {last_:.4f} (last 3); step median "
              f"{step_ms:.3f} ms (slowest rank, steps 1..{PIPE_STEPS - 1}, host clock); "
              f"all-reduce ms per rank {ar}; staged B per rank per step {staged} (exact); "
              f"flash launches per rank per step {[p['fwd'] for p in per_rank]} fwd, "
              f"{[p['dq'] for p in per_rank]} dq/dkv, all wgmma", flush=True)
        out[name] = {"launches": per_rank, "step_ms": step_ms, "err": err, "flips": flips}
    return out


def pipe_refusals():
    """(d): Ulysses under PP x SP x TP raises before any rank starts: the 3
    local heads of TP 2 do not split over seq 2."""
    from ddl25spring_tpu_torch.parallel.comm import Comm
    from ddl25spring_tpu_torch.parallel.pipeline import check_compositions
    from ddl25spring_tpu_torch.utils.mesh import Mesh

    grid = _pipe_grid((1, 2, 2, 2))
    mesh = Mesh(grid, 0, torch.device("cpu"), "gloo", Comm("gloo", torch.device("cpu")),
                {n: None for n in grid.names})
    try:
        check_compositions(pipe_cfg("dense", "bfloat16"), mesh, "gpipe", seq_axis="seq",
                           tp_axis="model", sp_mode="ulysses")
    except ValueError as e:
        check("local heads (3)" in str(e), f"(d) Ulysses raised {e}")
        print(f"  (d) sp-tp ulysses: ValueError: {e}")
    else:
        check(False, "(d) Ulysses over 3 local heads and seq 2 did not raise")


def pipe_kernel_checks(dev):
    """The kernels at ``PIPE_KERNEL_CASES`` against their plain versions on the
    ``wgmma`` variant, and the autograd Functions on the card against the
    CPU (:func:`sp_tp_kernel_checks`' checks); the max abs errors."""
    from ddl25spring_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator().manual_seed(14)
    errs = {"fwd": 0.0, "dq": 0.0, "dkv": 0.0}
    for B, H, L, causal in PIPE_KERNEL_CASES:
        e = kernel_case(fa, gen, dev, B * H, L, L, 48, torch.bfloat16, causal)
        errs = {n: max(errs[n], e[n]) for n in errs}
        for with_lse in (True, False):
            autograd_case(fa, gen, dev, (B, L, H, 48), torch.bfloat16, causal, with_lse)
    return errs


def pipe_inputs(dev) -> tuple:
    """Phase 14's world of 8 (:func:`pipe_comp_rank`)."""
    import numpy as np

    from ddl25spring_tpu_torch.data.tinystories import TinyStories
    from ddl25spring_tpu_torch.data.tokenizer import get_tokenizer

    exact = _token_batches(pipe_cfg("dense", "float32"), 6, 1, seed=23)[0]
    ds = iter(TinyStories(get_tokenizer(), batch_size=6, seq_l=256, seed=0))
    batches = [np.asarray(next(ds)) for _ in range(PIPE_STEPS)]
    return exact, batches, dev.type


def pipe_phase(dev, ranks=None, exact=None, kernel_times=None):
    """Phase 14: the pipeline compositions on the card, one world of 8 ranks
    ((a) on its first 6, (b)-(d) on all 8) from :func:`chain_phase`, each
    sub-phase timed, (e)'s kernel times from phase 10 (f)'s process (None:
    each made here, the phase run alone); returns the runs' launches, the
    kernels' errors at the new shapes and their times."""
    if ranks is None:
        args = pipe_inputs(dev)
        ranks, exact = own_world(pipe_comp_rank, 8, args), args[0]
    if kernel_times is None:
        (kernel_times,) = own_world(kernel_times_at, 1, (
            [(B, H, L, torch.bfloat16, c) for B, H, L, c in PIPE_KERNEL_CASES], "14 (e)"))
    t_phase = time.perf_counter()
    runs = {}
    t0 = time.perf_counter()
    print(f"  8 ranks, the 6-rank grid on the first 6, backend "
          f"{sorted({r[n]['backend'] for r in ranks for n in r})}", flush=True)
    for world in (6, 8):
        runs.update(pipe_checks([{n: v for n, v in r.items() if PIPE_RUNS[n]["world"] == world}
                                 for r in ranks[:world]], dev, exact))
    print(f"  the world of 8's checks took {time.perf_counter() - t0:.1f} s", flush=True)
    pipe_refusals()
    t0 = time.perf_counter()
    errs = pipe_kernel_checks(dev)
    times, lines = kernel_times
    for line in lines:
        print(line)
    print(f"  (e) took {time.perf_counter() - t0:.1f} s", flush=True)
    print(f"  phase 14 took {time.perf_counter() - t_phase:.1f} s (its world ran in phase "
          "10)")
    return {"runs": runs, "max_abs_err": errs, "times": times}


# ---------------------------------------------------------------- phase 15

ZERO_N = 4                      # ranks of phase 15's world; the n = 2 runs regrid it to 2 x 2
ZERO_EXACT_ROWS = 8             # (a), (b): fp32 ResNet rows per rank
ZERO_RESNET_ROWS = 256          # (a): bf16 ResNet rows per rank
ZERO_RESNET_STEPS = 10          # (a): bf16 ResNet steps (the LLaMA, MoE and rule runs: PIPE_STEPS)
ZERO_DP_STEPS = 3               # (a), (c): steps of the DP rank whose bytes are compared
ZERO_RESNET_LR = 0.1            # (a), (b): the fp32 step's SGD (the driver entry's, momentum 0.9)
ZERO_LLAMA = {f"n{n} {'prefetch' if pf else 'remat'}": (n, pf) for n in (4, 2)
              for pf in (True, False)}
ZERO_MOE_M = 2                  # (d): microbatches, one row each per rank


def _zero_resnet(dtype, dev):
    from ddl25spring_tpu_torch.models.resnet import ResNet18

    return ResNet18(norm="group", dtype=dtype, device=dev,
                    generator=torch.Generator().manual_seed(11))


def _resnet_loss(model, batch):
    from ddl25spring_tpu_torch.benchmarks import _nchw
    from ddl25spring_tpu_torch.ops.losses import cross_entropy_logits

    x_u8, y = batch
    return cross_entropy_logits(model(_nchw(x_u8, model.dtype)), y)


def _lm_loss(model, tokens):
    from ddl25spring_tpu_torch.ops.losses import causal_lm_loss

    return causal_lm_loss(model(tokens), tokens)


def _zero_moe_loss(model, tokens):
    return _moe_loss(model, tokens, model.cfg)[0]


def _np_rows(rows):
    return [r.detach().float().cpu().numpy() for r in rows]


def _np_grads(rows):
    return [r.grad.detach().float().cpu().numpy() for r in rows]


def _requested(dev) -> int:
    """The bytes the process's live tensors on ``dev`` asked the caching
    allocator for (``requested_bytes``: ``memory_allocated`` counts blocks,
    which the allocator rounds up, by up to 1 MiB for a large one)."""
    return torch.cuda.memory_stats(dev)["requested_bytes.all.current"]


def _zero_run(step, batches, dev, comm):
    """``step`` over ``batches``: losses, host seconds per step to the card's
    idle, comm counts per step, the flash launches of the run (the counts set
    to 0 just before it and read just after) and the bytes requested after
    each step (:func:`_requested`)."""
    import gc

    from ddl25spring_tpu_torch.ops import flash_attention as fa

    r = {"losses": [], "step_s": [], "comm": [], "alloc": []}
    gc.collect()
    comm.take_stats()
    fa.reset_launches()
    for b in batches:
        t0 = time.perf_counter()
        loss = step(b)
        torch.cuda.synchronize(dev)
        r["step_s"].append(time.perf_counter() - t0)
        r["comm"].append(comm.take_stats())
        r["losses"].append(float(loss))
        del loss
        r["alloc"].append(_requested(dev))
    r["launches"] = dict(fa.LAUNCHES)
    r["by_variant"] = {n: dict(c) for n, c in fa.LAUNCHES_BY_VARIANT.items()}
    return r


def _settled_alloc(dev):
    """The bytes requested once a run's objects are gone: the workspaces a
    process keeps (cuBLAS's) stay in it, so a run's persistent bytes are its
    requests between steps less this."""
    import gc

    gc.collect()
    torch.cuda.synchronize(dev)
    return _requested(dev)


def zero_rank(rdv, data, device):
    """One rank of phase 15's world of 4 ranks on the card (gloo through pinned
    host buffers), regridded to 2 x 2 for the n = 2 runs.  (a), (b): one fp32
    SGD step of ZeRO-3, ZeRO-1 and ZeRO-2 (sync, overlap) over the ResNet;
    the bf16 ZeRO-3 run and a DP rank's; (c): per ``ZERO_LLAMA`` run one fp32
    Adam step (loss, row gradients), then the bf16 run, and a DP rank's bf16
    run; (d): the MoE LLaMA under ZeRO-3, fp32 (routers' logits in call
    order) and bf16; (e): the rule tables' steps and the bespoke ones."""
    from ddl25spring_tpu_torch.models.llama import Llama
    from ddl25spring_tpu_torch.parallel import dp, rules, zero
    from ddl25spring_tpu_torch.utils.device import backend_flags
    from ddl25spring_tpu_torch.utils.mesh import init_mesh

    out = {"exact": {}, "runs": {}}
    with init_mesh(rdv, ZERO_N, stages=1, device=device) as world:
        dev, comm = world.device, world.comm
        meshes = {ZERO_N: world, 2: world.regrid(2, stages=2)}
        out.update(rank=world.rank, device=str(dev), backend=world.backend)

        def resnet_batch(x, y):
            return torch.from_numpy(x), torch.from_numpy(y).long()

        exact = resnet_batch(*data["resnet exact"])
        with backend_flags(**FP32_EXACT):
            for name in ("zero3", "zero1", "zero1 overlap", "zero2", "zero2 overlap"):
                model = _zero_resnet(torch.float32, dev)
                rows = zero.zero_shard_params(model, world)
                opt = torch.optim.SGD(rows, lr=ZERO_RESNET_LR, momentum=0.9)
                if name == "zero3":
                    step = zero.make_zero_dp_train_step(model, _resnet_loss, opt, world, rows)
                else:
                    step = zero.make_zero_partitioned_train_step(
                        model, _resnet_loss, opt, world, rows, stage=int(name[4]),
                        overlap=name.endswith("overlap"))
                r = {"loss": float(step(exact))}
                if name == "zero3":
                    r["rows"] = _np_rows(rows)
                elif world.rank == 0:
                    r["params"] = [p.detach().cpu().numpy() for p in dp.param_leaves(model)]
                out["exact"]["resnet " + name] = r
                del model, rows, opt, step
        batches = [resnet_batch(*b) for b in data["resnet"]]
        for name in ("zero3", "dp"):
            model = _zero_resnet(torch.bfloat16, dev)
            if name == "zero3":
                rows = zero.zero_shard_params(model, world)
                opt = torch.optim.SGD(rows, lr=float(RESNET_LR), momentum=0.9)
                step = zero.make_zero_dp_train_step(model, _resnet_loss, opt, world, rows)
            else:
                opt = torch.optim.SGD(model.parameters(), lr=float(RESNET_LR), momentum=0.9)
                step = dp.make_dp_train_step(model, _resnet_loss, opt, world)
            r = _zero_run(step, batches if name == "zero3" else batches[:ZERO_DP_STEPS], dev,
                          comm)
            del model, opt, step
            rows = None     # frees the ZeRO-3 rows before the baseline is read
            base = _settled_alloc(dev)
            r.update(persistent=[a - base for a in r.pop("alloc")])
            out["runs"]["resnet " + name] = r
        for name, (n, prefetch) in ZERO_LLAMA.items():
            mesh = meshes[n]
            for dtype in ("float32", "bfloat16"):
                cfg = pipe_cfg("dense", dtype)
                model = Llama(cfg, device=dev, generator=torch.Generator().manual_seed(7))
                rows = zero.zero_shard_llama_params(model, mesh)
                opt = torch.optim.Adam(rows.parameters(), lr=8e-4)
                step = zero.make_zero3_llama_train_step(model, opt, mesh, rows, prefetch=prefetch)
                if dtype == "float32":
                    with backend_flags(**FP32_EXACT):
                        loss = float(step(torch.from_numpy(data["llama exact"][:n * SPTP_ROWS])
                                          .long()))
                    out["exact"]["llama " + name] = {
                        "coords": mesh.coords, "loss": loss,
                        "grads": zero.LlamaRows(_np_grads(rows.outer),
                                                [_np_grads(layer) for layer in rows.blocks])}
                else:
                    r = _zero_run(step, [torch.from_numpy(b[:n * SPTP_ROWS]).long()
                                         for b in data["llama"]], dev, comm)
                    del model, rows, opt, step
                    base = _settled_alloc(dev)
                    r.update(persistent=[a - base for a in r.pop("alloc")], coords=mesh.coords)
                    out["runs"]["llama " + name] = r
        model = Llama(pipe_cfg("dense", "bfloat16"), device=dev,
                      generator=torch.Generator().manual_seed(7))
        opt = torch.optim.Adam(model.parameters(), lr=8e-4)
        step = dp.make_dp_train_step(model, _lm_loss, opt, world)
        r = _zero_run(step, [torch.from_numpy(b[:ZERO_N * SPTP_ROWS]).long()
                             for b in data["llama"][:ZERO_DP_STEPS]], dev, comm)
        del model, opt, step
        base = _settled_alloc(dev)
        r.update(persistent=[a - base for a in r.pop("alloc")])
        out["runs"]["llama dp"] = r
        for dtype in ("float32", "bfloat16"):
            cfg = moe_cfg(dtype)
            model = Llama(cfg, device=dev, generator=torch.Generator().manual_seed(7))
            rows = zero.zero_shard_params(model, world)
            opt = torch.optim.Adam(rows, lr=8e-4)
            step = zero.make_zero_dp_train_step(model, _zero_moe_loss, opt, world, rows,
                                                num_microbatches=ZERO_MOE_M)
            if dtype == "float32":
                # ZeRO-3 gathers the routers, so no tensor names its layer:
                # every call goes under layer 0, in call order
                with backend_flags(**FP32_EXACT), RouterLog(defaultdict(int)) as log:
                    loss = float(step(torch.from_numpy(data["moe exact"]).long()))
                out["exact"]["moe"] = {"loss": loss, "grads": _np_grads(rows),
                                       "logits": log.logs[0]}
            else:
                r = _zero_run(step, [torch.from_numpy(b).long() for b in data["moe"]], dev,
                              comm)
                r.pop("alloc")
                out["runs"]["moe"] = r
            del model, rows, opt, step
        x, y = (torch.from_numpy(a) for a in data["mlp"])
        for name in ("dp", "zero3"):
            for how in ("table", "bespoke"):
                model = dp.TinyMlp(device=dev)
                with torch.no_grad():
                    for p, a in zip(model.parameters(), data["mlp weights"]):
                        p.copy_(torch.from_numpy(a))
                part = rules.RulePartitioner(world, rules.TABLES[name])
                if name == "dp":
                    opt = torch.optim.Adam(model.parameters(), lr=1e-2)
                    step = (part.make_train_step(model, dp.tiny_mlp_loss, opt) if how == "table"
                            else dp.make_dp_train_step(model, dp.tiny_mlp_loss, opt, world))
                    state = dp.param_leaves(model)
                else:
                    rows = (part.shard_params(model) if how == "table"
                            else zero.zero_shard_params(model, world))
                    opt = torch.optim.Adam(rows, lr=1e-2)
                    step = (part.make_train_step(model, dp.tiny_mlp_loss, opt, rows=rows)
                            if how == "table"
                            else zero.make_zero_dp_train_step(model, dp.tiny_mlp_loss, opt,
                                                              world, rows))
                    state = rows
                losses = [float(step((x, y))) for _ in range(PIPE_STEPS)]
                out["exact"][f"rules {name} {how}"] = {
                    "losses": losses, "params": [t.detach().cpu().numpy() for t in state]}
    return out


def zero_row_bytes(leaves, n) -> int:
    """Bytes of one rank's rows of ``leaves`` (float32): ``sum k * 4``."""
    from ddl25spring_tpu_torch.parallel.zero import row_elems

    return sum(row_elems(leaf, n) * 4 for leaf in leaves)


def zero_staged_bytes(top, layer, n, L, remat=False) -> int:
    """Bytes one rank stages per ZeRO-3 step: each gather and each
    reduce-scatter of a bucket moves the rank's row one way and the ``[n, K]``
    buffer the other, ``(n + 1) K`` elements; the whole-tree step gathers and
    scatters the rows once (``top``, ``L = 0``), the LLaMA step the outer rows
    and each layer's (``layer``), gathering the layers twice under remat; the
    loss's mean is one float32 each way."""
    return (n + 1) * (2 * top + (3 if remat else 2) * L * layer) + 8


def _zero_resnet_oracle(dev, x_u8, y, n):
    """One process on the card from the same weights: each rank's rows
    forward and backward apart (the ranks' shapes), the gradients' sum over
    the slices divided by ``n``, one SGD step; the mean loss and the
    parameters after it, in ``param_leaves`` order."""
    from ddl25spring_tpu_torch.parallel.dp import param_leaves
    from ddl25spring_tpu_torch.utils.device import backend_flags

    with backend_flags(**FP32_EXACT):
        model = _zero_resnet(torch.float32, dev)
        opt = torch.optim.SGD(model.parameters(), lr=ZERO_RESNET_LR, momentum=0.9)
        losses = []
        for d in range(n):
            rows = slice(d * len(x_u8) // n, (d + 1) * len(x_u8) // n)
            loss = _resnet_loss(model, (torch.from_numpy(x_u8[rows]).to(dev),
                                        torch.from_numpy(y[rows]).long().to(dev)))
            loss.backward()
            losses.append(loss.item())
        for p in model.parameters():
            p.grad.div_(n)
        opt.step()
    return sum(losses) / n, [p.detach().cpu().numpy() for p in param_leaves(model)]


def _zero_llama_oracle(dev, tokens):
    """One process on the card: the fp32 loss and gradients of the batch."""
    from ddl25spring_tpu_torch.models.llama import Llama, export_grads
    from ddl25spring_tpu_torch.utils.device import backend_flags

    model = Llama(pipe_cfg("dense", "float32"), device=dev,
                  generator=torch.Generator().manual_seed(7))
    with backend_flags(**FP32_EXACT):
        loss = _lm_loss(model, torch.from_numpy(tokens).long().to(dev))
        loss.backward()
    return loss.item(), export_grads(model)


def _zero_moe_oracle(dev, tokens, groups):
    """One process on the card: the mean over the ``groups`` row groups (each
    rank's microbatches, in rank order) of ``causal_lm_loss + w aux``, each
    group dispatched alone as on the ranks; the gradients and the routers'
    logits in call order."""
    from ddl25spring_tpu_torch.models.llama import Llama, export_grads
    from ddl25spring_tpu_torch.utils.device import backend_flags

    model = Llama(moe_cfg("float32"), device=dev, generator=torch.Generator().manual_seed(7))
    t = torch.from_numpy(tokens).long().to(dev)
    with backend_flags(**FP32_EXACT), RouterLog(defaultdict(int)) as log:
        total = sum(_zero_moe_loss(model, g) for g in t.chunk(groups)) / groups
        total.backward()
    return total.item(), export_grads(model), log.logs[0]


def _tree_err(got: dict, want: dict) -> tuple[float, str]:
    from ddl25spring_tpu_torch.parallel.bucketing import flatten

    worst = (0.0, "")
    for (path, a), (_, b) in zip(flatten(got), flatten(want), strict=True):
        worst = max(worst, (float(abs(torch.as_tensor(a) - torch.as_tensor(b)).max()), path))
    return worst


def _median_ms(rs, key="step_s", skip=1):
    """Median over the steps after ``skip`` of the slowest rank's seconds, in ms."""
    steps = len(rs[0][key])
    return statistics.median(max(r[key][i] for r in rs) for i in range(skip, steps)) * 1e3


def zero_checks(ranks, dev, data):
    """Every check of phase 15 on the ranks' results; returns the LLaMA runs'
    launches per rank per step, the MoE run's, and the printed numbers."""
    import numpy as np

    from ddl25spring_tpu_torch.models.llama import Llama
    from ddl25spring_tpu_torch.parallel import dp, zero
    from ddl25spring_tpu_torch.parallel.bucketing import flatten, parts

    n = ZERO_N
    check(all(r["device"].startswith("cuda") for r in ranks),
          f"ranks on {[r['device'] for r in ranks]}")
    out = {"launches": {}}
    # (a), (b): fp32 ResNet steps against one process
    x, y = data["resnet exact"]
    want_loss, want = _zero_resnet_oracle(dev, x, y, n)
    leaves = dp.param_leaves(_zero_resnet(torch.float32, "meta"))
    for name in ("zero3", "zero1", "zero1 overlap", "zero2", "zero2 overlap"):
        rs = [r["exact"]["resnet " + name] for r in ranks]
        if name == "zero3":
            got = zero.zero_unshard_params(
                [np.concatenate([r["rows"][j] for r in rs]) for j in range(len(leaves))], leaves)
        else:
            got = rs[0]["params"]
        err = max(float(abs(a - b).max()) for a, b in zip(got, want, strict=True))
        losses = [r["loss"] for r in rs]
        check(all(excess(v, want_loss, (0.0, GRAD_BAND)) <= 0 for v in losses),
              f"({'a' if name == 'zero3' else 'b'}) resnet {name}: fp32 losses {losses} vs one "
              f"process {want_loss}")
        check(err <= GRAD_BAND, f"resnet {name}: fp32 parameters off one process by {err:.3g}")
        print(f"  ({'a' if name == 'zero3' else 'b'}) ResNet-18 {name}, fp32, one SGD step "
              f"(lr {ZERO_RESNET_LR}, momentum 0.9), {n} x {ZERO_EXACT_ROWS} rows: loss "
              f"{losses[0]:.6f} vs one process {want_loss:.6f}; parameters max abs err "
              f"{err:.2e}", flush=True)
    # (a): the bf16 ZeRO-3 run, its staged bytes and persistent bytes against a DP rank's
    row_bytes = zero_row_bytes(leaves, n)
    P = sum(sum(t.numel() for t in parts(leaf)) for leaf in leaves)
    rz = [r["runs"]["resnet zero3"] for r in ranks]
    rd = [r["runs"]["resnet dp"] for r in ranks]
    bf = rz[0]["losses"]
    check(all(r["losses"] == bf for r in rz), "(a) the ranks' bf16 losses differ")
    check(all(math.isfinite(v) for v in bf), f"(a) bf16 losses {bf}")
    first, last = statistics.mean(bf[:3]), statistics.mean(bf[-3:])
    check(last < first, f"(a) bf16 loss did not fall: {bf}")
    want_staged = zero_staged_bytes(row_bytes, 0, n, 0)
    staged = sorted({c["bytes_staged"] for r in rz for c in r["comm"]})
    check(staged == [want_staged], f"(a) staged {staged} B per rank per step, the rows give "
                                   f"{want_staged}")
    zp = [r["persistent"][-1] for r in rz]
    dpp = [r["persistent"][-1] for r in rd]
    z_want, d_want = 3 * row_bytes, 3 * P * 4
    for got, want_b, tag in ((zp, z_want, "ZeRO-3"), (dpp, d_want, "DP")):
        check(set(got) == {want_b}, f"(a) {tag} persistent bytes per rank {got}, the state "
                                    f"gives {want_b}")
    check(max(zp) <= min(dpp) / n + 3 * 4 * n * len(leaves),
          f"(a) ZeRO-3 persistent {zp} not 1/{n} of DP's {dpp} (+ the padding)")
    z_ms, d_ms = _median_ms(rz), _median_ms(rd)
    coll = statistics.median(c["collective_s"] for r in rz for c in r["comm"][1:]) * 1e3
    print(f"  (a) ResNet-18 ZeRO-3, bf16, {n} x {ZERO_RESNET_ROWS} rows, SGD lr {RESNET_LR}: "
          f"loss {first:.4f} (first 3) -> {last:.4f} (last 3); step median {z_ms:.1f} ms "
          f"(slowest rank, steps 1..{ZERO_RESNET_STEPS - 1}, host clock) vs DP {d_ms:.1f} ms "
          f"(steps 1..{ZERO_DP_STEPS - 1}); gather + reduce-scatter {coll:.1f} ms per rank per "
          f"step; staged {want_staged} B per rank per step (exact; JAX's wire count "
          f"{(n - 1) * row_bytes} B each way); persistent B per rank: ZeRO-3 {zp} (rows, grads, "
          f"momentum: 3 x {row_bytes}) vs DP {dpp} (3 x {P * 4}), ratio "
          f"{max(zp) / min(dpp):.4f}", flush=True)
    out["resnet"] = {"zero_ms": z_ms, "dp_ms": d_ms, "persistent": zp, "dp_persistent": dpp,
                     "staged": want_staged}
    # (c): LLaMA ZeRO-3, prefetch and remat, n = 4 and 2
    meta = Llama(pipe_cfg("dense", "float32"), device="meta", generator=torch.Generator())
    outer, layers = zero._llama_leaves(meta)
    oracle = {}
    out["llama"] = {}
    for name, (m, prefetch) in ZERO_LLAMA.items():
        line = [r for r in ranks if r["exact"]["llama " + name]["coords"][1] == 0]
        if m not in oracle:
            oracle[m] = _zero_llama_oracle(dev, data["llama exact"][:m * SPTP_ROWS])
        want_loss, want_grads = oracle[m]
        ex = [r["exact"]["llama " + name] for r in line]
        got = zero.zero_unshard_llama_params(
            zero.llama_rows_to_jax([e["grads"] for e in ex], meta), meta)
        err, where = _tree_err(got, want_grads)
        losses = [e["loss"] for e in ex]
        check(all(excess(v, want_loss, (0.0, GRAD_BAND)) <= 0 for v in losses),
              f"(c) {name}: fp32 losses {losses} vs one process {want_loss}")
        check(err <= GRAD_BAND, f"(c) {name}: fp32 gradient {where} off one process by {err:.3g}")
        rs = [r["runs"]["llama " + name] for r in ranks]
        bf = rs[0]["losses"]
        check(all(r["losses"] == bf for r in rs), f"(c) {name}: the ranks' bf16 losses differ")
        check(all(math.isfinite(v) for v in bf) and abs(bf[0] - math.log(4096)) < 1.0,
              f"(c) {name}: bf16 losses {bf}")
        first, last = statistics.mean(bf[:3]), statistics.mean(bf[-3:])
        check(last < first, f"(c) {name}: bf16 loss did not fall: {bf}")
        L = len(layers)
        want_l = {"fwd": L * (1 if prefetch else 2), "dq": L, "dkv": L}
        for r in rs:
            got_l = {k: v / PIPE_STEPS for k, v in r["launches"].items()}
            check(got_l == want_l, f"(c) {name}: launches per step {got_l} != {want_l}")
            for k in want_l:
                check(r["by_variant"][k].get("wgmma", 0) == want_l[k] * PIPE_STEPS and
                      r["by_variant"][k].get("scalar", 0) == 0,
                      f"(c) {name}: {k} by variant {r['by_variant'][k]}")
        top = zero_row_bytes([v for _, v in outer], m)
        layer = zero_row_bytes([v for _, v in layers[0]], m)
        want_staged = zero_staged_bytes(top, layer, m, L, remat=not prefetch)
        staged = sorted({c["bytes_staged"] for r in rs for c in r["comm"]})
        check(staged == [want_staged], f"(c) {name}: staged {staged} B per rank per step, the "
                                       f"rows give {want_staged}")
        state = 4 * (top + L * layer)
        zp = [r["persistent"][-1] for r in rs]
        check(set(zp) == {state}, f"(c) {name}: persistent bytes per rank {zp}, the state "
                                  f"gives {state}")
        ms = _median_ms(rs)
        coll = statistics.median(c["collective_s"] for r in rs for c in r["comm"][1:]) * 1e3
        ar = statistics.median(c["allreduce_s"] for r in rs for c in r["comm"][1:]) * 1e3
        print(f"  (c) LLaMA ZeRO-3 {name}: fp32 Adam step, loss {losses[0]:.6f} vs one process "
              f"{want_loss:.6f}, gradients max abs err {err:.2e} ({where}); bf16 loss "
              f"{first:.4f} (first 3) -> {last:.4f} (last 3); step median {ms:.1f} ms (slowest "
              f"rank, steps 1..{PIPE_STEPS - 1}, host clock); gather + reduce-scatter "
              f"{coll:.1f} ms, loss all-reduce {ar:.2f} ms per rank per step (medians); staged "
              f"{want_staged} B per rank per step (exact); flash launches per rank per step "
              f"{want_l}, all wgmma; persistent B per rank {zp} (rows, grads, Adam m and v: "
              f"4 x {top + L * layer})", flush=True)
        out["launches"][name] = [{k: v // PIPE_STEPS for k, v in r["launches"].items()}
                                 for r in rs]
        out["llama"][name] = {"step_ms": ms, "collective_ms": coll, "persistent": zp,
                              "staged": want_staged, "grad_err": err}
    rd = [r["runs"]["llama dp"] for r in ranks]
    P = sum(t.numel() for t in meta.parameters())
    dpp = [r["persistent"][-1] for r in rd]
    check(set(dpp) == {16 * P}, f"(c) DP persistent bytes per rank {dpp}, the state gives "
                                f"{16 * P}")
    zp4 = out["llama"]["n4 prefetch"]["persistent"]
    print(f"  (c) LLaMA DP rank, bf16, Adam: persistent B per rank {dpp} (4 x {P * 4}); step "
          f"median {_median_ms(rd):.1f} ms; ZeRO-3 n4 / DP {max(zp4) / min(dpp):.4f}", flush=True)
    out["llama"]["dp"] = {"step_ms": _median_ms(rd), "persistent": dpp}
    # (d): switch-MoE LLaMA under ZeRO-3, 2 microbatches
    exact = data["moe exact"]
    want_loss, want_grads, want_logs = _zero_moe_oracle(dev, exact, n * ZERO_MOE_M)
    mleaves = dp.param_leaves(Llama(moe_cfg("float32"), device="meta",
                                    generator=torch.Generator()))
    ex = [r["exact"]["moe"] for r in ranks]
    full = zero.zero_unshard_params(
        [np.concatenate([e["grads"][j] for e in ex]) for j in range(len(mleaves))], mleaves)
    err = max(float(abs(a - np.asarray(b)).max())
              for a, (_, b) in zip(full, flatten(want_grads), strict=True))
    flips = calls = 0
    for d, e in enumerate(ex):
        base = d * len(e["logits"])
        for i, p in enumerate(e["logits"]):
            q = want_logs[base + i]
            flips += int((p.argmax(-1) != q.argmax(-1)).sum())
            calls += 1
    losses = [e["loss"] for e in ex]
    check(all(excess(v, want_loss, (0.0, GRAD_BAND)) <= 0 for v in losses),
          f"(d) MoE: fp32 losses {losses} vs one process {want_loss}")
    check(err <= GRAD_BAND, f"(d) MoE: fp32 gradients off one process by {err:.3g}")
    check(flips == 0, f"(d) MoE: {flips} routing flips over {calls} router calls")
    rs = [r["runs"]["moe"] for r in ranks]
    bf = rs[0]["losses"]
    check(all(math.isfinite(v) for v in bf), f"(d) MoE bf16 losses {bf}")
    first, last = statistics.mean(bf[:3]), statistics.mean(bf[-3:])
    check(last < first, f"(d) MoE bf16 loss did not fall: {bf}")
    moe_l = {k: v // PIPE_STEPS for k, v in rs[0]["launches"].items()}
    want_l = {k: 6 * ZERO_MOE_M for k in ("fwd", "dq", "dkv")}
    check(all({k: v // PIPE_STEPS for k, v in r["launches"].items()} == want_l for r in rs),
          f"(d) MoE launches per step {moe_l} != {want_l}")
    print(f"  (d) MoE LLaMA ZeRO-3, {ZERO_MOE_M} microbatches of one row per rank: fp32 loss "
          f"{losses[0]:.6f} vs one process {want_loss:.6f}, gradients max abs err {err:.2e}, "
          f"routing flips {flips} over {calls} router calls; bf16 loss {first:.4f} (first 3) "
          f"-> {last:.4f} (last 3); step median {_median_ms(rs):.1f} ms; flash launches per "
          f"rank per step {moe_l}", flush=True)
    out["launches"]["moe"] = [{k: v // PIPE_STEPS for k, v in r["launches"].items()} for r in rs]
    # (e): the rule tables' steps against the bespoke builders, bitwise
    for name in ("dp", "zero3"):
        for r in ranks:
            a, b = r["exact"][f"rules {name} table"], r["exact"][f"rules {name} bespoke"]
            check(a["losses"] == b["losses"] and
                  all(np.array_equal(p, q) for p, q in zip(a["params"], b["params"], strict=True)),
                  f"(e) rank {r['rank']}: the {name} table's step differs from the bespoke one")
        losses = ranks[0]["exact"][f"rules {name} table"]["losses"]
        check(losses[-1] < losses[0], f"(e) {name}: loss did not fall: {losses}")
        print(f"  (e) RulePartitioner {name!r} table == bespoke builder, bitwise on every rank "
              f"over {PIPE_STEPS} Adam steps: loss {losses[0]:.4f} -> {losses[-1]:.4f}")
    return out


def zero_inputs(dev) -> tuple:
    """Phase 15's world of 4 (:func:`zero_rank`)."""
    import numpy as np

    from ddl25spring_tpu_torch.data.cifar10 import load_cifar10_u8
    from ddl25spring_tpu_torch.data.tinystories import TinyStories
    from ddl25spring_tpu_torch.data.tokenizer import get_tokenizer

    n = ZERO_N
    c = load_cifar10_u8(n_train=n * ZERO_RESNET_ROWS)
    x, y = c["x"], c["y"].astype(np.int64)
    rng = np.random.default_rng(15)
    order = [rng.permutation(len(x)) for _ in range(ZERO_RESNET_STEPS)]
    ds = iter(TinyStories(get_tokenizer(), batch_size=n * SPTP_ROWS, seq_l=256, seed=0))
    cfg = pipe_cfg("dense", "float32")
    g = np.random.default_rng(16)
    data = {"resnet exact": (x[:n * ZERO_EXACT_ROWS], y[:n * ZERO_EXACT_ROWS]),
            "resnet": [(x[o], y[o]) for o in order],
            "llama exact": _token_batches(cfg, n * SPTP_ROWS, 1, seed=23)[0],
            "llama": [np.asarray(next(ds)) for _ in range(PIPE_STEPS)],
            "moe exact": _token_batches(cfg, n * ZERO_MOE_M, 1, seed=29)[0],
            "mlp": (g.normal(size=(8 * n, 16)).astype(np.float32),
                    g.normal(size=(8 * n, 4)).astype(np.float32)),
            "mlp weights": [(0.1 * g.normal(size=s)).astype(np.float32)
                            for s in ((16, 32), (32,), (32, 4))]}
    data["moe"] = [b[:n * ZERO_MOE_M] for b in data["llama"]]
    return data, dev.type


def zero_phase(dev, ranks=None, data=None):
    """Phase 15: ZeRO stages 1, 2 and 3 and the rule tables on the card, one
    world of 4 ranks (from :func:`chain_phase`; None: spawned here); returns
    the checks' numbers and launches."""
    t0 = time.perf_counter()
    if ranks is None:
        args = zero_inputs(dev)
        ranks, data = own_world(zero_rank, ZERO_N, args), args[0]
    print(f"  {ZERO_N} ranks, backend {sorted({r['backend'] for r in ranks})}", flush=True)
    out = zero_checks(ranks, dev, data)
    print(f"  phase 15 took {time.perf_counter() - t0:.1f} s (its world ran in phase 10)")
    return out


# ---------------------------------------------------------------- phase 16

OBS_STEPS = 12                  # (a): guarded eager bf16 steps
OBS_POISON = 5                  # (a): the step whose loss factor is NaN
OBS_WINDOW_POISON = 9           # (b): the poisoned step inside the fused window of FUSE_K
OBS_TIMED = 3                   # (c): windows of FUSE_K steps per timed block
OBS_PIPE_POISON = (2, (1, 2))   # (e): the step, and the (replica, stage) rank whose loss is NaN
OBS_HALT_STEPS = 4              # (d): steps the halting child is given, the poison at 1


def _bits(tensors) -> list:
    """Each tensor's bits, as integers (a NaN compares equal to itself)."""
    ints = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    return [t.detach().contiguous().view(ints[t.element_size()]).clone() for t in tensors]


def _bitwise(a: list, b: list) -> bool:
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


def _opt_tensors(opt) -> list:
    return [v for st in opt.state.values() for v in st.values() if torch.is_tensor(v)]


def _scaled_lm_loss(model, batch):
    """The LLaMA loss times a factor the batch carries on the card: 1.0, or
    NaN on the step phase 16 poisons, so one code path runs both."""
    from ddl25spring_tpu_torch.ops.losses import causal_lm_loss

    tokens, factor = batch
    return causal_lm_loss(model(tokens), tokens) * factor


def obs_cfg():
    """Phase 16's LLaMA: full width, bf16, the flash kernels."""
    from ddl25spring_tpu_torch.utils.config import LlamaConfig

    return LlamaConfig(dtype="bfloat16", use_flash=True)


def _obs_llama(dev, capturable, guarded, policy="skip", seed=0):
    from ddl25spring_tpu_torch.models.llama import Llama
    from ddl25spring_tpu_torch.obs import sentinels
    from ddl25spring_tpu_torch.parallel.dp import make_train_step

    model = Llama(obs_cfg(), device=dev, generator=torch.Generator().manual_seed(seed))
    # capturable: Adam's state on the card, for a CUDA graph (the CPU has none)
    opt = torch.optim.Adam(model.parameters(), lr=8e-4,
                           capturable=capturable and torch.device(dev).type == "cuda")
    with sentinels.scoped(guarded, policy=policy):
        step = make_train_step(model, _scaled_lm_loss, opt, sentinel=guarded)
    return model, opt, step


def _guard_launches(dev, step, batch) -> int:
    """Kernels one call of ``step`` launches, from torch.profiler."""
    step(batch)
    torch.cuda.synchronize()
    return sum(e.count for e in kernel_events(lambda: step(batch), 1))


def obs_llama(rdv, run_dir, device="cuda"):
    """Phase 16 (a)-(c) and (g), in a process of its own (fresh profiler and
    flight state).  (a) 12 guarded eager steps (policy skip, plain Adam)
    with step 5's loss factor NaN, against 11 unguarded steps without it;
    the run logged into ``run_dir`` (spans, metrics, counters, flight,
    timeline).  (b) the same inside ``fuse_train_steps`` (k = 16,
    capturable Adam), step 9 poisoned, against 15 eager unguarded steps; the
    graph's node counts, guarded and unguarded.  (c) median step per
    16-step window, eager and fused, guarded and unguarded, in turns.
    Returns the numbers and the lines to print."""
    import os
    import tempfile

    from ddl25spring_tpu_torch import obs
    from ddl25spring_tpu_torch.obs import flight, sentinels, timeline
    from ddl25spring_tpu_torch.ops import flash_attention as fa
    from ddl25spring_tpu_torch.parallel.pipeline import fuse_train_steps

    dev, K = torch.device(device, 0) if device == "cuda" else torch.device(device), FUSE_K
    cfg = obs_cfg()
    gen = torch.Generator().manual_seed(16)
    tokens = torch.randint(0, cfg.vocab_size, (OBS_STEPS + 2 * K, MAIN_SHAPE[0], cfg.ctx_size),
                           generator=gen).to(dev)
    factors = torch.ones(OBS_STEPS, device=dev)
    factors[OBS_POISON] = float("nan")
    out, lines = {}, []
    sentinels.reset()
    flight.reset()
    obs.counters.reset()
    # (a) and (g): the guarded eager run, logged
    flight.configure(run_dir=run_dir)
    timeline.configure(run_dir, meta={"phase": 16})
    spans = obs.SpanRecorder(process_name="chip_smoke phase 16")
    logger = obs.MetricsLogger(run_dir, meta=obs.run_metadata(layout="one card",
                                                                 workload="llama"))
    model, opt, step = _obs_llama(dev, False, True)
    check(step.guard is not None, "(a) sentinel=True built no guard")
    fa.reset_launches()
    losses, before, after = [], None, None
    with obs.scoped(True):
        for i in range(OBS_STEPS):
            if i == OBS_POISON:
                sentinels.flush()
                before = _bits(list(model.parameters()) + _opt_tensors(opt))
            t0 = time.perf_counter()
            with spans.span("phase16.step", step=i):
                loss = step((tokens[i], factors[i]))
            losses.append(loss)
            logger.log(step=i, wall_s=time.perf_counter() - t0)
            if i == OBS_POISON:
                sentinels.flush()  # the fold puts Adam's host step counter back
                after = _bits(list(model.parameters()) + _opt_tensors(opt))
        sentinels.flush()
    launches = dict(fa.LAUNCHES)
    by_variant = {n: dict(c) for n, c in fa.LAUNCHES_BY_VARIANT.items()}
    records = flight.last()
    losses = torch.stack(losses).float().tolist()
    violations = [r for r in records if r["kind"] == "violation"]
    clean = [r for r in records if r["kind"] == "step"]
    check(len(records) == OBS_STEPS and len(violations) == 1
          and violations[0]["step"] == OBS_POISON,
          f"(a) {len(records)} records, violations {violations}: not one at step {OBS_POISON}")
    check(all(math.isfinite(r[k]) for r in clean for k in ("loss", "grad_norm", "update_ratio")),
          f"(a) a clean step's facts are not finite: {clean}")
    check(before is not None and _bitwise(before, after),
          "(a) the skipped step changed the parameters or the optimizer state")
    want = {n: 6 * OBS_STEPS for n in ("fwd", "dq", "dkv")}
    check(launches == want and all(by_variant[n]["wgmma"] == 6 * OBS_STEPS for n in want),
          f"(a) flash launches {launches}, by variant {by_variant}: not 6 a step on wgmma")
    # the unguarded run from the same weights, the poisoned batch left out
    plain, plain_opt, plain_step = _obs_llama(dev, False, False)
    ref = [plain_step((tokens[i], factors[i])).float().item()
           for i in range(OBS_STEPS) if i != OBS_POISON]
    mine = [x for i, x in enumerate(losses) if i != OBS_POISON]
    check(mine == ref, f"(a) clean guarded losses {mine} vs unguarded {ref}: not bitwise")
    check(_bitwise(_bits(model.parameters()), _bits(plain.parameters())),
          "(a) the guarded run's parameters differ from the unguarded run's")
    guard_launches = (_guard_launches(dev, step, (tokens[0], factors[0]))
                      - _guard_launches(dev, plain_step, (tokens[0], factors[0])))
    lines.append(f"  (a) guarded eager, {OBS_STEPS} steps, skip: 1 violation at step "
                 f"{violations[0]['step']} ({violations[0]['violating_metric']}, "
                 f"{len(violations[0].get('nonfinite_leaves', []))} non-finite leaves); "
                 f"parameters and Adam state bitwise unchanged across it; the {OBS_STEPS - 1} "
                 f"clean losses bitwise the unguarded run's ({mine[0]:.4f} -> {mine[-1]:.4f}); "
                 f"launches {launches} (wgmma); the guard's own kernels per step "
                 f"{guard_launches}")
    obs.counters.save(run_dir)
    spans.save(os.path.join(run_dir, "trace.json"))
    logger.close()
    flight.dump(reason="end_of_run")
    timeline.configure(None)
    out.update(eager_launches=launches, guard_launches=guard_launches)
    # (b): the window, step 9 poisoned, against 15 eager unguarded steps
    window = tokens[OBS_STEPS:OBS_STEPS + K]
    wf = torch.ones(K, device=dev)
    wf[OBS_WINDOW_POISON] = float("nan")
    sentinels.reset()
    flight.reset()
    fmodel, fopt, fstep = _obs_llama(dev, True, True)
    emodel, eopt, estep = _obs_llama(dev, True, False)
    ref = [estep((window[i], wf[i])).float().item() for i in range(K)
           if i != OBS_WINDOW_POISON]
    fa.reset_launches()
    with tempfile.TemporaryDirectory() as tmp:
        dumps = {"guarded": os.path.join(tmp, "guarded.dot")}
        multi = fuse_train_steps(fstep, K, module=fmodel, optimizer=fopt, device=dev,
                                 dump_graph=dumps["guarded"])
        fused = multi((window, wf))
        captured = {n: dict(c) for n, c in fa.CAPTURED.items()}
        umodel, uopt, ustep = _obs_llama(dev, True, False)
        dumps["unguarded"] = os.path.join(tmp, "unguarded.dot")
        umulti = fuse_train_steps(ustep, K, module=umodel, optimizer=uopt, device=dev,
                                  dump_graph=dumps["unguarded"])
        umulti((window, torch.ones(K, device=dev)))
        census = {}
        for name, path in dumps.items():
            check(os.path.exists(path), f"(b) CUDAGraph.debug_dump wrote no {path}")
            census[name] = ({}, 0)
            if os.path.exists(path):
                with open(path) as f:
                    census[name] = graph_census(f.read())
    sentinels.flush()
    records = flight.last()
    fused = fused.float().tolist()
    kinds = [r["kind"] for r in records]
    check([r["step"] for r in records] == list(range(K))
          and kinds.count("violation") == 1 and kinds[OBS_WINDOW_POISON] == "violation",
          f"(b) window records {kinds} (steps {[r['step'] for r in records]})")
    check([x for i, x in enumerate(fused) if i != OBS_WINDOW_POISON] == ref,
          f"(b) fused clean losses {fused} vs eager unguarded {ref}: not bitwise")
    check(_bitwise(_bits(list(fmodel.parameters()) + _opt_tensors(fopt)),
                   _bits(list(emodel.parameters()) + _opt_tensors(eopt))),
          f"(b) after the window, parameters or Adam state differ from {K - 1} clean eager steps")
    flash_nodes = {n: c for n, c in census["guarded"][0].items() if c}
    check(flash_nodes == {f"flash_{n}_wgmma": 6 * K for n in ("fwd", "dq", "dkv")}
          and all(c == {"wgmma": 6 * K, "tf32x3": 0, "scalar": 0} for c in captured.values()),
          f"(b) the guarded graph's flash nodes {flash_nodes}, captured {captured}")
    nodes = {name: c[1] for name, c in census.items()}
    lines.append(f"  (b) fused window of {K}, step {OBS_WINDOW_POISON} poisoned: {K} records "
                 "in step order, 1 violation; clean losses, parameters and Adam state bitwise "
                 f"{K - 1} eager unguarded steps'; graph nodes guarded {nodes['guarded']}, "
                 f"unguarded {nodes['unguarded']} (+{nodes['guarded'] - nodes['unguarded']}, "
                 f"{(nodes['guarded'] - nodes['unguarded']) / K:.1f} a step); flash nodes "
                 f"{flash_nodes}")
    out.update(nodes=nodes, fused_launches=flash_nodes)
    # (c): host wall per step, windows of K, guarded and unguarded in turns
    clean_window = (tokens[OBS_STEPS + K:OBS_STEPS + 2 * K], torch.ones(K, device=dev))
    runs = {"eager guarded": lambda: [step((clean_window[0][i], clean_window[1][i]))
                                      for i in range(K)],
            "eager unguarded": lambda: [plain_step((clean_window[0][i], clean_window[1][i]))
                                        for i in range(K)],
            "fused guarded": lambda: multi(clean_window),
            "fused unguarded": lambda: umulti(clean_window)}
    times = {name: [] for name in runs}
    for order in (list(runs), list(runs)[::-1]):
        for name in order:
            times[name] += _window_ms(runs[name], K, OBS_TIMED)
    sentinels.flush()
    med = {name: statistics.median(ts) for name, ts in times.items()}
    for kind in ("eager", "fused"):
        g, u = med[f"{kind} guarded"], med[f"{kind} unguarded"]
        lines.append(f"  (c) {kind}: median step guarded {g:.3f} ms, unguarded {u:.3f} ms "
                     f"({(g / u - 1) * 100:+.1f} %), {2 * OBS_TIMED} windows of {K} each")
    out["step_ms"] = med
    return out, lines


_HALT_CHILD = r"""
import sys, torch
sys.path.insert(0, sys.argv[2])
import chip_smoke as cs
from ddl25spring_tpu_torch.obs import flight, sentinels

torch.backends.cuda.matmul.allow_tf32 = False
dev = torch.device(sys.argv[3])
flight.configure(run_dir=sys.argv[1])
model, opt, step = cs._obs_llama(dev, False, True, policy="halt")
cfg = cs.obs_cfg()
tokens = torch.randint(0, cfg.vocab_size, (cs.OBS_HALT_STEPS, 3, cfg.ctx_size),
                       generator=torch.Generator().manual_seed(4)).to(dev)
for i in range(cs.OBS_HALT_STEPS):
    factor = torch.full((), float("nan") if i == 1 else 1.0, device=dev)
    step((tokens[i], factor))
    print(f"STEP {i} returned", flush=True)
sentinels.flush()
print("NO RAISE", flush=True)
"""


def obs_halt_start(tmp, device="cuda"):
    """(d): a child process running guarded steps under ``halt``, step 1's
    loss NaN; it must die of the violation.  Started here, read by
    :func:`obs_halt_check`."""
    import os

    root = os.path.dirname(os.path.abspath(__file__))
    return subprocess.Popen([sys.executable, "-c", _HALT_CHILD, tmp, root, device], cwd=root,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def obs_halt_check(proc, tmp) -> str:
    import os

    out, err = proc.communicate(timeout=SPAWN_TIMEOUT)
    returned = [int(x) for x in re.findall(r"STEP (\d+) returned", out)]
    check(proc.returncode != 0 and "NO RAISE" not in out,
          f"(d) the halting child exited {proc.returncode}: {out[-500:]} {err[-1500:]}")
    check("SentinelViolation" in err, f"(d) the child died of something else: {err[-1500:]}")
    check(max(returned, default=-1) <= 1,
          f"(d) halt surfaced after step {max(returned)}: more than one step late")
    with open(os.path.join(tmp, "flight.json")) as f:
        doc = json.load(f)
    v = doc.get("last_violation", {})
    check(doc["reason"] == "sentinel_halt" and v.get("step") == 1 and v.get("violating_metric"),
          f"(d) flight.json reason {doc['reason']}, last violation {v}")
    return (f"  (d) halt: the child raised SentinelViolation after step(s) {returned} returned "
            f"(poison at 1), exit {proc.returncode}; flight.json: {doc['reason']}, step "
            f"{v['step']}, {v['violating_metric']}")


def obs_pipe_rank(rdv, params, batches, device):
    """(e): one rank of the 2 x 3 DP x PP LLaMA (bf16, flash, gpipe, Adam
    8e-4, instrument and sentinel on, skip); the loss of rank
    ``OBS_PIPE_POISON[1]`` is NaN at step ``OBS_PIPE_POISON[0]`` through a
    factor on the card.  Returns its records, whether the poisoned step left
    its parameters and Adam state bitwise, its statics, ticks and launches."""
    from ddl25spring_tpu_torch import obs
    from ddl25spring_tpu_torch.obs import flight, sentinels
    from ddl25spring_tpu_torch.ops import flash_attention as fa
    from ddl25spring_tpu_torch.parallel import pipeline as pl
    from ddl25spring_tpu_torch.utils.mesh import init_mesh

    cfg = obs_cfg()
    factor = torch.ones((), device=torch.device(device, 0) if device == "cuda" else "cpu")
    loss = pl.causal_lm_loss
    pl.causal_lm_loss = lambda logits, tokens: loss(logits, tokens) * factor
    poison_step, poison_rank = OBS_PIPE_POISON
    with init_mesh(rdv, DP, PP, device=device) as mesh:
        stage = pl.shard_staged_params(params, cfg, mesh)
        opt = torch.optim.Adam(stage.parameters(), lr=8e-4)
        with sentinels.scoped(True, policy="skip"):
            step = pl.make_pipeline_train_step(stage, cfg, opt, mesh, MICRO, instrument=True,
                                               sentinel=True)
        out = {"coords": mesh.coords, "losses": []}
        fa.reset_launches()
        for i, b in enumerate(batches):
            mine = i == poison_step and mesh.coords == poison_rank
            if i == poison_step:
                sentinels.flush()
                before = _bits(list(stage.parameters()) + _opt_tensors(opt))
            if mine:
                factor.fill_(float("nan"))
            loss_i = step(torch.from_numpy(b).long())
            factor.fill_(1.0)
            out["losses"].append(None if loss_i is None else float(loss_i))
            if i == poison_step:
                sentinels.flush()
                out["unchanged"] = _bitwise(before, _bits(list(stage.parameters())
                                                          + _opt_tensors(opt)))
        sentinels.flush()
        out["launches"] = dict(fa.LAUNCHES)
        out["by_variant"] = {n: dict(c) for n, c in fa.LAUNCHES_BY_VARIANT.items()}
        out["records"] = flight.last()
        snap = obs.counters.snapshot()
        out["static"] = snap["static"]
        out["ticks"] = len(snap["series"].get("pipeline.tick", []))
        return out


def obs_pipe_checks(ranks) -> list[str]:
    from ddl25spring_tpu_torch.obs import gpipe_bubble_fraction

    poison_step = OBS_PIPE_POISON[0]
    n = len(ranks[0]["losses"])
    per_rank = [len(r["records"]) for r in ranks]
    check(per_rank == [n] + [0] * (len(ranks) - 1),
          f"(e) records per rank {per_rank}: only rank 0 records, once a step")
    kinds = [r["kind"] for r in ranks[0]["records"]]
    check(kinds.count("violation") == 1 and kinds[poison_step] == "violation",
          f"(e) rank 0's records {kinds}: not one violation at step {poison_step}")
    check(all(r["unchanged"] for r in ranks),
          f"(e) the skipped step changed some rank: {[r['unchanged'] for r in ranks]}")
    want = {"pipeline.num_stages": PP, "pipeline.num_microbatches": MICRO,
            "pipeline.num_chunks": 1,
            "pipeline.bubble_fraction_gpipe": gpipe_bubble_fraction(PP, MICRO)}
    for r in ranks:
        check(r["static"] == want, f"(e) rank {r['coords']} statics {r['static']}")
        check(r["ticks"] > 0 and r["ticks"] % n == 0, f"(e) rank {r['coords']} ticks {r['ticks']}")
        per_step = {k: v / n for k, v in r["launches"].items()}
        check(per_step == {"fwd": 2 * MICRO, "dq": 2 * MICRO, "dkv": 2 * MICRO}
              and all(v["scalar"] == 0 for v in r["by_variant"].values()),
              f"(e) rank {r['coords']} launches {r['launches']} over {n} steps")
    last = [r for r in ranks if r["coords"] == (0, PP - 1)][0]["losses"]
    check(not math.isfinite(last[poison_step])
          and all(math.isfinite(x) for i, x in enumerate(last) if i != poison_step),
          f"(e) the last stage's losses {last}")
    v = ranks[0]["records"][poison_step]
    return [f"  (e) 2 x 3 DP x PP gpipe, {n} bf16 steps, rank {OBS_PIPE_POISON[1]}'s loss NaN "
            f"at step {poison_step}: one violation, on rank 0 only ({v['violating_metric']}); "
            "every rank's parameters and Adam state bitwise unchanged by it; statics "
            f"{want}; ticks per rank per step {ranks[0]['ticks'] // n}; flash launches per "
            f"rank per step {2 * MICRO}/{2 * MICRO}/{2 * MICRO} on wgmma; losses {last}"]


def obs_trace(tmp, device="cuda") -> str:
    """(f): ``lab.dp_pp --workload llama --trace-dir``: the reporting rank's
    trace holds its steps' spans and the three flash kernels."""
    import os

    from ddl25spring_tpu_torch.lab import dp_pp

    run = dp_pp.main(["--workload", "llama", "--iters", "3", "--trace-dir", tmp,
                      "--device", device])
    check(len(run["losses"]) == 3 and all(math.isfinite(x) for x in run["losses"]),
          f"(f) lab losses {run['losses']}")
    with open(os.path.join(tmp, "trace.json")) as f:
        names = {str(e.get("name")) for e in json.load(f)["traceEvents"]}
    flash = {k: any(k in n for n in names)
             for k in ("flash_fwd_wgmma", "flash_dq_wgmma", "flash_dkv_wgmma")}
    check("dp_pp.step" in names and all(flash.values()),
          f"(f) the trace's names hold dp_pp.step: {'dp_pp.step' in names}, flash {flash}")
    return (f"  (f) lab.dp_pp --trace-dir: {len(names)} event names, dp_pp.step spans and "
            f"the three flash kernels in the reporting rank's trace.json")


def obs_export(run_dir) -> str:
    """(g): the run directory (a) wrote, merged by ``tools/trace_export.py``."""
    import os

    files = sorted(os.listdir(run_dir))
    want = {"trace.json", "metrics.jsonl", "counters.json", "flight.json", "timeline.jsonl"}
    check(want <= set(files), f"(g) the run directory holds {files}, not {sorted(want)}")
    root = os.path.dirname(os.path.abspath(__file__))
    r = subprocess.run([sys.executable, os.path.join(root, "tools", "trace_export.py"),
                        run_dir, "--check"], capture_output=True, text=True, timeout=120)
    check(r.returncode == 0, f"(g) trace_export --check exited {r.returncode}: "
                             f"{r.stdout[-800:]} {r.stderr[-800:]}")
    return f"  (g) run directory {sorted(want)}: trace_export --check exit 0"


def obs_phase(dev, device="cuda"):
    """Phase 16, each sub-phase timed; returns the launch counts and times
    (``device``: where the spawned processes run, ``"cpu"`` to rehearse)."""
    import os
    import tempfile

    from ddl25spring_tpu_torch.models.llama import Llama, export_params
    from ddl25spring_tpu_torch.parallel.launch import spawn
    from ddl25spring_tpu_torch.utils.config import replace

    with tempfile.TemporaryDirectory() as tmp:
        run_dir = os.path.join(tmp, "run")
        t0 = time.perf_counter()
        (llama, lines), = spawn(obs_llama, 1, run_dir, device, timeout=SPAWN_TIMEOUT)
        for line in lines:
            print(line)
        print(f"  (a)-(c) took {time.perf_counter() - t0:.1f} s", flush=True)
        halt_dir = os.path.join(tmp, "halt")
        os.makedirs(halt_dir)
        halt = obs_halt_start(halt_dir, device)
        t0 = time.perf_counter()
        cfg = replace(obs_cfg(), dtype="float32")
        params = export_params(Llama(cfg, device="cpu", generator=torch.Generator().manual_seed(7)))
        batches = _token_batches(cfg, DP * ROWS, PIPE_STEPS, 17)
        ranks = spawn(obs_pipe_rank, DP * PP, params, batches, device, timeout=SPAWN_TIMEOUT)
        for line in obs_pipe_checks(ranks):
            print(line)
        print(f"  (e) took {time.perf_counter() - t0:.1f} s", flush=True)
        t0 = time.perf_counter()
        print(obs_trace(os.path.join(tmp, "trace"), device))
        print(f"  (f) took {time.perf_counter() - t0:.1f} s", flush=True)
        print(obs_halt_check(halt, halt_dir))
        print(obs_export(run_dir))
    llama["pipe_launches"] = [{k: v // PIPE_STEPS for k, v in r["launches"].items()}
                              for r in ranks]
    return llama


# ---------------------------------------------------------------- phase 17

FT_ITERS = 8                    # (a), (b): the uninterrupted lab runs' steps
FT_EVERY = 2                    # (a), (b): --ckpt-every
FT_HALF = 3                     # (a): each of B's two runs
FT_KILL_AFTER = 3               # (b): SIGKILL once this step is durable
FT_GATE_STEPS = 6               # (c): guarded steps, one autosave each
FT_GATE_POISON = 3              # (c): the step whose loss factor is NaN
FT_ZERO_N = 4                   # (d): ranks; n = 2 regrids them to 2 x 2
FT_ZERO_ROWS = 4                # (d): global rows per step
FT_ZERO_EPS = 1e-6              # (d): Adam's eps (the parity tests' value; see ft_zero_rank)
FT_BAND = 2e-5                  # (d): atol and rtol, the JAX test's assert_allclose (test_elastic.py)
FT_ZERO_LAYERS = 2              # (d): the fp32 LLaMA's depth (full width), cut from 6
FT_LAB = ["--workload", "llama"]  # the lab's flags (2 x 3, gpipe, full width, flash)


def _ft_bits_equal(a: dict, b: dict) -> tuple[bool, str]:
    """Two restored checkpoints (nested dicts of host tensors), leaf by leaf,
    bitwise (NaN equal to itself); the first leaf that differs."""
    from ddl25spring_tpu_torch.utils import pytree

    fa, fb = pytree.flatten_with_path(a), pytree.flatten_with_path(b)
    if [p for p, _ in fa] != [p for p, _ in fb]:
        return False, "the keys differ"
    for (path, x), (_, y) in zip(fa, fb):
        if x.dtype != y.dtype or not _bitwise(_bits([x]), _bits([y])):
            return False, pytree.slashed(path)
    return True, ""


def _ft_lab(device, ckpt_dir, iters, every=FT_EVERY):
    """One run of ``lab.dp_pp --workload llama`` (2 x 3, gpipe, full width,
    bf16 on the card, flash), checkpointed into ``ckpt_dir`` when given."""
    from ddl25spring_tpu_torch.lab import dp_pp

    argv = [*FT_LAB, "--device", device, "--iters", str(iters)]
    if ckpt_dir:
        argv += ["--ckpt-dir", ckpt_dir, "--ckpt-every", str(every)]
    return dp_pp.main(argv)


def _ft_launch_check(tag, run, steps):
    """Every rank of a lab run launched each flash kernel 2 x M times a step
    (its 2 layers, M microbatches), all on ``wgmma`` on the card."""
    want = {n: 2 * MICRO * steps for n in ("fwd", "dq", "dkv")}
    for r in run["ranks"]:
        check(r["launches"] == want
              and all(v.get("scalar", 0) == 0 for v in r["launches_by_variant"].values()),
              f"{tag} rank {r['coords']} launches {r['launches']} by variant "
              f"{r['launches_by_variant']}, not {want} on wgmma")


def ft_resume(tmp, device="cuda") -> tuple[dict, list[str]]:
    """(a) A: ``FT_ITERS`` steps with ``--ckpt-every 2``; B: ``FT_HALF`` steps
    twice, the second resuming from step ``FT_HALF - 1``: B's step 5 equals
    A's bitwise, stage by stage.  (b) C, beside B: the same run as A in a
    process group of its own, SIGKILLed once step ``FT_KILL_AFTER`` is
    durable, relaunched for the steps left: its last checkpoint equals A's
    bitwise.  (e) an unchecked run of ``FT_ITERS`` steps for the step time
    without checkpoints, and the walls of a save and a restore."""
    import os
    import signal
    import threading

    from ddl25spring_tpu_torch.ft.manifest import latest_durable_step
    from ddl25spring_tpu_torch.utils.checkpoint import Checkpointer

    A, B, C = (os.path.join(tmp, x) for x in "ABC")
    lines, out = [], {}
    a = _ft_lab(device, A, FT_ITERS)
    _ft_launch_check("(a) A", a, FT_ITERS)
    # (b) runs beside B: C is launched as a process group of its own, and a
    # watcher SIGKILLs the group once step FT_KILL_AFTER is durable
    root = os.path.dirname(os.path.abspath(__file__))
    log = open(os.path.join(tmp, "c.log"), "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "ddl25spring_tpu_torch.lab.dp_pp", *FT_LAB, "--device", device,
         "--iters", str(FT_ITERS), "--ckpt-every", str(FT_EVERY), "--ckpt-dir", C],
        cwd=root, stdout=log, stderr=subprocess.STDOUT, start_new_session=True)

    def watch():
        deadline = time.monotonic() + SPAWN_TIMEOUT
        try:
            while proc.poll() is None and time.monotonic() < deadline:
                d = latest_durable_step(C)
                if d is not None and d >= FT_KILL_AFTER:
                    break
                time.sleep(0.005)
        finally:
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()

    watcher = threading.Thread(target=watch, name="ft-kill-watcher")
    watcher.start()
    try:
        b1 = _ft_lab(device, B, FT_HALF)
        b2 = _ft_lab(device, B, FT_HALF)
    finally:
        watcher.join()
        log.close()
    check({r["start"] for r in b2["ranks"]} == {FT_HALF},
          f"(a) B's second run started at {[r['start'] for r in b2['ranks']]}, not "
          f"{FT_HALF} (resumed from step {FT_HALF - 1})")
    _ft_launch_check("(a) B", b2, FT_HALF)
    check(a["losses"][:2 * FT_HALF] == b1["losses"] + b2["losses"],
          f"(a) losses A {a['losses']} vs B {b1['losses']} + {b2['losses']}")
    last_b = 2 * FT_HALF - 1
    Checkpointer(A).restore(last_b)        # the first restore also loads the library
    t0 = time.perf_counter()
    want = Checkpointer(A).restore(last_b)
    out["restore_s"] = time.perf_counter() - t0
    same, where = _ft_bits_equal(Checkpointer(B).restore(last_b), want)
    check(same, f"(a) B's step {last_b} differs from A's at {where}")
    stages = sorted(want)
    kinds = sorted({k for st in want.values() for o in st["opt_state"].values() for k in o})
    lines.append(f"  (a) lab 2 x 3 gpipe bf16, A {FT_ITERS} steps (--ckpt-every {FT_EVERY}), B "
                 f"{FT_HALF} + {FT_HALF} (resumed from step {FT_HALF - 1}): losses bitwise, "
                 f"B's step {last_b} bitwise A's, {stages}, parameters and Adam {kinds}; "
                 f"each rank 6/6/6 wgmma launches a step")
    # (b): the SIGKILLed run, relaunched for the steps left
    with open(os.path.join(tmp, "c.log")) as f:
        tail = f.read()[-1500:]
    check(proc.returncode == -signal.SIGKILL,
          f"(b) the run ended with {proc.returncode} before the kill: {tail}")
    d = latest_durable_step(C)
    check(d is not None and FT_KILL_AFTER <= d < FT_ITERS - 1,
          f"(b) durable step {d} after the kill, not in [{FT_KILL_AFTER}, {FT_ITERS - 2}]")
    entries = sorted(os.listdir(C))
    steps = [e for e in entries if e.isdigit()]
    check(all(os.path.exists(os.path.join(C, s, ".metadata")) for s in steps)
          and max(int(s) for s in steps) == d,
          f"(b) directory after the kill {entries}: a committed step without its metadata")
    c = _ft_lab(device, C, FT_ITERS - (d + 1))
    check({r["start"] for r in c["ranks"]} == {d + 1},
          f"(b) the relaunch started at {[r['start'] for r in c['ranks']]}, not {d + 1}")
    _ft_launch_check("(b) relaunch", c, FT_ITERS - (d + 1))
    same, where = _ft_bits_equal(Checkpointer(C).restore(FT_ITERS - 1),
                                 Checkpointer(A).restore(FT_ITERS - 1))
    check(same, f"(b) the relaunched run's step {FT_ITERS - 1} differs from A's at {where}")
    lines.append(f"  (b) SIGKILL of the process group with step {d} durable (staging left: "
                 f"{[e for e in entries if 'tmp' in e]}, invisible), relaunch of "
                 f"{FT_ITERS - (d + 1)} steps from step {d + 1}: step {FT_ITERS - 1} bitwise "
                 "the uninterrupted run's")
    # (e): the step with and without checkpoints, and each save's blocking wall
    plain = _ft_lab(device, "", FT_ITERS)
    _ft_launch_check("(e) unchecked", plain, FT_ITERS)
    saves = [s for r in a["ranks"] for s in r["ckpt_s"]]
    out.update(step_ckpt_ms=_median_ms(a["ranks"]), step_plain_ms=_median_ms(plain["ranks"]),
               save_block_ms=statistics.median(saves) * 1e3, save_block_max_ms=max(saves) * 1e3,
               lab_launches=[{k: v // FT_ITERS for k, v in r["launches"].items()}
                             for r in sorted(a["ranks"], key=lambda r: r["rank"])])
    lines.append(f"  (e) lab median step (slowest rank, steps 1..{FT_ITERS - 1}): "
                 f"{out['step_ckpt_ms']:.3f} ms with --ckpt-every {FT_EVERY}, "
                 f"{out['step_plain_ms']:.3f} ms without; an async save blocks "
                 f"{out['save_block_ms']:.3f} ms (median over ranks and saves, max "
                 f"{out['save_block_max_ms']:.3f}); a single-process restore of the "
                 f"2 x 3 checkpoint {out['restore_s'] * 1e3:.1f} ms (warm)")
    return out, lines


def ft_gate(rdv, ckpt_dir, device="cuda"):
    """(c), in a process of its own (fresh flight and sentinel state): the
    guarded full-width LLaMA step (policy skip, plain Adam) with an
    ``AutoSaver(save_every=1, async_save=False)``; step ``FT_GATE_POISON``'s
    loss factor is NaN, and the gate judges by the sentinels alone (no loss
    handed to it).  Returns the skipped records, the manifest, whether the
    restore of the last durable step equals the live state bitwise, and the
    save and restore walls."""
    import os

    from ddl25spring_tpu_torch.ft import AutoSaver, read_manifest, resume_bundle
    from ddl25spring_tpu_torch.obs import flight, sentinels
    from ddl25spring_tpu_torch.ops import flash_attention as fa
    from ddl25spring_tpu_torch.utils import checkpoint as ck

    dev = torch.device(device, 0) if device == "cuda" else torch.device(device)
    cfg = obs_cfg()
    sentinels.reset()
    flight.reset()
    model, opt, step = _obs_llama(dev, False, True)
    named = list(model.named_parameters())
    tokens = torch.randint(0, cfg.vocab_size, (FT_GATE_STEPS, MAIN_SHAPE[0], cfg.ctx_size),
                           generator=torch.Generator().manual_seed(17)).to(dev)
    factors = torch.ones(FT_GATE_STEPS, device=dev)
    factors[FT_GATE_POISON] = float("nan")
    saver = AutoSaver(ckpt_dir, save_every=1, max_to_keep=FT_GATE_STEPS, async_save=False)
    fa.reset_launches()
    saved, save_s = [], []
    for i in range(FT_GATE_STEPS):
        step((tokens[i], factors[i]))
        t0 = time.perf_counter()
        saved.append(saver.maybe_save(i, resume_bundle(
            {n: p.detach() for n, p in named}, ck.optimizer_state(opt, named),
            data_cursor=i + 1)))
        save_s.append(time.perf_counter() - t0)
    saver.close()
    launches = dict(fa.LAUNCHES)
    live = _bits([p for _, p in named] + [opt.state[p][k] for _, p in named
                                          for k in ("exp_avg", "exp_avg_sq", "step")])
    skipped = [r for r in flight.last() if r["kind"] == "save_skipped"]
    fresh, fresh_opt, _ = _obs_llama(dev, False, False, seed=1)
    fnamed = list(fresh.named_parameters())
    t0 = time.perf_counter()
    saver2 = AutoSaver(ckpt_dir, save_every=1)
    state, nxt = saver2.restore_or_init(resume_bundle(
        {n: p.detach() for n, p in fnamed}, ck.optimizer_template(fresh_opt, fnamed)))
    restore_s = time.perf_counter() - t0
    saver2.close()
    got = _bits([state["params"][n] for n, _ in named]
                + [state["opt_state"][n][k] for n, _ in named
                   for k in ("exp_avg", "exp_avg_sq", "step")])
    return {"saved": saved, "skipped": skipped, "manifest": read_manifest(ckpt_dir),
            "next": nxt, "bitwise": _bitwise(live, got), "launches": launches,
            "save_ms": [s * 1e3 for s in save_s], "restore_ms": restore_s * 1e3,
            "steps_on_disk": sorted(int(p) for p in os.listdir(ckpt_dir) if p.isdigit())}


def ft_gate_checks(g) -> str:
    check(g["saved"] == [i != FT_GATE_POISON for i in range(FT_GATE_STEPS)],
          f"(c) saves {g['saved']}: not every step but {FT_GATE_POISON}")
    check(len(g["skipped"]) == 1 and g["skipped"][0]["step"] == FT_GATE_POISON
          and g["skipped"][0]["reason"] == "sentinel_violation",
          f"(c) save_skipped records {g['skipped']}")
    man = g["manifest"]
    check(man["save_skipped"] == 1 and man["last_durable_step"] == FT_GATE_STEPS - 1
          and FT_GATE_POISON not in g["steps_on_disk"],
          f"(c) manifest {man}, steps on disk {g['steps_on_disk']}")
    check(g["next"] == FT_GATE_STEPS and g["bitwise"],
          f"(c) restore_or_init gave next step {g['next']}, bitwise {g['bitwise']}")
    want = {n: 6 * FT_GATE_STEPS for n in ("fwd", "dq", "dkv")}
    check(g["launches"] == want, f"(c) launches {g['launches']}, not {want}")
    return (f"  (c) guarded LLaMA, skip, AutoSaver every step: step {FT_GATE_POISON} poisoned -> "
            f"1 save_skipped (sentinel_violation), manifest save_skipped 1, steps on disk "
            f"{g['steps_on_disk']}, restore_or_init of step {FT_GATE_STEPS - 1} bitwise the "
            f"live parameters and Adam state; a synchronous save of the full state "
            f"{statistics.median(g['save_ms']):.1f} ms (median), restore "
            f"{g['restore_ms']:.1f} ms")


def ft_zero_rank(rdv, batches, ckpt_dir, device="cuda"):
    """(d): one rank of 4 on the card (gloo through pinned host buffers),
    regridded to 2 x 2 for n = 2: the fp32 full-width LLaMA ZeRO-3 (Adam 8e-4,
    eps ``FT_ZERO_EPS``: at 1e-8 Adam moves a gradient at rounding-noise size
    by up to its rate, and the two layouts round their sums differently),
    4 uninterrupted steps at n = 2; 2 steps at n = 4 autosaved, a live
    reshape to n = 2, 2 steps; 2 steps at n = 2, a reshape to n = 4, 2 steps;
    the n = 4 checkpoint restored on n = 2.  Returns rows, states, walls and
    launches."""
    from ddl25spring_tpu_torch.ft import AutoSaver, elastic, reshard, resume_bundle
    from ddl25spring_tpu_torch.models.llama import Llama
    from ddl25spring_tpu_torch.ops import flash_attention as fa
    from ddl25spring_tpu_torch.parallel import zero
    from ddl25spring_tpu_torch.utils import pytree
    from ddl25spring_tpu_torch.utils.mesh import init_mesh

    from ddl25spring_tpu_torch.utils.config import replace

    cfg = replace(pipe_cfg("dense", "float32"), n_layers=FT_ZERO_LAYERS)
    out = {"launches": {}, "by_variant": {}}
    with init_mesh(rdv, FT_ZERO_N, stages=1, device=device) as mesh4:
        dev = mesh4.device
        meshes = {FT_ZERO_N: mesh4, 2: mesh4.regrid(2, stages=2)}
        toks = [torch.from_numpy(b).long() for b in batches]

        def fresh(n):
            model = Llama(cfg, device=dev, generator=torch.Generator().manual_seed(0))
            rows = zero.zero_shard_llama_params(model, meshes[n])
            opt = torch.optim.Adam(rows.parameters(), lr=8e-4, eps=FT_ZERO_EPS)
            return model, rows, opt, zero.make_zero3_llama_train_step(model, opt, meshes[n], rows)

        def adopt(model, n, state):
            rows = zero.zero_rows_from_state(state, model, llama=True)
            opt = torch.optim.Adam(rows.parameters(), lr=8e-4, eps=FT_ZERO_EPS)
            zero.zero_load_optimizer(opt, rows, state, model)
            return rows, opt, zero.make_zero3_llama_train_step(model, opt, meshes[n], rows)

        def run(tag, step, ids):
            fa.reset_launches()
            for i in ids:
                step(toks[i])
            out["launches"][tag] = {k: v // len(ids) for k, v in fa.LAUNCHES.items()}
            out["by_variant"][tag] = {
                k: {x: c // len(ids) for x, c in v.items() if c}
                for k, v in fa.LAUNCHES_BY_VARIANT.items()}

        def np_rows(rows):
            return [r.detach().cpu().numpy() for r in rows.parameters()]

        def np_state(state):
            return {pytree.keystr(p): (x.local if isinstance(x, reshard.Rows) else x)
                    .detach().cpu().clone() for p, x in pytree.flatten_with_path(state)}

        _, rows, _, step = fresh(2)
        run("n2", step, range(4))
        out["ref"] = np_rows(rows)
        for first, second in ((FT_ZERO_N, 2), (2, FT_ZERO_N)):
            model, rows, opt, step = fresh(first)
            saver = None
            if first == FT_ZERO_N:
                saver = AutoSaver(ckpt_dir, save_every=1, async_save=False)
            run(f"n{first} before", step, range(2))
            if saver is not None:
                st = zero.zero_state(rows, opt, meshes[first], model)
                t0 = time.perf_counter()
                saver.maybe_save(1, resume_bundle(st["params"], st["opt_state"], data_cursor=2,
                                                  rng_seed=0))
                out["save_s"] = time.perf_counter() - t0
                saver.close()
            t0 = time.perf_counter()
            state = elastic.reshape_state(
                zero.zero_state(rows, opt, meshes[first], model),
                zero.zero_resume_template(model, opt, meshes[second], llama=True, abstract=True))
            rows2, opt2, step2 = adopt(model, second, state)
            if dev.type == "cuda":
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            ev = elastic.record_reshape(old=meshes[first].axis("data"),
                                        new=meshes[second].axis("data"), wall_s=wall,
                                        steps_lost=0, reason="device_loss")
            if first == FT_ZERO_N:
                out["live"] = np_state({"params": state["params"],
                                        "opt_state": state["opt_state"]})
            run(f"n{second} after", step2, (2, 3))
            out[f"{first}->{second}"] = {"rows": np_rows(rows2), "event": ev, "wall_s": wall}
            del model, rows, opt, step, rows2, opt2, step2, state
        fresh_model = Llama(cfg, device=dev, generator=torch.Generator().manual_seed(5))
        opt = torch.optim.Adam([torch.zeros(1, requires_grad=True)], lr=8e-4, eps=FT_ZERO_EPS)
        tmpl = zero.zero_resume_template(fresh_model, opt, meshes[2], llama=True)
        saver2 = AutoSaver(ckpt_dir, save_every=1)
        t0 = time.perf_counter()
        state, nxt = saver2.restore_or_init(resume_bundle(tmpl["params"], tmpl["opt_state"],
                                                          rng_seed=0))
        out["restore_s"] = time.perf_counter() - t0
        saver2.close()
        out["restored"] = (np_state({"params": state["params"], "opt_state": state["opt_state"]}),
                           nxt, int(state["data_cursor"]))
        out["rank"] = mesh4.rank
    return out


def ft_zero_inputs(zdir, device) -> tuple:
    """Phase 17 (d)'s world of 4 (:func:`ft_zero_rank`), checkpointing into
    ``zdir``."""
    return _token_batches(pipe_cfg("dense", "float32"), FT_ZERO_ROWS, 4, seed=31), zdir, device


def ft_zero_checks(ranks, ckpt_dir) -> tuple[dict, list[str]]:
    """(d)'s checks: the reshaped runs within ``FT_BAND`` of the
    uninterrupted n = 2 run (the rows unsharded over a DP line), the flight
    events, the checkpoint route bitwise the live reshape, the saved
    ``leaf_shapes``; returns the launches and walls."""
    import numpy as np

    from ddl25spring_tpu_torch.ft import read_manifest

    ranks = sorted(ranks, key=lambda r: r["rank"])
    lines = []

    def full(line, key=None):
        rows = [ranks[r]["ref"] if key is None else ranks[r][key]["rows"] for r in line]
        return [np.concatenate([rs[j] for rs in rows]) for j in range(len(rows[0]))]

    line2, line4 = (0, 2), tuple(range(FT_ZERO_N))
    ref = full(line2)

    def err(got):
        # a leaf's [n, k] rows flatten to its padded vector, whatever n is;
        # the excess over the band's rtol part, as assert_allclose counts
        worst = 0.0
        for a, b in zip(got, ref, strict=True):
            a, b = a.reshape(-1), b.reshape(-1)
            k = min(a.size, b.size)
            worst = max(worst, float((np.abs(a[:k] - b[:k]) - FT_BAND * np.abs(b[:k])).max()))
            check(not a[k:].any() and not b[k:].any(), "(d) nonzero padding")
        return worst

    shrink = err(full(line2, f"{FT_ZERO_N}->2"))
    grow = err(full(line4, f"2->{FT_ZERO_N}"))
    check(shrink <= FT_BAND and grow <= FT_BAND,
          f"(d) |4 -> 2 - ref| - {FT_BAND} |ref| up to {shrink:.3e}, 2 -> 4 {grow:.3e}: above "
          f"atol {FT_BAND} against the uninterrupted n = 2 run")
    ev = ranks[0][f"{FT_ZERO_N}->2"]["event"]
    check(ev["old"] == {"data": FT_ZERO_N} and ev["new"] == {"data": 2}
          and ev["steps_lost"] == 0, f"(d) reshape record {ev}")
    for r in ranks:
        restored, nxt, cursor = r["restored"]
        live = r["live"]
        check((nxt, cursor) == (2, 2) and sorted(restored) == sorted(live)
              and all(_bitwise(_bits([restored[k]]), _bits([live[k]])) for k in live),
              f"(d) rank {r['rank']}: the n = 4 checkpoint restored on n = 2 (next {nxt}, "
              f"cursor {cursor}) is not bitwise the live reshape's state")
    man = read_manifest(ckpt_dir)
    shapes = [tuple(s) for s, _ in man["leaf_shapes"]]
    rows2 = [s for s in shapes if len(s) == 2 and s[0] == FT_ZERO_N]
    rows3 = [s for s in shapes if len(s) == 3 and s[1] == FT_ZERO_N]
    check(rows2 and rows3 and len(rows2) + len(rows3) + 3 == len(shapes),
          f"(d) saved leaf_shapes {shapes}: not [4, k] / [L, 4, k] rows beside the cursor, "
          "the seed and Adam's count")
    launches = ranks[0]["launches"]
    for tag, c in launches.items():
        check(c == {k: FT_ZERO_LAYERS for k in ("fwd", "dq", "dkv")},
              f"(d) {tag} launches per step {c}")
    for r in ranks:
        for tag, c in r["by_variant"].items():
            n = r["launches"][tag]
            want_v = {k: {"tf32x3": n[k]} for k in ("fwd", "dq", "dkv")}
            check(c == want_v, f"(d) rank {r['rank']} {tag} launches per step by variant {c}, "
                               f"not {want_v}")
    walls = {k: max(r[f"{k}"]["wall_s"] for r in ranks) * 1e3
             for k in (f"{FT_ZERO_N}->2", f"2->{FT_ZERO_N}")}
    save_ms = max(r["save_s"] for r in ranks) * 1e3
    restore_ms = max(r["restore_s"] for r in ranks) * 1e3
    lines.append(f"  (d) fp32 LLaMA ZeRO-3, 4 ranks: against 4 uninterrupted steps at n = 2, "
                 f"max(|d| - {FT_BAND} |ref|) {shrink:.3e} after 4 -> 2 live and {grow:.3e} after "
                 f"2 -> 4 (atol {FT_BAND}); "
                 f"reshape record {ev['old']} -> {ev['new']}, steps lost 0; the n = 4 "
                 f"checkpoint restored on n = 2 bitwise the live reshape; leaf_shapes "
                 f"{len(rows2)} x [4, k], {len(rows3)} x [L, 4, k]; reshape walls "
                 f"{walls[f'{FT_ZERO_N}->2']:.1f} / {walls[f'2->{FT_ZERO_N}']:.1f} ms, "
                 f"a synchronous save at n = 4 {save_ms:.1f} ms, the cross-mesh restore "
                 f"{restore_ms:.1f} ms (slowest rank); flash launches a step {launches}, all "
                 "on tf32x3, every rank")
    return {"launches": [r["launches"] for r in ranks], "reshape_ms": walls,
            "save_ms": save_ms, "restore_ms": restore_ms}, lines


def ft_phase(dev, device="cuda", zero_world=None):
    """Phase 17, each sub-phase timed; returns the launch counts and walls
    (``device``: where the spawned processes run, ``"cpu"`` to rehearse).
    ``zero_world``: (d)'s ranks and checkpoint directory from
    :func:`chain_phase`; None runs (d)'s world here."""
    import os
    import tempfile

    from ddl25spring_tpu_torch.parallel.launch import spawn

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        lab, lines = ft_resume(tmp, device)
        for line in lines:
            print(line)
        print(f"  (a), (b), (e) took {time.perf_counter() - t0:.1f} s", flush=True)
        t0 = time.perf_counter()
        (gate,) = spawn(ft_gate, 1, os.path.join(tmp, "gate"), device, timeout=SPAWN_TIMEOUT)
        print(ft_gate_checks(gate))
        print(f"  (c) took {time.perf_counter() - t0:.1f} s", flush=True)
        t0 = time.perf_counter()
        if zero_world is None:
            zdir = os.path.join(tmp, "zero")
            ranks = spawn(ft_zero_rank, FT_ZERO_N, *ft_zero_inputs(zdir, device),
                          timeout=SPAWN_TIMEOUT)
        else:
            ranks, zdir = zero_world
        zero3, lines = ft_zero_checks(ranks, zdir)
        for line in lines:
            print(line)
        print(f"  (d) took {time.perf_counter() - t0:.1f} s", flush=True)
    return {"lab": lab, "gate": gate, "zero3": zero3}


SERVE_RAMP_S = 6.0              # (b): the ramp trace's duration (the bench default is 30 s)
SERVE_SHARED_S = 4.0            # (b): the shared-profile trace's
SERVE_SHARED_PAGE_LEN = 4       # (b): the shared run's page length (its prompts are 8 tokens)
SERVE_TICKS = 40                # (c): timed decode ticks per engine and turn
SERVE_PROFILED = 10             # (c): ticks under torch.profiler per engine
SERVE_REASONS = ("queue_full", "token_budget", "too_long", "pool_exhausted", "bad_request")


def _serve_model(cfg, device):
    from ddl25spring_tpu_torch.models.llama import Llama

    model = Llama(cfg, device=device, generator=torch.Generator().manual_seed(0))
    return model.requires_grad_(False)


def serve_fp32_run(cfg, device, graphs):
    """(a): the seeded smoke trace through the smoke-knob engine on the
    virtual clock, the host/device page mirror asserted after every step."""
    from ddl25spring_tpu_torch.serve import driver
    from ddl25spring_tpu_torch.serve.engine import ServeEngine
    from ddl25spring_tpu_torch.serve.traffic import TrafficSpec, synth_trace

    trace = synth_trace(TrafficSpec(**driver.SMOKE_TRAFFIC, vocab_size=cfg.vocab_size))
    knobs = driver.engine_knobs(smoke=True)
    eng = ServeEngine(_serve_model(cfg, device), cfg, **knobs, clock="virtual",
                      tick_s=driver.ab_tick_s(trace, knobs["max_slots"]), trace_label=None,
                      graphs=graphs)
    eng._sanitize = True  # analysis.host_sanitizer.check_serve_mirror at every step
    eng.warmup()
    eng.run(trace, max_steps=5_000)
    return eng


def serve_min_margin(model, cfg, reqs) -> float:
    """The smallest top-2 logit gap at any generated token of ``reqs``, from
    the CPU full forward (a card/CPU flip below it would be a near-tie)."""
    from ddl25spring_tpu_torch.models import llama

    gaps = []
    with torch.no_grad():
        for r in reqs:
            seq = torch.tensor([r.prompt + r.tokens])
            top2 = llama.llama_forward(model, seq, cfg)[0, len(r.prompt) - 1:-1].topk(2, -1)
            gaps.append(float((top2.values[:, 0] - top2.values[:, 1]).min()))
    return min(gaps)


def serve_exactness(dev) -> int:
    """Phase 18 (a): fp32 (TF32 off), the tiny model and the full-width
    config; returns the decode ticks run."""
    from ddl25spring_tpu_torch.models import decode as dm
    from ddl25spring_tpu_torch.models.llama import Llama
    from ddl25spring_tpu_torch.serve import driver
    from ddl25spring_tpu_torch.serve.engine import ServeEngine
    from ddl25spring_tpu_torch.utils.config import LlamaConfig

    ticks = 0
    for name, cfg in (("tiny", driver.serve_model("tiny")),
                      ("full width", LlamaConfig(dtype="float32"))):
        graphed, eager = serve_fp32_run(cfg, dev, True), serve_fp32_run(cfg, dev, False)
        cpu = serve_fp32_run(cfg, torch.device("cpu"), True)
        ticks += graphed._ticks + eager._ticks
        check(graphed._tick.graph is not None and eager._tick.graph is None,
              f"{name}: the graphed engine ran eagerly or the eager one captured")
        streams = [{r.rid: r.tokens for r in e.done} for e in (graphed, eager, cpu)]
        check(len(streams[0]) > 5 and streams[0] == streams[2],
              f"{name}: the card's token streams differ from the CPU's")
        check(streams[0] == streams[1], f"{name}: graphed and eager token streams differ")
        check(graphed.token_log == cpu.token_log, f"{name}: the token timeline differs")
        for key, t in graphed.pool.items():
            keep = slice(0, graphed.n_pages) if key in ("k", "v") else slice(None)
            check(torch.equal(t[keep], eager.pool[key][keep]),
                  f"{name}: the graphed pool's {key} is not bitwise the eager pool's")
        check(graphed.pool_ok_failures == 0 and graphed.mem_leak_check()["ok"],
              f"{name}: pool backstop fired or pages leaked")
        # paged == dense across a page boundary and a mid-batch admission
        model = graphed.params
        eng = ServeEngine(model, cfg, **driver.engine_knobs(smoke=True), clock="virtual",
                          trace_label=None)
        ra = eng.make_request([5, 9, 11, 3], 9)
        eng.submit(ra)
        eng.step()
        eng.step()
        rb = eng.make_request([7, 2, 8], 6)
        eng.submit(rb)
        while eng.queue or any(r is not None for r in eng.slots):
            eng.step()
        for r in (ra, rb):
            dense = dm.generate(model, torch.tensor([r.prompt], device=dev), cfg,
                                r.max_new_tokens)[0].tolist()
            check(r.tokens == dense, f"{name}: paged decode {r.tokens} != dense {dense}")
        cpu_model = Llama(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
        margin = serve_min_margin(cpu_model, cfg, cpu.done)
        print(f"  (a) {name} fp32: {len(streams[0])} requests, {graphed._ticks} ticks, "
              f"{graphed._prefills} prefills: token streams card (graphed) == card (eager) "
              f"== CPU, timeline equal, pool bitwise graphed == eager, mirror exact every "
              f"step, paged == dense across a page boundary and a mid-batch admission; "
              f"smallest top-2 gap {margin:.3g}", flush=True)
    return ticks


def serve_bench(tmp) -> dict:
    """Phase 18 (b): ``bench --serve`` at full width (``LlamaConfig()``, bf16)
    through the entry point, sentinels on, the ramp and the shared profile."""
    import os

    from ddl25spring_tpu_torch import bench
    from ddl25spring_tpu_torch.obs import sentinels
    from tools import goodput_report, mem_report

    import gc

    from ddl25spring_tpu_torch.obs import memscope

    gc.collect()
    left = memscope.live_array_summary(top=3)
    print(f"  (b) before the bench: {torch.cuda.memory_allocated()} B allocated on the card, "
          f"live tensors {left['by_device']}, the largest {left['largest']} (what earlier "
          "phases left)", flush=True)
    out = {}
    for profile, dur, page_len in (("ramp", SERVE_RAMP_S, None),
                                   ("shared", SERVE_SHARED_S, SERVE_SHARED_PAGE_LEN)):
        before = sentinels.violation_count()
        t0 = time.perf_counter()
        if page_len is not None:
            os.environ["DDL25_SERVE_PAGE_LEN"] = str(page_len)
        try:
            with sentinels.scoped(True, policy="log"):
                rec = bench.main(["--serve", "--serve-model", "ref", "--device", "cuda",
                                  "--serve-profile", profile, "--serve-duration", str(dur),
                                  "--perf-ledger", os.path.join(tmp, "ledger.jsonl"),
                                  "--obs-dir", os.path.join(tmp, profile)])
        finally:
            os.environ.pop("DDL25_SERVE_PAGE_LEN", None)
        wall = time.perf_counter() - t0
        cell, health = rec["telemetry"]["serve"], rec["telemetry"]["health"]
        check(cell["admitted"] + cell["rejected"] == cell["requests"]
              and cell["completed"] == cell["admitted"]
              and set(cell["rejected_by_reason"]) <= set(SERVE_REASONS),
              f"{profile}: requests {cell['requests']} != admitted {cell['admitted']} + "
              f"rejected {cell['rejected_by_reason']}, or completed {cell['completed']}")
        check(cell["pool_leak"]["ok"] and cell["pool_ok_failures"] == 0,
              f"{profile}: pages leaked at drain or the pool backstop fired: "
              f"{cell['pool_leak']}")
        check(health["sentinels"] and sentinels.violation_count() == before,
              f"{profile}: sentinel violations {sentinels.violation_count() - before}")
        check(cell["ab"]["advantage_tokens"] > 0,
              f"{profile}: continuous did not beat static: {cell['ab']}")
        pab = cell.get("prefix_ab")
        if profile == "shared":
            check(pab["prefix_hit_rate"] > 0 and pab["tokens_match"]
                  and pab["compared_requests"] > 0,
                  f"shared: prefix A/B without hits or with other tokens: {pab}")
        mem, gp = rec["telemetry"]["mem"], rec["telemetry"]["goodput"]
        band = mem.get("budget") or {}
        check(mem.get("enabled") and mem["leaked_pages"] == 0 and mem["growth_violations"] == 0
              and band.get("within_band") and band["source"] == "serve_static_accounting",
              f"{profile}: telemetry.mem off, leaking, growing or out of its band: {mem}")
        check(gp.get("scope") == "serve" and gp.get("slo_attainment") is not None,
              f"{profile}: telemetry.goodput without SLO attainment: {gp}")
        gates = {"mem_report --run --check": mem_report.main(
                     ["--run", os.path.join(tmp, profile), "--check"]),
                 "goodput_report --check": goodput_report.main(
                     ["--ledger", os.path.join(tmp, "ledger.jsonl"), "--check"])}
        check(not any(gates.values()), f"{profile}: a memory or goodput gate failed: {gates}")
        # every program of every engine is captured on one stream, so the
        # second bench of the process finds the workspaces the first made
        check(profile != "shared" or band["blas_workspaces"] == 0,
              f"shared: the second bench's warm-up made {band['blas_workspaces']} new cuBLAS "
              "workspaces, where the first bench's capture stream should have served")
        print(f"  (b) {profile}: live peak {band['measured_peak_bytes']} B above the floor of "
              f"{band['floor_bytes']} B held before the engine, against the bill "
              f"{band['budget_bytes']} B (mem_budget_bytes(per_chip=False) + "
              f"{band['blas_workspaces']} cuBLAS workspaces of {band['blas_workspace_bytes']} B "
              f"the warm-up made, of at most {band['streams']}); ratio {band['ratio']} "
              f"(tolerance {band['tolerance']}), {band['ratio_on_bill']} on the engine's own "
              f"bill, {mem['samples']} samples, 0 "
              f"leaked pages, 0 growth violations; SLO attainment {gp['slo_attainment']}, "
              f"availability {gp['availability']}, goodput "
              f"{gp['goodput_tokens_per_sec_per_chip']} tokens/s per card; gates {gates}",
              flush=True)
        print(f"  (b) {profile}, {cell['requests']} requests, {wall:.1f} s: "
              f"{cell['tokens_per_sec_per_chip']} tokens/s, TTFT p50 "
              f"{cell['ttft_s_p50'] * 1e3:.3f} ms p95 {cell['ttft_s_p95'] * 1e3:.3f} ms, "
              f"per-token p50 {cell['tok_latency_s_p50'] * 1e3:.3f} ms p95 "
              f"{cell['tok_latency_s_p95'] * 1e3:.3f} ms; admitted {cell['admitted']}, "
              f"rejected {cell['rejected_by_reason']}, peak pages "
              f"{cell['page_pool_peak_pages']}; A/B +{cell['ab']['advantage_tokens']} "
              f"tokens ({cell['ab']['advantage_frac']}); prefix hit rate "
              f"{cell['prefix_hit_rate']}, prefix A/B "
              f"{None if pab is None else (pab['advantage_tokens'], pab['tokens_match'])}; "
              f"no leak, no violation", flush=True)
        out[profile] = cell
    return out


def serve_ticks(dev) -> int:
    """Phase 18 (c): the full-width bf16 decode tick graphed and eager (the
    serving knobs, 4 slots decoding), in turns; host launches, device busy
    and idle share.  Returns the ticks run."""
    from torch.profiler import ProfilerActivity, profile

    from ddl25spring_tpu_torch.models.llama import Llama
    from ddl25spring_tpu_torch.serve import driver
    from ddl25spring_tpu_torch.serve.engine import ServeEngine
    from ddl25spring_tpu_torch.utils.config import LlamaConfig

    cfg = LlamaConfig()
    model = Llama(cfg, device=dev, generator=torch.Generator().manual_seed(0))
    model.requires_grad_(False)
    engines = {}
    for graphs in (True, False):
        eng = ServeEngine(model, cfg, **driver.engine_knobs(), clock="wall", trace_label=None,
                          graphs=graphs)
        eng.warmup()
        g = torch.Generator().manual_seed(1)
        for _ in range(eng.max_slots):  # 16-token prompts, decoding for 200 ticks
            eng.submit(eng.make_request(torch.randint(1, cfg.vocab_size, (16,),
                                                      generator=g).tolist(), 200))
        while eng.queue:
            eng.step()
        engines["graphed" if graphs else "eager"] = eng
    walls = {k: [] for k in engines}
    for _ in range(2):
        for name, eng in engines.items():
            for _ in range(SERVE_TICKS):
                t0 = time.perf_counter()
                eng.step()
                walls[name].append(time.perf_counter() - t0)
    check(engines["graphed"].slots[0].tokens == engines["eager"].slots[0].tokens,
          "the graphed and eager full-width bf16 engines decoded other tokens")
    stats = {}
    for name, eng in engines.items():
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(SERVE_PROFILED):
                eng.step()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        ka = prof.key_averages()
        busy = sum(e.self_device_time_total for e in ka
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and not e.is_user_annotation) / 1e3
        calls = {e.key: e.count // SERVE_PROFILED for e in ka
                 if e.key.startswith("cuda") and ("Launch" in e.key or "Memcpy" in e.key)}
        kernels = sum(e.count for e in ka if e.device_type == torch.autograd.DeviceType.CUDA
                      and not e.is_user_annotation) / SERVE_PROFILED
        stats[name] = (wall * 1e3 / SERVE_PROFILED, busy / SERVE_PROFILED, calls, kernels)
    for name in engines:
        ms, busy, calls, kernels = stats[name]
        steady = walls[name][SERVE_TICKS // 4:]
        median = statistics.median(steady) * 1e3
        print(f"  (c) {name} tick (4 slots, full width, bf16): median {median:.3f} ms (min "
              f"{min(steady) * 1e3:.3f}); device busy {busy:.3f} ms a tick, idle "
              f"{1 - busy / median:.3f} of the median tick ({1 - busy / ms:.3f} of the "
              f"{ms:.3f} ms under the profiler), {kernels:.0f} kernels a tick; host calls a "
              f"tick {calls}", flush=True)
    return sum(e._ticks for e in engines.values())


def serve_phase(dev) -> dict:
    """Phase 18, each sub-phase timed; returns the flash launches per decode
    tick (0: serving has no flash kernel on its path)."""
    import tempfile

    from ddl25spring_tpu_torch.ops import flash_attention as fa

    fa.reset_launches()
    t0 = time.perf_counter()
    ticks = serve_exactness(dev)
    print(f"  (a) took {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        cells = serve_bench(tmp)
    print(f"  (b) took {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    ticks += serve_ticks(dev)
    print(f"  (c) took {time.perf_counter() - t0:.1f} s", flush=True)
    launches = {n: fa.LAUNCHES[n] + sum(fa.CAPTURED[n].values()) for n in fa.LAUNCHES}
    check(not any(launches.values()), f"the serving path launched flash kernels: {launches}")
    return {"launches_per_tick": {n: c / ticks for n, c in launches.items()}, "cells": cells}


SPEC_K = 2                      # phase 19: drafts a round (the bench's DDL25_SERVE_SPEC_K default)
SPEC_STEPS = 25                 # (b): timed scheduler steps per engine and turn
SPEC_PROFILED = 10              # (b): steps under torch.profiler per engine
# (c): the chaos of each elastic run on the ramp trace cut to SERVE_RAMP_S (19
# requests, ~30 iterations of the elastic run's clock): a loss that hands one queued
# request over while the victim still decodes, a burst of 16 that the
# autoscaler answers, and a shrink to one replica
ELASTIC_CHAOS = ("device_loss@20", "traffic_spike@10:16", "capacity_change@12:1")


def spec_fp32_run(cfg, device, graphs, spec_k=SPEC_K, draft_layers=1):
    """(a): the seeded smoke trace through the smoke-knob engine with
    ``spec_k`` drafts a round on the virtual clock, the host/device page
    mirror asserted after every step."""
    from ddl25spring_tpu_torch.serve import driver
    from ddl25spring_tpu_torch.serve.engine import ServeEngine
    from ddl25spring_tpu_torch.serve.traffic import TrafficSpec, synth_trace

    trace = synth_trace(TrafficSpec(**driver.SMOKE_TRAFFIC, vocab_size=cfg.vocab_size))
    knobs = {**driver.engine_knobs(smoke=True), "spec_k": spec_k, "draft_layers": draft_layers}
    eng = ServeEngine(_serve_model(cfg, device), cfg, **knobs, clock="virtual",
                      tick_s=driver.ab_tick_s(trace, knobs["max_slots"]), trace_label=None,
                      graphs=graphs)
    eng._sanitize = True
    eng.warmup()
    eng.run(trace, max_steps=5_000)
    return eng


def spec_exactness(dev) -> None:
    """Phase 19 (a): fp32 (TF32 off), tiny-deep and the full-width config,
    ``spec_k`` = ``SPEC_K``: graphed, eager and CPU speculative engines, a
    non-speculative one and dense ``generate``.  At full width the seeded
    random weights leave the 1-layer drafter next to no agreement, so a
    full-depth drafter (the target's own 6 blocks: every draft accepted) runs
    too, for the full accepts and the (k+1)-step catch-up draft."""
    from ddl25spring_tpu_torch.models import decode as dm
    from ddl25spring_tpu_torch.serve import driver
    from ddl25spring_tpu_torch.utils.config import LlamaConfig

    full = LlamaConfig(dtype="float32")
    for name, cfg, layers in (("tiny-deep", driver.serve_model("tiny-deep"), 1),
                              ("full width", full, 1),
                              ("full width, full-depth drafter", full, full.n_layers)):
        t0 = time.perf_counter()
        graphed = spec_fp32_run(cfg, dev, True, draft_layers=layers)
        eager = spec_fp32_run(cfg, dev, False, draft_layers=layers)
        cpu = spec_fp32_run(cfg, torch.device("cpu"), True, draft_layers=layers)
        plain = spec_fp32_run(cfg, dev, True, spec_k=0)
        check(graphed._verify.graph is not None and graphed._draft_k1.graph is not None
              and eager._verify.graph is None,
              f"{name}: the graphed spec engine ran eagerly or the eager one captured")
        streams = [{r.rid: r.tokens for r in e.done} for e in (graphed, eager, cpu, plain)]
        check(len(streams[0]) > 5 and streams[0] == streams[2],
              f"{name}: the card's spec streams differ from the CPU's")
        check(streams[0] == streams[1], f"{name}: graphed and eager spec streams differ")
        check(streams[0] == streams[3], f"{name}: spec streams differ from the non-spec engine's")
        for r in graphed.done:
            want = dm.generate(graphed.params, torch.tensor([r.prompt], device=dev), cfg,
                               r.max_new_tokens)[0].tolist()
            check(r.tokens == want, f"{name}: spec stream {r.tokens} != dense {want}")
        check(graphed.spec_accept_counts == cpu.spec_accept_counts
              and eager.spec_accept_counts == cpu.spec_accept_counts,
              f"{name}: accept counts card {graphed.spec_accept_counts}, eager "
              f"{eager.spec_accept_counts}, CPU {cpu.spec_accept_counts}")
        check(graphed.token_log == cpu.token_log, f"{name}: the token timeline differs")
        k1_rounds = graphed._draft_steps - SPEC_K * graphed._spec_rounds
        check(name == "full width" or (graphed.spec_accept_counts.get(SPEC_K, 0) > 0
                                       and k1_rounds > 0),
              f"{name}: no full accept took the (k+1)-step draft: "
              f"{graphed.spec_accept_counts}, {k1_rounds} catch-up rounds")
        for label, ours, theirs in (("pool", graphed.pool, eager.pool),
                                    ("drafter pool", graphed.draft_pool, eager.draft_pool)):
            for key, t in ours.items():
                keep = slice(0, graphed.n_pages) if key in ("k", "v") else slice(None)
                check(torch.equal(t[keep], theirs[key][keep]),
                      f"{name}: the graphed {label}'s {key} is not bitwise the eager one's")
        for e in (graphed, eager):
            leak = e.mem_leak_check()  # the target pool keeps its prefix-cache pages
            check(e.pool_ok_failures == 0 and leak["ok"] and leak["draft"]["ok"]
                  and not (~e.draft_pool["free"]).any(),
                  f"{name}: a pool backstop fired or pages were left: {leak}")
        m = graphed.metrics()
        print(f"  (a) {name} fp32, k={SPEC_K}: {len(streams[0])} requests, "
              f"{graphed._spec_rounds} rounds ({k1_rounds} of k+1 steps), accept counts "
              f"{graphed.spec_accept_counts} (acceptance {m['acceptance_rate']}, flop ratio "
              f"{m['spec']['flop_ratio']}): spec streams card (graphed) == card (eager) == CPU "
              f"== non-spec == dense, accept counts and timeline equal the CPU's, both pools "
              f"bitwise graphed == eager and empty at drain, mirror exact every step; "
              f"{time.perf_counter() - t0:.1f} s", flush=True)


def _busy_ms(engine, steps):
    """Host wall and device busy per scheduler step over ``steps`` steps
    under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            engine.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy = sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.is_user_annotation) / 1e3
    return wall * 1e3 / steps, busy / steps


def spec_bench(dev, tmp) -> dict:
    """Phase 19 (b): ``DDL25_SERVE_SPEC=1 bench --serve`` at full width (bf16)
    through the entry point, its row through ``serve_report
    --check-spec-ab``; then the spec round against the decode tick at 4
    slots, both graphed."""
    import os

    from ddl25spring_tpu_torch import bench
    from ddl25spring_tpu_torch.models.llama import Llama
    from ddl25spring_tpu_torch.obs import sentinels
    from ddl25spring_tpu_torch.serve import driver
    from ddl25spring_tpu_torch.serve.engine import ServeEngine
    from ddl25spring_tpu_torch.utils.config import LlamaConfig
    from tools import serve_report

    led, obs_dir = os.path.join(tmp, "spec_ledger.jsonl"), os.path.join(tmp, "spec")
    before = sentinels.violation_count()
    t0 = time.perf_counter()
    os.environ["DDL25_SERVE_SPEC"] = "1"
    try:
        with sentinels.scoped(True, policy="log"):
            rec = bench.main(["--serve", "--serve-model", "ref", "--device", "cuda",
                              "--serve-duration", str(SERVE_RAMP_S), "--no-serve-ab",
                              "--no-serve-prefix-ab", "--perf-ledger", led, "--obs-dir", obs_dir])
    finally:
        os.environ.pop("DDL25_SERVE_SPEC", None)
    wall = time.perf_counter() - t0
    cell = rec["telemetry"]["serve"]
    sab = cell["spec_ab"]
    check(cell["spec"]["enabled"] and cell["completed"] == cell["admitted"]
          and cell["pool_leak"]["ok"] and cell["pool_ok_failures"] == 0,
          f"the spec ramp left work or pages: {cell['pool_leak']}")
    check(sentinels.violation_count() == before,
          f"sentinel violations {sentinels.violation_count() - before}")
    check(sab["tokens_match"] and sab["compared_requests"] > 0,
          f"the full-width spec A/B: other tokens or nothing compared: {sab}")
    print(f"  (b) spec ramp, full width, {cell['requests']} requests, {wall:.1f} s: "
          f"{cell['tokens_per_sec_per_chip']} tokens/s, TTFT p50 "
          f"{cell['ttft_s_p50'] * 1e3:.3f} ms p95 {cell['ttft_s_p95'] * 1e3:.3f} ms, per-round "
          f"p50 {cell['tok_latency_s_p50'] * 1e3:.3f} ms; acceptance {cell['acceptance_rate']}, "
          f"accept counts {cell['spec']['accept_counts']}; spec A/B (virtual clock) spec "
          f"{sab['spec_tokens_at_budget']} vs non-spec {sab['nospec_tokens_at_budget']} tokens "
          f"at {sab['budget_s']} s, advantage {sab['advantage_tokens']} "
          f"({sab['advantage_frac']}), acceptance {sab['acceptance_rate']}, "
          f"{sab['compared_requests']} streams equal", flush=True)
    # the gate needs a drafter that agrees: tiny-deep's (the seeded full-width
    # weights give the 1-layer drafter next to none)
    deep_led, deep_dir = os.path.join(tmp, "deep_ledger.jsonl"), os.path.join(tmp, "deep")
    os.environ["DDL25_SERVE_SPEC"] = "1"
    try:
        deep = bench.main(["--serve", "--smoke", "--serve-model", "tiny-deep", "--device",
                           "cuda", "--no-serve-ab", "--no-serve-prefix-ab", "--perf-ledger",
                           deep_led, "--obs-dir", deep_dir])["telemetry"]["serve"]["spec_ab"]
    finally:
        os.environ.pop("DDL25_SERVE_SPEC", None)
    check(deep["tokens_match"] and deep["compared_requests"] > 0
          and deep["draft_tokens_accepted"] > 0,
          f"the tiny-deep spec A/B: other tokens, nothing compared or no draft accepted: {deep}")
    gate = serve_report.main([deep_dir, "--ledger", deep_led, "--check-spec-ab"])
    check(gate == 0, f"serve_report --check-spec-ab failed ({gate}) on {deep}")
    print(f"  (b) spec bench, tiny-deep on the card: spec {deep['spec_tokens_at_budget']} vs "
          f"non-spec {deep['nospec_tokens_at_budget']} tokens, advantage "
          f"{deep['advantage_tokens']} ({deep['advantage_frac']}), acceptance "
          f"{deep['acceptance_rate']}, {deep['compared_requests']} streams equal; "
          f"serve_report --check-spec-ab passes", flush=True)

    cfg = LlamaConfig()
    model = Llama(cfg, device=dev, generator=torch.Generator().manual_seed(0))
    model.requires_grad_(False)
    engines = {}
    for k in (SPEC_K, 0):
        eng = ServeEngine(model, cfg, **{**driver.engine_knobs(), "spec_k": k}, clock="wall",
                          trace_label=None)
        eng.warmup()
        g = torch.Generator().manual_seed(1)
        for _ in range(eng.max_slots):  # 16-token prompts, 230 tokens each
            eng.submit(eng.make_request(torch.randint(1, cfg.vocab_size, (16,),
                                                      generator=g).tolist(), 230))
        while eng.queue:
            eng.step()
        engines["spec round" if k else "tick"] = eng
    walls = {name: [] for name in engines}
    start = {name: (e.generated_tokens, e._ticks) for name, e in engines.items()}
    for _ in range(2):
        for name, eng in engines.items():
            for _ in range(SPEC_STEPS):
                t0 = time.perf_counter()
                eng.step()
                walls[name].append(time.perf_counter() - t0)
    check(all(r is not None for e in engines.values() for r in e.slots),
          "a slot finished inside the timed window")
    tokens = {name: (e.generated_tokens - start[name][0])
              / ((e._ticks - start[name][1]) * e.max_slots) for name, e in engines.items()}
    out = {}
    for name, eng in engines.items():
        ms, busy = _busy_ms(eng, SPEC_PROFILED)
        median = statistics.median(walls[name][SPEC_STEPS // 4:]) * 1e3
        out[name] = {"median_ms": median, "busy_ms": busy, "profiled_ms": ms,
                     "tokens_per_step": tokens[name]}
    s, t = out["spec round"], out["tick"]
    check(engines["spec round"].slots[0].tokens[:len(engines["tick"].slots[0].tokens)]
          == engines["tick"].slots[0].tokens[:len(engines["spec round"].slots[0].tokens)],
          "the spec and plain full-width bf16 engines decoded other tokens")
    spec_eng = engines["spec round"]
    ratio = spec_eng.spec_flop_ratio
    print(f"  (b) 4 slots, full width, bf16, graphed: spec round (k={SPEC_K}) median "
          f"{s['median_ms']:.3f} ms, device busy {s['busy_ms']:.3f} ms ({s['profiled_ms']:.3f} "
          f"under the profiler), {s['tokens_per_step']:.3f} tokens a slot-round; decode tick "
          f"median {t['median_ms']:.3f} ms, busy {t['busy_ms']:.3f} ms ({t['profiled_ms']:.3f}), "
          f"{t['tokens_per_step']:.3f} tokens a slot-tick; round / tick: wall "
          f"{s['median_ms'] / t['median_ms']:.3f}, busy "
          f"{s['busy_ms'] / max(t['busy_ms'], 1e-9):.3f} "
          f"against the virtual clock's 1 + steps x {ratio:.4f} = "
          f"{1 + SPEC_K * ratio:.3f} (k steps) and k + 1 + steps x ratio = "
          f"{SPEC_K + 1 + SPEC_K * ratio:.3f}", flush=True)
    return {"cell": cell, "timing": out}


def elastic_run(dev) -> list:
    """Phase 19 (c): ``elastic_serve_run`` at full width (bf16) on the ramp
    trace under each of ``ELASTIC_CHAOS``, memscope on, every completed stream
    against a non-elastic engine's on the same trace."""
    from ddl25spring_tpu_torch import obs
    from ddl25spring_tpu_torch.ft import ChaosInjector, parse_chaos
    from ddl25spring_tpu_torch.obs import memscope
    from ddl25spring_tpu_torch.serve import driver
    from ddl25spring_tpu_torch.serve.engine import ServeEngine
    from ddl25spring_tpu_torch.serve.traffic import TrafficSpec, synth_trace
    from ddl25spring_tpu_torch.utils.config import LlamaConfig
    from tools.serve_report import check_reshape

    cfg = LlamaConfig()
    model = _serve_model(cfg, dev)
    trace = synth_trace(TrafficSpec(seed=0, duration_s=SERVE_RAMP_S, rate_rps=8.0,
                                    profile="ramp", vocab_size=cfg.vocab_size))
    knobs = driver.engine_knobs()
    tick_s = driver.ab_tick_s(trace, knobs["max_slots"])
    ref = ServeEngine(model, cfg, **{**knobs, "prefill_batch": knobs["max_slots"]},
                      clock="virtual", tick_s=tick_s, trace_label=None)
    ref.run(trace, max_steps=20_000)
    oracle = {(tuple(r.prompt), r.max_new_tokens): r.tokens for r in ref.done}
    check(len(oracle) > 5, f"the non-elastic engine completed {len(oracle)} kinds of request")
    cells = []
    obs.timeline.configure(None)
    with obs.scoped(True), memscope.scoped(True):
        for spec in ELASTIC_CHAOS:
            t0 = time.perf_counter()
            cell = driver.elastic_serve_run(model, cfg, trace, knobs,
                                            chaos=ChaosInjector(parse_chaos(spec), None),
                                            tick_s=tick_s, keep_requests=True)
            reqs = cell.pop("_requests")
            check(cell["events"] and cell["dropped_requests"] == 0
                  and cell["completed"] == cell["admitted"] == cell["submitted"],
                  f"{spec}: events {cell['events']}, dropped {cell['dropped_requests']}, "
                  f"submitted {cell['submitted']}, completed {cell['completed']}")
            bad = [r.rid for r in reqs
                   if r.tokens != oracle[(tuple(r.prompt), r.max_new_tokens)]]
            check(not bad, f"{spec}: requests {bad} decoded other tokens than the "
                           "non-elastic engine")
            shrinks = sum(1 for ev in cell["events"] if ev["new"] < ev["old"])
            steps = cell.get("mem_steps", [])
            check(len(steps) == shrinks and all(
                s["leak_ok"] and s["step_down_bytes"] > 0 for s in steps),
                f"{spec}: retired replicas' step-downs {steps}")
            fails = check_reshape([{"reshape": driver._reshape_cell(cell)}])
            check(not fails, f"{spec}: --check-reshape: {fails}")
            events = [(e["reason"], e["old"], e["new"], e["t"], e["t_end"])
                      for e in cell["events"]]
            print(f"  (c) {spec}: events {events}, replicas {cell['replicas_start']} -> {cell['replicas_end']}, "
                  f"{cell['completed']} of {cell['submitted']} completed, 0 dropped, every "
                  f"stream the non-elastic engine's; TTFT p95 steady {cell['ttft_s_p95_steady']}"
                  f" s, reshape window {cell['ttft_s_p95_reshape']} s; step-downs "
                  f"{[(s['replica'], s['step_down_bytes'], s['pool_bytes']) for s in steps]} "
                  f"(replica, live bytes freed, pool bytes); --check-reshape passes; "
                  f"{time.perf_counter() - t0:.1f} s", flush=True)
            cells.append(cell)
    return cells


def elastic_bench(tmp) -> dict:
    """Phase 19 (c): ``DDL25_CHAOS=<the first of ELASTIC_CHAOS> bench --serve``
    at full width through the entry point, its row through ``serve_report
    --check-reshape``."""
    import os

    from ddl25spring_tpu_torch import bench
    from tools import serve_report

    led, obs_dir = os.path.join(tmp, "elastic_ledger.jsonl"), os.path.join(tmp, "elastic")
    os.environ["DDL25_CHAOS"] = ELASTIC_CHAOS[0]
    try:
        rec = bench.main(["--serve", "--serve-model", "ref", "--device", "cuda",
                          "--serve-duration", str(SERVE_RAMP_S), "--no-serve-ab",
                          "--no-serve-prefix-ab", "--perf-ledger", led, "--obs-dir", obs_dir])
    finally:
        os.environ.pop("DDL25_CHAOS", None)
    cell = rec["telemetry"]["serve"]["reshape"]
    with open(os.path.join(obs_dir, "serve.json")) as f:
        steps = json.load(f)["reshape"].get("mem_steps", [])
    check(cell["dropped_requests"] == 0 and steps and all(s["step_down_bytes"] > 0
                                                          for s in steps),
          f"bench --serve under {ELASTIC_CHAOS[0]}: {cell}, step-downs {steps}")
    gate = serve_report.main([obs_dir, "--ledger", led, "--check-reshape"])
    check(gate == 0, f"serve_report --check-reshape failed ({gate}) on {cell}")
    print(f"  (c) bench --serve, DDL25_CHAOS={ELASTIC_CHAOS[0]}: events "
          f"{[(e['reason'], e['old'], e['new']) for e in cell['events']]}, 0 dropped, step-down "
          f"{[s['step_down_bytes'] for s in steps]} bytes; serve_report --check-reshape passes",
          flush=True)
    return cell


def spec_elastic_phase(dev) -> dict:
    """Phase 19, each sub-phase timed; checks that no flash kernel launched."""
    import tempfile

    from ddl25spring_tpu_torch.ops import flash_attention as fa

    fa.reset_launches()
    t0 = time.perf_counter()
    spec_exactness(dev)
    print(f"  (a) took {time.perf_counter() - t0:.1f} s", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        spec = spec_bench(dev, tmp)
        print(f"  (b) took {time.perf_counter() - t0:.1f} s", flush=True)
        t0 = time.perf_counter()
        cells = elastic_run(dev)
        bench_cell = elastic_bench(tmp)
        print(f"  (c) took {time.perf_counter() - t0:.1f} s", flush=True)
    launches = {n: fa.LAUNCHES[n] + sum(fa.CAPTURED[n].values()) for n in fa.LAUNCHES}
    check(not any(launches.values()),
          f"speculative or elastic serving launched flash kernels: {launches}")
    return {"spec": spec, "elastic": cells, "elastic_bench": bench_cell}


TP_N = 2                        # phase 20: ranks of the model axis, all on cuda:0 over gloo
TP_TICKS = 16                   # (c): timed decode ticks per TP engine (and the single-card one)
TP_PROFILED = 4                 # (c): ticks under torch.profiler per engine
TP_BENCH_S = 2.0                # (b): the ramp trace's duration (11 requests; the bf16
                                # streams leave the single card's within them)
TP_STREAMED_S = 1.0             # (b): the streamed row's (3 requests): its streams are the
                                # resident engine's bitwise ((a), (c)), so the resident row
                                # shows where they leave the single card's
TP_POOL_BAND = 1e-5             # (a): a rank's k/v against the single-card pool's heads


def _tp_prompts(cfg, rows=2, width=8, seed=5):
    return torch.randint(1, cfg.vocab_size, (rows, width),
                         generator=torch.Generator().manual_seed(seed), dtype=torch.int32)


def tp_logits(model, cfg, mesh) -> dict:
    """(a): the tick's logits after one prefill of two seeded prompts, from
    the resident TP engine, the streamed one and a single-card engine on this
    rank, each on a fresh pool of its own: the largest difference TP against
    single-card, and whether streamed equals resident bitwise."""
    from ddl25spring_tpu_torch.serve import driver, kv_pages
    from ddl25spring_tpu_torch.serve import engine as eng_mod
    from ddl25spring_tpu_torch.serve import spec as spec_mod
    from ddl25spring_tpu_torch.serve.engine import ServeEngine

    knobs = driver.engine_knobs(smoke=True)
    prompts, dev = _tp_prompts(cfg), mesh.device
    lens = torch.tensor([8, 5], dtype=torch.int32)
    out = {}
    for name, kw in (("resident", dict(tp=TP_N, mesh=mesh)),
                     ("streamed", dict(tp=TP_N, mesh=mesh, weight_stream=True)),
                     ("single", {})):
        m = model if name != "single" else _serve_model(cfg, dev)
        e = ServeEngine(m, cfg, **{**knobs, **kw}, graphs=False, clock="virtual",
                        trace_label=None)
        pool = kv_pages.init_page_pool(cfg, n_pages=e.n_pages, page_len=e.page_len,
                                       max_slots=e.max_slots, pages_per_seq=e.pages_per_seq,
                                       num_heads=cfg.num_heads // e.tp, device=dev)
        pool, first, _ = e._prefill_at(0).body(e.params, pool, prompts.to(dev), lens.to(dev),
                                               torch.zeros(2, dtype=torch.int32, device=dev),
                                               torch.arange(2, dtype=torch.int32, device=dev),
                                               None)
        stack = None if e._stream is None else eng_mod._stream_layer_stack(e.axis, *e._stream)
        _, logits, _ = spec_mod._position_step(cfg, e.axis, stack)(
            e.params, pool, first, pool["seq_len"], pool["active"])
        out[name] = logits.cpu()
    return {"max_diff": float((out["resident"] - out["single"]).abs().max()),
            "streamed_bitwise": torch.equal(out["resident"], out["streamed"])}


def tp_fp32_engine(model, cfg, mesh, weight_stream=False, spec_k=0):
    """(a): the seeded smoke trace through a ``tp = TP_N`` engine (the smoke
    knobs, virtual clock, eager), the page mirror asserted after every step."""
    from ddl25spring_tpu_torch.serve import driver
    from ddl25spring_tpu_torch.serve.engine import ServeEngine
    from ddl25spring_tpu_torch.serve.traffic import TrafficSpec, synth_trace

    trace = synth_trace(TrafficSpec(**driver.SMOKE_TRAFFIC, vocab_size=cfg.vocab_size))
    knobs = {**driver.engine_knobs(smoke=True), "spec_k": spec_k, "tp": TP_N,
             "weight_stream": weight_stream}
    eng = ServeEngine(model, cfg, **knobs, mesh=mesh, graphs=False, clock="virtual",
                      tick_s=driver.ab_tick_s(trace, knobs["max_slots"]), trace_label=None)
    eng._sanitize = True
    eng.warmup()
    eng.run(trace, max_steps=5_000)
    return eng


TP_EXACT = (("tiny", "tiny", 0), ("full width", None, 0), ("tiny-deep spec", "tiny-deep", SPEC_K))


def tp_exact_configs():
    from ddl25spring_tpu_torch.serve import driver
    from ddl25spring_tpu_torch.utils.config import LlamaConfig

    return [(name, LlamaConfig(dtype="float32") if key is None else driver.serve_model(key), k)
            for name, key, k in TP_EXACT]


def tp_cost(mesh) -> dict:
    """(c): the full-width bf16 decode tick at the serving knobs, 4 slots
    decoding, resident TP, streamed TP (both ranks, in lockstep) and, on rank
    0 alone, the single-card eager tick: each engine's persistent bytes
    (``torch.cuda.memory_allocated`` around its build and warmup) beside its
    ``mem_budget_bytes()``, ``TP_TICKS`` timed ticks (median wall), the
    collective seconds and staged bytes a tick (``Comm.take_stats``), then
    ``TP_PROFILED`` ticks under torch.profiler (device busy a tick), the peak
    (``max_memory_allocated``) over the timed ticks; the first divergence of
    the TP stream from the single-card one, with the single-card top-2 gap
    there."""
    import torch.distributed as dist

    from ddl25spring_tpu_torch.models import llama
    from ddl25spring_tpu_torch.serve import driver
    from ddl25spring_tpu_torch.serve.engine import ServeEngine
    from ddl25spring_tpu_torch.utils.config import LlamaConfig

    cfg = LlamaConfig()
    dev = mesh.device
    model = _serve_model(cfg, "cpu")
    # the serving knobs, the 4 prompts admitted in one 16-position prefill
    knobs = {**driver.engine_knobs(), "max_prompt_len": 16, "prefill_batch": 4}
    out, streams = {}, {}
    g = torch.Generator().manual_seed(1)
    prompts = [torch.randint(1, cfg.vocab_size, (16,), generator=g).tolist() for _ in range(4)]
    for name, kw in (("resident", dict(tp=TP_N, mesh=mesh)),
                     ("streamed", dict(tp=TP_N, mesh=mesh, weight_stream=True)),
                     ("single", {})):
        if name == "single" and mesh.rank != 0:
            dist.barrier(group=mesh.axis("model").group)
            break
        torch.cuda.synchronize(dev)
        before = torch.cuda.memory_allocated(dev)
        src = model if name != "single" else model.to(dev)
        eng = ServeEngine(src, cfg, **{**knobs, **kw}, graphs=False, clock="wall",
                          trace_label=None)
        eng.warmup()
        torch.cuda.synchronize(dev)
        held_model = sum(p.numel() * p.element_size() for p in model.parameters())
        held = torch.cuda.memory_allocated(dev) - before - (held_model if name == "single"
                                                            else 0)
        for p in prompts:
            eng.submit(eng.make_request(p, 200))
        while eng.queue:
            eng.step()
        mesh.comm.take_stats()
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        walls = []
        for _ in range(TP_TICKS):
            t0 = time.perf_counter()
            eng.step()
            walls.append(time.perf_counter() - t0)
        torch.cuda.synchronize(dev)
        peak = torch.cuda.max_memory_allocated(dev) - before - (held_model if name == "single"
                                                                else 0)
        stats = mesh.comm.take_stats()
        ms, busy = _busy_ms(eng, TP_PROFILED)
        out[name] = {"median_ms": statistics.median(walls[TP_TICKS // 4:]) * 1e3,
                     "busy_ms": busy, "profiled_ms": ms, "held": held, "peak": peak,
                     "budget": eng.mem_budget_bytes(),
                     "allreduce_ms": stats["allreduce_s"] * 1e3 / TP_TICKS,
                     "gather_ms": stats["collective_s"] * 1e3 / TP_TICKS,
                     "staged": stats["bytes_staged"] / TP_TICKS,
                     "plan": (None if eng._stream is None
                              else [eng._stream[0].bucket_size(b)
                                    for b in range(eng._stream[0].n_buckets)]),
                     # one gathered layer, whole (the rows' padding too)
                     "layer_bytes": (None if eng._stream is None
                                     else TP_N * sum(k * d.itemsize for k, d in zip(
                                         eng._stream[0].sizes, eng._stream[0].dtypes)))}
        streams[name] = list(eng.slots[0].tokens)
        prompt0 = eng.slots[0].prompt
        del eng
        if name == "single":
            model.to("cpu")
            dist.barrier(group=mesh.axis("model").group)
    if mesh.rank == 0:
        a, b = streams["resident"], streams["single"]
        n = min(len(a), len(b))
        first = next((i for i in range(n) if a[i] != b[i]), None)
        gap = None
        if first is not None:
            with torch.no_grad():
                top2 = llama.llama_forward(model.to(dev), torch.tensor(
                    [prompt0 + b[:first]], device=dev), cfg)[0, -1].float().topk(2).values
            model.to("cpu")
            gap = float(top2[0] - top2[1])
        out["divergence"] = {"compared": n, "first": first, "gap": gap,
                             "streamed_equals_resident": streams["streamed"][:n] == a[:n]}
    return out


def tp_rank(rdv, device="cuda"):
    """One rank of phase 20's world (``TP_N`` ranks of a ``1 x TP_N`` model
    mesh on ``device``): (a)'s fp32 engines and logits, then (c)'s costs; the
    flash launches over the whole rank."""
    from ddl25spring_tpu_torch.ops import flash_attention as fa
    from ddl25spring_tpu_torch.utils.mesh import init_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    fa.reset_launches()
    out = {"seconds": {}}
    with init_mesh(rdv, 1, model=TP_N, device=device) as mesh:
        out["index"] = mesh.axis("model").index
        for name, cfg, spec_k in tp_exact_configs():
            t0 = time.perf_counter()
            model = _serve_model(cfg, "cpu")
            res = {}
            for mode, ws in (("resident", False),) + ((("streamed", True),) if not spec_k else ()):
                e = tp_fp32_engine(model, cfg, mesh, ws, spec_k)
                leak = e.mem_leak_check()
                res[mode] = {"streams": {r.rid: r.tokens for r in e.done}, "log": e.token_log,
                             "accept": dict(e.spec_accept_counts),
                             "k": e.pool["k"][:e.n_pages].cpu(), "v": e.pool["v"][:e.n_pages].cpu(),
                             "ok": e.pool_ok_failures == 0 and leak["ok"],
                             "graphs": e.metrics()["config"]["graphs"]}
            if not spec_k:
                res["logits"] = tp_logits(model, cfg, mesh)
            out[name] = res
            out["seconds"][name] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out["cost"] = tp_cost(mesh)
        out["seconds"]["cost"] = time.perf_counter() - t0
    out["launches"] = {n: fa.LAUNCHES[n] + sum(fa.CAPTURED[n].values()) for n in fa.LAUNCHES}
    return out


def tp_exactness(dev) -> list:
    """Phase 20 (a) and (c): the card's world (its (c) costs too) against
    single-card engines, graphed and eager on the card and on the CPU (the
    same TP world on the CPU is ``tests/test_torch_serve_tp.py``'s).  Returns
    the card's ranks."""
    from ddl25spring_tpu_torch.parallel.launch import spawn

    t0 = time.perf_counter()
    single = {}
    for name, cfg, spec_k in tp_exact_configs():
        run = serve_fp32_run if not spec_k else spec_fp32_run
        single[name] = {mode: run(cfg, d, graphs) for mode, d, graphs in (
            ("graphed", dev, True), ("eager", dev, False), ("cpu", torch.device("cpu"), True))}
    print(f"  (a) the single-card engines: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    card = spawn(tp_rank, TP_N, timeout=SPAWN_TIMEOUT)
    print(f"  (a), (c) the card's world of {TP_N}: {time.perf_counter() - t0:.1f} s (rank 0: "
          + ", ".join(f"{k} {v:.1f} s" for k, v in card[0]["seconds"].items()) + ")",
          flush=True)
    for name, cfg, spec_k in tp_exact_configs():
        s = single[name]
        prog = "_verify" if spec_k else "_tick"
        check(getattr(s["graphed"], prog).graph is not None
              and getattr(s["eager"], prog).graph is None,
              f"{name}: the single-card graphed engine ran eagerly or the eager one captured")
        want = {r.rid: r.tokens for r in s["graphed"].done}
        check(len(want) > 5 and all({r.rid: r.tokens for r in e.done} == want
                                    for e in (s["eager"], s["cpu"])),
              f"{name}: the single-card streams differ graphed / eager / CPU")
        H = cfg.num_heads
        for r in card:
            i, res = r["index"], r[name]
            for mode in [m for m in ("resident", "streamed") if m in res]:
                got = res[mode]
                check(got["streams"] == want and got["log"] == s["graphed"].token_log,
                      f"{name} {mode} on rank {i}: streams or timeline differ from the "
                      "single-card engine's")
                check(got["ok"] and got["graphs"] is False,
                      f"{name} {mode} on rank {i}: pool backstop, leak or graph")
                if spec_k:
                    check(got["accept"] == s["graphed"].spec_accept_counts,
                          f"{name} on rank {i}: accept counts {got['accept']} != "
                          f"{s['graphed'].spec_accept_counts}")
                err = max(float((got[k] - s["graphed"].pool[k][:s["graphed"].n_pages, :, :,
                                 i * H // TP_N:(i + 1) * H // TP_N].cpu()).abs().max())
                          for k in ("k", "v"))
                check(err <= TP_POOL_BAND, f"{name} {mode} on rank {i}: pool slice {err:.3g} "
                                           "from the single-card heads")
            if "logits" in res:
                check(res["logits"]["streamed_bitwise"],
                      f"{name} on rank {i}: streamed logits != resident bitwise")
        diffs = [r[name]["logits"]["max_diff"] for r in card] if not spec_k else []
        accept = (f", accept counts {s['graphed'].spec_accept_counts}" if spec_k else "")
        print(f"  (a) {name} fp32, tp={TP_N}: {len(want)} requests; streams of the "
              f"{'resident' if spec_k else 'resident and streamed'} engines on the card "
              f"== the single-card engine graphed == eager == CPU, timelines equal"
              f"{accept}; each rank's pool within {TP_POOL_BAND} of its heads of the "
              f"single-card pool"
              + (f"; streamed logits == resident bitwise; largest |TP - single-card| logit "
                 f"{max(diffs):.3g}" if diffs else ""), flush=True)
    return card


def tp_cost_report(card):
    """Phase 20 (c)'s lines, from the card's ranks, with the arithmetic."""
    from ddl25spring_tpu_torch.utils.config import LlamaConfig

    cfg = LlamaConfig()
    S = 4
    ar = 2 * cfg.n_layers * S * cfg.dmodel * 2  # 12 all-reduces of [4, 1, 288] bf16
    for r in card:
        c = r["cost"]
        for name in [n for n in ("resident", "streamed", "single") if n in c]:
            x = c[name]
            want = 2 * ar if name != "single" else 0
            if x["plan"] is not None:  # a layer's rows to the host, TP_N rows back
                want += cfg.n_layers * sum(x["plan"]) * 4 * (1 + TP_N)
            check(name == "single" or x["staged"] == want,
                  f"rank {r['index']} {name}: staged {x['staged']} B a tick, not {want}")
            check(x["held"] <= x["budget"] * 1.05 + (1 << 20),
                  f"rank {r['index']} {name}: {x['held']} B held against a bill of "
                  f"{x['budget']} B")
            print(f"  (c) rank {r['index']} {name} tick (4 slots, full width, bf16, eager): "
                  f"median {x['median_ms']:.3f} ms, device busy {x['busy_ms']:.3f} ms "
                  f"({x['profiled_ms']:.3f} ms a tick under the profiler); all-reduce "
                  f"{x['allreduce_ms']:.3f} ms and all-gather {x['gather_ms']:.3f} ms a tick, "
                  f"staged {x['staged']:.0f} B a tick (arithmetic {want}); persistent "
                  f"{x['held']} B against mem_budget_bytes() {x['budget']}; peak over the "
                  f"ticks {x['peak']} B", flush=True)
        res, st = c["resident"], c["streamed"]
        # the layer computing and the next in flight, whole, and the
        # computing one's TP slices and their casts: at most 3 layers
        layer = st["layer_bytes"]
        extra = (st["peak"] - st["held"]) - (res["peak"] - res["held"])
        check(extra <= 3 * layer, f"rank {r['index']}: the streamed tick's transient bytes "
                                  f"exceed the resident tick's by {extra} B, past 3 gathered "
                                  f"layers ({3 * layer} B)")
        print(f"  (c) rank {r['index']} peak: streamed {st['peak']} B against resident "
              f"{res['peak']} B ({st['peak'] - res['peak']:+d} B); the streamed tick's "
              f"transient above the resident one's {extra} B = {extra / layer:.2f} gathered "
              f"layers of {layer} B", flush=True)
    d = card[0]["cost"]["divergence"]
    check(d["streamed_equals_resident"], f"streamed and resident bf16 streams differ: {d}")
    print(f"  (c) bf16 slot 0, {d['compared']} tokens: TP == single-card "
          + ("throughout" if d["first"] is None else
             f"up to position {d['first']}, where the single-card top-2 gap is {d['gap']:.3g}")
          + "; streamed == resident", flush=True)


def tp_bench(tmp) -> dict:
    """Phase 20 (b): ``bench --serve --serve-model ref --serve-tp 2`` at full
    width (bf16) through the entry point, resident and with
    ``DDL25_SERVE_WEIGHT_STREAM=1``, each row through ``serve_report
    --check-tp``; where a bf16 row's streams differ (the row-parallel sums
    round otherwise than one product), the gate runs on an fp32 tiny-deep
    row, which must pass."""
    import os

    from ddl25spring_tpu_torch import bench
    from ddl25spring_tpu_torch.obs.report import format_report, summarize_run
    from tools import mem_report, serve_report

    out = {}
    for mode, env, seconds in (("resident", {}, TP_BENCH_S),
                               ("streamed", {"DDL25_SERVE_WEIGHT_STREAM": "1"}, TP_STREAMED_S)):
        led, obs_dir = os.path.join(tmp, f"{mode}.jsonl"), os.path.join(tmp, mode)
        os.environ.update(env)
        t0 = time.perf_counter()
        try:
            rec = bench.main(["--serve", "--serve-model", "ref", "--serve-tp", str(TP_N),
                              "--device", "cuda", "--serve-duration", str(seconds),
                              "--no-serve-ab", "--no-serve-prefix-ab", "--perf-ledger", led,
                              "--obs-dir", obs_dir])
        finally:
            for k in env:
                os.environ.pop(k)
        wall = time.perf_counter() - t0
        cell = rec["telemetry"]["serve"]
        tab = cell["tp_ab"]
        check(cell["tp"] == TP_N and cell["weight_stream"] is (mode == "streamed")
              and cell["completed"] == cell["admitted"] and cell["pool_leak"]["ok"]
              and cell["pool_ok_failures"] == 0 and tab["budget_shrunk"],
              f"{mode}: the TP ramp left work or pages, or the bill did not shrink: {cell}")
        gate = serve_report.main([obs_dir, "--ledger", led, "--check-tp"])
        mem = rec["telemetry"]["mem"]
        with open(os.path.join(obs_dir, "mem.json")) as f:
            mem_doc = json.load(f)
        band = mem_doc["budget"]
        mem_gate = mem_report.main(["--run", obs_dir, "--check"])
        check(mem.get("enabled") and mem_doc["mesh"] == {"replicas": 1, "tp": TP_N}
              and band.get("within_band") and mem_doc["leaked_pages"] == 0 and mem_gate == 0,
              f"{mode}: rank 0's mem record off, out of its per-rank band or leaking "
              f"(mem_report --check {mem_gate}): {mem_doc['mesh']}, {band}")
        text = format_report(summarize_run(obs_dir))
        check(f"tp {TP_N}" in text and f"tp A/B (tp={TP_N})" in text and "KiB/chip" in text,
              f"{mode}: the report does not render the TP lines of serve.json")
        print(f"  (b) {mode}: rank 0's live peak {band['measured_peak_bytes']} B above its "
              f"floor of {band['floor_bytes']} B, against its band's bill "
              f"{band['budget_bytes']} B (its mem_budget_bytes(per_chip=True) + the dense copy "
              f"{band['dense_copy_bytes']} B + {band['blas_workspaces']} cuBLAS workspaces of "
              f"{band['blas_workspace_bytes']} B; ratio {band['ratio']}, "
              f"{band['ratio_on_bill']} on the bill and dense copy), mesh {mem_doc['mesh']}, mem_report "
              f"--check exit {mem_gate}; the report's TP lines: "
              + "; ".join(ln.strip() for ln in text.splitlines()
                          if ln.strip().startswith(("tp ", "tp A/B"))), flush=True)
        print(f"  (b) bench --serve-tp {TP_N} {mode}, full width bf16, {cell['requests']} "
              f"requests, {wall:.1f} s: {cell['tokens_per_sec_per_chip']} tokens/s, TTFT p50 "
              f"{cell['ttft_s_p50'] * 1e3:.3f} ms, per-token p50 "
              f"{cell['tok_latency_s_p50'] * 1e3:.3f} ms; pool {cell['pool_bytes_per_chip']} B "
              f"and parameters {cell['param_bytes_per_chip']} B per rank, bill "
              f"{tab['tp_mem_budget_bytes_per_chip']} against {tab['dense_mem_budget_bytes_per_chip']}"
              f" B; tokens_match {tab['tokens_match']} over {tab['compared_requests']} requests; "
              f"serve_report --check-tp exit {gate}", flush=True)
        check(gate == 0 or tab["tokens_match"] is False,
              f"{mode}: serve_report --check-tp failed ({gate}) with the streams equal: {tab}")
        miss = tab["first_mismatch"]
        check((miss is None) is tab["tokens_match"],
              f"{mode}: tokens_match {tab['tokens_match']} but first_mismatch {miss}")
        if miss is not None:
            print(f"  (b) {mode}: the bf16 TP streams leave the single card's at request "
                  f"{miss['rid']}, position {miss['position']} (TP token {miss['sharded']}, "
                  f"single-card {miss['dense']}), where the single-card top-2 gap is "
                  f"{miss['top2_gap']:.3g}", flush=True)
        out[mode] = (cell, gate)
    if any(gate for _, gate in out.values()):
        led, obs_dir = os.path.join(tmp, "deep.jsonl"), os.path.join(tmp, "deep")
        deep = bench.main(["--serve", "--smoke", "--serve-model", "tiny-deep", "--serve-tp",
                           str(TP_N), "--device", "cuda", "--no-serve-ab",
                           "--no-serve-prefix-ab", "--perf-ledger", led, "--obs-dir", obs_dir])
        gate = serve_report.main([obs_dir, "--ledger", led, "--check-tp"])
        check(gate == 0, f"serve_report --check-tp failed ({gate}) on the fp32 tiny-deep row: "
                         f"{deep['telemetry']['serve']['tp_ab']}")
        print(f"  (b) the bf16 streams differ (see (c) for where); fp32 tiny-deep bench "
              f"--serve-tp {TP_N}: serve_report --check-tp passes", flush=True)
    return out


def tp_phase(dev) -> dict:
    """Phase 20, each sub-phase timed; checks that no flash kernel launched
    (here and on every rank)."""
    import tempfile

    from ddl25spring_tpu_torch.ops import flash_attention as fa

    fa.reset_launches()
    t0 = time.perf_counter()
    card = tp_exactness(dev)
    tp_cost_report(card)
    print(f"  (a), (c) took {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        cells = tp_bench(tmp)
    print(f"  (b) took {time.perf_counter() - t0:.1f} s", flush=True)
    launches = {n: fa.LAUNCHES[n] + sum(fa.CAPTURED[n].values()) for n in fa.LAUNCHES}
    for r in card:
        for n, c in r["launches"].items():
            launches[n] += c
    check(not any(launches.values()), f"TP serving launched flash kernels: {launches}")
    return {"launches": launches, "cells": cells}


OBS_PERF_REPS = 8               # phase 21: barriered reps of the per-batch step
OBS_FEDAVG_ROUNDS = 2           # phase 21: the bench's FedAvg rounds (cut from 10)


def bench_obs_phase(dev) -> dict:
    """Phase 21: ``bench.main(["--device", "cuda", "--obs-dir", D, "--perf-reps",
    "8", "--rounds", "2", "--perf-ledger", L])`` at full width (ResNet-18,
    batch 1024, bf16, 16 steps per CUDA graph): the perf, mem and goodput
    cells and records, the flight dump's live tensors, the run's report,
    and the gate tools on ``D`` and ``L``; no flash kernel launched (the
    count the child that ran the path puts on its line)."""
    import os
    import tempfile

    from ddl25spring_tpu_torch import bench
    from ddl25spring_tpu_torch.obs import goodput
    from ddl25spring_tpu_torch.obs.report import format_report, summarize_run
    from ddl25spring_tpu_torch.utils.flops import PEAK_BF16_FLOPS
    from tools import goodput_report, mem_report, perf_report

    name = torch.cuda.get_device_name(0)
    with tempfile.TemporaryDirectory() as tmp:
        d, led = os.path.join(tmp, "run"), os.path.join(tmp, "ledger.jsonl")
        t0 = time.perf_counter()
        rec = bench.main(["--device", "cuda", "--obs-dir", d, "--perf-reps",
                          str(OBS_PERF_REPS), "--rounds", str(OBS_FEDAVG_ROUNDS),
                          "--perf-ledger", led, "--attempts", "1"])
        wall = time.perf_counter() - t0
        check("error" not in rec, f"the bench failed: {rec.get('error')}")
        tel = rec["telemetry"]
        sec = rec["secondary"]
        check([x.get("input", x.get("metric")) for x in sec]
              == ["hbm-resident-shuffle", "native-stream-uint8", "fixed-device-batch",
                  "fedavg_round_ms"] and all(x["value"] and x["value"] > 0 for x in sec),
              f"the line's secondaries are not the JAX bench's four: {sec}")
        check("pinned buffers" in sec[1].get("note", ""),
              f"native-stream-uint8 did not stream: {sec[1]}")
        check(rec.get("h2d_mib_per_s") and rec["h2d_mib_per_s"] > 0,
              f"h2d_mib_per_s {rec.get('h2d_mib_per_s')}")
        check("error" not in tel["perf"], f"perfscope failed: {tel['perf']}")
        with open(os.path.join(d, "perf.json")) as f:
            perf = json.load(f)
        peak = PEAK_BF16_FLOPS["NVIDIA H100 80GB HBM3"]
        want_mfu = perf["flops"] / (perf["step_s_p50"] * peak)
        check(perf["chip"] == name and perf["peak_source"] == "datasheet"
              and perf["peak_flops_per_chip"] == peak,
              f"perf record's chip {perf['chip']} / {perf['peak_source']} / "
              f"{perf['peak_flops_per_chip']}, want {name} / datasheet / {peak}")
        check(abs(perf["flops"] / RESNET_FLOPS - 1) < 0.1,
              f"perf FLOPs {perf['flops']:.4g} not within 10 % of {RESNET_FLOPS:.4g}")
        check(abs(perf["measured_mfu"] / want_mfu - 1) < 1e-9,
              f"measured_mfu {perf['measured_mfu']} != flops / (p50 x peak) {want_mfu}")
        check(perf["exposed_comms_s"] is not None and perf["exposed_comms_s"] >= 0,
              f"exposed_comms_s {perf['exposed_comms_s']}")
        mem = tel["mem"]
        with open(os.path.join(d, "mem.json")) as f:
            mem_doc = json.load(f)
        band = mem_doc["budget"]
        check(mem.get("enabled") and mem["growth_violations"] == 0 and band.get("within_band")
              and band["source"] == "first_sample_live_bytes"
              and 0 < mem_doc["memscope"]["live_bytes_peak"] <= rec["peak_bytes_allocated"],
              f"telemetry.mem off, growing, out of its band or not the allocator's: {mem}")
        with open(os.path.join(d, "flight.json")) as f:
            live = json.load(f)["live_arrays"]
        check(live["largest"] and any(t["device"] == str(dev) for t in live["largest"]),
              f"the flight dump names no live tensor on the card: {live}")
        doc = goodput.read_run_goodput(d)
        check(doc is not None and doc["sum_check"]["ok"] and tel["goodput"]["sum_check"]["ok"],
              f"the goodput doc breaks its sum-to-wall contract: {tel['goodput']}")
        text = format_report(summarize_run(d))
        check(all(t in text for t in ("performance (perf.json", "memory (mem.json",
                                       "goodput (goodput.json", "health (flight.json")),
              "the run's report lacks a section")
        gates = {"perf_report --check": perf_report.main(["--ledger", led, "--check"]),
                 "mem_report --run --check": mem_report.main(["--run", d, "--check"]),
                 "mem_report --ledger --check": mem_report.main(["--ledger", led, "--check"]),
                 "goodput_report --check": goodput_report.main(["--ledger", led, "--check"]),
                 "goodput_report --run": goodput_report.main(["--run", d])}
        check(not any(gates.values()), f"a gate tool failed: {gates}")
    # the bench ran in a child of the retry driver: its own count, off its line
    launches = rec.get("flash_launches")
    check(isinstance(launches, dict) and set(launches) == {"fwd", "dq", "dkv"}
          and not any(launches.values()),
          f"the bench's path launched flash kernels (or its line has no count): {launches}")
    phases = tel.get("phases") or {}
    largest = live["largest"][0]
    print(f"  headline: {rec['value']} samples/s per card ({rec['input']}), MFU {rec['mfu']} "
          f"(the 16-step graph window); phases {phases}", flush=True)
    print(f"  perf record (per-batch step, {perf['reps']} barriered reps): p50 "
          f"{perf['step_s_p50'] * 1e3:.3f} ms, p95 {perf['step_s_p95'] * 1e3:.3f} ms, min "
          f"{perf['step_s_min'] * 1e3:.3f} ms, compute-only p50 "
          f"{perf['compute_s_p50'] * 1e3:.3f} ms, exposed comms "
          f"{perf['exposed_comms_s'] * 1e3:.3f} ms; {perf['flops']:.6g} FLOP "
          f"({perf['flops'] / RESNET_FLOPS:.4f} of 3.41e12); measured MFU "
          f"{perf['measured_mfu']:.4f} against the headline's {rec['mfu']} (chip {perf['chip']}, "
          f"peak {perf['peak_flops_per_chip']:.4g} {perf['peak_source']})", flush=True)
    print(f"  mem: {mem['samples']} samples, live peak {band['measured_peak_bytes']} B against "
          f"the first sample's {band['budget_bytes']} B (ratio {band['ratio']}), "
          f"max_memory_allocated {rec['peak_bytes_allocated']} B (the child's), 0 growth "
          f"violations; "
          f"the flight dump's largest live tensor {largest['shape']} {largest['dtype']} "
          f"{largest['bytes']} B on {largest['device']}", flush=True)
    print(f"  goodput: fraction useful {doc['fraction_useful']} of {doc['total_wall_s']} s "
          f"(seconds {doc['seconds']}), sum_check ok; gates {gates}; flash launches in the "
          f"child {launches}; the bench took {wall:.1f} s", flush=True)
    print(f"  secondaries (samples/s per card): " + ", ".join(
        f"{x.get('input', x.get('metric'))} {x['value']}" for x in sec)
          + f"; h2d {rec['h2d_mib_per_s']} MiB/s", flush=True)
    return {"perf": perf, "mem": mem, "goodput": tel["goodput"], "wall_s": wall}


RESUME_STEPS = 6                # phase 22 (a): timed steps of the sigterm lineage, one a dispatch
RESUME_KILL = 3                 # (a): sigterm@k
RESUME_BATCH = 256              # (a): rows a step (cut from the bench's 1024, as (b)'s)
ELASTIC_STEPS = 6               # (b): timed steps of the elastic run (2 ranks on cuda:0)
ELASTIC_LOSS = 2                # (b): device_loss@k
ELASTIC_BATCH = 256             # (b): rows a rank (cut from 1024: after the reshape each replica runs both)
BENCH_ROWS = 8192               # (a), (b): the train split on the card (DDL25_BENCH_NTRAIN), cut from 50,000

# the bench as a user runs it, then whether this (parent) process made a CUDA context
_BENCH_PARENT = r"""
import json, sys, torch
from ddl25spring_tpu_torch import bench
bench.main(sys.argv[1:])
print(json.dumps({"parent_cuda_initialized": torch.cuda.is_initialized()}))
"""


def bench_cli(argv, env, timeout=900):
    """``python -c _BENCH_PARENT argv`` with ``env`` over this process's
    environment: ``(rc, bench record, parent_cuda_initialized, stderr,
    wall seconds)``."""
    import os

    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-c", _BENCH_PARENT, *argv], capture_output=True,
                       text=True, timeout=timeout, env={**os.environ, **env})
    dicts = []
    for line in r.stdout.splitlines():
        try:
            d = json.loads(line)
        except ValueError:
            continue
        if isinstance(d, dict):
            dicts.append(d)
    tail = dicts[-1] if dicts else {}
    rec = dicts[-2] if len(dicts) >= 2 else {}
    return (r.returncode, rec, tail.get("parent_cuda_initialized"), r.stderr,
            time.perf_counter() - t0)


def resilient_start(pool, tmp, device="cuda", extra=(), parts="abc", ready=None) -> dict:
    """Start phase 22's runs named in ``parts`` on ``pool``, each through the
    bench's command line in ``tmp``: (a) a sigterm lineage resumed from its
    durable step, (b) the elastic 2 -> 1 reshape, (c) the bench on a host
    with no visible GPU; returns their futures by part, for
    :func:`resilient_phase`.  ``device`` and ``extra`` flags for (a) and (b)
    (``"cpu"`` and a small ``--per-chip-batch`` rehearse them on the
    host).  ``ready``: a future that (a) waits for before it starts (the
    inputs of its streamed secondary, :func:`stream_inputs`)."""
    import os

    base = ["--device", device, "--no-fedavg", "--perf-reps", "0", *extra]
    # fewer host threads a child: the runs share the host's 8 cores with the
    # phases beside them
    rows = {"DDL25_BENCH_NTRAIN": str(BENCH_ROWS), "OMP_NUM_THREADS": "2"}
    futs = {}
    if "b" in parts:
        # as the retry driver's child: the parent adds nothing (b) checks
        futs["b"] = pool.submit(bench_cli, [
            "--per-chip-batch", str(ELASTIC_BATCH), *base, "--elastic", "--steps",
            str(ELASTIC_STEPS), "--attempts", "1", "--obs-dir", os.path.join(tmp, "elastic"),
            "--perf-ledger", os.path.join(tmp, "b.jsonl")],
            {"DDL25_CHAOS": f"device_loss@{ELASTIC_LOSS}", "DDL25_BENCH_CHILD": "1", **rows})
    if "c" in parts:
        futs["c"] = pool.submit(bench_cli, [
            "--device", "cuda", "--no-fedavg", "--perf-reps", "0", "--attempts", "1",
            "--obs-dir", os.path.join(tmp, "nogpu"), "--perf-ledger", os.path.join(tmp, "c.jsonl")],
            {"CUDA_VISIBLE_DEVICES": ""}, 300)
    if "a" in parts:
        futs["a"] = pool.submit(_after, ready, bench_cli, [
            "--per-chip-batch", str(RESUME_BATCH), *base, "--scan-steps", "1", "--steps",
            str(RESUME_STEPS), "--obs-dir", os.path.join(tmp, "lineage"), "--perf-ledger",
            os.path.join(tmp, "a.jsonl")], {"DDL25_CHAOS": f"sigterm@{RESUME_KILL}", **rows})
    return futs


def _after(ready, fn, *args):
    """``fn(*args)`` once the future ``ready`` (if any) has its result."""
    if ready is not None:
        ready.result()
    return fn(*args)


def stream_inputs() -> None:
    """What the bench's streamed secondary reads, made before phase 22 (a)
    and phase 21 need it: the synthesized CIFAR-format binaries and the
    native loader's library (``make`` at first use)."""
    from ddl25spring_tpu_torch.data.cifar10 import ensure_bin_dir
    from ddl25spring_tpu_torch.data.native_loader import load_native_lib

    ensure_bin_dir()
    load_native_lib("libddl25_dataloader.so")


def resilient_phase(tmp, futs, device="cuda") -> tuple[dict, list[str]]:
    """Phase 22's checks on the runs :func:`resilient_start` started in
    ``tmp`` (see the module docstring); returns the facts and the lines to
    print."""
    import os

    out, lines = {}, []
    d, led = os.path.join(tmp, "lineage"), os.path.join(tmp, "a.jsonl")
    dc = os.path.join(tmp, "nogpu")
    rc, rec, parent_ctx, err, wall_a = futs["a"].result()
    check(rc == 0 and rec and "error" not in rec,
          f"(a) the lineage failed: rc {rc}, {rec.get('error')}; {err[-3000:]}")
    tel = rec["telemetry"]
    resume, cell, fails = tel["resume"], tel["goodput"], tel.get("retry_failures", [])
    check(parent_ctx is False, f"(a) the retry parent made a CUDA context: {parent_ctx}")
    check(resume.get("resumes", 0) >= 1 and fails and fails[0]["reason"] == "preempted"
          and fails[0]["rc"] == 143, f"(a) no preempted attempt resumed: {resume}, {fails}")
    lineage = cell.get("lineage_id")
    with open(os.path.join(d, "flight.json")) as f:
        fl_meta = json.load(f)["meta"]
    with open(os.path.join(d, "timeline.jsonl")) as f:
        header = json.loads(f.readline())
    check(lineage and all(f["lineage_id"] == lineage for f in fails)
          and fl_meta.get("lineage_id") == lineage and fl_meta.get("attempt", 0) >= 2
          and header.get("lineage_id") == lineage,
          f"(a) more than one lineage id: {lineage}, {[f['lineage_id'] for f in fails]}, "
          f"{fl_meta.get('lineage_id')}, {header.get('lineage_id')}")
    lost = sum(f["goodput"]["lost_steps"] for f in fails if f.get("goodput"))
    check(cell["scope"] == "train_lineage" and cell["sum_check"]["ok"]
          and cell["replayed_steps_count"] == resume.get("steps_replayed") == lost > 0,
          f"(a) replayed {cell.get('replayed_steps_count')}, steps_replayed "
          f"{resume.get('steps_replayed')}, lost {lost}; sum_check {cell['sum_check']}")
    # in a process of its own: its report stays out of this script's lines
    gate = subprocess.run([sys.executable, "tools/goodput_report.py", "--ledger", led,
                           "--check"], capture_output=True, text=True, timeout=120)
    check(gate.returncode == 0, f"(a) goodput_report --check exit {gate.returncode}: "
                                f"{gate.stdout[-2000:]}")
    sec = rec["secondary"]
    check([x["input"] for x in sec] == ["native-stream-uint8", "fixed-device-batch"]
          and ("pinned buffers" in sec[0]["note"] or device == "cpu"),
          f"(a) secondaries {sec}")
    check(rec.get("flash_launches") == {"fwd": 0, "dq": 0, "dkv": 0},
          f"(a) the resumed child's flash launches {rec.get('flash_launches')}")
    lines.append(
        f"  (a) sigterm@{RESUME_KILL} lineage, {RESUME_STEPS} steps at batch {RESUME_BATCH}: "
        f"attempt 1 "
        f"rc {fails[0]['rc']} ({fails[0]['reason']}, wall {fails[0]['wall_s']} s), resumed "
        f"from step {resume.get('resumed_from_step')}, steps replayed "
        f"{resume.get('steps_replayed')} = lost {lost}, recovery_wall_s "
        f"{resume.get('recovery_wall_s')}, lineage fraction useful {cell['fraction_useful']} "
        f"of {cell['total_wall_s']} s (seconds {cell['seconds']}); headline {rec['value']} "
        f"samples/s per card; secondaries {[(x['input'], x['value']) for x in sec]}; h2d "
        f"{rec.get('h2d_mib_per_s')} MiB/s; goodput_report --check 0; parent CUDA context "
        f"{parent_ctx}; took {wall_a:.1f} s")
    out["lineage"] = {"resume": resume, "goodput": cell, "wall_s": wall_a}

    rc, rec, parent_ctx, err, wall_b = futs["b"].result()
    check(rc == 0 and rec and "error" not in rec,
          f"(b) the elastic run failed: rc {rc}, {rec.get('error')}; {err[-3000:]}")
    resume = rec["telemetry"]["resume"]
    shapes = [(e["old"], e["new"], e["steps_lost"]) for e in resume.get("reshape", [])]
    check(shapes == [({"data": 2}, {"data": 1}, 0)] and resume["total_steps_lost"] == 0
          and rec["value"] > 0 and rec["telemetry"]["goodput"]["sum_check"]["ok"],
          f"(b) reshapes {shapes}, value {rec.get('value')}")
    lines.append(
        f"  (b) elastic device_loss@{ELASTIC_LOSS}, {ELASTIC_STEPS} steps, {ELASTIC_BATCH} rows "
        f"a rank: reshape {shapes}, "
        f"wall {resume['reshape_wall_s']} s, {rec['value']} samples/s per card over "
        f"card-seconds ({rec['topology']}); took {wall_b:.1f} s")
    out["elastic"] = {"resume": resume, "value": rec["value"], "wall_s": wall_b}

    rc, rec, parent_ctx, err, wall_c = futs["c"].result()
    h = rec.get("telemetry", {}).get("health", {})
    check(rc == 0 and str(rec.get("error", "")).startswith(
              "exhausted 1 attempts; last: accelerator unreachable")
          and h.get("reason") == "device_unreachable" and rec.get("value") == 0.0
          and not os.path.exists(os.path.join(dc, "metrics.jsonl")),
          f"(c) no-GPU bench: rc {rc}, {rec}; {err[-2000:]}")
    lines.append(f"  (c) CUDA_VISIBLE_DEVICES=: {rec['error']!r}, health.reason "
                 f"{h['reason']}, no step trained; took {wall_c:.1f} s")
    return out, lines


# ---------------------------------------------------------------- phase 23

TOK_STEPS = 3                   # phase 23 (a): Adam steps per tokenizer
BPE_MERGES = 512                # phase 23 (a): the in-process BPE's merges


def lab_vocab() -> int:
    """The LLaMA labs' vocabulary: the tokenizer's (bytes: 259), as
    ``lab/s01_b2_dp_pp.py:117-121`` sizes it."""
    from ddl25spring_tpu_torch.data.tokenizer import get_tokenizer

    return get_tokenizer().vocab_size


def _wait_for_kernels(timeout=600.0):
    """Block until phase 2's libraries exist (built by the parent)."""
    from ddl25spring_tpu_torch.ops import _build

    libs = [_build.library_path(_build.CSRC / f) for f in
            ("flash_attention.cu", "flash_attention_sm90.cu", "flash_attention_tf32x3.cu")]
    t0 = time.perf_counter()
    while not all(lib.exists() for lib in libs):
        check(time.perf_counter() - t0 < timeout, "(a) the kernels were not built in time")
        time.sleep(0.5)


def tokenizer_run() -> None:
    """Phase 23 (a), in a child process: the SentencePiece model
    ``data/tinystories.model`` and a BPE trained here (:data:`BPE_MERGES`
    merges on the synthetic TinyStories text) each feed ``TinyStories`` into
    the full-width LLaMA sized by the tokenizer (dmodel 288, 6 heads, 6
    layers, ctx 256, bf16, flash kernels) for :data:`TOK_STEPS` Adam steps
    on the card: losses finite, the first within 1 of ln(vocab), each flash
    kernel launched 6 times a step, all on ``wgmma``; the native BPE encoder
    ran and equals the Python loop on the whole corpus.  The CPU work runs
    while the parent builds the kernels; the steps wait for them."""
    import warnings

    from ddl25spring_tpu_torch.data.tinystories import TinyStories, _load_corpus
    from ddl25spring_tpu_torch.data.tokenizer import BpeTokenizer, SentencePieceTokenizer
    from ddl25spring_tpu_torch.models import llama
    from ddl25spring_tpu_torch.ops import flash_attention as fa
    from ddl25spring_tpu_torch.ops.losses import causal_lm_loss
    from ddl25spring_tpu_torch.utils.config import LlamaConfig

    t0 = time.perf_counter()
    corpus = " ".join(_load_corpus(0, 200_000))
    bpe = BpeTokenizer.train(corpus, BPE_MERGES)
    t_train = time.perf_counter() - t0
    check(bpe.native, "(a) the native BPE encoder (native/libddl25_bpe.so) did not load")
    t1 = time.perf_counter()
    native_ids = bpe.encode(corpus)
    t_native = time.perf_counter() - t1
    t1 = time.perf_counter()
    py_ids = BpeTokenizer(bpe.merges, native=False).encode(corpus)
    t_py = time.perf_counter() - t1
    check(native_ids == py_ids, "(a) the native BPE encoding differs from the Python loop")
    print(f"  (a) BPE: {len(bpe.merges)} merges (asked {BPE_MERGES}) trained on "
          f"{len(corpus)} chars in {t_train:.1f} s; native encoder ran, {len(native_ids)} ids "
          f"equal to the Python loop's ({t_native * 1e3:.1f} ms native, {t_py * 1e3:.1f} ms "
          "Python)", flush=True)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        sp = SentencePieceTokenizer("data/tinystories.model")
    _wait_for_kernels()
    dev = torch.device("cuda", 0)
    B, L = MAIN_SHAPE[0], MAIN_SHAPE[1]
    facts = {}
    for name, tok in (("sentencepiece", sp), ("bpe", bpe)):
        cfg = LlamaConfig(vocab_size=tok.vocab_size, dtype="bfloat16", use_flash=True)
        model = llama.Llama(cfg, device=dev, generator=torch.Generator().manual_seed(0))
        opt = torch.optim.Adam(model.parameters(), lr=8e-4)
        ds = iter(TinyStories(tok, batch_size=B, seq_l=L, seed=0))
        losses, per_step = [], []
        for _ in range(TOK_STEPS):
            t = torch.as_tensor(next(ds), dtype=torch.long, device=dev)
            check(int(t.max()) < cfg.vocab_size, f"(a) {name}: an id past the embedding")
            fa.reset_launches()
            opt.zero_grad(set_to_none=True)
            loss = causal_lm_loss(llama.llama_forward(model, t, cfg), t)
            loss.backward()
            opt.step()
            losses.append(float(loss.detach()))
            per_step.append((dict(fa.LAUNCHES),
                             {n: dict(c) for n, c in fa.LAUNCHES_BY_VARIANT.items()}))
        check(all(math.isfinite(x) for x in losses), f"(a) {name}: losses {losses}")
        check(abs(losses[0] - math.log(cfg.vocab_size)) < 1.0,
              f"(a) {name}: first loss {losses[0]:.3f} far from ln({cfg.vocab_size})")
        want = {k: cfg.n_layers for k in ("fwd", "dq", "dkv")}
        for launches, by_variant in per_step:
            check(launches == want, f"(a) {name}: launches a step {launches} != {want}")
            check(all(by_variant[k].get("wgmma", 0) == cfg.n_layers for k in want),
                  f"(a) {name}: launches by variant {by_variant}, not all on wgmma")
        print(f"  (a) {name}: vocab {cfg.vocab_size}, loss {losses[0]:.4f} -> {losses[-1]:.4f} "
              f"over {TOK_STEPS} Adam steps (full width, bf16, ctx {L}, batch {B}); flash "
              f"launches a step {per_step[-1][0]}, all on wgmma", flush=True)
        facts[name] = per_step[-1][0]
    print(f"  (a) in {time.perf_counter() - t0:.1f} s (its process)", flush=True)
    print("23a " + json.dumps(facts), flush=True)


_TOKENIZER = r"""
import sys, torch
import chip_smoke
try:
    chip_smoke.tokenizer_run()
except chip_smoke.PhaseError as e:
    print(f"FAILED: {e}", flush=True)
    sys.exit(1)
"""


def tokenizer_proc() -> tuple[str, dict]:
    """Phase 23 (a) (:func:`tokenizer_run`) in a child process; returns what
    it printed and its flash launches a step by tokenizer, and fails as the
    child did."""
    import os

    r = subprocess.run([sys.executable, "-c", _TOKENIZER], capture_output=True, text=True,
                       timeout=900, cwd=os.path.dirname(os.path.abspath(__file__)))
    check(r.returncode == 0, f"23 (a) exit {r.returncode}: {r.stdout[-3000:]} "
                             f"{r.stderr[-3000:]}")
    lines = r.stdout.splitlines()
    facts = json.loads(next(x for x in lines if x.startswith("23a "))[4:])
    return "".join(x + "\n" for x in lines if not x.startswith("23a ")), facts


def golden_quick(dev) -> None:
    """Phase 23 (a)'s last part, in the FL phase's process (9 (e)'s, after
    the VFL and the VAE; it ends before phase 7 does, off the critical
    path): ``golden_tables --quick`` on the card; its header says which data
    the table stands on."""
    import contextlib
    import io

    from ddl25spring_tpu_torch.examples import golden_tables

    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rows = golden_tables.main(["--quick", "--device", dev.type])
    lines = out.getvalue().splitlines()
    check(lines and lines[0].startswith("# data: "), f"(a) golden_tables header {lines[:1]}")
    check(len(rows) == 2 and all(0.0 <= r["final_acc"] <= 1.0 for r in rows),
          f"(a) golden_tables rows {rows}")
    print(f"  23 (a) golden_tables --quick on the card in {time.perf_counter() - t0:.1f} s: "
          f"{lines[0]}")
    for r in rows:
        print(f"  23 (a)   {r['server']} N={r['N']} C={r['C']}: final acc "
              f"{r['final_acc']:.4f} (golden {r['golden']})")


def registry_run() -> list[str]:
    """Phase 23 (b): one spawned world of 4 ranks on ``cuda:0`` over gloo runs
    all 16 training strategies' ``describe()``, each for one step on its
    default mesh (the ``(1, 2)`` strategies on a 2-rank grid inside the
    world): every signature holds on every rank, the step's memory peak
    (``max_memory_allocated`` above the rank's allocation before the
    describe) is judged and under its budget.  Returns one line per
    strategy (rank 0's kinds, counts, bytes, peak against budget)."""
    from ddl25spring_tpu_torch.obs import comm_analytics as ca

    t0 = time.perf_counter()
    ranks = ca.run_in_world(device="cuda", timeout=SPAWN_TIMEOUT)
    lines = []
    for name in ca.STRATEGIES:
        reps = [r[name] for r in ranks if r[name] is not None]
        check(reps, f"(b) {name}: no rank ran it")
        for r in reps:
            check(r["signature_violations"] == [],
                  f"(b) {name} rank {r['rank']}: {r['signature_violations']}")
            peak, budget = r["memory"]["peak_bytes"], r["memory"]["budget_bytes"]
            check(peak is not None and budget is not None and 0 < peak <= budget,
                  f"(b) {name} rank {r['rank']}: peak {peak} B against budget {budget} B")
        peaks = [r["memory"]["peak_bytes"] for r in reps]
        lines.append(f"  (b) {ca.format_report(reps[0])}; peaks over its ranks "
                     f"{min(peaks)}-{max(peaks)} B")
    lines.append(f"  (b) 16 strategies held in one world of {ca.WORLD} ranks in "
                 f"{time.perf_counter() - t0:.1f} s")
    return lines


def lint_gate() -> str:
    """Phase 23 (c): the port's tree lints clean, source and host-safety passes
    (``python -m ddl25spring_tpu_torch.analysis --check --host-safety``),
    beside the build; touches no card."""
    import os

    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "ddl25spring_tpu_torch.analysis", "--check",
                        "--host-safety"], capture_output=True, text=True, timeout=300,
                       cwd=os.path.dirname(os.path.abspath(__file__)))
    check(r.returncode == 0, f"(c) lint exit {r.returncode}: {r.stderr[-3000:]}")
    heads = [line for line in r.stdout.splitlines() if line.startswith(("source lint",
                                                                        "host-safety"))]
    return (f"  (c) {'; '.join(heads)}; {r.stderr.strip().splitlines()[-1]} "
            f"({time.perf_counter() - t0:.1f} s, beside the build)")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 2
    from ddl25spring_tpu_torch import primer
    from ddl25spring_tpu_torch.ops import _build
    from ddl25spring_tpu_torch.ops import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions in full fp32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    print("== card")
    card = card_line()
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}, sm_{''.join(map(str, torch.cuda.get_device_capability(0)))}")

    print("== build")
    t0 = time.perf_counter()
    # phase 9 (e), phase 22 and phase 23 build no kernel and time nothing of
    # the card: 9 (e), 22 (a)-(c) and 23 (a), (c) start here, 23 (b) (the
    # registry world, on the kernels) once they are built; all of them run
    # beside the build, phase 3, the model check and phase 7 (whose checks
    # time nothing) and end before the primer, which has the card to itself.
    # Phase 22's and 23's lines print after phase 21
    import os
    import shutil
    import tempfile

    side = concurrent.futures.ThreadPoolExecutor(8)
    tmp22 = tempfile.mkdtemp(prefix="phase22-")
    binaries = side.submit(stream_inputs)
    # (a)'s streamed secondary reads what stream_inputs makes
    runs22 = resilient_start(side, tmp22, ready=binaries)
    lint23 = side.submit(lint_gate)
    tok23 = side.submit(tokenizer_proc)
    print("  phase 9 (e), federated learning (cuDNN, cuBLAS), beside the build:", flush=True)
    vertical = side.submit(fl_vertical_generative_proc)
    t_side, ends = time.perf_counter(), {}

    def timed(name, f):
        f.add_done_callback(lambda _: ends.setdefault(name, time.perf_counter()))

    for name, f in (("9 (e)", vertical), ("23 (a)", tok23), ("23 (c)", lint23),
                    *((f"22 ({k})", f) for k, f in runs22.items())):
        timed(name, f)
    libs = _build.build(_build.CSRC / "flash_attention.cu", _build.CSRC / "flash_attention_sm90.cu",
                        _build.CSRC / "flash_attention_tf32x3.cu")
    reg23 = side.submit(registry_run)
    timed("23 (b)", reg23)
    print(f"  {', '.join(lib.name for lib in libs)} in {time.perf_counter() - t0:.1f} s "
          f"(one nvcc each, in parallel; phase 9 (e), 22 and 23 (a), (c) beside them)")
    for lib in libs:
        print_ptxas(lib.with_suffix(".log").read_text())

    print("== kernels vs plain versions")
    B, L, H, hd = MAIN_SHAPE
    gen = torch.Generator().manual_seed(0)
    main_err = kernel_case(fa, gen, dev, B * H, L, L, hd, torch.bfloat16, True)
    fp32_err = kernel_case(fa, gen, dev, B * H, L, L, hd, torch.float32, True)
    for case in [
        (B * H, L, L, hd, torch.float32, False),
        (4, 200, 200, 64, torch.float32, True),    # ragged tail
        (4, 200, 200, 64, torch.float32, False),
        (4, 200, 200, 64, torch.bfloat16, True),
        (4, 200, 200, 48, torch.bfloat16, True),
        (4, 200, 200, 40, torch.bfloat16, True),   # hd 40: wgmma N = 48
        (2, 17, 17, 48, torch.bfloat16, True),     # shorter than one tile
        (2, 130, 130, 32, torch.float32, True),
        (2, 100, 100, 128, torch.float32, False),
        (2, 256, 256, 128, torch.bfloat16, True),
        # every wgmma width of the second products: N = 16 (hd 16; box 1 at
        # hd 80), 32 and 48 in box 1 (hd 96, 112)
        (2, 256, 256, 16, torch.bfloat16, True),
        (2, 256, 256, 80, torch.bfloat16, True),
        (2, 256, 256, 96, torch.bfloat16, True),
        (2, 256, 256, 112, torch.bfloat16, True),
        (2, 256, 192, 16, torch.bfloat16, False),
        (2, 200, 200, 112, torch.bfloat16, False),
        (2, 100, 100, 36, torch.bfloat16, True),   # hd not a multiple of 8: scalar bf16
        (4, 256, 192, 48, torch.float32, False),   # non-square, non-causal
        (4, 256, 192, 48, torch.bfloat16, False),
        (2, 66, 66, 48, torch.bfloat16, False),    # odd lengths, BH = 2
        (2, 130, 130, 48, torch.bfloat16, True),
        # fp32 dq and dk/dv on tf32x3: every padded width (hd 20 pads to 32),
        # lengths of 17, 66 and 130, causal and not, Lk != Lq
        (2, 17, 17, 16, torch.float32, True),
        (2, 100, 100, 20, torch.float32, True),
        (2, 66, 66, 80, torch.float32, False),
        (2, 130, 130, 96, torch.float32, False),
        (2, 66, 66, 112, torch.float32, True),
        (2, 130, 130, 128, torch.float32, True),
        (2, 17, 17, 48, torch.float32, False),
        (2, 256, 192, 16, torch.float32, False),
        (3, 17, 40, 36, torch.float32, False),
        (2, 66, 66, 18, torch.float32, True),      # hd not a multiple of 4: scalar fp32
    ]:
        kernel_case(fa, gen, dev, *case)
    misaligned_fp32_case(fa, gen, dev)
    for dtype in (torch.float32, torch.bfloat16):
        for causal in (True, False):
            autograd_case(fa, gen, dev, MAIN_SHAPE, dtype, causal, with_lse=False)
            autograd_case(fa, gen, dev, MAIN_SHAPE, dtype, causal, with_lse=True)
    autograd_case(fa, gen, dev, (2, 200, 2, 64), torch.float32, True, with_lse=True)

    print("== full-width model check (beside phases 9 (e), 22 and 23)")
    model_check(dev)

    print(f"== DP x PP on the card: {DP} x {PP} ranks, {MICRO} microbatches, {ROWS} rows "
          "per replica (beside phases 9 (e), 22 and 23: the slice's step time is no "
          "measurement; 10 (b) times the gpipe step alone)")
    t0 = time.perf_counter()
    fp32_launches = dp_pp_exactness(dev)
    dp_pp_slice(dev)
    nccl_dp(dev)
    print(f"  phase 7 in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    print(vertical.result(), end="")
    binaries.result()
    tok_out, tok_launches = tok23.result()
    lint_out = lint23.result()
    reg_lines = reg23.result()
    for f in runs22.values():
        f.exception()  # wait; phase 22 checks them after phase 21
    side.shutdown()
    print(f"  (phase 9 (e), phase 22 and phase 23 ended {time.perf_counter() - t0:.1f} s "
          "after phase 7; each ran "
          + ", ".join(f"{k} {t - t_side:.1f} s" for k, t in sorted(ends.items(),
                                                                  key=lambda kv: kv[1]))
          + " from the build's start)", flush=True)

    print(f"== the slice: primer, {STEPS} steps, full width, bf16, flash kernels (the card to "
          "itself)")
    fa.reset_launches()
    run = primer.main(["--iters", str(STEPS), "--batch", str(B), "--seq-len", str(L),
                       "--seed", "0"])
    launches = dict(fa.LAUNCHES)
    by_variant = {n: dict(c) for n, c in fa.LAUNCHES_BY_VARIANT.items()}
    losses = run["losses"]
    check(len(losses) == STEPS and all(math.isfinite(x) for x in losses),
          f"losses not all finite: {losses}")
    check(abs(losses[0] - math.log(4096)) < 1.0,
          f"first loss {losses[0]:.3f} far from ln(vocab) {math.log(4096):.3f}")
    first, last = statistics.mean(losses[:5]), statistics.mean(losses[-5:])
    check(last < first, f"loss did not fall: first-5 mean {first:.4f}, last-5 {last:.4f}")
    want = {name: 6 * STEPS for name in ("fwd", "dq", "dkv")}
    check(launches == want, f"kernel launches {launches} != {want}")
    for name in ("fwd", "dq", "dkv"):
        check(by_variant[name]["wgmma"] == 6 * STEPS,
              f"{name} launches by variant {by_variant[name]}: not all on the tensor cores")
    steady = run["step_s"][4:]
    step_ms = statistics.median(steady) * 1e3
    print(f"  loss {first:.4f} (first 5) -> {last:.4f} (last 5); launches {launches}, "
          f"by variant {by_variant}")
    print(f"  step time median {step_ms:.3f} ms (steps 4..{STEPS - 1}, host clock, "
          f"min {min(steady) * 1e3:.3f} ms), {B * L / (step_ms / 1e3):.1f} tokens/s")

    print("== timing at the LLaMA path's shape, bf16 causal")
    timing = time_kernels(fa, gen, dev)

    print("== where the step's time goes (torch.profiler, bf16, full width)")
    for use_flash in (True, False):
        profile_steps(dev, use_flash)

    print("== ResNet-18/CIFAR-10 on the card (cuDNN; no hand-written kernel on this path)")
    t0 = time.perf_counter()
    resnet_phase(dev)
    print(f"  phase 8 in {time.perf_counter() - t0:.1f} s")

    print("== federated learning on the card (cuDNN, cuBLAS; no hand-written kernel on "
          "this path)")
    t0 = time.perf_counter()
    fl_phase(dev, vertical=False)  # (e) ran beside the build
    print(f"  phase 9 (a)-(d) in {time.perf_counter() - t0:.1f} s")

    print(f"== schedules on the card: {', '.join(SCHED)} ({CHUNKS} chunks per rank when "
          "interleaved); grad accumulation; DP overlap")
    t0 = time.perf_counter()
    zroot = tempfile.mkdtemp(prefix="phase17d-")
    worlds = chain_phase(dev, os.path.join(zroot, "zero"))
    ktimes = schedules_phase(dev, worlds)
    fp32_times = ktimes["(f)"][0]["[18, 256, 48] float32 causal"]
    print(f"  phase 10 in {time.perf_counter() - t0:.1f} s (with the world of phases 10-17)")

    print(f"== fused dispatch: K train steps per CUDA graph (LLaMA K = {FUSE_K}, ResNet "
          f"hbm-scan K = {FUSE_K}, grad accumulation K = 4); the FedAvg client axis over ranks")
    print(card)
    t0 = time.perf_counter()
    fused = fused_phase(dev, worlds)
    print(f"  phase 11 in {time.perf_counter() - t0:.1f} s")

    print("== sequence and tensor parallelism on the card: the flash ring, Ulysses and "
          "Megatron TP with the vocab-sharded embedding and loss (4 ranks on cuda:0)")
    print(card)
    t0 = time.perf_counter()
    sptp = sp_tp_phase(dev, worlds["12"], ktimes["12 (c)"])
    print(f"  phase 12 in {time.perf_counter() - t0:.1f} s")

    print("== switch-MoE LLaMA and expert parallelism on the card: MoE in one process "
          "(top-1, top-2), EP x DP, TP-, SP-MoE (4 ranks on cuda:0), MoE through the five "
          "schedules (6 ranks)")
    print(card)
    t0 = time.perf_counter()
    moe = moe_phase(dev, worlds)
    print(f"  phase 13 in {time.perf_counter() - t0:.1f} s")

    print("== the pipeline compositions on the card: EP x DP x PP (6 ranks), DP x PP x TP, "
          "DP x PP x SP and PP x SP x TP (8 ranks), all on cuda:0")
    print(card)
    t0 = time.perf_counter()
    pipe = pipe_phase(dev, worlds["14"], worlds["inputs"]["14"][0], ktimes["14 (e)"])
    print(f"  phase 14 in {time.perf_counter() - t0:.1f} s")

    print("== ZeRO stages 1, 2 and 3 and the partition-rule engine on the card: ResNet-18 "
          "ZeRO-3 and ZeRO-1/2, LLaMA ZeRO-3 with gather prefetch and remat, MoE LLaMA under "
          "ZeRO-3, the rule tables (4 ranks on cuda:0)")
    print(card)
    t0 = time.perf_counter()
    zero3 = zero_phase(dev, worlds["15"], worlds["inputs"]["15"][0])
    print(f"  phase 15 in {time.perf_counter() - t0:.1f} s")

    print("== the observability slice on the card: guarded LLaMA eager and in a CUDA graph "
          "(policy skip), halt in a child, the 2 x 3 DP x PP guard, the lab's trace, the run "
          "directory")
    print(card)
    t0 = time.perf_counter()
    health = obs_phase(dev)
    print(f"  phase 16 in {time.perf_counter() - t0:.1f} s")

    print("== fault tolerance on the card: the 2 x 3 LLaMA lab checkpointed, resumed and "
          "SIGKILLed, the sentinel-gated autosave, the fp32 LLaMA ZeRO-3 reshaped live 4 -> 2 "
          "-> 4 and restored across meshes (4 ranks on cuda:0)")
    print(card)
    t0 = time.perf_counter()
    try:
        ft = ft_phase(dev, zero_world=(worlds["17 (d)"], os.path.join(zroot, "zero")))
    finally:
        shutil.rmtree(zroot, ignore_errors=True)
    print(f"  phase 17 in {time.perf_counter() - t0:.1f} s")

    print("== decode and the serving engine on the card: the paged engine graphed and eager "
          "against the CPU (fp32), bench --serve at full width (bf16), the decode tick's "
          "cost")
    print(card)
    t0 = time.perf_counter()
    serve = serve_phase(dev)
    print(f"  phase 18 in {time.perf_counter() - t0:.1f} s")

    print("== speculative decoding and elastic serving on the card: the spec engine graphed "
          "and eager against the CPU and dense (fp32), DDL25_SERVE_SPEC=1 bench --serve at full "
          "width (bf16), the spec round against the decode tick, replica scale-up/down under "
          "chaos at full width")
    print(card)
    t0 = time.perf_counter()
    spec_elastic_phase(dev)
    print(f"  phase 19 in {time.perf_counter() - t0:.1f} s")

    print(f"== TP-sharded serving and the ZeRO-3 weight-streaming decode on the card ({TP_N} "
          "ranks on cuda:0 over gloo): resident and streamed TP engines against single-card "
          "ones and the CPU (fp32), bench --serve --serve-tp at full width (bf16), the TP "
          "tick's cost and residency")
    print(card)
    t0 = time.perf_counter()
    tp = tp_phase(dev)
    print(f"  phase 20 in {time.perf_counter() - t0:.1f} s")

    print("== the rest of observability on the card: bench --obs-dir at full width (ResNet-18, "
          "batch 1024, bf16, 16 steps per CUDA graph): perfscope's record, memscope's cell, "
          "goodput, the run report and the gate tools")
    print(card)
    t0 = time.perf_counter()
    bench_obs_phase(dev)
    print(f"  phase 21 in {time.perf_counter() - t0:.1f} s")

    print("== the bench's retry driver and resilient run on the card: a sigterm@k lineage "
          "resumed from its durable step, the elastic 2 -> 1 reshape (2 ranks on cuda:0), the "
          "bench with no visible GPU")
    print(card)
    t0 = time.perf_counter()
    try:
        _, lines22 = resilient_phase(tmp22, runs22)
    finally:
        shutil.rmtree(tmp22, ignore_errors=True)
    for line in lines22:
        print(line)
    print(f"  phase 22's checks in {time.perf_counter() - t0:.1f} s (its runs beside the build, "
          "phase 3, the model check and phase 7)")

    print("== the tokenizers, the describe() registry and the lint gate on the card: "
          "SentencePiece and a trained BPE into the full-width LLaMA (bf16, flash), the 16 "
          "training strategies' collective signatures and memory budgets (4 ranks on cuda:0), "
          "the port's tree linted (each beside a phase that times nothing)")
    print(card)
    print(tok_out, end="")
    for line in reg_lines:
        print(line)
    print(lint_out)

    kernels = [
        {"name": f"flash_{name}", "route": "cuda", "source": SOURCE[timing[name]["variant"]],
         "replaces": REPLACES[name], "launches": launches[name],
         "launches_per_fused_window": fused["census"][f"flash_{name}_wgmma"],
         "launches_sp_tp_per_rank": {layout: [c[name] for c in per_rank]
                                     for layout, per_rank in sptp["launches"].items()},
         "launches_moe_per_step": {k: c[name] for k, c in moe["launches"].items()
                                   if k != "dense"},
         "launches_pipeline_compositions_per_rank": {
             run: [c[name] for c in r["launches"]] for run, r in pipe["runs"].items()},
         "launches_zero_per_rank": {run: [c[name] for c in per_rank]
                                    for run, per_rank in zero3["launches"].items()},
         "launches_obs_guarded_per_step": health["eager_launches"][name] // OBS_STEPS,
         "launches_obs_guarded_per_fused_window": health["fused_launches"][f"flash_{name}_wgmma"],
         "launches_obs_dp_pp_per_rank_per_step": [c[name] for c in health["pipe_launches"]],
         "launches_ft_lab_per_rank_per_step": [c[name] for c in ft["lab"]["lab_launches"]],
         "launches_ft_zero3_per_rank_per_step": [
             {run: c[name] for run, c in per_rank.items()} for per_rank in ft["zero3"]["launches"]],
         "launches_serve_per_tick": serve["launches_per_tick"][name],
         "launches_tp_serve": tp["launches"][name],
         "launches_tokenizer_per_step": {tok: c[name] for tok, c in tok_launches.items()},
         "max_abs_err": main_err[name], "max_abs_err_sp_tp": sptp["max_abs_err"][name],
         "max_abs_err_pipeline_compositions": pipe["max_abs_err"][name],
         **timing[name]}
        for name in ("fwd", "dq", "dkv")
    ] + [
        {"name": f"flash_{name}_tf32x3", "route": "cuda", "source": SOURCE["tf32x3"],
         "replaces": REPLACES[name], "launches": fp32_launches[name],
         "max_abs_err": fp32_err[name], "ms": fp32_times["ms"][name],
         "plain_ms": fp32_times["plain_ms"][name], "bound_ms": fp32_times["bound_ms"][name],
         "bound_by": fp32_times["bound_by"][name],
         "library_ms": fp32_times["ms"]["sdpa fwd"] if name == "fwd" else None,
         "bound_ms_cuda_cores": fp32_times["bound_ms_cuda_cores"][name],
         "scalar_device_ms": fp32_times["ms"][f"scalar {name}"],
         "sdpa_bwd_ms": fp32_times["ms"]["sdpa bwd"]}
        for name in ("fwd", "dq", "dkv")
    ]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
