#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --time-tree DIR   # kernel times of one checkout
    python3 chip_smoke.py --sbn-race RUNS [--keep OUT] [DIR[:RUNS] ...]

Phases, in order (a, b, c, e, f, g, h, i, j, k, l, m, n, o, p, d); any
failure exits nonzero:

(a) device and build: the card, its power limit, the torch and CUDA
    versions; every kernel of ``horovod_tpu_torch/csrc`` built with nvcc
    for sm_90a into ``build/horovod_tpu_torch/`` (the native core of
    ``csrc/hvd`` with g++ beside them), with each kernel's
    registers and spill bytes (``-Xptxas -v``) and HGMMA instructions
    (``cuobjdump -sass``) logged, and the forward's key tile in the
    library held equal to ``FWD_KEY_TILE``.
(b) kernels: every mode of each kernel (forward plain, train and state;
    dQ and dK/dV in the input dtype and in fp32) against its plain
    PyTorch version on the card, by normwise relative error — at the
    slice's shape (B=8, T=1024, H=12, D=64, bf16, causal) with q/k/v as
    views of one qkv tensor, as the model passes them, and contiguous; at
    the shapes of (g)'s tp=2 (6 heads) and pp=2/ep=2 (B=4) runs; at
    ragged fp32 and bf16 shapes (T=1000, Tk=700 with offsets and segment
    ids at D=128) and at a windowed causal case (W=256).
    For bf16 inputs the fp32 outputs are also held, at a tighter limit,
    against a plain version that rounds P and dS where the kernels do,
    which must refuse that reference rounded through bf16. At
    the slice's shape also: the plain versions with the last tile dropped,
    which the comparison must refuse, and each kernel's time (CUDA events,
    and the profiler's device time beside it) beside the plain version's,
    the bound, and PyTorch's scaled_dot_product_attention as a
    yardstick. Then the ring's blocks at the sp trainer's block shape
    (B=8, Tq=Tk=2048): the state mode and the fp32 dQ in a past, a
    diagonal and a future block (where the state must be exactly empty and
    dQ exactly 0), the fp32 dK/dV in the first two, with the global lse
    and delta, their planted faults and times; and every mode with packed
    segment ids, at bf16 (4 random segments at the ring's block shape,
    with the planted last-tile faults; then timed at (p)'s shapes, 3
    evenly packed documents of T 8192: Ulysses' full-sequence calls, B=2
    and 6 heads, and the ring's diagonal block, B=2, T=4096, 12 heads,
    with the bound over the pairs visible inside the documents and the
    library on the same boolean mask, rows of the kernel line as
    ``<mode>_seg``) and ragged fp32, where ignoring the ids must be
    refused.
(c) the slice: a small transformer's loss and gradients through the
    kernels against the same model on the CPU; then the GPT-2-small-class
    trainer (12 layers, d_model 768, T 1024, bf16, batch 8) for 2 warm-up
    and 10 steps through hvd.init -> DistributedOptimizer, and one no-grad
    forward. Loss finite and falling, every kernel launched as often as
    the layers and steps say, at least one bucket all-reduce. Then the
    same trainer with ``--remat`` (2 + 10 steps): step-0 loss within bf16
    tolerance of the first run's and every later loss within 1 % of the
    distance the first run's fell, lower peak memory, the forward's train
    mode launched twice per layer and step (the recompute), and a profile.
(e) sp on the card: two worker processes on cuda:0 form an NCCL world
    (each its own ``NCCL_HOSTID``, so NCCL's duplicate-GPU check, which
    compares host hashes, lets two ranks share one card; sockets over
    ``lo``). A small fp32 model with packed segment ids at sp=2, ring and
    Ulysses, against the same weights at sp=1 on the CPU; then the
    GPT-2-small-class trainer at sp=2 over T=4096 (``--sp 2 --seq-len
    4096``, 1 + 1 steps), with its loss, launch counts and bucket
    all-reduces checked on both ranks. The two ranks share one card: its
    step time is a correctness run, not a throughput figure.
(f) images (cuDNN and PyTorch ops; no kernel of the port): a small fp32
    ResNet18 on the card against the same weights on the CPU (loss,
    gradients, updated batch-norm statistics, rel 1e-4, TF32 off); then
    ``image_bench.run`` at full width, bf16, batch 32: ResNet-50 at 224 px
    (2 warm-up + 10 steps; again with ``--space-to-depth``, whose step-0
    loss must be the 7x7 stem's), VGG-16 and Inception-V3 (2 + 3 steps),
    each with images/s, step ms, MFU, peak memory and a profile by kernel
    group; loss finite (falling for ResNet-50), a bucket all-reduce run.
    Then dp=2 on cuda:0 as in (e) (``--dp-worker``): the small model on
    each rank's half batch, world-averaged, against the CPU's mean over
    the halves; ResNet-50 at full width for 1 + 2 steps with fp16 and
    with ef16 compression, the loss, parameters and batch-norm buffers
    equal on both ranks after every step.
(g) tensor, pipeline and expert parallelism: two ranks on cuda:0 in one
    NCCL world as in (e) (``--mp-worker``). Small fp32 models (2 layers,
    d_model 256, 4 heads of 64) at tp=2, pp=2 (M=2), ep=2 (MoE, 4
    experts, top-2, ample capacity) and tp=2 with GQA and RoPE, from the
    same global weights as a dense model on the CPU: the loss and the
    gradients gathered from both ranks' shards against it (rel 1e-4);
    allgather, reducescatter, alltoall, barrier and
    hierarchical_allreduce (local=2/cross=1 and local=1/cross=2) against
    their CPU values; backward_passes_per_step=2 with ef16 at dp=2,
    equal on both ranks and to k=1 on the joined rows. Then the
    GPT-2-small decoder at full width, bf16, 1 + 1 steps each:
    ``transformer_bench --tp 2``, pp=2 (two stages of 6 layers, M=2) and
    a MoE FFN at ep=2 (8 experts, d_expert 3072, top-2, capacity factor
    2.0), through the model's API: loss finite, falling and equal on both
    ranks, attention launched as the layers, steps and microbatches say;
    the tp=2 and pp=2 losses within 1 % of the distance (c)'s size-1 run
    fell (same weights and batch). (b) holds the bf16 kernels at these
    runs' shapes (6 heads a rank, 4 rows a call).
    Step times are correctness runs (two ranks share the card).
(h) ZeRO, checkpoints and Adasum: two ranks on cuda:0 in one NCCL world
    as in (e) (``--zero-worker``), deterministic kernels (cuDNN's and
    PyTorch's), TF32 off. ResNet-50 at 224 px, batch 32 a rank, bf16, SGD
    0.01 with momentum 0.9, at ZeRO stages 1, 2 and 3 (``zero.py``), 1 + 2
    steps each: the loss and the sha256 of the gathered parameters and
    the batch-norm buffers equal on both ranks after every step, stage 1
    equal to stage 2 bitwise, stage 3's losses within ``loss_drift`` of
    stage 2's, each rank's state bytes equal to the analytic model (params
    + masters + momentum + buffers; stage 3 / stage 1 = 0.5005 at d=2),
    with step ms and peak memory. The stage-3 state saved
    (``checkpoint.py``), restored into a fresh template and stepped once
    beside the original: bitwise equal. The flagship decoder with
    ``transformer_bench --zero`` (dp=2, batch 8 global, 1 + 2 steps): the
    attention kernels launched as the layers and steps say, losses equal
    on both ranks and within ``loss_drift`` of (c)'s size-1 run, the
    optimizer state per rank about half the unsharded run's; its state
    saved, restored and stepped: bitwise equal. Adasum: a 64x32 fp32
    model's delta step (``DistributedOptimizer(op=Adasum)``) over NCCL
    against ``adasum_reference`` on the CPU (rel 1e-5), then ResNet-50 with
    ``op=Adasum`` for 1 + 2 steps, equal on both ranks after every step.
(i) the negotiated eager plane: two ranks on cuda:0 in one NCCL world as
    in (e) (``--eager-worker``), ``hvd.init`` with the native core live
    (its controller on the base port + 1; direct mode fails the phase).
    Every op and dtype of the CPU tests through the named plane against
    analytic values, a refused duplicate name, poll before and after
    completion, join (rank 1 leaves after 2 of 5 named allreduces; rank
    0's last 3 are its own values), barrier and broadcast_object. Then
    ResNet-50 as in (f) (224 px, batch 32 a rank, bf16, each rank its own
    batch), 3 steps: every gradient submitted by
    ``hvd.allreduce_async(g, name=f"grad.{param}", op=Sum)`` from its
    post-accumulate hook (161 tensors, 25,557,032 fp32 elements), then
    every handle synchronized; each step bitwise equal to
    ``ops.collectives.grouped_allreduce(op=Sum)`` of the same gradients,
    at least two fused responses a step and cache hits on the worker in
    steps 2 and 3, with the responses, the native enqueue-to-negotiated
    and negotiated-to-executed p50/p99 and the wall ms from the first
    submit to the last synchronize. Last, rank 1's ResNet-50 from another
    seed takes rank 0's parameters by named broadcasts
    (``bcast.param.{i}``): bitwise equal after. No kernel of the port runs
    here (host C++ and NCCL).
(j) the runtime planes around the native core. First a host world without
    ``hvd.init`` (``--host-worker``): four processes as two hosts of two,
    the shm transport and the hierarchical allreduce armed, staging
    (``HOROVOD_HOST_VIA_XLA=1``, threshold 1 KiB) on cuda:0. On the ring:
    allreduce, allgather and broadcast of CPU tensors in fp32, bf16, fp16,
    int32 and int64 against analytic values; ``ring_traffic()`` shows local
    and shm bytes. Staged through NCCL: ResNet-50's gradient bytes in one
    fp32 tensor (timed, and timed again on the ring by ``ring_only``;
    within 1e-6 of the ring's result and of an fp64 sum), bf16, fp16,
    int32 and Average equal to the ring's, a broadcast and a ragged
    allgather; int64, fp64 and the tensors under 1 KiB stay on the ring:
    rank 0's timeline shows ``NCCL_*`` for the staged tensors and nothing
    for the others. Then two ranks of the eager plane
    (``--planes-worker``, one NCCL world for two ``hvd.init``): (i)'s
    ResNet-50 workload for 6 steps with ``HOROVOD_TIMELINE`` on rank 0,
    ``HOROVOD_AUTOTUNE=1`` (a short schedule, so the tuner pins within
    the phase) and ``HOROVOD_METRICS_EXPORT``: every step bitwise equal to
    ``grouped_allreduce``, every gradient's ``NEGOTIATE_ALLREDUCE`` then
    ``NCCL_ALLREDUCE`` in the trace, a response's time split p50/p99
    (enqueue to negotiated, negotiated to the executor's start, the NCCL
    activity), the pinned point and the responses a step; the Prometheus
    textfile parses and holds those counters. Then ``HOROVOD_FAULT_SPEC``
    fires ``xla.exec`` on rank 1 at its third response and ``zero.gather``
    at its second stage-3 step of a small model: the call raises
    ``HorovodInternalError`` on both ranks, those before and after
    complete. Last ``image_bench`` at dp=2 with ``--fault-spec``: the
    ring fields are there and not negative. No kernel of the port runs
    here.
(k) the torch binding and the elastic worker: the batch-norm race,
    ``SBN_RACE_RUNS`` pairs of ``--sbn-race-worker`` one after another,
    each under ``SBN_RACE_TIMEOUT_S`` (ResNet-50 with ``sync_bn_axis="dp"``
    and the example with ``SyncBatchNorm`` under the binding's optimizer,
    ``SBN_RACE_STEPS`` each; a pair that hangs fails (k)), beside two
    ranks on cuda:0 as two hosts of one (``--binding-worker``,
    ``hvd.init()`` of ``horovod_tpu_torch.torch``, deterministic
    kernels): the reference
    binding's worker checks on CUDA tensors and a CPU tensor through the
    host ring; ResNet-50 (bf16, batch 32 a rank) under the binding's
    per-parameter optimizer bitwise the bucketed one over 2 steps;
    ``SyncBatchNorm`` against ``BatchNorm2d`` over the world's batch
    (forward 1e-4, running mean 1e-5, variance 1e-4); ResNet-50 with and
    without ``sync_bn_axis="dp"`` and the example's ResNet-50 with local
    statistics, ``SyncBatchNorm`` and ``SyncBatchNorm`` through the
    binding's public call (``negotiated_statistics``) (ms a step, losses
    finite, world losses equal); ``HOROVOD_FAULT_SPEC`` (``xla.exec``)
    inside ``elastic.run`` with a ``TorchState``, bitwise the clean run;
    the example at two ranks. Then ``--elastic-worker``, twice: rank 1
    SIGKILLed inside its 64 MiB allreduces, and between the batches of a
    model of ``SyncBatchNorm`` (its direct all-reduces only), rank 0 raising
    within ``KILL_BOUND_S`` (the seconds printed), rank 1 respawned with
    its rank, the re-formed world committing its first batch within
    ``REFORM_BOUND_S`` of the kill (the seconds printed), both ending
    with rank 0's parameters; each kill run prints each group's abort
    seconds (``state.abort_report``) and the lost world's teardown, off
    the re-init's path (``state.teardown_report``). Last the example
    at one rank, full size (img/s a device). No kernel of the port runs
    here.
(l) the launcher and the elastic driver, ``python -m
    horovod_tpu_torch.run`` with two slots on cuda:0 as two hosts of one
    (``-H localhost:1,127.0.0.1:1``; each worker command wrapped to set
    its own ``NCCL_HOSTID``): ``--check-build --verbose`` must name the
    card (``COMPUTE=``), NCCL's version and the built kernel; the
    example at two ranks (fp32 ResNet-50, batch 32, 224 px, 1 + 2 x 2
    batches) as a static job, both ranks exiting 0, beside an elastic
    job with only the stall inspector whose rank 1 SIGSTOPs itself
    (rank 0 raising within ``STALL_BOUND_S``, the seconds printed); then
    the
    elastic job (``--launcher-worker``: (k)'s MLP, 64 MiB allreduces)
    with ``HOROVOD_HEARTBEAT_MS`` and a 2000 ms liveness timeout: rank 1
    SIGKILLs itself after batch 5 and SIGSTOPs itself after batch 12,
    the driver respawns it both times, the survivor raises within
    ``HANG_BOUND_S`` of the stop, and the job ends 0 with both ranks'
    parameters equal; the seconds from each fault to the raise and to
    the re-formed world are printed. No kernel of the port runs here.
(m) the TF and Keras bindings, only where ``tensorflow`` and ``keras``
    are installed (a probe; otherwise one line says so and nothing runs):
    the port's TF op library built from ``tensorflow/csrc/tf_ops.cc``;
    two ranks as two hosts of one under the launcher
    (``--tf-worker``) hold allreduce (Sum, Average, Min, Max, fp16
    compression, IndexedSlices), a ragged allgather and a broadcast,
    with their gradients, to numpy, and one ``DistributedGradientTape``
    step of a 256-wide MLP to a world of one's on the joined batch; on
    the host ring, then staged through NCCL (``HOROVOD_HOST_VIA_XLA=1``,
    1 KiB threshold); ``keras_mnist`` at two ranks (four batches). No
    kernel of the port runs here.
(n) the Spark integration and the MXNet binding: one line says which of
    pyspark, pandas, pyarrow, cloudpickle, keras and mxnet are installed.
    The Spark transport without Spark: a ``SparkDriverService``, two
    ``task_main`` processes (``--spark-task``) and
    ``run_via_task_services`` run ``spark_task_fn`` at two ranks on
    cuda:0 through the torch binding (each rank its own ``NCCL_HOSTID``):
    a 64 MiB fp32 Sum allreduce exact against its closed form and 5 steps
    of (k)'s 256-wide MLP under ``DistributedOptimizer``, the results in
    rank order and the parameters equal bitwise on both ranks (sha256);
    beside it a function that raises on every rank, which must be
    reported with its text, and a task that registers after its driver
    gave up, which must stop within ``DRIVER_LOST_BOUND_S``. Where pandas
    and pyarrow are installed, ``TorchEstimator.fit`` on the card
    (``--estimator-worker``: ``pytorch_spark_mnist``'s model without
    dropout, 4096 rows, 1 epoch) against the same fit with
    ``device="cpu"`` (normwise 1e-4, TF32 off) and ``transform`` on the
    card; where Keras is too, ``keras_spark_mnist`` for an epoch; where
    mxnet is, the MXNet binding at one rank. What is absent is named on a
    line and not run. No kernel of the port runs here.
(o) the port's native core on this machine: one probe line (g++, libc,
    kernel, the production core, and whether g++ builds a sound
    ``-fsanitize=thread``). Two worlds of four ranks (two hosts of two)
    on cuda:0 at once, while the TSan core and the stress harness
    (``csrc/testing/stress_core.cc``) build: a host world
    (``--heal-worker``: ``HOROVOD_HIER_CONTROL=1``, two stripes, the
    hierarchical allreduce, staging through NCCL) whose leader 0 cuts its
    cross link mid-allreduce (``HVD_FAULT_CROSS_DROP``): every allreduce
    bitwise the closed form striped, single-socket across the cut and
    striped again, and staged, ``link.reconnects`` >= 1 on both leaders,
    ``world_lost()`` false on every rank; and a torch-binding world on
    NCCL (``--lost-worker``) whose member rank 1 SIGKILLs itself between
    16 MiB allreduces: every survivor raises ``HorovodInternalError``
    within ``KILL_BOUND_S``, printed with each group's abort seconds.
    Then the harness, under TSan where it was built (zero reports),
    else on the production core; its ``departure`` phase (a rank that
    dies after its frame in the cycle of another rank's departure) must
    end all 9 rounds on LOST. No kernel of the port runs here.
(p) the packed long-context example and the tools. Two ranks on cuda:0
    in one NCCL world as in (e) (``--lc-worker``; a world of one on the
    CPU beside them, ``--lc-reference-worker``): the example's ``run()``
    (``examples/long_context.py``) at a small width (2 layers, 2 heads of
    64, T 256, 3 documents, fp32, TF32 off), ring and Ulysses, each
    parameter's step-0 gradient and each loss within rel 1e-4 of sp=1 on
    the CPU from the same weights (the ids moving the CPU's gradients by
    more than 100 times that); then at GPT-2-small widths (d_model 768,
    12 heads, 12 layers, vocab 1024, T 8192 at sp=2, batch 2, 3
    documents, bf16, step 0 + 2 steps) packed under the ring and under
    Ulysses from the same weights: losses finite and equal on both
    ranks, ring and Ulysses within rel 1e-4 at every step, every
    segment-id mode launched as ``packed_launches`` counts by layer, step
    and ring block; then at the step-0 weights again one no-grad forward
    with the ids (the ring's state mode and Ulysses' plain mode with ids
    once a layer and block), its loss the trainer's step-0 loss within
    1e-4, and one without: the unpacked loss not the packed one, the two
    strategies' logits within ``LC_LOGITS_TOL`` row by row, and packing
    moving the logits at the documents' first tokens by more than
    ``LC_IDS_MIN_REL``; step ms, tokens/s, peak memory and a profile of a
    ring step. Then the tools: ``tools.controller_bench --sizes 2,4,8``
    (the port's core, host only: hit and miss p50/p99, the reference's
    gate, the response cache engaged) and ``examples.scaling_bench`` at
    d=1 (ResNet-50, batch 32, 224 px, 2 + 10 steps; (f)'s images/s
    printed beside it), each ``python -m`` from the checkout; then in
    this process ``examples.synthetic_benchmark --num-iters 5``,
    ``tools.kernel_bench`` at T 2048 and 4096, again with ``--packed 4``
    (every numerics check passing), and ``tools.profile_resnet --model
    resnet50 --steps 3`` (a summary with op rows).
(d) the kernel table as one JSON line (the segment-id rows with (p)'s
    launches), the card's name and power limit, and last the result line
    ``{"ok": true, "device": {...}}``.
"""

import contextlib
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent

BF16_PEAK = 989e12      # H100 SXM dense bf16 tensor-core FLOP/s
FP32_PEAK = 67e12       # H100 SXM fp32 FLOP/s outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
SOURCE = "horovod_tpu_torch/csrc/flash_attention.cu"
PALLAS = "horovod_tpu/ops/pallas_attention.py"
REPLACES = {"flash_fwd": f"{PALLAS}:643", "flash_fwd_train": f"{PALLAS}:695",
            "flash_fwd_state": f"{PALLAS}:391",
            "flash_bwd_dq": f"{PALLAS}:737", "flash_bwd_dkv": f"{PALLAS}:770",
            "flash_bwd_dq_f32": f"{PALLAS}:737",
            "flash_bwd_dkv_f32": f"{PALLAS}:770"}
# Normwise relative error ||kernel - plain|| / ||plain||, per output dtype.
# It weighs every element, so a fault in the small late rows of causal
# attention shows; a limit set by max |plain| would be set by the first
# rows and keys, which are ~100x larger. On an H100 the bf16 rounding of
# P, dS and the outputs gives 2.1e-3 to 2.7e-3, and a kernel that drops
# the last tile of its loop reads 2e-2 or more.
TOLERANCE = {"torch.bfloat16": 5e-3, "torch.float32": 1e-5}
# What each limit covers: an output is held to the limit of the dtype its
# products ran in. The row statistics (lse, m, l) come from fp32 scores of
# exact products, so they take the fp32 limit; every other output went
# through bf16 products when the inputs are bf16 (the state mode's fp32
# acc sums P.V with P rounded to bf16; the fp32-output backward rounds P
# and dS to bf16 before its products), so it takes the inputs' limit.
ROW_STATS = ("lse", "m", "l")
# Keys (rows of q for dK/dV) that a planted last-tile fault drops: the
# smallest tile any kernel loops over, so a kernel whose loop ends one tile
# early loses at least this many.
DROPPED = 64
# The bf16 limit cannot tell an fp32 output from one rounded through bf16:
# the plain versions keep P and dS in fp32 (P rounded only against the
# final row max), and that alone reads ~1.7e-3, as much as rounding the
# output does. So the fp32 outputs of bf16 inputs (F32_OUTPUTS) are also
# held against rounded_plain, which rounds P and dS to bf16 where the
# kernels do, at ROUNDED_LIMIT; the same reference rounded through bf16
# is a planted fault that must be refused. On the CPU, perturbing the
# scores by fp32 summation order moves that comparison by ~3e-5, while
# rounding the output through bf16 moves it by ~1.7e-3.
F32_OUTPUTS = {"flash_fwd_state": ("acc",), "flash_bwd_dq_f32": ("dQ",),
               "flash_bwd_dkv_f32": ("dK", "dV")}
ROUNDED_LIMIT = 2e-4


def log(msg):
    print(msg, flush=True)


def card():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout
    return out.strip().splitlines()[0]


def time_ms(fn, iters=20, warmup=3):
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters=20):
    """Device time per call of the port's kernels (names with "flash_")
    that ``fn`` launches, from torch.profiler over ``iters`` calls after
    one warm-up: the kernel's own time where back-to-back CUDA events
    would read the host's launch time. None if the profiler saw none."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = 0.0
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA and \
                "flash_" in e.key:
            t = getattr(e, "self_device_time_total", None)
            us += e.self_cuda_time_total if t is None else t
    return us / 1e3 / iters if us else None


def visible_pairs(Tq, Tk, causal, q_off=0, k_off=0, window=None):
    """(query, key) pairs the attention visits, per batch-head."""
    import torch

    if not causal:
        return Tq * Tk
    iq = torch.arange(Tq)[:, None] + q_off
    ik = torch.arange(Tk)[None, :] + k_off
    ok = iq >= ik
    if window is not None:
        ok &= iq - ik < window
    return int(ok.sum())


def bound(nbytes, flops, dtype):
    import torch

    peak = BF16_PEAK if dtype == torch.bfloat16 else FP32_PEAK
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def rel_err(got, want):
    """||got - want|| / ||want||; 0 when both are exactly zero (a culled
    block's acc and l), inf when only ``want`` is."""
    g, w = got.double(), want.double()
    num, den = (g - w).norm().item(), w.norm().item()
    if den == 0.0:
        return 0.0 if num == 0.0 else math.inf
    return num / den


def limit(output, in_dtype):
    """The normwise limit of ``output`` (see ROW_STATS)."""
    import torch

    return TOLERANCE[str(torch.float32 if output in ROW_STATS else in_dtype)]


def compare(name, got, want, tol, failures):
    """Normwise relative error, printed beside its tolerance with the max
    |got - want|; a miss is added to ``failures``. Returns the max."""
    err = (got.float() - want.float()).abs().max().item()
    rel = rel_err(got, want)
    ok = math.isfinite(rel) and rel <= tol
    log(f"  {name:<26} rel_err {rel:.3e} (tolerance {tol:g})  max_abs_err "
        f"{err:.3e} (max |plain| {want.float().abs().max().item():.3g})  "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append(name)
    return err


OUTPUTS = {"flash_fwd": ("O",), "flash_fwd_train": ("O", "lse"),
           "flash_fwd_state": ("acc", "m", "l"), "flash_bwd_dq": ("dQ",),
           "flash_bwd_dkv": ("dK", "dV"), "flash_bwd_dq_f32": ("dQ",),
           "flash_bwd_dkv_f32": ("dK", "dV")}


def modes(q, k, v, do, lse, delta, kw, names=OUTPUTS):
    """{mode: (kernel call, plain call)} for every mode in ``names``, on
    these inputs; each call returns a tuple of the mode's outputs. The
    backward modes read ``lse``/``delta`` as their row statistics."""
    import torch

    from horovod_tpu_torch.ops import flash_attention as fa

    bwd = (q, k, v, do, lse, delta)
    f32 = dict(kw, out_dtype=torch.float32)
    table = {
        "flash_fwd": (lambda: fa.flash_fwd(q, k, v, **kw)[:1],
                      lambda: fa.flash_fwd_plain(q, k, v, **kw)[:1]),
        "flash_fwd_train": (
            lambda: fa.flash_fwd(q, k, v, with_lse=True, **kw),
            lambda: fa.flash_fwd_plain(q, k, v, with_lse=True, **kw)),
        "flash_fwd_state": (lambda: fa.flash_fwd_state(q, k, v, **kw),
                            lambda: fa.flash_fwd_state_plain(q, k, v, **kw)),
        "flash_bwd_dq": (lambda: (fa.flash_bwd_dq(*bwd, **kw),),
                         lambda: (fa.flash_bwd_dq_plain(*bwd, **kw),)),
        "flash_bwd_dkv": (lambda: fa.flash_bwd_dkv(*bwd, **kw),
                          lambda: fa.flash_bwd_dkv_plain(*bwd, **kw)),
        "flash_bwd_dq_f32": (lambda: (fa.flash_bwd_dq(*bwd, **f32),),
                             lambda: (fa.flash_bwd_dq_plain(*bwd, **f32),)),
        "flash_bwd_dkv_f32": (lambda: fa.flash_bwd_dkv(*bwd, **f32),
                              lambda: fa.flash_bwd_dkv_plain(*bwd, **f32)),
    }
    return {m: table[m] for m in names}


def demangle(names):
    """C++ names as the source spells them (c++filt), else as given."""
    tool = shutil.which("c++filt") or shutil.which("cu++filt")
    if not tool or not names:
        return {n: n for n in names}
    out = subprocess.run([tool], input="\n".join(names), capture_output=True,
                         text=True).stdout.splitlines()
    return dict(zip(names, out)) if len(out) == len(names) else \
        {n: n for n in names}


def kernel_report(name, path):
    """Registers, spill bytes (``-Xptxas -v``) and HGMMA instructions in
    the SASS (``cuobjdump -sass``) of each flash_* instantiation of the
    library: a log, not a check. Registers are the count at entry; the
    bf16 kernels' consumer warpgroups raise theirs with setmaxnreg."""
    from horovod_tpu_torch.ops import _build

    stats, fn = {}, None
    for line in _build.BUILD_LOG.get(name, "").splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) "
                      r"'?(\w+)'?", line)
        if m:
            fn = m.group(1)
            stats.setdefault(fn, {})
        elif fn and (m := re.search(r"(\d+) bytes spill stores, (\d+) bytes "
                                     r"spill loads", line)):
            stats[fn]["spill"] = f"{m.group(1)}/{m.group(2)}"
        elif fn and (m := re.search(r"Used (\d+) registers", line)):
            stats[fn]["regs"] = int(m.group(1))
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    hgmma = None
    if os.access(tool, os.X_OK):
        sass = subprocess.run([tool, "-sass", str(path)], capture_output=True,
                              text=True).stdout
        hgmma, fn = {}, None
        for line in sass.splitlines():
            m = re.search(r"Function : (\w+)", line)
            if m:
                fn = m.group(1)
                hgmma[fn] = 0
            elif fn and "HGMMA" in line:
                hgmma[fn] += 1
    names = sorted(n for n in stats if "flash_" in n)
    pretty = demangle(names)
    for n in names:
        st = stats[n]
        count = "not measured (no cuobjdump)" if hgmma is None else \
            hgmma.get(n, 0)
        log(f"    {pretty[n][:70]:<70} regs {st.get('regs')}, spill "
            f"stores/loads {st.get('spill')} bytes, HGMMA {count}")


def rounded_plain(mode, q, k, v, do, lse, delta, kw, tile):
    """The F32_OUTPUTS of ``mode`` for bf16 inputs, computed as the kernels
    round them: the forward walks the keys in tiles of ``tile`` (the
    kernel's, ``FWD_KEY_TILE``), takes P = exp(S - running max) and rounds
    it to bf16 before P.V, rescaling the fp32 accumulator as the max
    grows; the backward rounds P (for dV) and dS (for dQ and dK) to bf16
    before their products. Every other step is fp32, as in the kernels."""
    import torch

    from horovod_tpu_torch.ops import flash_attention as fa

    args = (kw["causal"], kw["q_off"], kw["k_off"], kw["window"],
            kw.get("q_seg"), kw.get("k_seg"))
    bf16 = torch.bfloat16
    if mode == "flash_fwd_state":
        s = fa._scores(q, k)
        allowed = fa._allowed(q, k, *args)
        if allowed is not None:
            s = torch.where(allowed, s, fa.NEG_INF)
        B, Tq, H, D = q.shape
        acc = torch.zeros((B, H, Tq, D), device=q.device)
        m = torch.full((B, H, Tq, 1), fa.NEG_INF, device=q.device)
        for k0 in range(0, k.shape[1], tile):
            st = s[..., k0:k0 + tile]
            m_new = torch.maximum(m, st.amax(-1, keepdim=True))
            corr = torch.where(m_new > fa.NEG_INF / 2, torch.exp(m - m_new),
                               1.0)
            p = torch.where(st <= fa.NEG_INF / 2, 0.0, torch.exp(st - m_new))
            acc = acc * corr + torch.einsum(
                "bhts,bshd->bhtd", p.to(bf16).float(),
                v[:, k0:k0 + tile].float())
            m = m_new
        return (acc.transpose(1, 2),)
    p, ds = fa._probs_and_dscores(q, k, v, do, lse, delta, *args)
    ds = ds.to(bf16).float()
    if mode == "flash_bwd_dq_f32":
        return (torch.einsum("bhts,bshd->bthd", ds, k.float()),)
    return (torch.einsum("bhts,bthd->bshd", ds, q.float()),
            torch.einsum("bhts,bthd->bshd", p.to(bf16).float(), do.float()))


def check_modes(label, calls, in_dtype, rounded=None):
    """Each mode's kernel against its plain version, output by output;
    with ``rounded`` (the inputs (q, k, v, do, lse, delta, kw), for bf16
    inputs) also each F32_OUTPUTS output against ``rounded_plain`` at
    ROUNDED_LIMIT, with that reference rounded through bf16 as a fault
    the comparison must refuse. Returns ({mode: max_abs_err}, {"mode
    out": plain output})."""
    import torch

    from horovod_tpu_torch.ops import flash_attention as fa

    errs, refs, bad = {}, {}, []
    for mode, (kern, plain) in calls.items():
        want = plain()
        got = kern()
        errs[mode] = 0.0
        for out, g, w in zip(OUTPUTS[mode], got, want):
            if g.dtype != w.dtype or g.shape != w.shape:
                bad.append(f"{mode} {out} {g.dtype}{list(g.shape)}")
                continue
            refs[f"{mode} {out}"] = w
            errs[mode] = max(errs[mode], compare(
                f"{mode} {out}", g, w, limit(out, in_dtype), bad))
        if rounded is None or mode not in F32_OUTPUTS or bad:
            continue
        outs = dict(zip(OUTPUTS[mode], got))
        exact = {}
        q = rounded[0]
        tile = fa.FWD_KEY_TILE[(q.dtype, q.shape[-1])]
        for out, w in zip(F32_OUTPUTS[mode],
                          rounded_plain(mode, *rounded[:6], rounded[6], tile)):
            exact[f"{mode} {out}"] = w
            compare(f"{mode} {out} (rounded P/dS)", outs[out], w,
                    ROUNDED_LIMIT, bad)
        # (A culled block's zero state rounds to itself.)
        refuse({n: w.to(torch.bfloat16).float() for n, w in exact.items()
                if w.abs().max() > 0}, exact, in_dtype,
               "output rounded through bf16", tol=ROUNDED_LIMIT)
    torch.cuda.synchronize()
    if bad:
        raise AssertionError(f"case {label}: kernels disagree with their "
                             f"plain versions: {bad}")
    return errs, refs


def refuse(faults, refs, in_dtype, why, tol=None):
    """Every planted fault ({"mode out": tensor}) must miss its limit
    (``tol`` when given, else the output's limit)."""
    missed = []
    for name, got in faults.items():
        out = name.split()[-1]
        rel = rel_err(got, refs[name])
        lim = tol or limit(out, in_dtype)
        log(f"  fault: {name:<24} {why}: rel_err {rel:.3e} (tolerance "
            f"{lim:g})  {'refused' if rel > lim else 'MISSED'}")
        if not rel > lim:
            missed.append(name)
    if missed:
        raise AssertionError(f"the comparison passes planted faults: "
                             f"{missed}")


def dropped_tile_faults(q, k, v, do, lse, delta, kw, names):
    """The plain versions with the last tile of the inner loop dropped,
    as a kernel whose loop ends one tile early would compute them (for
    dK/dV the last q-tile)."""
    def cut(ids):
        return None if ids is None else ids[:, :-DROPPED].contiguous()

    kw_k = dict(kw, k_seg=cut(kw.get("k_seg")))
    kw_q = dict(kw, q_seg=cut(kw.get("q_seg")))
    short = modes(q, k[:, :-DROPPED], v[:, :-DROPPED], do, lse, delta, kw_k,
                  [n for n in names if "dkv" not in n])
    short.update(modes(q[:, :-DROPPED], k, v, do[:, :-DROPPED],
                       lse[..., :-DROPPED].contiguous(),
                       delta[..., :-DROPPED].contiguous(), kw_q,
                       [n for n in names if "dkv" in n]))
    return {f"{mode} {out}": t for mode, (_, plain) in short.items()
            for out, t in zip(OUTPUTS[mode], plain())}


def segment_ids(B, T, n, generator):
    """int32 [B, T] ids of ``n`` random-length packed segments per row."""
    import torch

    cuts = torch.rand((B, T - 1), generator=generator).argsort(1)[:, :n - 1]
    cuts = (cuts + 1).sort(1).values
    return (torch.arange(T)[None, :, None] >= cuts[:, None, :]).sum(
        -1).to(torch.int32)


def work(name, B, Tq, Tk, H, D, es, pairs):
    """(bytes each input read once and output written once, FLOPs) of one
    call; a call with no visible pair needs only its outputs written."""
    act, act32, rows = B * H * D * es, B * H * D * 4, B * H * 4
    flops = {"flash_fwd": 4, "flash_fwd_train": 4, "flash_fwd_state": 4,
             "flash_bwd_dq": 6, "flash_bwd_dq_f32": 6, "flash_bwd_dkv": 8,
             "flash_bwd_dkv_f32": 8}[name] * D * pairs
    out = {"flash_fwd": Tq * act, "flash_fwd_train": Tq * (act + rows),
           "flash_fwd_state": Tq * (act32 + 2 * rows),
           "flash_bwd_dq": Tq * act, "flash_bwd_dq_f32": Tq * act32,
           "flash_bwd_dkv": 2 * Tk * act, "flash_bwd_dkv_f32": 2 * Tk * act32
           }[name]
    if pairs == 0:
        return out, 0
    inputs = (Tq + 2 * Tk) * act
    if "bwd" in name:
        inputs += Tq * act + 2 * Tq * rows   # dO, lse and delta
    return inputs + out, flops


def time_rows(calls, shape, dtype, pairs, library, errs, ids_bytes=0):
    """{mode: kernel-table row} timing each mode and its plain version;
    ``ids_bytes``: the segment ids, read once more by every mode."""
    B, Tq, Tk, H, D = shape
    table = {}
    for name, (kern, plain) in calls.items():
        ms = time_ms(kern)
        dev_ms = device_ms(kern)
        plain_ms = time_ms(plain, iters=5, warmup=1)
        nbytes, flops = work(name, B, Tq, Tk, H, D, dtype.itemsize, pairs)
        nbytes += ids_bytes
        bound_ms, bound_by = bound(nbytes, flops, dtype)
        table[name] = {
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[name], "launches": 0,
            "max_abs_err": errs[name], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library.get(name), "device_ms": dev_ms}
        log(f"  {name:<18} {ms:.4f} ms (profiler: {dev_ms} ms on the device) "
            f" plain {plain_ms:.4f} ms  bound "
            f"{1e3 * bound_ms:.2f} us ({bound_by}; {nbytes / 1e6:.1f} MB, "
            f"{flops / 1e9:.2f} GFLOP)  library {library.get(name)}")
    return table


def sdpa_times(q, k, v, do, causal, mask=None):
    """PyTorch's fused attention on the same inputs ([B, H, T, D] views),
    a yardstick the port never calls: (fwd ms, bwd ms). With ``mask`` (a
    boolean [B, 1, Tq, Tk], True where a pair is visible) in place of
    ``causal``: the same function as the kernels' segment-id mode."""
    import torch
    import torch.nn.functional as F

    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))
    kw = (dict(is_causal=causal) if mask is None else dict(attn_mask=mask))
    with torch.no_grad():
        fwd = time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                             **kw))
    out = F.scaled_dot_product_attention(qt, kt, vt, **kw)
    dot = do.transpose(1, 2)
    bwd = time_ms(lambda: torch.autograd.grad(out, (qt, kt, vt), dot,
                                              retain_graph=True))
    both = time_ms(lambda: torch.autograd.grad(
        F.scaled_dot_product_attention(qt, kt, vt, **kw), (qt, kt, vt), dot))
    log(f"  library (scaled_dot_product_attention"
        f"{'' if mask is None else ' with the boolean mask'}, yardstick): "
        f"fwd {fwd:.4f} ms, bwd {bwd:.4f} ms, fwd+bwd {both:.4f} ms")
    return fwd, bwd


def sdpa_state_ms(q, k, v, causal=False):
    """PyTorch's fused attention forward that also returns the lse
    (``_scaled_dot_product_flash_attention``, causal or not) on the same
    [B, H, T, D] views: one call that computes a K/V block's state in
    normalized form ((O, lse) rather than (acc, m, l)), a yardstick the
    port never calls. Logs how far its O and lse are from the plain
    state's acc / l and m + log l. Returns its ms."""
    import torch

    from horovod_tpu_torch.ops import flash_attention as fa

    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))

    def call():
        return torch.ops.aten._scaled_dot_product_flash_attention(
            qt, kt, vt, 0.0, causal)[:2]

    ms = time_ms(call)
    o, lse = call()
    acc, m, l = fa.flash_fwd_state_plain(q, k, v, causal=causal)
    log(f"  library (_scaled_dot_product_flash_attention"
        f"{', causal' if causal else ''}, (O, lse), "
        f"yardstick): {ms:.4f} ms; against the plain state: O rel_err "
        f"{rel_err(o.transpose(1, 2), acc / l.transpose(1, 2)[..., None]):.3e}"
        f", lse rel_err {rel_err(lse, m + torch.log(l)):.3e}")
    return ms


def kernel_case(label, B, T, H, D, dtype, causal, window=None, Tk=None,
                q_off=0, k_off=0, fused=False, timing=False, segments=0,
                packed_over=0, faults=False, timed=None):
    """Every kernel mode against its plain version on one shape; with
    ``fused`` q/k/v are views of one [B, T, 3, H, D] tensor, as the
    model's qkv projection gives them; with ``segments`` that many
    packed segments per row (random lengths, or with ``packed_over`` the
    long-context example's even packing of a sequence of that length,
    sliced at the offsets), and the plain versions without them as a
    fault the comparison must refuse; with ``faults`` the planted
    last-tile faults; with ``timing`` the time of
    every mode in ``timed`` (default all). Returns {kernel: row} for the
    table."""
    import torch

    Tk = Tk or T
    log(f"case {label}: B={B} Tq={T} Tk={Tk} H={H} D={D} {dtype} "
        f"causal={causal} window={window} q_off={q_off} k_off={k_off} "
        f"segments={segments} q/k/v "
        f"{'views of one [B,T,3,H,D]' if fused else 'contiguous'}")
    g = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape):
        return torch.randn((B, *shape, H, D), generator=g, device="cuda",
                           dtype=torch.float32).to(dtype)

    if fused:
        assert Tk == T
        q, k, v = randn(T, 3).unbind(2)
    else:
        q, k, v = randn(T), randn(Tk), randn(Tk)
    do = randn(T)
    kw = dict(causal=causal, q_off=q_off, k_off=k_off, window=window)
    if segments:
        n = max(q_off + T, k_off + Tk)
        if packed_over:
            from horovod_tpu_torch.examples.long_context import (
                packed_segment_ids)

            ids = torch.as_tensor(packed_segment_ids(packed_over, segments)[
                :n], dtype=torch.int32).expand(B, n).cuda()
        else:
            ids = segment_ids(B, n, segments,
                              torch.Generator().manual_seed(0)).cuda()
        kw.update(q_seg=ids[:, q_off:q_off + T].contiguous(),
                  k_seg=ids[:, k_off:k_off + Tk].contiguous())
    from horovod_tpu_torch.ops import flash_attention as fa

    o_ref, lse_ref = fa.flash_fwd_plain(q, k, v, with_lse=True, **kw)
    delta = (do.float() * o_ref.float()).sum(-1).transpose(1, 2).contiguous()
    args = (q, k, v, do, lse_ref, delta)
    errs, refs = check_modes(label, modes(*args, kw), dtype,
                             (*args, kw) if dtype == torch.bfloat16 else None)
    if segments:
        blind = dict(kw, q_seg=None, k_seg=None)
        refuse({f"{m} {o}": t for m, (_, plain) in modes(*args, blind).items()
                for o, t in zip(OUTPUTS[m], plain())}, refs, dtype,
               "segment ids ignored")
    if faults:
        refuse(dropped_tile_faults(*args, kw, OUTPUTS), refs, dtype,
               "last tile dropped")
    if not timing:
        return {}
    library, ids_bytes, fwd = {}, 0, None
    if segments:
        # Pairs visible inside the segments only (the ids' own mask), and
        # the library on the same boolean mask.
        allowed = fa._allowed(q, k, **kw).expand(B, 1, T, Tk)
        pairs = H * int(allowed.sum())
        ids_bytes = kw["q_seg"].nbytes + kw["k_seg"].nbytes
        log(f"  pairs visible inside the segments: {pairs} of "
            f"{B * H * visible_pairs(T, Tk, causal, q_off, k_off, window)} "
            f"causal")
        if window is None:
            fwd, bwd = sdpa_times(q, k, v, do, causal, mask=allowed)
    else:
        pairs = B * H * visible_pairs(T, Tk, causal, q_off, k_off, window)
        if window is None and q_off == k_off:
            fwd, bwd = sdpa_times(q, k, v, do, causal)
    if fwd is not None:
        library = {"flash_fwd": fwd, "flash_fwd_train": fwd,
                   "flash_bwd_dq": bwd, "flash_bwd_dkv": bwd,
                   "flash_bwd_dq_f32": bwd, "flash_bwd_dkv_f32": bwd}
    return time_rows(modes(*args, kw, timed or OUTPUTS), (B, T, Tk, H, D),
                     dtype, pairs, library, errs, ids_bytes)


def ring_inputs():
    """The ring's blocks at the sp trainer's block shape (B=8, Tq=Tk=2048,
    H=12, D=64, bf16, causal), q/k/v views of one qkv tensor per block.
    Rank 1 of an sp=2 ring holds q block 1 and meets k/v block 1
    (diagonal) and block 0 (past); rank 0 meets block 1 as a future
    block. Returns (q, {block: (k, v, q_off, k_off)}, dO, lse, delta)
    with rank 1's GLOBAL lse and delta (its two blocks merged, plain), as
    the ring's backward passes them."""
    import torch

    from horovod_tpu_torch.ops import flash_attention as fa

    B, T, H, D, dt = 8, 2048, 12, 64, torch.bfloat16
    g = torch.Generator(device="cuda").manual_seed(1)

    def randn(*shape):
        return torch.randn(shape, generator=g, device="cuda").to(dt)

    _, k0, v0 = randn(B, T, 3, H, D).unbind(2)
    q, k1, v1 = randn(B, T, 3, H, D).unbind(2)
    do = randn(B, T, H, D)
    blocks = {"past": (k0, v0, T, 0), "diagonal": (k1, v1, T, T),
              "future": (k1, v1, 0, T)}
    states = [fa.flash_fwd_state_plain(q, k, v, True, qo, ko)
              for k, v, qo, ko in (blocks["past"], blocks["diagonal"])]
    m = torch.maximum(states[0][1], states[1][1])
    c = [torch.exp(s[1] - m) for s in states]
    l = c[0] * states[0][2] + c[1] * states[1][2]
    acc = sum(s[0] * ci.transpose(1, 2)[..., None] for s, ci in zip(states, c))
    o = acc / l.transpose(1, 2)[..., None]
    lse = (m + torch.log(l)).contiguous()
    delta = (do.float() * o).sum(-1).transpose(1, 2).contiguous()
    return q, blocks, do, lse, delta


def ring_case():
    """The ring's block kernels on ``ring_inputs()``: the state mode, the
    fp32 dQ and the fp32 dK/dV in the past, diagonal and future blocks;
    the backward with the global lse and delta. In the future block every
    tile is culled, and the state must be exactly empty and dQ, dK and dV
    exactly 0. Returns the state and fp32 rows (timed at the past block,
    where every pair is visible; the library is timed at the past and
    diagonal blocks)."""
    import torch

    from horovod_tpu_torch.ops import flash_attention as fa

    q, blocks, do, lse, delta = ring_inputs()
    (B, T, H, D), dt = q.shape, q.dtype
    table = {}
    for name, (k, v, q_off, k_off) in blocks.items():
        kw = dict(causal=True, q_off=q_off, k_off=k_off, window=None)
        # The ring's backward launches dK/dV on every block, the future
        # one too (rank 0's second step at sp=2).
        names = ["flash_fwd_state", "flash_bwd_dq_f32", "flash_bwd_dkv_f32"]
        log(f"case ring-{name}: B={B} Tq=Tk={T} H={H} D={D} {dt} causal "
            f"q_off={q_off} k_off={k_off}, q/k/v views of one [B,T,3,H,D], "
            f"global lse/delta")
        args = (q, k, v, do, lse, delta)
        calls = modes(*args, kw, names)
        errs, refs = check_modes(f"ring-{name}", calls, dt, (*args, kw))
        if name == "future":
            acc_k, m_k, l_k = calls["flash_fwd_state"][0]()
            if not (torch.all(acc_k == 0) and torch.all(l_k == 0)
                    and torch.all(m_k == fa.NEG_INF)):
                raise AssertionError("future block: state is not the empty "
                                     "state (acc 0, m -1e30, l 0)")
            (dq_k,) = calls["flash_bwd_dq_f32"][0]()
            dk_k, dv_k = calls["flash_bwd_dkv_f32"][0]()
            if not (torch.all(dq_k == 0) and torch.all(dk_k == 0)
                    and torch.all(dv_k == 0)):
                raise AssertionError("future block: fp32 dQ, dK or dV is "
                                     "not exactly 0")
            log("  future block: state empty and fp32 dQ, dK and dV exactly "
                "0; no library call computes a block with no visible pair")
        if name == "past":
            refuse(dropped_tile_faults(*args, kw, names), refs, dt,
                   "last tile dropped")
        library = {}
        if name != "future":
            # Same work, block-local normalization: the fused attention
            # over this block (non-causal in the past block, causal in the
            # diagonal one), whose (O, lse) is the block's state normalized
            # (acc = O * l, m + log l = lse).
            causal_block = name == "diagonal"
            _, bwd = sdpa_times(q, k, v, do, causal=causal_block)
            library = {"flash_fwd_state": sdpa_state_ms(q, k, v,
                                                        causal_block),
                       "flash_bwd_dq_f32": bwd, "flash_bwd_dkv_f32": bwd}
        pairs = B * H * visible_pairs(T, T, True, q_off, k_off)
        rows = time_rows(calls, (B, T, T, H, D), dt, pairs, library, errs)
        if name == "past":
            table = rows
    return table


TRANSFORMER_GROUPS = {"flash attention (port)": ("flash_",),
                      "matmul (cuBLAS)": ("gemm", "Gemm", "nvjet", "cutlass",
                                          "xmma"),
                      "nccl": ("nccl",)}
# Kernel-name keys of the image models' groups, first match wins: cuDNN's
# batch-norm kernels before the convolutions ("cudnn" names both), the
# convolutions' implicit GEMMs before cuBLAS's ("xmma" names both).
IMAGE_GROUPS = {"batch norm": ("batch_norm", "bn_fw", "bn_bw", "BatchNorm",
                               "welford"),
                "conv (cuDNN)": ("fprop", "dgrad", "wgrad", "conv", "Conv",
                                 "implicit", "cudnn", "winograd"),
                "layout (NCHW<->NHWC)": ("nchwToNhwc", "nhwcToNchw"),
                "matmul (cuBLAS)": TRANSFORMER_GROUPS["matmul (cuBLAS)"],
                "optimizer (foreach)": ("multi_tensor_apply",),
                "pooling": ("pool",),
                "nccl": ("nccl",)}


def profile_steps(step, n=2, groups=TRANSFORMER_GROUPS, host_top=0):
    """Device time by kernel over ``n`` training steps (torch.profiler),
    grouped by kernel name (``groups``: {group: name keys}; the rest is
    "elementwise and other"), with the device's busy share of the
    profiled wall time; with ``host_top``, that many host-side ops by
    their own CPU time (the profiler's overhead included)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            step()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0) / n
    kernels, host = [], []
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CPU:
            host.append((e.self_cpu_time_total / 1e3 / n, e.count // n, e.key))
        # Annotation ranges (e.g. "Optimizer.step#AdamW.step") span other
        # kernels on the device timeline; counting them would count twice.
        if e.device_type != torch.autograd.DeviceType.CUDA or \
                getattr(e, "is_user_annotation", False) or \
                e.key.startswith(("Optimizer.", "ProfilerStep#")):
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        kernels.append((us / 1e3 / n, e.count // n, e.key))
    kernels.sort(reverse=True)
    other = "elementwise and other"
    by_group = {g: 0.0 for g in (*groups, other)}
    for ms, _, name in kernels:
        g = next((g for g, keys in groups.items()
                  if any(k in name for k in keys)), other)
        by_group[g] += ms
    busy = sum(ms for ms, _, _ in kernels)
    if busy == 0:
        log("    profile: torch.profiler recorded no device time")
        return
    log(f"    profile ({n} steps, torch.profiler): wall {wall_ms:.2f} ms/step "
        f"with the profiler on, device busy {busy:.2f} ms/step "
        f"({100 * busy / wall_ms:.1f}%)")
    for g, ms in by_group.items():
        log(f"      {g:<24} {ms:8.3f} ms/step ({100 * ms / busy:.1f}% of "
            f"device time)")
    for ms, count, name in kernels[:16]:
        log(f"      {ms:8.3f} ms/step  x{count:<4} {name[:90]}")
    if host_top:
        host.sort(reverse=True)
        log(f"    host ops by own CPU time (all ops: "
            f"{sum(ms for ms, _, _ in host):.2f} ms/step, "
            f"{sum(c for _, c, _ in host)} calls/step):")
        for ms, count, name in host[:host_top]:
            log(f"      {ms:8.3f} ms/step  x{count:<5} {name[:80]}")


def small_model_check():
    """A small transformer's loss and gradients through the kernels (GPU,
    fp32) against the same weights through the plain versions (CPU)."""
    import torch

    from horovod_tpu_torch.models.transformer import (Transformer,
                                                      TransformerConfig)
    from horovod_tpu_torch.training import cross_entropy_loss

    cfg = TransformerConfig(vocab=512, d_model=256, n_heads=4, d_head=64,
                            d_ff=1024, n_layers=2, max_seq=128)
    cpu = Transformer(cfg, device="cpu", seed=0)
    gpu = Transformer(cfg, device="cuda", seed=1)
    gpu.load_state_dict(cpu.state_dict())
    g = torch.Generator().manual_seed(0)
    tokens = torch.randint(0, cfg.vocab, (2, 128), generator=g)
    labels = torch.roll(tokens, -1, 1)
    losses = {}
    for name, model in (("cpu", cpu), ("gpu", gpu)):
        dev = next(model.parameters()).device
        loss = cross_entropy_loss(model(tokens.to(dev)), labels.to(dev))
        loss.backward()
        losses[name] = loss.item()
    worst = 0.0
    for (name, pc), (_, pg) in zip(cpu.named_parameters(),
                                   gpu.named_parameters()):
        err = (pg.grad.cpu() - pc.grad).abs().max().item()
        worst = max(worst, err / max(1e-6, pc.grad.abs().max().item()))
    rel = abs(losses["gpu"] - losses["cpu"]) / abs(losses["cpu"])
    log(f"small model (fp32, 2 layers, D=64): loss gpu {losses['gpu']:.6f} "
        f"cpu {losses['cpu']:.6f} (rel {rel:.2e}); worst grad err / max "
        f"|grad| {worst:.2e} (tolerance 1e-4)")
    if not (rel <= 1e-4 and worst <= 1e-4):
        raise AssertionError("small model through the kernels disagrees "
                             "with the CPU plain path")


SP = 2                # ranks of the sp phase, both on cuda:0
SP_STEPS = (1, 1)     # (e)'s sp trainer: warm-up and timed steps
SP_TIMEOUT_S = 600


def small_sp_reference():
    """The small packed model's loss and gradients at sp=1 on the CPU (the
    plain path), before the sp world exists. Returns (cfg kwargs, state,
    tokens, labels, segment ids, loss, {name: grad})."""
    import torch

    from horovod_tpu_torch.models.transformer import (Transformer,
                                                      TransformerConfig)
    from horovod_tpu_torch.training import cross_entropy_loss

    kw = dict(vocab=512, d_model=256, n_heads=4, d_head=64, d_ff=1024,
              n_layers=2, max_seq=256)
    cpu = Transformer(TransformerConfig(**kw), device="cpu", seed=0)
    g = torch.Generator().manual_seed(0)
    tokens = torch.randint(0, kw["vocab"], (2, 256), generator=g)
    labels = torch.roll(tokens, -1, 1)
    seg = segment_ids(2, 256, 4, g)
    loss = cross_entropy_loss(cpu(tokens, seg), labels)
    loss.backward()
    grads = {n: p.grad for n, p in cpu.named_parameters()}
    return kw, cpu.state_dict(), tokens, labels, seg, loss.item(), grads


def small_sp_check(strategy, ref):
    """The small model at sp=2 under ``strategy`` through the kernels
    (fp32), each rank on its half of T: the world-averaged loss and
    gradients against the sp=1 CPU reference, rel 1e-4 as in (c)."""
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models.transformer import (Transformer,
                                                      TransformerConfig)
    from horovod_tpu_torch.ops import collectives
    from horovod_tpu_torch.training import cross_entropy_loss

    kw, state, tokens, labels, seg, ref_loss, ref_grads = ref
    model = Transformer(TransformerConfig(sp_strategy=strategy, **kw),
                        device=hvd.device(), seed=1)
    model.load_state_dict(state)
    t = tokens.shape[1] // hvd.sp_size()
    cols = slice(hvd.sp_rank() * t, (hvd.sp_rank() + 1) * t)
    dev = hvd.device()
    loss = cross_entropy_loss(model(tokens[:, cols].to(dev),
                                    seg[:, cols].to(dev)),
                              labels[:, cols].to(dev))
    loss.backward()
    loss = collectives.allreduce(loss.detach()).item()
    worst = 0.0
    for name, p in model.named_parameters():
        grad = collectives.allreduce(p.grad).cpu()
        want = ref_grads[name]
        worst = max(worst, (grad - want).abs().max().item()
                    / max(1e-6, want.abs().max().item()))
    rel = abs(loss - ref_loss) / abs(ref_loss)
    log(f"small model sp={hvd.sp_size()} {strategy} (fp32, 2 layers, D=64, "
        f"T=256, 4 segments per row): loss {loss:.6f} vs sp=1 cpu "
        f"{ref_loss:.6f} (rel {rel:.2e}); worst grad err / max |grad| "
        f"{worst:.2e} (tolerance 1e-4)")
    if not (rel <= 1e-4 and worst <= 1e-4):
        raise AssertionError(f"small model at sp={hvd.sp_size()} "
                             f"({strategy}) disagrees with sp=1 on the CPU")
    return {"loss": loss, "rel": rel, "worst_grad": worst}


def sp_worker(out_path):
    """One rank of the sp phase (run as ``chip_smoke.py --sp-worker``):
    the small sp checks, then the full-width sp trainer; writes what it
    saw to ``out_path`` as JSON."""
    import torch

    sys.path.insert(0, str(REPO))
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import transformer_bench
    from horovod_tpu_torch.ops import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ref = small_sp_reference()
    hvd.init(device="cuda:0", sp=SP)
    out = {"rank": hvd.rank(), "small": {
        s: small_sp_check(s, ref) for s in ("ring", "ulysses")}}
    args = transformer_bench.parse_args([
        "--sp", str(SP), "--seq-len", "4096", "--num-warmup",
        str(SP_STEPS[0]), "--num-iters", str(SP_STEPS[1]), "--device",
        "cuda:0"])
    fa.reset_launches()
    run = transformer_bench.run(args)
    launches = dict(fa.LAUNCHES)
    profile_steps(run.step, n=1)
    out.update(launches=launches, losses=run.losses,
               allreduces=run.allreduce_count, result=run.result,
               peak_gib=run.peak_mem_bytes / 2**30,
               tokens=list(run.tokens.shape), layers=args.n_layers,
               steps=args.num_warmup + args.num_iters)
    hvd.shutdown()
    Path(out_path).write_text(json.dumps(out))
    return 0


def run_workers(flag, n, timeout_s, inputs=None, local_size=None,
                env=None):
    """``n`` processes of this script (``flag``: ``--sp-worker``,
    ``--dp-worker``, ``--mp-worker``, ``--zero-worker``,
    ``--eager-worker``, ``--host-worker`` or ``--planes-worker``), ranks
    of one NCCL world on cuda:0, each with its own ``NCCL_HOSTID`` and
    sockets over ``lo``; ``local_size`` ranks to a host (default all,
    cross-major), ``env`` added to their environment. ``inputs`` (any
    object) is saved beside their results as ``inputs.pt``. Their logs are
    printed and each rank's JSON result returned. Any worker that fails or
    outlives ``timeout_s`` fails the phase."""
    procs, tmp = spawn_workers(flag, n, inputs, local_size, env)
    return finish_workers(flag, procs, tmp, timeout_s)


def spawn_workers(flag, n, inputs=None, local_size=None, env=None,
                  script=None):
    """Start ``run_workers``'s processes without waiting for them (of
    ``script``, default this file); returns (the processes, their
    directory)."""
    import torch

    from horovod_tpu_torch.common.config import free_port_pair

    torch.cuda.empty_cache()   # leave the card to the workers
    port = free_port_pair()
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_workers_"))
    if inputs is not None:
        torch.save(inputs, tmp / "inputs.pt")
    procs = []
    local_size = local_size or n
    for r in range(n):
        renv = dict(os.environ, **(env or {}), HOROVOD_RANK=str(r),
                    HOROVOD_SIZE=str(n),
                    HOROVOD_LOCAL_RANK=str(r % local_size),
                    HOROVOD_LOCAL_SIZE=str(local_size),
                    HOROVOD_CONTROLLER_ADDR="127.0.0.1",
                    HOROVOD_CONTROLLER_PORT=str(port),
                    NCCL_HOSTID=f"chip-smoke-rank{r}",
                    NCCL_IB_DISABLE="1", NCCL_SOCKET_IFNAME="lo")
        with open(tmp / f"log{r}.txt", "w") as logf:
            procs.append(subprocess.Popen(
                [sys.executable, str(script or Path(__file__).resolve()),
                 flag, str(tmp / f"rank{r}.json")], env=renv,
                stdout=logf, stderr=subprocess.STDOUT))
    return procs, tmp


def finish_workers(flag, procs, tmp, timeout_s, codes=None):
    """Wait for ``spawn_workers``'s processes (killing those that outlive
    ``timeout_s``), print their logs and return each rank's JSON result
    (None for a rank without one). The exit codes must be ``codes``
    (default every one 0)."""
    t0 = time.perf_counter()
    try:
        for p in procs:
            p.wait(timeout=max(1.0, timeout_s - (time.perf_counter() - t0)))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, p in enumerate(procs):
        for line in (tmp / f"log{r}.txt").read_text().splitlines():
            log(f"    [rank {r}] {line}")
    got = [p.returncode for p in procs]
    if got != (codes or [0] * len(procs)):
        raise AssertionError(f"{flag} processes exited {got}")
    res = [json.loads((tmp / f"rank{r}.json").read_text())
           if (tmp / f"rank{r}.json").exists() else None
           for r in range(len(procs))]
    shutil.rmtree(tmp, ignore_errors=True)
    return res


def sp_phase(gpu):
    """(e): two ranks on cuda:0 in one NCCL world. Returns rank 0's
    launch counts of the sp trainer's run."""
    res = run_workers("--sp-worker", SP, SP_TIMEOUT_S)
    layers, steps = res[0]["layers"], res[0]["steps"]
    for r in res:
        losses = r["losses"]
        log(f"    rank {r['rank']}: losses {[round(x, 4) for x in losses]}")
        log(f"    rank {r['rank']}: step {r['result']['step_ms']} ms, peak "
            f"memory {r['peak_gib']:.2f} GiB, tokens shard {r['tokens']} "
            f"(two ranks sharing one card: a correctness run, not a "
            f"throughput figure) on {gpu}")
        log(f"    rank {r['rank']}: launches {r['launches']}, bucket "
            f"all-reduces {r['allreduces']}")
        if not all(math.isfinite(x) for x in losses):
            raise AssertionError("sp trainer: non-finite loss")
        if not losses[-1] < losses[0]:
            raise AssertionError("sp trainer: loss did not fall")
        if r["result"]["mesh"] != {"dp": 1, "pp": 1, "sp": SP, "tp": 1}:
            raise AssertionError(f"sp trainer: mesh {r['result']['mesh']}")
        want = {"flash_fwd_state": layers * steps * SP,
                "flash_bwd_dq_f32": layers * steps * SP,
                "flash_bwd_dkv_f32": layers * steps * SP,
                "flash_fwd_train": 0}
        got = {k: r["launches"][k] for k in want}
        if got != want:
            raise AssertionError(f"sp trainer launches {got}, expected {want}")
        if not r["allreduces"] >= 1:
            raise AssertionError("sp trainer: no bucket all-reduce ran")
    if res[0]["losses"] != res[1]["losses"]:
        raise AssertionError("sp trainer: the ranks' losses differ")
    log(f"    bench line {json.dumps(res[0]['result'])}")
    return res[0]["launches"]


# ---- (f) images --------------------------------------------------------------

IMAGE_TOL = 1e-4     # fp32 through cuDNN (TF32 off) against the CPU
# The s2d stem computes the 7x7 stem's function; in bf16 the two round the
# stem's products differently, which moves the step-0 loss (~6.9) by far
# less than a hundredth.
S2D_LOSS_TOL = 1e-2
DP = 2               # ranks of the image dp phase, both on cuda:0
DP_STEPS = (1, 2)    # its ResNet-50 runs: warm-up and timed steps
DP_TIMEOUT_S = 420
# (model, extra flags, timed steps) of the full-width runs, 2 warm-up each.
IMAGE_RUNS = (("resnet50", (), 10), ("resnet50", ("--space-to-depth",), 10),
              ("vgg16", (), 3), ("inception3", (), 3))


def small_image_problem():
    """The small image model on the CPU (fp32 ResNet18, num_filters 8, 10
    classes, seed 0) with its batch norms' scales, offsets and running
    statistics moved off their init values, so that every gradient and
    statistic shows (a block's last scale, zero at init, to 0.1 +- 0.02);
    and 4 standard-normal 64 px NHWC images with their labels."""
    import torch

    from horovod_tpu_torch.models import image_layers, resnet

    model = resnet.ResNet18(num_classes=10, num_filters=8,
                            dtype=torch.float32, device="cpu", seed=0)
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, image_layers.BatchNorm):
                gain = 0.1 if m.scale_init == 0 else 1.0
                n = m.weight.shape
                m.weight.copy_(gain * (1 + 0.2 * torch.randn(n, generator=g)))
                m.bias.copy_(0.1 * torch.randn(n, generator=g))
                m.running_mean.copy_(0.1 * torch.randn(n, generator=g))
                m.running_var.uniform_(0.5, 1.5, generator=g)
    images = torch.randn((4, 64, 64, 3), generator=g)
    labels = torch.randint(0, 10, (4,), generator=g)
    return model, images, labels


def image_grads(model, images, labels):
    """One training-mode forward and backward: (loss, {name: gradient},
    {name: updated running statistic}), the tensors copied to the CPU."""
    from horovod_tpu_torch.training import cross_entropy_loss

    model.train()
    model.zero_grad(set_to_none=True)
    dev = next(model.parameters()).device
    loss = cross_entropy_loss(model(images.to(dev)), labels.to(dev))
    loss.backward()
    return (loss.item(),
            {n: p.grad.to("cpu", copy=True)
             for n, p in model.named_parameters()},
            {n: b.to("cpu", copy=True) for n, b in model.named_buffers()})


def worst_rel(got, want):
    """max over tensors of max |got - want| / max |want|."""
    return max((got[n] - w).abs().max().item()
               / max(1e-6, w.abs().max().item()) for n, w in want.items())


def check_image_agreement(what, loss, grads, stats, ref):
    """Loss, gradients and statistics against ``ref`` = (loss, grads,
    stats) at IMAGE_TOL; logs and raises on a miss."""
    rel = abs(loss - ref[0]) / abs(ref[0])
    g, s = worst_rel(grads, ref[1]), worst_rel(stats, ref[2])
    log(f"    {what}: loss {loss:.6f} vs cpu {ref[0]:.6f} (rel {rel:.2e}); "
        f"worst grad err / max |grad| {g:.2e}, worst running-statistic err "
        f"/ max |statistic| {s:.2e} (tolerance {IMAGE_TOL:g})")
    if not max(rel, g, s) <= IMAGE_TOL:
        raise AssertionError(f"{what} disagrees with the CPU")
    return {"rel": rel, "worst_grad": g, "worst_stat": s}


def small_image_check():
    """(f) first: the small ResNet18 through cuDNN on the card against the
    same weights on the CPU."""
    import torch

    from horovod_tpu_torch.models import resnet

    cpu, images, labels = small_image_problem()
    gpu = resnet.ResNet18(num_classes=10, num_filters=8,
                          dtype=torch.float32, device="cuda", seed=1)
    gpu.load_state_dict(cpu.state_dict())
    if not gpu.conv_init.weight.is_contiguous(
            memory_format=torch.channels_last):
        raise AssertionError("conv weights on the card are not channels_last")
    ref = image_grads(cpu, images, labels)
    check_image_agreement("small ResNet18 (fp32, num_filters 8, 64 px, "
                          "batch 4) on the card", *image_grads(
                              gpu, images, labels), ref)


def run_image_bench(model, flags, iters, device=None, warmup=2):
    """``image_bench.run`` of ``model`` at its full width with ``warmup``
    and ``iters`` timed steps; returns the run."""
    from horovod_tpu_torch import image_bench

    argv = ["--model", model, "--num-warmup", str(warmup), "--num-iters",
            str(iters), *flags]
    if device is not None:
        argv += ["--device", device]
    return image_bench.run(image_bench.parse_args(argv))


def image_phase(gpu):
    """(f): the small model's agreement, the full-width image runs on one
    card with their profiles, then dp=2 on cuda:0. Returns ResNet-50's
    images/s."""
    import torch

    import horovod_tpu_torch as hvd

    small_image_check()
    first_loss, rate = {}, {}
    for model, flags, iters in IMAGE_RUNS:
        label = " ".join((model, *flags))
        log(f"  {label}: 2 warm-up + {iters} timed steps")
        run = run_image_bench(model, flags, iters)
        res, losses = run.result, run.losses
        log(f"    losses {[round(x, 4) for x in losses]}")
        log(f"    {res['value']} images/s, step {res['step_ms']} ms, MFU "
            f"{res.get('mfu')}, peak memory "
            f"{res['peak_mem_bytes'] / 2**30:.2f} GiB, bucket all-reduces "
            f"{run.allreduce_count} on {gpu}")
        profile_steps(run.step, groups=IMAGE_GROUPS, host_top=10)
        log(f"    bench line {json.dumps(res)}")
        if not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"{label}: non-finite loss")
        if model == "resnet50" and not losses[-1] < losses[0]:
            raise AssertionError(f"{label}: loss did not fall")
        if not run.allreduce_count >= 1:
            raise AssertionError(f"{label}: no bucket all-reduce ran")
        first_loss[label] = losses[0]
        rate[label] = res["value"]
        del run
        torch.cuda.empty_cache()
    hvd.shutdown()
    plain, s2d = first_loss["resnet50"], first_loss["resnet50 --space-to-depth"]
    rel = abs(s2d - plain) / abs(plain)
    log(f"  space-to-depth stem: step-0 loss {s2d:.6f} vs the 7x7 stem's "
        f"{plain:.6f} (rel {rel:.2e}, tolerance {S2D_LOSS_TOL:g})")
    if not rel <= S2D_LOSS_TOL:
        raise AssertionError("the s2d stem does not give the 7x7 model")

    log(f"  dp={DP}: two ranks on cuda:0, one NCCL world")
    res = run_workers("--dp-worker", DP, DP_TIMEOUT_S)
    for mode in ("fp16", "ef16"):
        for r in res:
            rr = r[mode]
            log(f"    rank {r['rank']} resnet50 --compression {mode}: losses "
                f"{[round(t[0], 4) for t in rr['trace']]}, step "
                f"{rr['result']['step_ms']} ms (two ranks sharing one card: "
                f"a correctness run), bucket all-reduces {rr['allreduces']}, "
                f"wire bytes/step "
                f"{rr['result']['compression']['wire_bytes_per_step']}")
            if rr["result"]["compression"]["mode"] != mode:
                raise AssertionError(f"rank {r['rank']} ran "
                                     f"{rr['result']['compression']}")
            if not all(math.isfinite(t[0]) for t in rr["trace"]):
                raise AssertionError(f"dp {mode}: non-finite loss")
            if not rr["allreduces"] >= 1:
                raise AssertionError(f"dp {mode}: no bucket all-reduce ran")
        traces = [r[mode]["trace"] for r in res]
        if len(traces[0]) != sum(DP_STEPS) or traces[0] != traces[1]:
            raise AssertionError(f"dp {mode}: the ranks' losses, parameters "
                                 f"or batch-norm buffers differ: {traces}")
        log(f"    {mode}: after each of {len(traces[0])} steps both ranks "
            f"hold the same loss, parameters and batch-norm buffers "
            f"(sha256 of each)")
    return rate["resnet50"]


def dp_worker(out_path):
    """One rank of the image dp phase (run as ``chip_smoke.py
    --dp-worker``): the small model on this rank's half batch, its
    world-averaged loss, gradients and statistics against the CPU's mean
    over the two halves; then ResNet-50 at full width, 1 + 2 steps with
    fp16 and then ef16 compression, with a digest of the loss, the
    parameters and the batch-norm buffers after every step."""
    import hashlib

    import torch

    sys.path.insert(0, str(REPO))
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import training
    from horovod_tpu_torch.models import resnet

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cpu, images, labels = small_image_problem()
    # A copy: a training-mode forward updates the live buffers in place.
    state = {n: t.clone() for n, t in cpu.state_dict().items()}
    b = images.shape[0] // DP
    halves = []
    for r in range(DP):
        cpu.load_state_dict(state)
        halves.append(image_grads(cpu, images[r * b:(r + 1) * b],
                                  labels[r * b:(r + 1) * b]))
    ref = (sum(h[0] for h in halves) / DP,
           *({n: sum(h[i][n] for h in halves) / DP for n in halves[0][i]}
             for i in (1, 2)))

    hvd.init(device="cuda:0")
    rank = hvd.rank()
    model = resnet.ResNet18(num_classes=10, num_filters=8,
                            dtype=torch.float32, device="cuda:0", seed=1)
    model.load_state_dict(state)
    opt = training.init_train_state(
        model, torch.optim.SGD(model.parameters(), lr=0.01, momentum=0.9),
        compression="none", bucket_cap_bytes=None)
    rows = slice(rank * b, (rank + 1) * b)
    loss = training.make_train_step(model, opt)(images[rows].cuda(),
                                                labels[rows].cuda()).item()
    # After the step .grad holds the world-averaged gradients it applied.
    out = {"rank": rank, "small": check_image_agreement(
        f"rank {rank}: small ResNet18 at dp={DP}, world-averaged", loss,
        {n: p.grad.cpu() for n, p in model.named_parameters()},
        {n: t.cpu() for n, t in model.named_buffers()}, ref)}
    del model, opt

    def digest(tensors):
        flat = torch.cat([t.detach().reshape(-1).float() for t in tensors])
        return hashlib.sha256(flat.cpu().numpy().tobytes()).hexdigest()

    make_step = training.make_train_step
    for mode in ("fp16", "ef16"):
        trace = []

        def traced(model, opt, trace=trace):
            step = make_step(model, opt)

            def traced_step(inputs, labels):
                loss = step(inputs, labels)
                trace.append([loss.item(), digest(model.parameters()),
                              digest(model.buffers())])
                return loss
            return traced_step

        training.make_train_step = traced
        try:
            run = run_image_bench("resnet50", ("--compression", mode),
                                  DP_STEPS[1], device="cuda:0",
                                  warmup=DP_STEPS[0])
        finally:
            training.make_train_step = make_step
        out[mode] = {"trace": trace, "result": run.result,
                     "allreduces": run.allreduce_count}
        del run
        torch.cuda.empty_cache()
    hvd.shutdown()
    Path(out_path).write_text(json.dumps(out))
    return 0


# ---- (g) tensor, pipeline and expert parallelism ---------------------------

MP = 2                # ranks of the model-parallel phase, both on cuda:0
MP_STEPS = (1, 1)     # its full-width runs: warm-up and timed steps
MP_TIMEOUT_S = 420
SMALL = dict(vocab=512, d_model=256, n_heads=4, d_head=64, d_ff=1024,
             n_layers=2, max_seq=128)
# name -> (model kwargs over SMALL, mesh, microbatches)
SMALL_MESHES = {
    "tp2": ({}, dict(tp=2), 1),
    "pp2": ({}, dict(pp=2), 2),
    "ep2-moe-top2": (dict(use_moe=True, n_experts=4, d_expert=256,
                          moe_top_k=2, capacity_factor=8.0), {}, 1),
    "tp2-gqa-rope": (dict(n_kv_heads=2, rope=True), dict(tp=2), 1),
}
# The flagship decoder of tools/transformer_bench.py:37-47 (bf16).
GPT2 = dict(vocab=50304, d_model=768, n_heads=12, d_head=64, d_ff=3072,
            n_layers=12, max_seq=1024)
GPT2_MOE = dict(GPT2, use_moe=True, n_experts=8, d_expert=3072, moe_top_k=2,
                capacity_factor=2.0)


def loss_drift(losses, ref):
    """The largest step-by-step difference between two runs' losses on
    the same weights and batches, and its tolerance: 1 % of the distance
    ``ref`` fell over those steps (bf16 runs that order their sums
    differently stay well inside; a wrong gradient bends the curve)."""
    n = min(len(losses), len(ref))
    drift = max(abs(a - b) for a, b in zip(losses[:n], ref[:n]))
    return drift, 1e-2 * (ref[0] - ref[n - 1])


def expected_launches(layers, steps, remat=False, microbatches=1):
    """The attention kernels one rank launches in ``steps`` training
    steps of ``layers`` layers (its stage's under pp): the forward's train
    mode once per layer and microbatch (twice under remat: the backward
    recomputes it), each backward kernel once, the plain mode never."""
    n = layers * steps * microbatches
    return {"flash_fwd": 0, "flash_fwd_train": n * (2 if remat else 1),
            "flash_bwd_dq": n, "flash_bwd_dkv": n}


def per_layer(leaves):
    """JAX-layout leaves with the per-layer ones ``[n_stages, L, ...]``
    flattened to ``[n_stages * L, ...]``: the same for every mesh."""
    from horovod_tpu_torch.models.transformer import REPLICATED

    return {k: v if k in REPLICATED else v.reshape(-1, *v.shape[2:])
            for k, v in leaves.items()}


def gather_dense(shards, cfg):
    """The whole model's tensors from every rank's ``(shard_coords(),
    {name: tensor})`` (say, its reduced gradients), per leaf, the layers
    stage-major (``per_layer``): the tp and expert slices put back in
    place, as the dense model holds them."""
    from horovod_tpu_torch.models.transformer import join_shards

    return per_layer(join_shards(
        [(c, {k: v.detach().float().cpu().numpy() for k, v in t.items()})
         for c, t in shards], cfg))


def global_leaves(model, n_stages):
    """A dense model's parameters as the JAX package's global leaves for
    ``n_stages`` pipeline stages (``params_from_jax`` slices any rank's
    share from them)."""
    from horovod_tpu_torch.models.transformer import REPLICATED, join_shards

    leaves = join_shards([(model.shard_coords(), dict(model.state_dict()))],
                         model.cfg)
    return {k: v if k in REPLICATED else
            v.reshape(n_stages, -1, *v.shape[2:]) for k, v in leaves.items()}


def small_mp_problems():
    """The small fp32 models of (g) on the CPU, dense and on one rank:
    for each, its kwargs, mesh, microbatches, global leaves, a batch of 4
    and the loss and per-leaf gradients (``per_layer``) to meet."""
    import torch

    from horovod_tpu_torch.models.transformer import (Transformer,
                                                      TransformerConfig,
                                                      join_shards)
    from horovod_tpu_torch.training import cross_entropy_loss

    out = {}
    for name, (kw, mesh, M) in SMALL_MESHES.items():
        cfg = TransformerConfig(**SMALL, **kw)
        cpu = Transformer(cfg, device="cpu", seed=0)
        g = torch.Generator().manual_seed(1)
        tokens = torch.randint(0, cfg.vocab, (4, 128), generator=g)
        labels = torch.roll(tokens, -1, 1)
        loss = cross_entropy_loss(cpu(tokens), labels)
        loss.backward()
        grads = per_layer(join_shards([(cpu.shard_coords(), {
            n: p.grad.numpy() for n, p in cpu.named_parameters()})], cfg))
        out[name] = dict(kw=dict(SMALL, **kw), mesh=mesh, M=M,
                         leaves=global_leaves(cpu, mesh.get("pp", 1)),
                         tokens=tokens, labels=labels, loss=loss.item(),
                         grads=grads)
    return out


def small_mp_check(name, prob):
    """One small model of (g) on this rank's mesh through the kernels:
    the loss and the gradients gathered from both ranks' shards against
    the CPU's dense model, at (c)'s tolerance."""
    import numpy as np
    import torch
    import torch.distributed as dist

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models.transformer import (Transformer,
                                                      TransformerConfig,
                                                      params_from_jax)
    from horovod_tpu_torch.training import make_train_step

    hvd.init(device="cuda:0", **prob["mesh"])
    cfg = TransformerConfig(**prob["kw"])
    model = Transformer(cfg, device="cuda:0", seed=1,
                        n_microbatches=prob["M"])
    coords = model.shard_coords()
    model.load_state_dict(params_from_jax(prob["leaves"], cfg, **coords))
    opt = hvd.DistributedOptimizer(torch.optim.SGD(model.parameters(), lr=0.0),
                                   named_parameters=model.named_parameters())
    b = prob["tokens"].shape[0] // hvd.dp_size()
    rows = slice(hvd.dp_rank() * b, (hvd.dp_rank() + 1) * b)
    loss = make_train_step(model, opt)(prob["tokens"][rows].cuda(),
                                       prob["labels"][rows].cuda()).item()
    shards = [None] * MP
    dist.all_gather_object(shards, (coords, {
        n: p.grad.cpu() for n, p in model.named_parameters()}))
    hvd.shutdown()
    got = gather_dense(shards, cfg)
    worst = max(float(np.abs(got[k] - want).max()
                      / max(1e-6, np.abs(want).max()))
                for k, want in prob["grads"].items())
    rel = abs(loss - prob["loss"]) / abs(prob["loss"])
    log(f"small {name} (fp32, mesh {prob['mesh'] or {'dp': MP}}, M="
        f"{prob['M']}): loss {loss:.6f} vs cpu {prob['loss']:.6f} (rel "
        f"{rel:.2e}); worst grad err / max |grad| over {len(got)} leaves "
        f"{worst:.2e} (tolerance 1e-4)")
    if set(got) != set(prob["grads"]) or not (rel <= 1e-4 and worst <= 1e-4):
        raise AssertionError(f"small {name} disagrees with the CPU")
    return {"loss": loss, "rel": rel, "worst_grad": worst}


def collectives_check(rank):
    """allgather, reducescatter, alltoall, barrier, and
    hierarchical_allreduce as local=2/cross=1 and local=1/cross=2, each
    once on the card against its value from both ranks' inputs on the
    CPU."""
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.ops import collectives

    xs = [torch.randn(8, 3, generator=torch.Generator().manual_seed(100 + r))
          for r in range(MP)]
    hs = [torch.randn(5, 3, generator=torch.Generator().manual_seed(200 + r))
          for r in range(MP)]
    x = xs[rank].cuda()
    rows = slice(4 * rank, 4 * rank + 4)
    want = {"allgather": torch.cat(xs),
            "reducescatter": (xs[0] + xs[1])[rows],
            "alltoall": torch.cat([xs[0][rows], xs[1][rows]]),
            "barrier": torch.tensor(MP)}
    hvd.init(device="cuda:0")
    got = {"allgather": collectives.allgather(x),
           "reducescatter": collectives.reducescatter(x, op=hvd.Sum),
           "alltoall": collectives.alltoall(x),
           "barrier": collectives.barrier()}
    hvd.shutdown()
    env = {k: os.environ[k] for k in ("HOROVOD_LOCAL_SIZE",
                                      "HOROVOD_LOCAL_RANK")}
    for local in (MP, 1):
        os.environ.update(HOROVOD_LOCAL_SIZE=str(local),
                          HOROVOD_LOCAL_RANK=str(rank % local))
        hvd.init(device="cuda:0")
        key = f"hierarchical local={hvd.local_size()}/cross={hvd.cross_size()}"
        got[key] = hvd.hierarchical_allreduce(hs[rank].cuda())
        want[key] = (hs[0] + hs[1]) / 2
        hvd.shutdown()
    os.environ.update(env)
    errs = {k: float((got[k].cpu().float() - want[k].float()).abs().max())
            for k in want}
    log(f"collectives on the card against the CPU, max abs err: {errs}")
    if max(errs.values()) > 1e-6:
        raise AssertionError(f"a collective disagrees with the CPU: {errs}")
    return errs


def accumulation_check(prob):
    """backward_passes_per_step=2 with ef16 at dp=2: the small dense
    model's two micro-batches of one row each (loss / 2) against k=1 on
    both rows, each rank's reduced gradients and their digest."""
    import hashlib

    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models.transformer import (Transformer,
                                                      TransformerConfig,
                                                      params_from_jax)
    from horovod_tpu_torch.training import cross_entropy_loss

    hvd.init(device="cuda:0")
    cfg = TransformerConfig(**prob["kw"])
    b = prob["tokens"].shape[0] // hvd.dp_size()
    rows = slice(hvd.dp_rank() * b, (hvd.dp_rank() + 1) * b)
    tokens, labels = (t[rows].cuda() for t in (prob["tokens"],
                                                prob["labels"]))
    grads = {}
    for k in (2, 1):
        model = Transformer(cfg, device="cuda:0", seed=1)
        model.load_state_dict(params_from_jax(prob["leaves"], cfg))
        opt = hvd.DistributedOptimizer(
            torch.optim.SGD(model.parameters(), lr=0.0),
            named_parameters=model.named_parameters(), compression="ef16",
            backward_passes_per_step=k)
        n = b // k
        for i in range(k):
            sl = slice(i * n, (i + 1) * n)
            (cross_entropy_loss(model(tokens[sl]), labels[sl]) / k).backward()
        opt.synchronize()
        grads[k] = torch.cat([p.grad.reshape(-1) for p in model.parameters()])
    hvd.shutdown()
    rel = float((grads[2] - grads[1]).norm() / grads[1].norm())
    digest = hashlib.sha256(grads[2].cpu().numpy().tobytes()).hexdigest()
    log(f"k=2 ef16 at dp={MP}: reduced gradients against k=1 on the joined "
        f"rows, normwise rel {rel:.2e} (tolerance 1e-3: one fp16 rounding "
        f"of the wire)")
    if not rel <= 1e-3:
        raise AssertionError("k=2 accumulation disagrees with k=1")
    return {"rel": rel, "digest": digest}


def timed_run(step, warmup=2, iters=3):
    """``step()`` ``warmup + iters`` times: (losses, ms per timed step,
    peak bytes allocated)."""
    import torch

    torch.cuda.reset_peak_memory_stats()
    losses = [step() for _ in range(warmup)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses += [step() for _ in range(iters)]
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0) / iters
    return ([float(x) for x in losses], ms,
            torch.cuda.max_memory_allocated())


def model_run(name, kw, mesh, microbatches, batch):
    """The full-width decoder through the model's API on ``mesh``: AdamW
    3e-4 as the bench, bf16, seed 0, ``MP_STEPS`` steps on this rank's rows
    of a ``batch`` x 1024 batch from RandomState(0)."""
    import numpy as np
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models.transformer import (Transformer,
                                                      TransformerConfig)
    from horovod_tpu_torch.ops import flash_attention as fa
    from horovod_tpu_torch.training import make_train_step

    hvd.init(device="cuda:0", **mesh)
    cfg = TransformerConfig(dtype=torch.bfloat16, **kw)
    model = Transformer(cfg, device="cuda:0", seed=0,
                        n_microbatches=microbatches)
    opt = hvd.DistributedOptimizer(
        torch.optim.AdamW(model.parameters(), lr=3e-4, weight_decay=1e-4),
        named_parameters=model.named_parameters())
    step = make_train_step(model, opt)
    tokens = np.random.RandomState(0).randint(0, cfg.vocab, (batch, 1024))
    b = batch // hvd.dp_size()
    rows = slice(hvd.dp_rank() * b, (hvd.dp_rank() + 1) * b)
    x = torch.as_tensor(tokens[rows], device="cuda:0")
    y = torch.roll(x, -1, 1)
    fa.reset_launches()
    losses, ms, peak = timed_run(lambda: step(x, y), *MP_STEPS)
    out = {"name": name, "mesh": hvd.axis_sizes(), "losses": losses,
           "step_ms": ms, "tokens_per_s": batch * 1024 / (ms / 1e3),
           "peak_gib": peak / 2**30, "launches": dict(fa.LAUNCHES),
           "expected": expected_launches(len(model.layers), sum(MP_STEPS),
                                         microbatches=microbatches),
           "batch": batch, "same_as_slice": kw is GPT2}
    del model, opt, step
    hvd.shutdown()
    torch.cuda.empty_cache()
    return out


def mp_worker(out_path):
    """One rank of (g) (run as ``chip_smoke.py --mp-worker``): the small
    models, the collectives, k=2 accumulation, then the full-width tp=2,
    pp=2 and ep=2 runs; writes what it saw to ``out_path`` as JSON."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(REPO))
    from horovod_tpu_torch import transformer_bench
    from horovod_tpu_torch.ops import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rank = int(os.environ["HOROVOD_RANK"])
    torch.cuda.set_device(0)
    # One NCCL world for every mesh: hvd.init adopts it, hvd.shutdown
    # leaves it up.
    dist.init_process_group(
        "nccl", rank=rank, world_size=MP, init_method=(
            f"tcp://127.0.0.1:{os.environ['HOROVOD_CONTROLLER_PORT']}"))
    problems = torch.load(Path(out_path).parent / "inputs.pt",
                          weights_only=False)
    out = {"rank": rank,
           "small": {n: small_mp_check(n, p) for n, p in problems.items()},
           "collectives": collectives_check(rank),
           "accumulation": accumulation_check(problems["tp2"])}
    runs = []
    fa.reset_launches()
    bench = transformer_bench.run(transformer_bench.parse_args([
        "--tp", str(MP), "--num-warmup", str(MP_STEPS[0]), "--num-iters",
        str(MP_STEPS[1]), "--device", "cuda:0"]))
    res = bench.result
    runs.append({"name": "tp2 (transformer_bench --tp 2)",
                 "mesh": res["mesh"], "losses": bench.losses,
                 "step_ms": res["step_ms"],
                 "tokens_per_s": res["global_batch"] * res["seq_len"]
                 / (res["step_ms"] / 1e3),
                 "peak_gib": bench.peak_mem_bytes / 2**30,
                 "launches": dict(fa.LAUNCHES),
                 "expected": expected_launches(res["n_layers"],
                                               sum(MP_STEPS)),
                 "batch": res["global_batch"], "same_as_slice": True})
    del bench
    import horovod_tpu_torch as hvd
    hvd.shutdown()
    torch.cuda.empty_cache()
    runs.append(model_run("pp2 (2 stages of 6 layers, M=2)", GPT2,
                          dict(pp=MP), 2, 8))
    runs.append(model_run("ep2 MoE (8 experts, 4 a rank, top-2, cf 2.0)",
                          GPT2_MOE, {}, 1, 8))
    out["runs"] = runs
    dist.destroy_process_group()
    Path(out_path).write_text(json.dumps(out))
    return 0


def mp_phase(gpu, slice_losses):
    """(g): two ranks on cuda:0 in one NCCL world, against references
    made here on the CPU first. The full-width runs of the slice's own
    model (tp=2, pp=2: the same weights and batch) are also held to the
    losses of (c)'s size-1 run, ``slice_losses``."""
    res = run_workers("--mp-worker", MP, MP_TIMEOUT_S,
                      inputs=small_mp_problems())
    if res[0]["accumulation"]["digest"] != res[1]["accumulation"]["digest"]:
        raise AssertionError("k=2 accumulation: the ranks' reduced "
                             "gradients differ")
    log(f"    k=2 ef16: both ranks hold the same reduced gradients "
        f"(sha256 {res[0]['accumulation']['digest'][:16]})")
    for i, run in enumerate(res[0]["runs"]):
        other = res[1]["runs"][i]
        for r, rr in enumerate((run, other)):
            log(f"    rank {r} {rr['name']}: mesh {rr['mesh']}, batch "
                f"{rr['batch']} x 1024, losses "
                f"{[round(x, 4) for x in rr['losses']]}, step "
                f"{rr['step_ms']:.2f} ms, {rr['tokens_per_s']:.1f} tokens/s, "
                f"peak {rr['peak_gib']:.2f} GiB (two ranks sharing one card "
                f"over host sockets: a correctness run) on {gpu}")
            log(f"    rank {r} launches {rr['launches']}")
            losses = rr["losses"]
            if not all(math.isfinite(x) for x in losses):
                raise AssertionError(f"{rr['name']}: non-finite loss")
            if not losses[-1] < losses[0]:
                raise AssertionError(f"{rr['name']}: loss did not fall")
            got = {k: rr["launches"][k] for k in rr["expected"]}
            if got != rr["expected"]:
                raise AssertionError(f"{rr['name']} launches {got}, "
                                     f"expected {rr['expected']}")
        if run["losses"] != other["losses"]:
            raise AssertionError(f"{run['name']}: the ranks' losses differ")
        if run["same_as_slice"]:
            drift, tol = loss_drift(run["losses"], slice_losses)
            log(f"    {run['name']}: largest step difference from the "
                f"size-1 run of (c) {drift:.3e} (tolerance {tol:.3e})")
            if not drift <= tol:
                raise AssertionError(f"{run['name']}: losses leave the "
                                     f"size-1 run's")
    return res[0]["runs"]


# ---- (h) ZeRO, checkpoints and Adasum -----------------------------------------

ZERO = 2              # ranks of phase (h), both on cuda:0
ZERO_STEPS = (1, 2)   # its ResNet-50 and decoder runs: warm-up and timed
ZERO_TIMEOUT_S = 480


def tensor_digest(tensors):
    """sha256 of the tensors' values (as fp32, in order)."""
    import hashlib

    import torch

    flat = torch.cat([t.detach().reshape(-1).float() for t in tensors])
    return hashlib.sha256(flat.cpu().numpy().tobytes()).hexdigest()


def zero_image_run(stage, x, y, seed=0, warmup=ZERO_STEPS[0],
                   iters=ZERO_STEPS[1]):
    """ResNet-50 (bf16, 1000 classes) in a ZeRO state of ``stage`` over
    the world, SGD 0.01 with momentum 0.9: ``warmup + iters`` steps, each
    followed by the loss and the digests of the gathered parameters and
    the batch-norm buffers. Returns (state, step, row)."""
    import functools

    import torch

    from horovod_tpu_torch import zero
    from horovod_tpu_torch.models import resnet

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = resnet.ResNet50(num_classes=1000, dtype=torch.bfloat16,
                            device="cuda:0", seed=seed)
    state = zero.init_zero_train_state(
        model, functools.partial(torch.optim.SGD, lr=0.01, momentum=0.9),
        zero_stage=stage, bucket_cap_bytes=None, compression="none")
    step = zero.make_zero_train_step(prefetch=1)
    trace, times = [], []
    for i in range(warmup + iters):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, loss = step(state, x, y)
        torch.cuda.synchronize()
        if i >= warmup:
            times.append(time.perf_counter() - t0)
        trace.append([loss.item(),
                      tensor_digest(zero.gather_params(state).values()),
                      tensor_digest(state.model.buffers())])
    return state, step, {
        "stage": stage, "trace": trace,
        "step_ms": 1e3 * sum(times) / len(times) if times else None,
        "peak_bytes": torch.cuda.max_memory_allocated(),
        "bytes": zero.state_bytes(state), "gathers": step.gathers,
        "n_params": sum(p.numel() for p in state.model.parameters()),
        "n_buffers": sum(b.numel() for b in state.model.buffers())}


def shared_tmp(name):
    """A checkpoint directory both ranks of (h) name alike (by the
    world's rendezvous port)."""
    return os.path.join(tempfile.gettempdir(), f"chip_smoke_ckpt_{name}_"
                        f"{os.environ['HOROVOD_CONTROLLER_PORT']}")


def zero_checkpoint_check(state, step, x, y, make_template):
    """Save ``state``, restore it into ``make_template()`` and step both
    once: (restored bitwise, next losses and digests equal)."""
    import shutil

    import torch

    from horovod_tpu_torch.checkpoint import CheckpointManager

    tmp = shared_tmp("resnet")
    try:
        mgr = CheckpointManager(tmp, max_to_keep=1)
        mgr.save(5, state)
        template, tstep = make_template()
        mgr.restore(template)
        mgr.close()
        torch.distributed.barrier()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    restored = torch.equal(template.pshard, state.pshard)
    state, a = step(state, x, y)
    template, b = tstep(template, x, y)
    from horovod_tpu_torch import zero

    same = (a.item() == b.item() and tensor_digest(
        zero.gather_params(state).values()) == tensor_digest(
        zero.gather_params(template).values()) and tensor_digest(
        state.model.buffers()) == tensor_digest(template.model.buffers()))
    return {"restored_equal": restored, "next_equal": same,
            "next_loss": a.item()}


def zero_worker(out_path):
    """One rank of (h) (run as ``chip_smoke.py --zero-worker``): ResNet-50
    at ZeRO stages 1, 2 and 3 with a checkpoint of the stage-3 state, the
    transformer's ``--zero`` with a checkpoint, and Adasum."""
    import numpy as np
    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(REPO))
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import training, transformer_bench
    from horovod_tpu_torch.checkpoint import CheckpointManager
    from horovod_tpu_torch.models import resnet
    from horovod_tpu_torch.models.transformer import Transformer
    from horovod_tpu_torch.ops import adasum
    from horovod_tpu_torch.ops import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # Stage 1 against stage 2 and a restored state against the original
    # are bitwise claims across runs: deterministic kernels throughout.
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    rank = int(os.environ["HOROVOD_RANK"])
    torch.cuda.set_device(0)
    dist.init_process_group(
        "nccl", rank=rank, world_size=ZERO, init_method=(
            f"tcp://127.0.0.1:{os.environ['HOROVOD_CONTROLLER_PORT']}"))
    hvd.init(device="cuda:0")
    out = {"rank": rank}
    b = 32
    images = np.random.RandomState(0).rand(b * ZERO, 224, 224, 3).astype(
        np.float32)
    labels = np.random.RandomState(1).randint(0, 1000, b * ZERO)
    x = torch.as_tensor(images[rank * b:(rank + 1) * b], device="cuda:0")
    y = torch.as_tensor(labels[rank * b:(rank + 1) * b], device="cuda:0")
    runs = []
    for stage in (1, 2, 3):
        state, step, row = zero_image_run(stage, x, y)
        runs.append(row)
        if stage == 3:
            def template():
                t, s, _ = zero_image_run(3, x, y, seed=1, warmup=0, iters=0)
                return t, s
            out["ckpt_resnet"] = zero_checkpoint_check(state, step, x, y,
                                                       template)
        del state, step
    out["zero_runs"] = runs
    hvd.shutdown()

    # The transformer with its optimizer state over dp, then without.
    torch.cuda.empty_cache()
    fa.reset_launches()
    args = ["--batch-size", "8", "--num-warmup", str(ZERO_STEPS[0]),
            "--num-iters", str(ZERO_STEPS[1]), "--device", "cuda:0"]
    bench = transformer_bench.run(transformer_bench.parse_args(
        ["--zero"] + args))
    out["tf_zero"] = {"losses": bench.losses, "launches": dict(fa.LAUNCHES),
                      "result": bench.result,
                      "peak_gib": bench.peak_mem_bytes / 2**30,
                      "layers": bench.result["n_layers"]}
    tokens = bench.tokens
    labels_tf = torch.roll(tokens, -1, 1)
    cfg = bench.model.cfg
    tmp = shared_tmp("transformer")
    mgr = CheckpointManager(tmp)
    mgr.save(5, {"model": bench.model, "opt": bench.optimizer})
    model = Transformer(cfg, device="cuda:0", seed=7)
    opt = hvd.DistributedOptimizer(
        torch.optim.AdamW(model.parameters(), lr=3e-4, weight_decay=1e-4),
        named_parameters=model.named_parameters(), zero_axis="dp")
    mgr.restore({"model": model, "opt": opt})
    restored = all(torch.equal(a, b_) for a, b_ in zip(
        bench.model.state_dict().values(), model.state_dict().values()))
    a = bench.step().item()
    b2 = training.make_train_step(model, opt)(tokens, labels_tf).item()
    out["ckpt_tf"] = {
        "restored_equal": restored,
        "next_equal": a == b2 and tensor_digest(
            bench.model.parameters()) == tensor_digest(model.parameters()),
        "next_loss": a}
    dist.barrier()
    shutil.rmtree(tmp, ignore_errors=True)
    del bench, model, opt, mgr
    hvd.shutdown()
    torch.cuda.empty_cache()
    plain = transformer_bench.run(transformer_bench.parse_args(
        ["--batch-size", "8", "--num-warmup", "1", "--num-iters", "1",
         "--device", "cuda:0"]))
    out["tf_plain_opt_bytes"] = plain.result["opt_state_bytes"]
    del plain
    hvd.shutdown()
    torch.cuda.empty_cache()

    # Adasum: a small fp32 model's delta step against the NumPy oracle.
    hvd.init(device="cuda:0")
    g = torch.Generator().manual_seed(5)
    w0 = torch.randn(32, 64, generator=g) * 0.1
    xs = torch.randn(ZERO, 16, 64, generator=g)
    ys = torch.randn(ZERO, 16, 32, generator=g)
    model = torch.nn.Linear(64, 32, bias=False).to("cuda:0")
    with torch.no_grad():
        model.weight.copy_(w0)
    opt = hvd.DistributedOptimizer(torch.optim.SGD(model.parameters(),
                                                   lr=0.1),
                                   op=hvd.Adasum, compression="none")
    opt.zero_grad()
    ((model(xs[rank].to("cuda:0")) - ys[rank].to("cuda:0")) ** 2
     ).mean().backward()
    opt.step()
    deltas = []
    for r in range(ZERO):   # each rank's local SGD delta, on the CPU
        w = w0.clone().requires_grad_()
        ((xs[r] @ w.T - ys[r]) ** 2).mean().backward()
        deltas.append((-0.1 * w.grad).numpy())
    want = w0.numpy() + adasum.adasum_reference(deltas)
    got = model.weight.detach().cpu().numpy()
    out["adasum_small"] = {
        "rel": float(np.linalg.norm(got - want) / np.linalg.norm(want)),
        "digest": tensor_digest([model.weight])}
    del model, opt
    # ResNet-50 with op=Adasum, ZERO_STEPS steps.
    model = resnet.ResNet50(num_classes=1000, dtype=torch.bfloat16,
                            device="cuda:0", seed=0)
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.01, momentum=0.9),
        op=hvd.Adasum, compression="none")
    step = training.make_train_step(model, opt)
    trace, times = [], []
    for i in range(sum(ZERO_STEPS)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = step(x, y)
        torch.cuda.synchronize()
        if i >= ZERO_STEPS[0]:
            times.append(time.perf_counter() - t0)
        trace.append([loss.item(), tensor_digest(model.parameters()),
                      tensor_digest(model.buffers())])
    out["adasum_resnet"] = {"trace": trace,
                            "step_ms": 1e3 * sum(times) / len(times)}
    hvd.shutdown()
    dist.destroy_process_group()
    Path(out_path).write_text(json.dumps(out))
    return 0


def zero_phase(gpu, slice_losses):
    """(h): two ranks on cuda:0 in one NCCL world. ``slice_losses``: (c)'s
    size-1 losses of the flagship decoder, which the ``--zero`` run at
    dp=2 on the same global batch must meet. Returns the ``--zero`` run's
    launch counts."""
    res = run_workers("--zero-worker", ZERO, ZERO_TIMEOUT_S)
    r0, r1 = res
    for rr in res:
        for run in rr["zero_runs"]:
            losses = [t[0] for t in run["trace"]]
            log(f"    rank {rr['rank']} ResNet-50 ZeRO stage {run['stage']}: "
                f"losses {[round(v, 4) for v in losses]}, step "
                f"{run['step_ms']:.2f} ms, peak {run['peak_bytes']} bytes, "
                f"state bytes {run['bytes']}, gathers/step {run['gathers']} "
                f"(two ranks sharing one card: a correctness run) on {gpu}")
            if not all(math.isfinite(v) for v in losses):
                raise AssertionError(f"ZeRO stage {run['stage']}: non-finite "
                                     f"loss")
    for i, run in enumerate(r0["zero_runs"]):
        if run["trace"] != r1["zero_runs"][i]["trace"]:
            raise AssertionError(f"ZeRO stage {run['stage']}: the ranks' "
                                 f"losses, parameters or buffers differ")
    s1, s2, s3 = r0["zero_runs"]
    if s1["trace"] != s2["trace"]:
        raise AssertionError("ZeRO stage 1 and stage 2 differ: "
                             f"{s1['trace']} vs {s2['trace']}")
    log(f"    stages 1 and 2: the same losses, parameters and buffers after "
        f"each of {len(s1['trace'])} steps (sha256), on both ranks")
    drift, tol = loss_drift([t[0] for t in s3["trace"]],
                            [t[0] for t in s2["trace"]])
    log(f"    stage 3 against stage 2: largest step difference {drift:.3e} "
        f"(tolerance {tol:.3e})")
    if not drift <= tol:
        raise AssertionError("ZeRO stage 3 leaves stage 2's losses")
    P, B = s1["n_params"], s1["n_buffers"]
    shard = (P + ZERO - 1) // ZERO * 4
    want = {1: 4 * P + 2 * shard + 4 * B, 3: 2 * shard + 4 * B}
    got = {run["stage"]: sum(run["bytes"].values())
           for run in (s1, s3)}
    ratio, want_ratio = got[3] / got[1], want[3] / want[1]
    log(f"    state bytes a rank: stage 1 {got[1]}, stage 2 "
        f"{sum(s2['bytes'].values())}, stage 3 {got[3]}; stage 3 / stage 1 "
        f"{ratio:.5f} (analytic {want_ratio:.5f}, 2/(d+2) = "
        f"{2 / (ZERO + 2):.3f})")
    if got != want:
        raise AssertionError(f"state bytes {got}, analytic {want}")
    if s3["bytes"]["params"] != 0:
        raise AssertionError("stage 3 holds parameter bytes")
    for key in ("ckpt_resnet", "ckpt_tf"):
        for rr in res:
            c = rr[key]
            if not (c["restored_equal"] and c["next_equal"]):
                raise AssertionError(f"{key} on rank {rr['rank']}: {c}")
        log(f"    {key}: restored bitwise and the next step equal to the "
            f"uninterrupted one on both ranks (loss {r0[key]['next_loss']})")
    for rr in res:
        tf = rr["tf_zero"]
        want_l = expected_launches(tf["layers"], sum(ZERO_STEPS))
        got_l = {k: tf["launches"][k] for k in want_l}
        log(f"    rank {rr['rank']} transformer --zero at dp={ZERO}: losses "
            f"{[round(v, 4) for v in tf['losses']]}, step "
            f"{tf['result']['step_ms']} ms, peak {tf['peak_gib']:.2f} GiB, "
            f"optimizer state {tf['result']['opt_state_bytes']} bytes "
            f"against {rr['tf_plain_opt_bytes']} unsharded, launches "
            f"{tf['launches']} on {gpu}")
        if got_l != want_l:
            raise AssertionError(f"--zero launches {got_l}, expected "
                                 f"{want_l}")
        half = tf["result"]["opt_state_bytes"] / rr["tf_plain_opt_bytes"]
        if not 0.45 <= half <= 0.55:
            raise AssertionError(f"--zero optimizer state {half:.3f} of "
                                 f"the unsharded one")
    if r0["tf_zero"]["losses"] != r1["tf_zero"]["losses"]:
        raise AssertionError("--zero: the ranks' losses differ")
    drift, tol = loss_drift(r0["tf_zero"]["losses"], slice_losses)
    log(f"    --zero against the size-1 run of (c): largest step difference "
        f"{drift:.3e} (tolerance {tol:.3e})")
    if not drift <= tol:
        raise AssertionError("--zero leaves the size-1 run's losses")
    for rr in res:
        log(f"    rank {rr['rank']} Adasum delta step of a 64x32 fp32 "
            f"model: normwise rel {rr['adasum_small']['rel']:.2e} against "
            f"adasum_reference on the CPU (tolerance 1e-5)")
        if not rr["adasum_small"]["rel"] <= 1e-5:
            raise AssertionError("Adasum disagrees with adasum_reference")
        ar = rr["adasum_resnet"]
        log(f"    rank {rr['rank']} ResNet-50 op=Adasum: losses "
            f"{[round(t[0], 4) for t in ar['trace']]}, step "
            f"{ar['step_ms']:.2f} ms on {gpu}")
        if not all(math.isfinite(t[0]) for t in ar["trace"]):
            raise AssertionError("Adasum ResNet-50: non-finite loss")
    if r0["adasum_small"]["digest"] != r1["adasum_small"]["digest"] or \
            r0["adasum_resnet"]["trace"] != r1["adasum_resnet"]["trace"]:
        raise AssertionError("Adasum: the ranks differ")
    log("    Adasum: both ranks hold the same parameters and buffers after "
        "every step")
    return r0["tf_zero"]["launches"]


# ---- (i) the negotiated eager plane ----------------------------------------

EAGER = 2             # ranks of phase (i), both on cuda:0
EAGER_TIMEOUT_S = 300
EAGER_STEPS = 3
# ResNet-50 at 1000 classes: its parameters, each one named gradient.
RESNET50_TENSORS, RESNET50_ELEMENTS = 161, 25_557_032


def eager_small_checks(rank):
    """Every op and dtype of the CPU tests (``tests/torch_eager_cases.py``)
    on the card through the named plane, against analytic values at the
    world's size; a refused duplicate name; poll before and after
    completion; join; barrier and broadcast_object. Returns the checks'
    names."""
    import numpy as np
    import torch

    import horovod_tpu_torch as hvd

    dev, n = hvd.device(), hvd.size()
    done = []

    def check(name, got, want):
        got = got.cpu() if isinstance(got, torch.Tensor) else \
            torch.as_tensor(got)
        want = torch.as_tensor(want).to("cpu", got.dtype)
        if got.shape != want.shape or not torch.equal(got, want):
            raise AssertionError(f"(i) {name} on rank {rank}: {got} != "
                                 f"{want}")
        done.append(name)

    base = torch.arange(6)
    total = n * base + n * (n - 1) // 2          # the sum of base + r
    for dt in (torch.float32, torch.float16, torch.bfloat16, torch.float64,
               torch.int32, torch.int64, torch.int16, torch.uint16,
               torch.int8, torch.uint8):
        x = (base + rank).to(dev, dt)
        check(f"allreduce-sum-{dt}", hvd.allreduce(x, op=hvd.Sum,
                                                   name=f"sum.{dt}"), total)
    x = base.float().to(dev) + rank
    check("allreduce-average", hvd.allreduce(x), base.float() + (n - 1) / 2)
    check("allreduce-min", hvd.allreduce(x, op=hvd.Min), base)
    check("allreduce-max", hvd.allreduce(x, op=hvd.Max), base + n - 1)
    check("allreduce-pre-postscale",
          hvd.allreduce(x, op=hvd.Sum, prescale_factor=2.0,
                        postscale_factor=0.25), total / 2)
    # bf16 accumulates in fp32 and rounds once.
    bf = [torch.full((8,), 1 + 2 ** -7, dtype=torch.bfloat16) * (r + 1)
          for r in range(n)]
    check("allreduce-bf16", hvd.allreduce(bf[rank].to(dev), op=hvd.Sum),
          sum(t.float() for t in bf).bfloat16())
    outs = hvd.grouped_allreduce(
        [x, base.reshape(2, 3).float().to(dev) * 2,
         base.int().to(dev) + rank], op=hvd.Sum)
    check("grouped-f32", outs[0], total.float())
    check("grouped-f32-2d", outs[1], (2 * n * base).reshape(2, 3).float())
    check("grouped-int32", outs[2], total.int())
    check("allgather", hvd.allgather(x.reshape(2, 3)),
          torch.cat([(base.float() + r).reshape(2, 3) for r in range(n)]))
    check("allgather-ragged", hvd.allgather(
        torch.full((rank + 1, 3), float(rank), device=dev)),
        torch.cat([torch.full((r + 1, 3), float(r)) for r in range(n)]))
    h = hvd.allgather_async(np.full((2 if rank % 2 else 1,), rank,
                                    np.float32), name="ragged.async")
    check("allgather-ragged-async-numpy", hvd.synchronize(h),
          np.concatenate([np.full((2 if r % 2 else 1,), r, np.float32)
                          for r in range(n)]))
    for root in range(n):
        check(f"broadcast-root{root}", hvd.broadcast(x, root),
              base.float() + root)
    check("broadcast-int64", hvd.broadcast(
        torch.full((3,), 10 ** 12 + rank, dtype=torch.int64, device=dev),
        n - 1), torch.full((3,), 10 ** 12 + n - 1, dtype=torch.int64))
    rs = torch.arange(6.0 * n).reshape(2 * n, 3)
    check("reducescatter", hvd.reducescatter(rs.to(dev) + rank, op=hvd.Sum),
          (n * rs + n * (n - 1) / 2)[2 * rank:2 * rank + 2])
    a2a = torch.arange(float(n)) + 100 * rank
    check("alltoall", hvd.alltoall(a2a.to(dev)),
          torch.tensor([rank + 100.0 * r for r in range(n)]))
    first = hvd.allreduce_async(x, name="dup")
    try:
        hvd.allreduce_async(x, name="dup")
        raise AssertionError("(i) a duplicate name was not refused")
    except hvd.DuplicateTensorNameError:
        done.append("duplicate-name-refused")
    hvd.synchronize(first)
    big = torch.ones(1 << 22, device=dev) * (rank + 1)
    h = hvd.allreduce_async(big, name="poll", op=hvd.Sum)
    before = hvd.poll(h)
    deadline = time.time() + 60
    while not hvd.poll(h):
        if time.time() > deadline:
            raise AssertionError("(i) poll never turned true")
        time.sleep(0.001)
    check("poll-then-synchronize", hvd.synchronize(h)[:4],
          torch.full((4,), n * (n + 1) / 2))
    done.append(f"poll-before-completion={before}")
    # Every rank but 0 leaves after 2 of 5 named allreduces; rank 0's last
    # 3 get their zeros.
    for i in range(5):
        if rank > 0 and i == 2:
            break
        got = hvd.allreduce(torch.full((4,), float(rank + 1), device=dev),
                            op=hvd.Sum, name=f"join.{i}")
        check(f"join-step{i}", got,
              torch.full((4,), n * (n + 1) / 2 if i < 2 else 1.0))
    if rank == 0:
        time.sleep(0.2)
    check("join-last-rank", torch.tensor(hvd.join()), torch.tensor(0))
    hvd.barrier()
    done.append("barrier")
    obj = hvd.broadcast_object({"from": rank, "list": [1, 2.5]}, root_rank=1)
    if obj != {"from": 1, "list": [1, 2.5]}:
        raise AssertionError(f"(i) broadcast_object gave {obj}")
    done.append("broadcast_object")
    return done


def eager_resnet(rank, eng, steps=EAGER_STEPS, after_step=None):
    """ResNet-50 (f)'s workload, each rank its own batch: every gradient
    submitted by name from its post-accumulate hook as it is made, then
    every handle synchronized; each step held to
    ``ops.collectives.grouped_allreduce(op=Sum)`` of the same gradients,
    bitwise (a sum of two is exact in either order). ``after_step()``, when
    given, adds its dict to each step's record."""
    import numpy as np
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import training
    from horovod_tpu_torch.common import metrics
    from horovod_tpu_torch.models import resnet
    from horovod_tpu_torch.ops import collectives

    core = eng.native_core
    dev = hvd.device()
    model = resnet.ResNet50(num_classes=1000, dtype=torch.bfloat16,
                            device=dev, seed=0)
    rng = np.random.RandomState(rank)
    x = torch.as_tensor(rng.rand(32, 224, 224, 3).astype(np.float32),
                        device=dev)
    y = torch.as_tensor(rng.randint(0, 1000, 32), device=dev)
    params = list(model.named_parameters())
    handles, submits = {}, []

    def hook(name):
        def submit(p):
            submits.append(time.perf_counter())
            handles[name] = hvd.allreduce_async(p.grad, name=f"grad.{name}",
                                                op=hvd.Sum)
        return submit

    for name, p in params:
        p.register_post_accumulate_grad_hook(hook(name))
    records = []
    for _ in range(steps):
        model.zero_grad(set_to_none=True)
        handles.clear()
        submits.clear()
        n_resp, hits = len(eng.response_sizes), core.cache_hits()
        loss = training.cross_entropy_loss(model(x), y)
        loss.backward()
        reduced = {n: hvd.synchronize(h) for n, h in handles.items()}
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - submits[0])
        grads = [p.grad for _, p in params]
        want = collectives.grouped_allreduce(grads, op=hvd.Sum)
        equal = all(torch.equal(reduced[n], w)
                    for (n, _), w in zip(params, want))
        diff = max(float((reduced[n] - w).norm() / w.norm().clamp_min(1e-30))
                   for (n, _), w in zip(params, want))
        sizes = [n for _, n in list(eng.response_sizes)[n_resp:]]
        records.append({
            "loss": loss.item(), "tensors": len(handles),
            "elements": sum(g.numel() for g in grads),
            "responses": len(sizes), "tensors_per_response": sizes,
            "cache_hits": core.cache_hits() - hits,
            "submit_span_ms": 1e3 * (submits[-1] - submits[0]),
            "wall_ms": wall_ms, "bitwise_equal": equal, "rel_diff": diff,
            **(after_step() if after_step else {})})
    hist = metrics.snapshot(drain=False)["native"]["histograms"]
    lat = {k: metrics.percentiles(hist[k], (50, 99))
           for k in ("enq_to_neg_allreduce_us", "neg_to_done_allreduce_us")}
    return {"steps": records, "latency_us": lat}


def eager_broadcast_params(rank):
    """Rank 1 starts from another seed; rank 0's ResNet-50 parameters
    reach it by named eager broadcasts (``bcast.param.{i}``)."""
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import resnet

    model = resnet.ResNet50(num_classes=1000, dtype=torch.bfloat16,
                            device=hvd.device(), seed=rank)
    params = list(model.parameters())
    before = tensor_digest(params)
    t0 = time.perf_counter()
    hs = [hvd.broadcast_async(p.data, 0, name=f"bcast.param.{i}")
          for i, p in enumerate(params)]
    with torch.no_grad():
        for p, h in zip(params, hs):
            p.copy_(hvd.synchronize(h))
    torch.cuda.synchronize()
    return {"before": before, "after": tensor_digest(params),
            "ms": 1e3 * (time.perf_counter() - t0)}


def eager_worker(out_path):
    """One rank of (i) (run as ``chip_smoke.py --eager-worker``): the
    named plane's small checks, ResNet-50's gradients through it, and the
    parameters by named broadcasts."""
    import torch

    sys.path.insert(0, str(REPO))
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.common.state import global_state

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    hvd.init(device="cuda:0")   # both ranks share the card
    eng = global_state().engine
    if eng.native_core is None:
        raise AssertionError("(i) the eager plane runs in direct mode")
    rank = hvd.rank()
    out = {"rank": rank, "native": True,
           "small": eager_small_checks(rank),
           "resnet": eager_resnet(rank, eng),
           "bcast": eager_broadcast_params(rank),
           "stall_report": hvd.stall_report()}
    hvd.shutdown()
    Path(out_path).write_text(json.dumps(out))
    return 0


def eager_phase(gpu):
    """(i): two ranks on cuda:0 in one NCCL world, the native core on the
    base port + 1."""
    t0 = time.perf_counter()
    res = run_workers("--eager-worker", EAGER, EAGER_TIMEOUT_S)
    for r in res:
        log(f"    rank {r['rank']}: native core live; {len(r['small'])} "
            f"small checks passed: {', '.join(r['small'])}")
        for i, st in enumerate(r["resnet"]["steps"]):
            log(f"    rank {r['rank']} ResNet-50 step {i}: loss "
                f"{st['loss']:.4f}, {st['tensors']} named gradients "
                f"({st['elements']} fp32 elements) in {st['responses']} "
                f"responses {st['tensors_per_response']}, cache hits "
                f"{st['cache_hits']}, first to last submit "
                f"{st['submit_span_ms']:.2f} ms, first submit to last "
                f"synchronize {st['wall_ms']:.2f} ms, bitwise equal to "
                f"grouped_allreduce {st['bitwise_equal']} (normwise "
                f"difference {st['rel_diff']:.2e}) on {gpu}")
            if (st["tensors"], st["elements"]) != (RESNET50_TENSORS,
                                                   RESNET50_ELEMENTS):
                raise AssertionError(f"(i) step {i}: {st['tensors']} "
                                     f"tensors, {st['elements']} elements")
            if not st["bitwise_equal"]:
                raise AssertionError(f"(i) step {i} on rank {r['rank']}: the "
                                     f"named plane differs from "
                                     f"grouped_allreduce")
            if not st["responses"] >= 2 or \
                    sum(st["tensors_per_response"]) != RESNET50_TENSORS:
                raise AssertionError(f"(i) step {i}: responses "
                                     f"{st['tensors_per_response']}")
            # A worker sends a repeated tensor as a cache id; the
            # coordinator (rank 0) sends no request frame.
            if i > 0 and r["rank"] > 0 and not st["cache_hits"] > 0:
                raise AssertionError(f"(i) step {i}: no response cache hit "
                                     f"on rank {r['rank']}")
        lat = r["resnet"]["latency_us"]
        log(f"    rank {r['rank']} native allreduce latency over "
            f"{EAGER_STEPS} steps (log2 buckets, us): enqueue to negotiated "
            f"{lat['enq_to_neg_allreduce_us']}, negotiated to executed "
            f"{lat['neg_to_done_allreduce_us']}")
        b = r["bcast"]
        log(f"    rank {r['rank']} parameters by {RESNET50_TENSORS} named "
            f"broadcasts from rank 0 in {b['ms']:.2f} ms: sha256 "
            f"{b['before'][:12]} -> {b['after'][:12]}")
        if r["stall_report"]:
            log(f"    rank {r['rank']} stall report: {r['stall_report']}")
    r0 = res[0]
    for r in res[1:]:
        if r["bcast"]["after"] != r0["bcast"]["before"] or \
                r["bcast"]["before"] == r0["bcast"]["before"]:
            raise AssertionError(f"(i) the named broadcasts did not give "
                                 f"rank {r['rank']} rank 0's parameters")
        if [s["loss"] for s in r0["resnet"]["steps"]] == \
                [s["loss"] for s in r["resnet"]["steps"]]:
            raise AssertionError("(i) the ranks' batches were not their own")
    if r0["bcast"]["after"] != r0["bcast"]["before"]:
        raise AssertionError("(i) rank 0's parameters changed")
    log(f"    (i) took {time.perf_counter() - t0:.1f} s")


# ---- (j) the runtime planes --------------------------------------------------

HOST_RANKS, HOST_LOCAL = 4, 2   # (j)'s host world: two hosts of two ranks
HOST_TIMEOUT_S = 240
PLANES = 2                      # ranks of (j)'s eager part, both on cuda:0
PLANES_TIMEOUT_S = 300
STAGE_THRESHOLD = 1024          # HOROVOD_HOST_VIA_XLA_THRESHOLD in (j)
PLANES_STEPS = 6                # ResNet-50 steps under the tuner
# The tuner's schedule in (j): one warm-up sample, then 4 scored ones of 40
# responses each; ResNet-50 gives ~70-150 responses a step, so the tuner
# pins in step 1 or 2 and the later steps run at the pinned point.
AUTOTUNE_ENV = {"HOROVOD_AUTOTUNE": "1",
                "HOROVOD_AUTOTUNE_WARMUP_SAMPLES": "1",
                "HOROVOD_AUTOTUNE_STEPS_PER_SAMPLE": "40",
                "HOROVOD_AUTOTUNE_BAYES_OPT_MAX_SAMPLES": "4"}
XLA_EXEC_FAULT = "xla.exec:rank=1:step=2:kind=raise"
ZERO_GATHER_FAULT = "zero.gather:rank=1:step=1:kind=raise"
BENCH_FAULT = "xla.exec:kind=delay_ms:ms=1"


def host_op(w, op, x, name, root=-1, reduce_op=1):
    """One blocking host-world collective of the CPU tensor ``x`` (Sum by
    default); returns the output tensor."""
    import torch

    from horovod_tpu_torch.common import host_world, native

    shape = ((w.size * x.shape[0],) + tuple(x.shape[1:])
             if op == native.OP_ALLGATHER else tuple(x.shape))
    out = torch.empty(shape, dtype=x.dtype)
    h = w.enqueue(name, op, reduce_op, host_world.dtype_code(x.dtype),
                  tuple(x.shape), x.data_ptr(), out.data_ptr(),
                  root_rank=root)
    r, err = w.wait(h)
    if r != 1:
        raise AssertionError(f"(j) host {name} failed: {err}")
    return out


def host_checks(w, rank, size):
    """Check 1: allreduce, allgather and broadcast of CPU tensors in every
    dtype on the ring (32 KiB of fp32 a tensor: past the tree threshold),
    against analytic values."""
    import torch

    from horovod_tpu_torch.common import native

    done = []
    base = torch.arange(8192) % 7
    for dt in (torch.float32, torch.bfloat16, torch.float16, torch.int32,
               torch.int64):
        x = (base + rank).to(dt)
        checks = {
            "allreduce": (host_op(w, native.OP_ALLREDUCE, x, f"host.sum.{dt}"),
                          size * base + size * (size - 1) // 2),
            "allgather": (host_op(w, native.OP_ALLGATHER, x,
                                  f"host.gather.{dt}"),
                          torch.cat([base + r for r in range(size)])),
            "broadcast": (host_op(w, native.OP_BROADCAST, x,
                                  f"host.bcast.{dt}", root=size - 1),
                          base + size - 1)}
        for op, (got, want) in checks.items():
            if not torch.equal(got, want.to(dt)):
                raise AssertionError(f"(j) host {op} {dt} on rank {rank}")
            done.append(f"{op}-{dt}")
    return done


def staging_checks(w, rank, size):
    """Check 2: with staging on (threshold 1 KiB), ResNet-50's gradient
    bytes in one fp32 tensor staged and on the ring (``ring_only``), timed;
    16-bit, int32 and Average staged against the ring; int64 and fp64 on
    the ring by the core's guard; a staged broadcast and ragged
    allgather."""
    import numpy as np
    import torch

    from horovod_tpu_torch.common import native

    AR = native.OP_ALLREDUCE
    gens = [torch.Generator().manual_seed(r) for r in range(size)]
    xs = [torch.randn(RESNET50_ELEMENTS, generator=g) for g in gens]
    want = sum(x.double() for x in xs)
    big = xs[rank]
    staged_ms, ring_ms = [], []
    for i in range(3):
        t0 = time.perf_counter()
        staged = host_op(w, AR, big, f"stage.big.{i}")
        staged_ms.append(1e3 * (time.perf_counter() - t0))
    small = torch.arange(16.0) + rank          # 64 bytes: under 1 KiB
    n = 1 << 16
    ints = (torch.arange(n) % 5 + rank).to(torch.int32)
    halves = (torch.arange(n) % 9 + rank) * 0.5
    staged_more = {
        "bf16": host_op(w, AR, halves.bfloat16(), "stage.bf16"),
        "fp16": host_op(w, AR, halves.half(), "stage.fp16"),
        "int32": host_op(w, AR, ints, "stage.int32"),
        "avg": host_op(w, AR, halves, "stage.avg", reduce_op=0),
        "small": host_op(w, AR, small, "under.small")}
    with w.ring_only():
        for i in range(3):
            t0 = time.perf_counter()
            ring = host_op(w, AR, big, f"ring.big.{i}")
            ring_ms.append(1e3 * (time.perf_counter() - t0))
        ring_more = {
            "bf16": host_op(w, AR, halves.bfloat16(), "ring.bf16"),
            "fp16": host_op(w, AR, halves.half(), "ring.fp16"),
            "int32": host_op(w, AR, ints, "ring.int32"),
            "avg": host_op(w, AR, halves, "ring.avg", reduce_op=0),
            "small": host_op(w, AR, small, "ring.small")}
    rel_ring = float((staged - ring).norm() / ring.norm())
    rel_exact = float((staged.double() - want).norm() / want.norm())
    if not (rel_ring <= 1e-6 and rel_exact <= 1e-6):
        raise AssertionError(f"(j) staged fp32 off: {rel_ring:.3e} from the "
                             f"ring, {rel_exact:.3e} from fp64")
    for k, got in staged_more.items():
        if not torch.equal(got, ring_more[k]):
            raise AssertionError(f"(j) staged {k} differs from the ring")
    i64 = torch.arange(n, dtype=torch.int64) + (1 << 40) * (rank + 1)
    got = host_op(w, AR, i64, "ring.int64")
    if not torch.equal(got, size * torch.arange(n, dtype=torch.int64)
                       + (1 << 40) * size * (size + 1) // 2):
        raise AssertionError("(j) int64 allreduce")
    f64 = torch.arange(n, dtype=torch.float64) / 4 + rank
    got = host_op(w, AR, f64, "ring.fp64")
    if not torch.equal(got, size * (torch.arange(n, dtype=torch.float64)
                                    / 4) + size * (size - 1) / 2):
        raise AssertionError("(j) fp64 allreduce")
    b = host_op(w, native.OP_BROADCAST, halves + 100 * rank, "stage.bcast",
                root=1)
    if not torch.equal(b, (torch.arange(n) % 9 + 1) * 0.5 + 100):
        raise AssertionError("(j) staged broadcast")
    rows = np.full(((rank + 1) * 300, 2), rank, np.float32)
    g, dims = w.allgatherv_np(rows, "stage.gather")
    if dims.tolist() != [(r + 1) * 300 for r in range(size)] or not \
            np.array_equal(g, np.concatenate(
                [np.full(((r + 1) * 300, 2), r, np.float32)
                 for r in range(size)])):
        raise AssertionError("(j) staged ragged allgather")
    return {"staged_ms": staged_ms, "ring_ms": ring_ms,
            "rel_ring": rel_ring, "rel_fp64": rel_exact,
            "staged": list(w.staging.staged)}


def trace_names(path):
    """(tensor name -> [events in file order]) of a Chrome trace."""
    events = json.loads(Path(path).read_text())
    tids = {e["tid"]: e["args"]["name"] for e in events if e["ph"] == "M"}
    per = {}
    for e in events:
        if e["ph"] in ("B", "E", "i") and e.get("tid") in tids:
            per.setdefault(tids[e["tid"]], []).append(e)
    return events, per


def response_split(per, prefix, steps, ranks):
    """From rank 0's trace of the eager plane: every tensor named
    ``prefix...`` has, each step, a ``NEGOTIATE_ALLREDUCE`` span followed by
    an ``NCCL_ALLREDUCE`` one. Per tensor and step: enqueue (the
    negotiation's start) to negotiated (the last rank's submission tick,
    ``RANK_READY[r]``), negotiated to the executor's start (the
    negotiation's end), and the NCCL activity (to the completion event);
    returns their p50/p99 in ms and the count."""
    import numpy as np

    parts = {"enqueue_to_negotiated": [], "negotiated_to_start": [],
             "activity": []}
    tensors = 0
    for name, evs in per.items():
        if not name.startswith(prefix):
            continue
        tensors += 1

        def ts(ph, act):
            return sorted(e["ts"] for e in evs
                          if e["ph"] == ph and e["name"] == act)

        nb, ne = ts("B", "NEGOTIATE_ALLREDUCE"), ts("E", "NEGOTIATE_ALLREDUCE")
        cb, ce = ts("B", "NCCL_ALLREDUCE"), ts("E", "NCCL_ALLREDUCE")
        ticks = sorted(e["ts"] for e in evs if e["ph"] == "i"
                       and e["name"].startswith("RANK_READY"))
        if not len(nb) == len(ne) == len(cb) == len(ce) == steps:
            raise AssertionError(
                f"(j) {name}: {len(nb)}/{len(ne)} NEGOTIATE_ALLREDUCE and "
                f"{len(cb)}/{len(ce)} NCCL_ALLREDUCE begin/end events, "
                f"expected {steps}")
        prev = float("-inf")
        for k in range(steps):
            mine = [t for t in ticks if prev < t <= ne[k]]
            if len(mine) != ranks or not nb[k] <= ne[k] <= cb[k] <= ce[k]:
                raise AssertionError(f"(j) {name} step {k}: ticks {mine}, "
                                     f"spans {nb[k], ne[k], cb[k], ce[k]}")
            parts["enqueue_to_negotiated"].append(max(mine) - nb[k])
            parts["negotiated_to_start"].append(ne[k] - max(mine))
            parts["activity"].append(ce[k] - cb[k])
            prev = ne[k]
    return {"tensors": tensors, "samples": len(parts["activity"]),
            **{k: {"p50_ms": float(np.percentile(v, 50)) / 1e3,
                   "p99_ms": float(np.percentile(v, 99)) / 1e3}
               for k, v in parts.items()}}


def parse_prometheus(text):
    """{series: value} of a Prometheus textfile; raises on a line that is
    neither a ``# TYPE`` comment nor ``name[{labels}] number``."""
    series = {}
    for line in text.splitlines():
        if line.startswith("#"):
            if not re.fullmatch(r"# TYPE \w+ (counter|gauge|histogram)",
                                line):
                raise AssertionError(f"(j) bad Prometheus line {line!r}")
            continue
        m = re.fullmatch(r'(\w+(?:\{le="[^"]+"\})?) (\S+)', line)
        try:
            series[m.group(1)] = float(m.group(2))
        except (AttributeError, ValueError):
            raise AssertionError(f"(j) bad Prometheus line {line!r}") \
                from None
    return series


def host_worker(out_path):
    """One rank of (j)'s host world (run as ``chip_smoke.py
    --host-worker``; two hosts of two ranks, no ``hvd.init``, the shm
    transport and the hierarchical allreduce armed, staging on cuda:0):
    checks 1 and 2."""
    import torch

    sys.path.insert(0, str(REPO))
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.common import host_world

    rank = int(os.environ["HOROVOD_RANK"])
    timeline = Path(out_path).parent / "host_timeline.json"
    if rank == 0:
        os.environ["HOROVOD_TIMELINE"] = str(timeline)
    torch.cuda.set_device(0)
    w = host_world.world()
    t0 = time.perf_counter()
    w.init(device="cuda:0")      # every rank stages on the one card
    init_s = time.perf_counter() - t0
    if w.staging is None:
        raise AssertionError("(j) staging did not activate")
    with w.ring_only():
        host = host_checks(w, rank, w.size)
    traffic = hvd.ring_traffic()
    staging = staging_checks(w, rank, w.size)
    w.shutdown()
    out = {"rank": rank, "init_s": init_s, "host": host, "traffic": traffic,
           "staging": staging}
    if rank == 0:
        _, per = trace_names(timeline)
        out["activities"] = {n: sorted({e["name"] for e in evs})
                             for n, evs in per.items()}
    Path(out_path).write_text(json.dumps(out))
    return 0


def fault_checks(rank):
    """Check 4: ``xla.exec`` fired on rank 1 at its third response, then
    ``zero.gather`` on rank 1 at its second stage-3 step of a small model:
    the faulted call raises ``HorovodInternalError`` on every rank (ms to
    the raise), the calls before and after it complete."""
    import functools

    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import zero
    from horovod_tpu_torch.common import faults
    from horovod_tpu_torch.image_bench import ZeroMLP

    dev = hvd.device()

    def armed(spec, calls):
        hvd.barrier()
        os.environ["HOROVOD_FAULT_SPEC"] = spec
        faults.refresh()
        seen = []
        for i, call in enumerate(calls):
            t0 = time.perf_counter()
            try:
                call(i)
                what = "ok"
            except hvd.HorovodInternalError as e:
                what = f"raised: {e}"
            seen.append({"call": i, "outcome": what,
                         "ms": 1e3 * (time.perf_counter() - t0)})
        hvd.barrier()
        os.environ.pop("HOROVOD_FAULT_SPEC")
        faults.refresh()
        return seen

    def allreduce(i):
        got = hvd.allreduce(torch.full((1024,), rank + 1.0, device=dev),
                            name=f"fault.{i}", op=hvd.Sum)
        if not torch.equal(got.cpu(), torch.full((1024,), 3.0)):
            raise AssertionError(f"(j) fault.{i} = {got[:4]}")

    model = ZeroMLP(hidden=64, layers=2, device=dev)
    state = zero.init_zero_train_state(
        model, functools.partial(torch.optim.SGD, lr=0.1), zero_stage=3,
        compression="none")
    step = zero.make_zero_train_step()
    g = torch.Generator().manual_seed(rank)
    x = torch.randn(8, 64, generator=g).to(dev)
    y = torch.randint(0, 16, (8,), generator=g).to(dev)

    def zero_step(i):
        _, loss = step(state, x, y)
        if not math.isfinite(float(loss)):
            raise AssertionError("(j) zero step loss")

    return {"xla.exec": armed(XLA_EXEC_FAULT, [allreduce] * 4),
            "zero.gather": armed(ZERO_GATHER_FAULT, [zero_step] * 3)}


def planes_worker(out_path):
    """One rank of (j)'s eager part (run as ``chip_smoke.py
    --planes-worker``): checks 3 and 5 with the timeline on rank 0, the
    tuner and the metrics pump, then checks 4 and 6 in a second
    ``hvd.init`` of the same NCCL world."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(REPO))
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import image_bench
    from horovod_tpu_torch.common import faults
    from horovod_tpu_torch.common.state import global_state
    from horovod_tpu_torch.ops import flash_attention as fa

    fa.reset_launches()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rank = int(os.environ["HOROVOD_RANK"])
    tmp = Path(out_path).parent
    torch.cuda.set_device(0)
    dist.init_process_group(
        "nccl", rank=rank, world_size=PLANES, init_method=(
            f"tcp://127.0.0.1:{os.environ['HOROVOD_CONTROLLER_PORT']}"))
    runtime = dict(AUTOTUNE_ENV,
                   HOROVOD_METRICS_EXPORT=str(tmp / f"metrics{rank}.prom"),
                   HOROVOD_METRICS_INTERVAL_MS="500")
    if rank == 0:
        runtime["HOROVOD_TIMELINE"] = str(tmp / "eager_timeline.json")
    os.environ.update(runtime)
    hvd.init(device="cuda:0")
    st = global_state()
    eng = st.engine

    def tuner_state():
        tuner = st.autotuner
        return {"tuning": tuner.active if tuner else None,
                "samples": tuner.samples_taken if tuner else None,
                "params": list(eng.native_core.get_parameters())}

    resnet = eager_resnet(rank, eng, PLANES_STEPS, after_step=tuner_state)
    pinned = list(st.autotuner.current) if st.autotuner else None
    hvd.shutdown()
    for k in runtime:
        os.environ.pop(k)
    out = {"rank": rank, "resnet": resnet, "pinned": pinned,
           "prometheus": parse_prometheus(
               (tmp / f"metrics{rank}.prom").read_text())}
    if rank == 0:
        _, per = trace_names(tmp / "eager_timeline.json")
        out["split"] = response_split(per, "grad.", PLANES_STEPS, PLANES)
    hvd.init(device="cuda:0")
    out["faults"] = fault_checks(rank)
    bench = image_bench.run(image_bench.parse_args([
        "--num-warmup", "1", "--num-iters", "2", "--device", "cuda:0",
        "--fault-spec", BENCH_FAULT]))
    os.environ.pop("HOROVOD_FAULT_SPEC")
    faults.refresh()
    out["bench"] = {k: bench.result.get(k) for k in (
        "ring_local_bytes", "ring_cross_bytes", "ring_shm_bytes",
        "local_transport", "host_hierarchical", "fault_spec", "step_ms",
        "loss")}
    out["bench"]["metrics_keys"] = sorted(bench.result.get("metrics") or {})
    out["launches"] = dict(fa.LAUNCHES)
    hvd.shutdown()
    dist.destroy_process_group()
    Path(out_path).write_text(json.dumps(out))
    return 0


def planes_phase(gpu):
    """(j): the host world (4 ranks as two hosts of two) with staging, then
    the eager plane's runtime planes (2 ranks), all on cuda:0."""
    t0 = time.perf_counter()
    res = run_workers("--host-worker", HOST_RANKS, HOST_TIMEOUT_S,
                      local_size=HOST_LOCAL, env={
                          "HOROVOD_SHM": "1",
                          "HOROVOD_HIERARCHICAL_ALLREDUCE": "1",
                          "HOROVOD_HOST_VIA_XLA": "1",
                          "HOROVOD_HOST_VIA_XLA_THRESHOLD":
                              str(STAGE_THRESHOLD)})
    for r in res:
        t, s = r["traffic"], r["staging"]
        log(f"    host rank {r['rank']}: world and staging up in "
            f"{r['init_s']:.2f} s; {len(r['host'])} ring checks passed; "
            f"ring traffic local {t['local_bytes']} B, cross "
            f"{t['cross_bytes']} B, shm {t['shm_bytes']} B (shm armed "
            f"{t['shm']}, hierarchical allreduce "
            f"{t['hierarchical_allreduce']})")
        log(f"    host rank {r['rank']}: {RESNET50_ELEMENTS} fp32 "
            f"({4 * RESNET50_ELEMENTS / 1e6:.1f} MB) allreduce of "
            f"{HOST_RANKS} ranks staged through NCCL "
            f"{[round(x, 2) for x in s['staged_ms']]} ms, on the ring "
            f"{[round(x, 2) for x in s['ring_ms']]} ms; staged against "
            f"ring {s['rel_ring']:.2e}, against fp64 {s['rel_fp64']:.2e} "
            f"(limit 1e-6); staged responses {s['staged']} on {gpu}")
        if not t["shm"] or not t["shm_bytes"] > 0:
            raise AssertionError(f"(j) rank {r['rank']}: no shm bytes with "
                                 f"shm armed: {t}")
    if not sum(r["traffic"]["local_bytes"] for r in res) > 0:
        raise AssertionError("(j) no local ring bytes")
    acts = res[0]["activities"]
    staged = {"stage.big.0", "stage.big.1", "stage.big.2", "stage.bf16",
              "stage.fp16", "stage.int32", "stage.avg"}
    ring = {"ring.big.0", "ring.big.1", "ring.big.2", "ring.int64",
            "ring.fp64", "under.small", "ring.small", "ring.bf16",
            "ring.fp16", "ring.int32", "ring.avg"}
    for name in staged:
        if "NCCL_ALLREDUCE" not in acts.get(name, ()):
            raise AssertionError(f"(j) {name} not staged: {acts.get(name)}")
    for name, want in (("stage.bcast", "NCCL_BCAST"),
                       ("stage.gather", "NCCL_ALLGATHER")):
        if want not in acts.get(name, ()):
            raise AssertionError(f"(j) {name}: {acts.get(name)}")
    for name in ring:
        if acts.get(name):
            raise AssertionError(f"(j) {name} was staged: {acts[name]}")
    log(f"    rank 0's timeline: {len(acts)} staged tensors, "
        f"{sorted(acts)}; none of {sorted(ring)}")

    res = run_workers("--planes-worker", PLANES, PLANES_TIMEOUT_S)
    for r in res:
        for i, st in enumerate(r["resnet"]["steps"]):
            log(f"    rank {r['rank']} ResNet-50 step {i}: "
                f"{st['responses']} responses, first submit to last "
                f"synchronize {st['wall_ms']:.2f} ms, bitwise equal "
                f"{st['bitwise_equal']}, tuner "
                f"{'tuning' if st['tuning'] else 'pinned'} after "
                f"{st['samples']} samples, cycle/fusion "
                f"{st['params']} on {gpu}")
            if not st["bitwise_equal"] or (st["tensors"], st["elements"]) \
                    != (RESNET50_TENSORS, RESNET50_ELEMENTS):
                raise AssertionError(f"(j) step {i} on rank {r['rank']}")
        prom = r["prometheus"]
        counts = {k: prom.get(k) for k in (
            "hvd_cycles", "hvd_cache_hits",
            "hvd_enq_to_neg_allreduce_us_count")}
        log(f"    rank {r['rank']} Prometheus textfile: {len(prom)} series "
            f"parsed, {counts}")
        if not (prom.get("hvd_cycles", 0) > 0 and
                prom.get("hvd_enq_to_neg_allreduce_us_count", 0)
                >= RESNET50_TENSORS * PLANES_STEPS):
            raise AssertionError(f"(j) metrics pump on rank {r['rank']}")
        for point, seen in r["faults"].items():
            log(f"    rank {r['rank']} {point}: {seen}")
            raised = [c["call"] for c in seen if c["outcome"] != "ok"]
            if raised != [2 if point == "xla.exec" else 1]:
                raise AssertionError(f"(j) {point} on rank {r['rank']}: "
                                     f"{seen}")
            if not max(c["ms"] for c in seen) < 60e3:
                raise AssertionError(f"(j) {point} beyond the stall bound")
        b = r["bench"]
        log(f"    rank {r['rank']} image_bench --fault-spec {BENCH_FAULT!r}"
            f": {b}")
        if b["fault_spec"] != BENCH_FAULT or b["local_transport"] not in (
                "tcp", "shm") or not all(
                b[k] >= 0 for k in ("ring_local_bytes", "ring_cross_bytes",
                                    "ring_shm_bytes")) or \
                set(b["host_hierarchical"]) != {"allreduce", "allgather",
                                                "tuned"}:
            raise AssertionError(f"(j) image_bench fields: {b}")
    for r in res:
        if any(r["launches"].values()):
            raise AssertionError(f"(j) attention kernels launched: "
                                 f"{r['launches']}")
    log(f"    attention kernel launches in (j): {res[0]['launches']}")
    r0 = res[0]
    steps = r0["resnet"]["steps"]
    pin = next((i for i, st in enumerate(steps) if not st["tuning"]), None)
    if r0["pinned"] is None or pin is None:
        raise AssertionError(f"(j) the tuner did not pin: {steps[-1]}")
    log(f"    tuner pinned fusion {r0['pinned'][0]:.2f} MB, cycle "
        f"{r0['pinned'][1]:.2f} ms during step {pin}; responses a step "
        f"{[st['responses'] for st in steps]}")
    sp = r0["split"]
    log(f"    a response's time from rank 0's trace ({sp['tensors']} "
        f"gradients x {PLANES_STEPS} steps = {sp['samples']}), p50/p99 ms: "
        f"enqueue to negotiated {sp['enqueue_to_negotiated']}, negotiated "
        f"to the executor's start {sp['negotiated_to_start']}, the NCCL "
        f"activity {sp['activity']}")
    if sp["tensors"] != RESNET50_TENSORS:
        raise AssertionError(f"(j) {sp['tensors']} gradients in the trace")
    log(f"    (j) took {time.perf_counter() - t0:.1f} s")


AB_MODES = ("flash_fwd", "flash_fwd_train", "flash_bwd_dq", "flash_bwd_dkv")
AB_RING_MODES = ("flash_fwd_state", "flash_bwd_dq_f32", "flash_bwd_dkv_f32")


# ---- (k) the torch binding and the elastic worker ----------------------------

BINDING = 2             # ranks of (k), both on cuda:0, two hosts of one
BINDING_TIMEOUT_S = 360
# (k): a survivor raises HorovodInternalError within this many seconds of
# its peer's SIGKILL (the native core's closed connection, then the
# communicators' abort); past it the phase fails as a hang.
KILL_BOUND_S = 30.0
# (k): the survivor commits its first batch in the re-formed world (the
# respawned rank 1 beside it) within this many seconds of the kill; past
# it the phase fails. The slowest of 22 kill runs on an NVIDIA H100 80GB
# HBM3 at 700 W (25.08 s, 11 of them between SyncBatchNorm batches;
# PERF.md) x 1.5, below the 59.4 s that torch's destructor of a lost
# world's NCCL group once took on its own.
REFORM_BOUND_S = 37.6
KILL_LOG_TAIL = 40      # lines of each worker's log on stderr when (k)(2) fails
ELASTIC_FAULT = "xla.exec:rank=1:step=3"
ELASTIC_BATCHES = 8     # (k)(1): committed batches of the small model
KILL_TARGET, KILL_READY = 20, 5     # (k)(2): batches, and when to kill
SBN_STEPS = (1, 1)      # warm-up and timed steps of (k)'s batch-norm runs
# (k)'s batch-norm race (``--sbn-race-worker``): runs, the warm-up and
# timed steps of each model, and each run's limit.
SBN_RACE_RUNS, SBN_RACE_STEPS, SBN_RACE_TIMEOUT_S = 2, (1, 3), 150


def binding_checks(hvd, rank, dev):
    """The reference binding's worker checks (``tests/test_torch.py``'s
    multi-process worker) on tensors on the card, at two ranks; then a CPU
    tensor through the host ring. Returns the checks' names."""
    import numpy as np
    import torch

    from horovod_tpu_torch.ops.adasum import adasum_reference

    done = []

    def check(name, ok, detail=""):
        if not ok:
            raise AssertionError(f"(k) {name} on rank {rank}: {detail}")
        done.append(name)

    x = torch.arange(10, dtype=torch.float32, device=dev) * (rank + 1)
    want = torch.arange(10, dtype=torch.float32, device=dev) * 3
    check("sum", torch.equal(hvd.allreduce(x, op=hvd.Sum, name="k.sum"),
                             want))
    check("average", torch.equal(hvd.allreduce(x, name="k.avg"), want / 2))
    xi = torch.full((6,), 2 ** 40 + rank, dtype=torch.int64, device=dev)
    hvd.allreduce_(xi, op=hvd.Sum, name="k.int64")
    check("int64-in-place", bool((xi == 2 ** 41 + 1).all()), xi)
    xm = torch.full((3,), float(rank), device=dev)
    check("min-max", bool((hvd.allreduce(xm, op=hvd.Max) == 1).all()) and
          bool((hvd.allreduce(xm, op=hvd.Min) == 0).all()))
    b = torch.full((5,), float(rank * 100), device=dev)
    check("broadcast-root1", torch.equal(hvd.broadcast(b, 1, name="k.bc"),
                                         torch.full_like(b, 100.0)))
    g = hvd.allgather(torch.full((rank + 1, 2), float(rank), device=dev),
                      name="k.ag")
    check("allgather-ragged", torch.equal(g.cpu(), torch.tensor(
        [[0.0, 0], [1, 1], [1, 1]])), g)
    t = torch.randn(4, device=dev, requires_grad=True)
    hvd.allreduce(t, name="k.grad").sum().backward()
    check("autograd", torch.equal(t.grad, torch.ones_like(t)), t.grad)
    bf = torch.full((8,), 1 + 2 ** -7, dtype=torch.bfloat16,
                    device=dev) * (rank + 1)
    check("bf16", torch.equal(hvd.allreduce(bf, op=hvd.Sum).cpu(), (
        torch.full((8,), 1 + 2 ** -7) * 3).bfloat16()))
    rng = np.random.RandomState(7)
    vecs = [rng.randn(1000).astype(np.float32) for _ in range(2)]
    got = hvd.allreduce(torch.from_numpy(vecs[rank]).to(dev),
                        op=hvd.Adasum, name="k.adasum").cpu().numpy()
    want_a = adasum_reference(vecs)
    err = float(np.abs(got - want_a).max() / np.abs(want_a).max())
    check("adasum", err <= 1e-5, err)
    obj = {"rank": rank, "data": list(range(rank + 1))}
    check("objects", hvd.broadcast_object(obj, root_rank=1) ==
          {"rank": 1, "data": [0, 1]} and
          [o["rank"] for o in hvd.allgather_object(obj)] == [0, 1])
    # broadcast_parameters + broadcast_optimizer_state (SGD with momentum,
    # its state not made yet), then 4 steps: every rank equal.
    torch.manual_seed(1234 + rank)
    model = torch.nn.Sequential(torch.nn.Linear(6, 8), torch.nn.ReLU(),
                                torch.nn.Linear(8, 1)).to(dev)
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.05, momentum=0.9),
        named_parameters=model.named_parameters())
    hvd.broadcast_optimizer_state(opt, root_rank=0)
    X = torch.randn(16, 6, generator=torch.Generator().manual_seed(99))
    X = X.to(dev)
    for _ in range(4):
        opt.zero_grad()
        xb = X[rank * 8:(rank + 1) * 8]
        torch.nn.functional.mse_loss(
            model(xb), xb.sum(1, keepdim=True)).backward()
        opt.step()
    flat = torch.cat([p.detach().flatten() for p in model.parameters()])
    both = hvd.allgather(flat[None], name="k.opt.check")
    check("optimizer-ranks-equal", torch.equal(both[0], both[1]))
    model2 = torch.nn.Linear(4, 1, bias=False).to(dev)
    torch.nn.init.zeros_(model2.weight)
    opt2 = hvd.DistributedOptimizer(
        torch.optim.SGD(model2.parameters(), lr=1.0),
        named_parameters=model2.named_parameters(),
        backward_passes_per_step=2)
    for micro in range(2):
        model2(torch.ones(2, 4, device=dev) * (rank + micro + 1)).sum() \
            .backward()
    opt2.step()
    check("backward-passes-per-step-2",
          torch.equal(model2.weight.cpu(), torch.full((1, 4), -8.0)),
          model2.weight)
    # A CPU tensor in the world on the card takes the host ring (in a
    # world on the CPU, the world's own plane).
    before = hvd.ring_traffic()["bytes_sent"]
    host = hvd.allreduce(torch.full((1024,), float(rank + 1)), op=hvd.Sum,
                         name="k.host")
    sent = hvd.ring_traffic()["bytes_sent"] - before
    check("cpu-tensor-host-ring", host.device.type == "cpu" and
          torch.equal(host, torch.full((1024,), 3.0)) and
          (sent > 0 or torch.device(dev).type == "cpu"),
          f"{host.device}, {sent} ring bytes")
    return done


def binding_resnet_bitwise(hvd, rank, dev, steps=2):
    """ResNet-50 (bf16, 224 px, batch 32 a rank, each rank its own batch)
    trained by the binding's per-parameter ``DistributedOptimizer`` and,
    from the same weights and batches, by the port's bucketed one
    (``horovod_tpu_torch.DistributedOptimizer``): the parameters' sha256
    after every step, each pair equal (a sum of two has one rounding)."""
    import numpy as np
    import torch

    import horovod_tpu_torch
    from horovod_tpu_torch import training
    from horovod_tpu_torch.models import resnet

    rng = np.random.RandomState(rank)
    x = torch.as_tensor(rng.rand(32, 224, 224, 3).astype(np.float32),
                        device=dev)
    y = torch.as_tensor(rng.randint(0, 1000, 32), device=dev)
    rows = []
    for name, wrap in (
            ("binding", lambda o, m: hvd.DistributedOptimizer(
                o, named_parameters=m.named_parameters())),
            ("bucketed", lambda o, m: horovod_tpu_torch.DistributedOptimizer(
                o, named_parameters=m.named_parameters()))):
        model = resnet.ResNet50(num_classes=1000, dtype=torch.bfloat16,
                                device=dev, seed=0)
        opt = wrap(torch.optim.SGD(model.parameters(), lr=0.01,
                                   momentum=0.9), model)
        digests = []
        for _ in range(steps):
            opt.zero_grad()
            training.cross_entropy_loss(model(x), y).backward()
            opt.step()
            digests.append(tensor_digest(list(model.parameters())))
        rows.append((name, len(list(model.parameters())), digests))
        del model, opt
        torch.cuda.empty_cache()
    return rows


def swap_sync_bn(module, hvd):
    """``module`` with every ``nn.BatchNorm2d`` replaced by the binding's
    ``SyncBatchNorm`` (the same buffers and parameters)."""
    import torch

    for name, child in module.named_children():
        if isinstance(child, torch.nn.BatchNorm2d):
            sbn = hvd.SyncBatchNorm(child.num_features, child.eps,
                                    child.momentum)
            sbn.load_state_dict(child.state_dict())
            setattr(module, name, sbn.to(child.weight.device))
        else:
            swap_sync_bn(child, hvd)
    return module


@contextlib.contextmanager
def negotiated_statistics(hvd):
    """(k)'s A/B alone: ``SyncBatchNorm``'s two sums a layer through the
    binding's public call (``hvd.synchronize(hvd.allreduce_async(...))``,
    which waits on the host for the card's completion event) instead of
    its own path (``ops/collectives.ordered_allreduce``: negotiated too
    beside the binding's optimizer, the result's event left to the
    caller's stream)."""
    from horovod_tpu_torch.torch import sync_batch_norm

    own = sync_batch_norm._world_sum
    sync_batch_norm._world_sum = lambda t, name: hvd.synchronize(
        hvd.allreduce_async(t, op=hvd.Sum, name=name))
    try:
        yield
    finally:
        sync_batch_norm._world_sum = own


def timed_steps(step, warmup, iters):
    """(losses, ms a step over the timed steps)."""
    import torch

    losses = [step() for _ in range(warmup)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses += [step() for _ in range(iters)]
    torch.cuda.synchronize()
    return losses, 1e3 * (time.perf_counter() - t0) / iters


def batch_norm_runs(hvd, rank, dev, steps, axes=("dp", None),
                    paths=("local", "synced", "negotiated")):
    """ResNet-50 (bf16, batch 32 a rank) with ``sync_bn_axis`` each of
    ``axes`` and the example's ResNet-50 (53 ``BatchNorm2d``) with each
    batch-norm path of ``paths`` (local statistics, ``SyncBatchNorm``,
    ``SyncBatchNorm`` through ``negotiated_statistics``), every model
    under the binding's per-parameter ``DistributedOptimizer`` for
    ``steps`` (warm-up, timed). Returns {"resnet_<axis>" or
    "example_<path>": (losses, ms a step)}."""
    import numpy as np
    import torch

    from horovod_tpu_torch import training
    from horovod_tpu_torch.examples import pytorch_synthetic_benchmark as ex
    from horovod_tpu_torch.models import resnet

    out = {}
    gen = torch.Generator().manual_seed(7)
    rng = np.random.RandomState(rank)
    x = torch.as_tensor(rng.rand(32, 224, 224, 3).astype(np.float32),
                        device=dev)
    y = torch.as_tensor(rng.randint(0, 1000, 32), device=dev)
    for axis in axes:
        model = resnet.ResNet50(num_classes=1000, dtype=torch.bfloat16,
                                device=dev, seed=0, sync_bn_axis=axis)
        opt = hvd.DistributedOptimizer(
            torch.optim.SGD(model.parameters(), lr=0.01, momentum=0.9),
            named_parameters=model.named_parameters())

        def step():
            opt.zero_grad()
            loss = training.cross_entropy_loss(model(x), y)
            loss.backward()
            opt.step()
            # The world's mean loss: each rank has its own batch.
            return hvd.allreduce(loss.detach(), name="k.loss").item()

        out[f"resnet_{axis}"] = timed_steps(step, *steps)
        del model, opt
        torch.cuda.empty_cache()
    xe = torch.randn(32, 3, 224, 224, generator=gen).to(dev)
    ye = torch.randint(0, 1000, (32,), generator=gen).to(dev)
    for path in paths:
        torch.manual_seed(42)
        model = ex.resnet50().to(dev)
        if path != "local":
            swap_sync_bn(model, hvd)
        opt = hvd.DistributedOptimizer(
            torch.optim.SGD(model.parameters(), lr=0.01),
            named_parameters=model.named_parameters())

        def step():
            opt.zero_grad()
            loss = torch.nn.functional.cross_entropy(model(xe), ye)
            loss.backward()
            opt.step()
            return loss.item()

        with (negotiated_statistics(hvd) if path == "negotiated"
              else contextlib.nullcontext()):
            out[f"example_{path}"] = timed_steps(step, *steps)
        del model, opt
        torch.cuda.empty_cache()
    return out


def sync_bn_checks(hvd, rank, dev):
    """``SyncBatchNorm`` on the card against ``nn.BatchNorm2d`` over both
    ranks' batch; then ``batch_norm_runs`` of every model and path."""
    import torch

    out = {}
    gen = torch.Generator().manual_seed(7)
    full = (torch.randn(16, 8, 12, 12, generator=gen) * 2 + 0.5).to(dev)
    sbn = hvd.SyncBatchNorm(8, momentum=0.5).to(dev)
    ref = torch.nn.BatchNorm2d(8, momentum=0.5).to(dev)
    got = sbn(full[rank * 8:(rank + 1) * 8])
    want = ref(full)[rank * 8:(rank + 1) * 8]
    out["sbn_forward"] = float((got - want).abs().max())
    out["sbn_mean"] = float((sbn.running_mean - ref.running_mean).abs().max())
    out["sbn_var"] = float((sbn.running_var - ref.running_var).abs().max())
    out.update(batch_norm_runs(hvd, rank, dev, SBN_STEPS))
    return out


def sbn_race_worker(out_path):
    """One rank of (k)'s batch-norm race (``chip_smoke.py
    --sbn-race-worker``; two hosts of one rank on cuda:0, as
    ``--binding-worker``): ``batch_norm_runs`` of ResNet-50 with
    ``sync_bn_axis="dp"`` and the example with ``SyncBatchNorm``, for
    ``SBN_RACE_STEPS`` (``CHIP_SMOKE_SBN_STEPS="w,t"`` moves them): the
    two workloads where the batch norms' world sums meet the gradients
    that the binding's optimizer submits from backward hooks. With
    ``CHIP_SMOKE_FR=1`` torch's NCCL flight recorder is on, and once a
    file ``dump`` appears beside ``out_path`` this rank writes its
    record of every group's collectives to ``fr.<rank>.pkl`` there."""
    import threading

    import torch

    sys.path.insert(0, str(REPO))
    tmp = Path(out_path).parent
    if os.environ.get("CHIP_SMOKE_FR") == "1":
        os.environ.setdefault("TORCH_NCCL_TRACE_BUFFER_SIZE", "4000")
    import horovod_tpu_torch.torch as hvd

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    hvd.init()
    dev = torch.device("cuda", torch.cuda.current_device())
    rank = hvd.rank()
    if os.environ.get("CHIP_SMOKE_FR") == "1":
        def dump():
            while not (tmp / "dump").exists():
                time.sleep(0.2)
            from torch._C._distributed_c10d import _dump_nccl_trace

            (tmp / f"fr.{rank}.pkl").write_bytes(_dump_nccl_trace())

        threading.Thread(target=dump, daemon=True).start()
    steps = tuple(int(v) for v in os.environ.get(
        "CHIP_SMOKE_SBN_STEPS", ",".join(map(str, SBN_RACE_STEPS))
    ).split(","))
    out = {"rank": rank, "steps": steps}
    out.update(batch_norm_runs(hvd, rank, dev, steps, axes=("dp",),
                               paths=("synced",)))
    hvd.shutdown()
    Path(out_path).write_text(json.dumps(out))
    return 0


def sbn_race_phase(gpu, runs=SBN_RACE_RUNS):
    """(k)'s batch-norm race: ``runs`` pairs of ``--sbn-race-worker``, one
    after another, each under ``SBN_RACE_TIMEOUT_S``; a pair that hangs or
    fails fails (k). Each run's losses must be finite and the same on
    both ranks."""
    for i in range(runs):
        t1 = time.perf_counter()
        res = run_workers("--sbn-race-worker", BINDING, SBN_RACE_TIMEOUT_S,
                          local_size=1,
                          env={"CUBLAS_WORKSPACE_CONFIG": ":4096:8"})
        for key in ("resnet_dp", "example_synced"):
            losses = [r[key][0] for r in res]
            if not all(math.isfinite(v) for v in losses[0]) or \
                    losses[0] != losses[1]:
                raise AssertionError(f"(k) batch-norm race {i}: {key} "
                                     f"losses {losses}")
        log(f"    batch-norm race {i + 1} of {runs}: "
            f"{time.perf_counter() - t1:.1f} s (limit "
            f"{SBN_RACE_TIMEOUT_S} s); ms a step over "
            f"{res[0]['steps'][1]} timed, rank 0: resnet_dp "
            f"{res[0]['resnet_dp'][1]:.2f}, example_synced "
            f"{res[0]['example_synced'][1]:.2f} on {gpu}")


def flight_record_summary(path, last=12):
    """The last ``last`` entries of one rank's NCCL flight record (torch's
    ``_dump_nccl_trace`` pickle), one line each: the group, its sequence
    number, the collective, its sizes and its state."""
    import pickle

    entries = pickle.loads(Path(path).read_bytes()).get("entries", [])
    lines = []
    for e in entries[-last:]:
        pg = e.get("process_group", ("?", "?"))
        lines.append(f"pg {pg[0]} ({pg[1]}) seq {e.get('collective_seq_id')} "
                     f"{e.get('profiling_name')} "
                     f"{e.get('input_sizes')} {e.get('state')}")
    return lines


def sbn_race_repro(runs, trees, keep="build/sbn_race", steps=(2, 8),
                   dump_s=85.0, abort_s=90.0, limit_s=120.0):
    """(k)'s batch-norm race alone (``python3 chip_smoke.py --sbn-race
    RUNS [--keep OUT] [DIR[:RUNS] ...]``): ``runs`` pairs of
    ``--sbn-race-worker`` for this checkout and, in turn with them, each
    DIR's own RUNS (default ``runs``; a DIR is another checkout, whose own
    package a copy of this file imports), ``steps`` of each model, torch's
    NCCL flight recorder on. A pair still running at ``dump_s`` writes its
    flight records, gets SIGABRT at ``abort_s`` (``PYTHONFAULTHANDLER``:
    every thread's stack in its log) and SIGKILL at ``limit_s``; the logs
    and records of a pair that hung or failed go under ``keep`` (OUT,
    relative to this checkout). One JSON line a run; 0 when no run failed
    other than by hanging."""
    import signal

    counts = [runs] + [int(t.rpartition(":")[2]) if ":" in t else runs
                       for t in trees]
    trees = [REPO, *[Path(t.partition(":")[0]).resolve() for t in trees]]
    scripts = [Path(__file__).resolve()]
    for t in trees[1:]:
        shutil.copy(Path(__file__).resolve(), t / "chip_smoke_race.py")
        scripts.append(t / "chip_smoke_race.py")
    keep = REPO / keep
    env = {"CUBLAS_WORKSPACE_CONFIG": ":4096:8", "CHIP_SMOKE_FR": "1",
           "PYTHONFAULTHANDLER": "1", "TORCH_NCCL_TRACE_BUFFER_SIZE": "4000",
           "TORCH_NCCL_ENABLE_TIMING": "1",
           "CHIP_SMOKE_SBN_STEPS": ",".join(map(str, steps))}
    failed = 0
    for i in range(max(counts)):
        for tree, script, count in zip(trees, scripts, counts):
            if i >= count:
                continue
            t0 = time.perf_counter()
            procs, tmp = spawn_workers("--sbn-race-worker", BINDING,
                                       local_size=1, env=env, script=script)
            hung = False
            for at, act in ((dump_s, "dump"), (abort_s, "abort"),
                            (limit_s, "kill")):
                while time.perf_counter() - t0 < at and \
                        any(p.poll() is None for p in procs):
                    time.sleep(0.2)
                if all(p.poll() is not None for p in procs):
                    break
                hung = True
                if act == "dump":
                    (tmp / "dump").write_text("")
                for p in procs:
                    if p.poll() is None and act != "dump":
                        p.send_signal(signal.SIGABRT if act == "abort"
                                      else signal.SIGKILL)
            for p in procs:
                p.wait()
            codes = [p.returncode for p in procs]
            row = {"tree": str(tree), "run": i, "hung": hung, "codes": codes,
                   "s": round(time.perf_counter() - t0, 3)}
            res = [json.loads((tmp / f"rank{r}.json").read_text())
                   if (tmp / f"rank{r}.json").exists() else None
                   for r in range(BINDING)]
            if res[0] is not None:
                row.update({k: round(res[0][k][1], 3)
                            for k in ("resnet_dp", "example_synced")})
            if hung:
                dest = keep / f"{Path(tree).name}_{i:02d}"
                shutil.copytree(tmp, dest, dirs_exist_ok=True)
                row["flight"] = {
                    r: flight_record_summary(tmp / f"fr.{r}.pkl")
                    for r in range(BINDING) if (tmp / f"fr.{r}.pkl").exists()}
            elif codes != [0, 0]:
                failed += 1
                shutil.copytree(tmp, keep / f"{Path(tree).name}_{i:02d}",
                                dirs_exist_ok=True)
            shutil.rmtree(tmp, ignore_errors=True)
            log(json.dumps(row))
    return 1 if failed else 0


def elastic_fault_run(hvd, rank, dev, fault):
    """(k)(1): a small model in ``elastic.run`` with a ``TorchState``,
    ``ELASTIC_BATCHES`` committed batches; with ``fault`` armed alike on
    both ranks at batch 2 (the point is voted). Returns (the batches
    the re-initialized worlds resumed from, the parameters' sha256)."""
    import torch

    from horovod_tpu_torch.common import faults

    gen = torch.Generator().manual_seed(11)
    data = torch.randn(ELASTIC_BATCHES, 2, 16, 256, generator=gen).to(dev)
    torch.manual_seed(3)
    model = torch.nn.Sequential(torch.nn.Linear(256, 256), torch.nn.ReLU(),
                                torch.nn.Linear(256, 10)).to(dev)
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.05, momentum=0.9),
        named_parameters=model.named_parameters())
    state = hvd.elastic.TorchState(model=model, optimizer=opt, batch=0)
    resets = []     # the batch each re-initialized world resumed from
    state.register_reset_callbacks([lambda: resets.append(state.batch)])
    armed = []

    @hvd.elastic.run
    def train(state):
        while state.batch < ELASTIC_BATCHES:
            if state.batch == 2 and not armed:
                hvd.barrier()   # every rank arms between the same responses
                os.environ["HOROVOD_FAULT_SPEC"] = fault
                faults.refresh()
                armed.append(True)
            opt.zero_grad()
            model(data[state.batch, rank]).square().mean().backward()
            opt.step()
            state.batch += 1
            state.commit()
        return state.batch

    batches = train(state)
    hvd.barrier()
    os.environ.pop("HOROVOD_FAULT_SPEC")
    faults.refresh()
    if batches != ELASTIC_BATCHES:
        raise AssertionError(f"(k) elastic run ended at batch {batches}")
    return resets, tensor_digest(list(model.parameters()))


def binding_worker(out_path):
    """One rank of (k) (run as ``chip_smoke.py --binding-worker``; two
    hosts of one rank on cuda:0): the binding's checks, its optimizer
    against the bucketed one, batch norm over the world, the elastic retry
    loop under a fault, and the example at two ranks."""
    import torch

    sys.path.insert(0, str(REPO))
    import horovod_tpu_torch.torch as hvd
    from horovod_tpu_torch.examples import pytorch_synthetic_benchmark as ex

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # The optimizers' comparison and the faulted run against the clean
    # one are bitwise claims across runs: deterministic kernels.
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    hvd.init()
    dev = torch.device("cuda", torch.cuda.current_device())
    rank = hvd.rank()
    out = {"rank": rank, "device": str(dev),
           "checks": binding_checks(hvd, rank, dev),
           "bitwise": binding_resnet_bitwise(hvd, rank, dev),
           "sync_bn": sync_bn_checks(hvd, rank, dev)}
    t0 = time.perf_counter()
    out["faulted"] = elastic_fault_run(hvd, rank, dev, ELASTIC_FAULT)
    out["faulted_s"] = time.perf_counter() - t0
    out["clean"] = elastic_fault_run(hvd, rank, dev, "")
    hvd.shutdown()
    out["example"] = ex.main(["--num-warmup-batches", "1",
                              "--num-batches-per-iter", "1",
                              "--num-iters", "1"])
    Path(out_path).write_text(json.dumps(out))
    return 0


def elastic_worker(out_path):
    """One rank of (k)(2) (run as ``chip_smoke.py --elastic-worker``): a
    model in ``elastic.run`` whose every batch ends in a 64 MiB
    allreduce, or, with ``CHIP_SMOKE_KILL_SYNC_BN=1``, a model of two
    ``SyncBatchNorm`` under a plain optimizer, whose only collectives are
    the batch norms' all-reduces (the same data on every rank), direct
    ones: no named collective runs beside them, so each batch runs in
    ``ops/collectives.direct_world_sums``.
    Rank 1 marks batch ``KILL_READY`` (``ready``); rank 0 writes the time
    it raised ``HorovodInternalError`` (``raised``), and each rank the
    time of its first batch committed in the re-formed world
    (``reformed``). The device is ``CHIP_SMOKE_DEVICE`` (cuda:0 by
    default)."""
    import faulthandler
    import signal
    import traceback

    import torch

    sys.path.insert(0, str(REPO))
    import horovod_tpu_torch.torch as hvd
    from horovod_tpu_torch.ops.collectives import direct_world_sums

    faulthandler.register(signal.SIGUSR1, all_threads=True)
    tmp = Path(out_path).parent
    dev = os.environ.get("CHIP_SMOKE_DEVICE", "cuda:0")
    respawned = os.environ.get("CHIP_SMOKE_RESPAWNED") == "1"
    sync_bn = os.environ.get("CHIP_SMOKE_KILL_SYNC_BN") == "1"
    hvd.init(device=dev)
    rank = hvd.rank()
    torch.manual_seed(rank)   # the ranks differ until state.sync()
    if sync_bn:
        model = torch.nn.Sequential(
            torch.nn.Linear(512, 512), hvd.SyncBatchNorm(512),
            torch.nn.ReLU(), torch.nn.Linear(512, 512),
            hvd.SyncBatchNorm(512)).to(dev)
        opt = torch.optim.SGD(model.parameters(), lr=0.01)
    else:
        model = torch.nn.Linear(512, 512).to(dev)
        opt = hvd.DistributedOptimizer(
            torch.optim.SGD(model.parameters(), lr=0.01),
            named_parameters=model.named_parameters())
    state = hvd.elastic.TorchState(model=model, optimizer=opt, batch=0)
    big = torch.ones(1 << 24, device=dev)
    resets, raised_in = [], []

    @hvd.elastic.run
    def train(state):
        while state.batch < KILL_TARGET:
            try:
                opt.zero_grad()
                if sync_bn:
                    time.sleep(0.02)    # rank 1's kill lands between batches
                    x = torch.randn(
                        64, 512, generator=torch.Generator().manual_seed(
                            state.batch)).to(dev)
                    with direct_world_sums():
                        model(x).square().mean().backward()
                    opt.step()
                else:
                    model(torch.ones(8, 512, device=dev)).sum().backward()
                    opt.step()
                    hvd.allreduce(big, name=f"big.{state.batch}")
                state.batch += 1
                state.commit()
                mark = tmp / f"reformed.{rank}"
                if (resets or respawned) and not mark.exists():
                    mark.write_text(repr(time.time()))
            except hvd.HorovodInternalError as e:
                resets.append(state.batch)
                raised_in.append(sorted({
                    Path(f.filename).name
                    for f in traceback.extract_tb(e.__traceback__)}))
                (tmp / f"raised.{rank}").write_text(repr(time.time()))
                raise
            if rank == 1 and not respawned and state.batch == KILL_READY:
                (tmp / "ready").write_text("1")
        return state.batch

    batches = train(state)
    from horovod_tpu_torch.common import state as hstate

    out = {"rank": rank, "batches": batches, "respawned": respawned,
           "resets": resets, "raised_in": raised_in,
           "digest": tensor_digest(list(model.parameters())),
           "aborts": hstate.abort_report(),
           "teardown": hstate.teardown_report()}
    hvd.shutdown()
    Path(out_path).write_text(json.dumps(out))
    return 0


def kill_and_respawn(n, env, timeout_s, bound_s=KILL_BOUND_S,
                     reform_bound_s=REFORM_BOUND_S):
    """(k)(2)'s driver: ``n`` ``--elastic-worker`` ranks; once rank 1
    marks ``ready``, SIGKILL it and time rank 0's ``raised`` mark (a
    failure past ``bound_s``: the survivor hung), then start rank 1 again
    with the same rank and time rank 0's ``reformed`` mark (a failure past
    ``reform_bound_s`` from the kill). Returns (seconds from the kill to
    the raise, from the kill to the re-formed world, each rank's result).
    Every process is stopped before it returns."""
    import signal

    from horovod_tpu_torch.common.config import free_port_pair

    port = free_port_pair()
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_kill_"))

    def spawn(r, extra=None):
        renv = dict(os.environ, **env, **(extra or {}), HOROVOD_RANK=str(r),
                    HOROVOD_SIZE=str(n), HOROVOD_LOCAL_RANK="0",
                    HOROVOD_LOCAL_SIZE="1", HOROVOD_CROSS_RANK=str(r),
                    HOROVOD_CROSS_SIZE=str(n),
                    HOROVOD_CONTROLLER_ADDR="127.0.0.1",
                    HOROVOD_CONTROLLER_PORT=str(port),
                    NCCL_HOSTID=f"chip-smoke-rank{r}",
                    NCCL_IB_DISABLE="1", NCCL_SOCKET_IFNAME="lo")
        logf = open(tmp / f"log{r}.txt", "a")
        return subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()),
             "--elastic-worker", str(tmp / f"rank{r}.json")], env=renv,
            stdout=logf, stderr=subprocess.STDOUT)

    procs = [spawn(r) for r in range(n)]
    t0 = time.perf_counter()

    def dump_stacks():
        for p in procs:                 # each thread's stack to its log
            if p.poll() is None:
                p.send_signal(signal.SIGUSR1)
        time.sleep(1.0)

    def wait_for(path, limit, what, running):
        while not path.exists():
            if time.perf_counter() > limit:
                dump_stacks()
                raise AssertionError(f"(k) timed out waiting for {what}")
            if any(p.poll() is not None for p in running):
                raise AssertionError(f"(k) a worker exited "
                                     f"{[p.poll() for p in procs]} before "
                                     f"{what}")
            time.sleep(0.01)

    ended = False
    try:
        wait_for(tmp / "ready", t0 + timeout_s, "rank 1's batches", procs)
        time.sleep(0.2)
        t_kill = time.time()
        procs[1].send_signal(signal.SIGKILL)
        procs[1].wait()
        wait_for(tmp / "raised.0", time.perf_counter() + bound_s,
                 f"rank 0 to raise within {bound_s} s of the kill",
                 procs[:1])
        kill_to_raise = float((tmp / "raised.0").read_text()) - t_kill
        procs[1] = spawn(1, {"CHIP_SMOKE_RESPAWNED": "1"})
        wait_for(tmp / "reformed.0",
                 time.perf_counter() + reform_bound_s - (time.time() - t_kill),
                 f"the world to re-form within {reform_bound_s} s of the "
                 f"kill", procs)
        kill_to_reform = float((tmp / "reformed.0").read_text()) - t_kill
        for p in procs:
            try:
                p.wait(timeout=max(1.0,
                                   timeout_s - (time.perf_counter() - t0)))
            except subprocess.TimeoutExpired:
                dump_stacks()
                raise
        ended = True
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        ended = ended and all(p.returncode == 0 for p in procs)
        for r in range(n):
            lines = (tmp / f"log{r}.txt").read_text().splitlines()
            for line in lines:
                log(f"    [rank {r}] {line}")
            if not ended:   # the end of each log beside the error
                for line in [x for x in lines
                             if not x.startswith("frame #")][-KILL_LOG_TAIL:]:
                    print(f"    [rank {r}] {line}", file=sys.stderr,
                          flush=True)
    codes = [p.returncode for p in procs]
    if codes != [0] * n:
        raise AssertionError(f"(k) elastic workers exited {codes}")
    res = [json.loads((tmp / f"rank{r}.json").read_text()) for r in range(n)]
    shutil.rmtree(tmp, ignore_errors=True)
    return kill_to_raise, kill_to_reform, res


def binding_phase(gpu):
    """(k): the binding's checks and batch norm over the world with two
    ranks on cuda:0, the elastic retry loop under a fault, a SIGKILLed rank
    and its replacement, and the example at one rank on the card."""
    import torch

    from horovod_tpu_torch.examples import pytorch_synthetic_benchmark as ex

    from concurrent.futures import ThreadPoolExecutor

    t0 = time.perf_counter()
    env = {"CUBLAS_WORKSPACE_CONFIG": ":4096:8"}
    # The batch-norm race runs beside the binding's pair (a world of its
    # own on the card; both are correctness runs, so the second world
    # only adds load) and must end, unhung, before the kill runs.
    with ThreadPoolExecutor(1) as pool:
        race = pool.submit(sbn_race_phase, gpu)
        # Two hosts of one rank: each rank's local rank is 0, so the
        # example's torch.cuda.set_device(hvd.local_rank()) takes the
        # one card.
        res = run_workers("--binding-worker", BINDING, BINDING_TIMEOUT_S,
                          local_size=1, env=env)
        race.result()
    for r in res:
        log(f"    rank {r['rank']} on {r['device']}: {len(r['checks'])} "
            f"binding checks passed: {', '.join(r['checks'])}")
        (_, n_b, d_b), (_, n_u, d_u) = r["bitwise"]
        log(f"    rank {r['rank']} ResNet-50 ({n_b} parameters): the "
            f"binding's DistributedOptimizer {[d[:12] for d in d_b]}, the "
            f"bucketed one {[d[:12] for d in d_u]}")
        if n_b != RESNET50_TENSORS or d_b != d_u:
            raise AssertionError(f"(k) rank {r['rank']}: the binding's "
                                 f"optimizer is not bitwise the bucketed "
                                 f"one")
        s = r["sync_bn"]
        log(f"    rank {r['rank']} SyncBatchNorm against BatchNorm2d over "
            f"the world's batch: forward {s['sbn_forward']:.2e} (limit "
            f"1e-4), running mean {s['sbn_mean']:.2e} (1e-5), running "
            f"variance {s['sbn_var']:.2e} (1e-4)")
        if not (s["sbn_forward"] <= 1e-4 and s["sbn_mean"] <= 1e-5 and
                s["sbn_var"] <= 1e-4):
            raise AssertionError(f"(k) rank {r['rank']}: SyncBatchNorm")
        for key in ("resnet_dp", "resnet_None", "example_local",
                    "example_synced", "example_negotiated"):
            losses, ms = s[key]
            log(f"    rank {r['rank']} {key}: losses "
                f"{[round(x, 4) for x in losses]}, {ms:.2f} ms a step "
                f"({SBN_STEPS[1]} timed, two ranks on one card) on {gpu}")
            if not all(math.isfinite(x) for x in losses):
                raise AssertionError(f"(k) {key}: a loss is not finite")
        for key in ("faulted", "clean"):
            log(f"    rank {r['rank']} elastic {key}: re-initialized at "
                f"batches {r[key][0]}, parameters {r[key][1][:12]}")
        if not r["faulted"][0] or r["clean"][0] or \
                r["faulted"][1] != r["clean"][1]:
            raise AssertionError(f"(k) rank {r['rank']}: the faulted elastic "
                                 f"run is not the clean one")
        log(f"    rank {r['rank']} the faulted run took "
            f"{r['faulted_s']:.2f} s; the example at two ranks "
            f"{[round(x, 1) for x in r['example']]} img/s a device")
    if res[0]["faulted"][1] != res[1]["faulted"][1]:
        raise AssertionError("(k) the ranks' elastic parameters differ")
    for key in ("resnet_dp", "resnet_None"):
        if res[0]["sync_bn"][key][0] != res[1]["sync_bn"][key][0]:
            raise AssertionError(f"(k) {key}: the ranks' losses differ")
    # An elastic job in a fixed world sets what HOROVOD_ELASTIC sets for
    # the groups init makes: torch's watchdog leaves a lost rank to the
    # binding's watch.
    from horovod_tpu_torch.common.state import ELASTIC_NCCL_ENV

    kill_env = dict(env, **ELASTIC_NCCL_ENV)
    for what, extra in (("inside the 64 MiB allreduces", {}),
                        ("between SyncBatchNorm batches",
                         {"CHIP_SMOKE_KILL_SYNC_BN": "1"})):
        t1 = time.perf_counter()
        kill_to_raise, kill_to_reform, kres = kill_and_respawn(
            BINDING, dict(kill_env, **extra), BINDING_TIMEOUT_S)
        log(f"    SIGKILL of rank 1 {what}: rank 0 raised "
            f"HorovodInternalError {kill_to_raise:.3f} s after it (bound "
            f"{KILL_BOUND_S} s); the respawned rank 1 rejoined and the "
            f"re-formed world committed a batch {kill_to_reform:.3f} s "
            f"after the kill (bound {REFORM_BOUND_S} s); "
            f"{time.perf_counter() - t1:.1f} s in all on {gpu}")
        for r in kres:
            log(f"    rank {r['rank']} (respawned {r['respawned']}): "
                f"{r['batches']} batches, reset at {r['resets']} (raised "
                f"through {r['raised_in']}), parameters {r['digest'][:12]}; "
                f"group aborts {abort_text(r['aborts'])}; the lost world's "
                f"teardown, off the re-init's path, "
                f"{abort_text(r['teardown'])}")
        if not (kres[0]["resets"] and kres[1]["respawned"] and
                kres[0]["batches"] == kres[1]["batches"] == KILL_TARGET and
                kres[0]["digest"] == kres[1]["digest"]):
            raise AssertionError(f"(k) the world did not re-form after the "
                                 f"kill {what}")
    torch.cuda.empty_cache()
    img = ex.main(["--num-warmup-batches", "2", "--num-batches-per-iter",
                   "5", "--num-iters", "3"])
    log(f"    pytorch_synthetic_benchmark at one rank (ResNet-50, fp32, "
        f"batch 32, 224 px): {[round(x, 1) for x in img]} img/s, mean "
        f"{sum(img) / len(img):.1f} img/s a device on {gpu}")
    log(f"    (k) took {time.perf_counter() - t0:.1f} s")


# ---- (l) the launcher and the elastic driver --------------------------------

LAUNCH_HOSTS = "localhost:1,127.0.0.1:1"     # two hosts of one slot
# Each slot's own NCCL host id, so NCCL lets two ranks share the card: the
# launcher gives both slots one environment, and a list command runs
# without a shell, so the worker command carries its own.
NCCL_HOST_WRAP = ["sh", "-c",
                  'NCCL_HOSTID=chip-smoke-$HOROVOD_HOSTNAME exec "$0" "$@"']
# Unbuffered: a job that fails while it runs shows its output's end.
LAUNCH_ENV = {"NCCL_IB_DISABLE": "1", "NCCL_SOCKET_IFNAME": "lo",
              "CUBLAS_WORKSPACE_CONFIG": ":4096:8", "PYTHONUNBUFFERED": "1"}
HANG_HEARTBEAT_MS, HANG_TIMEOUT_MS = 100, 2000
# The survivor raises within this many seconds of its peer's SIGSTOP with
# heartbeats armed: the liveness timeout, then the communicators' abort.
HANG_BOUND_S = HANG_TIMEOUT_MS / 1000 + 3.0
# (l): the survivor of the stall-only job (no heartbeats,
# HOROVOD_STALL_SHUTDOWN_TIME_SECONDS=2) raises within this many seconds
# of its peer's SIGSTOP: the coordinator's gather runs the stall inspector
# while the stopped rank's frame is missing, and its shutdown window
# ends the world as lost. 2.009 s on an NVIDIA H100 80GB HBM3 at 700 W
# (PERF.md): the window, a 0.1 s check, the watch's 10 ms read and the
# groups' aborts (0.935 s at most in 28 kill runs), with a second spare.
STALL_SHUTDOWN_S = 2
STALL_BOUND_S = 4.0
LAUNCH_KILL_AT, LAUNCH_STOP_AT, LAUNCH_TARGET = 5, 12, 18
LAUNCH_TIMEOUT_S = 240
LAUNCH_LOG_TAIL = 40


def launcher_worker(tmp):
    """A worker of (l)'s elastic jobs (``chip_smoke.py --launcher-worker
    DIR``, started by ``python -m horovod_tpu_torch.run``): (k)'s 256-wide
    MLP under ``DistributedOptimizer`` in ``elastic.run``, each batch
    ending in a 64 MiB allreduce, ``LAUNCH_TARGET`` batches, on
    ``CHIP_SMOKE_DEVICE`` (``cuda:<local rank>`` by default). Rank 1
    SIGKILLs itself after batch ``LAUNCH_KILL_AT`` and SIGSTOPs itself
    after batch ``LAUNCH_STOP_AT``, each once (a marker file stops its
    successor; ``CHIP_SMOKE_FAULTS`` names the faults and
    ``CHIP_SMOKE_STOP_AT`` moves the stop). Every batch, fault and raise
    is a line of ``DIR/events`` with its time; the final parameters'
    sha256 goes to ``DIR/final.<rank>``."""
    import signal

    import torch

    sys.path.insert(0, str(REPO))
    import horovod_tpu_torch.torch as hvd

    tmp = Path(tmp)
    (tmp / f"pid.{os.getpid()}").write_text("")
    faults = os.environ.get("CHIP_SMOKE_FAULTS", "kill,stop").split(",")
    stop_at = int(os.environ.get("CHIP_SMOKE_STOP_AT", LAUNCH_STOP_AT))

    def event(text):
        with open(tmp / "events", "a") as f:
            f.write(f"{text} {time.time()!r}\n")

    dev = os.environ.get("CHIP_SMOKE_DEVICE")   # cuda:<local rank> if unset
    hvd.init(device=dev)
    dev = torch.device(dev or f"cuda:{hvd.local_rank()}")
    torch.manual_seed(3)
    model = torch.nn.Sequential(torch.nn.Linear(256, 256), torch.nn.ReLU(),
                                torch.nn.Linear(256, 10)).to(dev)
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.05, momentum=0.9),
        named_parameters=model.named_parameters())
    state = hvd.elastic.TorchState(model=model, optimizer=opt, batch=0)
    big = torch.ones(1 << 24, device=dev)

    @hvd.elastic.run
    def train(state):
        while state.batch < LAUNCH_TARGET:
            rank = hvd.rank()
            try:
                gen = torch.Generator().manual_seed(1000 * state.batch + rank)
                opt.zero_grad()
                model(torch.randn(16, 256, generator=gen).to(dev)
                      ).square().mean().backward()
                opt.step()
                hvd.allreduce(big, name=f"big.{state.batch}")
            except hvd.HorovodInternalError:
                event(f"raised {rank}")
                raise
            state.batch += 1
            event(f"batch {state.batch} rank {rank} size {hvd.size()}")
            state.commit()
            for kind, at, sig in (("kill", LAUNCH_KILL_AT, signal.SIGKILL),
                                  ("stop", stop_at, signal.SIGSTOP)):
                if rank == 1 and kind in faults and state.batch == at and \
                        not (tmp / kind).exists():
                    (tmp / kind).write_text("")
                    event(f"fault {kind}")
                    os.kill(os.getpid(), sig)
        return state.batch

    batches = train(state)
    (tmp / f"final.{hvd.rank()}").write_text(json.dumps({
        "batches": batches, "size": hvd.size(),
        "digest": tensor_digest(list(model.parameters()))}))
    hvd.shutdown()
    return 0


class LaunchedJob:
    """``python -m horovod_tpu_torch.run ARGV`` in a session of its own,
    its output in ``DIR/launcher.out``. ``stop()`` ends the launcher and
    every worker that wrote its pid into ``DIR``."""

    def __init__(self, name, argv, env, phase="(l)"):
        self.name, self.phase = name, phase
        self.tmp = Path(tempfile.mkdtemp(prefix=f"chip_smoke_{name}_"))
        self.out = self.tmp / "launcher.out"
        discover = self.tmp / "discover.sh"
        discover.write_text("#!/bin/sh\n" + "".join(
            f"echo {h}\n" for h in LAUNCH_HOSTS.split(",")))
        discover.chmod(0o755)
        argv = [a.replace("{tmp}", str(self.tmp)) for a in argv]
        with open(self.out, "w") as f:
            self.proc = subprocess.Popen(
                [sys.executable, "-m", "horovod_tpu_torch.run", *argv],
                env=dict(os.environ, **LAUNCH_ENV, **env,
                         PYTHONPATH=str(REPO)),
                cwd=str(REPO), stdout=f, stderr=subprocess.STDOUT,
                start_new_session=True)
        self.t0 = time.perf_counter()

    def wait(self, timeout_s):
        try:
            return self.proc.wait(timeout=max(
                1.0, timeout_s - (time.perf_counter() - self.t0)))
        except subprocess.TimeoutExpired:
            return None

    def events(self):
        """Each line of the workers' ``events`` as (words, time)."""
        path = self.tmp / "events"
        if not path.exists():
            return []
        out = []
        for line in path.read_text().splitlines():
            *words, t = line.split()
            out.append((words, float(t)))
        return out

    def stop(self):
        import signal

        for pid in [p.name.split(".", 1)[1] for p in self.tmp.glob("pid.*")]:
            try:
                os.kill(int(pid), signal.SIGKILL)
            except OSError:
                pass
        if self.proc.poll() is None:
            os.killpg(self.proc.pid, signal.SIGKILL)
            self.proc.wait()

    def fail(self, why):
        """Raise ``why`` with the end of the launcher's output on stderr."""
        lines = [x for x in self.out.read_text().splitlines()
                 if not x.startswith("frame #")]
        for line in lines[-LAUNCH_LOG_TAIL:]:
            print(f"    [{self.name}] {line}", file=sys.stderr, flush=True)
        raise AssertionError(f"{self.phase} {self.name}: {why}")

    def log_output(self, keep=None):
        for line in self.out.read_text().splitlines():
            if keep is None or keep(line):
                log(f"    [{self.name}] {line}")


def first_after(events, t, pred):
    return next((te for w, te in events if te > t and pred(w)), None)


def launcher_phase(gpu):
    """(l): ``python -m horovod_tpu_torch.run`` on the card. Its
    ``--check-build --verbose``; a static job of the example at two ranks;
    a stall-only elastic job with rank 1 SIGSTOPped (rank 0 raising
    within ``STALL_BOUND_S``, beside the static job); then the elastic job with
    heartbeats: rank 1 SIGKILLed, then SIGSTOPped, and respawned both
    times."""
    import torch

    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    # (1) the capability report, the card probe included; it runs beside
    # the first two jobs' start.
    check = subprocess.Popen(
        [sys.executable, "-m", "horovod_tpu_torch.run", "--check-build",
         "--verbose"], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, cwd=str(REPO), env=dict(os.environ, PYTHONPATH=str(REPO)))
    worker = [*NCCL_HOST_WRAP, sys.executable, str(Path(__file__).resolve()),
              "--launcher-worker", "{tmp}"]
    discover = ["--host-discovery-script", "{tmp}/discover.sh"]
    # (2) the stall-only job: no heartbeats, the stall inspector armed.
    stall = LaunchedJob("stall", ["-np", "2", "--min-np", "2", *discover,
                                  "--blacklist-cooldown-range", "1", "1",
                                  *worker],
                        {"CHIP_SMOKE_FAULTS": "stop", "CHIP_SMOKE_STOP_AT": "3",
                         "HOROVOD_STALL_CHECK_TIME_SECONDS": "1",
                         "HOROVOD_STALL_SHUTDOWN_TIME_SECONDS":
                             str(STALL_SHUTDOWN_S)})
    jobs = [stall]
    try:
        # (3) the static job: the example at two ranks, full width.
        t1 = time.perf_counter()
        static = LaunchedJob(
            "static", ["-np", "2", "-H", LAUNCH_HOSTS, *NCCL_HOST_WRAP,
                       sys.executable, "-m",
                       "horovod_tpu_torch.examples.pytorch_synthetic_benchmark",
                       "--num-warmup-batches", "1", "--num-batches-per-iter",
                       "2", "--num-iters", "2"], {})
        jobs.append(static)
        try:
            out, err = check.communicate(timeout=180)
        finally:
            if check.poll() is None:
                check.kill()
                check.wait()
        for line in out.splitlines():
            log(f"    [check-build] {line}")
        name = torch.cuda.get_device_name(0)
        if check.returncode != 0 or f"COMPUTE={name}" not in out or \
                not re.search(r"^NCCL=\d+\.\d+", out, re.M) or \
                not re.search(r"\[X\] Hopper flash attention.*built: "
                              r"flash_attention", out):
            raise AssertionError(f"(l) --check-build --verbose exited "
                                 f"{check.returncode} without naming the "
                                 f"card, NCCL or the built kernels: "
                                 f"{err[-2000:]}")
        log(f"    check-build took {time.perf_counter() - t0:.1f} s")
        code = static.wait(LAUNCH_TIMEOUT_S)
        static.log_output(lambda x: "img/sec" in x or "Model:" in x
                          or "Iter" in x)
        if code != 0:
            static.fail(f"the static job exited {code}")
        out = static.out.read_text()
        per_dev = re.search(r"Img/sec per device: ([\d.]+)", out)
        log(f"    static job: both ranks exited 0; {per_dev.group(1)} img/s "
            f"a device (ResNet-50, fp32, batch 32, 224 px, 1 + 2 x 2 "
            f"batches; two ranks on one card beside the stall-only job, a "
            f"correctness run) in {time.perf_counter() - t1:.1f} s on {gpu}")
        # The stall-only job: rank 0 must raise within STALL_BOUND_S of
        # the stop.
        deadline = time.perf_counter() + LAUNCH_TIMEOUT_S
        while not any(w == ["fault", "stop"] for w, _ in stall.events()):
            if time.perf_counter() > deadline or stall.proc.poll() is not None:
                stall.fail("rank 1 never stopped")
            time.sleep(0.1)
        t_stop = next(t for w, t in stall.events() if w == ["fault", "stop"])

        def stall_raise():
            return first_after(stall.events(), t_stop,
                               lambda w: w == ["raised", "0"])

        while stall_raise() is None and time.time() < t_stop + STALL_BOUND_S:
            time.sleep(0.05)
        raised = stall_raise()
        log(f"    SIGSTOP of rank 1 with only the stall inspector "
            f"(HOROVOD_STALL_CHECK_TIME_SECONDS=1, "
            f"HOROVOD_STALL_SHUTDOWN_TIME_SECONDS={STALL_SHUTDOWN_S}): "
            + (f"rank 0 raised {raised - t_stop:.3f} s after it"
               if raised else f"no raise within {time.time() - t_stop:.1f} s")
            + f" (bound {STALL_BOUND_S} s) on {gpu}")
        if raised is None or raised - t_stop > STALL_BOUND_S:
            stall.fail(f"rank 0 did not raise within {STALL_BOUND_S} s of "
                       f"the SIGSTOP")
        stall.stop()
        # (4) the elastic job with heartbeats: a SIGKILL, then a SIGSTOP.
        t2 = time.perf_counter()
        job = LaunchedJob("elastic", ["-np", "2", "--min-np", "2", *discover,
                                      "--blacklist-cooldown-range", "1", "1",
                                      *worker],
                          {"HOROVOD_HEARTBEAT_MS": str(HANG_HEARTBEAT_MS),
                           "HOROVOD_LIVENESS_TIMEOUT_MS":
                               str(HANG_TIMEOUT_MS)})
        jobs.append(job)
        code = job.wait(LAUNCH_TIMEOUT_S)
        job.log_output(lambda x: "elastic:" in x or "liveness" in x)
        if code != 0:
            job.fail(f"the elastic job exited {code}")
        events = job.events()
        finals = [json.loads((job.tmp / f"final.{r}").read_text())
                  for r in range(2)]
        times = {}
        for kind in ("kill", "stop"):
            t_fault = next((t for w, t in events if w == ["fault", kind]),
                           None)
            if t_fault is None:
                job.fail(f"rank 1's {kind} never fired")
            raised = first_after(events, t_fault, lambda w: w == ["raised",
                                                                  "0"])
            reformed = first_after(events, t_fault,
                                   lambda w: w[:1] == ["batch"] and
                                   w[3] == "1" and w[5] == "2")
            if raised is None or reformed is None:
                job.fail(f"no raise or re-formed world after the {kind}")
            times[kind] = (raised - t_fault, reformed - t_fault)
            log(f"    SIG{kind.upper()} of rank 1 after its batch "
                f"{LAUNCH_KILL_AT if kind == 'kill' else LAUNCH_STOP_AT}: "
                f"rank 0 raised {times[kind][0]:.3f} s after it, the "
                f"respawned rank 1's first batch in the re-formed world "
                f"{times[kind][1]:.3f} s after it "
                f"(HOROVOD_HEARTBEAT_MS={HANG_HEARTBEAT_MS}, "
                f"HOROVOD_LIVENESS_TIMEOUT_MS={HANG_TIMEOUT_MS}) on {gpu}")
        log(f"    final state: {[f['digest'][:12] for f in finals]} after "
            f"{[f['batches'] for f in finals]} batches at size "
            f"{finals[0]['size']}; the elastic job took "
            f"{time.perf_counter() - t2:.1f} s")
        if times["stop"][0] > HANG_BOUND_S:
            job.fail(f"rank 0 raised {times['stop'][0]:.3f} s after the "
                     f"SIGSTOP, past the bound of {HANG_BOUND_S} s")
        if "EVICTED after" not in job.out.read_text():
            job.fail("the driver did not evict the stopped worker")
        if not (finals[0]["digest"] == finals[1]["digest"] and
                finals[0]["batches"] == finals[1]["batches"] ==
                LAUNCH_TARGET and finals[0]["size"] == 2):
            job.fail("the ranks' final states differ")
    finally:
        for j in jobs:
            j.stop()
    for j in jobs:
        shutil.rmtree(j.tmp, ignore_errors=True)
    log(f"    (l) took {time.perf_counter() - t0:.1f} s")


TF_TIMEOUT_S = 300
TF_STAGE_THRESHOLD = 1024   # HOROVOD_HOST_VIA_XLA_THRESHOLD of (m)'s staged job
TF_MLP_BATCH = 64           # the MLP's joined batch, split over the ranks


def tf_worker(tmp):
    """One rank of (m)'s jobs (``chip_smoke.py --tf-worker DIR``, started by
    ``python -m horovod_tpu_torch.run``): ``horovod_tpu_torch.tensorflow``
    on inputs every rank draws from the same seeds, each collective held
    to numpy (allreduce Sum, Average, Min, Max, fp16 compression and
    IndexedSlices; a ragged allgather and a broadcast from rank 1, with
    their gradients), then one ``DistributedGradientTape`` step of a
    256-wide MLP on this rank's share of a batch, held to the step of a
    world of one on the joined batch. Writes ``DIR/tf.<rank>.json``: the
    largest error of each check, whether the native ops ran, and the
    responses host staging carried. ``CHIP_SMOKE_DEVICE=cpu`` stages on
    gloo (a rehearsal without a card)."""
    import numpy as np
    import tensorflow as tf

    sys.path.insert(0, str(REPO))
    import horovod_tpu_torch.tensorflow as hvd
    from horovod_tpu_torch.common import host_world
    from horovod_tpu_torch.tensorflow.mpi_ops import _kernels

    tmp = Path(tmp)
    (tmp / f"pid.{os.getpid()}").write_text("")
    if os.environ.get("CHIP_SMOKE_DEVICE") == "cpu":
        host_world.world().init(device="cpu")
    hvd.init()
    rank, size = hvd.rank(), hvd.size()
    errs = {}

    def check(name, got, want, tol=0.0):
        got, want = np.asarray(got), np.asarray(want)
        if got.shape != want.shape:
            raise AssertionError(f"(m) {name}: shape {got.shape}, expected "
                                 f"{want.shape}")
        scale = max(1.0, float(np.max(np.abs(want)))) if want.size else 1.0
        err = float(np.max(np.abs(got.astype(np.float64) - want))) / scale \
            if want.size else 0.0
        if not err <= tol:
            raise AssertionError(f"(m) {name}: error {err:.3e} past {tol}")
        errs[name] = err

    rngs = [np.random.RandomState(100 + r) for r in range(size)]
    xs = np.stack([g.standard_normal(1 << 16).astype(np.float32)
                   for g in rngs])                    # 256 KiB a rank
    x = tf.constant(xs[rank])
    check("sum", hvd.allreduce(x, op=hvd.Sum), xs.astype(np.float64).sum(0),
          1e-6)
    check("average", hvd.allreduce(x, op=hvd.Average),
          xs.astype(np.float64).mean(0), 1e-6)
    check("min", hvd.allreduce(x, op=hvd.Min), xs.min(0))
    check("max", hvd.allreduce(x, op=hvd.Max), xs.max(0))
    halves = xs.astype(np.float16)
    check("fp16", hvd.allreduce(x, op=hvd.Average,
                                compression=hvd.Compression.fp16),
          (halves.sum(0, dtype=np.float32) / size).astype(np.float16), 1e-3)
    vals = [g.standard_normal((3, 8)).astype(np.float32) for g in rngs]
    idx = [np.asarray([r, r + size, 2 * size], np.int64) for r in range(size)]
    out = hvd.allreduce(tf.IndexedSlices(tf.constant(vals[rank]),
                                         tf.constant(idx[rank]),
                                         dense_shape=[2 * size + 1, 8]),
                        op=hvd.Average)
    check("slices.values", out.values, np.concatenate(vals) / size, 1e-6)
    check("slices.indices", out.indices, np.concatenate(idx))
    rows = [g.standard_normal(((r + 1) * 300, 8)).astype(np.float32)
            for r, g in enumerate(rngs)]
    w = np.random.RandomState(7).standard_normal(
        (sum(len(r) for r in rows), 8)).astype(np.float32)
    a = tf.Variable(rows[rank])
    with tf.GradientTape() as tape:
        gathered = hvd.allgather(a, name="m.ragged")
        loss = tf.reduce_sum(gathered * w)
    check("allgather", gathered, np.concatenate(rows))
    offset = sum(len(r) for r in rows[:rank])
    check("allgather.grad", tape.gradient(loss, a),
          size * w[offset:offset + len(rows[rank])], 1e-6)
    c = np.random.RandomState(8).standard_normal(1 << 16).astype(np.float32)
    b = tf.Variable(xs[rank])
    with tf.GradientTape() as tape:
        got = hvd.broadcast(b, root_rank=1, name="m.bcast")
        loss = tf.reduce_sum(got * c)
    check("broadcast", got, xs[1])
    check("broadcast.grad", tape.gradient(loss, b),
          size * c if rank == 1 else np.zeros_like(c), 1e-6)
    # One DistributedGradientTape step of a 256-wide MLP on this rank's
    # share of the batch, against a world of one's on the whole batch.
    g = np.random.RandomState(9)
    init = [g.standard_normal((64, 256)).astype(np.float32) / 8,
            np.zeros(256, np.float32),
            g.standard_normal((256, 10)).astype(np.float32) / 16,
            np.zeros(10, np.float32)]
    data = g.standard_normal((TF_MLP_BATCH, 64)).astype(np.float32)
    labels = g.randint(0, 10, TF_MLP_BATCH)
    share = TF_MLP_BATCH // size

    def mlp_loss(params, xb, yb):
        h = tf.nn.relu(xb @ params[0] + params[1])
        return tf.reduce_mean(tf.nn.sparse_softmax_cross_entropy_with_logits(
            labels=yb, logits=h @ params[2] + params[3]))

    dist_params = [tf.Variable(v) for v in init]
    ref_params = [tf.Variable(v) for v in init]
    mine = slice(rank * share, (rank + 1) * share)
    with tf.GradientTape() as tape:
        loss = mlp_loss(dist_params, data[mine], labels[mine])
    grads = hvd.DistributedGradientTape(tape).gradient(loss, dist_params)
    with tf.GradientTape() as tape:
        loss = mlp_loss(ref_params, data, labels)
    ref_grads = tape.gradient(loss, ref_params)
    for i, (p, q, gp, gq) in enumerate(zip(dist_params, ref_params, grads,
                                            ref_grads)):
        check(f"mlp.grad{i}", gp, gq.numpy(), 1e-5)
        p.assign_sub(0.1 * gp)
        q.assign_sub(0.1 * gq)
        check(f"mlp.param{i}", p, q.numpy(), 1e-5)
    staging = host_world.world().staging
    result = {"rank": rank, "size": size, "errors": errs,
              "native": _kernels() is not None,
              "staged": len(staging.staged) if staging else 0,
              "tf": tf.__version__}
    hvd.shutdown()
    (tmp / f"tf.{rank}.json").write_text(json.dumps(result))
    return 0


def tf_keras_phase(gpu):
    """(m): the TF and Keras bindings, where TensorFlow and Keras are
    installed (a probe; nothing is installed for it). The port's TF op
    library built from the checkout; (m)'s checks at two ranks under the
    launcher on the host ring and again staged through NCCL
    (``HOROVOD_HOST_VIA_XLA=1``); ``keras_mnist`` at two ranks for a few
    batches. The three jobs run at once."""
    import importlib.util

    missing = [m for m in ("tensorflow", "keras")
               if importlib.util.find_spec(m) is None]
    if missing:
        log(f"    (m) tf/keras: {' and '.join(missing)} not installed on "
            f"this machine; phase not run")
        return
    t0 = time.perf_counter()
    built = subprocess.run(
        [sys.executable, "-c",
         "import tensorflow as tf\n"
         "from horovod_tpu_torch.tensorflow import native_ops\n"
         "print(native_ops.build(), tf.__version__)"],
        cwd=str(REPO), env=dict(os.environ, PYTHONPATH=str(REPO)),
        capture_output=True, text=True, timeout=900)
    if built.returncode != 0:
        raise AssertionError(f"(m) the TF op library did not build: "
                             f"{built.stderr[-3000:]}")
    path, version = built.stdout.split()[-2:]
    log(f"    built {Path(path).relative_to(REPO)} against TensorFlow "
        f"{version} in {time.perf_counter() - t0:.1f} s")
    worker = [*NCCL_HOST_WRAP, sys.executable, str(Path(__file__).resolve()),
              "--tf-worker", "{tmp}"]
    hosts = ["-np", "2", "-H", LAUNCH_HOSTS]
    jobs = [LaunchedJob("tf_ring", hosts + worker, {}, phase="(m)"),
            LaunchedJob("tf_staged", hosts + worker,
                        {"HOROVOD_HOST_VIA_XLA": "1",
                         "HOROVOD_HOST_VIA_XLA_THRESHOLD":
                             str(TF_STAGE_THRESHOLD)}, phase="(m)"),
            LaunchedJob("keras_mnist", hosts + [
                *NCCL_HOST_WRAP, sys.executable, "-m",
                "horovod_tpu_torch.examples.keras_mnist", "--epochs", "1",
                "--batch-size", "1024", "--checkpoint-dir", "{tmp}"], {},
                phase="(m)")]
    try:
        for job in jobs:
            code = job.wait(TF_TIMEOUT_S)
            if code != 0:
                job.fail(f"exited {code}")
        for job in jobs[:2]:
            results = [json.loads((job.tmp / f"tf.{r}.json").read_text())
                       for r in range(2)]
            worst = {k: max(r["errors"][k] for r in results)
                     for k in results[0]["errors"]}
            staged = [r["staged"] for r in results]
            if not all(r["native"] for r in results):
                job.fail("the native TF ops did not run")
            if (job.name == "tf_staged") != all(n > 0 for n in staged):
                job.fail(f"staged responses {staged}")
            log(f"    {job.name}: every check within its tolerance; largest "
                f"errors {json.dumps(worst)}; staged responses {staged}; "
                f"TensorFlow {results[0]['tf']} on {gpu}")
        out = jobs[2].out.read_text()
        score = re.search(r"loss=(\S+) accuracy=(\S+)", out)
        if score is None or not math.isfinite(float(score.group(1))):
            jobs[2].fail("no finite loss line")
        log(f"    keras_mnist at two ranks (1 epoch, batch 1024 a rank): "
            f"{score.group(0)} in {time.perf_counter() - jobs[2].t0:.1f} s")
    finally:
        for job in jobs:
            job.stop()
    for job in jobs:
        shutil.rmtree(job.tmp, ignore_errors=True)
    log(f"    (m) took {time.perf_counter() - t0:.1f} s")


SPARK = 2                   # ranks of (n)'s transport, both on cuda:0
SPARK_TIMEOUT_S = 240
SPARK_BIG = 1 << 24         # fp32 elements of (n)'s allreduce: 64 MiB
SPARK_MLP_STEPS = 5         # (k)'s 256-wide MLP under DistributedOptimizer
SPARK_LOG_TAIL = 40         # lines of each task's log on stderr on failure
ESTIMATOR_ROWS = 4096       # pytorch_spark_mnist's DataFrame
ESTIMATOR_TOL = 1e-4        # the fit on the card against the fit on the CPU
PROBED = ("pyspark", "pandas", "pyarrow", "cloudpickle", "keras", "mxnet")


def probe_packages():
    """Which of ``PROBED`` this machine has (``importlib.util.find_spec``;
    nothing is installed for (n))."""
    import importlib.util

    return {m: importlib.util.find_spec(m) is not None for m in PROBED}


def spark_task_fn(steps):
    """(n)'s function, run once a rank by the Spark transport's
    ``task_exec`` subprocess (a module-level function: plain pickle, where
    cloudpickle is missing, carries it by name, and the subprocess imports
    ``chip_smoke`` from the repo root, its working directory). Its own
    ``NCCL_HOSTID`` from ``HOROVOD_RANK``; ``horovod_tpu_torch.torch`` on
    ``CHIP_SMOKE_DEVICE`` (cuda:0 by default): a 64 MiB fp32 Sum allreduce
    held exactly to its closed form, then ``steps`` steps of (k)'s
    256-wide MLP under ``DistributedOptimizer`` on this rank's batches.
    Returns the world's view, the allreduce's largest error, the losses
    and the parameters' sha256."""
    import torch

    rank = int(os.environ["HOROVOD_RANK"])
    os.environ["NCCL_HOSTID"] = f"chip-smoke-spark-rank{rank}"
    import horovod_tpu_torch.torch as hvd

    dev = os.environ.get("CHIP_SMOKE_DEVICE", "cuda:0")
    hvd.init(device=dev)
    size = hvd.size()
    pattern = torch.arange(SPARK_BIG, device=dev) % 1024
    got = hvd.allreduce(pattern.float() * (hvd.rank() + 1), op=hvd.Sum,
                        name="n.big")
    # Sum over the ranks of (r + 1) * pattern: exact in fp32.
    err = float((got - pattern.float() * (size * (size + 1) // 2))
                .abs().max())
    gen = torch.Generator().manual_seed(11)
    data = torch.randn(steps, size, 16, 256, generator=gen).to(dev)
    torch.manual_seed(3 + hvd.rank())    # the ranks differ until broadcast
    model = torch.nn.Sequential(torch.nn.Linear(256, 256), torch.nn.ReLU(),
                                torch.nn.Linear(256, 10)).to(dev)
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.05, momentum=0.9),
        named_parameters=model.named_parameters())
    losses = []
    for step in range(steps):
        opt.zero_grad()
        loss = model(data[step, hvd.rank()]).square().mean()
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
    out = {"rank": hvd.rank(), "size": size, "device": str(dev),
           "local_rank": int(os.environ["HOROVOD_LOCAL_RANK"]),
           "allreduce_err": err, "losses": losses,
           "digest": tensor_digest(list(model.parameters()))}
    hvd.shutdown()
    return out


def spark_failing_fn():
    """(n)'s function that raises on every rank."""
    raise RuntimeError("(n) planted failure in the task function")


def spark_task(index, addresses, key_hex):
    """``chip_smoke.py --spark-task INDEX ADDRESSES KEY``: one Spark task's
    body (``spark.exec.task_main``) against the driver at ADDRESSES (JSON),
    with the job's key in hex; prints its final state and its seconds."""
    sys.path.insert(0, str(REPO))
    from horovod_tpu_torch.spark.exec import task_main

    t0 = time.perf_counter()
    state = task_main(int(index), [tuple(a) for a in json.loads(addresses)],
                      bytes.fromhex(key_hex))
    print("TASK " + json.dumps({"state": state,
                                "seconds": time.perf_counter() - t0}),
          flush=True)
    return 0


class SparkTasks:
    """``n`` ``--spark-task`` processes against ``driver``, each in a
    session of its own (``stop()`` ends them and their functions'
    subprocesses), their output in ``DIR/task.<i>.txt``."""

    def __init__(self, name, driver, key, n):
        self.name = name
        self.tmp = Path(tempfile.mkdtemp(prefix=f"chip_smoke_{name}_"))
        self.procs = []
        for i in range(n):
            with open(self.tmp / f"task.{i}.txt", "w") as f:
                self.procs.append(subprocess.Popen(
                    [sys.executable, str(Path(__file__).resolve()),
                     "--spark-task", str(i), json.dumps(driver.addresses()),
                     key.hex()],
                    cwd=str(REPO), env=dict(os.environ, PYTHONPATH=str(REPO)),
                    stdout=f, stderr=subprocess.STDOUT,
                    start_new_session=True))

    def finish(self, timeout_s):
        """Each task's final record; a task that outlives ``timeout_s``,
        exits nonzero or printed no state fails the phase."""
        t0 = time.perf_counter()
        for p in self.procs:
            try:
                p.wait(timeout=max(1.0, timeout_s - (time.perf_counter() -
                                                     t0)))
            except subprocess.TimeoutExpired:
                self.fail("a task kept serving")
        records = []
        for i, p in enumerate(self.procs):
            lines = [x for x in (self.tmp / f"task.{i}.txt").read_text()
                     .splitlines() if x.startswith("TASK ")]
            if p.returncode != 0 or not lines:
                self.fail(f"task {i} exited {p.returncode}")
            records.append(json.loads(lines[-1][len("TASK "):]))
        return records

    def stop(self):
        import signal

        for p in self.procs:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.wait()
        shutil.rmtree(self.tmp, ignore_errors=True)

    def fail(self, why):
        for i in range(len(self.procs)):
            for line in (self.tmp / f"task.{i}.txt").read_text() \
                    .splitlines()[-SPARK_LOG_TAIL:]:
                print(f"    [{self.name} {i}] {line}", file=sys.stderr,
                      flush=True)
        raise AssertionError(f"(n) {self.name}: {why}")


def estimator_worker(out_path):
    """``chip_smoke.py --estimator-worker OUT``: ``TorchEstimator.fit`` of
    ``pytorch_spark_mnist``'s model without its dropout (784-128-10, Adam
    1e-3, cross-entropy) over its 4096-row DataFrame, batch 128, 1 epoch,
    on the LocalBackend: on the card (no ``device``: ``cuda:<local
    rank>``) and with ``device="cpu"`` from the same weights, TF32 off;
    the trainer's batch order is the reader's permutation seeded by the
    epoch, the same on both. Then ``transform`` of 64 rows on the card
    and on the CPU. Writes the histories, the normwise relative errors of
    the trained parameters and of the predictions, the devices and the
    seconds of each fit."""
    import numpy as np
    import torch

    sys.path.insert(0, str(REPO))
    from horovod_tpu_torch.examples.pytorch_spark_mnist import make_dataframe
    from horovod_tpu_torch.spark import LocalStore, TorchEstimator

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card_dev = os.environ.get("CHIP_SMOKE_DEVICE")   # cpu in a rehearsal
    torch.manual_seed(0)
    model = torch.nn.Sequential(torch.nn.Linear(784, 128), torch.nn.ReLU(),
                                torch.nn.Linear(128, 10))

    def ce_loss(output, target):
        return torch.nn.functional.cross_entropy(output, target.long())

    df = make_dataframe(ESTIMATOR_ROWS)
    fits, seconds = {}, {}
    for name, device in (("card", card_dev), ("cpu", "cpu")):
        est = TorchEstimator(
            model=model,
            optimizer=torch.optim.Adam(model.parameters(), lr=0.001),
            loss=ce_loss, feature_cols=["features"], label_cols=["label"],
            batch_size=128, epochs=1, device=device,
            store=LocalStore(str(Path(out_path).parent / name)))
        t0 = time.perf_counter()
        fits[name] = est.fit(df)
        seconds[name] = time.perf_counter() - t0
    card, cpu = fits["card"], fits["cpu"]
    params = {k: rel_err(v.float().cpu(), cpu.model.state_dict()[k].float())
              for k, v in card.model.state_dict().items()}
    probe = make_dataframe(64)
    preds = [torch.as_tensor(np.stack(m.transform(probe)["label__output"]
                                      .to_numpy())) for m in (card, cpu)]
    out = {"history": {k: m.history["loss"] for k, m in fits.items()},
           "param_rel": params, "pred_rel": rel_err(*preds),
           "devices": {k: str(next(m.model.parameters()).device)
                       for k, m in fits.items()},
           "seconds": seconds}
    Path(out_path).write_text(json.dumps(out))
    return 0


def spark_mxnet_phase(gpu):
    """(n): the Spark integration, the task services' driver and the MXNet
    binding. A probe line of the optional packages. Always, the
    transport without Spark: a ``SparkDriverService``, two ``task_main``
    processes and ``run_via_task_services`` run ``spark_task_fn`` at two
    ranks on cuda:0 through the torch binding (results in rank order,
    the allreduce exact, the parameters equal bitwise on both ranks);
    beside it a round whose function raises on every rank, which must
    be reported with its text, and a task that registers after its driver
    gave up, which must stop within ``DRIVER_LOST_BOUND_S``. Where pandas
    and pyarrow are installed, ``estimator_worker``; where Keras (with
    pandas and pyarrow) is, the port's ``keras_spark_mnist`` for one
    epoch; where mxnet is, the binding at one rank. No kernel of the port
    runs here."""
    import threading

    import torch

    from horovod_tpu_torch.run.common.util import secret
    from horovod_tpu_torch.spark.exec import (DRIVER_LOST_BOUND_S,
                                              SparkDriverService,
                                              run_via_task_services)

    t0 = time.perf_counter()
    have = probe_packages()
    log("    (n) installed: " + ", ".join(
        f"{m} {'yes' if ok else 'no'}" for m, ok in have.items()))
    device = os.environ.get("CHIP_SMOKE_DEVICE", "cuda:0")
    if device != "cpu":
        torch.cuda.empty_cache()    # leave the card to the tasks
    estimator = None
    if have["pandas"] and have["pyarrow"]:
        # It runs beside the transport's rounds.
        est_tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_estimator_"))
        estimator = subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()),
             "--estimator-worker", str(est_tmp / "out.json")], cwd=str(REPO),
            env=dict(os.environ, PYTHONPATH=str(REPO)),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    keys = [secret.make_secret_key() for _ in range(3)]
    drivers = [SparkDriverService(SPARK, keys[0]),
               SparkDriverService(SPARK, keys[1]),
               SparkDriverService(1, keys[2])]
    try:
        drivers[2].wait_for_initial_registration(0.01)
    except TimeoutError:
        pass    # the driver gave up before its task started
    else:
        raise AssertionError("(n) a driver with no task did not time out")
    groups = [SparkTasks(name, d, k, n) for name, d, k, n in zip(
        ("spark_run", "spark_failing", "spark_late"), drivers, keys,
        (SPARK, SPARK, 1))]
    env = {"NCCL_IB_DISABLE": "1", "NCCL_SOCKET_IFNAME": "lo",
           "CHIP_SMOKE_DEVICE": device}
    import importlib

    # The functions by the module name that task_exec imports (not
    # __main__'s).
    sys.path.insert(0, str(REPO))
    cs = importlib.import_module("chip_smoke")
    failed = {}

    def failing_round():
        try:
            drivers[1].wait_for_initial_registration(SPARK_TIMEOUT_S)
            run_via_task_services(drivers[1], cs.spark_failing_fn, (), {},
                                  SPARK, keys[1])
        except RuntimeError as e:
            failed["error"] = str(e)

    side = threading.Thread(target=failing_round, daemon=True)
    side.start()
    try:
        drivers[0].wait_for_initial_registration(SPARK_TIMEOUT_S)
        t1 = time.perf_counter()
        results = run_via_task_services(
            drivers[0], cs.spark_task_fn, (SPARK_MLP_STEPS,), {}, SPARK,
            keys[0], exec_timeout=SPARK_TIMEOUT_S, env=env)
        exec_s = time.perf_counter() - t1
        states = groups[0].finish(60)
        side.join(SPARK_TIMEOUT_S)
        bad_states = groups[1].finish(60)
        late = groups[2].finish(60)
        if estimator is not None:
            est_out = estimator.communicate(timeout=SPARK_TIMEOUT_S)[0]
    finally:
        for g in groups:
            g.stop()
        for d in drivers:
            d.shutdown()
        if estimator is not None and estimator.poll() is None:
            estimator.kill()
            estimator.wait()
    if [r["rank"] for r in results] != list(range(SPARK)) or \
            any(r["size"] != SPARK for r in results):
        raise AssertionError(f"(n) results out of rank order: {results}")
    for r in results:
        log(f"    rank {r['rank']} (local rank {r['local_rank']}) on "
            f"{r['device']}: 64 MiB Sum allreduce error "
            f"{r['allreduce_err']}, MLP losses "
            f"{[round(x, 5) for x in r['losses']]}, parameters "
            f"{r['digest'][:16]}")
        if r["allreduce_err"] != 0.0:
            raise AssertionError("(n) the allreduce is not exact")
        if not all(math.isfinite(x) for x in r["losses"]):
            raise AssertionError("(n) non-finite MLP loss")
    if len({r["digest"] for r in results}) != 1:
        raise AssertionError("(n) the ranks' parameters differ")
    if [s["state"] for s in states] != ["done"] * SPARK:
        raise AssertionError(f"(n) the tasks ended {states}")
    log(f"    run_via_task_services at {SPARK} ranks: results in rank "
        f"order, parameters equal bitwise after {SPARK_MLP_STEPS} steps, "
        f"exec round {exec_s:.1f} s, tasks served "
        f"{[round(s['seconds'], 1) for s in states]} s on {gpu}")
    error = failed.get("error", "")
    if "(n) planted failure" not in error or "spark tasks failed" not in \
            error:
        raise AssertionError(f"(n) the failing round was not reported: "
                             f"{error!r}")
    log(f"    the raising function: reported as {error.splitlines()[0]!r}"
        f" ...; its tasks ended {[s['state'] for s in bad_states]}")
    if late[0]["state"] != "refused" or \
            not late[0]["seconds"] <= DRIVER_LOST_BOUND_S:
        raise AssertionError(f"(n) the late registrant: {late}")
    log(f"    a task that registered after its driver gave up: "
        f"{late[0]['state']}, stopped {late[0]['seconds']:.2f} s after it "
        f"started (bound {DRIVER_LOST_BOUND_S:.0f} s)")

    if estimator is not None:
        if estimator.returncode != 0:
            print(est_out[-6000:], file=sys.stderr)
            raise AssertionError("(n) the estimator worker failed")
        est = json.loads((est_tmp / "out.json").read_text())
        shutil.rmtree(est_tmp, ignore_errors=True)
        worst = max(est["param_rel"].values())
        log(f"    TorchEstimator.fit ({ESTIMATOR_ROWS} rows, 1 epoch, batch "
            f"128) on {est['devices']['card']} in "
            f"{est['seconds']['card']:.1f} s and on the CPU in "
            f"{est['seconds']['cpu']:.1f} s: loss {est['history']}, "
            f"parameters within {worst:.2e} (normwise), transform within "
            f"{est['pred_rel']:.2e} (tolerance {ESTIMATOR_TOL:g}) on {gpu}")
        if not (worst <= ESTIMATOR_TOL and est["pred_rel"] <= ESTIMATOR_TOL):
            raise AssertionError("(n) the fit on the card leaves the CPU's")
        if device != "cpu" and not est["devices"]["card"].startswith("cuda"):
            raise AssertionError("(n) the estimator did not train on the "
                                 "card")
    else:
        log("    (n) torch estimator: pandas and pyarrow not installed on "
            "this machine; not run")
    if have["keras"] and have["pandas"] and have["pyarrow"]:
        proc = subprocess.run(
            [sys.executable, "-m", "horovod_tpu_torch.examples."
             "keras_spark_mnist", "--epochs", "1"], cwd=str(REPO),
            env=dict(os.environ, PYTHONPATH=str(REPO)), capture_output=True,
            text=True, timeout=SPARK_TIMEOUT_S)
        if proc.returncode != 0 or "history:" not in proc.stdout:
            print(proc.stdout[-3000:] + proc.stderr[-3000:], file=sys.stderr)
            raise AssertionError("(n) keras_spark_mnist failed")
        log("    keras_spark_mnist (1 epoch): " + [
            x for x in proc.stdout.splitlines() if x.startswith("history:")
        ][0])
    else:
        log("    (n) keras estimator: keras, pandas or pyarrow not "
            "installed on this machine; not run")
    if have["mxnet"]:
        proc = subprocess.run(
            [sys.executable, "-c",
             "import numpy as np, mxnet as mx\n"
             "import horovod_tpu_torch.mxnet as hvd\n"
             "hvd.init()\n"
             "x = mx.nd.array(np.arange(8, dtype=np.float32))\n"
             "assert (hvd.allreduce(x).asnumpy() == x.asnumpy()).all()\n"
             "assert (hvd.broadcast(x, 0).asnumpy() == x.asnumpy()).all()\n"
             "hvd.shutdown()\nprint(mx.__version__)\n"],
            cwd=str(REPO), env=dict(os.environ, PYTHONPATH=str(REPO)),
            capture_output=True, text=True, timeout=SPARK_TIMEOUT_S)
        if proc.returncode != 0:
            print(proc.stderr[-3000:], file=sys.stderr)
            raise AssertionError("(n) the MXNet binding failed")
        log(f"    mxnet {proc.stdout.strip()}: the binding's allreduce and "
            f"broadcast at one rank")
    else:
        log("    (n) mxnet: not installed on this machine; not run")
    log(f"    (n) took {time.perf_counter() - t0:.1f} s")


# ---- (o) the port's native core on the card's machine -----------------------

CORE_RANKS, CORE_LOCAL = 4, 2   # (o)'s worlds: two hosts of two ranks
CORE_TIMEOUT_S = 150
HEAL_COUNT = 1 << 14            # fp32 elements of each ring allreduce
# (o)'s self-heal world: the hierarchical control plane, two stripes, the
# hierarchical allreduce (its leaders' cross leg is what is cut) and
# staging through NCCL.
HEAL_ENV = {"HOROVOD_HIER_CONTROL": "1", "HOROVOD_STRIPES": "2",
            "HOROVOD_HIERARCHICAL_ALLREDUCE": "1",
            "HOROVOD_HOST_VIA_XLA": "1",
            "HOROVOD_HOST_VIA_XLA_THRESHOLD": str(STAGE_THRESHOLD)}
# Leader 0 cuts its cross link before its 3rd single-socket cross duplex:
# the second allreduce's reduce-scatter (two duplexes an allreduce at two
# hosts). The cut and the heal live on the single-socket carrier, so the
# world runs striped, then single-socket across the cut, then striped.
HEAL_DROP = "0:3"
LOST_VICTIM = 1                 # a member of host 0, whose leader is rank 0
LOST_AFTER = 3                  # allreduces before the victim's SIGKILL
TSAN_OPTIONS = "exitcode=66 halt_on_error=0"


def heal_worker(out_path):
    """One rank of (o)'s self-heal world (run as ``chip_smoke.py
    --heal-worker``; two hosts of two, no ``hvd.init``): ring allreduces
    of ``HEAL_COUNT`` small integers striped, then single-socket across
    leader 0's cut, then striped again, and one staged through NCCL, each
    held bitwise to the closed form; the healing counters and the
    world-lost verdict after."""
    import torch

    sys.path.insert(0, str(REPO))
    from horovod_tpu_torch.common import host_world, native

    rank = int(os.environ["HOROVOD_RANK"])
    dev = os.environ.get("CHIP_SMOKE_DEVICE", "cuda:0")
    if rank == 0:
        os.environ["HVD_FAULT_CROSS_DROP"] = HEAL_DROP
    if dev.startswith("cuda"):
        torch.cuda.set_device(0)
    w = host_world.world()
    w.init(device=dev)
    if w.staging is None:
        raise AssertionError("(o) staging did not activate")
    core, size = w._core, w.size
    base = (torch.arange(HEAL_COUNT) % 13).float()
    want = (base * size + size * (size - 1) // 2).view(torch.int32)
    equal, stripes = [], []

    def allreduce(name, ring=True):
        with (w.ring_only() if ring else contextlib.nullcontext()):
            out = host_op(w, native.OP_ALLREDUCE, base + rank, name)
        equal.append(torch.equal(out.view(torch.int32), want))
        stripes.append(core.ring_stripe_count())

    def set_stripes(k):
        if rank == 0:
            core.set_stripes(k)
        w.barrier(f"o.stripes.{k}")

    t0 = time.perf_counter()
    for i in range(2):
        allreduce(f"o.striped.{i}")
    set_stripes(1)
    for i in range(4):
        allreduce(f"o.cut.{i}")
    set_stripes(2)
    allreduce("o.striped.2")
    allreduce("o.staged", ring=False)
    counters = core.metrics_snapshot().get("counters", {})
    out = {"rank": rank, "equal": equal, "stripes": stripes,
           "reconnects": int(counters.get("link.reconnects", 0)),
           "stale": int(counters.get("link.stale_epoch_rejected", 0)),
           "stripe_bytes": core.ring_stripe_bytes(),
           "staged": w.staging is not None, "lost": core.world_lost(),
           "s": time.perf_counter() - t0}
    w.shutdown()
    Path(out_path).write_text(json.dumps(out))
    return 0


def lost_worker(out_path):
    """One rank of (o)'s lost-member world (run as ``chip_smoke.py
    --lost-worker``; two hosts of two, the torch binding, its groups
    on NCCL): 16 MiB allreduces until ``LOST_VICTIM`` SIGKILLs itself
    after ``LOST_AFTER`` of them; every survivor must raise
    ``HorovodInternalError``. Writes the time of the raise and each
    group's abort seconds."""
    import faulthandler
    import signal

    import torch

    sys.path.insert(0, str(REPO))
    import horovod_tpu_torch.torch as hvd
    from horovod_tpu_torch.common import state as hstate

    faulthandler.register(signal.SIGUSR1, all_threads=True)
    dev = os.environ.get("CHIP_SMOKE_DEVICE", "cuda:0")
    hvd.init(device=dev)
    rank = hvd.rank()
    x = torch.ones(1 << 22, device=dev)
    deadline = time.time() + CORE_TIMEOUT_S / 2
    i = 0
    try:
        while time.time() < deadline:
            if rank == LOST_VICTIM and i == LOST_AFTER:
                (Path(out_path).parent / "killed").write_text(
                    repr(time.time()))
                os.kill(os.getpid(), signal.SIGKILL)
            hvd.allreduce(x, name=f"o.lost.{i}")
            i += 1
        raise AssertionError(f"(o) rank {rank} did not raise")
    except hvd.HorovodInternalError:
        raised = time.time()
    hvd.shutdown()     # after the watch's abort, which the raise may beat
    out = {"rank": rank, "raised": raised, "allreduces": i,
           "aborts": hstate.abort_report(),
           "killed": float((Path(out_path).parent / "killed").read_text())}
    Path(out_path).write_text(json.dumps(out))
    return 0


def abort_text(aborts):
    """Each group's abort of a lost world (``state.abort_report``), or its
    teardown (``state.teardown_report``), on one line."""
    return ", ".join(f"{a['name']} {a['ranks']} ({a['backend']}) "
                     + ("still out" if a["seconds"] is None
                        else f"{a['seconds']:.3f} s")
                     for a in aborts) or "none"


def tsan_harness(tmp):
    """Build the TSan variant of the core and the stress harness against
    it where this host's g++ gives a sound TSan, else the harness against
    the production core: (why not TSan, or ""; harness; build
    seconds)."""
    from horovod_tpu_torch.common import native

    t0 = time.perf_counter()
    why = native.probe_sanitizer("tsan", tmp)
    harness = native.build_stress_harness("" if why else "tsan", tmp)
    return why, harness, time.perf_counter() - t0


def core_phase(gpu):
    """(o): the port's native core on this machine. The TSan variant and
    the stress harness build while two worlds of four ranks (two hosts of
    two on cuda:0) run: a host world whose cut cross leg heals in place,
    and a torch-binding world that loses a member. Then the harness runs
    under TSan."""
    import platform
    from concurrent.futures import ThreadPoolExecutor

    from horovod_tpu_torch.common import native
    from horovod_tpu_torch.common.state import ELASTIC_NCCL_ENV

    t0 = time.perf_counter()
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_core_"))
    gxx = subprocess.run([native._compiler(), "--version"],
                         capture_output=True, text=True).stdout
    with ThreadPoolExecutor(max_workers=1) as pool:
        tsan = pool.submit(tsan_harness, tmp)
        heal = spawn_workers("--heal-worker", CORE_RANKS,
                             local_size=CORE_LOCAL, env=HEAL_ENV)
        lost = spawn_workers("--lost-worker", CORE_RANKS,
                             local_size=CORE_LOCAL, env=ELASTIC_NCCL_ENV)
        heal_res = finish_workers("--heal-worker", *heal, CORE_TIMEOUT_S)
        codes = [0] * CORE_RANKS
        codes[LOST_VICTIM] = -9
        lost_res = finish_workers("--lost-worker", *lost, CORE_TIMEOUT_S,
                                  codes=codes)
        why, harness, build_s = tsan.result()
    worlds_s = time.perf_counter() - t0
    why_line = why.replace("\n", " | ")
    log(f"    (o) probe: {gxx.splitlines()[0]}, {platform.machine()}, "
        f"{' '.join(platform.libc_ver())}, kernel {platform.release()}; "
        f"production core {native.library_path('').name}; TSan "
        + (f"not available ({why_line}): the harness runs on the "
           f"production core, built in {build_s:.1f} s" if why else
           f"sound, {native.library_path('tsan').name} and the harness "
           f"built in {build_s:.1f} s"))
    leaders = {0, CORE_LOCAL}
    for r in heal_res:
        log(f"    heal rank {r['rank']}: allreduces bitwise the closed form "
            f"{r['equal']}, stripes in use {r['stripes']}, link.reconnects "
            f"{r['reconnects']}, stale epochs {r['stale']}, stripe bytes "
            f"{r['stripe_bytes']}, world_lost {r['lost']}, "
            f"{r['s']:.2f} s on {gpu}")
        healed = r["reconnects"] >= 1 if r["rank"] in leaders else \
            r["reconnects"] == 0
        if not (all(r["equal"]) and len(r["equal"]) == 8 and healed and
                not r["lost"] and r["stale"] == 0):
            raise AssertionError(f"(o) heal rank {r['rank']}: {r}")
        if r["rank"] in leaders and not (r["stripes"][0] == 2 and
                                         r["stripes"][2:6] == [0] * 4):
            raise AssertionError(f"(o) heal rank {r['rank']}: the carrier "
                                 f"was not striped, single, striped")
    for r in [x for x in lost_res if x is not None]:
        secs = r["raised"] - r["killed"]
        log(f"    lost member: rank {r['rank']} raised HorovodInternalError "
            f"{secs:.3f} s after rank {LOST_VICTIM}'s SIGKILL (bound "
            f"{KILL_BOUND_S} s), after {r['allreduces']} allreduces; group "
            f"aborts {abort_text(r['aborts'])} on {gpu}")
        if not 0 <= secs <= KILL_BOUND_S:
            raise AssertionError(f"(o) rank {r['rank']} raised {secs:.3f} s "
                                 f"after the kill")
    if sum(x is not None for x in lost_res) != CORE_RANKS - 1:
        raise AssertionError("(o) a survivor wrote no result")
    t1 = time.perf_counter()
    r = subprocess.run([str(harness)], capture_output=True, text=True,
                       timeout=300,
                       env=dict(os.environ, TSAN_OPTIONS=TSAN_OPTIONS))
    report = r.stdout + r.stderr
    lines = [x for x in r.stdout.splitlines()
             if x.startswith(("LIVENESS", "WORLDLOST", "DEPARTURE",
                              "STRESS_OK"))]
    log(f"    stress harness ({'production core' if why else 'TSan'}): "
        f"exit {r.returncode}, {report.count('WARNING: ThreadSanitizer')} "
        f"TSan reports, {time.perf_counter() - t1:.2f} s; "
        f"{'; '.join(lines)}")
    if r.returncode != 0 or "STRESS_OK" not in r.stdout or \
            "WARNING: ThreadSanitizer" in report or \
            "DEPARTURE lost 9 of 9 rounds" not in r.stdout:
        print(report[-4000:], file=sys.stderr, flush=True)
        raise AssertionError("(o) the stress harness failed")
    shutil.rmtree(tmp, ignore_errors=True)
    log(f"    (o) took {time.perf_counter() - t0:.1f} s (the worlds and the "
        f"build {worlds_s:.1f} s)")


# ---- (p) the long-context example and the tools ------------------------------

LC = 2                # ranks of phase (p), both on cuda:0
LC_SEQ, LC_BATCH, LC_DOCS = 8192, 2, 3   # global T, global batch, documents
LC_STEPS = 2          # timed steps after step 0 (the example's warm-up)
LC_WIDTH = ["--d-model", "768", "--n-heads", "12", "--n-layers", "12",
            "--seq-len", str(LC_SEQ), "--batch-size", str(LC_BATCH)]
# The correctness gate: the example at a small width, fp32. The kernels
# take heads of 64 or 128 and Ulysses needs heads % sp == 0: 2 heads of
# 64 at sp=2.
LC_SMALL = ["--d-model", "128", "--n-heads", "2", "--n-layers", "2",
            "--seq-len", "256", "--batch-size", "2", "--packed",
            str(LC_DOCS), "--steps", "2"]
LC_GATE_TOL = 1e-4    # fp32 through the kernels (TF32 off) against the CPU:
                      # the losses and each parameter's step-0 gradient
                      # (normwise)
# Ring and Ulysses compute the same exact attention; in bf16 they order
# their sums differently. Their losses at every step (8.8e-6 apart at
# step 0 on an H100, where packing moves the step-0 loss by 4.2e-4) and
# their step-0 logits, row by row (normwise over the vocabulary).
LC_STRATEGY_TOL = 1e-4
LC_LOGITS_TOL = 2e-2
# The logits at the documents' first tokens, packed against unpacked on
# the same weights: there packing leaves a token one key where the
# unpacked model gives it thousands (0.56 and 0.59 on an H100).
LC_IDS_MIN_REL = 1e-1
LC_TIMEOUT_S = 600
ULYSSES_SEG = ("flash_fwd", "flash_fwd_train", "flash_bwd_dq",
               "flash_bwd_dkv")
RING_SEG = ("flash_fwd_state", "flash_bwd_dq_f32", "flash_bwd_dkv_f32")
TOOL_TIMEOUT_S = 420


def segment_rows(*cases):
    """The timed rows of ``cases`` ({mode: row}) as the kernel line's
    segment-id rows, named ``<mode>_seg``."""
    return {f"{mode}_seg": dict(row, name=f"{mode}_seg")
            for rows in cases for mode, row in rows.items()}


def packed_launches(layers, steps, strategy, sp, packed=True):
    """The attention kernels one rank launches in ``steps`` training steps
    of the long-context example at sp > 1 (``parallel/ring_attention.py``,
    ``parallel/ulysses.py``): the ring runs the forward's state mode and
    both fp32-output backward kernels once per layer, step and ring block
    (sp blocks); Ulysses the train mode and both backward kernels in the
    input dtype once per layer and step. With segment ids each launch
    counts under its mode's ``_seg`` name. Every other count is 0."""
    from horovod_tpu_torch.ops import flash_attention as fa

    want = dict.fromkeys(fa.LAUNCHES, 0)
    if strategy == "ring":
        n, names = layers * steps * sp, RING_SEG
    else:
        n, names = layers * steps, ULYSSES_SEG[1:]
    for name in names:
        want[name + ("_seg" if packed else "")] = n
    return want


def lc_args(flags, strategy, sp=LC, device="cuda:0"):
    """The long-context example's arguments."""
    from horovod_tpu_torch.examples import long_context as lc

    return lc.parse_args([*flags, "--sp", str(sp), "--strategy", strategy,
                          "--device", device])


def lc_small_state():
    """(p)'s small fp32 model's weights, drawn on the CPU."""
    import torch

    from horovod_tpu_torch.examples import long_context as lc
    from horovod_tpu_torch.models.transformer import Transformer

    cfg = lc.model_config(lc_args(LC_SMALL, "ring", sp=1, device="cpu"),
                          torch.float32)
    return Transformer(cfg, device="cpu", seed=0).state_dict()


def lc_batch(args):
    """This rank's shard of the example's global batch, rebuilt from its
    recipe (``RandomState(0)`` tokens, labels rolled over the whole
    sequence, evenly packed ids): (tokens, labels, ids or None)."""
    import numpy as np
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.examples import long_context as lc

    assert hvd.axis_sizes()["dp"] == 1
    tokens = np.random.RandomState(0).randint(
        0, lc.VOCAB, (args.batch_size, args.seq_len))
    labels = np.roll(tokens, -1, axis=1)
    t = args.seq_len // args.sp
    cols = slice(hvd.sp_rank() * t, (hvd.sp_rank() + 1) * t)
    out = [torch.as_tensor(a[:, cols].copy(), device=hvd.device())
           for a in (tokens, labels)]
    ids = None
    if args.packed:
        ids = torch.as_tensor(np.tile(
            lc.packed_segment_ids(args.seq_len, args.packed)[cols],
            (args.batch_size, 1)).astype(np.int32), device=hvd.device())
    return out[0], out[1], ids


def world_mean(tensors):
    """Each tensor averaged over the world in place."""
    import torch.distributed as dist

    if dist.is_initialized() and dist.get_world_size() > 1:
        for t in tensors:
            dist.all_reduce(t)
            t /= dist.get_world_size()


def lc_step0_grads(model, args, ids=True):
    """``model``'s loss and gradients on this rank's ``lc_batch`` (without
    its ids where ``ids`` is false), averaged over the world as the
    optimizer averages them: (loss, {name: gradient on the CPU})."""
    from horovod_tpu_torch.training import cross_entropy_loss

    tokens, labels, seg = lc_batch(args)
    model.zero_grad(set_to_none=True)
    extra = (seg,) if ids and seg is not None else ()
    loss = cross_entropy_loss(model(tokens, *extra), labels)
    loss.backward()
    named = list(model.named_parameters())
    values = [loss.detach()] + [p.grad for _, p in named]
    world_mean(values)
    grads = {n: p.grad.detach().cpu() for n, p in named}
    model.zero_grad(set_to_none=True)
    return float(values[0]), grads


def lc_reference_worker(out_path):
    """(p)'s small gate on the CPU at sp=1, a world of one (run as
    ``chip_smoke.py --lc-reference-worker``): the step-0 gradients with
    and without the ids, then the example's losses."""
    import torch

    sys.path.insert(0, str(REPO))
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.examples import long_context as lc
    from horovod_tpu_torch.models.transformer import Transformer

    inputs = torch.load(Path(out_path).parent / "inputs.pt")
    args = lc_args(LC_SMALL, "ring", sp=1, device="cpu")
    hvd.init(device="cpu")
    model = Transformer(lc.model_config(args, torch.float32), device="cpu",
                        seed=1)
    model.load_state_dict(inputs["state"])
    _, packed = lc_step0_grads(model, args)
    _, plain = lc_step0_grads(model, args, ids=False)
    torch.save({"packed": packed, "plain": plain},
               Path(inputs["grads"]) / "reference.pt")
    losses = lc.run(args, model=model).losses
    hvd.shutdown()
    Path(out_path).write_text(json.dumps({"losses": losses}))
    return 0


def doc_start_rows(t_local):
    """This rank's rows that open a document after the first, and their
    global positions."""
    import torch

    import horovod_tpu_torch as hvd

    pos = torch.arange(hvd.sp_rank() * t_local, (hvd.sp_rank() + 1) * t_local)
    doc_len = LC_SEQ // LC_DOCS
    rows = ((pos % doc_len == 0) & (pos > 0) &
            (pos < doc_len * LC_DOCS)).nonzero()[:, 0]
    return rows, pos[rows].tolist()


def row_rel(got, want):
    """Each row's ||got - want|| / ||want|| over the vocabulary."""
    return ((got - want).double().norm(dim=-1) /
            want.double().norm(dim=-1))


def lc_worker(out_path):
    """One rank of (p) (run as ``chip_smoke.py --lc-worker``): the small
    fp32 gate, ring and Ulysses (step-0 gradients, then the example's
    losses), then the example's ``run()`` at full width, packed, under
    each strategy from the same weights, each with its launch counts;
    after each run the step-0 weights again: one no-grad forward with the
    ids (counted) and one without, their world losses and logits; writes
    what it saw to ``out_path`` as JSON."""
    import torch

    sys.path.insert(0, str(REPO))
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.examples import long_context as lc
    from horovod_tpu_torch.models.transformer import Transformer
    from horovod_tpu_torch.ops import flash_attention as fa
    from horovod_tpu_torch.training import cross_entropy_loss

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    inputs = torch.load(Path(out_path).parent / "inputs.pt")
    hvd.init(device="cuda:0", sp=LC)
    dev = hvd.device()
    out = {"rank": hvd.rank(), "small": {}, "runs": {}}
    for strategy in ("ring", "ulysses"):
        args = lc_args(LC_SMALL, strategy)
        model = Transformer(lc.model_config(args, torch.float32), device=dev,
                            seed=1)
        model.load_state_dict(inputs["state"])
        _, grads = lc_step0_grads(model, args)
        if hvd.rank() == 0:
            torch.save(grads, Path(inputs["grads"]) / f"{strategy}.pt")
        out["small"][strategy] = lc.run(args, model=model).losses
    del model
    cfg = lc.model_config(lc_args(LC_WIDTH, "ring"))
    weights = {k: v.clone() for k, v in
               Transformer(cfg, device=dev, seed=0).state_dict().items()}
    logits = {}
    for strategy in ("ring", "ulysses"):
        args = lc_args(LC_WIDTH + ["--steps", str(LC_STEPS), "--packed",
                                   str(LC_DOCS)], strategy)
        model = Transformer(lc.model_config(args), device=dev, seed=1)
        model.load_state_dict(weights)
        torch.cuda.empty_cache()
        fa.reset_launches()
        res = lc.run(args, model=model)
        row = {"losses": res.losses, "ms": res.ms_per_step,
               "tokens_per_s": res.tokens_per_s,
               "peak_gib": res.peak_mem_bytes / 2**30,
               "launches": dict(fa.LAUNCHES), "steps": 1 + LC_STEPS,
               "shard": list(res.tokens.shape)}
        if strategy == "ring":
            profile_steps(res.step, n=1)
        # The step-0 weights again, on the recipe's shard (the example's
        # own, checked): the logits with the ids (a no-grad forward of the
        # main path, counted) and without them.
        res.model.load_state_dict(weights)
        tokens, labels, seg = lc_batch(args)
        if not (torch.equal(tokens, res.tokens) and
                torch.equal(seg, res.segment_ids)):
            raise AssertionError("the example's shard is not its recipe's")
        fa.reset_launches()
        with torch.no_grad():
            packed = res.model(tokens, seg)
        torch.cuda.synchronize()
        row["no_grad_launches"] = dict(fa.LAUNCHES)
        with torch.no_grad():
            plain = res.model(tokens)
            losses = [cross_entropy_loss(packed, labels),
                      cross_entropy_loss(plain, labels)]
        world_mean(losses)
        row["no_grad_losses"] = [float(x) for x in losses]
        rows, row["start_rows"] = doc_start_rows(tokens.shape[1])
        rows = rows.to(dev)
        row["starts_rel"] = rel_err(packed[:, rows], plain[:, rows])
        logits[strategy] = packed
        out["runs"][strategy] = row
        del model, res, plain
    rel = row_rel(logits["ring"], logits["ulysses"])
    out["logits"] = {"worst_row": float(rel.max()),
                     "median_row": float(rel.median()),
                     "starts": rel_err(logits["ring"][:, rows],
                                       logits["ulysses"][:, rows])}
    out.update(layers=cfg.n_layers)
    hvd.shutdown()
    Path(out_path).write_text(json.dumps(out))
    return 0


def small_gate(res, ref, grads_dir):
    """(p)'s small fp32 gate: each strategy's step-0 gradients on the card
    (sp=2) against the CPU's (sp=1), parameter by parameter, and its
    losses against the CPU's; the ids must move the CPU's gradients by
    far more than the tolerance."""
    import torch

    want = torch.load(grads_dir / "reference.pt")
    moved = (sum(float((want["plain"][n] - g).norm() ** 2)
                 for n, g in want["packed"].items()) /
             sum(float(g.norm() ** 2) for g in want["packed"].values())) ** 0.5
    log(f"    small gate (fp32, 2 layers, 2 heads of 64, T 256, {LC_DOCS} "
        f"documents): the ids move the CPU's step-0 gradients by rel "
        f"{moved:.3e} (must exceed {100 * LC_GATE_TOL:g})")
    if not moved > 100 * LC_GATE_TOL:
        raise AssertionError("long context: the small gate cannot see the "
                             "ids")
    for strategy in ("ring", "ulysses"):
        got = torch.load(grads_dir / f"{strategy}.pt")
        errs = {n: rel_err(got[n], g) for n, g in want["packed"].items()}
        name, worst = max(errs.items(), key=lambda kv: kv[1])
        log(f"    small {strategy}: step-0 gradients on the card vs the "
            f"CPU, worst parameter {name} rel {worst:.2e} (tolerance "
            f"{LC_GATE_TOL:g})")
        if set(got) != set(want["packed"]) or not worst <= LC_GATE_TOL:
            raise AssertionError(f"long context: the small {strategy} "
                                 f"gradients disagree with the CPU")
    for r in res:
        for strategy, losses in r["small"].items():
            worst = max(abs(a - b) / abs(b) for a, b in zip(losses, ref))
            log(f"    rank {r['rank']} small {strategy}: losses "
                f"{[round(x, 6) for x in losses]} vs sp=1 cpu "
                f"{[round(x, 6) for x in ref]} (worst rel {worst:.2e}, "
                f"tolerance {LC_GATE_TOL:g})")
            if not worst <= LC_GATE_TOL:
                raise AssertionError(f"long context: the small {strategy} "
                                     f"run disagrees with the CPU")


def long_context_phase(gpu):
    """(p), the example: the small gate against the CPU, then the
    full-width packed runs on two ranks of cuda:0. Returns rank 0's
    launches of the segment-id modes over the packed runs and their
    no-grad forwards."""
    grads_dir = Path(tempfile.mkdtemp(prefix="chip_smoke_lc_grads_"))
    try:
        inputs = {"state": lc_small_state(), "grads": str(grads_dir)}
        ref_procs, ref_tmp = spawn_workers("--lc-reference-worker", 1,
                                           inputs)
        procs, tmp = spawn_workers("--lc-worker", LC, inputs)
        ref = finish_workers("--lc-reference-worker", ref_procs, ref_tmp,
                             LC_TIMEOUT_S)[0]["losses"]
        res = finish_workers("--lc-worker", procs, tmp, LC_TIMEOUT_S)
        small_gate(res, ref, grads_dir)
    finally:
        shutil.rmtree(grads_dir, ignore_errors=True)
    layers = res[0]["layers"]
    no_grad = {"ring": {"flash_fwd_state_seg": layers * LC},
               "ulysses": {"flash_fwd_seg": layers}}
    for name in ("ring", "ulysses"):
        rows = [r["runs"][name] for r in res]
        for r, row in zip(res, rows):
            log(f"    rank {r['rank']} {name}: losses "
                f"{[round(x, 4) for x in row['losses']]}, step "
                f"{row['ms']:.1f} ms, {row['tokens_per_s']:,.0f} tokens/s "
                f"(the world's), peak memory {row['peak_gib']:.2f} GiB, "
                f"shard {row['shard']} (two ranks sharing one card: a "
                f"correctness run) on {gpu}")
            log(f"    rank {r['rank']} {name}: launches "
                f"{ {k: v for k, v in row['launches'].items() if v} }; "
                f"no-grad forward with the ids "
                f"{ {k: v for k, v in row['no_grad_launches'].items() if v} }")
            if not all(math.isfinite(x) for x in row["losses"]):
                raise AssertionError(f"long context {name}: non-finite loss")
            want = packed_launches(layers, row["steps"], name, LC)
            if row["launches"] != want:
                raise AssertionError(f"long context {name}: launches "
                                     f"{row['launches']}, expected {want}")
            want = dict.fromkeys(row["no_grad_launches"], 0)
            want.update(no_grad[name])
            if row["no_grad_launches"] != want:
                raise AssertionError(f"long context {name}: no-grad forward "
                                     f"launches {row['no_grad_launches']}, "
                                     f"expected {want}")
        if rows[0]["losses"] != rows[1]["losses"] or \
                rows[0]["no_grad_losses"] != rows[1]["no_grad_losses"]:
            raise AssertionError(f"long context {name}: the ranks' losses "
                                 f"differ")
    runs = res[0]["runs"]
    for i, (a, b) in enumerate(zip(runs["ring"]["losses"],
                                   runs["ulysses"]["losses"])):
        rel = abs(b - a) / abs(a)
        log(f"    step {i}: ring {a:.6f}, ulysses {b:.6f} (rel {rel:.2e}, "
            f"tolerance {LC_STRATEGY_TOL:g})")
        if not rel <= LC_STRATEGY_TOL:
            raise AssertionError(f"long context: ring and Ulysses disagree "
                                 f"at step {i}")
    for name in ("ring", "ulysses"):
        (packed, plain), step0 = (runs[name]["no_grad_losses"],
                                  runs[name]["losses"][0])
        rel = abs(packed - step0) / abs(step0)
        log(f"    {name} at the step-0 weights, no grad: packed loss "
            f"{packed:.6f} (rel {rel:.2e} from step 0's), unpacked "
            f"{plain:.6f} (rel {abs(plain - packed) / abs(packed):.2e} from "
            f"the packed)")
        if not rel <= LC_STRATEGY_TOL:
            raise AssertionError(f"long context {name}: the no-grad step-0 "
                                 f"loss is not the trainer's")
        if plain == packed:
            raise AssertionError(f"long context {name}: the packed step-0 "
                                 f"loss equals the unpacked one: the ids are "
                                 f"ignored")
    for r in res:
        lg = r["logits"]
        log(f"    rank {r['rank']} step-0 logits, ring vs Ulysses: worst row "
            f"rel {lg['worst_row']:.3e} (tolerance {LC_LOGITS_TOL:g}), "
            f"median {lg['median_row']:.3e}, at the documents' first tokens "
            f"{lg['starts']:.3e}; packed vs unpacked at those tokens "
            f"{r['runs']['ring']['start_rows']}: ring "
            f"{r['runs']['ring']['starts_rel']:.3e}, Ulysses "
            f"{r['runs']['ulysses']['starts_rel']:.3e} (must exceed "
            f"{LC_IDS_MIN_REL:g})")
        if not lg["worst_row"] <= LC_LOGITS_TOL:
            raise AssertionError("long context: ring and Ulysses logits "
                                 "disagree at step 0")
        for name in ("ring", "ulysses"):
            if not r["runs"][name]["starts_rel"] > LC_IDS_MIN_REL:
                raise AssertionError(f"long context {name}: the ids do not "
                                     f"change the logits at the documents' "
                                     f"first tokens")
    seg = {}
    for name in ("ring", "ulysses"):
        for counts in (runs[name]["launches"],
                       runs[name]["no_grad_launches"]):
            for k, v in counts.items():
                seg[k] = seg.get(k, 0) + v
    return {k: v for k, v in seg.items() if k.endswith("_seg")}


def run_tool(module, *argv, timeout_s=TOOL_TIMEOUT_S):
    """``python -m module argv`` from the checkout's root, in a session of
    its own (killed whole past ``timeout_s``); prints its output and
    returns (stdout lines, stderr). A nonzero exit fails the phase."""
    import signal

    import torch

    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", module, *argv], cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        start_new_session=True, env=dict(os.environ, PYTHONPATH=str(REPO)))
    try:
        out, err = proc.communicate(timeout=timeout_s)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, err = proc.communicate()
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
    for line in out.splitlines():
        log(f"    | {line[:400]}")
    log(f"    ({module} {' '.join(argv)}: exit {proc.returncode}, "
        f"{time.perf_counter() - t0:.1f} s)")
    if proc.returncode != 0:
        for line in err.splitlines()[-30:]:
            log(f"    ! {line}")
        raise AssertionError(f"{module} exited {proc.returncode}")
    return out.splitlines(), err


def last_json(lines):
    return json.loads([x for x in lines if x.startswith("{")][-1])


def run_main(module, *argv):
    """``module.main(argv)`` in this process, where the kernels, the CUDA
    context and cuDNN's choices for ResNet-50 are loaded already; prints
    its output and returns (stdout lines, stderr). A nonzero return or a
    raise fails the phase."""
    import importlib
    import io

    t0 = time.perf_counter()
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        code = importlib.import_module(module).main(list(argv))
    for line in out.getvalue().splitlines():
        log(f"    | {line[:400]}")
    log(f"    ({module} {' '.join(argv)}, in this process: returned {code}, "
        f"{time.perf_counter() - t0:.1f} s)")
    if code:
        for line in err.getvalue().splitlines()[-30:]:
            log(f"    ! {line}")
        raise AssertionError(f"{module} returned {code}")
    return out.getvalue().splitlines(), err.getvalue()


def tools_phase(gpu, resnet50_img_s):
    """(p), the tools on this machine: the control plane's RTT and scaling
    at d=1, each from its command line; the synthetic benchmark, the
    kernel bench and a profile in this process."""
    log(f"  controller_bench: the port's core, negotiation alone (host "
        f"only), on {gpu}'s host")
    out, _ = run_tool("horovod_tpu_torch.tools.controller_bench", "--sizes",
                      "2,4,8")
    res = last_json(out)
    for size, row in res["sizes"].items():
        hit, miss = row["hit_ms"], row["miss_ms"]
        log(f"    size {size}: hit p50 {hit['p50']} ms p99 {hit['p99']} ms, "
            f"miss p50 {miss['p50']} ms p99 {miss['p99']} ms, worker cache "
            f"hits {row['cache_hits_worker_ranks']}")
        if not (hit["p50"] < 10.0 and miss["p50"] < 50.0):
            raise AssertionError(f"controller_bench size {size}: over the "
                                 f"gate (hit p50 < 10 ms, miss p50 < 50 ms)")
        if not row["cache_hits_worker_ranks"] >= (int(size) - 1) * \
                res["iters"]:
            raise AssertionError(f"controller_bench size {size}: the "
                                 f"response cache did not engage")

    # A world of one through the launcher. Its rate is printed beside
    # (f)'s image_bench, not held to it: the same command's rate moves by
    # a third from run to run on this host (PERF.md). That the harness
    # trains image_bench's model, dtype, batch and step is a CPU test's
    # (tests/test_torch_scaling_bench.py).
    log("  scaling_bench: ResNet-50, bf16, batch 32, 224 px, 2 + 10 steps, "
        "a world of 1 (the one card)")
    out, _ = run_tool("horovod_tpu_torch.examples.scaling_bench", "--model",
                      "resnet50", "--devices", "1", "--batch-size", "32",
                      "--image-size", "224", "--num-classes", "1000",
                      "--num-iters", "10")
    res = last_json(out)
    d1 = res["per_device_img_per_sec"]["1"]
    log(f"    d=1: {d1} img/s ((f)'s image_bench in this process: "
        f"{resnet50_img_s}) on {gpu}")
    if res["platform"] != "gpu" or res["value"] != 1.0 or not d1 > 0:
        raise AssertionError(f"scaling_bench: {res}")

    log("  synthetic_benchmark: ResNet-50, bf16, batch 32, 224 px")
    out, _ = run_main("horovod_tpu_torch.examples.synthetic_benchmark",
                      "--num-iters", "5")
    per = [x for x in out if x.startswith("Img/sec per device: ")]
    total = [x for x in out if x.startswith("Total img/sec on 1 device(s)")]
    iters = [x for x in out if x.startswith("Iter #")]
    if len(per) != 1 or len(total) != 1 or len(iters) != 5 or \
            not float(per[0].split()[3]) > 0:
        raise AssertionError("synthetic_benchmark: missing lines")

    for flags in (["--seq-lens", "2048,4096"],
                  ["--seq-lens", "2048,4096", "--packed", "4"]):
        log(f"  kernel_bench {' '.join(flags)}")
        out, _ = run_main("horovod_tpu_torch.tools.kernel_bench", *flags)
        summary = last_json(out)
        if not summary.get("numerics_ok"):
            raise AssertionError("kernel_bench: a numerics check failed")

    log("  profile_resnet: ResNet-50, 3 profiled steps")
    out, err = run_main("horovod_tpu_torch.tools.profile_resnet", "--model",
                        "resnet50", "--steps", "3")
    path = [x.split("summary -> ", 1)[1] for x in err.splitlines()
            if x.startswith("summary -> ")]
    text = Path(path[0]).read_text() if path and Path(path[0]).exists() \
        else ""
    rows = re.findall(r"^\| \d+ \|.*$", text, re.M)
    log(f"    summary {path[0] if path else None}: {len(rows)} op rows; "
        f"{json.dumps(last_json(out))}")
    for row in rows[:10]:
        log(f"      {row}")
    if not rows:
        raise AssertionError("profile_resnet: no summary or an empty one")


def time_tree(tree):
    """``chip_smoke.py --time-tree DIR``: kernel times of the checkout DIR
    (say, a parent commit unpacked with ``git archive``; it builds its own
    library in its own ``build/``), each over 50 launches after 5 of
    warm-up by CUDA events and, beside them, the kernels' device time by
    torch.profiler over 20: AB_MODES at the slice's shape (B=8, T=1024,
    H=12, D=64, bf16, causal, q/k/v views of one qkv tensor) and
    AB_RING_MODES at the ring's past block (``ring_inputs()``). One JSON
    line. Run parent, change, change, parent in one call and compare
    within it."""
    tree = Path(tree).resolve()
    sys.path.insert(0, str(tree))
    import torch

    from horovod_tpu_torch.ops import flash_attention as fa

    if not Path(fa.__file__).resolve().is_relative_to(tree):
        raise RuntimeError(f"imported {fa.__file__}, not from {tree}")
    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device")
        return 2
    B, T, H, D = 8, 1024, 12, 64
    g = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = torch.randn((B, T, 3, H, D), generator=g, device="cuda").to(
        torch.bfloat16).unbind(2)
    do = torch.randn((B, T, H, D), generator=g, device="cuda").to(q.dtype)
    o, lse = fa.flash_fwd(q, k, v, True, with_lse=True)
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    kw = dict(causal=True, q_off=0, k_off=0, window=None)
    calls = modes(q, k, v, do, lse, delta, kw, AB_MODES)
    rq, blocks, rdo, rlse, rdelta = ring_inputs()
    rk, rv, q_off, k_off = blocks["past"]
    ring = modes(rq, rk, rv, rdo, rlse, rdelta,
                 dict(causal=True, q_off=q_off, k_off=k_off, window=None),
                 AB_RING_MODES)
    calls.update({f"{name}@past": c for name, c in ring.items()})
    ms = {name: time_ms(kern, iters=50, warmup=5)
          for name, (kern, _) in calls.items()}
    dev = {name: device_ms(kern) for name, (kern, _) in calls.items()}
    log(json.dumps({"tree": str(tree), "card": card(), "shape": [B, T, H, D],
                    "ring_block": list(rq.shape), "iters": 50, "ms": ms,
                    "device_ms": dev}))
    return 0


def main():
    if not (REPO / "horovod_tpu_torch").is_dir():
        log("chip_smoke: horovod_tpu_torch not found beside this script")
        return 2
    import torch

    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device")
        return 2
    sys.path.insert(0, str(REPO))
    from concurrent.futures import ThreadPoolExecutor

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import transformer_bench
    from horovod_tpu_torch.common import native
    from horovod_tpu_torch.ops import _build
    from horovod_tpu_torch.ops import flash_attention as fa

    # (a) device and build
    started = time.perf_counter()

    def since():
        return f"(+{time.perf_counter() - started:.1f} s)"

    gpu = card()
    log(f"(a) card: {gpu}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, cuDNN {torch.backends.cudnn.version()}, "
        f"{torch.cuda.device_count()} visible")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    # The native core (g++, host C++) builds beside the kernels (nvcc).
    with ThreadPoolExecutor(max_workers=1) as pool:
        core = pool.submit(native.build)
        libs = _build.build_all(verbose=True)
        core = core.result()
    log(f"    built {', '.join(str(p.relative_to(REPO)) for p in libs.values())}"
        f" and {core.relative_to(REPO)} in {time.perf_counter() - t0:.1f} s")
    for name, path in libs.items():
        kernel_report(name, path)
    lib = _build.load("flash_attention")
    for (dt, d), tile in fa.FWD_KEY_TILE.items():
        got = lib.hvd_flash_fwd_key_tile(fa._DTYPE_CODE[dt], d)
        if got != tile:
            raise AssertionError(f"the forward's key tile at {dt}, D={d} is "
                                 f"{got}; FWD_KEY_TILE says {tile}")

    # (b) kernels against their plain versions
    log(f"(b) kernels {since()}")
    table = kernel_case("slice", 8, 1024, 12, 64, torch.bfloat16, True,
                        fused=True, timing=True, faults=True)
    kernel_case("slice-contiguous", 8, 1024, 12, 64, torch.bfloat16, True)
    # The shapes (g)'s full-width runs give the bf16 kernels: 6 heads a
    # rank at tp=2, and 4 rows a call in pp=2's microbatches and ep=2's
    # dp shard (the views' strides, and so the TMA maps, change).
    kernel_case("tp2-heads", 8, 1024, 6, 64, torch.bfloat16, True,
                fused=True)
    kernel_case("batch-4", 4, 1024, 12, 64, torch.bfloat16, True, fused=True)
    kernel_case("ragged-fp32", 2, 1000, 4, 64, torch.float32, False)
    kernel_case("ragged-fp32-d128-offsets", 1, 1000, 2, 128, torch.float32,
                True, Tk=700, q_off=300, k_off=0)
    kernel_case("window", 2, 1024, 4, 128, torch.bfloat16, True, window=256)
    # The bf16 kernels' ragged edges: T not a multiple of any tile (TMA
    # reads rows past T as zeros; columns past Tk are masked), Tq != Tk
    # with offsets, D=128 and segment ids in one case.
    kernel_case("ragged-bf16", 2, 1000, 4, 64, torch.bfloat16, False)
    kernel_case("ragged-bf16-d128-offsets-segments", 2, 1000, 4, 128,
                torch.bfloat16, True, Tk=700, q_off=300, segments=4)
    table.update(ring_case())   # the state and fp32 rows at the ring's shape
    kernel_case("segments-bf16", 8, 2048, 12, 64, torch.bfloat16, True,
                fused=True, segments=4, faults=True)
    # The segment-id modes at the shapes of (p)'s packed long-context
    # trainer (T 8192 at sp=2, 3 documents a row, packed as the example
    # packs them), timed, with the bound over the pairs visible inside
    # the documents and the library on the same boolean mask: Ulysses'
    # full-sequence calls (6 heads a rank) and the ring's diagonal block
    # (rank 0's half of T, 12 heads). Their rows join the kernel line
    # with (p)'s launches. The last-tile faults stay at the shapes above:
    # at T 8192 one 64-key tile moves the forward's and dQ's outputs by
    # less than the bf16 limit (3.8e-3 and 4.4e-3 on the H100).
    seg_table = segment_rows(
        kernel_case("segments-ulysses", LC_BATCH, LC_SEQ, 6, 64,
                    torch.bfloat16, True, fused=True, segments=LC_DOCS,
                    packed_over=LC_SEQ, timing=True, timed=ULYSSES_SEG),
        kernel_case("segments-ring-diagonal", LC_BATCH, LC_SEQ // LC, 12,
                    64, torch.bfloat16, True, fused=True, segments=LC_DOCS,
                    packed_over=LC_SEQ, timing=True, timed=RING_SEG))
    kernel_case("segments-ragged-fp32", 2, 1000, 4, 128, torch.float32, True,
                segments=4)

    # (c) the slice
    log(f"(c) slice {since()}")
    small_model_check()
    hvd.init()
    args = transformer_bench.parse_args(["--num-warmup", "2",
                                         "--num-iters", "10"])
    steps = args.num_warmup + args.num_iters
    fa.reset_launches()
    run = transformer_bench.run(args)
    train_launches = dict(fa.LAUNCHES)
    with torch.no_grad():
        logits = run.model(run.tokens)
    torch.cuda.synchronize()
    launches = dict(fa.LAUNCHES)
    profile_steps(run.step)
    res = run.result
    log(f"    losses {[round(x, 4) for x in run.losses]}")
    log(f"    {res['value']} tokens/s, step {res['step_ms']} ms, peak "
        f"memory {run.peak_mem_bytes / 2**30:.2f} GiB, MFU {res.get('mfu')}"
        f" on {gpu}")
    log(f"    launches {launches}")
    log(f"    bench line {json.dumps(res)}")
    if not all(math.isfinite(x) for x in run.losses):
        raise AssertionError("non-finite loss")
    if not run.losses[-1] < run.losses[0]:
        raise AssertionError("loss did not fall")
    want = expected_launches(args.n_layers, steps)
    got = {k: train_launches[k] for k in want}
    if got != want:
        raise AssertionError(f"launches {got}, expected {want}")
    if launches["flash_fwd"] != args.n_layers:
        raise AssertionError(f"plain-mode flash_fwd launched "
                             f"{launches['flash_fwd']} times, expected "
                             f"{args.n_layers} (the no-grad forward)")
    if not run.allreduce_count >= 1:
        raise AssertionError("no bucket all-reduce ran")
    log(f"    bucket all-reduces {run.allreduce_count}")
    if logits.shape != (run.tokens.shape[0], args.seq_len, args.vocab) or \
            not torch.isfinite(logits).all():
        raise AssertionError("no-grad forward: bad logits")
    # The same trainer with every layer recomputed in the backward.
    plain_losses, plain_peak = run.losses, run.peak_mem_bytes
    del run, logits
    torch.cuda.empty_cache()
    remat_args = transformer_bench.parse_args(["--remat", "--num-warmup", "2",
                                               "--num-iters", "10"])
    fa.reset_launches()
    remat = transformer_bench.run(remat_args)
    remat_launches = dict(fa.LAUNCHES)
    rel = abs(remat.losses[0] - plain_losses[0]) / abs(plain_losses[0])
    # Step 0 is the forward before any update, which remat cannot change;
    # the later steps follow the recomputed gradients.
    drift, drift_tol = loss_drift(remat.losses, plain_losses)
    log(f"    --remat: step-0 loss {remat.losses[0]:.6f} vs "
        f"{plain_losses[0]:.6f} (rel {rel:.2e}, tolerance 1e-2 for bf16), "
        f"losses {[round(x, 4) for x in remat.losses]}: largest step "
        f"difference from the plain run {drift:.3e} (tolerance "
        f"{drift_tol:.3e}), peak memory "
        f"{remat.peak_mem_bytes / 2**30:.2f} GiB vs "
        f"{plain_peak / 2**30:.2f} GiB, step {remat.result['step_ms']} ms, "
        f"launches {remat_launches} on {gpu}")
    profile_steps(remat.step)
    want = expected_launches(remat_args.n_layers, steps, remat=True)
    got = {k: remat_launches[k] for k in want}
    if got != want:
        raise AssertionError(f"--remat launches {got}, expected {want}")
    if not rel <= 1e-2:
        raise AssertionError("--remat changed the step-0 loss")
    if not drift <= drift_tol:
        raise AssertionError("--remat changed the losses after an update")
    if not remat.peak_mem_bytes < plain_peak:
        raise AssertionError("--remat did not lower peak memory")
    del remat
    hvd.shutdown()

    # (e) sp on the card
    log(f"(e) sp={SP}: two ranks on cuda:0, one NCCL world {since()}")
    launches.update({k: v for k, v in sp_phase(gpu).items()
                     if k in ("flash_fwd_state", "flash_bwd_dq_f32",
                              "flash_bwd_dkv_f32")})

    # (f) images: cuDNN and PyTorch ops, no kernel of the port
    log(f"(f) images {since()}")
    resnet50_img_s = image_phase(gpu)

    # (g) tensor, pipeline and expert parallelism
    log(f"(g) tp, pp and ep: {MP} ranks on cuda:0, one NCCL world {since()}")
    mp_phase(gpu, plain_losses)

    # (h) ZeRO, checkpoints and Adasum
    log(f"(h) ZeRO, checkpoints and Adasum: {ZERO} ranks on cuda:0, one "
        f"NCCL world {since()}")
    zero_launches = zero_phase(gpu, plain_losses)
    log(f"    transformer --zero launches {zero_launches}")

    # (i) the negotiated eager plane: host C++ and NCCL, no kernel of the
    # port
    log(f"(i) the eager plane: {EAGER} ranks on cuda:0, one NCCL world "
        f"{since()}")
    eager_phase(gpu)

    # (j) the runtime planes: host C++, NCCL and the host, no kernel of the
    # port
    log(f"(j) the runtime planes: a host world of {HOST_RANKS} ranks with "
        f"staging, then {PLANES} ranks of the eager plane, all on cuda:0 "
        f"{since()}")
    planes_phase(gpu)

    # (k) the torch binding and the elastic worker: NCCL, cuDNN and the
    # host, no kernel of the port
    log(f"(k) the torch binding and elastic: {BINDING} ranks on cuda:0, "
        f"one NCCL world {since()}")
    binding_phase(gpu)

    # (l) the launcher and the elastic driver: the host, NCCL and cuDNN, no
    # kernel of the port
    log(f"(l) the launcher: python -m horovod_tpu_torch.run, two ranks on "
        f"cuda:0 {since()}")
    launcher_phase(gpu)

    # (m) the TF and Keras bindings, where TensorFlow is installed: the
    # host, NCCL and the port's TF ops, no kernel of the port
    log(f"(m) tf/keras: the TF and Keras bindings {since()}")
    tf_keras_phase(gpu)

    # (n) Spark and MXNet: the host, NCCL and the torch binding, no kernel
    # of the port
    log(f"(n) spark/mxnet: the Spark transport, its driver and the MXNet "
        f"binding {since()}")
    spark_mxnet_phase(gpu)

    # (o) the port's native core on this machine: host C++, NCCL and the
    # host, no kernel of the port
    log(f"(o) the native core: its TSan build and harness, a healed cut "
        f"and a lost member, {CORE_RANKS} ranks on cuda:0 {since()}")
    core_phase(gpu)

    # (p) the long-context example, packed, and the tools
    log(f"(p) long context: the packed example at sp={LC} on cuda:0, then "
        f"the tools {since()}")
    launches.update(long_context_phase(gpu))
    tools_phase(gpu, resnet50_img_s)

    # (d) result
    log(f"(d) result {since()}")
    table.update(seg_table)
    for name, row in table.items():
        row["launches"] = launches[name]
    log(json.dumps({"kernels": list(table.values())}))
    log(gpu)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--sp-worker"]:
        sys.exit(sp_worker(sys.argv[2]))
    if sys.argv[1:2] == ["--dp-worker"]:
        sys.exit(dp_worker(sys.argv[2]))
    if sys.argv[1:2] == ["--mp-worker"]:
        sys.exit(mp_worker(sys.argv[2]))
    if sys.argv[1:2] == ["--zero-worker"]:
        sys.exit(zero_worker(sys.argv[2]))
    if sys.argv[1:2] == ["--eager-worker"]:
        sys.exit(eager_worker(sys.argv[2]))
    if sys.argv[1:2] == ["--host-worker"]:
        sys.exit(host_worker(sys.argv[2]))
    if sys.argv[1:2] == ["--planes-worker"]:
        sys.exit(planes_worker(sys.argv[2]))
    if sys.argv[1:2] == ["--binding-worker"]:
        sys.exit(binding_worker(sys.argv[2]))
    if sys.argv[1:2] == ["--sbn-race-worker"]:
        sys.exit(sbn_race_worker(sys.argv[2]))
    if sys.argv[1:2] == ["--elastic-worker"]:
        sys.exit(elastic_worker(sys.argv[2]))
    if sys.argv[1:2] == ["--launcher-worker"]:
        sys.exit(launcher_worker(sys.argv[2]))
    if sys.argv[1:2] == ["--tf-worker"]:
        sys.exit(tf_worker(sys.argv[2]))
    if sys.argv[1:2] == ["--spark-task"]:
        sys.exit(spark_task(*sys.argv[2:5]))
    if sys.argv[1:2] == ["--estimator-worker"]:
        sys.exit(estimator_worker(sys.argv[2]))
    if sys.argv[1:2] == ["--heal-worker"]:
        sys.exit(heal_worker(sys.argv[2]))
    if sys.argv[1:2] == ["--lost-worker"]:
        sys.exit(lost_worker(sys.argv[2]))
    if sys.argv[1:2] == ["--lc-worker"]:
        sys.exit(lc_worker(sys.argv[2]))
    if sys.argv[1:2] == ["--lc-reference-worker"]:
        sys.exit(lc_reference_worker(sys.argv[2]))
    if sys.argv[1:2] == ["--time-tree"]:
        sys.exit(time_tree(sys.argv[2]))
    if sys.argv[1:2] == ["--sbn-race"]:
        rest = sys.argv[3:]
        out = {}
        if rest[:1] == ["--keep"]:
            out["keep"], rest = rest[1], rest[2:]
        sys.exit(sbn_race_repro(int(sys.argv[2]), rest, **out))
    sys.exit(main())
