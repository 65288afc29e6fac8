#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --time-tree DIR   # kernel times of one checkout

Phases, in order (a, b, c, e, f, g, h, i, d); any failure exits nonzero:

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
    segment ids, at bf16 (timed, at the ring's block shape, with the bound
    over the pairs visible inside segments and the library on the same
    boolean mask, printed as rows of their own) and ragged fp32, where
    ignoring the ids must be refused.
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
    4096``), with its loss, launch counts and bucket all-reduces checked
    on both ranks. The two ranks share one card: its step time is a
    correctness run, not a throughput figure.
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
    the halves; ResNet-50 at full width for 2 + 3 steps with fp16 and
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
    GPT-2-small decoder at full width, bf16, 2 + 3 steps each:
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
    0.01 with momentum 0.9, at ZeRO stages 1, 2 and 3 (``zero.py``), 2 + 3
    steps each: the loss and the sha256 of the gathered parameters and
    the batch-norm buffers equal on both ranks after every step, stage 1
    equal to stage 2 bitwise, stage 3's losses within ``loss_drift`` of
    stage 2's, each rank's state bytes equal to the analytic model (params
    + masters + momentum + buffers; stage 3 / stage 1 = 0.5005 at d=2),
    with step ms and peak memory. The stage-3 state saved
    (``checkpoint.py``), restored into a fresh template and stepped once
    beside the original: bitwise equal. The flagship decoder with
    ``transformer_bench --zero`` (dp=2, batch 8 global, 2 + 3 steps): the
    attention kernels launched as the layers and steps say, losses equal
    on both ranks and within ``loss_drift`` of (c)'s size-1 run, the
    optimizer state per rank about half the unsharded run's; its state
    saved, restored and stepped: bitwise equal. Adasum: a 64x32 fp32
    model's delta step (``DistributedOptimizer(op=Adasum)``) over NCCL
    against ``adasum_reference`` on the CPU (rel 1e-5), then ResNet-50 with
    ``op=Adasum`` for 2 + 3 steps, equal on both ranks after every step.
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
(d) the kernel table as one JSON line, the card's name and power limit,
    and last the result line ``{"ok": true, "device": {...}}``.
"""

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


def sdpa_state_ms(q, k, v):
    """PyTorch's fused non-causal attention forward that also returns the
    lse (``_scaled_dot_product_flash_attention``) on the same [B, H, T, D]
    views: one call that computes a K/V block's state in normalized form
    ((O, lse) rather than (acc, m, l)), a yardstick the port never calls.
    Logs how far its O and lse are from the plain state's acc / l and
    m + log l. Returns its ms."""
    import torch

    from horovod_tpu_torch.ops import flash_attention as fa

    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))

    def call():
        return torch.ops.aten._scaled_dot_product_flash_attention(
            qt, kt, vt, 0.0, False)[:2]

    ms = time_ms(call)
    o, lse = call()
    acc, m, l = fa.flash_fwd_state_plain(q, k, v, causal=False)
    log(f"  library (_scaled_dot_product_flash_attention, (O, lse), "
        f"yardstick): {ms:.4f} ms; against the plain state: O rel_err "
        f"{rel_err(o.transpose(1, 2), acc / l.transpose(1, 2)[..., None]):.3e}"
        f", lse rel_err {rel_err(lse, m + torch.log(l)):.3e}")
    return ms


def kernel_case(label, B, T, H, D, dtype, causal, window=None, Tk=None,
                q_off=0, k_off=0, fused=False, timing=False, segments=0):
    """Every kernel mode against its plain version on one shape; with
    ``fused`` q/k/v are views of one [B, T, 3, H, D] tensor, as the
    model's qkv projection gives them; with ``segments`` that many
    packed segments per row, and the plain versions without them as a
    fault the comparison must refuse; with ``timing`` also the planted
    last-tile faults and every mode's time. Returns {kernel: row} for
    the table."""
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
        ids = segment_ids(B, max(q_off + T, k_off + Tk), segments,
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
    if not timing:
        return {}
    refuse(dropped_tile_faults(*args, kw, OUTPUTS), refs, dtype,
           "last tile dropped")
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
    return time_rows(modes(*args, kw), (B, T, Tk, H, D), dtype, pairs,
                     library, errs, ids_bytes)


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
    """The ring's block kernels on ``ring_inputs()``: the state mode and
    the fp32 dQ in the past, diagonal and future blocks; the fp32 dK/dV in
    the past and diagonal blocks; the backward with the global lse and
    delta. In the future block every tile is culled, and the state must be
    exactly empty and dQ exactly 0. Returns the state and fp32 rows (timed
    at the past block, where every pair is visible)."""
    import torch

    from horovod_tpu_torch.ops import flash_attention as fa

    q, blocks, do, lse, delta = ring_inputs()
    (B, T, H, D), dt = q.shape, q.dtype
    table = {}
    for name, (k, v, q_off, k_off) in blocks.items():
        kw = dict(causal=True, q_off=q_off, k_off=k_off, window=None)
        names = ["flash_fwd_state", "flash_bwd_dq_f32"]
        if name != "future":
            names += ["flash_bwd_dkv_f32"]
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
            if not torch.all(dq_k == 0):
                raise AssertionError("future block: fp32 dQ is not exactly 0")
            log("  future block: state empty and fp32 dQ exactly 0")
        if name == "past":
            refuse(dropped_tile_faults(*args, kw, names), refs, dt,
                   "last tile dropped")
        library = {}
        if name == "past":
            # Same work, block-local normalization: the non-causal fused
            # attention over this block, whose (O, lse) is the block's
            # state normalized (acc = O * l, m + log l = lse).
            _, bwd = sdpa_times(q, k, v, do, causal=False)
            library = {"flash_fwd_state": sdpa_state_ms(q, k, v),
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
        "--sp", str(SP), "--seq-len", "4096", "--num-warmup", "2",
        "--num-iters", "10", "--device", "cuda:0"])
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


def run_workers(flag, n, timeout_s, inputs=None):
    """``n`` processes of this script (``flag``: ``--sp-worker``,
    ``--dp-worker``, ``--mp-worker``, ``--zero-worker`` or
    ``--eager-worker``), ranks of one NCCL world on
    cuda:0, each with its own ``NCCL_HOSTID`` and sockets over ``lo``;
    ``inputs`` (any object) is saved beside their results as
    ``inputs.pt``. Their logs are printed and each rank's JSON result
    returned. Any worker that fails or outlives ``timeout_s`` fails the
    phase."""
    import torch

    from horovod_tpu_torch.common.config import free_port_pair

    torch.cuda.empty_cache()   # leave the card to the workers
    port = free_port_pair()
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_workers_"))
    if inputs is not None:
        torch.save(inputs, tmp / "inputs.pt")
    procs = []
    for r in range(n):
        env = dict(os.environ, HOROVOD_RANK=str(r), HOROVOD_SIZE=str(n),
                   HOROVOD_LOCAL_RANK=str(r), HOROVOD_LOCAL_SIZE=str(n),
                   HOROVOD_CONTROLLER_ADDR="127.0.0.1",
                   HOROVOD_CONTROLLER_PORT=str(port),
                   NCCL_HOSTID=f"chip-smoke-rank{r}",
                   NCCL_IB_DISABLE="1", NCCL_SOCKET_IFNAME="lo")
        with open(tmp / f"log{r}.txt", "w") as logf:
            procs.append(subprocess.Popen(
                [sys.executable, str(Path(__file__).resolve()), flag,
                 str(tmp / f"rank{r}.json")], env=env,
                stdout=logf, stderr=subprocess.STDOUT))
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
    codes = [p.returncode for p in procs]
    if codes != [0] * n:
        raise AssertionError(f"{flag} processes exited {codes}")
    res = [json.loads((tmp / f"rank{r}.json").read_text()) for r in range(n)]
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


def run_image_bench(model, flags, iters, device=None):
    """``image_bench.run`` of ``model`` at its full width with 2 warm-up
    and ``iters`` timed steps; returns the run."""
    from horovod_tpu_torch import image_bench

    argv = ["--model", model, "--num-warmup", "2", "--num-iters", str(iters),
            *flags]
    if device is not None:
        argv += ["--device", device]
    return image_bench.run(image_bench.parse_args(argv))


def image_phase(gpu):
    """(f): the small model's agreement, the full-width image runs on one
    card with their profiles, then dp=2 on cuda:0."""
    import torch

    import horovod_tpu_torch as hvd

    small_image_check()
    first_loss = {}
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
        if len(traces[0]) != 5 or traces[0] != traces[1]:
            raise AssertionError(f"dp {mode}: the ranks' losses, parameters "
                                 f"or batch-norm buffers differ: {traces}")
        log(f"    {mode}: after each of {len(traces[0])} steps both ranks "
            f"hold the same loss, parameters and batch-norm buffers "
            f"(sha256 of each)")


def dp_worker(out_path):
    """One rank of the image dp phase (run as ``chip_smoke.py
    --dp-worker``): the small model on this rank's half batch, its
    world-averaged loss, gradients and statistics against the CPU's mean
    over the two halves; then ResNet-50 at full width, 2 + 3 steps with
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
            run = run_image_bench("resnet50", ("--compression", mode), 3,
                                  device="cuda:0")
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
    3e-4 as the bench, bf16, seed 0, 2 + 3 steps on this rank's rows of a
    ``batch`` x 1024 batch from RandomState(0)."""
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
    losses, ms, peak = timed_run(lambda: step(x, y))
    out = {"name": name, "mesh": hvd.axis_sizes(), "losses": losses,
           "step_ms": ms, "tokens_per_s": batch * 1024 / (ms / 1e3),
           "peak_gib": peak / 2**30, "launches": dict(fa.LAUNCHES),
           "expected": expected_launches(len(model.layers), 5,
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
        "--tp", str(MP), "--num-warmup", "2", "--num-iters", "3",
        "--device", "cuda:0"]))
    res = bench.result
    runs.append({"name": "tp2 (transformer_bench --tp 2)",
                 "mesh": res["mesh"], "losses": bench.losses,
                 "step_ms": res["step_ms"],
                 "tokens_per_s": res["global_batch"] * res["seq_len"]
                 / (res["step_ms"] / 1e3),
                 "peak_gib": bench.peak_mem_bytes / 2**30,
                 "launches": dict(fa.LAUNCHES),
                 "expected": expected_launches(res["n_layers"], 5),
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
ZERO_TIMEOUT_S = 480


def tensor_digest(tensors):
    """sha256 of the tensors' values (as fp32, in order)."""
    import hashlib

    import torch

    flat = torch.cat([t.detach().reshape(-1).float() for t in tensors])
    return hashlib.sha256(flat.cpu().numpy().tobytes()).hexdigest()


def zero_image_run(stage, x, y, seed=0, warmup=2, iters=3):
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
    args = ["--batch-size", "8", "--num-warmup", "2", "--num-iters", "3",
            "--device", "cuda:0"]
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
    # ResNet-50 with op=Adasum, 2 + 3 steps.
    model = resnet.ResNet50(num_classes=1000, dtype=torch.bfloat16,
                            device="cuda:0", seed=0)
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.01, momentum=0.9),
        op=hvd.Adasum, compression="none")
    step = training.make_train_step(model, opt)
    trace, times = [], []
    for i in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = step(x, y)
        torch.cuda.synchronize()
        if i >= 2:
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
        want_l = expected_launches(tf["layers"], 5)
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


def eager_resnet(rank, eng):
    """ResNet-50 (f)'s workload, each rank its own batch: every gradient
    submitted by name from its post-accumulate hook as it is made, then
    every handle synchronized; each step held to
    ``ops.collectives.grouped_allreduce(op=Sum)`` of the same gradients,
    bitwise (a sum of two is exact in either order)."""
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
    steps = []
    for step in range(EAGER_STEPS):
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
        steps.append({"loss": loss.item(), "tensors": len(handles),
                      "elements": sum(g.numel() for g in grads),
                      "responses": len(sizes), "tensors_per_response": sizes,
                      "cache_hits": core.cache_hits() - hits,
                      "submit_span_ms": 1e3 * (submits[-1] - submits[0]),
                      "wall_ms": wall_ms, "bitwise_equal": equal,
                      "rel_diff": diff})
    hist = metrics.snapshot(drain=False)["native"]["histograms"]
    lat = {k: metrics.percentiles(hist[k], (50, 99))
           for k in ("enq_to_neg_allreduce_us", "neg_to_done_allreduce_us")}
    return {"steps": steps, "latency_us": lat}


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


AB_MODES = ("flash_fwd", "flash_fwd_train", "flash_bwd_dq", "flash_bwd_dkv")
AB_RING_MODES = ("flash_fwd_state", "flash_bwd_dq_f32", "flash_bwd_dkv_f32")


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
                        fused=True, timing=True)
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
    # The segment-id mode: rows of their own, with the bound over the pairs
    # visible inside segments and the library on the same boolean mask.
    # The main paths run no segment ids, so these rows have no launches
    # and stay out of the kernel line.
    seg_rows = kernel_case("segments-bf16", 8, 2048, 12, 64, torch.bfloat16,
                           True, fused=True, segments=4, timing=True)
    log(json.dumps({"segment_id_rows": [
        {k: v for k, v in row.items() if k != "launches"}
        for row in seg_rows.values()]}))
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
    image_phase(gpu)

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

    # (d) result
    log(f"(d) result {since()}")
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
    if sys.argv[1:2] == ["--time-tree"]:
        sys.exit(time_tree(sys.argv[2]))
    sys.exit(main())
