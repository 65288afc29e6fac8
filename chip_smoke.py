#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --time-tree DIR   # kernel times of one checkout

Phases, in order; any failure exits nonzero:

(a) device and build: the card, its power limit, the torch and CUDA
    versions; every kernel of ``horovod_tpu_torch/csrc`` built with nvcc
    for sm_90a into ``build/horovod_tpu_torch/``, with each kernel's
    registers and spill bytes (``-Xptxas -v``) and HGMMA instructions
    (``cuobjdump -sass``) logged, and the forward's key tile in the
    library held equal to ``FWD_KEY_TILE``.
(b) kernels: every mode of each kernel (forward plain, train and state;
    dQ and dK/dV in the input dtype and in fp32) against its plain
    PyTorch version on the card, by normwise relative error — at the
    slice's shape (B=8, T=1024, H=12, D=64, bf16, causal) with q/k/v as
    views of one qkv tensor, as the model passes them, and contiguous; at
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
    segment ids, at bf16 (timed, at the ring's block shape) and ragged
    fp32, where ignoring the ids must be refused.
(c) the slice: a small transformer's loss and gradients through the
    kernels against the same model on the CPU; then the GPT-2-small-class
    trainer (12 layers, d_model 768, T 1024, bf16, batch 8) for 2 warm-up
    and 10 steps through hvd.init -> DistributedOptimizer, and one no-grad
    forward. Loss finite and falling, every kernel launched as often as
    the layers and steps say, at least one bucket all-reduce.
(e) sp on the card: two worker processes on cuda:0 form an NCCL world
    (each its own ``NCCL_HOSTID``, so NCCL's duplicate-GPU check, which
    compares host hashes, lets two ranks share one card; sockets over
    ``lo``). A small fp32 model with packed segment ids at sp=2, ring and
    Ulysses, against the same weights at sp=1 on the CPU; then the
    GPT-2-small-class trainer at sp=2 over T=4096 (``--sp 2 --seq-len
    4096``), with its loss, launch counts and bucket all-reduces checked
    on both ranks. The two ranks share one card: its step time is a
    correctness run, not a throughput figure.
(d) the kernel table as one JSON line, the card's name and power limit,
    and last the result line ``{"ok": true, "device": {...}}``.
"""

import json
import math
import os
import re
import shutil
import socket
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


def time_rows(calls, shape, dtype, pairs, library, errs):
    """{mode: kernel-table row} timing each mode and its plain version."""
    B, Tq, Tk, H, D = shape
    table = {}
    for name, (kern, plain) in calls.items():
        ms = time_ms(kern)
        dev_ms = device_ms(kern)
        plain_ms = time_ms(plain, iters=5, warmup=1)
        nbytes, flops = work(name, B, Tq, Tk, H, D, dtype.itemsize, pairs)
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


def sdpa_times(q, k, v, do, causal):
    """PyTorch's fused attention on the same inputs ([B, H, T, D] views),
    a yardstick the port never calls: (fwd ms, bwd ms)."""
    import torch
    import torch.nn.functional as F

    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))
    with torch.no_grad():
        fwd = time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal))
    out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)
    dot = do.transpose(1, 2)
    bwd = time_ms(lambda: torch.autograd.grad(out, (qt, kt, vt), dot,
                                              retain_graph=True))
    both = time_ms(lambda: torch.autograd.grad(
        F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal),
        (qt, kt, vt), dot))
    log(f"  library (scaled_dot_product_attention, yardstick): fwd "
        f"{fwd:.4f} ms, bwd {bwd:.4f} ms, fwd+bwd {both:.4f} ms")
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
    library = {}
    if window is None and q_off == k_off and not segments:
        fwd, bwd = sdpa_times(q, k, v, do, causal)
        library = {"flash_fwd": fwd, "flash_fwd_train": fwd,
                   "flash_bwd_dq": bwd, "flash_bwd_dkv": bwd,
                   "flash_bwd_dq_f32": bwd, "flash_bwd_dkv_f32": bwd}
    pairs = B * H * visible_pairs(T, Tk, causal, q_off, k_off, window)
    return time_rows(modes(*args, kw), (B, T, Tk, H, D), dtype, pairs,
                     library, errs)


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


def profile_steps(step, n=2):
    """Device time by kernel over ``n`` training steps (torch.profiler),
    grouped, with the device's busy share of the profiled wall time."""
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
    kernels = []
    for e in prof.key_averages():
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
    groups = {"flash attention (port)": ("flash_",),
              "matmul (cuBLAS)": ("gemm", "Gemm", "nvjet", "cutlass", "xmma"),
              "nccl": ("nccl",)}
    by_group = {g: 0.0 for g in (*groups, "other")}
    for ms, _, name in kernels:
        g = next((g for g, keys in groups.items()
                  if any(k in name for k in keys)), "other")
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
    for ms, count, name in kernels[:12]:
        log(f"      {ms:8.3f} ms/step  x{count:<4} {name[:90]}")


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
    loss = hvd.allreduce(loss.detach()).item()
    worst = 0.0
    for name, p in model.named_parameters():
        grad = hvd.allreduce(p.grad).cpu()
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


def sp_phase(gpu):
    """(e): two ranks on cuda:0 in one NCCL world. Returns rank 0's
    launch counts of the sp trainer's run."""
    import torch

    torch.cuda.empty_cache()   # leave the card to the workers
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_sp_"))
    procs = []
    for r in range(SP):
        env = dict(os.environ, HOROVOD_RANK=str(r), HOROVOD_SIZE=str(SP),
                   HOROVOD_LOCAL_RANK=str(r), HOROVOD_LOCAL_SIZE=str(SP),
                   HOROVOD_CONTROLLER_ADDR="127.0.0.1",
                   HOROVOD_CONTROLLER_PORT=str(port),
                   NCCL_HOSTID=f"chip-smoke-sp-rank{r}",
                   NCCL_IB_DISABLE="1", NCCL_SOCKET_IFNAME="lo")
        with open(tmp / f"log{r}.txt", "w") as logf:
            procs.append(subprocess.Popen(
                [sys.executable, str(Path(__file__).resolve()),
                 "--sp-worker", str(tmp / f"rank{r}.json")], env=env,
                stdout=logf, stderr=subprocess.STDOUT))
    t0 = time.perf_counter()
    try:
        for p in procs:
            p.wait(timeout=max(1.0, SP_TIMEOUT_S - (time.perf_counter() - t0)))
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
    if codes != [0] * SP:
        raise AssertionError(f"sp workers exited {codes}")
    res = [json.loads((tmp / f"rank{r}.json").read_text()) for r in range(SP)]
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
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import transformer_bench
    from horovod_tpu_torch.ops import _build
    from horovod_tpu_torch.ops import flash_attention as fa

    # (a) device and build
    gpu = card()
    log(f"(a) card: {gpu}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.device_count()} visible")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    libs = _build.build_all(verbose=True)
    log(f"    built {', '.join(str(p.relative_to(REPO)) for p in libs.values())}"
        f" in {time.perf_counter() - t0:.1f} s")
    for name, path in libs.items():
        kernel_report(name, path)
    lib = _build.load("flash_attention")
    for (dt, d), tile in fa.FWD_KEY_TILE.items():
        got = lib.hvd_flash_fwd_key_tile(fa._DTYPE_CODE[dt], d)
        if got != tile:
            raise AssertionError(f"the forward's key tile at {dt}, D={d} is "
                                 f"{got}; FWD_KEY_TILE says {tile}")

    # (b) kernels against their plain versions
    log("(b) kernels")
    table = kernel_case("slice", 8, 1024, 12, 64, torch.bfloat16, True,
                        fused=True, timing=True)
    kernel_case("slice-contiguous", 8, 1024, 12, 64, torch.bfloat16, True)
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
                fused=True, segments=4, timing=True)
    kernel_case("segments-ragged-fp32", 2, 1000, 4, 128, torch.float32, True,
                segments=4)

    # (c) the slice
    log("(c) slice")
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
    layers = args.n_layers
    for name in ("flash_fwd_train", "flash_bwd_dq", "flash_bwd_dkv"):
        if train_launches[name] != layers * steps:
            raise AssertionError(f"{name} launched {train_launches[name]} "
                                 f"times, expected {layers * steps}")
    if train_launches["flash_fwd"] != 0 or launches["flash_fwd"] != layers:
        raise AssertionError(f"plain-mode flash_fwd launched "
                             f"{launches['flash_fwd']} times, expected "
                             f"{layers} (the no-grad forward)")
    if not run.allreduce_count >= 1:
        raise AssertionError("no bucket all-reduce ran")
    log(f"    bucket all-reduces {run.allreduce_count}")
    if logits.shape != (run.tokens.shape[0], args.seq_len, args.vocab) or \
            not torch.isfinite(logits).all():
        raise AssertionError("no-grad forward: bad logits")
    hvd.shutdown()

    # (e) sp on the card
    log(f"(e) sp={SP}: two ranks on cuda:0, one NCCL world")
    launches.update({k: v for k, v in sp_phase(gpu).items()
                     if k in ("flash_fwd_state", "flash_bwd_dq_f32",
                              "flash_bwd_dkv_f32")})

    # (d) result
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
    if sys.argv[1:2] == ["--time-tree"]:
        sys.exit(time_tree(sys.argv[2]))
    sys.exit(main())
