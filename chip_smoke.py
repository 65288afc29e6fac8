#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits nonzero:

(a) device and build: the card, its power limit, the torch and CUDA
    versions; every kernel of ``horovod_tpu_torch/csrc`` built with nvcc
    for sm_90a into ``build/horovod_tpu_torch/``.
(b) kernels: each kernel against its plain PyTorch version on the card,
    by normwise relative error — at the slice's shape (B=8, T=1024, H=12,
    D=64, bf16, causal) with q/k/v as views of one qkv tensor, as the
    model passes them, and contiguous; at ragged fp32 shapes (T=1000) and
    at a windowed causal case (W=256). At the slice's shape also: the
    plain versions with the last tile dropped, which the comparison must
    refuse, and each kernel's time beside the plain version's, the bound,
    and PyTorch's scaled_dot_product_attention as a yardstick.
(c) the slice: a small transformer's loss and gradients through the
    kernels against the same model on the CPU; then the GPT-2-small-class
    trainer (12 layers, d_model 768, T 1024, bf16, batch 8) for 2 warm-up
    and 10 steps through hvd.init -> DistributedOptimizer, and one no-grad
    forward. Loss finite and falling, every kernel launched as often as
    the layers and steps say, at least one bucket all-reduce.
(d) the kernel table as one JSON line, the card's name and power limit,
    and last the result line ``{"ok": true, "device": {...}}``.
"""

import json
import math
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent

BF16_PEAK = 989e12      # H100 SXM dense bf16 tensor-core FLOP/s
FP32_PEAK = 67e12       # H100 SXM fp32 FLOP/s outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
SOURCE = "horovod_tpu_torch/csrc/flash_attention.cu"
PALLAS = "horovod_tpu/ops/pallas_attention.py"
REPLACES = {"flash_fwd": f"{PALLAS}:643", "flash_fwd_train": f"{PALLAS}:695",
            "flash_bwd_dq": f"{PALLAS}:737", "flash_bwd_dkv": f"{PALLAS}:770"}
# Normwise relative error ||kernel - plain|| / ||plain||, per output dtype.
# It weighs every element, so a fault in the small late rows of causal
# attention shows; a limit set by max |plain| would be set by the first
# rows and keys, which are ~100x larger. On an H100 the bf16 rounding of
# P, dS and the outputs gives 2.1e-3 to 2.7e-3, and a kernel that drops
# the last tile of its loop reads 2e-2 or more.
TOLERANCE = {"torch.bfloat16": 5e-3, "torch.float32": 1e-5}
TILE = 64   # rows of a kernel tile at the slice's shape (bf16, D=64)


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
    g, w = got.double(), want.double()
    return ((g - w).norm() / w.norm()).item()


def compare(name, got, want, failures):
    """Normwise relative error, printed beside its tolerance with the max
    |got - want|; a miss is added to ``failures``. Returns the max."""
    err = (got.float() - want.float()).abs().max().item()
    rel = rel_err(got, want)
    tol = TOLERANCE[str(want.dtype)]
    ok = math.isfinite(rel) and rel <= tol
    log(f"  {name:<26} rel_err {rel:.3e} (tolerance {tol:g})  max_abs_err "
        f"{err:.3e} (max |plain| {want.float().abs().max().item():.3g})  "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append(name)
    return err


def planted_faults(q, k, v, do, lse, delta, refs, kw):
    """The plain versions with the last tile of the inner loop dropped,
    as a kernel whose loop ends one tile early would compute them. The
    comparison must refuse every one."""
    from horovod_tpu_torch.ops import flash_attention as fa

    kc, vc = k[:, :-TILE], v[:, :-TILE]
    o, lse_cut = fa.flash_fwd_plain(q, kc, vc, with_lse=True, **kw)
    faults = {
        "flash_fwd O": o, "flash_fwd_train lse": lse_cut,
        "flash_bwd_dq dQ": fa.flash_bwd_dq_plain(q, kc, vc, do, lse, delta,
                                                 **kw)}
    faults["flash_bwd_dkv dK"], faults["flash_bwd_dkv dV"] = \
        fa.flash_bwd_dkv_plain(q[:, :-TILE], k, v, do[:, :-TILE],
                               lse[..., :-TILE].contiguous(),
                               delta[..., :-TILE].contiguous(), **kw)
    missed = []
    for name, got in faults.items():
        want = refs[name]
        rel = rel_err(got, want)
        tol = TOLERANCE[str(want.dtype)]
        log(f"  fault: {name:<22} last tile dropped: rel_err {rel:.3e} "
            f"(tolerance {tol:g})  {'refused' if rel > tol else 'MISSED'}")
        if not rel > tol:
            missed.append(name)
    if missed:
        raise AssertionError(f"the comparison passes planted faults: "
                             f"{missed}")


def kernel_case(label, B, T, H, D, dtype, causal, window=None, Tk=None,
                q_off=0, k_off=0, fused=False, timing=False):
    """Every kernel against its plain version on one shape; with
    ``fused`` q/k/v are views of one [B, T, 3, H, D] tensor, as the
    model's qkv projection gives them; with ``timing`` also the planted
    faults and the times. Returns {kernel: row} for the table."""
    import torch
    import torch.nn.functional as F

    from horovod_tpu_torch.ops import flash_attention as fa

    Tk = Tk or T
    log(f"case {label}: B={B} Tq={T} Tk={Tk} H={H} D={D} {dtype} "
        f"causal={causal} window={window} q_off={q_off} k_off={k_off} "
        f"q/k/v {'views of one [B,T,3,H,D]' if fused else 'contiguous'}")
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
    o_ref, lse_ref = fa.flash_fwd_plain(q, k, v, with_lse=True, **kw)
    delta = (do.float() * o_ref.float()).sum(-1).transpose(1, 2).contiguous()
    bwd_args = (q, k, v, do, lse_ref, delta)
    refs = {"flash_fwd O": o_ref, "flash_fwd_train lse": lse_ref,
            "flash_bwd_dq dQ": fa.flash_bwd_dq_plain(*bwd_args, **kw)}
    refs["flash_bwd_dkv dK"], refs["flash_bwd_dkv dV"] = \
        fa.flash_bwd_dkv_plain(*bwd_args, **kw)

    errs, bad = {}, []
    o, _ = fa.flash_fwd(q, k, v, **kw)
    errs["flash_fwd"] = compare("flash_fwd O", o, o_ref, bad)
    o, lse = fa.flash_fwd(q, k, v, with_lse=True, **kw)
    errs["flash_fwd_train"] = max(
        compare("flash_fwd_train O", o, o_ref, bad),
        compare("flash_fwd_train lse", lse, lse_ref, bad))
    errs["flash_bwd_dq"] = compare(
        "flash_bwd_dq dQ", fa.flash_bwd_dq(*bwd_args, **kw),
        refs["flash_bwd_dq dQ"], bad)
    dk, dv = fa.flash_bwd_dkv(*bwd_args, **kw)
    errs["flash_bwd_dkv"] = max(
        compare("flash_bwd_dkv dK", dk, refs["flash_bwd_dkv dK"], bad),
        compare("flash_bwd_dkv dV", dv, refs["flash_bwd_dkv dV"], bad))
    torch.cuda.synchronize()
    if bad:
        raise AssertionError(f"case {label}: kernels disagree with their "
                             f"plain versions: {bad}")
    if not timing:
        return {}
    planted_faults(q, k, v, do, lse_ref, delta, refs, kw)

    es = q.element_size()
    act = B * H * D * es
    rows = B * H * 4
    pairs = B * H * visible_pairs(T, Tk, causal, q_off, k_off, window)
    work = {  # (bytes each input read once and output written once, FLOPs)
        "flash_fwd": ((2 * T + 2 * Tk) * act, 4 * D * pairs),
        "flash_fwd_train": ((2 * T + 2 * Tk) * act + T * rows, 4 * D * pairs),
        "flash_bwd_dq": ((3 * T + 2 * Tk) * act + 2 * T * rows,
                         6 * D * pairs),
        "flash_bwd_dkv": ((2 * T + 4 * Tk) * act + 2 * T * rows,
                          8 * D * pairs),
    }
    kernels = {
        "flash_fwd": (lambda: fa.flash_fwd(q, k, v, **kw),
                      lambda: fa.flash_fwd_plain(q, k, v, **kw)),
        "flash_fwd_train": (
            lambda: fa.flash_fwd(q, k, v, with_lse=True, **kw),
            lambda: fa.flash_fwd_plain(q, k, v, with_lse=True, **kw)),
        "flash_bwd_dq": (lambda: fa.flash_bwd_dq(*bwd_args, **kw),
                         lambda: fa.flash_bwd_dq_plain(*bwd_args, **kw)),
        "flash_bwd_dkv": (lambda: fa.flash_bwd_dkv(*bwd_args, **kw),
                          lambda: fa.flash_bwd_dkv_plain(*bwd_args, **kw)),
    }

    # Yardstick only (the port never calls it): PyTorch's fused attention
    # on the same inputs, [B, H, T, D] views.
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))
    sdpa_kw = dict(is_causal=causal) if window is None and q_off == k_off \
        else None
    library = {}
    if sdpa_kw is not None:
        with torch.no_grad():
            sdpa_fwd = time_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, **sdpa_kw))
        out = F.scaled_dot_product_attention(qt, kt, vt, **sdpa_kw)
        dot = do.transpose(1, 2)
        sdpa_bwd = time_ms(lambda: torch.autograd.grad(
            out, (qt, kt, vt), dot, retain_graph=True))
        sdpa_both = time_ms(lambda: torch.autograd.grad(
            F.scaled_dot_product_attention(qt, kt, vt, **sdpa_kw),
            (qt, kt, vt), dot))
        log(f"  library (scaled_dot_product_attention, yardstick): fwd "
            f"{sdpa_fwd:.4f} ms, bwd {sdpa_bwd:.4f} ms, fwd+bwd "
            f"{sdpa_both:.4f} ms")
        library = {"flash_fwd": sdpa_fwd, "flash_fwd_train": sdpa_fwd,
                   "flash_bwd_dq": sdpa_bwd, "flash_bwd_dkv": sdpa_bwd}

    table = {}
    for name, (kern, plain) in kernels.items():
        ms = time_ms(kern)
        plain_ms = time_ms(plain, iters=5, warmup=1)
        nbytes, flops = work[name]
        bound_ms, bound_by = bound(nbytes, flops, dtype)
        table[name] = {
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[name], "launches": 0,
            "max_abs_err": errs[name], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library.get(name)}
        log(f"  {name:<16} {ms:.4f} ms  plain {plain_ms:.4f} ms  bound "
            f"{1e3 * bound_ms:.2f} us ({bound_by}; {nbytes / 1e6:.1f} MB, "
            f"{flops / 1e9:.2f} GFLOP)  library {library.get(name)}")
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

    # (b) kernels against their plain versions
    log("(b) kernels")
    table = kernel_case("slice", 8, 1024, 12, 64, torch.bfloat16, True,
                        fused=True, timing=True)
    kernel_case("slice-contiguous", 8, 1024, 12, 64, torch.bfloat16, True)
    kernel_case("ragged-fp32", 2, 1000, 4, 64, torch.float32, False)
    kernel_case("ragged-fp32-d128-offsets", 1, 1000, 2, 128, torch.float32,
                True, Tk=700, q_off=300, k_off=0)
    kernel_case("window", 2, 1024, 4, 128, torch.bfloat16, True, window=256)

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
    sys.exit(main())
