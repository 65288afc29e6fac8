"""Flash-attention kernel microbench on the port: the hand-written Hopper
kernels (forward AND backward) beside PyTorch's fused attention, with a
numerics check against the plain version.

The port of ``tools/pallas_bench.py``. For each ``--seq-lens`` entry
(``--batch`` x T x ``--heads`` x ``--dim``, bf16, causal; with
``--packed N`` the rows pack N documents, evenly, as
``examples/long_context.py`` does, and attention keeps to each
document) it times the forward kernel in its train mode (O and lse) and
the backward kernels (dQ, then dK/dV) by CUDA events over ``--iters``
calls after a warm-up, beside ``scaled_dot_product_attention`` on the
same mask (a yardstick: the port never calls it), and holds each output
against the plain version of ``ops/flash_attention.py`` on the fp32
inputs (the fp32 oracle) by normwise relative error, limit
``TOLERANCE``. One JSON line per (seq_len, phase) with the reference's
keys, where ``pallas_ms`` is the port's kernels (the Pallas kernels'
counterpart), ``xla_ms`` the library's fused attention and
``maxerr_vs_xla`` the max abs error against the oracle; then a summary
line. It exits 1 if a numerics check fails.

Without a GPU it refuses unless ``--device cpu``, where the wrappers run
their plain versions (host-timed; a check of the tool, not of a kernel).

Usage: python -m horovod_tpu_torch.tools.kernel_bench [--seq-lens 2048,4096]
       [--iters 20] [--packed N]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

# Normwise ||kernel - oracle|| / ||oracle|| for bf16 inputs: the bf16
# rounding of P, dS and the outputs (the limit chip_smoke.py holds the
# kernels to).
TOLERANCE = 5e-3


def make_qkv(T, batch, heads, dim, device):
    """q, k, v and dO ``[B, T, H, D]`` in bf16 from ``RandomState(0)``."""
    rng = np.random.RandomState(0)
    shape = (batch, T, heads, dim)
    return [torch.as_tensor(rng.randn(*shape), dtype=torch.float32,
                            device=device).to(torch.bfloat16)
            for _ in range(4)]


def packed_ids(T, batch, n_docs, device):
    """int32 ``[B, T]`` ids of ``n_docs`` evenly packed documents."""
    from horovod_tpu_torch.examples.long_context import packed_segment_ids

    ids = np.tile(packed_segment_ids(T, n_docs)[None], (batch, 1))
    return torch.as_tensor(ids.astype(np.int32), device=device)


def clock(fn, iters, device):
    """ms per call: CUDA events on the card, the host clock on the CPU."""
    fn()
    if device == "cpu":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) / iters * 1e3
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def rel_err(got, want):
    g, w = got.double(), want.double()
    den = w.norm().item()
    return (g - w).norm().item() / den if den else float((g - w).norm())


def library_fns(q, k, v, do, allowed):
    """PyTorch's fused attention on the same inputs: (fwd, bwd) calls."""
    import torch.nn.functional as F

    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))
    kw = (dict(is_causal=True) if allowed is None
          else dict(attn_mask=allowed))
    dot = do.transpose(1, 2)

    def fwd():
        with torch.no_grad():
            return F.scaled_dot_product_attention(qt, kt, vt, **kw)

    out = F.scaled_dot_product_attention(qt, kt, vt, **kw)

    def bwd():
        return torch.autograd.grad(out, (qt, kt, vt), dot, retain_graph=True)

    return fwd, bwd


def bench_one(T, iters, batch, heads, dim, packed=0, window=None,
              device="cuda"):
    """The fwd and bwd rows at one sequence length."""
    from horovod_tpu_torch.ops import flash_attention as fa

    q, k, v, do = make_qkv(T, batch, heads, dim, device)
    seg = packed_ids(T, batch, packed, device) if packed else None
    kw = dict(causal=True, window=window, q_seg=seg, k_seg=seg)
    o, lse = fa.flash_fwd(q, k, v, with_lse=True, **kw)
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    bwd_args = (q, k, v, do, lse, delta)
    dq = fa.flash_bwd_dq(*bwd_args, **kw)
    dk, dv = fa.flash_bwd_dkv(*bwd_args, **kw)

    # The fp32 oracle: the plain versions on the inputs as fp32.
    qf, kf, vf, dof = (x.float() for x in (q, k, v, do))
    o_ref, lse_ref = fa.flash_fwd_plain(qf, kf, vf, with_lse=True, **kw)
    delta_ref = (dof * o_ref).sum(-1).transpose(1, 2).contiguous()
    ref_args = (qf, kf, vf, dof, lse_ref, delta_ref)
    dq_ref = fa.flash_bwd_dq_plain(*ref_args, **kw)
    dk_ref, dv_ref = fa.flash_bwd_dkv_plain(*ref_args, **kw)
    errs = {"fwd": [(o, o_ref)],
            "bwd": [(dq, dq_ref), (dk, dk_ref), (dv, dv_ref)]}
    del o_ref, dq_ref, dk_ref, dv_ref

    allowed = fa._allowed(q, k, True, 0, 0, window, seg, seg)
    if packed or window is not None:
        allowed = allowed.expand(batch, 1, T, T)
    else:
        allowed = None      # the library's own causal path
    lib_fwd, lib_bwd = library_fns(q, k, v, do, allowed)
    ms = {
        "fwd": clock(lambda: fa.flash_fwd(q, k, v, with_lse=True, **kw),
                     iters, device),
        "dq": clock(lambda: fa.flash_bwd_dq(*bwd_args, **kw), iters, device),
        "dkv": clock(lambda: fa.flash_bwd_dkv(*bwd_args, **kw), iters,
                     device),
    }
    lib = {"fwd": clock(lib_fwd, iters, device),
           "bwd": clock(lib_bwd, iters, device)}
    rows = []
    for phase in ("fwd", "bwd"):
        kern_ms = ms["fwd"] if phase == "fwd" else ms["dq"] + ms["dkv"]
        rel = max(rel_err(g, w) for g, w in errs[phase])
        row = {
            "seq_len": T, "phase": phase, "batch": batch, "heads": heads,
            "head_dim": dim, "causal": True, "window": window,
            "packed": packed,
            "pallas_ms": round(kern_ms, 4), "xla_ms": round(lib[phase], 4),
            "speedup": round(lib[phase] / kern_ms, 2),
            "maxerr_vs_xla": round(max(
                (g.float() - w.float()).abs().max().item()
                for g, w in errs[phase]), 4),
            "rel_err": rel, "numerics_ok": rel <= TOLERANCE,
        }
        if phase == "bwd":
            row.update(dq_ms=round(ms["dq"], 4), dkv_ms=round(ms["dkv"], 4))
        rows.append(row)
    return rows


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--seq-lens", default="2048,4096")
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--heads", type=int, default=8)
    p.add_argument("--dim", type=int, default=128)
    p.add_argument("--window", type=int, default=None,
                   help="sliding-window width")
    p.add_argument("--packed", type=int, default=0, metavar="N_DOCS",
                   help="pack N_DOCS documents per row (segment ids)")
    p.add_argument("--device", default=None,
                   help="default cuda; 'cpu' runs the plain versions only")
    args = p.parse_args(argv)

    device = args.device or "cuda"
    if device != "cpu" and not torch.cuda.is_available():
        p.error("no CUDA device: the kernels run on the card (pass "
                "--device cpu to run the plain versions)")
    kind = (torch.cuda.get_device_name(device) if device != "cpu"
            else "cpu")
    print(json.dumps({"platform": "gpu" if device != "cpu" else "cpu",
                      "device_kind": kind}), flush=True)
    rows = []
    for T in [int(t) for t in args.seq_lens.split(",")]:
        for row in bench_one(T, args.iters, args.batch, args.heads,
                             args.dim, args.packed, args.window, device):
            print(json.dumps(row), flush=True)
            rows.append(row)
        if device != "cpu":
            torch.cuda.empty_cache()
    ok = all(r["numerics_ok"] for r in rows)
    print(json.dumps({"summary": "kernel_bench", "device_kind": kind,
                      "rows": len(rows), "numerics_ok": ok,
                      "worst_rel_err": max(r["rel_err"] for r in rows),
                      "tolerance": TOLERANCE}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
