"""Transformer training benchmark on the port: tokens/s and MFU for a
GPT-2-small-class decoder, data and sequence parallel.

The port of ``tools/transformer_bench.py``: the same flags and defaults
and one JSON line with the same keys. One process per GPU. The world is
dp x sp x tp (``--sp``, ``--tp``; pp = 1 and one microbatch, as the JAX
tool): the global batch (default 8 per dp shard) splits over dp and the
global sequence over sp, so every rank takes a ``[batch / dp, seq_len /
sp]`` shard, the same on each tp rank, which holds H/tp heads and d_ff/tp
hidden units of every layer. Labels are rolled over the global sequence
before it is sharded. ``--remat`` recomputes each layer in the backward;
``--zero`` partitions the optimizer state over dp (ZeRO-1, the
``DistributedOptimizer``'s ``zero_axis``).

    python -m horovod_tpu_torch.transformer_bench          # GPT-2-small-ish
    python -m horovod_tpu_torch.transformer_bench --device cpu --d-model 64 \\
        --n-heads 4 --n-layers 2 --vocab 256 --seq-len 64 --num-iters 2
    # long context, under a launcher of 4 ranks (one per GPU):
    python -m horovod_tpu_torch.transformer_bench --sp 4 --seq-len 8192
    # Megatron tensor parallelism over 2 ranks, layers recomputed:
    python -m horovod_tpu_torch.transformer_bench --tp 2 --remat
    # ZeRO-1 over dp (optimizer state 1/dp a rank), with tp:
    python -m horovod_tpu_torch.transformer_bench --zero --tp 2

MFU convention (copied): model FLOPs per token = 6*N (N = matmul
parameter count: embedding table and learned positions excluded, untied
output head included) plus the attention term 12*L*T*d_attn (QK^T and PV,
fwd+bwd, causality not discounted), over the card's dense bf16 peak.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

# Dense bf16 peak of one H100 SXM (NVIDIA's data sheet), the MFU divisor.
H100_BF16_DENSE_FLOPS = 989e12


def peak_flops(device: torch.device) -> Optional[float]:
    """Dense bf16 peak of ``device``, or None where the port holds none."""
    if device.type == "cuda" and "H100" in torch.cuda.get_device_name(device):
        return H100_BF16_DENSE_FLOPS
    return None


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--d-model", type=int, default=768)
    p.add_argument("--n-heads", type=int, default=12)
    p.add_argument("--n-layers", type=int, default=12)
    p.add_argument("--vocab", type=int, default=50304,
                   help="GPT-2 vocab rounded up to a multiple of 128")
    p.add_argument("--seq-len", type=int, default=1024,
                   help="GLOBAL sequence length")
    p.add_argument("--batch-size", type=int, default=None,
                   help="global batch (default: 8 per dp shard)")
    p.add_argument("--sp", type=int, default=1,
                   help="sequence-parallel ranks; dp = world size / sp")
    p.add_argument("--tp", type=int, default=1,
                   help="tensor-parallel ranks (Megatron heads / hidden)")
    p.add_argument("--strategy", default="ring",
                   choices=["ring", "ulysses", "auto"])
    p.add_argument("--n-kv-heads", type=int, default=None,
                   help="grouped-query attention: KV heads < --n-heads")
    p.add_argument("--rope", action="store_true",
                   help="rotary positions instead of the learned table")
    p.add_argument("--window", type=int, default=None,
                   help="sliding-window attention width")
    p.add_argument("--zero", action="store_true",
                   help="ZeRO-1 over dp: each dp rank keeps the optimizer "
                        "state of its 1/dp slice of every parameter")
    p.add_argument("--remat", action="store_true",
                   help="rematerialize decoder layers (recompute each in "
                        "the backward)")
    p.add_argument("--num-warmup", type=int, default=3)
    p.add_argument("--num-iters", type=int, default=20)
    p.add_argument("--device", default=None,
                   help="default cuda:<local rank>; 'cpu' to run on the CPU")
    return p.parse_args(argv)


class BenchRun(NamedTuple):
    result: dict        # the JSON line
    losses: list        # every step's loss, warm-up included
    peak_mem_bytes: Optional[int]
    model: torch.nn.Module
    tokens: torch.Tensor
    allreduce_count: int  # bucket all-reduces the optimizer launched
    step: Callable[[], torch.Tensor]  # one more step on the same batch
    optimizer: torch.optim.Optimizer  # the DistributedOptimizer it steps


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(args) -> BenchRun:
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models.transformer import (
        Transformer, TransformerConfig, check_parallelism, global_shapes)
    from horovod_tpu_torch.training import make_train_step

    check_parallelism(sp=args.sp, tp=args.tp)
    hvd.init(device=args.device, sp=args.sp, tp=args.tp)
    device = hvd.device()
    size, dp, sp = hvd.size(), hvd.dp_size(), hvd.sp_size()
    batch = args.batch_size if args.batch_size is not None else 8 * dp
    if batch % dp:
        raise ValueError(f"global batch {batch} does not split over dp={dp}")
    if args.seq_len % sp:
        raise ValueError(f"seq_len {args.seq_len} does not split over "
                         f"sp={sp}")
    local, t_local = batch // dp, args.seq_len // sp
    kind = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    print(f"bench: dp={dp} sp={sp} tp={args.tp} on {device} ({kind}); "
          f"B={batch} "
          f"T={args.seq_len}", file=sys.stderr)

    cfg = TransformerConfig(
        vocab=args.vocab, d_model=args.d_model, n_heads=args.n_heads,
        d_head=args.d_model // args.n_heads, d_ff=4 * args.d_model,
        n_layers=args.n_layers, max_seq=args.seq_len, dtype=torch.bfloat16,
        sp_strategy=args.strategy, remat=args.remat,
        n_kv_heads=args.n_kv_heads, rope=args.rope,
        attention_window=args.window)
    model = Transformer(cfg, device=device, seed=0)
    # The whole model's counts (a tp rank holds a slice of each layer).
    shapes = global_shapes(cfg)
    count = {name: int(np.prod(shape)) for name, shape in shapes.items()
             if name != "pos" or not cfg.rope}
    n_params = sum(n if name in ("embed", "pos", "final_ln", "head")
                   else n * cfg.n_layers for name, n in count.items())
    n_matmul_params = n_params - count["embed"] - count.get("pos", 0)
    optimizer = hvd.DistributedOptimizer(
        torch.optim.AdamW(model.parameters(), lr=3e-4, weight_decay=1e-4),
        named_parameters=model.named_parameters(),
        zero_axis="dp" if args.zero else None)
    step = make_train_step(model, optimizer)

    rng = np.random.RandomState(0)
    tokens_all = rng.randint(0, cfg.vocab, (batch, args.seq_len))
    labels_all = np.roll(tokens_all, -1, axis=1)  # global roll, then shard
    rows = slice(hvd.dp_rank() * local, (hvd.dp_rank() + 1) * local)
    cols = slice(hvd.sp_rank() * t_local, (hvd.sp_rank() + 1) * t_local)
    tokens = torch.as_tensor(tokens_all[rows, cols], device=device)
    labels = torch.as_tensor(labels_all[rows, cols], device=device)

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    losses = [step(tokens, labels) for _ in range(max(1, args.num_warmup))]
    _sync(device)
    t0 = time.perf_counter()
    losses += [step(tokens, labels) for _ in range(args.num_iters)]
    _sync(device)
    dt = time.perf_counter() - t0
    losses = [float(x) for x in losses]
    peak_mem = (torch.cuda.max_memory_allocated(device)
                if device.type == "cuda" else None)

    tok_per_s = batch * args.seq_len * args.num_iters / dt
    d_attn = args.n_heads * (args.d_model // args.n_heads)
    attn_span = (min(args.seq_len, args.window) if args.window
                 else args.seq_len)
    flops_per_token = (6 * n_matmul_params +
                       12 * args.n_layers * attn_span * d_attn)
    result = {
        "metric": "transformer_tokens_per_sec_per_chip",
        "value": round(tok_per_s / size, 1),
        "unit": "tokens/sec/chip",
        "platform": "gpu" if device.type == "cuda" else device.type,
        "device_kind": kind,
        "n_params": n_params,
        "n_matmul_params": n_matmul_params,
        "d_model": args.d_model,
        "n_layers": args.n_layers,
        "seq_len": args.seq_len,
        "global_batch": batch,
        "mesh": hvd.axis_sizes(),
        "sp_strategy": args.strategy,
        "window": args.window,
        "zero": bool(args.zero),
        # This rank's optimizer-state bytes after the last step.
        "opt_state_bytes": sum(
            v.numel() * v.element_size() for st in optimizer.state.values()
            if isinstance(st, dict) for v in st.values()
            if torch.is_tensor(v)),
        "loss": round(losses[-1], 4),  # world average
        "step_ms": round(1e3 * dt / args.num_iters, 2),
    }
    peak = peak_flops(device)
    if peak:
        result["mfu"] = round(tok_per_s * flops_per_token / (size * peak), 4)
    return BenchRun(result, losses, peak_mem, model, tokens,
                    optimizer.allreduce_count, lambda: step(tokens, labels),
                    optimizer)


def main(argv=None):
    import horovod_tpu_torch as hvd

    try:
        print(json.dumps(run(parse_args(argv)).result))
    finally:
        hvd.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
