"""Long-context training with sequence/context parallelism, on the port.

The port of ``examples/jax_long_context.py``: the same flags, model,
data and printed lines. The token axis of a causal transformer is
sharded across the ranks of the sp axis, so each rank's attention memory
stays O(T_local) while the model trains on the full T_global sequence.
Two strategies, both exact:

- ``--strategy ring`` (default): K/V blocks rotate around the sp ring;
  the transfer of the next block overlaps the current block's kernel. No
  head-count constraint, and no rank ever holds more than T_local keys.
- ``--strategy ulysses``: one all-to-all swaps the sequence sharding for
  a head sharding, each rank runs full-sequence flash attention on
  heads/sp heads, and a second all-to-all swaps back; it needs
  (heads / tp) % sp == 0.
- ``--strategy auto``: ulysses when the head constraint holds, ring
  otherwise.

``--packed N_DOCS`` packs N_DOCS documents per row with segment-id
masking (tokens attend only within their document): the path that runs
the attention kernels' segment-id modes.

Where the JAX example lays a virtual mesh over one process, the port's
world is processes, one per GPU: dp is the world size over ``--sp``
(``--dp``, when given, must equal it). Each rank takes its
``[B / dp, T / sp]`` shard of the tokens and ids:

    python -m horovod_tpu_torch.run -np 2 \\
        python -m horovod_tpu_torch.examples.long_context --sp 2 \\
        --seq-len 8192 --packed 3
    # on the CPU (gloo), the same command with --device cpu
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import Callable, List, NamedTuple, Optional

import numpy as np
import torch

VOCAB = 1024


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--strategy", default="ring",
                        choices=["ring", "ulysses", "auto"])
    parser.add_argument("--sp", type=int, default=4,
                        help="sequence-parallel axis size")
    parser.add_argument("--dp", type=int, default=None,
                        help="data-parallel axis size (default: the rest)")
    parser.add_argument("--seq-len", type=int, default=2048,
                        help="GLOBAL sequence length (T_local = T / sp)")
    parser.add_argument("--batch-size", type=int, default=None,
                        help="global batch size (default: 2 per dp shard; "
                             "must divide by the dp axis)")
    parser.add_argument("--d-model", type=int, default=128)
    parser.add_argument("--n-heads", type=int, default=8)
    parser.add_argument("--n-layers", type=int, default=4)
    parser.add_argument("--steps", type=int, default=5)
    parser.add_argument("--remat", action="store_true",
                        help="rematerialize decoder layers in backward "
                             "(activation memory ~O(1) layers; the knob "
                             "that lets very long sequences fit)")
    parser.add_argument("--packed", type=int, default=0, metavar="N_DOCS",
                        help="pack N_DOCS documents per row with segment-"
                             "id attention masking (tokens attend only "
                             "within their document)")
    parser.add_argument("--device", default=None,
                        help="default cuda:<local rank>; 'cpu' to run on "
                             "the CPU")
    args = parser.parse_args(argv)
    if args.steps < 1:
        parser.error(f"--steps {args.steps} must be >= 1")
    if args.packed > args.seq_len:
        parser.error(f"--packed {args.packed} must be <= --seq-len "
                     f"{args.seq_len}")
    return args


class LongContextRun(NamedTuple):
    losses: List[float]   # step 0, then every timed step (world averages)
    ms_per_step: float
    tokens_per_s: float
    peak_mem_bytes: Optional[int]   # this rank's, on a GPU
    model: torch.nn.Module
    tokens: torch.Tensor            # this rank's shard
    segment_ids: Optional[torch.Tensor]
    step: Callable[[], torch.Tensor]  # one more step on the same batch


def model_config(args, dtype=torch.bfloat16):
    """The example's decoder: vocab 1024, d_ff 4 * d_model, bf16."""
    from horovod_tpu_torch.models.transformer import TransformerConfig

    return TransformerConfig(
        vocab=VOCAB, d_model=args.d_model, n_heads=args.n_heads,
        d_head=args.d_model // args.n_heads, d_ff=4 * args.d_model,
        n_layers=args.n_layers, max_seq=args.seq_len, dtype=dtype,
        sp_strategy=args.strategy, remat=args.remat)


def packed_segment_ids(seq_len: int, n_docs: int) -> np.ndarray:
    """Evenly packed documents' ids ``[seq_len]``, the last one taking
    the remainder; a real pipeline carries the ids from its packer."""
    doc_len = seq_len // n_docs
    return np.minimum(np.arange(seq_len) // doc_len, n_docs - 1)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(args, model: Optional[torch.nn.Module] = None) -> LongContextRun:
    """Train ``args.steps`` steps after step 0, printing the example's
    lines on rank 0. ``model``: a ``Transformer`` built in this world (say,
    with weights carried across by ``params_from_jax``); default the
    example's config drawn from seed 0. The caller shuts the world down."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models.transformer import Transformer
    from horovod_tpu_torch.training import make_train_step

    hvd.init(device=args.device, sp=args.sp)
    device = hvd.device()
    sizes = hvd.axis_sizes()
    if args.dp is not None and args.dp != sizes["dp"]:
        raise ValueError(f"--dp {args.dp}: the world of {hvd.size()} ranks "
                         f"at sp={args.sp} has dp={sizes['dp']}")
    batch = (args.batch_size if args.batch_size is not None
             else 2 * sizes["dp"])
    if batch % sizes["dp"]:
        raise ValueError(f"--batch-size {batch} must divide by the dp axis "
                         f"({sizes['dp']})")
    if args.seq_len % args.sp:
        raise ValueError(f"--seq-len {args.seq_len} does not split over "
                         f"sp={args.sp}")
    rank0 = hvd.rank() == 0

    def say(line):
        if rank0:
            print(line, flush=True)

    say(f"mesh: {sizes}; strategy={args.strategy}; "
        f"T_global={args.seq_len} -> T_local={args.seq_len // args.sp}")
    if model is None:
        model = Transformer(model_config(args), device=device, seed=0)
    optimizer = hvd.DistributedOptimizer(
        torch.optim.AdamW(model.parameters(), lr=3e-4, weight_decay=1e-4),
        named_parameters=model.named_parameters())
    step = make_train_step(model, optimizer)

    rng = np.random.RandomState(0)
    tokens_all = rng.randint(0, model.cfg.vocab, (batch, args.seq_len))
    labels_all = np.roll(tokens_all, -1, axis=1)  # global roll, then shard
    local, t_local = batch // sizes["dp"], args.seq_len // args.sp
    rows = slice(hvd.dp_rank() * local, (hvd.dp_rank() + 1) * local)
    cols = slice(hvd.sp_rank() * t_local, (hvd.sp_rank() + 1) * t_local)

    def shard(a):
        return torch.as_tensor(np.ascontiguousarray(a[rows, cols]),
                               device=device)

    tokens, labels = shard(tokens_all), shard(labels_all)
    seg = None
    if args.packed:
        ids = packed_segment_ids(args.seq_len, args.packed)
        seg = shard(np.tile(ids[None], (batch, 1)).astype(np.int32))
        say(f"packed: {args.packed} docs/row, "
            f"~{args.seq_len // args.packed} tokens each")

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    losses = [float(step(tokens, labels, seg))]
    say(f"step 0 (compile): loss={losses[0]:.4f}")
    _sync(device)
    t0 = time.perf_counter()
    timed = [step(tokens, labels, seg) for _ in range(args.steps)]
    _sync(device)
    dt = (time.perf_counter() - t0) / args.steps
    losses += [float(x) for x in timed]
    tok_per_s = batch * args.seq_len / dt
    say(f"loss={losses[-1]:.4f}  {dt * 1e3:.1f} ms/step  "
        f"{tok_per_s:,.0f} tokens/s")
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else None)
    return LongContextRun(losses, 1e3 * dt, tok_per_s, peak, model, tokens,
                          seg, lambda: step(tokens, labels, seg))


def main(argv=None):
    import horovod_tpu_torch as hvd

    args = parse_args(argv)
    try:
        run(args)
    finally:
        hvd.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
