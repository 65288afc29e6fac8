"""Packed-sequence id patterns through the port's flash attention against
the JAX package's, forward output and all three gradients.

The patterns are the ones the bf16 backward kernels treat apart (they cull
tiles by document and compare ids only in a tile that mixes them):
padding id 0 after the documents, an id that comes back after a gap,
documents shorter than a 64-token tile, boundaries on 64- and 128-token
edges, and ragged lengths with offsets and with a sliding window. On the
CPU the port computes its plain versions; the JAX side runs its Pallas
kernels in interpret mode. Tolerances are
``tests/test_torch_flash_attention.py``'s (the reference's own).
"""

import numpy as np
import pytest

from tests.test_torch_flash_attention import (TOL, _arrays, _assert_match,
                                              _jax_side, _torch_side)


def _docs(*lengths, first=1):
    return np.concatenate([np.full(n, first + i, np.int32)
                           for i, n in enumerate(lengths)])


# {name: (ids of the global positions, B, Tq, Tk, kwargs)}
PATTERNS = {
    "padding": (np.concatenate([_docs(50, 40, 30), np.zeros(36, np.int32)]),
                1, 156, 156, dict(causal=False)),
    "recurring": (np.concatenate([_docs(70, first=5), _docs(60, first=9),
                                  _docs(62, first=5)]),
                  1, 192, 192, dict(causal=True)),
    "short-docs": (_docs(*np.random.RandomState(0).randint(1, 64, 16))[:256],
                   1, 256, 256, dict(causal=True)),
    "tile-edges": (_docs(64, 64, 128), 1, 256, 256, dict(causal=True)),
    "ragged-offsets": (_docs(40, 57, 103), 2, 120, 88,
                       dict(causal=True, q_off=80, k_off=0)),
    "window": (_docs(30, 70, 60), 1, 160, 160, dict(causal=True, window=48)),
}


def _ids(name):
    ids, B, Tq, Tk, kw = PATTERNS[name]
    q_off, k_off = kw.get("q_off", 0), kw.get("k_off", 0)
    return (np.tile(ids[q_off:q_off + Tq], (B, 1)),
            np.tile(ids[k_off:k_off + Tk], (B, 1)))


def test_patterns_are_what_they_name():
    """Each pattern holds the feature it is named after, at the lengths
    the cases use."""
    pad, _, T, _, _ = PATTERNS["padding"]
    assert len(pad) == T and (pad[-36:] == 0).all() and (pad[:-36] > 0).all()
    rec = PATTERNS["recurring"][0]
    assert rec[0] == rec[-1] != rec[100]
    short = PATTERNS["short-docs"][0]
    assert len(short) == 256 and len(np.unique(short[:64])) >= 2
    edges = np.flatnonzero(np.diff(PATTERNS["tile-edges"][0])) + 1
    assert list(edges) == [64, 128]
    ids, B, Tq, Tk, kw = PATTERNS["ragged-offsets"]
    assert len(ids) == kw["q_off"] + Tq and Tq % 64 and Tk % 64
    assert len(PATTERNS["window"][0]) == PATTERNS["window"][2]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(PATTERNS))
def test_pattern_matches_jax(name, dtype):
    _, B, Tq, Tk, kw = PATTERNS[name]
    q, k, v, do = _arrays(B, Tq, Tk, 2, 16, seed=7)
    seg = _ids(name)
    want = _jax_side(q, k, v, do, dtype, seg=seg, **kw)
    got = _torch_side(q, k, v, do, dtype, seg=seg, **kw)
    _assert_match(got, want, TOL[dtype], f"{name} {dtype}")
    # The ids matter here: without them the port's gradients move by far
    # more than the tolerance.
    blind = _torch_side(q, k, v, do, dtype, **kw)
    assert max(np.abs(b - g).max() for b, g in zip(blind[1:], got[1:])) > \
        10 * TOL[dtype]


@pytest.mark.parametrize("B, T, ints", [(1, 960, 1056), (2, 960, 2108),
                                        (1, 1000, 1056), (3, 64, 392)])
def test_id_scratch_keeps_the_k_table_aligned(B, T, ints):
    """The bf16 backward kernels' id scratch holds the q side's table and
    then the k side's; each side's size is rounded to 4 ints, so the k
    side's bulk copies start 16-byte aligned also for one batch row with
    an odd count of 64-token tiles (960 tokens: 1024 padded ids and 15
    ranges, 1054 ints)."""
    import torch

    from horovod_tpu_torch.ops import flash_attention as fa

    assert fa._id_table_ints(B, T) == ints
    q = torch.zeros(B, T, 1, 64, dtype=torch.bfloat16)
    k = torch.zeros(B, 700, 1, 64, dtype=torch.bfloat16)
    seg = torch.zeros(B, T, dtype=torch.int32)
    scratch = fa._id_scratch(q, k, seg)
    assert scratch.numel() == ints + fa._id_table_ints(B, 700)
    assert ints * scratch.element_size() % 16 == 0
    assert fa._id_scratch(q.float(), k.float(), seg) is None
    assert fa._id_scratch(q, k, None) is None
