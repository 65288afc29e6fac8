"""Packed-sequence id patterns through the port's flash attention against
the JAX package's, forward output and all three gradients.

The patterns are the ones the bf16 kernels treat apart (they cull tiles
by document and compare ids only in a tile that mixes them): padding id 0
after the documents, an id that comes back after a gap, documents shorter
than a 64-token tile, boundaries on 64- and 128-token edges, ragged
lengths with offsets and with a sliding window, and a ring's past block
whose middle query document has no key in the block. On the CPU the port
computes its plain versions; the JAX side runs its Pallas kernels in
interpret mode. Tolerances are ``tests/test_torch_flash_attention.py``'s
(the reference's own).

``chip_smoke.forward_tiles`` models which key tiles the bf16 forward with
ids visits; it is held here against brute force on (b)'s id patterns and
on the packed long-context trainer's shapes.
"""

import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.ops import pallas_attention as ref
from horovod_tpu_torch.ops import flash_attention as fa
from proc_harness import REPO
from tests.test_torch_flash_attention import (TOL, _JDT, _TDT, _arrays,
                                              _assert_match, _jax_side,
                                              _torch_side)


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
    # a past block (q_off = Tk): rows 24..143 (document 7) see no key of
    # the block; the last rows' document 5 comes back from its start
    "rows-without-keys": (np.concatenate([_docs(40, first=5),
                                          _docs(80, first=6),
                                          _docs(120, first=7),
                                          _docs(48, first=5)]),
                          2, 192, 96, dict(causal=True, q_off=96, k_off=0)),
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
    ids, B, Tq, Tk, kw = PATTERNS["rows-without-keys"]
    assert kw["q_off"] == Tk and len(ids) == Tk + Tq
    q_ids, k_ids = _ids("rows-without-keys")
    without = ~np.isin(q_ids[0], k_ids[0])
    assert list(np.flatnonzero(without)[[0, -1]]) == [24, 143]
    assert q_ids[0, -1] == k_ids[0, 0]


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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rows_without_keys_forward_modes_match_jax(dtype):
    """The three forward modes on the past block whose middle document has
    no key in it, against the JAX package's Pallas kernels in interpret
    mode (plain O, the train kernel's lse, the block state): the rows
    without a key get O = 0, lse = +1e30, m = -1e30, l = 0 and acc = 0 on
    both sides."""
    _, B, Tq, Tk, kw = PATTERNS["rows-without-keys"]
    q, k, v, _ = _arrays(B, Tq, Tk, 2, 16, seed=9)
    qs, ks = _ids("rows-without-keys")
    H = q.shape[2]
    jq, jk, jv = (jnp.asarray(x, _JDT[dtype]) for x in (q, k, v))
    want_o = ref.flash_attention(jq, jk, jv, use_pallas=True,
                                 q_segment_ids=jnp.asarray(qs),
                                 k_segment_ids=jnp.asarray(ks), **kw)
    _, want_lse = ref._pallas_attention_fwd_train(
        *(ref._merge_heads(x) for x in (jq, jk, jv)),
        jnp.asarray([kw["q_off"], kw["k_off"]], jnp.int32), causal=True,
        interpret=True, q_seg=ref._tile_seg(qs, H),
        k_seg=ref._tile_seg(ks, H))
    want_state = ref.flash_attention_block(
        jq, jk, jv, kw["q_off"], kw["k_off"], causal=True, use_pallas=True,
        q_segment_ids=jnp.asarray(qs), k_segment_ids=jnp.asarray(ks))
    tq, tk, tv = (torch.tensor(x).to(_TDT[dtype]) for x in (q, k, v))
    segs = dict(q_seg=torch.tensor(qs), k_seg=torch.tensor(ks), **kw)
    o, _ = fa.flash_fwd(tq, tk, tv, **segs)
    o_train, lse = fa.flash_fwd(tq, tk, tv, with_lse=True, **segs)
    state = fa.flash_fwd_state(tq, tk, tv, **segs)
    tol = TOL[dtype]
    got = {"O": o, "train O": o_train, "lse": lse, "acc": state[0],
           "m": state[1], "l": state[2]}
    want = {"O": want_o, "train O": want_o,
            "lse": np.asarray(want_lse).reshape(B, H, Tq),
            "acc": want_state[0], "m": want_state[1], "l": want_state[2]}
    for name in got:
        np.testing.assert_allclose(got[name].float().numpy(),
                                   np.asarray(want[name], np.float32),
                                   rtol=tol, atol=tol, err_msg=name)
    empty = ~np.isin(qs, ks)                              # [B, Tq]
    assert empty.sum() == B * 120
    rows = np.broadcast_to(empty[:, None, :], (B, H, Tq))   # [B, H, Tq]
    for vals in ({n: x.float().numpy() for n, x in got.items()},
                 {n: np.asarray(w, np.float32) for n, w in want.items()}):
        for name in ("O", "train O", "acc"):
            assert (vals[name][empty] == 0).all(), name
        assert (vals["lse"][rows] == np.float32(1e30)).all()
        assert (vals["m"][rows] == np.float32(-1e30)).all()
        assert (vals["l"][rows] == 0).all()


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _tile_cases():
    """{label: (ids of the global positions, T, Tk, causal, q_off,
    window)}: (b)'s id patterns and (p)'s three segment-id shapes (T 8192
    evenly packed with 3 documents; the ring's blocks of 4096)."""
    cs = _chip_smoke()
    cases = {}
    for label, (ids, kw) in cs.id_patterns().items():
        cases[label] = (np.asarray(ids), kw["T"], kw.get("Tk", kw["T"]),
                        kw["causal"], kw.get("q_off", 0), kw.get("window"))
    from horovod_tpu_torch.examples.long_context import packed_segment_ids

    packed = packed_segment_ids(cs.LC_SEQ, cs.LC_DOCS)
    half = cs.LC_SEQ // cs.LC
    cases.update({"p-ulysses": (packed, cs.LC_SEQ, cs.LC_SEQ, True, 0, None),
                  "p-ring-diagonal": (packed, half, half, True, 0, None),
                  "p-ring-past": (packed, half, half, True, half, None)})
    return cases


def _by_tile(ok, rows=64, keys=128):
    """[query tiles of ``rows``, key tiles of ``keys``]: whether ``ok``
    ([Tq, Tk] bool) holds a True in the tile."""
    Tq, Tk = ok.shape
    nq, nk = -(-Tq // rows), -(-Tk // keys)
    full = np.zeros((nq * rows, nk * keys), bool)
    full[:Tq, :Tk] = ok
    return full.reshape(nq, rows, nk, keys).any(axis=(1, 3))


def _reach(T, Tk, causal, q_off, window, rows=128, keys=128):
    """[query tiles of ``rows``, key tiles of ``keys``]: whether some
    position of the query tile (ragged rows included) sees some position
    of the key tile under the causal mask and the window: the per-CTA
    culling the kernels had before ids."""
    q0 = q_off + rows * np.arange(-(-T // rows))[:, None]
    k0 = keys * np.arange(-(-Tk // keys))[None, :]
    if not causal:
        return np.ones((q0.shape[0], k0.shape[1]), bool)
    ok = q0 + rows - 1 >= k0
    if window:
        ok &= q0 - (k0 + keys - 1) < window
    return ok


@pytest.mark.parametrize("label", ["ids-padding", "ids-recurring",
                                   "ids-short-docs", "ids-tile-edges",
                                   "ids-ragged-offsets", "ids-window",
                                   "ids-batch-one", "ids-rows-without-keys",
                                   "p-ulysses", "p-ring-diagonal",
                                   "p-ring-past"])
def test_forward_tiles_hold_every_pair(label):
    """The bf16 forward's tiles with ids (``chip_smoke.forward_tiles``,
    the kernel's narrowing and tile classes), against brute force: each
    warpgroup of 64 rows computes every 128-key tile that holds a visible
    pair of one id; where the ids never decrease along the row, exactly
    the tiles of its CTA's causal range that hold a pair of one id; a
    tile it takes on the id-free path (ONE_ID) carries its rows' one id
    only."""
    cs = _chip_smoke()
    ids, T, Tk, causal, q_off, window = _tile_cases()[label]
    q_ids, k_ids = ids[q_off:q_off + T], ids[:Tk]
    computed, one_id, streamed, in_range = cs.forward_tiles(
        q_ids, k_ids, causal, q_off, 0, window)
    same = q_ids[:, None] == k_ids[None, :]
    visible = same.copy()
    if causal:
        diff = (np.arange(T)[:, None] + q_off) - np.arange(Tk)[None, :]
        visible &= diff >= 0
        if window:
            visible &= diff < window
    need, one_doc = _by_tile(visible), _by_tile(same)
    reach = _reach(T, Tk, causal, q_off, window)
    assert streamed <= in_range == int(reach.sum())
    for r in range(need.shape[0]):
        got = computed[r // 2, r % 2]
        assert set(np.flatnonzero(need[r])) <= got, r
        if (np.diff(ids) >= 0).all():
            assert got == set(np.flatnonzero(one_doc[r] & reach[r // 2])), r
        rows = q_ids[64 * r:64 * r + 64]
        for kt in one_id[r // 2, r % 2]:
            keys = k_ids[128 * kt:128 * kt + 128]
            assert len(set(rows) | set(keys)) == 1, (r, kt)
    # the rows of a 128-row tile past T's last 64 see nothing
    assert all(not computed[qt, w] for (qt, w) in computed
               if 128 * qt + 64 * w >= T)


def test_forward_tiles_cull_the_packed_shapes():
    """At (p)'s shapes (3 documents in 8192 tokens) the forward streams
    757 of the 2080 key tiles of the causal ranges at the Ulysses shape,
    318 of 528 at the ring's diagonal block and 121 of 1024 at its past
    block, where the rows of the third document see no tile at all (CTAs
    11 to 31 of 32 stream nothing): the counts dQ streams too."""
    cs = _chip_smoke()
    cases = _tile_cases()
    counts = {}
    for label in ("p-ulysses", "p-ring-diagonal", "p-ring-past"):
        ids, T, Tk, causal, q_off, window = cases[label]
        computed, _, streamed, in_range = cs.forward_tiles(
            ids[q_off:q_off + T], ids[:Tk], causal, q_off, 0, window)
        counts[label] = (streamed, in_range)
    assert counts["p-ulysses"] == (757, 2080)
    assert counts["p-ring-diagonal"] == (318, 528)
    assert counts["p-ring-past"] == (121, 1024)
    ids, T, Tk, causal, q_off, window = cases["p-ring-past"]
    computed = cs.forward_tiles(ids[q_off:q_off + T], ids[:Tk], causal,
                                q_off, 0, window)[0]
    assert [qt for qt in range(32) if computed[qt, 0] or computed[qt, 1]] \
        == list(range(11))


@pytest.mark.parametrize("B, Tq, Tk", [(2, 8192, 8192), (2, 4096, 4096),
                                       (2, 1000, 500), (1, 960, 700)])
def test_forward_id_scratch_holds_both_sides(B, Tq, Tk):
    """The forward's id tables take the same scratch as the backward's:
    the q side's table, then the k side's, each rounded to 4 ints, so the
    k side's bulk copies start 16-byte aligned."""
    q = torch.zeros(B, Tq, 1, 64, dtype=torch.bfloat16)
    k = torch.zeros(B, Tk, 1, 64, dtype=torch.bfloat16)
    seg = torch.zeros(B, Tq, dtype=torch.int32)
    scratch = fa._id_scratch(q, k, seg)
    n_q = fa._id_table_ints(B, Tq)
    assert scratch.numel() == n_q + fa._id_table_ints(B, Tk)
    assert n_q * scratch.element_size() % 16 == 0
    assert n_q >= B * (-(-Tq // 128) * 128 + 2 * -(-Tq // 64))


def test_id_tables_follow_the_c_convention():
    """``_seg_args``: ids and the scratch to build the tables in while they
    are not built; the scratch alone once an earlier launch built them;
    no tables for fp32 (raw ids always) or without ids; tables of another
    shape refused."""
    q = torch.zeros(2, 256, 1, 64, dtype=torch.bfloat16)
    k = torch.zeros(2, 128, 1, 64, dtype=torch.bfloat16)
    qs = torch.zeros(2, 256, dtype=torch.int64)
    ks = torch.zeros(2, 128, dtype=torch.int64)
    tables = fa.IdTables(q, k, qs)
    assert tables.scratch is None and not tables.built    # CPU: no build
    tables.scratch = fa._id_scratch(q, k, qs)
    q_ids, k_ids, scratch, same = fa._seg_args("f", q, k, qs, ks, tables)
    assert same is tables and scratch is tables.scratch
    assert q_ids.dtype == torch.int32 and k_ids.shape == (2, 128)
    tables.built = True
    assert fa._seg_args("f", q, k, qs, ks, tables)[:3] == \
        (None, None, tables.scratch)
    fresh = fa._seg_args("f", q.float(), k.float(), qs, ks, None)
    assert fresh[2] is None and fresh[0] is not None
    assert fa._seg_args("f", q, k, None, None, None)[:3] == (None,) * 3
    with pytest.raises(ValueError, match="id tables of"):
        fa._seg_args("f", q, q, qs, qs, tables)
    with pytest.raises(ValueError, match="without ids"):
        fa._seg_args("f", q, k, None, None, tables)


def test_one_set_of_id_tables_a_call(monkeypatch):
    """``flash_attention``'s forward and its two backward kernels get one
    ``IdTables``, and so do the two kernels of
    ``flash_attention_block_grads``; without ids none is made."""
    seen = []
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        def spy(*a, _real=getattr(fa, name), _name=name, id_tables=None,
                **kw):
            seen.append((_name, id_tables))
            return _real(*a, id_tables=id_tables, **kw)

        monkeypatch.setattr(fa, name, spy)
    q, k, v, do = (torch.tensor(x) for x in _arrays(1, 32, 32, 2, 64, 8))
    seg = torch.tensor(np.repeat([[1, 2]], 16, axis=1))
    q.requires_grad_()
    fa.flash_attention(q, k, v, q_segment_ids=seg,
                       k_segment_ids=seg).backward(do)
    assert [n for n, _ in seen] == ["flash_fwd", "flash_bwd_dq",
                                    "flash_bwd_dkv"]
    assert isinstance(seen[0][1], fa.IdTables)
    assert all(t is seen[0][1] for _, t in seen)
    seen.clear()
    o, lse = fa.flash_fwd_plain(q.detach(), k, v, with_lse=True,
                                q_seg=seg, k_seg=seg)
    delta = (do * o).sum(-1).transpose(1, 2).contiguous()
    fa.flash_attention_block_grads(q.detach(), k, v, do, lse, delta, 0, 0,
                                   q_segment_ids=seg, k_segment_ids=seg)
    assert [n for n, _ in seen] == ["flash_bwd_dq", "flash_bwd_dkv"]
    assert isinstance(seen[0][1], fa.IdTables) and seen[1][1] is seen[0][1]
    seen.clear()
    fa.flash_attention(q, k, v).backward(do)
    assert [t for _, t in seen] == [None] * 3
