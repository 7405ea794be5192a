"""Sort/rank path for one counting pass over a huge k-mer space.

The dense engine (ops/gkm.py) materializes per-sequence histograms over all
``base**k`` buckets — impossible for protein/text alphabets at large k
(20^7 > 1e9). This module computes one theta pass the way the reference's
LSD counting sort does (shared.cpp:156-191) but shaped for a device:

1. hash every window's projected k-mer into one or more 31-bit words
   (lexicographic order preserved),
2. one device sort groups equal k-mers (runs) and, within runs, equal
   sequences (pairs),
3. scatter-free compaction — a second sort on ``position + BIG*(1-flag)``
   moves run/pair starts to a prefix while preserving order — yields the
   (rank, seq, count) triples,
4. singleton runs (one sequence holds the k-mer) contribute only to the
   kernel diagonal via a segment sum; multi-sequence runs go through
   slab-blocked count-matmuls ``C_s @ C_s^T`` with exact cross-slab
   corrections for runs straddling a slab boundary (a run has at most N
   pairs, so a +-N window around each boundary bounds the straddler).

Counts are exact integers end to end: window counts (<= p_max < 16384)
are f32/bf16-exact, pair products run either as bf16 matmuls whose
products stay below 2^24 (p_max <= 255) or as base-128 int8 digit
matmuls reassembled in int32 (exact up to p_max^2 < 2^31).
"""

from __future__ import annotations

import functools
import math
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

# plain numpy scalars: a module-level jnp constant would initialize the
# XLA backend at import time, breaking jax.distributed.initialize()
BIG = np.int32(1 << 30)
SENTINEL = np.int32(2**31 - 1)


def hash_plan(base: int, k: int) -> Tuple[int, int]:
    """(digits_per_word, n_words) so each word stays below 2^31."""
    dpw = max(1, int(math.floor(31 / math.log2(max(base, 2)))))
    dpw = min(dpw, k)
    n_words = -(-k // dpw)
    return dpw, n_words


def _compact_by_flag(flag: jnp.ndarray, payloads: Tuple[jnp.ndarray, ...]):
    """Stable-move entries where ``flag`` is True to the front.

    Returns the sorted payloads plus the original position of each entry.
    Scatter-free: sorts on ``position + BIG * (1 - flag)``.
    """
    n = flag.shape[0]
    pos = jnp.arange(n, dtype=jnp.int32)
    key = pos + jnp.where(flag, 0, BIG)
    out = jax.lax.sort((key,) + tuple(payloads) + (pos,), num_keys=1)
    return out[1:-1], out[-1]


def _diff_prev(x):
    return jnp.concatenate([jnp.ones((1,), jnp.bool_), x[1:] != x[:-1]])


def _hash_sort(
    windows: jnp.ndarray,  # [N * P, g] int32 (invalid rows: any content)
    valid: jnp.ndarray,  # [N * P] bool
    seq_of: jnp.ndarray,  # [N * P] int32
    theta: jnp.ndarray,  # [k] int32
    *,
    base: int,
    code_min: int,
    n: int,
    dpw: int,
    n_words: int,
):
    """Hash every window's projected k-mer and run the ONE main sort.

    Returns ``(swords, sseq, svalid, new_run, new_pair, run_id)`` over the
    sorted window order: the sorted hash words, sequence ids, validity,
    run/pair start flags, and the dense run rank per window.
    """
    nfeat = windows.shape[0]
    k = theta.shape[0]

    # ---- multi-word lexicographic hash of the projected k-mer
    proj = jnp.take(windows, theta, axis=1) - code_min  # [nfeat, k]
    words = []
    for w in range(n_words):
        lo = w * dpw
        hi = min(lo + dpw, k)
        weights = base ** jnp.arange(hi - lo - 1, -1, -1, dtype=jnp.int32)
        word = jnp.sum(proj[:, lo:hi] * weights, axis=1, dtype=jnp.int32)
        words.append(jnp.where(valid, word, SENTINEL))

    # ---- sort by (words..., seq): runs group, pairs group within runs.
    # When the last word has headroom, the sequence id packs into its low
    # bits — one less sort operand, same lexicographic order.
    last_digits = k - (n_words - 1) * dpw
    seq_shift = 1 << max(n, 2).bit_length()
    # strictly below SENTINEL so a maximal packed value can never collide
    packed = (base**last_digits - 1) * seq_shift + (seq_shift - 1) < (1 << 31) - 1
    if packed:
        last = jnp.where(
            valid, words[-1] * seq_shift + seq_of, SENTINEL
        )
        sorted_ops = jax.lax.sort(
            tuple(words[:-1]) + (last,), num_keys=n_words
        )
        spacked = sorted_ops[-1]
        svalid = spacked != SENTINEL
        sseq = jnp.where(svalid, spacked % seq_shift, 0)
        swords = tuple(sorted_ops[:-1]) + (
            jnp.where(svalid, spacked // seq_shift, SENTINEL),
        )
    else:
        sorted_ops = jax.lax.sort(
            tuple(words) + (seq_of,), num_keys=n_words + 1
        )
        swords = sorted_ops[:-1]
        sseq = sorted_ops[-1]
        svalid = swords[0] != SENTINEL

    new_run = jnp.zeros(nfeat, jnp.bool_)
    for w in swords:
        new_run = new_run | _diff_prev(w)
    new_pair = new_run | _diff_prev(sseq)
    run_id = jnp.cumsum(new_run.astype(jnp.int32)) - 1
    return swords, sseq, svalid, new_run, new_pair, run_id


def _pass_phase1(
    windows: jnp.ndarray,  # [N * P, g] int32 (invalid rows: any content)
    valid: jnp.ndarray,  # [N * P] bool
    seq_of: jnp.ndarray,  # [N * P] int32
    theta: jnp.ndarray,  # [k] int32
    *,
    base: int,
    code_min: int,
    n: int,
    dpw: int,
    n_words: int,
):
    """Hash + sort + compaction for one pass: everything before the slab
    count-matmuls. Returns ``(diag, mseq, mrank, mcount, m2)`` — the
    singleton-run diagonal, the compacted multi-run pair arrays (prefix of
    length ``m2``), and the live pair count."""
    nfeat = windows.shape[0]
    swords, sseq, svalid, new_run, new_pair, run_id = _hash_sort(
        windows, valid, seq_of, theta,
        base=base, code_min=code_min, n=n, dpw=dpw, n_words=n_words,
    )
    diff_prev = _diff_prev

    # ---- compact pair starts (prefix, original order preserved)
    (pair_seq, pair_run, pair_valid_w0), pair_pos = _compact_by_flag(
        new_pair, (sseq, run_id, swords[0])
    )
    m_all = jnp.sum(new_pair.astype(jnp.int32))  # pair starts, incl. invalid
    m_valid = jnp.sum((new_pair & svalid).astype(jnp.int32))
    arange_f = jnp.arange(nfeat, dtype=jnp.int32)
    # beyond the compacted prefix sit non-start windows — not pairs at all
    pair_valid = (pair_valid_w0 != SENTINEL) & (arange_f < m_all)
    # beyond the pair prefix the "positions" are garbage (non-start entries)
    next_pos = jnp.where(
        arange_f + 1 < m_all,
        jnp.concatenate([pair_pos[1:], jnp.zeros((1,), jnp.int32)]),
        nfeat,
    )
    pair_count = jnp.where(pair_valid, next_pos - pair_pos, 0)

    # ---- per-pair run size (pairs of a run are contiguous in pair space)
    new_runpair = diff_prev(pair_run) & pair_valid
    n_runs = jnp.sum(new_runpair.astype(jnp.int32))
    (_,), runstart_pidx = _compact_by_flag(new_runpair, (pair_run,))
    next_rp = jnp.where(
        arange_f + 1 < n_runs,
        jnp.concatenate([runstart_pidx[1:], jnp.zeros((1,), jnp.int32)]),
        m_valid,
    )
    run_sizes = next_rp - runstart_pidx  # [R...] pairs per run, prefix-valid
    size_of_pair = jnp.take(
        run_sizes, jnp.clip(pair_run, 0, nfeat - 1), mode="clip"
    )
    single = pair_valid & (size_of_pair == 1)
    multi = pair_valid & (size_of_pair >= 2)

    # ---- diagonal: singleton runs only touch K[s, s]
    diag = jax.ops.segment_sum(
        jnp.where(single, pair_count * pair_count, 0),
        pair_seq,
        num_segments=n,
        indices_are_sorted=False,
    )

    # ---- compact multi pairs, re-rank densely
    (mseq, mrun, mcount), _ = _compact_by_flag(
        multi, (pair_seq, pair_run, pair_count)
    )
    m2 = jnp.sum(multi.astype(jnp.int32))
    new_mrun = diff_prev(mrun)
    mrank = jnp.cumsum(new_mrun.astype(jnp.int32)) - 1
    return diag, mseq, mrank, mcount, m2


def _pass_phase1_runs(
    windows: jnp.ndarray,
    valid: jnp.ndarray,
    seq_of: jnp.ndarray,
    theta: jnp.ndarray,  # [k] int32
    *,
    base: int,
    code_min: int,
    n: int,
    dpw: int,
    n_words: int,
):
    """Phase 1 of the run-aligned slab layout: ONE main sort + ONE
    pair-start compaction — no singleton/multi split, no run-size pass.

    Returns ``(pseq, prun, pcount, m2)`` in SORTED WINDOW SPACE (no
    compaction at all): per sorted window its sequence id, dense run
    rank, and pair count — the count of its (run, seq) group on the
    group's first window, 0 elsewhere — plus ``m2`` = the valid-window
    count (valid windows sort strictly before SENTINEL ones, so they form
    the prefix). Pair groups are contiguous in window space, so the
    run-aligned slab machinery indexes windows directly; the ~5% of
    windows that are not group heads scatter harmless zeros.

    Singleton runs flow through the slab gram like any other run: a
    single-entry column contributes exactly its c^2 diagonal term, so no
    separate diagonal path is needed (vs ``_pass_phase1``, which split
    them out to shrink the pair stream — measured on AImed the split
    removes only ~3% of pairs at the price of two extra full-length
    compaction sorts; the window-space form removes the remaining
    compaction sort too, leaving ONE sort per pass).
    """
    nfeat = windows.shape[0]
    _, sseq, svalid, _, new_pair, run_id = _hash_sort(
        windows, valid, seq_of, theta,
        base=base, code_min=code_min, n=n, dpw=dpw, n_words=n_words,
    )
    pos = jnp.arange(nfeat, dtype=jnp.int32)
    # next pair start strictly after each window, via one reverse cummin
    # (log-depth scan — far cheaper than the compaction sort it replaces)
    starts = jnp.where(new_pair, pos, jnp.int32(nfeat))
    rs = jax.lax.associative_scan(jnp.minimum, starts, reverse=True)
    next_after = jnp.concatenate(
        [rs[1:], jnp.full((1,), nfeat, jnp.int32)]
    )
    # the sentinel block (if any) begins with a pair start, so the last
    # valid group's count ends exactly at the first invalid window
    pair_count = jnp.where(new_pair & svalid, next_after - pos, 0)
    m2 = jnp.sum(svalid.astype(jnp.int32))
    return sseq, run_id, pair_count, m2


def _run_boundaries(
    prun: jnp.ndarray, m2: jnp.ndarray, *, width: int, s_bound: int
):
    """Pair-index boundaries of the run-aligned slabs.

    ``bnd[s]`` = first pair whose run rank >= s*width (so slab ``s``
    covers pairs [bnd[s], bnd[s+1]) — exactly the runs [s*width,
    (s+1)*width), never splitting a run). ``n_slabs`` = ceil(R / width).
    """
    nfeat = prun.shape[0]
    arange_f = jnp.arange(nfeat, dtype=jnp.int32)
    pr = jnp.where(arange_f < m2, prun, BIG)  # non-decreasing
    targets = jnp.arange(s_bound + 1, dtype=jnp.int32) * width
    bnd = jnp.searchsorted(pr, targets, side="left").astype(jnp.int32)
    n_runs = jnp.where(
        m2 > 0, jnp.take(prun, jnp.maximum(m2 - 1, 0), mode="clip") + 1, 0
    )
    n_slabs = (n_runs + width - 1) // width
    return bnd, n_slabs


def _slab_contrib_runs(
    s: jnp.ndarray,  # slab index (scalar int32)
    pseq: jnp.ndarray,
    prun: jnp.ndarray,
    pcount: jnp.ndarray,
    bnd: jnp.ndarray,  # [s_bound + 1] pair boundaries
    *,
    n: int,
    width: int,
    chunk: int,
    count_split: bool,
    tri_blocks: int = 0,
) -> jnp.ndarray:
    """[n, n] int32 contribution of run-aligned slab ``s``.

    The count matrix is [n, width] — width RUNS, not pairs, so its columns
    are fully dense in observed runs (the pair-aligned layout left ~90% of
    its 8192 columns zero on text data, paying ~10x the gram MACs). Pairs
    stream in over an inner chunk loop with a dynamic trip count. Because
    slabs never split a run, there is no cross-slab correction.
    """
    nfeat = pseq.shape[0]
    b0 = jnp.take(bnd, s, mode="clip")
    b1 = jnp.take(bnd, s + 1, mode="clip")
    r0 = s * width

    def chunk_body(c, cs):
        idx = b0 + c * chunk + jnp.arange(chunk, dtype=jnp.int32)
        live = idx < b1
        idx_c = jnp.clip(idx, 0, nfeat - 1)
        # dead lanes route to an out-of-range row and are dropped
        sq = jnp.where(live, jnp.take(pseq, idx_c, mode="clip"), n)
        rk = jnp.clip(jnp.take(prun, idx_c, mode="clip") - r0, 0, width - 1)
        ct = jnp.take(pcount, idx_c, mode="clip")
        return cs.at[sq, rk].add(ct.astype(jnp.float32), mode="drop")

    trips = (b1 - b0 + chunk - 1) // chunk
    # the zero init inherits pcount's varying-manual-axes type so the
    # fori carry types match when this runs inside shard_map (the body
    # mixes in device-varying pair arrays)
    zero = (jnp.take(pcount, 0, mode="clip") * 0).astype(jnp.float32)
    c_s = jax.lax.fori_loop(
        0, trips, chunk_body, jnp.zeros((n, width), jnp.float32) + zero
    )
    return _sym_gram(c_s, n, count_split, tri_blocks)


def _slab_contrib_runs_rows(
    s: jnp.ndarray,
    pseq: jnp.ndarray,
    prun: jnp.ndarray,
    pcount: jnp.ndarray,
    bnd: jnp.ndarray,
    row0: jnp.ndarray,  # traced: global row of this strip's first row
    *,
    n: int,
    n_pad: int,
    n_rows: int,
    width: int,
    chunk: int,
    count_split: bool,
) -> jnp.ndarray:
    """Row-strip ``[n_rows, n]`` of ``_slab_contrib_runs`` (the mesh unit:
    a device accumulating a kernel row block never materializes [n, n])."""
    nfeat = pseq.shape[0]
    b0 = jnp.take(bnd, s, mode="clip")
    b1 = jnp.take(bnd, s + 1, mode="clip")
    r0 = s * width

    def chunk_body(c, cs):
        idx = b0 + c * chunk + jnp.arange(chunk, dtype=jnp.int32)
        live = idx < b1
        idx_c = jnp.clip(idx, 0, nfeat - 1)
        sq = jnp.where(live, jnp.take(pseq, idx_c, mode="clip"), n_pad)
        rk = jnp.clip(jnp.take(prun, idx_c, mode="clip") - r0, 0, width - 1)
        ct = jnp.take(pcount, idx_c, mode="clip")
        return cs.at[sq, rk].add(ct.astype(jnp.float32), mode="drop")

    trips = (b1 - b0 + chunk - 1) // chunk
    # zero init inherits pcount's varying-manual-axes type (see
    # _slab_contrib_runs)
    zero = (jnp.take(pcount, 0, mode="clip") * 0).astype(jnp.float32)
    c_s = jax.lax.fori_loop(
        0, trips, chunk_body, jnp.zeros((n_pad, width), jnp.float32) + zero
    )
    ops_all = _count_ops(c_s[:n], count_split)
    ops_rows = tuple(
        jax.lax.dynamic_slice_in_dim(o, row0, n_rows, axis=0)
        for o in _count_ops(c_s, count_split)
    )
    return _gram_ops(ops_rows, ops_all, count_split)  # [n_rows, n]


def _count_ops(c_s: jnp.ndarray, count_split):
    """Matmul operand form of an f32 integer count block.

    ``count_split`` is a three-way static mode (bool kept for the two
    round-1..3 modes):

    - False: counts <= 255 are bf16-exact — one bf16 matmul with f32
      accumulation;
    - "f32x3": 255 < p_max <= 4095 — ONE f32 matmul at HIGHEST precision
      (true-f32 products and sums, never TF32). Exact because every
      per-pass entry — and, counts being
      nonnegative, every partial sum — is bounded by p_i*p_j < 2^24.
      Replaces the int8 digit trio + recombine below in the mid range,
      where the three [n, n] int32 combine planes (and the hl.T
      transpose) dominated the slab wall, not the MACs;
    - True: counts to p_max < 16384 split into base-128 digits, each
      < 128 so it fits SIGNED int8 — s8xs8->s32 dots are exact by
      construction.
      Digit bound: hi = c >> 7 <= p_max/128 <= 127. No int32 overflow:
      each reassembled term is bounded by the true per-pass entry
      K[i,j] <= p_i*p_j <= p_max^2 < 2^31."""
    if count_split is True:
        c_int = c_s.astype(jnp.int32)
        return ((c_int >> 7).astype(jnp.int8), (c_int & 127).astype(jnp.int8))
    if count_split == "f32x3":
        return (c_s,)
    return (c_s.astype(jnp.bfloat16),)


def _gram_ops(a_ops, b_ops, count_split):
    """Exact int32 ``A @ B^T`` on operand tuples from ``_count_ops``."""
    if count_split is True:
        hi_a, lo_a = a_ops
        hi_b, lo_b = b_ops
        pt = jnp.int32
        hh = jnp.matmul(hi_a, hi_b.T, preferred_element_type=pt)
        hl = jnp.matmul(hi_a, lo_b.T, preferred_element_type=pt)
        ll = jnp.matmul(lo_a, lo_b.T, preferred_element_type=pt)
        if a_ops is b_ops:
            # lo@hi^T == (hi@lo^T)^T for identical operands:
            # three matmuls, not four
            return hh * 16384 + (hl + hl.T) * 128 + ll
        lh = jnp.matmul(lo_a, hi_b.T, preferred_element_type=pt)
        return hh * 16384 + (hl + lh) * 128 + ll
    (cb_a,) = a_ops
    (cb_b,) = b_ops
    if count_split == "f32x3":
        return jnp.matmul(
            cb_a, cb_b.T, precision=jax.lax.Precision.HIGHEST
        ).astype(jnp.int32)
    return jnp.matmul(
        cb_a, cb_b.T, preferred_element_type=jnp.float32
    ).astype(jnp.int32)


def _sym_gram(c_s: jnp.ndarray, n: int, count_split: bool, tri_blocks: int):
    """Exact int32 ``c_s @ c_s^T`` for integer-valued f32 counts.

    ``tri_blocks >= 2`` computes only the upper-triangular row-block
    pairs (bi <= bj) — the symmetric half the caller mirrors at the end —
    saving (B-1)/(2B) of the matmul work. Entries strictly below the block
    diagonal are left zero; entries below the diagonal *inside* a
    diagonal block are computed (and equal their mirror)."""
    ops = [_count_ops(c_s, count_split)]

    def gram(a_ops, b_ops):
        return _gram_ops(a_ops, b_ops, count_split)

    if tri_blocks < 2 or n < 2 * tri_blocks:
        return gram(ops[0], ops[0])

    nb = -(-n // tri_blocks)
    row_ops = [
        tuple(o[bi * nb : (bi + 1) * nb] for o in ops[0])
        for bi in range(tri_blocks)
    ]
    ks = jnp.zeros((n, n), jnp.int32)
    for bi in range(tri_blocks):
        if not row_ops[bi][0].shape[0]:
            continue
        for bj in range(bi, tri_blocks):
            if not row_ops[bj][0].shape[0]:
                continue
            blk = gram(
                row_ops[bi],
                row_ops[bi] if bj == bi else row_ops[bj],
            )
            ks = jax.lax.dynamic_update_slice(ks, blk, (bi * nb, bj * nb))
    return ks


def _slab_contrib(
    s: jnp.ndarray,  # slab index (scalar int32)
    mseq: jnp.ndarray,
    mrank: jnp.ndarray,
    mcount: jnp.ndarray,
    m2: jnp.ndarray,
    *,
    n: int,
    slab: int,
    count_split: bool,
    tri_blocks: int = 0,
) -> jnp.ndarray:
    """[n, n] int32 contribution of slab ``s`` (zero when ``s`` is past
    this pass's own slab count — live/straddle masks are all false), so a
    batch of passes can run to the batch-wide max slab count."""
    nfeat = mseq.shape[0]
    idx_all = jnp.arange(slab, dtype=jnp.int32)
    n_win = ((n + 127) // 128) * 128  # boundary gather window, >= max run pairs

    s0 = s * slab
    idx = s0 + idx_all
    live = idx < m2
    seqs = jnp.take(mseq, idx, mode="clip")
    ranks = jnp.take(mrank, idx, mode="clip")
    cnts = jnp.where(live, jnp.take(mcount, idx, mode="clip"), 0)
    base_rank = jnp.take(mrank, s0, mode="clip")
    lrank = jnp.clip(ranks - base_rank, 0, slab - 1)

    c_s = jnp.zeros((n, slab), jnp.float32)
    # (rank, seq) is unique per compacted pair entry and the compaction
    # sort emits them in (rank, seq) order — both scatter hints hold
    c_s = c_s.at[seqs, lrank].add(
        cnts.astype(jnp.float32), unique_indices=True
    )
    ks = _sym_gram(c_s, n, count_split, tri_blocks)

    # cross-slab correction: the run containing pair s0 may straddle
    # the boundary; its (<= n) pairs live within +-n_win of s0
    straddle = (s > 0) & (
        jnp.take(mrank, s0, mode="clip")
        == jnp.take(mrank, jnp.maximum(s0 - 1, 0), mode="clip")
    ) & (s0 < m2)
    widx = jnp.arange(2 * n_win, dtype=jnp.int32) + s0 - n_win
    wlive = (widx >= 0) & (widx < m2)
    wrank = jnp.take(mrank, jnp.clip(widx, 0, nfeat - 1), mode="clip")
    wseq = jnp.take(mseq, jnp.clip(widx, 0, nfeat - 1), mode="clip")
    wcnt = jnp.take(mcount, jnp.clip(widx, 0, nfeat - 1), mode="clip")
    # A = the run's full prefix (earlier slabs); B = its part in THIS
    # slab only — summing A_b * B_b over boundaries yields each
    # cross-slab product exactly once even for runs spanning 3+ slabs
    in_run = wlive & (wrank == base_rank) & straddle
    a_mask = in_run & (widx < s0)
    b_mask = in_run & (widx >= s0) & (widx < s0 + slab)
    a_vec = jnp.zeros((n,), jnp.int32).at[wseq].add(
        jnp.where(a_mask, wcnt, 0)
    )
    b_vec = jnp.zeros((n,), jnp.int32).at[wseq].add(
        jnp.where(b_mask, wcnt, 0)
    )
    # int32 outer product: a*b <= p_i*p_j <= p_max^2 < 2^31 exactly
    # (an f32 product would round above 2^24, capping p_max at 4096)
    cross = a_vec[:, None] * b_vec[None, :]
    return ks + cross + cross.T


def _slab_contrib_rows(
    s: jnp.ndarray,
    mseq: jnp.ndarray,
    mrank: jnp.ndarray,
    mcount: jnp.ndarray,
    m2: jnp.ndarray,
    row0: jnp.ndarray,  # traced: global row of this strip's first row
    *,
    n: int,
    n_pad: int,  # >= n; row0 + n_rows <= n_pad (caller pads)
    n_rows: int,
    slab: int,
    count_split: bool,
) -> jnp.ndarray:
    """Row-strip ``[n_rows, n]`` of ``_slab_contrib``: the count matrix is
    built full (the sort is global), but only the strip's rows of the
    slab gram / cross-correction are computed, so a device accumulating a
    kernel row block never materializes [n, n]. Bit-identical to the
    corresponding rows of ``_slab_contrib(..., tri_blocks=0)``."""
    nfeat = mseq.shape[0]
    idx_all = jnp.arange(slab, dtype=jnp.int32)
    n_win = ((n + 127) // 128) * 128

    s0 = s * slab
    idx = s0 + idx_all
    live = idx < m2
    seqs = jnp.take(mseq, idx, mode="clip")
    ranks = jnp.take(mrank, idx, mode="clip")
    cnts = jnp.where(live, jnp.take(mcount, idx, mode="clip"), 0)
    base_rank = jnp.take(mrank, s0, mode="clip")
    lrank = jnp.clip(ranks - base_rank, 0, slab - 1)

    c_s = jnp.zeros((n_pad, slab), jnp.float32)
    c_s = c_s.at[seqs, lrank].add(
        cnts.astype(jnp.float32), unique_indices=True
    )
    ops_all = _count_ops(c_s[:n], count_split)
    ops_rows = tuple(
        jax.lax.dynamic_slice_in_dim(o, row0, n_rows, axis=0)
        for o in _count_ops(c_s, count_split)
    )
    ks = _gram_ops(ops_rows, ops_all, count_split)  # [n_rows, n]

    straddle = (s > 0) & (
        jnp.take(mrank, s0, mode="clip")
        == jnp.take(mrank, jnp.maximum(s0 - 1, 0), mode="clip")
    ) & (s0 < m2)
    widx = jnp.arange(2 * n_win, dtype=jnp.int32) + s0 - n_win
    wlive = (widx >= 0) & (widx < m2)
    wrank = jnp.take(mrank, jnp.clip(widx, 0, nfeat - 1), mode="clip")
    wseq = jnp.take(mseq, jnp.clip(widx, 0, nfeat - 1), mode="clip")
    wcnt = jnp.take(mcount, jnp.clip(widx, 0, nfeat - 1), mode="clip")
    in_run = wlive & (wrank == base_rank) & straddle
    a_mask = in_run & (widx < s0)
    b_mask = in_run & (widx >= s0) & (widx < s0 + slab)
    a_vec = jnp.zeros((n_pad,), jnp.int32).at[wseq].add(
        jnp.where(a_mask, wcnt, 0)
    )
    b_vec = jnp.zeros((n_pad,), jnp.int32).at[wseq].add(
        jnp.where(b_mask, wcnt, 0)
    )
    a_r = jax.lax.dynamic_slice_in_dim(a_vec, row0, n_rows)
    b_r = jax.lax.dynamic_slice_in_dim(b_vec, row0, n_rows)
    # row strip of (a b^T + b a^T)
    cross_r = a_r[:, None] * b_vec[None, :n] + b_r[:, None] * a_vec[None, :n]
    return ks + cross_r


@functools.partial(
    jax.jit,
    static_argnames=(
        "g", "base", "code_min", "n", "n_pad", "n_rows", "p", "slab",
        "dpw", "n_words", "count_split", "static_slabs", "tri_blocks",
        "layout", "run_width",
    ),
)
def sorted_theta_pass_batch_sum_rows(
    acc_rows: jnp.ndarray,  # [n_rows, n] int32 running row-strip sum
    windows: jnp.ndarray,
    valid: jnp.ndarray,
    seq_of: jnp.ndarray,
    thetas: jnp.ndarray,  # [T, k] int32
    live_t: jnp.ndarray,  # [T] int32 (0 = padding theta, contributes 0)
    row0: jnp.ndarray,  # traced scalar: global row offset of the strip
    *,
    n_pad: int,
    n_rows: int,
    **static,
) -> jnp.ndarray:
    """Row-strip variant of ``sorted_theta_pass_batch_sum``: adds the
    strip ``[row0:row0+n_rows, :n]`` of every live pass's kernel to
    ``acc_rows`` without ever materializing an [n, n] pass. This is the
    per-device unit of the rows-sharded mesh path
    (parallel/sharding.py:sorted_batch_rowsharded)."""
    static.pop("static_slabs", None)
    static.pop("tri_blocks", None)
    if static.get("layout", "pairs") == "runs":
        lanes, n_slabs, lane_r = _batch_phases_runs(
            windows, valid, seq_of, thetas, static, rows=True
        )
        livef_r = live_t.astype(jnp.int32)

        def body_runs(s, acc):
            ks = jax.vmap(
                lambda ps, pr, pc, bd: lane_r(
                    s, ps, pr, pc, bd, row0,
                    n_pad=n_pad, n_rows=n_rows,
                )
            )(*lanes)
            return acc + jnp.sum(ks * livef_r[:, None, None], axis=0)

        # thetas-derived zero: carry vma matches the body under shard_map
        return jax.lax.fori_loop(
            0, n_slabs, body_runs, acc_rows + jnp.take(thetas.ravel(), 0) * 0
        )
    diag, lanes, n_slabs, _ = _batch_phases(
        windows, valid, seq_of, thetas, dict(static, tri_blocks=0)
    )
    n = static["n"]
    slab = static["slab"]
    count_split = static["count_split"]
    livef = live_t.astype(jnp.int32)

    lane_rows = functools.partial(
        _slab_contrib_rows,
        n=n, n_pad=n_pad, n_rows=n_rows, slab=slab,
        count_split=count_split,
    )

    def body(s, acc):
        ks = jax.vmap(
            lambda ms, mr, mc, mm: lane_rows(s, ms, mr, mc, mm, row0)
        )(*lanes)
        return acc + jnp.sum(ks * livef[:, None, None], axis=0)

    # diagonal of singleton runs: strip rows get their diag entry at
    # column row0 + local_row
    diag_sum = jnp.sum(
        diag.astype(jnp.int32) * livef[:, None], axis=0
    )  # [n]
    diag_pad = jnp.pad(diag_sum, (0, n_pad - n))
    diag_r = jax.lax.dynamic_slice_in_dim(diag_pad, row0, n_rows)
    col = jnp.arange(n, dtype=jnp.int32)[None, :]
    row_g = row0 + jnp.arange(n_rows, dtype=jnp.int32)[:, None]
    init = acc_rows + jnp.where(col == row_g, diag_r[:, None], 0)
    return jax.lax.fori_loop(0, n_slabs, body, init)


def _sorted_theta_pass_core(
    windows: jnp.ndarray,
    valid: jnp.ndarray,
    seq_of: jnp.ndarray,
    theta: jnp.ndarray,  # [k] int32
    *,
    g: int,
    base: int,
    code_min: int,
    n: int,
    p: int,
    slab: int,
    dpw: int,
    n_words: int,
    count_split: bool,
    static_slabs: bool = False,
    tri_blocks: int = 0,
    layout: str = "pairs",
    run_width: int = 2048,
) -> jnp.ndarray:
    """One exact counting pass K_theta [n, n] int32 over subset ``theta``.

    ``layout`` picks the slab decomposition: "pairs" (pair-aligned slabs
    with cross-slab straddle corrections and a singleton fast path) or
    "runs" (run-aligned slabs of ``run_width`` runs, ``slab``-sized pair
    chunks — ~10x fewer gram MACs on text data, no corrections; integer-
    identical results). ``static_slabs`` replaces the data-dependent slab
    count with the static upper bound (extra iterations contribute exactly
    zero). ``tri_blocks >= 2`` returns only the upper block triangle (see
    ``_sym_gram``) — the caller mirrors."""
    nfeat = windows.shape[0]
    p1 = dict(base=base, code_min=code_min, n=n, dpw=dpw, n_words=n_words)
    if layout == "runs":
        pseq, prun, pcount, m2 = _pass_phase1_runs(
            windows, valid, seq_of, theta, **p1
        )
        s_bound = nfeat // run_width + 1
        bnd, n_slabs = _run_boundaries(
            prun, m2, width=run_width, s_bound=s_bound
        )
        if static_slabs:
            n_slabs = s_bound

        def slab_body_r(s, k_acc):
            return k_acc + _slab_contrib_runs(
                s, pseq, prun, pcount, bnd,
                n=n, width=run_width, chunk=slab,
                count_split=count_split, tri_blocks=tri_blocks,
            )

        return jax.lax.fori_loop(
            0, n_slabs, slab_body_r, jnp.zeros((n, n), jnp.int32)
        )

    diag, mseq, mrank, mcount, m2 = _pass_phase1(
        windows, valid, seq_of, theta, **p1
    )
    if static_slabs:
        n_slabs = (nfeat + slab - 1) // slab
    else:
        n_slabs = jnp.maximum((m2 + slab - 1) // slab, 0)

    def slab_body(s, k_acc):
        return k_acc + _slab_contrib(
            s, mseq, mrank, mcount, m2,
            n=n, slab=slab, count_split=count_split,
            tri_blocks=tri_blocks,
        )

    return jax.lax.fori_loop(0, n_slabs, slab_body, jnp.diag(diag))


_STATIC_NAMES = (
    "g", "base", "code_min", "n", "p", "slab", "dpw", "n_words",
    "count_split", "static_slabs", "tri_blocks", "layout", "run_width",
)

sorted_theta_pass = functools.partial(
    jax.jit, static_argnames=_STATIC_NAMES
)(_sorted_theta_pass_core)


def _batch_phases(windows, valid, seq_of, thetas, static):
    """vmapped phase-1 + the shared slab trip count for a theta batch.

    The slab loop's trip count is the batch-wide max of the per-pass pair
    counts — dynamic (a `while` in XLA), so a batch does max(m2)/slab
    iterations instead of the static worst case nfeat/slab (10x+ fewer on
    real text: most windows fall in singleton runs)."""
    p1 = {
        k: static[k] for k in ("base", "code_min", "n", "dpw", "n_words")
    }
    diag, mseq, mrank, mcount, m2 = jax.vmap(
        lambda th: _pass_phase1(windows, valid, seq_of, th, **p1)
    )(thetas)
    slab = static["slab"]
    n_slabs = jnp.maximum((jnp.max(m2) + slab - 1) // slab, 0)
    lane = functools.partial(
        _slab_contrib,
        n=static["n"], slab=slab, count_split=static["count_split"],
        tri_blocks=static.get("tri_blocks", 0),
    )
    return diag, (mseq, mrank, mcount, m2), n_slabs, lane


def _batch_phases_runs(windows, valid, seq_of, thetas, static, rows=False):
    """Run-aligned analogue of ``_batch_phases``: vmapped phase-1 +
    per-lane run boundaries + the batch-wide slab trip count. Returns
    ``(lanes, n_slabs, lane)`` — no diag (singletons flow through the
    slab grams in this layout)."""
    p1 = {
        k: static[k] for k in ("base", "code_min", "n", "dpw", "n_words")
    }
    pseq, prun, pcount, m2 = jax.vmap(
        lambda th: _pass_phase1_runs(windows, valid, seq_of, th, **p1)
    )(thetas)
    width = static["run_width"]
    s_bound = windows.shape[0] // width + 1
    bnd, n_slabs_l = jax.vmap(
        lambda pr, mm: _run_boundaries(
            pr, mm, width=width, s_bound=s_bound
        )
    )(prun, m2)
    n_slabs = jnp.max(n_slabs_l)
    kw = dict(
        n=static["n"], width=width, chunk=static["slab"],
        count_split=static["count_split"],
    )
    if rows:
        lane = functools.partial(_slab_contrib_runs_rows, **kw)
    else:
        lane = functools.partial(
            _slab_contrib_runs,
            tri_blocks=static.get("tri_blocks", 0),
            **kw,
        )
    return (pseq, prun, pcount, bnd), n_slabs, lane


@functools.partial(jax.jit, static_argnames=_STATIC_NAMES)
def sorted_theta_pass_batch(
    windows: jnp.ndarray,
    valid: jnp.ndarray,
    seq_of: jnp.ndarray,
    thetas: jnp.ndarray,  # [T, k] int32
    **static,
) -> jnp.ndarray:
    """T passes in one call: the multi-word sorts batch along the theta
    axis (one wide device sort instead of T serial ones) and the slab
    count-matmuls run batched. Returns [T, n, n] int32, each
    slice bit-identical to ``sorted_theta_pass`` on that theta."""
    static.pop("static_slabs", None)
    if static.get("layout", "pairs") == "runs":
        lanes, n_slabs, lane = _batch_phases_runs(
            windows, valid, seq_of, thetas, static
        )

        def body_r(s, acc):
            return acc + jax.vmap(
                lambda ps, pr, pc, bd: lane(s, ps, pr, pc, bd)
            )(*lanes)

        # + a thetas-derived zero: the carry inherits the body's
        # varying-manual-axes type under shard_map (see _slab_contrib_runs)
        init_r = jnp.zeros(
            (thetas.shape[0], static["n"], static["n"]), jnp.int32
        ) + jnp.take(thetas.ravel(), 0) * 0
        return jax.lax.fori_loop(0, n_slabs, body_r, init_r)
    diag, lanes, n_slabs, lane = _batch_phases(
        windows, valid, seq_of, thetas, static
    )

    def body(s, acc):
        return acc + jax.vmap(
            lambda ms, mr, mc, mm: lane(s, ms, mr, mc, mm)
        )(*lanes)

    init = jax.vmap(jnp.diag)(diag)
    return jax.lax.fori_loop(0, n_slabs, body, init)


@functools.partial(jax.jit, static_argnames=_STATIC_NAMES)
def sorted_theta_pass_batch_sum(
    acc: jnp.ndarray,  # [n, n] int32 running sum
    windows: jnp.ndarray,
    valid: jnp.ndarray,
    seq_of: jnp.ndarray,
    thetas: jnp.ndarray,  # [T, k] int32
    **static,
) -> jnp.ndarray:
    """``acc + sum_T pass(theta_t)`` fused in one dispatch: the
    skip-variance/exact stream never needs the per-theta slices, so only
    the [n, n] accumulator lands in HBM. Bit-identical to summing the
    batch slices (int32 adds commute; overflow is excluded by the
    caller's spill bound)."""
    static.pop("static_slabs", None)
    if static.get("layout", "pairs") == "runs":
        lanes, n_slabs, lane = _batch_phases_runs(
            windows, valid, seq_of, thetas, static
        )

        def body_r(s, k_acc):
            ks = jax.vmap(
                lambda ps, pr, pc, bd: lane(s, ps, pr, pc, bd)
            )(*lanes)
            return k_acc + jnp.sum(ks, axis=0)

        # thetas-derived zero: carry vma matches the body under shard_map
        return jax.lax.fori_loop(
            0, n_slabs, body_r, acc + jnp.take(thetas.ravel(), 0) * 0
        )
    diag, lanes, n_slabs, lane = _batch_phases(
        windows, valid, seq_of, thetas, static
    )

    def body(s, k_acc):
        ks = jax.vmap(lambda ms, mr, mc, mm: lane(s, ms, mr, mc, mm))(
            *lanes
        )
        return k_acc + jnp.sum(ks, axis=0)

    init = acc + jnp.sum(jax.vmap(jnp.diag)(diag), axis=0)
    return jax.lax.fori_loop(0, n_slabs, body, init)
