"""Sort/rank counting pass over a huge k-mer space, in PyTorch.

Counterpart of ``fastsk_tpu/ops/sorted_theta.py`` in its "runs" layout
(the JAX default). The dense engine (ops/gkm.py) histograms every
sequence over all ``base**k`` buckets, which is impossible for
protein/text alphabets at large k. One pass here does what the
reference's LSD counting sort and run walk do (shared.cpp:156-333):

1. hash every window's projected k-mer into int64 words (lexicographic
   order kept; the sequence id packs into the last word's low bits when
   it fits) and sort them: equal k-mers form runs and, within a run,
   equal sequences form pairs (sequence, count);
2. a run held by one sequence (a singleton run) adds only count^2 to that
   sequence's diagonal entry;
3. the other runs, densely re-ranked, go in run-aligned slabs of
   ``run_width`` runs: the slab's count matrix ``C_s [n, run_width]``
   (pairs scattered in chunks of ``slab``) adds ``C_s C_s^T``. Slabs never
   split a run, so no cross-slab correction is needed.

``lax.sort`` over several keys has no torch counterpart: one
``torch.sort`` of the packed int64 key does it when the key fits 62 bits,
else stable sorts least significant word first. The TPU-shaped
compaction sorts become ``torch.nonzero``. Integers equal the JAX
package's.

Exactness: count matrices are integer-valued; a pass's entries are at most
``p_max^2``. Products take bf16 operands with f32 outputs when the pass's
largest count fits bf16 (<= 256) on the card, f32 (no TF32) otherwise,
both exact below 2^24 (``p_max <= 4095``), and f64 past that
(``count_split``, the JAX package's int8 digit range): exact below 2^53.

A pass's two stages are the spans ``sorted.sort`` (phase 1) and
``sorted.products`` (the slab products) of ``utils/observe.py``; the
counters ``sorted.passes`` and ``sorted.slabs`` count the passes and the
slab products, always on, from values the host already holds.
"""

from __future__ import annotations

import math
from typing import List, Tuple

import torch

from ..utils.observe import count, span
from .gkm import gram

_WORD_BITS = 62  # each int64 word (and a packed key) stays below 2^62


def hash_plan(base: int, k: int) -> Tuple[int, int]:
    """(digits_per_word, n_words) so each int64 word stays below 2^62 (the
    JAX package's words are 31-bit)."""
    dpw = max(1, int(math.floor(_WORD_BITS / math.log2(max(base, 2)))))
    dpw = min(dpw, k)
    return dpw, -(-k // dpw)


def _diff_prev(x: torch.Tensor) -> torch.Tensor:
    """True where an entry differs from the one before it (and at 0)."""
    out = torch.ones(x.shape[0], dtype=torch.bool, device=x.device)
    out[1:] = x[1:] != x[:-1]
    return out


def _hash_sort(
    windows: torch.Tensor,  # [nfeat, g] int32, valid windows only
    seq_of: torch.Tensor,  # [nfeat] int64
    theta: torch.Tensor,  # [k] int64
    *,
    base: int,
    code_min: int,
    n: int,
    dpw: int,
    n_words: int,
):
    """Hash every window's projected k-mer and sort by (k-mer, sequence).

    Returns ``(sseq, new_run, new_pair)`` over the sorted window order: the
    sequence ids and the run and pair start flags."""
    k = theta.shape[0]
    proj = windows[:, theta].to(torch.int64) - code_min  # [nfeat, k]
    words: List[torch.Tensor] = []
    for w in range(n_words):
        word = proj[:, w * dpw]
        for j in range(w * dpw + 1, min(w * dpw + dpw, k)):
            word = word * base + proj[:, j]
        words.append(word)
    seq_bits = max(n, 2).bit_length()
    last_digits = k - (n_words - 1) * dpw
    packed = (base**last_digits) << seq_bits <= 1 << _WORD_BITS
    keys = words[:-1] + [(words[-1] << seq_bits) | seq_of] if packed else words + [seq_of]
    # lexicographic order: stable sorts, least significant key first (one
    # sort when everything packs into one word)
    order = None
    for key in reversed(keys):
        idx = torch.sort(key if order is None else key[order], stable=True).indices
        order = idx if order is None else order[idx]
    skeys = [key[order] for key in keys]
    if packed:
        sseq = skeys[-1] & ((1 << seq_bits) - 1)
        run_words = skeys[:-1] + [skeys[-1] >> seq_bits]
    else:
        sseq = skeys[-1]
        run_words = skeys[:-1]
    new_run = _diff_prev(run_words[0])
    for w in run_words[1:]:
        new_run |= _diff_prev(w)
    return sseq, new_run, new_run | _diff_prev(sseq)


def _pass_phase1(windows, seq_of, theta, *, base, code_min, n, dpw, n_words):
    """Hash, sort and run detection for one pass: everything before the
    slab products. Returns ``(diag, mseq, mrank, mcount)``: the singleton
    runs' ``[n]`` diagonal, and the pairs of the runs held by two or more
    sequences in (run, sequence) order, runs densely ranked from 0."""
    nfeat = windows.shape[0]
    sseq, new_run, new_pair = _hash_sort(
        windows, seq_of, theta, base=base, code_min=code_min, n=n, dpw=dpw, n_words=n_words,
    )
    pstart = torch.nonzero(new_pair).squeeze(1)
    m_pairs = pstart.shape[0]
    pcount = torch.diff(pstart, append=pstart.new_tensor([nfeat]))
    pseq = sseq[pstart]
    first = new_run[pstart]  # the first pair of its run
    rstart = torch.nonzero(first).squeeze(1)
    rsize = torch.diff(rstart, append=rstart.new_tensor([m_pairs]))
    single = torch.repeat_interleave(rsize == 1, rsize, output_size=m_pairs)
    diag = torch.zeros(n, dtype=torch.int64, device=windows.device)
    diag.index_add_(0, pseq[single], pcount[single] ** 2)
    multi = ~single
    mrank = torch.cumsum(first[multi], 0) - 1
    count("sorted.passes")
    return diag, pseq[multi], mrank, pcount[multi]


def _slab_counts(s, mseq, mrank, mcount, bnd, *, n, width, chunk, dtype) -> torch.Tensor:
    """Count matrix ``[n, width]`` of run-aligned slab ``s``: its pairs
    (``bnd[s]`` to ``bnd[s + 1]``) scattered ``chunk`` at a time; each
    (sequence, run) pair is unique, so no scatter adds up."""
    c_s = torch.zeros((n, width), dtype=dtype, device=mseq.device)
    for c0 in range(bnd[s], bnd[s + 1], chunk):
        c1 = min(c0 + chunk, bnd[s + 1])
        c_s[mseq[c0:c1], mrank[c0:c1] - s * width] = mcount[c0:c1].to(dtype)
    return c_s


def pass_products(diag, mseq, mrank, mcount, *, n, run_width, slab, count_split, row0=0,
                  n_rows=None):
    """The slab products of one pass after phase 1: rows ``[row0, row0 +
    n_rows)`` of ``K_theta``, ``[n_rows, n]`` int32 (the whole ``[n, n]``
    pass by default). A strip cuts each slab product's left operand to its
    rows and the singleton-run diagonal to the strip, and never builds the
    ``[n, n]`` pass; its rows past ``n`` are zero. The "runs"-layout
    counterpart of ``fastsk_tpu/ops/sorted_theta.py:
    sorted_theta_pass_batch_sum_rows`` for one pass."""
    n_rows = n if n_rows is None else n_rows
    r1 = max(row0, min(row0 + n_rows, n))
    acc = torch.zeros((n_rows, n), dtype=torch.float64 if count_split else torch.float32,
                      device=diag.device)
    n_runs = 0
    if mrank.shape[0]:
        # one host read a pass: the slab bounds and the largest count
        bounds = torch.searchsorted(
            mrank, torch.arange(0, int(mrank[-1]) + 1 + run_width, run_width, device=mrank.device)
        )
        n_runs = bounds.shape[0] - 1
        bnd = bounds.tolist()
    count("sorted.slabs", n_runs)
    if n_runs:
        if count_split:
            dtype = torch.float64
        elif diag.is_cuda and int(mcount.max()) <= 256:
            dtype = torch.bfloat16
        else:
            dtype = torch.float32
        for s in range(n_runs):
            c_s = _slab_counts(s, mseq, mrank, mcount, bnd, n=n, width=run_width,
                               chunk=slab, dtype=dtype)
            acc[: r1 - row0] += gram(c_s[row0:r1], c_s)
    ks = acc.to(torch.int32)
    ks.diagonal(offset=row0).add_(diag[row0:r1].to(torch.int32))
    return ks


def sorted_theta_pass(
    windows: torch.Tensor,
    seq_of: torch.Tensor,
    theta: torch.Tensor,  # [k] int64
    *,
    base: int,
    code_min: int,
    n: int,
    slab: int,
    dpw: int,
    n_words: int,
    count_split: bool,
    run_width: int = 2048,
    row0: int = 0,
    n_rows=None,
) -> torch.Tensor:
    """One exact counting pass over subset ``theta``: ``K_theta [n, n]``
    int32, or its row strip ``[row0, row0 + n_rows)`` (``pass_products``)."""
    with span("sorted.sort"):
        diag, mseq, mrank, mcount = _pass_phase1(
            windows, seq_of, theta, base=base, code_min=code_min, n=n, dpw=dpw, n_words=n_words,
        )
    with span("sorted.products"):
        return pass_products(diag, mseq, mrank, mcount, n=n, run_width=run_width, slab=slab,
                             count_split=count_split, row0=row0, n_rows=n_rows)
