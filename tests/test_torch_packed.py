"""The port's packed (ragged) exact engine against the JAX package, on the CPU.

Same numpy-seeded inputs through ``fastsk_tpu``'s ``PackedPairsEngine``
(the XLA backend, and kernels D, E and G in Pallas interpret mode) and
``fastsk_tpu_torch``'s, where the wrappers of kernels D, E and G run their
plain versions. Counts are integers: the tolerance is equality. The
whole-slice test holds AUC within 1e-6 and accuracy equal, as
``tests/test_torch_slice.py`` does.
"""

import math

import numpy as np
import pytest
import torch

import fastsk_tpu as J
import fastsk_tpu_torch as T
from fastsk_tpu.kernel.pairs_engine import PackedPairsEngine as JPacked
from fastsk_tpu_torch.kernel.pairs_engine import PackedPairsEngine, PairsGkmEngine
from fastsk_tpu_torch.ops import pairs_packed, pairs_packed_cuda
from fastsk_tpu_torch.ops.encode import encode_sequences
from fastsk_tpu_torch.utils.observe import counters

import oracle
from conftest import random_ragged_seqs

CPU = dict(device="cpu")


@pytest.fixture
def small_tile(monkeypatch):
    """64-row strips in both packages, as tests/test_packed_engine.py does."""
    monkeypatch.setattr(JPacked, "TILE", 64)
    monkeypatch.setattr(PackedPairsEngine, "TILE", 64)


def _port(X, g, m, **cfg):
    return PackedPairsEngine(encode_sequences(X), g, m, T.KernelConfig(**CPU, **cfg))


# the shapes of tests/test_packed_engine.py::test_packed_matches_oracle
@pytest.mark.parametrize(
    "g,m,n,lmin,lmax,alpha",
    [
        (6, 3, 9, 8, 30, 4),
        (5, 2, 12, 6, 60, 3),
        (8, 4, 10, 10, 40, 20),  # protein-sized alphabet
        (6, 5, 14, 7, 25, 30),  # text-sized alphabet
    ],
)
def test_packed_matches_jax_and_oracle(rng, small_tile, g, m, n, lmin, lmax, alpha):
    X = random_ragged_seqs(rng, n, lmin, lmax, alphabet=alpha)
    eng = _port(X, g, m)
    assert eng.route == "band"
    got = eng.exact()
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, oracle.exact_counts(X, g, m))
    np.testing.assert_array_equal(got, JPacked(encode_sequences(X), g, m).exact())


@pytest.mark.parametrize(
    "route,jax_backend,pairlist",
    [
        ("band", "pallas_interpret", False),  # kernel D
        ("pairlist", "pallas_interpret", True),  # kernel E
        ("grouped", "pallas_grouped_interpret", False),  # kernel G
    ],
)
def test_routes_match_jax_pallas_interpret(
    rng, small_tile, monkeypatch, route, jax_backend, pairlist
):
    """Each route of the port against the JAX Pallas kernel it replaces,
    on sequences that straddle strips."""
    if pairlist:
        monkeypatch.setenv("FASTSK_PACKED_PAIRLIST", "1")
    X = random_ragged_seqs(rng, 8, 60, 150, alphabet=4)
    enc = encode_sequences(X)
    jeng = JPacked(enc, 6, 3, J.KernelConfig(pairs_backend=jax_backend))
    eng = PackedPairsEngine(
        enc, 6, 3,
        T.KernelConfig(
            pairs_backend="pallas_grouped" if route == "grouped" else "pallas", **CPU
        ),
    )
    assert eng.route == route and eng.n_strips > 5
    np.testing.assert_array_equal(eng.exact(), jeng.exact())


@pytest.mark.parametrize("route", ["band", "pairlist", "grouped"])
def test_routes_straddling_match_oracle(rng, small_tile, monkeypatch, route):
    if route == "pairlist":
        monkeypatch.setenv("FASTSK_PACKED_PAIRLIST", "1")
    backend = "pallas_grouped" if route == "grouped" else "auto"
    X = random_ragged_seqs(rng, 6, 100, 200, alphabet=4)
    eng = _port(X, 6, 3, pairs_backend=backend)
    assert eng.route == route and eng.n_strips > 5
    np.testing.assert_array_equal(eng.exact(), oracle.exact_counts(X, 6, 3))


def test_two_digit_weights(rng, small_tile):
    """C(12, 6) = 924: two digit planes in the JAX package, plain int64
    here."""
    X = random_ragged_seqs(rng, 8, 18, 40, alphabet=4)
    want = oracle.exact_counts(X, 12, 6)
    np.testing.assert_array_equal(_port(X, 12, 6).exact(), want)
    np.testing.assert_array_equal(JPacked(encode_sequences(X), 12, 6).exact(), want)


def test_repetitive_and_mixed(rng, small_tile):
    X = [[1] * 150, [1] * 150, [1, 2, 3, 4] * 40]
    X += random_ragged_seqs(rng, 8, 8, 160, alphabet=4)
    want = oracle.exact_counts(X, 5, 2)
    np.testing.assert_array_equal(_port(X, 5, 2).exact(), want)
    np.testing.assert_array_equal(JPacked(encode_sequences(X), 5, 2).exact(), want)


def test_int64_fallback(small_tile):
    """Two sequences of 130 equal codes at g=20, m=10: every entry is
    111^2 * C(20, 10) > 2^31, so both packages return host int64."""
    X = [[3] * 130, [3] * 130]
    enc = encode_sequences(X)
    want = np.full((2, 2), 111**2 * math.comb(20, 10), dtype=np.int64)
    assert want[0, 0] >= 2**31
    got = PackedPairsEngine(enc, 20, 10, T.KernelConfig(**CPU)).exact_device()
    ref = JPacked(enc, 20, 10).exact_device()
    for counts in (got, ref):
        assert isinstance(counts, np.ndarray) and counts.dtype == np.int64
        np.testing.assert_array_equal(counts, want)
    fsk = T.FastSK(20, 10, config=T.KernelConfig(device_resident=True, **CPU))
    fsk.compute_train(X)
    np.testing.assert_array_equal(fsk.kernel_counts, want)


def test_api_routes_ragged_to_packed(rng):
    X = random_ragged_seqs(rng, 10, 8, 80, alphabet=4)
    fsk = T.FastSK(6, 2, config=T.KernelConfig(**CPU))
    assert isinstance(fsk._make_exact_engine(encode_sequences(X)), PackedPairsEngine)
    fsk.compute_train(X)
    ref = J.FastSK(6, 2)
    ref.compute_train(X)
    np.testing.assert_array_equal(fsk.kernel_counts, ref.kernel_counts)


def test_api_guard_rejected_falls_to_packed(rng):
    """Over the sequence-aligned int32 bound (g=16, m=10 at length 800)."""
    X = [rng.integers(1, 5, size=800).tolist() for _ in range(3)]
    enc = encode_sequences(X)
    fsk = T.FastSK(16, 10, config=T.KernelConfig(**CPU))
    assert isinstance(fsk._make_exact_engine(enc), PackedPairsEngine)
    assert type(J.FastSK(16, 10)._make_exact_engine(enc)).__name__ == "PackedPairsEngine"


def test_kernel_a_width_limit_routes_to_packed():
    """Uniform-length text at g=11 over 56 codes: a 616-byte one-hot row,
    past the 512 bytes kernel A once took. Both packages now take their
    sequence-aligned engine (kernel A streams the depth in 64-byte
    slabs), and the counts equal the JAX package's, through the API and
    through ``exact_engine="pairs"``."""
    rng = np.random.default_rng(5)
    X = rng.integers(1, 57, size=(6, 24))
    X[:, 0], X[:, 1] = 1, 56  # the full code range, so hash_base = 56
    X = X.tolist()
    enc = encode_sequences(X)
    assert enc.hash_base == 56
    fsk = T.FastSK(11, 4, config=T.KernelConfig(**CPU))
    assert isinstance(fsk._make_exact_engine(enc), PairsGkmEngine)
    fsk.compute_train(X)
    ref = J.FastSK(11, 4)
    assert type(ref._make_exact_engine(enc)).__name__ == "PairsGkmEngine"
    ref.compute_train(X)
    np.testing.assert_array_equal(fsk.kernel_counts, ref.kernel_counts)
    forced = T.FastSK(11, 4, config=T.KernelConfig(exact_engine="pairs", **CPU))
    assert isinstance(forced._make_exact_engine(enc), PairsGkmEngine)
    forced.compute_train(X)
    np.testing.assert_array_equal(forced.kernel_counts, ref.kernel_counts)


def test_kernel_a_shared_memory_limit():
    """Uniform proteins of length 1000 at g=10 over 24 codes: 992 x 256 B
    of windows per sequence, past a block's shared memory. Kernel A
    streams them in ranges of j windows, so the sequence-aligned engine
    builds in both packages with equal counts; only the int32 bound
    (g=16, m=8 on the same set) still refuses it, in both, and the API
    then takes the packed engine."""
    X = np.random.default_rng(6).integers(1, 25, size=(3, 1000)).tolist()
    enc = encode_sequences(X)
    got = PairsGkmEngine(enc, 10, 4, T.KernelConfig(**CPU)).exact()
    np.testing.assert_array_equal(got, J.kernel.pairs_engine.PairsGkmEngine(enc, 10, 4).exact())
    fsk = T.FastSK(10, 4, config=T.KernelConfig(**CPU))
    assert isinstance(fsk._make_exact_engine(enc), PairsGkmEngine)
    assert type(J.FastSK(10, 4)._make_exact_engine(enc)).__name__ == "PairsGkmEngine"
    with pytest.raises(ValueError, match="int32"):
        PairsGkmEngine(enc, 16, 8, T.KernelConfig(**CPU))
    with pytest.raises(ValueError, match="int32"):
        J.kernel.pairs_engine.PairsGkmEngine(enc, 16, 8)
    assert isinstance(T.FastSK(16, 8, config=T.KernelConfig(**CPU))._make_exact_engine(enc), PackedPairsEngine)
    assert type(J.FastSK(16, 8)._make_exact_engine(enc)).__name__ == "PackedPairsEngine"


def _ragged_labelled(seed: int, n: int):
    """Ragged sequences over 20 codes; positives carry a planted motif."""
    rng = np.random.default_rng(seed)
    y = rng.integers(0, 2, size=n)
    X = []
    for label in y:
        s = rng.integers(1, 21, size=int(rng.integers(12, 60)))
        if label:
            at = int(rng.integers(0, len(s) - 8 + 1))
            s[at : at + 8] = [3, 7, 1, 9, 4, 4, 12, 5]
        X.append(s.tolist())
    return X[: 3 * n // 4], X[3 * n // 4 :], y[: 3 * n // 4], y[3 * n // 4 :]


@pytest.mark.parametrize("device_resident", [False, True])
def test_ragged_slice_matches_jax(device_resident):
    Xtr, Xte, ytr, yte = _ragged_labelled(21, 64)
    j = J.FastSK(6, 2, config=J.KernelConfig(device_resident=device_resident))
    t = T.FastSK(6, 2, config=T.KernelConfig(device_resident=device_resident, **CPU))
    for f in (j, t):
        f.compute_kernel(Xtr, Xte, ytr, yte)
    assert isinstance(t._make_exact_engine(encode_sequences(Xtr, Xte)), PackedPairsEngine)
    np.testing.assert_array_equal(t.kernel_counts, j.kernel_counts)
    for f in (j, t):
        f.fit(C=1.0)
    assert abs(t.score("auc") - j.score("auc")) <= 1e-6
    assert t.score("accuracy") == j.score("accuracy")


def test_config_routes():
    assert T.KernelConfig(pairs_backend="pallas_grouped").pairs_backend == "pallas_grouped"
    T.KernelConfig(pairs_backend="pallas", exact_engine="packed")
    for refused in ("xla", "pallas_interpret", "pallas_grouped_interpret"):
        with pytest.raises(ValueError, match="plain versions run only"):
            T.KernelConfig(pairs_backend=refused)


def test_wrappers_check_inputs_and_count_no_cpu_launch(rng, small_tile):
    eng = _port(random_ragged_seqs(rng, 5, 20, 90, alphabet=4), 6, 3)
    rows = eng.rows()
    before = (
        counters()["packed_band.launches"],
        counters()["packed_pairlist.launches"],
        counters()["packed_grouped.launches"],
    )
    pairs_packed_cuda.packed_band(rows, k=3, n_out=eng.n)
    pairs_packed_cuda.packed_pairlist(rows, torch.tensor([0]), torch.tensor([1]), k=3)
    pairs_packed_cuda.packed_grouped(rows, 0, 0, k=3, group=2)
    after = (
        counters()["packed_band.launches"],
        counters()["packed_pairlist.launches"],
        counters()["packed_grouped.launches"],
    )
    assert after == before  # CPU path: no launch
    with pytest.raises(ValueError, match="k <= g"):
        pairs_packed_cuda.packed_band(rows, k=0, n_out=eng.n)
    with pytest.raises(ValueError, match="outside"):
        pairs_packed_cuda.packed_grouped(rows, 0, eng.n_strips, k=3, group=1)
    with pytest.raises(ValueError, match="one-byte"):
        pairs_packed_cuda.PackedRows(
            rows.codes, rows.seq_of, rows.first_seq, rows.tile, rows.c_pad, 300
        )


def _emulate_kernels(rows: pairs_packed_cuda.PackedRows, k: int, n: int):
    """numpy model of what kernels D and E compute from the operands their
    wrappers build (code planes, padded seq_of, tile metadata): D's upper
    tile triangle with mirrored off-diagonal bins, and E's pair list over
    every upper strip pair in tiles of ``sub_tile()`` rows, into part
    blocks."""
    band = np.zeros((n, n), np.int64)
    nt = rows.planes.shape[0] // ROW
    _emulate_block(rows, rows, k, _Walk(0, nt * ROW, 0, nt * ROW, True), _ALL,
                   _land_matrix(band, 0, True), grid=3)
    ns = rows.n_strips
    pa, pb = (v.numpy() for v in torch.triu_indices(ns, ns))
    tr = rows.sub_tile()
    parts = np.zeros((len(pa), rows.c_pad, rows.c_pad), np.int64)
    walk = _Walk.pairlist(pa, pb, rows.tile // tr)
    _emulate_block(rows, rows, k, walk, _ALL, _land_list_parts(parts, walk, rows.first_seq.numpy()),
                   grid=5, tr=tr)
    return band, parts, pa, pb


@pytest.mark.parametrize("tile", [64, 256])
def test_kernel_model_matches_plain(rng, monkeypatch, tile):
    """The kernels' operands and landing rules, modelled in numpy: D's
    upper-tile sweep with mirrored off-diagonal bins, and E's part blocks
    landed by ``land_parts``, both equal the plain version and the oracle
    on straddling sequences (g=7: the code planes' bits past g zero)."""
    monkeypatch.setattr(PackedPairsEngine, "TILE", tile)
    X = random_ragged_seqs(rng, 7, 20, 200, alphabet=5)
    eng = _port(X, 7, 3)
    rows = eng.rows()
    band, parts, pa, pb = _emulate_kernels(rows, eng.k, eng.n)
    plain = pairs_packed_cuda.packed_band(rows, k=eng.k, n_out=eng.n).numpy()
    np.testing.assert_array_equal(band, plain)
    order = eng.order
    want = oracle.exact_counts(X, 7, 3)[np.ix_(order, order)]
    np.testing.assert_array_equal(band, want)
    np.testing.assert_array_equal(
        parts,
        pairs_packed.packed_pair_parts_plain(
            rows.onehot, rows.seq_of, rows.first_seq, pa, pb,
            k=eng.k, tile=rows.tile, c_pad=rows.c_pad,
        ).numpy(),
    )
    mat = torch.zeros((eng.n + eng.c_pad,) * 2, dtype=torch.int64)
    pa_t, pb_t = torch.from_numpy(pa), torch.from_numpy(pb)
    pairs_packed.land_parts(
        mat, torch.from_numpy(parts), rows.first_seq[pa_t], rows.first_seq[pb_t], pb_t > pa_t
    )
    np.testing.assert_array_equal(mat[: eng.n, : eng.n].numpy(), want)


def poly_a_seqs(rng):
    """Homopolymers of the lowest code and DNA with poly-A runs of 20-60,
    one of the two homopolymers with a window count not a multiple of 8
    at each g = 17-20."""
    X = [[1] * 130, [1] * 131, [4] * 40]
    for length in (90, 155, 203):
        s = rng.integers(1, 5, size=length)
        at = int(rng.integers(0, length - 60))
        s[at : at + int(rng.integers(20, 61))] = 1
        X.append(s.tolist())
    return X


def _window_pair_counts(X, g, k):
    """Exact counts by brute force over window pairs: C(matches, k) with
    the codes compared directly."""
    wins = [np.array([s[p : p + g] for p in range(len(s) - g + 1)]) for s in X]
    comb = np.array([math.comb(d, k) for d in range(g + 1)], dtype=np.int64)
    return np.array([[comb[(a[:, None, :] == b[None, :, :]).sum(-1)].sum() for b in wins] for a in wins])


# g = 17 to 20 at small k: the code planes leave only 32 - g bits past g,
# so a padding row must weigh nothing by its mask, not by those bits,
# against valid rows that match it in nearly every place
@pytest.mark.parametrize("g,m", [(17, 16), (18, 12), (19, 11), (20, 12), (20, 19)])
def test_kernel_model_padding_rows_weigh_nothing(rng, monkeypatch, g, m):
    """D's and E's models (kernel E in 64-row tiles, into part blocks then
    landed) equal the plain version and the oracle on homopolymers of the
    lowest code and poly-A runs, at g = 17-20 and k = 1-8, with sequences
    whose last group of 8 rows holds padding."""
    monkeypatch.setattr(PackedPairsEngine, "TILE", 64)
    X = poly_a_seqs(rng)
    eng = _port(X, g, m)
    rows = eng.rows()
    assert (eng.pack["p"] % 8).any()
    band, parts, pa, pb = _emulate_kernels(rows, eng.k, eng.n)
    want = _window_pair_counts(X, g, g - m)[np.ix_(eng.order, eng.order)]
    if g - m <= 2:  # the oracle sums C(g, k) position subsets: small k only
        np.testing.assert_array_equal(want, oracle.exact_counts(X, g, m)[np.ix_(eng.order, eng.order)])
    np.testing.assert_array_equal(band, want)
    np.testing.assert_array_equal(pairs_packed_cuda.packed_band(rows, k=eng.k, n_out=eng.n).numpy(), want)
    mat = torch.zeros((eng.n + eng.c_pad,) * 2, dtype=torch.int64)
    pa_t, pb_t = torch.from_numpy(pa), torch.from_numpy(pb)
    pairs_packed.land_parts(
        mat, torch.from_numpy(parts), rows.first_seq[pa_t], rows.first_seq[pb_t], pb_t > pa_t
    )
    np.testing.assert_array_equal(mat[: eng.n, : eng.n].numpy(), want)


def _land_list_parts(out, walk, fs):
    """Kernel E's part blocks: slot s's bins at out[s, si - fs[pa[s]],
    sj - fs[pb[s]]]."""
    def land(bins, fi, fj, ti, tj, L):
        s = walk.slot(L)
        fa, fb = fs[walk.pa[s]], fs[walk.pb[s]]
        for (i, j), v in np.ndenumerate(bins):
            if v:
                out[s, fi + i - fa, fj + j - fb] += v
    return land


def _land_list_matrix(out, walk):
    """Kernel E's matrix landing: bins at (si, sj), and where pb[s] > pa[s]
    also at (sj, si); a diagonal slot holds both orders and lands once."""
    def land(bins, fi, fj, ti, tj, L):
        s = walk.slot(L)
        mirror = walk.pb[s] > walk.pa[s]
        for (i, j), v in np.ndenumerate(bins):
            if v:
                out[fi + i, fj + j] += v
                if mirror:
                    out[fj + j, fi + i] += v
    return land


@pytest.mark.parametrize("kind", ["upper", "mixed"])
@pytest.mark.parametrize("tile", [64, 256])
def test_kernel_e_matrix_landing_model(rng, monkeypatch, tile, kind):
    """Kernel E landing straight into the count matrix, modelled in numpy
    (each slot mirrored where pb[s] > pa[s]) on straddling sequences, in
    tiles of 64 rows (64-row strips) or 128 (two a 256-row strip): over
    the upper list of strip pairs it is the oracle's matrix; over a list
    with diagonal, reversed (b < a) and repeated slots it is
    ``land_parts`` of the plain part blocks; the CPU wrapper with ``out``
    lands the same."""
    monkeypatch.setattr(PackedPairsEngine, "TILE", tile)
    X = random_ragged_seqs(rng, 9, 20, 300, alphabet=6)
    eng = _port(X, 7, 3)
    rows = eng.rows()
    ns = eng.n_strips
    assert ns >= 4 and straddles(eng)
    if kind == "upper":
        pa, pb = (v.numpy() for v in torch.triu_indices(ns, ns))
    else:
        pa = np.array([0, 2, ns - 1, 1, 1, 3, 0])
        pb = np.array([0, 1, 0, 3, 3, 3, ns - 1])
    tr = rows.sub_tile()
    assert tr == min(tile, ROW)
    walk = _Walk.pairlist(pa, pb, tile // tr)
    m = eng.n + eng.c_pad
    got = np.zeros((m, m), np.int64)
    _emulate_block(rows, rows, eng.k, walk, _ALL, _land_list_matrix(got, walk), grid=4, tr=tr)
    pa_t, pb_t = torch.from_numpy(pa), torch.from_numpy(pb)
    want = torch.zeros((m, m), dtype=torch.int64)
    parts = pairs_packed.packed_pair_parts_plain(
        rows.onehot, rows.seq_of, rows.first_seq, pa, pb, k=eng.k, tile=tile, c_pad=eng.c_pad
    )
    pairs_packed.land_parts(want, parts, rows.first_seq[pa_t], rows.first_seq[pb_t], pb_t > pa_t)
    np.testing.assert_array_equal(got, want.numpy())
    if kind == "upper":
        order = eng.order
        np.testing.assert_array_equal(got[: eng.n, : eng.n],
                                      oracle.exact_counts(X, 7, 3)[np.ix_(order, order)])
    before = counters()["packed_pairlist.launches"]
    out = torch.zeros((m, m), dtype=torch.int64)
    assert pairs_packed_cuda.packed_pairlist(rows, pa_t, pb_t, k=eng.k, out=out) is out
    assert counters()["packed_pairlist.launches"] == before  # CPU path: no launch
    np.testing.assert_array_equal(out.numpy(), got)
    with pytest.raises(ValueError, match="int64"):
        pairs_packed_cuda.packed_pairlist(rows, pa_t, pb_t, k=eng.k, out=out.int())


@pytest.mark.parametrize(
    "pa,pb,tps",
    [
        ([0, 1, 2], [0, 1, 2], 1),  # diagonal slots
        ([0, 0, 0, 1, 1, 2], [0, 1, 2, 1, 2, 2], 2),  # an upper list
        ([3, 2, 0, 1], [1, 2, 3, 0], 3),  # reversed slots (b < a)
        ([1, 1, 0, 2], [2, 2, 0, 2], 16),  # repeated slots, tiles of a 2048-row strip
    ],
)
def test_kernel_list_walk_visits_each_tile_pair_once(pa, pb, tps):
    """Every grid splits kernel E's pair-list walk into runs that visit
    each index of the walk exactly once, slot after slot, each slot's tile
    pairs row tile first."""
    walk = _Walk.pairlist(pa, pb, tps)
    want = [(a * tps + u // tps, b * tps + u % tps) for a, b in zip(pa, pb) for u in range(tps * tps)]
    assert walk.total == len(want)
    assert [walk.at(L) for L in range(walk.total)] == want
    for grid in (1, 2, 3, 7, walk.total, walk.total + 5):
        assert [(ti, tj) for _, ti, tj in walk.runs(grid)] == want


def test_kernel_list_walk_past_int32():
    """A pair list of more than 2^31 tile pairs (the upper list of 3,000
    strips of 64 tiles): the walk's int64 index arithmetic lands on its
    first and last tile pairs and on each persistent block's first one."""
    ns, tps = 3000, 64
    pa, pb = (v.numpy().astype(np.int32) for v in torch.triu_indices(ns, ns))
    walk = _Walk.pairlist(pa, pb, tps)
    assert walk.total == len(pa) * tps * tps > 2**31
    assert walk.at(0) == (0, 0)
    last = (ns - 1) * tps + tps - 1
    assert walk.at(walk.total - 1) == (last, last)
    grid = 132 * 8
    for b in (1, grid // 2, grid - 1):
        begin = b * int(walk.total) // grid  # as the card: blockIdx.x * total / gridDim.x
        s, u = divmod(begin, tps * tps)
        assert walk.at(np.int64(begin)) == (int(pa[s]) * tps + u // tps, int(pb[s]) * tps + u % tps)


@pytest.mark.parametrize("g,alpha", [(4, 2), (7, 5), (8, 24), (12, 100), (20, 256)])
def test_code_planes_hold_each_codes_bits(rng, g, alpha):
    """The code-plane operand: ceil(log2 alpha) planes padded to 4 or 8
    words, bit q of plane p being bit p of code q, no bit past g in a
    valid row; a padding row (-1, also the rows past R) all zero. Groups
    of 8 rows holding two sequences, or a padding row before a valid one,
    are refused."""
    codes = torch.from_numpy(rng.integers(0, alpha, size=(96, g)).astype(np.int32))
    seq_of = torch.arange(96, dtype=torch.int32) // 8
    codes[5:8], seq_of[5:8] = -1, -1
    meta = (torch.zeros(3, dtype=torch.int32), 32, 16, alpha)
    rows = pairs_packed_cuda.PackedRows(codes, seq_of, *meta)
    nb = pairs_packed_cuda.code_planes(alpha)
    assert nb == max(1, math.ceil(math.log2(alpha)))
    planes = rows.planes.numpy().view(np.uint32)
    assert planes.shape == (ROW, pairs_packed_cuda.plane_stride(nb))
    pad = np.r_[5:8, 96:ROW]
    assert not planes[pad].any()
    assert not planes[:, nb:].any()
    valid = np.setdiff1d(np.arange(96), pad)
    c = codes.numpy()[valid]
    for p in range(nb):
        bits = (planes[valid, p, None] >> np.arange(32)) & 1
        np.testing.assert_array_equal(bits[:, :g], (c >> p) & 1)
        assert not bits[:, g:].any()
    for bad in (torch.where(torch.arange(96) == 12, 2, seq_of), torch.where(torch.arange(96) == 8, -1, seq_of)):
        with pytest.raises(ValueError, match="groups? of 8"):
            pairs_packed_cuda.PackedRows(codes, bad.to(torch.int32), *meta).planes


def test_pack_windows_matches_jax(rng):
    from fastsk_tpu.ops.pairs_packed import pack_windows as j_pack

    lengths = np.sort(rng.integers(8, 300, size=40))[::-1]
    for tile, group in ((64, 1), (2048, 8)):
        got, ref = pairs_packed.pack_windows(lengths, 6, tile, group), j_pack(lengths, 6, tile, group)
        assert got.keys() == ref.keys()
        for key in ref:
            np.testing.assert_array_equal(got[key], ref[key])


def test_packed_onehot_matches_jax_build_packed_x(rng, small_tile):
    """``onehot_rows(window_codes(...))`` is the JAX ``build_packed_x``."""
    import jax.numpy as jnp

    from fastsk_tpu.ops.pairs_packed import build_packed_x as j_build

    X = random_ragged_seqs(rng, 6, 9, 40, alphabet=7)
    eng = _port(X, 5, 2)
    p = eng.pack
    got = pairs_packed.onehot_rows(
        pairs_packed.window_codes(
            torch.from_numpy(eng._ids_sorted), torch.from_numpy(p["seq_of"]),
            torch.from_numpy(p["win_of"]), g=5, code_min=eng.code_min,
        ),
        eng.alpha,
    )
    assert torch.equal(got, eng.rows().onehot)
    ref = j_build(
        jnp.asarray(eng._ids_sorted), jnp.asarray(p["seq_of"]), jnp.asarray(p["win_of"]),
        g=5, alpha=eng.alpha, code_min=eng.code_min, dtype=jnp.int8,
    )
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize(
    "g,alpha,nb",
    [(8, 24, 5), (8, 5, 3), (8, 40, 6), (8, 56, 6), (20, 256, 8), (12, 100, 7)],
)
def test_kernel_d_body_selection(monkeypatch, g, alpha, nb):
    """Kernels D to G have one body, on ``nb`` code planes whatever the
    one-hot depth g * alpha (40 to 5,120 bytes here), and no row limit:
    the engine takes kernel D's route at any depth and kernel E's only
    under ``FASTSK_PACKED_PAIRLIST=1``."""
    pc = pairs_packed_cuda
    assert pc.code_planes(alpha) == nb and pc.plane_stride(nb) == (4 if nb <= 4 else 8)
    for gone in ("band_fits", "band_body", "grouped_body", "MMA_DEPTH_FASTER", "onehot_depth"):
        assert not hasattr(pc, gone)
    X = [list(range(1, alpha + 1)) + [1] * g, [alpha] * (g + 3)]  # every code: alphabet alpha
    monkeypatch.delenv("FASTSK_PACKED_PAIRLIST", raising=False)
    eng = _port(X, g, g // 2)
    assert eng.alpha == alpha and eng.route == "band"
    assert eng.rows().planes.shape[1] == pc.plane_stride(nb)
    monkeypatch.setenv("FASTSK_PACKED_PAIRLIST", "1")
    assert _port(X, g, g // 2).route == "pairlist"


def test_packed_band_on_cpu_takes_the_plain_version(monkeypatch):
    """On a CPU tensor kernel D is its plain version, equal to the oracle,
    and counts no launch."""
    pc = pairs_packed_cuda
    monkeypatch.setattr(PackedPairsEngine, "TILE", 64)
    rng = np.random.default_rng(9)
    X = [rng.integers(1, 6, size=int(rng.integers(8, 60))).tolist() for _ in range(9)]
    eng = PackedPairsEngine(encode_sequences(X), 5, 2, T.KernelConfig(device="cpu"))
    rows = eng.rows()
    before = counters()["packed_band.launches"]
    got = pc.packed_band(rows, k=3, n_out=eng.n)
    assert counters()["packed_band.launches"] == before
    pos = np.argsort(eng.order)
    np.testing.assert_array_equal(got.numpy()[np.ix_(pos, pos)], oracle.exact_counts(X, 5, 2))


# --------------------------------------- kernels D, F and G's shared walk

ROW = pairs_packed_cuda.ROW_TILE


def _pairs_before(ti, nt):  # csrc/hopper.cuh:pairs_before
    return ti * nt - ti * (ti - 1) // 2


def _row_tile_of(L, nt):  # csrc/hopper.cuh:row_tile_of, in doubles as there
    b2 = 2.0 * nt + 1.0
    ti = int((b2 - math.sqrt(b2 * b2 - 8.0 * L)) / 2.0)
    ti = min(max(ti, 0), nt - 1)
    while ti > 0 and _pairs_before(ti, nt) > L:
        ti -= 1
    while ti + 1 < nt and _pairs_before(ti + 1, nt) <= L:
        ti += 1
    return ti


class _Walk:
    """csrc/pairs_packed.cu's Walk as ``packed_block_launch`` and
    ``packed_grouped_launch`` build it from row ranges: the triangle
    (``tri``) over the tiles holding rows below ``c_hi``, or the
    rectangle; or, from ``pairlist``, kernel E's list of strip pairs."""

    def __init__(self, r_lo, r_hi, c_lo, c_hi, tri, tr=ROW):
        self.ti0, ti1 = r_lo // tr, -(-r_hi // tr)
        self.tri = tri
        self.pa = None
        if self.tri:
            nt = -(-c_hi // tr)
            self.nt, self.base = nt, _pairs_before(self.ti0, nt)
            self.total = _pairs_before(ti1, nt) - self.base
        else:
            self.tj0 = c_lo // tr
            self.nc = -(-c_hi // tr) - self.tj0
            self.total = (ti1 - self.ti0) * self.nc

    @classmethod
    def pairlist(cls, pa, pb, tps):
        """Slot s = L // tps^2 is strip pair (pa[s], pb[s]), its tile pairs
        row tile first; the index arithmetic in int64, as on the card."""
        w = cls.__new__(cls)
        w.pa, w.pb = np.asarray(pa, np.int64), np.asarray(pb, np.int64)
        w.tps = np.int64(tps)
        w.total = np.int64(len(w.pa)) * w.tps * w.tps
        return w

    def at(self, L):
        if self.pa is not None:
            s, u = divmod(np.int64(L), self.tps * self.tps)
            return int(self.pa[s] * self.tps + u // self.tps), int(self.pb[s] * self.tps + u % self.tps)
        if self.tri:
            g = L + self.base
            ti = _row_tile_of(g, self.nt)
            return ti, ti + g - _pairs_before(ti, self.nt)
        return self.ti0 + L // self.nc, self.tj0 + L % self.nc

    def next(self, ti, tj):
        tj += 1
        if tj == (self.nt if self.tri else self.tj0 + self.nc):
            return ti + 1, ti + 1 if self.tri else self.tj0
        return ti, tj

    def slot(self, L):
        return int(np.int64(L) // (self.tps * self.tps))

    def runs(self, grid):
        """(L, ti, tj) in the order persistent block b of ``grid`` visits
        them: its contiguous run, from ``at(begin)`` on by ``next`` (a
        list by ``at(L + 1)``)."""
        for b in range(grid):
            begin, end = b * self.total // grid, (b + 1) * self.total // grid
            if begin < end:
                ti, tj = self.at(begin)
                for L in range(begin, end):
                    yield L, ti, tj
                    if L + 1 < end:
                        ti, tj = self.at(L + 1) if self.pa is not None else self.next(ti, tj)


_ALL = (0, np.inf, 0, np.inf)  # no row outside the launch's strips


def _emulate_block(rows_i, rows_j, k, walk, masks, land, grid, tr=ROW):
    """numpy model of ``packed_bytes_kernel`` over ``walk``: each
    persistent block's run of tile pairs (every index of the walk exactly
    once over the grid); for two windows d, the popcount of the OR over
    code planes of their XOR and of the j row's padding mask (all ones
    where its seq_of is -1), weighing C(g - d, k) from a 64-entry table
    (zero past g); g - d must be the matches of the g code bytes (what the
    one-hot product counts) and a padding j row must weigh 0; i rows that
    are padding or outside ``masks = (r_lo, r_hi, c_lo, c_hi)``, j groups
    of 8 that start with padding and j rows outside the masks add nothing;
    32-bit bins relative to ``tile_first``, then ``land(bins, fi, fj, ti,
    tj, L)``."""
    pairs = list(walk.runs(grid))
    assert [L for L, _, _ in pairs] == list(range(walk.total))
    assert all((ti, tj) == walk.at(L) for L, ti, tj in pairs)
    g = rows_i.g
    by = [r.words.numpy().view(np.uint8).reshape(r.words.shape[0], -1)[:, :g] for r in (rows_i, rows_j)]
    pl = [r.planes.numpy().view(np.uint32) for r in (rows_i, rows_j)]
    assert all((p[r.seq_padded.numpy() >= 0] >> g).max() == 0 for p, r in zip(pl, (rows_i, rows_j)))
    seq = [r.seq_padded.numpy() for r in (rows_i, rows_j)]
    meta = [r.meta(tr) for r in (rows_i, rows_j)]
    cb = max(m.cb for m in meta)
    tbl = np.array([math.comb(g - d, k) if d <= g else 0 for d in range(64)])
    r_lo, r_hi, c_lo, c_hi = masks
    for L, ti, tj in pairs:
        ri, cj = np.arange(ti * tr, (ti + 1) * tr), np.arange(tj * tr, (tj + 1) * tr)
        si, sj = seq[0][ri], seq[1][cj]
        vi = (si >= 0) & (ri >= r_lo) & (ri < r_hi)
        sg = np.repeat(sj[::8], 8)  # the sequence of each row's group of 8
        vj = (sg >= 0) & (cj >= c_lo) & (cj < c_hi)
        pad = np.where(sj < 0, np.uint32(0xFFFFFFFF), np.uint32(0))
        differ = np.bitwise_or.reduce(pl[0][ri][:, None, :] ^ pl[1][cj][None, :, :], axis=-1)
        d = np.bitwise_count(differ | pad[None, :]).astype(np.int64)
        matches = (by[0][ri][:, None, :] == by[1][cj][None, :, :]).sum(-1)
        both = (si >= 0)[:, None] & (sj >= 0)[None, :]
        np.testing.assert_array_equal(np.where(both, g - d, 0), np.where(both, matches, 0))
        assert (tbl[d][:, sj < 0] == 0).all()
        w = tbl[d] * (vi[:, None] & vj[None, :])
        fi, fj = int(meta[0].tile_first[ti]), int(meta[1].tile_first[tj])
        li, lj = np.where(vi, si - fi, 0), np.where(vj, sg - fj, 0)
        assert li.max() < cb and lj.max() < cb
        bins = np.zeros((cb, cb), np.int64)
        np.add.at(bins, (li[:, None], lj[None, :]), w)
        assert bins.max() < 2**32  # the shared-memory bins are 32-bit unsigned
        land(bins, fi, fj, ti, tj, L)


def _land_matrix(out, row_off, mirror):
    def land(bins, fi, fj, ti, tj, L):
        for (i, j), v in np.ndenumerate(bins):
            if v:
                out[fi + i - row_off, fj + j] += v
                if mirror and ti != tj:
                    out[fj + j - row_off, fi + i] += v
    return land


def _emulate_packed_block(out, rows_i, strips_i, *, k, rows_j=None, strips_j=None, row_off=0,
                          grid=5):
    """The model of one ``packed_block`` call, with the row ranges its
    wrapper passes, into ``out`` (numpy) in place."""
    tile = rows_i.tile
    r = (strips_i[0] * tile, strips_i[1] * tile)
    mirror = rows_j is None
    if mirror:
        rows_j = rows_i
        c_hi = (rows_i.n_strips if strips_j is None else strips_j[1]) * tile
        c = (strips_i[0] * tile, c_hi)
        masks = (*r, 0, c_hi)
    else:
        c = (strips_j[0] * tile, strips_j[1] * tile)
        masks = (*r, *c)
    walk = _Walk(*r, *c, mirror)
    _emulate_block(rows_i, rows_j, k, walk, masks, _land_matrix(out, row_off, mirror), grid)
    return out


@pytest.mark.parametrize("tri", [True, False])
@pytest.mark.parametrize("nt,ti0,ti1", [(1, 0, 1), (7, 0, 7), (7, 2, 3), (9, 3, 9), (40, 17, 33)])
def test_kernel_walk_visits_each_tile_pair_once(nt, ti0, ti1, tri):
    """Every grid splits the walk into runs that visit each tile pair of
    the triangle restricted to row tiles ti0..ti1-1 (or of the rectangle
    against column tiles 1..nt-1) exactly once, row-tile-major."""
    walk = _Walk(ti0 * ROW, ti1 * ROW, ROW, nt * ROW, tri)
    want = [(ti, tj) for ti in range(ti0, ti1) for tj in (range(ti, nt) if tri else range(1, nt))]
    assert [walk.at(L) for L in range(walk.total)] == want
    for grid in (1, 2, 3, 7, walk.total, walk.total + 5):
        assert [(ti, tj) for _, ti, tj in walk.runs(grid)] == want


def test_kernel_walk_row_tile_at_full_size():
    """``row_tile_of`` in doubles at the 2.19 shape's 9,168 tiles (and a
    little past it) lands on every row's first and last pair, offset by
    the run's base as in the round-robin strips."""
    for nt in (9168, 40000):
        for ti in (0, 1, 2, 15, 16, nt // 2, nt - 17, nt - 2, nt - 1):
            first, last = _pairs_before(ti, nt), _pairs_before(ti + 1, nt) - 1
            assert _row_tile_of(first, nt) == _row_tile_of(last, nt) == ti
            walk = _Walk(ti * ROW, (ti + 1) * ROW, 0, nt * ROW, True)
            assert walk.at(0) == (ti, ti) and walk.at(walk.total - 1) == (ti, nt - 1)


@pytest.mark.parametrize("tile", [64, 256])
def test_kernel_f_model_matches_plain_and_oracle(rng, monkeypatch, tile):
    """Kernel F's two walks and landings, modelled in numpy, on straddling
    sequences (g=7): the ring's rectangles and its
    diagonal triangles with a row offset on each device's shard and the
    round-robin's triangle with its mirror, through both mesh routes of
    the engine, equal the plain composite per call (the triangle where its
    rows start on a 128-row tile and end on one or at its columns' end;
    narrower strips only add up over the partition), and the oracle in
    all."""
    from fastsk_tpu_torch.parallel import make_mesh

    monkeypatch.setattr(PackedPairsEngine, "TILE", tile)
    X = random_ragged_seqs(rng, 7, 20, 300, alphabet=5)
    plain = pairs_packed_cuda.packed_block
    calls = {"sharded": [], "replicated": []}
    state = None

    def model(out, rows_i, strips_i, **kw):
        got = _emulate_packed_block(out.numpy().copy(), rows_i, strips_i, **kw,
                                    grid=len(calls[state]) % 4 + 1)
        end = (kw.get("strips_j") or (0, rows_i.n_strips))[1]
        a0, a1 = (v * tile for v in strips_i)
        if kw.get("rows_j") is not None or (a0 % ROW == 0 and (a1 % ROW == 0 or strips_i[1] == end)):
            np.testing.assert_array_equal(got, plain(out.clone(), rows_i, strips_i, **kw).numpy())
        calls[state].append("rectangle" if kw.get("rows_j") is not None else "triangle")
        out.copy_(torch.from_numpy(got))
        return out

    monkeypatch.setattr(pairs_packed_cuda, "packed_block", model)
    want = oracle.exact_counts(X, 7, 3)
    for state in calls:
        eng = _port(X, 7, 3, mesh=make_mesh(2, 2, devices=["cpu"] * 4), mesh_state=state)
        assert eng.n_strips > 4 and straddles(eng)
        np.testing.assert_array_equal(eng.exact(), want)
    # the ring: a triangle a device with live strips (step 0), a rectangle
    # a later (device, step) whose own and visiting shards both hold live
    # strips; the round-robin: one triangle a strip
    spd = -(-eng.n_strips // 4)
    live = sum(d * spd < eng.n_strips for d in range(4))
    assert calls["sharded"][:live] == ["triangle"] * live
    assert calls["sharded"][live:] == ["rectangle"] * (live * (live - 1))
    assert calls["replicated"] == ["triangle"] * eng.n_strips


def straddles(eng) -> bool:
    first = eng.pack["row0"]
    last = first + (eng.pack["p"] + 7) // 8 * 8 - 1
    return bool((first // eng.tile != last // eng.tile).any())


def _land_parts(out, fs, a, b0, tps, c_pad):
    def land(bins, fi, fj, ti, tj, L):
        b = tj // tps
        for (i, j), v in np.ndenumerate(bins):
            if v:
                out[b - b0, fi + i - fs[a], fj + j - fs[b]] += v
    return land


@pytest.mark.parametrize("tile", [64, 256])
def test_kernel_g_model_several_groups(rng, monkeypatch, tile):
    """Kernel G over several groups in one launch, modelled in numpy (its
    128-row tiles at 256-row strips, kernel E's 64-row tiles over the pair
    list at 64), equals ``packed_pair_parts_plain``; the engine's grouped
    route lands it to the oracle with one launch a strip."""
    monkeypatch.setattr(PackedPairsEngine, "TILE", tile)
    X = random_ragged_seqs(rng, 16, 20, 300, alphabet=5)
    eng = _port(X, 7, 3, pairs_backend="pallas_grouped")
    rows, group = eng.rows(), eng.group
    assert eng.n_strips >= 2 * group
    tr = ROW if tile % ROW == 0 else rows.sub_tile()
    tps, fs = tile // tr, rows.first_seq.numpy()
    n_groups = eng.n_strips // group
    for a in (0, group + 1, eng.n_strips - 1):
        gidx = a // group
        n_b = (n_groups - gidx) * group
        got = np.zeros((n_b, eng.c_pad, eng.c_pad), np.int64)
        b0 = gidx * group
        walk = _Walk(a * tile, (a + 1) * tile, b0 * tile, (b0 + n_b) * tile, False, tr)
        _emulate_block(rows, rows, eng.k, walk, _ALL,
                       _land_parts(got, fs, a, b0, tps, eng.c_pad), grid=3, tr=tr)
        want = pairs_packed.packed_pair_parts_plain(
            rows.onehot, rows.seq_of, rows.first_seq, [a] * n_b, range(b0, b0 + n_b),
            k=eng.k, tile=tile, c_pad=eng.c_pad,
        ).numpy()
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(
            pairs_packed_cuda.packed_grouped(rows, a, gidx, k=eng.k, group=group,
                                             n_groups=n_groups - gidx).numpy(),
            want,
        )
    from fastsk_tpu_torch.kernel import pairs_engine

    calls = []
    grouped = pairs_engine.packed_grouped

    def spy(rows, a, gidx, **kw):
        calls.append(a)
        return grouped(rows, a, gidx, **kw)

    monkeypatch.setattr(pairs_engine, "packed_grouped", spy)
    np.testing.assert_array_equal(eng.exact(), oracle.exact_counts(X, 7, 3))
    assert calls == list(range(eng.n_strips))
