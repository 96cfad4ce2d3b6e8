"""The frozen yardstick: the count bound from the configurations' sizes,
the seeded inputs, the interval arithmetic."""

import math

import numpy as np
import pytest

from gkmbench import harness, yardstick
from gkmbench.loaders import ragged_fixed


def _data(cell, seed):
    c = harness.load_cell(cell)
    return c, harness.load_module("loaders", c.config["loader"]).load(c.config, seed, harness.HERE)


def test_kat2b_bound_is_57_2_ms():
    c, d = _data("kat2b.train", 3)
    assert d.windows(13) == 7020 * 188 == 1_319_760 and d.alpha == 5
    assert yardstick.count_bound_s(d.windows(13), 13, 5, d.n) * 1e3 == pytest.approx(57.2, abs=0.05)


def test_seed_219_set_bound_is_132_7_ms():
    X, _ = ragged_fixed.ragged_set(219, 2564, 16, 905, 24, [5, 17, 2, 11, 20, 8, 14, 3])
    w = sum(len(s) - 7 for s in X)
    assert w == 1_169_416
    assert yardstick.count_bound_s(w, 8, 24, len(X)) * 1e3 == pytest.approx(132.68, abs=0.01)


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 11])
def test_p219_seeds_deal_the_same_work(seed):
    c, d = _data("p219.train", seed)
    assert d.windows(8) == 1_169_416 and d.n == 2564 and len(d.Xtr) == 2051
    assert sorted(map(len, d.Xtr + d.Xte)) == sorted(
        map(len, ragged_fixed.ragged_set(219, 2564, 16, 905, 24, c.config["data"]["motif"])[0]))


@pytest.mark.parametrize("seed", [1, 2**31 + 5])
def test_kat2b_keeps_the_published_split_in_a_seeded_order(seed):
    c, d = _data("kat2b.train", seed)
    assert (int(d.ytr.sum()), int((1 - d.ytr).sum())) == (3159, 3159)
    assert (int(d.yte.sum()), int((1 - d.yte).sum())) == (351, 351)
    _, again = _data("kat2b.train", seed)
    assert again.Xtr == d.Xtr and np.array_equal(again.yte, d.yte)
    _, other = _data("kat2b.train", seed + 1)
    assert other.Xtr != d.Xtr
    assert sorted(map(tuple, d.Xtr)) == sorted(map(tuple, other.Xtr))
    assert sorted(map(tuple, d.Xte)) == sorted(map(tuple, other.Xte))


def test_intervals():
    merged = yardstick.union([(0, 2), (1, 3), (5, 6), (6, 7), (9, 9)])
    assert merged == [(0, 3), (5, 7)]
    assert yardstick.covered(merged, 2, 6) == 2
    assert yardstick.gaps(merged, -1, 8) == [(-1, 0), (3, 5), (7, 8)]
    ops, nbytes = yardstick.count_work(10, 3, 4, 2)
    assert ops == 55 * 24 and nbytes == 10 * 12 + 16
    assert math.isclose(yardstick.count_bound_s(10, 3, 4, 2),
                        max(ops / 1.979e15, nbytes / 3.35e12))
