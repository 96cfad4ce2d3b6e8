"""Tiny cells for the CPU tests: a real cell of ``BENCHMARK.json`` with its
data and widths cut down so that a run fits a test."""

from __future__ import annotations

import copy

from gkmbench import harness

TINY = {
    "kat2b_g13m7": {"g": 6, "m": 3, "data": {
        "train": {"pos": ["tests/data/tiny.train.pos.fasta"], "neg": ["tests/data/tiny.train.neg.fasta"]},
        "test": {"pos": ["tests/data/tiny.test.pos.fasta"], "neg": ["tests/data/tiny.test.neg.fasta"]}}},
    "p219_g8m4": {"g": 5, "m": 2, "data": {"n": 30, "lmin": 16, "lmax": 60}},
}


def tiny_cell(name: str) -> harness.Cell:
    cell = copy.deepcopy(harness.load_cell(name))
    cut = TINY[cell.config["name"]]
    cell.config.update({k: v for k, v in cut.items() if k != "data"})
    cell.config["data"].update(cut["data"])
    return cell
