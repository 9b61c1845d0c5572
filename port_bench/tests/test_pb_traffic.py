"""The traffic generator repeats exactly from a seed, and gives every seed
the same set of prompt lengths."""
import json
import math
from collections import Counter

import pytest

import torch

from port_bench.lib import harness as H
from port_bench.lib import traffic as TR

MIXES = ("chat-b4", "long-prompt")


def load(mix):
    return H.load_json(H.BENCH / "traffic" / f"{mix}.json")


def test_cycle_repeats_from_seed():
    for mix in MIXES:
        tr = load(mix)
        big = 2 ** 31 + 12345
        assert TR.request_cycle(tr, big) == TR.request_cycle(tr, big)
        assert TR.request_cycle(tr, 7) != TR.request_cycle(tr, 8)


def test_every_seed_has_the_same_lengths():
    for mix in MIXES:
        tr = load(mix)
        sets = [Counter(n for b in TR.request_cycle(tr, s) for n in b) for s in (1, 2, 2 ** 33)]
        assert sets[0] == sets[1] == sets[2]


def test_lengths_follow_the_mix():
    """Each mix's median, and its mean as the log-normal's exp(sigma^2 / 2)
    times the median, as its source gives them."""
    for mix, median, mean in (("chat-b4", 1020, 1155), ("long-prompt", 1500, 2048)):
        tr = load(mix)
        assert tr["prompt"]["median"] == median
        assert math.exp(tr["prompt"]["sigma"] ** 2 / 2) * median == pytest.approx(mean, rel=1e-3)
        lengths = sorted(TR.stratified_lengths(tr["prompt"], 1024))
        assert lengths[511] <= median <= lengths[512]
        assert sum(lengths) / len(lengths) == pytest.approx(mean, rel=0.03)
    chat = TR.stratified_lengths(load("chat-b4")["prompt"], 16)
    assert (min(chat), max(chat)) == (403, 2582)


def test_batches_differ_and_each_seed_has_every_batch_length():
    """A cycle longer than the batch: the batches of one seed differ from each
    other, and the seed changes only their order and composition."""
    tr = load("chat-b4")
    assert tr["cycle"] > tr["batch"]
    batches = TR.request_cycle(tr, 2 ** 31 + 7)
    assert len(batches) == tr["cycle"] // tr["batch"]
    assert len({max(b) for b in batches}) == len(batches)


def test_longest_first_starts_every_round():
    tr = load("long-prompt")
    seq = [n for b in TR.request_cycle(tr, 2 ** 31 + 9) for n in b]
    rounds = [seq[i:i + tr["cycle"]] for i in range(0, len(seq), tr["cycle"])]
    assert len(rounds) == tr["repeat"]
    assert all(r[0] == max(r) for r in rounds)
    assert len({tuple(r) for r in rounds}) > 1              # the seed orders the rest


def test_prompt_ids_repeat_and_pad():
    a, la = TR.prompt_ids(torch, [5, 3], 100, 2 ** 32 + 1, "p0", "cpu")
    b, lb = TR.prompt_ids(torch, [5, 3], 100, 2 ** 32 + 1, "p0", "cpu")
    assert torch.equal(a, b) and torch.equal(la, lb)
    assert a.shape == (2, 5) and bool((a[1, 3:] == 0).all())
    c, _ = TR.prompt_ids(torch, [5, 3], 100, 2 ** 32 + 1, "p1", "cpu")
    assert not torch.equal(a, c)


def test_seeds_beyond_32_bits():
    assert TR.derive(2 ** 31 + 5, "x") != TR.derive(2 ** 31 + 6, "x")
    assert 0 <= TR.derive(2 ** 40, "x") < 2 ** 63
    json.dumps(TR.request_cycle(load("chat-b4"), 2 ** 40))
