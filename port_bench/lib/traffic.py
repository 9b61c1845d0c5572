"""The one traffic generator: reads a mix's parameters and makes its
requests from the seed.

Prompt lengths are a stratified sample of a clipped log-normal: a cycle of
``cycle`` lengths at the quantiles (i + 1/2) / cycle.  Every seed gets the
same set of lengths; the seed only orders them and draws the token ids.
So two seeds do the same work in another order, and the spread between
runs is the system's, not the sample's.
"""
from __future__ import annotations

import hashlib
import math
from statistics import NormalDist

import numpy as np


def derive(seed: int, tag: str) -> int:
    """A 63-bit seed for one named stream of draws under ``seed``."""
    digest = hashlib.sha256(f"{int(seed)}:{tag}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def stratified_lengths(prompt: dict, n: int) -> list[int]:
    """``n`` lengths at the (i + 1/2) / n quantiles of a log-normal with
    the given median and sigma (of the log), rounded and clipped."""
    if prompt["dist"] != "lognormal":
        raise ValueError(f"the generator draws log-normal lengths, not {prompt['dist']!r}")
    dist = NormalDist()
    out = []
    for i in range(n):
        z = dist.inv_cdf((i + 0.5) / n)
        length = round(prompt["median"] * math.exp(prompt["sigma"] * z))
        out.append(int(min(max(length, prompt["min"]), prompt["max"])))
    return out


def request_cycle(traffic: dict, seed: int) -> list[list[int]]:
    """The cycle of batches: ``cycle`` stratified lengths in the seed's
    order, ``repeat`` times (each in its own order), cut into batches of
    ``batch`` requests.  Each batch gets its own prompt ids.

    With ``longest_first``, each round of the cycle starts with its
    longest prompt: a window that ends inside a round then holds that
    round's longest prompt too, so the longest prompts keep their share
    (1 / cycle) of the requests in every window, and a tail quantile
    inside that share reads the same prompt length in every run."""
    lengths = stratified_lengths(traffic["prompt"], traffic["cycle"])
    rng = np.random.default_rng(derive(seed, "order"))
    seq = []
    for _ in range(traffic.get("repeat", 1)):
        order = list(rng.permutation(len(lengths)))
        if traffic.get("longest_first"):
            top = max(order, key=lambda i: lengths[i])
            order = [top] + [i for i in order if i != top]
        seq += [lengths[i] for i in order]
    b = traffic["batch"]
    if len(seq) % b:
        raise ValueError(f"cycle {len(seq)} is not a multiple of the batch {b}")
    return [seq[i:i + b] for i in range(0, len(seq), b)]


def prompt_ids(torch, lengths: list[int], vocab: int, seed: int, tag: str, device):
    """Right-padded prompt ids [B, max(lengths)] (pad id 0) drawn on the
    device from the seed, and the lengths [B]."""
    gen = torch.Generator(device=device)
    gen.manual_seed(derive(seed, tag))
    t = max(lengths)
    ids = torch.randint(0, vocab, (len(lengths), t), generator=gen, device=device)
    lens = torch.tensor(lengths, device=device)
    ids = ids.masked_fill(torch.arange(t, device=device)[None] >= lens[:, None], 0)
    return ids, lens
