"""The traffic generator: a seed repeats exactly, shared prompts are whole
pages of one tenant's system prompt plus a tail, lengths are stratified."""

from __future__ import annotations

import json

import numpy as np
import pytest

from perfbench import harness
from perfbench.traffic import gen

MIXES = sorted(p.stem for p in (harness.HERE / "traffic").glob("*.json"))


def _mix(name):
    return json.loads((harness.HERE / "traffic" / f"{name}.json").read_text())


def _draw(mix, seed, n=40, vocab=1000):
    g = gen.make(mix, seed, vocab)
    return [g.next(c % g.clients) for c in range(n)]


@pytest.mark.parametrize("name", MIXES)
def test_seed_repeats_exactly(name):
    mix = _mix(name)
    a, b = _draw(mix, 2**31 + 99), _draw(mix, 2**31 + 99)
    for x, y in zip(a, b):
        assert np.array_equal(x.prompt, y.prompt)
        assert (x.max_new, x.namespace) == (y.max_new, y.namespace)
    c = _draw(mix, 2**31 + 100)
    assert any(not np.array_equal(x.prompt, y.prompt) for x, y in zip(a, c))


@pytest.mark.parametrize("name", MIXES)
def test_lengths_in_range(name):
    mix = _mix(name)
    P = mix["serving"]["prompt_len"]
    for s in _draw(mix, 7, n=200):
        assert 1 <= len(s.prompt) <= P
        assert s.prompt.min() >= 1            # token 0 is the padding
        lo, hi = mix["out_len"]
        assert (1 if s.index == 0 else lo) <= s.max_new <= hi
        assert len(s.prompt) + s.max_new <= mix["serving"]["max_len"]


def test_shared_prompts_are_whole_and_page_aligned():
    mix = _mix("shared-prefix")
    page = 16
    assert mix["prefix_len"] % page == 0
    specs = _draw(mix, 12345, n=64)
    by_ns = {}
    for s in specs:
        assert len(s.prompt) == mix["serving"]["prompt_len"] == 2048
        assert s.prefix_len == mix["prefix_len"]
        by_ns.setdefault(s.namespace, []).append(s.prompt)
    assert len(by_ns) == mix["namespaces"]
    for prompts in by_ns.values():
        heads = {p[:mix["prefix_len"]].tobytes() for p in prompts}
        tails = {p[mix["prefix_len"]:].tobytes() for p in prompts}
        assert len(heads) == 1 and len(tails) == len(prompts)
    heads = {v[0][:mix["prefix_len"]].tobytes() for v in by_ns.values()}
    assert len(heads) == mix["namespaces"]


@pytest.mark.parametrize("name", MIXES)
def test_every_seed_sends_the_same_sizes(name):
    mix = _mix(name)

    def sizes(seed, j):
        g = gen.make(mix, seed, 1000)
        out = [[g.next(c) for c in range(g.clients)] for _ in range(j + 1)]
        return (sorted(len(s.prompt) for s in out[j]),
                sorted(s.max_new for s in out[j]))

    for j in (0, 1, 3):
        a, b = sizes(1, j), sizes(2**31 + 5, j)
        assert a == b
    g = gen.make(mix, 9, 1000)
    firsts = sorted(g.next(c).max_new for c in range(g.clients))
    assert firsts[0] <= 1 + mix["out_len"][1] // g.clients


def test_unknown_kind():
    with pytest.raises(ValueError, match="unknown traffic kind"):
        gen.make({"kind": "open_loop", "serving": {"slots": 1}}, 0, 10)
