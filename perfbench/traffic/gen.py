"""The one traffic generator: every mix is a data file beside this module
that names the generator's kind and its parameters.

``closed_loop``: one client per batcher slot; a client sends its next
request the moment its previous one completes.  Each client draws its own
prompts from the run's seed, so the requests do not depend on the order in
which the program finishes them.  Lengths are stratified across clients:
the j-th requests of all clients together take ``clients`` evenly spaced
lengths of the mix's range, each once, dealt to the clients in an order
drawn from the seed, so every seed sends the same sizes at every stage of
the loop.  The clients' first requests take their output lengths evenly
from 1 to the largest, so completions spread from the first round.
Prompts either are unique (``namespaces`` 0) or are one of ``namespaces``
tenants' shared system prompts followed by a unique tail.

Keys of a ``closed_loop`` mix:
  serving        ServingConfig fields applied on top of the configuration's
  prompt_len     [lo, hi] tokens, or the shared prefix + tail below
  out_len        [lo, hi] output tokens
  namespaces     number of tenants sharing system prompts (0: none)
  prefix_len     tokens of each tenant's system prompt
  tail_len       unique tokens after it
  ramp           clients started per round during warm-up
  warmup_rounds  rounds run before the window opens
  check_tokens   served tokens the correctness sample aims at
  check_requests most requests in that sample
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np


@dataclasses.dataclass
class Spec:
    """One request as the client sends it."""

    client: int
    index: int
    prompt: np.ndarray
    max_new: int
    namespace: Optional[str]
    prefix_len: int


def _strata(lo: int, hi: int, n: int) -> np.ndarray:
    """``n`` evenly spaced whole lengths over [lo, hi]."""
    return np.floor(lo + (np.arange(n) + 0.5) * (hi - lo + 1) / n).astype(
        np.int64)


class ClosedLoop:
    """Request streams of a ``closed_loop`` mix for one seed."""

    def __init__(self, mix: Dict, seed: int, vocab: int):
        self.mix = mix
        self.seed = int(seed)
        self.clients = int(mix["serving"]["slots"])
        self.vocab = int(vocab)
        self.namespaces = int(mix.get("namespaces", 0))
        root = np.random.SeedSequence(self.seed)
        self._rngs = [np.random.default_rng(ss)
                      for ss in root.spawn(self.clients)]
        self._deals: Dict[int, tuple] = {}
        self._count = [0] * self.clients
        self.prefixes: List[np.ndarray] = []
        if self.namespaces:
            rng = np.random.default_rng(np.random.SeedSequence([self.seed, 1]))
            self.prefixes = [self._tokens(rng, int(mix["prefix_len"]))
                             for _ in range(self.namespaces)]

    def _tokens(self, rng, n: int) -> np.ndarray:
        # token 0 pads prompts in the program's batcher: draw 1 .. vocab - 1
        return rng.integers(1, self.vocab, size=n, dtype=np.int64).astype(
            np.int32)

    def _deal(self, j: int) -> tuple:
        """(prompt lengths, output lengths) of every client's j-th request:
        the stratified lengths in an order drawn from (seed, j)."""
        if j not in self._deals:
            rng = np.random.default_rng(
                np.random.SeedSequence([self.seed, 2, j]))
            n = self.clients
            lo, hi = self.mix["out_len"]
            outs = _strata(1 if j == 0 else lo, hi, n)[rng.permutation(n)]
            prompts = np.zeros_like(outs)
            if not self.namespaces:
                prompts = _strata(*self.mix["prompt_len"], n)[
                    rng.permutation(n)]
            self._deals[j] = (prompts, outs)
        return self._deals[j]

    def next(self, c: int) -> Spec:
        """Client ``c``'s next request."""
        i = self._count[c]
        self._count[c] += 1
        rng = self._rngs[c]
        prompts, outs = self._deal(i)
        n_out = int(outs[c])
        if self.namespaces:
            ns = c % self.namespaces
            tail = self._tokens(rng, int(self.mix["tail_len"]))
            prompt = np.concatenate([self.prefixes[ns], tail])
            return Spec(c, i, prompt, n_out, f"tenant{ns}",
                        len(self.prefixes[ns]))
        return Spec(c, i, self._tokens(rng, int(prompts[c])), n_out, None, 0)


KINDS = {"closed_loop": ClosedLoop}


def make(mix: Dict, seed: int, vocab: int):
    """The generator a mix file names, for one seed."""
    try:
        kind = KINDS[mix["kind"]]
    except KeyError:
        raise ValueError(f"unknown traffic kind {mix.get('kind')!r}; "
                         f"known: {sorted(KINDS)}") from None
    return kind(mix, seed, vocab)
