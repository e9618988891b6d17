"""What decides ``correct``: the served tokens of a sample of the requests
the window completed, judged by the plain reference.

For each sampled request the reference runs once over its padded prompt
and its served tokens and reads, at every served position, by how much the
served token's logit lies below the reference's best there.  The widest of
these gaps is the number compared (greedy tokens: the program's pick
should be the reference's best, up to the rounding of its served
precision).  The control (:func:`readings` with the control on) runs the
same reference in float8 and reads, at the same positions, the gap of the
token that float8 puts first.
"""

from __future__ import annotations

import importlib
from typing import Dict, List

import numpy as np


STATISTICS = ("gap", "mean", "p90", "p99", "off_best", "first",
              "request_median", "request_q75")


def sample(done: List, mix: Dict, seed: int) -> List[Dict]:
    """Requests drawn from the seed among ``done`` (completed in the
    window), the one with the most served tokens first, until
    ``check_tokens`` served tokens or ``check_requests`` requests."""
    if not done:
        return []
    rng = np.random.default_rng([int(seed) % (2 ** 63), 7])
    longest = max(done, key=lambda r: (len(r.req.out), r.n_prompt, -r.rid))
    rest = [r for r in done if r is not longest]
    order = [longest] + [rest[i] for i in rng.permutation(len(rest))]
    out, tokens = [], 0
    for r in order:
        if tokens >= int(mix["check_tokens"]) or \
                len(out) >= int(mix["check_requests"]):
            break
        out.append({"prompt": np.asarray(r.spec.prompt, dtype=np.int64),
                    "served": np.asarray(r.req.out, dtype=np.int64)})
        tokens += len(r.req.out)
    return out


def _rows(sample: List[Dict], prompt_len: int, device) -> List[Dict]:
    import torch

    rows = []
    for s in sample:
        pad = prompt_len - len(s["prompt"])
        toks = np.concatenate([np.zeros(pad, np.int64), s["prompt"],
                               s["served"][:-1]])
        rows.append({"tokens": torch.from_numpy(toks).to(device),
                     "prompt_len": prompt_len})
    return rows


def readings(conf: Dict, sample: List[Dict], seed: int, device,
             prompt_len: int, control: bool = False) -> Dict:
    """:func:`summary` of the served tokens' gaps under the float32
    reference, and with ``control`` that of float8's first choices
    (``control``; its widest gap is ``control_gap``); the weights are
    drawn again from ``seed``."""
    import torch

    from . import weights as wmod
    from .reference import common

    if not sample:
        out = {k: float("inf") for k in STATISTICS}
        out.update(tokens=0, control=None, control_gap=None)
        return out
    ffn = importlib.import_module(
        f"perfbench.reference.{conf['reference']}").ffn
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            w = wmod.make(conf, seed, device)
            rows = _rows(sample, prompt_len, device)
            ref = common.forward(w, conf, rows, ffn, "f32")
            gaps = [_gaps(z, torch.from_numpy(s["served"]).to(z.device))
                    for z, s in zip(ref, sample)]
            low = None
            if control:
                low = [_gaps(z, zl.argmax(dim=-1)) for z, zl in zip(
                    ref, common.forward(w, conf, rows, ffn, "fp8"))]
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev
    out = summary(gaps)
    out["tokens"] = sum(len(g) for g in gaps)
    out["control"] = summary(low) if low is not None else None
    out["control_gap"] = out["control"]["gap"] if low is not None else None
    return out


def _gaps(z, tokens):
    """Per position: the reference's best logit less that of ``tokens``."""
    return (z.max(dim=-1).values - z.gather(1, tokens[:, None])[:, 0]).cpu()


def summary(gaps) -> Dict:
    """The widest gap and the mean gap over all positions; how they spread:
    the 90th and 99th percentiles, the share of positions off the best, the
    widest gap at a request's first token (admission), and the median and
    the upper quartile of the requests' own mean gaps (nearest rank)."""
    import torch

    from .yardstick import percentile

    per_req = [float(g.double().mean()) for g in gaps]
    allg = torch.cat(gaps).double()
    return {"gap": float(allg.max()), "mean": float(allg.mean()),
            "p90": float(torch.quantile(allg, 0.90)),
            "p99": float(torch.quantile(allg, 0.99)),
            "off_best": float((allg > 0).double().mean()),
            "first": max(float(g[0]) for g in gaps),
            "request_median": percentile(per_req, 0.5),
            "request_q75": percentile(per_req, 0.75)}
