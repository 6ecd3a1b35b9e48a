"""Is what the timed path served correct?  The reference's verdict.

Once the window has closed (and the engine, its pool and its weights are
freed), a sample of the requests the engine finished, drawn from the
seed with the longest among them, is run through the plain float32
reference (``reference/model.py``) over each prompt with its served
tokens.  Each served token's gap below the reference's best logit at its
position is a reading.  The numbers compared (``limits/<cell>.json``,
``compare``) are the widest gap (greedy decoding: a correct server only
picks a token the reference ranks first or within rounding of first),
the mean gap, the 90th percentile and the share of tokens off the
reference's first place.  The reference draws the weights again from the
seed (``weights.ReferenceWeights``): it takes nothing the program made.

A witness (``control.py --witness``) reads the gaps also under other
references (each the keyword arguments of ``reference.model.Reference``),
a token judged by the best of a set; a reference that follows near-tied
expert routes taken the other way (``flip_margin``) judges it by the best
of its routings of that position.

The control reads, at the same positions, the gap of the token the
float8 reference (``reference/quant.py``) puts first, and is held to the
same limits by the same code: it has to come out not correct.
"""

from __future__ import annotations

import json
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

MIN_TOKENS = 256            # served tokens the sample reaches
MIN_REQUESTS = 4            # and requests: a fault confined to some lanes shows
WIDE_GAP = 0.25             # a gap the witness counts as wide
NEAR_TIES = (0.01, 0.03, 0.1)


def sample(recs, seed: int, min_tokens: int = MIN_TOKENS,
           min_requests: int = MIN_REQUESTS) -> list:
    """The finished, complete requests to check: the one with the most
    served tokens (the longest prompt among equals), then others in a
    seeded order until the sample holds ``min_tokens`` served tokens and
    ``min_requests`` requests."""
    done = sorted((r for r in recs if r.req is not None and r.req.finished_at is not None
                   and not r.req.expired and len(r.req.generated) == r.req.max_new_tokens),
                  key=lambda r: r.item.rid)
    if not done:
        return []
    first = max(done, key=lambda r: (len(r.req.generated), len(r.item.prompt)))
    rest = [r for r in done if r is not first]
    order = np.random.default_rng([seed, 0xC0FFEE]).permutation(len(rest))
    out, n = [first], len(first.req.generated)
    for i in order:
        if n >= min_tokens and len(out) >= min_requests:
            break
        out.append(rest[i])
        n += len(rest[i].req.generated)
    return out


def verdict(stats: dict, limits: dict, n_tokens: int) -> Tuple[Dict[str, dict], bool]:
    """Each compared number beside its limit, and whether all hold."""
    checks = {name: {"value": stats.get(name), "limit": lim}
              for name, lim in limits["compare"].items()}
    checks["tokens_checked"] = {"value": n_tokens, "min": limits["min_tokens"]}
    ok = (all(c["value"] is not None and c["value"] <= c["limit"]
              for name, c in checks.items() if name != "tokens_checked")
          and n_tokens >= limits["min_tokens"])
    return checks, bool(ok)


def sequences(torch, served: Sequence[Tuple[np.ndarray, List[int]]], device):
    """Each prompt with its served tokens but the last, and where the
    rows predicting the served tokens start."""
    seqs, starts = [], []
    for prompt, gen in served:
        toks = np.concatenate([prompt.astype(np.int64), np.asarray(gen[:-1], np.int64)])
        seqs.append(torch.from_numpy(toks).to(device))
        starts.append(len(prompt) - 1)
    return seqs, starts


def _gaps(torch, logits, picks, alternatives=None) -> np.ndarray:
    """Each row's gap of its picked token below the reference's best, the
    smallest over the reference's routings of that row."""
    out = []
    alternatives = alternatives or [None] * len(logits)
    for rows, pick, alt in zip(logits, picks, alternatives):
        pick = pick.to(rows.device).long()
        g = rows.max(dim=-1).values - rows.gather(1, pick[:, None])[:, 0]
        if alt is not None and len(alt[0]):
            at, lo = alt
            ga = lo.max(dim=-1).values - lo.gather(1, pick[at][:, None])[:, 0]
            g = g.scatter_reduce(0, at, ga, "amin")
        out.append(g.cpu().numpy())
    return np.concatenate(out) if out else np.zeros(0)


def served_gaps(torch, logits, served, alternatives=None) -> np.ndarray:
    """Each served token's gap below the reference's best at its position."""
    picks = [torch.as_tensor(gen) for _, gen in served]
    return _gaps(torch, logits, picks, alternatives)


def control_gaps(torch, ref_logits, low_logits, alternatives=None) -> np.ndarray:
    """At each position, the gap under the reference of the token the lower
    precision puts first."""
    return _gaps(torch, ref_logits, [low.argmax(dim=-1) for low in low_logits], alternatives)


def summary(gaps: np.ndarray) -> dict:
    """The numbers a cell's limits may compare: the widest gap, the mean
    gap, the 90th percentile, and the share of tokens off the reference's
    first place."""
    if not len(gaps):
        return {}
    g = gaps.astype(np.float64)
    return {"logit_gap": float(g.max()), "mean_gap": float(g.mean()),
            "p90_gap": float(np.quantile(g, 0.9)), "off_top_share": float((g > 0).mean())}


def _key(variant: dict) -> str:
    return json.dumps(variant, sort_keys=True)


def judge(torch, cfg: dict, seed: int, dtype, device, served,
          control: bool = False, witness: Optional[Dict[str, List[dict]]] = None) -> dict:
    """The served tokens' readings under the plain reference
    (``program``), the control's at the same positions (``control``), and
    for each named set of routings in ``witness`` both readings under it,
    with how the widest gaps sit against near-tied routes (``near_ties``)."""
    from .reference.model import Reference, no_tf32
    from .reference.quant import Fp8Reference
    from .weights import ReferenceWeights

    no_tf32()
    t0 = time.perf_counter()
    seqs, starts = sequences(torch, served, device)
    weights = ReferenceWeights(cfg, seed, dtype, device)
    low = Fp8Reference(cfg, weights).logits(seqs, starts) if control else None
    sets = {"compare": [{}], **(witness or {})}
    passes = {}
    for variants in sets.values():
        for v in variants:
            if _key(v) in passes:
                continue
            ref = Reference(cfg, weights, **v)
            logits = ref.logits(seqs, starts)
            alts = ref.alternatives
            passes[_key(v)] = (served_gaps(torch, logits, served, alts),
                               control_gaps(torch, logits, low, alts) if control else None,
                               torch.cat(ref.margins).cpu().numpy())
            del logits, ref, alts

    def best(variants, i):
        return np.min([passes[_key(v)][i] for v in variants], axis=0)

    out = {"program": summary(best(sets["compare"], 0)),
           "control": summary(best(sets["compare"], 1)) if control else None}
    if witness:
        out["witness"] = {name: {"program": summary(best(v, 0)),
                                 "control": summary(best(v, 1)) if control else None}
                          for name, v in witness.items()}
    if witness and _key({}) in passes:
        gaps, _, margin = passes[_key({})]
        wide = gaps > WIDE_GAP
        out["near_ties"] = {"wide": int(wide.sum()), "positions": int(len(gaps)), **{
            f"{t:g}": {"share": float((margin < t).mean()),
                       "of_wide": float((margin[wide] < t).mean()) if wide.any() else None}
            for t in NEAR_TIES}}
    out["reference_s"] = time.perf_counter() - t0
    return out
