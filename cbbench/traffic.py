"""The one traffic generator: it reads a mix (``traffic/<mix>.json``)
and the statement templates (``templates/<family>/<template>.json``) and
gives each client its statements, from the seed.

A mix holds:

- ``family``: the template family (``tpch``; ``gen/<family>.py`` makes its data);
- ``clients``: closed-loop clients (each sends its next statement when
  its last one has answered);
- ``templates``: the templates, in the order of a pass;
- ``order``: ``fixed`` (every client runs the templates in order) or
  ``permute`` (each client runs every pass in an order drawn
  from the seed);
- ``params``: ``validation`` (every statement takes the template's
  validation parameters) or ``drawn`` (each statement takes parameters
  of its own from a pool of ``pool`` distinct sets per template, drawn
  from ``pool_seed`` within ``ranges`` and never the validation set; the
  run's seed deals the pool out to the clients in an order of its own,
  so every seed runs the same set of statements in another order);
- ``ranges``: per template, the substitution parameters' ranges;
- ``check_sample``: how many of the window's distinct statements, drawn
  from the seed, the reference checks (every answer of each).

Warm-up runs every template with its validation parameters, so a drawn
window never repeats a warm-up statement.
"""

from __future__ import annotations

import datetime
import hashlib
import json
from dataclasses import dataclass
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent


@dataclass(frozen=True)
class Statement:
    template: str
    params: tuple  # sorted (name, value) pairs

    @property
    def key(self) -> tuple:
        return (self.template, self.params)

    def sql(self, templates: dict) -> str:
        return templates[self.template]["sql"].format(**dict(self.params))


def load_mix(name: str) -> dict:
    return json.loads((HERE / "traffic" / f"{name}.json").read_text())


def load_templates(family: str, names) -> dict[str, dict]:
    return {t: json.loads((HERE / "templates" / family / f"{t}.json")
                          .read_text()) for t in names}


def _stream(*parts) -> np.random.Generator:
    h = hashlib.sha256(repr(parts).encode()).digest()
    return np.random.default_rng(int.from_bytes(h[:8], "little"))


def _draw(spec: dict, rng: np.random.Generator) -> dict[str, str]:
    names, kind = spec["names"], spec["kind"]
    if kind == "int":
        return {names[0]: str(int(rng.integers(spec["lo"], spec["hi"] + 1)))}
    if kind == "choice":
        picks = rng.choice(len(spec["values"]), size=len(names),
                           replace=False)
        return {n: spec["values"][int(i)] for n, i in zip(names, picks)}
    if kind == "date":
        lo = datetime.date.fromisoformat(spec["lo"])
        hi = datetime.date.fromisoformat(spec["hi"])
        d = lo + datetime.timedelta(
            days=int(rng.integers(0, (hi - lo).days + 1)))
        return {names[0]: d.isoformat()}
    if kind == "year_start":
        return {names[0]:
                f"{int(rng.integers(spec['lo'], spec['hi'] + 1))}-01-01"}
    if kind == "month_start":
        y0, m0 = map(int, spec["lo"].split("-"))
        y1, m1 = map(int, spec["hi"].split("-"))
        k = int(rng.integers(0, (y1 - y0) * 12 + m1 - m0 + 1)) + m0 - 1
        return {names[0]: f"{y0 + k // 12}-{k % 12 + 1:02d}-01"}
    if kind == "band":
        # a centre in [lo, hi] hundredths, and the band around it
        c = int(rng.integers(spec["lo"], spec["hi"] + 1))
        w = spec["width"]
        return {names[0]: f"{(c - w) / 100:.2f}",
                names[1]: f"{(c + w) / 100:.2f}"}
    raise ValueError(f"unknown parameter kind {kind!r}")


def pool(mix: dict, template: str, validation: dict) -> list[tuple]:
    """The mix's distinct parameter sets of one template, in draw order
    (at most ``pool``; fewer where the ranges hold fewer)."""
    rng = _stream("pool", mix.get("pool_seed", 0), template)
    want = int(mix["pool"])
    seen = {tuple(sorted(validation.items()))}
    out = []
    for _ in range(want * 50):
        p = {}
        for spec in mix["ranges"][template]:
            p.update(_draw(spec, rng))
        key = tuple(sorted(p.items()))
        if key not in seen:
            seen.add(key)
            out.append(key)
            if len(out) == want:
                break
    return out


class Traffic:
    """The statements of one run: ``client(i)`` yields client i's."""

    def __init__(self, mix: dict, templates: dict[str, dict], seed: int):
        self.mix = mix
        self.templates = templates
        self.seed = int(seed)
        self.names = list(mix["templates"])
        self.pools = {}
        if mix["params"] == "drawn":
            for t in self.names:
                p = pool(mix, t, templates[t]["validation"])
                order = _stream("deal", self.seed, t).permutation(len(p))
                self.pools[t] = [p[i] for i in order]

    def warmup(self) -> list[Statement]:
        return [self._validation(t) for t in self.names]

    def _validation(self, t: str) -> Statement:
        return Statement(t, tuple(sorted(
            self.templates[t]["validation"].items())))

    def client(self, i: int):
        mix, names = self.mix, self.names
        rng = _stream("client", self.seed, i)
        n = len(names)
        k = int(mix["clients"])
        taken = {t: 0 for t in names}
        while True:
            if mix["order"] == "permute":
                order = [names[j] for j in rng.permutation(n)]
            else:
                order = names
            for t in order:
                if mix["params"] == "validation":
                    yield self._validation(t)
                else:
                    p = self.pools[t]
                    # client i takes entries i, i + k, i + 2k, ...
                    j = (i + k * taken[t]) % len(p)
                    taken[t] += 1
                    yield Statement(t, p[j])

    def check_sample(self, keys: list[tuple]) -> list[tuple]:
        """The distinct statements the reference checks: all of them, or
        ``check_sample`` drawn from the seed, each template alike."""
        cap = int(self.mix.get("check_sample", 0))
        keys = sorted(set(keys), key=repr)
        if not cap or len(keys) <= cap:
            return keys
        rng = _stream("check", self.seed)
        by_t: dict[str, list] = {}
        for key in keys:
            by_t.setdefault(key[0], []).append(key)
        picked = []
        groups = [rng.permutation(len(v)).tolist() for v in by_t.values()]
        lists = list(by_t.values())
        r = 0
        while len(picked) < cap:
            for g, lst in zip(groups, lists):
                if r < len(g) and len(picked) < cap:
                    picked.append(lst[g[r]])
            r += 1
        return picked
