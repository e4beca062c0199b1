"""Fault plans: the declarative half of the chaos plane.

The port's host copy of ``nerrf_tpu/chaos/plan.py`` (stdlib only), kept
identical below this docstring: the respond tier's scenario schedules draw
their coins from `hash01`, and a plan's JSON parses alike in both packages.
The fault points that a plan arms live in ``chaos/points.py``; nothing
here arms anything.

A `FaultPlan` is a seed plus a list of `FaultSpec`s, each naming one
**fault point** (a site threaded through the real code path — see
`chaos.points.SITES` for the catalog) and how it should fire.  Plans are
plain JSON so a game-day schedule is reviewable, diffable, and replayable:

    {
      "seed": 7,
      "faults": [
        {"site": "serve.poison_window", "prob": 0.05,
         "match": {"stream": "s1"}},
        {"site": "ingest.wire_error", "every": 40,
         "match": {"stream": "w0"}},
        {"site": "serve.device_latency", "every": 9, "delay_sec": 0.2,
         "after_sec": 5.0, "for_sec": 20.0}
      ]
    }

Triggers (all optional; every present clause must hold for a spec to fire):

  * ``at``       — fire on exactly the Nth check of this spec (1-based);
  * ``every``    — fire on every Nth check;
  * ``prob``     — seeded probabilistic.  When the call site supplies a
    ``key`` (the window's trace ID, a cache fingerprint), the draw is a
    pure hash of (seed, site, key) — the SAME window fires the SAME way
    on every retry and every replay of the plan.  Without a key the draw
    hashes the per-spec check counter, so a seeded plan still replays
    deterministically under an identical check order;
  * ``match``    — equality over the call-site context (stream, bucket,
    window_idx, program, …): aim a fault at one stream or one window.

Bounds: ``after_sec``/``for_sec`` gate on time since arming (a fault that
switches on mid-soak and off again), ``max_fires`` caps total firings.

Determinism is the point: the same plan + seed + traffic produces the
same injected-fault set, so a soak failure reproduces and a bisection
retry sees the same poison it saw the first time.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
from typing import Dict, List, Optional, Tuple

# fault modes a spec can carry; what each means is the call site's
# contract (see chaos.points: error → raise ChaosFault, stall/latency →
# sleep delay_sec, corrupt → the caller mangles flip_bytes of its payload)
MODES = ("error", "stall", "corrupt")


class ChaosFault(RuntimeError):
    """The injected failure.  A distinct type so recovery paths (and
    tests) can tell an injected fault from an organic one in journals and
    error strings, while still flowing through every generic ``except
    Exception`` fail-open path exactly like the real thing."""


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One armed fault: site + trigger + bounds + fault parameters."""

    site: str
    mode: str = "error"
    # triggers — all present clauses must hold
    at: Optional[int] = None
    every: Optional[int] = None
    prob: Optional[float] = None
    match: Optional[Dict[str, object]] = None
    # bounds
    after_sec: float = 0.0
    for_sec: Optional[float] = None
    max_fires: Optional[int] = None
    # fault parameters
    message: str = ""
    delay_sec: float = 0.25
    flip_bytes: int = 16

    def validate(self, known_sites: Optional[Tuple[str, ...]] = None) -> None:
        if known_sites is not None and self.site not in known_sites:
            raise ValueError(
                f"unknown fault site {self.site!r} "
                f"(known: {', '.join(sorted(known_sites))})")
        if self.mode not in MODES:
            raise ValueError(f"unknown fault mode {self.mode!r} "
                             f"(one of {MODES})")
        if self.at is None and self.every is None and self.prob is None \
                and self.match is None:
            raise ValueError(
                f"spec for {self.site!r} has no trigger (at/every/prob/"
                f"match) — it would fire on every check; say every=1 if "
                f"that is really what you want")
        if self.prob is not None and not 0.0 <= self.prob <= 1.0:
            raise ValueError(f"prob must be in [0,1], got {self.prob}")
        for field, val in (("at", self.at), ("every", self.every),
                           ("max_fires", self.max_fires)):
            if val is not None and int(val) < 1:
                raise ValueError(f"{field} must be >= 1, got {val}")

    def to_dict(self) -> dict:
        out = {"site": self.site, "mode": self.mode}
        for f in dataclasses.fields(self):
            if f.name in ("site", "mode"):
                continue
            v = getattr(self, f.name)
            if v != f.default:
                out[f.name] = v
        return out


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """A seed + the armed specs.  Immutable: arming takes a plan, and the
    controller's mutable state (hit counters, fire counts) lives outside
    it, so one plan object replays any number of times."""

    seed: int = 0
    faults: Tuple[FaultSpec, ...] = ()

    def validate(self, known_sites: Optional[Tuple[str, ...]] = None
                 ) -> "FaultPlan":
        for spec in self.faults:
            spec.validate(known_sites)
        return self

    def to_dict(self) -> dict:
        return {"seed": self.seed,
                "faults": [s.to_dict() for s in self.faults]}

    @classmethod
    def from_dict(cls, d: dict) -> "FaultPlan":
        if not isinstance(d, dict):
            # a plan whose top level is the faults ARRAY is an easy
            # hand-editing mistake; it must read as INVALID, not crash
            raise ValueError(
                f"a fault plan is a JSON object "
                f'{{"seed": N, "faults": […]}}, got {type(d).__name__}')
        known = {f.name for f in dataclasses.fields(FaultSpec)}
        faults = []
        for i, raw in enumerate(d.get("faults", [])):
            extra = set(raw) - known
            if extra:
                raise ValueError(
                    f"fault[{i}]: unknown field(s) {sorted(extra)} "
                    f"(known: {sorted(known)})")
            if "site" not in raw:
                raise ValueError(f"fault[{i}] has no 'site'")
            spec = FaultSpec(**{k: (tuple(v) if isinstance(v, list) else v)
                                for k, v in raw.items()})
            faults.append(spec)
        return cls(seed=int(d.get("seed", 0)), faults=tuple(faults))

    @classmethod
    def from_json(cls, text: str) -> "FaultPlan":
        return cls.from_dict(json.loads(text))


def load_plan(path: str | os.PathLike) -> FaultPlan:
    with open(os.fspath(path)) as f:
        return FaultPlan.from_json(f.read())


def hash01(seed: int, site: str, key: str) -> float:
    """Pure draw in [0,1): the probabilistic trigger's coin.  Keyed draws
    are replay- and retry-stable by construction — the same (seed, site,
    key) is the same coin forever."""
    h = hashlib.blake2s(f"{seed}:{site}:{key}".encode(),
                        digest_size=8).digest()
    return int.from_bytes(h, "big") / 2.0 ** 64


def corrupt_payload(payload: bytes, seed: int, site: str,
                    flip_bytes: int = 16) -> bytes:
    """Deterministically mangle ``flip_bytes`` positions of a payload
    (seeded by the plan, spread over the buffer) — the corrupt-mode
    helper for byte-shaped fault points (cache payloads, sidecars)."""
    if not payload:
        return payload
    out = bytearray(payload)
    n = max(1, min(int(flip_bytes), len(out)))
    for i in range(n):
        h = hashlib.blake2s(f"{seed}:{site}:{i}".encode(),
                            digest_size=8).digest()
        pos = int.from_bytes(h[:4], "big") % len(out)
        out[pos] ^= h[4] or 0xA5
    return bytes(out)
