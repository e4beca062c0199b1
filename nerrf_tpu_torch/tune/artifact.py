"""The versioned tuned-ladder artifact: what `nerrf tune` emits and every
deployment surface consumes.

One JSON document carries the fitted configuration — the bucket ladder
and the per-rung kernel routing table — plus the evidence that produced
it: expected padded device seconds for the static and tuned ladders under
the SAME fitted cost model, the fit's provenance (measured buckets,
priors cited), and a fingerprint of the corpus it was fitted from.  The
artifact is the unit of deployment:

  * ``apply_to_serve_config`` rebuilds a `ServeConfig` on the tuned
    ladder (`serve-detect --tuned`);
  * ``apply_to_model_config`` stamps the routing table into the model's
    `GraphSAGEConfig.routing`, which the forward consults first at every
    padded node bucket.

Everything admission/warmup already guarantees holds unchanged: the tuned
ladder is just a different ``ServeConfig.buckets`` value, so warmup runs
exactly the tuned set and admission rejects outside it.

The port's host copy of ``nerrf_tpu/tune/artifact.py`` over the port's
`ServeConfig` and model configs; the reference's AOT re-export of a tuned
ladder (`compilecache.aot.export_for_checkpoint(..., tuned=...)`) waits for
the compile cache (ROADMAP A.7).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from pathlib import Path
from typing import Optional, Tuple

ARTIFACT_SCHEMA = 1
ARTIFACT_KIND = "nerrf_tuned_ladder"

_MODES = ("fused", "dense_adj", "segment")


class TuneError(ValueError):
    """A one-line, operator-facing refusal (bad corpus, bad artifact).
    CLI surfaces print ``str(e)`` and exit nonzero — never a traceback."""


def corpus_fingerprint(corpus: dict) -> str:
    """Stable content hash of a tune corpus (sorted-key canonical JSON),
    stamped into the artifact so a fit is attributable to its data."""
    blob = json.dumps(corpus, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


def build_artifact(buckets, routing, expected: dict, fit: dict,
                   corpus: Optional[dict] = None) -> dict:
    art = {
        "schema": ARTIFACT_SCHEMA,
        "kind": ARTIFACT_KIND,
        "buckets": [list(b) for b in buckets],
        "routing": [list(r) for r in routing],
        "expected": expected,
        "fit": fit,
        "corpus_fingerprint": (corpus_fingerprint(corpus)
                               if corpus is not None else None),
        "provenance": "nerrf tune",
    }
    validate_artifact(art)
    return art


def validate_artifact(art: dict) -> dict:
    """Raise `TuneError` (one line) unless ``art`` is a well-formed tuned
    ladder this code version can apply; returns ``art`` unchanged."""
    if not isinstance(art, dict):
        raise TuneError("tuned artifact is not a JSON object")
    if art.get("kind") != ARTIFACT_KIND:
        raise TuneError(
            f"not a tuned-ladder artifact (kind={art.get('kind')!r}, "
            f"want {ARTIFACT_KIND!r})")
    if int(art.get("schema") or 0) > ARTIFACT_SCHEMA:
        raise TuneError(
            f"tuned artifact schema {art.get('schema')} is newer than "
            f"this build understands ({ARTIFACT_SCHEMA}) — upgrade first")
    buckets = art.get("buckets") or []
    if not buckets:
        raise TuneError("tuned artifact carries an empty bucket ladder")
    for b in buckets:
        if len(b) != 3 or any(int(x) <= 0 for x in b):
            raise TuneError(f"malformed bucket {b!r} (want [n, e, s] > 0)")
    for r in art.get("routing") or []:
        if len(r) != 2 or int(r[0]) <= 0 or r[1] not in _MODES:
            raise TuneError(f"malformed routing entry {r!r} "
                            f"(want [max_nodes, mode])")
    return art


def artifact_buckets(art: dict) -> Tuple[Tuple[int, int, int], ...]:
    return tuple(sorted(tuple(int(x) for x in b)
                        for b in art["buckets"]))


def artifact_routing(art: dict) -> Tuple[Tuple[int, str], ...]:
    return tuple(sorted((int(cap), str(mode))
                        for cap, mode in (art.get("routing") or [])))


def save_artifact(path, art: dict) -> None:
    """Validate and atomically publish the tuned-ladder artifact.

    Serve boots from this file (`--tuned`), so a crash mid-write must
    never leave a torn JSON on the final name: stage to a tmp name in
    the same directory and `os.replace` it into place, like every other
    durable publish in the repo."""
    p = Path(path)
    tmp = p.with_name(p.name + ".tmp")
    tmp.write_text(json.dumps(validate_artifact(art), indent=2) + "\n")
    tmp.replace(p)


def load_artifact(path) -> dict:
    p = Path(path)
    try:
        art = json.loads(p.read_text())
    except FileNotFoundError:
        raise TuneError(f"tuned artifact not found: {p}") from None
    except ValueError as e:
        raise TuneError(f"tuned artifact {p} is not JSON ({e})") from None
    return validate_artifact(art)


def apply_to_serve_config(art: dict, cfg=None):
    """A `ServeConfig` on the tuned ladder (every other knob keeps the
    base config's value)."""
    from nerrf_tpu_torch.serve.config import ServeConfig

    validate_artifact(art)
    base = cfg if cfg is not None else ServeConfig()
    return dataclasses.replace(base, buckets=artifact_buckets(art))


def apply_to_model_config(art: dict, model_cfg):
    """The model config with the artifact's routing table stamped into
    its `GraphSAGEConfig.routing` — accepts a `JointConfig` (routes into
    ``.gnn``) or a bare `GraphSAGEConfig`.  No routing in the artifact →
    the config comes back unchanged (auto rule keeps serving)."""
    validate_artifact(art)
    routing = artifact_routing(art)
    if not routing:
        return model_cfg
    if hasattr(model_cfg, "gnn"):
        return dataclasses.replace(
            model_cfg,
            gnn=dataclasses.replace(model_cfg.gnn, routing=routing))
    return dataclasses.replace(model_cfg, routing=routing)
