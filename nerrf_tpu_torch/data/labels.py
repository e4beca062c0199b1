"""Per-event label derivation from window-level ground truth.

(Copied from ``nerrf_tpu/data/labels.py`` so the port needs nothing of the JAX
package; keep the two identical: the parity tests compare their arrays.)

The reference's checked-in ground truth labels a single attack *window*
(`benchmarks/m1/results/m1_ground_truth.csv`), not individual events, while
its docs sketch per-event `is_attack` columns (`threat-model.mdx:108-119`).
This module bridges the two: given a window + target path, score each event by
the threat model's indicator heuristics (window membership, target-directory
writes/renames, suspicious extension, /proc recon reads, ransom-note names —
`docs/content/docs/architecture.mdx:112-120`).

Indicator logic lives in `schema.events.path_features` (one row per interned
string); here we only gather those rows by path id, so the per-event cost is a
vectorized lookup rather than Python string work — important at the ~25k
events/trace density the reference docs project (`threat-model.mdx:121-137`).
"""

from __future__ import annotations

import numpy as np

from nerrf_tpu_torch.data.loaders import Trace
from nerrf_tpu_torch.schema.events import Syscall

# Column indices into path_features() rows (see schema.events.path_features).
_F_PROC = 0
_F_SYSTEM = 2
_F_TARGETDIR = 3
_F_SUSPICIOUS = 4
_F_README = 5


def derive_event_labels(trace: Trace) -> np.ndarray:
    """float32 [N] per-event attack labels (1.0 = attack)."""
    if trace.labels is not None:
        return trace.labels
    if trace.ground_truth is None:
        return np.zeros(len(trace.events), np.float32)
    ev, st, gt = trace.events, trace.strings, trace.ground_truth
    in_window = gt.contains(ev.ts_ns)

    feats = st.features()  # [num_strings, PATH_FEATURE_DIM]
    pf = feats[ev.path_id]
    nf = feats[ev.new_path_id]

    suspicious = (pf[:, _F_SUSPICIOUS] > 0) | (nf[:, _F_SUSPICIOUS] > 0)
    ransom_note = pf[:, _F_README] > 0
    proc_read = pf[:, _F_PROC] > 0
    # target-directory membership: exact prefix match against the GT target,
    # not the generic /app heuristic feature
    under_target = np.array(
        [s.startswith(gt.target_path) for s in st.strings()], np.bool_
    )[ev.path_id]
    recon_files = np.array(
        [s == "/etc/passwd" for s in st.strings()], np.bool_
    )[ev.path_id]
    mutating = np.isin(
        ev.syscall,
        [int(Syscall.WRITE), int(Syscall.RENAME), int(Syscall.UNLINK), int(Syscall.OPENAT)],
    )

    label = in_window & (
        suspicious
        | ransom_note
        | (under_target & mutating)
        | proc_read
        | recon_files
    )
    return (label & ev.valid).astype(np.float32)
