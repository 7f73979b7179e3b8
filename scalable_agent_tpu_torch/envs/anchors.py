"""The port's copy of the JAX package's envs/anchors.py.

Anchor-table provenance machinery (VERDICT r4 #7 / ADVICE r4).

The human/random anchor tables in `envs/dmlab30.py` and
`envs/atari57.py` were reconstructed without access to their upstream
sources (reference mount empty, zero network egress — see each
module's caveat). A misremembered constant silently corrupts every
human-normalized score, so the tables carry three mechanical guards:

1. a pinned SHA-256 (`ANCHOR_SHA256`) of the canonical serialization —
   any accidental edit of a constant fails the self-check the next
   time scoring runs (and `tests/test_anchors.py`);
2. a once-per-process provenance warning when a score is computed from
   a table whose `ANCHOR_PROVENANCE` is still 'reconstructed', so no
   reported number can claim verified anchors by silence;
3. `scripts/verify_anchors.py`, which diffs the tables symbol-by-symbol
   against the upstream files once network/reference access exists and
   prints the one-line edit that flips provenance to 'verified'
   (docs/RUNBOOK.md §2 is the operator protocol).
"""

import hashlib
import logging
from typing import Dict

# Module names already warned this process (once-per-run semantics).
_warned = set()


def anchor_checksum(tables: Dict[str, Dict[str, float]]) -> str:
  """SHA-256 over a canonical serialization of named anchor tables.

  Keys sorted, floats via repr (exact — these are decimal literals,
  not computed values), so the checksum is stable across Python
  versions and dict orderings.
  """
  parts = []
  for table_name in sorted(tables):
    parts.append(table_name)
    table = tables[table_name]
    for key in sorted(table):
      parts.append(f'{key}={table[key]!r}')
  blob = '\n'.join(parts).encode('utf-8')
  return hashlib.sha256(blob).hexdigest()


def check_provenance(module_name: str, provenance: str,
                     pinned_sha256: str,
                     tables: Dict[str, Dict[str, float]]) -> None:
  """Scoring-time gate: self-check the table checksum, and warn once
  per process if the table is still unverified against upstream.

  Raises ValueError on checksum mismatch — a silently edited anchor
  is worse than no score at all.
  """
  actual = anchor_checksum(tables)
  if actual != pinned_sha256:
    raise ValueError(
        f'{module_name} anchor tables do not match their pinned '
        f'checksum (expected {pinned_sha256[:16]}…, got '
        f'{actual[:16]}…). A constant was edited without updating '
        f'ANCHOR_SHA256 — if the edit was a deliberate upstream '
        f'correction, rerun scripts/verify_anchors.py and update the '
        f'pinned value it prints.')
  if provenance != 'verified' and module_name not in _warned:
    _warned.add(module_name)
    logging.warning(
        '%s anchor tables are PROVENANCE=%r: reconstructed without '
        'access to the upstream source. Human-normalized scores '
        'computed from them are provisional until the tables are '
        'diffed against upstream (scripts/verify_anchors.py; '
        'docs/RUNBOOK.md section 2).', module_name, provenance)
