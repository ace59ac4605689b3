"""Fleet ledgers: every per-process run ledger of a workdir (counterpart of
the JAX package's ``obs/fleet.py``, its discovery half).

One process writes one ledger (``obs.ledger.per_process_filename``: rank 0
``telemetry.jsonl``, rank i > 0 ``telemetry-{i}.jsonl`` beside it).
:func:`discover_ledgers` finds and parses them all, each scoped to its last
run; the parallelism planner reads its measured margin and costs through
it (``parallel/planner.py``). The straggler analysis and the fleet report
section come with the telemetry readers (queue A 14.1).
"""

from __future__ import annotations

import dataclasses
import glob
import os
import re
from typing import Dict, List

from tensorflowdistributedlearning_tpu_torch.obs.ledger import (
    LEDGER_FILENAME,
    last_run_events,
    read_ledger_with_errors,
)

_SECONDARY_LEDGER_RE = re.compile(r"telemetry-(\d+)\.jsonl$")


@dataclasses.dataclass
class ProcessLedger:
    """One process's parsed ledger. ``events`` is scoped to the last run
    (what every aggregation reads); ``all_events`` keeps the whole appended
    history, the same parsed objects."""

    process_index: int
    path: str
    events: List[Dict]
    all_events: List[Dict]
    parse_errors: int

    @property
    def header(self) -> Dict:
        if self.events and self.events[0].get("event") == "run_header":
            return self.events[0]
        return {}


def discover_ledgers(workdir: str) -> List[ProcessLedger]:
    """Every per-process ledger under ``workdir``, sorted by process index.

    ``telemetry.jsonl`` is process 0 (a header's explicit
    ``process_index`` wins over the file name); ``telemetry-{i}.jsonl`` is
    process i. An unreadable file is skipped; an empty list means the
    workdir holds no ledger."""
    candidates = []
    canonical = os.path.join(workdir, LEDGER_FILENAME)
    if os.path.isfile(canonical):
        candidates.append((0, canonical))
    for path in sorted(glob.glob(os.path.join(workdir, "telemetry-*.jsonl"))):
        m = _SECONDARY_LEDGER_RE.search(os.path.basename(path))
        if m:
            candidates.append((int(m.group(1)), path))
    ledgers: List[ProcessLedger] = []
    for index, path in candidates:
        try:
            all_events, errors = read_ledger_with_errors(path)
        except OSError:
            continue
        events = last_run_events(all_events)
        header = events[0] if events and events[0].get("event") == "run_header" else {}
        ledgers.append(ProcessLedger(process_index=int(header.get("process_index", index)), path=path,
                                     events=events, all_events=all_events, parse_errors=errors))
    ledgers.sort(key=lambda led: led.process_index)
    return ledgers
