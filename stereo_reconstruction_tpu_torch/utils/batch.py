"""Batch runner with per-pair failure masking.

Port of ``stereo_reconstruction_tpu/utils/batch.py``. The reference aborts
the process on any failure (``throw std::runtime_error`` on scenario
bounds, fewer than 8 matches, a cheirality failure, fewer than 60 BA
points); here one bad pair does not sink the batch: each pair's outcome
carries a flag and an error string, and failed pairs are left out of the
aggregate metrics.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence

from stereo_reconstruction_tpu_torch.utils.profiling import append_jsonl


@dataclasses.dataclass
class PairOutcome:
    name: str
    ok: bool
    result: Any = None
    error: str = ""


def run_batch(pairs: Sequence, fn: Callable,
              metrics_path: Optional[str] = None) -> List[PairOutcome]:
    """Apply ``fn(pair)`` to each pair, masking failures.

    Device-level failures (a bad pose, too few matches) are flags inside
    the results; a host-level exception is caught for its pair alone."""
    outcomes: List[PairOutcome] = []
    for pair in pairs:
        name = getattr(pair, "name", str(len(outcomes)))
        try:
            result = fn(pair)
        except Exception as exc:  # noqa: BLE001 — per-pair isolation is the point
            outcomes.append(PairOutcome(name=name, ok=False,
                                        error=f"{type(exc).__name__}: {exc}"))
            if metrics_path:
                append_jsonl(metrics_path, {"pair": name, "ok": False, "error": str(exc)})
            continue
        outcomes.append(PairOutcome(name=name, ok=True, result=result))
        if metrics_path:
            record = {"pair": name, "ok": True}
            metrics = getattr(result, "metrics", None)
            if metrics:
                record.update(metrics)
            append_jsonl(metrics_path, record)
    return outcomes


def aggregate_metrics(outcomes: Sequence[PairOutcome]) -> Dict[str, float]:
    """Mean of the numeric metrics over successful pairs, and the counts of
    successful and failed pairs."""
    sums: Dict[str, float] = {}
    count = 0
    for o in outcomes:
        if not o.ok:
            continue
        metrics = getattr(o.result, "metrics", None)
        if not metrics:
            continue
        count += 1
        for k, v in metrics.items():
            if isinstance(v, (int, float)):
                sums[k] = sums.get(k, 0.0) + float(v)
    out = {k: v / max(count, 1) for k, v in sums.items()}
    out["num_ok"] = float(sum(o.ok for o in outcomes))
    out["num_failed"] = float(sum(not o.ok for o in outcomes))
    return out
