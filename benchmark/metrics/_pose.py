"""The time of a pose sub-stage in a traced request, for the ``pose_*_ms``
readers."""

from typing import Optional

from benchmark.metrics._program import Request


def stage_ns(req: Request, name: str) -> Optional[int]:
    """The request's time in its spans ``name``: a span's device time where
    it recorded one (a stage replayed from a CUDA graph, whose host span
    only launches it), else its host-clock length; None where it has
    none."""
    found = [round(r.device_ms * 1e6) if getattr(r, "device_ms", None) is not None
             else r.end_ns - r.start_ns for _, r in req if r.name == name]
    return sum(found) if found else None
