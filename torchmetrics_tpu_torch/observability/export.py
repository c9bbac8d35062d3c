"""Exporters: Perfetto trace JSON, Prometheus text scrape, JSONL event log.

Counterpart of ``torchmetrics_tpu/observability/export.py``, line for
line: a trace or a scrape of either package reads the same. Three
machine-readable views of the telemetry collected by
:mod:`~torchmetrics_tpu_torch.observability.spans` and
:mod:`~torchmetrics_tpu_torch.observability.registry`:

* :func:`to_perfetto` — Chrome/Perfetto ``trace_event`` JSON
  (``{"traceEvents": [...]}`` with ``ph: "X"`` complete events, micro-
  second timestamps). Load at https://ui.perfetto.dev.
* :func:`to_prometheus` — the text exposition format a Prometheus
  scraper expects (``# HELP`` / ``# TYPE`` / samples with labels).
* :class:`JsonlEventLog` — append-only one-JSON-object-per-line log.
  Each write is a single appended line followed by ``flush``; a
  preemption mid-run loses at most the current line and never corrupts
  prior records, so restarted workers keep appending to the same file.
"""
from __future__ import annotations

import json
import os
from typing import IO, Any, Dict, List, Optional

from .registry import Counter, Gauge, Histogram, Registry, REGISTRY
from .spans import Span, collected_spans

__all__ = [
    "to_perfetto",
    "write_perfetto",
    "to_prometheus",
    "JsonlEventLog",
]


def _json_safe(value: Any) -> Any:
    if isinstance(value, (str, int, float, bool)) or value is None:
        return value
    return str(value)


def to_perfetto(
    spans: Optional[List[Span]] = None,
    process_name: str = "torchmetrics_tpu",
) -> Dict[str, Any]:
    """Render spans as a Chrome/Perfetto ``trace_event`` document.

    Completed spans become ``ph: "X"`` (complete) events with ``ts``/
    ``dur`` in microseconds; zero-duration records become ``ph: "i"``
    instants. Span nesting is reconstructed by Perfetto from the shared
    ``tid`` timeline, and parent ids ride along in ``args`` for tools
    that want the explicit tree.
    """
    if spans is None:
        spans = collected_spans()
    events: List[Dict[str, Any]] = [
        {
            "name": "process_name",
            "ph": "M",
            "pid": os.getpid(),
            "args": {"name": process_name},
        }
    ]
    pid = os.getpid()
    for s in spans:
        if s.t1 is None:
            continue
        args = {k: _json_safe(v) for k, v in s.attrs.items()}
        args["span_id"] = s.span_id
        if s.parent_id:
            args["parent_id"] = s.parent_id
        if s.fenced:
            args["fenced"] = True
        dur_us = (s.t1 - s.t0) * 1e6
        ev: Dict[str, Any] = {
            "name": s.name,
            "pid": pid,
            "tid": s.tid,
            "ts": s.t0 * 1e6,
            "args": args,
        }
        if dur_us <= 0.0:
            ev.update(ph="i", s="t")
        else:
            ev.update(ph="X", dur=dur_us)
        events.append(ev)
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def write_perfetto(
    path: str,
    spans: Optional[List[Span]] = None,
    process_name: str = "torchmetrics_tpu",
) -> str:
    doc = to_perfetto(spans, process_name=process_name)
    with open(path, "w") as fh:
        json.dump(doc, fh)
    return path


def _prom_name(name: str) -> str:
    out = []
    for ch in name:
        out.append(ch if ch.isalnum() or ch == "_" else "_")
    sanitized = "".join(out)
    if sanitized and sanitized[0].isdigit():
        sanitized = "_" + sanitized
    return sanitized


def _prom_escape(value: str) -> str:
    """Escape a label value per the text exposition format.

    Backslash first (so later escapes aren't doubled), then double-quote
    and newline — the three characters the format reserves.
    """
    return (
        str(value)
        .replace("\\", "\\\\")
        .replace('"', '\\"')
        .replace("\n", "\\n")
    )


def _prom_labels(labels) -> str:
    if not labels:
        return ""
    body = ",".join(f'{k}="{_prom_escape(v)}"' for k, v in labels)
    return "{" + body + "}"


def _prom_value(value: float) -> str:
    if float(value).is_integer():
        return str(int(value))
    return repr(float(value))


def to_prometheus(registry: Optional[Registry] = None, prefix: str = "tmtpu") -> str:
    """Render the registry in the Prometheus text exposition format."""
    if registry is None:
        registry = REGISTRY
    lines: List[str] = []
    for inst in registry.instruments():
        metric = _prom_name(f"{prefix}_{inst.name}")
        if isinstance(inst, Counter):
            lines.append(f"# HELP {metric} {inst.help or inst.name}")
            lines.append(f"# TYPE {metric} counter")
            samples = inst.collect() or [((), 0.0)]
            for labels, value in samples:
                lines.append(f"{metric}{_prom_labels(labels)} {_prom_value(value)}")
        elif isinstance(inst, Gauge):
            lines.append(f"# HELP {metric} {inst.help or inst.name}")
            lines.append(f"# TYPE {metric} gauge")
            samples = inst.collect() or [((), 0.0)]
            for labels, value in samples:
                lines.append(f"{metric}{_prom_labels(labels)} {_prom_value(value)}")
        elif isinstance(inst, Histogram):
            lines.append(f"# HELP {metric} {inst.help or inst.name}")
            lines.append(f"# TYPE {metric} histogram")
            # a registered-but-never-observed histogram still emits one
            # valid unlabeled series (all-zero buckets, zero sum/count)
            samples = inst.collect() or [((), [0] * len(inst.buckets), 0.0, 0)]
            for labels, counts, total_sum, total in samples:
                cumulative = 0
                for le, n in zip(inst.buckets, counts):
                    cumulative += n
                    bucket_labels = tuple(labels) + (("le", repr(float(le))),)
                    lines.append(
                        f"{metric}_bucket{_prom_labels(bucket_labels)} {cumulative}"
                    )
                inf_labels = tuple(labels) + (("le", "+Inf"),)
                lines.append(f"{metric}_bucket{_prom_labels(inf_labels)} {total}")
                lines.append(
                    f"{metric}_sum{_prom_labels(labels)} {_prom_value(total_sum)}"
                )
                lines.append(f"{metric}_count{_prom_labels(labels)} {total}")
    return "\n".join(lines) + "\n"


class JsonlEventLog:
    """Append-only JSONL sink, safe under preemption.

    The file is opened in append mode so a rejoining worker resumes the
    same log; every record is written as one line then flushed, so a
    kill mid-run can truncate at most the final line (readers skip a
    trailing partial line via :meth:`read`).

    ``max_bytes`` arms size-capped rotation for long serve runs: when a
    record would push the active file past the cap, the file is atomically
    renamed to ``<path>.1`` (one backup generation, so disk stays bounded
    at roughly twice the cap) and the record starts a fresh file. Records
    are never split across the boundary, and rotation preserves the
    torn-trailing-line guarantee — a partial line torn by a preemption
    rides along into the rotated file, where :meth:`read` still skips it.
    """

    def __init__(self, path: str, max_bytes: Optional[int] = None) -> None:
        self.path = path
        self.max_bytes = max_bytes
        self._fh: Optional[IO[str]] = None

    @property
    def rotated_path(self) -> str:
        return self.path + ".1"

    def _ensure_open(self) -> IO[str]:
        if self._fh is None or self._fh.closed:
            self._fh = open(self.path, "a")
        return self._fh

    def _maybe_rotate(self, incoming_len: int) -> None:
        if not self.max_bytes:
            return
        try:
            size = os.path.getsize(self.path)
        except OSError:
            return
        if size and size + incoming_len > self.max_bytes:
            self.close()
            os.replace(self.path, self.rotated_path)

    def write(self, record: Dict[str, Any]) -> None:
        line = json.dumps({k: _json_safe(v) for k, v in record.items()}) + "\n"
        self._maybe_rotate(len(line))
        fh = self._ensure_open()
        fh.write(line)
        fh.flush()

    def write_span(self, span: Span) -> None:
        self.write(
            {
                "type": "span",
                "name": span.name,
                "t0": span.t0,
                "dur_s": span.duration_s,
                "span_id": span.span_id,
                "parent_id": span.parent_id,
                **span.attrs,
            }
        )

    def close(self) -> None:
        if self._fh is not None and not self._fh.closed:
            self._fh.close()

    def __enter__(self) -> "JsonlEventLog":
        self._ensure_open()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close()

    @staticmethod
    def read(path: str, include_rotated: bool = True) -> List[Dict[str, Any]]:
        """Parse a JSONL log, tolerating a truncated final line.

        With ``include_rotated`` (the default) a ``<path>.1`` backup left
        by :attr:`max_bytes` rotation is read first, so the caller sees
        the logical log in order; a line torn by a preemption — whether
        it now sits at the end of the backup or of the active file — is
        skipped, never merged across the boundary.
        """
        records: List[Dict[str, Any]] = []
        paths = [path + ".1", path] if include_rotated else [path]
        for p in paths:
            if not os.path.exists(p):
                continue
            with open(p) as fh:
                for line in fh:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        records.append(json.loads(line))
                    except json.JSONDecodeError:
                        continue  # partial trailing line from a preemption
        return records
