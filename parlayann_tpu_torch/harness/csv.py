"""CSV export of sweep results — same table layout as the reference.

Counterpart of parlayann_tpu/harness/csv.py (the same rows and formats).

Reference: write_to_csv (check_nn_recall.h:127-158) with the escaping
semantics of csvfile.h (append mode, quoted strings).
"""

from __future__ import annotations

import csv as _csv
import dataclasses


@dataclasses.dataclass
class GraphRecord:
    """Graph_ build-metadata record (parse_results.h:12-30)."""

    name: str
    params: str
    size: int
    time: float
    avg_deg: float
    max_deg: int


def write_to_csv(path: str, bucketed, graph_record: GraphRecord) -> None:
    """Append one result block (check_nn_recall.h:127-158 column set)."""
    with open(path, "a", newline="") as f:
        w = _csv.writer(f)
        w.writerow(["GRAPH", "Parameters", "Size", "Build time", "Avg degree",
                    "Max degree"])
        w.writerow([graph_record.name, graph_record.params, graph_record.size,
                    f"{graph_record.time:.4f}", f"{graph_record.avg_deg:.2f}",
                    graph_record.max_deg])
        w.writerow([])
        w.writerow(["Num queries", "Target recall", "Actual recall", "QPS",
                    "Average Cmps", "Tail Cmps", "Average Visited",
                    "Tail Visited", "k", "Q", "cut"])
        for bucket, r in bucketed:
            w.writerow([r.num_queries, bucket, r.recall, f"{r.QPS:.1f}",
                        int(r.avg_cmps), int(r.tail_cmps), int(r.avg_visited),
                        int(r.tail_visited), r.k, r.beamQ, r.cut])
        w.writerow([])
        w.writerow([])
