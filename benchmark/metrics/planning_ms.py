"""planning_ms: the SQL front end and the local planner, per query.

The mean, over the queries answered in the window, of the ``lifecycle``
spans ``parse``, ``plan`` and ``local_plan`` (summed over a grouped
query's buckets). None where no answered query has a trace."""
from statistics import fmean

PHASES = ("parse", "plan", "local_plan")


def read(run):
    vals = [sum(life.get(p, 0.0) for p in PHASES)
            for life in (run["spans"].get(a.get("query_id"), {}).get("lifecycle")
                         for a in run["answers"])
            if life and "parse" in life]
    return fmean(vals) if vals else None
