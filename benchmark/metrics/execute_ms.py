"""execute_ms: the executor and the operators, per query.

The mean, over the queries answered in the window, of the ``lifecycle``
span ``execute`` (summed over a grouped query's buckets). None where no
answered query has one."""
from statistics import fmean


def read(run):
    vals = [life["execute"]
            for life in (run["spans"].get(a.get("query_id"), {}).get("lifecycle")
                         for a in run["answers"])
            if life and "execute" in life]
    return fmean(vals) if vals else None
