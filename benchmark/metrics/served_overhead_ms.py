"""served_overhead_ms: what the server and the client add to a query.

The mean, over the queries answered in the window, of the client's latency
(from the POST of the statement to its last page of rows) less the engine's
``lifecycle`` span ``query`` of the same query, matched by the server's
query id. None where no query has both."""
from statistics import fmean


def read(run):
    gaps = [a["latency_s"] * 1e3 - run["spans"][a["query_id"]]["lifecycle"]["query"]
            for a in run["answers"]
            if "query" in run["spans"].get(a.get("query_id"), {}).get("lifecycle", {})]
    return fmean(gaps) if gaps else None
