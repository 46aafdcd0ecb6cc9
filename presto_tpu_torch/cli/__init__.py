"""Command-line client of the PyTorch port (``presto_tpu/cli``).

Usage:
  echo "select 1" | python -m presto_tpu_torch.cli --server http://localhost:8080
  python -m presto_tpu_torch.cli --execute "select count(*) from lineitem"
  python -m presto_tpu_torch.cli            # interactive REPL on a tty

Output formats: ALIGNED (default) or CSV (--output-format csv).
"""
from __future__ import annotations

import argparse
import sys
from typing import List, Optional

from ..client import QueryError, StatementClient


def split_statements(text: str) -> List[str]:
    """Split on ';' OUTSIDE string literals ('' is the in-literal escape) —
    `select 'a;b'` is one statement, not two."""
    out: List[str] = []
    buf: List[str] = []
    in_str = False
    i = 0
    while i < len(text):
        ch = text[i]
        if in_str:
            buf.append(ch)
            if ch == "'":
                if i + 1 < len(text) and text[i + 1] == "'":
                    buf.append("'")
                    i += 1
                else:
                    in_str = False
        elif ch == "'":
            in_str = True
            buf.append(ch)
        elif ch == ";":
            out.append("".join(buf))
            buf = []
        else:
            buf.append(ch)
        i += 1
    if "".join(buf).strip():
        out.append("".join(buf))
    return [s for s in out if s.strip()]


def statement_complete(text: str) -> bool:
    """Does the buffer end with a statement-terminating ';' (outside quotes)?"""
    in_str = False
    i = 0
    last_semi = -1
    while i < len(text):
        ch = text[i]
        if in_str:
            if ch == "'":
                if i + 1 < len(text) and text[i + 1] == "'":
                    i += 1
                else:
                    in_str = False
        elif ch == "'":
            in_str = True
        elif ch == ";":
            last_semi = i
        i += 1
    return last_semi >= 0 and not in_str and not text[last_semi + 1:].strip()


def format_aligned(columns: List[str], rows: List[list]) -> str:
    cells = [[("NULL" if v is None else str(v)) for v in r] for r in rows]
    widths = [len(c) for c in columns]
    for r in cells:
        for i, v in enumerate(r):
            widths[i] = max(widths[i], len(v))
    sep = "-+-".join("-" * w for w in widths)
    out = [" | ".join(c.ljust(w) for c, w in zip(columns, widths)), sep]
    for r in cells:
        out.append(" | ".join(v.ljust(w) for v, w in zip(r, widths)))
    out.append(f"({len(rows)} row{'s' if len(rows) != 1 else ''})")
    return "\n".join(out)


def format_csv(columns: List[str], rows: List[list]) -> str:
    import csv
    import io

    buf = io.StringIO()
    w = csv.writer(buf)
    w.writerow(columns)
    for r in rows:
        w.writerow(["" if v is None else v for v in r])
    return buf.getvalue().rstrip("\n")


def run_statement(server: str, sql: str, fmt: str) -> int:
    sql = sql.strip().rstrip(";")
    if not sql:
        return 0
    client = StatementClient(server, sql)
    try:
        rows = list(client.rows())
    except QueryError as e:
        print(f"Query failed: {e}", file=sys.stderr)
        return 1
    except OSError as e:
        print(f"Connection to {server} failed: {e}", file=sys.stderr)
        return 2
    cols = [c.name for c in client.columns] if client.columns else []
    text = (format_csv if fmt == "csv" else format_aligned)(cols, rows)
    print(text)
    return 0


def repl(server: str, fmt: str) -> int:
    """Interactive loop: a statement ends at a ';' outside quotes."""
    print(f"presto-tpu-torch connected to {server}. Semicolon ends a statement; "
          "quit/exit leaves.")
    buf: List[str] = []
    while True:
        try:
            line = input("presto-tpu-torch> " if not buf else "              -> ")
        except (EOFError, KeyboardInterrupt):
            print()
            return 0
        if not buf and line.strip().lower() in ("quit", "exit"):
            return 0
        buf.append(line)
        if statement_complete(" ".join(buf)):
            for stmt in split_statements(" ".join(buf)):
                run_statement(server, stmt, fmt)
            buf = []


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="presto-tpu-torch-cli")
    ap.add_argument("--server", default="http://localhost:8080")
    ap.add_argument("--execute", "-e", default=None,
                    help="run this statement and exit")
    ap.add_argument("--output-format", choices=["aligned", "csv"],
                    default="aligned")
    args = ap.parse_args(argv)

    if args.execute is not None:
        return run_statement(args.server, args.execute, args.output_format)
    if not sys.stdin.isatty():
        rc = 0
        for stmt in split_statements(sys.stdin.read()):
            rc = rc or run_statement(args.server, stmt, args.output_format)
        return rc
    return repl(args.server, args.output_format)


if __name__ == "__main__":
    sys.exit(main())
