"""The yardstick of the hash-table kernels: the chip's peak and the bytes a
call must move.

The rule is the one the port's kernel table uses (PERF.md): each input
byte read once and each output byte written once, counting what these
inputs need, not the most they could.

- insert (``ht_insert``): the mask (n bytes), each live row's key
  components (8 bytes each), the group ids written (4 n), the table's slot
  keys (8 bytes a component a slot) and slot rows (4 a slot) written, and
  the 12-byte stats.
- probe (``ht_probe``): the mask, each live row's key (8 bytes), the row
  ids written (4 n), and the table's slots that the live rows must reach:
  at least one 32-byte sector of slot rows for each live row, never more
  than the whole table (12 bytes a slot) once.
"""
from __future__ import annotations

# device-memory rate of one NVIDIA H100 SXM, bytes/s (NVIDIA's data sheet)
HBM_BYTES_PER_S = 3.35e12
SECTOR = 32


def insert_bytes(n: int, live: int, ncomps: int, slots: int) -> int:
    return n + live * ncomps * 8 + n * 4 + ncomps * slots * 8 + slots * 4 + 3 * 4


def probe_bytes(n: int, live: int, slots: int) -> int:
    return n + live * 8 + n * 4 + min(slots * 12, live * SECTOR)


def call_bytes(call: dict) -> int:
    if call["kind"] == "insert":
        return insert_bytes(call["n"], call["live"], call["ncomps"], call["slots"])
    return probe_bytes(call["n"], call["live"], call["slots"])


def bound_s(nbytes: int) -> float:
    """The least time the chip could take to move ``nbytes``."""
    return nbytes / HBM_BYTES_PER_S
