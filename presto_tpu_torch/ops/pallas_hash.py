"""Masked open-addressing hash table: insert and probe, kernel and plain version.

Counterpart of ``presto_tpu/ops/pallas_hash.py``, whose two Pallas kernels
become the hand-written CUDA kernels in ``kernels/hash_table.cu``:

- **insert** (``insert_table``): a power-of-two-slot table at load <= 0.5,
  built in at most ``INSERT_TRIPS`` rounds. In round d every pending row
  bids for slot ``(h(key) + d) & (S - 1)``; the lowest row id among the
  bidders for an empty slot claims it; every pending row whose slot now holds its
  key adopts the slot as its group id. Rows still pending after the last
  round raise the overflow flag. Also returns
  ``stats = [overflow, longest occupied run, distinct keys]``.
- **probe** (``probe_table``): a fixed-trip linear scan from ``h(key)``; a
  key match returns the stored build row, an empty slot ends the scan as a
  miss (-1).

Each wrapper launches its CUDA kernel for CUDA tensors and counts the launch
in its ``launches`` attribute, under a lock (drivers launch from several
threads), and in the launching thread's own tally (``thread_launches``,
which a fused segment reads to count the launches made inside it); for
CPU tensors it runs the plain PyTorch
version beside it (``insert_table_reference``, which takes the kernel's
rounds step for step, and ``probe_table_reference``), whose outputs are the
reference's bit for bit. Any other device raises. The constants have the reference's values.
"""
from __future__ import annotations

import threading
from typing import Optional, Tuple

import torch

# insert rounds per build attempt (the overflow flag catches the rest)
INSERT_TRIPS = 64
# builds whose longest occupied run exceeds this fall back to sorted
PROBE_TRIPS_CAP = 1 << 12
# table-size ceiling (slots): beyond this the build falls back to sorted
MAX_TABLE_SLOTS = 1 << 22

EMPTY = -1  # free-slot / miss sentinel

_INT32_MAX = 2 ** 31 - 1
_CLAIM_FREE = 2 ** 63 - 1  # claims entry of an empty slot: above every bid


_LAUNCH_LOCK = threading.Lock()
_THREAD = threading.local()


def _count_launch(wrapper) -> None:
    """One launch of ``wrapper``'s kernel: its process-wide count, under the
    lock, and the calling thread's tally."""
    with _LAUNCH_LOCK:
        wrapper.launches += 1
    name = wrapper.__name__
    setattr(_THREAD, name, getattr(_THREAD, name, 0) + 1)


def thread_launches(wrapper) -> int:
    """The launches of ``wrapper``'s kernel made by the calling thread."""
    return getattr(_THREAD, wrapper.__name__, 0)


def table_slots(n_rows: int) -> Optional[int]:
    """Power-of-two slot count at load factor <= 0.5, or None when the
    table would exceed the slot ceiling (callers fall back to sorted)."""
    slots = 1 << max(4, (2 * max(int(n_rows), 1) - 1).bit_length())
    return slots if slots <= MAX_TABLE_SLOTS else None


def probe_trips_for(max_run: int) -> int:
    """Static probe trip count for a measured longest occupied run: the run
    plus its terminating empty slot, bucketed to a power of two."""
    return 1 << max(3, int(max_run)).bit_length()


def _hash_base(comps: torch.Tensor, slots: int) -> torch.Tensor:
    """Row -> home slot, int32 (the reference's ``_hash_base``): multi-
    component keys fold through the mixer the way ``combined_key`` does."""
    from .hash_join import _GOLDEN, _mix64

    acc = _mix64(comps[0])
    for c in comps[1:]:
        acc = _mix64(acc ^ (c * _GOLDEN))
    return (acc & (slots - 1)).to(torch.int32)


def _max_occupied_run(used: torch.Tensor) -> torch.Tensor:
    """Longest circular run of occupied slots: doubled-array prefix-max of
    the last empty index (reads 2 * S when no slot is empty)."""
    S = used.shape[0]
    u2 = torch.cat([used, used])
    idx = torch.arange(2 * S, dtype=torch.int64, device=used.device)
    last_empty = torch.cummax(torch.where(u2, -1, idx), 0).values
    return (idx - last_empty)[S:].max()


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def insert_table_reference(comps: torch.Tensor, mask: torch.Tensor, slots: int,
                           trips: int = INSERT_TRIPS):
    """Plain PyTorch insert over (ncomps, n) int64 keys, step for step the
    kernel's rounds over a shrinking worklist of pending rows; the outputs
    are the reference's. Returns ``(slot_comps (ncomps, S) int64,
    slot_rows (S,) int32, gid (n,) int32, stats (3,) int32)``.

    Every masked row first bids for its home slot in round 0: it
    scatter-mins ``d << 32 | row`` into ``claims`` at its candidate slot
    ``(h + d) & (S - 1)`` (a row pending in round d has walked exactly d
    slots). A slot claimed in an earlier round holds a lower bid and keeps
    its owner, so only the bids for a slot that was empty at the start of
    the round compete, and the lowest row id wins. Round d then resolves its
    rows: ``claims[c]`` names the row that owns slot c, whether it won just
    now or in an earlier round, and every row whose input key equals the
    owner's resolves to c. The others bid for round d + 1 (if there is one),
    which cannot change an owner that round d reads.

    The rounds stop at an empty worklist or after ``trips`` rounds; the
    slot arrays then follow from ``claims``."""
    ncomps, n = comps.shape
    dev = comps.device
    h = _hash_base(comps, slots)
    claims = torch.full((slots,), _CLAIM_FREE, dtype=torch.int64, device=dev)
    gid = torch.full((n,), EMPTY, dtype=torch.int32, device=dev)

    def bid(d, rows):
        cand = ((h[rows] + d) & (slots - 1)).long()
        claims.scatter_reduce_(0, cand, (d << 32) | rows, "amin")
        return cand

    work = mask.nonzero().squeeze(1)
    cand = bid(0, work)
    for d in range(trips):
        if work.numel() == 0:
            break
        owner = claims[cand] & 0xFFFFFFFF
        same = (comps[:, owner] == comps[:, work]).all(0)
        gid[work[same]] = cand[same].to(torch.int32)
        work = work[~same]
        if d + 1 < trips:
            cand = bid(d + 1, work)
    used = claims != _CLAIM_FREE
    slot_rows = torch.where(used, claims & 0xFFFFFFFF, EMPTY).to(torch.int32)
    slot_comps = torch.zeros((ncomps, slots), dtype=torch.int64, device=dev)
    slot_comps[:, used] = comps[:, slot_rows[used].long()]
    stats = torch.stack([
        torch.tensor(work.numel() > 0, dtype=torch.int32, device=dev),  # overflow
        _max_occupied_run(used).to(torch.int32),    # probe scan bound
        used.sum().to(torch.int32),                 # distinct keys
    ])
    return slot_comps, slot_rows, gid, stats


def insert_round_profile(comps: torch.Tensor, mask: torch.Tensor, gid: torch.Tensor,
                         slots: int, trips: int) -> list:
    """Rows pending at the start of rounds 0..trips, derived from an
    insert's outputs: a row that resolved in round d walked d slots from its
    home (walks are shorter than the table), and an overflowed row never
    resolved. Equal to the kernel's per-round ``counts``."""
    home = _hash_base(comps, slots).long()
    dist = (gid.long() - home) & (slots - 1)
    resolved = mask & (gid >= 0)
    overflowed = int((mask & (gid < 0)).sum())
    walked = torch.bincount(dist[resolved], minlength=trips + 1)[:trips + 1]
    # rows that resolved in round >= d, i.e. a suffix sum of the walk lengths
    pending = walked.flip(0).cumsum(0).flip(0) + overflowed
    return [int(c) for c in pending.tolist()]


def probe_table_reference(slot_keys: torch.Tensor, slot_rows: torch.Tensor,
                          keys: torch.Tensor, mask: torch.Tensor, trips: int):
    """Plain PyTorch probe: per masked probe row, the matching build row id
    or EMPTY (-1), scanning at most ``trips`` slots."""
    slots = slot_keys.shape[0]
    h = _hash_base(keys.unsqueeze(0), slots)
    row = torch.full(keys.shape, EMPTY, dtype=torch.int32, device=keys.device)
    done = ~mask
    for d in range(trips):
        cand = ((h + d) & (slots - 1)).long()
        srow = slot_rows[cand]
        occupied = srow >= 0
        hit = ~done & occupied & (slot_keys[cand] == keys)
        row = torch.where(hit, srow, row)
        # an empty slot ends the cluster: everything after is a miss
        done = done | hit | ~occupied
    return row


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def _require(t: torch.Tensor, name: str, dtype: torch.dtype, shape: Tuple[int, ...],
             device: torch.device) -> None:
    if t.dtype != dtype or tuple(t.shape) != shape or t.device != device \
            or not t.is_contiguous():
        raise ValueError(
            f"{name}: want a contiguous {dtype} tensor of shape {shape} on "
            f"{device}, got {t.dtype} {tuple(t.shape)} on {t.device}"
            f"{'' if t.is_contiguous() else ' (not contiguous)'}")


def _check_slots(slots: int) -> None:
    if slots < 2 or slots & (slots - 1) or slots > _INT32_MAX:
        raise ValueError(f"slots must be a power of two >= 2, got {slots}")


def insert_table(comps: torch.Tensor, mask: torch.Tensor, slots: int,
                 trips: int = 0):
    """Insert-or-lookup: build the open-addressing table over the masked
    rows of ``comps``, a contiguous (ncomps, n) int64 tensor.

    Returns ``(slot_comps, slot_rows, gid, stats)``:
    - slot_comps: (ncomps, slots) int64 key storage (0 in empty slots)
    - slot_rows: (slots,) int32, the first inserting row id per slot, -1 empty
    - gid: (n,) int32, each masked row's slot; -1 for masked-off or
      overflowed rows
    - stats: (3,) int32, [overflow_flag, max_occupied_run, distinct_keys]
    """
    trips = trips or INSERT_TRIPS
    if trips < 1:
        raise ValueError(f"trips must be >= 1, got {trips}")
    if comps.dim() != 2 or comps.shape[0] < 1:
        raise ValueError(f"comps must be (ncomps >= 1, n), got {tuple(comps.shape)}")
    ncomps, n = comps.shape
    dev = comps.device
    _require(comps, "comps", torch.int64, (ncomps, n), dev)
    _require(mask, "mask", torch.bool, (n,), dev)
    _check_slots(slots)
    if n >= _INT32_MAX:
        raise ValueError(f"too many rows for int32 row ids: {n}")
    if dev.type == "cpu":
        return insert_table_reference(comps, mask, slots, trips)
    if dev.type != "cuda":
        raise RuntimeError(f"insert_table: no kernel for device {dev}")
    return _insert_cuda(comps, mask, slots, trips)[:4]


def _insert_cuda(comps: torch.Tensor, mask: torch.Tensor, slots: int, trips: int):
    """Launch the insert kernel on checked CUDA inputs; returns
    ``(slot_comps, slot_rows, gid, stats, counts)``, where ``counts[d]`` is
    the number of rows pending at the start of round d (0 past the last)."""
    from .. import kernels

    lib = kernels.library()
    ncomps, n = comps.shape
    dev = comps.device
    slot_comps = torch.empty((ncomps, slots), dtype=torch.int64, device=dev)
    slot_rows = torch.empty(slots, dtype=torch.int32, device=dev)
    gid = torch.empty(n, dtype=torch.int32, device=dev)
    stats = torch.empty(3, dtype=torch.int32, device=dev)
    claims = torch.empty(slots, dtype=torch.int64, device=dev)
    work = torch.empty((2, n, 2), dtype=torch.int32, device=dev)
    counts = torch.empty(trips + 1, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.ht_insert(comps.data_ptr(), mask.data_ptr(), ncomps, n, slots,
                            trips, slot_comps.data_ptr(), slot_rows.data_ptr(),
                            gid.data_ptr(), stats.data_ptr(), claims.data_ptr(),
                            work.data_ptr(), counts.data_ptr(), stream)
    kernels.check(lib, err, "ht_insert")
    _count_launch(insert_table)
    return slot_comps, slot_rows, gid, stats, counts


def insert_kernel_config(device) -> dict:
    """The insert kernel's launch shape on a CUDA device: cooperative grid
    blocks, threads per block, and the worklist size at which one block
    takes over the remaining rounds."""
    import ctypes

    from .. import kernels

    lib = kernels.library()
    vals = [ctypes.c_int() for _ in range(3)]
    with torch.cuda.device(device):
        err = lib.ht_insert_config(*(ctypes.byref(v) for v in vals))
    kernels.check(lib, err, "ht_insert_config")
    return dict(zip(("grid_blocks", "block_threads", "tail_rows"), (v.value for v in vals)))


insert_table.launches = 0


def probe_table(slot_keys: torch.Tensor, slot_rows: torch.Tensor,
                keys: torch.Tensor, mask: torch.Tensor, trips: int) -> torch.Tensor:
    """Probe: per masked probe row, the matching build row id or EMPTY(-1).
    ``trips`` must reach the build's longest occupied run plus its
    terminating empty slot (``probe_trips_for``); masked rows never match."""
    slots = slot_keys.shape[0] if slot_keys.dim() == 1 else -1
    n = keys.shape[0] if keys.dim() == 1 else -1
    dev = keys.device
    _require(slot_keys, "slot_keys", torch.int64, (slots,), dev)
    _require(slot_rows, "slot_rows", torch.int32, (slots,), dev)
    _require(keys, "keys", torch.int64, (n,), dev)
    _require(mask, "mask", torch.bool, (n,), dev)
    _check_slots(slots)
    if trips < 1:
        raise ValueError(f"trips must be >= 1, got {trips}")
    if dev.type == "cpu":
        return probe_table_reference(slot_keys, slot_rows, keys, mask, trips)
    if dev.type != "cuda":
        raise RuntimeError(f"probe_table: no kernel for device {dev}")
    from .. import kernels

    out = torch.empty(n, dtype=torch.int32, device=dev)
    if n == 0:  # nothing to launch, so nothing to count
        return out
    lib = kernels.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.ht_probe(slot_keys.data_ptr(), slot_rows.data_ptr(), slots,
                           keys.data_ptr(), mask.data_ptr(), n, trips,
                           out.data_ptr(), stream)
    kernels.check(lib, err, "ht_probe")
    _count_launch(probe_table)
    return out


probe_table.launches = 0
