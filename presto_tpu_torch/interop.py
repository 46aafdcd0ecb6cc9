"""Carry state from the JAX reference into the PyTorch port, as numpy arrays.

- ``page_from_numpy`` turns a reference page's arrays (types, data arrays,
  row mask, dictionaries) into a port Page on ``device``.
- ``lookup_source_from_table`` turns the outputs of the reference's
  ``insert_table`` (slot keys, slot rows) and the build's key and payload
  columns into the port's open-addressing ``LookupSource``, so one and the
  same table can be probed from both sides.
- ``aggregation_state_from_numpy`` turns a reference aggregation builder's
  result (group keys, state columns, the sketches' (groups, width) tables
  among them, and the validity mask) into the port's, so the port's
  ``final_map`` can finish a state the reference built.

Nothing here imports the reference: the caller hands over numpy arrays.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from . import resolve_device
from .block import _NP_TO_TORCH, Block, Dictionary, Page, torch_dtype
from .ops.aggregates import AggregateCall
from .ops.hash_join import LookupSource
from .types import Type


def _tensor(a: np.ndarray, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    # a read-only array (a JAX array's view) is copied once
    return torch.from_numpy(np.require(a, requirements=["C", "W"])).to(device=device, dtype=dtype)


def page_from_numpy(types: Sequence[Type], arrays: Sequence[np.ndarray],
                    mask: np.ndarray,
                    dictionaries: Optional[Sequence[Optional[Dictionary]]] = None,
                    device="cuda") -> Page:
    """A port Page from per-column numpy arrays of one capacity."""
    device = resolve_device(device)
    blocks = [Block(t, _tensor(np.asarray(a), torch_dtype(t), device), None,
                    dictionaries[i] if dictionaries else None)
              for i, (t, a) in enumerate(zip(types, arrays))]
    return Page(tuple(blocks), _tensor(np.asarray(mask), torch.bool, device))


def lookup_source_from_table(slot_keys: np.ndarray, slot_rows: np.ndarray, trips: int,
                             keys: np.ndarray, payload: Sequence[np.ndarray],
                             payload_meta: Sequence[Tuple[Type, Optional[Dictionary]]],
                             device="cuda") -> LookupSource:
    """The port's unique-build open-addressing LookupSource over a table the
    reference built. ``slot_keys``/``slot_rows`` are ``insert_table``'s
    (slots,) outputs, ``trips`` the probe trip count (``probe_trips_for``),
    ``keys`` and ``payload`` the build's concatenated (n,) columns that the
    slot rows index."""
    device = resolve_device(device)
    rows = _tensor(np.asarray(slot_rows), torch.int32, device)
    return LookupSource(
        kind="pallas",
        key_arrays=(_tensor(np.asarray(keys), torch.int64, device),),
        payload=tuple(_tensor(np.asarray(p), torch_dtype(t), device)
                      for p, (t, _d) in zip(payload, payload_meta)),
        payload_meta=list(payload_meta),
        unique=True,
        ph_keys=_tensor(np.asarray(slot_keys), torch.int64, device),
        ph_rows=rows,
        ph_trips=int(trips),
        payload_nulls=tuple(None for _ in payload))


def aggregation_state_from_numpy(calls: Sequence[AggregateCall], keys: Sequence[np.ndarray],
                                 states: Sequence[np.ndarray], valid: np.ndarray,
                                 device="cuda") -> Tuple[tuple, tuple, torch.Tensor]:
    """A builder's ``finish`` triple (keys, states, valid) on ``device`` from
    the reference's numpy arrays: the interleaved (value, null flag) key
    columns, one array per state column of ``calls`` in order (a vector
    state as a (groups, width) array: HyperLogLog registers float32, the
    percentile histogram float64), and the (groups,) validity mask. Each
    state array must have its column's width; it takes its column's dtype."""
    device = resolve_device(device)
    cols = [col for c in calls for col in c.function.state]
    if len(cols) != len(states):
        raise ValueError(f"{len(states)} state arrays for {len(cols)} state columns")
    groups = np.asarray(valid).shape[0]
    out = []
    for col, a in zip(cols, states):
        a = np.asarray(a)
        want = (groups, col.width) if col.width > 1 else (groups,)
        if a.shape != want:
            raise ValueError(f"a state array of shape {a.shape}, its column needs {want}")
        out.append(_tensor(a, _NP_TO_TORCH[np.dtype(col.dtype)], device))
    key_tensors = tuple(torch.from_numpy(np.require(k, requirements=["C", "W"])).to(device)
                        for k in keys)
    return key_tensors, tuple(out), _tensor(np.asarray(valid), torch.bool, device)
