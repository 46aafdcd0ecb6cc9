#!/usr/bin/env python3
"""Time the hash-table kernels beside design alternatives on one NVIDIA GPU.

    python3 kernel_sweep.py

At ``chip_smoke.py``'s inputs (the shapes TPC-H Q3 at SF1 gives the
kernels), each alternative is held bit-identical to the plain version and
then timed beside the shipped kernel in turns (shipped, variant, variant,
shipped; each the median of 20 CUDA-event timed calls):

- probe: walks compiled from ``PROBE_VARIANTS`` below, R rows per thread in
  lockstep, with the key of a visit loaded together with its row ("both")
  or only once the row shows the slot occupied ("dependent", the shipped
  kernel's choice at R = 1);
- insert: copies of ``kernels/hash_table.cu`` with another tail threshold
  or another cooperative grid; and the shipped insert with its rounds
  capped at k (the cost of rounds 0..k-1, and of the second launch).

Every kernel is called through its C entry point on preallocated buffers,
so the event times hold little host time; ``device_ms`` is the kernels'
own time from ``torch.profiler``.

Prints one ``SWEEP`` JSON line per measurement and the card line. Needs
CUDA and nvcc; builds into the git-ignored ``kernels/build/sweep/``.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys

import chip_smoke

PROBE_VARIANTS = r"""
#include <cuda_runtime.h>
namespace {
__device__ __forceinline__ unsigned long long mix64(unsigned long long x) {
  x = (x ^ (x >> 33)) * 0xFF51AFD7ED558CCDULL;
  x = (x ^ (x >> 33)) * 0xC4CEB9FE1A85EC53ULL;
  return x ^ (x >> 33);
}
template <int R, bool kBoth>
__global__ void __launch_bounds__(256) probe_rows(
    const long long* __restrict__ slot_keys, const int* __restrict__ slot_rows, int slots,
    const long long* __restrict__ keys, const unsigned char* __restrict__ mask, int n,
    int trips, int* __restrict__ out) {
  const long long first = (long long)blockIdx.x * (R * 256) + threadIdx.x;
  long long key[R];
  int cand[R], found[R];
  bool walking[R];
#pragma unroll
  for (int j = 0; j < R; ++j) {
    long long row = first + (long long)j * 256;
    key[j] = 0; cand[j] = 0; found[j] = -1;
    walking[j] = row < n && mask[row];
    if (walking[j]) {
      key[j] = keys[row];
      cand[j] = (int)(mix64((unsigned long long)key[j]) & (unsigned long long)(slots - 1));
    }
  }
  for (int d = 0; d < trips; ++d) {
    int srow[R];
    long long skey[R];
#pragma unroll
    for (int j = 0; j < R; ++j) {
      srow[j] = -1; skey[j] = 0;
      if (walking[j]) {
        srow[j] = slot_rows[cand[j]];
        if (kBoth) skey[j] = slot_keys[cand[j]];
      }
    }
    bool any = false;
#pragma unroll
    for (int j = 0; j < R; ++j) {
      if (!walking[j]) continue;
      if (srow[j] < 0) {
        walking[j] = false;
      } else if ((kBoth ? skey[j] : slot_keys[cand[j]]) == key[j]) {
        found[j] = srow[j];
        walking[j] = false;
      } else {
        cand[j] = (cand[j] + 1) & (slots - 1);
        any = true;
      }
    }
    if (!any) break;
  }
#pragma unroll
  for (int j = 0; j < R; ++j) {
    long long row = first + (long long)j * 256;
    if (row < n) out[row] = found[j];
  }
}
template <int R, bool kBoth>
int launch(const long long* sk, const int* sr, int slots, const long long* keys,
           const unsigned char* mask, int n, int trips, int* out, cudaStream_t s) {
  probe_rows<R, kBoth><<<(n + R * 256 - 1) / (R * 256), 256, 0, s>>>(sk, sr, slots, keys,
                                                                   mask, n, trips, out);
  return (int)cudaGetLastError();
}
}  // namespace
extern "C" int probe_variant(int rows, int both, const long long* sk, const int* sr,
                             int slots, const long long* keys, const unsigned char* mask,
                             int n, int trips, int* out, cudaStream_t s) {
  if (rows == 1) return both ? launch<1, true>(sk, sr, slots, keys, mask, n, trips, out, s)
                             : launch<1, false>(sk, sr, slots, keys, mask, n, trips, out, s);
  if (rows == 2) return both ? launch<2, true>(sk, sr, slots, keys, mask, n, trips, out, s)
                             : launch<2, false>(sk, sr, slots, keys, mask, n, trips, out, s);
  if (rows == 4) return both ? launch<4, true>(sk, sr, slots, keys, mask, n, trips, out, s)
                             : launch<4, false>(sk, sr, slots, keys, mask, n, trips, out, s);
  return (int)cudaErrorInvalidValue;
}
"""

# (name, text in kernels/hash_table.cu, replacement)
INSERT_VARIANTS = [
    ("tail_rows_256", "constexpr int kTailRows = 1024;", "constexpr int kTailRows = 256;"),
    ("tail_rows_2048", "constexpr int kTailRows = 1024;", "constexpr int kTailRows = 2048;"),
    ("grid_2_per_sm", "  *blocks = per_sm * sms;", "  *blocks = 2 * sms;"),
    ("grid_3_per_sm", "  *blocks = per_sm * sms;", "  *blocks = 3 * sms;"),
]


def emit(**rec) -> None:
    print("SWEEP " + json.dumps(rec), flush=True)


def build(name: str, source: str) -> ctypes.CDLL:
    from presto_tpu_torch import kernels

    out = kernels.BUILD_DIR / "sweep"
    out.mkdir(parents=True, exist_ok=True)
    cu, so = out / f"{name}.cu", out / f"lib{name}.so"
    cu.write_text(source)
    proc = subprocess.run([kernels.nvcc_path(), *kernels.NVCC_FLAGS, "-o", str(so), str(cu)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}:\n{proc.stderr}")
    return ctypes.CDLL(str(so))


def in_turns(shipped, variant, device):
    """Shipped, variant, variant, shipped: the two medians of each."""
    t = [chip_smoke.time_ms(f, 20, device) for f in (shipped, variant, variant, shipped)]
    return [t[0], t[3]], [t[1], t[2]]


def sweep_probe(device, inp, slot_keys, slot_rows, trips) -> None:
    import torch

    from presto_tpu_torch import kernels
    from presto_tpu_torch.ops import pallas_hash as ph

    shipped_lib = kernels.library()
    lib = build("probe_variants", PROBE_VARIANTS)
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.probe_variant.argtypes = [I, I, P, P, I, P, P, I, I, P, P]
    keys, mask = inp["pkeys"], inp["pmask"]
    n, slots = keys.shape[0], slot_keys.shape[0]
    want = ph.probe_table_reference(slot_keys, slot_rows, keys, mask, trips)
    out = torch.empty_like(want)
    args = (slot_keys.data_ptr(), slot_rows.data_ptr(), slots, keys.data_ptr(),
            mask.data_ptr(), n, trips, out.data_ptr(), torch.cuda.current_stream(device).cuda_stream)

    def shipped():
        kernels.check(shipped_lib, shipped_lib.ht_probe(*args), "ht_probe")

    for rows in (1, 2, 4):
        for both in (0, 1):
            def variant(rows=rows, both=both):
                kernels.check(lib, lib.probe_variant(rows, both, *args), "probe_variant")
            for fn in (shipped, variant):
                out.fill_(-2)
                fn()
                torch.cuda.synchronize()
                if not torch.equal(out, want):
                    raise AssertionError(f"probe rows={rows} both={both} differs")
            ship_ms, var_ms = in_turns(shipped, variant, device)
            emit(kernel="probe", variant=f"rows{rows}_{'both' if both else 'dependent'}",
                 ms=var_ms, shipped_ms=ship_ms,
                 device_ms=chip_smoke.device_ms(variant, 20, "probe_rows"),
                 shipped_device_ms=chip_smoke.device_ms(shipped, 20, "ht_probe"))


def insert_call(lib, device, comps, mask, slots, trips):
    """A call of ``lib``'s ht_insert on preallocated buffers, and its
    (slot_comps, slot_rows, gid, stats)."""
    import torch

    from presto_tpu_torch import kernels

    lib.ht_insert.argtypes = kernels._SIGNATURES["ht_insert"]
    ncomps, n = comps.shape
    outs = (torch.empty((ncomps, slots), dtype=torch.int64, device=device),
            torch.empty(slots, dtype=torch.int32, device=device),
            torch.empty(n, dtype=torch.int32, device=device),
            torch.empty(3, dtype=torch.int32, device=device))
    scratch = (torch.empty(slots, dtype=torch.int64, device=device),
               torch.empty((2, n, 2), dtype=torch.int32, device=device),
               torch.empty(trips + 1, dtype=torch.int32, device=device))
    args = (comps.data_ptr(), mask.data_ptr(), ncomps, n, slots, trips,
            *(t.data_ptr() for t in outs + scratch),
            torch.cuda.current_stream(device).cuda_stream)

    def call():
        kernels.check(lib, lib.ht_insert(*args), "ht_insert")
    return call, outs


def sweep_insert(device, inp) -> None:
    import torch

    from presto_tpu_torch import kernels
    from presto_tpu_torch.ops import pallas_hash as ph

    comps, mask, slots = inp["comps1"], inp["mask1"], inp["slots"]
    trips = ph.INSERT_TRIPS
    want = ph.insert_table_reference(comps, mask, slots)
    source = (kernels.BUILD_DIR.parent / kernels.SOURCE).read_text()
    shipped, _outs = insert_call(kernels.library(), device, comps, mask, slots, trips)

    for name, old, new in INSERT_VARIANTS:
        if old not in source:
            raise RuntimeError(f"insert variant {name}: {old!r} not in the source")
        lib = build(f"insert_{name}", source.replace(old, new))
        variant, got = insert_call(lib, device, comps, mask, slots, trips)
        variant()
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            raise AssertionError(f"insert variant {name} differs")
        ship_ms, var_ms = in_turns(shipped, variant, device)
        emit(kernel="insert", variant=name, ms=var_ms, shipped_ms=ship_ms,
             device_ms=chip_smoke.device_ms(variant, 20, "ht_insert_"),
             shipped_device_ms=chip_smoke.device_ms(shipped, 20, "ht_insert_"))

    for cap in (1, 2, 3, 4, 6, 8, 11, 15, 20, 25, 30, 40, trips):
        capped, _outs = insert_call(kernels.library(), device, comps, mask, slots, cap)
        emit(kernel="insert", rounds_cap=cap, ms=chip_smoke.time_ms(capped, 20, device),
             device_ms=chip_smoke.device_ms(capped, 20, "ht_insert_"),
             finish_device_ms=chip_smoke.device_ms(capped, 20, "ht_insert_finish"))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("kernel_sweep: CUDA is not available", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    from presto_tpu_torch.ops import pallas_hash as ph

    inp = chip_smoke.kernel_inputs(device)
    slot_comps, slot_rows, _gid, stats = ph.insert_table(inp["comps1"], inp["mask1"],
                                                         inp["slots"])
    sweep_probe(device, inp, slot_comps[0], slot_rows, ph.probe_trips_for(int(stats[1])))
    sweep_insert(device, inp)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
