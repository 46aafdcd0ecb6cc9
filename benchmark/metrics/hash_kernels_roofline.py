"""hash_kernels_roofline: the hash-table kernels against their roofline.

The least time the chip could take to move the bytes that the profiled
sub-window's inserts and probes must move (``benchmark/core/roofline.py``,
at the H100's 3.35 TB/s), over the device time of the ``ht_*`` kernels in
the same sub-window from ``torch.profiler``, in percent. None where the
sub-window held no call, or where the profiler recorded no ``ht_*`` kernel
for the calls made: the time has one source, the device trace."""
from benchmark.core import roofline


def read(run):
    calls = run.get("hash_calls") or []
    seconds = run.get("hash_kernel_s") or 0.0
    if not calls or seconds <= 0:
        return None
    bound = sum(roofline.bound_s(roofline.call_bytes(c)) for c in calls)
    return 100.0 * bound / seconds
