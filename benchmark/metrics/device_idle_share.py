"""device_idle_share: the share of the profiled sub-window in which no
operation ran on the card.

1 minus the union of the device operations' intervals (kernels, copies,
sets, from ``torch.profiler``) over the sub-window's length, in percent.
None where no device sub-window was profiled."""


def read(run):
    dev = run.get("device")
    if not dev or dev["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - dev["busy_s"] / dev["window_s"])
