"""The cluster tier of the PyTorch port: coordinator + worker servers over HTTP.

The port's copy of ``presto_tpu/cluster/``: discovery and heartbeat failure
detection, node and stage scheduling, remote tasks, worker task management,
token-acked output buffers with a replay spool, the ``PSER1`` page wire
format, retry policies, straggler speculation, graceful drain, the cluster
memory manager and the autoscaler. Every worker's tasks run on its own
``device``; pages cross between workers as host frames and are uploaded once
by the consuming task's scan. Division of labour with ``parallel/``: there,
logical workers of one process exchange device tensors; here, worker
servers exchange serialized frames over HTTP."""
__all__ = ["ClusterQueryRunner", "WorkerServer", "Backoff", "FaultInjector",
           "WorkerPoolAutoscaler"]


def __getattr__(name):  # lazy: `python -m presto_tpu_torch.cluster.worker`
    if name == "ClusterQueryRunner":          # must not re-import its own module
        from .coordinator import ClusterQueryRunner
        return ClusterQueryRunner
    if name == "WorkerServer":
        from .worker import WorkerServer
        return WorkerServer
    if name == "Backoff":
        from .retry import Backoff
        return Backoff
    if name == "FaultInjector":
        from .faults import FaultInjector
        return FaultInjector
    if name == "WorkerPoolAutoscaler":
        from .autoscaler import WorkerPoolAutoscaler
        return WorkerPoolAutoscaler
    raise AttributeError(name)
