"""Fault tolerance of the worker pools (the driver's heartbeat monitor) and
the search's elastic mesh (``elastic``)."""
from repro_torch.distributed.fault_tolerance import HeartbeatMonitor, WorkerInfo, WorkerState

__all__ = ["HeartbeatMonitor", "WorkerInfo", "WorkerState"]
