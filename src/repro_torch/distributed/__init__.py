"""Fault tolerance of the worker pools: the driver's heartbeat monitor.
The elastic mesh comes with the mesh slice of the port."""
from repro_torch.distributed.fault_tolerance import HeartbeatMonitor, WorkerInfo, WorkerState

__all__ = ["HeartbeatMonitor", "WorkerInfo", "WorkerState"]
