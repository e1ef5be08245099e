"""Fault tolerance of the worker pools (the driver's heartbeat monitor), the
training launcher's restart policy and the search's elastic mesh
(``elastic``)."""
from repro_torch.distributed.fault_tolerance import HeartbeatMonitor, RestartPolicy, WorkerInfo, WorkerState

__all__ = ["HeartbeatMonitor", "RestartPolicy", "WorkerInfo", "WorkerState"]
