"""Simulation substrate: synthetic video repositories + the oracle detector."""
from repro_torch.sim.oracle import Detections, class_select, filter_class, oracle_detect
from repro_torch.sim.repository import Repository, RepoSpec, generate, instances_visible

__all__ = ["Repository", "RepoSpec", "generate", "instances_visible", "Detections", "oracle_detect",
           "class_select", "filter_class"]
