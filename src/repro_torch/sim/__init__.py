"""Simulation substrate: synthetic video repositories and their detectors."""
from repro_torch.sim.oracle import (
    Detections,
    class_select,
    filter_class,
    frame_embedding,
    noisy_detect,
    oracle_detect,
)
from repro_torch.sim.repository import Repository, RepoSpec, generate, instances_visible

__all__ = ["Repository", "RepoSpec", "generate", "instances_visible", "Detections", "oracle_detect",
           "noisy_detect", "frame_embedding", "class_select", "filter_class"]
