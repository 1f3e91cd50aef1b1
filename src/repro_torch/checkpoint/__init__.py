"""Checkpoints and fault tolerance of the port (counterpart of ``repro.checkpoint``)."""
from .checkpoint import save, restore, latest_step, list_steps
from .fault_tolerance import LoopReport, run_resilient_loop
