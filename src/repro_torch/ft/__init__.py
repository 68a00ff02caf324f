"""Fault tolerance of the training path: checkpoints, straggler
detection and the elastic mesh plan."""
