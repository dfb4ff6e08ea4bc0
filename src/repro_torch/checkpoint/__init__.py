"""Crash-consistent snapshots of training state (``checkpoint.io``)."""
