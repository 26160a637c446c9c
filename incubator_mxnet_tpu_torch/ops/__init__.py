"""Ops: plain functions on tensors, and the hand-written kernels."""
