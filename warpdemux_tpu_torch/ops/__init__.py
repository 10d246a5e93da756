"""Batched tensor ops of the decision step; kernels dispatch by device."""
