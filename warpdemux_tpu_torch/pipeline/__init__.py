"""The fused per-minibatch decision step."""
