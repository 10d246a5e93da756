"""Host I/O: the pod5 reader and its VBZ signal codec (numpy)."""
