"""Runs over several devices and several processes: the devices of a
host's workers (mesh.py) and the file-sharded run of one process a device
(multihost.py)."""

from warpdemux_tpu_torch.parallel.mesh import make_mesh
