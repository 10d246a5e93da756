"""The live read-until lane: streaming gates, balancers, clients and the
session whose micro-batches take one device round trip each."""

from warpdemux_tpu_torch.live.caches import ReadCache, AccumulatingCache
from warpdemux_tpu_torch.live.session import Session, ReadObject
from warpdemux_tpu_torch.live.balancer import BarcodeBalancer, BarcodeBalancers
