"""MinKNOW gRPC transport for the read-until client (a copy of
warpdemux_tpu/live/minknow_grpc.py).

Adapts MinKNOW's bidirectional `data.get_live_reads` stream (the protocol
the reference's vendored read_until_api v3.4.1 speaks,
warpdemux/read_until/base.py:237-653) to the transport interface consumed
by warpdemux_tpu_torch.live.read_until.ReadUntilClient:

    transport.start(setup) -> iterator of responses with .chunks /
                              .action_responses
    transport.send_actions(actions)

Requires the external `minknow_api` package (gRPC stubs + Manager); this
module imports it lazily so the rest of the live stack (dummy harness,
session, balancers) works without it.
"""

from __future__ import annotations

import queue
from dataclasses import dataclass, field

import numpy as np


@dataclass
class _Response:
    chunks: list = field(default_factory=list)
    action_responses: list = field(default_factory=list)


class MinknowTransport:
    """get_live_reads stream wrapper for one sequencing position."""

    def __init__(self, host="127.0.0.1", port=None, device=None):
        from minknow_api.manager import Manager

        mgr = Manager(host=host, port=port)
        positions = list(mgr.flow_cell_positions())
        if device is not None:
            positions = [p for p in positions if p.name == device]
        if not positions:
            raise RuntimeError("no MinKNOW flow-cell position found")
        self.connection = positions[0].connect()
        self._request_queue: queue.Queue = queue.Queue()
        self._setup = None

    # ---- request iterator fed into the bidirectional stream ------------

    def _requests(self):
        yield self._setup
        while True:
            item = self._request_queue.get()
            if item is None:
                return
            yield item

    def start(self, setup: dict):
        from minknow_api import data_pb2

        self._setup = data_pb2.GetLiveReadsRequest(
            setup=data_pb2.GetLiveReadsRequest.StreamSetup(
                first_channel=setup["first_channel"],
                last_channel=setup["last_channel"],
                raw_data_type=(
                    data_pb2.GetLiveReadsRequest.CALIBRATED
                    if setup["raw_data_type"] == "calibrated"
                    else data_pb2.GetLiveReadsRequest.UNCALIBRATED
                ),
                sample_minimum_chunk_size=0,
            )
        )
        stream = self.connection.data.get_live_reads(self._requests())
        return self._responses(stream)

    def _responses(self, stream):
        from warpdemux_tpu_torch.live.read_until import ReadChunk

        for resp in stream:
            out = _Response()
            for aresp in resp.action_responses:
                out.action_responses.append(aresp.action_id)
            for channel, read in resp.channels.items():
                sig = np.frombuffer(read.raw_data, np.float32)
                out.chunks.append(
                    ReadChunk(
                        channel=int(channel),
                        read_id=read.id,
                        read_number=read.number,
                        signal=sig,
                        chunk_start=int(read.chunk_start_sample),
                        start_sample=int(
                            getattr(read, "start_sample", 0)
                        ),
                        chunk_classifications=tuple(
                            str(c) for c in read.chunk_classifications
                        ),
                    )
                )
            yield out

    def send_actions(self, actions):
        from minknow_api import data_pb2

        pb_actions = []
        for a in actions:
            kw = dict(action_id=a.action_id, channel=a.channel, id=a.read_id)
            if a.action == "unblock":
                pb_actions.append(
                    data_pb2.GetLiveReadsRequest.Action(
                        unblock=data_pb2.GetLiveReadsRequest.UnblockAction(
                            duration=a.duration
                        ),
                        **kw,
                    )
                )
            else:
                pb_actions.append(
                    data_pb2.GetLiveReadsRequest.Action(
                        stop_further_data=(
                            data_pb2.GetLiveReadsRequest.StopFurtherData()
                        ),
                        **kw,
                    )
                )
        self._request_queue.put(
            data_pb2.GetLiveReadsRequest(
                actions=data_pb2.GetLiveReadsRequest.Actions(
                    actions=pb_actions
                )
            )
        )

    def close(self):
        self._request_queue.put(None)
