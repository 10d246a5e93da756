"""Live balancing entry point.

Usage (the port of warpdemux_tpu/live/entry_point.py):

  python -m warpdemux_tpu_torch.live.entry_point --config_file live.toml [--dummy] [--device cpu]

The session runs on the CUDA GPU unless `--device` names another; without
a GPU and without `--device` it stops with an error before anything runs.
With --dummy the session runs against the synthetic replay client. A real
MinKNOW connection requires the `minknow_api` package (gRPC), loaded lazily.
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--config_file", required=True)
    ap.add_argument("--dummy", action="store_true",
                    help="replay synthetic reads instead of MinKNOW")
    ap.add_argument("--n_reads", type=int, default=200)
    ap.add_argument("--device", default=None,
                    help="torch device of the lane (default: the CUDA GPU)")
    args = ap.parse_args(argv)

    from warpdemux_tpu_torch._cuda import resolve_device
    from warpdemux_tpu_torch.live.config_parser import build_session

    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        print(e, file=sys.stderr)
        return 2

    client = None
    if args.dummy:
        from warpdemux_tpu_torch.live.dummy import DummyClient

        client = DummyClient(n_reads=args.n_reads)
    else:
        # real MinKNOW: gRPC transport + accumulating client with the
        # reference's construction parameters (entry_point.py:26-37:
        # one_chunk=False, AccumulatingCache(5120), calibrated signal,
        # prefilter_classes={'adapter'})
        from warpdemux_tpu_torch.live.caches import AccumulatingCache
        from warpdemux_tpu_torch.live.read_until import (
            ReadUntilClient,
            minknow_transport,
        )

        try:
            transport = minknow_transport()
        except RuntimeError as e:
            print(f"{e}; run with --dummy for the replay harness",
                  file=sys.stderr)
            return 2
        client = ReadUntilClient(
            transport,
            cache=AccumulatingCache(size=5120),
            one_chunk=False,
            filter_strands=True,
            prefilter_classes={"adapter"},
            calibrated_signal=True,
        )
        client.run()

    session = build_session(args.config_file, client=client, device=device)
    session.run()
    print("skip stats:", session.skip_stats)
    print("counters:", session.reporter.counters.summary())
    print("latency:", {
        k: f"{m*1000:.1f}+/-{s*1000:.1f}ms"
        for k, (m, s) in session.reporter.latency_stats().items()
    })
    return 0


if __name__ == "__main__":
    sys.exit(main())
