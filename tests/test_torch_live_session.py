"""Port parity: a scripted live session, decision for decision.

A client that delivers a fixed script of chunks (growing prefixes of 1500
samples a read, as the replay client delivers them, until the session
stops or unblocks the read) drives the JAX `Session` and the port's on the
CPU. Each chunk goes through `_handle_chunk`; the queue is then drained
through `_classify_batch` in fixed micro-batches, with no classifier
threads, so nothing depends on timing. The script covers the missed-start,
negative-offset trim, too-long, no-poly(A)-yet and real-range gates and
classified, noise, unclassified and failed reads; the skip stats, the
client's actions (stop / unblock with durations, in order) and the report
rows (all but their times) must be equal.
"""

import csv

import numpy as np
import pytest
import torch

from warpdemux_tpu.live.balancer import BalancerConfig as JaxBalancerConfig
from warpdemux_tpu.live.balancer import BarcodeBalancers as JaxBarcodeBalancers
from warpdemux_tpu.live.session import Session as JaxSession
from warpdemux_tpu.live.session import SessionConfig as JaxSessionConfig
from warpdemux_tpu.models.registry import load_model as jax_load_model
from warpdemux_tpu_torch.live.balancer import BalancerConfig, BarcodeBalancers
from warpdemux_tpu_torch.live.caches import LiveRead
from warpdemux_tpu_torch.live.dummy import synth_barcoded_read, synth_live_read
from warpdemux_tpu_torch.live.session import Session, SessionConfig
from warpdemux_tpu_torch.models.registry import load_model
from test_torch_xla_rsqrt import table_host  # noqa: F401 (a fixture)

MODEL = "WDX4_rna004_v1_0"
CHUNK = 1500
MICRO_BATCH = 4


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One CPU thread for torch here: the test workers share the machine's
    cores, and this file's many small operations gain nothing from more."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def models():
    return jax_load_model(MODEL), load_model(MODEL, "cpu")


def script(X_sv):
    """[(channel, read number, read id, signal, chunk_start, start_sample)]."""
    rng = np.random.default_rng(21)
    barcoded = [synth_barcoded_read(rng, X_sv[i]) for i in (0, 300, 600, 850, 0, 850, 300)]
    live = [synth_live_read(rng) for _ in range(6)]
    flat = np.r_[np.full(4000, 78.0), np.full(1500, 105.0), rng.normal(96, 13, 8000)].astype(np.float32)
    no_polya = synth_live_read(rng, adapter_len=14000)  # reaches max_chunk_size first
    trimmed = np.r_[rng.normal(200, 5, 300).astype(np.float32), synth_barcoded_read(rng, X_sv[600])]
    reads = [(s, 0, 0) for s in barcoded + live + [flat, no_polya]]
    reads.append((trimmed, 1000, 1300))  # the read starts 300 samples into its first chunk
    reads.append((barcoded[1], 5000, 1000))  # 4000 samples missed: over max_missed_start_offset
    reads.append((barcoded[2], 5000, 4700))  # 300 missed: under it
    return [
        (ch, 100 + ch, f"read{ch}", sig, chunk_start, start_sample)
        for ch, (sig, chunk_start, start_sample) in enumerate(reads, start=1)
    ]


class ScriptedClient:
    """Records every action; a read stops getting chunks once acted on."""

    def __init__(self):
        self.actions = []
        self.done = set()

    def stop_receiving_read(self, channel, read_number):
        self.actions.append(("stop", channel, read_number))
        self.done.add(read_number)

    def unblock_read(self, channel, read_number, duration=0.1):
        self.actions.append(("unblock", channel, read_number, duration))
        self.done.add(read_number)


def drive(session, client, reads):
    """Deliver the script round by round, then drain the queue."""
    longest = max(r[3].size for r in reads)
    for end in range(CHUNK, longest + CHUNK, CHUNK):
        for channel, number, read_id, sig, chunk_start, start_sample in reads:
            if number in client.done or end - CHUNK >= sig.size:
                continue
            session._handle_chunk(channel, LiveRead(
                channel=channel, read_id=read_id, read_number=number, signal=sig[:end],
                chunk_start=chunk_start, start_sample=start_sample,
            ))
    while not session.fpt_queue.empty():
        batch = []
        while len(batch) < MICRO_BATCH and not session.fpt_queue.empty():
            batch.append(session.fpt_queue.get())
        session._classify_batch(batch)
    session.reporter.close()
    with open(session.reporter.csv_path, newline="") as fh:
        rows = [{k: v for k, v in row.items() if k != "time"} for row in csv.DictReader(fh)]
    return dict(session.skip_stats), client.actions, rows


@pytest.mark.parametrize("check_real_range", [True, False])
@pytest.mark.parametrize("balance_type", ["reject_all", "adapter_count", "none"])
def test_scripted_session_decides_as_the_jax_session(table_host, models, tmp_path, balance_type, check_real_range):
    jax_model, model = models
    reads = script(model.X_sv.numpy())
    kw = dict(model_name=MODEL, save_path=str(tmp_path), max_batch=MICRO_BATCH,
              check_real_range=check_real_range, pred_conf_threshold=0.2)
    # no missing-barcode watchdog: its clock would make the two sessions'
    # decisions depend on how long the first one took
    bal = dict(balance_type=balance_type, balance_threshold=0.1, min_stat=0.2, watch_for_missing=False)
    jax_session = JaxSession(
        ScriptedClient(), JaxSessionConfig(run_id="jax", **kw),
        JaxBarcodeBalancers.from_configs(4, [JaxBalancerConfig(**bal)], [1.0], n_channels=126), model=jax_model,
    )
    session = Session(
        ScriptedClient(), SessionConfig(run_id="port", **kw),
        BarcodeBalancers.from_configs(4, [BalancerConfig(**bal)], [1.0], n_channels=126), model=model, device="cpu",
    )
    want = drive(jax_session, jax_session.client, reads)
    got = drive(session, session.client, reads)
    assert got[0] == want[0]
    assert got[1] == want[1]
    assert got[2] == want[2]
    # the script reaches every gate and every outcome
    stats, actions, rows = got
    assert stats["missed_reads"] == 1 and stats["too_long_reads"] == 1 and stats["no_polya_yet"] > 0
    assert stats["missed_obs_n"] > 0 and min(r[4] - r[5] for r in reads) == -300
    assert stats["not_real_read"] == (1 if check_real_range else 0)
    outcomes = {row["outcome"] for row in rows}
    assert {"classified", "noise", "unclassified"} <= outcomes
    assert ("failed" in outcomes) and (sum(row["outcome"] == "failed" for row in rows) == 1 + (not check_real_range))
    if balance_type == "reject_all":
        assert all(row["decision"] == "reject" for row in rows if row["outcome"] == "classified")
    if balance_type == "adapter_count":
        assert {row["decision"] for row in rows if row["outcome"] == "classified"} == {"accept", "reject"}
    if balance_type == "none":
        assert not any(a[0] == "unblock" for a in actions)
