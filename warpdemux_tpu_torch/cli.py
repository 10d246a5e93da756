"""Command-line interface of the PyTorch port: demux / prep / predict /
continue.

    python -m warpdemux_tpu_torch.cli demux -i <pod5s> -o <dir> -m WDX4_rna004_v1_0

The command surface of warpdemux_tpu/cli.py (the same flags, run-directory
layout, command.json manifest and `--export` overrides), on the port's run
loop. A run goes on the CUDA GPU unless `--device` names another; with no
GPU and no `--device` the command exits 2 before anything runs.

Runs over several cards or hosts are several processes, one a card, each
over a disjoint share of the pod5 files, its output shards tagged with its
rank, the run's counters summed over the processes (parallel/multihost.py):
`-j N` starts N worker processes on this host (`--device cpu -j N`: N on
the CPU), and `--coordinator` joins this host's processes to those of the
other hosts. A predictions-only demux on the vbz wire takes the two-stage
wire, as the JAX CLI does: each read's first `--stage1_preload` samples
(7168) cross first, and the tails only of minibatches whose decisions
need them (pipeline/run.use_twostage); `--stage1_preload 0` ships the
whole preload at once. Both write the same decisions.
"""

from __future__ import annotations

import argparse
import contextlib
import datetime
import logging
import os
import sys
import time
from dataclasses import replace
from pathlib import Path


def _str2bool(v) -> bool:
    """The reference parser's boolean argument convention."""
    if isinstance(v, bool):
        return v
    if v.lower() in ("yes", "true", "t", "y", "1"):
        return True
    if v.lower() in ("no", "false", "f", "n", "0"):
        return False
    raise argparse.ArgumentTypeError("Boolean value expected.")


def _collect_inputs(paths: list[str], suffix: str) -> list[str]:
    out = []
    for p in paths:
        path = Path(p)
        if path.is_dir():
            out.extend(str(f) for f in sorted(path.rglob(f"*{suffix}")))
        elif path.suffix and str(path).endswith(suffix):
            out.append(str(path))
    return out


def _read_id_file(path: str | None) -> set[str]:
    if not path:
        return set()
    return {line.strip() for line in Path(path).read_text().splitlines() if line.strip()}


def _add_device(p):
    p.add_argument("--device", choices=("cuda", "cpu"), default=None,
                   help="torch device of the run (default: the CUDA GPU)")


def _add_common(p):
    p.add_argument("-i", "--input", nargs="+", required=True,
                   help="pod5 file(s) or dir(s)")
    p.add_argument("-o", "--output", required=True, help="output dir root")
    p.add_argument("-m", "--model_name", required=True)
    p.add_argument("-b", "--minibatch_size", type=int, default=1000)
    p.add_argument("--batch_size_output", type=int, default=40000)
    p.add_argument("--read_id_csv", default=None,
                   help="file with read ids to include (one per line)")
    p.add_argument("--export", nargs="*", default=[],
                   help="config overrides, e.g. core.max_obs_trace=8000")
    # both bare (--save_boundaries) and valued (--save_boundaries true)
    p.add_argument("--save_dwell_time", type=_str2bool, nargs="?",
                   const=True, default=False)
    p.add_argument("--save_boundaries", type=_str2bool, nargs="?",
                   const=True, default=False)
    p.add_argument("--save_fpts", type=_str2bool, nargs="?",
                   const=True, default=False)
    p.add_argument("--create_subdir", action="store_true", default=True)
    p.add_argument("--no-create_subdir", dest="create_subdir", action="store_false")
    p.add_argument("--wire", choices=("vbz", "adc"), default="vbz",
                   help="host->device wire: the VBZ inner layout (decoded on "
                        "the device) or raw int16 ADC counts")
    p.add_argument("--stage1_preload", type=int, default=7168,
                   help="two-stage wire of predictions-only vbz runs: "
                        "samples a read shipped first, its tail only where "
                        "the decision needs it (0 = the whole preload at once)")
    p.add_argument("-j", "--devices", type=int, default=1,
                   help="devices to run on, one worker process a device, "
                        "each over its share of the pod5 files (0 = all "
                        "local devices; the reference's -j "
                        "reads-parallelism mapped onto the cards)")
    _add_device(p)
    p.add_argument("--profile-dir", default=None,
                   help="write a torch.profiler trace of the run there")
    # multi-host data parallelism (SURVEY 2.2: the reference scales by
    # reads-parallelism over cores, file_proc.py:1197-1245; several hosts
    # scale by disjoint pod5 file shards a process, rank-tagged output
    # shards and summed counters)
    p.add_argument("--coordinator", default=None,
                   help="torch.distributed rendezvous address (host:port) "
                        "of host 0; omit on single-host runs. 'env' reads "
                        "torchrun's environment (one process a card, -j 1)")
    p.add_argument("--num-processes", type=int, default=None,
                   help="host count for --coordinator runs (every host "
                        "runs the same -j)")
    p.add_argument("--process-id", type=int, default=None,
                   help="this host's index for --coordinator runs")


def build_parser():
    ap = argparse.ArgumentParser(
        prog="warpdemux-tpu-torch",
        description="Raw-signal barcode demultiplexing on CUDA GPUs",
    )
    sub = ap.add_subparsers(dest="command", required=True)

    d = sub.add_parser("demux", help="detect + fingerprint + classify")
    _add_common(d)

    pr = sub.add_parser("prep", help="detect + fingerprint only")
    _add_common(pr)

    # `predict PREDICT_FROM_DIR` / `continue CONTINUE_FROM_DIR` (positional
    # run dir; -i kept as an alias)
    pd_ = sub.add_parser("predict", help="classify fingerprints from a prep run")
    pd_.add_argument("input_dir", nargs="?", default=None,
                     help="previous prep run dir (with command.json)")
    pd_.add_argument("-i", "--input", default=None)
    pd_.add_argument("-m", "--model_name", default=None)
    pd_.add_argument("--batch_size_output", type=int, default=40000)
    _add_device(pd_)

    c = sub.add_parser("continue", help="resume a previous run")
    c.add_argument("input_dir", nargs="?", default=None, help="previous run dir")
    c.add_argument("-i", "--input", default=None)
    c.add_argument("-m", "--model_name", default=None)
    c.add_argument("-b", "--minibatch_size", type=int, default=None)
    _add_device(c)
    return ap


def _make_run_dir(root: str, command: str, create_subdir: bool) -> str:
    if not create_subdir:
        os.makedirs(root, exist_ok=True)
        return root
    stamp = datetime.datetime.now().strftime("%Y%m%d_%H%M")
    run_dir = os.path.join(root, f"warpdemux_tpu_{command}_{stamp}")
    os.makedirs(run_dir, exist_ok=True)
    return run_dir


def _setup_logging(run_dir: str):
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(levelname)s %(message)s",
        handlers=[
            logging.StreamHandler(sys.stdout),
            logging.FileHandler(os.path.join(run_dir, "warpdemux.log")),
        ],
        force=True,
    )


def _profile(profile_dir: str | None, device):
    """A torch.profiler context writing a Chrome trace into profile_dir."""
    if not profile_dir:
        return contextlib.nullcontext()
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    logging.info("profiling to %s", profile_dir)
    return profile(activities=activities, on_trace_ready=tensorboard_trace_handler(profile_dir))


def _run_batch_command(args, command: str, device, read_ids_excl=None, run_dir=None, bidx=None):
    from warpdemux_tpu_torch.config.config import (
        BatchConfig, ClassifConfig, Config, InputConfig, OutputConfig, TaskConfig,
    )
    from warpdemux_tpu_torch.config.utils import (
        dump_toml, get_model_spc_config, parse_export_overrides,
        resolve_model_chemistry_dict,
    )
    from warpdemux_tpu_torch.parallel.multihost import host_shard_tag, init_distributed, shard_files
    from warpdemux_tpu_torch.pipeline.run import run_demux

    files = _collect_inputs(args.input, ".pod5")
    if not files:
        raise SystemExit(f"no pod5 inputs found under {args.input}")

    # several processes: each takes a disjoint file shard and tags its
    # output shards (the reference's per-process bidx shards,
    # file_proc.py:1197-1245)
    pi, pc = init_distributed()
    shard_tag, all_files = "", files
    if pc > 1:
        files = shard_files(files, pi, pc)
        shard_tag = host_shard_tag(pi) + "_"

    run_dir = run_dir or _make_run_dir(args.output, command, args.create_subdir)
    _setup_logging(run_dir)
    logging.info(
        "run dir: %s (%d pod5 files%s, device %s)", run_dir, len(files),
        f", process {pi}/{pc}" if pc > 1 else "", device,
    )

    overrides = parse_export_overrides(args.export)
    spc = get_model_spc_config(args.model_name, overrides)

    do_predict = command == "demux"
    bidx = bidx or (0, 0, 0)
    config = Config(
        input=InputConfig(
            files=files,
            read_ids_incl=_read_id_file(args.read_id_csv),
            read_ids_excl=read_ids_excl or set(),
        ),
        output=OutputConfig(
            output_dir=run_dir,
            save_fpts=args.save_fpts or command == "prep",
            save_dwell_time=args.save_dwell_time,
            save_boundaries=args.save_boundaries or command == "prep",
            save_predictions=do_predict,
            shard_tag=shard_tag,
        ),
        batch=BatchConfig(
            minibatch_size=args.minibatch_size,
            batch_size_output=args.batch_size_output,
            bidx_pass=bidx[0],
            bidx_fail=bidx[1],
            bidx_predict=bidx[2],
            devices=args.devices,
            wire=args.wire,
            stage1_preload=args.stage1_preload,
        ),
        task=TaskConfig(command=command, preprocess=True, predict=do_predict),
        classif=ClassifConfig(model_name=args.model_name),
        sig_proc=spc,
    )
    if pi == 0:  # one manifest a run, with every input file (`continue` reads them)
        replace(config, input=replace(config.input, files=all_files)).write_command_json(sys.argv[1:])
        # snapshot the resolved chemistry config into the run dir
        (Path(run_dir) / "config.toml").write_text(
            dump_toml(resolve_model_chemistry_dict(args.model_name, overrides))
        )
    with _profile(args.profile_dir, device):
        stats = run_demux(config, device=device)
    _print_done(stats.total, stats.passed, stats.failed, stats.predicted, stats.elapsed_s)
    return stats


def _print_done(total, passed, failed, predicted, seconds, what=""):
    print(
        f"done{what}: {total} reads, {passed} pass, {failed} fail,"
        f" {predicted} predicted, {seconds:.1f}s"
        f" ({total / max(seconds, 1e-9):.0f} reads/s)"
    )


def _batch_worker(device, args, command, kw):
    """One worker process of `_run_batch` (in a process group already);
    its counters."""
    stats = _run_batch_command(args, command, device, **kw)
    return stats.total, stats.passed, stats.failed, stats.predicted


def _run_batch(args, command: str, device, **kw) -> int:
    """A demux / prep run: in this process on `device`, or with -j N in N
    worker processes, one a local device of device's kind
    (parallel/multihost.run_workers). With --coordinator the processes
    join those of the other hosts."""
    import torch.distributed as dist

    from warpdemux_tpu_torch.parallel.mesh import make_mesh
    from warpdemux_tpu_torch.parallel.multihost import init_distributed, run_workers

    devices = make_mesh(args.devices, device.type)
    coordinator = args.coordinator
    if len(devices) == 1:
        if coordinator is None:
            _run_batch_command(args, command, device, **kw)
            return 0
        init_distributed(coordinator, args.num_processes, args.process_id)
        try:
            _run_batch_command(args, command, device, **kw)
        finally:
            dist.destroy_process_group()
        return 0
    if coordinator == "env":
        raise SystemExit("--coordinator env: torchrun starts one process a card; run it with -j 1")
    if device.type == "cuda":  # built once here, not by every worker at once
        from warpdemux_tpu_torch import _cuda

        _cuda.build(_cuda.defines)
    kw["run_dir"] = kw.get("run_dir") or _make_run_dir(args.output, command, args.create_subdir)
    hosts = (args.num_processes, args.process_id) if coordinator else (1, 0)
    t0 = time.time()
    done = run_workers(_batch_worker, (args, command, kw), devices, coordinator, *hosts)
    _print_done(*(sum(col) for col in zip(*done)), time.time() - t0, f" ({len(devices)} processes)")
    return 0


def _cmd_predict(args, device):
    from warpdemux_tpu_torch.config.config import (
        BatchConfig, ClassifConfig, Config, InputConfig, OutputConfig, TaskConfig,
    )
    from warpdemux_tpu_torch.config.utils import get_model_spc_config
    from warpdemux_tpu_torch.pipeline.resume import scan_processed_reads
    from warpdemux_tpu_torch.pipeline.run import run_predict_from_fpts

    manifest = Config.read_command_json(args.input)
    if manifest["command"] not in ("prep",):
        raise SystemExit(
            f"predict requires a prep run dir; {args.input} was a "
            f"{manifest['command']} run"
        )
    model_name = args.model_name or manifest["model_name"]
    fpt_files = sorted(str(p) for p in (Path(args.input) / "fingerprints").glob("*.npz"))
    if not fpt_files:
        raise SystemExit(f"no fingerprints found in {args.input}/fingerprints")
    _setup_logging(args.input)
    spc = get_model_spc_config(model_name)
    # failed_reads shards of the prep run already occupy bidx 0..N; the
    # predict pass (non-finite fingerprints) continues the numbering
    _, _, bidx_fail, _ = scan_processed_reads(args.input, "fingerprints")
    config = Config(
        input=InputConfig(files=fpt_files),
        output=OutputConfig(output_dir=args.input, save_predictions=True),
        batch=BatchConfig(batch_size_output=args.batch_size_output, bidx_fail=bidx_fail),
        task=TaskConfig(command="predict", preprocess=False, predict=True),
        classif=ClassifConfig(model_name=model_name),
        sig_proc=spc,
    )
    stats = run_predict_from_fpts(config, device=device)
    print(
        f"done: {stats.predicted} predicted of {stats.total} fingerprints "
        f"in {stats.elapsed_s:.1f}s"
    )
    return 0


def _cmd_continue(args, device):
    from warpdemux_tpu_torch.config.config import Config
    from warpdemux_tpu_torch.pipeline.resume import scan_processed_reads

    manifest = Config.read_command_json(args.input)
    processed, bp, bf, bpr = scan_processed_reads(
        args.input,
        "predictions" if manifest["command"] == "demux" else "fingerprints",
    )
    logging.info("continue: %d reads already processed", len(processed))

    ns = argparse.Namespace(
        input=manifest["input_files"],
        output=args.input,
        model_name=args.model_name or manifest["model_name"],
        minibatch_size=args.minibatch_size or manifest["batch"]["minibatch_size"],
        batch_size_output=manifest["batch"]["batch_size_output"],
        read_id_csv=None,
        export=[],
        save_dwell_time=manifest["output"]["save_dwell_time"],
        save_boundaries=manifest["output"]["save_boundaries"],
        save_fpts=manifest["output"]["save_fpts"],
        create_subdir=False,
        devices=manifest["batch"].get("devices", 1),
        wire=manifest["batch"].get("wire", "vbz"),
        stage1_preload=manifest["batch"].get("stage1_preload", 7168),
        profile_dir=None,
        coordinator=None,
        num_processes=None,
        process_id=None,
    )
    return _run_batch(
        ns, manifest["command"], device,
        read_ids_excl=processed, run_dir=args.input, bidx=(bp, bf, bpr),
    )


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.command in ("predict", "continue"):
        args.input = args.input or args.input_dir
        if not args.input:
            raise SystemExit(f"{args.command} requires a run directory")
    coordinator = getattr(args, "coordinator", None)
    if coordinator not in (None, "env") and (args.num_processes is None or args.process_id is None):
        raise SystemExit("--coordinator host:port needs --num-processes and --process-id")

    from warpdemux_tpu_torch._cuda import resolve_device

    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        print(e, file=sys.stderr)
        return 2
    if args.command in ("demux", "prep"):
        if coordinator == "env" and device.type == "cuda":  # torchrun's process of this card
            device = resolve_device(f"cuda:{int(os.environ.get('LOCAL_RANK', 0))}")
        return _run_batch(args, args.command, device)
    if args.command == "predict":
        return _cmd_predict(args, device)
    return _cmd_continue(args, device)


if __name__ == "__main__":
    sys.exit(main())
