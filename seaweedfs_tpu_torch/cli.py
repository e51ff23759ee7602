"""CLI entry: `python -m seaweedfs_tpu_torch <subcommand>`.

The port's copy of seaweedfs_tpu/cli.py for the subcommands whose modules
are ported: `master`, `volume`, `server` (master and volume in one
process), `shell` and `version`, with the reference's flags.  Every other
reference subcommand exits 2 with one line naming the ROADMAP item that
ports it.

Differences from the reference, on purpose:
  * `-ec.codec` resolves flag, then master.toml's `codec.type`, then
    `cuda` (the reference's last default is `cpu`): the volume server runs
    on the card unless asked otherwise.  The choices are the port's codec
    registry (cuda, cuda_xor, cuda_bitplane, cpu, torch_cpu, auto); the
    reference's TPU names (tpu, tpu_xor, tpu_mxu, pallas, tpu_pallas, jax,
    mxu) are refused, from the flag or the TOML, with a message naming
    `cuda`.  A volume server on a device codec on a host without a card
    exits non-zero naming the card;
  * a flag of a plane that is not ported (the master's `-peerClusters`,
    the server's `-filer` and `-s3`) given a value other than its default
    exits non-zero naming ROADMAP A-7;
  * security.toml's JWT key and white list are read as the reference
    reads them; gRPC TLS certificates configured there make the process
    exit non-zero naming ROADMAP A-6 (security/tls.py is not ported), so
    it never runs without the TLS the operator asked for;
  * SIGTERM and SIGINT stop the servers (every thread joined) and the
    process exits 0; the reference dies on SIGTERM's default action.
"""

from __future__ import annotations

import argparse
import signal
import sys
import threading

VERSION = "seaweedfs_tpu_torch 0.1.0"

# the port's codec registry (ops/codec.py), in the order the help lists it
CODEC_CHOICES = ("cuda", "cuda_xor", "cuda_bitplane", "cpu", "torch_cpu",
                 "auto")
# the reference's device codec names, which name TPU programs
TPU_CODEC_NAMES = ("tpu", "tpu_xor", "tpu_mxu", "pallas", "tpu_pallas",
                   "jax", "mxu")

# reference subcommands this package does not have yet -> the ROADMAP item
NOT_PORTED = {
    "filer": "A-7 (filer/)",
    "mount": "A-7 (mount/)",
    "msgBroker": "A-7 (messaging/)",
    "filer.replicate": "A-7 (replication/)",
    "filer.backup": "A-7 (replication/)",
    "filer.meta.tail": "A-7 (replication/)",
    "filer.meta.backup": "A-7 (replication/meta_backup.py)",
    "filer.sync": "A-7 (replication/)",
    "s3": "A-7 (s3api/)",
    "iam": "A-7 (iamapi/)",
    "gateway": "A-7 (gateway.py)",
    "webdav": "A-7 (webdav/)",
    "ftp": "A-7 (ftpd/)",
    "backup": "A-6 (tools/backup.py)",
    "upload": "A-6 (tools/backup.py)",
    "download": "A-6 (tools/backup.py)",
    "filer.cat": "A-7 (tools/backup.py, the filer)",
    "filer.copy": "A-7 (tools/backup.py, the filer)",
    "benchmark": "A-6 (tools/benchmark.py)",
    "fix": "A-6 (tools/offline.py, the CLI's half)",
    "compact": "A-6 (the CLI's offline compact)",
    "export": "A-6 (tools/offline.py export_volume)",
    "scaffold": "A-6 (util/scaffold.py)",
}


class CliError(Exception):
    """A refusal the CLI reports as one line on stderr, exit code 2."""


def _resolve_codec(flag: str) -> str:
    """-ec.codec: the flag, else master.toml's [codec].type, else cuda."""
    from .util.config import load_configuration

    source = "-ec.codec"
    codec = flag
    if not codec:
        conf = load_configuration("master")
        codec = conf.get_string("codec.type", "")
        source = f"codec.type in {conf.path}"
    if not codec:
        return "cuda"
    if codec in TPU_CODEC_NAMES:
        raise CliError(
            f"{source}={codec!r} names a TPU codec; this port's device codec "
            f"is 'cuda' (choices: {', '.join(CODEC_CHOICES)})")
    if codec not in CODEC_CHOICES:
        raise CliError(
            f"{source}={codec!r} is not a codec; choices: "
            f"{', '.join(CODEC_CHOICES)} (the device codec is 'cuda')")
    return codec


def _require_card(codec: str) -> None:
    """A volume server on a device codec needs a card; say so before the
    store opens (the server would raise too, when it builds its codec)."""
    from .ops.codec import DEVICE_CODEC_NAMES

    if codec not in DEVICE_CODEC_NAMES:
        return
    import torch

    if not torch.cuda.is_available():
        raise CliError(
            f"-ec.codec={codec} needs an NVIDIA CUDA card, and "
            "this host has none (torch.cuda.is_available() is False); "
            "pass -ec.codec=cpu to run the EC codec on the host")


def _refuse(flag: str, value, default, what: str) -> None:
    if value != default and value not in ("", None):
        raise CliError(f"{flag}={value!r}: {what} is not ported yet")


class _Stopper:
    """SIGTERM/SIGINT -> stop the servers and return from wait()."""

    def __init__(self):
        self.event = threading.Event()
        for sig in (signal.SIGTERM, signal.SIGINT):
            signal.signal(sig, lambda _s, _f: self.event.set())

    def wait(self, servers: list) -> None:
        while not self.event.wait(1.0):
            pass
        for s in servers:
            s.stop()


def cmd_master(args) -> None:
    from .master.server import MasterServer
    from .util.config import load_configuration

    # TOML tier: master.toml supplies the maintenance script + sequencer
    # defaults; explicit CLI flags win (util/config.go two-tier model)
    mconf = load_configuration("master")
    interval = args.maintenanceInterval
    if interval is None:  # flag not given -> TOML, else 0 (disabled)
        interval = mconf.get_float("master.maintenance.periodic_seconds")
    # scripts=[] in the TOML means "run nothing", which run_maintenance
    # distinguishes from None (= its default suite)
    raw_scripts = mconf.get("master.maintenance.scripts")
    script = raw_scripts if isinstance(raw_scripts, list) else None
    sequencer = mconf.get_string("master.sequencer.type", "memory")
    node_id = mconf.get_int("master.sequencer.sequencer_snowflake_id")
    lifecycle_policy = None
    if args.lifecyclePolicy:
        import json

        with open(args.lifecyclePolicy) as f:
            lifecycle_policy = json.load(f)
    slo_specs = None
    if args.sloSpecs:
        from .telemetry.slo import specs_from_json

        slo_specs = specs_from_json(args.sloSpecs)
    stopper = _Stopper()
    m = MasterServer(
        ip=args.ip,
        port=args.port,
        volume_size_limit_mb=args.volumeSizeLimitMB,
        default_replication=args.defaultReplication,
        maintenance_interval=interval,
        maintenance_script=script,
        lifecycle_interval=args.lifecycleInterval,
        lifecycle_dir=args.lifecycleDir,
        lifecycle_rate_mbps=args.lifecycleRateMBps,
        lifecycle_policy=lifecycle_policy,
        repair_deadline_s=args.repairDeadlineS,
        sequencer=sequencer,
        sequencer_node_id=node_id,
        sequencer_etcd_urls=mconf.get_string(
            "master.sequencer.sequencer_etcd_urls", "127.0.0.1:2379"),
        metrics_port=args.metricsPort,
        jwt_signing_key=args.jwtKey or _security_jwt_key(),
        peers=args.peers.split(",") if args.peers else None,
        raft_state_dir=args.raftDir,
        peer_clusters=(args.peerClusters.split(",")
                       if args.peerClusters else None),
        slo_interval=args.sloInterval,
        slo_specs=slo_specs,
        canary_interval=args.canaryInterval,
        canary_s3=args.canaryS3,
        alert_webhook=args.alertWebhook,
        debug_dir=args.debugDir,
    )
    m.start()
    print(f"master listening http={args.port} grpc={m.grpc_port}", flush=True)
    stopper.wait([m])


def _volume_server(args, codec: str, master_addresses: list[str]):
    from .volume.server import VolumeServer

    return VolumeServer(
        directories=args.dir.split(","),
        master_addresses=master_addresses,
        ip=args.ip,
        port=args.port,
        data_center=getattr(args, "dataCenter", ""),
        rack=getattr(args, "rack", ""),
        codec_name=codec,
        max_volume_count=getattr(args, "max", None),
        metrics_port=getattr(args, "metricsPort", 0),
        jwt_signing_key=getattr(args, "jwtKey", "") or _security_jwt_key(),
        whitelist=(args.whiteList.split(",")
                   if getattr(args, "whiteList", "")
                   else _security_white_list()),
        tier_backends=_load_tier_backends(getattr(args, "tierBackends", "")),
        tcp_port=getattr(args, "tcpPort", 0),
    )


def _load_tier_backends(path: str) -> "dict | None":
    """-tierBackends: a JSON file {"s3.<id>": {"endpoint", "bucket",
    "access_key", "secret_key", "region"}} (the [storage.backend] tier)."""
    if not path:
        return None
    import json

    with open(path) as f:
        return json.load(f)


def cmd_volume(args) -> None:
    if args.offset5:
        from .storage import types as _t

        _t.set_offset_size(5)
    if args.index != "memory":
        from .storage.volume import set_needle_map_kind

        set_needle_map_kind(args.index)
    codec = _resolve_codec(args.ec_codec)
    _require_card(codec)
    stopper = _Stopper()
    v = _volume_server(
        args, codec, [_grpc_addr(m) for m in args.mserver.split(",")])
    v.start()
    print(f"volume server http={args.port} grpc={v.grpc_port} "
          f"dirs={args.dir} codec={codec}", flush=True)
    stopper.wait([v])


def cmd_server(args) -> None:
    """`weed server`: master + volume in one process (command/server.go).
    The filer and S3 gateway it can add come with ROADMAP A-7."""
    from .master.server import MasterServer

    _refuse("-filer", args.filer, False, "the filer (filer/, ROADMAP A-7)")
    _refuse("-s3", args.s3, False, "the S3 gateway (s3api/, ROADMAP A-7)")
    codec = _resolve_codec(args.ec_codec)
    _require_card(codec)
    stopper = _Stopper()
    m = MasterServer(ip=args.ip, port=args.masterPort)
    m.start()
    try:
        v = _volume_server(args, codec, [f"{args.ip}:{m.grpc_port}"])
    except BaseException:
        m.stop()
        raise
    v.start()
    print(f"server: master={args.masterPort} volume={args.port} "
          f"codec={codec}", flush=True)
    stopper.wait([v, m])


def cmd_shell(args) -> None:
    from .shell.commands import CommandEnv, run_command
    from .util.config import load_configuration

    master, filer = args.master, getattr(args, "filer", "")
    sconf = load_configuration("shell")
    if sconf.loaded:  # shell.toml fills only OMITTED flags (default=None)
        if master is None:
            master = sconf.get_string("cluster.default.master", "")
        if not filer:
            filer = sconf.get_string("cluster.default.filer", "")
    master = master or "127.0.0.1:9333"
    env = CommandEnv(_grpc_addr(master))
    if filer:
        env.option["filer"] = filer
    if args.command:
        print(run_command(env, args.command))
        return
    while True:
        try:
            line = input("> ")
        except EOFError:
            break
        if line.strip() in ("exit", "quit"):
            break
        try:
            print(run_command(env, line))
        except Exception as e:
            print(f"error: {e}")


def _grpc_addr(master: str) -> str:
    """Convert a server's HTTP address to its gRPC address (+10000)."""
    host, port = master.rsplit(":", 1)
    return f"{host}:{int(port) + 10000}"


def _security_jwt_key() -> str:
    """security.toml [jwt.signing].key — the flagless way to arm write
    JWTs cluster-wide (scaffold.go's security template)."""
    from .util.config import load_configuration

    return load_configuration("security").get_string("jwt.signing.key")


def _security_white_list() -> list[str] | None:
    from .util.config import load_configuration

    wl = load_configuration("security").get_list("guard.white_list")
    return [str(ip) for ip in wl] or None


def _refuse_tls(conf) -> None:
    """security.toml's gRPC TLS: certificates at `grpc.ca`,
    `grpc.<component>.cert/.key` or `<component>.cert/.key` (reference
    security/tls.py).  The port has no TLS half yet, so a configured
    certificate stops the process instead of serving in the clear."""
    if not conf.loaded:
        return
    keys = []
    for name, section in conf.data.items():
        if not isinstance(section, dict):
            continue
        if name == "grpc":
            if section.get("ca"):
                keys.append("grpc.ca")
            keys += [f"grpc.{c}.{k}" for c, sub in section.items()
                     if isinstance(sub, dict)
                     for k in ("cert", "key") if sub.get(k)]
        else:
            keys += [f"{name}.{k}" for k in ("cert", "key")
                     if isinstance(section.get(k), str) and section.get(k)]
    if keys:
        raise CliError(
            f"{conf.path} configures gRPC TLS ({', '.join(keys)}); "
            "security/tls.py is not ported yet (ROADMAP A-6), and this "
            "process will not serve without the TLS asked for")


def _setup_profiling(args) -> None:
    if getattr(args, "cpuprofile", "") or getattr(args, "memprofile", ""):
        from .util.grace import setup_profiling

        setup_profiling(args.cpuprofile, args.memprofile)


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="seaweedfs_tpu_torch")
    p.add_argument("-cpuprofile", default="",
                   help="write a cProfile dump here at exit")
    p.add_argument("-memprofile", default="",
                   help="write a tracemalloc top-allocations report here "
                        "at exit")
    sub = p.add_subparsers(dest="cmd", required=True)

    m = sub.add_parser("master")
    m.add_argument("-ip", default="127.0.0.1")
    m.add_argument("-port", type=int, default=9333)
    m.add_argument("-volumeSizeLimitMB", type=int, default=30 * 1024)
    m.add_argument("-defaultReplication", default="000")
    m.add_argument("-maintenanceInterval", type=float, default=None,
                   help="seconds between maintenance runs; 0 disables "
                        "(default: master.toml periodic_seconds)")
    m.add_argument("-metricsPort", type=int, default=0)
    m.add_argument("-jwtKey", default="")
    m.add_argument("-peers", default="",
                   help="comma-separated master quorum ip:port list (raft)")
    m.add_argument("-raftDir", default=".",
                   help="directory for persisted raft state")
    m.add_argument("-lifecycleInterval", type=float, default=0.0,
                   help="lifecycle controller cycle seconds; 0 = manual "
                        "only (volume.lifecycle -apply)")
    m.add_argument("-lifecycleDir", default="",
                   help="crash-safe lifecycle journal directory; empty "
                        "keeps jobs in memory only")
    m.add_argument("-lifecycleRateMBps", type=float, default=None,
                   help="cluster background-I/O budget shared by "
                        "lifecycle jobs and scrub (None = env "
                        "SEAWEEDFS_TPU_LIFECYCLE_RATE_MBPS, 0 = "
                        "unthrottled)")
    m.add_argument("-lifecyclePolicy", default="",
                   help="JSON policy file: {collection: {field: value}}")
    m.add_argument("-repairDeadlineS", type=float, default=None,
                   help="total-repair-time bound for dead-node mass "
                        "repair; when a -lifecycleRateMBps budget is "
                        "set, the pushed background rate is raised to "
                        "what the bound requires.  None = env "
                        "SEAWEEDFS_TPU_MASS_REPAIR_DEADLINE_S, 0 = "
                        "no bound")
    # the geo registry comes with a later slice (ROADMAP A-7): a value
    # other than the default is refused, never ignored
    m.add_argument("-peerClusters", default="",
                   help="comma-separated REMOTE-cluster master http "
                        "addresses for the /cluster/geo registry "
                        "(ROADMAP A-7: refused)")
    m.add_argument("-sloInterval", type=float, default=15.0,
                   help="SLO engine evaluation tick seconds (burn-rate "
                        "rules over family-filtered federation scrapes); "
                        "0 = evaluate only when /cluster/alerts is read")
    m.add_argument("-sloSpecs", default="",
                   help="JSON file with a list of SLO spec objects "
                        "(replaces the default suite)")
    m.add_argument("-canaryInterval", type=float, default=0.0,
                   help="synthetic canary probe tick seconds (black-box "
                        "write/read/delete, EC degraded read, routed "
                        "metadata, geo sentinel); 0 disables")
    m.add_argument("-canaryS3", default="",
                   help="S3 gateway http address the metadata_rt canary "
                        "routes through (empty = probe a registered "
                        "filer directly)")
    m.add_argument("-alertWebhook", default="",
                   help="POST every alert state transition to this URL "
                        "as JSON (the log sink always runs)")
    m.add_argument("-debugDir", default="",
                   help="flight-recorder bundle directory: alerts "
                        "transitioning to firing (and cluster.debug "
                        "-capture) snapshot cluster debug bundles here "
                        "with bounded retention (empty = in-memory ring)")
    m.set_defaults(fn=cmd_master)

    v = sub.add_parser("volume")
    v.add_argument("-dir", default="./data")
    v.add_argument("-mserver", default="127.0.0.1:9333")
    v.add_argument("-ip", default="127.0.0.1")
    v.add_argument("-port", type=int, default=8080)
    v.add_argument("-dataCenter", default="")
    v.add_argument("-rack", default="")
    v.add_argument("-max", type=int, default=7)
    v.add_argument("-port.tcp", dest="tcpPort", type=int, default=0,
                   help="experimental raw-TCP needle data path (0=off)")
    v.add_argument("-index", default="memory",
                   choices=("memory", "disk"),
                   help="needle map kind: in-RAM compact map, or "
                        "disk-backed sorted file for RAM-constrained "
                        "servers")
    v.add_argument("-offset.5bytes", dest="offset5", action="store_true",
                   help="5-byte needle offsets (8TB volumes; 17-byte "
                        ".idx/.ecx entries): process-wide, and every volume "
                        "process of the cluster needs it, since ec.encode "
                        "copies .ecx files between nodes")
    v.add_argument("-ec.codec", dest="ec_codec", default="",
                   help="EC codec: cuda (the card; the default), cpu, "
                        "torch_cpu or auto (default: master.toml "
                        "[codec].type, then cuda)")
    v.add_argument("-metricsPort", type=int, default=0)
    v.add_argument("-jwtKey", default="")
    v.add_argument("-whiteList", default="")
    v.add_argument("-tierBackends", default="",
                   help="JSON file of remote tier backends "
                        "({\"s3.<id>\": {endpoint, bucket, access_key, "
                        "secret_key, region}})")
    v.set_defaults(fn=cmd_volume)

    s = sub.add_parser("server")
    s.add_argument("-dir", default="./data")
    s.add_argument("-ip", default="127.0.0.1")
    s.add_argument("-masterPort", type=int, default=9333)
    s.add_argument("-port", type=int, default=8080)
    s.add_argument("-ec.codec", dest="ec_codec", default="")
    s.add_argument("-filer", action="store_true",
                   help="also start a filer (not ported: ROADMAP A-7)")
    s.add_argument("-filer.port", dest="filerPort", type=int, default=8888)
    s.add_argument("-filer.store", dest="filerStore", default="./filer.db")
    s.add_argument("-s3", action="store_true",
                   help="also start an S3 gateway (not ported: ROADMAP A-7)")
    s.add_argument("-s3.port", dest="s3Port", type=int, default=8333)
    s.set_defaults(fn=cmd_server)

    sh = sub.add_parser("shell")
    sh.add_argument("-master", default=None,
                    help="master ip:port (omitted -> shell.toml, then "
                         "127.0.0.1:9333)")
    sh.add_argument("-filer", default="",
                    help="filer http address for fs.*/s3.* commands")
    sh.add_argument("-c", dest="command", default="")
    sh.set_defaults(fn=cmd_shell)

    ver = sub.add_parser("version")
    ver.set_defaults(fn=lambda a: print(VERSION))

    return p


def main(argv=None) -> int:
    from .util.config import load_configuration

    argv = sys.argv[1:] if argv is None else list(argv)
    # the subcommand is the first word that is neither a global flag nor
    # its value
    words = [a for i, a in enumerate(argv) if not a.startswith("-")
             and not (i and argv[i - 1] in ("-cpuprofile", "-memprofile"))]
    if words and words[0] in NOT_PORTED:
        print(f"seaweedfs_tpu_torch: subcommand {words[0]!r} is not ported "
              f"yet (ROADMAP {NOT_PORTED[words[0]]})", file=sys.stderr)
        return 2
    args = _parser().parse_args(argv)
    try:
        _setup_profiling(args)
        _refuse_tls(load_configuration("security"))
        args.fn(args)
    except (CliError, ValueError, RuntimeError, OSError) as e:
        print(f"seaweedfs_tpu_torch {args.cmd}: error: {e}", file=sys.stderr)
        return 2 if isinstance(e, CliError) else 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
