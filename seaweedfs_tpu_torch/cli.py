"""CLI entry: `python -m seaweedfs_tpu_torch <subcommand>`.

The port's copy of seaweedfs_tpu/cli.py for the subcommands whose modules
are ported: `master`, `volume`, `server` (master, volume and optionally a
filer in one process), `filer`, `shell`, `scaffold`, the client tools
(`benchmark`, `backup`, `upload`, `download`, `filer.cat`, `filer.copy`),
the offline volume tools (`fix`, `compact`, `export`) and `version`, with
the reference's flags.  Every other reference subcommand exits 2 with one
line naming the ROADMAP item that ports it.

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
    the server's `-s3`, the filer's `-peers`, `-clusterId`, `-geoPeers`
    and `-geoRateMBps`) given a value other than its default, a filer.toml
    that enables a store kind with an external server, and a
    notification.toml that enables a publisher exit non-zero naming
    ROADMAP A-7;
  * security.toml is read as the reference reads it: the JWT key, the
    white list, and the gRPC mTLS certificates every process installs
    before it serves or dials (the listener presents its component's
    certificate, `client` for the shell and the client tools).  A
    certificate set that is named but incomplete or does not load stops
    the process with the error; it never serves in the clear;
  * `benchmark` takes `-collection` and `-replication` (the reference's
    run_benchmark has both; its CLI passes neither);
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
    "s3": "A-7a (s3api/)",
    "iam": "A-7a (iamapi/)",
    "mount": "A-7b (mount/)",
    "msgBroker": "A-7b (messaging/)",
    "filer.replicate": "A-7b (replication/)",
    "filer.backup": "A-7b (replication/)",
    "filer.meta.tail": "A-7b (replication/)",
    "filer.meta.backup": "A-7b (replication/meta_backup.py)",
    "filer.sync": "A-7b (replication/)",
    "webdav": "A-7b (webdav/)",
    "ftp": "A-7b (ftpd/)",
    "gateway": "A-7c (gateway.py)",
}

# filer.toml's store kinds in the order the reference tries them, each
# with the key naming its path (reference _filer_store_selection)
FILER_TOML_KINDS = (("sqlite", "dbFile"), ("leveldb", "dir"),
                    ("leveldb2", "dir"), ("leveldb3", "dir"), ("redis", ""),
                    ("etcd", ""), ("elastic7", ""), ("mongodb", ""),
                    ("cassandra", ""), ("mysql", ""), ("postgres", ""),
                    ("memory", ""))


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
    """`weed server`: master + volume, optionally a filer, in one process
    (command/server.go).  The S3 gateway it can add comes with ROADMAP
    A-7a."""
    from .master.server import MasterServer

    _refuse("-s3", args.s3, False, "the S3 gateway (s3api/, ROADMAP A-7a)")
    codec = _resolve_codec(args.ec_codec)
    _require_card(codec)
    if args.filer:
        _refuse_notification()
    store, store_path = (_filer_store_selection(args.filerStore)
                         if args.filer else (None, None))
    stopper = _Stopper()
    servers = []
    try:
        m = MasterServer(ip=args.ip, port=args.masterPort)
        m.start()
        servers.insert(0, m)
        v = _volume_server(args, codec, [f"{args.ip}:{m.grpc_port}"])
        v.start()
        servers.insert(0, v)
        extras = ""
        if args.filer:
            from .filer.server import FilerServer

            f = FilerServer(masters=[f"{args.ip}:{m.grpc_port}"],
                            ip=args.ip, port=args.filerPort, store=store,
                            store_path=store_path)
            f.start()
            servers.insert(0, f)
            extras = f" filer={args.filerPort}"
    except BaseException:
        for srv in servers:
            srv.stop()
        raise
    print(f"server: master={args.masterPort} volume={args.port}{extras} "
          f"codec={codec}", flush=True)
    stopper.wait(servers)


def _filer_store_selection(flag_store: str) -> tuple[str, str]:
    """filer.toml picks the store backend; the -store flag (a path) keeps
    its historical meaning of "sqlite at this path" and wins when given.
    -> (store, store_path).  A filer.toml that enables a kind with an
    external server is refused naming ROADMAP A-7a."""
    from .filer.filerstore import NOT_PORTED_KINDS
    from .util.config import load_configuration

    store, store_path = "sqlite", flag_store
    ported = [k for k, _p in FILER_TOML_KINDS if k not in NOT_PORTED_KINDS]
    fconf = load_configuration("filer")
    if fconf.loaded and flag_store == "./filer.db":  # flag left at default
        for kind, path_key in FILER_TOML_KINDS:
            if fconf.get_bool(f"{kind}.enabled"):
                if kind in NOT_PORTED_KINDS:
                    raise CliError(
                        f"{fconf.path} enables the {kind!r} filer store, "
                        "which is not ported yet (ROADMAP A-7a: the external "
                        f"store kinds); the port has {', '.join(ported)}")
                store = kind
                if path_key:
                    store_path = fconf.get_string(f"{kind}.{path_key}",
                                                  store_path)
                break
    return store, store_path


def _refuse_notification() -> None:
    """notification.toml with a publisher enabled: the filer would fan
    every metadata event out to it; the port has no publishers yet."""
    from .util.config import load_configuration

    conf = load_configuration("notification")
    if not conf.loaded:
        return
    section = conf.data.get("notification", {})
    enabled = [k for k, v in section.items()
               if isinstance(v, dict) and v.get("enabled")]
    if enabled:
        raise CliError(
            f"{conf.path} enables notification.{', '.join(enabled)}; "
            "notification publishers are not ported yet (notification/, "
            "ROADMAP A-7b)")


def cmd_filer(args) -> None:
    from .filer.server import FilerServer

    _refuse("-peers", args.peers, "",
            "filer peers (filer/meta_aggregator.py, ROADMAP A-7c)")
    _refuse("-clusterId", args.clusterId, 0,
            "geo replication (replication/geo.py, ROADMAP A-7c)")
    _refuse("-geoPeers", args.geoPeers, "",
            "geo replication (replication/geo.py, ROADMAP A-7c)")
    _refuse("-geoRateMBps", args.geoRateMBps, None,
            "geo replication (replication/geo.py, ROADMAP A-7c)")
    _refuse_notification()
    store, store_path = _filer_store_selection(args.store)
    stopper = _Stopper()
    f = FilerServer(
        masters=[_grpc_addr(m) for m in args.master.split(",")],
        ip=args.ip,
        port=args.port,
        store=store,
        store_path=store_path,
        max_mb=args.maxMB,
        metrics_port=args.metricsPort,
        cipher=args.cipher,
        meta_log_dir=args.metaLogDir,
    )
    f.start()
    print(f"filer http={args.port} grpc={f.grpc_port} store={store}",
          flush=True)
    stopper.wait([f])


def cmd_backup(args) -> None:
    from .tools.backup import backup_volume

    res = backup_volume(args.server, args.volumeId, args.dir,
                        collection=args.collection)
    print(f"volume {args.volumeId}: appended {res['appended']} needles"
          + (" (full resync)" if res["full_resync"] else ""))


def cmd_upload(args) -> None:
    import json

    from .tools.backup import upload_files

    results = upload_files(args.master, args.files,
                           collection=args.collection,
                           replication=args.replication, ttl=args.ttl)
    print(json.dumps(results, indent=2))


def cmd_download(args) -> None:
    from .tools.backup import download_files

    for path in download_files(args.server, args.fids, args.dir):
        print(path)


def cmd_filer_cat(args) -> None:
    from .tools.backup import filer_cat

    sys.stdout.buffer.write(filer_cat(args.filer, args.path))
    sys.stdout.buffer.flush()


def cmd_filer_copy(args) -> None:
    from .tools.backup import filer_copy

    for p in filer_copy(args.filer, args.sources, args.dest):
        print(p)


def cmd_bench(args) -> None:
    from .tools.benchmark import run_benchmark

    run_benchmark(
        master=args.master,
        num_files=args.n,
        file_size=args.size,
        concurrency=args.c,
        do_read=not args.write_only,
        collection=args.collection,
        replication=args.replication,
    )


def cmd_fix(args) -> None:
    from .tools.offline import fix_index

    fix_index(args.dir, args.volumeId, args.collection)
    print(f"rebuilt index for volume {args.volumeId}")


def cmd_compact(args) -> None:
    from .storage.vacuum import vacuum_volume
    from .storage.volume import Volume

    v = Volume(args.dir, args.collection, args.volumeId)
    try:
        vacuum_volume(v)
    finally:
        v.close()
    print(f"compacted volume {args.volumeId}")


def cmd_export(args) -> None:
    from .tools.offline import export_volume

    n = export_volume(args.dir, args.volumeId, args.collection, args.output)
    print(f"exported {n} needles to {args.output}")


def cmd_scaffold(args) -> None:
    import os

    from .util.scaffold import scaffold

    text = scaffold(args.config)
    if args.output == "-":
        print(text, end="")
    else:
        path = os.path.join(args.output, f"{args.config}.toml")
        with open(path, "w") as f:
            f.write(text)
        print(f"wrote {path}")


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


# cmd -> the certificate identity its gRPC listener presents; commands
# absent here are pure clients ("server" hosts its servers behind one
# listener credential set, the master's)
_TLS_COMPONENT = {
    "master": "master", "volume": "volume", "filer": "filer",
    "server": "master",
}


def _configure_security(cmd: str) -> None:
    """Load security.toml and install this process's gRPC mTLS
    credentials before any server or channel exists (the reference's
    boot-time LoadServerTLS/LoadClientTLS).  A named but incomplete or
    unloadable certificate set raises ValueError: the process stops."""
    from .pb import rpc as rpclib
    from .security.tls import (load_client_credentials,
                               load_server_credentials)
    from .util.config import load_configuration

    conf = load_configuration("security")
    if not conf.loaded:
        return
    component = _TLS_COMPONENT.get(cmd, "client")
    server_creds = (load_server_credentials(conf, component)
                    if cmd in _TLS_COMPONENT else None)
    channel_creds = load_client_credentials(conf, component)
    if server_creds or channel_creds:
        rpclib.configure_security(server_creds, channel_creds)


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
                   help="also start a filer")
    s.add_argument("-filer.port", dest="filerPort", type=int, default=8888)
    s.add_argument("-filer.store", dest="filerStore", default="./filer.db")
    s.add_argument("-s3", action="store_true",
                   help="also start an S3 gateway (not ported: ROADMAP A-7a)")
    s.add_argument("-s3.port", dest="s3Port", type=int, default=8333)
    s.set_defaults(fn=cmd_server)

    f = sub.add_parser("filer")
    f.add_argument("-master", default="127.0.0.1:9333")
    f.add_argument("-ip", default="127.0.0.1")
    f.add_argument("-port", type=int, default=8888)
    f.add_argument("-store", default="./filer.db",
                   help="sqlite file (filer.toml picks another store when "
                        "this is left at its default)")
    f.add_argument("-maxMB", type=int, default=4,
                   help="split files into chunks of at most this size")
    f.add_argument("-metricsPort", type=int, default=0)
    f.add_argument("-peers", default="",
                   help="peer filer http addresses for metadata "
                        "federation (ROADMAP A-7c: refused)")
    f.add_argument("-encryptVolumeData", dest="cipher", action="store_true",
                   help="AES-GCM encrypt chunk data before it reaches "
                        "volume servers")
    f.add_argument("-clusterId", type=int, default=0,
                   help="geo replication cluster id (ROADMAP A-7c: refused)")
    f.add_argument("-geoPeers", default="",
                   help="remote-cluster filer http addresses (ROADMAP "
                        "A-7c: refused)")
    f.add_argument("-geoRateMBps", type=float, default=None,
                   help="per-link geo budget (ROADMAP A-7c: refused)")
    f.add_argument("-metaLogDir", default="",
                   help="durable metadata event log dir (default: "
                        "<store path>.metalog for disk stores)")
    f.set_defaults(fn=cmd_filer)

    bk = sub.add_parser("backup")
    bk.add_argument("-server", default="127.0.0.1:9333",
                    help="master http address")
    bk.add_argument("-volumeId", type=int, required=True)
    bk.add_argument("-dir", default=".")
    bk.add_argument("-collection", default="")
    bk.set_defaults(fn=cmd_backup)

    up = sub.add_parser("upload")
    up.add_argument("-master", default="127.0.0.1:9333")
    up.add_argument("-collection", default="")
    up.add_argument("-replication", default="")
    up.add_argument("-ttl", default="")
    up.add_argument("files", nargs="+")
    up.set_defaults(fn=cmd_upload)

    dl = sub.add_parser("download")
    dl.add_argument("-server", default="127.0.0.1:9333",
                    help="master http address")
    dl.add_argument("-dir", default=".")
    dl.add_argument("fids", nargs="+")
    dl.set_defaults(fn=cmd_download)

    fcat = sub.add_parser("filer.cat")
    fcat.add_argument("-filer", default="127.0.0.1:8888")
    fcat.add_argument("path")
    fcat.set_defaults(fn=cmd_filer_cat)

    fcp = sub.add_parser("filer.copy")
    fcp.add_argument("-filer", default="127.0.0.1:8888")
    fcp.add_argument("sources", nargs="+")
    fcp.add_argument("dest")
    fcp.set_defaults(fn=cmd_filer_copy)

    b = sub.add_parser("benchmark")
    b.add_argument("-master", default="127.0.0.1:9333")
    b.add_argument("-n", type=int, default=1024)
    b.add_argument("-size", type=int, default=1024)
    b.add_argument("-c", type=int, default=16)
    b.add_argument("-collection", default="")
    b.add_argument("-replication", default="")
    b.add_argument("--write-only", action="store_true")
    b.set_defaults(fn=cmd_bench)

    for name, fn in (("fix", cmd_fix), ("compact", cmd_compact),
                     ("export", cmd_export)):
        o = sub.add_parser(name)
        o.add_argument("-dir", default=".")
        o.add_argument("-volumeId", type=int, required=True)
        o.add_argument("-collection", default="")
        if name == "export":
            o.add_argument("-o", dest="output", default="export.tar")
        o.set_defaults(fn=fn)

    sc = sub.add_parser("scaffold")
    sc.add_argument("-config", default="security",
                    choices=("security", "master", "filer",
                             "notification", "replication", "shell"))
    sc.add_argument("-output", default=".",
                    help="output directory, or - for stdout")
    sc.set_defaults(fn=cmd_scaffold)

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
        if args.cmd != "scaffold":
            _configure_security(args.cmd)
        args.fn(args)
    except (CliError, ValueError, RuntimeError, OSError) as e:
        print(f"seaweedfs_tpu_torch {args.cmd}: error: {e}", file=sys.stderr)
        return 2 if isinstance(e, CliError) else 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
