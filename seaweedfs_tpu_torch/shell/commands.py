"""Admin shell core: CommandEnv, registry, and the maintenance script.

Reference: weed/shell/commands.go (CommandEnv + exclusive admin lock) and
master_server.go:187-242 (the [master.maintenance] loop that runs
`ec.encode; ec.rebuild; ec.balance; volume.balance; volume.fix.replication`
every 17 minutes under the admin lock).

The port's copy of seaweedfs_tpu/shell/commands.py.  It registers the
commands that need only a master and volume servers (ec_commands.py,
volume_commands.py, and cluster_commands.py's cluster.status,
cluster.alerts, cluster.hot and cluster.debug).  The reference's
fs_commands.py, filer.ring and cluster.geo need the filer fleet and the
geo registry and come with a later slice; naming one of their commands,
or a volume command left out here, raises the same ValueError as an
unknown command, with the ROADMAP item that brings it.
"""

from __future__ import annotations

import shlex
from dataclasses import dataclass, field

import grpc

from ..pb import master_pb2
from ..pb import rpc as rpclib


@dataclass
class CommandEnv:
    master_grpc: str  # "ip:grpc_port"
    locked_token: int = 0
    option: dict = field(default_factory=dict)

    def master(self) -> rpclib.Stub:
        return rpclib.master_stub(self.master_grpc, timeout=60)

    def volume_server(self, grpc_address: str) -> rpclib.Stub:
        return rpclib.volume_server_stub(grpc_address, timeout=600)

    def topology(self) -> master_pb2.TopologyInfo:
        return self.master().VolumeList(master_pb2.VolumeListRequest()).topology_info

    def volume_size_limit(self) -> int:
        resp = self.master().VolumeList(master_pb2.VolumeListRequest())
        return resp.volume_size_limit_mb * (1 << 20)

    # -- exclusive admin lock (wdclient/exclusive_locks analogue) ---------

    def acquire_lock(self) -> bool:
        try:
            resp = self.master().LeaseAdminToken(
                master_pb2.LeaseAdminTokenRequest(
                    previous_token=self.locked_token, lock_name="admin"
                )
            )
            self.locked_token = resp.token
            return True
        except grpc.RpcError:
            return False

    def release_lock(self) -> None:
        if self.locked_token:
            try:
                self.master().ReleaseAdminToken(
                    master_pb2.ReleaseAdminTokenRequest(
                        previous_token=self.locked_token, lock_name="admin"
                    )
                )
            except grpc.RpcError:
                pass
            self.locked_token = 0


COMMANDS: dict[str, object] = {}


def register(name: str):
    def deco(fn):
        COMMANDS[name] = fn
        return fn

    return deco


def run_command(env: CommandEnv, line: str) -> str:
    """Run one shell command line; returns its output text."""
    parts = shlex.split(line)
    if not parts:
        return ""
    name, args = parts[0], parts[1:]
    fn = COMMANDS.get(name)
    if fn is None:
        where = _not_ported(name)
        if where:
            raise ValueError(f"command {name!r} is not ported yet ({where})")
        raise ValueError(
            f"unknown command {name!r}; available: {', '.join(sorted(COMMANDS))}"
        )
    return fn(env, args) or ""


# reference commands this package does not have yet -> where they come from
_NOT_PORTED = {
    "cluster.geo": "shell/cluster_commands.py, the geo registry, "
                   "ROADMAP A-7",
    "filer.ring": "shell/cluster_commands.py, the filer fleet, ROADMAP A-7",
    "collection.": "shell/fs_commands.py, ROADMAP A-7",
    "fs.": "shell/fs_commands.py, ROADMAP A-7",
    "s3.": "shell/fs_commands.py, ROADMAP A-7",
}


def _not_ported(name: str) -> str:
    for prefix, where in _NOT_PORTED.items():
        if name == prefix or (prefix.endswith(".") and name.startswith(prefix)):
            return where
    return ""


DEFAULT_MAINTENANCE_SCRIPT = (
    # the scaffold default block, line-for-line (command/scaffold.go:503-518;
    # lock/unlock are implicit — run_maintenance holds the admin lock)
    "ec.encode -fullPercent=95 -quietFor=1h",
    "ec.rebuild -force",
    "ec.balance -force",
    "volume.balance -force",
    "volume.fix.replication",
)


def run_maintenance(env: CommandEnv, script=None) -> list[str]:
    """The [master.maintenance] script block (scaffold.go:503-518).

    `script` is a list of shell command lines (from master.toml's
    [master.maintenance].scripts); None runs the scaffold default.
    """
    out = []
    if not env.acquire_lock():
        return ["maintenance: admin lock busy"]
    try:
        for line in script if script is not None else DEFAULT_MAINTENANCE_SCRIPT:
            try:
                out.append(f"> {line}\n{run_command(env, line)}")
            except Exception as e:
                out.append(f"> {line}\nerror: {e}")
    finally:
        env.release_lock()
    return out


# import command modules for registration side effects
from . import cluster_commands  # noqa: E402,F401
from . import ec_commands  # noqa: E402,F401
from . import volume_commands  # noqa: E402,F401
