"""`weed scaffold` — emit default TOML config files.

The port's copy of seaweedfs_tpu/util/scaffold.py.

Reference: weed/command/scaffold.go:13 (the templates themselves are
redesigned for this framework: python store backends, the tpu ec codec
section, and the maintenance scripts that our shell actually implements).
"""

from __future__ import annotations

SECURITY_TOML = '''\
# security.toml
# Discovered from ./, ~/.seaweedfs/, /usr/local/etc/seaweedfs/,
# /etc/seaweedfs/. All sections are optional; empty values disable the
# feature.

[jwt.signing]
# When set, the master mints a JWT with each assignment and volume
# servers require it on writes (flag -jwtKey overrides).
key = ""

[guard]
# Source-IP whitelist for volume-server writes (flag -whiteList overrides).
white_list = []

# gRPC mTLS: every component presents a cert signed by the shared CA and
# verifies its peers. Generate a dev set with:
#   python -c "from seaweedfs_tpu.security import generate_dev_certs; \\
#              generate_dev_certs('certs')"
[grpc]
ca = ""

[grpc.master]
cert = ""
key  = ""

[grpc.volume]
cert = ""
key  = ""

[grpc.filer]
cert = ""
key  = ""

[grpc.broker]
cert = ""
key  = ""

[grpc.client]
cert = ""
key  = ""
'''

MASTER_TOML = '''\
# master.toml

[master.maintenance]
# Admin-shell lines the leader runs under the exclusive admin lock.
scripts = [
  "ec.encode -fullPercent=95 -quietFor=1h",
  "ec.rebuild -force",
  "ec.balance -force",
  "volume.balance -force",
  "volume.fix.replication",
]
# Seconds between runs (the reference's default is ~17 minutes).
periodic_seconds = 1020

[master.sequencer]
# memory | snowflake | etcd
type = "memory"
# etcd kind: comma-separated etcd v3 endpoints (framework-native client)
sequencer_etcd_urls = "127.0.0.1:2379"
# Unique per-master worker id stamped into snowflake file ids.
sequencer_snowflake_id = 0

# The erasure-coding codec volume servers use for bulk encode/rebuild
# (flag -ec.codec overrides).
[codec]
# auto | cpu | tpu | tpu_xor | tpu_mxu — auto probes one timed encode
# round trip and picks the faster of the device and host-SIMD codecs
# for this machine.
type = "auto"
'''

FILER_TOML = '''\
# filer.toml
# Exactly one enabled store backend.

[memory]
# In-process, non-persistent; tests only.
enabled = false

[sqlite]
enabled = true
dbFile = "./filer.db"

[leveldb]
# Embedded sorted-file store (pure python SSTable-style).
enabled = false
dir = "./filerldb"

[leveldb2]
# Same store, md5-hash-partitioned into 8 instances (dir/00..07).
enabled = false
dir = "./filerldb2"

[leveldb3]
# Adaptive per-bucket partitioning: /buckets/<b> objects get their own
# DB; dropping a bucket is O(1).
enabled = false
dir = "./filerldb3"

[redis]
# Any RESP2 endpoint (framework-native client, no redis library).
enabled = false
host = "127.0.0.1"
port = 6379
db = 0

[etcd]
# etcd v3 cluster (framework-native gRPC KV client, no etcd library).
enabled = false
servers = "127.0.0.1:2379"

[elastic7]
# Elasticsearch 7 (framework-native REST client, no ES library).
enabled = false
servers = "http://127.0.0.1:9200"
username = ""
password = ""

[mongodb]
# MongoDB 3.6+ (framework-native OP_MSG wire client, no pymongo).
enabled = false
host = "127.0.0.1"
port = 27017
database = "seaweedfs"

[cassandra]
# Cassandra (framework-native CQL v4 client, no driver library).
# Expects: CREATE TABLE seaweedfs.filemeta (directory blob, name blob,
#   meta blob, PRIMARY KEY (directory, name));
enabled = false
host = "127.0.0.1"
port = 9042
keyspace = "seaweedfs"

[mysql]
# Needs the pymysql (or mysqlclient) driver installed.
enabled = false
hostname = "localhost"
port = 3306
username = "root"
password = ""
database = "seaweedfs"

[postgres]
# Needs the psycopg2 driver installed.
enabled = false
hostname = "localhost"
port = 5432
username = "postgres"
password = ""
database = "seaweedfs"
'''

NOTIFICATION_TOML = '''\
# notification.toml
# Filer metadata events fan out to at most one enabled queue
# (weed scaffold -config=notification analogue).

[notification.log]
# Print events to the filer's log.
enabled = false

[notification.file]
# Append JSON events to a local file.
enabled = false
path = "./filer_events.jsonl"

[notification.kafka]
# Needs a reachable Kafka broker.
enabled = false
hosts = "kafka1:9092"
topic = "seaweedfs_filer"

[notification.aws_sqs]
# Signed with the framework's own SigV4; no AWS SDK required.
enabled = false
aws_access_key_id = ""
aws_secret_access_key = ""
region = "us-east-2"
sqs_queue_url = ""

# (google_pub_sub exists in code but needs a programmatic OAuth token
# source, which a static TOML cannot supply — configure it in-process.)
'''

REPLICATION_TOML = '''\
# replication.toml
# Where `filer.replicate` replays filer events; one enabled sink.

[source.filer]
enabled = true
grpcAddress = "localhost:18888"
directory = "/buckets"

[sink.local]
enabled = false
directory = "/backup"

[sink.filer]
enabled = false
grpcAddress = "localhost:18888"
directory = "/backup"

[sink.s3]
# Any S3-compatible endpoint (framework-native SigV4 client).
enabled = false
endpoint = "localhost:8333"
bucket = "backup"
directory = ""

[sink.google_cloud_storage]
# HMAC interoperability credentials (S3-compat XML API).
enabled = false
bucket = ""
access_key = ""
secret_key = ""
directory = ""

[sink.azure]
enabled = false
account_name = ""
account_key = ""
container = ""
directory = ""

[sink.backblaze]
enabled = false
b2_account_id = ""
b2_master_application_key = ""
region = "us-west-002"
bucket = ""
directory = ""
'''

SHELL_TOML = '''\
# shell.toml
# Defaults for `weed shell` when -master/-filer flags are omitted.

[cluster.default]
master = "localhost:9333"
filer = "localhost:8888"
'''

TEMPLATES = {
    "security": SECURITY_TOML,
    "master": MASTER_TOML,
    "filer": FILER_TOML,
    "notification": NOTIFICATION_TOML,
    "replication": REPLICATION_TOML,
    "shell": SHELL_TOML,
}


def scaffold(config: str) -> str:
    if config not in TEMPLATES:
        raise ValueError(
            f"unknown config {config!r}; one of {sorted(TEMPLATES)}")
    return TEMPLATES[config]
