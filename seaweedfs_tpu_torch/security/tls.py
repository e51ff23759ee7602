"""mTLS for the gRPC substrate — the port's copy of
seaweedfs_tpu/security/tls.py.

Reference: weed/security/tls.go — every component can present a client
certificate and verify peers against a shared CA; servers require and
verify client certs ([grpc] section of security.toml: ca, plus
<component>.cert/.key for master/volume/filer/client/...).

The grpc-python binding expresses the same policy with
ssl_server_credentials(require_client_auth=True) and
ssl_channel_credentials; pb/rpc.py consults `configure_security(...)`'d
state when opening listening ports and channels.  `generate_dev_certs`
creates a CA + per-component certs for tests and dev clusters (the
reference points users at openssl for this); it imports `cryptography`
only when called.

Difference from the reference, on purpose: a security.toml that names
some of a component's three files (`grpc.ca`, its cert, its key) but not
all, or names files that do not parse as a matching PEM key pair and CA,
raises ValueError naming them.  The reference serves in the clear on a
partial set and defers a bad PEM to the first handshake; the port never
runs without the TLS the operator asked for.
"""

from __future__ import annotations

import datetime
import ipaddress
import os

import ssl

import grpc


def _read_cert_triplet(config, component: str):
    """Resolve + read (key, cert, ca) bytes for a component, or None.

    Keys follow the reference convention: cert/key at
    `grpc.<component>.cert/.key` (or bare `<component>.cert/.key`), the
    shared CA at `grpc.ca`.
    """
    if config is None or not config.loaded:
        return None
    names = {
        "cert": config.get_string(f"grpc.{component}.cert")
        or config.get_string(f"{component}.cert"),
        "key": config.get_string(f"grpc.{component}.key")
        or config.get_string(f"{component}.key"),
        "ca": config.get_string("grpc.ca"),
    }
    if not any(names.values()):
        return None
    missing = [k for k, v in names.items() if not v]
    if missing:
        raise ValueError(
            f"{config.path}: gRPC TLS for {component!r} names "
            f"{', '.join(f'{k}={v}' for k, v in names.items() if v)} but "
            f"no {', '.join(missing)}; refusing to serve in the clear")
    try:
        # parse now: a bad PEM or a key that does not match its cert
        # stops the process here, not at the first handshake
        ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
        ctx.load_cert_chain(names["cert"], names["key"])
        ctx.load_verify_locations(cafile=names["ca"])
    except (OSError, ssl.SSLError) as e:
        raise ValueError(
            f"{config.path}: gRPC TLS for {component!r} cannot load "
            f"cert={names['cert']} key={names['key']} ca={names['ca']}: "
            f"{e}") from e
    out = []
    for k in ("key", "cert", "ca"):
        with open(names[k], "rb") as f:
            out.append(f.read())
    return tuple(out)


def load_server_credentials(config, component: str):
    """-> grpc.ServerCredentials or None when the config has no certs.

    Mirrors LoadServerTLS (tls.go:26): client certs required + verified.
    """
    triplet = _read_cert_triplet(config, component)
    if triplet is None:
        return None
    key, cert, ca = triplet
    return grpc.ssl_server_credentials(
        [(key, cert)], root_certificates=ca, require_client_auth=True
    )


def load_client_credentials(config, component: str = "client"):
    """-> grpc.ChannelCredentials or None (LoadClientTLS, tls.go:69)."""
    triplet = _read_cert_triplet(config, component)
    if triplet is None:
        return None
    key, cert, ca = triplet
    return grpc.ssl_channel_credentials(
        root_certificates=ca, private_key=key, certificate_chain=cert
    )


def generate_dev_certs(directory: str,
                       components=("master", "volume", "filer", "client"),
                       days: int = 365) -> dict[str, tuple[str, str]]:
    """Create a CA plus one cert/key pair per component under `directory`.

    Certificates carry SANs for localhost/127.0.0.1 so in-process cluster
    tests can dial by IP.  Returns {"ca": (ca_path, ""), component:
    (cert_path, key_path), ...}.
    """
    from cryptography import x509
    from cryptography.hazmat.primitives import hashes, serialization
    from cryptography.hazmat.primitives.asymmetric import rsa
    from cryptography.x509.oid import NameOID

    os.makedirs(directory, exist_ok=True)
    now = datetime.datetime.now(datetime.timezone.utc)
    out: dict[str, tuple[str, str]] = {}

    def _key():
        return rsa.generate_private_key(public_exponent=65537, key_size=2048)

    def _write(path: str, data: bytes) -> None:
        with open(path, "wb") as f:
            f.write(data)

    ca_key = _key()
    ca_name = x509.Name(
        [x509.NameAttribute(NameOID.COMMON_NAME, "seaweedfs-tpu dev ca")])
    ca_cert = (
        x509.CertificateBuilder()
        .subject_name(ca_name).issuer_name(ca_name)
        .public_key(ca_key.public_key())
        .serial_number(x509.random_serial_number())
        .not_valid_before(now - datetime.timedelta(minutes=5))
        .not_valid_after(now + datetime.timedelta(days=days))
        .add_extension(x509.BasicConstraints(ca=True, path_length=None),
                       critical=True)
        .sign(ca_key, hashes.SHA256())
    )
    ca_path = os.path.join(directory, "ca.crt")
    _write(ca_path, ca_cert.public_bytes(serialization.Encoding.PEM))
    out["ca"] = (ca_path, "")

    for comp in components:
        key = _key()
        subject = x509.Name(
            [x509.NameAttribute(NameOID.COMMON_NAME, f"{comp}.seaweedfs")])
        cert = (
            x509.CertificateBuilder()
            .subject_name(subject).issuer_name(ca_name)
            .public_key(key.public_key())
            .serial_number(x509.random_serial_number())
            .not_valid_before(now - datetime.timedelta(minutes=5))
            .not_valid_after(now + datetime.timedelta(days=days))
            .add_extension(
                x509.SubjectAlternativeName([
                    x509.DNSName("localhost"),
                    x509.DNSName(f"{comp}.seaweedfs"),
                    x509.IPAddress(ipaddress.ip_address("127.0.0.1")),
                ]),
                critical=False,
            )
            .sign(ca_key, hashes.SHA256())
        )
        cert_path = os.path.join(directory, f"{comp}.crt")
        key_path = os.path.join(directory, f"{comp}.key")
        _write(cert_path, cert.public_bytes(serialization.Encoding.PEM))
        _write(key_path, key.private_bytes(
            serialization.Encoding.PEM,
            serialization.PrivateFormat.TraditionalOpenSSL,
            serialization.NoEncryption(),
        ))
        out[comp] = (cert_path, key_path)
    return out
