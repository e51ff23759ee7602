"""The port's write JWTs and IP whitelist guard (seaweedfs_tpu_torch/security/)
held against the reference's (seaweedfs_tpu/security/).

`encode_jwt` on fixed claims gives the reference's token byte for byte;
`gen_write_jwt` does too with the clock pinned (it stamps `exp` from
time.time).  Each package verifies the other's tokens and rejects them
after tampering, under another key, for another fid and once expired.
`Guard` answers as the reference's on the same seeded whitelists and
addresses."""

from __future__ import annotations

import ipaddress

import numpy as np
import pytest

from seaweedfs_tpu.security import guard as ref_guard
from seaweedfs_tpu.security import jwt as ref_jwt
from seaweedfs_tpu_torch.security import guard, jwt

SIDES = {"reference": ref_jwt, "port": jwt}


def _claims(seed: int) -> list[tuple[bytes, dict]]:
    rng = np.random.default_rng(seed)
    out = []
    for i in range(24):
        key = rng.integers(0, 256, int(rng.integers(1, 64))).astype(
            np.uint8).tobytes()
        fid = f"{int(rng.integers(1, 1000))},{int(rng.integers(1, 2**40)):x}" \
              f"{int(rng.integers(0, 2**32)):08x}"
        claims = {"exp": int(rng.integers(1, 2**31)), "sub": fid}
        if i % 4 == 1:
            claims = {"sub": fid}  # no expiry
        elif i % 4 == 2:
            claims["extra"] = ["ü", i, None]  # non-ascii, nested
        out.append((key, claims))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_encode_jwt_equals_the_reference(seed):
    for key, claims in _claims(seed):
        assert jwt.encode_jwt(key, claims) == ref_jwt.encode_jwt(key, claims)


def test_gen_write_jwt_equals_the_reference_at_one_instant(monkeypatch):
    import time

    now = 1_760_000_000.25
    monkeypatch.setattr(time, "time", lambda: now)
    for key, claims in _claims(3):
        for expires in (1, 10, 3600):
            assert jwt.gen_write_jwt(key, claims["sub"], expires) \
                == ref_jwt.gen_write_jwt(key, claims["sub"], expires)
    assert jwt.gen_write_jwt(b"", "3,01") == "" == ref_jwt.gen_write_jwt(
        b"", "3,01")


@pytest.mark.parametrize("signer,verifier", [
    ("reference", "port"), ("port", "reference"), ("port", "port")])
def test_tokens_verify_across_packages(signer, verifier):
    sign, check = SIDES[signer], SIDES[verifier]
    for key, claims in _claims(4):
        fid = claims["sub"]
        token = sign.gen_write_jwt(key, fid, 60)
        assert check.verify_write_jwt(key, token, fid)
        assert check.decode_jwt(key, token)["sub"] == fid
        # another fid, another key, a tampered payload or signature
        assert not check.verify_write_jwt(key, token, fid + "0")
        assert not check.verify_write_jwt(key + b"x", token, fid)
        h, p, s = token.split(".")
        assert check.decode_jwt(key, f"{h}.{p}x.{s}") is None
        assert check.decode_jwt(key, f"{h}.{p}.{s[:-2]}") is None
        assert not check.verify_write_jwt(key, "", fid)
        # an expired token, and an unbound (empty-sub) wildcard
        old = sign.encode_jwt(key, {"exp": 1, "sub": fid})
        assert not check.verify_write_jwt(key, old, fid)
        wild = sign.encode_jwt(key, {"sub": ""})
        assert check.verify_write_jwt(key, wild, fid)


def test_token_from_header_equals_the_reference():
    for h in (None, "", "Bearer abc", "bearer abc", "BEARER a.b.c",
              "Basic abc", "Bearer", "Bearer a b", "  Bearer   x  "):
        assert jwt.token_from_header(h) == ref_jwt.token_from_header(h)


def _addresses(rng, n: int) -> list[str]:
    out = [str(ipaddress.IPv4Address(int(x)))
           for x in rng.integers(0, 2**32, n, dtype=np.uint64)]
    out += ["127.0.0.1", "10.1.2.3", "192.168.1.1", "::1", "fe80::1",
            "not-an-ip", ""]
    return out


@pytest.mark.parametrize("whitelist", [
    None, [], ["127.0.0.1", "10.0.0.0/8"], ["192.168.0.0/16", " ", "bogus"],
    ["0.0.0.0/0"], ["::1", "fe80::/10", "10.1.2.3"], ["10.1.2.0/24"],
])
def test_guard_answers_as_the_reference(whitelist):
    rng = np.random.default_rng(len(whitelist or ()))
    mine, ref = guard.Guard(whitelist), ref_guard.Guard(whitelist)
    assert [str(n) for n in mine.networks] == [str(n) for n in ref.networks]
    for addr in _addresses(rng, 256):
        assert mine.allows(addr) == ref.allows(addr), addr


def test_guard_cases_of_the_reference_suite():
    g = guard.Guard(["127.0.0.1", "10.0.0.0/8"])
    assert g.allows("127.0.0.1")
    assert g.allows("10.1.2.3")
    assert not g.allows("192.168.1.1")
    assert guard.Guard([]).allows("8.8.8.8")  # empty whitelist admits all
