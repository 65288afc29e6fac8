"""The launcher's shared secret and HMAC signing (the port's copy of
``horovod_tpu/run/common/util/secret.py``): every frame of the
launcher's services carries the HMAC of its payload under a per-job
key."""

import hashlib
import hmac
import os

DIGEST_LENGTH_BYTES = 32


def make_secret_key() -> bytes:
    return os.urandom(32)


def compute_digest(secret_key: bytes, message_bytes: bytes) -> bytes:
    return hmac.new(secret_key, message_bytes, hashlib.sha256).digest()


def check_digest(secret_key: bytes, message_bytes: bytes,
                 digest: bytes) -> bool:
    expected = compute_digest(secret_key, message_bytes)
    return hmac.compare_digest(expected, digest)
