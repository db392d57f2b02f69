"""Transparent data encryption — at-rest protection for the table store.

The reference encrypts cluster files with a keyring unlocked at startup
(TDE; key lifecycle outside the database). Analog: a cluster key string
(config storage.encryption_key — point it at a secret manager value, not
a literal in source) derives a Fernet key (AES-128-CBC + HMAC-SHA256,
from the `cryptography` package); every micro-partition file and
manifest encrypts whole — footers and manifests carry min/max stats and
string dictionaries, which are data. CURRENT pointers and lock files
stay plaintext (they hold only version numbers / pids).

A store written with a key refuses to open its files without one, and a
wrong key fails MAC verification — never silent garbage."""

from __future__ import annotations

import base64
import hashlib


class TdeError(RuntimeError):
    pass


class Cipher:
    """encrypt/decrypt bytes under a cluster key string."""

    def __init__(self, key: str):
        try:
            from cryptography.fernet import Fernet
        except ImportError as e:  # pragma: no cover — baked into image
            raise TdeError(f"TDE needs the 'cryptography' package: {e}")
        digest = hashlib.sha256(key.encode()).digest()
        self._f = Fernet(base64.urlsafe_b64encode(digest))

    def encrypt(self, data: bytes) -> bytes:
        return self._f.encrypt(data)

    def decrypt(self, data: bytes) -> bytes:
        from cryptography.fernet import InvalidToken

        try:
            return self._f.decrypt(data)
        except InvalidToken:
            raise TdeError("decryption failed: wrong encryption key "
                           "(storage.encryption_key) or corrupt file")


def make_cipher(key: str | None):
    return Cipher(key) if key else None
