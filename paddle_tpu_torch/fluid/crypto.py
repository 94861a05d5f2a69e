"""Model encryption (reference paddle/fluid/framework/io/crypto/:
cipher.h:24 CipherFactory + aes_cipher.h:48 AESCipher, used to encrypt
saved inference models), copied from the JAX package's
``fluid/crypto.py``: the same bytes on disk, so an encrypted model saved
by either package decrypts in the other.

AES-256-GCM via the `cryptography` package: authenticated encryption
(the reference's AES-CBC+tag scheme modernized), random 96-bit nonce
prepended to the ciphertext. Keys are 32 raw bytes or any string
(hashed to 32 bytes with SHA-256, matching the reference's convert-key
helper behavior).

``cryptography`` is imported at first use: where it is not installed,
only an encrypted save or load fails, with an ImportError that names
the package."""
from __future__ import annotations

import hashlib
import os


def _key_bytes(key) -> bytes:
    if isinstance(key, str):
        key = key.encode()
    if len(key) != 32:
        key = hashlib.sha256(key).digest()
    return key


def _aesgcm():
    try:
        from cryptography.hazmat.primitives.ciphers.aead import AESGCM
    except ImportError as e:
        raise ImportError(
            "an encrypted model needs the 'cryptography' package "
            "(AES-GCM), which is not installed") from e
    return AESGCM


def encrypt_bytes(data: bytes, key) -> bytes:
    AESGCM = _aesgcm()
    nonce = os.urandom(12)
    return nonce + AESGCM(_key_bytes(key)).encrypt(nonce, data, None)


def decrypt_bytes(data: bytes, key) -> bytes:
    AESGCM = _aesgcm()
    return AESGCM(_key_bytes(key)).decrypt(data[:12], data[12:], None)


def encrypt_file(path: str, key, out_path=None) -> str:
    out_path = out_path or path
    with open(path, "rb") as f:
        data = f.read()
    with open(out_path, "wb") as f:
        f.write(encrypt_bytes(data, key))
    return out_path


def decrypt_file(path: str, key) -> bytes:
    with open(path, "rb") as f:
        return decrypt_bytes(f.read(), key)
