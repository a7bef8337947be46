"""Chained token-block hashing for KV prefix reuse and routing affinity.

Counterpart of ``ray_tpu/util/blockhash.py``, byte for byte: one digest per
FULL block of ``block_tokens`` token ids, chained so a block's hash commits
to the whole prefix ending at it:

    digest_i = blake2b(digest_{i-1} || tokens[i*bt : (i+1)*bt])

The seed and digest size are the JAX package's, so a router hashing with
either package and a block manager of either package agree on every key.
"""

from __future__ import annotations

import hashlib
from typing import List, Optional, Sequence

_DIGEST_BYTES = 16
# Chain root: the "digest" preceding block 0. Public because the KV block
# manager threads it as the parent key of a chain's first tail entry.
SEED = b"ray_tpu-kv-block"


def _chain(prev: bytes, block: Sequence[int]) -> bytes:
    h = hashlib.blake2b(prev, digest_size=_DIGEST_BYTES)
    h.update(b",".join(b"%d" % int(t) for t in block))
    return h.digest()


def block_hashes(tokens: Sequence[int], block_tokens: int,
                 max_blocks: Optional[int] = None) -> List[bytes]:
    """Chained digests of every FULL block of ``tokens`` (a trailing partial
    block is NOT hashed — its contents aren't stable until the block fills)."""
    n_full = len(tokens) // block_tokens
    if max_blocks is not None:
        n_full = min(n_full, max_blocks)
    digests: List[bytes] = []
    prev = SEED
    for i in range(n_full):
        prev = _chain(prev, tokens[i * block_tokens:(i + 1) * block_tokens])
        digests.append(prev)
    return digests



def prefix_head_hash(tokens: Sequence[int], block_tokens: int,
                     blocks: int) -> Optional[bytes]:
    """Digest of the prompt's leading ``blocks`` full blocks (fewer if the
    prompt is shorter) — the serve router's affinity key. None when the
    prompt has no full block (nothing stable to key on)."""
    digests = block_hashes(tokens, block_tokens, max_blocks=blocks)
    return digests[-1] if digests else None
