"""The port's own copy of what tpusim draws from `jax.random` (threefry2x32
keys, `split` and `uniform` over float32), bit for bit.

tpusim runs with 64-bit types off and with `jax_threefry_partitionable`
on, and these functions reproduce that setting only:

- a key is two uint32 words; `prng_key(seed)` is (0, seed mod 2**32), as
  `PRNGKey(seed)` is with x64 off (jax/_src/prng.py `threefry_seed`);
- `split(key)` is the "foldlike" split (`_threefry_split_foldlike`): new key
  j is (bits1[j], bits2[j]) of threefry2x32(key, hi=[0, 0], lo=[0, 1]);
- `fold_in(key, data)` is threefry2x32(key, hi=0, lo=data mod 2**32), the
  hash of `threefry_seed(data)` (`_threefry_fold_in`);
- `uniform(key, n)` draws element i from counter (hi 0, lo i) alone
  (`_threefry_random_bits_partitionable`): bits = bits1 ^ bits2, then the
  float32 of bits >> 9 under the exponent of 1.0, minus 1.0 (`_uniform`,
  whose scale by 1 and shift by 0 leave it as it is). So a draw over a
  padded axis equals the draw over N on its first N entries.

Words are int64 tensors (or Python ints) holding values in [0, 2**32):
every operation below masks back to 32 bits, so the same code runs on
tensors of either device and on plain integers. The CUDA kernels carry the
same hash (replay.cu `threefry2x32`).

The event key chain of tpusim's table engine and sequential oracle
(tpusim/sim/table_engine.py:1048-1049, tpusim/sim/engine.py:283) consumes
one step per event, whatever its kind: key, sub = split(key), then
k_rand, k_sel = split(sub). `event_keys` gives each event's k_rand and
k_sel, `advance_key` the chain's key after a number of events (a chunked
replay's next root).
"""

from __future__ import annotations

from typing import Tuple

import torch

# jax.config.jax_threefry_partitionable as tpusim runs it; a test holds
# the installed JAX to it
THREEFRY_PARTITIONABLE = True

_M = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & _M


def threefry2x32(k0, k1, x0, x1):
    """The Threefry-2x32 hash of counters (x0, x1) under key (k0, k1), 20
    rounds (jax/_src/prng.py `_threefry2x32_lowering`). Words are Python
    ints or int64 tensors in [0, 2**32); returns (y0, y1) alike."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _M
    x1 = (x1 + ks[1]) & _M
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M
    return x0, x1


def prng_key(seed: int) -> Tuple[int, int]:
    """`jax.random.PRNGKey(seed)` with 64-bit types off."""
    return 0, int(seed) & _M


def split(key) -> Tuple[Tuple[int, int], Tuple[int, int]]:
    """The two keys of `jax.random.split(key)` (partitionable form)."""
    k0, k1 = (int(w) for w in key)
    a = threefry2x32(k0, k1, 0, 0)
    b = threefry2x32(k0, k1, 0, 1)
    return a, b


def fold_in(key, data: int) -> Tuple[int, int]:
    """`jax.random.fold_in(key, data)`."""
    k0, k1 = (int(w) for w in key)
    return threefry2x32(k0, k1, 0, int(data) & _M)


def random_bits(key, n: int, device=None) -> torch.Tensor:
    """`jax.random.bits(key, (n,))` as uint32 values in an int64 tensor."""
    k0, k1 = (int(w) for w in key)
    lo = torch.arange(n, dtype=torch.int64, device=device)
    y0, y1 = threefry2x32(k0, k1, torch.zeros_like(lo), lo)
    return y0 ^ y1


def bits_to_unit(bits: torch.Tensor) -> torch.Tensor:
    """uint32 bits (int64) -> float32 in [0, 1), as `_uniform` maps them."""
    one = ((bits >> 9) | 0x3F800000).to(torch.int32)
    return one.view(torch.float32) - 1.0


def uniform(key, n: int, device=None) -> torch.Tensor:
    """`jax.random.uniform(key, (n,))`, float32."""
    return bits_to_unit(random_bits(key, n, device))


def advance_key(key, e: int) -> Tuple[int, int]:
    """The chain's key after `e` events from `key`: `split(key)[0]`, `e`
    times (event_keys' chain, without the per-event keys)."""
    k0, k1 = (int(w) & _M for w in key)
    for _ in range(e):
        k0, k1 = threefry2x32(k0, k1, 0, 0)
    return k0, k1


def event_keys(key, e: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(k_rand, k_sel), int64 [E, 2] each: the keys event i of a replay
    draws from when the chain starts at `key`. The chain itself is serial
    (Python integers, one step an event); the keys split from each step's
    `sub` are hashed for all events at once."""
    k0, k1 = (int(w) for w in key)
    subs = []
    for _ in range(e):
        (k0, k1), sub = split((k0, k1))
        subs.append(sub)
    s = torch.tensor(subs, dtype=torch.int64).reshape(e, 2)
    z = torch.zeros(e, dtype=torch.int64)
    rand = threefry2x32(s[:, 0], s[:, 1], z, z)
    sel = threefry2x32(s[:, 0], s[:, 1], z, z + 1)
    return torch.stack(rand, 1), torch.stack(sel, 1)
